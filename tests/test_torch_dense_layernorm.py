"""The port's LayerNorm dense family against the JAX package's, on the CPU:
StableLM-2-1.6B (LayerNorm, SwiGLU, a quarter of each head rotated) and
Nemotron-4-340B (LayerNorm, squared-ReLU MLP, half of each head of 192
rotated, GQA 96/8), in fp32, with JAX's weights carried by the weight
bridge.

The config copies equal JAX's field for field, and the model's own
parameter count (on the ``meta`` device) is JAX's tree's: the reference's
``param_count`` leaves out LayerNorm's biases, pinned here.  The ungated
MLP (``relu2``, ``gelu``) against ``apply_mlp``, and ungated experts against
``apply_moe`` (gather, capacity and exact), within 1e-5; partial-rotary
attention (0.25 at D=64, 0.5 at D=192) against JAX's ``attention_full`` and
``attention_decode`` (paged and contiguous) within 1e-5; the plain flash,
paged and decode versions at D=192, G=12 against ``_flash_jnp``,
``_paged_jnp``, ``_decode_jnp`` and each Pallas kernel in interpret mode, in
fp32 (2e-5) and bf16 (2e-2).  Then ``reduced()`` StableLM and a narrow
Nemotron (head_dim 192, 24 heads on 2 KV heads, 2 layers): prefill and
decode logits within 1e-4, greedy streams, counters and KV occupancy equal
to the JAX engine's in both layouts, the keyed graph path (capture
emulated) equal to eager; and the launcher, on the CPU and (memory query
stubbed) refusing on the card a config whose weights exceed free memory.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models.layers import Builder
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models import moe
from repro_torch.models.attention import Attention, attention_decode, attention_full
from repro_torch.models.bridge import flatten_tree, state_from_jax
from repro_torch.models.layers import rope_freqs, rope_tables
from repro_torch.models.mlp import MLP
from repro_torch.models.transformer import Model
from repro_torch.serving import engine
from test_torch_engine import EmulatedGraphs

MODULE_TOL = 1e-5
LOGIT_TOL = 1e-4
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCHS = ["stablelm-1.6b", "nemotron-4-340b"]
# the reference's ModelConfig.param_count and JAX's tree (``Model.param_count``
# over its leaves): the reference leaves out LayerNorm's biases, d for each
# of the 2 · n_layers + 1 norms
PARAMS = {"stablelm-1.6b": (1_644_267_520, 1_644_367_872),
          "nemotron-4-340b": (341_025_638_400, 341_029_195_776)}
TOK = ByteTokenizer()
MAX_LEN = 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: under the parallel test workers a
    thread pool a process costs these small models several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(cfg):
    """``reduced()``, and for Nemotron its published head: 192 wide, 24
    query heads on 2 KV heads (G = 12, as 96 on 8)."""
    cfg = cfg.reduced()
    if cfg.name.startswith("nemotron"):
        cfg = dataclasses.replace(cfg, head_dim=192, n_heads=24, n_kv_heads=2)
    return cfg


def _state(tree):
    return {k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in flatten_tree(jax.tree.map(np.asarray, tree)).items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---- configs and the parameter count --------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_copy_and_param_count_undercount(arch):
    """The copy equals the reference field for field; both configs'
    ``param_count`` keep the reference's undercount of LayerNorm's biases,
    and the model's own count, on ``meta``, is JAX's tree's."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    said, held = PARAMS[arch]
    assert cfg.param_count() == jcfg.param_count() == said
    assert JaxModel(jcfg).param_count() == held
    assert Model(cfg, device="meta").param_count() == held
    assert held - said == (2 * cfg.n_layers + 1) * cfg.d_model
    assert _narrow(cfg).norm == "layernorm"


def test_nemotron_first_four_layers_are_46_5_gb():
    """The size the card serves: Nemotron-4-340B's first 4 of 96 layers at
    full width, 23,253,553,152 parameters, 46.5 GB in bf16."""
    cfg = dataclasses.replace(get_arch("nemotron-4-340b"), n_layers=4)
    jcfg = dataclasses.replace(jax_get_arch("nemotron-4-340b"), n_layers=4)
    n = Model(cfg, device="meta").param_count()
    assert n == JaxModel(jcfg).param_count() == 23_253_553_152
    assert n * 2 == 46_507_106_304


# ---- the ungated MLP and ungated experts ----------------------------------

@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_ungated_mlp_matches_reference(act):
    """``down(act(up(x)))`` with JAX's leaves, no ``gate``."""
    jcfg = dataclasses.replace(jax_get_arch("nemotron-4-340b").reduced(), activation=act)
    cfg = dataclasses.replace(get_arch("nemotron-4-340b").reduced(), activation=act)
    p = jmlp.init_mlp(Builder("init", jax.random.PRNGKey(3)), jcfg)
    assert set(p) == {"up", "down"}
    mlp = MLP(cfg, dtype=torch.float32, device="cpu")
    mlp.load_state_dict(_state(p))
    assert mlp.gate is None
    x = _x((2, 7, cfg.d_model), seed=4)
    _close(mlp(torch.from_numpy(x)).numpy(), jmlp.apply_mlp(p, jcfg, jnp.asarray(x)),
           MODULE_TOL)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_ungated_experts_match_reference(act, exact):
    """Experts holding ``up``/``down`` only, through the gather dispatch at
    capacity factor 1.0 (pairs dropped) and exact: output and load-balance
    loss."""
    base = jax_get_arch("qwen3-moe-30b-a3b").reduced()
    jcfg = dataclasses.replace(base, activation=act,
                               moe=dataclasses.replace(base.moe, capacity_factor=1.0))
    cbase = get_arch("qwen3-moe-30b-a3b").reduced()
    cfg = dataclasses.replace(cbase, activation=act,
                              moe=dataclasses.replace(cbase.moe, capacity_factor=1.0))
    p = jmoe.init_moe(Builder("init", jax.random.PRNGKey(5)), jcfg)
    assert "gate" not in p
    layer = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict(_state(p))
    x = _x((3, 9, cfg.d_model), seed=6)
    want, jaux = jmoe.apply_moe(p, jcfg, jnp.asarray(x), dispatch="gather", exact=exact)
    got, aux = layer(torch.from_numpy(x), exact=exact)
    _close(got.numpy(), want, MODULE_TOL)
    _close(aux.numpy(), jaux, MODULE_TOL)


# ---- partial rotary attention ---------------------------------------------

def _attn_pair(arch, head_dim, seed=0):
    """One attention layer of ``arch``'s family at ``head_dim`` (StableLM's
    rotary_pct 0.25, Nemotron's 0.5, their GQA shapes narrowed)."""
    kw = dict(head_dim=head_dim, n_heads=4, n_kv_heads=4 if arch.startswith("stable") else 2)
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    p = jattn.init_attention(Builder("init", jax.random.PRNGKey(seed)), jcfg)
    attn = Attention(cfg, dtype=torch.float32, device="cpu")
    attn.load_state_dict(_state(p))
    inv = torch.as_tensor(rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta),
                          dtype=torch.float32)
    return jcfg, cfg, p, attn, inv


ROTARY = [("stablelm-1.6b", 64, 16), ("nemotron-4-340b", 192, 96)]


@pytest.mark.parametrize("arch,hd,rotated", ROTARY)
def test_partial_rotary_attention_full_matches_reference(arch, hd, rotated):
    """Prefill attention: output and the rotated K (the unrotated tail of
    each head passes through) within 1e-5."""
    jcfg, cfg, p, attn, inv = _attn_pair(arch, hd)
    assert 2 * inv.numel() == rotated
    B, S = 2, 20
    x = _x((B, S, cfg.d_model), seed=11)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, (jk, jv) = jattn.attention_full(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, (k, v) = attention_full(attn, cfg, torch.from_numpy(x),
                                 rope_tables(torch.from_numpy(pos.copy()), inv))
    _close(got.numpy(), want, MODULE_TOL)
    _close(k.numpy(), jk, MODULE_TOL)
    _close(v.numpy(), jv, MODULE_TOL)
    raw = (torch.from_numpy(x) @ attn.k.w).reshape(B, S, cfg.n_kv_heads, hd)
    assert torch.equal(k[..., rotated:], raw[..., rotated:])


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch,hd,rotated", ROTARY)
def test_partial_rotary_attention_decode_matches_reference(arch, hd, rotated, paged):
    """One decode step from the same caches: output and the cache written."""
    jcfg, cfg, p, attn, inv = _attn_pair(arch, hd, seed=1)
    rng = np.random.default_rng(12)
    B, Hk = 3, cfg.n_kv_heads
    lengths = np.asarray([5, 17, 9], np.int32)
    x = _x((B, 1, cfg.d_model), seed=13)
    rope = rope_tables(torch.from_numpy(lengths)[:, None], inv)
    if paged:
        P, ps, n_cols = 12, 8, 3
        pools = rng.normal(size=(2, P, ps, Hk, hd)).astype(np.float32)
        table = rng.permutation(P)[:B * n_cols].reshape(B, n_cols).astype(np.int32)
        jc = {"k": jnp.asarray(pools[0]), "v": jnp.asarray(pools[1]),
              "len": jnp.asarray(lengths)}
        want, jnew = jattn.attention_decode(p, jcfg, jnp.asarray(x), jc,
                                            flags={"kv_table": jnp.asarray(table)})
        k_cache = torch.zeros((P + 1, ps, Hk, hd))
        v_cache = torch.zeros_like(k_cache)
        k_cache[:P], v_cache[:P] = torch.from_numpy(pools[0]), torch.from_numpy(pools[1])
        got = attention_decode(attn, cfg, torch.from_numpy(x), k_cache, v_cache,
                               torch.from_numpy(lengths), torch.from_numpy(table), rope)
        k_cache, v_cache = k_cache[:P], v_cache[:P]
    else:
        bufs = rng.normal(size=(2, B, 24, Hk, hd)).astype(np.float32)
        jc = {"k": jnp.asarray(bufs[0]), "v": jnp.asarray(bufs[1]), "len": jnp.asarray(lengths)}
        want, jnew = jattn.attention_decode(p, jcfg, jnp.asarray(x), jc)
        k_cache, v_cache = torch.from_numpy(bufs[0].copy()), torch.from_numpy(bufs[1].copy())
        got = attention_decode(attn, cfg, torch.from_numpy(x), k_cache, v_cache,
                               torch.from_numpy(lengths), None, rope)
    _close(got.numpy(), want, MODULE_TOL)
    _close(k_cache.numpy(), jnew["k"], MODULE_TOL)
    _close(v_cache.numpy(), jnew["v"], MODULE_TOL)


# ---- the plain kernels at D = 192, G = 12 ---------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _arrs(rng, dtype, *shapes):
    """The same draws as a torch tensor and a jax array, rounded to dtype."""
    tdt, jdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy(), jdt)))
    return out


def _kernel_close(got, want, dtype):
    _close(got.float().numpy(), want, KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_d192_g12_matches_jax(dtype):
    """Causal GQA prefill, 24 heads on 2, a ragged length over 32-wide tiles."""
    rng = np.random.default_rng(192)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (2, 45, 24, 192), (2, 45, 2, 192),
                                      (2, 45, 2, 192))
    got = flash_attention_plain(q, k, v, causal=True, q_block=32, kv_block=32)
    assert got.dtype == q.dtype and got.shape == q.shape
    _kernel_close(got, jops._flash_jnp(jq, jk, jv, causal=True, window=None, q_block=32,
                                       kv_block=32, causal_skip=True), dtype)
    _kernel_close(got, flash_attention_pallas(jq, jk, jv, causal=True, q_block=32, kv_block=32,
                                              interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_at_d192_g12_matches_jax(dtype):
    """Pages of 16 in a shuffled pool, lengths on a page edge and inside one,
    sentinel entries past each length."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(193)
    B, S, H, Hk, D, ps = 3, 40, 24, 2, 192, 16
    (q, jq), (k, _), (v, _) = _arrs(rng, dtype, (B, 1, H, D), (B, S, Hk, D), (B, S, Hk, D))
    lengths = np.asarray([16, 23, 40], np.int32)
    n_tab, P = -(-S // ps), B * -(-S // ps) + 2
    phys = rng.permutation(P)[:B * n_tab].reshape(B, n_tab)
    k_pool = np.full((P, ps, Hk, D), 1e3, np.float32)
    v_pool = np.full_like(k_pool, 1e3)
    pad = np.zeros((B, n_tab * ps - S, Hk, D), np.float32)
    k_pool[phys.reshape(-1)] = np.concatenate([k.float().numpy(), pad], 1).reshape(-1, ps, Hk, D)
    v_pool[phys.reshape(-1)] = np.concatenate([v.float().numpy(), pad], 1).reshape(-1, ps, Hk, D)
    table = np.where(np.arange(n_tab)[None] * ps < lengths[:, None], phys, P).astype(np.int32)
    kp, vp = torch.from_numpy(k_pool).to(tdt), torch.from_numpy(v_pool).to(tdt)
    jkp, jvp = (jnp.asarray(t.float().numpy(), DTYPES[dtype][1]) for t in (kp, vp))
    got = paged_attention_plain(q, kp, vp, torch.from_numpy(table), torch.from_numpy(lengths))
    jt, jl = jnp.asarray(table), jnp.asarray(lengths)
    _kernel_close(got, jops._paged_jnp(jq, jkp, jvp, jt, jl), dtype)
    _kernel_close(got, paged_attention_pallas(jq, jkp, jvp, jt, jl, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_at_d192_g12_matches_jax(dtype):
    """Contiguous decode: lengths 0 (zeros), 1, ragged and the whole cache."""
    rng = np.random.default_rng(194)
    B, S, H, Hk, D = 4, 50, 24, 2, 192
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, 1, H, D), (B, S, Hk, D), (B, S, Hk, D))
    lengths = np.asarray([0, 1, 29, S], np.int32)
    got = decode_attention_plain(q, k, v, torch.from_numpy(lengths))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    jl = jnp.asarray(lengths)
    _kernel_close(got, jops._decode_jnp(jq, jk, jv, jl), dtype)
    _kernel_close(got, decode_attention_pallas(jq, jk, jv, jl, kv_block=16, interpret=True),
                  dtype)


# ---- the models ------------------------------------------------------------

_PAIRS: dict = {}


def _pair(arch):
    """(JAX model, its params, the port's model with the same weights)."""
    if arch not in _PAIRS:
        jcfg, cfg = _narrow(jax_get_arch(arch)), _narrow(get_arch(arch))
        jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
        jparams = jmodel.init(jax.random.PRNGKey(7))
        model = Model(cfg, device="cpu")
        model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        _PAIRS[arch] = (jmodel, jparams, model)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_maps_layernorm_and_ungated_leaves(arch):
    """Every leaf of the JAX tree lands unchanged in the port's state dict
    (strict load): LayerNorm's ``scale`` and ``bias`` in each block and the
    final norm, and Nemotron's ungated ``up``/``down`` with no ``gate``."""
    jmodel, jparams, model = _pair(arch)
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    cfg = model.cfg
    assert {"final_norm/scale", "final_norm/bias", "blocks/b0/n1/bias",
            "blocks/b0/n2/bias"} <= set(flat)
    mlp = {k for k in flat if "/mlp/" in k}
    want = {"blocks/b0/mlp/up/w", "blocks/b0/mlp/down/w"}
    assert mlp == (want if cfg.activation == "relu2" else want | {"blocks/b0/mlp/gate/w"})
    state = model.state_dict()
    for key in ("blocks/b0/n1/bias", "blocks/b0/mlp/up/w"):
        leaf = key[len("blocks/b0/"):].replace("/", ".")
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(state[f"blocks.{i}.{leaf}"].numpy(), flat[key][i])
    np.testing.assert_array_equal(state["final_norm.bias"].numpy(), flat["final_norm/bias"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """A right-padded prefill into a contiguous cache of ``max_len``, then
    three decode steps: logits within 1e-4, the cache rows too."""
    jmodel, jparams, model = _pair(arch)
    rng = np.random.default_rng(1)
    B, S, max_len = 3, 24, 30
    tokens = rng.integers(0, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 7, 16], np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  lengths=jnp.asarray(lengths))
    got, cache = model.prefill(torch.from_numpy(tokens), lengths=torch.from_numpy(lengths),
                               max_len=max_len)
    _close(got.numpy(), want, LOGIT_TOL)
    for step in range(3):
        tok = rng.integers(0, 259, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        _close(got.numpy(), want, LOGIT_TOL)
    for name in ("k", "v"):
        _close(cache[name].numpy(), jcache["blocks"]["b0"][name], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch):
    """Two paged decode steps from the same pools and table."""
    jmodel, jparams, model = _pair(arch)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    B, ps, n_cols, P = 4, 8, 4, 18
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pools = rng.normal(size=(2, L, P, ps, Hk, hd)).astype(np.float32)
    lengths = np.asarray([5, 17, 9, 21], np.int32)
    table = rng.permutation(P)[:B * n_cols].reshape(B, n_cols).astype(np.int32)
    jcache = {"blocks": {"b0": {"k": jnp.asarray(pools[0]), "v": jnp.asarray(pools[1]),
                                "len": jnp.asarray(np.tile(lengths, (L, 1)))}}}
    cache = model.init_paged_cache(P, ps, B)
    cache["k"][:, :P] = torch.from_numpy(pools[0])
    cache["v"][:, :P] = torch.from_numpy(pools[1])
    cache["len"][:] = torch.from_numpy(lengths)
    for step in range(2):
        tokens = rng.integers(0, 259, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tokens), jcache,
                                          table=jnp.asarray(table))
        got = model.decode_step(torch.from_numpy(tokens), cache, torch.from_numpy(table))
        _close(got.numpy(), want, LOGIT_TOL)


def _workload():
    """Six requests, two admission rounds on 4 slots: shared-prefix and
    mixed-length prompts, one identical pair."""
    sys_ = "system: answer tersely. "
    prompts = [sys_ + "same", sys_ + "same", sys_ + "q1 " + "ab" * 9, "x" * 40,
               sys_ + "q2", sys_ + "q3 " + "cd" * 4]
    return [(TOK.encode(p), m) for p, m in zip(prompts, (6, 9, 12, 5, 14, 8))]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_reference_engine(arch, paged):
    """Both engines serve the workload (4 slots, K = 4, page 8): streams,
    counters and occupancy identical."""
    jmodel, jparams, model = _pair(arch)
    kw = dict(max_slots=4, max_len=MAX_LEN, decode_block=4, paged=paged, page_size=8,
              eos_id=-1)
    ref = jengine.ServingEngine(jmodel, jparams, **kw)
    eng = engine.ServingEngine(model, device="cpu", **kw)
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    assert [r.out_tokens for r in r_got] == [r.out_tokens for r in r_ref]
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    assert eng.kv_occupancy() == ref.kv_occupancy()


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_path_matches_eager(arch, paged):
    """The engine's fused dispatch through ``GraphSet``'s keyed path (first
    call eager, then capture and replays, emulated on the CPU): streams,
    counters and the final cache identical to the eager body's."""
    _, _, model = _pair(arch)
    got = {}
    for leg in ("graphed", "eager"):
        eng = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, decode_block=4,
                                   paged=paged, page_size=8, eos_id=-1, device="cpu")
        if leg == "graphed":
            gs = eng._graphs = EmulatedGraphs()
        rs = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
        eng.serve(rs)
        got[leg] = ([r.out_tokens for r in rs], eng.n_decode_calls, eng.n_prefill_calls,
                    {k: v.clone() for k, v in eng.cache.items()})
    g, e = got["graphed"], got["eager"]
    assert g[:3] == e[:3]
    for k in g[3]:
        assert torch.equal(g[3][k], e[3][k]), k
    assert len(gs.graphs) >= 1 and gs.n_replays == g[1] - len(gs._warm) > 0


# ---- the launcher ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_reduced_arch_on_the_cpu(arch, capsys):
    """``serve engine --arch <arch> --device cpu``: on the CPU a config
    above 5e7 parameters is reduced, as in the JAX launcher."""
    from repro_torch.launch import serve as launcher

    for extra in ([], ["--contiguous"]):
        launcher.engine_main(["--arch", arch, *extra, "--device", "cpu", "--requests", "3",
                              "--batch-prompt", "2", "--max-new", "5"])
        out = capsys.readouterr().out
        assert f"{arch}-smoke: served 3/3 requests" in out, out


def test_card_launcher_refuses_weights_above_free_memory(monkeypatch):
    """On a card (free memory stubbed at 80 GB) full-width Nemotron-4-340B's
    682 GB of bf16 weights are refused before the init, naming --reduced;
    StableLM-2-1.6B's 3.29 GB pass; the CPU is not asked."""
    from repro_torch.launch import serve as launcher

    asked = []

    def mem_get_info(dev):
        asked.append(torch.device(dev).type)
        return 80 * 10**9, 80 * 10**9

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    with pytest.raises(SystemExit, match="--reduced"):
        launcher.check_fits(get_arch("nemotron-4-340b"), "cuda")
    launcher.check_fits(get_arch("stablelm-1.6b"), "cuda")
    launcher.check_fits(get_arch("nemotron-4-340b"), "cpu")
    assert asked == ["cuda", "cuda"]
    # the launcher itself stops there, before building the model on the card
    with pytest.raises(SystemExit, match="682.1 GB of bfloat16 weights"):
        launcher.engine_main(["--arch", "nemotron-4-340b", "--device", "cuda"])
