"""The port's RG-LRU hybrid (RecurrentGemma) against the JAX package's, on the
CPU: the RG-LRU scan's plain version, flash and decode attention at head
widths 128 and 256 under MQA with a sliding window and ring lengths, GeGLU,
the weight bridge's pattern groups and tails, and the reduced model's
prefill and greedy decode through ring caches.

Tolerances: the RG-LRU scan in float32 at 1e-5 and bfloat16 at 2e-2, as
``tests/test_kernels.py`` holds ``rglru_pallas`` to the oracle; attention
at 2e-5 / 2e-2, as ``tests/test_torch_kernels.py``; model logits and caches
at 1e-4 (absolute and relative), as ``tests/test_torch_model.py``; greedy
token streams identical.  Inputs are made with numpy from fixed seeds, and
weights cross from the JAX ``Model.init`` through the bridge.
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
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro.models.transformer import Model as JaxModel
from repro_torch.config import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.mlp import gelu
from repro_torch.models.rglru import causal_conv
from repro_torch.models.transformer import Model, RGLRUBlock
from repro_torch.serving.graphs import RecurrentDecoder


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "recurrentgemma-9b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _rglru_inputs(rng, B, T, W, gates):
    """x ~ N(0, 1); log-gates ``mild`` −|N(0, 0.5)| (as
    ``tests/test_kernels.py``), ``strong`` U(−20, 0), or ``near0`` within
    1e-6 of 0, where 1 − exp(2a) keeps only a few bits; a state ~ N(0, 1)."""
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    a_log = {"mild": lambda: -np.abs(0.5 * rng.normal(size=(B, T, W))),
             "strong": lambda: -rng.uniform(0.0, 20.0, (B, T, W)),
             "near0": lambda: -rng.uniform(0.0, 1e-6, (B, T, W))}[gates]()
    return x, a_log.astype(np.float32), rng.normal(size=(B, W)).astype(np.float32)


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("gates", ["mild", "strong", "near0"])
@pytest.mark.parametrize("T", [1, 33, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_matches_jax(dtype, T, gates, carried):
    """Against the token-by-token oracle, the associative-scan ``_rglru_jnp``
    and the Pallas kernel (interpret mode, chunk 32: T = 33 and 100 leave a
    ragged chunk); outputs and the final state."""
    rng = np.random.default_rng(T + len(gates) + 7 * carried)
    x, a_log, s0 = _rglru_inputs(rng, 2, T, 64, gates)
    xt = torch.from_numpy(x).to(TORCH[dtype])
    jx = jnp.asarray(xt.float().numpy(), JNP[dtype])
    state, jstate = (torch.from_numpy(s0), jnp.asarray(s0)) if carried else (None, None)
    h, h_t = rglru_plain(xt, torch.from_numpy(a_log), state)
    assert h.dtype == xt.dtype and h_t.dtype == torch.float32
    ja = jnp.asarray(a_log)
    for want_h, want_s in (jref.rglru_ref(jx, ja, state=jstate),
                           jops._rglru_jnp(jx, ja, jstate),
                           rglru_pallas(jx, ja, state=jstate, chunk=32, w_block=32,
                                        interpret=True)):
        _close(h, want_h, TOL[dtype])
        _close(h_t, want_s, TOL[dtype])


@pytest.mark.parametrize("gates", ["mild", "strong", "near0"])
def test_rglru_oracle_matches_jax_oracle(gates):
    rng = np.random.default_rng(40 + len(gates))
    x, a_log, s0 = _rglru_inputs(rng, 2, 37, 32, gates)
    h, h_t = ref.rglru_ref(*(torch.from_numpy(a) for a in (x, a_log, s0)))
    want_h, want_s = jref.rglru_ref(*(jnp.asarray(a) for a in (x, a_log, s0)))
    _close(h, want_h, TOL["float32"])
    _close(h_t, want_s, TOL["float32"])


def test_rglru_plain_chains_its_state():
    """Two halves with the state carried equal one run over the whole."""
    rng = np.random.default_rng(3)
    x, a_log, s0 = (torch.from_numpy(a) for a in _rglru_inputs(rng, 3, 50, 16, "mild"))
    h, h_t = rglru_plain(x, a_log, s0)
    h1, s1 = rglru_plain(x[:, :20], a_log[:, :20], s0)
    h2, s2 = rglru_plain(x[:, 20:], a_log[:, 20:], s1)
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    assert torch.equal(s2, h_t)


def test_rglru_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; the kernel
    wrapper refuses CPU tensors."""
    rng = np.random.default_rng(4)
    x, a_log, s0 = (torch.from_numpy(a) for a in _rglru_inputs(rng, 2, 5, 8, "mild"))
    before = rglru_cuda.launches
    for got, want in zip(ops.rglru_scan(x, a_log, s0), rglru_plain(x, a_log, s0)):
        assert torch.equal(got, want)
    assert rglru_cuda.launches == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_cuda(x, a_log, s0)


# ---------------------------------------------------------------------------
# attention at head widths 128 and 256
# ---------------------------------------------------------------------------

def _arrs(rng, dtype, *shapes):
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(TORCH[dtype])
        out.append((t, jnp.asarray(t.float().numpy(), JNP[dtype])))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [128, 256])
def test_flash_plain_wide_heads_mqa_window(D, dtype):
    """MQA (H = 4 on Hk = 1) with a window shorter than S and a ragged S,
    against ``_flash_jnp`` and the naive oracle."""
    rng = np.random.default_rng(D)
    B, S, H, Hk, win = 2, 45, 4, 1, 16
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))
    got = flash_attention_plain(q, k, v, causal=True, window=win, q_block=16, kv_block=16)
    _close(got, jops._flash_jnp(jq, jk, jv, causal=True, window=win, q_block=16, kv_block=16,
                                causal_skip=True), ATTN_TOL[dtype])
    _close(got, jref.mha_ref(jq, jk, jv, causal=True, window=win), ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [128, 256])
def test_decode_plain_wide_heads_ring_lengths(D, dtype):
    """One query token per row against a 32-slot ring under MQA (H = 4 on
    Hk = 1): ring lengths ``min(pos + 1, S_buf)`` below and at the ring's
    size, and a length-0 row, against ``_decode_jnp`` and, on the rows with
    keys (its softmax over no key is NaN), the oracle."""
    rng = np.random.default_rng(D + 1)
    B, S_buf, H, Hk = 4, 32, 4, 1
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, 1, H, D), (B, S_buf, Hk, D),
                                      (B, S_buf, Hk, D))
    pos = np.asarray([-1, 6, 31, 70])                     # the last has wrapped the ring
    lengths = np.minimum(pos + 1, S_buf).astype(np.int32)
    got = decode_attention_plain(q, k, v, torch.from_numpy(lengths))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, jops._decode_jnp(jq, jk, jv, jnp.asarray(lengths)), ATTN_TOL[dtype])
    _close(got[1:], jref.decode_attention_ref(jq[1:], jk[1:], jv[1:], jnp.asarray(lengths[1:])),
           ATTN_TOL[dtype])


# ---------------------------------------------------------------------------
# GeGLU and the causal conv
# ---------------------------------------------------------------------------

def test_gelu_is_jax_tanh_form():
    x = np.linspace(-10.0, 10.0, 4001, dtype=np.float32)
    got = gelu(torch.from_numpy(x))
    _close(got, jax.nn.gelu(jnp.asarray(x)), 1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (exact - got).abs().max().item() > 1e-4     # the erf form is not it


def test_causal_conv_matches_jax():
    from repro.models.rglru import _causal_conv as jax_causal_conv

    rng = np.random.default_rng(9)
    w, b = rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32)
    x, st = rng.normal(size=(2, 7, 8)).astype(np.float32), rng.normal(size=(2, 3, 8))
    st = st.astype(np.float32)
    for state in (None, st):
        got, got_st = causal_conv(torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x),
                                  None if state is None else torch.from_numpy(state))
        want, want_st = jax_causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
                                        None if state is None else jnp.asarray(state))
        _close(got, want, 1e-6)
        _close(got_st, want_st, 0.0)


# ---------------------------------------------------------------------------
# configs and the weight bridge
# ---------------------------------------------------------------------------

def _cfgs(n_layers=None):
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _pair(n_layers, seed=0):
    jcfg, cfg = _cfgs(n_layers)
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


def test_full_width_recurrentgemma_config():
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, tuple(cfg.block_pattern), cfg.window, cfg.lru_width,
            cfg.conv_width, cfg.activation, cfg.dtype) == \
        ("hybrid", 38, 4096, 16, 1, 256, 12_288, 256_000, ("rglru", "rglru", "local"), 2048,
         4096, 4, "geglu", "bfloat16")
    assert cfg.layer_kinds().count("rglru") == 26 and cfg.layer_kinds().count("local") == 12


def test_param_count_undercount_is_pinned():
    """The reference's ``ModelConfig.param_count`` counts 2·d·W + 2·W² for an
    RG-LRU block's recurrence, where the block holds three d×W projections
    (``in_gate``, ``in_rec``, ``out``), two W×W gates, the conv, its bias
    and ``lambda``: 10.008 B against the 10.445 B its ``Model`` holds.  The
    port's copy of the config keeps the same count; the port's ``Model``
    holds what the JAX ``Model`` holds (checked on the reduced config)."""
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert round(jcfg.param_count() / 1e9, 3) == 10.008
    held = JaxModel(jcfg).param_count()
    assert round(held / 1e9, 3) == 10.445
    W, d = cfg.lru_width, cfg.d_model
    assert held - jcfg.param_count() == 26 * (d * W + W)     # one d×W and one W per block
    jmodel, _, model = _pair(None)
    assert model.param_count() == jmodel.param_count()


@pytest.mark.parametrize("n_layers", [6, 8])
def test_bridge_maps_pattern_groups_and_tails(n_layers):
    """``blocks/b<s>`` leaves are stacked over the n_layers // 3 groups and
    land on layers 3·g + s; the 8-layer stack's ``rem0``/``rem1`` tail lands
    on layers 6 and 7.  Every port parameter is filled."""
    _, jparams, model = _pair(n_layers)
    state = model.state_dict()
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    seen = set()
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "blocks":
            slot, leaf = int(parts[1][1:]), ".".join(parts[2:])
            for g in range(arr.shape[0]):
                name = f"blocks.{3 * g + slot}.{leaf}"
                np.testing.assert_array_equal(state[name].numpy(), arr[g])
                seen.add(name)
        elif parts[0].startswith("rem"):
            name = f"blocks.{6 + int(parts[0][3:])}.{'.'.join(parts[1:])}"
            np.testing.assert_array_equal(state[name].numpy(), arr)
            seen.add(name)
        else:
            np.testing.assert_array_equal(state[key.replace("/", ".")].numpy(), arr)
            seen.add(key.replace("/", "."))
    assert seen == set(state)
    assert any(k.startswith("rem") for k in flat) == (n_layers == 8)
    kinds = model.cfg.layer_kinds()
    assert [isinstance(b, RGLRUBlock) for b in model.blocks] == [k == "rglru" for k in kinds]
    assert kinds[-2:] == (["rglru", "rglru"] if n_layers == 8 else ["rglru", "local"])
    assert "blocks.2.attn.q.w" in state and "blocks.0.rec.lambda" in state


def test_bridge_refuses_wrong_stacks():
    _, jparams, model = _pair(8)
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    cfg = model.cfg
    with pytest.raises(ValueError, match="groups"):          # one group too few
        state_from_jax({k: (v[:1] if k.startswith("blocks/") else v)
                        for k, v in flat.items()}, cfg)
    with pytest.raises(ValueError, match="slot"):            # a slot the pattern lacks
        state_from_jax({"blocks/b3/n1/scale": flat["blocks/b0/n1/scale"]}, cfg)
    with pytest.raises(ValueError, match="tail"):            # a tail the config lacks
        state_from_jax({"rem2/n1/scale": flat["rem0/n1/scale"]}, cfg)
    with pytest.raises(ValueError, match="no encoder"):     # an encoder leaf, no encoder
        state_from_jax({"encoder/norm/scale": flat["final_norm/scale"]}, cfg)


def test_rglru_init_follows_builder_scheme():
    _, cfg = _cfgs(None)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rec = model.blocks[0].rec
    assert torch.equal(rec.conv_b, torch.zeros_like(rec.conv_b))
    lam = getattr(rec, "lambda")
    assert lam.abs().max() < 1.0 and lam.std() > 0.3               # U(−1, 1)
    conv = torch.cat([b.rec.conv_w.flatten() for b in model.blocks if isinstance(b, RGLRUBlock)])
    assert abs(conv.std().item() - 0.5 / np.sqrt(cfg.conv_width)) < 0.03


# ---------------------------------------------------------------------------
# the reduced model: prefill past the window, then greedy decode past the wrap
# ---------------------------------------------------------------------------

def _cache_close(model, cache, jcache, atol=MODEL_TOL):
    """Every leaf of the port's mixed cache against the JAX tree, through the
    index map of ``Model.init_cache``."""
    cfg = model.cfg
    P = len(cfg.block_pattern)
    n_groups = cfg.n_layers // P
    for i, (kind, j) in enumerate(zip(cfg.layer_kinds(), model.cache_index)):
        jl = (jcache["blocks"][f"b{i % P}"] if i < n_groups * P else
              jcache[f"rem{i - n_groups * P}"])
        pick = (lambda a: np.asarray(a)[i // P]) if i < n_groups * P else np.asarray
        leaves = ("conv", "h") if kind == "rglru" else ("k", "v")
        for leaf in leaves:
            np.testing.assert_allclose(cache[leaf][j].numpy(), pick(jl[leaf]), atol=atol,
                                       rtol=atol, err_msg=f"layer {i} {leaf}")
        if kind != "rglru":
            np.testing.assert_array_equal(cache["len"].numpy(), pick(jl["len"]))


@pytest.mark.parametrize("n_layers", [6, 8])
def test_hybrid_prefill_and_greedy_decode_match_reference(n_layers):
    """Two prompts of 45 tokens, past the 32-slot window, into caches of
    max_len 64 (a ring of 32), then 40 greedy steps that wrap the ring twice:
    logits within 1e-4 at every step, streams identical, and every cache
    leaf close after prefill and at the end."""
    jmodel, jparams, model = _pair(n_layers)
    tokens = np.random.default_rng(n_layers).integers(0, 512, (2, 45)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), 64)
    got, cache = model.prefill(torch.from_numpy(tokens), max_len=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    assert cache["k"].shape[2] == 32 and cache["h"].dtype == torch.float32
    _cache_close(model, cache, jcache)
    step = jax.jit(jmodel.decode_step)
    j_tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
    t_tok = got[:, 0].argmax(-1).to(torch.int32)[:, None]
    j_stream, t_stream = [j_tok], [t_tok.numpy()]
    for i in range(40):
        want, jcache = step(jparams, jnp.asarray(j_tok), jcache)
        got = model.decode_step(t_tok, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=f"step {i}")
        j_tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        t_tok = got[:, 0].argmax(-1).to(torch.int32)[:, None]
        j_stream.append(j_tok)
        t_stream.append(t_tok.numpy())
    np.testing.assert_array_equal(np.concatenate(t_stream, 1), np.concatenate(j_stream, 1))
    _cache_close(model, cache, jcache)
    np.testing.assert_array_equal(cache["len"].numpy(), [85, 85])


def test_hybrid_fused_decode_in_place_matches_reference():
    """``RecurrentDecoder`` on the reduced hybrid: three calls of 8 greedy
    steps from a 45-token prefill into a 32-slot ring, so the ring wraps:
    the streams are JAX's greedy streams, every cache leaf matches JAX's
    after the 24 steps, and every cache tensor keeps its storage."""
    jmodel, jparams, model = _pair(8)
    tokens = np.random.default_rng(9).integers(0, 512, (2, 45)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), 64)
    got, cache = model.prefill(torch.from_numpy(tokens), max_len=64)
    dec = RecurrentDecoder(model, decode_block=8)
    dec.start(cache, got[:, 0].argmax(-1).to(torch.int32))
    ptrs = {k: v.data_ptr() for k, v in dec.cache(2).items()}
    stream = torch.cat([dec().clone() for _ in range(3)]).T.numpy()
    step = jax.jit(jmodel.decode_step)
    tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
    j_stream = []
    for _ in range(24):
        want, jcache = step(jparams, jnp.asarray(tok), jcache)
        tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        j_stream.append(tok)
    np.testing.assert_array_equal(stream, np.concatenate(j_stream, 1))
    _cache_close(model, dec.cache(2), jcache)
    np.testing.assert_array_equal(dec.cache(2)["len"].numpy(), [69, 69])
    assert {k: v.data_ptr() for k, v in dec.cache(2).items()} == ptrs


def test_hybrid_cache_layout_and_refusals():
    _, _, model = _pair(8)
    cfg = model.cfg
    cache = model.init_cache(3, 100)
    assert cache["k"].shape == (2, 3, cfg.window, cfg.n_kv_heads, cfg.head_dim)
    assert cache["conv"].shape == (6, 3, cfg.conv_width - 1, cfg.lru_width)
    assert cache["h"].shape == (6, 3, cfg.lru_width) and cache["h"].dtype == torch.float32
    assert model.init_cache(3, 20)["k"].shape[2] == 20           # ring of min(window, max_len)
    assert model.cache_index == [0, 1, 0, 2, 3, 1, 4, 5]
    tokens = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        model.prefill(tokens, lengths=torch.tensor([4, 3, 2]))
    with pytest.raises(ValueError, match="paged"):
        model.decode_step(tokens[:, :1], cache, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged"):
        model.init_paged_cache(8, 16, 3)
    for pattern in (("rglru",), ("local",), ("rglru", "local", "rwkv")):   # not hybrids
        with pytest.raises(NotImplementedError, match="blocks"):
            Model(dataclasses.replace(cfg, block_pattern=pattern), device="cpu")
