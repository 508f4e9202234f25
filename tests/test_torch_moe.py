"""The port's mixture-of-experts layer and QK-norm attention against the JAX
package, on the CPU.

``repro_torch.models.moe.MoE`` against ``repro.models.moe.apply_moe`` with
the same weights (the JAX ``init_moe`` tree, carried by name) and inputs
drawn with numpy from fixed seeds, in fp32: outputs within 1e-5 and the
load-balance loss within 1e-6, at both dispatches (``gather`` and
``dense``), with and without the shared expert, at the reduced configs'
capacity factor 8 and at 1.0, where pairs are dropped (and the same pairs
as in JAX); ties among router logits resolved as ``jax.lax.top_k`` does;
the chunked dispatch and ``exact=True``; gradients within 1e-5 of each
leaf's largest.  Then QK-norm attention against JAX's ``attention_full``
and ``attention_decode`` (paged and contiguous) within 1e-5, the weight
bridge over the MoE leaves, and the configs' ``param_count`` undercount,
which the port's copy keeps as the reference has it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.config import MoEConfig as JaxMoEConfig
from repro.config import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.layers import Builder
from repro_torch.config import ModelConfig, MoEConfig, ShardingConfig, get_arch
from repro_torch.models import moe
from repro_torch.models.attention import Attention, attention_decode, attention_full
from repro_torch.models.bridge import flatten_tree, state_from_jax
from repro_torch.models.layers import rope_freqs, rope_tables
from repro_torch.models.transformer import Model

OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-5          # of each leaf's largest |gradient|
ATTN_TOL = 1e-5



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: under the parallel test workers a
    thread pool a process costs these small models several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(E=8, k=2, d_shared=0, cf=8.0, d=32, **extra):
    kw = dict(name="m", family="moe", n_layers=2, d_model=d, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, dtype="float32", **extra)
    m = dict(n_experts=E, top_k=k, d_expert=16, d_shared=d_shared, capacity_factor=cf)
    return (JaxModelConfig(**kw, moe=JaxMoEConfig(**m)),
            ModelConfig(**kw, moe=MoEConfig(**m)))


def _state(tree):
    return {k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in flatten_tree(jax.tree.map(np.asarray, tree)).items()}


def _pair(dispatch="gather", seed=0, chunk_tokens=65_536, **cfg_kw):
    jcfg, cfg = _cfgs(**cfg_kw)
    p = jmoe.init_moe(Builder("init", jax.random.PRNGKey(seed)), jcfg)
    layer = moe.MoE(cfg, dtype=torch.float32, device="cpu", dispatch=dispatch,
                    chunk_tokens=chunk_tokens)
    layer.load_state_dict(_state(p))
    return jcfg, p, layer


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dropped(top_i, E, C):
    flat_e, ranks = jmoe._pair_ranks(jnp.asarray(top_i), E)
    return set(np.nonzero(np.asarray(ranks) >= C)[0].tolist())


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("d_shared", [0, 48])
@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_layer_matches_reference(dispatch, d_shared, cf):
    """Outputs within 1e-5 and aux within 1e-6; at capacity factor 1.0 the
    port drops exactly the (token, slot) pairs JAX drops, and some."""
    jcfg, p, layer = _pair(dispatch, d_shared=d_shared, cf=cf)
    x = _x((4, 16, 32))
    want, waux = jmoe.apply_moe(p, jcfg, jnp.asarray(x), dispatch)
    got, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(aux.item() - float(waux)) <= AUX_TOL
    # the routing: top-k and the dropped pairs, port against JAX
    xt = torch.from_numpy(x).reshape(-1, 32)
    probs = torch.softmax((xt @ layer.router).float(), dim=-1)
    _, top_i = moe.top_k_stable(probs, 2)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 32) @ p["router"], axis=-1)
    _, jtop_i = jax.lax.top_k(jprobs, 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    C = moe.capacity(layer.cfg.moe, 64)
    _, ranks = moe.pair_ranks(top_i)
    dropped = set(np.nonzero(ranks.numpy() >= C)[0].tolist())
    assert dropped == _dropped(np.asarray(jtop_i), 8, C)
    assert (len(dropped) > 0) == (cf == 1.0)


@pytest.mark.parametrize("E,k,T", [(8, 2, 64), (60, 4, 37), (128, 8, 16)])
def test_pair_ranks_match_reference(E, k, T):
    """Ranks within each expert in (token, slot) order, on routing with many
    pairs an expert (a skewed draw), against JAX's ``_pair_ranks``."""
    rng = np.random.default_rng(E + k + T)
    top_i = np.stack([rng.choice(E, k, replace=False, p=np.linspace(1, 3, E) / np.linspace(
        1, 3, E).sum()) for _ in range(T)]).astype(np.int32)
    flat_e, ranks = moe.pair_ranks(torch.from_numpy(top_i).long())
    jflat, jranks = jmoe._pair_ranks(jnp.asarray(top_i), E)
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))


def test_tied_router_logits_pick_the_reference_experts():
    """A router whose columns repeat in pairs and a bf16 input: logits tie
    exactly, and the stable top-k takes the lower expert first, as
    ``jax.lax.top_k``; the layer's output follows JAX's in bf16 too."""
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = jmoe.init_moe(Builder("init", jax.random.PRNGKey(4)), jcfg)
    r = np.array(p["router"].astype(jnp.float32))
    r[:, 4:] = r[:, :4]                                   # expert j ties expert j + 4
    p["router"] = jnp.asarray(r, jnp.bfloat16)
    layer = moe.MoE(cfg, dtype=torch.bfloat16, device="cpu")
    layer.load_state_dict(state_from_jax({"router": p["router"], "gate": p["gate"],
                                          "up": p["up"], "down": p["down"]}, cfg))
    x = _x((2, 16, 32), seed=5)
    xt = jnp.asarray(x, jnp.bfloat16).reshape(-1, 32)
    jprobs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    jtop_p, jtop_i = jax.lax.top_k(jprobs, 2)
    probs = torch.softmax((torch.from_numpy(x).to(torch.bfloat16).reshape(-1, 32)
                           @ layer.router).float(), dim=-1)
    top_p, top_i = moe.top_k_stable(probs, 2)
    assert np.all(np.asarray(jtop_p)[:, 0] == np.asarray(jtop_p)[:, 1])   # every row ties
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    assert (top_i[:, 0] < top_i[:, 1]).all()
    want, _ = jmoe.apply_moe(p, jcfg, jnp.asarray(x, jnp.bfloat16))
    got, _ = layer(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_chunked_dispatch_matches_reference(dispatch):
    """T = 64 tokens in chunks of 16, capacity per chunk, at factor 1.0."""
    jcfg, p, layer = _pair(dispatch, cf=1.0, chunk_tokens=16)
    x = _x((4, 16, 32), seed=2)
    want, waux = jmoe.apply_moe(p, jcfg, jnp.asarray(x), dispatch, chunk_tokens=16)
    got, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(aux.item() - float(waux)) <= AUX_TOL
    whole, _ = jmoe.apply_moe(p, jcfg, jnp.asarray(x), dispatch)
    assert np.abs(np.asarray(whole) - np.asarray(want)).max() > 1e-4   # chunks drop otherwise


@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_exact_dispatch_matches_reference(dispatch):
    """``exact=True``: capacity T, nothing dropped even at factor 0.25."""
    jcfg, p, layer = _pair(dispatch, cf=0.25, d_shared=48)
    x = _x((8, 1, 32), seed=3)
    want, _ = jmoe.apply_moe(p, jcfg, jnp.asarray(x), dispatch, exact=True)
    got, _ = layer(torch.from_numpy(x), exact=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)
    dropped, _ = layer(torch.from_numpy(x))
    assert (dropped - got).abs().max().item() > 1e-4


@pytest.mark.parametrize("d_shared", [0, 48])
def test_layer_gradients_match_reference(d_shared):
    """d(sum(out²) + aux) for every parameter and the input, at capacity
    factor 1.0 (dropped pairs carry no gradient)."""
    jcfg, p, layer = _pair(cf=1.0, d_shared=d_shared, seed=6)
    x = _x((2, 16, 32), seed=7)

    def jloss(p_, x_):
        o, aux = jmoe.apply_moe(p_, jcfg, x_)
        return jnp.sum(o * o) + aux

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    layer.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = layer(xt)
    loss = (out * out).sum() + aux
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [xt, *params.values()])
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    want = {"x": torch.from_numpy(np.array(jgx)), **_state(jgp)}
    assert set(want) == {"x", *params}
    for name, g in zip(["x", *params], grads):
        scale = want[name].abs().max().item()
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-12), f"{name}: {err:.3g} of {scale:.3g}"


def test_ep_dispatch_raises_and_unknown_dispatch_refused():
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    with pytest.raises(NotImplementedError, match="mesh"):
        Model(cfg, ShardingConfig(moe_dispatch="ep"), device="cpu")
    with pytest.raises(ValueError, match="moe_dispatch"):
        Model(cfg, ShardingConfig(moe_dispatch="scatter"), device="cpu")
    assert Model(cfg, ShardingConfig(moe_dispatch="dense"), device="cpu").blocks[0].mlp.dispatch \
        == "dense"


def test_decode_dispatch_shapes_do_not_depend_on_routing():
    """The decode step's dispatch (``exact=True``) makes tensors whose
    shapes the input shapes fix, whatever the routing: a captured graph
    can replay it.  (That it reads nothing back to the host shows on the
    card, where a sync inside a capture fails the capture.)"""
    jcfg, p, layer = _pair(cf=1.0)
    shapes = set()
    for seed in range(4):
        x = torch.from_numpy(_x((8, 1, 32), seed=seed))
        top_i = moe.top_k_stable(torch.softmax(x.reshape(8, 32) @ layer.router, -1), 2)[1]
        slot = moe._slots(top_i, 8, 8)
        shapes.add((tuple(slot.shape), tuple(layer(x, exact=True)[0].shape)))
    assert shapes == {((16,), (8, 1, 32))}


# ---- QK-norm attention ----------------------------------------------------

def _attn_pair(seed=0):
    jcfg = dataclasses.replace(jax_get_arch("qwen3-moe-30b-a3b").reduced(), n_heads=4,
                               n_kv_heads=2)
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(), n_heads=4, n_kv_heads=2)
    p = jattn.init_attention(Builder("init", jax.random.PRNGKey(seed)), jcfg)
    # scales away from one, so the norm's scale is exercised
    rng = np.random.default_rng(seed + 10)
    for name in ("q_norm", "k_norm"):
        p[name] = jnp.asarray(rng.uniform(0.5, 1.5, p[name].shape).astype(np.float32))
    attn = Attention(cfg, dtype=torch.float32, device="cpu")
    attn.load_state_dict(_state(p))
    inv = torch.as_tensor(rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta),
                          dtype=torch.float32)
    return jcfg, cfg, p, attn, inv


def test_qk_norm_parameters_follow_the_reference():
    jcfg, cfg, p, attn, _ = _attn_pair()
    assert {"q_norm", "k_norm"} <= set(p) and {"q_norm", "k_norm"} <= set(attn.state_dict())
    fresh = Attention(cfg, dtype=torch.float32, device="cpu")
    fresh.init(torch.Generator().manual_seed(0))
    assert torch.equal(fresh.q_norm, torch.ones(cfg.head_dim))
    plain = Attention(dataclasses.replace(cfg, qk_norm=False), dtype=torch.float32, device="cpu")
    assert "q_norm" not in plain.state_dict()


def test_qk_norm_attention_full_matches_reference():
    jcfg, cfg, p, attn, inv = _attn_pair()
    B, S = 2, 24
    x = _x((B, S, cfg.d_model), seed=11)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, (jk, jv) = jattn.attention_full(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, (k, v) = attention_full(attn, cfg, torch.from_numpy(x),
                                 rope_tables(torch.from_numpy(pos.copy()), inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_qk_norm_attention_decode_matches_reference(paged):
    """One decode step from the same caches: outputs and the cache written."""
    jcfg, cfg, p, attn, inv = _attn_pair(seed=1)
    rng = np.random.default_rng(12)
    B, Hk, hd = 3, cfg.n_kv_heads, cfg.head_dim
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
        S = 24
        bufs = rng.normal(size=(2, B, S, Hk, hd)).astype(np.float32)
        jc = {"k": jnp.asarray(bufs[0]), "v": jnp.asarray(bufs[1]), "len": jnp.asarray(lengths)}
        want, jnew = jattn.attention_decode(p, jcfg, jnp.asarray(x), jc)
        k_cache, v_cache = torch.from_numpy(bufs[0].copy()), torch.from_numpy(bufs[1].copy())
        got = attention_decode(attn, cfg, torch.from_numpy(x), k_cache, v_cache,
                               torch.from_numpy(lengths), None, rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(k_cache.numpy(), np.asarray(jnew["k"]), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    np.testing.assert_allclose(v_cache.numpy(), np.asarray(jnew["v"]), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


# ---- configs, the bridge and the parameter count --------------------------

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
# the reference's ModelConfig.param_count against the initialized tree: it
# leaves out the shared expert's gate_proj (d a layer) and the QK-norm
# scales (2 · head_dim a layer)
PARAMS = {"qwen3-moe-30b-a3b": (30_532_110_336, 30_532_122_624),
          "qwen2-moe-a2.7b": (14_315_735_040, 14_315_784_192)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_copy_and_param_count_undercount(arch):
    """The copy equals the reference field for field; both configs'
    ``param_count`` keep the reference's undercount, and the model's own
    count (its parameters, as JAX's ``Model.param_count`` counts its tree's
    leaves) holds the rest.  Counted on the ``meta`` device: no memory."""
    from repro.models.transformer import Model as JaxModel

    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    said, held = PARAMS[arch]
    assert cfg.param_count() == jcfg.param_count() == said
    assert JaxModel(jcfg).param_count() == held
    model = Model(cfg, device="meta")
    # the vocab is padded to a multiple of 32: 151,936 already is one
    assert model.param_count() == held
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    assert held - said == L * ((d if cfg.moe.d_shared else 0) + (2 * hd if cfg.qk_norm else 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_maps_every_moe_leaf(arch):
    """Every leaf of the JAX tree of a reduced MoE model, the stacked
    experts (n_groups, E, d, f) included, lands unchanged in the port's
    state dict under its own name, and nothing else is there."""
    from repro.config import ShardingConfig as JaxShardingConfig
    from repro.models.transformer import Model as JaxModel

    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jparams = JaxModel(jcfg, JaxShardingConfig(remat="none")).init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    state = state_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    model.load_state_dict(state)              # strict: same keys both ways
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    mlp = {k for k in flat if "/mlp/" in k}
    want = {"blocks/b0/mlp/router", "blocks/b0/mlp/gate", "blocks/b0/mlp/up",
            "blocks/b0/mlp/down"}
    if cfg.moe.d_shared:
        want |= {f"blocks/b0/mlp/shared/{n}" for n in ("gate/w", "up/w", "down/w", "gate_proj")}
    assert mlp == want
    for key in sorted(mlp) + (["blocks/b0/attn/q_norm"] if cfg.qk_norm else []):
        leaf = key[len("blocks/b0/"):].replace("/", ".")
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(model.state_dict()[f"blocks.{i}.{leaf}"].numpy(),
                                          flat[key][i])
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    assert flat["blocks/b0/mlp/gate"].shape == (cfg.n_layers, E, d, f)
    assert model.blocks[0].mlp.down.shape == (E, f, d)
