"""The port's mixture-of-experts models against the JAX package's, on the
CPU: ``reduced()`` Qwen3-30B-A3B (QK-norm, GQA, 8 experts top-2) and
Qwen1.5-MoE-A2.7B (QKV bias, a sigmoid-gated shared expert), in fp32,
with JAX's weights carried by the weight bridge.

Prefill and decode logits within 1e-4 of JAX's ``Model`` (paged and
contiguous decode); greedy streams, dispatch counters and KV occupancy
identical to JAX's ``ServingEngine`` in both layouts, at ``reduced()``'s
capacity factor 8 and at 1.0, where the admission prefills drop pairs
(the capacity counts the bucket's padding rows and positions, so both
engines must prefill the same (B, L)); ``Model.loss`` and every gradient,
the load-balance loss's included, within 1e-5 of ``jax.value_and_grad``
(relative for the loss, of each leaf's largest |gradient| otherwise); and
the engine's keyed graph path, capture emulated on the CPU, equal to the
eager body.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import moe
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine
from test_torch_engine import EmulatedGraphs

TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each leaf's largest |gradient|
ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
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


def _cfgs(arch, cf=None):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return jcfg, cfg


_PAIRS: dict = {}


def _pair(arch, cf=None, seed=0):
    """(JAX model, its params, the port's model with the same weights),
    built once per (arch, capacity factor, seed)."""
    key = (arch, cf, seed)
    if key not in _PAIRS:
        jcfg, cfg = _cfgs(arch, cf)
        jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
        jparams = jmodel.init(jax.random.PRNGKey(seed))
        model = Model(cfg, device="cpu")
        model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        _PAIRS[key] = (jmodel, jparams, model)
    return _PAIRS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_copy_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.family == "moe" and cfg.moe.capacity_factor == 8.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """A right-padded prefill into a contiguous cache of ``max_len``, then
    three decode steps (``exact`` dispatch): logits within 1e-4, the cache
    rows too."""
    jmodel, jparams, model = _pair(arch)
    rng = np.random.default_rng(1)
    B, S, max_len = 3, 24, 30
    tokens = rng.integers(0, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 7, 16], np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  lengths=jnp.asarray(lengths))
    got, cache = model.prefill(torch.from_numpy(tokens), lengths=torch.from_numpy(lengths),
                               max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for step in range(3):
        tok = rng.integers(0, 259, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL)


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
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")


def _workload():
    """Six requests, two admission rounds on 4 slots: shared-prefix and
    mixed-length prompts, one identical pair."""
    sys_ = "system: answer tersely. "
    prompts = [sys_ + "same", sys_ + "same", sys_ + "q1 " + "ab" * 9, "x" * 40,
               sys_ + "q2", sys_ + "q3 " + "cd" * 4]
    return [(TOK.encode(p), m) for p, m in zip(prompts, (6, 9, 12, 5, 14, 8))]


class _DropCount:
    """Counts the (token, slot) pairs the capacity dispatch drops, from the
    module's own routing functions, wrapped around ``dispatch_gather``."""

    def __init__(self, monkeypatch):
        self.pairs = 0
        inner = moe.dispatch_gather

        def counted(layer, xt, top_p, top_i, C):
            _, ranks = moe.pair_ranks(top_i)
            self.pairs += int((ranks >= C).sum())
            return inner(layer, xt, top_p, top_i, C)

        monkeypatch.setattr(moe, "dispatch_gather", counted)


@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_reference_engine(arch, paged, cf, monkeypatch):
    """Both engines serve the workload (4 slots, K = 4, page 8): streams,
    counters and occupancy identical.  At capacity factor 1.0 the
    admission prefills drop pairs (counted), and the streams still agree:
    the port prefills the JAX engine's (B, L), padding included."""
    jmodel, jparams, model = _pair(arch, cf)
    kw = dict(max_slots=4, max_len=MAX_LEN, decode_block=4, paged=paged, page_size=8,
              eos_id=-1)
    ref = jengine.ServingEngine(jmodel, jparams, **kw)
    eng = engine.ServingEngine(model, device="cpu", **kw)
    drops = _DropCount(monkeypatch)
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    assert [r.out_tokens for r in r_got] == [r.out_tokens for r in r_ref]
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    assert eng.kv_occupancy() == ref.kv_occupancy()
    assert (drops.pairs > 0) == (cf == 1.0), drops.pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``Model.loss`` (cross-entropy plus the layers' summed load-balance
    loss) and its gradient for every parameter, at capacity factor 1.0 so
    the training forward drops pairs too."""
    jmodel, jparams, model = _pair(arch, 1.0, seed=3)
    rng = np.random.default_rng(0)
    t = rng.integers(0, model.cfg.vocab_size, (4, 25)).astype(np.int32)
    labels = t[:, 1:].copy()
    labels[:, -3:] = -100
    batch = {"tokens": t[:, :-1], "labels": labels}
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = state_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    _, aux = model.forward(torch.from_numpy(batch["tokens"]))
    assert aux.item() > 0
    model.requires_grad_()
    try:
        params = dict(model.named_parameters())
        loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        model.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert set(jgrads) == set(params)
    for (n, _), g in zip(params.items(), grads):
        want = jgrads[n]
        scale = want.abs().max().item()
        err = (g - want).abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-12), f"{n}: {err:.3g} of {scale:.3g}"
    assert any("mlp.router" in n and g.abs().max() > 0 for n, g in zip(params, grads))


@pytest.mark.parametrize("paged", [True, False])
def test_graph_path_matches_eager(paged):
    """The engine's fused dispatch through ``GraphSet``'s keyed path (first
    call eager, then capture and replays, emulated on the CPU) on reduced
    Qwen3-30B-A3B: streams, counters and the final cache identical to the
    eager body's, with every dispatch after a key's first replayed."""
    _, _, model = _pair("qwen3-moe-30b-a3b", 1.0)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_reduced_moe_on_the_cpu(arch, capsys):
    """``serve engine --arch <moe> --reduced --device cpu`` serves every
    request; on the CPU a config above 5e7 parameters is reduced even
    without ``--reduced``, as in the JAX launcher."""
    from repro_torch.launch import serve as launcher

    for extra in (["--reduced"], []):
        launcher.engine_main(["--arch", arch, *extra, "--device", "cpu", "--requests", "3",
                              "--batch-prompt", "2", "--max-new", "5"])
        out = capsys.readouterr().out
        assert f"{arch}-smoke: served 3/3 requests" in out, out
