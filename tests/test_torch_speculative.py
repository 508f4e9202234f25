"""The port's routed speculative decoding against the JAX package's, on the
CPU, and the pieces under it: ``Model.decode_span``, the span attention
entry points, the paged decode's plain version at head_dim 128 and the
``qwen1.5-4b`` config.

A tiny-m target (the JAX init of seed 3, carried across by the weight
bridge) is drafted for by tiny-s (seed 5, another width and depth) and by
itself (the accept-all case), as ``tests/test_speculative.py`` sets up its
drafts; that file's pool-member surface test is left out, since
``serving/pool.py`` is not ported.  The emitted streams must equal the
target-only engine's, and the JAX ``SpeculativeEngine``'s streams and
counters, greedy and sampled.

The paged span masks sentinel pages, as the port's paged kernel and plain
version do; the JAX package's ``paged_span_attention`` clips a sentinel to
page P−1 (``ROADMAP.md`` §3's deliberate divergence), so the two differ on a
retired row only, which the engines never read.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import EmulatedGraphs

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro.serving.generation import GenerationConfig as JaxGenerationConfig
from repro.serving.speculative import SpeculativeEngine as JaxSpeculativeEngine
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine
from repro_torch.serving.generation import GenerationConfig
from repro_torch.serving.speculative import SpeculativeEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOK = ByteTokenizer()
MAX_LEN = 160
SYS = "system: you are a terse assistant; answer every query in order. "
TOL = 1e-4
COUNTERS = ("n_rounds", "n_drafted", "n_accepted", "n_bonus", "n_decode_calls",
            "n_decode_steps", "n_prefill_calls")


def _pair(cfg_name, seed, jcfg=None, cfg=None):
    jcfg = jcfg or jax_get_arch(cfg_name)
    cfg = cfg or get_arch(cfg_name)
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def models():
    """The tiny-m target and the tiny-s draft, each in both frameworks."""
    return {"target": _pair("tiny-m", 3), "small": _pair("tiny-s", 5)}


def _requests(mod, gen_cls, sampled=False):
    """``tests/test_speculative.py``'s workload: a shared prefix, varying
    lengths and budgets; sampled, a seed and the knobs a request."""
    out = []
    for i in range(5):
        p = SYS + f"query number {i} " + "ab" * (4 * i)
        g = None
        if sampled:
            g = gen_cls(max_new=8 + 4 * i, temperature=0.8, top_k=50, top_p=0.95, seed=7 + i)
        out.append(mod.Request(rid=i, tokens=TOK.encode(p), max_new=8 + 4 * i, gen=g))
    return out


def _port_requests(sampled=False):
    return _requests(engine, GenerationConfig, sampled)


def _spec(models, kind, slots=4, **kw):
    draft = models["target" if kind == "identical" else "small"][2]
    kw = {"max_len": MAX_LEN, "spec_k": 4, "page_size": 16, "eos_id": -1, **kw}
    return SpeculativeEngine(models["target"][2], draft, max_slots=slots, device="cpu", **kw)


def _counters(eng):
    return tuple(getattr(eng, c) for c in COUNTERS) + (eng.kv_occupancy(),)


@pytest.fixture(scope="module")
def target_only(models):
    """The target alone, greedy and sampled: the reference streams."""
    out = {}
    for sampled in (False, True):
        eng = engine.ServingEngine(models["target"][2], max_slots=4, max_len=MAX_LEN,
                                   decode_block=5, paged=True, page_size=16, eos_id=-1,
                                   device="cpu")
        reqs = _port_requests(sampled)
        eng.serve(reqs)
        out[sampled] = [r.out_tokens for r in reqs]
    return out


def _serve_both(eng, reqs_of):
    """Greedy then sampled on one engine: the streams and counters after each."""
    out = []
    for sampled in (False, True):
        reqs = reqs_of(sampled)
        eng.serve(reqs)
        out.append(([r.out_tokens for r in reqs], _counters(eng)))
    return out


@pytest.fixture(scope="module")
def served(models):
    """Each draft, on 4 slots: the port's and the JAX engine's serves."""
    jt_model, jt_params, _ = models["target"]
    out = {}
    for kind in ("identical", "small"):
        jd_model, jd_params, _ = models["target" if kind == "identical" else "small"]
        ref = JaxSpeculativeEngine(jt_model, jt_params, jd_model, jd_params, max_slots=4,
                                   max_len=MAX_LEN, spec_k=4, page_size=16, eos_id=-1)
        eng = _spec(models, kind)
        out[kind] = dict(
            jax=_serve_both(ref, lambda s: _requests(jengine, JaxGenerationConfig, s)),
            port=_serve_both(eng, _port_requests), engine=eng)
    return out


@pytest.mark.parametrize("kind", ["identical", "small"])
def test_streams_and_counters_match_target_only_and_jax(served, target_only, kind):
    """Greedy then sampled on one engine: the streams are the target's own
    and the JAX engine's, and every counter and ``kv_occupancy()`` equal the
    JAX engine's after each serve."""
    got = served[kind]
    for sampled, ((streams, counters), (j_streams, j_counters)) in enumerate(
            zip(got["port"], got["jax"])):
        assert streams == target_only[bool(sampled)], f"sampled={bool(sampled)}"
        assert streams == j_streams
        assert counters == j_counters
    eng = got["engine"]
    for side in (eng.target, eng.draft):
        side.kv.alloc.check(tables=side.kv.slot_pages)
        assert side.kv.alloc.pages_in_use == 0


@pytest.mark.parametrize("sampled", [False, True])
def test_one_slot_streams_match_target_only(models, target_only, sampled):
    """One slot: every request admitted alone, the self-draft accepting
    windows whole."""
    spec = _spec(models, "identical", slots=1)
    reqs = _port_requests(sampled)
    spec.serve(reqs)
    assert [r.out_tokens for r in reqs] == target_only[sampled]


def test_identical_draft_accepts_nearly_everything(served):
    """Same weights on both sides: every comparison matches; the rate dips
    below 1 only because limit-cut last windows count their unused
    proposals."""
    spec = served["identical"]["engine"]
    assert spec.accept_rate() > 0.8
    assert spec.n_bonus > 0


def test_counters_account_for_every_round(models):
    spec = _spec(models, "small")
    reqs = _port_requests()
    spec.serve(reqs)
    n_tok = sum(len(r.out_tokens) for r in reqs)
    assert spec.n_rounds > 0
    assert spec.n_drafted % spec.spec_k == 0
    assert 0 <= spec.n_accepted <= spec.n_drafted
    # every token is a first token of admission, an accepted draft, or the
    # one mismatch or bonus token of a slot-round
    assert spec.n_accepted + spec.n_bonus <= n_tok
    assert n_tok <= spec.n_accepted + spec.n_drafted // spec.spec_k + len(reqs)
    assert spec.draft.n_decode_calls == spec.target.n_decode_calls == spec.n_rounds
    assert spec.draft.n_decode_steps == spec.n_rounds * (spec.spec_k + 1)


def test_eos_retirement_matches_target_only(models, target_only):
    """A reachable EOS retires each request on the target-only engine's
    token, also in the middle of an accepted window."""
    flat = [t for w in target_only[False] for t in w[1:]]
    eos = max(set(flat), key=flat.count)
    ref = engine.ServingEngine(models["target"][2], max_slots=4, max_len=MAX_LEN,
                               decode_block=5, paged=True, page_size=16, eos_id=eos,
                               device="cpu")
    r1 = _port_requests()
    ref.serve(r1)
    spec = _spec(models, "small", eos_id=eos)
    r2 = _port_requests()
    spec.serve(r2)
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in r2]
    assert any(eos in r.out_tokens for r in r2), "the workload must hit EOS"


@pytest.mark.parametrize("k", [1, 3, 8])
def test_spec_k_sweep_preserves_stream(models, target_only, k):
    spec = _spec(models, "small", spec_k=k)
    reqs = _port_requests()
    spec.serve(reqs)
    assert [r.out_tokens for r in reqs] == target_only[False]


def test_generate_text_matches_plain_engine(models):
    plain = engine.ServingEngine(models["target"][2], max_slots=2, max_len=MAX_LEN,
                                 decode_block=5, paged=True, page_size=16, device="cpu")
    spec = _spec(models, "small", slots=2, eos_id=ByteTokenizer.eos)
    prompts = ["hello there", "speculate on this"]
    assert spec.generate_text(prompts, max_new=12) == plain.generate_text(prompts, max_new=12)
    occ = spec.kv_occupancy()
    assert occ["kv_bytes"] == occ["draft_kv_bytes"] == 0
    assert occ["peak_kv_bytes"] > spec.target.kv_occupancy()["peak_kv_bytes"]
    with pytest.raises(ValueError, match="spec_k"):
        _spec(models, "small", spec_k=0)
    other = Model(dataclasses.replace(get_arch("tiny-s"), vocab_size=300), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(models["target"][2], other, device="cpu")


def _logged(run, log):
    """``run`` with every key it is called with appended to ``log``."""
    def wrapper(key, body):
        log.append(key)
        return run(key, body)
    return wrapper


def test_graph_path_replays_keys_out_of_capture_order(models):
    """Both dispatches through ``GraphSet``'s keyed path, capture emulated
    on the CPU: requests of several lengths, two sampled, served twice on
    one engine, so the (table columns, ``sample``) key changes inside a
    serve and the second serve replays keys captured before the first
    serve's last.  Streams and counters are the eager body's; replays are
    every dispatch but each key's first."""
    def reqs():
        rs = _port_requests()
        for r in rs[:2]:
            r.gen = GenerationConfig(max_new=r.max_new, temperature=0.8, top_k=20, top_p=0.9,
                                     seed=50 + r.rid)
        rs[4].max_new = 110
        return rs

    got, keys = {}, {"draft": [], "target": []}
    for leg in ("graphed", "eager"):
        spec = _spec(models, "identical")
        if leg == "graphed":
            for side in ("draft", "target"):
                gs = getattr(spec, side)._graphs = EmulatedGraphs()
                gs.run = _logged(gs.run, keys[side])
        got[leg] = []
        for _ in range(2):
            rs = reqs()
            spec.serve(rs)
            got[leg].append([r.out_tokens for r in rs])
        got[leg].append(_counters(spec))
        if leg == "graphed":
            graphed = spec
    assert got["graphed"] == got["eager"]
    for side in ("draft", "target"):
        gs, log = getattr(graphed, side)._graphs, keys[side]
        captured = list(dict.fromkeys(log))
        assert list(gs.graphs) == captured and len(captured) >= 3
        assert {key[1] for key in captured} == {True, False}
        assert gs.n_replays == len(log) - len(captured)
        assert captured.index(log[len(log) // 2]) < len(captured) - 1


# ---------------------------------------------------------------------------
# decode_span and the span attention entry points
# ---------------------------------------------------------------------------

def _paged_setup(model, rng, lengths, S, retired=()):
    """Pools of random K/V, a table mapping every page the next S writes
    touch (a retired row all sentinels), in both frameworks' layouts."""
    cfg = model.cfg
    B, ps, n_cols = len(lengths), 8, 6
    P = B * n_cols + 2
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pools = rng.normal(size=(2, L, P, ps, Hk, hd)).astype(np.float32)
    phys = rng.permutation(P)[:B * n_cols].reshape(B, n_cols)
    table = np.where(np.arange(n_cols)[None] * ps < (lengths + S)[:, None], phys, P)
    table[list(retired)] = P
    table = table.astype(np.int32)
    jcache = {"blocks": {"b0": {"k": jnp.asarray(pools[0]), "v": jnp.asarray(pools[1]),
                                "len": jnp.asarray(np.tile(lengths, (L, 1)))}}}
    cache = model.init_paged_cache(P, ps, B)
    cache["k"][:, :P] = torch.from_numpy(pools[0]).to(model.dtype)
    cache["v"][:, :P] = torch.from_numpy(pools[1]).to(model.dtype)
    cache["len"][:] = torch.from_numpy(lengths)
    return jcache, cache, table, P


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_span_matches_steps_and_reference(models, layout):
    """A span of 5 tokens against 5 sequential ``decode_step``s of the port
    (logits and caches bit for bit: the span is those steps) and against
    JAX's ``decode_span`` (within 1e-4).  Paged: row
    3 is retired (all sentinels): JAX drops its writes and clips its reads,
    the port writes to the drop page and masks, so only finiteness is
    asked of it.  Contiguous: row 0 runs past ``max_len``, where both drop
    the writes."""
    jmodel, jparams, model = models["target"]
    rng = np.random.default_rng(4)
    S = 5
    tokens = rng.integers(0, 259, (4, S)).astype(np.int32)
    if layout == "paged":
        lengths = np.asarray([5, 17, 9, 21], np.int32)
        jcache, cache, table, P = _paged_setup(model, rng, lengths, S, retired=[3])
        jtable, ttable, live, cut = jnp.asarray(table), torch.from_numpy(table), [0, 1, 2], P
    else:
        prompt = rng.integers(0, 259, (4, 30)).astype(np.int32)
        plens = np.asarray([30, 12, 25, 7], np.int32)
        _, jcache = jmodel.prefill(jparams, jnp.asarray(prompt), 32, lengths=jnp.asarray(plens))
        _, cache = model.prefill(torch.from_numpy(prompt), lengths=torch.from_numpy(plens),
                                 max_len=32)
        jtable = ttable = None
        live, cut = [0, 1, 2, 3], None
    steps = _clone(cache)
    want, jcache = jmodel.decode_span(jparams, jnp.asarray(tokens), jcache, table=jtable)
    got = model.decode_span(torch.from_numpy(tokens), cache, ttable)
    seq = torch.cat([model.decode_step(torch.from_numpy(tokens[:, i:i + 1]), steps, ttable)
                     for i in range(S)], dim=1)
    assert got.shape == (4, S, model.vocab_padded) and torch.isfinite(got).all()
    np.testing.assert_allclose(got[live].numpy(), np.asarray(want)[live], atol=TOL, rtol=TOL)
    assert torch.equal(got, seq)
    assert torch.equal(cache["len"], steps["len"])
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["blocks"]["b0"]["len"])[0])
    for name in ("k", "v"):
        mine = cache[name][:, :cut] if cut else cache[name]
        assert torch.equal(mine, steps[name][:, :cut] if cut else steps[name])
        np.testing.assert_allclose(mine.numpy(), np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL)


def test_decode_span_refuses_what_jax_refuses():
    rwkv = Model(get_arch("rwkv6-3b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="global-attention"):
        rwkv.decode_span(torch.zeros((1, 2), dtype=torch.int32), rwkv.init_cache(1, 8))
    gemma = Model(get_arch("recurrentgemma-9b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="global-attention"):
        gemma.decode_span(torch.zeros((1, 2), dtype=torch.int32), gemma.init_cache(1, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_attention_plain_matches_reference(dtype):
    """``ops.span_attention`` / ``paged_span_attention`` on CPU tensors
    against JAX's: S = 4 positions, base lengths with 0 among them, G = 2.
    Paged row 3 is retired (all sentinels, stale length): the port gives
    zeros, JAX attends the clipped page P−1, and they differ there."""
    rng = np.random.default_rng(6)
    B, S, H, Hk, D, ps, n_cols = 4, 4, 4, 2, 16, 8, 5
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def both(a):
        t = torch.from_numpy(a.astype(np.float32)).to(tdt)
        return t, jnp.asarray(t.float().numpy(), jdt)

    q, jq = both(rng.normal(size=(B, S, H, D)))
    base = np.asarray([0, 13, 27, 20], np.int32)
    k, jk = both(rng.normal(size=(B, n_cols * ps, Hk, D)))
    v, jv = both(rng.normal(size=(B, n_cols * ps, Hk, D)))
    got = ops.span_attention(q, k, v, torch.from_numpy(base))
    want = jops.span_attention(jq, jk, jv, jnp.asarray(base))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    P = B * n_cols + 1
    pool_k, jpool_k = both(rng.normal(size=(P, ps, Hk, D)))
    pool_v, jpool_v = both(rng.normal(size=(P, ps, Hk, D)))
    table = rng.permutation(P)[:B * n_cols].reshape(B, n_cols).astype(np.int32)
    table[3] = P
    got = ops.paged_span_attention(q, pool_k, pool_v, torch.from_numpy(table),
                                   torch.from_numpy(base))
    want = np.asarray(jops.paged_span_attention(jq, jpool_k, jpool_v, jnp.asarray(table),
                                                jnp.asarray(base)), np.float32)
    np.testing.assert_allclose(got[:3].float().numpy(), want[:3], atol=tol, rtol=tol)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    assert np.abs(want[3]).max() > 0.1                    # the clipped page, read


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_at_head_dim_128_matches_reference(dtype):
    """The plain paged version at D = 128 (Qwen1.5-4B's heads, G = 1, and
    G = 2) against ``_paged_jnp`` and ``paged_attention_pallas`` in
    interpret mode, every page below a row's length mapped."""
    rng = np.random.default_rng(7)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    for B, H, Hk, ps, n_cols in ((3, 4, 4, 16, 4), (2, 4, 2, 8, 5)):
        D = 128
        P = B * n_cols + 3
        lengths = np.append(rng.integers(1, n_cols * ps + 1, B - 1), n_cols * ps).astype(np.int32)
        table = rng.permutation(P)[:B * n_cols].reshape(B, n_cols).astype(np.int32)

        def both(shape):
            t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
            return t, jnp.asarray(t.float().numpy(), jdt)

        (q, jq), (kp, jkp), (vp, jvp) = both((B, 1, H, D)), both((P, ps, Hk, D)), \
            both((P, ps, Hk, D))
        got = paged_attention_plain(q, kp, vp, torch.from_numpy(table), torch.from_numpy(lengths))
        for want in (jops._paged_jnp(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lengths)),
                     paged_attention_pallas(jq, jkp, jvp, jnp.asarray(table),
                                            jnp.asarray(lengths), interpret=True)):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# qwen1.5-4b
# ---------------------------------------------------------------------------

def test_qwen_4b_config_copy_matches_reference():
    jcfg, cfg = jax_get_arch("qwen1.5-4b"), get_arch("qwen1.5-4b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.qkv_bias, cfg.rope_theta, cfg.dtype) == \
        (40, 2560, 20, 20, 128, 6912, 151_936, True, 5e6, "bfloat16")
    assert 3.9e9 < cfg.param_count() < 4.0e9
    assert cfg.param_count() == jcfg.param_count()


def test_narrow_qwen_4b_matches_reference():
    """``qwen1.5-4b``'s ``reduced()`` widened back to head_dim 128 (MHA, QKV
    bias, rope θ 5e6): through the bridge, prefill logits, then a paged span
    of 3 and a paged decode step, within 1e-4 of the JAX model."""
    jcfg = dataclasses.replace(jax_get_arch("qwen1.5-4b").reduced(), head_dim=128)
    cfg = dataclasses.replace(get_arch("qwen1.5-4b").reduced(), head_dim=128)
    jmodel, jparams, model = _pair("qwen1.5-4b", 1, jcfg, cfg)
    assert model.blocks[0].attn.q.w.shape == (64, 4 * 128)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 500, (2, 20)).astype(np.int32)
    want, _ = jmodel.prefill(jparams, jnp.asarray(tokens), 20)
    got, _ = model.prefill(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    lengths = np.asarray([9, 30], np.int32)
    jcache, cache, table, _ = _paged_setup(model, rng, lengths, 4)
    span = rng.integers(0, 500, (2, 3)).astype(np.int32)
    want, jcache = jmodel.decode_span(jparams, jnp.asarray(span), jcache, table=jnp.asarray(table))
    got = model.decode_span(torch.from_numpy(span), cache, torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    step = rng.integers(0, 500, (2, 1)).astype(np.int32)
    want, _ = jmodel.decode_step(jparams, jnp.asarray(step), jcache, table=jnp.asarray(table))
    got = model.decode_step(torch.from_numpy(step), cache, torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# bf16 streams across (K, slots)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_pair():
    jcfg = dataclasses.replace(jax_get_arch("qwen1.5-0.5b").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(), dtype="bfloat16")
    return _pair("qwen1.5-0.5b", 0, jcfg, cfg)


@pytest.mark.parametrize("framework", ["jax", "port"])
def test_bf16_streams_hold_across_k_and_slots(bf16_pair, framework):
    """``docs/sampling.md`` promises a request the same tokens under any
    ``decode_block`` and slot placement.  ``reduced()`` Qwen1.5-0.5B in
    bfloat16, 16 batch prompts, the even ones sampled, served at (K, slots)
    = (8, 8) and (1, 4): other admission batches, so other prefill and
    decode batch shapes.  Both engines keep the promise on the CPU (each
    against itself; the two frameworks round bf16 products differently, so
    they are not compared with each other).  The split ``chip_smoke.py``
    reports on the card therefore comes from the card's own shape-dependent
    rounding, not from an op of the port that the CPU runs."""
    jmodel, jparams, model = bf16_pair
    rng = np.random.default_rng(0)
    prompts = [TOK.encode(SYS + " ".join(f"{rng.integers(0, 99)}+{rng.integers(0, 99)}"
                                         for _ in range(6))) for _ in range(16)]
    mod, gen_cls = (jengine, JaxGenerationConfig) if framework == "jax" else \
        (engine, GenerationConfig)
    streams = []
    for K, slots in ((8, 8), (1, 4)):
        if framework == "jax":
            eng = jengine.ServingEngine(jmodel, jparams, max_slots=slots, max_len=256,
                                        decode_block=K, paged=True, page_size=16, eos_id=-1)
        else:
            eng = engine.ServingEngine(model, max_slots=slots, max_len=256, decode_block=K,
                                       paged=True, page_size=16, eos_id=-1, device="cpu")
        reqs = [mod.Request(rid=i, tokens=list(p), max_new=32, gen=gen_cls(
            max_new=32, temperature=0.8, top_k=50, top_p=0.95, seed=1000 + i)
            if i % 2 == 0 else None) for i, p in enumerate(prompts)]
        eng.serve(reqs)
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 32 for s in streams[0])
