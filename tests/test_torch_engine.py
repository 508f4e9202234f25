"""The port's serving engine against the JAX package's, on the CPU, in both
KV layouts.

Both engines serve the workload of ``tests/test_engine.py`` with the same
tiny-s weights (bridged from the JAX init): greedy token streams must be
identical and the dispatch and KV counters equal, over K ∈ {1, 8}
decode-block depths × {1, 4} slots, paged and contiguous.  Every prompt
opens with a shared system prefix (prefix sharing), and the first three are
identical (a copy-on-write fork on their first decode write).
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro.serving import kvpool as jkvpool
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.models.attention import attention_decode
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine, graphs, kvpool
from repro_torch.serving.generation import GenerationConfig


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


def _workload():
    """Three identical prompts, admitted together, then ``tests/test_engine.py``'s
    shared-prefix requests — mixed prompt lengths and max_new, the bare
    prefix, one prompt at the max_len−1 ceiling."""
    prompts = [SYS + "same"] * 3
    prompts += [SYS + f"query number {i} " + "abc" * (5 * i) for i in range(5)]
    prompts += [SYS, "z" * (MAX_LEN - 8)]
    max_news = (6, 7, 9, 3, 1, 17, 40, 8, 25, 32)
    return [(TOK.encode(p), m) for p, m in zip(prompts, max_news)]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("tiny-s")
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = Model(get_arch("tiny-s"), device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), model.cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def eos_id(models):
    """A token the untrained model emits mid-stream, so the streams retire by
    EOS as well as by max_new and the length ceiling."""
    _, _, model = models
    probe = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, eos_id=-1,
                                 device="cpu")
    reqs = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    probe.serve(reqs)
    counts: dict[int, int] = {}
    for r in reqs:
        for t in r.out_tokens[1:]:
            counts[t] = counts.get(t, 0) + 1
    return max(counts, key=counts.get)


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("k", [1, 8])
def test_greedy_streams_and_kv_counters_match_reference(models, eos_id, k, slots):
    jmodel, jparams, model = models
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=slots, max_len=MAX_LEN,
                                decode_block=k, paged=True, page_size=16, eos_id=eos_id)
    eng = engine.ServingEngine(model, max_slots=slots, max_len=MAX_LEN, decode_block=k,
                               paged=True, page_size=16, eos_id=eos_id, device="cpu")
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    for a, b in zip(r_ref, r_got):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
        assert b.done
    assert any(eos_id in r.out_tokens for r in r_got), "no stream retired by EOS"
    assert eng.kv_occupancy() == ref.kv_occupancy()
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    eng.kv.alloc.check(tables=eng.kv.slot_pages)
    assert eng.kv.alloc.pages_in_use == 0
    if slots > 1:
        assert eng.kv.alloc.n_shares > 0 and eng.kv.alloc.n_forks > 0


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("k", [1, 8])
def test_contiguous_streams_and_counters_match_reference(models, eos_id, k, slots):
    """``paged=False`` on both sides: streams, dispatch counters and
    ``kv_occupancy()`` identical.  The horizon slice engages (max_len 160,
    horizons of 32–128 while the streams are short), and retired slots'
    garbage streams run past it."""
    jmodel, jparams, model = models
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=slots, max_len=MAX_LEN,
                                decode_block=k, paged=False, eos_id=eos_id)
    eng = engine.ServingEngine(model, max_slots=slots, max_len=MAX_LEN, decode_block=k,
                               paged=False, eos_id=eos_id, device="cpu")
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    for a, b in zip(r_ref, r_got):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
        assert b.done
    assert any(eos_id in r.out_tokens for r in r_got), "no stream retired by EOS"
    assert eng.kv_occupancy() == ref.kv_occupancy()
    assert eng.kv_occupancy()["paged"] is False
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)


def test_serve_stepwise_matches_serve(models, eos_id):
    """The port's stepwise reference driver gives the fused driver's streams,
    and JAX's stepwise driver's counters."""
    jmodel, jparams, model = models
    fused = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, decode_block=8,
                                 paged=False, eos_id=eos_id, device="cpu")
    step = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, paged=False,
                                eos_id=eos_id, device="cpu")
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=4, max_len=MAX_LEN, paged=False,
                                eos_id=eos_id)
    r_fused = [engine.Request(rid=i, tokens=t, max_new=m)
               for i, (t, m) in enumerate(_workload())]
    r_step = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    fused.serve(r_fused)
    step.serve_stepwise(r_step)
    ref.serve_stepwise(r_ref)
    assert [r.out_tokens for r in r_step] == [r.out_tokens for r in r_fused]
    assert [r.out_tokens for r in r_step] == [r.out_tokens for r in r_ref]
    assert all(r.done for r in r_step)
    assert (step.n_decode_calls, step.n_decode_steps, step.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    with pytest.raises(RuntimeError, match="contiguous"):
        engine.ServingEngine(model, max_slots=2, max_len=64, device="cpu").serve_stepwise([])


def test_engine_refuses_recurrent_models():
    """JAX's engine asserts in prefill that variable-length batches need an
    attention-only stack; the port's refuses an RWKV6 model up front, in
    both layouts."""
    model = Model(get_arch("rwkv6-3b").reduced(), device="cpu")
    for paged in (True, False):
        with pytest.raises(ValueError, match="attention-only"):
            engine.ServingEngine(model, max_slots=2, max_len=64, paged=paged, device="cpu")


def test_generate_text_matches_reference(models):
    jmodel, jparams, model = models
    prompts = [f"query number {i}" for i in range(5)]
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=2, max_len=128, paged=True)
    eng = engine.ServingEngine(model, max_slots=2, max_len=128, device="cpu")
    assert eng.generate_text(prompts, max_new=8) == ref.generate_text(prompts, max_new=8)


def test_allocator_pinned_to_reference_on_full_pool():
    """n_pages=1, alloc → share → fork: the fork needs a fresh page, so both
    allocators raise OutOfPages and keep the same state."""
    states = []
    for mod in (jkvpool, kvpool):
        a = mod.BlockAllocator(n_pages=1, page_size=16)
        p = a.alloc()
        a.share(p)
        with pytest.raises(mod.OutOfPages):
            a.fork(p)
        a.check()
        states.append((a.refcount(p), a.pages_in_use, a.n_allocs, a.n_shares, a.n_forks))
    assert states[0] == states[1] == (2, 1, 1, 1, 0)


def test_unported_paths_raise(models, monkeypatch, capsys):
    """The ``online`` and ``http`` modes of the launcher are ported
    (``tests/test_torch_online.py``, ``tests/test_torch_http.py``) and, like
    every entry point, raise without a card unless ``--device cpu`` is
    given; the paged KV cache refuses a sliding window, as the JAX
    package asserts (ring caches are the contiguous layout's).  Sampled
    decoding and speculative decoding are ported now
    (``tests/test_torch_sampling.py``, ``tests/test_torch_speculative.py``), so
    a sampled request is served, and so is a speculative one through the
    launcher's ``--draft-member``, which the contiguous layout refuses."""
    from repro_torch.launch import serve as launcher

    _, _, model = models
    launcher.engine_main(["--arch", "tiny-m", "--draft-member", "tiny-s", "--device", "cpu",
                          "--requests", "2", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "speculative: k=4 rounds=" in out
    with pytest.raises(SystemExit, match="paged"):
        launcher.engine_main(["--draft-member", "tiny-s", "--contiguous", "--device", "cpu"])
    if not torch.cuda.is_available():
        for mode in ("online", "http"):
            monkeypatch.setattr("sys.argv", ["serve", mode])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                launcher.main()
    for paged in (True, False):
        eng = engine.ServingEngine(model, max_slots=2, max_len=64, paged=paged, device="cpu")
        req = engine.Request(rid=0, tokens=TOK.encode("hi"),
                             gen=GenerationConfig(max_new=4, temperature=0.7))
        eng.serve([req])
        assert req.done and len(req.out_tokens) == 4
    cache = model.init_paged_cache(8, 16, 2)
    x = torch.zeros((2, 1, model.cfg.d_model))
    pos = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        attention_decode(model.blocks[0].attn, model.cfg, x, cache["k"][0], cache["v"][0],
                         pos, table, None, window=16)


class EmulatedGraphs(graphs.GraphSet):
    """``GraphSet`` with its card path emulated on the CPU.  A "capture"
    runs the body once (its work stands for the first replay's, which is
    then skipped), and every later replay runs the captured closure again
    into the captured outputs, its launches tallied aside and dropped, as a
    replay runs no Python.  The body (the engine's is a
    ``partial`` of its dispatch's values) keeps the values it was made with,
    as a graph keeps its inputs' addresses; but unlike a graph the rerun
    reads attributes afresh, so only the card holds a replay against the
    eager body in full (``chip_smoke.py``)."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.on_card = True

    def _record(self, body):
        out = body()
        first = [True]

        def replay():
            if first[0]:
                first[0] = False
                return
            with launches.tally():          # a replay runs no Python
                out.copy_(body())

        return SimpleNamespace(replay=replay), out


@pytest.mark.parametrize("paged", [True, False])
def test_graph_path_streams_and_counters_match_reference(models, paged):
    """The engine's fused dispatch through ``GraphSet``'s keyed path (first
    call of a key eager, then capture and replays, here emulated on the
    CPU): streams, dispatch counters and ``kv_occupancy()`` identical to the
    JAX engine's, with several keys captured and every dispatch after a
    key's first replayed.  No EOS, so the streams run to their limits
    through several horizon buckets."""
    jmodel, jparams, model = models
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=4, max_len=MAX_LEN, decode_block=4,
                                paged=paged, page_size=16, eos_id=-1)
    eng = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, decode_block=4,
                               paged=paged, page_size=16, eos_id=-1, device="cpu")
    eng._graphs = EmulatedGraphs()
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    assert [r.out_tokens for r in r_got] == [r.out_tokens for r in r_ref]
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    assert eng.kv_occupancy() == ref.kv_occupancy()
    gs = eng._graphs
    assert len(gs.graphs) >= 2
    assert gs.n_replays == eng.n_decode_calls - len(gs._warm) > eng.n_decode_calls // 2


@pytest.mark.parametrize("paged", [True, False])
def test_graph_path_replays_keys_out_of_capture_order(models, paged):
    """The workload, four requests sampled, served twice on one engine
    through the emulated graphs: the key changes inside a serve (horizon or
    table columns, and ``sample``), and the second serve replays keys
    captured before the first serve's last one.  Both serves give the eager
    body's streams and counters, so each dispatch's body holds its own
    horizon, table and ``sample``, as a graph holds what it saw at
    capture."""
    _, _, model = models

    def reqs():
        return [engine.Request(rid=i, tokens=t, max_new=m, gen=GenerationConfig(
            max_new=m, temperature=0.8, top_k=20, top_p=0.9, seed=50 + i) if i in (0, 1, 2, 5)
            else None) for i, (t, m) in enumerate(_workload())]

    got, keys = {}, []
    for leg in ("graphed", "eager"):
        eng = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, decode_block=4,
                                   paged=paged, page_size=16, eos_id=-1, device="cpu")
        if leg == "graphed":
            gs = eng._graphs = EmulatedGraphs()
            inner = gs.run
            gs.run = lambda key, body: (keys.append(key), inner(key, body))[1]
        got[leg] = []
        for _ in range(2):
            rs = reqs()
            eng.serve(rs)
            got[leg].append([r.out_tokens for r in rs])
        got[leg].append((eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls,
                         eng.kv_occupancy()))
    assert got["graphed"] == got["eager"]
    assert got["eager"][0] == got["eager"][1]
    captured = list(dict.fromkeys(keys))
    assert list(gs.graphs) == captured and len(captured) >= 3
    assert {k[1] for k in captured} == {True, False}
    assert gs.n_replays == len(keys) - len(captured)
    second = keys[len(keys) // 2]
    assert captured.index(second) < len(captured) - 1


def test_graph_set_keys_and_launch_counts():
    """First call of a key eager, second captured then replayed, later ones
    replayed; a wrapper's launches ticked at capture go to the capture's
    tally, not the counter, and are added at every replay, so they count the
    work done."""
    gs = EmulatedGraphs()
    wrapper = paged_attention_cuda
    start = wrapper.launches
    calls = []

    def body(tag):
        calls.append(tag)
        launches.count(wrapper, 3)
        return torch.tensor([len(calls)])

    try:
        assert gs.run("a", lambda: body("a")).item() == 1 and wrapper.launches == start + 3
        out = gs.run("a", lambda: body("a2"))
        assert calls == ["a", "a2"] and out.item() == 2 and wrapper.launches == start + 6
        assert gs.run("a", lambda: body("unused")) is out and out.item() == 3
        assert calls == ["a", "a2", "a2"] and wrapper.launches == start + 9
        assert gs.run("b", lambda: body("b")).item() == 4 and len(gs.graphs) == 1
        assert gs.n_replays == 2
    finally:
        wrapper.launches = start


def test_launch_counts_hold_across_threads():
    """Launches counted from many threads at once while one thread holds a
    capture's tally open: the counter ends at the launches made outside the
    tally, and the tally holds exactly its own thread's."""
    import sys
    import threading

    wrapper = flash_attention_cuda
    start = wrapper.launches
    n_threads, per = 16, 2000
    tallies = []
    in_tally, others_done = threading.Event(), threading.Barrier(n_threads)

    def work(i):
        if i == 0:
            with launches.tally() as t:
                in_tally.set()
                for _ in range(per):
                    launches.count(wrapper)
                others_done.wait(timeout=60)
            tallies.append(t)
        else:
            in_tally.wait(timeout=60)
            for _ in range(per):
                launches.count(wrapper)
            others_done.wait(timeout=60)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert wrapper.launches == start + (n_threads - 1) * per
        assert tallies == [{wrapper: per}]
    finally:
        sys.setswitchinterval(old)
        wrapper.launches = start
