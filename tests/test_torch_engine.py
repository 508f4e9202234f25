"""The port's paged serving engine against the JAX package's, on the CPU.

Both engines serve the workload of ``tests/test_engine.py`` with the same
tiny-s weights (bridged from the JAX init): greedy token streams must be
identical and the KV page counters equal, over K ∈ {1, 8} decode-block
depths × {1, 4} slots.  Every prompt opens with a shared system prefix
(prefix sharing), and the first three are identical (a copy-on-write fork
on their first decode write).
"""
import jax
import numpy as np
import pytest

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro.serving import kvpool as jkvpool
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine, kvpool
from repro_torch.serving.generation import GenerationConfig

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


def test_unported_paths_raise(models):
    _, _, model = models
    with pytest.raises(NotImplementedError, match="contiguous"):
        engine.ServingEngine(model, paged=False, device="cpu")
    eng = engine.ServingEngine(model, max_slots=2, max_len=64, device="cpu")
    req = engine.Request(rid=0, tokens=TOK.encode("hi"),
                         gen=GenerationConfig(max_new=4, temperature=0.7))
    with pytest.raises(NotImplementedError, match="sampled"):
        eng.serve([req])
