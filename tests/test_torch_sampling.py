"""The port's sampling against the JAX package's, on the CPU.

* ``utils/prng.py`` against ``jax.random`` (JAX 0.9's defaults: 32-bit
  mode, ``jax_threefry_partitionable`` on): ``PRNGKey``, ``fold_in``, 32-bit
  ``bits`` and float32 ``uniform`` bit for bit; ``gumbel`` within 2 ulp
  counted in units of the last place of max(|g|, 1) — each library's float32
  ``log`` is within an ulp of the exact value, and near g = 0 the outer log
  turns the inner log's one-ulp difference into many ulps of g itself, but
  never into more than 2 ulp of 1.
* ``sample_tokens`` against JAX's on rows of mixed greedy and sampled knobs
  (top-k, top-p, both, neither): the tokens are identical on this file's
  seeds (no row sits within an ulp of a nucleus boundary, so none needs
  holding by distribution); temperature 0 is the argmax bit for bit.
* The sampled engine: fused streams equal the stepwise loop's at K ∈ {1,
  8} and slots ∈ {1, 4}, paged and contiguous (token t of a request is a
  pure function of (seed, t)), and equal the JAX engine's.
* The draws fit the filtered softmax: a chi-square over the kept ranks below
  the 1e-6 tail of its distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro.serving.generation import GenerationConfig as JaxGenerationConfig
from repro_torch.config import get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine
from repro_torch.serving.generation import GenerationConfig
from repro_torch.utils import prng


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOK = ByteTokenizer()
MAX_LEN = 128
SEEDS = [0, 1, 42, 2**31 + 7, 2**32 - 1, 2**40 + 3, -5]


def _jax_keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])


def _words(keys):
    return prng.as_words(np.asarray(keys, np.uint32))


def _as_u32(t):
    return t.numpy().astype(np.uint32)


def test_prng_key_fold_in_bits_and_uniform_match_jax():
    for s in SEEDS:
        np.testing.assert_array_equal(prng.prng_key(s), np.asarray(jax.random.PRNGKey(s)))
    keys = _jax_keys(SEEDS)
    data = np.array([0, 1, 77, 2**31 - 1, 5, 1000, 3], np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(keys, data))
    got = _as_u32(prng.fold_in(_words(keys), torch.from_numpy(data)))
    np.testing.assert_array_equal(got, want)
    n = 1001                                       # odd: the last counter pair alone
    bits = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32)) for k in want])
    np.testing.assert_array_equal(_as_u32(prng.random_bits(_words(want), n)), bits)
    uni = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in want])
    np.testing.assert_array_equal(prng.uniform(_words(want), n).numpy().view(np.int32),
                                  uni.view(np.int32))


def test_gumbel_within_two_ulp_of_jax():
    keys = np.asarray(jax.vmap(jax.random.fold_in)(_jax_keys(SEEDS), np.arange(7, dtype=np.int32)))
    n = 20000
    want = np.stack([np.asarray(jax.random.gumbel(k, (n,))) for k in keys])
    got = prng.gumbel(_words(keys), n).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    assert np.isfinite(got).all() and got.min() > -5 and got.max() < 17


def _sampling_inputs(seed, B=12, V=512):
    """Rows of logits at several scales and the knobs of every branch:
    greedy (temp 0), top-k alone, top-p alone, both, neither, and k = 1."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * rng.uniform(0.5, 6.0, (B, 1))).astype(np.float32)
    keys = _jax_keys([int(s) for s in rng.integers(0, 2**31, B)])
    n = rng.integers(0, 200, B).astype(np.int32)
    temp = np.array([0.0, 0.8, 0.8, 0.8, 1.3, 0.5] * (B // 6), np.float32)
    top_k = np.array([0, 50, 0, 20, 0, 1] * (B // 6), np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.95, 1.0, 0.5] * (B // 6), np.float32)
    return logits, keys, n, temp, top_k, top_p


def _jax_sample(logits, keys, n, temp, top_k, top_p):
    return np.asarray(jengine.sample_tokens(
        jnp.asarray(logits), jengine._fold_keys(jnp.asarray(keys), jnp.asarray(n)),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))


def _port_sample(logits, keys, n, temp, top_k, top_p):
    return engine.sample_tokens(torch.from_numpy(logits),
                                engine._fold_keys(_words(keys), torch.from_numpy(n)),
                                torch.from_numpy(temp), torch.from_numpy(top_k),
                                torch.from_numpy(top_p)).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_sample_tokens_match_jax(seed):
    args = _sampling_inputs(seed)
    got = _port_sample(*args)
    np.testing.assert_array_equal(got, _jax_sample(*args))
    assert got.dtype == np.int32
    # a zero temperature is the argmax bit for bit, whatever the other knobs
    logits, keys, n, temp, top_k, top_p = args
    greedy = _port_sample(logits, keys, n, np.zeros_like(temp), top_k, top_p)
    np.testing.assert_array_equal(greedy, logits.argmax(-1))


def test_draws_fit_the_filtered_softmax():
    """4,000 draws of one row at positions 0..3999: the counts of the kept
    ranks against the softmax renormalised over them (the nucleus of 0.8
    keeps 11 ranks, under top-k 40; its edge is 4.7e-4 of mass from the
    next rank, far above float32 rounding), chi-square below its 1e-6
    upper tail (Wilson–Hilferty), and no draw outside the kept ranks."""
    rng = np.random.default_rng(11)
    V, N = 512, 4000
    row = (rng.standard_normal(V) * 2.0).astype(np.float32)
    t, k, p = 0.8, 40, 0.8
    sl = np.sort(row.astype(np.float64) / t)[::-1]
    probs = np.exp(sl - sl[0]) / np.exp(sl - sl[0]).sum()
    kept = int(min(k, np.sum(np.cumsum(probs) - probs < p)))
    assert 2 < kept < k                            # the nucleus binds before top-k
    expect = N * probs[:kept] / probs[:kept].sum()
    toks = _port_sample(np.tile(row, (N, 1)), np.tile(prng.prng_key(9), (N, 1)),
                        np.arange(N, dtype=np.int32), np.full(N, t, np.float32),
                        np.full(N, k, np.int32), np.full(N, p, np.float32))
    rank = {int(tok): r for r, tok in enumerate(np.argsort(-row, kind="stable"))}
    counts = np.bincount([rank[int(x)] for x in toks], minlength=V)
    assert counts[kept:].sum() == 0
    stat = float(((counts[:kept] - expect) ** 2 / expect).sum())
    df, z = kept - 1, 4.753                        # z of the 1e-6 upper tail
    bound = df * (1 - 2 / (9 * df) + z * np.sqrt(2 / (9 * df))) ** 3
    assert stat < bound, (stat, bound)


# ---------------------------------------------------------------------------
# the sampled engine
# ---------------------------------------------------------------------------

def _workload(gen_cls):
    """Eight requests behind a shared prefix, alternately sampled (temperature
    0.8, top-k 20, top-p 0.9, its own seed) and greedy."""
    sys = "system: answer each query in order. "
    out = []
    for i in range(8):
        toks = TOK.encode(sys + f"query {i} " + "xy" * (3 * i))
        gen = (gen_cls(max_new=10 + i, temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)
               if i % 2 == 0 else gen_cls(max_new=10 + i))
        out.append((toks, gen))
    return out


@pytest.fixture(scope="module")
def models():
    jmodel = JaxModel(jax_get_arch("tiny-s"), JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = Model(get_arch("tiny-s"), device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), model.cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def stepwise(models):
    """The sampled streams of the port's stepwise loop: the fixed point."""
    _, _, model = models
    eng = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, paged=False, device="cpu")
    reqs = [engine.Request(rid=i, tokens=t, gen=g) for i, (t, g) in
            enumerate(_workload(GenerationConfig))]
    eng.serve_stepwise(reqs)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("k", [1, 8])
def test_sampled_fused_streams_match_stepwise(models, stepwise, k, slots, paged):
    _, _, model = models
    eng = engine.ServingEngine(model, max_slots=slots, max_len=MAX_LEN, decode_block=k,
                               paged=paged, device="cpu")
    reqs = [engine.Request(rid=i, tokens=t, gen=g) for i, (t, g) in
            enumerate(_workload(GenerationConfig))]
    eng.serve(reqs)
    assert [r.out_tokens for r in reqs] == stepwise
    assert [len(s) for s in stepwise] == [10 + i for i in range(8)]


@pytest.mark.parametrize("paged", [True, False])
def test_sampled_engine_streams_match_reference(models, paged):
    jmodel, jparams, model = models
    ref = jengine.ServingEngine(jmodel, jparams, max_slots=4, max_len=MAX_LEN, decode_block=4,
                                paged=paged)
    eng = engine.ServingEngine(model, max_slots=4, max_len=MAX_LEN, decode_block=4,
                               paged=paged, device="cpu")
    r_ref = [jengine.Request(rid=i, tokens=t, gen=g) for i, (t, g) in
             enumerate(_workload(JaxGenerationConfig))]
    r_got = [engine.Request(rid=i, tokens=t, gen=g) for i, (t, g) in
             enumerate(_workload(GenerationConfig))]
    ref.serve(r_ref)
    eng.serve(r_got)
    for a, b in zip(r_ref, r_got):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    assert eng.kv_occupancy() == ref.kv_occupancy()
