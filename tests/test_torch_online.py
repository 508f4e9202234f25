"""The port's online server (``serving/online.py``) against the JAX package's.

``Gateway.serve`` on the simulated pool with the virtual clock: the window
reports and the completed requests (by rid) are the JAX package's, plain,
with two replicas a member, with autoscaling, with the semantic cache (the
port's brute-force top-1 is a torch matmul on the cache's device, JAX's a
``jnp`` one: the same hits, the similarities within 1e-6, since the two
products may sum in another order, and so the hits' discounted utilities)
and with ``ChaosMember`` faults.  The dispatcher's thread pool may finish
groups in any order, but the server reads their results in dispatch order,
so the records are ordered; only the chaos case, whose injected faults
follow each member's call order, runs one dispatch thread in both
frameworks.  Then the ``serve online`` command
on the CPU prints the JAX command's summary and dispatch mix.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import repro.api as japi
from repro.serving import fault as jfault
from repro.serving import online as jonline
from repro.serving import semcache as jsemcache
from repro_torch import api
from repro_torch.serving import fault, online, semcache
from test_torch_core import same

ROOT = Path(__file__).resolve().parents[1]
POOL = dict(task="agnews", n_train=192, n_val=48, n_test=96, seed=0)
RECORD = ("rid", "query_idx", "arrived_at", "completed_at", "utility", "model", "batch",
          "cost", "cache_hit", "sem_hit", "sem_sim", "sem_loss", "n_reroutes", "dropped",
          "content")


def serve_both(pool_kw=None, cfg_kw=None, serve_kw=None, chaos=False, qps=25.0,
               duration=6.0, policy=None):
    """Fit a KNN gateway in each framework on the same spec, stream the same
    seeded arrivals through it, and return ((stats, server) JAX, port)."""
    out = []
    for mod, onl, flt, dev in ((japi, jonline, jfault, None), (api, online, fault, "cpu")):
        spec = mod.RunSpec(pool=mod.PoolSpec(**POOL, **(pool_kw or {})), router="knn",
                           coreset_size=48)
        gw = (mod.Gateway.from_spec(spec) if dev is None
              else mod.Gateway.from_spec(spec, device=dev)).fit()
        rb = gw.robatch
        test = gw.wl.subset_indices("test")
        base = float(rb.cost_model.state_cost(0, rb.calibrations[0].b_effect, test).mean())
        kw = dict(cfg_kw or {})
        if "semantic_cache" in kw:
            kw["semantic_cache"] = (jsemcache if dev is None else semcache).SemanticCacheConfig(
                **kw["semantic_cache"])
        cfg = onl.OnlineConfig(budget_per_s=qps * base * 3.0, window_s=0.25, **kw)
        arrivals = onl.poisson_arrivals(np.random.default_rng(0), qps, duration, test,
                                        repeat_frac=0.3)
        pool = None
        if chaos:
            last = len(gw.pool) - 1
            pool = [flt.ChaosMember(m, seed=11 + k, latency_noise_s=0.002,
                                    fail_from=1 if k == last else 10**9,
                                    fail_until=3 if k == last else 10**9)
                    for k, m in enumerate(gw.pool)]
        stats = gw.serve(arrivals, cfg, pool=pool, policy=policy, **(serve_kw or {}))
        out.append((stats, gw.server, pool))
    return out


def close(a, b, path):
    assert abs(a - b) <= 1e-6, (path, a, b)


def check_same(jres, res):
    """Window reports and completed requests identical; with the semantic
    cache, what follows from a hit's similarity within 1e-6."""
    (jstats, jsrv, _), (stats, srv, _) = jres, res
    assert len(srv.windows) == len(jsrv.windows) > 0
    for jw, w in zip(jsrv.windows, srv.windows):
        jd, d = dataclasses.asdict(jw), dataclasses.asdict(w)
        close(jd.pop("sem_utility_loss"), d.pop("sem_utility_loss"), f"window t={w.t}")
        same(jd, d, f"window t={w.t}")
    jdone = sorted(jsrv.completed, key=lambda r: r.rid)
    done = sorted(srv.completed, key=lambda r: r.rid)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for jr, r in zip(jdone, done):
        for f in RECORD:
            if r.sem_hit and f in ("sem_sim", "sem_loss", "utility"):
                close(getattr(jr, f), getattr(r, f), f"rid {r.rid}.{f}")
            else:
                same(getattr(jr, f), getattr(r, f), f"rid {r.rid}.{f}")
    for f in ("n_submitted", "n_completed", "n_cache_hits", "n_dropped", "n_reroutes",
              "total_cost", "budget_allowance", "n_sem_hits", "latency_p50", "latency_p99"):
        same(getattr(jstats, f), getattr(stats, f), f)
    for f in ("mean_utility", "sem_utility_loss"):
        close(getattr(jstats, f), getattr(stats, f), f)
    assert stats.n_completed == stats.n_submitted


def test_serve_matches_plain():
    jres, res = serve_both()
    check_same(jres, res)
    assert res[0].n_cache_hits > 0


def test_serve_matches_with_replicas():
    jres, res = serve_both(pool_kw=dict(replicas=2), qps=40.0)
    check_same(jres, res)
    assert all(w.replica_counts == (2, 2, 2) for w in res[1].windows)


def test_serve_matches_with_autoscaling():
    jres, res = serve_both(pool_kw=dict(max_replicas=3), serve_kw=dict(autoscale=True),
                           qps=80.0)
    check_same(jres, res)
    jsc, sc = jres[1].autoscaler, res[1].autoscaler
    same(jsc.events, sc.events)
    assert sc.summary() == jsc.summary() and len(sc.events) > 0


def test_serve_matches_with_semantic_cache():
    """Near duplicates hit at a cosine threshold of 0.8; the port's torch
    top-1 finds the same keys, with similarities within 1e-6."""
    jres, res = serve_both(cfg_kw=dict(semantic_cache=dict(sim_threshold=0.8)))
    check_same(jres, res)
    assert res[1].semcache.device.type == "cpu"
    assert res[0].n_sem_hits > 0
    jst, st = jres[1].semcache.stats(), res[1].semcache.stats()
    close(jst.pop("utility_loss"), st.pop("utility_loss"), "utility_loss")
    assert st == jst


def test_serve_matches_under_chaos():
    jres, res = serve_both(chaos=True, cfg_kw=dict(max_workers=1))
    check_same(jres, res)
    for jc, c in zip(jres[2], res[2]):
        assert (c.n_calls, c.n_faults, c.n_hangs) == (jc.n_calls, jc.n_faults, jc.n_hangs)
    assert sum(c.n_faults for c in res[2]) > 0
    assert all(br.state.value == "closed" for br in res[1].breakers)


def test_semantic_cache_top1_matches_jnp():
    """The brute-force top-1 alone, over a store built from one seeded
    workload: the same keys as ``jnp``'s, the similarities within 1e-6."""
    from repro_torch.data import make_workload

    wl = make_workload("agnews", **{k: v for k, v in POOL.items() if k != "task"})
    eps = semcache.EpsilonModel(np.array([0.0, 1.0]), np.array([0.2, 0.0]))
    jcache = jsemcache.SemanticCache(jsemcache.SemanticCacheConfig(sim_threshold=-1.0),
                                     wl.embeddings, jsemcache.EpsilonModel(eps.sim_grid,
                                                                           eps.eps_grid))
    cache = semcache.SemanticCache(semcache.SemanticCacheConfig(sim_threshold=-1.0),
                                   wl.embeddings, eps, device="cpu")
    for q in range(0, 120, 3):
        for c in (jcache, cache):
            c.insert(q, 0.5 + q / 1000, q % 3, f"a{q}")
    for q in range(1, 336, 5):
        jh, h = jcache.lookup(q), cache.lookup(q)
        assert (h.source_idx, h.model, h.content) == (jh.source_idx, jh.model, jh.content)
        close(jh.similarity, h.similarity, f"query {q}")


def test_serve_online_command_prints_the_reference():
    args = ["online", "--qps", "25", "--duration", "8", "--n-train", "192", "--coreset", "32"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    outs = [subprocess.run([sys.executable, "-m", mod, *args, *extra], env=env,
                           capture_output=True, text=True, timeout=300)
            for mod, extra in (("repro.launch.serve", []),
                               ("repro_torch.launch.serve", ["--device", "cpu"]))]
    for o in outs:
        assert o.returncode == 0, o.stderr[-2000:]
    assert outs[1].stdout == outs[0].stdout
    assert "dispatch mix (model, batch) -> queries:" in outs[1].stdout
