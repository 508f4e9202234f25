"""Live pool members of the port against the JAX package's.

``ServedPoolMember``s over the port's engines for ``tiny-s`` and ``tiny-m``
in fp32, with weights carried from the JAX package's models (random, from
seeds), against the JAX package's members over the same weights, on the
tiny pool's addition task (``build_task_workload``, seeded): the same
answers, utilities and token counts from ``invoke_batch``; the same SSE
deltas from the batch-prompt demultiplexer; the same labels, probes, billed
tokens and calibrations from a two-member ``Robatch.fit``; the same results
from a ``ReplicaSet`` of two; and the same window reports and completed
requests from a short online serve whose two members are dispatched on two
threads at once, each engine's graph capture emulated on the CPU.  A live
member's latency is the wall clock's, so completion times (and the
latencies made from them) are the only records left out.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.core import robatch as jrobatch
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro.serving import online as jonline
from repro.serving import pool as jpool
from repro.serving import tinypool as jtinypool
from repro.serving.batcher import BatchPromptFormatter as JaxFormatter
from repro_torch import api
from repro_torch.config import get_arch
from repro_torch.core import robatch
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import engine, online, pool, tinypool
from repro_torch.serving.batcher import BatchPromptFormatter
from test_torch_core import same
from test_torch_engine import EmulatedGraphs

NAMES = ("tiny-s", "tiny-m")


def judge(pred, gold):
    """A verdict that varies with the untrained models' answers (the task's
    own judge scores random weights 0 everywhere, which routes every query
    to the cheapest member): a pure function of the answer text."""
    return float(len(pred.encode()) % 2 == 0)


class Sink:
    def __init__(self):
        self.deltas = []

    def push(self, delta):
        self.deltas.append(delta)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: its models here are tiny, so
    a pool of threads a process only adds contention when the suite runs in
    several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, seed in zip(NAMES, (5, 3)):
        jmodel = JaxModel(jax_get_arch(name), JaxShardingConfig(remat="none"))
        jparams = jmodel.init(jax.random.PRNGKey(seed))
        model = Model(get_arch(name), device="cpu")
        model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), model.cfg))
        out[name] = (jmodel, jparams, model)
    return out


def build(models, port, replicas=1, emulate=False):
    """(workload, [member per name]) in one framework; ``replicas`` > 1 makes
    each member a ReplicaSet of that many engines over one model."""
    fmt = (BatchPromptFormatter if port else JaxFormatter)(tinypool.SYSTEM_PROMPT)
    tp = tinypool if port else jtinypool
    wl, task = tp.build_task_workload(np.random.default_rng(0), fmt, n_train=8, n_test=8)
    task.judge = judge
    members = []
    for name in NAMES:
        jmodel, jparams, model = models[name]

        def member():
            if port:
                eng = engine.ServingEngine(model, max_slots=4, max_len=512, decode_block=8,
                                           paged=True, page_size=16, device="cpu")
                if emulate:
                    eng._graphs = EmulatedGraphs()
                cls = pool.ServedPoolMember
            else:
                eng = jengine.ServingEngine(jmodel, jparams, max_slots=4, max_len=512,
                                            decode_block=8, paged=True, page_size=16)
                cls = jpool.ServedPoolMember
            c_in, c_out = tp.TINY_PRICES[name]
            return cls(name, eng, fmt, task, c_in=c_in, c_out=c_out, context_len=512)

        if replicas > 1:
            members.append((pool if port else jpool).ReplicaSet(
                [member() for _ in range(replicas)], name=name))
        else:
            members.append(member())
    return wl, task, members


def result(res):
    return (list(res.answers), res.utilities, res.in_tokens, res.out_tokens)


def test_task_and_invoke_batch_match(models):
    jwl, jtask, jmembers = build(models, port=False)
    wl, task, members = build(models, port=True)
    same(jwl, wl)
    assert list(task.queries) == list(jtask.queries) and list(task.answers) == list(jtask.answers)
    for jm, m in zip(jmembers, members):
        for idx in ([0], [1, 2, 3], [4, 5, 6, 7, 8, 9]):
            jr, r = jm.invoke_batch(jwl, np.array(idx)), m.invoke_batch(wl, np.array(idx))
            same(result(jr), result(r))
        assert m.kv_occupancy() == jm.kv_occupancy()


def test_stream_demux_deltas_match(models):
    jwl, _, jmembers = build(models, port=False)
    wl, _, members = build(models, port=True)
    idx = np.array([3, 4, 5, 6])
    for jm, m in zip(jmembers, members):
        jsinks = {p: [Sink()] for p in range(4)}
        sinks = {p: [Sink()] for p in range(4)}
        jr = jm.invoke_batch(jwl, idx, streams=jsinks)
        r = m.invoke_batch(wl, idx, streams=sinks)
        same(result(jr), result(r))
        for p in range(4):
            assert sinks[p][0].deltas == jsinks[p][0].deltas
            assert "".join(sinks[p][0].deltas) == r.answers[p]


def test_two_member_fit_matches(models):
    jwl, _, jmembers = build(models, port=False)
    wl, _, members = build(models, port=True)
    kw = dict(router_kind="knn", coreset_size=4, grid_multiple=2)
    jrb = jrobatch.Robatch(jmembers, jwl, **kw).fit()
    rb = robatch.Robatch(members, wl, device="cpu", **kw).fit()
    same(jrb.train_labels, rb.train_labels)
    assert (rb.profile.n_probes, rb.profile.billed_tokens) == \
        (jrb.profile.n_probes, jrb.profile.billed_tokens) and rb.profile.n_probes > 0
    same(jrb.calibrations, rb.calibrations)
    test = wl.subset_indices("test")
    budget = float(rb.cost_model.single_model_cost(1, test, 1))
    same(jrb.schedule(test, budget), rb.schedule(test, budget))
    jout = jrobatch.execute(jmembers, jwl, jrb.schedule(test, budget).assignment)
    out = robatch.execute(members, wl, rb.schedule(test, budget).assignment)
    for f in ("accuracy", "exact_cost", "n_invocations", "per_query_utility"):
        same(getattr(jout, f), getattr(out, f), f)


def test_replica_set_matches(models):
    jwl, _, jsets = build(models, port=False, replicas=2)
    wl, _, sets = build(models, port=True, replicas=2)
    for js, s in zip(jsets, sets):
        assert (s.n_replicas, s.n_available(), s.c_in, s.c_out, s.context_len) == \
            (js.n_replicas, js.n_available(), js.c_in, js.c_out, js.context_len)
        for idx in ([0, 1], [2, 3, 4]):
            same(result(js.invoke_batch(jwl, np.array(idx))),
                 result(s.invoke_batch(wl, np.array(idx))))
        assert s.loads() == js.loads() == [0, 0]
        assert s.kv_occupancy() == js.kv_occupancy()


def test_online_serve_over_two_live_members_matches(models):
    """Both members dispatched concurrently (two worker threads), each
    engine capturing and replaying its keyed graphs (emulated): the window
    reports and completed requests of the JAX server over the same weights.
    The MLP router is left to ``chip_smoke.py``; here the KNN router keeps
    the plans bit for bit, and with k = 2 its estimates vary enough across
    queries that a window dispatches to both members."""
    outs = []
    for port in (False, True):
        wl, _, members = build(models, port=port, emulate=port)
        mod, onl = (api, online) if port else (japi, jonline)
        kw = dict(device="cpu") if port else {}
        spec = mod.RunSpec(router="knn", knn_k=2, coreset_size=4, grid_multiple=2)
        gw = mod.Gateway(members, wl, spec=spec, **kw).fit()
        test = wl.subset_indices("test")
        base = float(gw.robatch.cost_model.state_cost(
            0, gw.robatch.calibrations[0].b_effect, test).mean())
        cfg = onl.OnlineConfig(budget_per_s=4.0 * base * 3.0, window_s=0.5)
        arrivals = onl.poisson_arrivals(np.random.default_rng(1), 4.0, 3.0, test,
                                        repeat_frac=0.2)
        stats = gw.serve(arrivals, cfg)
        outs.append((stats, gw.server, members))
    (jstats, jsrv, _), (stats, srv, members) = outs
    assert srv._pool_exec._max_workers == 2
    assert len(srv.windows) == len(jsrv.windows) > 0
    for jw, w in zip(jsrv.windows, srv.windows):
        same(dataclasses.asdict(jw), dataclasses.asdict(w), f"window t={w.t}")
    jdone = sorted(jsrv.completed, key=lambda r: r.rid)
    done = sorted(srv.completed, key=lambda r: r.rid)
    for jr, r in zip(jdone, done):
        for f in ("rid", "query_idx", "arrived_at", "utility", "model", "batch", "cost",
                  "cache_hit", "dropped", "content", "n_reroutes"):
            same(getattr(jr, f), getattr(r, f), f"rid {r.rid}.{f}")
    assert stats.n_completed == stats.n_submitted == jstats.n_submitted > 0
    assert stats.total_cost == jstats.total_cost and stats.n_cache_hits > 0
    assert all(br.state.value == "closed" for br in srv.breakers)
    assert any(len(m.engine._graphs.graphs) for m in members)
    assert any(set(w.group_models) == {0, 1} for w in srv.windows)
