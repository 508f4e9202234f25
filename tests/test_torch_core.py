"""RoBatch's modeling and routing stages in the port against the JAX package.

The control plane's core is numpy on both sides (the port holds copies of
``data/{workload,simulator}`` and ``core/{problem,coreset,scaling,pareto,
scheduler,robatch,baselines}``), so on the same seeded workload and pool
every output is compared bit for bit: the workload itself, the cost model,
the coresets, each calibration (``b_max``, the ternary-searched
``b_effect``, the profiled means and σ, the scaling fit), the candidate
space and its frontiers, and the heap, vectorized and windowed schedules
(with capacity caps, both cap modes, and the robust walk).  The router is
the KNN one here, numpy on both sides; the MLP router is held in
``tests/test_torch_router.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import pareto as jpareto
from repro.core import problem as jproblem
from repro.core import robatch as jrobatch
from repro.core import scheduler as jscheduler
from repro.core.coreset import select_coreset as jselect_coreset
from repro.data import make_simulated_pool as jmake_pool
from repro.data import make_workload as jmake_workload
from repro_torch.core import pareto, problem, robatch, scheduler
from repro_torch.core.coreset import select_coreset
from repro_torch.data import make_simulated_pool, make_workload


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = dict(n_train=192, n_val=48, n_test=96)


def same(a, b, path="value"):
    """Bit-for-bit equality of two results, one from each framework: arrays
    by dtype and value (NaNs equal), floats exactly, dataclasses and named
    tuples of the same class name field by field, containers element-wise."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields, path
        for f in a._fields:
            same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def fitted(family, fit="piecewise", task="agnews"):
    """(JAX Robatch, port Robatch), both fitted with the KNN router on the
    same seeded workload and simulated pool."""
    jwl, wl = jmake_workload(task, **N), make_workload(task, **N)
    jrb = jrobatch.Robatch(jmake_pool(family), jwl, router_kind="knn", coreset_size=48,
                           scaling_fit=fit).fit()
    rb = robatch.Robatch(make_simulated_pool(family), wl, router_kind="knn",
                         coreset_size=48, scaling_fit=fit, device="cpu").fit()
    return jrb, rb


@pytest.fixture(scope="module")
def qwen3():
    return fitted("qwen3")


@pytest.mark.parametrize("task", ["agnews", "gsm8k"])
def test_workload_and_pool_are_the_reference(task):
    """The same seed makes the same workload and pool."""
    same(jmake_workload(task, **N), make_workload(task, **N))
    for fam in ("qwen3", "gemma3"):
        same(jmake_pool(fam), make_simulated_pool(fam))


def test_cost_model_matches(qwen3):
    jrb, rb = qwen3
    test = rb.wl.subset_indices("test")
    jcm, cm = jrb.cost_model, rb.cost_model
    rng = np.random.default_rng(3)
    for k in range(len(rb.pool)):
        same(jcm.sys_cost(k), cm.sys_cost(k))
        same(jcm.query_cost(k, test), cm.query_cost(k, test))
        same(jcm.expected_query_cost(k, test), cm.expected_query_cost(k, test))
        for b in (1, 3, 8, 17):
            same(jcm.state_cost(k, b, test), cm.state_cost(k, b, test))
            same(jcm.single_model_cost(k, test, b), cm.single_model_cost(k, test, b))
    model, batch = rng.integers(0, 3, len(test)), rng.choice([1, 2, 4, 8], len(test))
    ja = jproblem.Assignment(test, model, batch)
    a = problem.Assignment(test, model, batch)
    same(jcm.amortized_total(ja), cm.amortized_total(a))
    same(jcm.exact_total(ja), cm.exact_total(a))
    same(jproblem.group_into_batches(ja), problem.group_into_batches(a))


@pytest.mark.parametrize("method", ["kcenter", "fl", "herding"])
def test_coreset_matches(method):
    emb = make_workload("agnews", **N).embeddings[:192]
    for m in (1, 17, 48):
        same(jselect_coreset(emb, m, method, seed=5), select_coreset(emb, m, method, seed=5))


@pytest.mark.parametrize("family,fit", [("qwen3", "piecewise"), ("qwen3", "powerlaw"),
                                        ("qwen3", "knn"), ("gemma3", "piecewise")])
def test_calibrations_and_space_match(family, fit):
    """b_max, the ternary-searched b_effect, the grid, the profiled means
    and σ and the scaling fit of every member; the router's labels; the
    candidate space of the test set and its frontiers."""
    jrb, rb = fitted(family, fit)
    same(jrb.train_labels, rb.train_labels)
    same(jrb._train_idx, rb._train_idx)
    same(jrb.profile.coreset_idx, rb.profile.coreset_idx)
    same(jrb.calibrations, rb.calibrations)
    test = rb.wl.subset_indices("test")
    jspace, space = jrb.candidate_space(test), rb.candidate_space(test)
    same(jspace, space)
    same(jpareto.build_frontiers(jspace), pareto.build_frontiers(space))


def budgets(space):
    init = space.cost[:, space.initial_state].sum()
    top = space.cost.max(axis=1).sum()
    return [0.5 * init, init, init + 0.3 * (top - init), init + 1.5 * (top - init)]


@pytest.mark.parametrize("kind", ["heap", "vectorized"])
def test_offline_schedules_match(qwen3, kind):
    jrb, rb = qwen3
    test = rb.wl.subset_indices("test")
    space = rb.candidate_space(test)
    jfn = jscheduler.greedy_schedule if kind == "heap" else jscheduler.greedy_schedule_vectorized
    fn = scheduler.greedy_schedule if kind == "heap" else scheduler.greedy_schedule_vectorized
    for b in budgets(space):
        same(jfn(jrb.candidate_space(test), test, b), fn(space, test, b))
        same(jrb.schedule(test, b, scheduler=kind), rb.schedule(test, b, scheduler=kind))


@pytest.mark.parametrize("cap_mode", ["pack", "defer"])
def test_window_schedules_match(qwen3, cap_mode):
    """``greedy_schedule_window`` over restricted and row-taken spaces, with
    capacity caps (a cap of 0 among them) and the robust walk (λ > 0, a
    cost margin)."""
    jrb, rb = qwen3
    test = rb.wl.subset_indices("test")[:40]
    jspace, space = jrb.candidate_space(test), rb.candidate_space(test)
    rows = np.arange(0, 40, 3)
    jsub = jscheduler.take_rows(jscheduler.restrict_space(jspace, {0, 2}), rows)
    sub = scheduler.take_rows(scheduler.restrict_space(space, {0, 2}), rows)
    same(jsub, sub)
    cases = [dict(), dict(group_caps={0: 1, 1: 2, 2: 1}),
             dict(group_caps={0: 2, 1: 0, 2: 1}, robust_lambda=0.5, cost_margin=0.1),
             dict(allowed_models={0, 1}, robust_lambda=1.0),
             dict(group_caps={0: 1, 2: 1}, scheduler="vectorized")]
    for b in budgets(space)[1:]:
        for kw in cases:
            same(jscheduler.greedy_schedule_window(jspace, test, b, cap_mode=cap_mode, **kw),
                 scheduler.greedy_schedule_window(space, test, b, cap_mode=cap_mode, **kw))
        same(jscheduler.greedy_schedule_window(jsub, test[rows], b, cap_mode=cap_mode,
                                               group_caps={0: 1}),
             scheduler.greedy_schedule_window(sub, test[rows], b, cap_mode=cap_mode,
                                              group_caps={0: 1}))


def _random_space(mod_problem, mod_pareto, rng, n, n_models, n_batches):
    """``tests/test_scheduler.py``'s ``random_space``, built from the given
    framework's ``State`` and ``CandidateSpace``."""
    batches = [1, 2, 4][:n_batches]
    states, cost_cols, util_cols = [], [], []
    base = rng.uniform(0.5, 2.0, size=(n, n_models)).cumsum(axis=1)
    sys_c = rng.uniform(0.5, 3.0, size=n_models).cumsum()
    for k in range(n_models):
        for b in batches:
            states.append(mod_problem.State(k, b))
            cost_cols.append(base[:, k] + sys_c[k] / b)
            util_cols.append(rng.uniform(0, 1, size=n))
    init = states.index(mod_problem.State(0, batches[-1]))
    return mod_pareto.CandidateSpace(states=states, cost=np.stack(cost_cols, 1),
                                      util=np.stack(util_cols, 1), initial_state=init)


def test_vectorized_scheduler_fault_is_pinned_to_the_reference():
    """The seed's failing ``tests/test_scheduler.py::
    test_vectorized_matches_heap_objective`` at ``params=(2, 3, 1, 86,
    0.75)``: the round-based scheduler reaches less than 0.85 of the heap's
    objective there.  A fault of the reference, which the port keeps: its
    schedules on that instance are the reference's, bit for bit."""
    n, k, nb, seed, slack = 2, 3, 1, 86, 0.75
    jspace = _random_space(jproblem, jpareto, np.random.default_rng(seed), n, k, nb)
    space = _random_space(problem, pareto, np.random.default_rng(seed), n, k, nb)
    init = space.cost[:, space.initial_state].sum()
    budget = init + slack * (space.cost.max(axis=1).sum() - init)
    heap = scheduler.greedy_schedule(space, np.arange(n), budget)
    vec = scheduler.greedy_schedule_vectorized(space, np.arange(n), budget)
    same(jscheduler.greedy_schedule(jspace, np.arange(n), budget), heap)
    same(jscheduler.greedy_schedule_vectorized(jspace, np.arange(n), budget), vec)
    assert vec.est_utility < 0.85 * heap.est_utility


def test_free_assignments_and_exec_match(qwen3):
    """``attach_free_assignments`` and ``execute``: a committed assignment's
    exact cost and utilities from the simulated pool, bit for bit."""
    jrb, rb = qwen3
    test = rb.wl.subset_indices("test")
    b = budgets(rb.candidate_space(test))[2]
    jres, res = jrb.schedule(test, b), rb.schedule(test, b)
    jscheduler.attach_free_assignments(jres, [0.25, 0.5])
    scheduler.attach_free_assignments(res, [0.25, 0.5])
    same(jres, res)
    same(jrobatch.execute(jrb.pool, jrb.wl, jres.assignment),
         robatch.execute(rb.pool, rb.wl, res.assignment))
