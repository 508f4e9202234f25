"""The port's control-plane API (specs, the policy registry, ``Gateway``)
against the JAX package's.

With the KNN router the whole offline path is numpy on both sides, so
``Gateway.from_spec(spec).fit()`` gives the JAX package's calibrations, and
``submit()`` under every registered policy gives its ``ExecutionOutcome``
(accuracy, exact cost, invocations, per-query utilities) bit for bit.  The
port's gateway, Robatch and semantic cache run on the card unless
``device="cpu"`` is asked, and raise without one.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import robatch as jrobatch
from repro_torch import api
from repro_torch.core import robatch
from repro_torch.data import make_simulated_pool, make_workload
from repro_torch.serving.semcache import EpsilonModel, SemanticCache, SemanticCacheConfig
from test_torch_core import same


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POOL = dict(task="agnews", n_train=192, n_val=48, n_test=96, seed=0)
PARAMS = {"routellm": dict(tau=0.5, b=8), "frugalgpt": dict(tau=0.5, b=8),
          "batcher-sim": dict(tau=0.5, b=8), "batcher-div": dict(tau=0.5, b=8),
          "obp": dict(tau=0.5, b=8), "batch-only": dict(model=1)}


def specs(mod):
    return [mod.RunSpec(),
            mod.RunSpec(pool=mod.PoolSpec(**POOL, replicas=2, max_replicas=4,
                                          semantic_cache=True, temperature=0.7, top_k=20),
                        policy=mod.PolicySpec("routellm", {"tau": 0.6, "b": 4}),
                        router="knn", coreset_size=32, scaling_fit="powerlaw"),
            mod.RunSpec(pool=mod.PoolSpec(kind="tiny", draft_member="tiny-s", spec_k=3),
                        policy=mod.PolicySpec("obp", {"b": 4}), epsilon=0.02)]


def test_runspec_round_trips_as_the_reference():
    for jspec, spec in zip(specs(japi), specs(api)):
        assert spec.to_dict() == jspec.to_dict()
        assert spec.to_json() == jspec.to_json()
        assert api.RunSpec.from_json(jspec.to_json()) == spec
        assert api.RunSpec.from_dict(spec.to_dict()) == spec
        assert spec.robatch_kwargs() == jspec.robatch_kwargs()
        assert spec.pool.generation_config() == jspec.pool.generation_config() or (
            spec.pool.generation_config().to_dict() == jspec.pool.generation_config().to_dict())
    with pytest.raises(ValueError, match="unknown spec keys"):
        api.RunSpec.from_dict({"routr": "knn"})
    with pytest.raises(ValueError, match="kind"):
        api.PoolSpec(kind="quantum").build()


def test_policy_registry_is_the_reference():
    assert api.list_policies() == japi.list_policies()
    for name in api.list_policies():
        cls, jcls = api.get_policy(name), japi.get_policy(name)
        assert cls.__name__ == jcls.__name__
        assert (cls.requires_budget, cls.cap_mode) == (jcls.requires_budget, jcls.cap_mode)
    with pytest.raises(api.UnknownPolicyError):
        api.get_policy("definitely-not-registered")


@pytest.fixture(scope="module")
def gateways():
    spec = dict(router="knn", coreset_size=48)
    jgw = japi.Gateway.from_spec(japi.RunSpec(pool=japi.PoolSpec(**POOL), **spec)).fit()
    gw = api.Gateway.from_spec(api.RunSpec(pool=api.PoolSpec(**POOL), **spec),
                               device="cpu").fit()
    test = gw.wl.subset_indices("test")
    budget = float(gw.robatch.cost_model.single_model_cost(1, test, 1))
    return jgw, gw, budget


def test_gateway_fit_matches(gateways):
    jgw, gw, _ = gateways
    same(jgw.wl, gw.wl)
    same(jgw.robatch.calibrations, gw.robatch.calibrations)
    same(jgw.robatch.train_labels, gw.robatch.train_labels)
    assert gw.robatch.device == torch.device("cpu")


@pytest.mark.parametrize("name", japi.list_policies())
def test_submit_matches_under_every_policy(gateways, name):
    jgw, gw, budget = gateways
    for b in (budget, 2.5 * budget):
        want = jgw.submit(budget=b, policy=name, **PARAMS.get(name, {}))
        got = gw.submit(budget=b, policy=name, **PARAMS.get(name, {}))
        assert got.accuracy == want.accuracy and got.exact_cost == want.exact_cost
        assert got.n_invocations == want.n_invocations
        same(want.per_query_utility, got.per_query_utility)
    jplan = jgw.plan(budget=budget, policy=name, **PARAMS.get(name, {}))
    plan = gw.plan(budget=budget, policy=name, **PARAMS.get(name, {}))
    for field in ("query_idx", "groups", "group_costs", "est_utility", "est_cost",
                  "schedule", "adaptive", "deferred_idx"):
        same(getattr(jplan, field), getattr(plan, field), field)


def test_tiny_pool_and_http_wait_for_their_slices(gateways):
    """The trained tiny pool and the HTTP front end are ported now
    (``tests/test_torch_tinypool.py``, ``tests/test_torch_http.py``): the pool
    trains on the card unless ``device="cpu"`` is asked, so without one it
    raises, and ``serve(metrics=)`` binds the registry to the server."""
    from repro_torch.http import MetricsRegistry
    from repro_torch.serving.online import OnlineConfig

    _, gw, budget = gateways
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.PoolSpec(kind="tiny", n_train=8, n_test=8, steps=1).build()
    reg = MetricsRegistry()
    gw.serve([], OnlineConfig(budget_per_s=budget), metrics=reg)
    assert "robatch_windows_total" in reg.render()


def test_control_plane_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so device='cuda' is valid here")
    wl, pool = make_workload("agnews", n_train=32, n_val=8, n_test=16), make_simulated_pool()
    for make in (lambda: api.Gateway(pool, wl),
                 lambda: api.Gateway.from_spec(api.RunSpec()),
                 lambda: robatch.Robatch(pool, wl, router_kind="knn"),
                 lambda: SemanticCache(SemanticCacheConfig(), wl.embeddings,
                                       EpsilonModel(np.zeros(2), np.zeros(2)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert jrobatch.Robatch(pool, wl).router_kind == "mlp"   # the JAX one has no device
