"""Scheduling-policy protocol + registry — the control plane's open API.

A *policy* answers the two-dimensional routing question the paper poses —
which model AND which batch size for every query — behind one interface, so
RoBatch itself, every adapted baseline and any user-written strategy are
interchangeable at every call site (offline commit, online serving, the
``serve`` CLI, the benchmarks)::

    pol = get_policy("frugalgpt")(tau=0.6, b=8)
    pol.fit(pool, workload, artifacts=rb)       # modeling artifacts shared
    outcome = pol.run(test_idx, budget)         # plan + commit

The modeling-stage artifacts (router, per-model calibrations, cost model,
profiling cache) are fitted ONCE — as a fitted :class:`repro_torch.core.robatch.
Robatch`, which acts as the artifact bundle — and handed to every policy via
``fit(..., artifacts=...)``; policies never re-bill the modeling stage.

Registering a strategy is one decorator::

    @register_policy("my-strategy")
    class MyStrategy(SchedulingPolicy):
        def plan(self, query_idx, budget=None, timings=None): ...

See docs/policies.md for a complete ~20-line example.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.pareto import CandidateSpace
from repro_torch.core.problem import State, group_into_batches
from repro_torch.core.robatch import ExecutionOutcome, Robatch, execute_plan
from repro_torch.core.scheduler import ScheduleResult, greedy_schedule_window

__all__ = ["Plan", "SchedulingPolicy", "UnknownPolicyError", "register_policy",
           "get_policy", "list_policies", "fit_artifacts", "amortized_group_costs"]


@dataclass
class Plan:
    """What a policy decided for a query set: the physical commit plan plus
    its predicted (amortized) utility/cost accounting.

    ``groups`` is the ``[(State, members)]`` batch plan the executor commits;
    ``group_costs`` aligns with it (amortized Eq. 13 dollars per group) so the
    online server can bill held-back groups correctly.  Adaptive policies
    (FrugalGPT's cascade) cannot separate planning from execution — they
    return ``groups=None`` with ``adaptive=True`` and realize the plan inside
    :meth:`SchedulingPolicy.commit`.
    """

    query_idx: np.ndarray
    groups: Optional[list[tuple[State, np.ndarray]]]
    group_costs: Optional[list[float]] = None
    est_utility: Optional[float] = None
    est_cost: Optional[float] = None
    schedule: Optional[ScheduleResult] = None   # present for Alg.-1 policies
    adaptive: bool = False
    deferred_idx: Optional[np.ndarray] = None   # capacity-deferred query ids
    # (windowed plans under per-member group caps; the server requeues these)


def amortized_group_costs(cost_model, groups) -> list[float]:
    """Eq. 13 amortized dollars per physical group of a commit plan."""
    return [float(cost_model.state_cost(int(s.model), int(s.batch), members).sum())
            for s, members in groups]


def fit_artifacts(pool: Sequence, wl, **robatch_kwargs) -> Robatch:
    """Fit the shared modeling-stage artifacts (router, calibrations, cost
    model, profiling cache) once; the fitted Robatch IS the artifact bundle."""
    return Robatch(pool, wl, **robatch_kwargs).fit()


class SchedulingPolicy:
    """Base class / protocol for pluggable routing-with-batching strategies.

    Lifecycle: construct with strategy params → :meth:`fit` against a pool and
    workload (reusing shared artifacts when provided) → :meth:`plan` /
    :meth:`commit` / :meth:`run` offline, or :meth:`window_space` /
    :meth:`plan_window` per admission window from the online server.

    Subclasses must implement :meth:`plan`; everything else has working
    defaults.  ``exec_pool`` is the member list plans refer to by model index
    — the shared pool for most policies, a single-member view for the
    batch-only ablation.
    """

    name: str = ""                  # filled by @register_policy
    requires_budget: bool = False   # True: plan() needs a budget to be useful
    cap_mode: str = "pack"          # replica-cap handling in plan_window:
    #   "pack"  — capacity-aware Δ-heap (greedy_schedule_capped): over-cap
    #             members are re-packed into fewer, larger batches, and only
    #             the unplaceable remainder is deferred;
    #   "defer" — legacy _apply_group_caps post-pass (defer every over-cap
    #             group wholesale) — the safety-net semantics the online
    #             server also applies to caps-unaware policies
    robust: float = 0.0             # λ of the uncertainty-robust walk: each
    #   state's proxy utility is penalized by λ·σ (calibration-residual std);
    #   0 keeps the point-estimate walk bit-identical
    cost_margin: float = 0.0        # worst-case budget margin: the walk draws
    #   the window budget down at cost·(1+margin)

    # fitted attributes (set by fit())
    rb: Optional[Robatch] = None
    pool: Optional[list] = None
    wl = None
    exec_pool: Optional[list] = None
    cm = None        # cost model matching exec_pool's member indexing

    # ------------------------------------------------------------------ fit
    def fit(self, pool: Sequence, wl, artifacts: Optional[Robatch] = None,
            **fit_kwargs) -> "SchedulingPolicy":
        """Bind the policy to a pool/workload.  ``artifacts`` is a fitted
        :class:`Robatch` (the shared modeling bundle); without one the policy
        fits its own with ``fit_kwargs`` forwarded to ``Robatch``."""
        self.pool = list(pool)
        self.wl = wl
        if artifacts is None:
            artifacts = fit_artifacts(self.pool, wl, **fit_kwargs)
        assert artifacts.router is not None, "artifacts must be fitted"
        self.rb = artifacts
        self.exec_pool = self.pool
        self.cm = artifacts.cost_model
        self._post_fit()
        return self

    def _post_fit(self) -> None:
        """Hook for derived state (ablation clones, cached spaces, ...)."""

    # ------------------------------------------------------------- offline
    def plan(self, query_idx: np.ndarray, budget: Optional[float] = None,
             timings: Optional[dict] = None) -> Plan:
        """Decide (model, batch) for every query; optionally fill a latency
        breakdown into ``timings`` (at minimum ``total``)."""
        raise NotImplementedError

    def plan_timed(self, query_idx: np.ndarray,
                   budget: Optional[float] = None) -> tuple[Plan, dict]:
        """Instrumented :meth:`plan` — works for ANY registered policy; the
        Robatch family refines it with the §6.5 router/proxy/greedy split."""
        timings: dict = {}
        t0 = time.perf_counter()
        plan = self.plan(query_idx, budget, timings=timings)
        timings.setdefault("total", time.perf_counter() - t0)
        return plan, timings

    def commit(self, plan: Plan) -> ExecutionOutcome:
        """Execute a plan against ``exec_pool``, billing actual tokens."""
        assert plan.groups is not None, f"{self.name}: plan has no groups"
        return execute_plan(self.exec_pool, self.wl, plan.groups, plan.query_idx)

    def run(self, query_idx: np.ndarray,
            budget: Optional[float] = None) -> ExecutionOutcome:
        """plan + commit in one call (what ``Gateway.submit`` invokes)."""
        return self.commit(self.plan(query_idx, budget))

    # -------------------------------------------------------------- online
    def window_space(self, query_idx: np.ndarray) -> CandidateSpace:
        """Per-query candidate states for one admission window.  The online
        server restricts this to surviving (breaker-closed) models, runs
        budget admission against the initial-state column, and hands the
        restricted space back to :meth:`plan_window`."""
        raise NotImplementedError(f"{self.name} does not support online serving")

    def plan_window(self, space: CandidateSpace, query_idx: np.ndarray,
                    budget: float, caps: Optional[dict] = None) -> Plan:
        """One online scheduling round over a (restricted) window space.
        Default: windowed Alg. 1 + per-state batch packing.  ``caps`` maps
        model index → max batch-groups this window (replicated members'
        concurrency, :class:`repro_torch.serving.pool.ReplicaSet`), handled per
        ``cap_mode`` (capacity-aware packing by default); query ids that
        still don't fit come back in ``Plan.deferred_idx`` for the server to
        requeue."""
        res = greedy_schedule_window(space, query_idx, budget, group_caps=caps,
                                     cap_mode=self.cap_mode,
                                     robust_lambda=self.robust,
                                     cost_margin=self.cost_margin)
        groups = group_into_batches(res.assignment)
        return Plan(query_idx=np.asarray(query_idx), groups=groups,
                    group_costs=amortized_group_costs(self.cm, groups),
                    est_utility=res.est_utility, est_cost=res.amortized_cost,
                    schedule=res, deferred_idx=res.deferred_idx)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[SchedulingPolicy]] = {}


class UnknownPolicyError(KeyError):
    """Raised by :func:`get_policy` for names that were never registered."""


def register_policy(name: str):
    """Class decorator: make a :class:`SchedulingPolicy` subclass available
    as ``get_policy(name)`` (and thereby to the Gateway, the online server,
    ``serve --policy`` and the smoke suite)."""

    def deco(cls: type[SchedulingPolicy]) -> type[SchedulingPolicy]:
        if not (isinstance(cls, type) and issubclass(cls, SchedulingPolicy)):
            raise TypeError(f"@register_policy({name!r}) needs a SchedulingPolicy "
                            f"subclass, got {cls!r}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_policy(name: str) -> type[SchedulingPolicy]:
    """Look up a registered policy class by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownPolicyError(
            f"unknown policy {name!r}; registered: {sorted(_REGISTRY)}") from None


def list_policies() -> list[str]:
    """Sorted names of every registered policy."""
    return sorted(_REGISTRY)
