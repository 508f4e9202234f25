"""Registered scheduling policies: RoBatch (both scheduler variants), the
five adapted baselines (§6.1.2) and both ablations (§6.3), all behind the
:class:`repro_torch.api.policy.SchedulingPolicy` interface.

Each policy keeps its algorithmic core in :mod:`repro_torch.core` —
``Robatch.schedule`` for the Alg.-1 family; the §6 routing rules, the shared
``batcher_group``/``obp_group`` packing and the FrugalGPT cascade from
:mod:`repro_torch.core.baselines` for the baselines — so a policy's offline
``plan``/``commit`` is **bit-identical** to the legacy entry point it ports
(property-tested in ``tests/test_api.py``).

Online behaviour: Alg.-1 policies expose their full candidate space per
window.  Fixed-assignment baselines (RouteLLM, BATCHER, OBP, the vanilla
cascade's predicted exit level for FrugalGPT) expose a two-point space per
query — the cheapest model and the routed model — so the windowed scheduler
can still degrade gracefully to the cheap model when the rolling budget is
tight, and circuit breaking composes unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.api.policy import Plan, SchedulingPolicy, amortized_group_costs, register_policy
from repro_torch.core.baselines import (
    batch_only,
    batcher_group,
    frugalgpt_execute,
    obp_group,
    router_only,
)
from repro_torch.core.pareto import CandidateSpace
from repro_torch.core.problem import Assignment, State, group_into_batches
from repro_torch.core.robatch import ExecutionOutcome
from repro_torch.core.scheduler import greedy_schedule_window

__all__ = [
    "RobatchPolicy", "RobatchVectorizedPolicy", "RouteLLMPolicy",
    "FrugalGPTPolicy", "BatcherSimPolicy", "BatcherDivPolicy", "OBPPolicy",
    "RouterOnlyPolicy", "BatchOnlyPolicy",
]


# ---------------------------------------------------------------------------
# the Alg.-1 family: full Robatch + ablations (share a Robatch "engine")
# ---------------------------------------------------------------------------

@register_policy("robatch")
class RobatchPolicy(SchedulingPolicy):
    """The paper's full framework: greedy Pareto climb (Alg. 1, Δ-heap)."""

    requires_budget = True
    scheduler = "heap"

    def __init__(self, cap_mode: str = "pack", robust: float = 0.0,
                 cost_margin: float = 0.0):
        if cap_mode not in ("pack", "defer"):
            raise ValueError(f"cap_mode must be 'pack' or 'defer', got {cap_mode!r}")
        if robust < 0 or cost_margin < 0:
            raise ValueError(f"robust λ and cost_margin must be ≥ 0, got "
                             f"robust={robust!r} cost_margin={cost_margin!r}")
        self.cap_mode = cap_mode
        self.robust = float(robust)
        self.cost_margin = float(cost_margin)

    def _post_fit(self) -> None:
        self._engine = self._make_engine()
        self.exec_pool = list(self._engine.pool)
        self.cm = self._engine.cost_model

    def _make_engine(self):
        return self.rb

    def plan(self, query_idx: np.ndarray, budget: Optional[float] = None,
             timings: Optional[dict] = None) -> Plan:
        if budget is None:
            raise ValueError(f"policy {self.name!r} requires a budget")
        res = self._engine.schedule(query_idx, budget, scheduler=self.scheduler,
                                    timings=timings)
        groups = group_into_batches(res.assignment)
        return Plan(query_idx=np.asarray(query_idx), groups=groups,
                    group_costs=amortized_group_costs(self.cm, groups),
                    est_utility=res.est_utility, est_cost=res.amortized_cost,
                    schedule=res)

    def window_space(self, query_idx: np.ndarray) -> CandidateSpace:
        return self._engine.candidate_space(query_idx)

    def plan_window(self, space: CandidateSpace, query_idx: np.ndarray,
                    budget: float, caps: Optional[dict] = None) -> Plan:
        """Windowed Alg. 1 under the class's scheduler variant (the
        vectorized fig11 fast path applies online too), capacity-capped when
        the pool is replicated (capacity-aware Δ-heap packing unless
        ``cap_mode="defer"``), uncertainty-robust when ``robust`` (λ) or
        ``cost_margin`` is set."""
        res = greedy_schedule_window(space, query_idx, budget, group_caps=caps,
                                     scheduler=self.scheduler,
                                     cap_mode=self.cap_mode,
                                     robust_lambda=self.robust,
                                     cost_margin=self.cost_margin)
        groups = group_into_batches(res.assignment)
        return Plan(query_idx=np.asarray(query_idx), groups=groups,
                    group_costs=amortized_group_costs(self.cm, groups),
                    est_utility=res.est_utility, est_cost=res.amortized_cost,
                    schedule=res, deferred_idx=res.deferred_idx)


@register_policy("robatch-vec")
class RobatchVectorizedPolicy(RobatchPolicy):
    """Beyond-paper round-based vectorized Alg. 1 (fig11 fast path)."""

    scheduler = "vectorized"


@register_policy("router-only")
class RouterOnlyPolicy(RobatchPolicy):
    """Ablation: B_k = {1} — pure model selection, no amortization."""

    def _make_engine(self):
        return router_only(self.rb)


@register_policy("batch-only")
class BatchOnlyPolicy(RobatchPolicy):
    """Ablation: a single fixed model m_k; scheduling over its batch sizes
    only.  Plans index into a one-member ``exec_pool`` view."""

    def __init__(self, model: int = 1):
        self.model = int(model)

    def _make_engine(self):
        return batch_only(self.rb, self.model)


# ---------------------------------------------------------------------------
# fixed-assignment baselines
# ---------------------------------------------------------------------------

def _routed_space(cm, query_idx: np.ndarray, u_hat: np.ndarray,
                  routed: np.ndarray, b: int) -> CandidateSpace:
    """Two-point per-query window space for a fixed model assignment: every
    model contributes its (m_k, b) state; a query's routed state carries the
    router's utility estimate, all others 0.  Pareto pruning then leaves
    {cheapest, routed} per query, so windowed Alg. 1 upgrades to the routed
    model when the rolling budget affords it and falls back to the cheapest
    state when it does not."""
    query_idx = np.asarray(query_idx)
    K = u_hat.shape[1]
    states = [State(k, b) for k in range(K)]
    cost = np.stack([cm.state_cost(k, b, query_idx) for k in range(K)], axis=1)
    util = np.zeros_like(cost)
    rows = np.arange(len(query_idx))
    util[rows, routed] = np.clip(u_hat[rows, routed], 0.0, 1.0)
    return CandidateSpace(states=states, cost=cost, util=util,
                          initial_state=int(np.argmin(cost.sum(axis=0))))


class _FixedAssignmentPolicy(SchedulingPolicy):
    """Shared scaffolding: a routing rule over the router's û matrix fixes
    each query's model; `_groups` packs the batches.  One router prediction
    serves both the assignment and the utility estimate."""

    def __init__(self, tau: float = 0.5, b: int = 8):
        self.tau = float(tau)
        self.b = int(b)

    # subclasses: the routing rule, as (n, K) û → (n,) model index
    def _route(self, u_hat: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _groups(self, a: Assignment) -> list[tuple[State, np.ndarray]]:
        return group_into_batches(a)

    def _predict(self, query_idx: np.ndarray) -> np.ndarray:
        return self.rb.router.predict(self.wl.embeddings[np.asarray(query_idx)])

    def plan(self, query_idx: np.ndarray, budget: Optional[float] = None,
             timings: Optional[dict] = None) -> Plan:
        query_idx = np.asarray(query_idx)
        u_hat = self._predict(query_idx)
        a = Assignment(query_idx=query_idx, model=self._route(u_hat),
                       batch=np.full(len(query_idx), self.b, dtype=int))
        groups = self._groups(a)
        est_u = float(np.clip(u_hat[np.arange(len(a)), a.model], 0.0, 1.0).sum())
        return Plan(query_idx=query_idx, groups=groups,
                    group_costs=amortized_group_costs(self.cm, groups),
                    est_utility=est_u, est_cost=self.cm.amortized_total(a))

    def window_space(self, query_idx: np.ndarray) -> CandidateSpace:
        u_hat = self._predict(query_idx)
        return _routed_space(self.cm, query_idx, u_hat,
                             self._route(u_hat), self.b)


@register_policy("routellm")
class RouteLLMPolicy(_FixedAssignmentPolicy):
    """RouteLLM (adapted): weak/strong threshold router + fixed-size batching
    (the rule of :func:`repro_torch.core.baselines.routellm_assignment`)."""

    def _route(self, u_hat: np.ndarray) -> np.ndarray:
        weak, strong = 0, u_hat.shape[1] - 1
        return np.where(u_hat[:, weak] >= self.tau, weak, strong).astype(int)


class _VanillaRoutedPolicy(_FixedAssignmentPolicy):
    """Baselines that reuse Robatch's router for model assignment (§6.1.2):
    cheapest model predicted confident ≥ τ, else the best-û model (the rule
    of :func:`repro_torch.core.baselines.vanilla_router_assignment`)."""

    def __init__(self, tau: float = 0.5, b: int = 8, seed: int = 0):
        super().__init__(tau=tau, b=b)
        self.seed = int(seed)

    def _route(self, u_hat: np.ndarray) -> np.ndarray:
        return np.where(u_hat.max(1) >= self.tau,
                        (u_hat >= self.tau).argmax(1), u_hat.argmax(1)).astype(int)


@register_policy("batcher-sim")
class BatcherSimPolicy(_VanillaRoutedPolicy):
    """BATCHER-SIM (adapted): k-means clusters, batches filled within a
    cluster."""

    mode = "sim"

    def _groups(self, a: Assignment) -> list[tuple[State, np.ndarray]]:
        return batcher_group(self.wl, a, self.b, mode=self.mode, seed=self.seed)

    def plan_window(self, space: CandidateSpace, query_idx: np.ndarray,
                    budget: float, caps: Optional[dict] = None) -> Plan:
        res = greedy_schedule_window(space, query_idx, budget, group_caps=caps,
                                     cap_mode=self.cap_mode)
        groups = self._groups(res.assignment)
        return Plan(query_idx=np.asarray(query_idx), groups=groups,
                    group_costs=amortized_group_costs(self.cm, groups),
                    est_utility=res.est_utility, est_cost=res.amortized_cost,
                    schedule=res, deferred_idx=res.deferred_idx)


@register_policy("batcher-div")
class BatcherDivPolicy(BatcherSimPolicy):
    """BATCHER-DIV (adapted): round-robin across clusters."""

    mode = "div"


@register_policy("obp")
class OBPPolicy(BatcherSimPolicy):
    """OBP (adapted): adaptive clustering + context-length refinement,
    variable batch sizes."""

    mode = "obp"

    def _groups(self, a: Assignment) -> list[tuple[State, np.ndarray]]:
        return obp_group(self.wl, self.pool, a, self.b, seed=self.seed)


# ---------------------------------------------------------------------------
# FrugalGPT: adaptive cascade (plan and execution interleave)
# ---------------------------------------------------------------------------

@register_policy("frugalgpt")
class FrugalGPTPolicy(_FixedAssignmentPolicy):
    """FrugalGPT (adapted): cheap→expensive cascade with a scorer.

    The cascade decides escalation from each level's *response*, so the
    physical plan cannot be known up front: :meth:`plan` returns an adaptive
    placeholder and :meth:`commit` runs the cascade (identical to the legacy
    ``frugalgpt_execute``).  Online windows use the *predicted* exit level
    (first model with û ≥ τ) as the routed state."""

    def plan(self, query_idx: np.ndarray, budget: Optional[float] = None,
             timings: Optional[dict] = None) -> Plan:
        return Plan(query_idx=np.asarray(query_idx), groups=None, adaptive=True)

    def commit(self, plan: Plan) -> ExecutionOutcome:
        return frugalgpt_execute(self.rb, plan.query_idx, self.tau, self.b)

    def _route(self, u_hat: np.ndarray) -> np.ndarray:
        accept = u_hat >= self.tau
        first = accept.argmax(1)                    # 0 when no level accepts —
        return np.where(accept.any(1), first, u_hat.shape[1] - 1).astype(int)
