"""Candidate states, dominance pruning and per-query Pareto frontiers (§5).

Def. 5.1: state s' dominates s on q_i iff cost(s') ≤ cost(s) and û(s') ≥ û(s).
Thm. 5.3 proves pruning dominated states is lossless under amortized per-query
cost (Eq. 13) — property-tested in tests/test_scheduler.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.problem import CostModel, State
from repro_torch.core.scaling import KNNScaling, ModelCalibration

__all__ = ["CandidateSpace", "pareto_frontier", "build_frontiers"]


@dataclass
class CandidateSpace:
    """All candidate states (m_k, b) with per-query cost and proxy utility."""

    states: list[State]           # B̃ = Σ_k |B_k| states
    cost: np.ndarray              # (n, B̃) amortized per-query cost, Eq. 13
    util: np.ndarray              # (n, B̃) proxy utility û_{i,k,b}, Eq. 8
    initial_state: int            # column index of s(0) = (m_1, b_1^effect)
    sigma: np.ndarray | None = None
    # ^ (n, B̃) per-state utility uncertainty (calibration-residual std of the
    #   proxy, ModelCalibration.u_std_at broadcast over queries); None when
    #   the calibration predates the robust walk — the scheduler's robust
    #   mode (utility − λ·σ) degrades to the point-estimate walk then


def build_candidate_space(
    cm: CostModel,
    calibrations: Sequence[ModelCalibration],
    query_idx: np.ndarray,
    u_hat_1: np.ndarray,          # (n, K) router estimates û_{i,k,1}
    query_emb: np.ndarray | None = None,
) -> CandidateSpace:
    """Assemble Eq. 8 proxies and Eq. 13 costs for every (query, state)."""
    query_idx = np.asarray(query_idx)
    n = len(query_idx)
    states: list[State] = []
    cost_cols: list[np.ndarray] = []
    util_cols: list[np.ndarray] = []
    sigma_cols: list[np.ndarray] = []
    initial = -1
    for cal in calibrations:
        k = cal.k
        if isinstance(cal.scaling, KNNScaling):
            assert query_emb is not None, "KNN scaling needs query embeddings"
            rho_fn = cal.scaling.per_query(query_emb)
        else:
            rho_fn = None
        u_std_at = getattr(cal, "u_std_at", {}) or {}
        for b in cal.grid:
            b = int(b)
            states.append(State(k, b))
            cost_cols.append(cm.state_cost(k, b, query_idx))
            if rho_fn is not None:
                rho = rho_fn(b)                      # (n,) query-specific
            else:
                rho = float(np.asarray(cal.scaling(b)))
            util_cols.append(np.clip(u_hat_1[:, k] * rho, 0.0, 1.0))
            sigma_cols.append(np.full(n, float(u_std_at.get(b, 0.0))))
        if k == 0:
            initial = states.index(State(0, int(cal.b_effect)))
    assert initial >= 0, "cheapest model must provide its effective batch size"
    return CandidateSpace(
        states=states,
        cost=np.stack(cost_cols, axis=1),
        util=np.stack(util_cols, axis=1),
        initial_state=initial,
        sigma=np.stack(sigma_cols, axis=1),
    )


def pareto_frontier(cost: np.ndarray, util: np.ndarray, keep: int | None = None) -> np.ndarray:
    """Indices of non-dominated states, sorted by ascending cost.

    A state is dominated if another has (cost ≤, util ≥) with at least one
    strict; ties keep the first occurrence. O(B̃ log B̃).
    """
    order = np.lexsort((-util, cost))          # by cost asc, then util desc
    frontier: list[int] = []
    best_u = -np.inf
    for j in order:
        if util[j] > best_u + 1e-12:
            frontier.append(int(j))
            best_u = float(util[j])
    if keep is not None and keep >= 0:
        # force-include a state (the initial state) even if dominated, as the
        # algorithm anchors the upgrade chain there (it is globally cheapest
        # for m_1's b_effect so in practice it is already on the frontier).
        if keep not in frontier:
            frontier = sorted(set(frontier) | {keep}, key=lambda j: (cost[j], -util[j]))
    return np.array(frontier, dtype=int)


def build_frontiers(space: CandidateSpace) -> list[np.ndarray]:
    """Per-query Pareto frontiers over the candidate space (Fig. 6)."""
    out = []
    for i in range(space.cost.shape[0]):
        fr = pareto_frontier(space.cost[i], space.util[i], keep=space.initial_state)
        # drop frontier entries cheaper than the initial state: the upgrade
        # chain starts at s(0) (it has the globally lowest cost; anything
        # cheaper could only exist through degenerate pricing and is unusable
        # as an "upgrade").
        start = np.where(fr == space.initial_state)[0][0]
        out.append(fr[start:])
    return out
