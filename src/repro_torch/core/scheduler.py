"""Greedy budget-constrained scheduling — Algorithm 1 (§5).

Implementations:
  * ``greedy_schedule``          — faithful Alg. 1: heap keyed by Δ (Eq. 14).
  * ``greedy_schedule_window``   — windowed/online entry point: restricts the
    candidate space to the surviving models (circuit breaking) and re-anchors
    the initial state, then runs Alg. 1 over one admission window against the
    rolling-budget slice handed down by :mod:`repro_torch.serving.online`.
  * ``brute_force_schedule``     — exact enumeration for micro instances; used
    by the property tests to bound greedy sub-optimality and to validate the
    NP-hardness reduction (Thm. 3.2).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.pareto import CandidateSpace, build_frontiers
from repro_torch.core.problem import Assignment

__all__ = ["ScheduleResult", "greedy_schedule", "greedy_schedule_vectorized",
           "greedy_schedule_window", "greedy_schedule_capped", "restrict_space",
           "take_rows", "brute_force_schedule", "attach_free_assignments"]


@dataclass
class ScheduleResult:
    assignment: Assignment
    est_utility: float           # Σ û at the chosen states (objective, Eq. 5)
    amortized_cost: float        # Σ Eq. 13 costs — what the budget tracked
    spent_budget: float          # budget consumed (== amortized_cost)
    n_upgrades: int
    infeasible: bool             # initial assignment alone exceeded the budget
    deferred_idx: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=int))
    # ^ query ids pushed out of this window by per-member capacity caps
    #   (``group_caps``); the online server requeues them for the next round
    n_packed: int = 0
    # ^ queries the capacity-aware pass moved to a wider batch (or another
    #   member) to fit the caps — the autoscaler's packing-pressure signal
    deferred_by_member: dict = field(default_factory=dict)
    # ^ model index → how many of ``deferred_idx`` ITS cap pushed out; keys
    #   the backlog to the bottleneck member so a later autoscaler can grow
    #   only it (Σ values == len(deferred_idx))
    packed_by_member: dict = field(default_factory=dict)
    # ^ model index → queries the capacity pass moved off (or within) that
    #   over-cap member (Σ values == n_packed)
    n_free: int = 0
    # ^ zero-cost assignments folded into this round's accounting after the
    #   frontier walk (semantic-cache hits priced at cost=0, utility
    #   u·(1−ε(sim)) — see attach_free_assignments)
    free_utility: float = 0.0
    # ^ Σ discounted utility of those free assignments (already included in
    #   est_utility once attached)


def attach_free_assignments(res: ScheduleResult,
                            utilities) -> ScheduleResult:
    """Fold zero-cost assignments into a window's schedule accounting.

    A semantic-cache hit serves a query at zero marginal cost with utility
    ``u·(1−ε(sim))`` — the same (cost, utility) currency the frontier walk
    optimizes, just with a degenerate cost column.  The online server calls
    this after :func:`greedy_schedule_window` so the round's ``est_utility``
    covers the hits exactly like any committed upgrade, while
    ``amortized_cost``/``spent_budget`` are untouched (free assignments draw
    nothing from the bucket)."""
    utilities = [float(u) for u in utilities]
    res.n_free += len(utilities)
    res.free_utility += sum(utilities)
    res.est_utility += sum(utilities)
    return res


def _robust_view(space: CandidateSpace, robust_lambda: float,
                 cost_margin: float) -> tuple[np.ndarray, np.ndarray]:
    """(walk_cost, walk_util) the robust frontier walk decides on.

    ``robust_lambda`` penalizes each state's proxy utility by λ·σ (its
    calibration-residual std, :attr:`CandidateSpace.sigma`) — upgrades whose
    estimated gain rests on noisy calibration stop looking attractive.
    ``cost_margin`` inflates every cost by (1 + margin): the walk draws the
    budget down at worst-case prices, so a realized cost overrun up to the
    margin still lands inside the window's slice.  At λ=0 and margin=0 the
    original matrices are returned UNCHANGED (same objects), so the default
    path stays bit-identical to the point-estimate walk (property-tested).
    """
    lam = float(robust_lambda)
    walk_util = (space.util - lam * space.sigma
                 if lam > 0.0 and space.sigma is not None else space.util)
    mfac = 1.0 + float(cost_margin)
    walk_cost = space.cost * mfac if mfac != 1.0 else space.cost
    return walk_cost, walk_util


def greedy_schedule(
    space: CandidateSpace,
    query_idx: np.ndarray,
    budget: float,
    robust_lambda: float = 0.0,
    cost_margin: float = 0.0,
) -> ScheduleResult:
    """Algorithm 1.

    Every query starts at s(0) = (m_1, b_1^effect); the priority queue holds
    (−Δ, query, frontier position); upgrades are committed while budget
    remains.  A popped-but-unaffordable upgrade drops the query from the queue
    (Alg. 1 line 11–12).  Note this drop is *lossless*, not just faithful: the
    remaining budget is monotonically decreasing and frontier costs are
    ascending, so an upgrade that is unaffordable now can never become
    affordable later, and no later state of the same query can be cheaper.

    ``robust_lambda``/``cost_margin`` switch on the uncertainty-robust walk
    (see :func:`_robust_view`): frontiers, Δ gains and budget feasibility use
    the penalized utility and worst-case cost, while the returned
    ``est_utility``/``amortized_cost`` stay in raw (point-estimate) currency —
    ``spent_budget`` is the worst-case draw the walk committed to.
    """
    query_idx = np.asarray(query_idx)
    n = len(query_idx)
    walk_cost, walk_util = _robust_view(space, robust_lambda, cost_margin)
    if walk_cost is space.cost and walk_util is space.util:
        frontiers = build_frontiers(space)
    else:
        frontiers = build_frontiers(CandidateSpace(
            states=space.states, cost=walk_cost, util=walk_util,
            initial_state=space.initial_state))
    cost, util = walk_cost, walk_util

    # position of each query along its frontier (0 == initial state)
    pos = np.zeros(n, dtype=int)
    remaining = budget
    for i in range(n):
        remaining -= cost[i, frontiers[i][0]]
    infeasible = remaining < 0

    heap: list[tuple[float, int, int]] = []   # (−Δ, i, next_pos)

    def push_next(i: int):
        fr = frontiers[i]
        t = pos[i]
        if t + 1 >= len(fr):
            return
        s_now, s_next = fr[t], fr[t + 1]
        dc = cost[i, s_next] - cost[i, s_now]
        du = util[i, s_next] - util[i, s_now]
        delta = du / max(dc, 1e-12)           # Eq. 14
        heapq.heappush(heap, (-delta, i, t + 1))

    for i in range(n):
        push_next(i)

    upgrades = 0
    while heap and remaining > 0:
        _neg_delta, i, t = heapq.heappop(heap)
        if t != pos[i] + 1:
            continue                           # stale entry
        fr = frontiers[i]
        inc = cost[i, fr[t]] - cost[i, fr[t - 1]]
        if remaining - inc < 0:
            continue                           # Alg. 1 line 11–12 (lossless drop)
        pos[i] = t
        remaining -= inc
        upgrades += 1
        push_next(i)

    chosen = np.array([frontiers[i][pos[i]] for i in range(n)])
    model = np.array([space.states[j].model for j in chosen])
    batch = np.array([space.states[j].batch for j in chosen])
    est_u = float(space.util[np.arange(n), chosen].sum())
    amort = float(space.cost[np.arange(n), chosen].sum())
    return ScheduleResult(
        assignment=Assignment(query_idx=query_idx, model=model, batch=batch),
        est_utility=est_u,
        amortized_cost=amort,
        spent_budget=budget - remaining if not infeasible else amort,
        n_upgrades=upgrades,
        infeasible=bool(infeasible),
    )


def greedy_schedule_vectorized(
    space: CandidateSpace,
    query_idx: np.ndarray,
    budget: float,
    rounds: int = 64,
    robust_lambda: float = 0.0,
    cost_margin: float = 0.0,
) -> ScheduleResult:
    """Beyond-paper: round-based vectorized variant of Alg. 1.

    The paper's own latency breakdown (Fig. 12) shows the heap loop dominates
    scheduling time.  This variant commits upgrades in ROUNDS: each round
    computes every query's next-transition Δ (vectorized), argsorts once, and
    commits the affordable prefix in Δ order.  Within a round a query commits
    at most one upgrade, so the ordering differs from the global heap only
    when a query's *successive* Δs straddle other queries' — rare on real
    frontiers (Δ decreases along a frontier by construction of Pareto
    dominance).  Objective parity is property-tested ≥ heap·(1−ε); speed is
    benchmarked in fig11.
    """
    query_idx = np.asarray(query_idx)
    n = len(query_idx)
    walk_cost, walk_util = _robust_view(space, robust_lambda, cost_margin)
    if walk_cost is space.cost and walk_util is space.util:
        frontiers = build_frontiers(space)
    else:
        frontiers = build_frontiers(CandidateSpace(
            states=space.states, cost=walk_cost, util=walk_util,
            initial_state=space.initial_state))
    max_t = max(len(f) for f in frontiers)
    # pad frontiers into a dense (n, max_t) matrix of state columns
    fr = np.full((n, max_t), -1, dtype=int)
    for i, f in enumerate(frontiers):
        fr[i, : len(f)] = f
    fr_len = np.array([len(f) for f in frontiers])
    rows = np.arange(n)
    costs = np.where(fr >= 0, walk_cost[rows[:, None], np.maximum(fr, 0)], np.inf)
    utils = np.where(fr >= 0, walk_util[rows[:, None], np.maximum(fr, 0)], -np.inf)

    pos = np.zeros(n, dtype=int)
    remaining = budget - costs[:, 0].sum()
    infeasible = remaining < 0
    upgrades = 0
    for _ in range(rounds):
        has_next = pos + 1 < fr_len
        nxt = np.minimum(pos + 1, max_t - 1)
        inc = np.where(has_next, costs[rows, nxt] - costs[rows, pos], np.inf)
        du = np.where(has_next, utils[rows, nxt] - utils[rows, pos], -np.inf)
        with np.errstate(invalid="ignore"):
            delta = np.where(has_next, du / np.maximum(inc, 1e-12), -np.inf)
        order = np.argsort(-delta, kind="stable")
        inc_sorted = inc[order]
        valid = np.isfinite(inc_sorted)
        csum = np.cumsum(np.where(valid, inc_sorted, 0.0))
        affordable = valid & (csum <= remaining + 1e-12) & (delta[order] > 0)
        take = order[affordable]
        if len(take) == 0:
            break
        pos[take] += 1
        remaining -= inc[take].sum()
        upgrades += len(take)
    chosen = fr[rows, pos]
    model = np.array([space.states[j].model for j in chosen])
    batch = np.array([space.states[j].batch for j in chosen])
    est_u = float(space.util[rows, chosen].sum())
    amort = float(space.cost[rows, chosen].sum())
    return ScheduleResult(
        assignment=Assignment(query_idx=query_idx, model=model, batch=batch),
        est_utility=est_u, amortized_cost=amort,
        spent_budget=budget - remaining if not infeasible else amort,
        n_upgrades=upgrades, infeasible=bool(infeasible))


def restrict_space(space: CandidateSpace, allowed_models: set[int]) -> CandidateSpace:
    """Project a candidate space onto the states of ``allowed_models``.

    This is how circuit breaking reaches the scheduler: an open breaker
    removes every (m_k, b) state of the tripped model from the decision space,
    so rescheduled queries can only land on surviving models.  The initial
    state is re-anchored to the cheapest surviving column (total cost over the
    window) — if m_1 itself tripped, the upgrade chain now starts at the
    cheapest surviving model's state, preserving Alg. 1's anchor invariant.
    """
    keep = [j for j, s in enumerate(space.states) if s.model in allowed_models]
    if not keep:
        raise ValueError("restrict_space: no states survive the model mask")
    cost = space.cost[:, keep]
    util = space.util[:, keep]
    if space.states[space.initial_state].model in allowed_models:
        initial = keep.index(space.initial_state)
    else:
        initial = int(np.argmin(cost.sum(axis=0)))
    return CandidateSpace(states=[space.states[j] for j in keep],
                          cost=cost, util=util, initial_state=initial,
                          sigma=(space.sigma[:, keep]
                                 if space.sigma is not None else None))


def take_rows(space: CandidateSpace, rows: np.ndarray) -> CandidateSpace:
    """Row-subset of a candidate space (admission control keeps a prefix of
    the window; the deferred suffix is rescheduled next tick)."""
    rows = np.asarray(rows)
    return CandidateSpace(states=space.states, cost=space.cost[rows],
                          util=space.util[rows], initial_state=space.initial_state,
                          sigma=(space.sigma[rows]
                                 if space.sigma is not None else None))


def _apply_group_caps(res: ScheduleResult, space: CandidateSpace,
                      group_caps: dict[int, int]) -> ScheduleResult:
    """Enforce per-member batch-group capacity on a window's schedule.

    Safety net only: the capacity-aware walk (:func:`greedy_schedule_capped`,
    ``cap_mode="pack"``) packs caps into the schedule itself; this post-pass
    survives for ``cap_mode="defer"`` and for caps-unaware policies whose
    plans the online server has to bound after the fact.

    A member backed by N replicas can run N batch-groups concurrently, so one
    admission window may commit at most ``group_caps[k]`` groups to model k.
    The assignment is packed exactly like :func:`group_into_batches` (chunks
    of b per state); over-cap models keep their highest-estimated-utility
    groups and the rest are *deferred* — returned via ``deferred_idx`` so the
    server retries them next window (capacity backpressure, the same shape as
    budget backpressure — never a drop)."""
    a = res.assignment
    n = len(a.query_idx)
    state_col = {(s.model, s.batch): j for j, s in enumerate(space.states)}
    rows_by_state: dict[tuple[int, int], list[int]] = {}
    for i in range(n):
        rows_by_state.setdefault((int(a.model[i]), int(a.batch[i])), []).append(i)
    by_model: dict[int, list[tuple[float, list[int]]]] = {}
    for (k, b), rows in rows_by_state.items():
        j = state_col[(k, b)]
        for s in range(0, len(rows), b):
            chunk = rows[s:s + b]
            by_model.setdefault(k, []).append((float(space.util[chunk, j].sum()), chunk))
    overflow: list[int] = []
    deferred_by: dict[int, int] = {}
    for k, groups in by_model.items():
        cap = group_caps.get(k)
        if cap is None or len(groups) <= cap:
            continue
        groups.sort(key=lambda g: -g[0])          # stable: ties keep FCFS order
        for _u, chunk in groups[cap:]:
            overflow.extend(chunk)
            deferred_by[int(k)] = deferred_by.get(int(k), 0) + len(chunk)
    if not overflow:
        return res
    keep = np.setdiff1d(np.arange(n), np.asarray(overflow))
    chosen = np.array([state_col[(int(a.model[i]), int(a.batch[i]))] for i in keep],
                      dtype=int)
    return ScheduleResult(
        assignment=Assignment(query_idx=a.query_idx[keep], model=a.model[keep],
                              batch=a.batch[keep]),
        est_utility=float(space.util[keep, chosen].sum()),
        amortized_cost=float(space.cost[keep, chosen].sum()),
        spent_budget=float(space.cost[keep, chosen].sum()),
        n_upgrades=res.n_upgrades,
        infeasible=res.infeasible,
        deferred_idx=np.asarray(a.query_idx)[np.sort(np.asarray(overflow))],
        deferred_by_member=deferred_by,
    )


def _group_demand(model: np.ndarray, batch: np.ndarray) -> dict[int, int]:
    """Physical batch-groups each member must run for an assignment:
    ``Σ_b ceil(n_{k,b} / b)`` — exactly how :func:`group_into_batches` chunks."""
    demand: dict[int, int] = {}
    for k in np.unique(model):
        mask_k = model == k
        g = 0
        for b in np.unique(batch[mask_k]):
            g += int(np.ceil(int((mask_k & (batch == b)).sum()) / int(b)))
        demand[int(k)] = g
    return demand


def greedy_schedule_capped(
    space: CandidateSpace,
    query_idx: np.ndarray,
    budget: float,
    group_caps: dict[int, int],
    scheduler: str = "heap",
    robust_lambda: float = 0.0,
    cost_margin: float = 0.0,
) -> ScheduleResult:
    """Capacity-aware Alg. 1: pack the window instead of deferring it.

    The frontier walk runs unconstrained first; when the resulting schedule
    demands more concurrent batch-groups of a member than its cap (its
    healthy-replica count), the capacity pass re-scores that member's states
    toward *fewer, larger batches*:

    1. **Merge** — the narrowest batch in use on an over-cap member is folded
       into its next-wider sibling state (Eq. 13 cost is decreasing in b, so
       every merge refunds budget; group count is non-increasing and the
       number of distinct states strictly decreases, so the loop terminates).
    2. **Spill** — demand that exceeds even the widest packing
       (``n_k > cap_k · b_max``) moves the lowest-û overflow queries to the
       cheapest affordable state of a member with spare group capacity.
    3. **Defer** — only what neither packing nor spilling can place comes back
       in ``deferred_idx`` (the online server requeues it next window).

    When no cap binds the result is **bit-identical** to the uncapped
    schedule (property-tested), so caps cost nothing on the happy path.
    ``n_packed`` counts queries steps 1–2 moved — the capacity-pressure
    signal :class:`repro_torch.serving.autoscale.Autoscaler` scales on.
    """
    query_idx = np.asarray(query_idx)
    fn = greedy_schedule_vectorized if scheduler == "vectorized" else greedy_schedule
    res = fn(space, query_idx, budget, robust_lambda=robust_lambda,
             cost_margin=cost_margin)
    caps = {int(k): int(c) for k, c in group_caps.items() if c is not None}
    a = res.assignment
    if all(d <= caps.get(k, d) for k, d in _group_demand(a.model, a.batch).items()):
        return res                                  # caps never bind: untouched
    # the packing passes keep deciding in the walk's currency: worst-case
    # prices draw the refunded budget down, penalized utilities rank the
    # spill victims.  mfac == 1.0 and walk_util is space.util at the default
    # λ=0/margin=0, so those paths stay bit-identical to the prior code.
    mfac = 1.0 + float(cost_margin)
    _, walk_util = _robust_view(space, robust_lambda, cost_margin)

    n = len(a.query_idx)
    state_col = {(s.model, s.batch): j for j, s in enumerate(space.states)}
    col = np.array([state_col[(int(a.model[i]), int(a.batch[i]))]
                    for i in range(n)], dtype=int)
    cols_of: dict[int, list[int]] = {}              # model → cols, batch asc
    for j, s in enumerate(space.states):
        cols_of.setdefault(int(s.model), []).append(j)
    for k in cols_of:
        cols_of[k].sort(key=lambda j: space.states[j].batch)

    active = np.ones(n, dtype=bool)
    remaining = budget - res.amortized_cost * mfac
    n_packed = 0
    deferred_rows: list[int] = []
    # both keyed by the OVER-CAP member whose cap forced the move/defer (the
    # bottleneck signal), not by where a spilled query happened to land
    packed_by: dict[int, int] = {}
    deferred_by: dict[int, int] = {}

    def used_counts(k: int) -> dict[int, int]:
        out = {}
        for j in cols_of[k]:
            c = int((active & (col == j)).sum())
            if c:
                out[j] = c
        return out

    def demand_of(k: int) -> int:
        return sum(int(np.ceil(c / space.states[j].batch))
                   for j, c in used_counts(k).items())

    def fits_one_more(k: int, j: int) -> bool:
        cap = caps.get(k)
        if cap is None:
            return True
        b = space.states[j].batch
        at_j = int((active & (col == j)).sum())
        extra = 1 if at_j % b == 0 else 0           # a new group only at multiples
        return demand_of(k) + extra <= cap

    for k in sorted(caps):
        if k not in cols_of:
            continue                                # model absent from this space
        cap = caps[k]
        # 1. merge: narrowest state in use → its next-wider sibling
        while demand_of(k) > cap:
            merged = False
            for j in sorted(used_counts(k), key=lambda j: space.states[j].batch):
                wider = [w for w in cols_of[k]
                         if space.states[w].batch > space.states[j].batch]
                if not wider:
                    continue
                w = wider[0]
                rows = np.where(active & (col == j))[0]
                remaining += float((space.cost[rows, j] - space.cost[rows, w]).sum()) * mfac
                col[rows] = w
                n_packed += len(rows)
                packed_by[k] = packed_by.get(k, 0) + len(rows)
                merged = True
                break
            if not merged:
                break                               # everything at the widest state
        over = demand_of(k) - cap
        if over <= 0:
            continue
        # 2./3. spill overflow beyond cap·b_max to members with headroom
        jw = cols_of[k][-1]
        rows_k = np.where(active & (col == jw))[0]
        order = rows_k[np.argsort(walk_util[rows_k, jw], kind="stable")]
        n_keep = max(0, cap) * int(space.states[jw].batch)
        for i in order[: max(0, len(rows_k) - n_keep)]:
            remaining += float(space.cost[i, jw]) * mfac   # refund the vacated state
            active[i] = False
            placed = False
            cand = [j for kk, js in cols_of.items() if kk != k for j in js]
            cand.sort(key=lambda j: float(space.cost[i, j]))
            for j in cand:
                kk = int(space.states[j].model)
                if caps.get(kk, 1) <= 0 or not fits_one_more(kk, j):
                    continue
                if float(space.cost[i, j]) * mfac > remaining + 1e-12:
                    continue
                col[i] = j
                active[i] = True
                remaining -= float(space.cost[i, j]) * mfac
                n_packed += 1
                packed_by[k] = packed_by.get(k, 0) + 1
                placed = True
                break
            if not placed:
                deferred_rows.append(int(i))
                deferred_by[k] = deferred_by.get(k, 0) + 1

    keep = np.where(active)[0]
    chosen = col[keep]
    model = np.array([space.states[j].model for j in chosen], dtype=int)
    batch = np.array([space.states[j].batch for j in chosen], dtype=int)
    dropped = np.sort(np.asarray(deferred_rows, dtype=int))
    return ScheduleResult(
        assignment=Assignment(query_idx=a.query_idx[keep], model=model, batch=batch),
        est_utility=float(space.util[keep, chosen].sum()),
        amortized_cost=float(space.cost[keep, chosen].sum()),
        spent_budget=float(space.cost[keep, chosen].sum()),
        n_upgrades=res.n_upgrades,
        infeasible=res.infeasible,
        deferred_idx=np.asarray(a.query_idx)[dropped],
        n_packed=n_packed,
        deferred_by_member=deferred_by,
        packed_by_member=packed_by,
    )


def greedy_schedule_window(
    space: CandidateSpace,
    query_idx: np.ndarray,
    budget: float,
    allowed_models: set[int] | None = None,
    group_caps: dict[int, int] | None = None,
    scheduler: str = "heap",
    cap_mode: str = "pack",
    robust_lambda: float = 0.0,
    cost_margin: float = 0.0,
) -> ScheduleResult:
    """One online scheduling round: Alg. 1 over a single admission window.

    The offline algorithm sees the whole test set and the whole budget; the
    online server calls this once per deadline window with (a) the queries
    that arrived inside the window and (b) the budget slice currently in the
    token bucket.  The frontier machinery is reused unchanged — only the
    candidate space is restricted to surviving models first.

    ``group_caps`` maps model index → max batch-groups this window (a
    replicated member's replica count — see
    :class:`repro_torch.serving.pool.ReplicaSet`).  A cap of 0 removes the model
    from the window's space outright (all replicas down).  ``cap_mode="pack"``
    (the default) takes the caps into the frontier walk itself via
    :func:`greedy_schedule_capped` — over-cap members are re-packed into
    fewer, larger batches and only the truly unplaceable remainder is
    deferred; ``cap_mode="defer"`` keeps the legacy
    :func:`_apply_group_caps` post-pass (the safety net caps-unaware policies
    fall back to), which defers every over-cap group wholesale.  Either way
    the pushed-out queries come back via ``ScheduleResult.deferred_idx``.
    ``scheduler`` picks the Alg. 1 variant (``"heap"`` or ``"vectorized"``,
    as offline).
    """
    if group_caps:
        saturated = {k for k, cap in group_caps.items() if cap is not None and cap <= 0}
        if saturated:
            candidates = (set(allowed_models) if allowed_models is not None
                          else {s.model for s in space.states})
            allowed_models = candidates - saturated
            if not allowed_models:
                # every member saturated: the whole window is capacity-
                # deferred (backpressure, not a crash — retried next round)
                qi = np.asarray(query_idx)
                empty = Assignment(query_idx=qi[:0],
                                   model=np.empty(0, dtype=int),
                                   batch=np.empty(0, dtype=int))
                return ScheduleResult(assignment=empty, est_utility=0.0,
                                      amortized_cost=0.0, spent_budget=0.0,
                                      n_upgrades=0, infeasible=False,
                                      deferred_idx=qi.copy())
    if allowed_models is not None:
        space = restrict_space(space, set(allowed_models))
    if group_caps and cap_mode == "pack":
        return greedy_schedule_capped(space, query_idx, budget, group_caps,
                                      scheduler=scheduler,
                                      robust_lambda=robust_lambda,
                                      cost_margin=cost_margin)
    fn = greedy_schedule_vectorized if scheduler == "vectorized" else greedy_schedule
    res = fn(space, query_idx, budget, robust_lambda=robust_lambda,
             cost_margin=cost_margin)
    if group_caps:
        res = _apply_group_caps(res, space, group_caps)
    return res


def brute_force_schedule(space: CandidateSpace, query_idx: np.ndarray,
                         budget: float) -> ScheduleResult:
    """Exact optimum by enumeration over the *pruned frontiers* (micro instances).

    Exponential — guarded to ≤ ~2M combinations; tests use n ≤ 8, |frontier| ≤ 5.
    """
    query_idx = np.asarray(query_idx)
    n = len(query_idx)
    frontiers = build_frontiers(space)
    sizes = [len(f) for f in frontiers]
    n_comb = int(np.prod(sizes))
    if n_comb > 2_000_000:
        raise ValueError(f"instance too large for brute force: {n_comb} combinations")
    cost, util = space.cost, space.util
    best_u, best_choice = -np.inf, None
    for combo in itertools.product(*[range(s) for s in sizes]):
        c = sum(cost[i, frontiers[i][t]] for i, t in enumerate(combo))
        if c > budget + 1e-9:
            continue
        u = sum(util[i, frontiers[i][t]] for i, t in enumerate(combo))
        if u > best_u:
            best_u, best_choice = u, combo
    if best_choice is None:                    # even all-initial is infeasible
        best_choice = tuple(0 for _ in range(n))
        best_u = sum(util[i, frontiers[i][0]] for i in range(n))
    chosen = np.array([frontiers[i][t] for i, t in enumerate(best_choice)])
    model = np.array([space.states[j].model for j in chosen])
    batch = np.array([space.states[j].batch for j in chosen])
    amort = float(cost[np.arange(n), chosen].sum())
    return ScheduleResult(
        assignment=Assignment(query_idx=query_idx, model=model, batch=batch),
        est_utility=float(best_u),
        amortized_cost=amort,
        spent_budget=amort,
        n_upgrades=0,
        infeasible=amort > budget + 1e-9,
    )
