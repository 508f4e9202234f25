"""Adapted baselines (§6.1.2) and ablation variants (§6.3).

Routing baselines (RouteLLM, FrugalGPT) are made batch-capable by grouping the
queries routed to each model into fixed-size batches; batching baselines
(BATCHER-SIM/DIV, OBP) reuse Robatch's own non-batched router for model
assignment and then apply their grouping strategy — exactly the paper's
adaptation protocol.

Ablations: Router-Only (B_k = {1}) and Batch-Only (single fixed model m_k,
scheduling restricted to its batch-size space).
"""
from __future__ import annotations

import hashlib
from dataclasses import replace as dc_replace

import numpy as np

from repro_torch.core.problem import Assignment, CostModel, State
from repro_torch.core.robatch import ExecutionOutcome, Robatch
from repro_torch.data.workload import Workload

__all__ = [
    "single_model_assignment", "vanilla_router_assignment", "routellm_assignment",
    "frugalgpt_execute", "batcher_group", "batcher_assignment_plan",
    "obp_group", "obp_plan", "router_only", "batch_only", "kmeans",
]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Plain numpy k-means (cluster ids) — fully vectorized (scatter-add
    center updates; the naive per-cluster loop is O(k·n) Python at 16k-query
    scale, fig11)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    k = max(1, min(k, len(x)))
    centers = x[rng.choice(len(x), k, replace=False)]
    assign = np.zeros(len(x), dtype=int)
    x_sq = (x ** 2).sum(1)
    for _ in range(iters):
        d2 = x_sq[:, None] - 2.0 * (x @ centers.T) + (centers ** 2).sum(1)[None, :]
        new_assign = d2.argmin(1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        sums = np.zeros_like(centers)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=k).astype(np.float64)
        nonzero = counts > 0
        centers[nonzero] = sums[nonzero] / counts[nonzero, None]
    return assign


def _stable_coin(tag: str, idx: np.ndarray) -> np.ndarray:
    h = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little")
    x = (np.asarray(idx, dtype=np.uint64) + np.uint64(h)) * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC2B2AE3D27D4EB4F)
    x ^= x >> np.uint64(29)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


# ---------------------------------------------------------------------------
# single-model + vanilla-router reference points (Fig. 2)
# ---------------------------------------------------------------------------

def single_model_assignment(query_idx: np.ndarray, k: int, b: int) -> Assignment:
    query_idx = np.asarray(query_idx)
    return Assignment(query_idx=query_idx,
                      model=np.full(len(query_idx), k, dtype=int),
                      batch=np.full(len(query_idx), b, dtype=int))


def vanilla_router_assignment(rb: Robatch, query_idx: np.ndarray, tau: float,
                              b: int = 1) -> Assignment:
    """Cheapest model predicted correct with confidence ≥ τ; else best-û model."""
    query_idx = np.asarray(query_idx)
    u = rb.router.predict(rb.wl.embeddings[query_idx])          # (n, K)
    model = np.where(u.max(1) >= tau, (u >= tau).argmax(1), u.argmax(1))
    return Assignment(query_idx=query_idx, model=model.astype(int),
                      batch=np.full(len(query_idx), b, dtype=int))


# ---------------------------------------------------------------------------
# RouteLLM (adapted): strong/weak threshold router + fixed-size batching
# ---------------------------------------------------------------------------

def routellm_assignment(rb: Robatch, query_idx: np.ndarray, tau: float, b: int) -> Assignment:
    """Route to the weak (cheapest) model when its predicted win-rate ≥ τ,
    otherwise the strong (most capable) model; then batch per model at size b."""
    query_idx = np.asarray(query_idx)
    u = rb.router.predict(rb.wl.embeddings[query_idx])
    weak, strong = 0, u.shape[1] - 1
    model = np.where(u[:, weak] >= tau, weak, strong)
    return Assignment(query_idx=query_idx, model=model.astype(int),
                      batch=np.full(len(query_idx), b, dtype=int))


# ---------------------------------------------------------------------------
# FrugalGPT (adapted): cascade with a scorer; per-level fixed-size batching
# ---------------------------------------------------------------------------

def frugalgpt_execute(rb: Robatch, query_idx: np.ndarray, tau: float, b: int) -> ExecutionOutcome:
    """LLM cascade: invoke cheap→expensive, accept when the scorer approves.

    FrugalGPT's scorer is a *learned* utility estimator over the response
    (Chen et al. 2024); per the §6.1.2 adaptation protocol it shares Robatch's
    router as that estimator: accept at level k iff û_{i,k,1} ≥ τ (plus a
    small response-conditioned refinement — the scorer sees the generation,
    which carries a weak extra signal).  Billing accumulates every attempted
    level, which is exactly why cascades lose to routing at tight budgets.
    """
    wl, pool = rb.wl, rb.pool
    query_idx = np.asarray(query_idx)
    u_hat = rb.router.predict(wl.embeddings[query_idx])    # (n, K)
    hat_of = {int(q): u_hat[i] for i, q in enumerate(query_idx)}
    remaining = query_idx.copy()
    util = np.zeros(len(query_idx))
    pos_of = {int(q): i for i, q in enumerate(query_idx)}
    cost = 0.0
    n_inv = 0
    for k in range(len(pool)):
        if len(remaining) == 0:
            break
        last = k == len(pool) - 1
        accepted_mask = np.zeros(len(remaining), dtype=bool)
        for s in range(0, len(remaining), b):
            chunk = remaining[s:s + b]
            res = pool[k].invoke_batch(wl, chunk)
            n_inv += 1
            cost += res.in_tokens * pool[k].c_in / 1e6 + res.out_tokens * pool[k].c_out / 1e6
            # scorer: router estimate refined by a weak response-quality signal
            noise = _stable_coin(f"frugal::{pool[k].name}", chunk) - 0.5
            score = np.array([hat_of[int(q)][k] for q in chunk]) \
                + 0.05 * (res.utilities - 0.5) + 0.05 * noise
            take = (score >= tau) | last
            for q, u, t in zip(chunk, res.utilities, take):
                if t:
                    util[pos_of[int(q)]] = u
            accepted_mask[s:s + len(chunk)] = take
        remaining = remaining[~accepted_mask]
    return ExecutionOutcome(accuracy=float(util.mean()), exact_cost=float(cost),
                            n_invocations=n_inv, per_query_utility=util)


# ---------------------------------------------------------------------------
# BATCHER-SIM / BATCHER-DIV (adapted): router assignment + clustered batching
# ---------------------------------------------------------------------------

def batcher_group(wl: Workload, a: Assignment, b: int, mode: str = "sim",
                  seed: int = 0) -> list[tuple[State, np.ndarray]]:
    """Batches per model from k-means clusters over a fixed model assignment:
    SIM fills batches within a cluster, DIV round-robins across clusters
    (Fan et al., ICDE'24).  Shared by the legacy entry point and the
    ``batcher-sim``/``batcher-div`` registered policies (offline and per
    online window)."""
    plan = []
    for k in np.unique(a.model):
        members = a.query_idx[a.model == k]
        emb = wl.embeddings[members]
        n_clusters = max(1, len(members) // max(b, 1))
        cl = kmeans(emb, n_clusters, seed=seed)
        if mode == "sim":
            order = np.argsort(cl, kind="stable")
        elif mode == "div":
            # round-robin: sort by (rank within cluster, cluster)
            rank = np.zeros(len(members), dtype=int)
            for j in np.unique(cl):
                rank[cl == j] = np.arange((cl == j).sum())
            order = np.lexsort((cl, rank))
        else:
            raise ValueError(mode)
        ordered = members[order]
        for s in range(0, len(ordered), b):
            plan.append((State(int(k), b), ordered[s:s + b]))
    return plan


def batcher_assignment_plan(rb: Robatch, query_idx: np.ndarray, tau: float, b: int,
                            mode: str = "sim", seed: int = 0):
    """Model per query from Robatch's router (threshold τ), then
    :func:`batcher_group` clustering per model."""
    a = vanilla_router_assignment(rb, query_idx, tau, b)
    return a, batcher_group(rb.wl, a, b, mode=mode, seed=seed)


# ---------------------------------------------------------------------------
# OBP (adapted): adaptive clustering + refinement, variable batch sizes
# ---------------------------------------------------------------------------

def obp_group(wl: Workload, pool, a: Assignment, target_b: int,
              seed: int = 0) -> list[tuple[State, np.ndarray]]:
    """OBP grouping over a fixed model assignment: cluster related queries,
    refine groups to balance affinity / context length (Ji et al., VLDB'25
    adaptation).  Shared by the legacy entry point and the ``obp`` policy."""
    plan = []
    for k in np.unique(a.model):
        members = a.query_idx[a.model == k]
        emb = wl.embeddings[members]
        ctx = pool[k].context_len
        n_clusters = max(1, len(members) // max(target_b, 1))
        cl = kmeans(emb, n_clusters, seed=seed)
        for j in np.unique(cl):
            group = members[cl == j]
            # refinement: split groups whose prompt would overflow the window
            # or exceed 2× the target size; merge is implicit via cluster count
            mean_in = max(wl.in_tokens[group].mean(), 1)
            max_by_ctx = max(1, int((0.8 * ctx - wl.sys_tokens) // mean_in))
            cap = min(2 * target_b, max_by_ctx)
            for s in range(0, len(group), cap):
                chunk = group[s:s + cap]
                plan.append((State(int(k), len(chunk)), chunk))
    return plan


def obp_plan(rb: Robatch, query_idx: np.ndarray, tau: float, target_b: int,
             seed: int = 0):
    """Optimized Batch Prompting: router model assignment, then
    :func:`obp_group` adaptive clustering with variable batch sizes."""
    a = vanilla_router_assignment(rb, query_idx, tau, target_b)
    return a, obp_group(rb.wl, rb.pool, a, target_b, seed=seed)


# ---------------------------------------------------------------------------
# Ablations (§6.3)
# ---------------------------------------------------------------------------

def router_only(rb: Robatch) -> Robatch:
    """Robatch with B_k = {1}: pure model selection, no amortization."""
    clone = dc_replace(rb)
    clone.calibrations = [
        dc_replace(c, grid=np.array([1]), b_effect=1) for c in rb.calibrations
    ]
    return clone


def batch_only(rb: Robatch, k: int) -> Robatch:
    """Robatch restricted to model m_k: scheduling over its batch sizes only.

    The initial state becomes (m_k, b_k^effect): we re-index the pool to the
    single member so the scheduler's "cheapest model" is m_k itself.
    """
    sub_pool = [rb.pool[k]]
    clone = Robatch(pool=sub_pool, wl=rb.wl, router_kind=rb.router_kind, seed=rb.seed,
                    device=rb.device)
    clone.cost_model = CostModel(sub_pool, rb.wl)
    cal = dc_replace(rb.calibrations[k], k=0)
    clone.calibrations = [cal]
    clone.profile = rb.profile
    clone.train_labels = rb.train_labels[:, [k]] if rb.train_labels is not None else None

    class _SliceRouter:
        def __init__(self, base, col):
            self.base, self.col = base, col

        def predict(self, emb):
            return self.base.predict(emb)[:, [self.col]]

    clone.router = _SliceRouter(rb.router, k)
    return clone
