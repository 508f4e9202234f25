"""Batch-size calibration and utility scaling functions ρ_k(b) (§4).

Implements, per pool model m_k:
  * the largest batch size b_k^max from the system-prompt share threshold ε
    (Eq. 9 rearranged to Eq. 10);
  * profiling of coreset utility at candidate batch sizes (cached — every LLM
    invocation is billed);
  * the effective batch size b_k^effect as the RCU minimizer located by
    integer ternary search over the (unimodal) RCU curve (Eq. 11, Fig. 5);
  * three fits of ρ_k(b): piecewise-linear interpolation (Eq. 12, default),
    power-law 1 − α(b−1)^β (nonlinear least squares, no scipy needed), and
    KNN linear interpolation (query-specific, §6.4.4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.problem import CostModel
from repro_torch.data.workload import Workload

__all__ = [
    "batch_grid", "b_max_from_epsilon", "ProfileCache", "ternary_search_rcu",
    "PiecewiseLinearScaling", "PowerLawScaling", "KNNScaling", "fit_scaling",
    "ModelCalibration", "calibrate_model",
]


def b_max_from_epsilon(cm: CostModel, k: int, idx: np.ndarray, epsilon: float) -> int:
    """Eq. (10): b_k^max = ceil(C_sys(m_k)(1−ε) / (ε · E[C_q(m_k)]))."""
    c_sys = cm.sys_cost(k)
    e_q = cm.expected_query_cost(k, idx)
    return max(1, math.ceil(c_sys * (1 - epsilon) / (epsilon * e_q)))


def batch_grid(b_max: int, multiple: int = 4) -> np.ndarray:
    """Candidate batch sizes: {1, 2} ∪ multiples of `multiple` up to b_max.

    §6.1.4: "All batch size b_k ∈ B_k used are multiples of 4" (the paper's
    running example additionally uses b=2, which we keep for small pools).
    """
    grid = [1]
    if b_max >= 2:
        grid.append(2)
    grid.extend(range(multiple, b_max + 1, multiple))
    return np.unique(np.array(grid, dtype=int))


class ProfileCache:
    """Caches coreset utility profiling per (model, batch size).

    Every probe is a real (simulated or served) set of batched invocations on
    the coreset Q''; the cache guarantees the ternary search and the scaling
    fit never re-bill a probe (§4 complexity: O(C_API Σ log b_max)).
    """

    def __init__(self, pool, wl: Workload, coreset_idx: np.ndarray, rng_seed: int = 0):
        self.pool = pool
        self.wl = wl
        self.coreset_idx = np.asarray(coreset_idx)
        self._cache: dict[tuple[int, int], np.ndarray] = {}
        self.n_probes = 0
        self.billed_tokens = 0

    def utilities(self, k: int, b: int) -> np.ndarray:
        """Per-coreset-query utilities when served at batch size b on model k."""
        key = (k, int(b))
        if key not in self._cache:
            model = self.pool[k]
            out = np.zeros(len(self.coreset_idx))
            for s in range(0, len(self.coreset_idx), int(b)):
                chunk = self.coreset_idx[s:s + int(b)]
                res = model.invoke_batch(self.wl, chunk)
                out[s:s + len(chunk)] = res.utilities
                self.billed_tokens += res.in_tokens + res.out_tokens
            self._cache[key] = out
            self.n_probes += 1
        return self._cache[key]

    def mean_utility(self, k: int, b: int) -> float:
        """Mean utility at batch size b, measured over *full* batches only.

        A trailing partial batch runs at an effectively smaller batch size; in
        the collapsed regime its (higher) accuracy creates spurious bumps in
        the ū(b) tail that would break the unimodality of the RCU curve.
        """
        u = self.utilities(k, b)
        n_full = (len(self.coreset_idx) // int(b)) * int(b)
        return float(u[:n_full].mean()) if n_full else float(u.mean())


def rcu(cm: CostModel, cache: ProfileCache, k: int, b: int) -> float:
    """Eq. (11): (C_sys + b·E[C_q]) / E[utility of the batched prompt].

    The numerator is the expected cost of one *batched prompt* of size b; the
    denominator is that prompt's expected utility, i.e. the summed utilities
    of its b queries (b · E[u_{·,k,b}]).  Equivalently: amortized per-query
    cost divided by per-query utility — decreasing while amortization wins,
    increasing once utility collapses, hence the 'V' shape of Fig. 5.
    """
    num = cm.sys_cost(k) + b * cm.expected_query_cost(k, cache.coreset_idx)
    u = cache.mean_utility(k, b)
    if u <= 1e-9:
        # collapsed regime: no utility at any price.  Must be +inf — a finite
        # floor would make the tail slowly *decreasing* (num/b → E[C_q]) and
        # break the unimodality the ternary search relies on.
        return float("inf")
    return num / (b * u)


def ternary_search_rcu(cm: CostModel, cache: ProfileCache, k: int, grid: np.ndarray) -> int:
    """Integer ternary search for argmin RCU over the batch-size grid (Fig. 5).

    The RCU curve is unimodal ('V'-shaped, §4); search runs over grid indices
    so probes stay on valid batch sizes.
    """
    lo, hi = 0, len(grid) - 1
    while hi - lo > 2:
        m1 = lo + (hi - lo) // 3
        m2 = hi - (hi - lo) // 3
        if rcu(cm, cache, k, int(grid[m1])) <= rcu(cm, cache, k, int(grid[m2])):
            hi = m2 - 1
        else:
            lo = m1 + 1
    vals = [(rcu(cm, cache, k, int(grid[j])), int(grid[j])) for j in range(lo, hi + 1)]
    return min(vals)[1]


# ---------------------------------------------------------------------------
# Scaling function fits
# ---------------------------------------------------------------------------

@dataclass
class PiecewiseLinearScaling:
    """Eq. (12): piecewise-linear interpolation of ρ_k at profiled points."""

    bs: np.ndarray         # profiled batch sizes (ascending, bs[0] == 1)
    rho: np.ndarray        # ρ_k at those points (rho[0] == 1)

    def __call__(self, b) -> np.ndarray:
        return np.interp(np.asarray(b, dtype=float), self.bs, self.rho)


@dataclass
class PowerLawScaling:
    """ρ_k(b) = 1 − α(b−1)^β, fitted by nonlinear least squares (§6.4.4)."""

    alpha: float
    beta: float

    def __call__(self, b) -> np.ndarray:
        b = np.asarray(b, dtype=float)
        return np.clip(1.0 - self.alpha * np.maximum(b - 1.0, 0.0) ** self.beta, 0.0, 1.0)


@dataclass
class KNNScaling:
    """Query-specific ρ: average utilities of nearest coreset neighbours at
    each profiled batch size (§6.4.4, "KNN linear interpolation")."""

    coreset_emb: np.ndarray           # (m, d)
    bs: np.ndarray                    # profiled batch sizes
    util_table: np.ndarray            # (m, |bs|) coreset utilities per batch size
    k: int = 8

    def per_query(self, emb: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
        """Returns rho(b) -> (n,) for the given query embeddings."""
        sims = np.asarray(emb, np.float32) @ self.coreset_emb.T
        nn = np.argpartition(-sims, min(self.k, sims.shape[1] - 1), axis=1)[:, : self.k]
        curves = self.util_table[nn].mean(axis=1)             # (n, |bs|)
        base = np.maximum(curves[:, :1], 1e-6)
        curves = np.clip(curves / base, 0.0, 1.0)

        def rho(b):
            b = float(b)
            j = int(np.searchsorted(self.bs, b, side="right")) - 1
            if j >= len(self.bs) - 1:
                return curves[:, -1]
            lo_b, hi_b = self.bs[j], self.bs[j + 1]
            t = (b - lo_b) / max(hi_b - lo_b, 1e-9)
            return curves[:, j] * (1 - t) + curves[:, j + 1] * t
        return rho


def _eq12_smooth(bs: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Eq. (12) smoothing: value anchored at u[j-1] plus the (j+1, j-1) secant."""
    rho = np.empty_like(u)
    u1 = max(u[0], 1e-6)
    for j in range(len(bs)):
        jm = max(j - 1, 0)
        jp = min(j + 1, len(bs) - 1)
        if jp == jm:
            rho[j] = u[j] / u1
            continue
        slope = (u[jp] - u[jm]) / (bs[jp] - bs[jm])
        rho[j] = (u[jm] + (bs[j] - bs[jm]) * slope) / u1
    rho[0] = 1.0
    return np.clip(rho, 0.0, 1.2)


def fit_scaling(method: str, bs: np.ndarray, u: np.ndarray,
                coreset_emb: np.ndarray | None = None,
                util_table: np.ndarray | None = None):
    """Fit ρ_k(b) from coreset mean utilities u at batch sizes bs."""
    bs = np.asarray(bs, dtype=float)
    u = np.asarray(u, dtype=float)
    if method == "piecewise":
        return PiecewiseLinearScaling(bs, _eq12_smooth(bs, u))
    if method == "powerlaw":
        rho = np.clip(u / max(u[0], 1e-6), 0.0, 1.2)
        z = np.maximum(bs - 1.0, 0.0)
        mask = z > 0
        best = (np.inf, 0.0, 1.0)
        for beta in np.linspace(0.1, 3.0, 59):
            zz = z[mask] ** beta
            denom = float(zz @ zz)
            alpha = float(zz @ (1.0 - rho[mask]) / denom) if denom > 0 else 0.0
            alpha = max(alpha, 0.0)
            resid = float(np.sum((1.0 - alpha * zz - rho[mask]) ** 2))
            if resid < best[0]:
                best = (resid, alpha, beta)
        return PowerLawScaling(alpha=best[1], beta=best[2])
    if method == "knn":
        assert coreset_emb is not None and util_table is not None
        return KNNScaling(coreset_emb=coreset_emb, bs=bs, util_table=util_table)
    raise ValueError(f"unknown scaling fit {method!r}")


# ---------------------------------------------------------------------------
# Full per-model calibration
# ---------------------------------------------------------------------------

@dataclass
class ModelCalibration:
    """Everything the routing stage needs about one pool member."""

    k: int
    b_max: int
    b_effect: int
    grid: np.ndarray              # valid batch sizes B_k = grid ≤ b_effect
    scaling: object               # ρ_k(b) callable (or KNNScaling)
    u_mean_at: dict[int, float] = field(default_factory=dict)  # profiled means
    u_std_at: dict[int, float] = field(default_factory=dict)
    # ^ per-batch-size std of the profiled coreset utilities — the calibration
    #   residual σ_k(b) the robust frontier walk penalizes (utility − λ·σ).
    #   Defaulted so profiles pickled before this field existed still load.


def calibrate_model(
    cm: CostModel,
    cache: ProfileCache,
    k: int,
    epsilon: float = 0.01,
    grid_multiple: int = 4,
    fit: str = "piecewise",
    coreset_emb: np.ndarray | None = None,
) -> ModelCalibration:
    """§4 end-to-end for one model: b_max → ternary search → ρ_k fit."""
    b_max = b_max_from_epsilon(cm, k, cache.coreset_idx, epsilon)
    # cap by the model's context window: batch prompt must fit
    ctx = cm.pool[k].context_len
    mean_q = float(cm.wl.in_tokens[cache.coreset_idx].mean())
    b_ctx = max(1, int((0.9 * ctx - cm.wl.sys_tokens) // max(mean_q, 1.0)))
    # profiling can only measure batch sizes the coreset can fill
    b_max = min(b_max, b_ctx, len(cache.coreset_idx))
    grid = batch_grid(b_max, grid_multiple)
    b_eff = ternary_search_rcu(cm, cache, k, grid)
    valid = grid[grid <= b_eff]
    # profile every valid grid point (cached; ternary search already hit many)
    u = np.array([cache.mean_utility(k, int(b)) for b in valid])
    # σ_k(b): dispersion of the per-coreset-query utilities behind each mean,
    # over the same full batches mean_utility averages — the uncertainty the
    # robust frontier walk (scheduler robust_lambda) penalizes
    u_sd = []
    for b in valid:
        uu = cache.utilities(k, int(b))
        n_full = (len(cache.coreset_idx) // int(b)) * int(b)
        uu = uu[:n_full] if n_full else uu
        u_sd.append(float(uu.std()))
    util_table = None
    if fit == "knn":
        util_table = np.stack([cache.utilities(k, int(b)) for b in valid], axis=1)
    scaling = fit_scaling(fit, valid, u, coreset_emb=coreset_emb, util_table=util_table)
    return ModelCalibration(
        k=k, b_max=b_max, b_effect=int(b_eff), grid=valid, scaling=scaling,
        u_mean_at={int(b): float(x) for b, x in zip(valid, u)},
        u_std_at={int(b): float(s) for b, s in zip(valid, u_sd)},
    )
