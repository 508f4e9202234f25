"""Coreset selection over query embeddings (§4 + Table 3 sensitivity).

Three algorithms, matching the paper's sensitivity study: k-center greedy
(default, Gonzalez 1985), facility location (greedy submodular, Lin & Bilmes
2009) and herding (Welling 2009).
"""
from __future__ import annotations

import numpy as np

__all__ = ["kcenter_greedy", "facility_location", "herding", "select_coreset"]


def kcenter_greedy(emb: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """Greedy 2-approx of the k-center objective: maximize coverage radius."""
    n = len(emb)
    m = min(m, n)
    rng = np.random.default_rng(seed)
    chosen = [int(rng.integers(n))]
    d2 = np.sum((emb - emb[chosen[0]]) ** 2, axis=1)
    for _ in range(m - 1):
        nxt = int(np.argmax(d2))
        chosen.append(nxt)
        d2 = np.minimum(d2, np.sum((emb - emb[nxt]) ** 2, axis=1))
    return np.array(chosen)


def facility_location(emb: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """Greedy maximization of Σ_i max_{j∈S} sim(i, j) (submodular)."""
    n = len(emb)
    m = min(m, n)
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    sim = e @ e.T                              # (n, n); fine at paper scale (≤2048)
    best = np.full(n, -np.inf)
    chosen: list[int] = []
    for _ in range(m):
        # candidate j's objective = Σ_i max(best_i, sim_ij)
        gains = np.sum(np.maximum(best[:, None], sim), axis=0)
        gains[chosen] = -np.inf
        j = int(np.argmax(gains))
        chosen.append(j)
        best = np.maximum(best, sim[:, j])
    return np.array(chosen)


def herding(emb: np.ndarray, m: int, seed: int = 0) -> np.ndarray:
    """Herding: iteratively pick points matching the empirical mean."""
    n = len(emb)
    m = min(m, n)
    mu = emb.mean(axis=0)
    w = mu.copy()
    chosen: list[int] = []
    mask = np.zeros(n, bool)
    for _ in range(m):
        scores = emb @ w
        scores[mask] = -np.inf
        j = int(np.argmax(scores))
        chosen.append(j)
        mask[j] = True
        w = w + mu - emb[j]
    return np.array(chosen)


_METHODS = {"kcenter": kcenter_greedy, "fl": facility_location, "herding": herding}


def select_coreset(emb: np.ndarray, m: int, method: str = "kcenter", seed: int = 0) -> np.ndarray:
    """Positions (into `emb`) of the selected coreset Q''."""
    return _METHODS[method](np.asarray(emb, np.float64), m, seed)
