"""Route-with-Batching problem: states, cost model (Eqs. 1–4, 13), assignments.

This module is deliberately framework-free (numpy only): the scheduler is a
host-side control-plane algorithm, exactly as deployed in the paper (§6.5 runs
it on a CPU next to the serving cluster).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Protocol, Sequence

import numpy as np

from repro_torch.data.workload import Workload

__all__ = ["State", "PoolMember", "CostModel", "Assignment", "group_into_batches"]


class State(NamedTuple):
    """An execution state s = (m_k, b): model index and batch size (§3)."""

    model: int
    batch: int


class PoolMember(Protocol):
    """What the scheduler needs to know about an LLM pool member."""

    name: str
    c_in: float          # $ per 1M input tokens
    c_out: float         # $ per 1M output tokens
    context_len: int


@dataclass
class Assignment:
    """A full solution x_{i,k,b}: one state per query (Eq. 6)."""

    query_idx: np.ndarray    # (n,) workload indices this assignment covers
    model: np.ndarray        # (n,) int model index k
    batch: np.ndarray        # (n,) int batch size b

    def states(self) -> list[State]:
        return [State(int(k), int(b)) for k, b in zip(self.model, self.batch)]

    def __len__(self) -> int:
        return len(self.query_idx)


class CostModel:
    """Monetary cost accounting per Eqs. (1), (2), (4) and (13).

    Token prices are $ / 1M tokens (API convention); costs are dollars.
    """

    def __init__(self, pool: Sequence[PoolMember], wl: Workload):
        self.pool = list(pool)
        self.wl = wl
        self.K = len(self.pool)
        self._c_in = np.array([m.c_in for m in self.pool]) / 1e6
        self._c_out = np.array([m.c_out for m in self.pool]) / 1e6

    # -- Eq. (2) -------------------------------------------------------------
    def sys_cost(self, k: int) -> float:
        """C_sys(m_k): fixed system-prompt cost of one invocation of m_k."""
        return float(self.wl.sys_tokens * self._c_in[k])

    def query_cost(self, k: int, idx: np.ndarray) -> np.ndarray:
        """C_{q_i}(m_k): per-query input+output token cost (vectorized)."""
        idx = np.asarray(idx)
        return (self.wl.in_tokens[idx] * self._c_in[k]
                + self.wl.out_tokens[idx] * self._c_out[k])

    def expected_query_cost(self, k: int, idx: np.ndarray) -> float:
        """E_{q_i}[C_{q_i}(m_k)] over a query set (used by Eqs. 9–11)."""
        return float(self.query_cost(k, idx).mean())

    # -- Eq. (13): amortized per-query state cost ----------------------------
    def state_cost(self, k: int, b: int, idx: np.ndarray) -> np.ndarray:
        """C_{q_i}(s) = C_sys/b + C_{q_i}(m_k)."""
        return self.sys_cost(k) / b + self.query_cost(k, idx)

    def amortized_total(self, a: Assignment) -> float:
        """Σ_i C_{q_i}(s(q_i)) — the budget the greedy scheduler tracks."""
        total = 0.0
        for k in range(self.K):
            for b in np.unique(a.batch[a.model == k]):
                sel = (a.model == k) & (a.batch == b)
                total += float(self.state_cost(k, int(b), a.query_idx[sel]).sum())
        return total

    # -- Eq. (4): exact cost with ceiling over physical invocations ----------
    def exact_total(self, a: Assignment) -> float:
        """Σ_k Σ_b ceil(N_{k,b}/b)·C_sys(m_k) + Σ C_{q_i}(m_k)."""
        total = 0.0
        for k in range(self.K):
            mask_k = a.model == k
            for b in np.unique(a.batch[mask_k]):
                sel = mask_k & (a.batch == b)
                n_kb = int(sel.sum())
                total += np.ceil(n_kb / b) * self.sys_cost(k)
                total += float(self.query_cost(k, a.query_idx[sel]).sum())
        return total

    # -- workload-level reference points -------------------------------------
    def single_model_cost(self, k: int, idx: np.ndarray, b: int = 1) -> float:
        """Cost of serving `idx` entirely on model k at batch size b (Eq. 4)."""
        idx = np.asarray(idx)
        n_inv = np.ceil(len(idx) / b)
        return float(n_inv * self.sys_cost(k) + self.query_cost(k, idx).sum())


def group_into_batches(a: Assignment,
                       order: np.ndarray | None = None) -> list[tuple[State, np.ndarray]]:
    """Pack queries sharing a state into physical batches of that state's size.

    Returns [(state, workload-index array)] — the commit plan the serving
    engine executes.  ``order`` optionally permutes queries first (e.g. by
    similarity for BATCHER-SIM-style packing).
    """
    plan: list[tuple[State, np.ndarray]] = []
    pos = np.arange(len(a)) if order is None else np.asarray(order)
    model, batch, qidx = a.model[pos], a.batch[pos], a.query_idx[pos]
    for k in np.unique(model):
        for b in np.unique(batch[model == k]):
            sel = (model == k) & (batch == b)
            members = qidx[sel]
            for s in range(0, len(members), int(b)):
                plan.append((State(int(k), int(b)), members[s:s + int(b)]))
    return plan
