"""Robatch — the unified two-stage framework (§3 overview, §4 modeling, §5 routing).

Usage::

    rb = Robatch(pool, workload)
    rb.fit()                                  # modeling stage (offline, billed once)
    result = rb.schedule(test_idx, budget)    # routing stage (online)
    outcome = execute(pool, workload, result.assignment)   # commit batches

``pool`` is any sequence of members exposing ``c_in/c_out/context_len`` and
``invoke_batch(workload, idx) -> BatchResult`` — the calibrated simulator
(:mod:`repro_torch.data.simulator`) or the real served pool
(:mod:`repro_torch.serving.pool`) plug in interchangeably.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.coreset import select_coreset
from repro_torch.core.pareto import CandidateSpace, build_candidate_space
from repro_torch.core.problem import Assignment, CostModel, group_into_batches
from repro_torch.core.router import KNNRouter, train_mlp_router
from repro_torch.core.scaling import ModelCalibration, ProfileCache, calibrate_model
from repro_torch.core.scheduler import ScheduleResult, greedy_schedule, greedy_schedule_vectorized
from repro_torch.data.workload import Workload
from repro_torch.device import resolve_device

__all__ = ["Robatch", "ExecutionOutcome", "execute", "execute_plan", "collect_router_labels"]


@dataclass
class ExecutionOutcome:
    """Result of committing an assignment through real batched invocations."""

    accuracy: float              # mean utility over the workload (objective)
    exact_cost: float            # actual billed $ (Eq. 4 accounting, partial batches real)
    n_invocations: int
    per_query_utility: np.ndarray
    wall_clock_s: float = 0.0    # scheduling overhead only (excl. LLM latency), §6.1.3


def execute_plan(pool, wl: Workload, plan, query_idx: np.ndarray) -> ExecutionOutcome:
    """Commit a physical batch plan [(State, members)]: invoke, bill actual tokens."""
    util = np.zeros(len(query_idx))
    pos_of = {int(q): i for i, q in enumerate(query_idx)}
    cost = 0.0
    for state, members in plan:
        res = pool[state.model].invoke_batch(wl, members)
        cost += res.in_tokens * pool[state.model].c_in / 1e6
        cost += res.out_tokens * pool[state.model].c_out / 1e6
        for q, u in zip(members, res.utilities):
            util[pos_of[int(q)]] = u
    return ExecutionOutcome(
        accuracy=float(util.mean()),
        exact_cost=float(cost),
        n_invocations=len(plan),
        per_query_utility=util,
    )


def execute(pool, wl: Workload, a: Assignment) -> ExecutionOutcome:
    """Commit an assignment: pack per-state batches, invoke, bill actual tokens."""
    return execute_plan(pool, wl, group_into_batches(a), a.query_idx)


def collect_router_labels(pool, wl: Workload, idx: np.ndarray) -> np.ndarray:
    """Offline b=1 evaluation of all K models on Q' → ground-truth u_{i,k,1} (§4)."""
    idx = np.asarray(idx)
    labels = np.zeros((len(idx), len(pool)))
    for k, m in enumerate(pool):
        labels[:, k] = m.evaluate(wl, idx, batch_size=1)
    return labels


@dataclass
class Robatch:
    """The full framework; see module docstring."""

    pool: Sequence
    wl: Workload
    # modeling-stage hyper-parameters (§6.1.4 defaults)
    router_kind: str = "mlp"            # mlp | knn
    router_hidden: Sequence[int] = (256, 128)
    knn_k: int = 16
    coreset_method: str = "kcenter"
    coreset_size: int = 256
    epsilon: float = 0.01               # Eq. 9 threshold
    grid_multiple: int = 4
    scaling_fit: str = "piecewise"      # piecewise | powerlaw | knn
    seed: int = 0
    # where the MLP router trains and predicts: the card unless "cpu" is asked
    device: object = "cuda"

    # fitted artifacts
    cost_model: CostModel = None
    router: object = None
    calibrations: list[ModelCalibration] = field(default_factory=list)
    profile: ProfileCache = None
    train_labels: np.ndarray = None
    _train_idx: np.ndarray = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # --------------------------------------------------------------- stage 1
    def fit(self, train_part: str = "train", labels: Optional[np.ndarray] = None) -> "Robatch":
        """Modeling stage: router on Q', coreset Q'', per-model calibration."""
        self.cost_model = CostModel(self.pool, self.wl)
        tr = self.wl.subset_indices(train_part)
        self._train_idx = tr
        # (1) ground-truth b=1 labels for Q' (offline evaluation of all K models)
        if labels is None:
            labels = collect_router_labels(self.pool, self.wl, tr)
        self.train_labels = labels
        # (2) router training (û_{i,k,1})
        emb_tr = self.wl.embeddings[tr]
        if self.router_kind == "mlp":
            self.router = train_mlp_router(emb_tr, labels, hidden=tuple(self.router_hidden),
                                           seed=self.seed, device=self.device)
        elif self.router_kind == "knn":
            self.router = KNNRouter(train_embeddings=emb_tr.astype(np.float32),
                                    train_labels=labels, k=self.knn_k)
        else:
            raise ValueError(self.router_kind)
        # (3) coreset Q'' ⊂ Q'
        core_pos = select_coreset(emb_tr, self.coreset_size, self.coreset_method, self.seed)
        core_idx = tr[core_pos]
        self.profile = ProfileCache(self.pool, self.wl, core_idx)
        # (4) per-model calibration: b_max (Eq. 10) → b_effect (ternary / Eq. 11)
        #     → scaling fit ρ_k (Eq. 12 default)
        self.calibrations = [
            calibrate_model(self.cost_model, self.profile, k, epsilon=self.epsilon,
                            grid_multiple=self.grid_multiple, fit=self.scaling_fit,
                            coreset_emb=self.wl.embeddings[core_idx])
            for k in range(len(self.pool))
        ]
        return self

    # --------------------------------------------------------------- stage 2
    def candidate_space(self, query_idx: np.ndarray,
                        timings: Optional[dict] = None) -> CandidateSpace:
        """Eq. 8/13 candidate space for a query set.

        When ``timings`` is passed, the §6.5 stage breakdown is written into
        it (``router``: û prediction, ``proxy``: space assembly).
        """
        assert self.router is not None, "call fit() first"
        t0 = time.perf_counter()
        emb = self.wl.embeddings[np.asarray(query_idx)]
        u_hat_1 = self.router.predict(emb)
        t1 = time.perf_counter()
        space = build_candidate_space(self.cost_model, self.calibrations,
                                      query_idx, u_hat_1, query_emb=emb)
        if timings is not None:
            timings["router"] = t1 - t0
            timings["proxy"] = time.perf_counter() - t1
        return space

    def schedule(self, query_idx: np.ndarray, budget: float,
                 scheduler: str = "heap",
                 timings: Optional[dict] = None) -> ScheduleResult:
        """Routing stage: greedy Pareto climb under the budget (Alg. 1).
        ``scheduler="vectorized"`` uses the beyond-paper round-based variant
        (near-identical objective, much faster at large |Q| — fig11).
        ``timings`` optionally collects the §6.5 router/proxy/greedy/total
        latency breakdown."""
        space = self.candidate_space(query_idx, timings=timings)
        fn = greedy_schedule_vectorized if scheduler == "vectorized" else greedy_schedule
        t0 = time.perf_counter()
        res = fn(space, query_idx, budget)
        if timings is not None:
            timings["greedy"] = time.perf_counter() - t0
            timings["total"] = (timings.get("router", 0.0)
                                + timings.get("proxy", 0.0) + timings["greedy"])
        return res

    def schedule_timed(self, query_idx: np.ndarray, budget: float,
                       scheduler: str = "heap"):
        """``schedule`` plus the §6.5 latency breakdown (same code path)."""
        timings: dict = {}
        res = self.schedule(query_idx, budget, scheduler=scheduler, timings=timings)
        return res, timings

    # ------------------------------------------------------------- lifecycle
    def save_profile(self, path: str) -> None:
        """Persist the fitted control-plane state (fault tolerance: a restarted
        scheduler reloads this instead of re-billing the modeling stage)."""
        state = dict(
            router_kind=self.router_kind,
            router=self.router,
            calibrations=self.calibrations,
            train_labels=self.train_labels,
            train_idx=self._train_idx,
            workload=self.wl.name,
            pool=[m.name for m in self.pool],
        )
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_profile(self, path: str) -> "Robatch":
        with open(path, "rb") as f:
            state = pickle.load(f)
        assert state["workload"] == self.wl.name, "profile belongs to another workload"
        assert state["pool"] == [m.name for m in self.pool], "profile belongs to another pool"
        self.cost_model = CostModel(self.pool, self.wl)
        self.router = state["router"]
        self.calibrations = state["calibrations"]
        self.train_labels = state["train_labels"]
        self._train_idx = state["train_idx"]
        return self
