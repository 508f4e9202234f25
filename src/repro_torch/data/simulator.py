"""Calibrated model-pool simulator.

The paper's pools are commercial APIs (Qwen3 4B/14B/32B via the Qwen API,
Gemma3 4B/12B/27B via OpenRouter).  We replace each member with a simulator
whose behaviour is calibrated to the paper's empirical sections:

* §2.1 / Fig. 2 — per-task capability tiers: larger models are more accurate
  *on average* but do not universally dominate every task.
* §2.2 / Fig. 3 — accuracy vs batch size: stable up to a model/task-specific
  knee (b≈16 on AGNews, b≈8 on GSM8K), then a drastic collapse; smaller models
  collapse earlier (Qwen3-4B) and larger ones are more resilient (14B/32B).
* §2.2 / Fig. 4 — cost vs batch size: query/output cost stable except in the
  collapse regime, where *inference degeneration* inflates output tokens
  (repetitive/malformed output, observed for b>50 on Qwen3-4B and large b on
  GSM8K).

Determinism: each (query, model) pair draws a fixed latent threshold, so a
query's correctness is monotone in effective accuracy — re-evaluating the same
state is reproducible, and the same query flips from correct to incorrect as
the batch size crosses its personal tolerance, never chaotically.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.data.workload import Workload

__all__ = ["SimulatedModel", "make_simulated_pool", "POOL_SPECS", "BatchResult",
           "evaluate_chunked"]


def _stable_uniform(tag: str, idx: np.ndarray) -> np.ndarray:
    """Deterministic per-(tag, index) uniforms in [0,1) — stable across runs."""
    h = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little")
    # SplitMix64-style mix of (tag hash, index)
    x = (np.asarray(idx, dtype=np.uint64) + np.uint64(h)) * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


@dataclass
class BatchResult:
    """Outcome of one physical batched invocation."""

    utilities: np.ndarray        # (b,) 0/1 per query in the batch
    in_tokens: int               # actual input tokens billed (sys + queries)
    out_tokens: int              # actual output tokens billed (incl. degeneration)
    latency_s: float             # simulated wall clock (for straggler handling)
    answers: Optional[list] = None   # (b,) parsed answer texts when the member
    #   actually generated text (real engines); None for calibrated simulators


def evaluate_chunked(member, wl: Workload, idx: np.ndarray,
                     batch_size: int) -> np.ndarray:
    """Shared pool-member ``evaluate`` body: utilities for ``idx`` served in
    consecutive ``invoke_batch`` chunks of ``batch_size`` (used by the
    simulator, the real served members and replica sets alike)."""
    idx = np.asarray(idx)
    out = np.zeros(len(idx))
    for s in range(0, len(idx), batch_size):
        chunk = idx[s:s + batch_size]
        out[s:s + len(chunk)] = member.invoke_batch(wl, chunk).utilities
    return out


@dataclass
class SimulatedModel:
    """One pool member with published-API-like pricing and calibrated accuracy."""

    name: str
    c_in: float                   # $ per 1M input tokens
    c_out: float                  # $ per 1M output tokens
    context_len: int
    capability: dict[str, float]  # per-benchmark capability in [0,1]
    resilience: float             # batch-size knee scale (bigger = collapses later)
    collapse_width: float = 0.22  # relative width of the collapse transition
    interference: float = 0.05    # sensitivity to co-batched query diversity
    degeneration: float = 1.5     # output inflation slope past the knee
    seed_tag: str = ""

    def __post_init__(self):
        if not self.seed_tag:
            self.seed_tag = "sim::" + self.name

    # -- calibration-facing internals ---------------------------------------
    def _knee(self, wl: Workload) -> float:
        """Task- and model-specific tolerance knee (Fig. 3)."""
        # Reasoning-style tasks (long outputs) tolerate far smaller batches.
        task_tol = {"reasoning": 8.0, "qa": 12.0, "nli": 16.0,
                    "paraphrase": 16.0, "classification": 24.0}[wl.spec.task]
        return task_tol * self.resilience

    def base_prob(self, wl: Workload, idx: np.ndarray) -> np.ndarray:
        """P(correct | b=1) per query (Fig. 2 calibration)."""
        cap = self.capability[wl.name]
        z = wl.spec.sensitivity * (cap - wl.difficulty[idx])
        return 1.0 / (1.0 + np.exp(-z))

    def batch_multiplier(self, wl: Workload, b: int, batch_in_tokens: float) -> float:
        """Relative accuracy retention at batch size b (Fig. 3 calibration)."""
        if b <= 1:
            return 1.0
        knee = self._knee(wl)
        width = max(1.0, self.collapse_width * knee)
        raw = 1.0 / (1.0 + np.exp((b - knee) / width))
        norm = 1.0 / (1.0 + np.exp((1.0 - knee) / width))
        mult = float(raw / norm)
        # hard context-window ceiling: prompt beyond the effective window
        # collapses accuracy regardless of the knee
        if batch_in_tokens > 0.9 * self.context_len:
            mult *= 0.05
        return mult

    # -- serving-facing API ---------------------------------------------------
    def invoke_batch(self, wl: Workload, batch_idx: np.ndarray) -> BatchResult:
        """Run one physical batched invocation of len(batch_idx) queries."""
        b = len(batch_idx)
        in_tok = int(wl.sys_tokens + wl.in_tokens[batch_idx].sum())
        p1 = self.base_prob(wl, batch_idx)
        mult = self.batch_multiplier(wl, b, in_tok)
        # mild composition effect: diverse co-batched queries interfere slightly
        if b > 1 and self.interference > 0:
            e = wl.embeddings[batch_idx]
            sim = float(np.clip((e @ e.T).mean(), -1, 1))
            mult *= 1.0 - self.interference * (1.0 - sim)
        thresholds = _stable_uniform(self.seed_tag + "::" + wl.name, batch_idx)
        util = (p1 * mult >= thresholds).astype(np.float64)
        # output tokens: degeneration inflates outputs past the knee (Fig. 4)
        out_tok = float(wl.out_tokens[batch_idx].sum())
        knee = self._knee(wl)
        if b > knee:
            out_tok *= 1.0 + self.degeneration * (b - knee) / knee
        # simulated latency: linear in tokens with per-invocation overhead
        latency = 0.5 + 1e-4 * in_tok + 2e-3 * out_tok
        return BatchResult(util, in_tok, int(out_tok), latency)

    def evaluate(self, wl: Workload, idx: np.ndarray, batch_size: int,
                 rng: np.random.Generator | None = None) -> np.ndarray:
        """Utilities for `idx` served in consecutive batches of `batch_size`."""
        return evaluate_chunked(self, wl, idx, batch_size)


# ---------------------------------------------------------------------------
# Pool specifications (capabilities per benchmark, API-like prices $/1M tokens)
# ---------------------------------------------------------------------------
# Capability tables encode Fig. 2's observation that bigger is usually — but
# not universally — better (e.g. mid model ties large on easy classification).
# Capabilities are solved numerically so that mean b=1 accuracy over each
# benchmark's difficulty distribution hits Fig. 2/3-like tiers, e.g. AGNews
# 0.72/0.80/0.85 and GSM8K 0.42/0.62/0.78 for Qwen3 4B/14B/32B (the Gemma3
# family is slightly weaker with narrower gaps, as observed in Fig. 7).
POOL_SPECS: dict[str, list[dict]] = {
    "qwen3": [
        dict(name="qwen3-4b", c_in=0.15, c_out=0.60, context_len=32_768,
             resilience=0.85,
             capability=dict(agnews=0.477, gsm8k=0.601, mmlu=0.540,
                             snli=0.551, mrpc=0.577, imdb=0.516)),
        dict(name="qwen3-14b", c_in=0.35, c_out=1.40, context_len=65_536,
             resilience=1.6,
             capability=dict(agnews=0.557, gsm8k=0.788, mmlu=0.666,
                             snli=0.647, mrpc=0.646, imdb=0.584)),
        dict(name="qwen3-32b", c_in=0.70, c_out=2.80, context_len=131_072,
             resilience=2.4,
             capability=dict(agnews=0.619, gsm8k=0.962, mmlu=0.776,
                             snli=0.725, mrpc=0.690, imdb=0.629)),
    ],
    "gemma3": [
        dict(name="gemma3-4b", c_in=0.08, c_out=0.32, context_len=32_768,
             resilience=0.8,
             capability=dict(agnews=0.450, gsm8k=0.550, mmlu=0.500,
                             snli=0.520, mrpc=0.550, imdb=0.490)),
        dict(name="gemma3-12b", c_in=0.25, c_out=1.00, context_len=65_536,
             resilience=1.5,
             capability=dict(agnews=0.540, gsm8k=0.730, mmlu=0.640,
                             snli=0.620, mrpc=0.630, imdb=0.570)),
        dict(name="gemma3-27b", c_in=0.55, c_out=2.20, context_len=131_072,
             resilience=2.2,
             capability=dict(agnews=0.600, gsm8k=0.880, mmlu=0.740,
                             snli=0.700, mrpc=0.670, imdb=0.610)),
    ],
}


def make_simulated_pool(family: str = "qwen3") -> list[SimulatedModel]:
    """Pool members in ascending cost/capability order (paper assumption §3)."""
    members = [SimulatedModel(**spec) for spec in POOL_SPECS[family]]
    assert all(a.c_in < b.c_in and a.c_out < b.c_out for a, b in zip(members, members[1:]))
    return members
