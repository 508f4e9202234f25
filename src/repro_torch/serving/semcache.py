"""Semantic response cache in the router's embedding space.

The exact-match :class:`repro_torch.serving.online.ResponseCache` only collapses
*identical* queries; at millions-of-users scale the dominant residual cost is
re-answering *near-duplicates*.  This module adds the embedding-similarity
layer the ROADMAP calls for, with two design commitments:

* **No new model.**  Queries are embedded with the SAME fitted space the KNN
  router already uses — ``Workload.embeddings``, the (L2-normalized) vectors
  :class:`repro_torch.core.router.KNNRouter` computes cosine similarities over.
  The cache is built from the shared modeling artifacts
  (:class:`repro_torch.core.robatch.Robatch`, handed around via ``Gateway.fit()`` /
  ``SchedulingPolicy.fit(artifacts=...)``), so a hit is judged in exactly the
  geometry the router routes in.

* **A hit is priced, not assumed free-of-error.**  Serving a cached answer
  for a *similar* (not identical) query costs zero dollars but risks utility.
  :class:`EpsilonModel` calibrates that risk offline — ε(sim), the expected
  relative utility loss of reusing an answer across a query pair at cosine
  similarity ``sim``, fitted on held-out labeled pairs from the router's
  training split and forced monotone non-increasing in ``sim`` — so the
  online plane can account a hit as a (cost = 0, utility = u·(1−ε(sim)))
  assignment next to the scheduler's real ones
  (:func:`repro_torch.core.scheduler.attach_free_assignments`).

Lookup is exact brute-force top-1 over the stored keys (one torch matmul
against a key matrix kept on the cache's device — the store is small by
construction), with an optional bucketed
random-hyperplane (LSH) index for large stores that trades a little recall
for sublinear candidate sets.  Entries carry a TTL and are LRU-evicted under
a byte budget, mirroring the exact cache's boundedness.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SemanticCacheConfig", "EpsilonModel", "SemanticCache", "SemHit"]

# fixed per-entry overhead charged against the byte budget on top of the
# answer text: the stored embedding reference, floats, dict slots
_ENTRY_OVERHEAD_BYTES = 96


@dataclass(frozen=True)
class SemanticCacheConfig:
    """Knobs for the semantic cache (``OnlineConfig.semantic_cache``).

    ``sim_threshold=inf`` keeps the cache structurally in place but makes a
    hit impossible (cosine ≤ 1) — the bench gate uses it to prove the wired
    server is bit-identical to one with no semantic cache at all."""

    sim_threshold: float = 0.92       # cosine hit threshold; inf disables hits
    max_bytes: int = 1 << 20          # byte budget for cached answers (LRU)
    ttl_s: float = float("inf")       # entry lifetime on the serving timeline
    calib_pairs: int = 4096           # labeled pairs for the ε(sim) fit
    calib_bins: int = 12              # similarity bins of the ε(sim) fit
    calib_seed: int = 0
    index: str = "brute"              # brute | lsh
    lsh_planes: int = 8               # hyperplanes of the optional LSH index


@dataclass
class EpsilonModel:
    """Calibrated utility-loss estimate ε(sim) ∈ [0, 1].

    Fitted from held-out labeled pairs: for queries i, j with ground-truth
    per-model utility rows U_i, U_j (the router's b=1 training labels), the
    loss proxy of answering i with j's cached answer is the mean per-model
    utility disagreement ``|U_i − U_j|.mean()``.  Pairs are binned by cosine
    similarity; bin means are made monotone non-increasing in sim (a running
    minimum low→high), so for any threshold τ, ``ε(sim) ≤ ε(τ)`` whenever
    ``sim ≥ τ`` — the property the bench gate's loss bound leans on.
    """

    sim_grid: np.ndarray              # (B,) ascending bin centers
    eps_grid: np.ndarray              # (B,) monotone non-increasing losses

    def __call__(self, sim: float) -> float:
        if not np.isfinite(sim):
            return 0.0
        return float(np.clip(np.interp(sim, self.sim_grid, self.eps_grid),
                             0.0, 1.0))

    @classmethod
    def fit(cls, embeddings: np.ndarray, utilities: np.ndarray,
            n_pairs: int = 4096, n_bins: int = 12,
            seed: int = 0) -> "EpsilonModel":
        """``embeddings`` (n, d) L2-normalized, ``utilities`` (n, K) per-model
        ground truth in [0, 1] for the same rows."""
        emb = np.asarray(embeddings, dtype=np.float32)
        util = np.asarray(utilities, dtype=np.float64)
        n = len(emb)
        assert n >= 2 and len(util) == n
        rng = np.random.default_rng(seed)
        i = rng.integers(0, n, size=n_pairs)
        j = rng.integers(0, n, size=n_pairs)
        keep = i != j
        i, j = i[keep], j[keep]
        # random pairs undersample the high-similarity region a threshold
        # actually operates in; add every row's nearest neighbor as a pair so
        # the top bins are populated by pairs that look like real cache hits
        sample = (np.arange(n) if n <= 4096
                  else rng.choice(n, size=4096, replace=False))
        gram = emb[sample] @ emb.T
        gram[np.arange(len(sample)), sample] = -np.inf
        i = np.concatenate([i, sample])
        j = np.concatenate([j, np.argmax(gram, axis=1)])
        sims = np.sum(emb[i] * emb[j], axis=1)
        loss = np.abs(util[i] - util[j]).mean(axis=1)
        # quantile bin edges keep every bin populated whatever the sim
        # distribution looks like (random pairs pile up near 0, near-dup
        # pairs near 1)
        qs = np.linspace(0.0, 1.0, n_bins + 1)
        edges = np.unique(np.quantile(sims, qs))
        if len(edges) < 3:            # degenerate similarity spread
            return cls(sim_grid=np.array([0.0, 1.0]),
                       eps_grid=np.array([float(loss.mean())] * 2))
        which = np.clip(np.searchsorted(edges, sims, side="right") - 1,
                        0, len(edges) - 2)
        centers, means = [], []
        for b in range(len(edges) - 1):
            sel = which == b
            if sel.any():
                centers.append(float(sims[sel].mean()))
                means.append(float(loss[sel].mean()))
        # monotone non-increasing in sim: ε at higher similarity never exceeds
        # ε at lower similarity (running min, low→high)
        mono = np.minimum.accumulate(np.asarray(means))
        return cls(sim_grid=np.asarray(centers), eps_grid=mono)


@dataclass(frozen=True)
class SemHit:
    """One thresholded nearest-neighbor hit, fully priced."""

    source_idx: int                   # the stored query whose answer is reused
    similarity: float
    utility_raw: float                # the cached answer's judged utility
    utility: float                    # u · (1 − ε(sim)) — what the hit serves
    utility_loss: float               # u · ε(sim) — the discounted estimate
    epsilon: float                    # ε(sim)
    model: int
    content: Optional[str]


@dataclass
class _Entry:
    utility: float
    model: int
    content: Optional[str]
    n_bytes: int
    expires_at: float


class _LshIndex:
    """Optional bucketed index: sign-pattern buckets over seeded random
    hyperplanes.  Lookup probes the query's bucket plus all Hamming-distance-1
    neighbors — approximate (a near-dup in a distant bucket is missed), but
    the candidate set stays small for large stores."""

    def __init__(self, dim: int, n_planes: int, seed: int):
        rng = np.random.default_rng(seed)
        self.planes = rng.normal(size=(dim, n_planes)).astype(np.float32)
        self.buckets: dict[int, set[int]] = {}

    def _code(self, emb: np.ndarray) -> int:
        bits = (emb @ self.planes) >= 0.0
        return int(sum(1 << b for b, on in enumerate(bits) if on))

    def add(self, key: int, emb: np.ndarray) -> None:
        self.buckets.setdefault(self._code(emb), set()).add(key)

    def remove(self, key: int, emb: np.ndarray) -> None:
        code = self._code(emb)
        bucket = self.buckets.get(code)
        if bucket is not None:
            bucket.discard(key)
            if not bucket:
                del self.buckets[code]

    def candidates(self, emb: np.ndarray) -> list[int]:
        code = self._code(emb)
        probe = [code] + [code ^ (1 << b)
                          for b in range(self.planes.shape[1])]
        out: list[int] = []
        for c in probe:
            out.extend(self.buckets.get(c, ()))
        return out


class SemanticCache:
    """Embedding-similarity response cache over workload query indices.

    ``embeddings`` is the fitted space (rows indexed by workload query id);
    :meth:`from_artifacts` builds both it and the ε(sim) calibration from a
    fitted :class:`repro_torch.core.robatch.Robatch`.  All times are the serving
    timeline the online server ticks on (virtual or wall-relative seconds).
    The brute-force key matrix lives on ``device`` (the card unless "cpu"
    is asked); the LSH index stays in numpy on the host.
    """

    def __init__(self, config: SemanticCacheConfig, embeddings: np.ndarray,
                 eps_model: EpsilonModel, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        emb = np.asarray(embeddings, dtype=np.float32)
        self._emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
        self.eps_model = eps_model
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._index = (_LshIndex(emb.shape[1], config.lsh_planes,
                                 config.calib_seed)
                       if config.index == "lsh" else None)
        self._key_matrix: Optional[torch.Tensor] = None  # brute-force cache
        self._key_order: list[int] = []
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.expirations = 0
        self.utility_loss = 0.0       # Σ u·ε(sim) over all hits served

    # ------------------------------------------------------------- internals
    def _entry_bytes(self, content: Optional[str]) -> int:
        return (len(content.encode()) if content else 0) + _ENTRY_OVERHEAD_BYTES

    def _drop(self, key: int, counter: Optional[str] = None) -> None:
        entry = self._entries.pop(key)
        self.total_bytes -= entry.n_bytes
        if self._index is not None:
            self._index.remove(key, self._emb[key])
        self._key_matrix = None
        if counter is not None:
            setattr(self, counter, getattr(self, counter) + 1)

    def _expire(self, now: float) -> None:
        dead = [k for k, e in self._entries.items() if e.expires_at <= now]
        for k in dead:
            self._drop(k, "expirations")

    def _top1(self, q: np.ndarray) -> tuple[Optional[int], float]:
        """Exact brute-force top-1 (torch matmul on the device) or
        LSH-bucketed top-1."""
        if self._index is not None:
            cand = self._index.candidates(q)
            if not cand:
                return None, -1.0
            sims = self._emb[cand] @ q
            best = int(np.argmax(sims))
            return cand[best], float(sims[best])
        if self._key_matrix is None:
            self._key_order = list(self._entries)
            self._key_matrix = torch.from_numpy(self._emb[self._key_order]).to(self.device)
        sims = torch.matmul(self._key_matrix, torch.from_numpy(q).to(self.device))
        best = int(torch.argmax(sims))
        return self._key_order[best], float(sims[best])

    # ------------------------------------------------------------------- api
    @classmethod
    def from_artifacts(cls, rb, config: SemanticCacheConfig) -> "SemanticCache":
        """Reuse the router's fitted embedding space + labels: the workload
        embeddings the KNN router measures cosine similarity in, and its b=1
        ground-truth labels as the ε(sim) calibration pairs.  The key matrix
        goes on the artifacts' device (``rb.device``)."""
        assert rb.router is not None, "Robatch must be fitted first"
        emb = np.asarray(rb.wl.embeddings, dtype=np.float32)
        tr = np.asarray(rb._train_idx)
        emb_n = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
        eps = EpsilonModel.fit(emb_n[tr], rb.train_labels,
                               n_pairs=config.calib_pairs,
                               n_bins=config.calib_bins,
                               seed=config.calib_seed)
        return cls(config, emb, eps, device=rb.device)

    def lookup(self, query_idx: int, now: float = 0.0) -> Optional[SemHit]:
        """Thresholded nearest-neighbor lookup; a hit refreshes LRU recency
        and accrues the calibrated utility-loss estimate."""
        if not np.isfinite(self.cfg.sim_threshold):
            return None               # cache off: not even a counted miss
        self._expire(now)
        if not self._entries:
            self.misses += 1
            return None
        key, sim = self._top1(self._emb[int(query_idx)])
        if key is None or sim < self.cfg.sim_threshold:
            self.misses += 1
            return None
        entry = self._entries[key]
        self._entries.move_to_end(key)
        eps = self.eps_model(sim)
        loss = entry.utility * eps
        self.hits += 1
        self.utility_loss += loss
        return SemHit(source_idx=key, similarity=sim,
                      utility_raw=entry.utility,
                      utility=entry.utility * (1.0 - eps),
                      utility_loss=loss, epsilon=eps,
                      model=entry.model, content=entry.content)

    def insert(self, query_idx: int, utility: float, model: int,
               content: Optional[str], now: float = 0.0) -> None:
        """Store a served answer; TTL from ``now``, LRU-evict past the byte
        budget.  An entry larger than the whole budget is simply not stored."""
        if not np.isfinite(self.cfg.sim_threshold):
            return
        key = int(query_idx)
        n_bytes = self._entry_bytes(content)
        if n_bytes > self.cfg.max_bytes:
            return
        if key in self._entries:
            self._drop(key)               # replace: refresh value + recency
        self._entries[key] = _Entry(utility=float(utility), model=int(model),
                                    content=content, n_bytes=n_bytes,
                                    expires_at=now + self.cfg.ttl_s)
        self.total_bytes += n_bytes
        if self._index is not None:
            self._index.add(key, self._emb[key])
        self._key_matrix = None
        self.insertions += 1
        while self.total_bytes > self.cfg.max_bytes and len(self._entries) > 1:
            self._drop(next(iter(self._entries)), "evictions")

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return dict(entries=len(self._entries), bytes=self.total_bytes,
                    hits=self.hits, misses=self.misses,
                    insertions=self.insertions, evictions=self.evictions,
                    expirations=self.expirations,
                    utility_loss=self.utility_loss)
