"""Synthetic workload generators mirroring the paper's six benchmarks.

The paper evaluates on AGNews, GSM8K, MMLU, SNLI, MRPC and IMDB with
2048/512/1024 train/val/test splits (§6.1.4).  The public datasets (and the
commercial LLM APIs the paper queries) are external artifacts, so we build a
*statistically faithful* synthetic counterpart for each benchmark:

* a latent per-query difficulty whose distribution matches the task's observed
  hardness profile (GSM8K hard & dispersed, IMDB easy & concentrated, ...);
* query embeddings that carry (noisy) information about difficulty and topic
  clusters — exactly the signal a sentence-embedding model exposes to the
  routers in the paper;
* per-query input/output token counts and a shared system-prompt length whose
  cost shares reproduce the paper's measurements (system prompt ≈59.5% of the
  b=1 cost on AGNews and ≈90.1% on GSM8K, §2.2).

Ground-truth utilities come from :mod:`repro_torch.data.simulator` (calibrated pool)
or from a *real* pool served by :mod:`repro_torch.serving` (tiny trained models).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["BenchmarkSpec", "Workload", "BENCHMARKS", "make_workload",
           "alternate_embeddings"]


@dataclass(frozen=True)
class BenchmarkSpec:
    name: str
    task: str                    # classification | reasoning | nli | paraphrase | qa
    n_classes: int               # output label space (reasoning => 0, free-form)
    sys_tokens: int              # shared system prompt length (tokens)
    query_tokens: tuple[float, float]    # lognormal (mean, sigma) of input tokens
    out_tokens: tuple[float, float]      # lognormal (mean, sigma) of output tokens
    difficulty: tuple[float, float]      # Beta(a, b) of latent difficulty in [0, 1]
    n_topics: int                # latent topic clusters (drives embedding structure)
    sensitivity: float           # how fast accuracy drops with difficulty


# Calibration notes
# -----------------
# sys share at b=1  =  sys / (sys + E[q_in]*1 + E[q_out]*r)  with token prices folded
# in later; we calibrate in *tokens* assuming input/output price ratio ~1:4.
# AGNews: sys 90, query ~55, out ~4   -> share ~0.60        (paper: 59.5%)
# GSM8K : sys 1250, query ~65, out ~75 -> share ~0.90       (paper: 90.1%)
BENCHMARKS: dict[str, BenchmarkSpec] = {
    "agnews": BenchmarkSpec("agnews", "classification", 4, 90, (55, 0.35), (4, 0.10),
                            (2.0, 4.5), 4, 7.0),
    "gsm8k": BenchmarkSpec("gsm8k", "reasoning", 0, 1250, (65, 0.45), (75, 0.50),
                           (4.5, 2.2), 8, 5.0),
    "mmlu": BenchmarkSpec("mmlu", "qa", 4, 400, (120, 0.50), (6, 0.15), (3.5, 2.8),
                          57, 5.5),
    "snli": BenchmarkSpec("snli", "nli", 3, 140, (45, 0.30), (4, 0.10), (2.6, 3.2), 6, 6.0),
    "mrpc": BenchmarkSpec("mrpc", "paraphrase", 2, 120, (70, 0.30), (4, 0.10),
                          (2.4, 3.0), 5, 6.0),
    "imdb": BenchmarkSpec("imdb", "classification", 2, 80, (230, 0.45), (4, 0.10),
                          (1.6, 6.0), 3, 8.0),
}


@dataclass
class Workload:
    """A set of queries (one benchmark) with everything the system needs."""

    name: str
    spec: BenchmarkSpec
    embeddings: np.ndarray       # (n, d) float32 — sentence-embedding stand-ins
    difficulty: np.ndarray       # (n,)  float32 in [0,1] — latent; only simulators peek
    topic: np.ndarray            # (n,)  int32 topic cluster ids
    in_tokens: np.ndarray        # (n,)  int32 query input tokens
    out_tokens: np.ndarray       # (n,)  int32 expected output tokens
    sys_tokens: int
    split: dict[str, np.ndarray] = field(default_factory=dict)   # name -> indices

    @property
    def n(self) -> int:
        return len(self.difficulty)

    @property
    def embed_dim(self) -> int:
        return self.embeddings.shape[1]

    def subset_indices(self, part: str) -> np.ndarray:
        return self.split[part]

    def mean_query_tokens(self, part: Optional[str] = None) -> float:
        idx = self.split[part] if part else np.arange(self.n)
        return float(self.in_tokens[idx].mean())


def make_workload(
    name: str,
    n_train: int = 2048,
    n_val: int = 512,
    n_test: int = 1024,
    embed_dim: int = 64,
    seed: int = 0,
) -> Workload:
    """Generate one benchmark workload with the paper's split sizes."""
    spec = BENCHMARKS[name]
    # stable across processes: Python's hash() is salted per interpreter run,
    # which made every process draw a different "same" workload (flaky tests)
    name_seed = zlib.crc32(name.encode())
    rng = np.random.default_rng(np.random.SeedSequence([name_seed, seed]))
    n = n_train + n_val + n_test

    difficulty = rng.beta(*spec.difficulty, size=n).astype(np.float32)
    topic = rng.integers(0, spec.n_topics, size=n).astype(np.int32)

    # Embeddings: topic centroid + difficulty direction + isotropic noise.
    # The router can recover difficulty (and therefore per-model utility) from
    # these, with realistic noise — mirroring what a sentence embedding carries.
    centroids = rng.normal(0, 1.0, size=(spec.n_topics, embed_dim)).astype(np.float32)
    diff_dir = rng.normal(0, 1.0, size=(embed_dim,)).astype(np.float32)
    diff_dir /= np.linalg.norm(diff_dir)
    noise = rng.normal(0, 0.55, size=(n, embed_dim)).astype(np.float32)
    emb = centroids[topic] + 2.2 * np.outer(difficulty - difficulty.mean(), diff_dir) + noise
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8

    mu_in, sg_in = spec.query_tokens
    mu_out, sg_out = spec.out_tokens
    in_tokens = np.maximum(4, rng.lognormal(np.log(mu_in), sg_in, size=n)).astype(np.int32)
    # harder queries tend to need longer answers on reasoning tasks
    out_scale = 1.0 + (1.5 * difficulty if spec.task == "reasoning" else 0.0)
    out_tokens = np.maximum(1, rng.lognormal(np.log(mu_out), sg_out, size=n)
                            * out_scale).astype(np.int32)

    idx = rng.permutation(n)
    split = {
        "train": idx[:n_train],
        "val": idx[n_train:n_train + n_val],
        "test": idx[n_train + n_val:],
    }
    return Workload(
        name=name, spec=spec, embeddings=emb, difficulty=difficulty, topic=topic,
        in_tokens=in_tokens, out_tokens=out_tokens, sys_tokens=spec.sys_tokens, split=split,
    )


# Embedding-model stand-ins for the §6.4.2 sensitivity study.  Each "model"
# sees the same latent semantics through a different lens: its own rotation,
# dimensionality and noise floor (BGE slightly noisier, E5 slightly cleaner —
# matching the paper's observation that differences stay small).
_EMBED_VARIANTS = {
    "qwen3-0.6b": dict(dim=None, noise=0.0, seed=101),    # the default embeddings
    "e5-base": dict(dim=48, noise=0.10, seed=102),
    "bge-base": dict(dim=48, noise=0.25, seed=103),
}


def alternate_embeddings(wl: Workload, kind: str) -> np.ndarray:
    spec = _EMBED_VARIANTS[kind]
    if spec["dim"] is None and spec["noise"] == 0.0:
        return wl.embeddings
    rng = np.random.default_rng(spec["seed"])
    d_in = wl.embed_dim
    d_out = spec["dim"] or d_in
    proj = rng.normal(0, 1.0 / np.sqrt(d_in), size=(d_in, d_out)).astype(np.float32)
    emb = wl.embeddings @ proj + spec["noise"] * rng.normal(size=(wl.n, d_out)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8
    return emb
