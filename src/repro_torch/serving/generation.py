"""Unified generation configuration (a copy of the JAX package's).

One frozen dataclass carries every per-request generation knob — token
budget, temperature/top-k/top-p sampling, PRNG seed.  JSON/dict round-trip
rejects unknown keys loudly, so a typo'd field never silently falls back to
a default.

``temperature=0`` (the default) is greedy argmax; the port's engine
samples a config with ``greedy`` False with the JAX package's bits
(``repro_torch.utils.prng``).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields, replace


def _from_known_fields(cls, d: dict):
    names = {f.name for f in fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown field(s) {sorted(unknown)}; "
                         f"known: {sorted(names)}")
    return cls(**d)


@dataclass(frozen=True)
class GenerationConfig:
    """Per-request generation knobs.

    ``max_new``      — output token budget (prefill's first token included).
    ``temperature``  — 0 (default) is greedy argmax; > 0 samples from the
                       temperature-scaled distribution.
    ``top_k``        — keep only the k highest-probability tokens (0 = off).
    ``top_p``        — nucleus sampling: keep the smallest prefix of the
                       sorted distribution with cumulative mass ≥ top_p
                       (1.0 = off; the argmax token is always kept).
    ``seed``         — per-request PRNG seed; same seed ⇒ bit-identical
                       streams regardless of batching/replica placement.
    ``decode_block`` — engine fused-scan depth K (0 = keep the engine's
                       configured value; honored at engine construction when
                       threaded through ``PoolSpec``, not per request — K is
                       jit-static).
    """
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    decode_block: int = 0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.decode_block < 0:
            raise ValueError(f"decode_block must be >= 0, got {self.decode_block}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def with_(self, **kw) -> "GenerationConfig":
        return replace(self, **kw)

    # ---------------- dict / JSON round-trip ----------------
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GenerationConfig":
        return _from_known_fields(cls, dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "GenerationConfig":
        return cls.from_dict(json.loads(s))
