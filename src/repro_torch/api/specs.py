"""Declarative experiment specs with dict/JSON round-trip.

An experiment is data, not wiring code: a :class:`RunSpec` names the pool
(:class:`PoolSpec` — calibrated simulator family or the trained tiny real
pool), the strategy (:class:`PolicySpec` — a registry name plus params) and
the shared modeling-stage hyper-parameters.  ``Gateway.from_spec`` turns one
into a runnable system; ``serve --spec run.json`` does the same from the
command line.

Round-trip contract (tested in ``tests/test_api.py``)::

    spec == RunSpec.from_json(spec.to_json())
    spec == RunSpec.from_dict(spec.to_dict())
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, fields

__all__ = ["PoolSpec", "PolicySpec", "RunSpec"]


def _from_known_fields(cls, d: dict):
    known = {f.name for f in fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown spec keys {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    return cls(**d)


@dataclass
class PoolSpec:
    """Where the pool and its workload come from.

    ``kind="simulated"`` — the calibrated simulator (`repro_torch.data.simulator`)
    over a benchmark workload; subsumes the ad-hoc construction previously
    wired by ``benchmarks/common.py`` and the serve CLI's flag soup.
    ``kind="tiny"`` — the REAL trained tiny-s/m/l pool
    (`repro_torch.serving.tinypool`), served by the continuous-batching engine.
    """

    kind: str = "simulated"          # simulated | tiny
    family: str = "qwen3"            # simulated: POOL_SPECS family
    task: str = "agnews"             # simulated: workload benchmark name
    n_train: int = 2048
    n_val: int = 512
    n_test: int = 1024
    seed: int = 0
    steps: int = 300                 # tiny: LM training steps
    replicas: int = 1                # engines per member (ReplicaSet when > 1)
    min_replicas: int = 0            # autoscale floor (0 = unset → 1)
    max_replicas: int = 0            # autoscale ceiling (0 = fixed-size pool)
    semantic_cache: bool = False     # embedding-space near-duplicate cache
    sim_threshold: float = 0.92      # cosine hit threshold when enabled
    draft_member: str = ""           # tiny: cheap member that drafts for the
    #   more expensive ones (routed speculative decoding); "" = off
    spec_k: int = 4                  # speculation depth when drafting
    temperature: float = 0.0         # default sampling knobs for real members
    top_k: int = 0                   # (0/1.0 defaults = greedy legacy path)
    top_p: float = 1.0
    gen_seed: int = 0                # PRNG seed for sampled decoding

    def build(self, device="cuda"):
        """Materialize → (workload, pool).

        ``replicas > 1`` wraps every member in a
        :class:`repro_torch.serving.pool.ReplicaSet` — N deterministic copies for
        the simulator, N engines sharing one set of trained weights for the
        tiny pool — so the online scheduler gets real per-member concurrency
        (and the matching per-window capacity caps).  ``max_replicas > 0``
        declares the pool autoscalable: members are wrapped in ReplicaSets
        even at ``replicas=1`` and carry a replica factory, so
        :class:`repro_torch.serving.autoscale.Autoscaler` can grow them to the
        ceiling at serving time.  The tiny pool trains and serves on
        ``device`` (the card unless ``"cpu"`` is asked)."""
        if self.replicas < 1:
            raise ValueError(f"PoolSpec.replicas must be >= 1, got {self.replicas}")
        if self.max_replicas and self.max_replicas < max(self.replicas,
                                                         self.min_replicas):
            raise ValueError(f"PoolSpec.max_replicas={self.max_replicas} below "
                             f"replicas={self.replicas}/min_replicas="
                             f"{self.min_replicas}")
        scalable = self.max_replicas > 0
        if self.draft_member and self.kind != "tiny":
            raise ValueError("PoolSpec.draft_member needs kind='tiny' — only "
                             "real engines can speculative-decode")
        if self.kind == "simulated":
            from repro_torch.data import make_simulated_pool, make_workload

            wl = make_workload(self.task, n_train=self.n_train, n_val=self.n_val,
                               n_test=self.n_test, seed=self.seed)
            pool = make_simulated_pool(self.family)
            if self.replicas > 1 or scalable:
                from repro_torch.serving.pool import replicate_simulated

                pool = [replicate_simulated(m, self.replicas) for m in pool]
            return wl, pool
        if self.kind == "tiny":
            import numpy as np

            from repro_torch.serving.tinypool import build_tiny_pool

            rng = np.random.default_rng(self.seed)
            wl, pool, _fmt = build_tiny_pool(rng, steps=self.steps,
                                             n_train=self.n_train,
                                             n_test=self.n_test,
                                             replicas=self.replicas,
                                             scalable=scalable,
                                             draft_member=self.draft_member,
                                             spec_k=self.spec_k,
                                             device=device)
            return wl, pool
        raise ValueError(f"PoolSpec.kind must be 'simulated' or 'tiny', "
                         f"got {self.kind!r}")

    def autoscale_policy(self, **overrides):
        """An :class:`~repro_torch.serving.autoscale.AutoscalePolicy` bounded by
        this spec (``None`` when the spec declares no ceiling)."""
        if self.max_replicas <= 0 and "max_replicas" not in overrides:
            return None
        from repro_torch.serving.autoscale import AutoscalePolicy

        kw = dict(min_replicas=max(1, self.min_replicas),
                  max_replicas=self.max_replicas or max(1, self.replicas))
        kw.update(overrides)
        return AutoscalePolicy(**kw)

    def generation_config(self, **overrides):
        """A :class:`~repro_torch.serving.generation.GenerationConfig` from this
        spec's sampling fields (``None`` when every field is at its greedy
        default and no override is given — the legacy bit-identical path)."""
        unset = (self.temperature == 0.0 and self.top_k == 0
                 and self.top_p == 1.0)
        if unset and not overrides:
            return None
        from repro_torch.serving.generation import GenerationConfig

        kw = dict(temperature=self.temperature, top_k=self.top_k,
                  top_p=self.top_p, seed=self.gen_seed)
        kw.update(overrides)
        return GenerationConfig(**kw)

    def semcache_config(self, **overrides):
        """A :class:`~repro_torch.serving.semcache.SemanticCacheConfig` from this
        spec's flags (``None`` when the spec does not enable the cache)."""
        if not self.semantic_cache:
            return None
        from repro_torch.serving.semcache import SemanticCacheConfig

        kw = dict(sim_threshold=self.sim_threshold)
        kw.update(overrides)
        return SemanticCacheConfig(**kw)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PoolSpec":
        return _from_known_fields(cls, dict(d))


@dataclass
class PolicySpec:
    """A registry name plus its constructor params."""

    name: str = "robatch"
    params: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: dict) -> "PolicySpec":
        return _from_known_fields(cls, dict(d))

    def build(self):
        """Instantiate the (unfitted) policy from the registry."""
        from repro_torch.api.policy import get_policy

        return get_policy(self.name)(**self.params)


@dataclass
class RunSpec:
    """One full experiment: pool + policy + shared modeling hyper-parameters
    (§6.1.4 defaults — these configure the once-fitted artifact bundle that
    every policy reuses)."""

    pool: PoolSpec = field(default_factory=PoolSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    router: str = "mlp"              # mlp | knn
    knn_k: int = 16
    coreset_method: str = "kcenter"
    coreset_size: int = 256
    scaling_fit: str = "piecewise"   # piecewise | powerlaw | knn
    epsilon: float = 0.01
    grid_multiple: int = 4
    seed: int = 0

    def robatch_kwargs(self) -> dict:
        """Modeling-stage kwargs for :class:`repro_torch.core.robatch.Robatch`."""
        return dict(router_kind=self.router, knn_k=self.knn_k,
                    coreset_method=self.coreset_method,
                    coreset_size=self.coreset_size,
                    scaling_fit=self.scaling_fit, epsilon=self.epsilon,
                    grid_multiple=self.grid_multiple, seed=self.seed)

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> dict:
        d = asdict(self)
        d["pool"] = self.pool.to_dict()
        d["policy"] = self.policy.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        d = dict(d)
        if "pool" in d:
            d["pool"] = PoolSpec.from_dict(d["pool"])
        if "policy" in d:
            d["policy"] = PolicySpec.from_dict(d["policy"])
        return _from_known_fields(cls, d)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        return cls.from_dict(json.loads(text))
