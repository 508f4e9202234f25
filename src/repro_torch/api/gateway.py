"""Gateway — one facade over the whole control plane, offline and online.

::

    gw = Gateway.from_spec(RunSpec(...)).fit()        # pool + artifacts, once
    out = gw.submit(test_idx, budget)                 # offline commit
    out = gw.submit(test_idx, policy="routellm", tau=0.6, b=8)
    stats = gw.serve(arrivals, OnlineConfig(...))     # streaming (PR-1 layer)

One modeling stage (router, calibrations, profiling cache) is fitted per
gateway and shared by every policy requested from it, so sweeping strategies
(fig7/fig8) never re-bills the offline evaluation.

The gateway runs on ``device`` (the card unless ``"cpu"`` is asked): its MLP
router trains and predicts there, and the semantic cache keeps its keys
there.  ``serve_http`` puts the HTTP front end (``repro_torch.http``) over
a live online server.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.api.policy import Plan, SchedulingPolicy, get_policy
from repro_torch.api.specs import RunSpec
from repro_torch.core.robatch import ExecutionOutcome, Robatch
from repro_torch.device import resolve_device

__all__ = ["Gateway"]


class Gateway:
    """Facade binding a (pool, workload) to the policy registry.

    ``artifacts`` is the shared fitted :class:`Robatch` bundle; pass a
    pre-fitted one to reuse an existing modeling stage (the parity tests do),
    otherwise :meth:`fit` fits it from the spec's hyper-parameters, on
    ``device``.
    """

    def __init__(self, pool: Sequence, wl, spec: Optional[RunSpec] = None,
                 artifacts: Optional[Robatch] = None, device="cuda"):
        self.device = resolve_device(device)
        self.pool = list(pool)
        self.wl = wl
        self.spec = spec if spec is not None else RunSpec()
        self.robatch = artifacts            # the shared modeling artifacts
        self.server = None                  # last online server (post-serve)
        self._policies: dict = {}

    # ----------------------------------------------------------- construction
    @classmethod
    def from_spec(cls, spec: Union[RunSpec, dict, str], device="cuda") -> "Gateway":
        """Build the pool/workload a spec describes (dict and JSON accepted)."""
        if isinstance(spec, str):
            spec = RunSpec.from_json(spec)
        elif isinstance(spec, dict):
            spec = RunSpec.from_dict(spec)
        device = resolve_device(device)
        wl, pool = spec.pool.build(device=device)
        return cls(pool, wl, spec=spec, device=device)

    def fit(self) -> "Gateway":
        """Fit the shared modeling stage once (no-op when already fitted)."""
        if self.robatch is None:
            kw = self.spec.robatch_kwargs()
            n_train = len(self.wl.subset_indices("train"))
            kw["coreset_size"] = min(kw["coreset_size"], max(1, n_train // 2))
            self.robatch = Robatch(self.pool, self.wl, device=self.device, **kw).fit()
        return self

    # ---------------------------------------------------------------- policies
    def policy(self, name: Optional[str] = None, **params) -> SchedulingPolicy:
        """A fitted policy sharing this gateway's artifacts.

        ``name=None`` uses the spec's policy (params merged over the spec's);
        an explicit name uses exactly the given params.  Instances are cached
        per (name, params)."""
        self.fit()
        if name is None:
            name = self.spec.policy.name
            merged = dict(self.spec.policy.params)
            merged.update(params)
            params = merged
        try:
            key = (name, tuple(sorted(params.items())))
            cached = self._policies.get(key)
        except TypeError:                    # unhashable param → skip cache
            key, cached = None, None
        if cached is None:
            cached = get_policy(name)(**params).fit(self.pool, self.wl,
                                                    artifacts=self.robatch)
            if key is not None:
                self._policies[key] = cached
        return cached

    # ----------------------------------------------------------------- offline
    def plan(self, query_idx: Optional[np.ndarray] = None,
             budget: Optional[float] = None, policy: Optional[str] = None,
             **params) -> Plan:
        """Plan without committing (inspect the decisions / Pareto stats)."""
        idx = self.wl.subset_indices("test") if query_idx is None else query_idx
        return self.policy(policy, **params).plan(idx, budget)

    def submit(self, query_idx: Optional[np.ndarray] = None,
               budget: Optional[float] = None, policy: Optional[str] = None,
               **params) -> ExecutionOutcome:
        """Offline commit: plan the query set and execute the batch plan."""
        idx = self.wl.subset_indices("test") if query_idx is None else query_idx
        return self.policy(policy, **params).run(idx, budget)

    # ------------------------------------------------------------------ online
    def _resolve_autoscale(self, config, autoscale):
        """``autoscale`` overrides ``config.autoscale``: an
        :class:`repro_torch.serving.autoscale.AutoscalePolicy`, ``True`` to take the
        bounds the ``PoolSpec`` declares via ``max_replicas``, or ``False`` to
        pin the pool fixed."""
        from dataclasses import replace

        if autoscale is None:
            return config
        if autoscale is True:
            autoscale = self.spec.pool.autoscale_policy()
            if autoscale is None:
                raise ValueError("Gateway autoscale=True needs the PoolSpec "
                                 "to declare max_replicas > 0")
        elif autoscale is False:
            autoscale = None                     # explicit opt-out: fixed pool
        return replace(config, autoscale=autoscale)

    def _resolve_generation(self, config):
        """Inject the PoolSpec's declared default GenerationConfig when the
        caller's ``OnlineConfig`` does not already carry one — spec-level
        sampling fields (``temperature``/``top_k``/``top_p``/``gen_seed``)
        then apply to every serve entry point, exactly like the semantic
        cache's spec-level enablement."""
        from dataclasses import replace

        if config.generation is not None:
            return config
        gen = self.spec.pool.generation_config()
        if gen is None:
            return config
        return replace(config, generation=gen)

    def _resolve_semcache(self, config):
        """Inject the PoolSpec's declared semantic cache when the caller's
        ``OnlineConfig`` does not already carry one — spec-level
        ``semantic_cache=True`` enables it for every serve entry point
        without threading a config through each call site."""
        from dataclasses import replace

        if config.semantic_cache is not None:
            return config
        semcache = self.spec.pool.semcache_config()
        if semcache is None:
            return config
        return replace(config, semantic_cache=semcache)

    def serve(self, arrivals, config, policy: Optional[str] = None,
              pool: Optional[Sequence] = None, live: bool = False,
              clock=None, autoscale=None, metrics=None, **params):
        """Stream an arrival list through the online serving layer under the
        selected policy; returns :class:`ServerStats` and leaves the drained
        server on ``self.server`` for inspection.

        With ``config.realtime`` the stream is paced against the wall clock
        (injectable via ``clock``); ``live=True`` additionally fronts it with
        a :class:`repro_torch.serving.online.LiveArrivalSource` submission thread
        instead of in-loop admission.  ``autoscale`` overrides
        ``config.autoscale`` (see :meth:`_resolve_autoscale`).  ``metrics``
        takes a :class:`repro_torch.http.metrics.MetricsRegistry` populated live
        through the server's observability hooks (the same wiring
        :meth:`serve_http` exposes at ``GET /metrics``)."""
        from repro_torch.serving.online import OnlineRobatchServer

        if live and not getattr(config, "realtime", False):
            raise ValueError("Gateway.serve(live=True) needs "
                             "OnlineConfig(realtime=True) — a live arrival "
                             "thread cannot pace a virtual clock")
        config = self._resolve_generation(
            self._resolve_semcache(self._resolve_autoscale(config, autoscale)))
        pol = self.policy(policy, **params)
        srv = OnlineRobatchServer(pol, pool if pool is not None else pol.exec_pool,
                                  self.wl, config, clock=clock)
        if metrics is not None:
            from repro_torch.http.metrics import bind_server_metrics

            bind_server_metrics(metrics, srv)
        try:
            if live:
                stats = srv.run_live(arrivals)
            else:
                stats = srv.run(arrivals)
        finally:
            srv.close()
        self.server = srv
        return stats

    def serve_http(self, config, policy: Optional[str] = None,
                   pool: Optional[Sequence] = None, host: str = "127.0.0.1",
                   port: int = 0, autoscale=None, metrics=None, **params):
        """Bring up the OpenAI-compatible HTTP front-end (:mod:`repro_torch.http`)
        over a live online server and return the started
        :class:`repro_torch.http.server.HttpFrontend` (``.port`` carries the bound
        port; call ``.stop()`` to shut down).  The underlying server is left
        on ``self.server`` for inspection, as with :meth:`serve`."""
        from repro_torch.http.server import HttpFrontend
        from repro_torch.serving.online import OnlineRobatchServer

        config = self._resolve_generation(
            self._resolve_semcache(self._resolve_autoscale(config, autoscale)))
        pol = self.policy(policy, **params)
        srv = OnlineRobatchServer(pol, pool if pool is not None else pol.exec_pool,
                                  self.wl, config)
        self.server = srv
        return HttpFrontend(srv, host=host, port=port, metrics=metrics).start()
