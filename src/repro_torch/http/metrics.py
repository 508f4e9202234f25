"""Prometheus-style metrics for the serving plane, stdlib-only.

:class:`MetricsRegistry` holds counter/gauge/histogram families with label
support and renders the Prometheus text exposition format (version 0.0.4 —
``# HELP``/``# TYPE`` headers, ``name{label="value"} number`` samples,
cumulative ``_bucket{le=...}`` histograms).  No client library: the format is
a dozen lines of string assembly, and ``requirements-ci.txt`` stays lean.

:func:`bind_server_metrics` wires a registry to a running
:class:`repro_torch.serving.online.OnlineRobatchServer` through its ``on_window`` /
``on_complete`` hooks, translating the serving plane's existing signals —
window accounting, per-member capacity pressure, breaker transitions, replica
counts and pending async builds, paged-KV occupancy, budget spend — into
scrapeable families.  The HTTP front-end (:mod:`repro_torch.http.server`) adds its
own request/latency families on top and serves ``registry.render()`` at
``GET /metrics``.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bind_server_metrics", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Family:
    """One metric family: a name, a help line, and children keyed by label
    values.  A family with no ``labelnames`` has exactly one anonymous child
    and the family itself proxies its methods."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        assert set(labels) == set(self.labelnames), \
            f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
            return child

    def _default(self):
        return self.labels() if not self.labelnames else None

    def _label_str(self, key: tuple) -> str:
        if not key:
            return ""
        pairs = ",".join(f'{n}="{_escape(v)}"'
                          for n, v in zip(self.labelnames, key))
        return "{" + pairs + "}"

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            lines.extend(child.render_samples(self.name, self._label_str(key)))
        return lines


class _CounterChild:
    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, "counters only go up"
        self.value += amount

    def render_samples(self, name: str, labels: str) -> list[str]:
        return [f"{name}{labels} {_fmt(self.value)}"]


class Counter(_Family):
    kind = "counter"
    _child = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)


class _GaugeChild:
    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def render_samples(self, name: str, labels: str) -> list[str]:
        return [f"{name}{labels} {_fmt(self.value)}"]


class Gauge(_Family):
    kind = "gauge"
    _child = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)


class _HistogramChild:
    def __init__(self, buckets: Sequence[float]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.total += 1
        i = bisect_left(self.buckets, v)
        if i < len(self.counts):
            self.counts[i] += 1

    def render_samples(self, name: str, labels: str) -> list[str]:
        # cumulative le-buckets, as Prometheus requires
        base = labels[1:-1] if labels else ""
        lines, cum = [], 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            sep = "," if base else ""
            lines.append(f'{name}_bucket{{{base}{sep}le="{_fmt(le)}"}} {cum}')
        sep = "," if base else ""
        lines.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {self.total}')
        lines.append(f"{name}_sum{labels} {_fmt(self.sum)}")
        lines.append(f"{name}_count{labels} {self.total}")
        return lines


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class MetricsRegistry:
    """Named metric families, rendered together at ``GET /metrics``."""

    def __init__(self):
        self._families: "dict[str, _Family]" = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help_text,
                                                 labelnames, **kw)
            assert isinstance(fam, cls) and fam.labelnames == tuple(labelnames), \
                f"metric {name} re-registered with a different signature"
            return fam

    def counter(self, name: str, help_text: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_text, labelnames,
                              buckets=buckets)

    def render(self) -> str:
        with self._lock:
            families = sorted(self._families.items())
        lines: list[str] = []
        for _, fam in families:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


def bind_server_metrics(registry: MetricsRegistry, server,
                        prefix: str = "robatch") -> MetricsRegistry:
    """Populate ``registry`` from a server's existing signals via its
    ``on_window``/``on_complete`` hooks.  Idempotent families (re-binding a
    second server to the same registry reuses them); chains with any hooks
    already installed."""
    names = [m.name for m in server.pool]

    completions = registry.counter(
        f"{prefix}_requests_total", "completed requests by outcome",
        ("outcome",))
    latency = registry.histogram(
        f"{prefix}_request_latency_seconds",
        "request latency (arrival to completion, serving timeline)")
    utility = registry.counter(
        f"{prefix}_utility_sum", "summed judged utility of served requests")
    cost = registry.counter(
        f"{prefix}_cost_dollars_total", "realized billed cost by member",
        ("member",))
    windows = registry.counter(f"{prefix}_windows_total",
                               "scheduling rounds run")
    pending = registry.gauge(f"{prefix}_pending_requests",
                             "queue depth entering the last round")
    late = registry.gauge(f"{prefix}_window_late_seconds",
                          "realtime lateness of the last round")
    spent_g = registry.gauge(f"{prefix}_budget_spent_dollars",
                             "total realized budget spend")
    window_ctr = registry.counter(
        f"{prefix}_window_events_total",
        "per-round accounting events (admitted/deferred/shed/...)", ("event",))
    held = registry.counter(
        f"{prefix}_capacity_held_total",
        "queries held out by a member's replica caps", ("member",))
    packed = registry.counter(
        f"{prefix}_capacity_packed_total",
        "queries re-packed into wider batches by a member's caps", ("member",))
    pressure = registry.gauge(
        f"{prefix}_member_pressure",
        "cumulative capacity pressure (held+packed queries) per member",
        ("member",))
    breaker_state = registry.gauge(
        f"{prefix}_breaker_state",
        "circuit breaker state per member (0=closed 1=half-open 2=open)",
        ("member",))
    breaker_trips = registry.counter(
        f"{prefix}_breaker_trips_total", "breaker close->open transitions",
        ("member",))
    replicas = registry.gauge(f"{prefix}_member_replicas",
                              "active replicas per member", ("member",))
    scale_events = registry.counter(
        f"{prefix}_scale_events_total",
        "autoscale actions fired, by member and direction", ("member", "direction"))
    pending_builds = registry.gauge(
        f"{prefix}_member_pending_builds",
        "async replica builds launched but not yet attached", ("member",))
    kv_pages = registry.gauge(
        f"{prefix}_kv_pages", "paged-KV occupancy per member",
        ("member", "kind"))
    cache_entries = registry.gauge(f"{prefix}_cache_entries",
                                   "response cache live entries")
    cache_hits = registry.gauge(f"{prefix}_cache_hits_total",
                                "response cache hits")
    sem_events = registry.counter(
        f"{prefix}_semcache_events_total",
        "semantic cache events (hit/miss/insert/evict/expire)", ("event",))
    sem_entries = registry.gauge(f"{prefix}_semcache_entries",
                                 "semantic cache live entries")
    sem_bytes = registry.gauge(f"{prefix}_semcache_bytes",
                               "semantic cache stored answer bytes")
    sem_loss = registry.gauge(
        f"{prefix}_semcache_utility_loss_sum",
        "summed calibrated utility-loss estimate u·ε(sim) over hits")
    sem_sim = registry.histogram(
        f"{prefix}_semcache_hit_similarity",
        "cosine similarity of semantic cache hits",
        buckets=(0.80, 0.84, 0.88, 0.90, 0.92, 0.94, 0.96, 0.98, 0.99, 1.0))

    from repro_torch.serving.fault import CircuitState
    state_code = {CircuitState.CLOSED: 0, CircuitState.HALF_OPEN: 1,
                  CircuitState.OPEN: 2}
    # pressure gauges surface even before any pressure accrues — a scrape
    # right after boot must already carry one sample per member
    own_pressure = {k: 0 for k in range(len(names))}
    for name in names:
        pressure.labels(member=name).set(0)
        breaker_trips.labels(member=name)     # zero-valued child
    trips_seen = [br.n_trips for br in server.breakers]

    # semantic-cache counters are cumulative on the cache object — scrape
    # deltas per window so a re-bound registry never double-counts
    sem_seen = {"hit": 0, "miss": 0, "insert": 0, "evict": 0, "expire": 0}

    def on_complete(req) -> None:
        if req.dropped:
            completions.labels(outcome="dropped").inc()
        else:
            outcome = ("sem_hit" if req.sem_hit
                       else "cache_hit" if req.cache_hit else "served")
            completions.labels(outcome=outcome).inc()
            latency.observe(max(0.0, req.latency))
            utility.inc(float(req.utility or 0.0))
            if req.sem_hit:
                sem_sim.observe(req.sem_sim)
        if req.model is not None and req.cost:
            cost.labels(member=names[req.model]).inc(req.cost)

    def on_window(rep) -> None:
        windows.inc()
        pending.set(rep.n_pending)
        late.set(rep.late_s)
        spent_g.set(server.bucket.total_spent)
        cache_entries.set(len(server.cache))
        cache_hits.set(server.cache.hits)
        sc = getattr(server, "semcache", None)
        if sc is not None:
            sem_entries.set(len(sc))
            sem_bytes.set(sc.total_bytes)
            sem_loss.set(sc.utility_loss)
            for event, total in (("hit", sc.hits), ("miss", sc.misses),
                                 ("insert", sc.insertions),
                                 ("evict", sc.evictions),
                                 ("expire", sc.expirations)):
                if total > sem_seen[event]:
                    sem_events.labels(event=event).inc(total - sem_seen[event])
                    sem_seen[event] = total
        for event, n in (("admitted", rep.n_admitted),
                         ("deferred", rep.n_deferred),
                         ("shed", rep.n_shed), ("failed", rep.n_failed),
                         ("coalesced", rep.n_coalesced),
                         ("groups", rep.n_groups)):
            if n:
                window_ctr.labels(event=event).inc(n)
        for k, n in rep.held_by_member:
            held.labels(member=names[k]).inc(n)
            own_pressure[k] += n
        for k, n in rep.packed_by_member:
            packed.labels(member=names[k]).inc(n)
            own_pressure[k] += n
        # satellite: Autoscaler.pressure_by_member as per-member gauges —
        # the autoscaler's own accumulation when one is attached, the same
        # held+packed sum accumulated here when the pool is fixed
        by_member = (server.autoscaler.pressure_by_member
                     if server.autoscaler is not None else own_pressure)
        for k, n in by_member.items():
            pressure.labels(member=names[k]).set(n)
        for k, (br, name) in enumerate(zip(server.breakers, names)):
            breaker_state.labels(member=name).set(state_code[br.state])
            if br.n_trips > trips_seen[k]:
                breaker_trips.labels(member=name).inc(br.n_trips - trips_seen[k])
                trips_seen[k] = br.n_trips
        for member, from_n, to_n in getattr(rep, "scale_events", ()):
            direction = "up" if to_n > from_n else "down"
            scale_events.labels(member=member, direction=direction).inc()
        for k, n in enumerate(rep.replica_counts):
            replicas.labels(member=names[k]).set(n)
        for name, m in zip(names, server.pool):
            nb = getattr(m, "n_pending_builds", None)
            if nb is not None:
                pending_builds.labels(member=name).set(int(nb))
        for k, used, shared, forks in rep.kv_pages:
            kv_pages.labels(member=names[k], kind="used").set(used)
            kv_pages.labels(member=names[k], kind="shared").set(shared)
            kv_pages.labels(member=names[k], kind="cow_forks").set(forks)

    def chain(old, new):
        if old is None:
            return new

        def both(arg):
            old(arg)
            new(arg)
        return both

    server.on_complete = chain(server.on_complete, on_complete)
    server.on_window = chain(server.on_window, on_window)
    return registry


def make_registry(server=None, prefix: str = "robatch",
                  registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Convenience: a fresh registry, optionally pre-bound to a server."""
    registry = registry if registry is not None else MetricsRegistry()
    if server is not None:
        bind_server_metrics(registry, server, prefix=prefix)
    return registry
