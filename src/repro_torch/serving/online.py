"""Online RoBatch serving: streaming admission, windowed scheduling under a
rolling budget, and concurrent cross-model dispatch.

The paper's routing stage (§5, Alg. 1) schedules a *fixed* query set against a
*fixed* budget.  This layer runs the same greedy budget/batch-size assignment
over a live arrival stream:

    arrivals ──► admission window (deadline) ──► response cache
        ──► policy.plan_window(...) against a token-bucket budget ($/s)
        ──► physical batch plan ──► concurrent dispatch
        ──► circuit breaking + rescheduling onto surviving models

Design points:

* **Pluggable policies.**  The per-window decision is any registered
  :class:`repro_torch.api.SchedulingPolicy` — the server only consumes
  ``window_space`` (admission costs) and ``plan_window`` (the decision), so
  RoBatch's windowed Alg. 1, the adapted baselines' budget-aware two-point
  spaces and user strategies all serve interchangeably.

* **Deadline windows.**  Requests accumulate for ``window_s`` seconds, then
  one scheduling round assigns every pending query a (model, batch) state.
  Larger windows amortize the shared system prompt better (more queries per
  physical batch) at the price of queueing latency — the knob benchmarked by
  ``benchmarks/online_throughput.py``.
* **Rolling budget.**  A token bucket refills at ``budget_per_s`` dollars/s up
  to ``burst_s`` seconds of burst.  Each round schedules against the current
  balance; the *realized* (exact, Eq. 4) cost of dispatched batches is then
  drawn down, so estimate-vs-actual drift self-corrects next round.  A query
  whose cheapest state exceeds the bucket *capacity* can never be afforded and
  is shed immediately; one that is merely unaffordable *now* waits.
* **Circuit breaking.**  Each pool member carries a
  :class:`repro_torch.serving.fault.CircuitBreaker`.  An open breaker removes the
  model from the candidate space (``restrict_space``) and the failed window's
  queries are rescheduled onto survivors next round.
* **Response cache.**  The batch-prompt wire format is a pure function of the
  query text (docs/batch_format.md), so responses are cacheable by query
  identity; a hit completes immediately and bills zero cost.  Duplicate
  queries *within* one window coalesce onto a single scheduled instance.
  ``OnlineConfig(semantic_cache=...)`` layers a second, embedding-space cache
  behind the exact one (:mod:`repro_torch.serving.semcache`): near-duplicate queries
  above a cosine threshold reuse a cached answer at zero cost, discounted by a
  calibrated utility-loss estimate ε(sim) — see docs/caching.md.
* **Virtual time.**  The server is tick-driven on an injectable clock: service
  latencies come from ``BatchResult.latency_s`` (measured for real engines,
  simulated for the calibrated pool), so benchmarks never sleep.

* **Real time.**  ``OnlineConfig(realtime=True)`` paces the same tick loop
  against a wall clock instead: ``run`` sleeps to each window boundary (late
  windows are accounted in ``WindowReport.late_s``, never skipped), the
  ``BudgetBucket`` refills on elapsed wall seconds, and ``run_live`` fronts a
  :class:`LiveArrivalSource` thread that submits a seeded arrival stream at
  its wall-clock due times.  The time source is injectable
  (:class:`MonotonicClock` in production, :class:`FakeClock` in tests), and
  arrival *generation* is split from *pacing* (:func:`arrival_stream` vs. the
  pacer), so one seeded stream replays identically in both modes.

* **Live ingress.**  ``submit_request`` is the bridge the HTTP front-end
  (:mod:`repro_torch.http`) sits on: it returns an :class:`OnlineRequest` carrying a
  ``done_event`` the caller blocks on and, for streamed responses, a
  :class:`StreamSink` the batch-prompt demultiplexer pushes per-decode-block
  text deltas into.  ``run_bridge`` paces the same windowed ``step()`` loop
  against the wall clock with no pre-generated arrival list — requests arrive
  concurrently from handler threads.  ``_complete`` finalizes every request
  with its answer text (``OnlineRequest.content``): the parsed generation for
  real engines, a deterministic synthesized line for calibrated simulators,
  the cached text on a cache hit.

* **Replica capacity.**  A replicated member
  (:class:`repro_torch.serving.pool.ReplicaSet`) can run at most ``n_replicas``
  batch-groups concurrently, so the server threads per-member group caps into
  the windowed scheduler (``group_caps`` in
  :func:`repro_torch.core.scheduler.greedy_schedule_window`).  Caps-aware policies
  take the caps into the frontier walk itself (the capacity-aware Δ-heap
  packs over-cap members into fewer, larger batches before deferring); the
  server's own per-group backstop holds whatever caps-unaware plans overflow
  — capacity backpressure composes with budget backpressure instead of
  silently queueing on one engine's lock.

* **Autoscaling.**  ``OnlineConfig(autoscale=AutoscalePolicy(...))`` attaches
  a :class:`repro_torch.serving.autoscale.Autoscaler`: each window's backlog
  (capacity-held + packed queries, queue depth, realtime lateness) feeds a
  hysteresis/cooldown control loop that grows or shrinks every scalable
  member via ``ReplicaSet.scale_to`` — the new capacity lands in the caps the
  next window plans against.
"""
from __future__ import annotations

import inspect
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import attach_free_assignments, restrict_space, take_rows
from repro_torch.serving.autoscale import Autoscaler, AutoscalePolicy
from repro_torch.serving.fault import BreakerPolicy, CircuitBreaker, CircuitState
from repro_torch.serving.generation import GenerationConfig
from repro_torch.serving.semcache import SemanticCacheConfig

__all__ = ["OnlineRequest", "OnlineConfig", "BudgetBucket", "ResponseCache",
           "StreamSink", "WindowReport", "ServerStats", "OnlineRobatchServer",
           "MonotonicClock", "FakeClock", "LiveArrivalSource",
           "arrival_stream", "poisson_arrivals"]


class MonotonicClock:
    """Wall time: the production time source for ``realtime`` serving."""

    now = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


class FakeClock:
    """Deterministic time source: ``sleep`` advances ``now`` instantly, so
    real-time pacing logic runs under test without wall-clock waits.

    Single-threaded by design — with two sleepers sharing one fake clock
    (e.g. a pacer thread plus the serving loop) the unsynchronized advances
    would add instead of overlap.  Use it with ``run``/``run_paced``;
    ``run_live`` refuses it and needs a real clock."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)
        self.n_sleeps = 0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.n_sleeps += 1
        self.t += max(0.0, float(dt))


class StreamSink:
    """Per-request live delta channel between the serving plane and a waiting
    consumer (an SSE handler thread, a test).

    The batch-prompt demultiplexer (:meth:`repro_torch.serving.pool.ServedPoolMember.
    invoke_batch`) pushes text deltas as decode blocks land; ``_complete``
    seals the stream with the authoritative final answer — any tail the live
    deltas did not cover is pushed first, then a terminal ``("done", None)``
    event (or ``("error", reason)`` for a shed request).  Members that never
    generate text (calibrated simulators, cache hits) stream nothing live, so
    the seal splits their content into two deltas — every streamed completion
    carries ≥ 2 content chunks, whatever served it.

    Events on ``q``: ``("delta", text)``, ``("error", reason)``,
    ``("done", None)``.  push/finish are called from serving-side threads,
    the queue consumer from the subscriber's.
    """

    def __init__(self):
        self.q: "queue.Queue[tuple[str, Optional[str]]]" = queue.Queue()
        self.emitted = ""             # concatenation of all pushed deltas
        self.n_deltas = 0
        self.closed = False

    def push(self, delta: str) -> None:
        if not delta or self.closed:
            return
        self.emitted += delta
        self.n_deltas += 1
        self.q.put(("delta", delta))

    def finish(self, content: str, *, split: bool = False,
               error: Optional[str] = None) -> None:
        if self.closed:
            return
        if error is not None:
            self.q.put(("error", error))
        else:
            tail = content[len(self.emitted):] \
                if content.startswith(self.emitted) else content
            if split and not self.emitted and len(tail) > 1:
                mid = (len(tail) + 1) // 2
                self.push(tail[:mid])
                self.push(tail[mid:])
            elif tail:
                self.push(tail)
        self.closed = True
        self.q.put(("done", None))


@dataclass
class OnlineRequest:
    """One streamed query: a workload index plus serving lifecycle state."""

    rid: int
    query_idx: int
    arrived_at: float
    completed_at: Optional[float] = None
    utility: Optional[float] = None
    model: Optional[int] = None
    batch: Optional[int] = None
    cost: float = 0.0                 # this request's share of billed cost
    cache_hit: bool = False
    sem_hit: bool = False             # served by the semantic (embedding) cache
    sem_sim: float = 0.0              # cosine similarity of the semantic hit
    sem_loss: float = 0.0             # calibrated utility-loss estimate u·ε(sim)
    n_reroutes: int = 0
    dropped: bool = False
    content: Optional[str] = None     # final answer text (set at completion)
    stream: Optional[StreamSink] = None   # live delta channel (submit_request)
    done_event: Optional[threading.Event] = None  # set when _complete runs
    gen: Optional["GenerationConfig"] = None  # per-request sampling override
    #   (None → the server's OnlineConfig.generation, then the member default)

    @property
    def sampled(self) -> bool:
        return self.gen is not None and not self.gen.greedy

    @property
    def latency(self) -> float:
        return self.completed_at - self.arrived_at


class BudgetBucket:
    """Token bucket in dollars: refills at ``rate_per_s``, holds at most
    ``burst_s`` seconds of budget.  ``spend`` may overdraw slightly (realized
    cost of an already-dispatched batch exceeding its amortized estimate);
    the debt suppresses admission until refills cover it."""

    def __init__(self, rate_per_s: float, burst_s: float = 2.0):
        self.rate = float(rate_per_s)
        self.capacity = self.rate * burst_s
        self._balance = self.capacity
        self._last: Optional[float] = None
        self.total_spent = 0.0

    def balance(self, now: float) -> float:
        if self._last is not None and now > self._last:
            self._balance = min(self.capacity, self._balance + self.rate * (now - self._last))
        self._last = now
        return self._balance

    def spend(self, amount: float) -> None:
        self._balance -= amount
        self.total_spent += amount


class ResponseCache:
    """Bounded LRU cache keyed by query identity.

    The byte-level batch prompt is deterministic in the query text, so a
    repeated query is served from cache at zero cost.  Values are
    ``(utility, model_idx, content)`` — what the judge scored when the query
    was first served, where, and the answer text it got (``None`` when the
    member produced no text — the server re-synthesizes deterministically)."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._entries: OrderedDict[int, tuple[float, int, Optional[str]]] = \
            OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: int) -> Optional[tuple[float, int, Optional[str]]]:
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        return None

    def put(self, key: int, value: tuple[float, int, Optional[str]]) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)


@dataclass
class OnlineConfig:
    budget_per_s: float               # rolling budget rate ($/s)
    window_s: float = 0.25            # admission deadline window
    burst_s: float = 2.0              # bucket capacity in seconds of budget
    max_window: int = 512             # queries per scheduling round (backpressure)
    max_reroutes: int = 3             # reschedules before a query is shed
    cache_entries: int = 4096
    breaker: BreakerPolicy = field(default_factory=BreakerPolicy)
    max_workers: Optional[int] = None # dispatch threads (default: total replicas)
    realtime: bool = False            # pace windows against the wall clock
    autoscale: Optional[AutoscalePolicy] = None
    # ^ backlog-driven replica autoscaling (repro_torch.serving.autoscale); None
    #   keeps the pool fixed — only members exposing scale_to participate
    semantic_cache: Optional[SemanticCacheConfig] = None
    # ^ embedding-space near-duplicate cache (repro_torch.serving.semcache) probed
    #   after the exact-match cache and ahead of admission; None (the
    #   default) keeps the serving path bit-identical to the cache-less plane
    generation: Optional[GenerationConfig] = None
    # ^ server-wide default GenerationConfig forwarded to real pool members;
    #   per-request OnlineRequest.gen overrides it, None keeps every member
    #   on its own default (the legacy greedy path, bit-identical)


@dataclass
class WindowReport:
    """One scheduling round's accounting (the server keeps the full list)."""

    t: float
    n_pending: int = 0                # queue depth entering the round
    n_cache_hits: int = 0
    n_sem_hits: int = 0               # semantic-cache (near-duplicate) hits
    sem_utility_loss: float = 0.0     # Σ u·ε(sim) the hits were discounted by
    n_coalesced: int = 0              # duplicate queries merged in-window
    n_admitted: int = 0               # scheduled this round
    n_deferred: int = 0               # unaffordable/over-cap, retried next round
    n_capacity_held: int = 0          # deferred specifically by replica caps
    n_cap_packed: int = 0             # re-packed into wider batches to fit caps
    n_shed: int = 0                   # can never afford → dropped
    n_failed: int = 0                 # queries whose dispatch group faulted
    n_groups: int = 0                 # physical batches dispatched
    avail: float = 0.0                # bucket balance when the round started
    est_cost: float = 0.0             # amortized cost the scheduler committed
    spent: float = 0.0                # realized billed cost (Eq. 4 semantics)
    open_models: tuple = ()           # breaker-open member names
    group_models: tuple = ()          # model index of each dispatched group
    late_s: float = 0.0               # realtime: how late past the boundary
    replica_counts: tuple = ()        # active replicas per member after the round
    held_by_member: tuple = ()        # ((member_idx, n_queries), ...) capacity
    #   holds keyed by the member whose cap pushed the work out — query
    #   granularity (coalesced duplicates count once), unlike the
    #   request-granular n_capacity_held; the bottleneck-member signal a
    #   later per-member autoscaler grows on
    packed_by_member: tuple = ()      # ((member_idx, n_queries), ...) Δ-heap
    #   packing moves keyed by the over-cap member that forced them
    kv_pages: tuple = ()              # ((member_idx, used, shared, forks), ...)
    #   paged-KV occupancy per member with a real engine behind it — the
    #   memory-headroom signal the autoscaler and the bench gate read; empty
    #   entries (simulated members) are omitted
    scale_events: tuple = ()          # ((member_name, from_n, to_n), ...) the
    #   autoscale actions fired on THIS round's control tick — the per-member
    #   attribution the metrics registry turns into
    #   robatch_scale_events_total{member, direction}

    @property
    def kv_occupancy(self) -> int:
        """Total live KV pages across members this round (0 when no member
        runs a paged engine)."""
        return sum(used for _, used, _s, _f in self.kv_pages)

    def summary(self) -> str:
        """One operator-readable line per scheduling round — includes the
        paged-KV occupancy that previously lived only in the dataclass."""
        line = (f"t={self.t:.2f}s pending={self.n_pending} "
                f"admitted={self.n_admitted} groups={self.n_groups} "
                f"deferred={self.n_deferred} held={self.n_capacity_held} "
                f"packed={self.n_cap_packed} shed={self.n_shed} "
                f"spent=${self.spent:.6f}")
        if self.late_s:
            line += f" late={self.late_s * 1e3:.0f}ms"
        if self.replica_counts:
            line += f" replicas={list(self.replica_counts)}"
        if self.kv_pages:
            per = " ".join(f"m{k}:{used}p/{shared}sh/{forks}cow"
                           for k, used, shared, forks in self.kv_pages)
            line += f" kv_pages[{self.kv_occupancy} live: {per}]"
        return line


@dataclass
class ServerStats:
    n_submitted: int
    n_completed: int
    n_cache_hits: int
    n_coalesced: int
    n_dropped: int
    n_reroutes: int
    duration_s: float
    qps: float
    latency_p50: float
    latency_p99: float
    mean_utility: float
    total_cost: float
    budget_allowance: float           # rate·duration + burst capacity
    n_sem_hits: int = 0               # semantic-cache completions
    sem_utility_loss: float = 0.0     # Σ u·ε(sim) across those completions
    windows: list = field(default_factory=list)

    def summary(self) -> str:
        cached = f"{self.n_cache_hits} cached"
        if self.n_sem_hits:
            cached += f" +{self.n_sem_hits} sem"
        return (f"served {self.n_completed - self.n_dropped}/{self.n_submitted} "
                f"({cached}, {self.n_dropped} dropped, "
                f"{self.n_reroutes} reroutes) in {self.duration_s:.1f}s · "
                f"{self.qps:.1f} qps · p50 {self.latency_p50:.2f}s "
                f"p99 {self.latency_p99:.2f}s · util {self.mean_utility:.3f} · "
                f"${self.total_cost:.5f} of ${self.budget_allowance:.5f} allowed")


class OnlineRobatchServer:
    """Streams queries through a pluggable :class:`repro_torch.api.SchedulingPolicy`.

    ``policy`` is any fitted registered policy — the server only consumes the
    policy protocol (``window_space`` for admission + ``plan_window`` for the
    per-window decision), so RoBatch, the adapted baselines and user-written
    strategies all serve interchangeably.  A fitted
    :class:`repro_torch.core.robatch.Robatch` is still accepted and wrapped in the
    ``robatch`` policy (legacy call sites keep working).

    ``pool`` is the member list the dispatcher bills and invokes — usually
    ``policy.exec_pool``, but it may wrap members (e.g.
    :class:`repro_torch.serving.fault.FlakyMember`) as long as order matches, since
    plans refer to members by index.  A member exposing ``n_replicas`` (a
    :class:`repro_torch.serving.pool.ReplicaSet`) caps its per-window batch-groups
    at that count; plain members keep the legacy unbounded-window semantics.

    ``clock`` is the real-time time source (``now()``/``sleep(dt)``); it is
    only consulted when ``config.realtime`` — virtual runs never sleep.
    """

    def __init__(self, policy, pool: Sequence, wl, config: OnlineConfig,
                 clock=None):
        if not hasattr(policy, "window_space"):    # a fitted Robatch (legacy)
            from repro_torch.api.policies import RobatchPolicy

            assert policy.router is not None, "Robatch must be fitted before serving"
            policy = RobatchPolicy().fit(policy.pool, wl, artifacts=policy)
        assert policy.rb is not None, "policy must be fitted before serving"
        assert len(pool) == len(policy.exec_pool), \
            "pool must mirror the policy's exec_pool by index"
        self.policy = policy
        self.rb = policy.rb                        # shared modeling artifacts
        self.pool = list(pool)
        self.wl = wl
        self.cfg = config
        self.clock = clock if clock is not None else MonotonicClock()
        self.now = 0.0
        self.bucket = BudgetBucket(config.budget_per_s, config.burst_s)
        self.cache = ResponseCache(config.cache_entries)
        self.semcache = None
        if config.semantic_cache is not None:
            from repro_torch.serving.semcache import SemanticCache

            self.semcache = SemanticCache.from_artifacts(
                self.rb, config.semantic_cache)
        self.breakers = [CircuitBreaker(config.breaker, clock=lambda: self.now)
                         for _ in self.pool]
        # replica trackers left on their default wall clock are rebound to the
        # serving timeline (virtual ticks or wall-relative seconds), so replica
        # cooldown/probe re-admission recovers on the SAME clock as the
        # member-level breakers; an explicitly injected tracker clock wins
        for m in self.pool:
            tracker = getattr(m, "tracker", None)
            if tracker is not None and tracker.clock is time.monotonic:
                tracker.clock = lambda: self.now
        self._pw_caps = "caps" in inspect.signature(policy.plan_window).parameters
        self.autoscaler = (Autoscaler(self.pool, config.autoscale)
                           if config.autoscale is not None else None)
        self.pending: deque[OnlineRequest] = deque()
        self.completed: list[OnlineRequest] = []
        self.windows: list[WindowReport] = []
        self._locks = [threading.Lock() for _ in self.pool]
        self._submit_lock = threading.Lock()
        workers = config.max_workers or max(
            1, sum(getattr(m, "n_replicas", 1) for m in self.pool),
            # autoscale can grow the pool past its initial size — size the
            # dispatch pool for the ceiling so scaled-up groups run concurrent
            len(self.pool) * (config.autoscale.max_replicas
                              if config.autoscale is not None else 0))
        self._pool_exec = ThreadPoolExecutor(max_workers=workers)
        self._next_rid = 0
        self.n_coalesced = 0
        self.pacer_leaked = False     # run_live: arrival thread outlived join
        # observability hooks (repro_torch.http.metrics binds these): called from
        # the serving thread — keep them fast and non-blocking
        self.on_window = None         # fn(WindowReport) after every round
        self.on_complete = None       # fn(OnlineRequest) at every completion
        self._bridge_t0: Optional[float] = None   # run_bridge timeline origin

    # ------------------------------------------------------------- admission
    def submit(self, query_idx: int, at: Optional[float] = None) -> OnlineRequest:
        """Thread-safe: a LiveArrivalSource submits concurrently with step()."""
        with self._submit_lock:
            req = OnlineRequest(rid=self._next_rid, query_idx=int(query_idx),
                                arrived_at=self.now if at is None else at)
            self._next_rid += 1
            self.pending.append(req)
            return req

    def submit_request(self, query_idx: int, *, stream: bool = False,
                       at: Optional[float] = None,
                       gen: Optional[GenerationConfig] = None) -> OnlineRequest:
        """Live-ingress submit: the request carries a ``done_event`` the
        caller can block on, and (with ``stream=True``) a :class:`StreamSink`
        receiving per-decode-block text deltas.  Arrival time defaults to the
        bridge timeline when :meth:`run_bridge` is running, else the server's
        current tick.  ``gen`` overrides the server's default
        :class:`GenerationConfig` for this request (sampled requests bypass
        the response caches — a cached sample is not a fresh draw)."""
        if at is None and self._bridge_t0 is not None:
            at = self.clock.now() - self._bridge_t0
        with self._submit_lock:
            # sink and event attach BEFORE the request becomes visible to the
            # serving loop — a step() racing ahead must find them in place
            req = OnlineRequest(rid=self._next_rid, query_idx=int(query_idx),
                                arrived_at=self.now if at is None else at,
                                done_event=threading.Event(),
                                stream=StreamSink() if stream else None,
                                gen=gen)
            self._next_rid += 1
            self.pending.append(req)
            return req

    def allowed_models(self) -> list[int]:
        return [k for k, br in enumerate(self.breakers) if br.allow_request()]

    def caps(self) -> dict[int, int]:
        """Per-member batch-group concurrency caps for the NEXT window.

        A replicated member's cap is its healthy-replica count right now
        (``ReplicaSet.n_available``), so a replica outage shrinks what the
        scheduler may commit instead of silently queueing on the survivors;
        plain members are absent (uncapped — legacy single-engine semantics).
        """
        caps = {}
        for k, m in enumerate(self.pool):
            if hasattr(m, "n_available"):
                caps[k] = int(m.n_available())
            elif hasattr(m, "n_replicas"):
                caps[k] = int(m.n_replicas)
        return caps

    # -------------------------------------------------------------- serving
    def _default_content(self, req: OnlineRequest) -> str:
        """Deterministic answer text for members that produce none (the
        calibrated simulators): a pure function of (member, query, utility),
        so HTTP responses stay bit-identical across runs and serving paths."""
        if req.model is None:
            return ""
        return (f"[{self.pool[req.model].name}] q{req.query_idx} "
                f"utility={req.utility:.3f}")

    def _complete(self, req: OnlineRequest, *, at: float, utility: float,
                  model: Optional[int], batch: Optional[int], cost: float,
                  cache_hit: bool = False, dropped: bool = False,
                  content: Optional[str] = None) -> None:
        req.completed_at = at
        req.utility = utility
        req.model = model
        req.batch = batch
        req.cost = cost
        req.cache_hit = cache_hit
        req.dropped = dropped
        req.content = "" if dropped else (
            content if content is not None else self._default_content(req))
        if req.stream is not None:
            if dropped:
                req.stream.finish("", error="request shed (budget/reroute limit)")
            else:
                req.stream.finish(req.content, split=True)
        self.completed.append(req)
        if req.done_event is not None:
            req.done_event.set()
        if self.on_complete is not None:
            self.on_complete(req)

    def _sampled(self, req: OnlineRequest) -> bool:
        """Does this request decode stochastically?  Its own gen wins; with
        none attached the server-wide default decides."""
        if req.gen is not None:
            return not req.gen.greedy
        return (self.cfg.generation is not None
                and not self.cfg.generation.greedy)

    def _group_gen(self, members: np.ndarray, by_idx) -> Optional[GenerationConfig]:
        """The GenerationConfig one dispatched batch group decodes under: the
        first per-request override in FCFS order, else the server default.
        Coalesced duplicates and co-batched queries share the group's single
        generation (one batch prompt is one decode stream)."""
        for q in members:
            for req in by_idx[int(q)]:
                if req.gen is not None:
                    return req.gen
        return self.cfg.generation

    def _invoke(self, k: int, members: np.ndarray, streams=None, gen=None):
        kw = {"streams": streams} if streams else {}
        if gen is not None and getattr(self.pool[k], "supports_generation",
                                       False):
            kw["gen"] = gen
        if getattr(self.pool[k], "thread_safe", False):
            # ReplicaSets serialize per replica internally — concurrent groups
            # on one member are exactly what the replicas are for
            return self.pool[k].invoke_batch(self.wl, members, **kw)
        with self._locks[k]:          # engines are not thread-safe; members are
            return self.pool[k].invoke_batch(self.wl, members, **kw)

    def _finish_window(self, rep: WindowReport) -> WindowReport:
        """Seal one round: record per-member replica counts, give the
        autoscaler its control tick (its scale actions land in the caps the
        NEXT round plans against), and append the report."""
        rep.replica_counts = tuple(int(getattr(m, "n_replicas", 1))
                                   for m in self.pool)
        kv = []
        for k, m in enumerate(self.pool):
            fn = getattr(m, "kv_occupancy", None)
            occ = fn() if fn is not None else None
            if occ and occ.get("paged"):
                kv.append((k, int(occ.get("pages_used", 0)),
                           int(occ.get("pages_shared", 0)),
                           int(occ.get("cow_forks", 0))))
        rep.kv_pages = tuple(kv)
        if self.autoscaler is not None:
            fired = self.autoscaler.observe(rep, len(self.pending), rep.t)
            rep.scale_events = tuple((e.member, e.from_n, e.to_n) for e in fired)
            rep.replica_counts = tuple(int(getattr(m, "n_replicas", 1))
                                       for m in self.pool)
        self.windows.append(rep)
        if self.on_window is not None:
            self.on_window(rep)
        return rep

    def step(self, now: Optional[float] = None) -> WindowReport:
        """Run one scheduling round over the queries pending at ``now``."""
        self.now = self.now + self.cfg.window_s if now is None else now
        now = self.now
        rep = WindowReport(t=now, n_pending=len(self.pending))
        take = [self.pending.popleft()
                for _ in range(min(len(self.pending), self.cfg.max_window))]

        # 1. response cache: exact hits complete immediately and bill nothing;
        #    exact misses probe the semantic cache (embedding-space near
        #    duplicates), which completes at cost 0 with the discounted
        #    utility u·(1−ε(sim)) — anything left enters scheduling
        misses: list[OnlineRequest] = []
        sem_utils: list[float] = []
        for req in take:
            if self._sampled(req):
                # a cached answer is one past draw — sampled requests want a
                # fresh one, so they skip both caches (lookup AND insert)
                misses.append(req)
                continue
            hit = self.cache.get(req.query_idx)
            if hit is not None:
                u, k, text = hit
                self._complete(req, at=now, utility=u, model=k, batch=None,
                               cost=0.0, cache_hit=True, content=text)
                rep.n_cache_hits += 1
                continue
            sem = (self.semcache.lookup(req.query_idx, now=now)
                   if self.semcache is not None else None)
            if sem is not None:
                req.sem_hit = True
                req.sem_sim = sem.similarity
                req.sem_loss = sem.utility_loss
                self._complete(req, at=now, utility=sem.utility,
                               model=sem.model, batch=None, cost=0.0,
                               cache_hit=True, content=sem.content)
                rep.n_sem_hits += 1
                rep.sem_utility_loss += sem.utility_loss
                sem_utils.append(sem.utility)
            else:
                misses.append(req)

        # 2. coalesce duplicates: one scheduled instance answers them all
        by_idx: "OrderedDict[int, list[OnlineRequest]]" = OrderedDict()
        for req in misses:
            by_idx.setdefault(req.query_idx, []).append(req)
        rep.n_coalesced = len(misses) - len(by_idx)
        self.n_coalesced += rep.n_coalesced

        allowed = self.allowed_models()
        rep.open_models = tuple(self.pool[k].name for k, br in enumerate(self.breakers)
                                if br.state == CircuitState.OPEN)
        if not by_idx or not allowed:
            # requeue front-of-queue in FCFS order (iterate groups backwards)
            for reqs in reversed(list(by_idx.values())):
                self.pending.extendleft(reversed(reqs))
            rep.n_deferred = len(misses)
            return self._finish_window(rep)

        # 3. policy window space, restricted to surviving models
        idx = np.fromiter(by_idx.keys(), dtype=int)
        full = self.policy.window_space(idx)
        space = restrict_space(full, set(allowed))

        # 4. budget admission: affordable FCFS prefix at initial-state cost
        avail = rep.avail = self.bucket.balance(now)
        base = space.cost[:, space.initial_state]
        affordable = np.cumsum(base) <= max(avail, 0.0) + 1e-12
        n_adm = int(affordable.sum())
        if n_adm == 0 and float(full.cost[0].min()) > self.bucket.capacity + 1e-12:
            # head query can *never* be afforded at this budget rate — judged
            # against the FULL pool, so queries that are only expensive while
            # a breaker is open are deferred (and served after recovery), not
            # shed
            for req in by_idx[int(idx[0])]:
                self._complete(req, at=now, utility=0.0, model=None, batch=None,
                               cost=0.0, dropped=True)
                rep.n_shed += 1
            idx = idx[1:]
        deferred = idx[n_adm:]
        for q in deferred[::-1]:
            self.pending.extendleft(reversed(by_idx[int(q)]))
        rep.n_deferred = int(sum(len(by_idx[int(q)]) for q in deferred))
        idx = idx[:n_adm]
        rep.n_admitted = int(sum(len(by_idx[int(q)]) for q in idx))
        if n_adm == 0:
            return self._finish_window(rep)

        # 5. the policy's windowed decision against the bucket's current
        #    balance (the server restricted the space up front for admission
        #    control, so no further model mask is needed here); replica
        #    capacity caps ride along when the policy understands them
        caps = self.caps()
        cap_kw = {"caps": caps or None} if self._pw_caps else {}
        wplan = self.policy.plan_window(take_rows(space, np.arange(n_adm)), idx,
                                        avail, **cap_kw)
        if wplan.schedule is not None and sem_utils:
            # core-scheduler accounting: semantic hits enter the window's
            # ScheduleResult as (cost=0, utility=u·(1−ε)) assignments, so
            # frontier-level utility totals include what the cache served
            attach_free_assignments(wplan.schedule, sem_utils)
        held_by: dict[int, int] = {}
        packed_by: dict[int, int] = {}
        if wplan.schedule is not None:
            # capacity-packing pressure (greedy_schedule_capped) — an
            # autoscaler signal even when nothing is held outright
            rep.n_cap_packed = int(getattr(wplan.schedule, "n_packed", 0))
            for k, c in getattr(wplan.schedule, "deferred_by_member", {}).items():
                held_by[int(k)] = held_by.get(int(k), 0) + int(c)
            for k, c in getattr(wplan.schedule, "packed_by_member", {}).items():
                packed_by[int(k)] = packed_by.get(int(k), 0) + int(c)

        # half-open breakers get exactly ONE probe group: any further groups
        # scheduled on a recovering member are deferred to the next window
        # (without burning reroute budget) instead of risking a reroute storm
        half_open = {k for k, br in enumerate(self.breakers)
                     if br.state == CircuitState.HALF_OPEN}
        probed: set[int] = set()
        used: dict[int, int] = {}     # groups committed per member this window
        dispatch, held = [], []
        # queries the scheduler itself pushed out under replica-capacity caps
        if wplan.deferred_idx is not None:
            for q in wplan.deferred_idx:
                reqs = by_idx[int(q)]
                held.extend(reqs)
                rep.n_capacity_held += len(reqs)
        for (state, members), gcost in zip(wplan.groups, wplan.group_costs):
            k = int(state.model)
            if k in half_open:
                if k in probed:
                    held.extend(req for q in members for req in by_idx[int(q)])
                    continue
                probed.add(k)
            cap = caps.get(k)
            if cap is not None and used.get(k, 0) >= cap:
                # backstop for policies that pack caps-unaware plans: a member
                # never runs more concurrent groups than it has replicas
                grp = [req for q in members for req in by_idx[int(q)]]
                held.extend(grp)
                rep.n_capacity_held += len(grp)
                held_by[k] = held_by.get(k, 0) + len(members)
                continue
            used[k] = used.get(k, 0) + 1
            dispatch.append((state, members))
            rep.est_cost += float(gcost)   # committed cost: dispatched only
        rep.n_deferred += len(held)
        rep.n_admitted -= len(held)   # held groups were never attempted
        rep.held_by_member = tuple(sorted(held_by.items()))
        rep.packed_by_member = tuple(sorted(packed_by.items()))

        # 6. concurrent dispatch across pool members; members that generate
        #    text get the live per-position subscriber sinks so SSE deltas
        #    flow at decode-block cadence (simulators stream at completion)
        futures = {}
        for state, members in dispatch:
            k = int(state.model)
            streams = None
            if getattr(self.pool[k], "supports_streams", False):
                streams = {pos: sinks for pos, q in enumerate(members)
                           if (sinks := [r.stream for r in by_idx[int(q)]
                                         if r.stream is not None])}
            gen = self._group_gen(members, by_idx)
            fut = self._pool_exec.submit(self._invoke, k, members,
                                         streams or None, gen)
            futures[fut] = (state, members, gen)
        rep.n_groups = len(dispatch)
        rep.group_models = tuple(int(s.model) for s, _ in dispatch)

        requeue: list[OnlineRequest] = []
        for fut, (state, members, gen) in futures.items():
            k = int(state.model)
            try:
                out = fut.result()
            except Exception:         # noqa: BLE001 — member fault
                probe_failed = k in half_open     # expected-risk probe traffic
                self.breakers[k].record_failure()
                for q in members:
                    for req in by_idx[int(q)]:
                        rep.n_failed += 1
                        if not probe_failed:
                            req.n_reroutes += 1
                        if req.n_reroutes > self.cfg.max_reroutes:
                            self._complete(req, at=now, utility=0.0, model=None,
                                           batch=None, cost=0.0, dropped=True)
                        else:
                            requeue.append(req)
                continue
            self.breakers[k].record_success()
            cost = (out.in_tokens * self.pool[k].c_in
                    + out.out_tokens * self.pool[k].c_out) / 1e6
            self.bucket.spend(cost)
            rep.spent += cost
            done_at = now + float(out.latency_s)
            share = cost / max(1, len(members))
            answers = getattr(out, "answers", None)
            cacheable = gen is None or gen.greedy
            for pos, (q, u) in enumerate(zip(members, out.utilities)):
                text = answers[pos] if answers is not None else None
                if cacheable:      # one sample must not become every answer
                    self.cache.put(int(q), (float(u), k, text))
                    if self.semcache is not None:
                        self.semcache.insert(int(q), float(u), k, text,
                                             now=done_at)
                for req in by_idx[int(q)]:
                    self._complete(req, at=done_at, utility=float(u), model=k,
                                   batch=int(state.batch), cost=share,
                                   content=text)
        retry = sorted(requeue + held, key=lambda r: r.rid)
        if retry:                     # FCFS: oldest retried request re-enters first
            self.pending.extendleft(reversed(retry))
        return self._finish_window(rep)

    def run(self, arrivals: Sequence[tuple[float, int]], *,
            max_ticks: int = 100_000) -> ServerStats:
        """Drive a pre-generated arrival stream to completion.

        ``arrivals`` is a time-sorted list of ``(t, query_idx)``.  By default
        the clock is virtual: each tick advances ``window_s``, admits
        everything that has arrived, and runs one scheduling round; it keeps
        ticking until the stream is exhausted and the queue drains.  With
        ``config.realtime`` the same loop is paced against the injected wall
        clock instead (see :meth:`run_paced`) — the identical tick/admission
        structure is what makes one seeded stream replay identically in both
        modes.
        """
        arrivals = list(arrivals)
        if self.cfg.realtime:
            return self.run_paced(arrivals, max_ticks=max_ticks)
        pos = 0
        for _ in range(max_ticks):
            if pos >= len(arrivals) and not self.pending:
                break
            t = self.now + self.cfg.window_s
            while pos < len(arrivals) and arrivals[pos][0] <= t:
                at, q = arrivals[pos]
                self.submit(q, at=at)
                pos += 1
            self.step(t)
        return self.stats()

    def run_paced(self, arrivals: Sequence[tuple[float, int]], *,
                  max_ticks: int = 100_000) -> ServerStats:
        """Real-time drive of a pre-generated stream: sleep to each window
        boundary on the wall clock, admit what has (wall-)arrived, run one
        round.  A slow round never skips a window — the next rounds fire
        back-to-back and the overshoot lands in ``WindowReport.late_s``."""
        clock = self.clock
        t0 = clock.now()
        pos = 0
        for tick in range(1, max_ticks + 1):
            if pos >= len(arrivals) and not self.pending:
                break
            target = tick * self.cfg.window_s
            lag = target - (clock.now() - t0)
            if lag > 0:
                clock.sleep(lag)
            now = clock.now() - t0
            while pos < len(arrivals) and arrivals[pos][0] <= now:
                at, q = arrivals[pos]
                self.submit(q, at=at)
                pos += 1
            rep = self.step(now)
            rep.late_s = max(0.0, now - target)
        return self.stats()

    def run_bridge(self, stop_event: threading.Event, *,
                   max_ticks: int = 10_000_000, drain_ticks: int = 1000) -> None:
        """Live-ingress serving loop: no pre-generated arrival list — requests
        arrive concurrently via :meth:`submit_request` (e.g. from HTTP handler
        threads) while this loop fires one scheduling round per wall-clock
        window boundary, exactly like :meth:`run_paced`.

        On ``stop_event`` the loop stops admitting ticks and *drains*: pending
        requests get up to ``drain_ticks`` further rounds to complete (budget
        refills keep accruing on the bridge timeline), then any stragglers are
        completed as dropped — a waiter on ``done_event`` is never stranded.
        """
        clock = self.clock
        t0 = clock.now()
        self._bridge_t0 = t0
        try:
            for tick in range(1, max_ticks + 1):
                if stop_event.is_set():
                    break
                target = tick * self.cfg.window_s
                lag = target - (clock.now() - t0)
                if lag > 0:
                    # interruptible sleep: a shutdown mid-window wakes the
                    # loop instead of waiting the window out
                    stop_event.wait(lag)
                    if stop_event.is_set():
                        break
                now = clock.now() - t0
                rep = self.step(now)
                rep.late_s = max(0.0, now - target)
            for _ in range(drain_ticks):
                if not self.pending:
                    break
                self.step(clock.now() - t0)
            while self.pending:       # unaffordable stragglers: fail, don't hang
                req = self.pending.popleft()
                self._complete(req, at=clock.now() - t0, utility=0.0,
                               model=None, batch=None, cost=0.0, dropped=True)
        finally:
            self._bridge_t0 = None

    def run_live(self, arrivals: Sequence[tuple[float, int]], *,
                 duration_s: Optional[float] = None,
                 max_ticks: int = 100_000,
                 join_timeout_s: float = 5.0) -> ServerStats:
        """Real-time serving fronted by a live arrival thread.

        A :class:`LiveArrivalSource` replays the (seeded, pre-generated)
        stream against the wall clock, submitting each arrival as its
        timestamp comes due, while this loop fires one scheduling round per
        window boundary; after ``duration_s`` (default: the stream's horizon)
        it keeps ticking until the queue drains.

        The pacer thread is stopped and joined for ``join_timeout_s`` on the
        way out; a pacer that fails to exit by then (a stuck ``submit``, a
        wedged clock sleep) is a *leak* — it can keep submitting into a
        server the caller believes is finished.  The leak is recorded on
        :attr:`pacer_leaked` and warned to stderr rather than silently
        swallowed by the daemon flag."""
        assert self.cfg.realtime, "run_live needs OnlineConfig(realtime=True)"
        if isinstance(self.clock, FakeClock):
            raise ValueError("run_live shares the clock between the pacer "
                             "thread and the serving loop — FakeClock is "
                             "single-threaded; use run() for fake-clock "
                             "determinism tests")
        arrivals = list(arrivals)
        if duration_s is None:
            duration_s = arrivals[-1][0] if arrivals else 0.0
        clock = self.clock
        t0 = clock.now()
        source = LiveArrivalSource(self, arrivals, t0=t0)
        source.start()
        try:
            for tick in range(1, max_ticks + 1):
                target = tick * self.cfg.window_s
                lag = target - (clock.now() - t0)
                if lag > 0:
                    clock.sleep(lag)
                now = clock.now() - t0
                rep = self.step(now)
                rep.late_s = max(0.0, now - target)
                if now >= duration_s and not source.is_alive() and not self.pending:
                    break
        finally:
            source.stop()
            source.join(timeout=join_timeout_s)
            self.pacer_leaked = bool(source.is_alive())
            if self.pacer_leaked:
                print(f"run_live: WARNING pacer thread still alive "
                      f"{join_timeout_s}s after stop — arrival source leaked",
                      file=sys.stderr)
        return self.stats()

    # ------------------------------------------------------------- reporting
    def stats(self) -> ServerStats:
        done = self.completed
        served = [r for r in done if not r.dropped]
        lats = np.array([r.latency for r in served]) if served else np.array([0.0])
        t0 = min((r.arrived_at for r in done), default=0.0)
        dur = max(self.now - t0, 1e-9)
        return ServerStats(
            n_submitted=self._next_rid,
            n_completed=len(done),
            n_cache_hits=self.cache.hits,
            n_coalesced=self.n_coalesced,
            n_dropped=sum(r.dropped for r in done),
            n_reroutes=sum(r.n_reroutes for r in done),
            duration_s=dur,
            qps=len(served) / dur,
            latency_p50=float(np.percentile(lats, 50)),
            latency_p99=float(np.percentile(lats, 99)),
            mean_utility=float(np.mean([r.utility for r in served])) if served else 0.0,
            total_cost=self.bucket.total_spent,
            budget_allowance=self.bucket.rate * dur + self.bucket.capacity,
            n_sem_hits=self.semcache.hits if self.semcache is not None else 0,
            sem_utility_loss=(self.semcache.utility_loss
                              if self.semcache is not None else 0.0),
            windows=self.windows,
        )

    def close(self) -> None:
        self._pool_exec.shutdown(wait=True)


class LiveArrivalSource(threading.Thread):
    """Wall-clock pacer for a pre-generated arrival stream.

    Generation and pacing are deliberately separate concerns: the *stream* is
    a seeded ``[(t, query_idx)]`` list (:func:`poisson_arrivals`), and this
    thread only *replays* it — sleeping on the server's clock until each
    timestamp comes due, then calling ``server.submit(q, at=t)``.  The same
    list fed to a virtual-clock ``run`` therefore produces the identical
    request sequence (determinism-tested in ``tests/test_online_serving.py``).
    """

    def __init__(self, server: "OnlineRobatchServer",
                 arrivals: Iterable[tuple[float, int]],
                 t0: Optional[float] = None, poll_s: float = 0.05):
        super().__init__(daemon=True)
        self.server = server
        self.arrivals = list(arrivals)
        self.clock = server.clock
        self.t0 = self.clock.now() if t0 is None else t0
        self.poll_s = poll_s
        # NB: not ``_stop`` — threading.Thread uses that name internally
        self._stop_requested = threading.Event()
        self.n_submitted = 0

    def stop(self) -> None:
        self._stop_requested.set()

    def run(self) -> None:
        for t, q in self.arrivals:
            while not self._stop_requested.is_set():
                lag = t - (self.clock.now() - self.t0)
                if lag <= 0:
                    break
                self.clock.sleep(min(lag, self.poll_s))
            if self._stop_requested.is_set():
                return
            self.server.submit(int(q), at=float(t))
            self.n_submitted += 1


def arrival_stream(rng: np.random.Generator, qps: float, universe: np.ndarray,
                   repeat_frac: float = 0.0) -> Iterator[tuple[float, int]]:
    """Unbounded seeded Poisson ``(t, query_idx)`` generator over ``universe``
    indices; with probability ``repeat_frac`` an arrival re-asks an earlier
    query (drives cache hits).

    Pure *generation*: no run length, no pacing.  Bound it with
    :func:`poisson_arrivals`, replay it virtually with ``run`` or in wall time
    with :class:`LiveArrivalSource` — the draws depend only on the rng state,
    so one seed yields one stream everywhere.
    """
    t = 0.0
    seen: list[int] = []
    while True:
        t += float(rng.exponential(1.0 / qps))
        if seen and float(rng.random()) < repeat_frac:
            q = int(seen[int(rng.integers(0, len(seen)))])
        else:
            q = int(universe[int(rng.integers(0, len(universe)))])
            seen.append(q)
        yield (t, q)


def poisson_arrivals(rng: np.random.Generator, qps: float, duration_s: float,
                     universe: np.ndarray, repeat_frac: float = 0.0) -> list[tuple[float, int]]:
    """The arrivals of :func:`arrival_stream` falling before ``duration_s``."""
    out: list[tuple[float, int]] = []
    for t, q in arrival_stream(rng, qps, universe, repeat_frac):
        if t >= duration_s:
            return out
        out.append((t, q))
