"""Real served pool: adapts ServingEngines to the scheduler's PoolMember
protocol, so Robatch routes across *actually running* models.

The port's members wrap the port's engines (:class:`ServingEngine` or
:class:`SpeculativeEngine`, on the card or the CPU); the rest of the module
is a copy of the JAX package's.

The pool-member protocol (docs/architecture.md) is what lets the calibrated
simulator (:mod:`repro_torch.data.simulator`) and this real pool interchange:

    name: str; c_in, c_out: float ($/1M tokens); context_len: int
    invoke_batch(workload, batch_idx) -> BatchResult
    evaluate(workload, idx, batch_size) -> per-query utilities

A ``TextTask`` supplies the query/answer text for a Workload (the numeric
Workload drives the scheduler; the TextTask drives real token-level serving).
Utilities come from judging the parsed batched generations — accuracy
degradation with batch size emerges from the models themselves, not a
simulator.

Members are safe to invoke from the online dispatcher's worker threads: each
member serializes access to its engine (the KV-cache slots are mutable state),
while different members run genuinely concurrently.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.data.simulator import BatchResult, evaluate_chunked
from repro_torch.data.workload import Workload
from repro_torch.serving.batcher import BatchPromptFormatter
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.fault import ReplicaPolicy, ReplicaTracker
from repro_torch.serving.generation import GenerationConfig


class DispatchTimeout(RuntimeError):
    """A replica dispatch exceeded ``ReplicaSet.dispatch_timeout_s`` — the
    dispatching thread abandoned the (possibly hung) engine call and failed
    over to a sibling replica."""


@dataclass
class TextTask:
    """Parallel text view of a workload: query/answer strings by index."""

    queries: Sequence[str]
    answers: Sequence[str]
    judge: Callable[[str, str], float] = None   # (prediction, gold) -> utility

    def __post_init__(self):
        if self.judge is None:
            self.judge = lambda pred, gold: float(pred.strip() == gold.strip())


class ServedPoolMember:
    """One pool member backed by a live ServingEngine."""

    supports_streams = True
    # ^ invoke_batch accepts ``streams`` (per-position live subscriber sinks);
    #   the online dispatcher feature-detects this attribute before forwarding
    supports_generation = True
    # ^ invoke_batch accepts ``gen`` (a GenerationConfig); same feature probe

    def __init__(self, name: str, engine: ServingEngine, formatter: BatchPromptFormatter,
                 task: TextTask, c_in: float, c_out: float, context_len: int,
                 max_answer_tokens: int = 8,
                 generation: Optional[GenerationConfig] = None):
        self.name = name
        self.engine = engine
        self.formatter = formatter
        self.task = task
        self.c_in = c_in
        self.c_out = c_out
        self.context_len = context_len
        self.max_answer_tokens = max_answer_tokens
        self.generation = generation    # member-default gen (None → greedy)
        self._lock = threading.Lock()
        self._rid = itertools.count()   # monotonic per-member invocation id

    def _stream_demux(self, b: int, streams: dict):
        """Per-decode-block demultiplexer for the batch-prompt wire format.

        The engine's ``Request.on_tokens`` hook fires once per fused
        ``decode_block`` dispatch with the freshly appended token ids; this
        closure accumulates them, splits the byte stream on the answer
        separator, and pushes each subscribed position's *text delta* to its
        sinks — so SSE chunks flow mid-generation at decode-block cadence.

        Splitting happens on raw bytes (the separator is one byte), so
        position boundaries are exact even when a multi-byte UTF-8 character
        straddles two decode blocks.  While a part is still open, only its
        longest cleanly decodable prefix is emitted and trailing whitespace is
        held back; when the part closes (a later separator, EOS, or the
        generation ending) the final text is the same ``strip()``-ed answer
        :meth:`BatchPromptFormatter.parse` produces — so the concatenated
        deltas always equal the request's non-streamed answer.
        """
        sep = self.formatter.sep.encode()
        eos = self.engine.eos_id
        acc: list[int] = []
        emitted = ["" for _ in range(b)]
        closed = [False] * b

        def clean_prefix(raw: bytes) -> str:
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError as e:
                return raw[: e.start].decode("utf-8", errors="ignore")

        def push(pos: int, text: str) -> None:
            delta = text[len(emitted[pos]):] if text.startswith(emitted[pos]) \
                else text          # defensive: never retract, re-push whole
            if delta:
                emitted[pos] += delta
                for sink in streams[pos]:
                    sink.push(delta)

        def on_tokens(new_ids: list[int], done: bool) -> None:
            acc.extend(new_ids)
            ids, ended = acc, done
            if eos in ids:
                ids, ended = ids[: ids.index(eos)], True
            raw = bytes(i for i in ids if i < 256)
            parts = raw.split(sep)
            for pos in streams:
                if pos >= b or pos >= len(parts) or closed[pos]:
                    continue
                if pos < len(parts) - 1 or ended:
                    closed[pos] = True
                    push(pos, parts[pos].decode("utf-8", errors="replace").strip())
                else:
                    push(pos, clean_prefix(parts[pos]).strip())

        return on_tokens

    def invoke_batch(self, wl: Workload, batch_idx: np.ndarray,
                     streams: Optional[dict] = None,
                     gen: Optional[GenerationConfig] = None) -> BatchResult:
        b = len(batch_idx)
        queries = [self.task.queries[int(i)] for i in batch_idx]
        prompt = self.formatter.format(queries)
        t0 = time.perf_counter()
        effective = gen if gen is not None else self.generation
        if effective is not None:
            # the batch needs room for every co-batched answer: the caller's
            # max_new acts as a per-query cap on the member's answer sizing,
            # scaled to the batch (sampling params/seed pass through as-is)
            per_q = min(self.max_answer_tokens, effective.max_new)
            effective = effective.with_(max_new=per_q * b + b)
        # each physical invocation gets a fresh rid so engine-level logs and
        # traces can tell invocations apart (next() is atomic under the GIL)
        req = Request(rid=next(self._rid), tokens=prompt,
                      max_new=self.max_answer_tokens * b + b, gen=effective)
        if streams:
            req.on_tokens = self._stream_demux(b, streams)
        with self._lock:              # one engine, one in-flight batch
            self.engine.serve([req])
        latency = time.perf_counter() - t0
        tok = self.formatter.tokenizer
        out_ids = req.out_tokens
        if self.engine.eos_id in out_ids:
            out_ids = out_ids[: out_ids.index(self.engine.eos_id)]
        text = tok.decode(out_ids)
        answers = self.formatter.parse(text, b)
        util = np.array([self.task.judge(a, self.task.answers[int(i)])
                         for a, i in zip(answers, batch_idx)])
        return BatchResult(utilities=util, in_tokens=len(prompt),
                           out_tokens=len(req.out_tokens), latency_s=latency,
                           answers=answers)

    def evaluate(self, wl: Workload, idx: np.ndarray, batch_size: int,
                 rng=None) -> np.ndarray:
        return evaluate_chunked(self, wl, idx, batch_size)

    def kv_occupancy(self) -> dict:
        """KV memory telemetry of the backing engine (see
        :meth:`repro_torch.serving.engine.ServingEngine.kv_occupancy`)."""
        return self.engine.kv_occupancy()


class ReplicaSet:
    """N interchangeable replicas behind ONE pool-member facade.

    The scheduler and the online server see a single member — one name, one
    price, one circuit breaker, one column family in the candidate space — of
    capacity ``n_replicas`` concurrent batch-groups (the per-window cap the
    scheduler enforces, see ``group_caps`` in
    :func:`repro_torch.core.scheduler.greedy_schedule_window`).  Each invocation is
    dispatched to the least-loaded *healthy* replica (in-flight count, index
    as tie-break); a replica fault is retried on the next-healthiest sibling
    while :class:`repro_torch.serving.fault.ReplicaTracker` records the failure, so
    a single-replica outage degrades the set's capacity instead of tripping
    the member's breaker.  Only when every replica has failed does
    ``invoke_batch`` raise — that is the signal the member-level breaker
    consumes.

    Replicas must be interchangeable pool members (same pricing/behaviour):
    distinct engines over shared trained weights for the real pool
    (:func:`repro_torch.serving.tinypool.build_tiny_pool`), dataclass copies for the
    simulator.  ``thread_safe`` tells the online dispatcher to skip its
    per-member serialization lock — replicas serialize themselves, so groups
    bound for different replicas genuinely run concurrently.

    **Autoscaling.**  ``factory`` is a zero-arg callable producing one more
    interchangeable replica; with one attached, :meth:`scale_to` grows the
    set on demand (un-parking previously drained replicas before building new
    ones) and shrinks it by drain-then-eject: the victim replica is retired in
    the :class:`~repro_torch.serving.fault.ReplicaTracker` (no new dispatch; its
    in-flight batch finishes normally) rather than torn down mid-batch, so a
    scale-down never fails a query.  Retired replicas stay attached and are
    the first capacity a later scale-up restores.

    **Async warm attach.**  With ``async_build=True`` a grow that needs the
    factory runs it on a background thread instead of inside the caller: a
    tiny-pool factory constructs (and jit-warms) a whole
    :class:`~repro_torch.serving.engine.ServingEngine`, and the autoscaler fires
    ``scale_to`` from the serving loop — building inline would stretch the
    very window that detected the backlog.  ``scale_to`` returns the current
    active count immediately, the build lands in a ready buffer, and the
    finished replica *joins at the next window boundary*: ``n_available()``
    (what the server's per-window ``caps()`` reads) and ``n_replicas``
    attach any completed builds before reporting.  ``n_pending_builds``
    counts launched-but-unattached builds so repeated breaches never
    double-build.  A shrink does not cancel in-flight builds — they attach
    and are then eligible victims for the next scale-down.
    """

    thread_safe = True

    def __init__(self, replicas: Sequence, *, name: Optional[str] = None,
                 policy: Optional[ReplicaPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 factory: Optional[Callable[[], object]] = None,
                 async_build: bool = False,
                 dispatch_timeout_s: Optional[float] = None,
                 max_dispatch_retries: int = 0,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 1.0):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self.replicas = list(replicas)
        self.name = name if name is not None else self.replicas[0].name
        self.tracker = ReplicaTracker(len(self.replicas), policy, clock)
        self.factory = factory
        self.async_build = bool(async_build)
        # dispatch hardening (docs/robustness.md): a per-dispatch wall-clock
        # deadline (None = legacy direct call, no watcher thread) and a
        # bounded same-replica retry ladder for ordinary faults.  Timeouts
        # never retry the same replica — a hung engine stays hung — they
        # record a failure and fail over to a sibling immediately.
        self.dispatch_timeout_s = dispatch_timeout_s
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.n_timeouts = 0
        self.n_dispatch_retries = 0
        self._inflight = [0] * len(self.replicas)
        self._lock = threading.Lock()
        self._ready: list = []          # built off-thread, awaiting attach
        self._pending_builds = 0        # launched factory builds not yet attached

    @property
    def n_replicas(self) -> int:
        """Active (non-retired) replica count — the member's nominal size.
        Attaches any finished async builds first (the window-boundary join)."""
        self._join_ready()
        return self.tracker.n_active()

    @property
    def n_pending_builds(self) -> int:
        """Async factory builds launched but not yet attached."""
        with self._lock:
            return self._pending_builds + len(self._ready)

    def _spawn_build(self) -> None:
        def work():
            try:
                replica = self.factory()
            except BaseException:
                # a failed build must release its pending slot, or the
                # phantom count suppresses every future scale-up
                with self._lock:
                    self._pending_builds -= 1
                raise               # surface the fault on the thread's stderr
            with self._lock:
                self._pending_builds -= 1
                self._ready.append(replica)

        threading.Thread(target=work, daemon=True,
                         name=f"{self.name}-replica-build").start()

    def _join_ready(self) -> None:
        """Attach replicas whose background build finished (never blocks)."""
        with self._lock:
            ready, self._ready = self._ready, []
            for replica in ready:
                self.replicas.append(replica)
                self._inflight.append(0)
                self.tracker.add_replica()

    def scale_to(self, n: int) -> int:
        """Grow or shrink the active replica count toward ``n``; returns the
        count actually reached (growth stops at the attached replicas when no
        ``factory`` is set; the floor is always 1).

        Grow: retired replicas are restored first (clean health slate), then
        ``factory()`` attaches brand-new ones — inline, or launched on a
        background thread with ``async_build`` (the call then returns the
        still-current count and the new replica joins at the next
        ``n_available()``/``n_replicas`` read).  Shrink: victims — preferring
        already-unhealthy, then idle, then highest-index replicas — are
        *retired* in the tracker, which removes them from dispatch while any
        in-flight batch drains to completion.
        """
        n = max(1, int(n))
        self._join_ready()
        while True:
            with self._lock:
                states = self.tracker.replicas
                active = self.tracker.n_active()
                if active < n:
                    parked = [r for r, st in enumerate(states) if st.retired]
                    if parked:
                        self.tracker.restore(parked[0])
                        continue
                    if self.factory is None:
                        return active
                    if self.async_build:
                        deficit = (n - active - self._pending_builds
                                   - len(self._ready))
                        for _ in range(max(0, deficit)):
                            self._pending_builds += 1
                            self._spawn_build()
                        return active
                elif active > n:
                    alive = [r for r, st in enumerate(states) if not st.retired]
                    victim = max(alive,
                                 key=lambda r: (not self.tracker.healthy(r),
                                                -self._inflight[r], r))
                    self.tracker.retire(victim)
                    continue
                else:
                    return active
            # build OUTSIDE the dispatch lock: a tiny-pool factory constructs
            # a whole ServingEngine, and in-flight batches must not stall on
            # (or be unable to release their slot during) the construction
            replica = self.factory()
            with self._lock:
                self.replicas.append(replica)
                self._inflight.append(0)
                self.tracker.add_replica()

    def n_available(self) -> int:
        """Healthy-replica count — the member's CURRENT group capacity (the
        online server re-reads this every window, so an ejected replica
        shrinks the caps the scheduler plans against, and a finished async
        build joins here — at the window boundary).  Never 0: a fully
        ejected set still gets one probe group, and the member-level breaker
        owns the remove-from-space decision."""
        self._join_ready()
        return max(1, self.tracker.n_healthy())

    @property
    def c_in(self) -> float:
        return self.replicas[0].c_in

    @property
    def c_out(self) -> float:
        return self.replicas[0].c_out

    @property
    def context_len(self) -> int:
        return self.replicas[0].context_len

    def loads(self) -> list[int]:
        with self._lock:
            return list(self._inflight)

    def _acquire(self, exclude: set[int]) -> Optional[int]:
        """Least-loaded healthy replica (falls back to ejected ones only when
        every non-excluded replica is ejected — a last-ditch probe beats
        failing a batch that might still be servable).  Retired replicas
        (scale-down drain) never take new work."""
        with self._lock:
            ranked = [r for r in range(len(self.replicas))
                      if r not in exclude and not self.tracker.replicas[r].retired]
            if not ranked:
                return None
            healthy = [r for r in ranked if self.tracker.healthy(r)]
            r = min(healthy or ranked, key=lambda i: (self._inflight[i], i))
            self._inflight[r] += 1
            return r

    @property
    def supports_streams(self) -> bool:
        """Live token streaming is offered iff the replicas offer it (the set
        merely routes the ``streams`` subscription to whichever replica wins
        dispatch)."""
        return bool(getattr(self.replicas[0], "supports_streams", False))

    @property
    def supports_generation(self) -> bool:
        """GenerationConfig forwarding, same feature-probe contract as
        :attr:`supports_streams`."""
        return bool(getattr(self.replicas[0], "supports_generation", False))

    def _dispatch(self, r: int, wl: Workload, batch_idx: np.ndarray,
                  kw: dict) -> BatchResult:
        """One physical dispatch to replica ``r``, under the per-dispatch
        deadline when one is configured.  The timed path runs the invocation
        on a fresh daemon thread and abandons it on expiry — leaking the hung
        thread is the point: the *serving* thread unwedges and fails over
        while the stuck engine call is left to die with the process."""
        if self.dispatch_timeout_s is None:
            return self.replicas[r].invoke_batch(wl, batch_idx, **kw)
        box: dict = {}
        done = threading.Event()

        def work():
            try:
                box["out"] = self.replicas[r].invoke_batch(wl, batch_idx, **kw)
            except BaseException as e:    # noqa: BLE001 — carried to the caller
                box["err"] = e
            finally:
                done.set()

        threading.Thread(target=work, daemon=True,
                         name=f"{self.name}-dispatch-r{r}").start()
        if not done.wait(self.dispatch_timeout_s):
            with self._lock:
                self.n_timeouts += 1
            raise DispatchTimeout(
                f"{self.name}: replica {r} dispatch exceeded "
                f"{self.dispatch_timeout_s}s deadline")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def invoke_batch(self, wl: Workload, batch_idx: np.ndarray,
                     streams: Optional[dict] = None,
                     gen: Optional[GenerationConfig] = None) -> BatchResult:
        tried: set[int] = set()
        last: Optional[Exception] = None
        while True:
            r = self._acquire(tried)
            if r is None:
                raise RuntimeError(
                    f"{self.name}: all {self.n_replicas} replicas failed") from last
            kw = {"streams": streams} if streams and getattr(
                self.replicas[r], "supports_streams", False) else {}
            if gen is not None and getattr(self.replicas[r],
                                           "supports_generation", False):
                kw["gen"] = gen
            try:
                for attempt in range(self.max_dispatch_retries + 1):
                    t0 = time.perf_counter()
                    try:
                        out = self._dispatch(r, wl, batch_idx, kw)
                    except DispatchTimeout as e:
                        # a hung replica stays hung: no same-replica retry,
                        # record the failure and fail over to a sibling
                        last = e
                        self.tracker.record_failure(r)
                        tried.add(r)
                        break
                    except Exception as e:    # noqa: BLE001 — replica fault
                        last = e
                        self.tracker.record_failure(r)
                        if attempt < self.max_dispatch_retries:
                            with self._lock:
                                self.n_dispatch_retries += 1
                            time.sleep(min(self.backoff_cap_s,
                                           self.backoff_base_s * 2 ** attempt))
                            continue
                        tried.add(r)
                        break
                    else:
                        self.tracker.record_success(r, time.perf_counter() - t0)
                        return out
            finally:
                with self._lock:
                    self._inflight[r] -= 1

    def evaluate(self, wl: Workload, idx: np.ndarray, batch_size: int,
                 rng=None) -> np.ndarray:
        return evaluate_chunked(self, wl, idx, batch_size)

    def kv_occupancy(self) -> dict:
        """Aggregate KV telemetry over replicas that expose it: sums bytes
        and page counters so the set reads as one member (simulated replicas
        report nothing and contribute zeros)."""
        total: dict = {}
        for rep in self.replicas:
            fn = getattr(rep, "kv_occupancy", None)
            if fn is None:
                continue
            for k, v in fn().items():
                if isinstance(v, bool):
                    total[k] = total.get(k, False) or v
                elif isinstance(v, (int, float)):
                    total[k] = total.get(k, 0) + v
        return total


def replicate_simulated(member, n: int, **kwargs) -> ReplicaSet:
    """ReplicaSet of ``n`` dataclass copies of a simulated member (copies are
    deterministic-identical, so replication changes capacity, not outcomes).
    The copy constructor doubles as the set's autoscaling ``factory``, so the
    :class:`~repro_torch.serving.autoscale.Autoscaler` can grow it past ``n``."""
    from dataclasses import replace

    kwargs.setdefault("factory", lambda: replace(member))
    return ReplicaSet([replace(member) for _ in range(n)],
                      name=member.name, **kwargs)
