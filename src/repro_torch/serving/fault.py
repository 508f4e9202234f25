"""Fault tolerance for pool invocations: deadlines, retries, straggler
re-dispatch, health tracking, circuit breaking, chaos injection.

At 1000+ node scale, a routing scheduler's batches land on many serving
replicas; slow or dead replicas must not stall the workload.  Two layers:

``FaultTolerantInvoker`` wraps any pool member and implements:

  * deadline-based straggler detection (p50-adaptive or fixed),
  * bounded retries with a backup replica (speculative re-dispatch),
  * consecutive-failure health ejection with cool-down re-admission,
  * an invocation journal so a crashed scheduler can re-enqueue in-flight
    batches on recovery (no query silently dropped).

``CircuitBreaker`` is the online-serving counterpart (closed → open →
half-open): an open breaker removes its model from the scheduler's candidate
space entirely (see :func:`repro_torch.core.scheduler.restrict_space`), instead of
retrying per invocation.  ``FlakyMember`` injects failures deterministically
so tests and benchmarks can drive the trip/reroute/recovery paths.

``ReplicaTracker`` sits one level *below* the breaker: a
:class:`repro_torch.serving.pool.ReplicaSet` is ONE member (one breaker, one entry
in the candidate space) made of N interchangeable replicas, and the tracker
keeps per-replica health — consecutive-failure ejection with cooldown
re-admission and latency stats — so least-loaded dispatch can route around a
dead replica while the set as a whole keeps serving (degraded, not broken).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np


@dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0      # deadline = factor × running p50 latency
    min_deadline_s: float = 2.0
    max_retries: int = 2
    eject_after: int = 3              # consecutive failures before ejection
    cooldown_s: float = 30.0


@dataclass
class _Health:
    consecutive_failures: int = 0
    ejected_until: float = 0.0
    latencies: list = field(default_factory=list)

    def p50(self) -> float:
        return float(np.median(self.latencies)) if self.latencies else 0.0


class FaultTolerantInvoker:
    """Wraps pool members; ``invoke(member_idx, fn)`` runs fn with deadline +
    retry + journal semantics.  ``fn`` must be idempotent (batched LLM calls
    are: re-invoking re-bills but returns equivalent results)."""

    def __init__(self, n_members: int, policy: Optional[StragglerPolicy] = None,
                 backup_of: Optional[Callable[[int], Optional[int]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or StragglerPolicy()
        self.health = [_Health() for _ in range(n_members)]
        self.backup_of = backup_of or (lambda k: None)
        self.clock = clock
        self.journal: list[dict] = []     # in-flight + completed invocations
        self.n_redispatched = 0
        self.n_retries = 0

    def healthy(self, k: int) -> bool:
        return self.clock() >= self.health[k].ejected_until

    def _deadline(self, k: int) -> float:
        p50 = self.health[k].p50()
        return max(self.policy.min_deadline_s, self.policy.deadline_factor * p50)

    def invoke(self, k: int, fn: Callable[[], object], *, latency_of=None,
               tag: str = ""):
        """Run fn() against member k with fault handling.

        ``latency_of(result)``: extracts the (simulated or measured) latency;
        when it exceeds the deadline the invocation counts as a straggler and
        is re-dispatched to the backup member (if any) — the faster result
        wins, which is exactly speculative execution.
        """
        entry = {"member": k, "tag": tag, "state": "inflight", "t": self.clock()}
        self.journal.append(entry)
        attempts = 0
        last_err = None
        while attempts <= self.policy.max_retries:
            attempts += 1
            try:
                result = fn()
                lat = latency_of(result) if latency_of else 0.0
                h = self.health[k]
                h.latencies.append(lat)
                if len(h.latencies) > 256:
                    h.latencies.pop(0)
                if lat > self._deadline(k):
                    backup = self.backup_of(k)
                    if backup is not None and self.healthy(backup):
                        self.n_redispatched += 1
                        entry["state"] = "redispatched"
                        return self.invoke(backup, fn, latency_of=latency_of, tag=tag)
                h.consecutive_failures = 0
                entry["state"] = "done"
                return result
            except Exception as e:              # noqa: BLE001 — replica fault
                last_err = e
                self.n_retries += 1
                h = self.health[k]
                h.consecutive_failures += 1
                if h.consecutive_failures >= self.policy.eject_after:
                    h.ejected_until = self.clock() + self.policy.cooldown_s
                    backup = self.backup_of(k)
                    if backup is not None and self.healthy(backup):
                        entry["state"] = "redispatched"
                        return self.invoke(backup, fn, latency_of=latency_of, tag=tag)
        entry["state"] = "failed"
        raise RuntimeError(f"member {k} failed after {attempts} attempts") from last_err

    def inflight(self) -> list[dict]:
        """Batches to re-enqueue after a scheduler crash (recovery path)."""
        return [e for e in self.journal if e["state"] == "inflight"]


# ---------------------------------------------------------------------------
# per-replica health (ReplicaSet members)
# ---------------------------------------------------------------------------

@dataclass
class ReplicaPolicy:
    eject_after: int = 2              # consecutive failures before ejection
    cooldown_s: float = 30.0          # ejected → probe re-admission delay
    latency_window: int = 128         # per-replica latency samples retained


@dataclass
class _ReplicaState:
    n_ok: int = 0
    n_failures: int = 0
    n_ejections: int = 0
    consecutive_failures: int = 0
    ejected_until: float = 0.0
    retired: bool = False            # drained out by the autoscaler (scale-down)
    latencies: list = field(default_factory=list)

    def p50(self) -> float:
        return float(np.median(self.latencies)) if self.latencies else 0.0


class ReplicaTracker:
    """Per-replica health/latency inside one :class:`~repro_torch.serving.pool.
    ReplicaSet` member.

    The member-level :class:`CircuitBreaker` decides whether the *set* is in
    the candidate space; this tracker decides which replica *within* the set
    may take the next batch.  Ejection mirrors half-open breaker semantics at
    replica granularity: ``eject_after`` consecutive failures remove a replica
    from dispatch for ``cooldown_s``, after which it is offered exactly one
    probe batch — a success re-admits it, another failure re-ejects it for a
    fresh cooldown (``consecutive_failures`` only resets on success).  The
    clock is injectable so virtual-time tests drive recovery deterministically.
    """

    def __init__(self, n_replicas: int, policy: Optional[ReplicaPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or ReplicaPolicy()
        self.clock = clock
        self.replicas = [_ReplicaState() for _ in range(n_replicas)]

    def healthy(self, r: int) -> bool:
        st = self.replicas[r]
        return not st.retired and self.clock() >= st.ejected_until

    # -- autoscaling hooks (ReplicaSet.scale_to drives these) ----------------
    def add_replica(self) -> int:
        """Register a freshly attached replica; returns its index."""
        self.replicas.append(_ReplicaState())
        return len(self.replicas) - 1

    def retire(self, r: int) -> None:
        """Scale-down eject: the replica takes no new dispatch (in-flight work
        drains normally) until :meth:`restore` un-retires it."""
        self.replicas[r].retired = True

    def restore(self, r: int) -> None:
        """Re-admit a retired replica with a clean health slate (a parked
        replica's stale failure streak must not instantly re-eject it)."""
        st = self.replicas[r]
        st.retired = False
        st.consecutive_failures = 0
        st.ejected_until = 0.0

    def n_active(self) -> int:
        """Replicas not retired by scale-down (healthy or not)."""
        return sum(not st.retired for st in self.replicas)

    def record_success(self, r: int, latency_s: float = 0.0) -> None:
        st = self.replicas[r]
        st.n_ok += 1
        st.consecutive_failures = 0
        st.ejected_until = 0.0
        st.latencies.append(float(latency_s))
        if len(st.latencies) > self.policy.latency_window:
            st.latencies.pop(0)

    def record_failure(self, r: int) -> None:
        st = self.replicas[r]
        st.n_failures += 1
        st.consecutive_failures += 1
        if st.consecutive_failures >= self.policy.eject_after:
            st.ejected_until = self.clock() + self.policy.cooldown_s
            st.n_ejections += 1

    def n_healthy(self) -> int:
        return sum(self.healthy(r) for r in range(len(self.replicas)))

    def snapshot(self) -> list[dict]:
        """Per-replica health/latency rows (benchmark + debug surface)."""
        return [dict(replica=r, healthy=self.healthy(r), retired=st.retired,
                     n_ok=st.n_ok, n_failures=st.n_failures,
                     n_ejections=st.n_ejections, p50_latency_s=st.p50())
                for r, st in enumerate(self.replicas)]


# ---------------------------------------------------------------------------
# circuit breaking (online serving)
# ---------------------------------------------------------------------------

class CircuitState(str, Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclass
class BreakerPolicy:
    failure_threshold: int = 3        # consecutive failures before tripping
    recovery_time_s: float = 30.0     # open → half-open probe delay


class CircuitBreaker:
    """Per-model breaker: closed → (failures ≥ threshold) → open →
    (recovery time elapsed) → half-open → one probe decides.

    Unlike the invoker's per-call retry, the breaker acts at the *scheduling*
    level: while open, the model is absent from the candidate space and every
    query that would have landed on it is rescheduled onto survivors.  While
    half-open, the online server sends exactly one probe group per window
    (probe failures don't burn the queries' reroute budget).  The clock is
    injectable so the online server's virtual time drives recovery.
    """

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or BreakerPolicy()
        self.clock = clock
        self.state = CircuitState.CLOSED
        self.failure_count = 0
        self.last_failure_at: Optional[float] = None
        self.n_trips = 0

    def allow_request(self) -> bool:
        if self.state == CircuitState.CLOSED:
            return True
        if self.state == CircuitState.OPEN:
            if (self.last_failure_at is not None
                    and self.clock() - self.last_failure_at >= self.policy.recovery_time_s):
                self.state = CircuitState.HALF_OPEN
                return True
            return False
        return True                    # HALF_OPEN: allow the probe

    def record_success(self) -> None:
        self.failure_count = 0
        self.state = CircuitState.CLOSED
        self.last_failure_at = None

    def record_failure(self) -> None:
        self.failure_count += 1
        self.last_failure_at = self.clock()
        if self.state == CircuitState.HALF_OPEN or \
                self.failure_count >= self.policy.failure_threshold:
            if self.state != CircuitState.OPEN:
                self.n_trips += 1
            self.state = CircuitState.OPEN


class FlakyMember:
    """Chaos wrapper around a pool member: raises on invocations in
    ``[fail_from, fail_until)`` (counted per wrapper), proxies otherwise.

    Deterministic by construction, so tests and benchmarks can script a
    mid-run outage (breaker trips, queries reroute) and — by bounding the
    span — a recovery (half-open probe succeeds, breaker closes).
    """

    def __init__(self, inner, fail_from: int = 0, fail_until: int = 10**9):
        self.inner = inner
        self.fail_from = fail_from
        self.fail_until = fail_until
        self.n_calls = 0
        self.n_faults = 0

    @property
    def name(self):
        return self.inner.name

    @property
    def c_in(self):
        return self.inner.c_in

    @property
    def c_out(self):
        return self.inner.c_out

    @property
    def context_len(self):
        return self.inner.context_len

    def invoke_batch(self, wl, batch_idx):
        call = self.n_calls
        self.n_calls += 1
        if self.fail_from <= call < self.fail_until:
            self.n_faults += 1
            raise RuntimeError(f"{self.name}: injected fault (call {call})")
        return self.inner.invoke_batch(wl, batch_idx)

    def evaluate(self, wl, idx, batch_size, rng=None):
        return self.inner.evaluate(wl, idx, batch_size, rng)


class ChaosMember:
    """Seeded fault injector around a pool member (docs/robustness.md).

    Where :class:`FlakyMember` scripts one hard outage window, ChaosMember
    composes the realistic degradation modes a robustness benchmark needs —
    all deterministic given ``seed`` and the wrapper's call sequence:

      * **latency noise** — each surviving call's reported ``latency_s``
        gains an Exp(``latency_noise_s``) draw (virtual: no wall sleep, so
        simulated-pool benchmarks stay fast);
      * **slow degrade** — call ``i`` additionally gains ``degrade_s * i``,
        modelling a replica that rots (memory pressure, thermal throttle);
      * **error bursts** — calls in ``[fail_from, fail_until)`` raise with
        probability ``error_rate`` (1.0 = hard outage, the FlakyMember case);
      * **hangs** — calls in ``[hang_from, hang_until)`` block the
        dispatching thread for ``hang_s`` *wall* seconds and then raise.
        This is the scenario :class:`repro_torch.serving.pool.ReplicaSet`'s
        ``dispatch_timeout_s`` exists for: without a timeout a hung replica
        wedges the serving thread for the full hang.

    Counters (``n_calls``, ``n_faults``, ``n_hangs``) are exact given the
    windows, so benchmarks can gate on them bit-for-bit.  The wrapper is a
    full pool-member proxy (pricing, feature probes, ``evaluate``), so it
    nests anywhere a member does — including as a replica inside a
    ReplicaSet.
    """

    def __init__(self, inner, *, seed: int = 0,
                 latency_noise_s: float = 0.0, degrade_s: float = 0.0,
                 fail_from: int = 10**9, fail_until: int = 10**9,
                 error_rate: float = 1.0,
                 hang_from: int = 10**9, hang_until: int = 10**9,
                 hang_s: float = 5.0):
        self.inner = inner
        self.rng = np.random.default_rng(seed)
        self.latency_noise_s = float(latency_noise_s)
        self.degrade_s = float(degrade_s)
        self.fail_from, self.fail_until = int(fail_from), int(fail_until)
        self.error_rate = float(error_rate)
        self.hang_from, self.hang_until = int(hang_from), int(hang_until)
        self.hang_s = float(hang_s)
        self.n_calls = 0
        self.n_faults = 0
        self.n_hangs = 0

    @property
    def name(self):
        return self.inner.name

    @property
    def c_in(self):
        return self.inner.c_in

    @property
    def c_out(self):
        return self.inner.c_out

    @property
    def context_len(self):
        return self.inner.context_len

    @property
    def supports_streams(self):
        return bool(getattr(self.inner, "supports_streams", False))

    @property
    def supports_generation(self):
        return bool(getattr(self.inner, "supports_generation", False))

    def invoke_batch(self, wl, batch_idx, **kw):
        call = self.n_calls
        self.n_calls += 1
        if self.hang_from <= call < self.hang_until:
            self.n_hangs += 1
            time.sleep(self.hang_s)               # wall-clock: wedge the caller
            raise RuntimeError(f"{self.name}: injected hang (call {call})")
        if self.fail_from <= call < self.fail_until and \
                self.rng.random() < self.error_rate:
            self.n_faults += 1
            raise RuntimeError(f"{self.name}: injected fault (call {call})")
        out = self.inner.invoke_batch(wl, batch_idx, **kw)
        extra = self.degrade_s * call
        if self.latency_noise_s > 0.0:
            extra += float(self.rng.exponential(self.latency_noise_s))
        if extra > 0.0:
            from dataclasses import replace
            out = replace(out, latency_s=out.latency_s + extra)
        return out

    def evaluate(self, wl, idx, batch_size, rng=None):
        return self.inner.evaluate(wl, idx, batch_size, rng)
