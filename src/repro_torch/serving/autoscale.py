"""Backlog-driven replica autoscaling: the control loop that *sizes* the pool.

The windowed scheduler (``greedy_schedule_window``) walks the cost-utility
frontier under a FIXED set of per-member capacity caps; this module closes the
remaining loop — from the backlog each :class:`~repro_torch.serving.online.
WindowReport` exposes back to :meth:`repro_torch.serving.pool.ReplicaSet.scale_to`:

    signal    capacity pressure  = n_capacity_held  (queries the caps pushed
                                   out of the window entirely)
                                 + n_cap_packed     (queries the capacity-aware
                                   Δ-heap squeezed into wider batches to fit)
              queue depth        = requests still pending after the round
              late_s             = realtime window-pacing lag
    decision  per-member hysteresis (``hold_windows`` consecutive breaches)
              + per-member ``cooldown_s``, so a one-window spike or a scale
              action's own transient never flaps the pool
    actuation ``ReplicaSet.scale_to(n ± step)`` within
              [``min_replicas``, ``max_replicas``] — grow attaches
              factory-built (or un-parks drained) replicas, shrink retires
              them drain-first through the ``ReplicaTracker``

Scaling acts on *capacity* signals only: budget-deferred work is excluded
from the pressure term, because adding replicas cannot buy budget.  The
server re-reads ``ReplicaSet.n_available()`` every window, so a scale action
reaches the scheduler's ``group_caps`` on the very next round.

The decision is *bottleneck-aware*: ``pressure_by_member`` keeps a
recency-weighted (exponentially decayed) per-member trace of the held/packed
attribution the reports carry, and a pool-wide up-breach grows only the
member that trace names as the bottleneck.  Shrink is evaluated per member —
a member whose own pressure is gone and whose groups run below its replica
count drains independently of its siblings.  Reports without attribution
(plain scalar counters) fall back to the original pool-wide actuation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

__all__ = ["AutoscalePolicy", "ScaleEvent", "Autoscaler"]


@dataclass
class AutoscalePolicy:
    """Knobs of the control loop (see docs/robustness.md for the diagram).

    ``up_pressure``/``down_pressure`` bound the per-window capacity-pressure
    signal (held + packed queries); ``up_queue_depth`` catches backlogs that
    build as plain queue growth; ``late_high_s`` (realtime only, 0 disables)
    treats window-pacing lag as saturation.  ``hold_windows`` and
    ``cooldown_s`` are the hysteresis: a breach must persist, and actions
    must space out, before a member moves.  ``pressure_decay`` halves (by
    default) the per-member pressure trace every window, so a burst that
    ended stops biasing bottleneck selection after a few rounds.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    up_pressure: int = 4              # held+packed queries/window to grow on
    down_pressure: int = 0            # pressure ≤ this is a shrink candidate
    up_queue_depth: int = 32          # post-round queue depth to grow on
    down_queue_depth: int = 4         # queue must also be ≤ this to shrink
    late_high_s: float = 0.0          # realtime lateness to grow on (0 = off)
    hold_windows: int = 2             # consecutive breaches before acting
    cooldown_s: float = 1.0           # min serving-time between actions
    step: int = 1                     # replicas added/removed per action
    pressure_decay: float = 0.5       # per-window decay of the member trace


class ScaleEvent(NamedTuple):
    """One actuation, kept in :attr:`Autoscaler.events` (bench/debug trail)."""

    t: float
    member: str
    from_n: int
    to_n: int
    reason: str


@dataclass
class _Streaks:
    up: int = 0
    down: int = 0


# trace entries below this are dropped after decay (keeps the dict — and the
# summary line — from carrying a tail of vanishing floats forever)
_TRACE_EPS = 1e-3


class Autoscaler:
    """Grows/shrinks scalable pool members against window backlog.

    The up-breach *signal* is pool-wide (pressure, queue depth, lateness are
    properties of the round), but the *actuation* targets the bottleneck:
    the member with the largest decayed ``pressure_by_member`` trace grows,
    its siblings do not.  Shrink decisions are per member.  Each member keeps
    its own breach streaks and cooldown clock; a scale action resets only the
    acting member's streaks and pressure trace.

    Drive it with :meth:`observe` once per scheduling round — the online
    server does so automatically when ``OnlineConfig.autoscale`` is set.
    """

    def __init__(self, pool: Sequence, policy: AutoscalePolicy | None = None):
        self.policy = policy or AutoscalePolicy()
        self._indexed = [(k, m) for k, m in enumerate(pool)
                         if hasattr(m, "scale_to")]
        self.members = [m for _k, m in self._indexed]
        self.events: list[ScaleEvent] = []
        self._streaks: dict[int, _Streaks] = {k: _Streaks()
                                              for k, _m in self._indexed}
        self._last_action_t: dict[int, float] = {}
        # per-member capacity-pressure trace (WindowReport.held_by_member +
        # packed_by_member, exponentially decayed each window): names the
        # bottleneck for grow decisions and is reset by that member's action
        self.pressure_by_member: dict[int, float] = {}
        # floor the pool to min_replicas up front (a pool built at R=1 with
        # min_replicas=2 should not wait for a breach to reach its floor)
        for m in self.members:
            if m.n_replicas < self.policy.min_replicas:
                m.scale_to(self.policy.min_replicas)

    # ------------------------------------------------------------- signals
    def pressure(self, rep) -> int:
        """Capacity pressure of one window: queries held out by the caps plus
        queries the Δ-heap packed into wider batches to fit them."""
        return int(getattr(rep, "n_capacity_held", 0)
                   + getattr(rep, "n_cap_packed", 0))

    def _fold_trace(self, rep) -> dict[int, int]:
        """Decay the per-member trace one window, fold in this report's
        attribution, and return the *undecayed* per-member counts of this
        window alone (the shrink signal)."""
        window_by: dict[int, int] = {}
        for field_name in ("held_by_member", "packed_by_member"):
            for k, c in getattr(rep, field_name, ()):
                window_by[int(k)] = window_by.get(int(k), 0) + int(c)
        decayed: dict[int, float] = {}
        for k, v in self.pressure_by_member.items():
            v *= self.policy.pressure_decay
            if v >= _TRACE_EPS:
                decayed[k] = v
        for k, c in window_by.items():
            decayed[k] = decayed.get(k, 0.0) + c
        self.pressure_by_member = decayed
        return window_by

    # ------------------------------------------------------------- control
    def observe(self, rep, queue_depth: int, now: float) -> list[ScaleEvent]:
        """One control tick: fold a finished window's report into the
        per-member breach streaks and actuate where hysteresis + cooldown
        allow.  Returns the scale events fired this tick (usually empty)."""
        p = self.policy
        if not self.members:
            return []
        window_by = self._fold_trace(rep)
        pressure = self.pressure(rep)
        late = getattr(rep, "late_s", 0.0)
        breach_up = (pressure >= p.up_pressure
                     or queue_depth >= p.up_queue_depth
                     or (p.late_high_s > 0 and late >= p.late_high_s))
        # grow only where the trace says the pressure lives; reports without
        # attribution (plain scalar counters) keep the legacy pool-wide grow
        scalable = [k for k, _m in self._indexed]
        trace = {k: v for k, v in self.pressure_by_member.items()
                 if k in scalable and v > 0}
        if not breach_up:
            up_members: set[int] = set()
        elif trace:
            up_members = {max(sorted(trace), key=trace.get)}
        else:
            up_members = set(scalable)
        attributed = bool(window_by) or pressure == 0
        groups = list(getattr(rep, "group_models", ()))

        fired: list[ScaleEvent] = []
        for k, m in self._indexed:
            # shrink needs genuinely unused capacity, not just absent
            # backlog: a member dispatching at its group cap is saturated
            # even at pressure 0 (the caps themselves kept the backlog
            # away), and shrinking it would only re-create the pressure
            # next window (flapping)
            member_p = window_by.get(k, 0) if attributed else pressure
            up_k = k in up_members
            down_k = (not up_k
                      and not (breach_up and not trace)
                      and member_p <= p.down_pressure
                      and queue_depth <= p.down_queue_depth
                      and groups.count(k) < m.n_replicas)
            st = self._streaks[k]
            st.up = st.up + 1 if up_k else 0
            st.down = st.down + 1 if down_k else 0
            last = self._last_action_t.get(k)
            in_cooldown = last is not None and now - last < p.cooldown_s
            if st.up >= p.hold_windows and not in_cooldown:
                ev = self._actuate_member(
                    m, +p.step, now,
                    f"pressure={pressure} queue={queue_depth} late={late:.3f}s")
            elif st.down >= p.hold_windows and not in_cooldown:
                ev = self._actuate_member(
                    m, -p.step, now,
                    f"idle: pressure={member_p} queue={queue_depth}")
            else:
                continue
            if ev is not None:
                fired.append(ev)
                self._last_action_t[k] = now
                self._streaks[k] = _Streaks()   # a fresh breach must rebuild
                self.pressure_by_member.pop(k, None)  # action resets the trace
        self.events.extend(fired)
        return fired

    def _actuate_member(self, m, delta: int, now: float,
                        reason: str) -> ScaleEvent | None:
        p = self.policy
        cur = int(m.n_replicas)
        # an async-building set (ReplicaSet(async_build=True)) counts its
        # in-flight factory builds toward the target, so a sustained
        # breach never double-builds while a warm engine is on its way
        pending = int(getattr(m, "n_pending_builds", 0))
        target = max(p.min_replicas, min(p.max_replicas, cur + pending + delta))
        if target == cur + pending:
            return None
        reached = int(m.scale_to(target))
        after = int(getattr(m, "n_pending_builds", 0))
        if reached == cur and after == pending:
            return None
        # from/to count in-flight builds: an async grow reads 1→2
        # when the warm engine is still constructing off-thread
        return ScaleEvent(t=now, member=m.name, from_n=cur + pending,
                          to_n=reached + after,
                          reason=reason + (" (async build)"
                                           if after > pending else ""))

    # ------------------------------------------------------------ reporting
    def replica_counts(self) -> tuple:
        return tuple(int(m.n_replicas) for m in self.members)

    def events_by_member(self) -> dict[str, tuple[int, int]]:
        """``{member name: (n up-events, n down-events)}`` over the run."""
        out: dict[str, tuple[int, int]] = {}
        for e in self.events:
            up, down = out.get(e.member, (0, 0))
            if e.to_n > e.from_n:
                up += 1
            else:
                down += 1
            out[e.member] = (up, down)
        return out

    def summary(self) -> str:
        ups = sum(e.to_n > e.from_n for e in self.events)
        downs = len(self.events) - ups
        by_member = ("" if not self.pressure_by_member else
                     ", pressure by member " + str({
                         k: round(v, 2) for k, v in
                         sorted(self.pressure_by_member.items())}))
        acted = ("" if not self.events else
                 ", actions by member " + str({
                     name: f"+{u}/-{d}" for name, (u, d) in
                     sorted(self.events_by_member().items())}))
        return (f"autoscaler: {len(self.events)} actions ({ups} up, {downs} "
                f"down), replicas now {self.replica_counts()}{by_member}{acted}")
