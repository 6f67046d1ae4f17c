"""OpTracker: in-flight + historic op tracing.

Counterpart of ``ceph_tpu/cluster/optracker.py``.

Behavioral mirror of the reference's TrackedOp machinery
(src/common/TrackedOp.cc, src/osd/OpRequest.cc): every tracked op records
timestamped events from arrival to completion; the tracker keeps the
in-flight set plus ring buffers of the most recent and the slowest
completed ops, served by the admin commands dump_ops_in_flight /
dump_historic_ops / dump_historic_slow_ops.

Cross-layer tracing (round 6): an op minted client-side carries a trace
header (id + pre-arrival events stamped by the objecter and each
messenger hop); TrackedOp absorbs it so one ``dump_historic_ops`` entry
shows the op's whole life — objecter submit, messenger send, OSD
dispatch, encode/journal/commit — across daemons.  ``CURRENT_OP`` lets
deep layers (backends, stores) mark the op being served without
threading the handle through every call.

Slow-op semantics (reference osd_op_complaint_time, default 30s): the
slowest-completed ring only admits ops at/above ``slow_threshold``
(0 disables it entirely — the old behavior of 0 admitting EVERY op made
the ring a second history buffer), and ``slow_in_flight()`` reports
currently-blocked ops past the threshold for the health-warning path
("N slow ops, oldest age X").
"""

from __future__ import annotations

import contextvars
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# the op currently being served on this task's context (reference: the
# OpRequest threaded through do_op/do_osd_ops; a contextvar keeps the
# deep layers' signatures unchanged)
CURRENT_OP: contextvars.ContextVar[Optional["TrackedOp"]] = \
    contextvars.ContextVar("ceph_tpu_torch_current_op", default=None)


def mark_current(event: str) -> None:
    """Record an event on the op being served, if any (no-op outside a
    tracked dispatch — recovery, scrub, internal ops)."""
    op = CURRENT_OP.get()
    if op is not None:
        op.mark(event)


def _lock_trace(name: str, phase: str) -> None:
    """DepLock trace hook: lock wait/acquire pairs land on the current
    op's timeline (pg.lock / messenger.session wait become first-class
    attribution stages) with one ContextVar read per acquisition."""
    op = CURRENT_OP.get()
    if op is not None:
        op.mark(f"lock_{phase}:{name}")


# install at import: every daemon that tracks ops pulls this module in,
# and the hook itself is a no-op outside a tracked dispatch
from ceph_tpu_torch.utils import lockdep as _lockdep  # noqa: E402

_lockdep.TRACE_HOOK = _lock_trace


class TrackedOp:
    def __init__(self, tracker: "OpTracker", desc: str,
                 trace: Optional[Dict] = None):
        self._tracker = tracker
        self._clock = tracker.clock
        self.seq = next(tracker._seq)
        self.desc = desc
        self.start = self._clock.monotonic()
        self.wall_start = self._clock.time()
        self.events: List[tuple] = []
        self.duration: Optional[float] = None
        self.trace_id: Optional[str] = None
        if trace:
            self.trace_id = trace.get("id")
            # inherited events carry wall-clock stamps from upstream
            # layers (objecter, messenger hops); rebase them onto this
            # op's clock — loopback daemons share the wall clock, so
            # negative offsets faithfully mean "before OSD arrival".
            # Clamp at 0.0: the wall and monotonic clocks are sampled at
            # different instants, so an inherited stamp can land
            # epsilon-PAST our start and would sort after "initiated" —
            # drifting the timeline (a pre-arrival hop rendered as if it
            # happened mid-dispatch).  Everything upstream happened
            # before this op existed, by causality.
            for name, ts in trace.get("events", ()):
                self.events.append((min(ts - self.wall_start, 0.0), name))
        self.events.append((0.0, "initiated"))

    def mark(self, event: str) -> None:
        self.events.append((self._clock.monotonic() - self.start, event))

    def mark_at(self, event: str, mono_ts: float) -> None:
        """Record an event at an explicit ``clock.monotonic()`` stamp —
        for shared timestamps computed elsewhere (the encode coalescer's
        tick window lands on every op of the batch)."""
        self.events.append((mono_ts - self.start, event))

    def finish(self) -> None:
        if self.duration is None:
            self.mark("done")
            self.duration = self._clock.monotonic() - self.start
            self._tracker._finished(self)

    def age(self) -> float:
        return self._clock.monotonic() - self.start

    def dump(self) -> Dict:
        # sorted() is stable: same-stamp events keep insertion (causal)
        # order, so the inherited client-side hops can never interleave
        # into the OSD-side marks (the round-9 event-ordering fix)
        ordered = sorted(self.events, key=lambda ev: ev[0])
        out = {
            "seq": self.seq,
            "description": self.desc,
            "age": self._clock.monotonic() - self.start,
            "duration": self.duration,
            "type_data": {"events": [
                {"time": round(t, 6), "event": e} for t, e in ordered]},
        }
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.duration is not None:
            # stage-labeled spans derived from the same timeline, so
            # dump_historic_ops and graft-trace agree on one op story
            from ceph_tpu_torch.trace.attribution import spans_from_events

            out["spans"] = spans_from_events(ordered)
        return out


class OpTracker:
    def __init__(self, history_size: int = 20, slow_size: int = 20,
                 slow_threshold: float = 30.0, clock=None):
        """``slow_threshold`` mirrors osd_op_complaint_time (reference
        default 30s); 0 disables slow-op tracking.  ``clock`` is the
        owning daemon's (chaos-skewable) time source — op ages follow
        the daemon's view of time, so a clock-skew scenario makes slow-op
        warnings fire early/late exactly as NTP drift would."""
        from ceph_tpu_torch.chaos.clock import ChaosClock

        self.clock = clock or ChaosClock()
        self._seq = itertools.count(1)
        self._in_flight: Dict[int, TrackedOp] = {}
        self._history: Deque[TrackedOp] = deque(maxlen=history_size)
        self._slowest: List[TrackedOp] = []
        self._slow_size = slow_size
        self.slow_threshold = slow_threshold

    def create(self, desc: str, trace: Optional[Dict] = None) -> TrackedOp:
        op = TrackedOp(self, desc, trace=trace)
        self._in_flight[op.seq] = op
        return op

    def _finished(self, op: TrackedOp) -> None:
        self._in_flight.pop(op.seq, None)
        self._history.append(op)
        if self.slow_threshold > 0 and op.duration is not None and \
                op.duration >= self.slow_threshold:
            self._slowest.append(op)
            self._slowest.sort(key=lambda o: -(o.duration or 0))
            del self._slowest[self._slow_size:]

    def resize(self, history_size: Optional[int] = None,
               slow_size: Optional[int] = None) -> None:
        """Apply runtime knob changes (injectargs on
        osd_op_history_size / osd_op_history_slow_op_size) to the live
        rings, keeping the newest entries."""
        if history_size is not None and \
                history_size != self._history.maxlen:
            self._history = deque(self._history, maxlen=history_size)
        if slow_size is not None:
            self._slow_size = slow_size
            del self._slowest[slow_size:]

    def slow_in_flight(self) -> Tuple[int, float]:
        """(count, oldest_age) of in-flight ops blocked past the
        complaint threshold — the 'N slow ops, oldest age X' health feed
        (reference OpTracker::check_ops_in_flight)."""
        if self.slow_threshold <= 0:
            return 0, 0.0
        ages = [op.age() for op in self._in_flight.values()]
        slow = [a for a in ages if a >= self.slow_threshold]
        return len(slow), max(slow) if slow else 0.0

    def history(self) -> List[TrackedOp]:
        """Completed ops, oldest first (the attribution aggregator's
        input — ceph_tpu_torch.trace.attribution.aggregate_tracker)."""
        return list(self._history)

    # -- admin-command surfaces (reference dump_historic_ops et al.) --------

    def dump_ops_in_flight(self) -> Dict:
        ops = sorted(self._in_flight.values(), key=lambda o: o.seq)
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}

    def dump_historic_ops(self) -> Dict:
        return {"num_ops": len(self._history),
                "ops": [o.dump() for o in self._history]}

    def dump_historic_slow_ops(self) -> Dict:
        return {"num_ops": len(self._slowest),
                "ops": [o.dump() for o in self._slowest]}
