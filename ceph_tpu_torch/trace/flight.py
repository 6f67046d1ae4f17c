"""graft-blackbox: the always-on per-daemon flight recorder.

A bounded ring of structured events every daemon feeds as it runs —
op-lifecycle samples, queue-depth/admission/cwnd samples, map-epoch
applies and peering kicks, health transitions, chaos injections and
crash points, scrub/repair detections, LOOP_LAG spikes.  The ring is
the cluster's black box: it costs a deque append while everything is
healthy and becomes the postmortem's raw material the moment a gate
breaks (``trace/postmortem.py`` snapshots every daemon's ring
into one bundle).

Clock contract: events are stamped on the daemon's OWN (possibly
chaos-skewed) clock, and ``dump()`` records the skew alongside the
events — so a postmortem consumer subtracts it and the rings of a
skewed cluster still merge onto one cluster-wide timeline, exactly the
way the reference correlates daemon logs via their recorded clock
offsets.

No-op contract (the chaos-injector/graft-trace shape): with
``blackbox_enabled=0`` (the default) ``FlightRecorder.from_config``
returns the shared ``NULL_FLIGHT`` singleton — falsy, ``__slots__`` of
nothing, every method a constant — and feed sites guard with one
``if self.flight:`` test, so the disabled hot path allocates nothing
and retains nothing (pinned by tests/test_blackbox.py the way the
NULL_SPAN pin test guards the tracer).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional


class _NullFlight:
    """Shared disabled recorder: one falsy test at every feed site,
    zero allocation, zero retention (the NULL_SPAN analog)."""

    __slots__ = ()

    enabled = False
    daemon = ""
    dropped = 0

    def __bool__(self) -> bool:
        return False

    def record(self, kind: str, **data) -> None:
        pass

    def op_sample(self, desc: str, duration: float,
                  slow: bool = False) -> None:
        pass

    def events(self) -> List:
        return []

    def dump(self) -> Dict:
        return {"enabled": False, "daemon": "", "skew": 0.0,
                "dropped": 0, "capacity": 0, "events": []}


NULL_FLIGHT = _NullFlight()


class FlightRecorder:
    """Bounded per-daemon event ring (the enabled path).

    ``clock`` is the daemon's ChaosClock (or None for clients without
    one — plain wall time, zero skew).  ``capacity`` bounds memory
    hard: the deque drops the oldest event per overflow append and
    ``dropped`` counts what the ring forgot, so a postmortem reader
    knows when the breach outran the box.
    """

    __slots__ = ("daemon", "clock", "ring", "dropped", "sample_every",
                 "_seq", "_op_n")

    enabled = True

    def __init__(self, daemon: str, capacity: int = 512,
                 sample_every: int = 8, clock=None):
        self.daemon = daemon
        self.clock = clock
        self.ring: deque = deque(maxlen=max(1, int(capacity)))
        self.dropped = 0
        self.sample_every = max(1, int(sample_every))
        self._seq = 0
        self._op_n = 0

    def __bool__(self) -> bool:
        return True

    @classmethod
    def from_config(cls, daemon: str, config, clock=None):
        """The per-daemon factory every constructor calls: the shared
        NULL_FLIGHT when ``blackbox_enabled=0`` (provable no-op), a
        real ring sized by ``blackbox_ring`` otherwise."""
        if not getattr(config, "blackbox_enabled", 0):
            return NULL_FLIGHT
        return cls(daemon,
                   capacity=getattr(config, "blackbox_ring", 512),
                   sample_every=getattr(config, "blackbox_sample", 8),
                   clock=clock)

    # -- feeds ---------------------------------------------------------------

    def _now(self) -> float:
        return self.clock.time() if self.clock is not None \
            else time.time()

    def record(self, kind: str, **data) -> None:
        """Append one structured event, stamped on the daemon's own
        (possibly skewed) clock.  Overflow drops the oldest event and
        counts it — memory stays bounded under any flood."""
        self._seq += 1
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append((self._seq, self._now(), kind, data))

    def op_sample(self, desc: str, duration: float,
                  slow: bool = False) -> None:
        """Op-lifecycle feed: every ``sample_every``-th completed op
        (slow ops always — they are exactly what a postmortem wants)."""
        self._op_n += 1
        if slow or self._op_n % self.sample_every == 0:
            self.record("op", desc=desc, dur=round(duration, 6),
                        slow=bool(slow))

    # -- dump surfaces -------------------------------------------------------

    def events(self) -> List:
        return list(self.ring)

    def dump(self) -> Dict:
        """The ``blackbox dump`` admin payload: the ring plus the
        recorded clock offset (``skew``) a consumer subtracts to align
        this daemon's stamps with the rest of the cluster."""
        skew = float(getattr(self.clock, "skew", 0.0)) \
            if self.clock is not None else 0.0
        return {
            "enabled": True,
            "daemon": self.daemon,
            "skew": skew,
            "dropped": self.dropped,
            "capacity": self.ring.maxlen,
            "events": [
                {"seq": seq, "t": round(t, 6), "kind": kind,
                 "data": data}
                for seq, t, kind, data in self.ring],
        }


def merged_timeline(daemon_dumps: Dict[str, Dict],
                    limit: Optional[int] = None) -> List[Dict]:
    """Merge per-daemon ``dump()`` payloads onto one skew-corrected
    cluster timeline (newest-last).  The postmortem report's spine."""
    out: List[Dict] = []
    for name in sorted(daemon_dumps):
        d = daemon_dumps[name] or {}
        skew = float(d.get("skew", 0.0))
        for ev in d.get("events", ()):
            out.append({"t": round(ev["t"] - skew, 6),
                        "daemon": d.get("daemon") or name,
                        "kind": ev["kind"],
                        "data": ev.get("data", {})})
    out.sort(key=lambda e: e["t"])
    return out[-limit:] if limit else out
