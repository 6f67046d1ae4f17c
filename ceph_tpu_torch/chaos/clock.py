"""Per-daemon skewable time source (the clock-skew injector).

Counterpart of ``ceph_tpu/chaos/clock.py``.

Each daemon reads time through its own ``ChaosClock`` instead of the
``time`` module directly; a scenario (or ``injectargs
chaos_clock_skew``) shifts one daemon's view of time without touching
the others.  Heartbeat grace windows, Paxos lease staleness, beacon
timeouts, and op-tracker ages are all computed from this source, so a
skewed daemon really does fire early elections or false failure
reports — the bug class the reference only meets in production when NTP
drifts.

Skew 0.0 (the default) is a plain passthrough: one attribute read and a
float add over ``time.monotonic()`` — the disabled-injector no-op
contract.
"""

from __future__ import annotations

import time


class ChaosClock:
    __slots__ = ("skew",)

    def __init__(self, skew: float = 0.0):
        self.skew = skew

    @classmethod
    def from_config(cls, config) -> "ChaosClock":
        """A clock bound to a daemon's config copy: ``injectargs
        chaos_clock_skew`` retargets it live (and is counted)."""
        clock = cls(config.chaos_clock_skew)

        def _observe(name, value):
            if name == "chaos_clock_skew":
                clock.set_skew(value)

        config.add_observer(_observe)
        return clock

    def set_skew(self, skew: float) -> None:
        if skew != self.skew:
            from ceph_tpu_torch.chaos.counters import CHAOS

            CHAOS.inc("clock_skews")
        self.skew = skew

    def monotonic(self) -> float:
        return time.monotonic() + self.skew

    def time(self) -> float:
        return time.time() + self.skew
