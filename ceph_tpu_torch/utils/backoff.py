"""Capped exponential backoff with seeded full jitter + AIMD window.

The retry-delay policy for monclient hunting, messenger session
reconnect, mon-command leaderless retries, and objecter resends
(reference: the osdc/Objecter and MonClient backoff knobs; jitter shape
per the classic full-jitter scheme — delay drawn uniformly from
[0, min(cap, base * factor^n)]).  Deterministic when handed a seeded
``random.Random``: chaos scenarios derive one per consumer from the
scenario seed, so retry timing replays with the fault schedule.

``AIMDWindow`` is the client-side congestion window the objecter runs
against OSD admission throttles: multiplicative decrease on an explicit
throttle pushback, additive (1/w per ack) recovery — TCP-Reno-shaped
flow control where the congestion signal is the OSD saying EBUSY
instead of a lost packet.
"""

from __future__ import annotations

import random
from typing import List, Optional


class ExpBackoff:
    def __init__(self, base: float = 0.05, cap: float = 1.0,
                 factor: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self.factor = factor
        self.rng = rng or random.Random()
        self._n = 0

    def next(self) -> float:
        """The next delay: full jitter over the capped exponential
        envelope.  Each call advances the attempt counter."""
        ceiling = min(self.cap, self.base * (self.factor ** self._n))
        self._n += 1
        return self.rng.uniform(0.0, ceiling)

    def reset(self) -> None:
        """Back to attempt 0 (call on success)."""
        self._n = 0

    def schedule(self, n: int) -> List[float]:
        """Preview the next ``n`` delays without consuming real retries
        on a live consumer: runs on a COPY of the rng state."""
        rng = random.Random()
        rng.setstate(self.rng.getstate())
        out = []
        saved = self._n
        for _ in range(n):
            ceiling = min(self.cap, self.base * (self.factor ** saved))
            saved += 1
            out.append(rng.uniform(0.0, ceiling))
        return out


class AIMDWindow:
    """Additive-increase / multiplicative-decrease inflight-op window.

    Starts wide open (``ceiling``): with admission throttles off (the
    default) no pushback ever arrives and the window never constrains
    anything — a provable no-op, like the chaos injectors.  The first
    pushback halves it; each subsequent ack recovers +1/w (one window's
    worth of acks per +1 of window, the Reno congestion-avoidance
    slope)."""

    def __init__(self, ceiling: int):
        self.ceiling = max(1, int(ceiling))
        self.window = float(self.ceiling)
        self.pushbacks = 0

    @property
    def limit(self) -> int:
        return max(1, int(self.window))

    def on_ack(self) -> None:
        self.window = min(float(self.ceiling),
                          self.window + 1.0 / max(self.window, 1.0))

    def on_pushback(self) -> None:
        self.pushbacks += 1
        self.window = max(1.0, self.window / 2.0)
