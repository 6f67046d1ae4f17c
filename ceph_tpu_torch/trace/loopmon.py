"""Asyncio event-loop profiler: sampled loop lag + task queue/wall time.

Every daemon here is one asyncio event loop; chaos runs proved
head-of-line blocking in the messenger read loop is a real bug class,
and graftlint's asyncio sanitizer only catches the STATIC shape of it.
This is the runtime half: a sampler task measures how late the loop
wakes a timer (loop lag — the time some callback held the loop), and
``wrap()`` instruments spawned per-op tasks with spawn counts, queued
time (create -> first run) and wall time, all as ordinary perf counters
so they ride the existing mgr report / Prometheus / daemonperf paths.

Disabled (``loop_profile_interval=0``, the default) the profiler
declares nothing, samples nothing, and ``wrap()`` returns the coroutine
untouched — the zero-overhead-at-default contract shared with
graft-trace and the chaos injectors.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

from ceph_tpu_torch.utils import perf as perfmod


class LoopProfiler:
    def __init__(self, perf, interval: float, prefix: str = "loop"):
        self.perf = perf
        self.interval = interval
        self.prefix = prefix
        self.enabled = interval > 0
        self.last_lag = 0.0
        # max lag since the last beacon window reset: the "sustained
        # lag" signal the LOOP_LAG health warning keys off
        self.window_max = 0.0
        if self.enabled:
            perf.add_time(f"{prefix}_lag", prio=perfmod.PRIO_INTERESTING,
                          desc="sampled event-loop wakeup lag")
            perf.add_histogram(
                f"{prefix}_lag_hist", scale=1e6,
                unit=perfmod.UNIT_SECONDS,
                desc="event-loop lag, log2 microsecond buckets")
            perf.add_u64(f"{prefix}_task_spawns",
                         desc="profiled tasks spawned")
            perf.add_time(f"{prefix}_task_queued",
                          desc="task create -> first-run delay")
            perf.add_time(f"{prefix}_task_wall",
                          desc="profiled task wall time")

    async def sample(self) -> None:
        """The sampler coroutine; the owning daemon creates (and tracks)
        the task.  Each round sleeps ``interval`` and records how far
        past the deadline the loop actually woke us."""
        loop = asyncio.get_event_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            lag = max(0.0, loop.time() - t0 - self.interval)
            self.last_lag = lag
            if lag > self.window_max:
                self.window_max = lag
            self.perf.tinc(f"{self.prefix}_lag", lag)
            self.perf.hinc(f"{self.prefix}_lag_hist", lag)

    def lag_report(self) -> Optional[Tuple[float, float]]:
        """(last_sample, window_max) for the beacon, or None when the
        profiler is off (the beacon field stays absent)."""
        if not self.enabled:
            return None
        return (self.last_lag, self.window_max)

    def reset_window(self) -> None:
        """Called after each beacon: the next window measures afresh, so
        a drained stall clears the health warning."""
        self.window_max = 0.0

    def wrap(self, coro):
        """Instrument a to-be-spawned coroutine: spawn count, queued
        delay (create -> first run), wall time.  Identity when off."""
        if not self.enabled:
            return coro
        loop = asyncio.get_event_loop()
        created = loop.time()
        self.perf.inc(f"{self.prefix}_task_spawns")

        async def _run():
            t0 = loop.time()
            self.perf.tinc(f"{self.prefix}_task_queued", t0 - created)
            try:
                return await coro
            finally:
                self.perf.tinc(f"{self.prefix}_task_wall",
                               loop.time() - t0)

        return _run()
