"""Process-wide device-kernel counters (reference src/common/perf_counters.cc).

The port keeps only the ``KERNELS`` registry its device paths book into:
named u64 counters with ``inc``/``get``, time counters with ``tinc``
(``t_<tag>`` from ``ops/profiling.device_loop_slope``), ``reset`` and
``dump``, under the names ``ceph_tpu.utils.perf.KERNELS`` carries so a
perf dump of either package reads alike.
"""

from __future__ import annotations

import threading
from typing import Dict


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        # name -> [avgcount, sum, last, min, max] seconds
        self._avgs: Dict[str, list] = {}

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def tinc(self, name: str, seconds: float) -> None:
        """Time/average counter (avgcount + sum + last/min/max, like
        PERFCOUNTER_TIME|PERFCOUNTER_LONGRUNAVG)."""
        with self._lock:
            entry = self._avgs.setdefault(name, [0, 0.0, 0.0, None, None])
            entry[0] += 1
            entry[1] += seconds
            entry[2] = seconds
            entry[3] = seconds if entry[3] is None \
                else min(entry[3], seconds)
            entry[4] = seconds if entry[4] is None \
                else max(entry[4], seconds)

    def reset(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            for entry in self._avgs.values():
                entry[:] = [0, 0.0, 0.0, None, None]

    def dump(self) -> Dict:
        with self._lock:
            out: Dict = dict(self._counters)
            for k, (count, total, last, mn, mx) in self._avgs.items():
                out[k] = {"avgcount": count, "sum": total, "last": last,
                          "min": mn, "max": mx}
            return {self.name: out}


KERNELS = PerfCounters("device_kernels")
