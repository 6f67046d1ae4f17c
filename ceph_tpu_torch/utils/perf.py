"""Process-wide device-kernel counters (reference src/common/perf_counters.cc).

The port keeps only the ``KERNELS`` registry its EC path books into:
named u64 counters with ``inc``/``get``/``reset``/``dump``, the same
names ``ceph_tpu.utils.perf.KERNELS`` carries so a perf dump of either
package reads alike.
"""

from __future__ import annotations

import threading
from typing import Dict


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0

    def dump(self) -> Dict:
        with self._lock:
            return {self.name: dict(self._counters)}


KERNELS = PerfCounters("device_kernels")
