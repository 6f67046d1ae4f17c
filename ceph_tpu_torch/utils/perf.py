"""Perf counters (reference src/common/perf_counters.cc).

Counterpart of ``ceph_tpu/utils/perf.py``, with the same names and dump
formats, so a perf dump of either package reads alike.

Per-daemon registry of named counters: u64 counters, time sums, and
long-running averages (avgcount/sum pairs), dumped as JSON-able dicts — the
"perf dump" admin-socket surface.

Telemetry extensions mirroring the reference more closely:

- typed schemas (``add_u64``/``add_time``/``add_histogram``): unit
  (none/bytes), priority, and description per counter, served by
  ``perf schema`` exactly like PerfCountersBuilder's type/unit/prio
  metadata (src/common/perf_counters.h PERFCOUNTER_* flags);
- time counters carry last/min/max alongside avgcount/sum (the
  reference's PERFCOUNTER_TIME + LONGRUNAVG pairing);
- ``PerfHistogram``: power-of-2 bucketed histograms for latencies and
  I/O sizes (reference src/common/perf_histogram.h with
  SCALE_LOG2 axis config), served by ``perf histogram dump``;
- ``PerfCountersCollection`` is thread-safe and supports ``remove()``
  so daemons deregister their counters on shutdown (reference
  PerfCountersCollectionImpl holds m_lock for add/remove/dump).

``KERNELS`` is the process-wide device-kernel instrumentation registry:
the dense-compute layers (ops/crc32c, ec/codec, ec/stripe, crush/mapper,
balance/scorer) record invocation counts, bytes processed, and padding
waste there, ``ops/profiling.device_loop_slope`` books its ``t_<tag>``
times with ``tinc``, and every daemon folds it into its own ``perf
dump``.  Its counters are incremented from several host threads (the
sharded placement runs one per device), hence the lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

# counter units (reference unit_t, perf_counters.h)
UNIT_NONE = "none"
UNIT_BYTES = "bytes"
UNIT_SECONDS = "seconds"

# counter priorities (reference PRIO_* in perf_counters.h)
PRIO_CRITICAL = 10
PRIO_INTERESTING = 8
PRIO_USEFUL = 5
PRIO_DEBUGONLY = 0


class PerfHistogram:
    """Power-of-2 bucketed histogram (reference perf_histogram.h,
    SCALE_LOG2): bucket i counts values in [2^i, 2^(i+1)) after scaling.

    ``scale`` maps the recorded value into bucket units first — e.g.
    scale=1e6 buckets a seconds-valued latency by microseconds, the
    reference's op-latency axis config.
    """

    def __init__(self, buckets: int = 32, scale: float = 1.0,
                 unit: str = UNIT_NONE, desc: str = ""):
        self.n_buckets = buckets
        self.scale = scale
        self.unit = unit
        self.desc = desc
        self.buckets: List[int] = [0] * buckets
        self.count = 0
        self.sum = 0.0

    def add(self, value: float) -> None:
        v = int(value * self.scale)
        if v < 1:
            idx = 0
        else:
            idx = min(self.n_buckets - 1, v.bit_length() - 1)
        self.buckets[idx] += 1
        self.count += 1
        self.sum += value

    def reset(self) -> None:
        self.buckets = [0] * self.n_buckets
        self.count = 0
        self.sum = 0.0

    def lower_bounds(self) -> List[int]:
        """Bucket i's inclusive lower bound in SCALED units."""
        return [0] + [1 << i for i in range(1, self.n_buckets)]

    def dump(self) -> Dict:
        return {
            "buckets": list(self.buckets),
            "lower_bounds": self.lower_bounds(),
            "scale": self.scale,
            "count": self.count,
            "sum": self.sum,
        }


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        # name -> [count, sum, last, min, max]
        self._avgs: Dict[str, list] = {}
        self._hists: Dict[str, PerfHistogram] = {}
        # name -> {"type", "unit", "priority", "description"}
        self._schema: Dict[str, Dict] = {}

    # -- schema declarations (PerfCountersBuilder analog) -------------------

    def _declare(self, name: str, ctype: str, unit: str, prio: int,
                 desc: str) -> None:
        self._schema[name] = {"type": ctype, "unit": unit,
                              "priority": prio, "description": desc}

    def add_u64(self, name: str, unit: str = UNIT_NONE,
                prio: int = PRIO_USEFUL, desc: str = "") -> None:
        with self._lock:
            self._declare(name, "u64", unit, prio, desc)
            self._counters.setdefault(name, 0)

    def add_time(self, name: str, prio: int = PRIO_USEFUL,
                 desc: str = "") -> None:
        with self._lock:
            self._declare(name, "time_avg", UNIT_SECONDS, prio, desc)
            self._avgs.setdefault(name, [0, 0.0, 0.0, None, None])

    def add_histogram(self, name: str, buckets: int = 32,
                      scale: float = 1.0, unit: str = UNIT_NONE,
                      prio: int = PRIO_USEFUL,
                      desc: str = "") -> PerfHistogram:
        with self._lock:
            self._declare(name, "histogram", unit, prio, desc)
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = PerfHistogram(
                    buckets=buckets, scale=scale, unit=unit, desc=desc)
            return h

    # -- updates -------------------------------------------------------------

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name] = value

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

    def hinc(self, name: str, value: float) -> None:
        """Histogram insert; auto-declares a default log2 histogram for
        an undeclared name (unschema'd counters stay usable, like inc)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = PerfHistogram()
                self._declare(name, "histogram", UNIT_NONE,
                              PRIO_USEFUL, "")
            h.add(value)

    def time(self, name: str):
        """Context manager timing a block into a tinc counter."""
        perf = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                perf.tinc(name, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def reset(self) -> None:
        """Zero every value, keeping schemas (reference 'perf reset')."""
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            for entry in self._avgs.values():
                entry[:] = [0, 0.0, 0.0, None, None]
            for h in self._hists.values():
                h.reset()

    # -- dump surfaces -------------------------------------------------------

    def dump(self) -> Dict:
        with self._lock:
            out: Dict = dict(self._counters)
            for k, (count, total, last, mn, mx) in self._avgs.items():
                out[k] = {"avgcount": count, "sum": total, "last": last,
                          "min": mn, "max": mx}
            for k, h in self._hists.items():
                out[k] = h.dump()
            return {self.name: out}

    def dump_histograms(self) -> Dict:
        """Histogram-only view (reference 'perf histogram dump')."""
        with self._lock:
            return {self.name: {k: h.dump()
                                for k, h in self._hists.items()}}

    def dump_critical(self, min_prio: int = PRIO_INTERESTING) -> Dict:
        """High-priority counters only (reference prio_adjust on the
        mgr report path): the postmortem bundle's perf slice — small
        enough to snapshot per daemon at trigger time without dragging
        the full dump (histograms excluded; they're bulk, not triage)."""
        with self._lock:
            out: Dict = {}
            for k, v in self._counters.items():
                meta = self._schema.get(k)
                if meta is None or meta["priority"] >= min_prio:
                    out[k] = v
            for k, (count, total, last, mn, mx) in self._avgs.items():
                meta = self._schema.get(k)
                if meta is None or meta["priority"] >= min_prio:
                    out[k] = {"avgcount": count, "sum": total,
                              "last": last, "min": mn, "max": mx}
            return {self.name: out}

    def dump_schema(self) -> Dict:
        """Counter metadata (reference 'perf schema')."""
        with self._lock:
            schema = dict(self._schema)
            # untyped counters surface with inferred defaults so the
            # schema always covers the dump
            for k in self._counters:
                schema.setdefault(k, {"type": "u64", "unit": UNIT_NONE,
                                      "priority": PRIO_USEFUL,
                                      "description": ""})
            for k in self._avgs:
                schema.setdefault(k, {"type": "time_avg",
                                      "unit": UNIT_SECONDS,
                                      "priority": PRIO_USEFUL,
                                      "description": ""})
            return {self.name: schema}


class PerfCountersCollection:
    """Registry of all PerfCounters in a daemon (perf dump aggregates).

    Thread-safe: create/register/remove/dump serialize on one lock
    (reference PerfCountersCollectionImpl m_lock) — daemons mutate the
    registry from the event loop while device-compute executors read it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._all: Dict[str, PerfCounters] = {}
        self._shared: set = set()

    def create(self, name: str) -> PerfCounters:
        pc = PerfCounters(name)
        with self._lock:
            self._all[name] = pc
        return pc

    def register(self, pc: PerfCounters,
                 shared: bool = True) -> PerfCounters:
        """Adopt an existing PerfCounters (e.g. the process-wide KERNELS
        registry) into this daemon's dump.  ``shared`` counters are
        excluded from this collection's reset(): one daemon's
        'perf reset' must not wipe telemetry every other daemon in the
        process reads from the same registry."""
        with self._lock:
            self._all[pc.name] = pc
            if shared:
                self._shared.add(pc.name)
            else:
                self._shared.discard(pc.name)
        return pc

    def get(self, name: str) -> Optional[PerfCounters]:
        with self._lock:
            return self._all.get(name)

    def remove(self, name: str) -> None:
        """Deregister on daemon shutdown (reference remove() path)."""
        with self._lock:
            self._all.pop(name, None)
            self._shared.discard(name)

    def _snapshot(self, skip_shared: bool = False):
        with self._lock:
            return [pc for name, pc in self._all.items()
                    if not (skip_shared and name in self._shared)]

    def dump(self) -> Dict:
        out: Dict = {}
        for pc in self._snapshot():
            out.update(pc.dump())
        return out

    def dump_histograms(self) -> Dict:
        out: Dict = {}
        for pc in self._snapshot():
            out.update(pc.dump_histograms())
        return out

    def dump_schema(self) -> Dict:
        out: Dict = {}
        for pc in self._snapshot():
            out.update(pc.dump_schema())
        return out

    def dump_critical(self, min_prio: int = PRIO_INTERESTING) -> Dict:
        out: Dict = {}
        for pc in self._snapshot():
            out.update(pc.dump_critical(min_prio=min_prio))
        return out

    def reset(self) -> None:
        for pc in self._snapshot(skip_shared=True):
            pc.reset()


# Process-wide device-kernel instrumentation (one per process like the
# reference's per-process g_ceph_context counters): the dense-compute
# layers are libraries shared by every daemon in the process, so their
# counters live here and each daemon folds them into its perf dump.
KERNELS = PerfCounters("device_kernels")
