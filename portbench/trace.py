"""Reading a torch.profiler trace into what the per-layer metrics need.

The traced run profiles a few of its window's units inside one
``portbench.window`` annotation.  ``Trace`` holds, in microseconds on the
trace's clock:

- ``span``: the annotation's start and end on the host;
- ``device``: every kernel, copy and memset the card ran in the span, as
  ``(category, name, start, duration)``;
- ``host``: the host thread's torch operations and CUDA runtime calls,
  for naming idle gaps.

Parsed from the profiler's Chrome-trace export, whose format has held
across PyTorch versions.  A trace with no device events reads as None in
every device metric: a share is never made up from host time.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
UNIT = "portbench.unit"
HOST = "host, in no torch op"


@dataclass
class Trace:
    span: Tuple[float, float]
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    # what the driver counted over the profiled units (bytes, ops, units)
    work: Dict[str, float] = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.span[1] - self.span[0]

    def of(self, cat: str) -> List[Tuple[str, float, float]]:
        return [(n, s, d) for c, n, s, d in self.device if c == cat]

    def busy_us(self) -> float:
        """Length of the union of the device's intervals in the span."""
        return sum(b - a for a, b in self._merged())

    def _merged(self) -> List[Tuple[float, float]]:
        lo, hi = self.span
        iv = sorted((max(s, lo), min(s + d, hi)) for _c, _n, s, d
                    in self.device if s + d > lo and s < hi)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def gaps(self) -> List[Tuple[float, float]]:
        """The span's intervals in which the device ran nothing."""
        lo, hi = self.span
        out, t = [], lo
        for a, b in self._merged():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [[name, s], ...]."""
        tot: Dict[str, float] = {}
        for _c, n, _s, d in self.device:
            tot[n] = tot.get(n, 0.0) + d
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, d * 1e-6] for n, d in best]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time by the innermost host operation running across each
        gap's middle: [[name, s], ...], the largest first."""
        gaps = self.gaps()
        ops = sorted(self.host, key=lambda o: (o[1], -o[2]))
        tot: Dict[str, float] = {}
        stack: List[Tuple[str, float]] = []
        i = 0
        for a, b in sorted(gaps):
            mid = (a + b) / 2
            while i < len(ops) and ops[i][1] <= mid:
                name, s, d = ops[i]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((name, s + d))
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][0] if stack else HOST
            if name == UNIT:
                name = HOST
            tot[name] = tot.get(name, 0.0) + (b - a)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, d * 1e-6] for n, d in best]


def from_events(events: List[dict]) -> Optional[Trace]:
    """A Trace from Chrome-trace events, or None without the window's
    annotation."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = win[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tr = Trace(span=(lo, hi))
    tid = w.get("tid")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if s + d < lo or s > hi:
            continue
        if cat in DEVICE_CATS:
            tr.device.append((cat, e.get("name", "?"), s, d))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime") \
                and e.get("tid") == tid and e is not w:
            tr.host.append((e.get("name", "?"), s, d))
    return tr


def from_profiler(prof) -> Optional[Trace]:
    """Export the profiler's trace to a temporary file, read it, delete
    it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return from_events(events)
