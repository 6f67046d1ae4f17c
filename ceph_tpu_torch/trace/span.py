"""graft-trace: causal span tracing across daemons.

The reference threads blkin/Zipkin-style tracepoints through
Messenger -> OSD -> ObjectStore so one client op can be followed as a
single timed tree across daemons (PAPER.md L6).  This is that seam for
the asyncio port: a per-daemon :class:`Tracer` mints spans carrying a
``trace_id`` (the op-lifecycle id the objecter already stamps into
message trace headers) plus a ``span_id``/``parent_id`` chain, and the
message header's ``"span"`` field propagates causality across the wire —
the receiving daemon parents its span under the sender's.

Contract (BENCH_NOTES "zero overhead when disabled"): at default config
(``trace_enabled=0``) ``Tracer.start`` returns the shared
:data:`NULL_SPAN` singleton — no allocation, no retention, no
contextvar churn beyond one ``enabled`` test — and ``Tracer.context()``
returns ``None`` so no message ever grows a span field.  The tracer is
therefore provably a no-op on the bench hot path, the same contract the
chaos injectors honor.

Spans are collected PER DAEMON (each tracer keeps its own completed
spans ring, keyed by trace_id) exactly like a real distributed tracer's
per-process reporter; ``assemble_tree`` merges the per-daemon dumps
into the one cross-daemon tree, and ``ceph_tpu_torch.trace.perfetto`` renders
it for chrome://tracing / Perfetto.
"""

from __future__ import annotations

import contextvars
import itertools
import time
from collections import OrderedDict
from typing import Dict, List, Optional

# the span currently open on this task's context: children parent under
# it and Tracer.context() exports it into message headers.  ContextVars
# keep interleaved ops (and daemons sharing one loop) from cross-linking.
CURRENT_SPAN: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("ceph_tpu_current_span", default=None)


class Span:
    """One timed node of a trace tree.  Usable as a context manager:
    entering installs it as CURRENT_SPAN (so nested spans and outgoing
    messages parent under it), exiting finishes it."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "daemon", "start", "end", "meta", "_token")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.daemon = tracer.daemon
        self.start = time.time()
        self.end: Optional[float] = None
        self.meta: Dict = {}
        self._token = None

    def annotate(self, **kv) -> None:
        self.meta.update(kv)

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time()
            self._tracer._finished(self)

    def dump(self) -> Dict:
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "daemon": self.daemon,
            "start": self.start,
            "dur": (self.end - self.start) if self.end is not None
            else None,
        }
        if self.meta:
            out["meta"] = dict(self.meta)
        return out

    def __enter__(self) -> "Span":
        self._token = CURRENT_SPAN.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            CURRENT_SPAN.reset(self._token)
            self._token = None
        self.finish()
        return False


class _NullSpan:
    """The disabled-tracing span: every operation is a no-op.  One
    shared instance — the disabled path allocates nothing per op."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def annotate(self, **kv) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Per-daemon span factory + completed-span collector."""

    def __init__(self, daemon: str, enabled: bool = False,
                 keep: int = 256):
        self.daemon = daemon
        self.enabled = bool(enabled)
        self.keep = keep
        self._seq = itertools.count(1)
        self._tid = itertools.count(1)
        # trace_id -> [span dicts] of COMPLETED spans, oldest trace first
        self._traces: "OrderedDict[str, List[Dict]]" = OrderedDict()

    def mint_trace_id(self) -> str:
        return f"{self.daemon}:t{next(self._tid)}"

    def start(self, name: str, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None):
        """Open a span.  With no explicit parent, nests under the task's
        CURRENT_SPAN (same-daemon causality); with no trace_id, joins
        the parent's trace or mints a fresh one (a root)."""
        if not self.enabled:
            return NULL_SPAN
        if parent_id is None:
            cur = CURRENT_SPAN.get()
            if cur is not None and cur.span_id is not None:
                parent_id = cur.span_id
                if trace_id is None:
                    trace_id = cur.trace_id
        if trace_id is None:
            trace_id = self.mint_trace_id()
        return Span(self, trace_id, f"{self.daemon}:s{next(self._seq)}",
                    parent_id, name)

    def context(self) -> Optional[Dict]:
        """The propagation header for an outgoing message: the current
        span's (trace_id, span_id), or None when tracing is off / no
        span is open — so a disabled tracer never grows a message."""
        if not self.enabled:
            return None
        cur = CURRENT_SPAN.get()
        if cur is None or cur.span_id is None:
            return None
        return {"id": cur.trace_id, "span": cur.span_id}

    def _finished(self, span: Span) -> None:
        self._traces.setdefault(span.trace_id, []).append(span.dump())
        while len(self._traces) > self.keep:
            self._traces.popitem(last=False)

    # -- dump surfaces (admin socket `trace dump` / `trace recent`) --------

    def dump_trace(self, trace_id: str) -> List[Dict]:
        return list(self._traces.get(trace_id, []))

    def dump_recent(self, n: int = 20) -> Dict[str, List[Dict]]:
        tids = list(self._traces)[-n:]
        return {tid: list(self._traces[tid]) for tid in tids}


def assemble_tree(spans: List[Dict]) -> List[Dict]:
    """Merge per-daemon span dumps of ONE trace into the cross-daemon
    tree: returns the root spans, each with a ``children`` list, sorted
    by start time.  Spans whose parent is absent (a daemon's ring
    trimmed it) surface as roots rather than vanishing."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict] = []
    for s in by_id.values():
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(s)
        else:
            roots.append(s)
    def _sort(nodes: List[Dict]) -> None:
        nodes.sort(key=lambda n: n["start"])
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return roots
