"""Perfetto / chrome://tracing JSON export.

Renders graft-trace data in the Chrome Trace Event format (the
``{"traceEvents": [...]}`` JSON both chrome://tracing and Perfetto
load): per-daemon process lanes, one thread lane per op, complete
("ph": "X") slices per stage or span.  Two sources:

- ``chrome_trace_from_dumps``: ``dump_historic_ops`` payloads from one
  or more daemons (always available — the event timeline is always-on);
- ``chrome_trace_from_spans``: completed Tracer spans of one trace
  (available when ``trace_enabled=1``), nested by parent links.

Pure functions over plain dicts, so a saved dump file converts with no
cluster in sight.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from ceph_tpu_torch.trace.attribution import spans_from_events


def _meta(pid: int, name: str) -> Dict:
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}


def chrome_trace_from_dumps(dumps: Dict[str, Dict]) -> Dict:
    """``{daemon_name: dump_historic_ops_payload}`` -> chrome trace.

    Each daemon becomes a process lane; each op a thread lane (named by
    its trace id / description); each inter-event stage a slice."""
    events: List[Dict] = []
    for pid, daemon in enumerate(sorted(dumps), start=1):
        events.append(_meta(pid, daemon))
        ops = dumps[daemon].get("ops", [])
        for tid, op in enumerate(ops, start=1):
            label = op.get("trace_id") or op.get("description", f"op{tid}")
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": label}})
            evs = [(e["time"], e["event"])
                   for e in op.get("type_data", {}).get("events", [])]
            for sp in spans_from_events(evs):
                events.append({
                    "name": sp["event"], "cat": sp["stage"], "ph": "X",
                    "pid": pid, "tid": tid,
                    "ts": round(sp["start"] * 1e6, 3),
                    "dur": round(sp["dur"] * 1e6, 3),
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_from_spans(spans: Sequence[Dict]) -> Dict:
    """Completed span dicts (one trace, any number of daemons) ->
    chrome trace: process lane per daemon, slices at absolute wall
    timestamps so cross-daemon causality lines up on one axis."""
    daemons = sorted({s["daemon"] for s in spans})
    pid_of = {d: i for i, d in enumerate(daemons, start=1)}
    base = min((s["start"] for s in spans), default=0.0)
    events: List[Dict] = [_meta(pid, d) for d, pid in pid_of.items()]
    for s in spans:
        events.append({
            "name": s["name"], "cat": s.get("trace_id", ""), "ph": "X",
            "pid": pid_of[s["daemon"]], "tid": 1,
            "ts": round((s["start"] - base) * 1e6, 3),
            "dur": round((s["dur"] or 0.0) * 1e6, 3),
            "args": {"span_id": s["span_id"],
                     "parent_id": s["parent_id"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write(path: str, doc: Dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
