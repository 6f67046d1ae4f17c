"""Per-stage wall-time attribution over op event timelines.

A TrackedOp's event list is a monotone timeline from the objecter's
submit stamp to the OSD's ``done``.  Attribution slices that timeline
into consecutive deltas and labels each delta with the STAGE reached by
its closing event, so every traced nanosecond lands in exactly one
bucket — coverage of the traced window is 100% by construction, and the
only unaccounted wall time is outside the instrumented path (reply
flight back to the client + client wakeup), which the caller measures
as ``wall_coverage`` against the client-observed latency.

The cluster's I/O runs far below the device kernels, and this
module answers "where does each millisecond actually go" per stage —
dispatch-queue wait, PG-lock wait, device encode, store commit,
sub-write fan-out — aggregated across completed ops
(``dump_op_attribution`` admin command, ``bench.py --attribute``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

# stage reached by an event (the delta ENDING at that event belongs to
# the stage).  Events absent here fall through the prefix rules below.
EVENT_STAGE = {
    "objecter:submit": "client",
    "objecter:send": "client",
    "osd:arrival": "wire",
    "initiated": "dispatch_queue",
    "dispatched": "dispatch_queue",
    "ec_encode": "op_prepare",
    "ec_encoded": "device_encode",
    "store:journal_queued": "store_commit",
    "store:commit": "store_commit",
    "ec_sub_write_sent": "sub_write_send",
    "sub_op_sent": "sub_write_send",
    "sub_write_acked": "sub_write_wait",
    "sub_op_acked": "sub_write_wait",
    "ec_sub_read_sent": "sub_read_send",
    "sub_read_acked": "sub_read_wait",
    "commit": "commit",
    "done": "reply",
    "dup_reply_from_cache": "dup_cache",
    "dup_refused_from_log": "dup_cache",
    # overload-regime stages: client congestion-window wait,
    # dead-work shed at dequeue, straggler hedge on degraded EC reads —
    # so wall_coverage holds with backpressure enabled (bench.py
    # --attribute books throttle waits instead of losing them to "wire")
    "objecter:throttle_wait": "throttle_wait",
    "shed_expired": "shed",
    "ec_hedge_sent": "hedge",
    # batched data plane: an EC write parks at the encode
    # coalescer until its dispatch tick (batch_wait = queued-for-tick +
    # the other ops' share of the coalesced encode) and then books its
    # AMORTIZED share of the tick's device dispatch (batch_encode) —
    # so wall_coverage holds with sharded dispatch + coalescing on
    "batch_parked": "op_prepare",
    "batch_tick": "batch_wait",
    "batch_encoded": "batch_encode",
    # verified batched reads: the read twin — a gather's
    # decode parks at the read coalescer until its tick and books the
    # amortized share of the fused decode, so wall_coverage holds on
    # the read path with coalescing + verify-on-read enabled
    "read_batch_parked": "op_prepare",
    "read_batch_tick": "read_batch_wait",
    "read_batch_decoded": "batch_decode",
    # reply-leg tail: the delta from the reply's client-side
    # recv stamp to the caller actually resuming — event-loop wakeup,
    # previously the untraced slice of wall_coverage
    "objecter:complete": "client_wakeup",
    # client-edge batching: an op parked at the objecter's
    # per-(session, OSD) tick coalescer books queued-for-tick time
    # (client_batch_wait) plus its AMORTIZED share of the tick's frame
    # build/send (client_batch_send) — the client twin of
    # batch_wait/batch_encode, so wall_coverage holds with
    # objecter_batch_tick_ops > 0
    "objecter:batch_tick": "client_batch_wait",
    "objecter:batch_sent": "client_batch_send",
    # planar at rest: the two SANCTIONED layout hops — the
    # coalesced encode's client-bytes -> planes ingest and the read
    # assemble's planes -> client-bytes egress — book as planar_convert
    # so `bench.py --attribute` shows exactly what the at-rest format
    # costs (steady-state shard traffic between them is conversion-free
    # by contract; the pinned counter proves it)
    "planar_ingest": "planar_convert",
    "planar_egress": "planar_convert",
}


def stage_for(event: str) -> str:
    s = EVENT_STAGE.get(event)
    if s is not None:
        return s
    if event.startswith("lock_acquired:"):
        return f"lock:{event.split(':', 1)[1]}"
    if event.startswith("lock_wait:"):
        # the delta reaching the wait mark is execution BEFORE the lock
        return "exec"
    if event.startswith("throttle:"):
        # messenger byte-throttle acquire stamp (throttle:<daemon>:
        # acquired): the delta from recv to here is budget wait
        return "throttle_wait"
    if event.startswith("msgr:"):
        return "wire" if event.endswith(":recv") else "messenger_send"
    if event.startswith("shard:"):
        # sharded dispatch stamps (shard:<idx>:queued / :tick): the
        # delta reaching the tick stamp is time parked in the shard
        # queue awaiting its dispatch tick
        return "batch_wait" if event.endswith(":tick") \
            else "dispatch_queue"
    return f"other:{event}"


def attribute_events(
        events: Sequence[Tuple[float, str]]) -> Tuple[Dict[str, float], float]:
    """(stage -> seconds, traced_total).  ``events`` are (time, name)
    pairs on one op's timeline (any consistent clock); deltas between
    consecutive events are labeled by the closing event's stage.  The
    stage sums always add up to ``traced_total`` exactly."""
    evs = sorted(events, key=lambda e: e[0])
    stages: "OrderedDict[str, float]" = OrderedDict()
    for (t0, _), (t1, name) in zip(evs, evs[1:]):
        stage = stage_for(name)
        stages[stage] = stages.get(stage, 0.0) + max(0.0, t1 - t0)
    total = max(0.0, evs[-1][0] - evs[0][0]) if len(evs) > 1 else 0.0
    return stages, total


def spans_from_events(
        events: Sequence[Tuple[float, str]]) -> List[Dict]:
    """The timeline as stage-labeled spans (for dump_historic_ops and
    the Perfetto export): one span per inter-event delta, rebased so
    the first event is t=0."""
    evs = sorted(events, key=lambda e: e[0])
    if not evs:
        return []
    base = evs[0][0]
    out: List[Dict] = []
    for (t0, _), (t1, name) in zip(evs, evs[1:]):
        out.append({"stage": stage_for(name), "event": name,
                    "start": round(t0 - base, 6),
                    "dur": round(max(0.0, t1 - t0), 6)})
    return out


def _report(sums: Dict[str, float], total: float, n: int,
            measured_wall_s: Optional[float]) -> Dict:
    """The one report shape (stage sums + fractions + coverage) shared
    by per-daemon aggregation and the cross-daemon merge, so the two
    artifacts can never diverge in rounding or formula."""
    out: Dict = {
        "ops": n,
        "traced_total_s": round(total, 6),
        "stages": OrderedDict(
            (stage, {"s": round(s, 6),
                     "frac": round(s / total, 4) if total else 0.0})
            for stage, s in sorted(sums.items(), key=lambda kv: -kv[1])),
    }
    if measured_wall_s and n:
        out["measured_wall_s"] = round(measured_wall_s, 6)
        out["wall_coverage"] = round((total / n) / measured_wall_s, 4)
    return out


def aggregate(event_lists: Sequence[Sequence[Tuple[float, str]]],
              measured_wall_s: Optional[float] = None) -> Dict:
    """Roll completed-op timelines into one per-stage breakdown.

    ``measured_wall_s``: the externally measured mean per-op wall time
    (client-observed latency); when given, ``wall_coverage`` reports
    what fraction of it the traced timeline accounts for — the
    bench acceptance metric (>= 0.9 on the cluster_io write bench)."""
    sums: "OrderedDict[str, float]" = OrderedDict()
    total = 0.0
    n = 0
    for events in event_lists:
        stages, t = attribute_events(events)
        if t <= 0.0:
            continue
        n += 1
        total += t
        for stage, s in stages.items():
            sums[stage] = sums.get(stage, 0.0) + s
    return _report(sums, total, n, measured_wall_s)


def merge_reports(reports: Sequence[Dict],
                  measured_wall_s: Optional[float] = None) -> Dict:
    """Merge per-daemon ``aggregate`` reports into one breakdown.

    A pool's PGs spread primaries across OSDs, so each daemon's tracker
    holds a DISJOINT slice of the workload's ops — coverage of the
    whole bench window needs the SUM of every daemon's report, not the
    biggest single one (a stage pathology confined to one OSD must not
    vanish from the artifact)."""
    sums: "OrderedDict[str, float]" = OrderedDict()
    total = 0.0
    n = 0
    for rep in reports:
        n += rep.get("ops", 0)
        total += rep.get("traced_total_s", 0.0)
        for stage, row in rep.get("stages", {}).items():
            sums[stage] = sums.get(stage, 0.0) + row["s"]
    return _report(sums, total, n, measured_wall_s)


def aggregate_tracker(tracker, match: Optional[str] = None,
                      measured_wall_s: Optional[float] = None) -> Dict:
    """Aggregate over an OpTracker's completed-op history (the
    ``dump_op_attribution`` admin payload).  ``match`` filters on the
    op description substring (e.g. 'write_full' to isolate the write
    bench from interleaved reads)."""
    ops = [op for op in tracker.history()
           if match is None or match in op.desc]
    return aggregate([op.events for op in ops],
                     measured_wall_s=measured_wall_s)


async def flush_op_history(cluster, size: int) -> None:
    """Empty every OSD's completed-op ring, restoring capacity
    ``size`` (injectargs 0 -> size through the admin socket).  The
    shared warm-up flush for attribution runs: warm-up ops must never
    be attributed into a timing window."""
    for oid in cluster.osds:
        for n in (0, size):
            await cluster.daemon_command(
                f"osd.{oid}", {"prefix": "injectargs",
                               "args": {"osd_op_history_size": n}})
