"""graft-blackbox postmortems: triggered bundles + breach attribution.

When a judge convicts — an SLO gate fails, a chaos invariant convicts,
a crash point fires, or the mon transitions to HEALTH_ERR — the cluster
snapshots its black boxes into ONE bundle: every daemon's flight ring
(via the ``blackbox dump`` admin command), every OSD's historic-op
rings, the mgr Prometheus scrape, and the mon's health history.  The
bundle is a plain JSON document (``POSTMORTEM_*.json``) diagnosable
with no cluster in sight.

``breach_report`` reconstructs the breach window from a bundle: the
late/convicted op set, its per-stage wall attribution (reusing
``trace/attribution.py`` — the acceptance bar is wall_coverage >= 0.9
over the breach set), and a top-suspects table (daemon/stage/seconds).
``render_report`` renders it; ``chrome_trace`` exports the
bundle's op timelines through the existing Perfetto writer.

Determinism: a bundle's content includes wall stamps (they vary run to
run by construction), so the seeded-replay witness is ``replay_key`` —
a hash over the bundle's deterministic projection (trigger kind+reason,
daemon set, failing gate names/thresholds, seed) — the same contract
chaos ``Verdict.replay_key`` uses to exclude wire-level counters.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence

TRIGGER_KINDS = ("slo_gate", "chaos_conviction", "crash_point",
                 "health_err")

BUNDLE_KIND = "graft-blackbox-postmortem"

# per-daemon admin command timeout during collection: a bundle is taken
# while the cluster may be mid-chaos; a wedged daemon must cost seconds,
# not the default 30s, and its slot records the error instead
_COLLECT_TIMEOUT = 5.0


# ------------------------------------------------------------ collection


async def _cmd(cluster, name: str, cmd) -> Dict:
    """One admin command with the collection timeout; failures become
    data (the daemon may be crashed — that IS postmortem evidence)."""
    try:
        return {"ok": True,
                "data": await cluster.daemon_command(
                    name, cmd, timeout=_COLLECT_TIMEOUT)}
    except Exception as e:  # noqa: BLE001 - a dead daemon is evidence
        return {"ok": False, "error": repr(e)}


async def collect_bundle(cluster, kind: str, reason: str,
                         detail: Optional[Dict] = None,
                         clients: Sequence = ()) -> Dict:
    """Snapshot the cluster's black boxes into one bundle dict.

    ``clients`` are Objecter instances (clients have no admin socket —
    their rings are read directly).  Every per-daemon fetch tolerates
    that daemon being dead: plain chaos scenarios run without a mgr,
    and a crash-point bundle is taken with its victim already down.
    """
    daemons: Dict[str, Dict] = {}
    historic: Dict[str, Dict] = {}
    names = [f"osd.{i}" for i in sorted(cluster.osds)]
    names += [f"mon.{m.rank}" for m in cluster.mons]
    if cluster.mgr is not None:
        names.append("mgr")
    for name in names:
        r = await _cmd(cluster, name, "blackbox dump")
        if r["ok"]:
            # flatten the admin payload to the flight dump shape (the
            # same shape client rings use), critical perf riding along
            data = r["data"] or {}
            daemons[name] = {**(data.get("flight") or {}),
                             "perf_critical": data.get("perf_critical")}
        else:
            daemons[name] = {"error": r["error"]}
        if name.startswith("osd."):
            ops = await _cmd(cluster, name, "dump_historic_ops")
            slow = await _cmd(cluster, name, "dump_historic_slow_ops")
            historic[name] = {
                "ops": r2["data"] if (r2 := ops)["ok"]
                else {"error": r2["error"]},
                "slow": r3["data"] if (r3 := slow)["ok"]
                else {"error": r3["error"]},
            }
    for c in clients:
        # Objecter or its RadosClient wrapper both accepted
        obj = getattr(c, "objecter", c)
        flight = getattr(obj, "flight", None)
        if flight is not None and flight:
            daemons[flight.daemon] = flight.dump()
    scrape = await _cmd(cluster, "mgr", "prometheus metrics") \
        if cluster.mgr is not None else {"ok": False,
                                         "error": "no mgr in cluster"}
    health = await _cmd(cluster, f"mon.{cluster.mons[0].rank}", "health")
    history = await _cmd(cluster, f"mon.{cluster.mons[0].rank}",
                         "health history")
    bundle = {
        "kind": BUNDLE_KIND,
        "trigger": {"kind": kind, "reason": reason,
                    "detail": detail or {}},
        "daemons": daemons,
        "historic_ops": historic,
        "mgr_scrape": scrape["data"] if scrape["ok"]
        else {"error": scrape["error"]},
        "health": health["data"] if health["ok"]
        else {"error": health["error"]},
        "health_history": history["data"] if history["ok"]
        else {"error": history["error"]},
    }
    bundle["breach"] = breach_report(bundle)
    return bundle


def write_bundle(bundle: Dict, out_dir: str,
                 tag: Optional[str] = None) -> str:
    """Write ``POSTMORTEM_<kind>_<tag>.json``.  The name is a pure
    function of the trigger (no wall stamps), so a seeded replay lands
    on the same path — collisions overwrite, which is exactly the
    replay semantics we want."""
    trig = bundle.get("trigger", {})
    if tag is None:
        tag = hashlib.sha256(
            str(trig.get("reason", "")).encode()).hexdigest()[:10]
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", tag)
    path = os.path.join(
        out_dir, f"POSTMORTEM_{trig.get('kind', 'unknown')}_{safe}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    return path


def load_bundle(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != BUNDLE_KIND:
        raise ValueError(f"{path}: not a {BUNDLE_KIND} bundle")
    return doc


# ---------------------------------------------------------- breach report


def _breach_ops(bundle: Dict) -> List[Dict]:
    """The breach set: every historic slow op, else the slowest decile
    (at least one) of completed ops — the late/convicted ops the
    attribution must cover."""
    slow: List[Dict] = []
    normal: List[Dict] = []
    for daemon, h in sorted(bundle.get("historic_ops", {}).items()):
        for bucket, out in (("slow", slow), ("ops", normal)):
            payload = h.get(bucket) or {}
            for op in payload.get("ops", ()) \
                    if isinstance(payload, dict) else ():
                if op.get("duration"):
                    out.append({**op, "daemon": daemon})
    if slow:
        return slow
    normal.sort(key=lambda op: -op["duration"])
    return normal[:max(1, len(normal) // 10)]


def breach_report(bundle: Dict) -> Dict:
    """Per-stage attribution + top suspects over the breach set.

    Reuses ``trace/attribution.py`` exactly as ``bench.py --attribute``
    does: each op's event timeline is sliced into stage deltas;
    ``measured_wall_s`` is the breach set's mean client-visible
    duration, so ``wall_coverage`` reports the fraction of the late
    ops' wall the timelines explain (acceptance: >= 0.9)."""
    from ceph_tpu_torch.trace.attribution import aggregate, attribute_events

    ops = _breach_ops(bundle)
    event_lists = []
    suspects: Dict[tuple, Dict] = {}
    for op in ops:
        evs = [(e["time"], e["event"])
               for e in op.get("type_data", {}).get("events", ())]
        if len(evs) < 2:
            continue
        event_lists.append(evs)
        stages, _total = attribute_events(evs)
        if not stages:
            continue
        top_stage, top_s = max(stages.items(), key=lambda kv: kv[1])
        m = re.search(r"\b(\d+\.[0-9a-fx]+)\b",
                      str(op.get("description", "")))
        key = (op["daemon"], m.group(1) if m else "-", top_stage)
        row = suspects.setdefault(
            key, {"daemon": key[0], "pg": key[1], "stage": key[2],
                  "ops": 0, "seconds": 0.0,
                  "example": op.get("description", "")})
        row["ops"] += 1
        row["seconds"] = round(row["seconds"] + top_s, 6)
    wall = sum(op["duration"] for op in ops) / len(ops) if ops else None
    report = aggregate(event_lists, measured_wall_s=wall)
    ranked = sorted(suspects.values(),
                    key=lambda r: -r["seconds"])[:10]
    return {"breach_ops": len(ops), "attribution": report,
            "suspects": ranked}


def replay_key(bundle: Dict) -> str:
    """Seeded-replay witness: sha256 over the bundle's DETERMINISTIC
    projection.  Wall stamps, durations, and wire-level counters vary
    with async timing (the Verdict.replay_key precedent excludes them);
    what must match bit-for-bit across two runs of one seed is the
    trigger identity, the daemon set, and the failing gates'
    names/thresholds."""
    trig = bundle.get("trigger", {})
    detail = trig.get("detail", {}) or {}
    gates = detail.get("gates", ())
    proj = {
        "kind": trig.get("kind"),
        "reason": trig.get("reason"),
        "daemons": sorted(bundle.get("daemons", {})),
        "gates": sorted(
            (g.get("gate"), g.get("threshold")) for g in gates
            if isinstance(g, dict)),
        "seed": detail.get("seed"),
        "name": detail.get("spec") or detail.get("scenario"),
    }
    blob = json.dumps(proj, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


# -------------------------------------------------------------- rendering


def chrome_trace(bundle: Dict) -> Dict:
    """Perfetto/chrome-trace export of the bundle's op timelines
    through the existing ``trace/perfetto.py`` writer, with the flight
    rings folded in as instant events on each daemon's lane."""
    from ceph_tpu_torch.trace.flight import merged_timeline
    from ceph_tpu_torch.trace.perfetto import chrome_trace_from_dumps

    dumps = {}
    for daemon, h in sorted(bundle.get("historic_ops", {}).items()):
        ops = h.get("ops")
        if isinstance(ops, dict) and "ops" in ops:
            dumps[daemon] = ops
    doc = chrome_trace_from_dumps(dumps)
    timeline = merged_timeline(
        {n: d for n, d in bundle.get("daemons", {}).items()
         if isinstance(d, dict) and d.get("events") is not None})
    base = timeline[0]["t"] if timeline else 0.0
    pids = {}
    for ev in timeline:
        pid = pids.setdefault(ev["daemon"], 1000 + len(pids))
        doc["traceEvents"].append({
            "name": ev["kind"], "ph": "i", "s": "p",
            "pid": pid, "tid": 0,
            "ts": round((ev["t"] - base) * 1e6, 3),
            "args": ev.get("data", {})})
    return doc


def render_report(bundle: Dict, timeline_tail: int = 30) -> str:
    """The human breach report."""
    from ceph_tpu_torch.trace.flight import merged_timeline

    trig = bundle.get("trigger", {})
    lines = [
        f"postmortem: trigger={trig.get('kind')} "
        f"reason={trig.get('reason')}",
        f"replay_key: {replay_key(bundle)[:16]}",
    ]
    detail = trig.get("detail", {}) or {}
    for g in detail.get("gates", ()):
        if isinstance(g, dict):
            lines.append(
                f"  gate {g.get('gate')}: value={g.get('value')} "
                f"threshold={g.get('threshold')}")
    health = bundle.get("health", {})
    if isinstance(health, dict) and health.get("checks"):
        for name, msg in sorted(health["checks"].items()):
            lines.append(f"  health {name}: {msg}")
    breach = bundle.get("breach") or breach_report(bundle)
    rep = breach.get("attribution", {})
    lines.append(
        f"breach set: {breach.get('breach_ops', 0)} op(s), "
        f"wall_coverage={rep.get('wall_coverage', 'n/a')}")
    for stage, row in list(rep.get("stages", {}).items())[:8]:
        lines.append(f"  {stage:<20} {row['s']:>10.4f}s "
                     f"{row['frac'] * 100:5.1f}%")
    if breach.get("suspects"):
        lines.append("top suspects (daemon/pg/stage):")
        for s in breach["suspects"][:5]:
            lines.append(
                f"  {s['daemon']:<8} {s['pg']:<12} {s['stage']:<16} "
                f"{s['ops']} op(s) {s['seconds']:.4f}s")
    timeline = merged_timeline(
        {n: d for n, d in bundle.get("daemons", {}).items()
         if isinstance(d, dict) and d.get("events") is not None},
        limit=timeline_tail)
    if timeline:
        lines.append(f"cluster timeline (last {len(timeline)} events, "
                     f"skew-corrected):")
        base = timeline[0]["t"]
        for ev in timeline:
            data = " ".join(f"{k}={v}" for k, v in
                            sorted(ev["data"].items())[:4])
            lines.append(f"  +{ev['t'] - base:8.3f}s {ev['daemon']:<10} "
                         f"{ev['kind']:<12} {data}")
    return "\n".join(lines)
