"""SLO judge: declarative gates evaluated from EXPORTED telemetry.

Counterpart of ``ceph_tpu/load/slo.py``.

The contract: every gate verdict is computed from what
the cluster actually exports — the mgr Prometheus text scrape, the
mon's health command, and admin-socket dumps — never from reaching into
daemon internals.  A production operator could compute the identical
verdicts from the identical endpoints; that is the point.  (The single
exception is the ``deadline`` gate: "zero acks past the client's
budget" is by definition client-observed, exactly like the chaos
``deadline`` invariant.)

Gates:

====================  ==================================================
``goodput``           scraped served-op delta >= ``goodput_min_frac`` x
                      the offered op count (``ceph_osd_client_ops``)
``p99``               scraped op-latency histogram p99 over the window
                      <= ``p99_ms`` (``ceph_osd_op_lat_hist`` buckets)
``cwnd``              the client AIMD window CONVERGED, not collapsed:
                      either no pushback ever arrived (wide open) or
                      the post-window window floor >= ``cwnd_floor``
                      (``ceph_client_cwnd`` / ``_pushbacks``)
``qos``               dmclock conformance visible on the scrape; under
                      declared contention (``qos_reservation_min`` > 0)
                      reservation-driven dequeues actually happened
``health``            SLOW_OPS and LOOP_LAG clear at window end (mon
                      health checks)
``deadline``          zero acked-past-deadline ops (client-observed)
====================  ==================================================
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_SERIES = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[-+0-9.eEinfa]+)$")
_LABEL = re.compile(r'(\w+)="([^"]*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Prometheus text exposition -> {metric: [(labels, value), ...]}.
    Tiny on purpose: exactly the subset ``render_prometheus`` emits."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES.match(line)
        if not m:
            continue
        labels = dict(_LABEL.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


@dataclass
class TelemetrySnapshot:
    """One scrape of everything the judge is allowed to look at."""

    prom: Dict[str, List[Tuple[Dict[str, str], float]]]
    health: Dict
    dmclock: Dict[str, Dict]
    stamp: float = 0.0


async def snapshot(cluster) -> TelemetrySnapshot:
    """Collect the exported views: mgr Prometheus text (admin-command
    scrape — same exposition the HTTP endpoint serves), mon health, and
    per-OSD ``dump_dmclock`` admin dumps."""
    text = await cluster.daemon_command("mgr", "prometheus metrics")
    health = await cluster.clients[0].objecter.mon_command(
        {"prefix": "health"})
    dm: Dict[str, Dict] = {}
    for osd_id in sorted(cluster.osds):
        dm[f"osd.{osd_id}"] = await cluster.daemon_command(
            f"osd.{osd_id}", "dump_dmclock")
    return TelemetrySnapshot(prom=parse_prometheus(text), health=health,
                             dmclock=dm,
                             stamp=asyncio.get_event_loop().time())


# ------------------------------------------------------------- helpers


def counter_sum(snap: TelemetrySnapshot, metric: str,
                daemon_prefix: str = "osd.") -> float:
    return sum(v for labels, v in snap.prom.get(metric, ())
               if labels.get("daemon", "").startswith(daemon_prefix))


def counter_delta(before: TelemetrySnapshot, after: TelemetrySnapshot,
                  metric: str, daemon_prefix: str = "osd.") -> float:
    return counter_sum(after, metric, daemon_prefix) - \
        counter_sum(before, metric, daemon_prefix)


def _bucket_table(snap: TelemetrySnapshot, metric: str) -> Dict[Tuple[str,
                                                                      str],
                                                                float]:
    out: Dict[Tuple[str, str], float] = {}
    for labels, v in snap.prom.get(f"{metric}_bucket", ()):
        out[(labels.get("daemon", ""), labels.get("le", ""))] = v
    return out


def hist_quantile(before: TelemetrySnapshot, after: TelemetrySnapshot,
                  metric: str, q: float) -> Optional[float]:
    """Quantile of the WINDOW's samples from cumulative-bucket deltas,
    merged across daemons.  Returns the bucket upper bound (same units
    as the histogram ``_sum`` — seconds for latency histograms), None
    when the window recorded no samples, or ``inf`` when the quantile
    falls in the ``+Inf`` bucket — the caller's <= gate must FAIL on
    overflow (clamping to the top finite bound would let an
    arbitrarily bad tail pass the ceiling)."""
    b0, b1 = _bucket_table(before, metric), _bucket_table(after, metric)
    per_le: Dict[str, float] = {}
    for key, v in b1.items():
        d = v - b0.get(key, 0.0)
        if d > 0:
            per_le[key[1]] = per_le.get(key[1], 0.0) + d
    if not per_le:
        return None
    total = per_le.pop("+Inf", None)
    finite = sorted((float(le), c) for le, c in per_le.items())
    if total is None:
        total = max((c for _, c in finite), default=0.0)
    if total <= 0:
        return None
    want = q * total
    for le, cum in finite:
        if cum >= want:
            return le
    return float("inf")


# --------------------------------------------------------------- gates


@dataclass
class SLOReport:
    """Gate verdicts for one load window (rides the LOAD_r* artifact)."""

    rows: List[Dict] = field(default_factory=list)
    # path of the graft-blackbox bundle a failing judgment triggered
    # (None when passing or when the recorder is off) — artifact
    # traceability: a failed run is diagnosable from the artifact alone
    postmortem: Optional[str] = None

    @property
    def passed(self) -> bool:
        return all(r["passed"] for r in self.rows)

    def failures(self) -> List[str]:
        return [f"{r['gate']}: value={r['value']} "
                f"threshold={r['threshold']} ({r.get('note', '')})"
                for r in self.rows if not r["passed"]]

    def failing_gates(self) -> List[Dict]:
        """Observed-vs-threshold rows for every failed gate — what the
        postmortem trigger detail and the artifact record."""
        return [{"gate": r["gate"], "value": r["value"],
                 "threshold": r["threshold"]}
                for r in self.rows if not r["passed"]]

    def as_rows(self) -> List[Dict]:
        return [dict(r) for r in self.rows]


def _row(report: SLOReport, gate: str, value, threshold, passed: bool,
         source: str, note: str = "") -> None:
    report.rows.append({"gate": gate, "value": value,
                        "threshold": threshold, "passed": bool(passed),
                        "source": source, "note": note})


def judge(spec, result, before: TelemetrySnapshot,
          after: TelemetrySnapshot) -> SLOReport:
    """Evaluate every gate for one window.  ``spec`` is the LoadSpec
    (thresholds), ``result`` the LoadResult (offered count + the
    client-observed deadline bookkeeping)."""
    report = SLOReport()

    # goodput: served client ops on the scrape vs what we offered
    served = counter_delta(before, after, "ceph_osd_client_ops")
    floor = spec.gate("goodput_min_frac", 0.5) * max(1, result.offered)
    _row(report, "goodput", round(served, 1), round(floor, 1),
         served >= floor, "scrape:ceph_osd_client_ops",
         f"offered={result.offered} over {spec.duration}s")

    # p99 latency from the scraped histogram delta
    ceil_s = spec.gate("p99_ms", 5000.0) / 1000.0
    p99 = hist_quantile(before, after, "ceph_osd_op_lat_hist", 0.99)
    if p99 is None:
        note, value = "no samples in window", None
    elif p99 == float("inf"):
        # stay JSON-clean in the artifact: the overflow is a string
        note, value = "p99 beyond the largest histogram bucket", "+Inf"
    else:
        note, value = "", round(p99 * 1000.0, 3)
    _row(report, "p99", value, spec.gate("p99_ms", 5000.0),
         p99 is not None and p99 <= ceil_s,
         "scrape:ceph_osd_op_lat_hist", note)

    # AIMD congestion window: converged, not collapsed.  Zero pushbacks
    # means the window never constrained (a provable no-op) and passes;
    # with pushbacks, the surviving window must stay off the floor.
    cwnds = [v for labels, v in after.prom.get("ceph_client_cwnd", ())
             if labels.get("daemon", "").startswith("client.load")]
    pushbacks = counter_delta(before, after, "ceph_client_cwnd_pushbacks",
                              daemon_prefix="client.load")
    cwnd_floor = spec.gate("cwnd_floor", 2.0)
    if not cwnds:
        _row(report, "cwnd", None, cwnd_floor, False,
             "scrape:ceph_client_cwnd",
             "no client sessions on the scrape (mgr_report missing)")
    elif pushbacks == 0:
        _row(report, "cwnd", min(cwnds), cwnd_floor, True,
             "scrape:ceph_client_cwnd", "no pushback: window wide open")
    else:
        _row(report, "cwnd", min(cwnds), cwnd_floor,
             min(cwnds) >= cwnd_floor, "scrape:ceph_client_cwnd",
             f"{int(pushbacks)} pushbacks in window")

    # dmclock conformance: the counters must be ON the scrape; under
    # declared contention, reservation-driven dequeues happened
    res_min = spec.gate("qos_reservation_min", 0.0)
    mclock = any(d.get("enabled") for d in after.dmclock.values())
    present = "ceph_osd_qos_served_reservation" in after.prom and \
        "ceph_osd_qos_evicted" in after.prom
    if not mclock:
        _row(report, "qos", None, res_min, present,
             "scrape+admin:dump_dmclock",
             "osd_op_queue=fifo: conformance not applicable; counters "
             + ("exported" if present else "MISSING from scrape"))
    else:
        res = counter_delta(before, after,
                            "ceph_osd_qos_served_reservation")
        _row(report, "qos", round(res, 1), res_min,
             present and res >= res_min, "scrape+admin:dump_dmclock",
             f"evicted={int(counter_sum(after, 'ceph_osd_qos_evicted'))}")

    # health: the overload warnings stayed clear at window end
    checks = (after.health or {}).get("checks", {}) or {}
    bad = sorted(set(checks) & {"SLOW_OPS", "LOOP_LAG"})
    _row(report, "health", bad or "clear", "no SLOW_OPS/LOOP_LAG",
         not bad, "mon:health",
         "; ".join(str(checks[k]) for k in bad))

    # control plane: the vectorized-churn counters must be
    # ON the scrape (epochs applied, PGs re-peered, the peering
    # duration histogram, skip-to-full events), and an optional
    # map_epochs_min floor gates churn keep-up — storm soaks set it,
    # steady-state specs leave it 0 (counters-present only)
    epochs_min = spec.gate("map_epochs_min", 0.0)
    applied = counter_delta(before, after, "ceph_osd_map_epochs_applied")
    cp_present = all(
        name in after.prom for name in (
            "ceph_osd_map_epochs_applied", "ceph_osd_pgs_repeered",
            "ceph_osd_map_skip_to_full",
            "ceph_osd_peering_lat_hist_bucket"))
    _row(report, "map_churn", round(applied, 1), epochs_min,
         cp_present and applied >= epochs_min,
         "scrape:ceph_osd_map_epochs_applied",
         "" if cp_present
         else "control-plane counters MISSING from scrape")

    # integrity & full-protection counters: the verified
    # read / read-repair / scheduled-scrub / cluster-full telemetry
    # must be ON the scrape (an operator alerts on these; a refactor
    # dropping them from export would blind every such alert), and an
    # optional repairs floor gates corruption soaks — steady-state
    # specs leave it 0 (counters-present only, like map_churn)
    repairs_min = spec.gate("integrity_repairs_min", 0.0)
    repairs = counter_delta(before, after, "ceph_osd_read_repairs") + \
        counter_delta(before, after, "ceph_osd_scrub_errors_repaired")
    integ_present = all(
        name in after.prom for name in (
            "ceph_osd_read_repairs", "ceph_osd_read_shard_crc_errors",
            "ceph_osd_scrub_errors_repaired", "ceph_osd_full_rejects",
            "ceph_osd_read_batch_ticks"))
    _row(report, "integrity", round(repairs, 1), repairs_min,
         integ_present and repairs >= repairs_min,
         "scrape:ceph_osd_read_repairs",
         "" if integ_present
         else "integrity/full counters MISSING from scrape")

    # balance counters: the mgr's balancer/autoscaler/reshape
    # families must be ON the scrape even with the subsystem disabled
    # (declared at mgr init — all-zeros is the provable-no-op witness),
    # and an optional committed-moves floor gates convergence scenarios
    # — steady-state specs leave it 0 (counters-present only)
    moves_min = spec.gate("balance_moves_min", 0.0)
    committed = counter_delta(before, after,
                              "ceph_mgr_balancer_moves_committed",
                              daemon_prefix="mgr.")
    bal_present = all(
        name in after.prom for name in (
            "ceph_mgr_balancer_rounds", "ceph_mgr_balancer_candidates",
            "ceph_mgr_balancer_moves_committed",
            "ceph_mgr_balancer_throttled", "ceph_mgr_autoscale_rounds"))
    _row(report, "balance", round(committed, 1), moves_min,
         bal_present and committed >= moves_min,
         "scrape:ceph_mgr_balancer_moves_committed",
         "" if bal_present
         else "mgr balance counters MISSING from scrape")

    # deadline: zero acks past the client budget (client-observed —
    # the one gate that cannot come from a scrape by definition)
    _row(report, "deadline", len(result.late_acks), 0,
         not result.late_acks, "client:driver",
         result.late_acks[0] if result.late_acks else "")
    return report
