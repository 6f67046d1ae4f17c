"""Mgr: the metrics/management daemon.

Counterpart of ``ceph_tpu/cluster/mgr.py``.

Behavioral mirror of the reference ceph-mgr core loop (src/mgr/): daemons
stream their perf counters as MMgrReport (MgrClient::send_report,
src/mgr/MgrClient.cc:232), the mgr keeps per-daemon state
(DaemonState/DaemonPerfCounters, src/mgr/DaemonState.h:65) and serves
aggregated views over admin commands — the substrate the reference's
dashboard/restful python modules sit on.

Round 6: a Prometheus-style exporter (the reference's mgr prometheus
module, src/pybind/mgr/prometheus/module.py) renders every reported
daemon's counters in the Prometheus text exposition format with
``daemon`` labels — u64 counters as plain gauges, time/avg counters as
``_sum``/``_count`` pairs, perf histograms as cumulative ``_bucket``
series — served both over the admin socket (``prometheus metrics``) and
an optional HTTP endpoint (``serve_exporter``).

The port's mgr plans on a device: ``device`` (CUDA unless the caller
names the CPU) is set on every map it takes in, so the balancer's scorer
and the reshaper's ``pool_mapping`` run there, whatever device the
sending monitor used.
"""

from __future__ import annotations

import asyncio
import pickle
import time
from typing import Any, Dict, Optional, Tuple

from ceph_tpu_torch.balance import PgAutoscaler, Reshaper, UpmapBalancer
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.messenger import Addr, Connection, Dispatcher, EntityName, Messenger
from ceph_tpu_torch.cluster.monclient import MonTargeter
from ceph_tpu_torch.utils import AdminSocket, Config, KERNELS, PerfCountersCollection
from ceph_tpu_torch.utils.backoff import ExpBackoff
from ceph_tpu_torch.utils.device import resolve_device_index

# the graft-balance counter families, DECLARED (present-and-zero on the
# scrape) at mgr init whether or not the loops ever run: the SLO
# balance gate asserts presence, and a disabled subsystem showing
# all-zeros is the provable-no-op witness
_BALANCE_COUNTERS = (
    ("mgr_balancer_rounds", "balancer optimization rounds"),
    ("mgr_balancer_candidates", "candidate moves scored"),
    ("mgr_balancer_moves_proposed", "moves chosen by the optimizer"),
    ("mgr_balancer_moves_committed", "moves committed to the mon"),
    ("mgr_balancer_throttled", "rounds skipped for *full flags, "
                               "recovery pressure, or unclean health"),
    ("mgr_balancer_bytes_projected", "projected bytes the committed "
                                     "moves will shift"),
    ("mgr_balancer_skew_before_milli", "pg-per-osd stddev before the "
                                       "last round (x1000)"),
    ("mgr_balancer_skew_after_milli", "pg-per-osd stddev after the "
                                      "last round (x1000)"),
    ("mgr_autoscale_rounds", "autoscaler rounds"),
    ("mgr_autoscale_splits", "pg_num doublings issued"),
    ("mgr_autoscale_pgp_bumps", "pgp_num catch-ups issued"),
    ("mgr_reshape_grows", "grow operations started"),
    ("mgr_reshape_drains", "drain operations started"),
)


def _prom_name(counter: str) -> str:
    """Counter -> Prometheus metric name (the exporter module's
    sanitization: [a-zA-Z0-9_] only, 'ceph_' prefix)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_"
                   for c in counter)
    return f"ceph_{safe}"


def render_prometheus(daemons: Dict[str, Dict]) -> str:
    """Render {daemon_name: {counter: value}} as Prometheus text format.

    Values may be ints (u64 counters), {"avgcount","sum",...} dicts
    (time/avg counters -> _sum + _count), or {"buckets","lower_bounds",
    ...} dicts (perf histograms -> cumulative _bucket + _sum + _count).
    Pure function so the format is testable without a cluster.
    """
    by_metric: Dict[str, list] = {}
    for daemon in sorted(daemons):
        counters = daemons[daemon]
        for name in sorted(counters):
            val = counters[name]
            metric = _prom_name(name)
            label = f'daemon="{daemon}"'
            if isinstance(val, dict) and "buckets" in val:
                rows = by_metric.setdefault(metric, [])
                cum = 0
                # le bounds must be in the SAME units as _sum (the raw
                # recorded value): un-apply the histogram's bucketing
                # scale (e.g. 1e6 for microsecond-bucketed latencies)
                scale = val.get("scale", 1.0) or 1.0
                for count, lb in zip(val["buckets"],
                                     val["lower_bounds"]):
                    cum += count
                    # bucket upper bound: the NEXT bucket's lower bound
                    # (bucket 0 spans scaled [0, 2), so its bound is 2)
                    ub = (lb * 2 if lb else 2) / scale
                    rows.append((f'{metric}_bucket{{{label},'
                                 f'le="{ub:g}"}}', cum))
                rows.append((f'{metric}_bucket{{{label},le="+Inf"}}',
                             val["count"]))
                rows.append((f"{metric}_count{{{label}}}", val["count"]))
                rows.append((f"{metric}_sum{{{label}}}", val["sum"]))
            elif isinstance(val, dict) and "avgcount" in val:
                rows = by_metric.setdefault(metric, [])
                rows.append((f"{metric}_count{{{label}}}",
                             val["avgcount"]))
                rows.append((f"{metric}_sum{{{label}}}", val["sum"]))
            elif isinstance(val, (int, float)):
                by_metric.setdefault(metric, []).append(
                    (f"{metric}{{{label}}}", val))
    lines = []
    for metric in sorted(by_metric):
        lines.append(f"# TYPE {metric} untyped")
        for series, value in by_metric[metric]:
            lines.append(f"{series} {value}")
    return "\n".join(lines) + "\n"


class MgrDaemon(Dispatcher):
    def __init__(self, mon_addr, config: Optional[Config] = None,
                 rank: int = 0, device=None, placements=None):
        """``device``: where the balance loops' placement and scoring run
        (CUDA unless the caller names the CPU; raises without a card).
        ``placements``: a raw-placement cache the maps this mgr takes in
        share with the other daemons of an in-process cluster
        (``vstart.PlacementCache``), or None."""
        self.device = resolve_device_index(device)
        self.placements = placements
        self.rank = rank
        # per-daemon config copy: injectargs on one daemon must never
        # leak into another (each reference daemon owns its md_config_t)
        self.config = Config(**config.show()) if config else Config()
        self.messenger = Messenger(
            EntityName("mgr", rank),
            secret=self.config.auth_secret(),
            auth=self.config.cephx_context(f"mgr.{rank}"),
            config=self.config)
        self.messenger.add_dispatcher(self)
        # a hunt re-subscribes on the monitor it lands on: the map feed
        # follows the mgr across a monitor's death (the reference's mgr
        # hunts without it and keeps planning on its last map)
        self.monc = MonTargeter(
            self.messenger, mon_addr,
            subscribe_since=lambda: self.osdmap.epoch if self.osdmap else 0)
        self.perfcoll = PerfCountersCollection()
        self.perf = self.perfcoll.create(f"mgr.{rank}")
        self.perfcoll.register(KERNELS)
        # daemon -> {counters, last_report} (DaemonStateIndex analog)
        self.daemons: Dict[str, Dict] = {}
        self._stopped = False
        self._exporter = None
        self.exporter_addr: Optional[Tuple[str, int]] = None
        # graft-blackbox flight ring (NULL_FLIGHT when disabled)
        from ceph_tpu_torch.trace import FlightRecorder

        self.flight = FlightRecorder.from_config(
            "mgr", self.config)
        # graft-balance: the policy subsystem.  Objects always exist
        # (admin commands work pull-driven); the LOOPS only start when
        # mgr_balancer_enabled / mgr_autoscale_enabled say so.
        for name, desc in _BALANCE_COUNTERS:
            self.perf.add_u64(name, desc=desc)
        self.osdmap = None
        self._mon_tid = 0
        self._mon_inflight: Dict[int, asyncio.Future] = {}
        self.balancer = UpmapBalancer(self)
        self.autoscaler = PgAutoscaler(self)
        self.reshaper = Reshaper(self)
        self.asok = self._build_admin_socket()

    def _build_admin_socket(self) -> AdminSocket:
        asok = AdminSocket()
        asok.register_common(self.perfcoll, self.config,
                             flight=self.flight)
        asok.register("mgr status",
                      lambda cmd: {
                          "daemons": sorted(self.daemons),
                          "reports": self.perf.get("mgr_reports"),
                      }, "reporting daemons + report count")
        asok.register("counter dump",
                      lambda cmd: {d: s["counters"]
                                   for d, s in self.daemons.items()},
                      "every reported daemon's raw counters")
        asok.register("counter sum", self._counter_sum,
                      "aggregate one counter across daemons")
        asok.register("prometheus metrics",
                      lambda cmd: self.prometheus_metrics(),
                      "Prometheus text-format exposition of all "
                      "daemons' counters")
        asok.register("balance status", self._cmd_balance_status,
                      "balancer/autoscaler last rounds + reshape ops "
                      "(advances open reshape ops)")
        asok.register("balance optimize",
                      lambda cmd: self.balancer.tick(
                          dry_run=bool(cmd.get("dry_run"))),
                      "run one balancer round now (dry_run=True plans "
                      "without committing)")
        asok.register("balance autoscale",
                      lambda cmd: self.autoscaler.tick(
                          dry_run=bool(cmd.get("dry_run"))),
                      "run one autoscaler round now")
        asok.register("balance grow",
                      lambda cmd: self.reshaper.grow(
                          int(cmd.get("count", 0)),
                          int(cmd.get("osds_per_host", 1) or 1)),
                      "mint new OSD ids + CRUSH hosts through the mon")
        asok.register("balance drain",
                      lambda cmd: self.reshaper.drain_osds(
                          [int(o) for o in cmd.get("osds", [])]),
                      "start draining OSDs (out -> wait-clean -> purge)")
        return asok

    async def _cmd_balance_status(self, cmd) -> Dict:
        # pull-driven advance: with the loops disabled, polling status
        # is what moves reshape ops forward (zero background activity)
        ops = await self.reshaper.advance()
        return {"enabled": bool(self.config.mgr_balancer_enabled),
                "autoscale_enabled": bool(self.config.mgr_autoscale_enabled),
                "vectorized": bool(self.config.mgr_balancer_vectorized),
                "epoch": self.osdmap.epoch if self.osdmap else 0,
                "last_round": self.balancer.last_round,
                "last_autoscale": self.autoscaler.last_round,
                "pools": self.autoscaler.pool_targets(),
                "reshape_ops": ops}

    def _counter_sum(self, cmd):
        name = cmd.get("counter", "")
        return sum(s["counters"].get(name, 0)
                   for s in self.daemons.values()
                   if isinstance(s["counters"].get(name, 0),
                                 (int, float)))

    def prometheus_metrics(self) -> str:
        """Every reported daemon's counters + the mgr's own, labeled."""
        all_daemons = {d: s["counters"] for d, s in self.daemons.items()}
        for name, counters in self.perfcoll.dump().items():
            all_daemons.setdefault(name, counters)
        return render_prometheus(all_daemons)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        addr = await self.messenger.bind(host, port)
        # announce to the mon; the mon publishes us through the osdmap
        # (MgrMap analog) so daemons learn where to report.  Beacons
        # REPEAT: a single one can land on a leaderless mon mid-election
        # and be dropped silently (the mon only commits from its leader)
        await self.monc.send(M.MMgrBeacon(addr=addr), raise_on_fail=True)
        self._beacon_task = asyncio.get_event_loop().create_task(
            self._beacon_loop(addr))
        # follow the osdmap like any daemon: the balance subsystem plans
        # against the subscribed map, never a side-channel copy
        await self.monc.send(M.MMonSubscribe(what="osdmap", addr=addr),
                             raise_on_fail=True)
        if self.config.mgr_balancer_enabled:
            self._balance_task = asyncio.get_event_loop().create_task(
                self._balance_loop())
        if self.config.mgr_autoscale_enabled:
            self._autoscale_task = asyncio.get_event_loop().create_task(
                self._autoscale_loop())
        return addr

    async def _balance_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(
                max(0.05, self.config.mgr_balancer_interval))
            try:
                await self.reshaper.advance()
                await self.balancer.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a failed round must not kill the policy loop; counted,
                # and the next round reads fresh state anyway
                self.perf.inc("mgr_balancer_round_errors")

    async def _autoscale_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(
                max(0.05, self.config.mgr_autoscale_interval))
            try:
                await self.autoscaler.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.perf.inc("mgr_autoscale_round_errors")

    async def mon_command(self, cmd: Dict[str, Any],
                          timeout: float = 10.0):
        """Objecter-style mon command from the mgr: tid-matched futures,
        capped jittered retry on -11 (leaderless quorum) and transport
        errors, RuntimeError on real failures."""
        deadline = asyncio.get_event_loop().time() + timeout * 3
        backoff = ExpBackoff(base=0.05, cap=1.0)
        last_err: Optional[BaseException] = None
        while asyncio.get_event_loop().time() < deadline:
            self._mon_tid += 1
            tid = self._mon_tid
            fut = asyncio.get_event_loop().create_future()
            self._mon_inflight[tid] = fut
            try:
                await self.monc.send(M.MMonCommand(cmd=cmd, tid=tid),
                                     raise_on_fail=True)
                reply = await asyncio.wait_for(fut, timeout=timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                self._mon_inflight.pop(tid, None)
                last_err = e
                await asyncio.sleep(backoff.next())
                continue
            if reply.result == -11:   # no leader yet: retry
                last_err = RuntimeError(str(reply.data))
                await asyncio.sleep(backoff.next())
                continue
            if reply.result != 0:
                raise RuntimeError(f"mon command failed: {reply.data}")
            return reply.data
        raise TimeoutError(f"mgr mon command never succeeded: {last_err}")

    async def serve_exporter(self, host: str = "127.0.0.1",
                             port: int = 0) -> Tuple[str, int]:
        """Start the HTTP scrape endpoint (the prometheus module's
        StandbyModule server analog): GET anything -> text metrics."""
        self._exporter = await asyncio.start_server(
            self._serve_scrape, host, port)
        self.exporter_addr = self._exporter.sockets[0].getsockname()[:2]
        return self.exporter_addr

    async def _serve_scrape(self, reader, writer) -> None:
        try:
            # drain the request head; the path is irrelevant (every
            # scrape gets the full exposition).  Bounded: a client that
            # connects and never finishes its head must not wedge the
            # handler task for the life of the mgr
            async def _head():
                while True:
                    line = await reader.readline()
                    if not line or line in (b"\r\n", b"\n"):
                        return

            await asyncio.wait_for(_head(), timeout=5.0)
            body = self.prometheus_metrics().encode()
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() +
                b"\r\nConnection: close\r\n\r\n" + body)
            await writer.drain()
            self.perf.inc("mgr_scrapes")
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except (ConnectionError, OSError, RuntimeError):
                pass  # best-effort close of a dying scrape socket

    async def _beacon_loop(self, addr: Addr) -> None:
        while not self._stopped:
            await asyncio.sleep(max(1.0, self.config.mon_lease_interval * 4))
            await self.monc.send(M.MMgrBeacon(addr=addr))

    async def stop(self) -> None:
        self._stopped = True
        for tname in ("_beacon_task", "_balance_task", "_autoscale_task"):
            t = getattr(self, tname, None)
            if t:
                t.cancel()
        if self._exporter is not None:
            self._exporter.close()
        await self.messenger.shutdown()
        self.perfcoll.remove(self.perf.name)

    async def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, M.MMgrReport):
            self.daemons[msg.daemon] = {
                "counters": msg.counters,
                "last_report": time.monotonic(),
            }
            self.perf.inc("mgr_reports")
            if self.flight and self.perf.get("mgr_reports") % 16 == 0:
                # sampled: the report stream is per-daemon-per-beacon;
                # one ring event every 16 keeps the box from being all
                # mgr traffic
                self.flight.record("report", daemon=msg.daemon)
            return True
        if isinstance(msg, M.MCommand):
            result, data = await self.asok.dispatch(msg.cmd)
            await conn.send(M.MCommandReply(tid=msg.tid, result=result,
                                            data=data))
            return True
        if isinstance(msg, M.MOSDMapMsg):
            newmap = pickle.loads(msg.osdmap_blob)
            if self.osdmap is None or newmap.epoch >= self.osdmap.epoch:
                self.osdmap = newmap.set_device(self.device,
                                                self.placements)
            return True
        if isinstance(msg, M.MOSDIncMapMsg):
            m = self.osdmap
            if m is not None and msg.prev_epoch == m.epoch:
                for blob in msg.inc_blobs:
                    m.apply_incremental(pickle.loads(blob))
            elif m is not None and msg.epoch <= m.epoch:
                pass  # already current
            else:
                # gap: resync from our epoch (objecter's recovery move)
                await self.monc.send(M.MMonSubscribe(
                    what="osdmap", addr=self.messenger.my_addr,
                    since=m.epoch if m else 0))
            return True
        if isinstance(msg, M.MMonCommandReply):
            fut = self._mon_inflight.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        return False
