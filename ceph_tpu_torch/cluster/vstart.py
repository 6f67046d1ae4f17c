"""vstart: in-process dev cluster launcher.

Counterpart of ``ceph_tpu/cluster/vstart.py``.

Analog of the reference's src/vstart.sh dev-cluster bootstrap: spin up one
monitor and N OSD daemons on loopback, build the initial CRUSH map/OSDMap,
and hand back a connected client.  Used as the fixture for the tier-3-style
cluster tests (reference qa/standalone/ceph-helpers.sh run the same
daemons-on-loopback shape) and runnable as a module for interactive use:

    python -m ceph_tpu_torch.cluster.vstart --osds 3
"""

from __future__ import annotations

import asyncio
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster.mgr import MgrDaemon
from ceph_tpu_torch.cluster.mon import Monitor
from ceph_tpu_torch.cluster.objecter import RadosClient
from ceph_tpu_torch.cluster.osd import OSDDaemon
from ceph_tpu_torch.crush.types import build_hierarchy
from ceph_tpu_torch.osdmap.osdmap import OSDMap
from ceph_tpu_torch.utils import Config
from ceph_tpu_torch.utils.device import resolve_device_index, warm_device


class PlacementCache:
    """Raw placements shared by the daemons of one in-process cluster.
    Each daemon holds its own copy of the map and maps every pool of it
    at every epoch; the copies of one epoch place alike, so a pool's raw
    placement is computed once per distinct input (``OSDMap._raw_key``)
    and handed to every copy.  An LRU of ``ENTRIES`` placements: the
    pools of the few epochs a cluster's daemons are spread over."""

    ENTRIES = 64

    def __init__(self):
        self.hits = self.misses = 0
        self._memo: "OrderedDict[bytes, Tuple]" = OrderedDict()
        # a monitor mints in executor threads while OSDs map on the loop
        self._lock = threading.Lock()

    def get(self, key: bytes):
        with self._lock:
            got = self._memo.get(key)
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
                self._memo.move_to_end(key)
            return got

    def put(self, key: bytes, value) -> None:
        with self._lock:
            self._memo[key] = value
            while len(self._memo) > self.ENTRIES:
                self._memo.popitem(last=False)


@dataclass
class Cluster:
    """A running mini cluster: mon quorum, N OSDs, loopback messengers."""

    mons: List[Monitor]
    osds: Dict[int, OSDDaemon]
    config: Config
    mon_addrs: List[tuple] = field(default_factory=list)
    clients: List[RadosClient] = field(default_factory=list)
    mgr: Optional[MgrDaemon] = None
    mgr_addr: Optional[tuple] = None
    mds: Optional[object] = None       # rank-0 MDSDaemon (cluster/mds.py)
    mds_addr: Optional[tuple] = None
    mdss: Optional[dict] = None        # rank -> MDSDaemon (multi-active)
    # the card every daemon and client of this cluster runs its device
    # work on (or the CPU, for the plain versions)
    device: Optional[object] = None
    # per-daemon config copies of killed OSDs: a revive must resume the
    # daemon's OWN config (injected fault options survive kill/revive
    # within a chaos scenario), not the cluster template
    osd_configs: Dict[int, Config] = field(default_factory=dict)
    # durable stores of killed/crashed OSDs: a crash-revive remounts the
    # same store and replays its journal (MemStore kills stay lost-RAM)
    osd_stores: Dict[int, object] = field(default_factory=dict)
    # chaos crash-point teardown tasks: a daemon that
    # self-crashes at an armed seam hands its teardown HERE — the dying
    # daemon cannot own the task (its stop() would cancel the crash
    # mid-flight).  Self-discarding; drain_chaos() awaits stragglers so
    # a scenario's heal phase never races a crash still in progress.
    _chaos_tasks: set = field(default_factory=set)
    # per-rank config copies of crashed MDS ranks: like osd_configs, a
    # restarted rank resumes its OWN config so injected fault options
    # (e.g. an armed replay-seam crash point) survive the bounce; the
    # rank's pools ride along so a babysitter can restart it without
    # re-deriving them
    mds_configs: Dict[int, Config] = field(default_factory=dict)
    mds_pools: Dict[int, tuple] = field(default_factory=dict)
    # graft-blackbox: triggered postmortem bundles.  Every
    # produced bundle record lands here ({kind, reason, path, bundle});
    # _bb_seen dedups triggers (one bundle per (kind, reason) — a
    # flapping HEALTH_ERR edge or a re-judged gate must not spray
    # bundles), _bb_tasks tracks async trigger collection spawned from
    # sync seams (the mon health callback), drained by stop().
    postmortems: List[Dict] = field(default_factory=list)
    _bb_seen: set = field(default_factory=set)
    _bb_tasks: set = field(default_factory=set)
    # the boot-time store factory, kept so elastically-grown OSDs
    # (add_osds) get the same backing-store flavor as the original set
    store_factory: Optional[object] = None
    # the raw placements every daemon of this cluster shares
    placements: PlacementCache = field(default_factory=PlacementCache)

    async def blackbox_trigger(self, kind: str, reason: str,
                               detail: Optional[Dict] = None,
                               clients=()) -> Optional[Dict]:
        """Fire a postmortem trigger: snapshot every daemon's flight
        ring + historic ops + mgr scrape + mon health history into ONE
        bundle (ceph_tpu_torch/trace/postmortem.py), write POSTMORTEM_*.json
        when blackbox_dir is set, and remember the record.  One falsy
        test when blackbox_enabled=0 (the no-op contract); deduped per
        (kind, reason)."""
        if not getattr(self.config, "blackbox_enabled", 0):
            return None
        key = (kind, reason)
        if key in self._bb_seen:
            return None
        self._bb_seen.add(key)
        from ceph_tpu_torch.trace import postmortem as pm

        bundle = await pm.collect_bundle(self, kind, reason,
                                         detail=detail, clients=clients)
        path = None
        out_dir = getattr(self.config, "blackbox_dir", "")
        if out_dir:
            path = pm.write_bundle(bundle, out_dir)
        rec = {"kind": kind, "reason": reason, "path": path,
               "bundle": bundle}
        self.postmortems.append(rec)
        return rec

    def _arm_blackbox(self, mon: Monitor) -> None:
        """Install the mon's HEALTH_ERR trigger seam: the edge INTO
        HEALTH_ERR (detected by the mon's tick) spawns a bundle
        collection task owned by the cluster (the mon's tick loop must
        not block on collecting a cluster-wide snapshot)."""
        if not getattr(self.config, "blackbox_enabled", 0):
            return
        from ceph_tpu_torch.utils.tasks import track_task

        def fire(checks: Dict) -> None:
            async def _collect():
                await self.blackbox_trigger(
                    "health_err", f"mon.{mon.rank} HEALTH_ERR",
                    detail={"checks": checks})

            track_task(self._bb_tasks,
                       asyncio.get_event_loop().create_task(_collect()))

        mon._blackbox_health_cb = fire

    async def drain_blackbox(self) -> None:
        """Wait out in-flight trigger collections (stop() calls this
        first so a bundle never races the teardown)."""
        while self._bb_tasks:
            # collection drain: each task's outcome is its bundle record
            await asyncio.gather(*list(self._bb_tasks),
                                 return_exceptions=True)

    def _arm_chaos_crash(self, osd: OSDDaemon) -> None:
        """Install the crash-point callback: when the daemon's write
        path trips an armed chaos_crash_point, the cluster performs the
        same bookkeeping as an injector-driven crash_osd (config +
        durable store remembered for revive)."""
        from ceph_tpu_torch.utils.tasks import track_task

        def fire(point: str) -> None:
            async def _crash():
                if self.osds.get(osd.osd_id) is osd:
                    await self.crash_osd(osd.osd_id)
                # a fired crash point is a postmortem trigger: the
                # bundle is taken with the victim already down (its
                # flight ring's tail IS the evidence of interest, and
                # collection tolerates the dead daemon)
                await self.blackbox_trigger(
                    "crash_point",
                    f"osd.{osd.osd_id} crash point {point!r}",
                    detail={"osd": osd.osd_id, "point": point})

            track_task(self._chaos_tasks,
                       asyncio.get_event_loop().create_task(_crash()))

        osd._chaos_crash_cb = fire

    async def drain_chaos(self) -> None:
        """Wait out in-flight crash-point teardowns (scenario runner
        calls this before healing/reviving)."""
        while self._chaos_tasks:
            # teardown drain: each task's outcome is the crash itself
            await asyncio.gather(*list(self._chaos_tasks),
                                 return_exceptions=True)

    @property
    def mon(self) -> Monitor:
        """The authoritative monitor: the quorum leader (or the only one)."""
        for m in self.mons:
            if m.is_leader:
                return m
        return self.mons[0]

    @property
    def mon_addr(self):
        return self.mon_addrs[0] if len(self.mon_addrs) == 1 \
            else self.mon_addrs

    async def start_mds(self, meta_pool: int, data_pool: int,
                        rank: int = 0):
        """Start (or restart) an active MDS rank over existing pools
        (multiple ranks = multi-active, subtree-partitioned).  A rank
        crashed at a chaos seam resumes its own per-rank config copy
        (mds_configs), like an OSD revive.  The rank runs on the
        cluster's ``device``."""
        from ceph_tpu_torch.cluster.mds import MDSDaemon

        cfg = self.mds_configs.pop(rank, None) or self.config
        daemon = MDSDaemon(self.mon_addr, meta_pool, data_pool,
                           config=cfg, rank=rank, device=self.device)
        self._arm_chaos_crash_mds(daemon)
        self.mds_pools[rank] = (meta_pool, data_pool)
        addr = await daemon.start()
        if self.mdss is None:
            self.mdss = {}
        self.mdss[rank] = daemon
        if rank == 0 or self.mds is None:
            self.mds = daemon
            self.mds_addr = addr
        return daemon

    def _arm_chaos_crash_mds(self, daemon) -> None:
        """Install the MDS crash-point callback: when the rank's serve
        or replay path trips an armed chaos_crash_point, the cluster
        performs the same bookkeeping as crash_mds (per-rank config
        remembered; the rank's durable state already lives in RADOS)."""
        from ceph_tpu_torch.utils.tasks import track_task

        def fire(point: str) -> None:
            async def _crash():
                if (self.mdss or {}).get(daemon.rank) is daemon:
                    await self.crash_mds(daemon.rank)
                else:
                    # crashed during boot, before registration: remember
                    # the config and put the half-started daemon down
                    self.mds_configs.setdefault(daemon.rank,
                                                daemon.config)
                    await daemon.stop()

            track_task(self._chaos_tasks,
                       asyncio.get_event_loop().create_task(_crash()))

        daemon._chaos_crash_cb = fire

    async def crash_mds(self, rank: int) -> None:
        """Power-cut an MDS rank: stop it at this instant,
        remembering its per-rank config for the restart.  The MDS holds
        no local store — its journal and dirfrags live in RADOS — so
        the restarted rank's boot replay is the recovery path."""
        daemon = (self.mdss or {}).pop(rank, None)
        if daemon is None:
            return
        self.mds_configs[rank] = daemon.config
        if self.mds is daemon:
            self.mds = next(iter((self.mdss or {}).values()), None)
        daemon._stopped = True
        await daemon.stop()

    @property
    def mon(self) -> Monitor:
        """The authoritative monitor: the quorum leader (or the only one)."""
        for m in self.mons:
            if m.is_leader:
                return m
        return self.mons[0]

    @property
    def mon_addr(self):
        return self.mon_addrs[0] if len(self.mon_addrs) == 1 \
            else self.mon_addrs

    async def client(self, name: str = "admin") -> RadosClient:
        c = RadosClient(self.mon_addr, name=name, config=self.config,
                        device=self.device)
        await c.connect()
        self.clients.append(c)
        return c

    def daemon_addr(self, name: str):
        """Resolve a daemon name ('osd.2', 'mon', 'mon.1', 'mgr',
        'mds.0') to its messenger address — the 'ceph daemon <name>'
        target-resolution seam."""
        kind, _, num = name.partition(".")
        if kind == "mon":
            rank = int(num) if num else self.mons[0].rank
            return self.mon_addrs[rank]
        if kind == "osd":
            osd = self.osds.get(int(num))
            if osd is None:
                raise KeyError(f"no such daemon {name}")
            return osd.messenger.my_addr
        if kind == "mgr":
            if self.mgr_addr is None:
                raise KeyError("no mgr running")
            return self.mgr_addr
        if kind == "mds":
            rank = int(num) if num else 0
            daemon = (self.mdss or {}).get(rank)
            if daemon is None:
                raise KeyError(f"no such daemon {name}")
            return daemon.messenger.my_addr
        raise KeyError(f"unknown daemon kind {kind!r}")

    async def daemon_command(self, name: str, cmd, timeout: float = 30.0):
        """'ceph daemon <name> <cmd>' against this cluster: route an
        MCommand to the daemon's admin socket (cmd: prefix string or
        full command dict)."""
        if isinstance(cmd, str):
            cmd = {"prefix": cmd}
        if not self.clients:
            await self.client()
        return await self.clients[0].objecter.daemon_command(
            self.daemon_addr(name), cmd, timeout=timeout)

    # serialized pickle of the cluster's INITIAL blank osdmap: the seed
    # a revived in-memory monitor reboots from (committed state comes
    # back from the quorum, like a reference mon resyncing from peers)
    _initial_map_blob: bytes = b""

    async def kill_mon(self, rank: int) -> None:
        """Hard-stop a monitor (mon_thrash analog)."""
        await self.mons[rank].stop()

    async def revive_mon(self, rank: int) -> Monitor:
        """Start a fresh monitor for a killed rank (mon_thrash revive):
        binds the ORIGINAL monmap address, rejoins elections, and
        catches up — paxos state through the collect/catch-up path
        (the election's last_committed guard keeps the blank rejoiner
        from winning before it has), the osdmap through an explicit
        subscription to the leader (paxos catch-up alone can be trimmed
        past a long-dead rejoiner's horizon)."""
        import pickle as _pickle

        mon = Monitor(_pickle.loads(self._initial_map_blob),
                      config=self.config, rank=rank,
                      n_mons=len(self.mons), device=self.device,
                      placements=self.placements)
        host, port = self.mon_addrs[rank]
        await mon.start(host, port)
        self.mons[rank] = mon
        self._arm_blackbox(mon)
        if len(self.mons) > 1:
            mon.set_monmap(self.mon_addrs)
            await mon.begin_elections()
            for _ in range(100):
                if mon.leader_rank is not None and \
                        mon.leader_rank != rank:
                    await mon._request_map_sync()
                    break
                await asyncio.sleep(0.05)
        return mon

    async def wait_for_leader(self, timeout: float = 10.0,
                              exclude: int = -1) -> Monitor:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            for m in self.mons:
                if m.rank != exclude and m.is_leader:
                    return m
            await asyncio.sleep(0.05)
        raise TimeoutError("no mon leader elected")

    async def kill_osd(self, osd_id: int) -> None:
        """Hard-stop an OSD (thrasher kill_osd analog).  The daemon's
        per-daemon config is remembered for revive; a durable store
        (FileStore/BlueStore — anything with a crash/mount cycle) is
        remembered too, since a dead host's disks survive it."""
        osd = self.osds.pop(osd_id)
        self.osd_configs[osd_id] = osd.config
        if hasattr(osd.store, "crash"):
            self.osd_stores[osd_id] = osd.store
        await osd.stop()

    async def crash_osd(self, osd_id: int, torn_tail: bool = False,
                        lose_frames: int = 0) -> None:
        """Power-cut an OSD (chaos disk injector): no clean store
        shutdown; a durable store may tear/lose its journal tail and is
        kept for a revive that must replay it."""
        osd = self.osds.pop(osd_id)
        self.osd_configs[osd_id] = osd.config
        if hasattr(osd.store, "crash"):
            self.osd_stores[osd_id] = osd.store
        await osd.stop(crash=True, torn_tail=torn_tail,
                       lose_frames=lose_frames)

    async def revive_osd(self, osd_id: int,
                         with_store: bool = False) -> OSDDaemon:
        """Start a fresh daemon for the id (revive_osd analog; empty
        store by default — recovery must repopulate it).  It resumes the
        killed daemon's OWN config copy, so fault options injected
        before the kill survive the bounce; ``with_store`` remounts the
        remembered durable store (journal replay) instead of booting
        empty."""
        cfg = self.osd_configs.pop(osd_id, None) or self.config
        # the remembered store is consumed either way: reviving empty
        # must not leave a stale pre-crash store behind for a later
        # ``osd_id in osd_stores`` check to remount over recovered data
        store = self.osd_stores.pop(osd_id, None)
        if not with_store:
            store = None
        osd = OSDDaemon(osd_id, self.mon_addr, config=cfg, store=store,
                        device=self.device, placements=self.placements)
        await osd.start()
        self.osds[osd_id] = osd
        self._arm_chaos_crash(osd)
        return osd

    async def restart_osd(self, osd_id: int) -> OSDDaemon:
        """Stop + start an OSD KEEPING its object store (daemon restart:
        the persisted pg log lets peering delta-resync instead of
        backfilling, reference OSD.cc:2556 superblock resume) AND its
        per-daemon config (injected fault options survive the bounce)."""
        old = self.osds.pop(osd_id)
        store = old.store
        await old.stop()
        osd = OSDDaemon(osd_id, self.mon_addr, config=old.config,
                        store=store, device=self.device,
                        placements=self.placements)
        await osd.start()
        self.osds[osd_id] = osd
        self._arm_chaos_crash(osd)
        return osd

    async def add_osds(self, count: int, osds_per_host: int = 1,
                       timeout: float = 15.0) -> List[int]:
        """Elastic growth (graft-balance): mint ``count`` new
        OSD ids + CRUSH hosts through the mon ('osd grow', one
        Incremental), boot daemons into them, and wait until the map
        shows them up — the live N->2N expansion primitive."""
        if not self.clients:
            await self.client()
        data = await self.clients[0].objecter.mon_command(
            {"prefix": "osd grow", "count": count,
             "osds_per_host": osds_per_host})
        new_ids = [int(o) for o in data["new_osds"]]
        await self.boot_osds(new_ids, timeout=timeout)
        return new_ids

    async def boot_osds(self, osd_ids: List[int],
                        timeout: float = 15.0) -> None:
        """Boot daemons into already-minted ids (the mgr reshape path
        mints them via 'balance grow'; this is the operator's side of
        the handshake) and wait until the mon map shows them up."""
        for o in osd_ids:
            factory = self.store_factory
            osd = OSDDaemon(o, self.mon_addr, config=self.config,
                            store=factory(o) if factory else None,
                            device=self.device,
                            placements=self.placements)
            await osd.start()
            self.osds[o] = osd
            self._arm_chaos_crash(osd)
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if all(self.mon.osdmap.osd_up[o] for o in osd_ids):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError(f"grown osds never booted: {osd_ids}")

    async def remove_osd(self, osd_id: int,
                         timeout: float = 20.0) -> None:
        """Finish a drain: stop the daemon, wait for the mon to see it
        down, purge it from the maps.  The caller is responsible for
        having drained data first ('osd out' + wait-clean — the
        mgr Reshaper's drain op); this is the stop-and-purge tail."""
        if osd_id in self.osds:
            await self.kill_osd(osd_id)
        self.osd_configs.pop(osd_id, None)
        self.osd_stores.pop(osd_id, None)
        await self.wait_down(osd_id, timeout=timeout)
        if not self.clients:
            await self.client()
        await self.clients[0].objecter.mon_command(
            {"prefix": "osd purge", "id": osd_id, "sure": True})

    async def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if all(o.osdmap is not None and o.osdmap.epoch >= epoch
                   for o in self.osds.values()):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError(f"epoch {epoch} not reached")

    async def wait_down(self, osd_id: int, timeout: float = 20.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if not self.mon.osdmap.osd_up[osd_id]:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError(f"osd.{osd_id} never marked down")

    async def stop(self) -> None:
        await self.drain_blackbox()
        for c in self.clients:
            await c.shutdown()
        for d in (self.mdss or {}).values():
            await d.stop()
        if self.mds is not None and self.mds not in \
                (self.mdss or {}).values():
            await self.mds.stop()
        if self.mgr is not None:
            await self.mgr.stop()
        for osd in self.osds.values():
            await osd.stop()
        for m in self.mons:
            await m.stop()


def _fast_config() -> Config:
    """Test-speed timings (the vstart analog of ceph.conf overrides)."""
    return Config(
        osd_heartbeat_interval=0.1,
        osd_heartbeat_grace=1.5,
        mon_tick_interval=0.1,
        mon_osd_down_out_interval=2.0,
        mon_osd_min_down_reporters=1,
        mon_osd_beacon_grace=1.5,
        osd_recovery_delay_start=0.05,
        osd_client_op_timeout=5.0,
        # first kernel builds of codec shapes can take tens of seconds on a
        # loaded CPU; client retries must outlast them
        rados_osd_op_timeout=90.0,
        # batched data plane: vstart clusters run the sharded
        # dispatch + per-tick stripe-batch coalescing path — the plain
        # Config() zero-defaults remain the per-op bisection anchor
        osd_op_shards=2,
        osd_batch_tick_ops=16,
        # client-edge batching: the objecter coalesces a
        # tick's ops per (session, OSD) into MOSDOpBatch frames with
        # batched replies; objecter_batch_tick_ops=0 stays the per-op
        # frame anchor for bit-exactness and same-host A/B
        objecter_batch_tick_ops=16,
        # planar at rest: vstart clusters store EC shards as
        # packed bit-planes end-to-end; osd_ec_planar_at_rest=0 (the
        # plain Config() default) stays the byte-at-rest bit-exactness
        # anchor for bisection and same-session A/B
        osd_ec_planar_at_rest=1,
    )


async def start_cluster(n_osds: int = 3, osds_per_host: int = 1,
                        config: Optional[Config] = None,
                        store_factory=None, n_mons: int = 1,
                        with_mgr: bool = False,
                        mon_store_factory=None, device=None) -> Cluster:
    """Boot the mon quorum + OSDs and wait for everything up in the map.

    ``store_factory(osd_id) -> ObjectStore`` selects the backing store
    (default MemStore; pass a FileStore factory for a durable cluster —
    the vstart.sh --bluestore/--filestore switch analog).  ``n_mons`` > 1
    runs a Paxos quorum with leader election.  ``device``: the card
    every daemon and client runs its device work on (CUDA unless the
    caller names the CPU; raises without a card)."""
    import pickle as _pickle

    device = resolve_device_index(device)
    # a process's first I/O must not wait on nvcc or cuBLAS's load
    await asyncio.get_running_loop().run_in_executor(
        None, warm_device, device)

    config = config or _fast_config()
    if getattr(config, "race_check_enabled", 0):
        # arm the process-global write-after-read tracker (graft-race);
        # race_run installs its own tracker+shim pair, so only arm when
        # nothing is installed yet — a boot must not wipe a run's state
        from ceph_tpu_torch.analysis import racecheck
        if not racecheck.TRACKER:
            racecheck.install(racecheck.from_config(config))
    n_hosts = (n_osds + osds_per_host - 1) // osds_per_host
    cmap, _ = build_hierarchy(n_hosts, osds_per_host, numrep=3)
    osdmap = OSDMap(cmap, max_osd=n_osds, device=device)
    # OSDs boot "down" until they report in (reference: superblock boot flow)
    for o in range(n_osds):
        osdmap.osd_up[o] = False
    map_blob = _pickle.dumps(osdmap)
    placements = PlacementCache()
    mons: List[Monitor] = []
    mon_addrs: List[tuple] = []
    for r in range(n_mons):
        mon = Monitor(_pickle.loads(map_blob), config=config, rank=r,
                      n_mons=n_mons,
                      store=mon_store_factory(r) if mon_store_factory
                      else None, device=device, placements=placements)
        mon_addrs.append(await mon.start())
        mons.append(mon)
    cluster = Cluster(mons=mons, osds={}, config=config,
                      mon_addrs=mon_addrs, store_factory=store_factory,
                      device=device, placements=placements)
    cluster._initial_map_blob = map_blob
    for mon in mons:
        cluster._arm_blackbox(mon)
    if n_mons > 1:
        for mon in mons:
            mon.set_monmap(mon_addrs)
        await mons[0].begin_elections()
        await cluster.wait_for_leader()
    if with_mgr:
        cluster.mgr = MgrDaemon(cluster.mon_addr, config=config,
                                device=device, placements=placements)
        cluster.mgr_addr = await cluster.mgr.start()
    for o in range(n_osds):
        osd = OSDDaemon(o, cluster.mon_addr, config=config,
                        store=store_factory(o) if store_factory else None,
                        device=device, placements=placements)
        await osd.start()
        cluster.osds[o] = osd
        cluster._arm_chaos_crash(osd)
    deadline = asyncio.get_event_loop().time() + 10
    while asyncio.get_event_loop().time() < deadline:
        if all(cluster.mon.osdmap.osd_up[o] for o in range(n_osds)):
            break
        await asyncio.sleep(0.02)
    else:
        raise TimeoutError("OSDs never booted")
    await cluster.wait_for_epoch(cluster.mon.osdmap.epoch)
    return cluster


async def _main(n_osds: int, device=None) -> None:
    cluster = await start_cluster(n_osds, device=device)
    client = await cluster.client()
    status = await client.status()
    print(f"cluster up: {status}")
    pool = await client.pool_create("rbd", "replicated", pg_num=8, size=2)
    io = client.ioctx(pool)
    await io.write_full("hello", b"world")
    print("hello ->", await io.read("hello"))
    await cluster.stop()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--osds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args()
    asyncio.run(_main(args.osds, args.device))
