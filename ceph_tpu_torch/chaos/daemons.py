"""Daemon injector: kill / revive / restart / crash-stop cluster daemons.

Counterpart of ``ceph_tpu/chaos/daemons.py``.

The thrasher layer (reference qa/tasks/thrashosds.py + ceph_manager.py
kill_osd/revive_osd), built on the vstart Cluster's daemon lifecycle.
Every action ticks the chaos counters; random victims are resolved by
``scenario.build_schedule`` from its seeded stream BEFORE the run, so a
scenario's kill sequence replays exactly.

``crash_osd`` is the power-cut variant: the store is closed WITHOUT its
clean-shutdown checkpoint and may tear or lose its journal tail
(FileStore/BlueStore ``crash()``), so the revived daemon exercises
torn-tail replay; a crashed MemStore comes back empty, like RAM.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.net import ensure_injector


class DaemonInjector:
    def __init__(self, cluster):
        self.cluster = cluster
        # frontier monotonicity marks: (osd_id, pgid) ->
        # the PERSISTED last_complete right before a store-preserving
        # bounce.  The frontier invariant asserts the revived daemon's
        # watermark never regressed below it — a reloaded watermark
        # ahead of (or behind) what the store actually holds is exactly
        # the crash bug class the reconstruction prevents.  Not
        # recorded for torn/lost-tail crashes (tail loss is the
        # injected fault) and dropped when a daemon revives empty.
        self.frontier_marks: Dict[Tuple[int, object], tuple] = {}

    def _mark_frontier(self, osd_id: int) -> None:
        osd = self.cluster.osds.get(osd_id)
        if osd is None:
            return
        for pgid in list(osd.pgs):
            try:
                self.frontier_marks[(osd_id, pgid)] = \
                    osd._load_last_complete(pgid)
            except Exception:
                pass

    # -- lifecycle ----------------------------------------------------------

    async def kill_osd(self, osd_id: int) -> None:
        await self.cluster.kill_osd(osd_id)
        CHAOS.inc("daemon_kills")

    async def crash_osd(self, osd_id: int, torn_tail: bool = False,
                        lose_frames: int = 0) -> None:
        if not torn_tail and not lose_frames:
            self._mark_frontier(osd_id)
        await self.cluster.crash_osd(osd_id, torn_tail=torn_tail,
                                     lose_frames=lose_frames)
        CHAOS.inc("daemon_kills")
        CHAOS.inc("disk_crashes")

    async def revive_osd(self, osd_id: int,
                         with_store: bool = False) -> None:
        if not with_store:
            # booting empty: the recorded watermark no longer binds
            for key in [k for k in self.frontier_marks
                        if k[0] == osd_id]:
                del self.frontier_marks[key]
        await self.cluster.revive_osd(osd_id, with_store=with_store)
        CHAOS.inc("daemon_revives")

    async def restart_osd(self, osd_id: int) -> None:
        self._mark_frontier(osd_id)
        await self.cluster.restart_osd(osd_id)
        CHAOS.inc("daemon_restarts")

    async def kill_mon(self, rank: int) -> None:
        await self.cluster.kill_mon(rank)
        CHAOS.inc("daemon_kills")


# -- partitions (cluster-level, name-addressed) -----------------------------


def _messengers(cluster, names: List[str]):
    for name in names:
        kind, _, num = name.partition(".")
        if kind == "osd":
            osd = cluster.osds.get(int(num))
            if osd is not None:
                yield osd.messenger
        elif kind == "mon":
            rank = int(num) if num else 0
            if rank < len(cluster.mons):
                yield cluster.mons[rank].messenger
        elif kind == "mgr" and cluster.mgr is not None:
            yield cluster.mgr.messenger
        elif kind == "mds":
            daemon = (cluster.mdss or {}).get(int(num) if num else 0)
            if daemon is not None:
                yield daemon.messenger


def _addrs(cluster, names: List[str]) -> List[Tuple[str, int]]:
    out = []
    for name in names:
        try:
            out.append(tuple(cluster.daemon_addr(name)))
        except KeyError:
            pass
    return out


def partition(cluster, side_a: List[str], side_b: List[str],
              symmetric: bool = True) -> None:
    """Block side_a -> side_b traffic (and the reverse when symmetric):
    each named daemon's net injector gains the other side's addrs.
    Asymmetric partitions model one-way link failures — A's sends fail
    while B still reaches A."""
    b_addrs = _addrs(cluster, side_b)
    for msgr in _messengers(cluster, side_a):
        ensure_injector(msgr).partition(*b_addrs)
    if symmetric:
        a_addrs = _addrs(cluster, side_a)
        for msgr in _messengers(cluster, side_b):
            ensure_injector(msgr).partition(*a_addrs)


def heal_partitions(cluster) -> None:
    """Drop every partition edge on every live daemon messenger."""
    for msgr in _all_messengers(cluster):
        if msgr.chaos is not None:
            msgr.chaos.heal()


def _all_messengers(cluster):
    for m in cluster.mons:
        yield m.messenger
    for o in cluster.osds.values():
        yield o.messenger
    if cluster.mgr is not None:
        yield cluster.mgr.messenger
    for d in (cluster.mdss or {}).values():
        yield d.messenger
    for c in cluster.clients:
        yield c.objecter.messenger


def zero_rates(cluster) -> None:
    """Heal-all: zero every chaos_* rate on every daemon config (clock
    skew included) and clear partitions — the scenario runner calls this
    before checking invariants so convergence runs fault-free."""
    zeros = {
        "chaos_net_drop": 0.0, "chaos_net_dup": 0.0,
        "chaos_net_delay": 0.0, "chaos_net_delay_prob": 0.0,
        "chaos_net_reorder": 0.0, "chaos_net_reset": 0.0,
        "chaos_net_partition": "",
        "chaos_net_batch_item_drop": 0.0,
        "chaos_net_batch_ack_dup": 0.0,
        "chaos_net_batch_ack_reorder": 0.0,
        "chaos_crash_point": "", "chaos_crash_point_skip": 0,
        "chaos_disk_read_err": 0.0, "chaos_disk_enospc": 0.0,
        "chaos_disk_bitrot": 0.0, "chaos_clock_skew": 0.0,
    }
    configs = [m.config for m in cluster.mons]
    configs += [o.config for o in cluster.osds.values()]
    # dead daemons keep their per-daemon config in osd_configs and
    # resume it on revive — scrub those too, or the heal phase's own
    # revives would resurrect the injected rates mid-invariant-check
    configs += list(cluster.osd_configs.values())
    # crashed MDS ranks resume their remembered config the same way
    configs += list(getattr(cluster, "mds_configs", {}).values())
    if cluster.mgr is not None:
        configs.append(cluster.mgr.config)
    for d in (cluster.mdss or {}).values():
        configs.append(d.config)
    for c in cluster.clients:
        configs.append(c.objecter.config)
    for cfg in configs:
        cfg.injectargs(zeros)
    heal_partitions(cluster)
