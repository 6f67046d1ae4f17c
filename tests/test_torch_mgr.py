"""The port's mgr and its balance loops against ``ceph_tpu``'s.

- ``render_prometheus`` on the inputs of
  ``tests/test_perf_counters.py``'s Prometheus cases: the same text;
- ``MonTargeter`` hunting a dead monmap with backoff
  (``tests/test_backoff.py::test_montargeter_hunts_with_backoff``) on the
  port, with the reference's delays for the same seed;
- ``UpmapBalancer.tick`` of each package's ``MgrDaemon`` against its own
  monitor on loopback, both from one map: every branch (throttled by a
  full flag, by recovery pressure, by unclean health; a dry run; a
  committed round) gives the same result, the same counters and the same
  committed ``pg_upmap_items``;
- ``PgAutoscaler.pool_targets`` and ``tick`` through the same mgrs;
- ``Reshaper`` grow and drain against a stub mgr that records its mon
  commands: the same commands and the same op states.

The port's mgr runs on ``device="cpu"``; the reference's maps its pools
with its scalar mapper behind the batched call (no XLA compile).  Each
loopback scenario runs under its own timeout.
"""

import asyncio
import copy
import random
import types

import numpy as np
import pytest

import ceph_tpu.balance as jbalance
import ceph_tpu.cluster.messages as jmessages
import ceph_tpu.cluster.mgr as jmgr
import ceph_tpu.cluster.monclient as jmonclient
import ceph_tpu.osdmap.osdmap as josd
import ceph_tpu.utils.perf as jperf
import ceph_tpu_torch.balance as pbalance
import ceph_tpu_torch.cluster.messages as pmessages
import ceph_tpu_torch.cluster.mgr as pmgr
import ceph_tpu_torch.cluster.monclient as pmonclient
import ceph_tpu_torch.utils.perf as pperf
from ceph_tpu.crush import ScalarMapper as JScalarMapper
from test_torch_mon import (PORT, REF, command, fast_config, leader_of,
                            map_state, plain, run, settle, start_quorum,
                            stop_all, wait_for)
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF.mgr, REF.balance, REF.perf = jmgr, jbalance, jperf
PORT.mgr, PORT.balance, PORT.perf = pmgr, pbalance, pperf
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


# -- the exporter and the monclient ------------------------------------------

PROM_INPUTS = [
    {"osd.0": {"ops": 5,
               "lat": {"avgcount": 2, "sum": 0.5, "last": 0.3,
                       "min": 0.2, "max": 0.3},
               "lat_hist": {"buckets": [1, 2, 0, 1],
                            "lower_bounds": [0, 2, 4, 8],
                            "scale": 1.0, "count": 4, "sum": 11.0}},
     "osd.1": {"ops": 7}},
    {"osd.0": {"lat_hist": {"buckets": [3, 1], "lower_bounds": [0, 2],
                            "scale": 1e6, "count": 4, "sum": 0.004}}},
]


@pytest.mark.parametrize("case", range(len(PROM_INPUTS)))
def test_render_prometheus_equals_reference(case):
    text = pmgr.render_prometheus(copy.deepcopy(PROM_INPUTS[case]))
    assert text == jmgr.render_prometheus(copy.deepcopy(PROM_INPUTS[case]))
    if case == 0:
        assert 'ceph_lat_hist_bucket{daemon="osd.0",le="4"} 3' in text
        assert text.count("# TYPE ceph_ops untyped") == 1
    else:
        assert 'le="2e-06"' in text and 'le="4e-06"' in text


async def _hunt_delays(monclient, seed):
    class DeadMessenger:
        my_addr = ("127.0.0.1", 1)

        async def send_message(self, msg, addr):
            raise ConnectionError("down")

    mt = monclient.MonTargeter(DeadMessenger(),
                               [("127.0.0.1", 2), ("127.0.0.1", 3)],
                               rng=random.Random(seed))
    slept = []
    orig_sleep = asyncio.sleep

    async def spy_sleep(d):
        slept.append(d)
        await orig_sleep(0)

    asyncio.sleep = spy_sleep
    try:
        ok = await mt.send(object())
    finally:
        asyncio.sleep = orig_sleep
    assert not ok
    return slept, mt.current


def test_montargeter_hunts_with_backoff():
    """A dead monmap is hunted with growing jittered delays (not
    hammered), the schedule replays from the same seed, and it is the
    reference's schedule."""
    s1 = asyncio.run(_hunt_delays(pmonclient, 5))
    s2 = asyncio.run(_hunt_delays(pmonclient, 5))
    assert s1 == s2
    assert s1 == asyncio.run(_hunt_delays(jmonclient, 5))
    # one backoff BETWEEN targets; the last failure returns immediately
    assert len(s1[0]) == 1 and all(d >= 0 for d in s1[0])


# -- the balancer and the autoscaler through each package's mgr -------------------


class ScalarBatch:
    """The reference's scalar mapper behind its pool_mapping's batched
    call, memoized per (rule, size, weights, x): the reference maps with
    it instead of compiling its XLA mapper."""

    def __init__(self, cmap):
        self.sm = JScalarMapper(cmap)
        self.rows = {}

    def do_rule_batch(self, ruleno, xs, result_max, weights):
        memo = self.rows.setdefault(
            (ruleno, result_max, np.asarray(weights).tobytes()), {})
        res = np.zeros((len(xs), result_max), dtype=np.int64)
        rlen = np.zeros(len(xs), dtype=np.int64)
        for i, x in enumerate(np.asarray(xs).tolist()):
            row = memo.get(x)
            if row is None:
                row = memo[x] = self.sm.do_rule(ruleno, x, result_max,
                                                list(weights))
            res[i, : len(row)] = row
            rlen[i] = len(row)
        return res, rlen


@pytest.fixture
def ref_scalar_mapper(monkeypatch):
    """Every reference map (the mgr's, its scratch copies) places through
    one memoized scalar mapper of its CRUSH map."""
    batches = {}

    def tensor_mapper(self):
        sig = repr([(b.id, b.items, b.weights)
                    for b in self.crush.buckets.values()]) + \
            repr([r.steps for r in self.crush.rules])
        if sig not in batches:
            batches[sig] = ScalarBatch(self.crush)
        return batches[sig]

    monkeypatch.setattr(josd.OSDMap, "tensor_mapper",
                        property(tensor_mapper))


POOL_PGS = 256


async def mgr_rounds(pkg):
    """A one-mon cluster of 32 OSDs with one pool, and a mgr subscribed to
    it: the balancer's branches and the autoscaler, in order."""
    cfg = fast_config(pkg, mgr_balancer_max_moves=8)
    mons, addrs = await start_quorum(pkg, 1, config=cfg)
    mon = mons[0]
    mgr = pkg.mgr.MgrDaemon(addrs[0], config=cfg, **pkg.dev)
    await mgr.start()
    out = {}
    try:
        await wait_for(lambda: mon.osdmap.mgr_addr is not None,
                       "the mgr's beacon never committed")
        await command(pkg, mon, {"prefix": "osd pool create", "pool": "rbd",
                                 "pg_num": POOL_PGS, "size": 3})
        await settle(mons)
        await wait_for(lambda: mgr.osdmap is not None
                       and mgr.osdmap.epoch == mon.osdmap.epoch, "mgr map")
        bal = mgr.balancer
        mgr.osdmap.flags.add("nearfull")
        out["flags"] = await bal.tick()
        mgr.osdmap.flags.discard("nearfull")
        mgr.daemons = {"osd.0": {"counters": {"osd_recovery_yields": 1}}}
        out["unclean"] = await bal.tick()
        mgr.daemons["osd.0"]["counters"]["osd_recovery_yields"] = 2
        out["recovery"] = await bal.tick()
        mgr.config.mgr_balancer_require_clean = 0
        out["dry_run"] = await bal.tick(dry_run=True)
        before = mon.osdmap.epoch
        out["committed"] = await bal.tick()
        await settle(mons)
        await wait_for(lambda: mgr.osdmap.epoch == mon.osdmap.epoch,
                       "mgr never saw the commit")
        out["epoch_step"] = mon.osdmap.epoch - before
        out["upmaps"] = plain(mon.osdmap.pg_upmap_items)
        mgr.daemons = {"osd.0": {"counters": {
            "osd_recovery_yields": 2, "osd_pool_1_objects": 64 * 2048,
            "osd_stat_bytes_used": 1 << 30}}}
        out["targets"] = plain(mgr.autoscaler.pool_targets())
        out["autoscale"] = [await mgr.autoscaler.tick()]
        await settle(mons)
        await wait_for(lambda: mgr.osdmap.epoch == mon.osdmap.epoch, "map")
        out["autoscale"].append(await mgr.autoscaler.tick())
        await settle(mons)
        out["pool"] = map_state(mon.osdmap)["pools"]
        out["counters"] = {k: v for k, v in
                           mgr.perf.dump()[mgr.perf.name].items()
                           if k.startswith("mgr_balancer")
                           or k.startswith("mgr_autoscale")}
        # the mgr's address is a port the kernel picked: left out
        out["mgr_map"] = {k: v for k, v in map_state(mgr.osdmap).items()
                          if k != "mgr"}
        out["mon_map"] = {k: v for k, v in map_state(mon.osdmap).items()
                          if k != "mgr"}
        return out
    finally:
        await mgr.stop()
        await stop_all(mons)


def test_balancer_and_autoscaler_equal_reference(ref_scalar_mapper):
    ref = run(mgr_rounds(REF))
    port = run(mgr_rounds(PORT))
    for key in ref:
        assert plain(port[key]) == plain(ref[key]), key
    assert ref["flags"]["skipped"].startswith("cluster flags")
    assert ref["unclean"]["skipped"] == "unclean health: PG_RECOVERING"
    assert ref["recovery"]["skipped"] == "recovery yielding to client QoS"
    assert ref["dry_run"]["moves"] > 0 and "committed" not in ref["dry_run"]
    assert ref["committed"]["committed"] is True
    assert ref["committed"]["skew_after"] < ref["committed"]["skew_before"]
    assert ref["epoch_step"] == 1
    assert sum(len(v) for v in ref["upmaps"].values()) == \
        ref["committed"]["moves"]
    assert ref["mgr_map"] == ref["mon_map"]
    assert [a["actions"][0]["set"] for a in ref["autoscale"]] == \
        ["pg_num", "pgp_num"]
    assert ref["counters"]["mgr_balancer_throttled"] == 3


# -- the reshaper against a stub mgr --------------------------------------------


class StubMgr:
    """The reshaper's view of a mgr: a map, counters, and a mon that
    records each command and answers as the real one would."""

    def __init__(self, pkg, m):
        self.osdmap = m
        self.perf = pkg.perf.PerfCounters("mgr.stub")
        self.config = pkg.Config()
        self.commands = []
        self.healthy = False

    async def mon_command(self, cmd, timeout=10.0):
        self.commands.append(plain(cmd))
        prefix = cmd["prefix"]
        if prefix == "osd grow":
            base = self.osdmap.max_osd
            return {"new_osds": list(range(base, base + cmd["count"]))}
        if prefix == "health":
            return {"checks": {} if self.healthy else
                    {"PG_RECOVERING": "1 pg(s) on temp acting"}}
        return None


async def reshape_story(pkg):
    m = pkg.osd.OSDMap(pkg.types.build_hierarchy(4, 4)[0], **pkg.dev)
    m.add_pool(pkg.osd.PGPool(pool_id=1, size=3, pg_num=64, pgp_num=64,
                              crush_rule=0, name="rbd"))
    mgr = StubMgr(pkg, m)
    r = pkg.balance.Reshaper(mgr)
    states = [await r.grow(4, 2)]
    m.apply_incremental(pkg.osd.Incremental(
        epoch=m.epoch + 1, new_max_osd=20,
        new_crush_hosts=(("host4", (16, 17), (0x10000,) * 2, "default"),
                         ("host5", (18, 19), (0x10000,) * 2, "default"))))
    states.append(await r.advance())
    m.apply_incremental(pkg.osd.Incremental(
        epoch=m.epoch + 1, new_up={o: None for o in range(16, 20)}))
    states.append(await r.advance())
    states.append(await r.drain_osds([0, 1]))
    m.apply_incremental(pkg.osd.Incremental(
        epoch=m.epoch + 1, new_weights={0: 0, 1: 0}))
    states.append(await r.advance())
    mgr.healthy = True
    states.append(await r.advance())
    m.apply_incremental(pkg.osd.Incremental(epoch=m.epoch + 1,
                                            new_down=[0, 1]))
    states.append(await r.advance())
    return states, mgr.commands, mgr.perf.dump()


def test_reshaper_equals_reference(ref_scalar_mapper):
    ref = run(reshape_story(REF))
    port = run(reshape_story(PORT))
    assert plain(port) == plain(ref)
    states, commands, _perf = ref
    phases = [[op["phase"] for op in (s if isinstance(s, list) else [s])]
              for s in states]
    assert phases == [["waiting-up"], ["waiting-up"], ["done"],
                      ["wait-clean"], ["done", "wait-clean"],
                      ["done", "wait-down"], ["done", "done"]]
    # the drain's advance re-sends "osd out" while the map still shows
    # the OSDs in (the stub mon commits nothing)
    assert [c["prefix"] for c in commands] == [
        "osd grow", "osd out", "osd out", "health", "health", "osd purge",
        "osd purge"]


def test_mgr_defaults_and_exporter_equal_reference():
    """A port mgr's declared counter families and its admin commands
    answer as the reference's."""
    async def scenario(pkg):
        mgr = pkg.mgr.MgrDaemon(("127.0.0.1", 1), config=pkg.Config(),
                                **pkg.dev)
        try:
            status = await mgr.asok.dispatch({"prefix": "mgr status"})
            text = mgr.prometheus_metrics()
            return status, sorted(
                line for line in text.splitlines()
                if "mgr_balancer" in line or "mgr_autoscale" in line)
        finally:
            await mgr.messenger.shutdown()

    assert run(scenario(PORT)) == run(scenario(REF))


def test_mgr_follows_the_map_across_a_monitor_death():
    """The port's mgr re-subscribes on the monitor its hunt lands on, so
    commits after its monitor's death still reach it; the reference's
    mgr hunts without re-subscribing and keeps its last map (ROADMAP
    §C)."""
    async def scenario(pkg):
        cfg = fast_config(pkg)
        mons, addrs = await start_quorum(pkg, 3, config=cfg)
        mgr = pkg.mgr.MgrDaemon(addrs, config=cfg, **pkg.dev)
        await mgr.start()
        try:
            leader = await leader_of(mons)
            await wait_for(lambda: leader.osdmap.mgr_addr is not None
                           and mgr.osdmap is not None
                           and mgr.osdmap.epoch == leader.osdmap.epoch,
                           "the mgr never registered")
            await mons[0].stop()          # the monitor it subscribed to
            survivors = mons[1:]
            leader = await leader_of(survivors)
            await mgr.mon_command({"prefix": "osd out", "ids": [3]},
                                  timeout=5.0)
            leader = await settle(survivors)
            try:
                await wait_for(lambda: mgr.osdmap.epoch ==
                               leader.osdmap.epoch, "stale", bound=2.0)
            except TimeoutError:
                return False
            return mgr.osdmap.osd_weight[3] == 0
        finally:
            await mgr.stop()
            await stop_all(mons)

    assert run(scenario(PORT)) is True
    assert run(scenario(REF)) is False
