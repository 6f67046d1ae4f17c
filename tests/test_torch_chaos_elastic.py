"""The port's elastic runner (``ceph_tpu_torch/chaos/balance.py``) against
``ceph_tpu``'s, on the cases of ``tests/test_balance_elastic.py``.

Host determinism, exact equality with the reference: the scenario library
(``dataclasses.asdict``) at four scales, ``build_elastic_plan`` of every
elastic scenario at five seeds, and the slot-move ledger on one pair of
mappings.

Whole runs on a port cluster (``device="cpu"``, each under its own
deadline): ``expand-drain-smoke`` at seed 7 (grow 3 -> 6 under a load
window, rebalance, drain back, judged) and PG-split dup protection with
read-your-ack across the split.  What is compared does not depend on
timing: the verdict, its plan, and the counters the reference's tests
assert.  One port-only case pins the runner's convergence wait, which
no longer waits for OSDs a drain purged (the reference's spends its whole
timeout there).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

import ceph_tpu.chaos.balance as jbalance
import ceph_tpu_torch.chaos.balance as balance
from tests._flaky import contention_retry
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 180.0
SCALES = (0.03, 0.1, 0.5, 1.0)
SEEDS = range(5)
NAMES = sorted(jbalance.elastic_scenarios(1.0))


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


# ------------------------------------------------------- seeded planning


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("scale", SCALES)
def test_elastic_library_equals_reference(scale, name):
    got = balance.elastic_scenarios(scale)
    assert sorted(got) == NAMES
    assert dataclasses.asdict(got[name]) == dataclasses.asdict(
        jbalance.elastic_scenarios(scale)[name])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_elastic_plan_equals_reference(name, seed):
    for scale in (0.06, 1.0):
        got = balance.build_elastic_plan(
            balance.elastic_scenarios(scale)[name], seed)
        assert got == jbalance.build_elastic_plan(
            jbalance.elastic_scenarios(scale)[name], seed)


def test_elastic_plan_bit_identical_replay():
    sc = balance.elastic_scenarios(0.06)["expand-drain"]
    assert balance.build_elastic_plan(sc, 7) == \
        balance.build_elastic_plan(sc, 7)
    assert balance.build_elastic_plan(sc, 7) != \
        balance.build_elastic_plan(sc, 8)
    smoke_a = balance.elastic_scenarios(0.03)["expand-drain-smoke"]
    smoke_b = balance.elastic_scenarios(1.0)["expand-drain-smoke"]
    assert smoke_a == smoke_b


def test_moved_slots_equals_reference():
    """The slot-move ledger counts what the reference's counts: changed
    rows of a pool, and every slot of a reshaped or vanished pool."""
    rng = np.random.default_rng(5)
    before = {1: rng.integers(0, 6, (16, 2)),
              2: rng.integers(0, 6, (8, 3)),
              3: rng.integers(0, 6, (4, 2))}
    after = {1: before[1].copy(), 2: rng.integers(0, 6, (16, 3))}
    after[1][[2, 7, 11], 0] += 1
    assert balance._moved_slots(before, after) == \
        jbalance._moved_slots(before, after) == 3 + 48 + 8


# ------------------------------------------------ the tier-1 e2e smoke


@pytest.mark.chaos
@contention_retry(attempts=2)
def test_expand_drain_smoke_passes():
    """The full elastic cycle at tier-1 size: load, grow 3->6, rebalance,
    the HEALTH_OK bound, the move budget, drain back, judged
    durability/acting/health/lockdep and SLO gates."""
    sc = balance.elastic_scenarios(0.03)["expand-drain-smoke"]
    v = run(balance.run_elastic(sc, 7, device="cpu"))
    assert v.passed, v.failures
    plan = balance.build_elastic_plan(sc, 7)
    assert plan == jbalance.build_elastic_plan(
        jbalance.elastic_scenarios(0.03)["expand-drain-smoke"], 7)
    assert [e["action"] for e in v.schedule] == [p["phase"] for p in plan]
    assert v.counters.get("moves_committed", 0) >= 1


# -------------------------------- dup protection across the split seam


@contention_retry(attempts=4)
def test_pg_split_dup_protection_and_read_your_ack():
    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.cluster.vstart import start_cluster
    from ceph_tpu_torch.ops.jenkins import str_hash_rjenkins
    from ceph_tpu_torch.osdmap.osdmap import ceph_stable_mod

    async def scenario():
        cluster = await start_cluster(3, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create("seam", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            payload = {f"seam-{i}": (b"acked-%d " % i) * 40
                       for i in range(24)}
            for k, v in payload.items():
                await io.write_full(k, v)

            def seed_at(oid, pg_num, mask):
                return ceph_stable_mod(
                    str_hash_rjenkins(oid.encode()), pg_num, mask)

            mover = next(k for k in payload if seed_at(k, 8, 7) >= 4)
            parent = client.objecter.object_pgid(pool, mover)
            _, _, _, primary = \
                client.objecter.osdmap.pg_to_up_acting_osds(parent)
            pst = cluster.osds[primary].pgs[parent]
            entry = next(e for e in pst.log.entries
                         if e.oid == mover
                         and getattr(e, "client_reqid", None))
            reqid = tuple(entry.client_reqid)

            await client.pool_set("seam", "pg_num", 8)
            for _ in range(300):
                if all(o.osdmap.pools[pool].pg_num == 8
                       for o in cluster.osds.values() if not o._stopped):
                    break
                await asyncio.sleep(0.1)

            child = client.objecter.object_pgid(pool, mover)
            assert child.seed >= 4, "picked object did not migrate"
            assert child != parent

            for k, v in payload.items():
                assert await io.read(k, timeout=60) == v, k

            _, _, _, cprimary = \
                client.objecter.osdmap.pg_to_up_acting_osds(child)
            osd = cluster.osds[cprimary]
            cst = osd.pgs[child]
            assert cst.log.has_reqid(reqid), \
                "reqid index did not migrate with the split"

            replies = []

            class _Conn:
                async def send(self, msg):
                    replies.append(msg)

            msg = M.MOSDOp(reqid=reqid, pgid=child, oid=mover,
                           ops=[("append", {"data": b"DOUBLE-APPLY"})],
                           epoch=osd.osdmap.epoch)
            before = osd.perf.get("osd_dup_ops_from_log")
            await osd._handle_client_op(_Conn(), msg)
            for _ in range(200):
                if replies:
                    break
                await asyncio.sleep(0.05)
            assert replies and replies[-1].result == 0, replies
            assert osd.perf.get("osd_dup_ops_from_log") == before + 1
            assert await io.read(mover, timeout=60) == payload[mover], \
                "dup resend re-applied across the split seam"
        finally:
            await cluster.stop()

    run(scenario(), bound=120.0)


# ------------------------------- convergence after a drain (a repair)


class _FakeMap:
    def __init__(self):
        self.max_osd = 6
        self.epoch = 9
        # osd.3-5 were grown, drained and purged: not up, not in the map
        self.osd_exists = [True] * 3 + [False] * 3
        self.osd_up = [True] * 3 + [False] * 3


class _FakeCluster:
    def __init__(self):
        class _Mon:
            osdmap = _FakeMap()

        self.mon = _Mon()
        self.waited = []

    async def wait_for_epoch(self, epoch, timeout=10.0):
        self.waited.append(epoch)


def test_converge_does_not_wait_for_osds_a_drain_purged():
    """``scenario._converge`` after a drain: the purged ids are no OSDs
    to wait for, so it returns at once and waits for the epoch.  The
    reference waits for them and spends its whole timeout (so its
    ``expand-drain-smoke`` takes 60 s more than its work)."""
    import time

    from ceph_tpu.chaos.scenario import _converge as jconverge
    from ceph_tpu_torch.chaos.scenario import _converge

    cluster = _FakeCluster()
    t0 = time.monotonic()
    run(_converge(cluster, 30.0), bound=5.0)
    assert time.monotonic() - t0 < 2.0
    assert cluster.waited == [9]
    ref = _FakeCluster()
    t0 = time.monotonic()
    run(jconverge(ref, 1.0), bound=5.0)
    assert time.monotonic() - t0 >= 1.0
    # a down OSD that still exists is still waited for
    cluster.mon.osdmap.osd_up[1] = False
    t0 = time.monotonic()
    run(_converge(cluster, 1.0), bound=5.0)
    assert time.monotonic() - t0 >= 1.0
