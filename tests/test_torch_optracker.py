"""The port's op tracker, chaos clock and interrupt seams against
``ceph_tpu``'s.

The cases of ``tests/test_optracker.py``, the clock cases of
``tests/test_chaos.py`` and the interrupt-seam cases of
``tests/test_frontdoor.py`` run on both packages; then one seeded
sequence of ops, marks and finishes under a fixed clock must dump the
same history, slow ring, in-flight set and stage spans in both.
"""

import random
import time
import types

import pytest

import ceph_tpu.chaos.clock as jclock
import ceph_tpu.chaos as jchaos
import ceph_tpu.chaos.counters as jcounters
import ceph_tpu.chaos.points as jpoints
import ceph_tpu.cluster.optracker as joptracker
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.chaos.clock as clock
import ceph_tpu_torch.chaos as chaos
import ceph_tpu_torch.chaos.counters as counters
import ceph_tpu_torch.chaos.points as points
import ceph_tpu_torch.cluster.optracker as optracker
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.lockdep as lockdep
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(optracker=joptracker, clock=jclock,
                            counters=jcounters, config=jconfig,
                            lockdep=jlockdep, points=jpoints, chaos=jchaos)
PORT = types.SimpleNamespace(optracker=optracker, clock=clock,
                             counters=counters, config=config,
                             lockdep=lockdep, points=points, chaos=chaos)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


@BOTH
def test_slow_threshold_zero_disables(pkg):
    t = pkg.optracker.OpTracker(slow_threshold=0.0)
    for i in range(5):
        t.create(f"op{i}").finish()
    assert t.dump_historic_slow_ops()["num_ops"] == 0
    assert t.slow_in_flight() == (0, 0.0)


@BOTH
def test_slow_ring_admits_only_slow_ops(pkg):
    t = pkg.optracker.OpTracker(slow_threshold=0.02, slow_size=2)
    t.create("fast").finish()
    for i in range(3):
        op = t.create(f"slow{i}")
        op.start -= 0.05
        op.finish()
    dump = t.dump_historic_slow_ops()
    assert dump["num_ops"] == 2
    assert all("slow" in o["description"] for o in dump["ops"])
    assert dump["ops"][0]["duration"] >= dump["ops"][1]["duration"]
    assert t.dump_historic_ops()["num_ops"] == 4


@BOTH
def test_slow_in_flight_counts_blocked_ops(pkg):
    t = pkg.optracker.OpTracker(slow_threshold=0.02)
    op = t.create("stuck")
    assert t.slow_in_flight() == (0, 0.0)
    op.start -= 0.1
    n, oldest = t.slow_in_flight()
    assert n == 1 and oldest >= 0.1
    op.finish()
    assert t.slow_in_flight() == (0, 0.0)
    assert t.dump_historic_slow_ops()["num_ops"] == 1


@BOTH
def test_trace_absorption_and_event_ordering(pkg):
    t = pkg.optracker.OpTracker()
    now = time.time()
    trace = {"id": "client.x#ab:op7",
             "events": [("objecter:submit", now - 0.02),
                        ("msgr:client.1:send", now - 0.01)]}
    op = t.create("osd_op(...)", trace=trace)
    op.mark("dispatched")
    op.mark("commit")
    op.finish()
    d = t.dump_historic_ops()["ops"][0]
    assert d["trace_id"] == "client.x#ab:op7"
    names = [e["event"] for e in d["type_data"]["events"]]
    assert names.index("objecter:submit") < \
        names.index("msgr:client.1:send") < names.index("initiated")
    assert names.index("initiated") < names.index("dispatched") < \
        names.index("commit") < names.index("done")
    times = [e["time"] for e in d["type_data"]["events"]]
    assert times == sorted(times)


@BOTH
def test_resize_applies_runtime_knobs(pkg):
    t = pkg.optracker.OpTracker(history_size=10, slow_size=10,
                                slow_threshold=0.001)
    for i in range(8):
        op = t.create(f"op{i}")
        op.start -= 0.01
        op.finish()
    assert t.dump_historic_ops()["num_ops"] == 8
    t.resize(history_size=3, slow_size=2)
    hist = t.dump_historic_ops()
    assert hist["num_ops"] == 3
    assert hist["ops"][-1]["description"] == "op7"
    assert t.dump_historic_slow_ops()["num_ops"] == 2
    t.resize(history_size=5)
    t.create("op8").finish()
    assert t.dump_historic_ops()["num_ops"] == 4


@BOTH
def test_mark_current_contextvar(pkg):
    t = pkg.optracker.OpTracker()
    pkg.optracker.mark_current("ignored")
    op = t.create("op")
    token = pkg.optracker.CURRENT_OP.set(op)
    try:
        pkg.optracker.mark_current("ec_encode")
        pkg.optracker.mark_current("commit")
    finally:
        pkg.optracker.CURRENT_OP.reset(token)
    pkg.optracker.mark_current("also_ignored")
    op.finish()
    names = [e["event"] for e in op.dump()["type_data"]["events"]]
    assert "ec_encode" in names and "commit" in names
    assert "ignored" not in names and "also_ignored" not in names


@BOTH
def test_lock_waits_land_on_the_current_op(pkg):
    """Importing the tracker installs its lockdep trace hook: a DepLock
    taken while an op is current marks the wait and the acquisition."""
    import asyncio

    assert pkg.lockdep.TRACE_HOOK is pkg.optracker._lock_trace
    t = pkg.optracker.OpTracker()
    op = t.create("op")

    async def take():
        token = pkg.optracker.CURRENT_OP.set(op)
        try:
            async with pkg.lockdep.DepLock("pg.lock"):
                pass
        finally:
            pkg.optracker.CURRENT_OP.reset(token)

    asyncio.run(take())
    pkg.lockdep.LockDep.instance().reset()
    names = [e for _t, e in op.events]
    assert "lock_wait:pg.lock" in names and "lock_acquired:pg.lock" in names


@BOTH
def test_chaos_clock_skew_and_observer(pkg):
    cfg = pkg.config.Config()
    clk = pkg.clock.ChaosClock.from_config(cfg)
    assert abs(clk.monotonic() - time.monotonic()) < 0.1
    before = pkg.counters.CHAOS.dump()["chaos"].get("clock_skews", 0)
    cfg.injectargs({"chaos_clock_skew": 5.0})
    assert clk.skew == 5.0
    assert clk.monotonic() - time.monotonic() > 4.0
    assert clk.time() - time.time() > 4.0
    assert pkg.counters.CHAOS.dump()["chaos"]["clock_skews"] == before + 1


@BOTH
def test_optracker_ages_follow_skewed_clock(pkg):
    clk = pkg.clock.ChaosClock()
    tracker = pkg.optracker.OpTracker(slow_threshold=10.0, clock=clk)
    op = tracker.create("op")
    assert tracker.slow_in_flight() == (0, 0.0)
    clk.skew = 60.0
    n, oldest = tracker.slow_in_flight()
    assert n == 1 and oldest >= 10.0
    op.finish()


class _Clock:
    """A clock that moves only when told: both trackers see one time."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 5_000_000.0 + self.now


def _drive(pkg, seed):
    clk = _Clock()
    t = pkg.optracker.OpTracker(history_size=12, slow_size=4,
                                slow_threshold=0.5, clock=clk)
    rs = random.Random(seed)
    live = []
    stages = ["queued_for_pg", "reached_pg", "ec_encode", "batch_tick",
              "sub_op_sent", "store:commit", "commit_sent",
              "lock_wait:pg.lock", "lock_acquired:pg.lock"]
    for i in range(120):
        clk.now += rs.uniform(0.0, 0.3)
        r = rs.random()
        if r < 0.35 or not live:
            trace = None
            if rs.random() < 0.5:
                trace = {"id": f"client.{i}",
                         "events": [("objecter:submit", clk.time() - 0.2),
                                    ("msgr:client.1:send",
                                     clk.time() - 0.1)]}
            live.append(t.create(f"osd_op({i})", trace=trace))
        elif r < 0.8:
            op = live[rs.randrange(len(live))]
            if rs.random() < 0.3:
                op.mark_at(rs.choice(stages), clk.now - rs.uniform(0, 0.05))
            else:
                op.mark(rs.choice(stages))
        else:
            live.pop(rs.randrange(len(live))).finish()
    return (t.dump_historic_ops(), t.dump_historic_slow_ops(),
            t.dump_ops_in_flight(), t.slow_in_flight(),
            [o.desc for o in t.history()])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_op_timelines_equal_reference(seed):
    assert _drive(PORT, seed) == _drive(REF, seed)


@BOTH
def test_interrupt_point_unarmed_is_noop(pkg):
    before = pkg.counters.chaos_total()
    pkg.points.maybe_interrupt(pkg.config.Config(), "rbd_snap_pre_header")
    assert pkg.counters.chaos_total() == before


@BOTH
def test_interrupt_point_fires_one_shot_with_skip(pkg):
    cfg = pkg.config.Config(chaos_crash_point="rgw_part_mid",
                            chaos_crash_point_skip=2)
    pkg.points.maybe_interrupt(cfg, "rgw_part_mid")
    pkg.points.maybe_interrupt(cfg, "rgw_complete_mid")
    pkg.points.maybe_interrupt(cfg, "rgw_part_mid")
    assert cfg.chaos_crash_point == "rgw_part_mid"
    before = pkg.counters.CHAOS.dump()["chaos"]["interrupt_points_fired"]
    with pytest.raises(pkg.points.ChaosInterrupt):
        pkg.points.maybe_interrupt(cfg, "rgw_part_mid")
    assert pkg.counters.CHAOS.dump()["chaos"]["interrupt_points_fired"] \
        == before + 1
    assert cfg.chaos_crash_point == ""
    pkg.points.maybe_interrupt(cfg, "rgw_part_mid")


@BOTH
def test_interrupt_point_chain_pops_head(pkg):
    cfg = pkg.config.Config(
        chaos_crash_point="rgw_part_mid,rgw_complete_mid")
    pkg.points.maybe_interrupt(cfg, "rgw_complete_mid")
    with pytest.raises(pkg.points.ChaosInterrupt):
        pkg.points.maybe_interrupt(cfg, "rgw_part_mid")
    assert cfg.chaos_crash_point == "rgw_complete_mid"
    assert pkg.points.resolve_fire(cfg, "rgw_complete_mid") is True
    assert cfg.chaos_crash_point == ""


@BOTH
def test_chaos_crash_unwinds_like_a_cancellation(pkg):
    """An armed crash point's ``ChaosCrash`` is a CancelledError, so the
    hygiene paths that re-raise cancellations carry it out."""
    import asyncio

    assert issubclass(pkg.chaos.ChaosCrash, asyncio.CancelledError)

    async def victim():
        try:
            await asyncio.sleep(0)
            raise pkg.chaos.ChaosCrash("power cut")
        except asyncio.CancelledError:
            raise

    with pytest.raises(pkg.chaos.ChaosCrash):
        asyncio.run(victim())
    assert {"ChaosClock", "ChaosInterrupt", "DiskInjector", "NetInjector",
            "ensure_injector", "maybe_interrupt", "CHAOS", "stream"} <= \
        set(vars(pkg.chaos))
