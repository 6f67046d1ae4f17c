"""The port's front-door chaos runner (``ceph_tpu_torch/chaos/frontdoor.py``)
against ``ceph_tpu``'s, on the cases of ``tests/test_frontdoor.py``.

Host determinism, exact equality with the reference: the scenario library
(``dataclasses.asdict``) at four scales, ``build_schedule`` of every
front-door scenario at five seeds, and the load plan of a spec with the
front-door verbs.  The three application-level invariants convict the
reference's synthetic histories with the reference's failure lines.

Whole runs on a port cluster (``device="cpu"``, each under its own
deadline): the no-op proof of the unarmed seams, the multipart reclaim of
every interrupted state, the MDS replay that never trims an unreplayed
event, and ``frontdoor-smoke`` at seed 7, whose verdict's replay key equals
that of a passing reference verdict of its own schedule.  What is compared
does not depend on timing.  The reference's slow-marked cases (the smoke's
replay twin and the slow trio) have slow-marked copies.
"""

import asyncio
import dataclasses

import pytest

import ceph_tpu.chaos.frontdoor as jfrontdoor
import ceph_tpu.chaos.invariants as jinv
import ceph_tpu.chaos.scenario as jscenario
import ceph_tpu_torch.chaos.frontdoor as frontdoor
import ceph_tpu_torch.chaos.invariants as inv
import ceph_tpu_torch.chaos.scenario as scenario
from tests._flaky import contention_retry
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 120.0
SCALES = (0.03, 0.1, 0.5, 1.0)
SEEDS = range(5)
NAMES = sorted(jfrontdoor.frontdoor_scenarios(1.0))


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def ref_replay_key(sc, seed: int):
    """The replay key of a passing reference run of ``sc`` at ``seed``:
    its own schedule, passed, no failures."""
    return jscenario.Verdict(
        name=sc.name, seed=seed, schedule=jscenario.build_schedule(sc, seed),
        passed=True, failures=[]).replay_key()


# ------------------------------------------------------------ the library


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("scale", SCALES)
def test_frontdoor_library_equals_reference(scale, name):
    got = frontdoor.frontdoor_scenarios(scale)
    assert sorted(got) == NAMES
    assert dataclasses.asdict(got[name]) == dataclasses.asdict(
        jfrontdoor.frontdoor_scenarios(scale)[name])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_frontdoor_schedule_equals_reference(name, seed):
    got = scenario.build_schedule(frontdoor.frontdoor_scenarios(1.0)[name],
                                  seed)
    assert got == jscenario.build_schedule(
        jfrontdoor.frontdoor_scenarios(1.0)[name], seed)


def test_frontdoor_schedules_deterministic():
    """Every builtin resolves a bit-identical schedule from its seed;
    client/mds crash points never consume OSD bookkeeping."""
    for name, sc in frontdoor.frontdoor_scenarios(1.0).items():
        s1, s2 = scenario.build_schedule(sc, 23), \
            scenario.build_schedule(sc, 23)
        assert s1 == s2, name
        for e in s1:
            if e["action"] == "crash_point":
                assert "at" in e["args"], (name, e)
                assert e["target"] == "client" or \
                    e["target"].startswith("mds"), (name, e)


def test_payload_equals_reference():
    from ceph_tpu.chaos.rng import stream as jstream
    from ceph_tpu_torch.chaos.rng import stream

    a, b = stream(7, "fd_rbd"), jstream(7, "fd_rbd")
    for tag, size in (("g0-reg1", 8 << 10), ("mp-r1-p2", 4 << 10),
                      ("child-g2-reg3", 100), ("x", 1)):
        assert frontdoor._payload(a, tag, size) == \
            jfrontdoor._payload(b, tag, size)


def test_load_plan_determinism_with_frontdoor_verbs():
    """The front-door verbs ride the plan contract: same seed, same plan,
    equal to the reference's; a spec without them resolves only the
    librados verbs."""
    from ceph_tpu.load.driver import LoadSpec as JLoadSpec
    from ceph_tpu.load.driver import build_plan as jbuild_plan
    from ceph_tpu.load.driver import plan_key as jplan_key
    from ceph_tpu_torch.load.driver import LoadSpec, build_plan, plan_key

    shape = dict(name="fdmix", clients=8, sessions=2, rate=2.0,
                 duration=1.0, objects=8,
                 verbs=(("write", 1.0), ("rbd_snap", 1.0),
                        ("rbd_clone_read", 1.0), ("rgw_multipart", 1.0)))
    fd = LoadSpec(**shape)
    assert plan_key(build_plan(fd, 9)) == plan_key(build_plan(fd, 9))
    assert plan_key(build_plan(fd, 9)) != plan_key(build_plan(fd, 10))
    for seed in (9, 10):
        assert plan_key(build_plan(fd, seed)) == \
            jplan_key(jbuild_plan(JLoadSpec(**shape), seed))
    verbs = {op["verb"] for ops in build_plan(fd, 9) for op in ops}
    assert verbs & {"rbd_snap", "rbd_clone_read", "rgw_multipart"}
    base = LoadSpec(name="base", clients=8, sessions=2, rate=2.0,
                    duration=1.0, objects=8)
    assert {op["verb"] for ops in build_plan(base, 9) for op in ops} <= \
        {"write", "read", "rmw", "append", "delete"}


# ------------------------------------- synthetic-history invariants


class _FakeImage:
    def __init__(self, content):
        self.content = content                    # (region, snap) -> bytes

    async def read(self, offset, length, snap_name=None, timeout=None):
        return self.content[(offset // length, snap_name)]


class _SnapFD:
    """Minimal duck-typed stand-in for FrontdoorState's rbd half."""

    def __init__(self, content, snaps, parent_pin=None,
                 clone_expect=None):
        self.region_size = 4
        self.image_name = "img"
        self.clone_name = "clone"
        self.parent_snap = "s0"
        self.snaps = snaps
        self.parent_pin = parent_pin or {}
        self.clone_expect = clone_expect or {}
        self._img = _FakeImage(content)

    async def open_image(self, name):
        return self._img


class _FakeMeta:
    def __init__(self, key):
        self.key = key


class _FakeListing:
    def __init__(self, keys):
        self.keys = [_FakeMeta(k) for k in keys]


class _FakeRGW:
    def __init__(self, objects):
        self.objects = objects                    # key -> bytes

    async def list_objects(self, bucket, prefix="", marker="",
                           max_keys=1000):
        return _FakeListing(sorted(self.objects))

    async def get_object(self, bucket, key, timeout=None):
        if key not in self.objects:
            raise FileNotFoundError(key)
        return _FakeMeta(key), self.objects[key]

    async def head_object(self, bucket, key, timeout=None):
        if key not in self.objects:
            raise FileNotFoundError(key)
        return _FakeMeta(key)


class _MpFD:
    def __init__(self, objects, completed=None, pending=None,
                 orphans=()):
        self.bucket = "b"
        self.rgw = _FakeRGW(objects)
        self.mp_completed = completed or {}
        self.mp_pending = pending or {}
        self._orphans = list(orphans)

    async def part_oids(self):
        return self._orphans


class _NsFD:
    def __init__(self, tree, model=None, gone=()):
        self.tree = tree                          # path -> kind
        self.ns_model = model or {}
        self.ns_gone = set(gone)

    async def fs_stat(self, path):
        if path not in self.tree:
            raise FileNotFoundError(path)

        class Ino:
            mode = self.tree[path]

        return Ino()

    async def fs_listdir(self, path):
        if path not in self.tree:
            raise FileNotFoundError(path)
        return []


def both(check: str, make):
    """The failure lines of the port's and the reference's ``check`` on
    two fresh fakes from ``make``; they must be equal."""
    got = run(getattr(inv, check)(make(), timeout=0.1))
    want = run(getattr(jinv, check)(make(), timeout=0.1))
    assert got == want
    return got


def test_snapshot_invariant_convicts_torn_read():
    failures = both("check_snapshot", lambda: _SnapFD(
        content={(0, "s0"): b"gnB!"},
        snaps={"s0": {0: frozenset({b"gnA!"})}}))
    assert failures and "torn or post-snap" in failures[0]
    assert both("check_snapshot", lambda: _SnapFD(
        content={(0, "s0"): b"gnA!"},
        snaps={"s0": {0: frozenset({b"gnA!"})}})) == []


def test_snapshot_invariant_convicts_mutated_parent_and_lost_copyup():
    failures = both("check_snapshot", lambda: _SnapFD(
        content={(0, "s0"): b"MUT!", (1, None): b"zzzz"}, snaps={},
        parent_pin={0: b"pin!"}, clone_expect={1: frozenset({b"chld"})}))
    assert any("MUTATED" in f for f in failures)
    assert any("lost copy-up" in f for f in failures)


def test_multipart_invariant_convicts_orphans_and_half_visibility():
    assert any("orphaned part" in f for f in both(
        "check_multipart",
        lambda: _MpFD(objects={}, orphans=[".mp.1:b:0001.00001"])))
    assert any("PARTIALLY visible" in f for f in both(
        "check_multipart",
        lambda: _MpFD(objects={"k": b"wrong"}, pending={"k": b"right"})))
    failures = both("check_multipart", lambda: _MpFD(
        objects={}, completed={"k": b"payload"}))
    assert any("unreadable" in f for f in failures)
    assert any("missing from the bucket listing" in f for f in failures)
    assert both("check_multipart", lambda: _MpFD(
        objects={"done": b"x"}, completed={"done": b"x"},
        pending={"gone": b"y"})) == []


def test_namespace_invariant_convicts_lost_and_resurrected():
    assert any("lost post-replay" in f for f in both(
        "check_namespace", lambda: _NsFD(
            tree={"/fd": "dir"}, model={"/fd": "dir", "/fd/f1": "file"})))
    assert any("resurrected" in f for f in both(
        "check_namespace", lambda: _NsFD(
            tree={"/fd": "dir", "/fd/old": "file"}, model={"/fd": "dir"},
            gone=["/fd/old"])))
    assert both("check_namespace", lambda: _NsFD(
        tree={"/fd": "dir", "/fd/f1": "file"},
        model={"/fd": "dir", "/fd/f1": "file"})) == []


def test_finish_clone_expect_equals_reference():
    """The judge-prep of the clone half resolves the reference's
    expectations from one recorded history."""
    states = []
    for mod in (frontdoor, jfrontdoor):
        sc = mod.frontdoor_scenarios(1.0)["frontdoor-smoke"]
        st = mod.FrontdoorState(sc)
        st.parent_pin = {0: b"p0", 1: b"p1", 2: b"p2"}
        st.clone_acked = {0: b"c0"}
        st.clone_attempted = {0: {b"c0", b"c0b"}, 1: {b"c1"}}
        st.finish_clone_expect()
        states.append(st.clone_expect)
    assert states[0] == states[1]
    assert states[0][2] == frozenset({b"p2"})


# ------------------------------------------------------------ whole runs


def test_frontdoor_paths_are_noop_without_armed_points():
    """A full RBD snap/clone/copyup cycle, an RGW multipart and MDS
    metadata ops with no point armed never touch a chaos counter."""
    from ceph_tpu_torch.chaos.counters import chaos_total
    from ceph_tpu_torch.cluster.mds import MDSClient
    from ceph_tpu_torch.cluster.rbd import RBD
    from ceph_tpu_torch.cluster.rgw import RGW
    from ceph_tpu_torch.cluster.vstart import start_cluster

    async def scenario_():
        cluster = await start_cluster(3, device="cpu")
        try:
            before = chaos_total()
            client = await cluster.client()
            pool = await client.pool_create("fdnoop", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            rbd = RBD(io)
            await rbd.create("i", 64 << 10, stripe_unit=8 << 10,
                             stripe_count=1, object_size=16 << 10)
            img = await rbd.open("i")
            await img.write(0, b"g1" * 8192)      # both object halves
            await img.snap_create("s")
            await rbd.clone("i", "s", "c")
            child = await rbd.open("c")
            await child.write(0, b"c" * 8192)      # copy-up traversal
            assert await child.read(8 << 10, 4) == b"g1g1"
            with pytest.raises(OSError):
                await img.snap_remove("s")          # pinned by the clone
            rgw = RGW(io)
            await rgw.create_bucket("b")
            uid = await rgw.create_multipart("b", "k")
            await rgw.upload_part("b", "k", uid, 1, b"p1" * 100)
            await rgw.upload_part("b", "k", uid, 2, b"p2" * 100)
            await rgw.complete_multipart("b", "k", uid)
            _, data = await rgw.get_object("b", "k")
            assert data == b"p1" * 100 + b"p2" * 100
            assert await rgw.list_multipart_uploads("b") == {}
            meta = await client.pool_create("fdnm", "replicated",
                                            pg_num=4, size=3)
            data_p = await client.pool_create("fdnd", "replicated",
                                             pg_num=4, size=3)
            await cluster.start_mds(meta, data_p)
            for _ in range(100):
                await client.objecter._refresh_map()
                if getattr(client.objecter.osdmap, "mds_addr", None):
                    break
                await asyncio.sleep(0.05)
            fs = MDSClient(client, data_p, meta_pool=meta)
            await fs.mkdir("/d")
            await fs.create("/d/f")
            assert chaos_total() == before
        finally:
            await cluster.stop()

    run(scenario_())


@contention_retry()
def test_multipart_reclaim_resolves_every_interrupted_state():
    """One cluster, all four reclaim duties: orphaned parts collected, an
    interrupted complete rolled forward (visible once, exact bytes), an
    interrupted abort finished, a dangling index entry repaired; and a
    crash mid-cleanup finished by the next reclaim."""
    from ceph_tpu_torch.chaos.points import ChaosInterrupt
    from ceph_tpu_torch.cluster.rgw import RGW
    from ceph_tpu_torch.cluster.vstart import start_cluster

    async def scenario_():
        cluster = await start_cluster(3, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create("mprec", "replicated",
                                            pg_num=4, size=3)
            io = client.ioctx(pool)
            rgw = RGW(io)
            await rgw.create_bucket("b")

            uid1 = await rgw.create_multipart("b", "k1")
            io.objecter.config.set("chaos_crash_point", "rgw_part_mid")
            with pytest.raises(ChaosInterrupt):
                await rgw.upload_part("b", "k1", uid1, 1, b"orphan")

            uid2 = await rgw.create_multipart("b", "k2")
            await rgw.upload_part("b", "k2", uid2, 1, b"AA" * 50)
            await rgw.upload_part("b", "k2", uid2, 2, b"BB" * 50)
            io.objecter.config.set("chaos_crash_point",
                                   "rgw_complete_mid")
            with pytest.raises(ChaosInterrupt):
                await rgw.complete_multipart("b", "k2", uid2)
            with pytest.raises(FileNotFoundError):
                await rgw.head_object("b", "k2")   # all-or-nothing

            uid3 = await rgw.create_multipart("b", "k3")
            await rgw.upload_part("b", "k3", uid3, 1, b"CC" * 50)
            io.objecter.config.set("chaos_crash_point", "rgw_abort_mid")
            with pytest.raises(ChaosInterrupt):
                await rgw.abort_multipart("b", "k3", uid3)

            await rgw.put_object("b", "gone", b"dead payload")
            await io.remove(rgw._data_oid("b", "gone"))

            stats = await rgw.reclaim_multipart("b", abort_open=True)
            assert stats["rolled_forward"] == 1, stats
            assert stats["orphan_parts"] >= 1, stats
            assert stats["aborts_finished"] >= 1, stats
            assert stats["index_repaired"] == 1, stats
            _, data = await rgw.get_object("b", "k2")
            assert data == b"AA" * 50 + b"BB" * 50
            prefix = rgw._mp_prefix("b")
            assert [o for o in await io.list_objects()
                    if o.startswith(prefix)] == []
            assert await rgw.list_multipart_uploads("b") == {}
            listed = [m.key for m in (await rgw.list_objects("b")).keys]
            assert listed == ["k2"]
            with pytest.raises(FileNotFoundError):
                await rgw.head_object("b", "gone")

            uid4 = await rgw.create_multipart("b", "k4")
            await rgw.upload_part("b", "k4", uid4, 1, b"DD" * 50)
            await rgw.upload_part("b", "k4", uid4, 2, b"EE" * 50)
            real_remove = io.remove
            seen = {"n": 0}

            async def dying_remove(oid, timeout=None):
                if oid.startswith(rgw._mp_prefix("b")):
                    seen["n"] += 1
                    if seen["n"] == 2:
                        raise TimeoutError("client died mid-cleanup")
                return await real_remove(oid, timeout=timeout)

            io.remove = dying_remove
            with pytest.raises(TimeoutError):
                await rgw.complete_multipart("b", "k4", uid4)
            io.remove = real_remove
            stats = await rgw.reclaim_multipart("b", abort_open=True)
            assert stats["rolled_forward"] == 1, stats
            _, d4 = await rgw.get_object("b", "k4")
            assert d4 == b"DD" * 50 + b"EE" * 50
            assert await rgw.list_multipart_uploads("b") == {}
            assert [o for o in await io.list_objects()
                    if o.startswith(rgw._mp_prefix("b"))] == []
        finally:
            await cluster.stop()

    run(scenario_())


@contention_retry()
def test_mds_replay_transient_failure_never_trims_unreplayed():
    """A transient apply failure during replay stops the watermark: the
    journal keeps the event, the boot fails loudly, and a later replay
    applies it."""
    from ceph_tpu_torch.cluster.vstart import start_cluster

    async def scenario_():
        cluster = await start_cluster(3, device="cpu")
        try:
            admin = await cluster.client()
            meta = await admin.pool_create("rjm", "replicated",
                                           pg_num=4, size=2)
            data = await admin.pool_create("rjd", "replicated",
                                           pg_num=4, size=2)
            await cluster.start_mds(meta, data)
            mds = cluster.mds
            seq = mds._seq + 1
            await mds._journal_append(seq, ("create", "/victim"))

            real_create = mds.fs.create

            async def failing_create(path):
                raise IOError("transient meta-pool failure")

            mds.fs.create = failing_create
            with pytest.raises(IOError):
                await mds._replay_journal()
            applied, events = await mds._journal_state()
            assert applied < seq
            assert f"{seq:016d}" in events
            mds.fs.create = real_create
            await mds._replay_journal()
            assert "victim" in await mds.fs.listdir("/")
            applied, events = await mds._journal_state()
            assert applied >= seq
            assert f"{seq:016d}" not in events   # now safely trimmed
        finally:
            await cluster.stop()

    run(scenario_())


@pytest.mark.chaos
def test_frontdoor_smoke_scenario():
    """All three surfaces under one client interrupt or MDS crash per
    round: the snapshot, multipart and namespace invariants hold, the
    schedule resolves bit-identically, the seams fired, and the verdict's
    replay key is a passing reference verdict's."""
    sc = frontdoor.frontdoor_scenarios(1.0)["frontdoor-smoke"]
    s1 = scenario.build_schedule(sc, 7)
    assert s1 == scenario.build_schedule(sc, 7)
    v = run(frontdoor.run_frontdoor(sc, 7, device="cpu"))
    assert v.passed, v.failures
    assert v.schedule == s1
    assert v.counters.get("interrupt_points_fired", 0) >= 1
    assert v.counters.get("mds_crash_points_fired", 0) >= 1
    assert v.replay_key() == ref_replay_key(
        jfrontdoor.frontdoor_scenarios(1.0)["frontdoor-smoke"], 7)


# ------------------------------------------------ the reference's slow ones


@pytest.mark.chaos
@pytest.mark.slow
def test_frontdoor_smoke_replays_bit_identical():
    sc = frontdoor.frontdoor_scenarios(1.0)["frontdoor-smoke"]
    v1 = run(frontdoor.run_frontdoor(sc, 7, device="cpu"))
    v2 = run(frontdoor.run_frontdoor(sc, 7, device="cpu"))
    assert v1.passed, v1.failures
    assert v2.passed, v2.failures
    assert v1.replay_key() == v2.replay_key()


SLOW_RUNS = {
    # name: (seed, the counter the reference's test asserts, its floor)
    "rbd-snap-midwrite": (11, "interrupt_points_fired", 1),
    "rgw-multipart-crash": (11, "interrupt_points_fired", 1),
    "mds-journal-replay": (11, "mds_crash_points_fired", 2),
}


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW_RUNS))
def test_frontdoor_library_scenario_passes(name, tmp_path):
    seed, counter, floor = SLOW_RUNS[name]
    sc = frontdoor.frontdoor_scenarios(1.0)[name]
    v = run(frontdoor.run_frontdoor(sc, seed, tmpdir=str(tmp_path),
                                    device="cpu"), bound=900.0)
    assert v.passed, v.failures
    assert v.counters.get(counter, 0) >= floor
    assert v.replay_key() == ref_replay_key(
        jfrontdoor.frontdoor_scenarios(1.0)[name], seed)
