"""The port's seeded chaos runner (``ceph_tpu_torch/chaos/{daemons,
invariants,scenario}.py``) against ``ceph_tpu``'s, on the cases of
``tests/test_chaos_scenario.py``, ``tests/test_batch_chaos.py`` and
``tests/test_thrash.py``.

Host determinism, exact equality with the reference: the scenario
library entry for entry, ``build_schedule`` for every scenario of
``builtin_scenarios()`` and ``storm_scenarios(0.05)`` at seeds 0-4, and
``_payload``'s bytes.

Whole runs on a port cluster (``device="cpu"``, each under its own
deadline): ``smoke`` at seed 42 twice and ``batch-smoke`` at seed 31
once, as the reference's tier-1 tests run them.  What is compared does
not depend on timing: each verdict's ``replay_key()`` equals the one a
passing run of the reference's own schedule has, the fault counters
equal what the reference's tests assert, and every acked object of
``batch-smoke`` reads back with its acting members' shards equal to the
reference codec's encode of the bytes read.  The reference's clusters are
not run here (its own tests run them).  The reference's slow-marked
scenarios have slow-marked copies below, to run by hand.

The runner's entry points run on CUDA unless ``device`` names another,
and raise when CUDA is absent: pinned for ``run_scenario``,
``LoadContext.create``, ``run_load``, ``run_fill_drain`` and
``race_run``.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import ceph_tpu.chaos.scenario as jscenario
import ceph_tpu_torch.chaos.scenario as scenario
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 120.0
SEEDS = range(5)
BUILTIN = sorted(jscenario.builtin_scenarios())
STORMS = sorted(jscenario.storm_scenarios(0.05))


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def ref_replay_key(name: str, seed: int, sc=None):
    """The replay key of a passing reference run of ``name`` at ``seed``:
    its own schedule, passed, no failures."""
    sc = sc or jscenario.builtin_scenarios()[name]
    return jscenario.Verdict(
        name=name, seed=seed, schedule=jscenario.build_schedule(sc, seed),
        passed=True, failures=[]).replay_key()


# ------------------------------------------------------------ the library


@pytest.mark.parametrize("name", BUILTIN)
def test_scenario_library_equals_reference(name):
    assert sorted(scenario.builtin_scenarios()) == BUILTIN
    assert dataclasses.asdict(scenario.builtin_scenarios()[name]) == \
        dataclasses.asdict(jscenario.builtin_scenarios()[name])


@pytest.mark.parametrize("name", STORMS)
def test_scaled_storm_library_equals_reference(name):
    assert dataclasses.asdict(scenario.storm_scenarios(0.05)[name]) == \
        dataclasses.asdict(jscenario.storm_scenarios(0.05)[name])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", BUILTIN)
def test_build_schedule_equals_reference(name, seed):
    got = scenario.build_schedule(scenario.builtin_scenarios()[name], seed)
    assert got == jscenario.build_schedule(
        jscenario.builtin_scenarios()[name], seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", STORMS)
def test_scaled_storm_schedule_equals_reference(name, seed):
    got = scenario.build_schedule(scenario.storm_scenarios(0.05)[name], seed)
    assert got == jscenario.build_schedule(
        jscenario.storm_scenarios(0.05)[name], seed)


def test_schedules_differ_across_seeds():
    sc = scenario.builtin_scenarios()["thrash-replicated"]
    plans = {str(scenario.build_schedule(sc, seed)) for seed in range(20)}
    assert len(plans) > 1


def test_verdict_replay_key_equals_reference():
    sched = scenario.build_schedule(
        scenario.builtin_scenarios()["batch-smoke"], 31)
    for passed, failures in ((True, []), (False, ["b: x", "a: y"])):
        got = scenario.Verdict(name="batch-smoke", seed=31, schedule=sched,
                               passed=passed, failures=failures,
                               counters={"daemon_kills": 1})
        ref = jscenario.Verdict(name="batch-smoke", seed=31, schedule=sched,
                                passed=passed, failures=failures)
        assert got.replay_key() == ref.replay_key()
        assert sorted(got.as_dict()) == sorted(ref.as_dict())


@pytest.mark.parametrize("seed,oid,gen,repeat", [
    (42, "obj0", 0, 20), (31, "obj11", 1, 30), (0, "obj3", 2, 60),
    (7, "x", 0, 1)])
def test_payload_equals_reference(seed, oid, gen, repeat):
    from ceph_tpu.chaos.rng import stream as jstream
    from ceph_tpu_torch.chaos.rng import stream

    a, b = stream(seed, "workload"), jstream(seed, "workload")
    got = [scenario._payload(a, oid, gen, repeat) for _ in range(8)]
    assert got == [jscenario._payload(b, oid, gen, repeat)
                   for _ in range(8)]


def test_scenario_zipf_is_the_load_sampler():
    from ceph_tpu_torch.load.dist import zipf_pick

    assert scenario._zipf_pick is zipf_pick


# ------------------------------------------------------------ the device


def _entry_points():
    from ceph_tpu_torch.analysis.racecheck import race_run
    from ceph_tpu_torch.chaos.integrity import integrity_scenarios, \
        run_fill_drain
    from ceph_tpu_torch.load.driver import LoadContext, builtin_specs, \
        run_load

    sc = scenario.builtin_scenarios()["smoke"]
    spec = builtin_specs()["smoke"]
    fill = integrity_scenarios(0.06)["disk-fill-drain"]
    return {
        "run_scenario": lambda **kw: run(scenario.run_scenario(sc, 1, **kw)),
        "LoadContext.create": lambda **kw: run(LoadContext.create(spec, 1,
                                                                  **kw)),
        "run_load": lambda **kw: run(run_load(spec, 1, **kw)),
        "run_fill_drain": lambda **kw: run(run_fill_drain(fill, 1, **kw)),
        "race_run": lambda **kw: race_run("smoke", 1, **kw),
    }


ENTRY_POINTS = ["run_scenario", "LoadContext.create", "run_load",
                "run_fill_drain", "race_run"]


class _Booted(Exception):
    pass


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_runs_on_cuda_unless_asked(entry, monkeypatch):
    """With no ``device`` the cluster boots on the CUDA card; without a
    card the entry point raises before it boots anything."""
    import ceph_tpu_torch.cluster.vstart as vstart

    booted = []

    async def fake_start(*args, device=None, **kwargs):
        booted.append(device)
        raise _Booted()

    monkeypatch.setattr(vstart, "start_cluster", fake_start)
    call = _entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert booted == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(_Booted):
        call()
    with pytest.raises(_Booted):
        call(device="cpu")
    assert booted == [torch.device("cuda", 0), torch.device("cpu")]


# ------------------------------------------------------------ whole runs


@pytest.mark.chaos
def test_smoke_scenario_replays_the_reference_schedule():
    """``tests/test_chaos_scenario.py::test_smoke_scenario_replays_bit_
    identical`` on the port: twice from seed 42, each a passing verdict
    on the reference's schedule, the faults fired."""
    sc = scenario.builtin_scenarios()["smoke"]
    want = ref_replay_key("smoke", 42)
    v1 = run(scenario.run_scenario(sc, 42, device="cpu"))
    v2 = run(scenario.run_scenario(sc, 42, device="cpu"))
    assert v1.passed, v1.failures
    assert v2.passed, v2.failures
    assert v1.replay_key() == v2.replay_key() == want
    assert v1.schedule == v2.schedule
    assert v1.counters.get("daemon_kills") == 1
    assert v1.counters.get("net_drops", 0) > 0


def _read_back_and_shards(store):
    """A ``judge_invariants`` that, once the invariants are judged and
    before the runner stops the cluster, reads back every acked object
    and takes every acting member's shard of it."""
    real = scenario.judge_invariants

    async def judge(cluster, dmn, io, invariants, acked, **kw):
        from ceph_tpu_torch.cluster.pg import _coll
        from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
        from ceph_tpu_torch.ec import planar_store

        failures = await real(cluster, dmn, io, invariants, acked, **kw)
        objecter = cluster.clients[0].objecter
        store["unit"] = int(cluster.mon.osdmap.pools[io.pool_id].ec_profile[
            "stripe_unit"])
        store["attempted"] = kw.get("attempted") or {}
        for oid in sorted(acked):
            pgid = objecter.object_pgid(io.pool_id, oid)
            _, _, acting, _ = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
            shards = {}
            for slot, o in enumerate(acting):
                if o == CRUSH_ITEM_NONE:
                    continue
                st = cluster.osds[o].store
                coll = _coll(pgid)
                if st.stat(coll, oid) is None:
                    shards[slot] = None
                    continue
                assert int(st.getattr(coll, oid, "shard")) == slot
                if st.object_layout(coll, oid) == \
                        planar_store.LAYOUT_PLANAR:
                    shards[slot] = planar_store.planes_to_shard(
                        planar_store.blob_to_planes(
                            st.read_planar(coll, oid)))
                else:
                    shards[slot] = bytes(st.read(coll, oid))
            store[oid] = (await io.read(oid, timeout=30), acked[oid],
                          shards)
        return failures

    return judge


@pytest.mark.chaos
def test_batch_smoke_scenario_reads_back_the_reference_shards(
        tmp_path, monkeypatch):
    """``tests/test_batch_chaos.py::test_batch_smoke_scenario`` on the
    port: seed 31, a passing verdict on the reference's schedule with its
    ``commit_mid_fanout`` crash point; every acked object reads back as a
    whole attempted payload, and each acting member's shard equals the
    reference codec's encode of the bytes read (jerasure reed_sol_van
    k2m1)."""
    from ceph_tpu.ec import factory as jfactory
    from ceph_tpu.ec import stripe as jstripe

    sc = scenario.builtin_scenarios()["batch-smoke"]
    s1 = scenario.build_schedule(sc, 31)
    assert s1 == scenario.build_schedule(sc, 31)
    cp = [e for e in s1 if e["action"] == "crash_point"]
    assert cp and cp[0]["args"]["point"] == "commit_mid_fanout"
    assert "at" in cp[0]["args"]
    assert any(scenario.build_schedule(sc, s) != s1 for s in range(8))
    seen = {}
    monkeypatch.setattr(scenario, "judge_invariants",
                        _read_back_and_shards(seen))
    v = run(scenario.run_scenario(sc, 31, tmpdir=str(tmp_path / "a"),
                                  device="cpu"))
    assert v.passed, v.failures
    assert v.schedule == s1
    assert v.replay_key() == ref_replay_key("batch-smoke", 31)
    assert v.counters.get("crash_points_fired", 0) == 1
    unit, attempted = seen.pop("unit"), seen.pop("attempted")
    assert len(seen) == v.acked_objects > 0
    codec = jfactory(dict(sc.ec_profile))
    sinfo = jstripe.StripeInfo(codec.get_data_chunk_count(), unit)
    for oid, (got, acked, shards) in seen.items():
        assert got == acked or got in attempted.get(oid, ()), oid
        rows = jstripe.encode_stripes(codec, sinfo, got)
        assert len(shards) == 3
        for slot, blob in shards.items():
            assert blob is not None, (oid, slot)
            assert blob == np.asarray(rows[slot]).tobytes(), (oid, slot)


# ------------------------------------------------ the reference's slow ones


@pytest.mark.chaos
@pytest.mark.slow
def test_batch_smoke_scenario_replays_bit_identical(tmp_path):
    sc = scenario.builtin_scenarios()["batch-smoke"]
    v1 = run(scenario.run_scenario(sc, 31, tmpdir=str(tmp_path / "a"),
                                   device="cpu"))
    v2 = run(scenario.run_scenario(sc, 31, tmpdir=str(tmp_path / "b"),
                                   device="cpu"))
    assert v1.passed, v1.failures
    assert v2.passed, v2.failures
    assert v1.replay_key() == v2.replay_key() == \
        ref_replay_key("batch-smoke", 31)
    assert v1.counters.get("net_batch_item_drops", 0) + \
        v2.counters.get("net_batch_item_drops", 0) > 0


SLOW_RUNS = {
    # name: (seed, file store, the counters the reference's test asserts)
    "partition-kill-torn": (7, True, {"disk_torn_journals": 1}),
    "clock-skew": (3, False, {}),
    "bitrot-scrub": (11, False, {"disk_bitrot_flips": 1}),
    "thrash-replicated": (42, False, {"daemon_restarts": 4}),
    "thrash-ec-midwrite": (11, False, {}),
    "batch-kill-midtick": (17, True, {}),
    "rolling-restart-sharded": (13, True, {"daemon_restarts": 4}),
    "overload-shed": (29, False, {}),
    "overload-smoke": (23, False, {}),
}


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW_RUNS))
def test_library_scenario_passes(name, tmp_path):
    seed, file_store, counters = SLOW_RUNS[name]
    sc = scenario.builtin_scenarios()[name]
    v = run(scenario.run_scenario(
        sc, seed, tmpdir=str(tmp_path) if file_store else None,
        device="cpu"), bound=600.0)
    assert v.passed, v.failures
    assert v.replay_key() == ref_replay_key(name, seed)
    for k, want in counters.items():
        assert v.counters.get(k) == want, (k, v.counters)


@pytest.mark.chaos
@pytest.mark.slow
def test_thrash_osds_kill_revive():
    sc = scenario.Scenario(
        name="thrash-kill", osds=5, pool_size=3, pg_num=8,
        rounds=3, objects_per_round=6,
        events=(
            scenario.ev(0, "kill_osd"),
            scenario.ev(1, "revive_osd"),
            scenario.ev(1, "kill_osd"),
            scenario.ev(2, "revive_osd"),
        ),
        invariants=("durability", "acting", "health", "scrub", "lockdep"),
        converge_timeout=90.0)
    v = run(scenario.run_scenario(sc, 1337, device="cpu"), bound=600.0)
    assert v.passed, v.failures
    assert v.counters.get("daemon_kills") == 2
    assert v.counters.get("daemon_revives") == 2


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("scale,name,seed", [
    (0.06, "rolling-restart-100", 7), (0.06, "mon-bounce-under-churn", 11),
    (1.0, "rolling-restart-100", 42), (1.0, "mon-bounce-under-churn", 42)])
def test_storm_scenario_passes(scale, name, seed, tmp_path):
    sc = scenario.storm_scenarios(scale)[name]
    v = run(scenario.run_scenario(sc, seed, tmpdir=str(tmp_path),
                                  device="cpu"), bound=1800.0)
    assert v.passed, v.failures
    assert v.replay_key() == ref_replay_key(
        name, seed, jscenario.storm_scenarios(scale)[name])


# ------------------------------------- phase 9's recovery, at a CPU size


def test_indep_pool_over_hosts_recovers_a_stopped_and_outed_osd():
    """chip_smoke phase 9's recovery sequence (ROADMAP §C's open fault) at
    a size the CPU runs: 12 OSDs on 6 hosts, an EC pool on the mon's
    ``chooseleaf indep <size> type host`` rule (jerasure reed_sol_van
    k4m2: every host holds a slot of every PG, as ISA k8m4 does on phase
    9's 12 hosts), objects written, one OSD stopped by the
    ``DaemonInjector`` until the mon marks it down and out; then the
    ``acting`` and ``durability`` invariants hold, no pg_temp is left,
    and every acting member of every object's PG holds its shard."""
    from ceph_tpu_torch.chaos import invariants as inv
    from ceph_tpu_torch.chaos.daemons import DaemonInjector
    from ceph_tpu_torch.cluster.pg import _coll
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    victim = 5

    async def case():
        cfg = _fast_config()
        cluster = await start_cluster(12, osds_per_host=2, config=cfg,
                                      device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "indep", "erasure", pg_num=16,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van", "k": "4",
                            "m": "2"})
            io = client.ioctx(pool)
            acked = {}
            for i in range(12):
                data = (f"indep-{i}-".encode() * 700)[:5000 + 97 * i]
                await io.write_full(f"o{i}", data)
                acked[f"o{i}"] = data
            dmn = DaemonInjector(cluster)
            await dmn.kill_osd(victim)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 30
            m = cluster.mon.osdmap
            while m.osd_up[victim] or m.osd_weight[victim]:
                assert loop.time() < deadline, "never down and out"
                await asyncio.sleep(0.1)
                m = cluster.mon.osdmap
            failures = await inv.check_acting(cluster, timeout=60)
            failures += await inv.check_durability(io, acked, timeout=60)
            deadline = loop.time() + 30
            while cluster.mon.osdmap.pg_temp and loop.time() < deadline:
                await asyncio.sleep(0.1)
            m = cluster.mon.osdmap
            absent = []
            for oid in acked:
                pgid = client.objecter.object_pgid(pool, oid)
                _, _, acting, _ = m.pg_to_up_acting_osds(pgid)
                assert victim not in acting
                absent += [(oid, o) for o in acting
                           if o != CRUSH_ITEM_NONE and cluster.osds[
                               o].store.stat(_coll(pgid), oid) is None]
            return failures, dict(m.pg_temp), absent
        finally:
            await cluster.stop()

    failures, pg_temp, absent = run(case())
    assert failures == []
    assert pg_temp == {}
    assert absent == []


# ------------------------- a shard member never acks past a gap in its log


class _Conn:
    """The primary's end of a sub-write: records the replies it is sent."""

    def __init__(self):
        self.replies = []

    async def send(self, msg):
        self.replies.append(msg)


def test_ec_member_refuses_a_client_sub_write_past_a_gap_in_its_log():
    """ROADMAP §C: an EC member that missed a client sub-write (a
    dropped batch item) must not apply a later one of the same PG.  The
    reference's member applies it: its log head then claims an object it
    does not hold, peering (which compares heads) pushes nothing, the
    primary's watermark passes the failed entry, and ``batch-smoke`` at
    seed 31 lost acked objects under a loaded CPU.  The port's member
    refuses the gapped sub-write (result -11, alone or in a batch frame)
    and keeps its head; a contiguous one still applies."""
    import time

    from ceph_tpu_torch.cluster import messages as M
    from ceph_tpu_torch.cluster.pg import _coll
    from ceph_tpu_torch.cluster.pglog import LogEntry
    from ceph_tpu_torch.cluster.vstart import start_cluster

    async def case():
        cluster = await start_cluster(3, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "gap", "erasure", pg_num=4,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van", "k": "2",
                            "m": "1"})
            io = client.ioctx(pool)
            await io.write_full("a", b"a" * 3000)
            pgid = client.objecter.object_pgid(pool, "a")
            _, _, acting, _ = cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
            member = cluster.osds[acting[1]]
            st = member.pgs[pgid]
            head = st.last_update
            blob = member.store.read_planar(_coll(pgid), "a")
            layout = member.store.object_layout(_coll(pgid), "a")

            def sub(oid, seq, prior, n):
                entry = LogEntry(op="modify", oid=oid,
                                 version=(head[0], seq),
                                 prior_version=(head[0], prior))
                return M.MOSDECSubOpWrite(
                    reqid=("gap", n), pgid=pgid, oid=oid, shard=1,
                    data=blob, chunk_off=0, shard_size=None,
                    hinfo={"size": 3000, "version": seq}, entry=entry,
                    epoch=cluster.mon.osdmap.epoch,
                    deadline=time.time() + 60, layout=layout)

            out = {}
            conn = _Conn()
            # head+2 follows head+1, which never arrived: a gap
            await member._handle_ec_write(conn, sub("g1", head[1] + 2,
                                                    head[1] + 1, 1))
            out["single"] = ([r.result for r in conn.replies],
                             st.last_update == head,
                             member.store.stat(_coll(pgid), "g1"))
            conn = _Conn()
            await member._handle_ec_write_batch(conn, M.MOSDECSubOpWriteBatch(
                items=[sub("g2", head[1] + 3, head[1] + 2, 2)]))
            out["batch"] = (conn.replies[0].results,
                            st.last_update == head,
                            member.store.stat(_coll(pgid), "g2"))
            conn = _Conn()
            await member._handle_ec_write(conn, sub("c1", head[1] + 1,
                                                    head[1], 3))
            out["contiguous"] = ([r.result for r in conn.replies],
                                 st.last_update == (head[0], head[1] + 1))
            return out
        finally:
            await cluster.stop()

    out = run(case())
    assert out["single"] == ([-11], True, None)
    assert out["batch"] == ([(("gap", 2), -11, 1)], True, None)
    assert out["contiguous"] == ([0], True)


def test_a_shed_ec_sub_write_does_not_wedge_the_pg():
    """A member that sheds a client sub-write (its deadline passed) opens
    a gap that it refuses later sub-writes across: the primary must
    resync it without waiting for a map change, so a later write to the
    PG is acked with no map change between and every object reads back.  The
    refused op itself queues the resync: the primary's drained-frontier
    re-arm is switched off here, as a steady pipelined stream that never
    drains the frontier leaves it."""
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    async def case():
        cfg = _fast_config()
        # no false downs on a loaded worker: the epoch must stay put
        cfg.osd_heartbeat_grace = cfg.mon_osd_beacon_grace = 30.0
        cluster = await start_cluster(3, config=cfg, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "shed", "erasure", pg_num=1,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van", "k": "2",
                            "m": "1"})
            io = client.ioctx(pool)
            await io.write_full("a", b"a" * 3000)
            pgid = client.objecter.object_pgid(pool, "a")
            _, _, acting, primary = \
                cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
            member = cluster.osds[next(o for o in acting if o != primary)]
            real, shed = member._sub_op_expired, []

            def expire_b_once(msg):
                if getattr(msg, "oid", None) == "b" and not shed:
                    shed.append(msg.reqid)
                    msg.deadline = 0.0   # a deadline already past
                return real(msg)

            member._sub_op_expired = expire_b_once
            cluster.osds[primary]._frontier_rearm_if_short = \
                lambda st: None
            epoch = cluster.mon.osdmap.epoch
            try:
                await io.write_full("b", b"b" * 3000)
                b_acked = True
            except OSError:
                b_acked = False
            # the client retries a write that failed, as the load
            # driver's clients do; the PG must take it within the
            # primary's recovery backoff, with no map change
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 15
            while True:
                try:
                    await io.write_full("c", b"c" * 3000)
                    break
                except OSError:
                    assert loop.time() < deadline, "the PG takes no writes"
                    await asyncio.sleep(0.2)
            got = {o: await io.read(o) for o in
                   (("a", "b", "c") if b_acked else ("a", "c"))}
            # epochs that change the map itself, not only the cluster log
            changed = [e for e in range(epoch + 1,
                                        cluster.mon.osdmap.epoch + 1)
                       if any(v for k, v in vars(
                           cluster.mon._inc_log[e]).items()
                           if k not in ("epoch", "new_log_entries"))]
            return (len(shed), changed,
                    member.perf.get("osd_sub_ops_shed_expired"),
                    {o: d[:1] * len(d) == d for o, d in got.items()})
        finally:
            await cluster.stop()

    n_shed, changed, shed_count, reads = run(case(), bound=60.0)
    assert (n_shed, changed, shed_count) == (1, [], 1)
    assert set(reads) >= {"a", "c"} and all(reads.values())


def test_a_failed_delta_push_stops_the_member_replay(tmp_path):
    """ROADMAP §C: a member behind by two objects whose first push
    fails must not take the second.  The reference's primary pushes on:
    the member's head then passes the object it lacks, no later round
    (which compares heads) pushes it, and the PG reads clean with a
    member short of a shard (``batch-smoke`` at seed 31 under a loaded
    CPU left an acting member without an acked object).  The port's
    primary stops the replay; its retry pushes both."""
    from ceph_tpu_torch.cluster.filestore import FileStore
    from ceph_tpu_torch.cluster.pg import _coll
    from ceph_tpu_torch.cluster.vstart import start_cluster

    async def case():
        cluster = await start_cluster(
            3, device="cpu",
            store_factory=lambda o: FileStore(str(tmp_path / f"osd{o}")))
        try:
            client = await cluster.client()
            pool = await client.pool_create(
                "replay", "erasure", pg_num=1,
                ec_profile={"plugin": "jerasure",
                            "technique": "reed_sol_van", "k": "2",
                            "m": "1"})
            io = client.ioctx(pool)
            await io.write_full("a", b"a" * 3000)
            pgid = client.objecter.object_pgid(pool, "a")
            _, _, acting, primary = \
                cluster.mon.osdmap.pg_to_up_acting_osds(pgid)
            member = next(o for o in acting if o != primary)
            await cluster.kill_osd(member)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20
            while cluster.mon.osdmap.osd_up[member]:
                assert loop.time() < deadline, "never down"
                await asyncio.sleep(0.05)
            await io.write_full("b", b"b" * 3000)
            await io.write_full("c", b"c" * 3000)
            prim = cluster.osds[primary]
            real, failed = prim._push_object, []

            async def flaky(pool_, st, osd, oid, entry):
                if oid == "b" and not failed:
                    failed.append(osd)
                    return False
                return await real(pool_, st, osd, oid, entry)

            prim._push_object = flaky
            await cluster.revive_osd(member, with_store=True)
            coll = _coll(pgid)
            deadline = loop.time() + 30
            while True:
                store = cluster.osds[member].store
                held = {o for o in ("a", "b", "c")
                        if store.stat(coll, o) is not None}
                st = prim.pgs[pgid]
                if held == {"a", "b", "c"} and \
                        st.last_complete == st.last_update:
                    break
                if loop.time() > deadline:
                    break
                await asyncio.sleep(0.1)
            return failed == [member], held
        finally:
            await cluster.stop()

    assert run(case()) == (True, {"a", "b", "c"})
