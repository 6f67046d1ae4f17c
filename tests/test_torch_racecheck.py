"""The port's race tracker (``ceph_tpu_torch/analysis/racecheck.py``)
against ``ceph_tpu``'s: the cases of ``tests/test_racecheck.py`` that need
no scenario runner.

Each case drives both packages' trackers through the same probe sequence
and compares their findings and reports, without the probe sites and
stacks (file paths differ between the packages).  The boot case starts a
cluster of each package with ``race_check_enabled=1`` under its own
deadline.  The seeded race runs (``race_run``) wait for the port's
scenario layer.
"""

import asyncio
import re

import pytest

import ceph_tpu.analysis.racecheck as jracecheck
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.analysis.racecheck as racecheck
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.lockdep as lockdep
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    BOUND, PORT, REF, _one_torch_thread, _port_lockdep_reset)

PKGS = [(racecheck, lockdep), (jracecheck, jlockdep)]


_AUTO_NAME = re.compile(r"Task-\d+")


def norm(findings):
    """Findings without probe sites and stacks, and with asyncio's
    numbered default task names (their counter is process-wide) as
    ``Task``."""
    def name(s):
        return _AUTO_NAME.sub("Task", s)

    return [{**f, "message": name(f["message"]),
             **{side: {k: name(v) if k == "task" else v
                       for k, v in f[side].items()
                       if k not in ("site", "stack")}
                for side in ("read", "write")}}
            for f in findings]


def both(case):
    """``case(racecheck, lockdep)`` for the port, then the reference;
    their normalized findings must be equal.  Returns the port's."""
    got, ref = (norm(case(rc, ld)) for rc, ld in PKGS)
    assert got == ref
    return got


# ----------------------------------------------------- NULL_RACE contract


@pytest.mark.parametrize("rc", [racecheck, jracecheck],
                         ids=["port", "ref"])
def test_null_race_noop_contract(rc):
    """Default-off is a provable no-op: falsy, slotless (retains
    nothing), constant report, and it IS the module default."""
    NULL_RACE = rc.NULL_RACE
    assert rc.TRACKER is NULL_RACE
    assert not NULL_RACE
    assert NULL_RACE.enabled is False
    assert rc._NullRace.__slots__ == ()
    with pytest.raises(AttributeError):
        NULL_RACE.anything = 1
    NULL_RACE.note_read(("pg", 0, "1.0"), "self_info")
    NULL_RACE.note_write(("pg", 0, "1.0"), "self_info")
    NULL_RACE.advance_tick()
    assert NULL_RACE.findings() == []
    assert NULL_RACE.report() == {"enabled": False, "seed": 0,
                                  "ticks": 0, "reads": 0, "writes": 0,
                                  "findings": []}
    assert NULL_RACE.report() == jracecheck.NULL_RACE.report()


def test_from_config_gates_on_race_check_enabled():
    for rc, Config in ((racecheck, config.Config),
                       (jracecheck, jconfig.Config)):
        cfg = Config()
        assert cfg.race_check_enabled == 0
        assert rc.from_config(cfg) is rc.NULL_RACE
        cfg.race_check_enabled = 1
        cfg.race_check_seed = 5
        t = rc.from_config(cfg)
        assert isinstance(t, rc.RaceTracker)
        assert t.seed == 5


def test_install_swaps_and_restores_the_probe_target():
    for rc in (racecheck, jracecheck):
        t = rc.RaceTracker(seed=2)
        prev = rc.install(t)
        try:
            assert prev is rc.NULL_RACE and rc.TRACKER is t
        finally:
            rc.uninstall()
        assert rc.TRACKER is rc.NULL_RACE


# ------------------------------------------------------------ the tracker


def test_tracker_convicts_cross_task_write_after_read():
    def case(rc, ld):
        t = rc.RaceTracker(seed=3)

        async def main():
            wrote = asyncio.Event()

            async def reader():
                t.note_read(("pg", 0, "1.0"), "self_info")
                await wrote.wait()      # finishes WITHOUT re-reading

            async def writer():
                await asyncio.sleep(0)
                t.note_write(("pg", 0, "1.0"), "self_info")
                wrote.set()

            rt = asyncio.get_event_loop().create_task(reader(),
                                                      name="recovery-round")
            wt = asyncio.get_event_loop().create_task(writer(),
                                                      name="commit-entry")
            await asyncio.gather(rt, wt)
            return t.findings()

        found = asyncio.run(main())
        assert len(found) == 1
        f = found[0]
        assert f["rule"] == "write-after-read"
        assert "recovery-round" in f["message"]
        assert "commit-entry" in f["message"]
        # both probes attributed: task, site, stack
        assert f["read"]["task"] == "recovery-round" and f["read"]["stack"]
        assert f["write"]["task"] == "commit-entry" and f["write"]["stack"]
        return found

    assert len(both(case)) == 1


def _reread(rc, ld):
    t = rc.RaceTracker()

    async def main():
        wrote = asyncio.Event()

        async def reader():
            t.note_read(("pg", 0, "1.0"), "self_info")
            await wrote.wait()
            t.note_read(("pg", 0, "1.0"), "self_info")   # the refresh

        async def writer():
            await asyncio.sleep(0)
            t.note_write(("pg", 0, "1.0"), "self_info")
            wrote.set()

        await asyncio.gather(asyncio.ensure_future(reader()),
                             asyncio.ensure_future(writer()))
        return t.findings()

    return asyncio.run(main())


def test_tracker_reread_revalidates():
    """A re-read AFTER the write is exactly what a fix looks like (the
    self-info refresh, the PG identity recheck): no conviction."""
    assert both(_reread) == []


def test_tracker_common_lock_suppresses():
    """Reader and writer holding a shared DepLock at their probes were
    serialized by it — no interleaving to convict."""
    def case(rc, ld):
        t = rc.RaceTracker()

        async def main():
            wrote = asyncio.Event()

            async def reader():
                ld.DepLock._held[id(asyncio.current_task())] = ["pg:1.0"]
                t.note_read(("pgs", 0, "1.0"), "registry")
                await wrote.wait()

            async def writer():
                await asyncio.sleep(0)
                ld.DepLock._held[id(asyncio.current_task())] = ["pg:1.0"]
                t.note_write(("pgs", 0, "1.0"), "registry")
                wrote.set()

            await asyncio.gather(asyncio.ensure_future(reader()),
                                 asyncio.ensure_future(writer()))
            return t.findings()

        try:
            return asyncio.run(main())
        finally:
            ld.DepLock._held.clear()

    assert both(case) == []


def test_tracker_cancelled_reader_never_convicts():
    """Chaos kills cancel in-flight commit tasks; a cancelled reader
    unwound without acting on its snapshot."""
    def case(rc, ld):
        t = rc.RaceTracker()

        async def main():
            async def reader():
                t.note_read(("pgs", 0, "1.0"), "registry")
                # not a timing guess: park forever so cancel() is the
                # only way out — the cancelled-reader shape under test
                await asyncio.Event().wait()

            rt = asyncio.get_event_loop().create_task(reader())
            await asyncio.sleep(0)
            t.note_write(("pgs", 0, "1.0"), "registry")
            rt.cancel()
            try:
                await rt
            except asyncio.CancelledError:
                pass
            return t.findings()

        return asyncio.run(main())

    assert both(case) == []


def test_tracker_own_write_neither_convicts_nor_revalidates():
    """A task's own write doesn't convict it (no interleaving), but its
    local snapshot is STILL stale — the record must stand so a later
    cross-task write convicts (the single-task half of the self-info
    bug)."""
    def case(rc, ld):
        t = rc.RaceTracker()

        async def main():
            wrote = asyncio.Event()

            async def reader():
                t.note_read(("pg", 0, "1.0"), "self_info")
                t.note_write(("pg", 0, "1.0"), "self_info")   # own write
                await wrote.wait()

            async def writer():
                await asyncio.sleep(0)
                t.note_write(("pg", 0, "1.0"), "self_info")
                wrote.set()

            await asyncio.gather(asyncio.ensure_future(reader()),
                                 asyncio.ensure_future(writer()))
            return t.findings()

        return asyncio.run(main())

    assert len(both(case)) == 1, "record was dropped by the task's own write"


def test_tracker_report_counts_probes_and_ticks():
    def case(rc, ld):
        t = rc.RaceTracker(seed=4)
        t.advance_tick()
        t.advance_tick()

        async def main():
            t.note_read(("k",), "f")
            t.note_write(("k",), "f")

        asyncio.run(main())
        rep = t.report()
        assert (rep["ticks"], rep["reads"], rep["writes"]) == (2, 1, 1)
        return {k: v for k, v in rep.items() if k != "findings"}

    got, ref = (case(rc, ld) for rc, ld in PKGS)
    assert got == ref == {"enabled": True, "seed": 4, "ticks": 2,
                          "reads": 1, "writes": 1, "pending_open": 0}


# ---------------- the two bug classes the probes guard, at runtime


def _recovery_shape(refresh: bool):
    """A recovery round snapshots self-info, awaits peer queries, and
    (fixed) re-reads after the await; a concurrent commit advances the
    log head meanwhile."""
    def case(rc, ld):
        t = rc.RaceTracker()

        async def main():
            advanced = asyncio.Event()

            async def recovery_round():
                t.note_read(("pg", 0, "1.0"), "self_info")    # round start
                await advanced.wait()                          # peer query
                if refresh:
                    t.note_read(("pg", 0, "1.0"), "self_info")  # the fix
                # ... elects an authority from infos and returns

            async def commit():
                await asyncio.sleep(0)
                t.note_write(("pg", 0, "1.0"), "self_info")   # log head +1
                advanced.set()

            await asyncio.gather(asyncio.ensure_future(recovery_round()),
                                 asyncio.ensure_future(commit()))
            return t.findings()

        return asyncio.run(main())

    return both(case)


def test_stale_selfinfo_shape_convicts():
    assert len(_recovery_shape(refresh=False)) == 1


def test_refreshed_selfinfo_shape_is_quiet():
    assert _recovery_shape(refresh=True) == []


def _commit_shape(recheck: bool):
    """A commit opens against the PGState it pulled from the registry,
    awaits acks, and (fixed) re-checks registry identity at resolve
    time; peering replaces the entry meanwhile."""
    def case(rc, ld):
        t = rc.RaceTracker()

        async def main():
            replaced = asyncio.Event()

            async def commit():
                t.note_read(("pgs", 0, "1.0"), "registry")    # frontier open
                await replaced.wait()                          # ack wait
                if recheck:
                    t.note_read(("pgs", 0, "1.0"), "registry")
                # ... advances the watermark on the snapshot it held

            async def map_apply():
                await asyncio.sleep(0)
                t.note_write(("pgs", 0, "1.0"), "registry")   # replaced
                replaced.set()

            await asyncio.gather(asyncio.ensure_future(commit()),
                                 asyncio.ensure_future(map_apply()))
            return t.findings()

        return asyncio.run(main())

    return both(case)


def test_superseded_pgstate_shape_convicts():
    assert len(_commit_shape(recheck=False)) == 1


def test_identity_recheck_shape_is_quiet():
    assert _commit_shape(recheck=True) == []


# --------------------------------------------- the tracker in a cluster


def test_admin_race_report_command():
    """``race report`` serves the tracker's report, and the disabled
    payload (never an error) when no tracker is installed."""
    from ceph_tpu_torch.utils.admin_socket import AdminSocket
    from ceph_tpu_torch.utils.perf import PerfCounters

    sock = AdminSocket()
    sock.register_common(PerfCounters("t"))
    res, data = asyncio.run(sock.dispatch({"prefix": "race report"}))
    assert res == 0 and data == jracecheck.NULL_RACE.report()
    prev = racecheck.install(racecheck.RaceTracker(seed=9))
    try:
        res, data = asyncio.run(sock.dispatch({"prefix": "race report"}))
        assert res == 0 and data["enabled"] is True and data["seed"] == 9
    finally:
        racecheck.install(prev)


def test_boot_arms_tracker_from_config():
    """``race_check_enabled=1`` arms the process-global tracker at
    vstart boot (seeded from ``race_check_seed``), live I/O moves the
    probe counters, and ``race report`` serves them, in both packages;
    a default boot leaves NULL_RACE installed."""
    async def scenario(P, rc):
        cfg = P.imp("cluster.vstart._fast_config")()
        cfg.set("race_check_enabled", 1)
        cfg.set("race_check_seed", 7)
        cluster = await P.imp("cluster.vstart.start_cluster")(3, config=cfg)
        try:
            assert rc.TRACKER.enabled
            client = await cluster.client()
            pool = await client.pool_create("p", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            await io.write_full("obj", b"x" * 512)
            assert await io.read("obj") == b"x" * 512
            return await cluster.daemon_command("osd.0", "race report")
        finally:
            await cluster.stop()
            rc.uninstall()

    for P, rc in ((PORT, racecheck), (REF, jracecheck)):
        assert rc.TRACKER is rc.NULL_RACE
        try:
            rep = asyncio.run(asyncio.wait_for(scenario(P, rc), BOUND))
        finally:
            rc.uninstall()
        assert rep["enabled"] is True and rep["seed"] == 7
        assert rep["reads"] > 0 and rep["writes"] > 0
        assert rep["findings"] == [], rep["findings"]
        assert rc.TRACKER is rc.NULL_RACE


# ------------------------------------------- regression: frontier re-arm


def test_frontier_rearm_when_drained_short():
    """Every open frontier entry resolved (some ok=False — their acks
    died with a crashed peer) leaves the pipeline DRAINED with the
    watermark short of the log head, and no later ack or map change is
    coming — without a re-arm the primary is incomplete forever on an
    idle pool.  _frontier_done must arm the recovery retry exactly then.
    Both packages' PG mixins, the same states."""
    def case(P):
        PGState = P.imp("cluster.pg.PGState")
        PGid = P.imp("osdmap.osdmap.PGid")

        class _Store:
            def omap_get(self, coll, oid):
                return {}

            def queue_transaction(self, txn):
                pass

        class _Host(P.imp("cluster.pg.PGLogMixin")):
            osd_id = 0

            def __init__(self):
                self.store = _Store()
                self.perf = P.imp("utils.PerfCounters")("t")
                self.retries = []

            def _queue_recovery_retry(self, st):
                self.retries.append(st)

        h = _Host()
        st = PGState(PGid(1, 0))
        st.primary = 0
        for v in ((1, 1), (1, 2)):
            h._frontier_open(st, v)
        st.last_update = (1, 2)
        h._frontier_done(st, (1, 1), ok=True)
        assert h.retries == []          # (1,2) still open: not drained
        h._frontier_done(st, (1, 2), ok=False)   # acks lost: resolves dirty
        assert not st.pipeline_pending
        assert st.last_complete == (1, 1) and st.last_update == (1, 2)
        assert h.retries == [st], "drained-short frontier did not re-arm"

        # watermark AT the head after a clean drain: no spurious re-arm
        h2 = _Host()
        st2 = PGState(PGid(1, 1))
        st2.primary = 0
        h2._frontier_open(st2, (1, 1))
        st2.last_update = (1, 1)
        h2._frontier_done(st2, (1, 1), ok=True)
        assert h2.retries == []

        # a REPLICA never self-arms (peering is primary-driven)
        h3 = _Host()
        st3 = PGState(PGid(1, 2))
        st3.primary = 7
        h3._frontier_open(st3, (1, 1))
        st3.last_update = (1, 1)
        h3._frontier_done(st3, (1, 1), ok=False)
        assert h3.retries == []
        return [(s.last_update, s.last_complete, list(s.pipeline_pending))
                for s in (st, st2, st3)]

    assert case(PORT) == case(REF)


# --------------------------------- regression: planar rewind attr restore


def test_planar_rewind_restores_attrs_and_version():
    """Rewinding a divergent planar-at-rest write must roll back the
    size/hinfo_crc/version attrs with the PLANES: old data under a new
    crc fails verify-on-read on every later gather.  Both packages' EC
    backends, the same stored bytes and attrs."""
    def case(P):
        planar_store = P.imp("ec.planar_store")
        PGState = P.imp("cluster.pg.PGState")
        LogEntry = P.imp("cluster.pglog.LogEntry")
        PGLog = P.imp("cluster.pglog.PGLog")
        MemStore = P.imp("cluster.store.MemStore")
        Transaction = P.imp("cluster.store.Transaction")
        PGid = P.imp("osdmap.osdmap.PGid")

        class _Host(P.imp("cluster.backend_ec.ECBackendMixin"),
                    P.imp("cluster.pg.PGLogMixin")):
            osd_id = 0

            def __init__(self):
                self.store = MemStore()
                self.perf = P.imp("utils.PerfCounters")("t")

        h = _Host()
        pgid = PGid(1, 0)
        coll = f"pg_{pgid.pool}_{pgid.seed}"
        h.store.queue_transaction(Transaction().create_collection(coll))

        def planar_blob(byte: bytes, n: int) -> bytes:
            return planar_store.planes_to_blob(
                planar_store.shard_to_planes(byte * n, seam=None))

        # v1: the committed generation (64-byte shard, logical size 120)
        h._apply_shard(pgid, "obj", 0, planar_blob(b"A", 64), 0, 64,
                       {"size": 120, "version": 1},
                       layout=planar_store.LAYOUT_PLANAR)
        v1_planes = h.store.read_planar(coll, "obj")
        v1_attrs = {k: h.store.getattr(coll, "obj", k)
                    for k in ("shard", "size", "hinfo_crc")}
        assert v1_attrs["hinfo_crc"] is not None

        # v2: the divergent write (different bytes AND size)
        h._apply_shard(pgid, "obj", 0, planar_blob(b"B", 72), 0, 72,
                       {"size": 130, "version": 2},
                       layout=planar_store.LAYOUT_PLANAR)
        assert h.store.getattr(coll, "obj", "size") == b"130"
        assert h.store.getattr(coll, "obj", "hinfo_crc") != \
            v1_attrs["hinfo_crc"]

        st = PGState(pgid)
        st.log = PGLog(entries=[
            LogEntry(op="modify", oid="obj", version=(1, 1)),
            LogEntry(op="modify", oid="obj", version=(1, 2))])
        st.last_update = (1, 2)
        h.rewind_divergent_log(st, (1, 1))

        assert h.store.read_planar(coll, "obj") == v1_planes
        assert h.store.object_layout(coll, "obj") == \
            planar_store.LAYOUT_PLANAR
        for name, want in v1_attrs.items():
            assert h.store.getattr(coll, "obj", name) == want, \
                f"attr {name!r} not rolled back with the planes"
        assert h.store.get_version(coll, "obj") == 1
        return v1_planes, v1_attrs

    assert case(PORT) == case(REF)
