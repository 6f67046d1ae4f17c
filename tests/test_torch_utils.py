"""The port's host foundation against ``ceph_tpu``'s: ``utils/``,
``chaos/{rng,counters}`` and ``cluster/auth``.

Each case drives the port's module and the reference module with the same
seeded inputs and update sequences and requires equal outputs: perf
dumps, schemas and histograms; the ``Option`` tables and ``set``'s
validation errors; backoff and AIMD sequences; compressor bytes; lockdep
graphs and cycle errors; chaos rng streams and counters; schedfuzz
traces; admin-socket replies; auth key derivation, sealed boxes and
tickets.  The cases of ``tests/test_perf_counters.py``,
``test_backoff.py``, ``test_aux_components.py`` and ``test_racecheck.py``
that need no cluster run here against the port too.
"""

import asyncio
import json
import random
import threading
import types

import numpy as np
import pytest

import ceph_tpu.chaos.counters as jcounters
import ceph_tpu.chaos.rng as jrng
import ceph_tpu.cluster.auth as jauth
import ceph_tpu.utils.admin_socket as jasok
import ceph_tpu.utils.backoff as jbackoff
import ceph_tpu.utils.compressor as jcompressor
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.deadline as jdeadline
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu.utils.perf as jperf
import ceph_tpu.utils.schedfuzz as jschedfuzz
import ceph_tpu.utils.tasks as jtasks
import ceph_tpu.trace.flight as jflight
import ceph_tpu_torch.chaos.counters as counters
import ceph_tpu_torch.chaos.rng as rng
import ceph_tpu_torch.cluster.auth as auth
import ceph_tpu_torch.utils.admin_socket as asok
import ceph_tpu_torch.utils.backoff as backoff
import ceph_tpu_torch.utils.compressor as compressor
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.deadline as deadline
import ceph_tpu_torch.utils.lockdep as lockdep
import ceph_tpu_torch.utils.perf as perf
import ceph_tpu_torch.utils.schedfuzz as schedfuzz
import ceph_tpu_torch.utils.tasks as tasks
import ceph_tpu_torch.trace.flight as flight
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(
    perf=jperf, config=jconfig, backoff=jbackoff, compressor=jcompressor,
    lockdep=jlockdep, rng=jrng, counters=jcounters, schedfuzz=jschedfuzz,
    asok=jasok, auth=jauth, deadline=jdeadline, tasks=jtasks,
    flight=jflight)
PORT = types.SimpleNamespace(
    perf=perf, config=config, backoff=backoff, compressor=compressor,
    lockdep=lockdep, rng=rng, counters=counters, schedfuzz=schedfuzz,
    asok=asok, auth=auth, deadline=deadline, tasks=tasks, flight=flight)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _port_lockdep_reset():
    """The port's lock graph is process-wide like the reference's (which
    the test configuration resets between tests): reset it too."""
    lockdep.LockDep.instance().reset()
    lockdep.DepLock._held.clear()
    yield
    lockdep.LockDep.instance().reset()
    lockdep.DepLock._held.clear()


# ---------------------------------------------------------------- perf


def perf_sequence(pm, seed: int):
    """A seeded update sequence over every counter kind; returns every
    dump surface."""
    r = np.random.default_rng(seed)
    pc = pm.PerfCounters("d")
    pc.add_u64("ops", unit=pm.UNIT_NONE, prio=pm.PRIO_CRITICAL,
               desc="ops served")
    pc.add_u64("bytes", unit=pm.UNIT_BYTES, prio=pm.PRIO_USEFUL)
    pc.add_time("lat", prio=pm.PRIO_INTERESTING, desc="op latency")
    pc.add_histogram("lat_hist", buckets=16, scale=1e6,
                     unit=pm.UNIT_SECONDS, prio=pm.PRIO_CRITICAL)
    for step in range(300):
        kind = int(r.integers(0, 6))
        if kind == 0:
            pc.inc("ops", int(r.integers(1, 9)))
        elif kind == 1:
            pc.inc("bytes", int(r.integers(0, 1 << 20)))
        elif kind == 2:
            pc.tinc("lat", float(r.random()) / 100)
        elif kind == 3:
            pc.hinc("lat_hist", float(r.random()) / 10)
        elif kind == 4:
            pc.hinc("sizes", int(r.integers(0, 1 << 30)))
        else:
            pc.set("gauge", int(r.integers(0, 100)))
        if step == 200:
            pc.reset()
    coll = pm.PerfCountersCollection()
    coll.register(pc, shared=False)
    other = coll.create("osd.1")
    other.inc("x", 3)
    other.tinc("t", 0.5)
    return (pc.dump(), pc.dump_schema(), pc.dump_histograms(),
            pc.dump_critical(), coll.dump(), coll.dump_schema(),
            coll.dump_histograms(), coll.dump_critical(pm.PRIO_CRITICAL))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perf_dumps_equal_reference(seed):
    assert perf_sequence(perf, seed) == perf_sequence(jperf, seed)


def test_perf_constants_and_kernels_equal_reference():
    for name in ("UNIT_NONE", "UNIT_BYTES", "UNIT_SECONDS", "PRIO_CRITICAL",
                 "PRIO_INTERESTING", "PRIO_USEFUL", "PRIO_DEBUGONLY"):
        assert getattr(perf, name) == getattr(jperf, name)
    assert perf.KERNELS.name == jperf.KERNELS.name == "device_kernels"
    h, jh = perf.PerfHistogram(buckets=12, scale=3.0), \
        jperf.PerfHistogram(buckets=12, scale=3.0)
    for v in np.random.default_rng(9).random(200) * 5000:
        h.add(float(v))
        jh.add(float(v))
    assert h.dump() == jh.dump()


def test_kernels_call_sites_keep_working():
    """The port's KERNELS call sites (codecs, mapper, profiling's tinc)
    book into the widened registry as before, and a collection folds it
    in as a shared registry."""
    from ceph_tpu_torch.ec import factory

    perf.KERNELS.reset()
    codec = factory({"plugin": "isa", "k": "4", "m": "2"}, device="cpu")
    codec.encode_batch(np.zeros((2, 4, 64), dtype=np.uint8))
    perf.KERNELS.tinc("t_probe", 0.5)
    d = perf.KERNELS.dump()["device_kernels"]
    assert d["ec_matmul_calls"] == 1 and d["ec_matmul_bytes"] == 512
    assert d["t_probe"]["avgcount"] == 1
    coll = perf.PerfCountersCollection()
    coll.register(perf.KERNELS)
    coll.reset()
    assert perf.KERNELS.get("ec_matmul_calls") == 1
    assert coll.dump_schema()["device_kernels"]["t_probe"]["type"] == \
        "time_avg"
    perf.KERNELS.reset()


@BOTH
def test_u64_and_time_counters(pkg):
    pm = pkg.perf
    pc = pm.PerfCounters("d")
    pc.add_u64("ops", unit=pm.UNIT_NONE, prio=pm.PRIO_CRITICAL,
               desc="ops served")
    pc.inc("ops", 3)
    pc.tinc("lat", 0.25)
    pc.tinc("lat", 0.75)
    d = pc.dump()["d"]
    assert d["ops"] == 3
    assert d["lat"] == {"avgcount": 2, "sum": 1.0, "last": 0.75,
                        "min": 0.25, "max": 0.75}
    schema = pc.dump_schema()["d"]
    assert schema["ops"]["priority"] == pm.PRIO_CRITICAL
    assert schema["ops"]["type"] == "u64"
    assert schema["lat"]["type"] == "time_avg"
    assert schema["lat"]["unit"] == pm.UNIT_SECONDS
    with pc.time("blk"):
        pass
    assert pc.dump()["d"]["blk"]["avgcount"] == 1


@BOTH
def test_histogram_buckets_scale_and_reset(pkg):
    h = pkg.perf.PerfHistogram(buckets=8, scale=1.0)
    for v in (0, 1, 2, 3, 500, 10 ** 9):
        h.add(v)
    d = h.dump()
    assert d["count"] == 6
    assert d["buckets"][0] == 2 and d["buckets"][1] == 2
    assert d["buckets"][7] == 2
    assert d["lower_bounds"][:3] == [0, 2, 4]
    pc = pkg.perf.PerfCounters("d")
    pc.add_histogram("lat_hist", buckets=16, scale=1e6,
                     unit=pkg.perf.UNIT_SECONDS)
    pc.hinc("lat_hist", 0.000001)
    pc.hinc("lat_hist", 0.001)
    d = pc.dump()["d"]["lat_hist"]
    assert d["buckets"][0] == 1 and d["buckets"][9] == 1
    pc.reset()
    d = pc.dump()["d"]["lat_hist"]
    assert d["count"] == 0 and sum(d["buckets"]) == 0
    pc.hinc("adhoc", 7)
    assert pc.dump()["d"]["adhoc"]["count"] == 1
    json.dumps(pc.dump())
    json.dumps(pc.dump_schema())


@BOTH
def test_collection_thread_safety_remove_and_shared_reset(pkg):
    coll = pkg.perf.PerfCountersCollection()
    errors = []

    def churn(i):
        try:
            for j in range(200):
                pc = coll.create(f"d{i}_{j}")
                pc.inc("x")
                coll.dump()
                coll.remove(f"d{i}_{j}")
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and coll.dump() == {}
    own = coll.create("osd.9")
    own.inc("ops", 5)
    shared = pkg.perf.PerfCounters("device_kernels_test")
    shared.inc("calls", 7)
    coll.register(shared)
    coll.reset()
    assert own.get("ops") == 0 and shared.get("calls") == 7
    coll.register(shared, shared=False)
    coll.reset()
    assert shared.get("calls") == 0
    assert coll.get("osd.9") is own
    coll.remove("osd.9")
    assert coll.get("osd.9") is None


def test_perf_counters_count_exactly_across_threads():
    """More threads than cores and a short switch interval: a lost update
    of ``inc``, ``tinc`` or ``hinc`` would show in the totals."""
    import sys

    pc = perf.PerfCounters("mt")

    def bump():
        for _ in range(3000):
            pc.inc("n")
            pc.tinc("t", 0.5)
            pc.hinc("h", 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    d = pc.dump()["mt"]
    assert d["n"] == 48000 and d["t"]["avgcount"] == 48000
    assert d["t"]["sum"] == 24000.0 and d["h"]["count"] == 48000


# -------------------------------------------------------------- config


def test_option_tables_equal_reference():
    mine = [(o.name, o.type, o.default, o.min, o.max)
            for o in config.OPTIONS]
    ref = [(o.name, o.type, o.default, o.min, o.max)
           for o in jconfig.OPTIONS]
    assert mine == ref
    assert config.Config().show() == jconfig.Config().show()
    names = {o.name for o in config.OPTIONS}
    assert {"osd_ec_mesh", "osd_ec_mesh_devices"} <= names
    assert config.Config().osd_ec_mesh == "off"


def _set_outcome(cfg_mod, name, value):
    cfg = cfg_mod.Config()
    try:
        cfg.set(name, value)
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        return type(e).__name__, str(e)
    return "ok", cfg.get(name)


def test_set_validation_equals_reference():
    cases = [("no_such_option", 1), ("osd_pool_default_size", 0),
             ("osd_pool_default_size", 17), ("osd_pool_default_size", "4"),
             ("debug_osd", 21), ("debug_osd", -1), ("osd_ec_mesh", "on"),
             ("osd_heartbeat_interval", "x"), ("osd_ec_mesh_devices", 2.9)]
    for o in config.OPTIONS:
        if o.min is not None:
            cases.append((o.name, o.min - 1))
            cases.append((o.name, o.min))
        if o.max is not None:
            cases.append((o.name, o.max + 1))
    for name, value in cases:
        assert _set_outcome(config, name, value) == \
            _set_outcome(jconfig, name, value), (name, value)


@BOTH
def test_config_observers_attrs_and_injectargs(pkg):
    cfg = pkg.config.Config(debug_osd=3)
    seen = []

    def obs(k, v):
        seen.append((k, v))

    cfg.add_observer(obs)
    cfg.osd_ec_mesh = "on"
    cfg.injectargs({"osd_ec_mesh_devices": 4, "debug_ms": "2"})
    cfg.remove_observer(obs)
    cfg.remove_observer(obs)
    cfg.debug_mon = 1
    assert seen == [("osd_ec_mesh", "on"), ("osd_ec_mesh_devices", 4),
                    ("debug_ms", 2)]
    assert cfg.debug_osd == 3 and cfg.show()["debug_mon"] == 1
    with pytest.raises(AttributeError):
        cfg.no_such_option
    assert cfg.auth_secret() is None
    assert cfg.cephx_context("osd.0") is None


# ------------------------------------------------------- backoff, AIMD


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_backoff_schedules_equal_reference(seed):
    for kw in ({}, {"base": 0.1, "cap": 10.0, "factor": 3.0}):
        a = backoff.ExpBackoff(rng=random.Random(seed), **kw)
        b = jbackoff.ExpBackoff(rng=random.Random(seed), **kw)
        assert a.schedule(12) == b.schedule(12)
        seq_a = [a.next() for _ in range(12)]
        seq_b = [b.next() for _ in range(12)]
        assert seq_a == seq_b
        a.reset()
        b.reset()
        assert a.next() == b.next()


@BOTH
def test_backoff_envelope_reset_and_preview(pkg):
    a = pkg.backoff.ExpBackoff(base=0.05, cap=1.0, rng=random.Random(7))
    sched = [a.next() for _ in range(8)]
    for n, d in enumerate(sched):
        assert 0.0 <= d <= min(1.0, 0.05 * 2 ** n)
    assert max(sched[4:]) > 0.05
    b = pkg.backoff.ExpBackoff(base=0.1, cap=10.0, factor=2.0,
                               rng=random.Random(3))
    for _ in range(6):
        b.next()
    b.reset()
    assert b.next() <= 0.1
    c = pkg.backoff.ExpBackoff(base=0.05, cap=1.0, rng=random.Random(11))
    assert c.schedule(5) == [c.next() for _ in range(5)]


def test_aimd_sequences_equal_reference():
    r = np.random.default_rng(5)
    a, b = backoff.AIMDWindow(64), jbackoff.AIMDWindow(64)
    seq = []
    for push in r.random(500) < 0.05:
        for w in (a, b):
            w.on_pushback() if push else w.on_ack()
        seq.append((a.window, a.limit, a.pushbacks))
        assert (a.window, a.limit, a.pushbacks) == \
            (b.window, b.limit, b.pushbacks)
    assert min(s[0] for s in seq) >= 1.0 and max(s[0] for s in seq) <= 64


@BOTH
def test_aimd_window_shape(pkg):
    w = pkg.backoff.AIMDWindow(64)
    assert w.limit == 64 and w.window == 64.0
    w.on_ack()
    assert w.window == 64.0
    w.on_pushback()
    assert w.window == 32.0 and w.pushbacks == 1
    for _ in range(10):
        w.on_pushback()
    assert w.window == 1.0
    before = w.window
    w.on_ack()
    assert before < w.window <= before + 1.0
    w2 = pkg.backoff.AIMDWindow(64)
    w2.on_pushback()
    for _ in range(32):
        w2.on_ack()
    assert 32.5 < w2.window < 34.0


# ----------------------------------------------------------- compressor


@pytest.mark.parametrize("name", ["zlib", "lzma", "bz2", "snappy"])
def test_compressor_roundtrip_bytes_equal_reference(name):
    data = np.random.default_rng(8).integers(0, 16, 20000,
                                             dtype=np.uint8).tobytes()
    data += b"compress me " * 1000
    c, jc = compressor.create(name), jcompressor.create(name)
    blob = c.compress(data)
    assert len(blob) < len(data)
    assert blob == jc.compress(data)
    assert c.decompress(blob) == data == jc.decompress(blob)


def test_compressor_registry_and_ratio_equal_reference():
    assert compressor.get_available() == jcompressor.get_available()
    assert set(compressor.get_available()) >= {"zlib", "lzma", "bz2"}
    with pytest.raises(ValueError):
        compressor.create("nope")
    noise = np.random.default_rng(4).integers(0, 256, 4096,
                                              dtype=np.uint8).tobytes()
    for data in (b"a" * 10000, noise):
        assert compressor.maybe_compress("zlib", data) == \
            jcompressor.maybe_compress("zlib", data)
    ok, blob = compressor.maybe_compress("zlib", b"a" * 10000)
    assert ok and len(blob) < 10000
    ok, blob = compressor.maybe_compress("zlib", noise)
    assert not ok and blob == noise


# -------------------------------------------------------------- lockdep


def _lock_run(ld, prefix):
    """Nest locks in a seeded order, then close a cycle; returns the
    graph dump and the cycle error's text."""
    ld.LockDep.instance().reset()
    names = [f"{prefix}{i}" for i in range(5)]
    locks = {n: ld.DepLock(n) for n in names}

    async def nest(order):
        async def go(i):
            if i == len(order):
                return
            async with locks[order[i]]:
                await go(i + 1)
        await go(0)

    r = random.Random(12)
    for run in ([0, 1, 2], [2, 3], [3, 4]) + tuple(
            sorted(r.sample(range(5), 3)) for _ in range(3)):
        asyncio.run(nest([names[i] for i in run]))
    dump = ld.LockDep.instance().dump()
    try:
        asyncio.run(nest([names[4], names[0]]))
    except ld.LockCycleError as e:
        err = str(e)
    else:
        err = None
    ld.LockDep.instance().reset()
    return dump, err


def test_lockdep_graphs_and_cycle_errors_equal_reference():
    mine, theirs = _lock_run(lockdep, "L"), _lock_run(jlockdep, "L")
    assert mine == theirs
    assert mine[1] is not None and "cycle" in mine[1]


@BOTH
def test_lockdep_detects_cycle_and_allows_consistent_order(pkg):
    ld = pkg.lockdep
    ld.LockDep.instance().reset()
    a, b, c = ld.DepLock("A"), ld.DepLock("B"), ld.DepLock("C")

    async def order(*locks):
        async def go(i):
            if i < len(locks):
                async with locks[i]:
                    await go(i + 1)
        await go(0)

    asyncio.run(order(a, b, c))
    asyncio.run(order(a, b, c))
    with pytest.raises(ld.LockCycleError):
        asyncio.run(order(c, a))
    assert ld.LockDep.instance().dump()["edges"] == {"A": ["B", "C"],
                                                     "B": ["C"]}
    ld.LockDep.instance().reset()


# ------------------------------------------------------------ chaos rng


def test_chaos_rng_streams_equal_reference():
    for seed in (0, 1, 42, 2 ** 40):
        for name in ("net", "disk", "schedfuzz", "daemons"):
            assert rng.derive_seed(seed, name) == jrng.derive_seed(seed, name)
            a, b = rng.stream(seed, name), jrng.stream(seed, name)
            assert [a.random() for _ in range(50)] == \
                [b.random() for _ in range(50)]
    assert rng.derive_seed(1, "a") != rng.derive_seed(1, "b")


def test_chaos_counters_equal_reference():
    assert counters.CHAOS.dump_schema() == jcounters.CHAOS.dump_schema()
    assert counters.chaos_total() == 0
    cfg, jcfg = config.Config(chaos_seed=5), jconfig.Config(chaos_seed=5)
    assert counters.chaos_report(cfg) == jcounters.chaos_report(jcfg)
    cfg.chaos_net_drop = 0.5
    jcfg.chaos_net_drop = 0.5
    counters.CHAOS.inc("net_drops", 3)
    jcounters.CHAOS.inc("net_drops", 3)
    try:
        rep, jrep = counters.chaos_report(cfg), jcounters.chaos_report(jcfg)
        assert rep == jrep and rep["active"]
        assert counters.chaos_total() == 3
    finally:
        counters.CHAOS.reset()
        jcounters.CHAOS.reset()
    assert counters.chaos_report()["options"] == {}


# ------------------------------------------------------------ schedfuzz


def _workload(n: int = 6, rounds: int = 4):
    order = []

    async def worker(i):
        for r in range(rounds):
            await asyncio.sleep(0)
            order.append((i, r))

    async def main():
        await asyncio.gather(*(worker(i) for i in range(n)))
        return tuple(order)

    return main


def _fuzz_trace(mod, seed):
    loop = mod.SchedFuzzLoop(seed=seed)
    try:
        asyncio.set_event_loop(loop)
        result = loop.run_until_complete(_workload()())
    finally:
        asyncio.set_event_loop(None)
        loop.close()
    return result, loop.fuzz_trace(), loop.trace_digest()


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_schedfuzz_trace_equals_reference(seed):
    mine, theirs = _fuzz_trace(schedfuzz, seed), _fuzz_trace(jschedfuzz, seed)
    assert mine == theirs
    assert schedfuzz.run_fuzzed(_workload(), seed=seed) == \
        jschedfuzz.run_fuzzed(_workload(), seed=seed)


def test_schedfuzz_replays_explores_and_perturbs():
    r1, d1 = schedfuzz.run_fuzzed(_workload(), seed=7)
    assert (r1, d1) == schedfuzz.run_fuzzed(_workload(), seed=7)
    runs = [schedfuzz.run_fuzzed(_workload(), seed=s) for s in range(8)]
    assert len({r for r, _ in runs}) > 1 and len({d for _, d in runs}) > 1
    fifo = asyncio.run(_workload()())
    assert any(r != fifo for r, _ in runs)
    _, trace, _ = _fuzz_trace(schedfuzz, 11)
    assert trace
    last = 0
    for tick, n, perm, deferred in trace:
        assert tick > last and sorted(perm) == list(range(n))
        assert 0 <= deferred <= n
        last = tick


# --------------------------------------------------------- admin socket


def _asok_replies(pkg):
    pc = pkg.perf.PerfCounters("d")
    pc.add_u64("ops", prio=pkg.perf.PRIO_CRITICAL)
    pc.inc("ops", 4)
    pc.tinc("lat", 0.125)
    pc.hinc("sizes", 4096)
    coll = pkg.perf.PerfCountersCollection()
    coll.register(pc, shared=False)
    cfg = pkg.config.Config(chaos_seed=3)
    sock = pkg.asok.AdminSocket()
    sock.register_common(coll, cfg, flight=pkg.flight.NULL_FLIGHT)
    pkg.lockdep.LockDep.instance().reset()
    pkg.lockdep.LockDep.instance().edges["x"] = {"y"}

    async def boom(cmd):
        raise ValueError("x")

    sock.register("boom", boom)
    cmds = ["perf dump", "perf schema", "perf histogram dump",
            "config show", "chaos report", "lockdep dump", "blackbox dump",
            {"prefix": "injectargs", "args": {"debug_osd": 5}},
            "config show", "boom", "nope", "perf reset", "perf dump"]

    async def scenario():
        out = []
        for c in cmds:
            cmd = c if isinstance(c, dict) else {"prefix": c}
            out.append((cmd["prefix"], await sock.dispatch(cmd)))
        return out

    try:
        return asyncio.run(scenario()), sock.commands()
    finally:
        pkg.lockdep.LockDep.instance().reset()


def test_admin_socket_replies_equal_reference():
    (mine, cmds), (theirs, jcmds) = _asok_replies(PORT), _asok_replies(REF)
    assert mine == theirs
    replies = dict(mine)
    assert replies["perf dump"][1]["d"]["ops"] == 0      # after reset
    assert replies["config show"][1]["debug_osd"] == 5
    assert replies["lockdep dump"][1]["edges"] == {"x": ["y"]}
    assert replies["boom"][0] == -22 and "ValueError" in replies["boom"][1]
    assert replies["nope"][0] == -22
    # the port serves every command of the reference's common set except
    # the one that reads the static-analysis package
    assert set(jcmds) - set(cmds) == {"graftlint report"}
    assert {k: v for k, v in jcmds.items() if k in cmds} == cmds


# ----------------------------------------------------------------- auth


def test_auth_key_derivation_and_caps_equal_reference():
    master = bytes(range(32))
    for name in ("client.admin", "osd.0", "mon.a", "client.x"):
        assert auth.entity_key(master, name) == jauth.entity_key(master,
                                                                  name)
        assert auth.default_caps_for(name) == jauth.default_caps_for(name)
    assert auth.service_key(master) == jauth.service_key(master)
    assert auth.DEFAULT_CAPS == jauth.DEFAULT_CAPS
    for caps in ({"osd": "rw"}, {"osd": "r"}, {"mon": "r"}, {}):
        for access in ("r", "rw"):
            assert auth.allows(caps, "osd", access) == \
                jauth.allows(caps, "osd", access)
    assert auth.SIG_LEN == jauth.SIG_LEN


def test_auth_sealed_boxes_and_tickets_cross_packages():
    master = b"k" * 32
    key = auth.service_key(master)
    payload = {"a": 1, "b": b"\x00\xff"}
    assert jauth.unseal(key, auth.seal(key, payload)) == payload
    assert auth.unseal(key, jauth.seal(key, payload)) == payload
    blob = auth.seal(key, payload)
    with pytest.raises(ValueError, match="MAC"):
        jauth.unseal(key, blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(ValueError, match="short"):
        auth.unseal(key, b"x")
    # a ticket the port issues opens under the reference's keys with the
    # same fields, and its session key reaches the client either way
    tblob, for_client, skey = auth.issue_ticket(master, "client.x",
                                                {"osd": "rw"}, 60.0)
    t = jauth.unseal(jauth.service_key(master), tblob)
    assert (t.entity, t.caps, t.session_key) == ("client.x", {"osd": "rw"},
                                                 skey)
    assert jauth.unseal(jauth.entity_key(master, "client.x"),
                        for_client) == skey
    # each package verifies its own authorizers and refuses tampering
    for mod in (auth, jauth):
        tb, _, sk = mod.issue_ticket(master, "osd.3", {"osd": "rw"}, 60.0)
        got = mod.verify_authorizer(master, mod.make_authorizer(tb, sk))
        assert got.entity == "osd.3" and got.caps == {"osd": "rw"}
        bad = mod.make_authorizer(tb, b"z" * 32)
        with pytest.raises(ValueError, match="proof"):
            mod.verify_authorizer(master, bad)
        with pytest.raises(ValueError):
            mod.verify_authorizer(master, b"\x00")
        old, _, _ = mod.issue_ticket(master, "osd.3", {}, -1.0)
        with pytest.raises(ValueError, match="expired"):
            mod.validate_ticket(master, old)


def test_cephx_context_from_config_equals_reference():
    kw = dict(auth_supported="cephx", auth_shared_secret="s3cret",
              auth_ticket_ttl=120.0)
    cfg, jcfg = config.Config(**kw), jconfig.Config(**kw)
    for entity in ("osd.1", "client.admin"):
        ctx, jctx = cfg.cephx_context(entity), jcfg.cephx_context(entity)
        assert isinstance(ctx, auth.CephxContext)
        assert (ctx.entity, ctx.master, ctx.entity_secret, ctx.ttl) == \
            (jctx.entity, jctx.master, jctx.entity_secret, jctx.ttl)
    daemon = cfg.cephx_context("osd.1")
    daemon.ensure_ticket()
    assert not daemon.ticket_expired()
    t = auth.validate_ticket(b"s3cret", daemon.ticket_blob)
    assert t.caps == auth.default_caps_for("osd.1")
    client = cfg.cephx_context("client.admin")
    with pytest.raises(PermissionError):
        client.ensure_ticket()
    tb, sealed, sk = jauth.issue_ticket(b"s3cret", "client.admin", {}, 60.0)
    client.adopt(tb, sealed, 60.0)
    assert client.session_key == sk


# ------------------------------------------------------ deadline, tasks


@BOTH
def test_deadline_budget(pkg):
    async def scenario():
        assert pkg.deadline.deadline_of(None) is None
        assert pkg.deadline.remaining(None) is None
        d = pkg.deadline.deadline_of(30.0)
        left = pkg.deadline.remaining(d)
        assert 0 < left <= 30.0
        with pytest.raises(TimeoutError):
            pkg.deadline.remaining(pkg.deadline.deadline_of(-1.0))

    asyncio.run(scenario())


@BOTH
def test_track_task_registry(pkg):
    async def scenario():
        reg = set()
        done = asyncio.Event()

        async def job():
            await done.wait()
            return 5

        t = pkg.tasks.track_task(reg, asyncio.ensure_future(job()))
        assert t in reg
        done.set()
        assert await t == 5
        await asyncio.sleep(0)
        return reg

    assert asyncio.run(scenario()) == set()
