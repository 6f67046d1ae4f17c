"""The port's tick batchers against ``ceph_tpu``'s.

Each package gets stub daemons of the same shape (the ``_FakeOSD`` of
``tests/test_batch_chaos.py``: a config, perf counters, a clock, task
tracking, and ``_compute`` through ``run_in_executor`` as the OSD runs
it).  On them:

- ``SubWriteBatcher``: the per-item failure contract and the coalescing
  of ``test_batch_chaos.py``;
- ``ReadBatcher``: ``test_verified_reads.py``'s verify and per-item fault
  isolation, then decode, reencode and verify of both layouts, equal to
  the reference's;
- ``EncodeBatcher``: 32 concurrent requests of seeded sizes on ISA k8m4
  planes at rest and on cauchy_good k8m4 bytes at rest give the
  reference's shards and crcs byte for byte in one tick of 32 ops;
  ``encode_once`` agrees; a stop in the middle of a tick fails the
  leftovers with ``ConnectionError``;
- ``OpBatcher`` and ``ClientReplyBatcher`` on stub senders: the frames
  they put on the wire and their failure handling.

The port's stubs run on ``device="cpu"``.  The reference's coalesced
functions on a CPU JAX backend compute cauchy parity with a bytewise host
engine (ROADMAP §C); for the cauchy pool the reference takes its device
route, as it does on its own accelerator.
"""

import asyncio
import functools
import types

import numpy as np
import pytest

import ceph_tpu.chaos.clock as jclock
import ceph_tpu.cluster.batcher as jbatcher
import ceph_tpu.cluster.messages as jmessages
import ceph_tpu.ops.crc32c as jcrc
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.perf as jperf
import ceph_tpu.utils.tasks as jtasks
from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import stripe as jstripe
import ceph_tpu_torch.chaos.clock as clock
import ceph_tpu_torch.cluster.batcher as batcher
import ceph_tpu_torch.cluster.messages as messages
import ceph_tpu_torch.ops.crc32c as crc
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.perf as perf
import ceph_tpu_torch.utils.tasks as tasks
from ceph_tpu_torch.ec import factory
from ceph_tpu_torch.ec import stripe
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(
    batcher=jbatcher, M=jmessages, config=jconfig, perf=jperf,
    tasks=jtasks, clock=jclock, stripe=jstripe, crc=jcrc, device=None,
    factory=jfactory)
PORT = types.SimpleNamespace(
    batcher=batcher, M=messages, config=config, perf=perf, tasks=tasks,
    clock=clock, stripe=stripe, crc=crc, device="cpu",
    factory=functools.partial(factory, device="cpu"))
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
BOUND = 120.0

ISA = {"plugin": "isa", "k": "8", "m": "4"}
CAUCHY = {"plugin": "jerasure", "technique": "cauchy_good", "k": "8",
          "m": "4", "packetsize": "2048"}
ERASURES = [(0,), (1, 10), (0, 1, 2, 3)]


def run(coro):
    """Each case under its own bound: a hang fails the case."""
    return asyncio.run(asyncio.wait_for(coro, timeout=BOUND))


@pytest.fixture(autouse=True)
def _reference_device_route(monkeypatch):
    """The reference's cauchy parity on a CPU JAX backend comes from its
    bytewise host engine, which ignores packets; its device route is the
    one its own accelerator runs.  ISA (w=8 matrices) keeps the host
    engine, which is bit-exact for it."""
    plain = jstripe._host_engine_ok
    monkeypatch.setattr(
        jstripe, "_host_engine_ok",
        lambda codec: plain(codec) and
        getattr(codec, "packetsize", None) is None)


class _StubOSD:
    """Just enough OSD for the batchers, the same shape in both
    packages: recordable sends with per-target failure injection, and
    the tick compute in an executor thread."""

    def __init__(self, pkg, tick_ops=64, device="from-pkg"):
        self._stopped = False
        self.config = pkg.config.Config(osd_batch_tick_ops=tick_ops,
                                        objecter_batch_tick_ops=tick_ops)
        self.perf = pkg.perf.PerfCounters("osd.stub")
        self.clock = pkg.clock.ChaosClock()
        self.sent = []
        self.fail_targets = set()
        self.gate = None
        self._tasks = set()
        self._tasks_mod = pkg.tasks
        if device == "from-pkg":
            device = pkg.device
        if device is not None:
            self.device = device

        class _Map:
            epoch = 7

        self.osdmap = _Map()

    def _track(self, task):
        return self._tasks_mod.track_task(self._tasks, task)

    def _chaos_point(self, name):
        pass

    async def _compute(self, fn, *args):
        if self.gate is not None:
            await self.gate.wait()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, functools.partial(fn, *args))

    async def _send_osd(self, target, msg):
        if self.gate is not None:
            await self.gate.wait()
        if target in self.fail_targets:
            raise ConnectionError(f"peer osd.{target} dead")
        n = len(msg.items) if hasattr(msg, "items") else 1
        self.sent.append((target, type(msg).__name__, n))


# ------------------------------------------------------ SubWriteBatcher


@BOTH
def test_subwrite_batcher_failure_unacks_only_affected_ops(pkg):
    async def scenario():
        osd = _StubOSD(pkg, tick_ops=16)
        b = pkg.batcher.SubWriteBatcher(osd)
        osd.fail_targets = {1}
        M = pkg.M

        async def op(name):
            return await asyncio.gather(
                b.send(1, M.MOSDECSubOpWrite(reqid=(name, 1), shard=0)),
                b.send(2, M.MOSDECSubOpWrite(reqid=(name, 1), shard=1)),
                return_exceptions=True)

        rx, ry = await asyncio.gather(op("x"), op("y"))
        for res in (rx, ry):
            assert isinstance(res[0], ConnectionError)
            assert res[1] is None
        assert sum(n for t, _k, n in osd.sent if t == 2) == 2
        osd.fail_targets = set()
        ok = await asyncio.wait_for(
            b.send(1, M.MOSDECSubOpWrite(reqid=("z", 1), shard=0)),
            timeout=5.0)
        assert ok is None
        assert any(t == 1 for t, _k, _n in osd.sent)

    run(scenario())


@BOTH
def test_subwrite_batcher_coalesces_same_target_into_one_frame(pkg):
    async def scenario():
        osd = _StubOSD(pkg, tick_ops=16)
        osd.gate = asyncio.Event()
        b = pkg.batcher.SubWriteBatcher(osd)
        M = pkg.M
        first = asyncio.ensure_future(
            b.send(3, M.MOSDECSubOpWrite(reqid=("a", 1), shard=0)))
        await asyncio.sleep(0)
        rest = [asyncio.ensure_future(
            b.send(3, M.MOSDECSubOpWrite(reqid=(f"b{i}", 1), shard=0)))
            for i in range(3)]
        await asyncio.sleep(0)
        osd.gate.set()
        await asyncio.gather(first, *rest)
        kinds = [(k, n) for _t, k, n in osd.sent]
        assert ("MOSDECSubOpWrite", 1) in kinds
        assert ("MOSDECSubOpWriteBatch", 3) in kinds
        assert osd.perf.get("osd_subwrite_batches") == 1
        assert osd.perf.get("osd_subwrite_batched_items") == 3

    run(scenario())


# ----------------------------------------------------------- ReadBatcher


@BOTH
def test_read_batcher_verify_and_fault_isolation(pkg):
    codec = pkg.factory({"plugin": "jerasure", "technique": "reed_sol_van",
                         "k": "2", "m": "1"})
    sinfo = pkg.stripe.StripeInfo(2, 4096)
    data = b"\xa5" * 8192
    full = pkg.stripe.encode_stripes(codec, sinfo, data)

    async def scenario():
        rb = pkg.batcher.ReadBatcher(_StubOSD(pkg, tick_ops=16))
        row = full[0].tobytes()
        good_crc = pkg.crc.crc32c(0xFFFFFFFF, row)
        oks = await rb.verify([row, row], [good_crc, good_crc ^ 1])
        assert oks == [True, False]
        results = await asyncio.gather(
            rb.decode(codec, sinfo, {0: full[0], 1: full[1]}, len(data)),
            rb.decode(codec, sinfo, {0: full[0]}, len(data)),
            rb.decode(codec, sinfo, {1: full[1], 2: full[2]}, len(data)),
            return_exceptions=True)
        assert results[0] == data
        assert isinstance(results[1], ValueError)
        assert results[2] == data

    run(scenario())


def _datas(seed, n=32):
    rs = np.random.default_rng(seed)
    sizes = [int(s) for s in rs.integers(4096, 65537, n - 2)] + [0, 100]
    return [rs.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


def _pool(pkg, planar):
    if planar:
        return (pkg.factory(dict(ISA)), pkg.stripe.StripeInfo(8, 4096))
    return (pkg.factory(dict(CAUCHY)), pkg.stripe.StripeInfo(8, 16384))


def _read_tick(pkg, planar, encoded, datas):
    """Decode and reencode of every op for each erasure set, and one
    verify of every shard with one row corrupted, each set's requests
    submitted at once."""
    codec, sinfo = _pool(pkg, planar)

    async def scenario():
        osd = _StubOSD(pkg)
        rb = pkg.batcher.ReadBatcher(osd)
        out = {}
        for er in ERASURES:
            reqs = [({s: shards[s] for s in range(12) if s not in er},
                     len(d)) for (shards, _c), d in zip(encoded, datas)]
            out[("decode", er)] = await asyncio.gather(
                *(rb.decode(codec, sinfo, sh, size, planar=planar)
                  for sh, size in reqs))
            out[("reencode", er)] = [np.asarray(r) for r in
                                     await asyncio.gather(
                *(rb.reencode(codec, sinfo, sh, size, planar=planar)
                  for sh, size in reqs))]
        ticks = (osd.perf.get("osd_read_batch_ticks"),
                 osd.perf.get("osd_read_batch_coalesced"))
        rows, crcs = [], []
        for shards, cs in encoded:
            for s in range(12):
                rows.append(np.ascontiguousarray(shards[s]).tobytes())
                crcs.append(cs[s])
        bad = len(rows) // 3
        rows[bad] = bytes([rows[bad][0] ^ 0x10]) + rows[bad][1:]
        out["verify"] = await rb.verify(rows, crcs, planar=planar)
        out["bad"] = bad
        out["ticks"] = ticks
        out["verify_ticks"] = (
            osd.perf.get("osd_read_batch_ticks") - ticks[0],
            osd.perf.get("osd_read_batch_coalesced") - ticks[1])
        return out

    return run(scenario())


def _encode_tick(pkg, planar, datas, want):
    codec, sinfo = _pool(pkg, planar)

    async def scenario():
        osd = _StubOSD(pkg)
        eb = pkg.batcher.EncodeBatcher(osd)
        res = await asyncio.gather(
            *(eb.encode(codec, sinfo, d, want_crc=w, planar=planar)
              for d, w in zip(datas, want)))
        once = [await eb.encode_once(codec, sinfo, datas[i], planar=planar)
                for i in (0, 30, 31)]
        return res, once, (osd.perf.get("osd_batch_ticks"),
                           osd.perf.get("osd_batch_coalesced_ops"))

    return run(scenario())


@pytest.mark.parametrize("planar", [True, False],
                         ids=["isa-planes", "cauchy-bytes"])
def test_encode_and_read_batchers_equal_reference(planar):
    datas = _datas(8 if planar else 9)
    want = [i % 5 != 4 for i in range(len(datas))]
    got, got_once, got_ticks = _encode_tick(PORT, planar, datas, want)
    ref, ref_once, ref_ticks = _encode_tick(REF, planar, datas, want)
    assert got_ticks == ref_ticks == (1, 32)
    for (gs, gc, gt), (rs_, rc, rt), w in zip(got, ref, want):
        assert isinstance(gs, np.ndarray) and gs.shape == rs_.shape
        assert np.array_equal(gs, rs_)
        assert gc == rc
        assert (gc is not None) == w
        assert all(type(c) is int for c in gc or ())
        assert gt[2] == rt[2] == 32
    for g, r in zip(got_once, ref_once):
        assert np.array_equal(np.asarray(g), np.asarray(r))
    assert np.array_equal(np.asarray(got_once[0]), got[0][0])
    # the read path, on shards and crcs of the write (crcs for all)
    full = [(s, c if c is not None else
             [int(x) for x in (stripe.encode_planes_multi if planar else
                               stripe.encode_stripes_multi)(
                 *_pool(PORT, planar), [d], [True])[0][1]])
            for (s, c, _t), d in zip(got, datas)]
    rgot = _read_tick(PORT, planar, full, datas)
    rref = _read_tick(REF, planar, full, datas)
    for er in ERASURES:
        assert rgot[("decode", er)] == rref[("decode", er)] == datas
        for g, r, (shards, _c) in zip(rgot[("reencode", er)],
                                      rref[("reencode", er)], full):
            assert np.array_equal(g, r)
            assert np.array_equal(g, shards)
    assert rgot["verify"] == rref["verify"]
    assert rgot["verify"].count(False) == 1
    assert rgot["verify"][rgot["bad"]] is False
    assert rgot["ticks"] == rref["ticks"]
    # the port's verify always rides one tick; the reference's answers
    # inline where its hardware crc32c extension is installed
    assert rgot["verify_ticks"] == (1, 1)
    assert rref["verify_ticks"] == ((0, 0) if jcrc._gcrc else (1, 1))


@BOTH
def test_encode_batcher_stop_mid_tick_fails_leftovers(pkg):
    codec, sinfo = _pool(pkg, True)
    datas = _datas(4, n=8)

    async def scenario():
        osd = _StubOSD(pkg)
        osd.gate = asyncio.Event()
        eb = pkg.batcher.EncodeBatcher(osd)
        first = [asyncio.ensure_future(eb.encode(codec, sinfo, d, True,
                                                 planar=True))
                 for d in datas[:4]]
        await asyncio.sleep(0)
        await asyncio.sleep(0)          # the worker parks in its tick
        later = [asyncio.ensure_future(eb.encode(codec, sinfo, d, True,
                                                 planar=True))
                 for d in datas[4:]]
        await asyncio.sleep(0)
        osd._stopped = True             # the daemon stops mid-tick
        osd.gate.set()
        done = await asyncio.gather(*first, *later, return_exceptions=True)
        shape = [type(r).__name__ for r in done]
        # a second batcher: cancel the worker inside its tick
        osd2 = _StubOSD(pkg)
        osd2.gate = asyncio.Event()
        eb2 = pkg.batcher.EncodeBatcher(osd2)
        futs = [asyncio.ensure_future(eb2.encode(codec, sinfo, d, True,
                                                 planar=True))
                for d in datas]
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        for t in list(osd2._tasks):
            t.cancel()
        cancelled = await asyncio.gather(*futs, return_exceptions=True)
        return shape, [str(e) for e in cancelled], \
            [str(e) for e in done[4:]]

    shape, cancelled, left = run(scenario())
    assert shape == ["tuple"] * 4 + ["ConnectionError"] * 4
    assert left == ["encode batcher stopped"] * 4
    assert cancelled == ["encode batcher stopped"] * 8


# ----------------------------------------------- OpBatcher, replies


class _StubObjecter:
    def __init__(self, pkg, tick_ops):
        self._stopped = False
        self.config = pkg.config.Config(objecter_batch_tick_ops=tick_ops)
        self.sent = []
        self.fail_first = False
        self._batch_ticks = 0
        self._batch_tick_ops = 0
        self.flight = None
        self._tasks = set()
        self._tasks_mod = pkg.tasks
        self.messenger = types.SimpleNamespace(send_message=self._send)

    def _track(self, task):
        return self._tasks_mod.track_task(self._tasks, task)

    async def _send(self, msg, addr):
        self.sent.append((addr, msg))
        if self.fail_first and len(self.sent) == 1:
            raise ConnectionError("wire down")


def _frames(sent):
    out = []
    for addr, m in sent:
        items = m.items if hasattr(m, "items") else [m]
        out.append((addr, type(m).__name__,
                    [it.reqid for it in items],
                    sorted(n for n, _t in (m.trace or {}).get("events", []))
                    if m.trace else None,
                    [sorted(n for n, _t in it.trace["events"])
                     for it in items if it.trace]))
    return out


def _op_batches(pkg):
    M = pkg.M

    def op(tid):
        m = M.MOSDOp(reqid=("c", tid), pgid=None, oid=f"o{tid}",
                     ops=[("write_full", {"data": b"x"})], epoch=7)
        m.trace = {"id": f"t{tid}", "events": []}
        return m

    async def scenario():
        obj = _StubObjecter(pkg, 8)
        ob = pkg.batcher.OpBatcher(obj)
        a, b = ("10.0.0.1", 1), ("10.0.0.2", 2)
        await asyncio.gather(*[ob.send(a, op(i)) for i in range(5)],
                             ob.send(b, op(99)))
        first = (_frames(obj.sent), obj._batch_ticks, obj._batch_tick_ops)
        bad = _StubObjecter(pkg, 8)
        bad.fail_first = True
        ob2 = pkg.batcher.OpBatcher(bad)
        results = await asyncio.gather(*[ob2.send(a, op(i))
                                         for i in range(3)],
                                       return_exceptions=True)
        await ob2.send(a, op(9))
        return first, [type(r).__name__ for r in results], \
            _frames(bad.sent)

    return run(scenario())


def test_op_batcher_frames_equal_reference():
    """Ops parked for one OSD before its worker runs ride one MOSDOpBatch
    with the amortized batch stamps; a lone op to another OSD ships as a
    plain MOSDOp; a failed frame fails every op of its tick, and the
    next op rides a fresh tick."""
    got, ref = _op_batches(PORT), _op_batches(REF)
    assert got == ref
    (frames, ticks, ops), results, after = got
    assert [(f[0], f[1]) for f in frames] == [
        (("10.0.0.1", 1), "MOSDOpBatch"), (("10.0.0.2", 2), "MOSDOp")]
    assert frames[0][2] == [("c", i) for i in range(5)]
    assert all(t == ["objecter:batch_sent", "objecter:batch_tick"]
               for t in frames[0][4])
    assert frames[1][3] == []
    assert (ticks, ops) == (1, 5)
    assert results == ["ConnectionError"] * 3
    assert [f[1] for f in after] == ["MOSDOpBatch", "MOSDOp"]


def _reply_batches(pkg):
    M = pkg.M

    class _Conn:
        def __init__(self, fail=False):
            self.sent, self.fail = [], fail

        async def send(self, msg):
            if self.fail:
                raise ConnectionError("client gone")
            self.sent.append(msg)

    async def scenario():
        osd = _StubOSD(pkg, tick_ops=8)
        rb = pkg.batcher.ClientReplyBatcher(osd)
        ok, dead = _Conn(), _Conn(fail=True)
        for i in range(6):
            rb.send(ok, M.MOSDOpReply(reqid=("c", i), result=0))
        for i in range(3):
            rb.send(dead, M.MOSDOpReply(reqid=("d", i), result=0))
        loop = asyncio.get_event_loop()

        async def drained():
            deadline = loop.time() + 10.0
            while (rb._workers or rb._pending) and loop.time() < deadline:
                await asyncio.sleep(0.01)

        await drained()
        rb.send(ok, M.MOSDOpReply(reqid=("c", 6), result=0))   # lone
        await drained()
        frames = [(type(m).__name__,
                   [it.reqid for it in getattr(m, "items", [m])])
                  for m in ok.sent]
        return frames, {k: osd.perf.get(k) for k in (
            "osd_client_batch_reply_frames", "osd_client_batch_reply_items",
            "osd_client_batch_reply_drops")}

    return run(scenario())


def test_client_reply_batcher_frames_equal_reference():
    """Replies parked for one client connection ride one
    MOSDOpReplyBatch, a lone reply ships plain, and a dead connection's
    replies are counted as dropped."""
    got, ref = _reply_batches(PORT), _reply_batches(REF)
    assert got == ref
    frames, counts = got
    assert frames == [("MOSDOpReplyBatch", [("c", i) for i in range(6)]),
                      ("MOSDOpReply", [("c", 6)])]
    assert counts == {"osd_client_batch_reply_frames": 1,
                      "osd_client_batch_reply_items": 6,
                      "osd_client_batch_reply_drops": 3}
