"""The port's messenger, wire messages and net injector against
``ceph_tpu``'s.

The cases of ``tests/test_messenger.py`` that need no cluster (ordered
replay across a dropped connection and a restarted receiver, an
unreachable peer, a tampered signed frame, the byte throttle) run on both
packages over real loopback sockets, each bounded by its own timeout.
Then: cephx sessions (authorizer first, a client ticket bootstrapped from
a stand-in monitor, an unauthenticated frame refused); the handshake
frames' fixed encodings byte for byte; a chaos-injected session that
still delivers every frame; the net injector's fates and batch-frame
mutations equal to the reference's for the same seed; and every message
class of ``messages.py`` with the reference's names and fields, carried
across by its fields and round-tripped through the port's frames.
"""

import asyncio
import dataclasses
import hashlib
import hmac
import pickle
import random
import struct
import types
from dataclasses import dataclass
from typing import List

import pytest

import ceph_tpu.chaos.counters as jcounters
import ceph_tpu.chaos.net as jnet
import ceph_tpu.chaos.rng as jrng
import ceph_tpu.cluster.auth as jauth
import ceph_tpu.cluster.messages as jmessages
import ceph_tpu.cluster.messenger as jmessenger
import ceph_tpu.osdmap.osdmap as josdmap
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.chaos.counters as counters
import ceph_tpu_torch.chaos.net as net
import ceph_tpu_torch.chaos.rng as rng
import ceph_tpu_torch.cluster.auth as auth
import ceph_tpu_torch.cluster.messages as messages
import ceph_tpu_torch.cluster.messenger as messenger
import ceph_tpu_torch.osdmap.osdmap as osdmap
import ceph_tpu_torch.utils.config as config
import ceph_tpu_torch.utils.lockdep as lockdep
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)


# test messages of each package (module level: frames are pickles)
@dataclass
class RefNum(jmessenger.Message):
    n: int = 0


@dataclass
class RefBlob(jmessenger.Message):
    data: bytes = b""


@dataclass
class PortNum(messenger.Message):
    n: int = 0


@dataclass
class PortBlob(messenger.Message):
    data: bytes = b""


REF = types.SimpleNamespace(
    msgr=jmessenger, M=jmessages, net=jnet, rng=jrng, counters=jcounters,
    auth=jauth, config=jconfig, osdmap=josdmap, lockdep=jlockdep,
    Num=RefNum, Blob=RefBlob)
PORT = types.SimpleNamespace(
    msgr=messenger, M=messages, net=net, rng=rng, counters=counters,
    auth=auth, config=config, osdmap=osdmap, lockdep=lockdep,
    Num=PortNum, Blob=PortBlob)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
BOUND = 30.0


@pytest.fixture(autouse=True)
def _port_lockdep_reset():
    """The port's lock-order graph is process-wide, like the reference's
    (which the suite's conftest resets): start each case clean."""
    lockdep.LockDep.instance().reset()
    lockdep.DepLock._held.clear()
    yield
    lockdep.LockDep.instance().reset()
    lockdep.DepLock._held.clear()


def run(coro):
    """Each case under its own bound: a hang fails the case, not the
    suite."""
    return asyncio.run(asyncio.wait_for(coro, timeout=BOUND))


def _collector(pkg):
    class Collector(pkg.msgr.Dispatcher):
        def __init__(self):
            self.got: List[int] = []
            self.msgs: List = []

        async def ms_dispatch(self, conn, msg) -> bool:
            if isinstance(msg, pkg.Num):
                self.got.append(msg.n)
                return True
            self.msgs.append(msg)
            return True

    return Collector()


async def _until(pred, secs=10.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + secs
    while not pred() and loop.time() < deadline:
        await asyncio.sleep(0.02)


# --------------------------------------------------------- reliability


@BOTH
def test_reconnect_replays_unacked_in_order(pkg):
    async def scenario():
        rx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1))
        coll = _collector(pkg)
        rx.add_dispatcher(coll)
        addr = await rx.bind()
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 2))
        try:
            total = 60
            for i in range(total):
                if i in (20, 40):
                    conn = tx._out.get(tuple(addr))
                    if conn:
                        conn.writer.close()
                await tx.send_message(pkg.Num(n=i), addr)
            await _until(lambda: set(coll.got) >= set(range(total)))
            assert set(coll.got) == set(range(total))
            dedup = []
            for n in coll.got:
                if not dedup or n > dedup[-1]:
                    dedup.append(n)
            assert dedup == list(range(total))
        finally:
            await tx.shutdown()
            await rx.shutdown()

    run(scenario())


@BOTH
def test_reconnect_survives_receiver_restart(pkg):
    async def scenario():
        rx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1))
        coll = _collector(pkg)
        rx.add_dispatcher(coll)
        addr = await rx.bind()
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 2))
        try:
            for i in range(10):
                await tx.send_message(pkg.Num(n=i), addr)
            await _until(lambda: set(coll.got) >= set(range(10)))
            await rx.shutdown()
            rx2 = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1))
            coll2 = _collector(pkg)
            rx2.add_dispatcher(coll2)
            await rx2.bind(host=addr[0], port=addr[1])
            try:
                for i in range(10, 20):
                    await tx.send_message(pkg.Num(n=i), addr)
                await _until(lambda: set(range(10, 20)) <= set(coll2.got))
                assert set(range(10, 20)) <= set(coll2.got)
            finally:
                await rx2.shutdown()
        finally:
            await tx.shutdown()

    run(scenario())


@BOTH
def test_unreachable_peer_raises_after_retries(pkg):
    async def scenario():
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("client", 9))
        try:
            with pytest.raises((ConnectionError, OSError)):
                await tx.send_message(pkg.Num(n=1), ("127.0.0.1", 1))
        finally:
            await tx.shutdown()

    run(scenario())


@BOTH
def test_tampered_frame_rejected(pkg):
    async def scenario():
        rx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1), secret=b"k")
        coll = _collector(pkg)
        rx.add_dispatcher(coll)
        addr = await rx.bind()
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 2), secret=b"k")
        try:
            await tx.send_message(pkg.Num(n=1), addr)
            await _until(lambda: coll.got == [1])
            reader, writer = await asyncio.open_connection(*addr)
            m = pkg.Num(n=666)
            m.src = pkg.msgr.EntityName("osd", 3)
            payload = pickle.dumps(m) + b"\x00" * 16
            writer.write(struct.pack("<I", len(payload)) + payload)
            await writer.drain()
            # an absence has no state to converge on: give the read loop
            # the chance to (wrongly) dispatch the forged frame
            await asyncio.sleep(0.2)  # graftlint: ignore[fixed-sleep-in-tests]
            writer.close()
            assert coll.got == [1]
        finally:
            await tx.shutdown()
            await rx.shutdown()

    run(scenario())


@BOTH
def test_byte_throttle_backpressure(pkg):
    async def scenario():
        gate = asyncio.Event()
        in_dispatch = []

        class Slow(pkg.msgr.Dispatcher):
            async def ms_dispatch(self, conn, msg):
                if isinstance(msg, pkg.Blob):
                    in_dispatch.append(len(msg.data))
                    await gate.wait()
                    return True
                return False

        server = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 0))
        server.add_dispatcher(Slow())
        server.set_policy("client", pkg.msgr.Policy(
            lossy=True, throttle=pkg.msgr.Throttle(100_000)))
        addr = await server.bind()
        senders = [pkg.msgr.Messenger(pkg.msgr.EntityName("client", i))
                   for i in (1, 2, 3)]
        try:
            for s in senders:
                await s.send_message(pkg.Blob(data=b"x" * 65536), addr)
            await _until(lambda: len(in_dispatch) >= 1)
            # an absence has no state to converge on: the other two
            # frames must stay out of dispatch while the budget is held
            await asyncio.sleep(0.3)  # graftlint: ignore[fixed-sleep-in-tests]
            assert len(in_dispatch) == 1, in_dispatch
            gate.set()
            await _until(lambda: len(in_dispatch) >= 3)
            assert len(in_dispatch) == 3, in_dispatch
        finally:
            gate.set()
            for s in senders:
                await s.shutdown()
            await server.shutdown()

    run(scenario())


@BOTH
def test_lossy_policy_does_not_replay(pkg):
    """A lossy peer policy drops the unacked tail on a reset and fails
    the send instead of replaying it."""
    async def scenario():
        rx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1))
        addr = await rx.bind()
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("client", 1))
        tx.set_policy(None, pkg.msgr.Policy(lossy=True))
        try:
            await tx.send_message(pkg.Num(n=1), addr)
            await rx.shutdown()
            sess = tx._sessions[tuple(addr)]
            sess.unacked[99] = b"never acked"
            with pytest.raises(ConnectionError, match="lossy"):
                await tx._reconnect_replay(sess, tuple(addr))
            assert not sess.unacked
        finally:
            await tx.shutdown()

    run(scenario())


# ---------------------------------------------------------------- cephx


def _auth_server(pkg, master):
    def handle(msg):
        ek = pkg.auth.entity_key(master, msg.entity)
        want = hmac.new(ek, b"authreq:" + msg.entity.encode() + msg.nonce,
                        hashlib.sha256).digest()[:pkg.msgr.SIG_LEN]
        if not hmac.compare_digest(want, msg.proof):
            return pkg.msgr._MsgAuthReply(result=-13, error="bad key proof")
        blob, sealed, _ = pkg.auth.issue_ticket(
            master, msg.entity, pkg.auth.default_caps_for(msg.entity), 60.0)
        return pkg.msgr._MsgAuthReply(result=0, ticket_blob=blob,
                                      sealed_key=sealed, ttl=60.0)
    return handle


@BOTH
def test_cephx_sessions_and_client_bootstrap(pkg):
    """Daemons self-issue tickets and present the authorizer first;
    a client bootstraps its ticket from a monitor stand-in, then its
    signed session frames are accepted; a data frame on a connection
    that never authenticated is refused before any unpickling."""
    cfg = pkg.config.Config(auth_supported="cephx",
                            auth_shared_secret="cluster-key")
    master = cfg.auth_secret()

    async def scenario():
        mon = pkg.msgr.Messenger(pkg.msgr.EntityName("mon", 0),
                                 auth=cfg.cephx_context("mon.0"))
        mon.auth_server = _auth_server(pkg, master)
        coll = _collector(pkg)
        mon.add_dispatcher(coll)
        addr = await mon.bind()
        osd = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 3),
                                 auth=cfg.cephx_context("osd.3"))
        client = pkg.msgr.Messenger(pkg.msgr.EntityName("client", 4),
                                    auth=cfg.cephx_context("client.4"))
        try:
            await osd.send_message(pkg.Num(n=1), addr)
            with pytest.raises(PermissionError):
                client.auth.ensure_ticket()
            await client.cephx_bootstrap(addr)
            await client.send_message(pkg.Num(n=2), addr)
            await _until(lambda: sorted(coll.got) == [1, 2])
            assert sorted(coll.got) == [1, 2]
            peers = {c.peer_entity for c in mon._accepted
                     if c.peer_entity}
            assert {"osd.3", "client.4"} <= peers
            reader, writer = await asyncio.open_connection(*addr)
            payload = pickle.dumps(pkg.Num(n=666))
            writer.write(struct.pack("<IB", 1 + len(payload), 0) + payload)
            await writer.drain()
            # an absence has no state to converge on
            await asyncio.sleep(0.2)  # graftlint: ignore[fixed-sleep-in-tests]
            writer.close()
            assert sorted(coll.got) == [1, 2]
        finally:
            await client.shutdown()
            await osd.shutdown()
            await mon.shutdown()

    run(scenario())


def test_handshake_frames_encode_as_the_reference():
    cases = [
        ("_MsgAuth", {"authorizer": bytes(range(40))}),
        ("_MsgAuthRequest", {"entity": "client.admin",
                             "nonce": b"n" * 16, "proof": b"p" * 16}),
        ("_MsgAuthReply", {"result": -13, "ttl": 12.5,
                           "ticket_blob": b"t" * 33, "sealed_key": b"s" * 9,
                           "error": "bad key proof"}),
    ]
    for name, fields in cases:
        want = jmessenger._encode_hs(getattr(jmessenger, name)(**fields))
        got = messenger._encode_hs(getattr(messenger, name)(**fields))
        assert got == want
        back = messenger._decode_hs(got[0], got[1:])
        assert type(back).__name__ == name
        assert {k: getattr(back, k) for k in fields} == fields
    assert messenger._encode_hs(PORT.Num(n=1)) is None
    with pytest.raises(ConnectionError):
        messenger._decode_hs(2, b"\x05\x00ab")
    assert messenger._sign(b"k", b"payload") == \
        jmessenger._sign(b"k", b"payload")


# ---------------------------------------------------------------- chaos


@BOTH
def test_net_injector_rates_and_partitions(pkg):
    inj = pkg.net.NetInjector(pkg.rng.stream(1, "t"), drop=1.0)
    fate = inj.on_frame(("h", 1))
    assert fate.drop and fate.retransmit > 0
    inj2 = pkg.net.NetInjector(pkg.rng.stream(1, "t"), dup=1.0, reset=1.0)
    fate2 = inj2.on_frame(("h", 1))
    assert fate2.dup and fate2.reset and not fate2.drop
    assert pkg.net.parse_partitions("127.0.0.1:5,127.0.0.1:6") == {
        ("127.0.0.1", 5), ("127.0.0.1", 6)}
    inj2.partition(("127.0.0.1", 5))
    assert inj2.partitioned(("127.0.0.1", 5))
    with pytest.raises(ConnectionError):
        inj2.check_connect(("127.0.0.1", 5))
    inj2.heal()
    inj2.check_connect(("127.0.0.1", 5))


def _frame(pkg, n):
    return pkg.M.MOSDECSubOpWriteBatch(
        items=[pkg.M.MOSDECSubOpWrite(reqid=("c", i), shard=i % 3)
               for i in range(n)], epoch=1)


@BOTH
def test_batch_item_drop_partial_and_deterministic(pkg):
    before = pkg.counters.CHAOS.dump()["chaos"].get("net_batch_item_drops",
                                                    0)
    frame = _frame(pkg, 12)
    pkg.net.NetInjector(pkg.rng.stream(5, "t"),
                        batch_item_drop=0.5).mutate_batch(frame)
    assert 1 <= len(frame.items) < 12
    assert pkg.counters.CHAOS.dump()["chaos"]["net_batch_item_drops"] == \
        before + 12 - len(frame.items)
    frame2 = _frame(pkg, 12)
    pkg.net.NetInjector(pkg.rng.stream(5, "t"),
                        batch_item_drop=0.5).mutate_batch(frame2)
    assert [it.reqid for it in frame2.items] == \
        [it.reqid for it in frame.items]
    frame3 = _frame(pkg, 6)
    pkg.net.NetInjector(pkg.rng.stream(1, "x"),
                        batch_item_drop=1.0).mutate_batch(frame3)
    assert len(frame3.items) == 1


@BOTH
def test_batch_ack_dup_and_reorder(pkg):
    inj = pkg.net.NetInjector(pkg.rng.stream(9, "a"), batch_ack_dup=1.0)
    reply = pkg.M.MOSDECSubOpWriteBatchReply(
        results=[(("c", i), 0, i) for i in range(4)])
    inj.mutate_batch(reply)
    assert len(reply.results) == 8
    inj2 = pkg.net.NetInjector(pkg.rng.stream(9, "b"),
                               batch_ack_reorder=1.0)
    reply2 = pkg.M.MOSDECSubOpWriteBatchReply(
        results=[(("c", i), 0, i) for i in range(8)])
    orig = list(reply2.results)
    inj2.mutate_batch(reply2)
    assert sorted(reply2.results) == sorted(orig)


@BOTH
def test_injector_none_with_only_batch_rates_off(pkg):
    cfg = pkg.config.Config()
    assert pkg.net.NetInjector.from_config(cfg, "osd.0") is None
    cfg.chaos_net_batch_item_drop = 0.3
    inj = pkg.net.NetInjector.from_config(cfg, "osd.0")
    assert inj is not None and inj.batch_item_drop == 0.3


def _decisions(pkg, seed):
    """Every decision of an injector with all families on, for one seed:
    frame fates, then batch-frame and batched-ack mutations."""
    cfg = pkg.config.Config(
        chaos_seed=seed, chaos_net_drop=0.1, chaos_net_dup=0.2,
        chaos_net_delay=0.03, chaos_net_delay_prob=0.3,
        chaos_net_reorder=0.15, chaos_net_reset=0.1,
        chaos_net_partition="127.0.0.1:7",
        chaos_net_batch_item_drop=0.3, chaos_net_batch_ack_dup=0.3,
        chaos_net_batch_ack_reorder=0.5)
    inj = pkg.net.NetInjector.from_config(cfg, "osd.4")
    fates = [dataclasses.astuple(inj.on_frame(("127.0.0.1", 9)))
             for _ in range(200)]
    frames = []
    for n in (1, 2, 5, 12, 30):
        f = _frame(pkg, n)
        inj.mutate_batch(f)
        frames.append([it.reqid for it in f.items])
        r = pkg.M.MOSDECSubOpWriteBatchReply(
            results=[(("c", i), 0, i) for i in range(n)])
        inj.mutate_batch(r)
        frames.append(list(r.results))
    ensured = pkg.net.ensure_injector(types.SimpleNamespace(
        chaos=None, config=cfg, name="osd.4"))
    return (fates, frames, sorted(inj.partitions),
            [ensured.rng.random() for _ in range(3)])


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_net_injector_decisions_equal_reference(seed):
    assert _decisions(PORT, seed) == _decisions(REF, seed)


@BOTH
def test_chaotic_session_still_delivers_every_frame(pkg):
    """Drops, duplicates and delays on the sender's frames: the
    session's retransmission replay still delivers every frame at least
    once, and the injector follows the config live.  (Reorders and
    resets may lose a frame by design; the cluster's retries cover
    them.)"""
    cfg = pkg.config.Config(chaos_seed=3, chaos_net_drop=0.1,
                            chaos_net_dup=0.2, chaos_net_delay=0.01,
                            chaos_net_delay_prob=0.2)

    async def scenario():
        rx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 1))
        coll = _collector(pkg)
        rx.add_dispatcher(coll)
        addr = await rx.bind()
        tx = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", 2), config=cfg)
        assert tx.chaos is not None
        try:
            for i in range(40):
                await tx.send_message(pkg.Num(n=i), addr)
            await _until(lambda: set(coll.got) >= set(range(40)), 20.0)
            assert set(coll.got) == set(range(40))
            cfg.injectargs({"chaos_net_drop": 0.0, "chaos_net_dup": 0.0,
                            "chaos_net_delay_prob": 0.0})
            assert tx.chaos is None
        finally:
            await tx.shutdown()
            await rx.shutdown()

    run(scenario())


# ------------------------------------------------------------- messages


def _message_classes(mod, base):
    return {name: cls for name, cls in vars(mod).items()
            if isinstance(cls, type) and issubclass(cls, base)
            and cls is not base and cls.__module__ == mod.__name__}


# the fields the port's messages add to the reference's, each a
# deliberate difference (ROADMAP §C): the interval that fences a stale EC
# primary's rewinds, and the number that ties a map refresh to the mon's
# answer.  Each defaults to "none".
PORT_FIELDS = {"MMonSubscribe": {"tid": 0}, "MOSDMapMsg": {"sub_tid": 0},
               "MOSDIncMapMsg": {"sub_tid": 0},
               "MOSDPGPush": {"interval": None}}


def test_message_classes_and_fields_equal_reference():
    ref = _message_classes(jmessages, jmessenger.Message)
    port = _message_classes(messages, messenger.Message)
    assert sorted(port) == sorted(ref) and len(port) > 30
    assert set(PORT_FIELDS) <= set(ref)
    for name, cls in ref.items():
        want = [(f.name, f.init, repr(f.default) if f.default is not
                 dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]
        got = [(f.name, f.init, repr(f.default) if f.default is not
                dataclasses.MISSING else None)
               for f in dataclasses.fields(port[name])]
        extra = PORT_FIELDS.get(name, {})
        assert [g for g in got if g[0] not in extra] == want, name
        assert [g for g in got if g[0] in extra] == \
            [(k, True, repr(v)) for k, v in extra.items()], name
    assert messages.THROTTLED == jmessages.THROTTLED
    assert messages.MUTATING_OPS == jmessages.MUTATING_OPS
    for name in ("Message", "_MsgAck", "_MsgAuth", "_MsgAuthRequest",
                 "_MsgAuthReply", "EntityName"):
        assert [f.name for f in dataclasses.fields(
            getattr(messenger, name))] == [f.name for f in dataclasses.fields(
                getattr(jmessenger, name))]
    assert messages.PGid is osdmap.PGid


def _value(rs: random.Random, default, name):
    """A seeded plain value shaped like a field's default."""
    if name == "pgid":
        return ("pgid", rs.randrange(8), rs.randrange(1 << 16))
    if isinstance(default, bool):
        return rs.random() < 0.5
    if isinstance(default, int):
        return rs.randrange(-1000, 1 << 40)
    if isinstance(default, float):
        return rs.random() * 1e6
    if isinstance(default, str):
        return "".join(rs.choice("abcxyz._-") for _ in range(rs.randrange(12)))
    if isinstance(default, bytes):
        return bytes(rs.randrange(256) for _ in range(rs.randrange(64)))
    if isinstance(default, tuple):
        return tuple(rs.randrange(100) for _ in range(rs.randrange(1, 4)))
    if isinstance(default, list):
        return [("op", {"k": rs.randrange(9)}) for _ in range(3)]
    if isinstance(default, dict):
        return {f"k{i}": rs.randrange(9) for i in range(rs.randrange(4))}
    return {"opaque": rs.randrange(1 << 30), "stamp": rs.random()}


def _carry(value, pkg):
    if isinstance(value, tuple) and value and value[0] == "pgid":
        return pkg.osdmap.PGid(value[1], value[2])
    return value


def _fields_of(msg):
    out = {}
    for f in dataclasses.fields(msg):
        if not f.init:
            continue
        v = getattr(msg, f.name)
        if type(v).__name__ == "PGid":
            v = ("pgid", v.pool, v.seed)
        out[f.name] = v
    return out


def test_every_message_round_trips_through_the_port_frames():
    """Each class of ``messages.py``, built with seeded field values in
    the reference and carried to the port by its fields, crosses a signed
    port session and arrives with every field equal."""
    ref = _message_classes(jmessages, jmessenger.Message)
    rs, rs_port = random.Random(2026), random.Random(2027)
    sent = []
    for name in sorted(ref):
        plain = {f.name: _value(rs, f.default if f.default is not
                                dataclasses.MISSING else f.default_factory(),
                                f.name)
                 for f in dataclasses.fields(ref[name]) if f.init}
        rmsg = ref[name](**{k: _carry(v, REF) for k, v in plain.items()})
        # the port's own fields (PORT_FIELDS) get seeded values too
        extra = {k: _value(rs_port, 0, k) for k in PORT_FIELDS.get(name, {})}
        pmsg = getattr(messages, name)(**{
            k: _carry(v, PORT) for k, v in _fields_of(rmsg).items()},
            **extra)
        got = _fields_of(pmsg)
        assert {k: v for k, v in got.items() if k not in extra} == \
            _fields_of(rmsg) == plain, name
        assert {k: got[k] for k in extra} == extra, name
        sent.append(pmsg)

    async def scenario():
        rx = messenger.Messenger(messenger.EntityName("osd", 1), secret=b"s")
        coll = _collector(PORT)
        rx.add_dispatcher(coll)
        addr = await rx.bind()
        tx = messenger.Messenger(messenger.EntityName("osd", 2), secret=b"s")
        try:
            for msg in sent:
                await tx.send_message(msg, addr)
            await _until(lambda: len(coll.msgs) >= len(sent))
        finally:
            await tx.shutdown()
            await rx.shutdown()
        return coll.msgs

    got = run(scenario())
    assert [type(m).__name__ for m in got] == \
        [type(m).__name__ for m in sent]
    for g, s in zip(got, sent):
        assert _fields_of(g) == _fields_of(s)
        assert g.src == messenger.EntityName("osd", 2) and g.sid == s.sid
