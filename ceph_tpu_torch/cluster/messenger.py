"""Async messenger: Connection / Dispatcher / sessions over asyncio TCP.

Counterpart of ``ceph_tpu/cluster/messenger.py``.

Structural mirror of the reference messenger abstraction (src/msg/
Messenger.h, Dispatcher.h; AsyncMessenger event loops): entity-named
endpoints, per-peer Connections with ordered delivery and reconnect,
dispatchers receiving typed messages.  Transport is asyncio TCP on
loopback (the reference's tier-3 standalone tests run the same way:
N daemons x 1 host over real sockets).  Frames are length-prefixed and
typed: ordinary messages are pickles — an internal trust boundary, like
the reference's cephx-signed native encoding is within a cluster —
while the cephx handshake frames use FIXED struct encodings so that no
unauthenticated byte ever reaches the deserializer (in cephx mode, data
frames on a connection without a session key are rejected outright).

Integrity (reference cephx message signing, src/auth/cephx/): when the
messenger holds a cluster secret, every frame carries a truncated
HMAC-SHA256 over the payload; receivers verify before unpickling and
reset the connection on mismatch, so a byte-flipped or forged frame can
never reach a dispatcher.  auth "none" (no secret) stays the default,
like the reference's auth_supported=none dev mode.

Reliability (reference AsyncConnection reconnect/replay semantics):
outgoing traffic runs over per-peer SESSIONS with monotonically
increasing sequence numbers; sent frames stay buffered until the peer
acks them, and a dropped TCP connection is transparently re-opened with
the unacked tail replayed IN ORDER.  Delivery is therefore ordered
at-least-once — handlers are idempotent by design (absolute-offset
writes, versioned log appends), exactly like the reference's lossless
osd-osd policy replaying out_q after a session reset.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
import struct
import hmac as _hmac
import hashlib
import time as _time

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.cluster.optracker import mark_current
from ceph_tpu_torch.utils.lockdep import DepLock

Addr = Tuple[str, int]

_SID = itertools.count(1)

# stream buffer limit: asyncio's 64 KiB default pauses/resumes the
# transport several times inside EVERY 1 MiB data frame (flow-control
# churn per sub-write); sized to hold a whole large frame.  Socket
# buffers get the same treatment so a burst of shard sub-writes drains
# in few syscalls (TCP_NODELAY is asyncio's default already).
_STREAM_LIMIT = 4 << 20
_SOCK_BUF = 2 << 20


def _tune_socket(writer) -> None:
    import socket as _socket

    sock = writer.get_extra_info("socket")
    if sock is None:
        return
    try:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, _SOCK_BUF)
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, _SOCK_BUF)
    except OSError:  # pragma: no cover - exotic transports
        pass


@dataclass(frozen=True)
class EntityName:
    type: str  # mon | osd | client | mgr
    num: int

    def __str__(self):
        return f"{self.type}.{self.num}"


@dataclass
class Message:
    """Base message; src/seq/sid are stamped by the sending messenger.

    ``trace`` is the op-lifecycle trace header (round 6 telemetry): a
    {"id", "events": [(name, wall_ts), ...]} dict minted by the objecter
    and stamped by each messenger hop, absorbed into the receiving
    daemon's TrackedOp so dump_historic_ops shows the op's cross-daemon
    timeline (reference: the OpRequest's event list + blkin-style trace
    propagation)."""

    src: Optional[EntityName] = field(default=None, init=False)
    seq: int = field(default=0, init=False)
    sid: int = field(default=0, init=False)
    trace: Optional[dict] = field(default=None, init=False)


@dataclass
class _MsgAck(Message):
    """Transport-level ack: trims the sender's replay buffer."""

    acked: int = 0


@dataclass
class _MsgAuth(Message):
    """Connection authorizer (cephx mode): MUST be the first frame on a
    connection; carries the sealed ticket + session-key possession proof
    (reference CephXAuthorizer in the connection handshake)."""

    authorizer: bytes = b""


@dataclass
class _MsgAuthRequest(Message):
    """Client -> mon ticket request (reference CEPH_AUTH_CEPHX
    MAuth): entity + proof of the per-entity key."""

    entity: str = ""
    nonce: bytes = b""
    proof: bytes = b""


@dataclass
class _MsgAuthReply(Message):
    """Mon -> client: sealed ticket + session key sealed under the
    entity key (result != 0 -> refused)."""

    result: int = 0
    ticket_blob: bytes = b""
    sealed_key: bytes = b""
    ttl: float = 3600.0
    error: str = ""


class _Session:
    """Per-peer outgoing session: seq numbering + unacked replay buffer
    (reference AsyncConnection out_seq/out_q)."""

    MAX_UNACKED = 512

    def __init__(self):
        self.conn: Optional["Connection"] = None
        self.seq = 0
        self.unacked: "OrderedDict[int, bytes]" = OrderedDict()
        self.overflowed = False
        # set by a chaos frame drop: NO later frame may go out until the
        # tail is replayed — the peer's acks are CUMULATIVE (ack of N
        # trims everything <= N), which is only sound while delivery is
        # in-order, so a skipped frame must block the session until
        # retransmission restores order
        self.needs_replay = False
        # unique attribute name on purpose: graftlint's static lock
        # resolver binds attr -> lock name, and PGState already owns
        # the bare attr `lock`
        self.order_lock = DepLock("messenger.session")

    def buffer(self, seq: int, frame: bytes) -> None:
        self.unacked[seq] = frame
        while len(self.unacked) > self.MAX_UNACKED:
            # cannot trim silently and still promise at-least-once: mark
            # the session broken so the next reconnect FAILS loudly
            # instead of replaying an incomplete tail
            self.overflowed = True
            self.unacked.popitem(last=False)

    def ack(self, seq: int) -> None:
        for s in [s for s in self.unacked if s <= seq]:
            del self.unacked[s]
        if not self.unacked:
            self.overflowed = False  # fully acked: contract restored


class Connection:
    def __init__(self, messenger: "Messenger", reader, writer,
                 peer: Optional[EntityName] = None,
                 peer_addr: Optional[Addr] = None):
        self.messenger = messenger
        self.reader = reader
        self.writer = writer
        self.peer = peer
        self.peer_addr = peer_addr
        self._send_lock = DepLock("messenger.conn_send")
        self._seq = 0
        self.closed = False
        # cephx session state (set by the authorizer handshake):
        # subsequent frames both ways sign with the session key, and
        # dispatchers consult peer_caps for authorization
        self.session_key: Optional[bytes] = None
        self.peer_entity: Optional[str] = None
        self.peer_caps: Optional[Dict[str, str]] = None

    def _sign_key(self) -> Optional[bytes]:
        return self.session_key if self.session_key is not None \
            else self.messenger.secret

    async def send(self, msg: Message) -> None:
        msg.src = self.messenger.name
        async with self._send_lock:
            self._seq += 1
            msg.seq = self._seq
            if msg.trace is not None:
                # hop stamp for replies riding raw connections (the
                # reply-leg half of op attribution; send_message stamps
                # session traffic the same way)
                msg.trace.setdefault("events", []).append(
                    (f"msgr:{self.messenger.name}:send", _time.time()))
            hs = _encode_hs(msg)
            if hs is not None:
                # handshake: fixed struct, pre-session, unsigned
                bufs = [struct.pack("<I", len(hs)), hs]
            else:
                payload = pickle.dumps(msg)
                secret = self._sign_key()
                sig = _sign(secret, payload) if secret is not None \
                    else b""
                # zero-copy framing: header/payload/signature go to the
                # transport as separate buffers — a 1 MiB payload is
                # never re-materialized into a fresh frame bytes
                bufs = [struct.pack("<IB",
                                    1 + len(payload) + len(sig),
                                    _FT_MSG), payload]
                if sig:
                    bufs.append(sig)
            try:
                for b in bufs:
                    self.writer.write(b)
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                self.closed = True
                raise

    async def close(self) -> None:
        self.closed = True
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError, RuntimeError,
                asyncio.TimeoutError):
            pass  # best-effort close of an already-dying transport


class Dispatcher:
    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        """Return True if handled."""
        return False

    async def ms_handle_reset(self, conn: Connection) -> None:
        ...


class Throttle:
    """Byte-budget backpressure (reference Throttle bound to the
    messenger policies, src/ceph_osd.cc:511-525 client-throttler): a
    reader acquires its frame's bytes before dispatch and releases
    after; when the budget is exhausted the reader WAITS — it stops
    draining its socket, so TCP backpressure propagates to the peer
    instead of the daemon queueing unboundedly."""

    def __init__(self, max_bytes: int):
        self.max = max_bytes
        self.cur = 0
        self.waiting = 0
        self._cond = asyncio.Condition()

    async def acquire(self, n: int) -> bool:
        """Returns True when the caller had to WAIT for budget — the
        signal the read loop stamps into the op's trace header so
        throttle wait shows up in per-stage attribution."""
        n = min(n, self.max)  # a single oversized frame must not wedge
        waited = False
        async with self._cond:
            self.waiting += 1
            try:
                while self.cur + n > self.max:
                    waited = True
                    await self._cond.wait()
            finally:
                self.waiting -= 1
            self.cur += n
        return waited

    async def release(self, n: int) -> None:
        n = min(n, self.max)
        async with self._cond:
            self.cur = max(0, self.cur - n)
            self._cond.notify_all()


@dataclass
class Policy:
    """Per-peer-type connection policy (reference Messenger::Policy):
    ``lossy`` sessions do NOT replay their unacked tail across a reset —
    the send fails and the peer re-requests (stateless client policy;
    enforced in _reconnect_replay); ``throttle`` bounds bytes
    concurrently in dispatch from peers of this type (backpressure in
    _read_loop)."""

    lossy: bool = False
    throttle: Optional[Throttle] = None


SIG_LEN = 16

# frame-type bytes: every frame is <u32 len><type><body>.  Type 0 is a
# pickled Message (signed when a key is bound); types 1-3 are the cephx
# handshake in FIXED struct encodings, so no unauthenticated byte ever
# reaches the pickle deserializer (the r4 advisor's high finding: the
# old handshake pickled first and authenticated after).
_FT_MSG, _FT_AUTH, _FT_AUTH_REQ, _FT_AUTH_REPLY = 0, 1, 2, 3


def _sign(secret: bytes, payload: bytes) -> bytes:
    return _hmac.new(secret, payload, hashlib.sha256).digest()[:SIG_LEN]


def _encode_hs(msg: Message) -> Optional[bytes]:
    """Handshake frame body (type byte + fixed struct), or None for
    ordinary messages."""
    if isinstance(msg, _MsgAuth):
        return bytes([_FT_AUTH]) + msg.authorizer
    if isinstance(msg, _MsgAuthRequest):
        e = msg.entity.encode()
        return (bytes([_FT_AUTH_REQ]) + struct.pack("<H", len(e)) + e +
                struct.pack("<B", len(msg.nonce)) + msg.nonce +
                struct.pack("<B", len(msg.proof)) + msg.proof)
    if isinstance(msg, _MsgAuthReply):
        err = msg.error.encode()
        return (bytes([_FT_AUTH_REPLY]) +
                struct.pack("<idII", msg.result, msg.ttl,
                            len(msg.ticket_blob), len(msg.sealed_key)) +
                msg.ticket_blob + msg.sealed_key +
                struct.pack("<H", len(err)) + err)
    return None


def _decode_hs(ftype: int, body: bytes) -> Message:
    try:
        if ftype == _FT_AUTH:
            return _MsgAuth(authorizer=body)
        if ftype == _FT_AUTH_REQ:
            (el,) = struct.unpack_from("<H", body)
            off = 2
            entity = body[off:off + el].decode()
            off += el
            nl = body[off]
            nonce = body[off + 1:off + 1 + nl]
            off += 1 + nl
            pl = body[off]
            proof = body[off + 1:off + 1 + pl]
            if off + 1 + pl != len(body):
                raise ValueError("trailing bytes")
            return _MsgAuthRequest(entity=entity, nonce=nonce, proof=proof)
        if ftype == _FT_AUTH_REPLY:
            result, ttl, tl, kl = struct.unpack_from("<idII", body)
            off = struct.calcsize("<idII")
            blob = body[off:off + tl]
            key = body[off + tl:off + tl + kl]
            off += tl + kl
            (el,) = struct.unpack_from("<H", body, off)
            err = body[off + 2:off + 2 + el].decode()
            if off + 2 + el != len(body) or len(blob) != tl or len(key) != kl:
                raise ValueError("trailing bytes")
            return _MsgAuthReply(result=result, ttl=ttl, ticket_blob=blob,
                                 sealed_key=key, error=err)
    except (struct.error, IndexError, UnicodeDecodeError, ValueError) as e:
        raise ConnectionError(f"malformed handshake frame: {e}")
    raise ConnectionError(f"unknown frame type {ftype}")


class Messenger:
    def __init__(self, name: EntityName, secret: bytes = None, auth=None,
                 config=None):
        self.name = name
        self.secret = secret
        # cephx mode (auth = auth.CephxContext): per-connection session
        # keys replace the global secret; secret must be None then
        self.auth = auth
        if auth is not None:
            self.secret = None
        # chaos net injector (ceph_tpu/chaos/net.py), rebuilt whenever
        # the owning daemon's chaos_net_* options change (injectargs
        # seam, like the reference's ms_inject_socket_failures).  None
        # when disabled: the send path pays one `is None` test.
        self.config = config
        self.chaos = None
        if config is not None:
            config.add_observer(self._chaos_observer)
            self._chaos_reconfig()
        # mon-side hook: callable(_MsgAuthRequest) -> _MsgAuthReply
        self.auth_server = None
        self.sid = next(_SID)
        self.dispatchers: List[Dispatcher] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._out: Dict[Addr, Connection] = {}
        self._sessions: Dict[Addr, _Session] = {}
        self._accepted: List[Connection] = []
        # live-task registry: completed tasks self-discard, or a chaos
        # run would grow one dead Task per dropped/reordered frame for
        # the daemon's lifetime
        self._tasks: Set[asyncio.Task] = set()
        self._auth_waiters: Dict[int, asyncio.Future] = {}
        self._closing = False
        self.my_addr: Optional[Addr] = None
        # per-peer-type policies (reference Messenger::set_policy, bound
        # in ceph_osd.cc:511-525); key None = default
        self._policies: Dict[Optional[str], Policy] = {}

    def _chaos_observer(self, name: str, value) -> None:
        if name.startswith("chaos_net") or name == "chaos_seed":
            self._chaos_reconfig()

    def _chaos_reconfig(self) -> None:
        from ceph_tpu_torch.chaos.net import NetInjector

        keep = self.chaos.partitions if self.chaos is not None else None
        self.chaos = NetInjector.from_config(
            self.config, str(self.name), keep_partitions=keep)

    def set_policy(self, peer_type: Optional[str], policy: Policy) -> None:
        """Bind a Policy for connections whose peer entity has ``type``
        (e.g. 'client', 'osd'); ``None`` sets the default."""
        self._policies[peer_type] = policy

    def policy_for(self, conn: "Connection") -> Optional[Policy]:
        ptype = conn.peer.type if conn.peer is not None else None
        return self._policies.get(ptype, self._policies.get(None))

    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        self._server = await asyncio.start_server(
            self._accept, host, port, limit=_STREAM_LIMIT)
        self.my_addr = self._server.sockets[0].getsockname()[:2]
        return self.my_addr

    async def _accept(self, reader, writer) -> None:
        _tune_socket(writer)
        conn = Connection(self, reader, writer)
        if self._closing:
            # a peer raced our shutdown: refuse, or the read loop would
            # keep Server.wait_closed() (which since py3.12 awaits every
            # handler) hanging until the PEER closes — a distributed
            # shutdown deadlock when that peer stops after us
            await conn.close()
            return
        self._accepted.append(conn)
        task = asyncio.current_task()
        if task is not None:
            self._track(task)
        await self._read_loop(conn)

    async def _read_loop(self, conn: Connection) -> None:
        try:
            while True:
                hdr = await conn.reader.readexactly(4)
                (n,) = struct.unpack("<I", hdr)
                if n < 1:
                    raise ConnectionError("empty frame")
                frame = await conn.reader.readexactly(n)
                # memoryview slicing: verification, signature strip, and
                # unpickle all run on views of the one received buffer —
                # no per-frame payload re-materialization (round 11)
                ftype, payload = frame[0], memoryview(frame)[1:]
                if ftype != _FT_MSG:
                    # handshake frames: fixed struct decode, no pickle
                    # (tiny; decoded from a plain bytes copy)
                    msg = _decode_hs(ftype, bytes(payload))
                    if self.auth is None or not await \
                            self._handle_auth_frame(conn, msg):
                        raise ConnectionError(
                            f"unexpected handshake frame type {ftype}")
                    continue
                if self.auth is not None and conn.session_key is None:
                    # cephx mode: nothing but the handshake may ride an
                    # unauthenticated connection — reject BEFORE any
                    # deserialization
                    raise ConnectionError("unauthenticated data frame")
                verify_key = conn.session_key if conn.session_key \
                    is not None else self.secret
                if verify_key is not None:
                    # verify BEFORE unpickling: unauthenticated bytes
                    # must never reach the deserializer
                    if len(payload) < SIG_LEN or not _hmac.compare_digest(
                            _sign(verify_key, payload[:-SIG_LEN]),
                            payload[-SIG_LEN:]):
                        raise ConnectionError("bad message signature")
                    payload = payload[:-SIG_LEN]
                msg = pickle.loads(payload)
                if conn.peer is None:
                    conn.peer = msg.src
                if msg.trace is not None:
                    # receive-side hop stamp: the trace header records
                    # when this endpoint took the message off the wire
                    # (arrival, before any dispatch queueing) — the
                    # "wire" stage boundary in op attribution
                    msg.trace.setdefault("events", []).append(
                        (f"msgr:{self.name}:recv", _time.time()))
                if isinstance(msg, _MsgAck):
                    sess = self._sessions.get(conn.peer_addr)
                    if sess is not None:
                        sess.ack(msg.acked)
                    continue
                if msg.sid:
                    # session traffic: ack so the sender can trim replay
                    try:
                        await conn.send(_MsgAck(acked=msg.seq))
                    except (ConnectionError, OSError, RuntimeError):
                        pass
                pol = self.policy_for(conn)
                thr = pol.throttle if pol is not None else None
                if thr is not None:
                    # byte-budget backpressure: waiting here stops this
                    # socket's drain, pushing TCP backpressure to the peer
                    if await thr.acquire(n) and msg.trace is not None:
                        # the wait was real: stamp it so attribution
                        # books the delta as throttle_wait, not wire
                        msg.trace.setdefault("events", []).append(
                            (f"throttle:{self.name}:acquired",
                             _time.time()))
                    # dispatch handoff seam: a dispatcher that QUEUES the
                    # message (the OSD's ShardedOpWQ analog) takes
                    # ownership by setting _throttle_held and releases
                    # after serving — the cap then bounds bytes in
                    # dispatch, not merely in enqueue
                    msg._throttle = thr
                    msg._throttle_bytes = n
                try:
                    for d in self.dispatchers:
                        if await d.ms_dispatch(conn, msg):
                            break
                finally:
                    if thr is not None and \
                            not getattr(msg, "_throttle_held", False):
                        await thr.release(n)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            # actually CLOSE the socket (not just flag it): a signature
            # mismatch must tear the TCP stream down so the peer's session
            # sees the failure and reconnect+replay engages, instead of
            # writing into a blackholed socket until overflow
            await conn.close()
            for d in self.dispatchers:
                try:
                    await d.ms_handle_reset(conn)
                except Exception:
                    # a broken reset hook must not kill the read loop,
                    # but it is a BUG in the dispatcher — surface it
                    import logging

                    logging.getLogger("ceph_tpu_torch.msgr").exception(
                        "%s: ms_handle_reset hook failed", self.name)

    async def _handle_auth_frame(self, conn: Connection, msg) -> bool:
        """cephx transport frames (already struct-decoded — the pickle
        deserializer never sees unauthenticated bytes; the authorizer's
        pickled interior sits behind the sealed ticket's MAC)."""
        from ceph_tpu_torch.cluster import auth as authmod

        if isinstance(msg, _MsgAuth):
            if self.auth.master is None:
                raise ConnectionError("no master key to verify authorizer")
            try:
                t = authmod.verify_authorizer(self.auth.master,
                                              msg.authorizer)
            except ValueError as e:
                # malformed/forged authorizer must tear the connection
                # down through the normal reset path (close +
                # ms_handle_reset), not kill the read-loop task
                raise ConnectionError(f"bad authorizer: {e}")
            conn.session_key = t.session_key
            conn.peer_entity = t.entity
            conn.peer_caps = t.caps
            return True
        if isinstance(msg, _MsgAuthRequest):
            if self.auth_server is None:
                raise ConnectionError("not an auth server")
            reply = self.auth_server(msg)
            await conn.send(reply)
            return True
        if isinstance(msg, _MsgAuthReply):
            fut = self._auth_waiters.pop(id(conn), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        return False

    async def cephx_bootstrap(self, mon_addr: Addr) -> None:
        """Client ticket bootstrap (reference MAuth round-trip): prove
        the entity key to a monitor, adopt the returned ticket."""
        import os as _os

        from ceph_tpu_torch.cluster import auth as authmod

        nonce = _os.urandom(16)
        proof = _hmac.new(self.auth.entity_secret,
                          b"authreq:" + self.auth.entity.encode() + nonce,
                          hashlib.sha256).digest()[:SIG_LEN]
        reader, writer = await asyncio.open_connection(
            mon_addr[0], mon_addr[1], limit=_STREAM_LIMIT)
        conn = Connection(self, reader, writer, peer_addr=tuple(mon_addr))
        fut = asyncio.get_event_loop().create_future()
        self._auth_waiters[id(conn)] = fut
        task = asyncio.get_event_loop().create_task(self._read_loop(conn))
        self._track(task)
        try:
            await conn.send(_MsgAuthRequest(entity=self.auth.entity,
                                            nonce=nonce, proof=proof))
            reply = await asyncio.wait_for(fut, timeout=10.0)
            if reply.result != 0:
                raise PermissionError(
                    f"auth refused for {self.auth.entity}: {reply.error}")
            self.auth.adopt(reply.ticket_blob, reply.sealed_key,
                            ttl_hint=getattr(reply, "ttl", 3600.0))
        finally:
            self._auth_waiters.pop(id(conn), None)
            await conn.close()

    async def connect(self, addr: Addr) -> Connection:
        if self.chaos is not None:
            # asymmetric partition: OUR connects to that peer fail like
            # a blackholed TCP connect; their path to us is untouched
            self.chaos.check_connect(addr)
        conn = self._out.get(tuple(addr))
        if conn is not None and not conn.closed:
            return conn
        reader, writer = await asyncio.open_connection(
            addr[0], addr[1], limit=_STREAM_LIMIT)
        _tune_socket(writer)
        conn = Connection(self, reader, writer, peer_addr=tuple(addr))
        if self.auth is not None:
            # authorizer-first (reference connection handshake): present
            # the ticket before any session traffic; the session key
            # signs everything after
            from ceph_tpu_torch.cluster import auth as authmod

            self.auth.ensure_ticket()
            await conn.send(_MsgAuth(authorizer=authmod.make_authorizer(
                self.auth.ticket_blob, self.auth.session_key)))
            conn.session_key = self.auth.session_key
        self._out[tuple(addr)] = conn
        task = asyncio.get_event_loop().create_task(self._read_loop(conn))
        self._track(task)
        return conn

    async def send_message(self, msg: Message, addr: Addr) -> None:
        """Session send: ordered at-least-once with reconnect + replay of
        the unacked tail (reference AsyncConnection replay)."""
        addr = tuple(addr)
        sess = self._sessions.get(addr)
        if sess is None:
            sess = self._sessions[addr] = _Session()
        async with sess.order_lock:
            sess.seq += 1
            msg.src = self.name
            msg.seq = sess.seq
            msg.sid = self.sid
            if msg.trace is not None:
                # messenger hop stamp: the trace header records when this
                # endpoint put the message on the wire
                msg.trace.setdefault("events", []).append(
                    (f"msgr:{self.name}:send", _time.time()))
            if self.chaos is not None:
                # batch-frame faults mutate the message BEFORE pickling
                # so the buffered replay frame carries the same partial
                # tick — the item loss is real, not racing replay
                self.chaos.mutate_batch(msg)
            payload = pickle.dumps(msg)
            # buffer the UNSIGNED payload and sign at write time with the
            # connection's key: a cephx ticket renewal mints a new session
            # key for NEW connections, while frames replayed over a fresh
            # connection must carry the fresh key's signature (signing at
            # buffer time would wedge the replay after every renewal)
            sess.buffer(sess.seq, payload)
            fate = None
            if self.chaos is not None:
                fate = self.chaos.on_frame(addr)
                if fate.delay:
                    await asyncio.sleep(fate.delay)
                if fate.drop:
                    # drop + socket failure (reference
                    # ms_inject_socket_failures): the frame stays in
                    # unacked, the connection dies, and the session is
                    # GATED (needs_replay) until a retransmission timer
                    # or the next send replays the tail in order —
                    # packet loss under retransmission, not silent
                    # erasure (under a partition the replayed reconnect
                    # fails too and the loss is real)
                    sess.needs_replay = True
                    old = self._out.pop(addr, None)
                    if old is not None:
                        await old.close()
                    self._track(
                        asyncio.get_event_loop().create_task(
                            self._replay_later(sess, addr,
                                               fate.retransmit)))
                    return
                if fate.reorder and not sess.needs_replay:
                    # a gated session must not leak frames around the
                    # replay: the peer's acks are cumulative, so a late
                    # frame delivered past the gate would trim the
                    # still-undelivered dropped frame from the replay
                    # buffer — silent erasure, not reordering
                    self._track(
                        asyncio.get_event_loop().create_task(
                            self._late_send(sess, addr, sess.seq,
                                            payload, fate.reorder)))
                    return
            try:
                if sess.needs_replay:
                    # a chaos drop gated this session: replay the whole
                    # unacked tail (this frame is buffered, so it rides
                    # the replay) before anything newer goes out
                    await self._reconnect_replay(sess, addr)
                    return
                conn = await self.connect(addr)
                bufs = self._frame_bufs(conn, payload)
                self._write_frame(conn, bufs)
                if fate is not None and fate.dup:
                    self._write_frame(conn, bufs)  # duplicate delivery:
                    # handlers are idempotent by contract — prove it
                await conn.writer.drain()
                # flush boundary on the CURRENT op's timeline (sub-op
                # fan-out runs under the op context; no-op otherwise)
                mark_current("msgr:flushed")
                if fate is not None and fate.reset:
                    # injected session reset AFTER the bytes left: the
                    # peer sees a clean close; our next send reconnects
                    # and replays the unacked tail
                    self._out.pop(addr, None)
                    await conn.close()
            except (ConnectionError, OSError, RuntimeError):
                if self._closing:
                    raise
                await self._reconnect_replay(sess, addr)

    async def _replay_later(self, sess: _Session, addr: Addr,
                            delay: float) -> None:
        """Chaos retransmission timer: replay the session's unacked tail
        after a dropped frame gated the session.  A failure here leaves
        the gate set — the next send retries the replay."""
        await asyncio.sleep(delay)
        if self._closing or not sess.needs_replay:
            return
        try:
            async with sess.order_lock:
                if sess.needs_replay:
                    await self._reconnect_replay(sess, addr, retries=1)
        except (ConnectionError, OSError, RuntimeError):
            pass

    async def _late_send(self, sess: _Session, addr: Addr, seq: int,
                         payload: bytes, delay: float) -> None:
        """Chaos reorder: this frame goes out AFTER traffic that was
        sent later (ordered-delivery violation, deliberately).  A
        failure here is a DROP, and by then the cumulative ack of later
        traffic may already have trimmed the frame from the replay
        buffer — so it is re-buffered (in seq order) and the session
        gated, turning the failure into packet loss under
        retransmission rather than silent erasure."""
        await asyncio.sleep(delay)
        try:
            conn = await self.connect(addr)
            self._write_frame(conn, self._frame_bufs(conn, payload))
            await conn.writer.drain()
        except (ConnectionError, OSError, RuntimeError):
            if self._closing:
                return
            async with sess.order_lock:
                if seq not in sess.unacked:
                    sess.unacked[seq] = payload
                    for s in sorted(sess.unacked):
                        sess.unacked.move_to_end(s)
                sess.needs_replay = True
            self._track(
                asyncio.get_event_loop().create_task(
                    self._replay_later(sess, addr, delay)))

    def _track(self, task: asyncio.Task) -> asyncio.Task:
        from ceph_tpu_torch.utils.tasks import track_task

        return track_task(self._tasks, task)

    def _frame_bufs(self, conn: Connection, payload: bytes) -> list:
        """Frame as a buffer list (header, payload, signature), written
        sequentially: large payloads pass straight to the transport
        instead of being copied into a fresh frame bytes per hop (the
        round-11 zero-copy framing; replay buffers still hold only the
        single pickled payload)."""
        key = conn._sign_key()
        sig = _sign(key, payload) if key is not None else b""
        bufs = [struct.pack("<IB", 1 + len(payload) + len(sig),
                            _FT_MSG), payload]
        if sig:
            bufs.append(sig)
        return bufs

    @staticmethod
    def _write_frame(conn: Connection, bufs: list) -> None:
        for b in bufs:
            conn.writer.write(b)

    async def _reconnect_replay(self, sess: _Session, addr: Addr,
                                retries: int = 3) -> None:
        """Re-open the peer connection and replay every unacked frame in
        order; raises when the peer stays unreachable."""
        if sess.overflowed:
            # frames were evicted while unacked: an in-order replay is no
            # longer possible — fail the send and reset the session so
            # future traffic starts from a clean (acked-empty) state
            sess.unacked.clear()
            sess.overflowed = False
            sess.needs_replay = False
            raise ConnectionError(
                f"session to {addr} lost unacked frames (overflow); "
                "cannot replay")
        old_conn = self._out.get(addr)
        if old_conn is not None:
            pol = self.policy_for(old_conn)
            if pol is not None and pol.lossy:
                # lossy peer policy (reference stateless client policy):
                # no replay across a reset — drop the unacked tail and
                # surface the failure so the caller re-requests
                sess.unacked.clear()
                sess.needs_replay = False
                raise ConnectionError(
                    f"lossy session to {addr} reset; not replaying")
        last: Optional[Exception] = None
        # capped exponential backoff with jitter between attempts (was:
        # immediate linear retry) — seeded via chaos_seed so scenario
        # retry timing replays with the fault schedule
        from ceph_tpu_torch.utils.backoff import ExpBackoff

        backoff = ExpBackoff(base=0.02, cap=0.5, rng=self._backoff_rng())
        for attempt in range(retries):
            old = self._out.pop(addr, None)
            if old is not None:
                await old.close()
            try:
                conn = await self.connect(addr)
                for payload in sess.unacked.values():
                    self._write_frame(conn, self._frame_bufs(conn,
                                                             payload))
                await conn.writer.drain()
                sess.needs_replay = False
                return
            except (ConnectionError, OSError, RuntimeError) as e:
                last = e
                await asyncio.sleep(backoff.next())
        # keep the session gated while undelivered frames remain: a later
        # send must replay them BEFORE anything newer, or the peer's
        # cumulative acks could trim a frame it never saw
        sess.needs_replay = bool(sess.unacked)
        raise last or ConnectionError(f"reconnect to {addr} failed")

    def _backoff_rng(self):
        """Seeded jitter stream when the daemon carries a chaos seed
        (deterministic scenario replay); fresh entropy otherwise."""
        if self.config is not None and self.config.chaos_seed:
            from ceph_tpu_torch.chaos.rng import stream

            return stream(self.config.chaos_seed,
                          f"backoff:{self.name}:{self.sid}")
        return None

    async def shutdown(self) -> None:
        self._closing = True
        if self.config is not None:
            # the config outlives this messenger (daemon bounces reuse
            # it): leave no observer behind to pin dead incarnations
            self.config.remove_observer(self._chaos_observer)
        if self._server:
            self._server.close()
        for conn in list(self._out.values()) + list(self._accepted):
            await conn.close()
        # cancel + drain reader/handler tasks BEFORE wait_closed: since
        # py3.12 wait_closed() awaits every connection handler, and a
        # handler blocked in its read loop only exits via EOF or cancel
        pending = [t for t in self._tasks if not t.done()]
        for t in pending:
            t.cancel()
        if pending:
            # teardown drain of just-cancelled reader tasks; their
            # results are void by definition
            await asyncio.gather(*pending, return_exceptions=True)  # graftlint: ignore[swallowed-async-error]
        if self._server:
            await self._server.wait_closed()
