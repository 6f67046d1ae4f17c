"""Object classes: server-side ops executing inside the OSD.

Counterpart of ``ceph_tpu/cluster/objclass.py``.

Behavioral mirror of the reference's cls plugin system (src/cls/ +
src/objclass/ hooks): a registry of named classes, each exposing named
methods invoked through the client "exec" op against one object; the
method runs ON the primary with transactional access to the object's
data, xattrs, and omap — the seam RBD/RGW/lock/refcount build on.

Python classes register with ``register(name)`` the way the reference's
``CLS_INIT`` entry points do (cls_hello, cls_lock, cls_refcount analogs
are built in below).
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional


class ClsError(Exception):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(msg)
        self.errno = errno_


class MethodContext:
    """What a class method may do to its object (objclass.h ops subset).

    Reads happen against the store; mutations are collected into the
    op's transaction so they commit + replicate atomically with the op.
    """

    def __init__(self, store, coll: str, oid: str, txn):
        self._store = store
        self._coll = coll
        self.oid = oid
        self._txn = txn

    # -- reads --
    def read(self, offset: int = 0, length: Optional[int] = None) -> bytes:
        try:
            return self._store.read(self._coll, self.oid, offset, length)
        except FileNotFoundError:
            return b""

    def stat(self) -> Optional[int]:
        return self._store.stat(self._coll, self.oid)

    def getxattr(self, name: str) -> Optional[bytes]:
        return self._store.getattr(self._coll, self.oid, "_" + name)

    def omap_get(self) -> Dict[str, bytes]:
        return self._store.omap_get(self._coll, self.oid)

    # -- writes (transactional) --
    def write(self, offset: int, data: bytes) -> None:
        self._txn.write(self._coll, self.oid, offset, data)

    def setxattr(self, name: str, value: bytes) -> None:
        self._txn.setattr(self._coll, self.oid, "_" + name, value)

    def rmxattr(self, name: str) -> None:
        self._txn.rmattr(self._coll, self.oid, "_" + name)

    def omap_set(self, kv: Dict[str, bytes]) -> None:
        self._txn.omap_set(self._coll, self.oid, kv)

    def omap_rmkeys(self, keys) -> None:
        self._txn.omap_rmkeys(self._coll, self.oid, list(keys))


Method = Callable[[MethodContext, bytes], bytes]


class ClassRegistry:
    _instance: Optional["ClassRegistry"] = None

    def __init__(self):
        self._classes: Dict[str, Dict[str, Method]] = {}

    @classmethod
    def instance(cls) -> "ClassRegistry":
        if cls._instance is None:
            cls._instance = ClassRegistry()
        return cls._instance

    def register(self, cls_name: str, method: str, fn: Method) -> None:
        self._classes.setdefault(cls_name, {})[method] = fn

    def call(self, cls_name: str, method: str, ctx: MethodContext,
             indata: bytes) -> bytes:
        methods = self._classes.get(cls_name)
        if methods is None:
            raise ClsError(-95, f"no such class {cls_name}")  # EOPNOTSUPP
        fn = methods.get(method)
        if fn is None:
            raise ClsError(-95, f"{cls_name} has no method {method}")
        return fn(ctx, indata)


def register(cls_name: str, method: str):
    def deco(fn: Method) -> Method:
        ClassRegistry.instance().register(cls_name, method, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# Built-in classes (reference cls_hello / cls_lock / cls_refcount analogs)
# ---------------------------------------------------------------------------


@register("hello", "say_hello")
def _hello(ctx: MethodContext, indata: bytes) -> bytes:
    name = indata.decode() if indata else "world"
    return f"Hello, {name}!".encode()


@register("lock", "lock")
def _lock(ctx: MethodContext, indata: bytes) -> bytes:
    """Exclusive advisory lock (cls_lock subset): indata = pickled
    {name, cookie}; fails with -16 (EBUSY) when held by another cookie."""
    req = pickle.loads(indata)
    key = f"lock.{req['name']}"
    cur = ctx.getxattr(key)
    if cur is not None and cur != req["cookie"].encode():
        raise ClsError(-16, "lock held")
    ctx.setxattr(key, req["cookie"].encode())
    return b""


@register("lock", "unlock")
def _unlock(ctx: MethodContext, indata: bytes) -> bytes:
    req = pickle.loads(indata)
    key = f"lock.{req['name']}"
    cur = ctx.getxattr(key)
    if cur is None:
        raise ClsError(-2, "no such lock")
    if cur != req["cookie"].encode():
        raise ClsError(-16, "lock held by another cookie")
    ctx.rmxattr(key)
    return b""


@register("refcount", "get")
def _ref_get(ctx: MethodContext, indata: bytes) -> bytes:
    refs = pickle.loads(ctx.getxattr("refcount") or pickle.dumps(set()))
    refs.add(indata.decode())
    ctx.setxattr("refcount", pickle.dumps(refs))
    return b""


@register("refcount", "put")
def _ref_put(ctx: MethodContext, indata: bytes) -> bytes:
    refs = pickle.loads(ctx.getxattr("refcount") or pickle.dumps(set()))
    refs.discard(indata.decode())
    ctx.setxattr("refcount", pickle.dumps(refs))
    return pickle.dumps(len(refs))


@register("inotable", "alloc")
def _ino_alloc(ctx: MethodContext, indata: bytes) -> bytes:
    """Atomic inode-number allocation (reference InoTable): the
    read-increment-write runs under the OSD's PG serialization."""
    cur = ctx.omap_get().get("next", b"2")
    ino = int(cur)
    ctx.omap_set({"next": str(ino + 1).encode()})
    return str(ino).encode()


@register("dirfrag", "link")
def _dirfrag_link(ctx: MethodContext, indata: bytes) -> bytes:
    """Create-exclusive dentry insert (reference MDS dirfrag link):
    EEXIST when the name is already present — atomic under PG order."""
    req = pickle.loads(indata)
    if req["name"] in ctx.omap_get():
        raise ClsError(-17, "dentry exists")  # EEXIST
    ctx.omap_set({req["name"]: req["value"]})
    return b""

@register("rbd_journal", "append")
def _rbd_journal_append(ctx: MethodContext, indata: bytes) -> bytes:
    """Atomic journal append (reference cls_journal): allocate the next
    sequence under PG serialization and store the event at it, so two
    racing writers can never claim the same journal slot."""
    import pickle as _p

    omap = ctx.omap_get()
    seq = int(omap.get("_head", b"0")) + 1
    ctx.omap_set({"_head": str(seq).encode(),
                  f"{seq:016d}": indata})
    return str(seq).encode()


@register("rbd_journal", "trim")
def _rbd_journal_trim(ctx: MethodContext, indata: bytes) -> bytes:
    """Drop entries at or below the committed position (reference
    cls_journal client-commit + trim)."""
    upto = int(indata)
    omap = ctx.omap_get()
    dead = [k for k in omap
            if not k.startswith("_") and int(k) <= upto]
    if dead:
        ctx.omap_rmkeys(dead)
    return str(len(dead)).encode()



@register("rgw_mp", "alloc")
def _mp_alloc(ctx: MethodContext, indata: bytes) -> bytes:
    """Atomic multipart upload-id allocation (reference cls_rgw keeps
    multipart meta under the bucket index the same way): the counter
    read-increment-write runs under PG serialization, so two racing
    InitMultipart calls can never mint the same id.  The counter key is
    underscore-prefixed so registry listings can filter it."""
    seq = int(ctx.omap_get().get("_next", b"1"))
    ctx.omap_set({"_next": str(seq + 1).encode()})
    return str(seq).encode()


@register("rgw_bilog", "append")
def _bilog_append(ctx: MethodContext, indata: bytes) -> bytes:
    """Atomic bucket-index-log append (reference cls_rgw bilog ops):
    seq allocation + entry write + window trim run as ONE transaction
    under PG serialization, so concurrent index mutations can never
    collide on a sequence number or lose an entry.  indata: pickled
    {"entry": bytes, "max": int}; returns the allocated seq."""
    import pickle as _p

    req = _p.loads(indata)
    head_b = ctx.getxattr("bilog.head")
    seq = (int(head_b) if head_b else 0) + 1
    ctx.omap_set({f"{seq:012d}": req["entry"]})
    ctx.setxattr("bilog.head", str(seq).encode())
    maxlen = int(req.get("max", 1000))
    if seq > maxlen:
        cutoff = seq - maxlen
        ctx.omap_rmkeys([f"{s:012d}"
                         for s in range(max(1, cutoff - 64), cutoff + 1)])
        ctx.setxattr("bilog.tail", str(cutoff).encode())
    return str(seq).encode()
