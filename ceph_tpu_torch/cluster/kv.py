"""KeyValueDB: the ordered key-value abstraction under the monitor/store.

Counterpart of ``ceph_tpu/cluster/kv.py``.

Behavioral mirror of reference src/kv/ (KeyValueDB.h): prefixed keyspace,
atomic transactions (set/rmkey/rmkeys_by_prefix), ordered iteration —
with MemDB (src/kv/MemDB.cc analog) and a store-backed implementation
persisting through an ObjectStore collection (the MonitorDBStore.h
pattern: mon state as a kv database over the storage layer).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


class KVTransaction:
    def __init__(self):
        self.ops: List[Tuple] = []

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rmkey", prefix, key))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmprefix", prefix))
        return self


class KeyValueDB:
    def submit_transaction(self, txn: KVTransaction) -> None:
        raise NotImplementedError

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        raise NotImplementedError


class MemDB(KeyValueDB):
    def __init__(self):
        self._data: Dict[str, Dict[str, bytes]] = {}

    def submit_transaction(self, txn: KVTransaction) -> None:
        for op in txn.ops:
            if op[0] == "set":
                _, p, k, v = op
                self._data.setdefault(p, {})[k] = v
            elif op[0] == "rmkey":
                _, p, k = op
                self._data.get(p, {}).pop(k, None)
            elif op[0] == "rmprefix":
                self._data.pop(op[1], None)

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self._data.get(prefix, {}).get(key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        yield from sorted(self._data.get(prefix, {}).items())


class StoreDB(KeyValueDB):
    """KV over an ObjectStore collection: one object per prefix, keys in
    its omap (the MonitorDBStore-over-storage pattern).  Inherits the
    store's durability (journaled FileStore -> durable kv)."""

    COLL = "kvdb"

    def __init__(self, store):
        from ceph_tpu_torch.cluster.store import Transaction

        self.store = store
        self._Transaction = Transaction
        store.queue_transaction(
            Transaction().create_collection(self.COLL))

    def submit_transaction(self, txn: KVTransaction) -> None:
        t = self._Transaction()
        for op in txn.ops:
            if op[0] == "set":
                _, p, k, v = op
                t.touch(self.COLL, p).omap_set(self.COLL, p, {k: v})
            elif op[0] == "rmkey":
                _, p, k = op
                t.omap_rmkeys(self.COLL, p, [k])
            elif op[0] == "rmprefix":
                t.remove(self.COLL, op[1])
        self.store.queue_transaction(t)

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self.store.omap_get(self.COLL, prefix).get(key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        yield from sorted(self.store.omap_get(self.COLL, prefix).items())
