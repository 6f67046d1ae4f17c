"""Decode-table LRU cache.

Mirrors the role of the reference's ErasureCodeIsaTableCache
(src/erasure-code/isa/ErasureCodeIsaTableCache.h:48, capacity 2516): decode
matrices are built per erasure-pattern signature and reused.  Ours caches the
bit-expanded decode matrix already resident on the device (a torch
tensor), so a cache hit costs nothing on the host.  Copy of
``ceph_tpu/ec/table_cache.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class DecodeTableCache:
    DEFAULT_CAPACITY = 2516  # same bound the reference uses

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._od: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable):
        try:
            value = self._od.pop(key)
        except KeyError:
            self.misses += 1
            return None
        self._od[key] = value
        self.hits += 1
        return value

    def put(self, key: Hashable, value) -> None:
        if key in self._od:
            self._od.pop(key)
        elif len(self._od) >= self.capacity:
            self._od.popitem(last=False)
        self._od[key] = value

    def __len__(self) -> int:
        return len(self._od)
