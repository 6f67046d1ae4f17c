"""lockdep: runtime lock-ordering cycle detection.

Behavioral mirror of reference src/common/lockdep.cc (408 LoC): every
named lock acquisition records "held -> acquiring" ordering edges in a
global graph; an acquisition that would close a cycle raises immediately
with both conflicting chains — turning potential deadlocks into loud
failures at first occurrence.  Wraps asyncio locks (our serialization
primitive) the way the reference wraps Mutex.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Set


class LockCycleError(RuntimeError):
    pass


# op-trace seam (graft-trace): called as hook(lock_name, phase) with
# phase "wait" just before acquisition and "acquired" just after, so
# lock-wait time lands on the current op's event timeline without any
# per-call-site instrumentation.  The cluster's op tracker installs it
# at import; the default None keeps DepLock standalone.
TRACE_HOOK = None


class LockDep:
    _instance: Optional["LockDep"] = None

    def __init__(self):
        self.edges: Dict[str, Set[str]] = {}   # held -> then-acquired
        self.enabled = True

    @classmethod
    def instance(cls) -> "LockDep":
        if cls._instance is None:
            cls._instance = LockDep()
        return cls._instance

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS for an existing ordering path src -> ... -> dst."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self.edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def will_lock(self, name: str, held: List[str]) -> None:
        if not self.enabled:
            return
        for h in held:
            if h == name:
                continue
            # adding h -> name; a cycle exists if name -> ... -> h already
            back = self._path(name, h)
            if back is not None:
                raise LockCycleError(
                    f"lock ordering cycle: acquiring {name!r} while "
                    f"holding {h!r}, but existing order is "
                    f"{' -> '.join(back)}")
            self.edges.setdefault(h, set()).add(name)

    def reset(self) -> None:
        self.edges.clear()

    def dump(self) -> Dict[str, object]:
        """The observed runtime lock graph, JSON-shaped for the admin
        socket (`lockdep dump`) and for merging into a static lock
        graph."""
        return {
            "edges": {h: sorted(nxt) for h, nxt in sorted(self.edges.items())},
            "locks": sorted(set(self.edges) |
                            {n for nxt in self.edges.values() for n in nxt}),
            "held": {str(k): list(v) for k, v in DepLock._held.items() if v},
            "enabled": self.enabled,
        }


class DepLock:
    """An asyncio.Lock with lockdep tracking (named, per-task held set)."""

    _held: Dict[int, List[str]] = {}

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()

    def _task_key(self) -> int:
        return id(asyncio.current_task())

    async def __aenter__(self):
        key = self._task_key()
        held = DepLock._held.setdefault(key, [])
        LockDep.instance().will_lock(self.name, held)
        hook = TRACE_HOOK
        if hook is not None:
            hook(self.name, "wait")
        await self._lock.acquire()
        if hook is not None:
            hook(self.name, "acquired")
        held.append(self.name)
        return self

    async def __aexit__(self, *exc):
        key = self._task_key()
        held = DepLock._held.get(key, [])
        # pop the MOST RECENT occurrence: releases unwind LIFO, and
        # list.remove would drop the first (outermost) entry, corrupting
        # the per-task stack whenever same-named locks nest
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        if not held:
            DepLock._held.pop(key, None)
        self._lock.release()
        return False
