"""dmClock: reservation/weight/limit QoS scheduling.

Counterpart of ``ceph_tpu/cluster/dmclock.py``.

Behavioral analog of the reference's dmClock op scheduling
(src/dmclock/ vendored library + mClockOpClassQueue / mClockClientQueue,
src/osd/mClockOpClassQueue.h): each client class gets a QoS spec
(reservation = guaranteed ops/s, weight = proportional share of spare
capacity, limit = ops/s cap); every request is stamped with reservation/
proportion/limit tags derived from the previous tag (the dmClock paper's
tag arithmetic), and dequeue serves reservation-eligible requests by
R-tag first, then spare capacity by P-tag, never past the L-tag.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class QoSSpec:
    """Client-class service parameters (dmclock ClientInfo)."""

    reservation: float = 0.0   # guaranteed ops/s (0 = none)
    weight: float = 1.0        # share of spare capacity
    limit: float = 0.0         # ops/s cap (0 = unlimited)


@dataclass
class _Tags:
    r: float
    p: float
    l: float


class _ClientRec:
    def __init__(self, spec: QoSSpec):
        self.spec = spec
        self.prev: Optional[_Tags] = None
        self.queue: List[Tuple[int, object]] = []


class DmClockQueue:
    """Single-queue dmClock scheduler (the per-shard queue the reference
    plugs into ShardedOpWQ)."""

    def __init__(self, now=time.monotonic):
        self._clients: Dict[str, _ClientRec] = {}
        self._now = now
        self._seq = itertools.count()
        # conformance counters (dmclock PullReq phase telemetry): how
        # many dequeues were reservation-driven vs spare-capacity, and
        # how many queued requests were evicted to admit higher classes
        # under throttle pressure — exported via the OSD perf path
        self.stats: Dict[str, int] = {
            "served_reservation": 0, "served_spare": 0, "evicted": 0}

    def ensure_client(self, client: str, default: QoSSpec) -> None:
        """Install ``default`` only on first sight of the client."""
        if client not in self._clients:
            self._clients[client] = _ClientRec(default)

    def set_client(self, client: str, spec: QoSSpec) -> None:
        """Install/update a client's QoS spec; queued requests and tag
        history survive a spec change (injectargs-style live update)."""
        rec = self._clients.get(client)
        if rec is None:
            self._clients[client] = _ClientRec(spec)
        else:
            rec.spec = spec

    def enqueue(self, client: str, item) -> None:
        rec = self._clients.setdefault(client, _ClientRec(QoSSpec()))
        now = self._now()
        s = rec.spec
        prev = rec.prev
        # dmClock tag arithmetic: advance from the previous tag at the
        # class's configured rate, but never fall behind real time
        if prev is None:
            tags = _Tags(r=now, p=now, l=now)
        else:
            tags = _Tags(
                r=max(now, prev.r + (1.0 / s.reservation
                                     if s.reservation else 0.0)),
                p=max(now, prev.p + 1.0 / max(s.weight, 1e-9)),
                l=max(now, prev.l + (1.0 / s.limit if s.limit else 0.0)),
            )
        rec.prev = tags
        rec.queue.append((next(self._seq), item, tags))

    def _head(self, rec: _ClientRec):
        return rec.queue[0] if rec.queue else None

    def dequeue(self) -> Optional[object]:
        """One scheduling decision (dmclock PullPriorityQueue::pull):
        1. any reservation-eligible request (R-tag <= now) — smallest R;
        2. else the smallest P-tag whose limit allows service (L <= now);
        3. else nothing is currently eligible."""
        now = self._now()
        best_r = None
        best_p = None
        for name, rec in self._clients.items():
            head = self._head(rec)
            if head is None:
                continue
            _, _, tags = head
            if rec.spec.reservation and tags.r <= now:
                if best_r is None or tags.r < best_r[0]:
                    best_r = (tags.r, name)
            if tags.l <= now:
                if best_p is None or tags.p < best_p[0]:
                    best_p = (tags.p, name)
        pick = best_r or best_p
        if pick is None:
            return None
        self.stats["served_reservation" if pick is best_r
                   else "served_spare"] += 1
        rec = self._clients[pick[1]]
        _, item, _ = rec.queue.pop(0)
        return item

    def _evict_pick(self, match) -> Optional[str]:
        """The eviction victim's client: largest HEAD P-tag among
        matching clients with queued work — the class currently least
        entitled to service (head tag = its next scheduling position;
        the tail tag would just bias toward the longest backlog)."""
        best = None
        for name, rec in self._clients.items():
            if not rec.queue or not match(name):
                continue
            tag = rec.queue[0][2]
            if best is None or tag.p > best[0]:
                best = (tag.p, name)
        return best[1] if best is not None else None

    def peek_evict(self, match) -> Optional[object]:
        """The item ``evict(match)`` WOULD shed, without shedding it —
        the caller checks whether the eviction actually buys admission
        before dropping background work for nothing."""
        name = self._evict_pick(match)
        if name is None:
            return None
        return self._clients[name].queue[-1][1]

    def evict(self, match) -> Optional[object]:
        """Shed one queued request of a client whose name satisfies
        ``match`` — the youngest request of the client with the LARGEST
        head P-tag (the least-entitled class, its least-urgent work).
        The QoS-enforced shedding seam: under admission pressure the
        caller evicts background classes to admit reserved clients.
        Returns the evicted item, or None when nothing matches."""
        name = self._evict_pick(match)
        if name is None:
            return None
        rec = self._clients[name]
        _, item, _ = rec.queue.pop()
        self.stats["evicted"] += 1
        return item

    def evicted_total(self) -> int:
        return self.stats["evicted"]

    def purge(self, predicate) -> List[object]:
        """Remove and return every queued item satisfying ``predicate``
        (dead-work shedding: an op whose deadline passed must not wait
        for its L-tag to mature — it is dropped, not paced).  Tag
        history is untouched, so the class's pacing is unaffected."""
        out: List[object] = []
        for rec in self._clients.values():
            keep = []
            for entry in rec.queue:
                if predicate(entry[1]):
                    out.append(entry[1])
                else:
                    keep.append(entry)
            rec.queue[:] = keep
        return out

    def dump(self) -> Dict:
        """Conformance + queue-depth snapshot (the `dump_dmclock` admin
        payload): per-client spec, depth, and the global counters."""
        return {
            "stats": dict(self.stats),
            "clients": {
                name: {"reservation": rec.spec.reservation,
                       "weight": rec.spec.weight,
                       "limit": rec.spec.limit,
                       "queued": len(rec.queue)}
                for name, rec in self._clients.items()},
        }

    def next_eligible_in(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest queued head becomes limit-eligible
        (None when the queue is empty; 0 when something is ready)."""
        if now is None:
            now = self._now()
        best = None
        for rec in self._clients.values():
            head = self._head(rec)
            if head is None:
                continue
            wait = max(0.0, head[2].l - now)
            if best is None or wait < best:
                best = wait
        return best

    def drain_eligible(self, max_items: int = 1 << 30) -> List[object]:
        out = []
        while len(out) < max_items:
            item = self.dequeue()
            if item is None:
                break
            out.append(item)
        return out

    def __len__(self) -> int:
        return sum(len(r.queue) for r in self._clients.values())
