"""Elector + Paxos: the multi-monitor quorum machinery.

Counterpart of ``ceph_tpu/cluster/paxos.py``.

Behavioral mirror of the reference monitor consensus stack:

- Elector (src/mon/Elector.cc): rank-based leader election — a candidate
  proposes with a bumped election epoch, defers (acks) to lower ranks,
  and declares victory when a majority acked and no lower rank spoke up;
  epochs are odd while electing, even when stable.
- Paxos (src/mon/Paxos.cc): the leader runs collect (:146) to learn the
  peons' last_committed and any accepted-but-uncommitted value (promised
  under a higher proposal number), re-proposes it if newer, catches
  lagging peons up from its committed log, then serves begin (:606) /
  accept (:765) / commit (:840) rounds — ONE in-flight proposal at a
  time, exactly like the reference.
- Leases (:Paxos lease extend): the leader heartbeats the quorum; a peon
  whose lease goes stale calls a new election.

The Monitor drives these with callbacks: ``send(rank, msg)`` transmits to
a peer monitor, ``apply(version, value)`` applies a committed value to
the replicated state (the osdmap service), ``on_leader_change(leader)``
re-points forwarding.
"""

from __future__ import annotations

import asyncio
import pickle
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.utils.lockdep import DepLock


class Elector:
    def __init__(self, rank: int, n_mons: int, send, on_elected,
                 timeout: float = 0.3, state_version=None):
        self.rank = rank
        self.n = n_mons
        self.send = send                  # async (peer_rank, msg)
        self.on_elected = on_elected      # async (leader, quorum, epoch)
        self.timeout = timeout
        # the candidate-preference input: paxos
        # last_committed.  A peer holding NEWER committed state never
        # defers to a stale candidate — the reference's "deferred to
        # whoever has the freshest store" rule, which keeps a revived
        # blank monitor from winning (and forking epochs) before the
        # collect/catch-up path has healed it.
        self.state_version = state_version or (lambda: 0)
        self.epoch = 1
        self.electing = False
        self.stopped = False
        self.leader: Optional[int] = None
        self.quorum: List[int] = []
        self._acked: set = set()
        self._deferred_to: Optional[int] = None
        self._deferred_key: Optional[Tuple[int, int]] = None
        self._victory_task: Optional[asyncio.Task] = None

    def _cand_key(self, rank: int, last_committed: int) -> Tuple[int, int]:
        """Election preference: freshest committed state first, lowest
        rank as the tiebreak (smaller key wins)."""
        return (-last_committed, rank)

    @property
    def majority(self) -> int:
        return self.n // 2 + 1

    def stop(self) -> None:
        """A stopped monitor must never campaign again — a dead-but-
        running elector would starve the surviving quorum with endless
        lowest-rank proposals."""
        self.stopped = True
        self.electing = False
        if self._victory_task:
            self._victory_task.cancel()

    async def start_election(self) -> None:
        if self.electing or self.stopped:
            return
        self.electing = True
        self.leader = None
        self._deferred_to = None
        self._deferred_key = None
        if self.epoch % 2 == 0:
            self.epoch += 1
        else:
            self.epoch += 2
        self._acked = {self.rank}
        for r in range(self.n):
            if r != self.rank:
                try:
                    await self.send(r, M.MMonElection(
                        op="propose", epoch=self.epoch, rank=self.rank,
                        last_committed=self.state_version()))
                except (ConnectionError, OSError):
                    pass
        if self._victory_task:
            self._victory_task.cancel()
        self._victory_task = asyncio.get_event_loop().create_task(
            self._victory_check())

    async def _victory_check(self) -> None:
        await asyncio.sleep(self.timeout)
        if not self.electing:
            return
        if self._deferred_to is not None:
            # a lower rank is out there; wait for its victory, or retry
            await asyncio.sleep(self.timeout * 4)
            if self.electing:
                self._deferred_to = None
                self._deferred_key = None
                self.electing = False
                await self.start_election()
            return
        if len(self._acked) >= self.majority:
            self.epoch += 1  # stable epochs are even
            self.electing = False
            self.leader = self.rank
            self.quorum = sorted(self._acked)
            for r in range(self.n):
                if r != self.rank:
                    try:
                        await self.send(r, M.MMonElection(
                            op="victory", epoch=self.epoch, rank=self.rank,
                            quorum=self.quorum))
                    except (ConnectionError, OSError):
                        pass
            await self.on_elected(self.rank, self.quorum, self.epoch)
        else:
            # not enough acks (peers down / racing): retry
            self.electing = False
            await self.start_election()

    async def handle(self, msg: M.MMonElection) -> None:
        if self.stopped:
            return
        if msg.op == "propose":
            if msg.epoch > self.epoch:
                self.epoch = msg.epoch
                self._deferred_to = None
                self._deferred_key = None
            key = self._cand_key(msg.rank,
                                 getattr(msg, "last_committed", 0))
            if key < self._cand_key(self.rank, self.state_version()):
                # defer to the preferred candidate (reference
                # Elector::defer + the catch-up guard: freshest
                # committed state beats rank) — but ack at most ONE
                # candidate per epoch unless a strictly better one
                # appears, or two mutually-unreachable candidates could
                # both collect a majority
                if self._deferred_key is not None and \
                        key >= self._deferred_key:
                    return
                self._deferred_to = msg.rank
                self._deferred_key = key
                if not self.electing:
                    self.electing = True
                    self._acked = set()
                    if self._victory_task:
                        self._victory_task.cancel()
                    self._victory_task = asyncio.get_event_loop() \
                        .create_task(self._victory_check())
                try:
                    await self.send(msg.rank, M.MMonElection(
                        op="ack", epoch=msg.epoch, rank=self.rank))
                except (ConnectionError, OSError):
                    pass
            else:
                # a worse candidate (higher rank, or staler committed
                # state) is campaigning: counter with our own
                if not self.electing or self._deferred_to is None:
                    self.electing = False
                    await self.start_election()
        elif msg.op == "ack":
            if self.electing and msg.epoch == self.epoch:
                self._acked.add(msg.rank)
        elif msg.op == "victory":
            # accept a strictly newer epoch, or break same-epoch ties in
            # favour of the LOWER rank (dueling-candidates window)
            if msg.epoch > self.epoch or (
                    msg.epoch == self.epoch and
                    (self.leader is None or msg.rank < self.leader)):
                self.epoch = msg.epoch
                self.electing = False
                self.leader = msg.rank
                self.quorum = list(msg.quorum)
                if self._victory_task:
                    self._victory_task.cancel()
                await self.on_elected(msg.rank, self.quorum, msg.epoch)


class Paxos:
    """Single-decree-at-a-time multi-Paxos over the mon quorum."""

    def __init__(self, rank: int, n_mons: int, send, apply_fn,
                 timeout: float = 1.0):
        self.rank = rank
        self.n = n_mons
        self.send = send                  # async (peer_rank, msg)
        self.apply_fn = apply_fn          # async (version, value)
        self.timeout = timeout
        self.last_committed = 0
        self.accepted_pn = 0
        self.values: Dict[int, bytes] = {}   # committed log (trimmed)
        self.max_log = 500
        # peon-side promised-but-uncommitted value
        self.uncommitted: Optional[Tuple[int, int, bytes]] = None
        self.leading = False
        self.active = False               # collect finished, may propose
        self.quorum: List[int] = []
        self._propose_lock = DepLock("paxos.propose")
        self._round_waiter: Optional[asyncio.Future] = None
        self._round_acks: set = set()
        self._round_key: Tuple = ()
        self._pending_commits: Dict[int, bytes] = {}

    @property
    def majority(self) -> int:
        return self.n // 2 + 1

    # ------------------------------------------------------------- leader

    async def leader_init(self, quorum: List[int]) -> None:
        """Collect phase after winning an election (Paxos.cc:146)."""
        self.leading = True
        self.active = False
        self.quorum = list(quorum)
        pn = ((self.accepted_pn // 100) + 1) * 100 + self.rank
        self.accepted_pn = pn
        self._round_key = ("collect", pn)
        self._round_acks = {self.rank}
        self._replies: List[M.MMonPaxos] = []
        fut = self._round_waiter = asyncio.get_event_loop().create_future()
        for r in self.quorum:
            if r != self.rank:
                try:
                    await self.send(r, M.MMonPaxos(
                        op="collect", pn=pn, rank=self.rank,
                        last_committed=self.last_committed))
                except (ConnectionError, OSError):
                    pass
        try:
            await asyncio.wait_for(fut, timeout=self.timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._round_waiter = None
        # adopt the newest uncommitted value promised under this pn
        best: Optional[Tuple[int, int, bytes]] = None
        if self.uncommitted and self.uncommitted[1] == self.last_committed + 1:
            best = self.uncommitted
        for rep in self._replies:
            if rep.uncommitted_version == self.last_committed + 1 and \
                    rep.uncommitted_value:
                if best is None or rep.uncommitted_pn > best[0]:
                    best = (rep.uncommitted_pn, rep.uncommitted_version,
                            rep.uncommitted_value)
        self.active = True
        if best is not None:
            await self.propose(best[2])

    async def propose(self, value: bytes) -> bool:
        """begin/accept/commit one value (Paxos.cc:606,765,840)."""
        if not (self.leading and self.active):
            return False
        async with self._propose_lock:
            if not (self.leading and self.active):
                return False
            version = self.last_committed + 1
            pn = self.accepted_pn
            self.uncommitted = (pn, version, value)
            self._round_key = ("accept", pn, version)
            self._round_acks = {self.rank}
            fut = self._round_waiter = \
                asyncio.get_event_loop().create_future()
            for r in self.quorum:
                if r != self.rank:
                    try:
                        await self.send(r, M.MMonPaxos(
                            op="begin", pn=pn, rank=self.rank,
                            version=version, value=value,
                            last_committed=self.last_committed))
                    except (ConnectionError, OSError):
                        pass
            try:
                await asyncio.wait_for(fut, timeout=self.timeout)
            except asyncio.TimeoutError:
                return False
            finally:
                self._round_waiter = None
            # majority accepted: commit
            await self._commit(version, value)
            for r in self.quorum:
                if r != self.rank:
                    try:
                        await self.send(r, M.MMonPaxos(
                            op="commit", pn=pn, rank=self.rank,
                            version=version, value=value))
                    except (ConnectionError, OSError):
                        pass
            return True

    # --------------------------------------------------------------- peon

    def step_down(self) -> None:
        self.leading = False
        self.active = False

    async def _commit(self, version: int, value: bytes) -> None:
        if version != self.last_committed + 1:
            if version > self.last_committed + 1:
                self._pending_commits[version] = value
                # a rejoiner behind a TRIMMED log can never drain this
                # gap from commits alone (the map itself resyncs via
                # the mon's osdmap subscription; the log via the next
                # election's collect) — bound the buffer so a long-dead
                # revived peon does not grow it for the quorum's life
                while len(self._pending_commits) > self.max_log:
                    del self._pending_commits[min(self._pending_commits)]
            return
        self.values[version] = value
        self.last_committed = version
        if self.uncommitted and self.uncommitted[1] <= version:
            self.uncommitted = None
        for v in sorted(k for k in self.values if
                        k <= self.last_committed - self.max_log):
            del self.values[v]
        await self.apply_fn(version, value)
        # drain any out-of-order commits that are now contiguous
        while self.last_committed + 1 in self._pending_commits:
            v = self.last_committed + 1
            await self._commit(v, self._pending_commits.pop(v))

    async def handle(self, msg: M.MMonPaxos) -> None:
        if msg.op == "collect":
            if msg.pn > self.accepted_pn:
                self.accepted_pn = msg.pn
                self.step_down()
                reply = M.MMonPaxos(
                    op="last", pn=msg.pn, rank=self.rank,
                    last_committed=self.last_committed)
                if self.uncommitted:
                    reply.uncommitted_pn = self.uncommitted[0]
                    reply.uncommitted_version = self.uncommitted[1]
                    reply.uncommitted_value = self.uncommitted[2]
                # a peon AHEAD of the collecting leader hands it the
                # committed values it lacks (reference handle_collect
                # share_state): without this a lagging new leader would
                # re-propose old version numbers and fork the state
                if msg.last_committed < self.last_committed:
                    reply.catch_up = [
                        (v, self.values[v])
                        for v in range(msg.last_committed + 1,
                                       self.last_committed + 1)
                        if v in self.values]
                try:
                    await self.send(msg.rank, reply)
                except (ConnectionError, OSError):
                    pass
        elif msg.op == "last":
            if self._round_waiter is not None and \
                    self._round_key == ("collect", msg.pn):
                # learn anything the peon committed that we lack FIRST
                for v, blob in msg.catch_up:
                    await self._commit(v, blob)
                self._replies.append(msg)
                self._round_acks.add(msg.rank)
                # catch a lagging peon up from the committed log
                if msg.last_committed < self.last_committed:
                    catch = [(v, self.values[v])
                             for v in range(msg.last_committed + 1,
                                            self.last_committed + 1)
                             if v in self.values]
                    try:
                        await self.send(msg.rank, M.MMonPaxos(
                            op="commit", pn=msg.pn, rank=self.rank,
                            version=0, catch_up=catch))
                    except (ConnectionError, OSError):
                        pass
                if len(self._round_acks) >= self.majority and \
                        not self._round_waiter.done():
                    self._round_waiter.set_result(None)
        elif msg.op == "begin":
            # version guard: never accept a proposal for a version we
            # already committed (a stale leader that missed commits)
            if msg.pn >= self.accepted_pn and \
                    msg.version == self.last_committed + 1:
                # promise invariant: once we accept pn we must refuse any
                # later collect with a lower pn (reference handle_begin)
                self.accepted_pn = msg.pn
                self.uncommitted = (msg.pn, msg.version, msg.value)
                try:
                    await self.send(msg.rank, M.MMonPaxos(
                        op="accept", pn=msg.pn, rank=self.rank,
                        version=msg.version))
                except (ConnectionError, OSError):
                    pass
        elif msg.op == "accept":
            if self._round_waiter is not None and \
                    self._round_key == ("accept", msg.pn, msg.version):
                self._round_acks.add(msg.rank)
                if len(self._round_acks) >= self.majority and \
                        not self._round_waiter.done():
                    self._round_waiter.set_result(None)
        elif msg.op == "commit":
            for v, blob in msg.catch_up:
                await self._commit(v, blob)
            if msg.version:
                await self._commit(msg.version, msg.value)
