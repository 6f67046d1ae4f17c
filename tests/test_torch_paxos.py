"""The port's Elector and Paxos against ``ceph_tpu``'s.

Three monitors' consensus machinery of each package runs in one process:
every message goes through a stub ``send`` into a queue that a pump
delivers in a seeded order, and a partition is a set of ranks whose sends
fail.  The same schedule drives both packages, and each monitor's events
(elections won or followed, every committed ``(version, value)``, each
proposal's outcome) must be equal, as must what the schedule is built to
show: the lowest rank leads a fresh quorum, the freshest ``last_committed``
beats rank, a stepped-down leader proposes nothing, and a collect catches
a lagging peon up.  Each scenario runs under its own timeout.
"""

import asyncio
import random
import types

import pytest

import ceph_tpu.cluster.messages as jmessages
import ceph_tpu.cluster.paxos as jpaxos
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.cluster.messages as pmessages
import ceph_tpu_torch.cluster.paxos as ppaxos
import ceph_tpu_torch.utils.lockdep as plockdep
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(name="ref", paxos=jpaxos, M=jmessages)
PORT = types.SimpleNamespace(name="port", paxos=ppaxos, M=pmessages)
TIMEOUT = 0.05


@pytest.fixture(autouse=True)
def _lockdep_reset():
    for mod in (plockdep, jlockdep):
        mod.LockDep.instance().reset()
        mod.DepLock._held.clear()
    yield
    for mod in (plockdep, jlockdep):
        mod.LockDep.instance().reset()


class Net:
    """Three (Elector, Paxos) pairs wired through a seeded message pump."""

    def __init__(self, pkg, seed, n=3, fresh=None):
        self.pkg = pkg
        self.rng = random.Random(seed)
        self.queue = {}          # (src, dst) -> messages in send order
        self.cut = set()
        self.events = {r: [] for r in range(n)}
        self.tasks = set()
        fresh = fresh or {}
        self.electors, self.paxi = [], []
        for r in range(n):
            px = pkg.paxos.Paxos(r, n, self._sender(r), self._applier(r),
                                 timeout=TIMEOUT * 6)
            px.last_committed = fresh.get(r, 0)
            for v in range(1, px.last_committed + 1):
                px.values[v] = f"pre{v}".encode()
            self.paxi.append(px)
            self.electors.append(pkg.paxos.Elector(
                r, n, self._sender(r), self._elected(r), timeout=TIMEOUT,
                state_version=lambda px=px: px.last_committed))

    def _sender(self, src):
        async def send(dst, msg):
            if src in self.cut or dst in self.cut:
                raise ConnectionError("partitioned")
            self.queue.setdefault((src, dst), []).append(msg)
        return send

    def _applier(self, rank):
        async def apply(version, value):
            self.events[rank].append(("apply", version, value))
        return apply

    def _elected(self, rank):
        async def on_elected(leader, quorum, epoch):
            self.events[rank].append(("elected", leader, tuple(quorum),
                                      epoch))
            if leader == rank:
                await self.paxi[rank].leader_init(quorum)
            else:
                self.paxi[rank].step_down()
        return on_elected

    def _spawn(self, coro):
        task = asyncio.get_running_loop().create_task(coro)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def pump(self):
        """Deliver queued messages one at a time: a seeded choice of
        channel, each channel in send order (the messenger's sessions are
        ordered), each handler in its own task (a handler may wait on a
        round that only later deliveries complete)."""
        while True:
            chans = sorted(k for k, v in self.queue.items() if v)
            if chans:
                (_src, dst) = chan = chans[self.rng.randrange(len(chans))]
                msg = self.queue[chan].pop(0)
                if dst in self.cut:
                    continue
                if isinstance(msg, self.pkg.M.MMonElection):
                    self._spawn(self.electors[dst].handle(msg))
                else:
                    self._spawn(self.paxi[dst].handle(msg))
            await asyncio.sleep(0)

    async def leader(self, exclude=()):
        for _ in range(2000):
            for r, px in enumerate(self.paxi):
                if r not in exclude and px.leading and px.active and \
                        self.electors[r].leader == r:
                    return r
            await asyncio.sleep(0.002)
        raise TimeoutError("no leader")

    async def quiet(self):
        for _ in range(2000):
            if not any(self.queue.values()) and not self.tasks:
                return
            await asyncio.sleep(0.002)
        raise TimeoutError("the network never went quiet")


async def settled(net):
    """Past every election timer (a deferring elector waits four
    timeouts for the victory) and with nothing left in flight."""
    await asyncio.sleep(TIMEOUT * 6)
    await net.quiet()


def run(coro, bound=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


async def consensus(pkg, seed):
    """Elect, commit, partition a peon away while committing more, heal
    and re-elect from the lagging side (the collect catches it up), then
    step the leader down."""
    net = Net(pkg, seed)
    pump = asyncio.get_running_loop().create_task(net.pump())
    try:
        await net.electors[2].start_election()
        first = await net.leader()
        await settled(net)
        quorum = tuple(net.electors[first].quorum)
        outcomes = []
        for i in range(3):
            outcomes.append(await net.paxi[first].propose(f"v{i}".encode()))
        await net.quiet()
        lag = next(r for r in range(3) if r != first)
        net.cut = {lag}
        for i in range(3, 6):
            outcomes.append(await net.paxi[first].propose(f"v{i}".encode()))
        await net.quiet()
        lagging = net.paxi[lag].last_committed
        # the lagging peon campaigns with the other peon away: the
        # freshest monitor still wins, and its collect, which needs the
        # lagging peon's reply for a majority, catches it up
        net.cut = {3 - first - lag}
        await net.electors[lag].start_election()
        await settled(net)
        second = await net.leader()
        caught = [px.last_committed for px in net.paxi]
        net.cut = set()
        net.paxi[second].step_down()
        outcomes.append(await net.paxi[second].propose(b"refused"))
        await net.quiet()
        return {"first": first, "second": second, "lag": lag,
                "lagging": lagging, "caught": caught, "outcomes": outcomes,
                "quorum": quorum,
                "quorum2": tuple(net.electors[second].quorum),
                "events": net.events,
                "logs": [dict(px.values) for px in net.paxi]}
    finally:
        pump.cancel()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_consensus_equals_reference(seed):
    ref = run(consensus(REF, seed))
    port = run(consensus(PORT, seed))
    assert port == ref
    assert ref["first"] == 0 and ref["quorum"] == (0, 1, 2)
    assert ref["outcomes"] == [True] * 6 + [False]
    assert ref["lagging"] == 3
    assert ref["second"] == 0 and ref["quorum2"] == (0, ref["lag"])
    caught = ref["caught"]
    assert caught[ref["lag"]] == caught[0] == 6
    assert ref["logs"][ref["lag"]] == ref["logs"][0]
    # the monitors that took part applied v0..v5 once, in order
    for rank in (0, ref["lag"]):
        applied = [e[1:] for e in ref["events"][rank] if e[0] == "apply"]
        assert applied == [(v + 1, f"v{v}".encode()) for v in range(6)]


async def freshest(pkg, seed):
    """Rank 2 holds the freshest committed state: it wins over lower
    ranks, and its collect hands the peon that answers first what it
    lacks."""
    net = Net(pkg, seed, fresh={0: 1, 1: 2, 2: 4})
    pump = asyncio.get_running_loop().create_task(net.pump())
    try:
        await net.electors[0].start_election()
        await settled(net)
        leader = await net.leader()
        return {"leader": leader, "events": net.events,
                "caught": [px.last_committed for px in net.paxi],
                "epochs": [e.epoch for e in net.electors]}
    finally:
        pump.cancel()


@pytest.mark.parametrize("seed", [4, 5])
def test_freshest_wins_equals_reference(seed):
    ref = run(freshest(REF, seed))
    port = run(freshest(PORT, seed))
    assert port == ref
    assert ref["leader"] == 2
    # the collect's majority (the leader and the first peon to answer)
    # holds everything the leader had
    assert ref["caught"][2] == 4 and ref["caught"].count(4) >= 2
    assert len(set(ref["epochs"])) == 1 and ref["epochs"][0] % 2 == 0
