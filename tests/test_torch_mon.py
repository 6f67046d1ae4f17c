"""The port's monitor against ``ceph_tpu``'s.

Both packages' maps are built from one spec (the same ``build_hierarchy``
arguments, pools, weights, upmaps, pg_temp and purges, each applied
through the package's own ``Incremental``), or the JAX map is carried
across field by field with ``port_map``.  Checked, exactly:

(a) a one-mon and a three-mon quorum of each package on loopback, fed the
    same seeded command sequence: every reply's ``(result, data)``, the
    final map and the cluster log (without its wall-clock stamps);
(b) the mint fuzz: seeded ``(old map, Incremental)`` pairs on 4x4 to 8x8
    maps with replicated and erasure pools of 64-512 PGs, where the port
    mints from ``pool_raw_up`` and the reference walks ``pg_raw_up`` PG by
    PG: the same ``new_pg_temp`` entries and the same counters;
(c) ``pool_raw_up`` equal to ``pg_raw_up`` on every seed, with upmaps and
    nonexistent OSDs present;
(d) the cases of ``tests/test_cluster_mon.py`` that need no OSD: leader
    failover in the middle of a pool create, a peon forwarding commands,
    the cluster log service;
(e) boot, failure reports coalescing into one epoch and beacon-grace
    mark-down, from stub OSD messengers;
(f) a store resume; and a ``device="cpu"`` peon that takes in maps sent
    from a CUDA map and never touches CUDA.

Every loopback scenario runs under its own ``asyncio.wait_for`` bound with
short election, paxos and tick timeouts.
"""

import asyncio
import copy
import dataclasses
import pickle
import types

import numpy as np
import pytest
import torch

import ceph_tpu.cluster.messages as jmessages
import ceph_tpu.cluster.messenger as jmessenger
import ceph_tpu.cluster.mon as jmon
import ceph_tpu.cluster.store as jstore
import ceph_tpu.crush.types as jtypes
import ceph_tpu.osdmap.osdmap as josd
import ceph_tpu.utils.config as jconfig
import ceph_tpu.utils.lockdep as jlockdep
import ceph_tpu_torch.cluster.messages as pmessages
import ceph_tpu_torch.cluster.messenger as pmessenger
import ceph_tpu_torch.cluster.mon as pmon
import ceph_tpu_torch.cluster.store as pstore
import ceph_tpu_torch.crush.types as ptypes
import ceph_tpu_torch.osdmap.osdmap as posd
import ceph_tpu_torch.utils.config as pconfig
import ceph_tpu_torch.utils.lockdep as plockdep
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REF = types.SimpleNamespace(
    name="ref", mon=jmon, M=jmessages, msgr=jmessenger, types=jtypes,
    osd=josd, Config=jconfig.Config, store=jstore, dev={})
PORT = types.SimpleNamespace(
    name="port", mon=pmon, M=pmessages, msgr=pmessenger, types=ptypes,
    osd=posd, Config=pconfig.Config, store=pstore, dev={"device": "cpu"})
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
BOUND = 60.0


@pytest.fixture(autouse=True)
def _port_lockdep_reset():
    """The port's lock graph is its own process-wide one (the conftest
    resets only the reference's)."""
    plockdep.LockDep.instance().reset()
    plockdep.DepLock._held.clear()
    yield
    plockdep.LockDep.instance().reset()
    plockdep.DepLock._held.clear()
    jlockdep.LockDep.instance().reset()


def run(coro, bound=BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def fast_config(pkg, **kw):
    """Test-speed timings: paxos rounds, leases and ticks.  The election
    timeout stays the default's: a survivor's proposals to a dead peer
    wait out the messenger's reconnect backoff, and a timeout shorter
    than that lets the survivors' elections duel for seconds."""
    opts = dict(mon_tick_interval=0.05, mon_election_timeout=0.3,
                mon_paxos_timeout=1.0, mon_lease_interval=0.1,
                mon_lease_ack_timeout=1.0, mon_osd_min_down_reporters=1,
                mon_osd_beacon_grace=0.6, mon_osd_down_out_interval=600.0,
                mon_osd_failure_coalesce=0.1)
    opts.update(kw)
    return pkg.Config(**opts)


# -- one spec, both packages -------------------------------------------------


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def port_crush(jc):
    """A reference CrushMap's fields as the port's CrushMap."""
    pc = ptypes.CrushMap(ptypes.Tunables(**_fields(jc.tunables)))
    for key, val in vars(jc).items():
        if key == "tunables":
            continue
        if key == "buckets":
            val = {bid: ptypes.Bucket(**copy.deepcopy(_fields(b)))
                   for bid, b in val.items()}
        elif key == "rules":
            val = [ptypes.Rule(**copy.deepcopy(_fields(r))) for r in val]
        elif key == "choose_args":
            assert not val, "choose_args are not carried across"
            val = {}
        else:
            val = copy.deepcopy(val)
        setattr(pc, key, val)
    return pc


def port_map(jm, device="cpu"):
    """A reference OSDMap's fields (numpy arrays and plain dicts) as the
    port's OSDMap on ``device``."""
    pm = posd.OSDMap(port_crush(jm.crush), jm.max_osd, device=device)

    def pg(p):
        return posd.PGid(p.pool, p.seed)

    for key, val in vars(jm).items():
        if key in ("crush", "_scalar", "_tensor", "device"):
            continue
        if key == "pools":
            val = {pid: posd.PGPool(**copy.deepcopy(_fields(p)))
                   for pid, p in val.items()}
        elif key in ("pg_upmap", "pg_upmap_items", "pg_temp",
                     "primary_temp"):
            val = {pg(p): copy.deepcopy(v) for p, v in val.items()}
        else:
            val = copy.deepcopy(val)
        setattr(pm, key, val)
    pm.invalidate_mappers()
    return pm


def plain(obj):
    """A map or delta field as plain Python (PGid keys as tuples), so the
    two packages' values compare."""
    if isinstance(obj, (josd.PGid, posd.PGid)):
        return (obj.pool, obj.seed)
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(plain(v) for v in obj)
    if isinstance(obj, list):
        return [plain(v) for v in obj]
    if isinstance(obj, set):
        return sorted(plain(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, plain(_fields(obj)))
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def map_state(m):
    """Everything a map holds that the monitor changes."""
    return plain({
        "epoch": m.epoch, "max_osd": m.max_osd,
        "exists": list(m.osd_exists), "up": list(m.osd_up),
        "weight": list(m.osd_weight), "flags": m.flags,
        "pools": m.pools, "rules": m.crush.rules,
        "buckets": m.crush.buckets, "pg_upmap_items": m.pg_upmap_items,
        "pg_temp": m.pg_temp, "primary_temp": m.primary_temp,
        "revoked": m.revoked_entities, "affinity": m.osd_primary_affinity,
        "addrs": m.osd_addrs, "mgr": m.mgr_addr})


def ec_rule(mod, cmap, size):
    """An erasure rule on the map's root: chooseleaf indep over hosts."""
    t = mod
    root = next(b for b, v in cmap.buckets.items()
                if v.type == max(x.type for x in cmap.buckets.values()))
    return cmap.add_rule(t.Rule(steps=[
        (t.RULE_TAKE, root, 0), (t.RULE_CHOOSELEAF_INDEP, size, 1),
        (t.RULE_EMIT, 0, 0)], type=3))


def spec_map(pkg, n_hosts, per_host, pools, device=None):
    """Both packages' map from one spec: ``pools`` of (pool_id, type,
    size, pg_num); erasure pools on an indep rule."""
    cmap, rep_rule = pkg.types.build_hierarchy(n_hosts, per_host)
    rules = {}
    for pid, ptype, size, pg_num in pools:
        if ptype == pkg.osd.POOL_TYPE_ERASURE and size not in rules:
            rules[size] = ec_rule(pkg.types, cmap, size)
    kw = {"device": device} if pkg is PORT else {}
    m = pkg.osd.OSDMap(cmap, **kw)
    for pid, ptype, size, pg_num in pools:
        rule = rules[size] if ptype == pkg.osd.POOL_TYPE_ERASURE \
            else rep_rule
        m.add_pool(pkg.osd.PGPool(
            pool_id=pid, type=ptype, size=size, min_size=max(1, size - 1),
            pg_num=pg_num, pgp_num=pg_num, crush_rule=rule,
            name=f"p{pid}"))
    return m


# -- (c) pool_raw_up ----------------------------------------------------------

REP, EC = posd.POOL_TYPE_REPLICATED, posd.POOL_TYPE_ERASURE


@pytest.mark.parametrize("ptype,size", [(REP, 3), (EC, 4), (REP, 2)],
                         ids=["replicated", "erasure", "replicated2"])
def test_pool_raw_up_equals_pg_raw_up(ptype, size):
    jm = spec_map(REF, 6, 4, [(1, ptype, size, 256)])
    rng = np.random.default_rng(7 + size)
    for pg in rng.choice(256, 24, replace=False).tolist():
        raw = jm.pg_raw_up(josd.PGid(1, pg))
        live = [o for o in raw if o < jm.max_osd]
        if live:
            jm.pg_upmap_items[josd.PGid(1, pg)] = [
                (live[0], int(rng.integers(0, 24)))]
    jm.pg_upmap[josd.PGid(1, 3)] = [0, 5, 9, 13][:size]
    # nonexistent OSDs: purged ids still placed until their weight drops
    jm.osd_exists[2] = jm.osd_exists[17] = False
    jm.osd_up[5] = False
    pm = port_map(jm)
    got = pm.pool_raw_up(1)
    # the list lengths the mint reads beside the rows
    lengths = pm._pool_raw(1)[1]
    assert got.shape == (256, size) and got.dtype == np.int64
    saw_short = 0
    for s in range(256):
        want = pm.pg_raw_up(posd.PGid(1, s))
        assert want == jm.pg_raw_up(josd.PGid(1, s))
        assert got[s].tolist() == \
            want + [ptypes.CRUSH_ITEM_NONE] * (size - len(want)), s
        assert lengths[s] == len(want), s
        saw_short += len(want) < size
    if ptype == REP:
        assert saw_short, "no replicated row lost a member to the filter"


# -- (b) the mint fuzz ----------------------------------------------------------


def _mint_case(seed):
    """One seeded (old map, Incremental) pair, as a spec both packages
    apply: returns (pre-mutations, the delta's fields, map shape)."""
    rng = np.random.default_rng(seed)
    n_hosts = int(rng.integers(4, 9))
    per_host = int(rng.integers(4, 9))
    n = n_hosts * per_host
    pools = [(1, REP, 3, int(rng.choice([64, 128, 256, 512])))]
    if rng.random() < 0.8:
        pools.append((2, EC, int(rng.integers(3, min(n_hosts - 1, 4) + 1)),
                      int(rng.choice([64, 128]))))
    return rng, n_hosts, per_host, n, pools


MINT_KINDS = ["drain", "upmap", "purge", "down", "pool", "weights",
              "explicit", "armed", "ec_purge"]


def mint_pair(seed):
    """Both packages' (map, Incremental) for fuzz case ``seed``: the JAX
    map takes the pre-state through its own Incrementals and the port's
    starts from ``port_map`` of it; the delta is built once per package
    from the same draws."""
    rng, n_hosts, per_host, n, pools = _mint_case(seed)
    jm = spec_map(REF, n_hosts, per_host, pools)
    kind = MINT_KINDS[seed % len(MINT_KINDS)]

    def j_inc(**kw):
        jm.apply_incremental(josd.Incremental(epoch=jm.epoch + 1, **kw))

    # pre-state shared by every kind: an upmap, an out OSD, a temp entry
    pg0 = josd.PGid(1, int(rng.integers(0, pools[0][3])))
    src = jm.pg_raw_up(pg0)[0]
    j_inc(new_pg_upmap_items={pg0: [(src, (src + per_host) % n)]},
          new_weights={int(rng.integers(0, n)): 0})
    # a stale handoff naming ids the map no longer has: swept
    j_inc(new_pg_temp={josd.PGid(1, 1): [n + 1, n + 2]})
    host = int(rng.integers(0, n_hosts))
    host_osds = list(range(host * per_host, (host + 1) * per_host))
    fields = {}

    def wholesale_drain():
        """Every host of one PG's members out: that PG (and any other
        placed on those hosts alone) is replaced wholesale."""
        victim = jm.pg_raw_up(josd.PGid(1, int(rng.integers(0, 64))))
        return {o: 0 for h in sorted({v // per_host for v in victim})
                for o in range(h * per_host, (h + 1) * per_host)}

    if kind == "drain":
        fields["new_weights"] = wholesale_drain()
    elif kind == "ec_purge":
        # an erasure PG's first host purged while in, its other hosts
        # drained: the PG's entry keeps a NONE in the purged slot
        pid = 2 if 2 in jm.pools else 1
        victim = [v for v in jm.pg_raw_up(josd.PGid(pid, int(
            rng.integers(0, jm.pools[pid].pg_num)))) if v < n]
        hosts = sorted({v // per_host for v in victim})
        fields["old_osds"] = tuple(range(hosts[0] * per_host,
                                         (hosts[0] + 1) * per_host))
        fields["new_weights"] = {o: 0 for h in hosts[1:]
                                 for o in range(h * per_host,
                                                (h + 1) * per_host)}
    elif kind == "upmap":
        items = {}
        for pid, _t, size, pg_num in pools:
            for seed_ in rng.choice(pg_num, 8, replace=False).tolist():
                raw = jm.pg_raw_up(josd.PGid(pid, seed_))
                members = [o for o in raw if o < n]
                others = [o for o in range(n) if o not in members]
                dst = rng.choice(others, len(members), replace=False)
                items[(pid, seed_)] = [(int(a), int(b))
                                       for a, b in zip(members, dst)]
        fields["new_pg_upmap_items"] = items
    elif kind == "purge":
        # the host drained and down in the old map, then purged
        j_inc(new_weights={o: 0 for o in host_osds}, new_down=host_osds)
        fields["old_osds"] = tuple(host_osds)
    elif kind == "down":
        fields["new_down"] = host_osds
    elif kind == "pool":
        fields["new_pools"] = {9: (REP, 3, 64)}
        fields["new_weights"] = {host_osds[0]: 0}
    elif kind == "weights":
        fields["new_weights"] = {int(o): int(rng.choice([0, 0x8000]))
                                 for o in rng.choice(n, n // 3,
                                                     replace=False)}
    elif kind == "explicit":
        fields["new_weights"] = wholesale_drain()
        fields["new_pg_temp"] = {(1, s): [int(rng.integers(0, n))]
                                 for s in range(0, pools[0][3], 5)}
    else:   # armed handoffs in the old map, some with every donor purged
        temps = {josd.PGid(1, s): [int(o) for o in
                                   rng.choice(n, 3, replace=False)]
                 for s in range(0, pools[0][3], 3)}
        j_inc(new_pg_temp=temps)
        gone = host_osds[:2]
        j_inc(new_weights={o: 0 for o in gone}, new_down=gone)
        fields["new_weights"] = {o: 0 for o in wholesale_drain()
                                 if o not in gone}
        fields["old_osds"] = tuple(gone)
    return jm, fields


def make_inc(pkg, m, fields):
    """The delta ``fields`` as ``pkg``'s Incremental on top of ``m``."""
    kw = {}
    for key, val in fields.items():
        if key in ("new_pg_upmap_items", "new_pg_temp"):
            val = {pkg.osd.PGid(*k): v for k, v in val.items()}
        elif key == "new_pools":
            rule = m.pools[1].crush_rule
            val = {pid: pkg.osd.PGPool(
                pool_id=pid, type=t, size=s, min_size=s - 1, pg_num=p,
                pgp_num=p, crush_rule=rule, name=f"p{pid}")
                for pid, (t, s, p) in val.items()}
        kw[key] = copy.deepcopy(val)
    return pkg.osd.Incremental(epoch=m.epoch + 1, **kw)


MINT_CASES = 14


@pytest.mark.parametrize("seed", range(MINT_CASES))
def test_mint_equals_reference(seed):
    jm, fields = mint_pair(seed)
    pm = port_map(jm)
    jmn = jmon.Monitor(jm, config=REF.Config())
    pmn = pmon.Monitor(pm, config=PORT.Config(), device="cpu")
    jinc, pinc = make_inc(REF, jm, fields), make_inc(PORT, pm, fields)
    jmn._mint_pg_temp(jinc)
    pmn._mint_pg_temp(pinc)
    assert plain(pinc.new_pg_temp) == plain(jinc.new_pg_temp)
    assert list(map(plain, pinc.new_pg_temp)) == \
        list(map(plain, jinc.new_pg_temp))
    for c in ("mon_pg_temp_minted", "mon_pg_temp_swept"):
        assert pmn.perf.get(c) == jmn.perf.get(c), c
    # the case reached the branches it was drawn for
    kind = MINT_KINDS[seed % len(MINT_KINDS)]
    # the stale entry is swept, unless a wholesale remap minted over it
    stale = jinc.new_pg_temp[josd.PGid(1, 1)]
    assert jmn.perf.get("mon_pg_temp_swept") == (stale == [])
    if kind in ("drain", "upmap", "explicit", "armed", "ec_purge"):
        assert jmn.perf.get("mon_pg_temp_minted") > 0, kind
    if kind in ("upmap", "ec_purge") and 2 in jm.pools:
        assert any(pg.pool == 2 for pg in jinc.new_pg_temp)
    if kind == "ec_purge" and 2 in jm.pools:
        assert any(ptypes.CRUSH_ITEM_NONE in v for pg, v in
                   jinc.new_pg_temp.items() if pg.pool == 2)
    # the delta still applies, and both maps land equal
    jm.apply_incremental(jinc)
    pm.apply_incremental(pinc)
    assert map_state(pm) == map_state(jm)


def test_mint_batched_calls():
    """The port's mint makes one batched placement per pool of both maps
    (none for a pool the old map lacks), whatever the pool's size."""
    from ceph_tpu_torch.utils.perf import KERNELS

    jm, fields = mint_pair(0)
    pm = port_map(jm)
    fields = dict(fields, new_pools={9: (REP, 3, 64)})
    pmn = pmon.Monitor(pm, config=PORT.Config(), device="cpu")
    inc = make_inc(PORT, pm, fields)
    before = KERNELS.get("crush_map_calls")
    pmn._mint_pg_temp(inc)
    assert KERNELS.get("crush_map_calls") - before == 2 * len(pm.pools)


# -- loopback quorums ----------------------------------------------------------


class StubConn:
    """The client end of a command: records the replies it is sent."""

    peer_caps = None
    closed = False

    def __init__(self):
        self.replies = {}

    async def send(self, msg):
        self.replies[msg.tid] = msg


def ready(m):
    """A leader that may propose: elected and past its collect phase."""
    return not m.stopped and m.is_leader and (m.paxos is None
                                              or m.paxos.active)


async def wait_for(pred, what, bound=10.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + bound
    while not pred():
        if loop.time() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.005)


async def leader_of(mons):
    await wait_for(lambda: any(ready(m) for m in mons), "no leader")
    return next(m for m in mons if ready(m))


def fresh_map(pkg, n_hosts=4, per_host=4, up=True):
    cmap, _ = pkg.types.build_hierarchy(n_hosts, per_host)
    m = pkg.osd.OSDMap(cmap, **pkg.dev)
    if not up:
        m.osd_up = [False] * m.max_osd
    return m


async def start_quorum(pkg, n, config=None, stores=None, osdmap=None):
    """``n`` monitors on 127.0.0.1 from one map; elections for n > 1."""
    cfg = config or fast_config(pkg)
    blob = pickle.dumps(osdmap or fresh_map(pkg))
    mons, addrs = [], []
    for r in range(n):
        mon = pkg.mon.Monitor(pickle.loads(blob), config=cfg, rank=r,
                              n_mons=n, store=stores[r] if stores else None,
                              **pkg.dev)
        addrs.append(await mon.start())
        mons.append(mon)
    if n > 1:
        for mon in mons:
            mon.set_monmap(addrs)
        await mons[0].begin_elections()
    await leader_of(mons)
    return mons, addrs


async def stop_all(mons):
    for m in mons:
        if not m.stopped:
            await m.stop()


_TID = [0]


async def command(pkg, mon, cmd):
    """One command through ``mon`` (a peon forwards it), its reply as
    (result, data)."""
    _TID[0] += 1
    tid = _TID[0]
    conn = StubConn()
    await mon._handle_command(conn, pkg.M.MMonCommand(cmd=dict(cmd),
                                                      tid=tid))
    await wait_for(lambda: tid in conn.replies, f"no reply to {cmd}")
    reply = conn.replies[tid]
    return reply.result, reply.data


async def settle(mons):
    """Wait until the leader's tick flushed its cluster-log buffer and
    every live monitor applied the same epoch."""
    live = [m for m in mons if not m.stopped]
    leader = await leader_of(live)
    # the tick pops the buffer before its commit lands: also wait for
    # the map mutex the commit holds
    await wait_for(lambda: not leader._pending_clog
                   and not leader._map_mutex._lock.locked(),
                   "clog never flushed")
    await wait_for(lambda: len({m.osdmap.epoch for m in live}) == 1
                   and all(len(m.cluster_log) == len(leader.cluster_log)
                           for m in live), "mons never converged")
    return leader


def command_sequence(seed, n_osds=16):
    """A seeded command sequence: pools (replicated and EC), out/in,
    upmaps and their removal, pg_num, snaps, rename, delete, health, df,
    the log, and a few refusals."""
    rng = np.random.default_rng(seed)
    outs = sorted(rng.choice(n_osds, 3, replace=False).tolist())
    ins = [o for o in range(n_osds) if o not in outs]
    items = {f"1.{s}": [[int(rng.integers(0, n_osds)),
                         int(rng.choice(ins))]]
             for s in sorted(rng.choice(16, 6, replace=False).tolist())}
    first = next(iter(items))
    return [
        {"prefix": "osd pool create", "pool": "rep",
         "pool_type": "replicated", "pg_num": 16, "size": 3},
        {"prefix": "osd pool create", "pool": "ec", "pool_type": "erasure",
         "pg_num": 8, "ec_profile": {"plugin": "jerasure",
                                      "technique": "reed_sol_van",
                                      "k": "2", "m": "1"}},
        {"prefix": "osd pool create", "pool": "rep"},
        {"prefix": "osd out", "ids": outs},
        {"prefix": "health"},
        {"prefix": "osd in", "id": outs[0]},
        {"prefix": "osd pg-upmap-items", "items": items},
        {"prefix": "osd pg-upmap-items", "items": {"1.999": [[0, 1]]}},
        {"prefix": "osd pg-upmap-items",
         "items": {"1.3": [[ins[0], outs[1]]]}},
        {"prefix": "osd rm-pg-upmap-items", "pgids": [first]},
        {"prefix": "osd pool set", "pool": "rep", "var": "pg_num",
         "val": 32},
        {"prefix": "osd pool set", "pool": "rep", "var": "pgp_num",
         "val": 32},
        {"prefix": "osd pool set", "pool": "ec", "var": "pg_num",
         "val": 16},
        {"prefix": "osd pool mksnap", "pool": "rep", "snap": "s1"},
        {"prefix": "osd pool mksnap", "pool": "rep", "snap": "s2"},
        {"prefix": "osd pool rmsnap", "pool": "rep", "snap": "s1"},
        {"prefix": "osd pool rename", "srcpool": "ec", "destpool": "ec2"},
        {"prefix": "osd pool delete", "pool": "ec2"},
        {"prefix": "osd pool delete", "pool": "ec2", "pool2": "ec2",
         "sure": True},
        # three of the four hosts out in one epoch: every PG placed on
        # exactly those hosts is replaced wholesale (a pg_temp mint)
        {"prefix": "osd out", "ids": list(range(12))},
        {"prefix": "status"},
        {"prefix": "health"},
        {"prefix": "df"},
        {"prefix": "log last", "num": 50},
        {"prefix": "no such command"},
    ]


def unstamped(reply):
    """A reply with the cluster log's wall-clock stamps left out."""
    result, data = reply
    if isinstance(data, list) and data and isinstance(data[0], dict) \
            and "stamp" in data[0]:
        data = [{k: v for k, v in e.items() if k != "stamp"} for e in data]
    return result, data


async def run_sequence(pkg, n_mons, seed):
    mons, _ = await start_quorum(pkg, n_mons)
    try:
        replies = []
        for i, cmd in enumerate(command_sequence(seed)):
            # alternate the monitor a command enters through: a peon
            # forwards to the leader
            await settle(mons)
            replies.append(unstamped(
                await command(pkg, mons[i % n_mons], cmd)))
        leader = await settle(mons)
        states = [map_state(m.osdmap) for m in mons]
        logs = [[(who, prio, msg) for who, _t, prio, msg in m.cluster_log]
                for m in mons]
        assert all(s == states[0] for s in states)
        assert all(log == logs[0] for log in logs)
        minted = leader.perf.get("mon_pg_temp_minted")
        return replies, states[0], logs[0], minted
    finally:
        await stop_all(mons)


@pytest.mark.parametrize("n_mons", [1, 3])
def test_command_sequence_equals_reference(n_mons):
    ref = run(run_sequence(REF, n_mons, 11))
    port = run(run_sequence(PORT, n_mons, 11))
    for i, (a, b) in enumerate(zip(port[0], ref[0])):
        assert plain(a) == plain(b), (i, a, b)
    assert port[1:] == ref[1:]
    results = [r for r, _d in ref[0]]
    assert results.count(0) >= 18 and {-22, -1, -95} <= set(results)
    assert ref[3] > 0, "the drain of three hosts minted no pg_temp"


# -- (d) the no-OSD cases of test_cluster_mon.py ---------------------------------


async def client_command(pkg, mons, cmd, bound=20.0):
    """Objecter-style: try the live monitors in turn, retrying a
    leaderless quorum (-11) or a dead forward target."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + bound
    while loop.time() < deadline:
        for m in mons:
            if m.stopped:
                continue
            try:
                res = await asyncio.wait_for(command(pkg, m, cmd), 3.0)
            except (ConnectionError, OSError, TimeoutError,
                    asyncio.TimeoutError):
                continue
            if res[0] != -11:
                return res
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{cmd} never committed")


@BOTH
def test_leader_failover_mid_pool_create(pkg):
    async def scenario():
        mons, _ = await start_quorum(pkg, 3)
        try:
            assert (await client_command(
                pkg, mons, {"prefix": "osd pool create", "pool": "before",
                            "pg_num": 8}))[0] == 0
            leader = await leader_of(mons)
            before = leader.perf.get("mon_proposals")
            task = asyncio.get_running_loop().create_task(command(
                pkg, leader, {"prefix": "osd pool create", "pool": "during",
                              "pg_num": 8}))
            await wait_for(lambda: leader.perf.get("mon_proposals") > before
                           or task.done(), "the create never reached paxos")
            await leader.stop()
            try:
                await asyncio.wait_for(task, 5.0)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass
            res = await client_command(
                pkg, mons, {"prefix": "osd pool create", "pool": "during",
                            "pg_num": 8})
            assert res[0] == 0
            survivors = [m for m in mons if not m.stopped]
            new_leader = await settle(survivors)
            assert new_leader.rank != leader.rank
            names = [sorted(p.name for p in m.osdmap.pools.values())
                     for m in survivors]
            assert names[0] == names[1] == ["before", "during"]
            return map_state(new_leader.osdmap)["pools"]
        finally:
            await stop_all(mons)

    pools = run(scenario())
    assert [p[1]["name"] for p in pools.values()] == ["before", "during"]


@BOTH
def test_peon_forwards_commands(pkg):
    async def scenario():
        mons, _ = await start_quorum(pkg, 3)
        try:
            leader = await leader_of(mons)
            peon = next(m for m in mons if not m.is_leader)
            res = await command(pkg, peon, {"prefix": "osd pool create",
                                            "pool": "viapeon", "pg_num": 4})
            assert res == (0, 1)
            assert any(p.name == "viapeon"
                       for p in leader.osdmap.pools.values())
            assert peon.perf.get("mon_commands_forwarded") >= 1
        finally:
            await stop_all(mons)

    run(scenario())


@BOTH
def test_cluster_log_service(pkg):
    """Daemon and mon events Paxos-replicate into a queryable log: a pool
    create, an MLog a daemon sent through a peon, and an induced failure
    all show in 'log last' on every monitor."""
    async def scenario():
        mons, _ = await start_quorum(pkg, 3)
        try:
            leader = await leader_of(mons)
            peon = next(m for m in mons if not m.is_leader)
            await command(pkg, leader, {"prefix": "osd pool create",
                                        "pool": "clogp", "pg_num": 4,
                                        "size": 2})
            await peon.ms_dispatch(StubConn(), pkg.M.MLog(entries=(
                ("osd.3", 1.0, "WRN", "slow request on osd.3"),)))
            await leader.ms_dispatch(StubConn(), pkg.M.MOSDFailure(
                failed_osd=7, reporter=2))
            await wait_for(lambda: not leader.osdmap.osd_up[7],
                           "osd.7 never marked down")
            leader = await settle(mons)
            res, entries = await command(pkg, peon, {"prefix": "log last",
                                                     "num": 50})
            msgs = [e["msg"] for e in entries]
            assert any("pool 'clogp' created" in m for m in msgs), msgs
            assert "slow request on osd.3" in msgs
            assert any("osd.7" in m and "down" in m for m in msgs), msgs
            assert all({"who", "stamp", "prio", "msg"} <= set(e)
                       for e in entries)
            return sorted((e["who"], e["prio"], e["msg"]) for e in entries)
        finally:
            await stop_all(mons)

    log = run(scenario())
    assert ("osd.3", "WRN", "slow request on osd.3") in log


def test_cluster_log_equals_reference():
    """The cluster-log case gives the same entries in both packages."""
    async def scenario(pkg):
        mons, _ = await start_quorum(pkg, 1)
        try:
            await command(pkg, mons[0], {"prefix": "osd pool create",
                                         "pool": "clogp", "pg_num": 4})
            await mons[0].ms_dispatch(StubConn(), pkg.M.MOSDFailure(
                failed_osd=7, reporter=2))
            await wait_for(lambda: not mons[0].osdmap.osd_up[7], "no down")
            await settle(mons)
            return [(w, p, m) for w, _t, p, m in mons[0].cluster_log]
        finally:
            await stop_all(mons)

    assert run(scenario(PORT)) == run(scenario(REF))


# -- (e) boot, coalesced failures, beacon grace ------------------------------------


async def stub_osds(pkg, ids, cfg):
    out = {}
    for i in ids:
        msgr = pkg.msgr.Messenger(pkg.msgr.EntityName("osd", i), config=cfg)
        await msgr.bind("127.0.0.1", 0)
        out[i] = msgr
    return out


async def osd_lifecycle(pkg):
    """Six stub OSDs boot; reports fail three of them inside one coalesce
    window; OSDs 0 and 1 keep beaconing and OSD 2 goes silent."""
    cfg = fast_config(pkg)
    mons, addrs = await start_quorum(pkg, 1, config=cfg,
                                     osdmap=fresh_map(pkg, 2, 3, up=False))
    mon = mons[0]
    osds = await stub_osds(pkg, range(6), cfg)
    try:
        for i, msgr in osds.items():
            await msgr.send_message(pkg.M.MOSDBoot(
                osd_id=i, addr=msgr.my_addr, instance=100 + i), addrs[0])
        await wait_for(lambda: all(mon.osdmap.osd_up), "boot")
        for failed in (3, 4, 5):
            await osds[0].send_message(pkg.M.MOSDFailure(
                failed_osd=failed, reporter=0), addrs[0])
        await wait_for(lambda: not any(mon.osdmap.osd_up[3:]), "failures")
        for _ in range(24):
            for i in (0, 1):
                await osds[i].send_message(pkg.M.MOSDAlive(osd_id=i),
                                           addrs[0])
            await asyncio.sleep(0.05)
        await wait_for(lambda: not mon.osdmap.osd_up[2], "beacon grace")
        await settle(mons)
        downs = [sorted(inc.new_down) for _e, inc in
                 sorted(mon._inc_log.items()) if inc.new_down]
        counters = {c: mon.perf.get(c) for c in (
            "mon_osd_boot", "mon_osd_marked_down", "mon_failures_coalesced",
            "mon_osd_boot_fenced")}
        log = sorted((w, p, m) for w, _t, p, m in mon.cluster_log)
        return list(mon.osdmap.osd_up), downs, counters, log
    finally:
        for msgr in osds.values():
            await msgr.shutdown()
        await stop_all(mons)


def test_boot_failures_and_beacon_grace_equal_reference():
    port = run(osd_lifecycle(PORT))
    ref = run(osd_lifecycle(REF))
    assert port == ref
    up, downs, counters, _log = port
    assert up == [True, True, False, False, False, False]
    assert downs == [[3, 4, 5], [2]]
    assert counters["mon_failures_coalesced"] == 2
    assert counters["mon_osd_boot"] == 6


# -- (f) store resume, and a CPU peon that never touches CUDA ------------------------


@BOTH
def test_store_resume(pkg, tmp_path):
    from ceph_tpu.cluster.filestore import FileStore as JFileStore
    from ceph_tpu_torch.cluster.filestore import FileStore as PFileStore

    make = PFileStore if pkg is PORT else JFileStore

    async def scenario():
        mons, _ = await start_quorum(pkg, 1, stores=[make(str(tmp_path))])
        await command(pkg, mons[0], {"prefix": "osd pool create",
                                     "pool": "kept", "pg_num": 16})
        await command(pkg, mons[0], {"prefix": "osd out", "ids": [0, 1]})
        await settle(mons)
        before = map_state(mons[0].osdmap)
        log = list(mons[0].cluster_log)
        await stop_all(mons)
        again, _ = await start_quorum(pkg, 1, stores=[make(str(tmp_path))])
        try:
            assert again[0].perf.get("mon_store_resumes") == 1
            assert map_state(again[0].osdmap) == before
            assert again[0].cluster_log == log
            res = await command(pkg, again[0], {"prefix": "osd pool create",
                                                "pool": "after"})
            assert res[0] == 0 and again[0].osdmap.epoch > before["epoch"]
        finally:
            await stop_all(again)

    run(scenario())


def test_cpu_peon_never_touches_cuda(monkeypatch, tmp_path):
    """Maps that arrive carrying a CUDA device (a full-map push from a
    card-side monitor, a store written by one) are put on the receiving
    monitor's CPU: with CUDA made to fail on any use, a peon takes such a
    push, then leads and commits placement changes (its mint maps whole
    pools), and a monitor resumes such a store."""
    from ceph_tpu_torch.cluster.filestore import FileStore
    from ceph_tpu_torch.cluster.kv import KVTransaction, StoreDB

    def no_cuda(*_a, **_k):
        raise AssertionError("CUDA was touched")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)

    async def scenario():
        mons, _ = await start_quorum(PORT, 3)
        try:
            leader = await leader_of(mons)
            await command(PORT, leader, {"prefix": "osd pool create",
                                         "pool": "a", "pg_num": 32})
            await settle(mons)
            peon = next(m for m in mons if not m.is_leader)
            pushed = copy.deepcopy(leader.osdmap)
            pushed.device = torch.device("cuda")
            pushed.epoch += 1
            await peon.ms_dispatch(StubConn(), PORT.M.MOSDMapMsg(
                epoch=pushed.epoch, osdmap_blob=pickle.dumps(pushed)))
            assert peon.osdmap.device.type == "cpu"
            assert peon.osdmap.pool_raw_up(1).shape == (32, 3)
            # the peon leads: its mint maps pool "a" on its own device
            for m in mons:
                if m is not peon:
                    await m.stop()
            peon.n_mons = 1
            peon.paxos = None
            peon.is_leader = True
            res = await command(PORT, peon, {"prefix": "osd out",
                                             "ids": [0, 1, 2, 3, 4, 5]})
            assert res[0] == 0
            assert peon.osdmap.tensor_mapper.device.type == "cpu"
        finally:
            await stop_all(mons)

    run(scenario())
    # a store holding a map pickled with a CUDA device resumes on the CPU
    store = FileStore(str(tmp_path))
    store.mount()
    m = fresh_map(PORT)
    m.device = torch.device("cuda")
    StoreDB(store).submit_transaction(
        KVTransaction().set("osdmap", "latest", pickle.dumps(m)))
    store.umount()

    async def resume():
        mon = pmon.Monitor(fresh_map(PORT), config=fast_config(PORT),
                           store=FileStore(str(tmp_path)), device="cpu")
        await mon.start()
        try:
            assert mon.perf.get("mon_store_resumes") == 1
            assert mon.osdmap.device.type == "cpu"
            await command(PORT, mon, {"prefix": "osd pool create",
                                      "pool": "b", "pg_num": 16})
            await command(PORT, mon, {"prefix": "osd out", "ids": [0]})
            assert mon.osdmap.tensor_mapper.device.type == "cpu"
        finally:
            await mon.stop()

    run(resume())
