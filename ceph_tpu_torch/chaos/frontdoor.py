"""Front-door chaos scenarios: RBD / RGW / MDS under named crash points.

Counterpart of ``ceph_tpu/chaos/frontdoor.py``.  ``run_frontdoor`` takes
the ``device`` every daemon and client of its cluster runs on: CUDA
unless the caller names another (``device="cpu"`` for the plain
versions); it raises when CUDA is absent and no device was named.

The OSD-level crash points stop at the librados data plane — no crash
point fires inside an RBD copy-up, an RGW multipart complete, or an MDS
journal write, and no invariant can express "the snapshot read back
torn".  This module runs the L8 front doors as chaos workloads:

- **RBD**: generation writes to fixed regions of a striped image, a
  snapshot per round (``rbd_snap_pre_header`` interrupts between snap-id
  allocation and the header save), a clone from the first snapshot
  (``rbd_clone_mid`` between child registration and the child header)
  whose child writes copy-up under ``rbd_copyup_mid``;
- **RGW**: one multipart upload per round — parts (``rgw_part_mid``
  orphans a payload), then a seeded fate: complete
  (``rgw_complete_mid`` cuts between final payload and index flip),
  abort (``rgw_abort_mid``), or abandon; the heal phase runs the
  ``reclaim_multipart`` pass before judging;
- **MDS**: seeded mkdir/create/rename traffic while ``mds_journal_mid``
  / ``mds_replay_mid`` crash the rank (a daemon — it dies through the
  vstart callback and a babysitter restarts it into journal replay).

Client-library points interrupt-and-retry (``ChaosInterrupt``): the
"application" dies mid-transaction and a seeded coin decides whether a
restarted application retries.  The verdict is judged by the
application-level invariants of the shared table
(``snapshot``, ``multipart``, ``namespace`` in
``scenario.judge_invariants``), against the workload's own bookkeeping
(``FrontdoorState``).  Same replay contract as every other scenario:
``build_schedule`` + per-surface seeded streams make a seed's run — and
its verdict — bit-identical.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.daemons import DaemonInjector
from ceph_tpu_torch.chaos.points import ChaosInterrupt
from ceph_tpu_torch.chaos.rng import stream
from ceph_tpu_torch.chaos.scenario import (
    Event,
    Verdict,
    apply_event,
    build_schedule,
    heal_cluster,
    judge_invariants,
    wait_converged,
)


@dataclass(frozen=True)
class FrontdoorScenario:
    """Declarative front-door chaos shape (the Scenario analog; shares
    Event/build_schedule, so schedules resolve identically)."""

    name: str
    osds: int = 3
    pool_size: int = 3
    pg_num: int = 8
    rounds: int = 2
    store: str = "mem"                       # "mem" | "file" | "blue"
    surfaces: Tuple[str, ...] = ("rbd", "rgw", "mds")
    events: Tuple[Event, ...] = ()
    invariants: Tuple[str, ...] = ("snapshot", "multipart", "namespace",
                                   "acting", "health", "lockdep")
    config: Tuple[Tuple[str, object], ...] = ()
    # rbd shape: region_size-aligned whole-region writes are single
    # atomic OSD ops (one extent in one object), so per-region history
    # is judgeable; object_size = 2 regions makes copy-up meaningful
    # (a child write to one region materializes its neighbor)
    regions: int = 6
    region_size: int = 16 << 10
    # rgw shape
    parts_per_upload: int = 3
    part_size: int = 4 << 10
    # mds ops per round
    meta_ops: int = 5
    op_timeout: float = 30.0                 # per front-door op budget
    load: Optional[object] = None            # LoadSpec driven per round
    converge_timeout: float = 60.0


class FrontdoorState:
    """The workload's application-level bookkeeping — the judge context
    the snapshot/multipart/namespace invariants convict against.  The
    invariant checks consume only the attributes/methods below, so the
    synthetic-history unit tests can drive them with fakes."""

    IMAGE = "fdimg"
    CLONE = "fdclone"
    BUCKET = "fdbucket"

    def __init__(self, sc: FrontdoorScenario):
        self.sc = sc
        self.io = None                       # judge-side IoCtx
        self.rgw = None                      # judge-side RGW handle
        self.fsc = None                      # judge-side MDSClient
        self.region_size = sc.region_size
        self.image_name = self.IMAGE
        self.clone_name = self.CLONE
        self.bucket = self.BUCKET
        self.parent_snap = "fs0"
        # rbd history: per-region attempted payload sets + last ack;
        # `dirty` regions had an attempt whose outcome is unknown (a
        # timed-out RADOS op may still land late), so they are never
        # pinned as stable parent-snap content
        self.rbd_attempted: Dict[int, Set[bytes]] = {}
        self.rbd_acked: Dict[int, bytes] = {}
        self.rbd_dirty: Set[int] = set()
        # regions that may legitimately still read as ZEROS: every
        # attempt so far failed, so nothing provably landed — cleared
        # by the first ack (after which zeros can never reappear)
        self.rbd_zero_ok: Set[int] = set()
        self.snaps: Dict[str, Dict[int, frozenset]] = {}
        self.parent_pin: Dict[int, bytes] = {}
        self.clone_attempted: Dict[int, Set[bytes]] = {}
        self.clone_acked: Dict[int, bytes] = {}
        self.clone_expect: Dict[int, frozenset] = {}
        # rgw history
        self.mp_completed: Dict[str, bytes] = {}
        self.mp_pending: Dict[str, bytes] = {}
        # mds history
        self.ns_model: Dict[str, str] = {}
        self.ns_gone: Set[str] = set()

    # -- judge surfaces (duck-typed for the invariant checks) ----------

    async def open_image(self, name: str):
        from ceph_tpu_torch.cluster.rbd import RBD

        return await RBD(self.io).open(name)

    async def part_oids(self) -> List[str]:
        prefix = self.rgw._mp_prefix(self.bucket)
        return [o for o in await self.io.list_objects()
                if o.startswith(prefix)]

    async def fs_stat(self, path: str):
        self.fsc._lease.clear()              # judge reads, not cached
        return await self.fsc.stat(path)

    async def fs_listdir(self, path: str):
        self.fsc._lease.clear()
        return await self.fsc.listdir(path)

    # -- judge-prep ----------------------------------------------------

    def finish_clone_expect(self) -> None:
        """Resolve per-region clone expectations from the recorded
        history: child-acked regions hold the child's bytes (or any
        attempted generation — at-least-once), untouched pinned regions
        fall through to the pinned parent snap, unacked child attempts
        accept either side."""
        for r, pinned in self.parent_pin.items():
            attempted = self.clone_attempted.get(r)
            if r in self.clone_acked:
                self.clone_expect[r] = frozenset(
                    {self.clone_acked[r]} | (attempted or set()))
            elif attempted:
                self.clone_expect[r] = frozenset(attempted | {pinned})
            else:
                self.clone_expect[r] = frozenset({pinned})


def _payload(rng, tag: str, size: int) -> bytes:
    body = f"{tag}-{rng.randrange(1 << 30)}-".encode()
    return (body * (size // len(body) + 1))[:size]


# ------------------------------------------------------------ workloads


class _Runner:
    def __init__(self, sc: FrontdoorScenario, seed: int, cluster,
                 admin, pool: int, meta_pool: int, data_pool: int):
        self.sc = sc
        self.seed = seed
        self.cluster = cluster
        self.admin = admin
        self.pool = pool
        self.meta_pool = meta_pool
        self.data_pool = data_pool
        self.st = FrontdoorState(sc)
        self.rbd_rng = stream(seed, "fd_rbd")
        self.rgw_rng = stream(seed, "fd_rgw")
        self.mds_rng = stream(seed, "fd_mds")
        self._img = None
        self._clone = None
        self._mds_stop = asyncio.Event()
        self._ns_seq = 0

    # -- setup ---------------------------------------------------------

    async def setup(self) -> None:
        from ceph_tpu_torch.cluster.mds import MDSClient
        from ceph_tpu_torch.cluster.rbd import RBD
        from ceph_tpu_torch.cluster.rgw import RGW

        sc, st = self.sc, self.st
        st.io = self.admin.ioctx(self.pool)
        if "rbd" in sc.surfaces:
            rbd = RBD(st.io)
            await rbd.create(st.IMAGE, sc.regions * sc.region_size,
                             stripe_unit=sc.region_size, stripe_count=1,
                             object_size=2 * sc.region_size)
            self._img = await rbd.open(st.IMAGE)
        if "rgw" in sc.surfaces:
            st.rgw = RGW(st.io)
            await st.rgw.create_bucket(st.BUCKET)
        if "mds" in sc.surfaces:
            await self.cluster.start_mds(self.meta_pool, self.data_pool)
            await self._wait_mds_addr()
            st.fsc = MDSClient(self.admin, self.data_pool,
                               meta_pool=self.meta_pool)
            await st.fsc.mkdir("/fd")
            st.ns_model["/fd"] = "dir"

    async def _wait_mds_addr(self, timeout: float = 15.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            await self.admin.objecter._refresh_map()
            if getattr(self.admin.objecter.osdmap, "mds_addr", None):
                return
            await asyncio.sleep(0.05)
        raise TimeoutError("MDS never registered in the map")

    # -- the MDS babysitter --------------------------------------------
    #
    # MDS crash points kill the daemon; metadata traffic (and the
    # namespace invariant) need the rank back — the babysitter restarts
    # crashed ranks into journal replay.  A rank whose BOOT crashes at
    # an armed mds_replay_mid dies again mid-replay (ChaosCrash out of
    # start_mds); the point is one-shot per config, so the next lap
    # completes the replay.

    async def mds_babysitter(self) -> None:
        from ceph_tpu_torch.chaos import ChaosCrash

        while not self._mds_stop.is_set():
            for rank, pools in list(self.cluster.mds_pools.items()):
                daemon = (self.cluster.mdss or {}).get(rank)
                if daemon is not None and not daemon._stopped:
                    continue
                try:
                    await self.cluster.start_mds(pools[0], pools[1],
                                                 rank=rank)
                except ChaosCrash:
                    continue            # replay-seam crash: next lap
                except (IOError, OSError, TimeoutError,
                        ConnectionError):
                    continue            # cluster still converging
            try:
                await asyncio.wait_for(self._mds_stop.wait(),
                                       timeout=0.15)
            except asyncio.TimeoutError:
                pass

    async def ensure_mds(self, timeout: float = 20.0) -> None:
        """Post-heal: the rank must be up and replayed before judging."""
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            daemon = (self.cluster.mdss or {}).get(0)
            if daemon is not None and not daemon._stopped:
                return
            await asyncio.sleep(0.1)
        raise TimeoutError("MDS rank 0 never came back after heal")

    # -- rbd round -----------------------------------------------------

    async def _reopen_image(self):
        from ceph_tpu_torch.cluster.rbd import RBD

        self._img = await RBD(self.st.io).open(self.st.IMAGE)
        return self._img

    async def _rbd_write(self, img_get, attempted, acked, dirty,
                         region: int, payload: bytes, retry: bool,
                         reopen) -> None:
        """One whole-region write with interrupt-and-retry: the
        ChaosInterrupt is the client process dying; ``retry`` (drawn
        from the seeded stream BEFORE the attempt, so the stream never
        depends on whether the point fired) decides if a restarted
        client re-drives the op against a FRESH handle."""
        attempted.setdefault(region, set()).add(payload)
        if region not in acked and acked is self.st.rbd_acked:
            # nothing has provably landed here yet: a failed attempt
            # leaves the region legitimately zero (judge bookkeeping)
            self.st.rbd_zero_ok.add(region)
        rs = self.sc.region_size
        for attempt in range(2):
            try:
                img = await img_get()
                await img.write(region * rs, payload,
                                timeout=self.sc.op_timeout)
                acked[region] = payload
                dirty.discard(region)
                self.st.rbd_zero_ok.discard(region)
                return
            except ChaosInterrupt:
                if not retry or attempt:
                    break
                CHAOS.inc("interrupt_retries")
                await reopen()
            except (IOError, OSError, TimeoutError):
                break
        dirty.add(region)

    async def rbd_round(self, rnd: int) -> None:
        sc, st, rng = self.sc, self.st, self.rbd_rng
        regs = sorted(rng.sample(range(sc.regions),
                                 max(1, sc.regions // 2)))
        plan = [(r, _payload(rng, f"g{rnd}-reg{r}", sc.region_size),
                 rng.random() < 0.7) for r in regs]
        for region, payload, retry in plan:
            await self._rbd_write(lambda: self._img_get(), st.rbd_attempted,
                                  st.rbd_acked, st.rbd_dirty,
                                  region, payload, retry,
                                  self._reopen_image)
        await self._rbd_snap(rnd)
        if rnd >= 1:
            await self._rbd_clone_phase(rnd)

    async def _img_get(self):
        if self._img is None:
            await self._reopen_image()
        return self._img

    async def _rbd_snap(self, rnd: int) -> None:
        st, rng = self.st, self.rbd_rng
        name = f"fs{rnd}"
        for attempt in range(2):
            try:
                img = await self._img_get()
                await img.snap_create(name, timeout=self.sc.op_timeout)
            except ChaosInterrupt:
                if attempt:
                    return
                CHAOS.inc("interrupt_retries")
                await self._reopen_image()
                continue
            except FileExistsError:
                pass    # the retried create's first half had landed
            except (IOError, OSError, TimeoutError):
                return  # unacked snap: never judged
            break
        # acked: record the point-in-time contract — each judged region
        # must hold ONE whole generation attempted before this instant.
        # Regions where every attempt so far FAILED may legitimately
        # still be zeros (nothing provably landed), so their allowed
        # set includes the virgin states; one ack retires that forever.
        rs = self.sc.region_size
        zero_states = frozenset({b"", b"\x00" * rs})
        st.snaps[name] = {
            r: frozenset(attempts) | (zero_states if r in st.rbd_zero_ok
                                      else frozenset())
            for r, attempts in st.rbd_attempted.items()}

    async def _rbd_clone_phase(self, rnd: int) -> None:
        from ceph_tpu_torch.cluster.rbd import RBD

        sc, st, rng = self.sc, self.st, self.rbd_rng
        if st.parent_snap not in st.snaps:
            return                       # parent snap never acked
        rs = sc.region_size
        if self._clone is None and rnd == 1:
            # pin stable parent-snap content BEFORE any child churn:
            # only clean regions (every attempt acked) are stable
            # against late-landing writes
            img = await self._img_get()
            for r in sorted(set(st.rbd_acked) - st.rbd_dirty):
                if r in st.snaps[st.parent_snap]:
                    try:
                        st.parent_pin[r] = bytes(await img.read(
                            r * rs, rs, snap_name=st.parent_snap,
                            timeout=sc.op_timeout))
                    except (IOError, OSError, TimeoutError,
                            KeyError):
                        pass
            for attempt in range(2):
                try:
                    await RBD(st.io).clone(st.IMAGE, st.parent_snap,
                                           st.CLONE,
                                           timeout=sc.op_timeout)
                except ChaosInterrupt:
                    if attempt:
                        return
                    CHAOS.inc("interrupt_retries")
                    continue
                except FileExistsError:
                    pass
                except (IOError, OSError, TimeoutError):
                    return
                break
            try:
                self._clone = await RBD(st.io).open(st.CLONE)
            except (IOError, OSError, TimeoutError,
                    FileNotFoundError):
                return
        if self._clone is None:
            return

        async def reopen():
            self._clone = await RBD(st.io).open(st.CLONE)

        async def clone_get():
            return self._clone

        pinned = sorted(st.parent_pin)
        if not pinned:
            return
        targets = sorted(rng.sample(pinned,
                                    max(1, len(pinned) // 2)))
        for r in targets:
            payload = _payload(rng, f"child-g{rnd}-reg{r}", rs)
            retry = rng.random() < 0.7
            await self._rbd_write(clone_get, st.clone_attempted,
                                  st.clone_acked, set(), r, payload,
                                  retry, reopen)

    # -- rgw round -----------------------------------------------------

    async def rgw_round(self, rnd: int) -> None:
        sc, st, rng = self.sc, self.st, self.rgw_rng
        key = f"mpk{rnd}"
        fate = rng.choice(["complete", "complete", "abort", "abandon"])
        part_payloads = [_payload(rng, f"mp-r{rnd}-p{n}", sc.part_size)
                         for n in range(1, sc.parts_per_upload + 1)]
        retries = [rng.random() < 0.7
                   for _ in range(sc.parts_per_upload + 1)]
        try:
            uid = await st.rgw.create_multipart(st.BUCKET, key,
                                                timeout=sc.op_timeout)
        except (IOError, OSError, TimeoutError):
            return
        recorded: List[bytes] = []
        for n, payload in enumerate(part_payloads, start=1):
            for attempt in range(2):
                try:
                    await st.rgw.upload_part(st.BUCKET, key, uid, n,
                                             payload,
                                             timeout=sc.op_timeout)
                    recorded.append(payload)
                except ChaosInterrupt:
                    if not retries[n - 1] or attempt:
                        fate = "abandon"   # client died mid-upload
                        break
                    CHAOS.inc("interrupt_retries")
                    continue
                except (IOError, OSError, TimeoutError,
                        FileNotFoundError):
                    fate = "abandon"
                    break
                break
            if fate == "abandon":
                break
        if fate == "complete" and recorded:
            expect = b"".join(recorded)
            try:
                await st.rgw.complete_multipart(st.BUCKET, key, uid,
                                                timeout=sc.op_timeout)
                st.mp_completed[key] = expect
            except ChaosInterrupt:
                # the gateway died mid-complete: all-or-nothing is the
                # judge's to prove after the reclaim pass
                st.mp_pending[key] = expect
            except (IOError, OSError, TimeoutError):
                st.mp_pending[key] = expect
        elif fate == "abort":
            try:
                await st.rgw.abort_multipart(st.BUCKET, key, uid,
                                             timeout=sc.op_timeout)
            except (ChaosInterrupt, IOError, OSError, TimeoutError):
                pass                       # reclaim finishes the abort
        # abandoned uploads are left for the reclaim pass

    # -- mds round -----------------------------------------------------

    async def mds_round(self, rnd: int) -> None:
        sc, st, rng = self.sc, self.st, self.mds_rng
        for _ in range(sc.meta_ops):
            op = rng.choice(["mkdir", "create", "create", "rename"])
            self._ns_seq += 1
            if op == "rename":
                files = sorted(p for p, k in st.ns_model.items()
                               if k == "file")
                if not files:
                    op = "create"
                else:
                    src = rng.choice(files)
                    dst = f"/fd/mv{self._ns_seq}"
                    try:
                        await st.fsc.rename(src, dst)
                    except FileNotFoundError:
                        # our paths are unique: ENOENT on a (possibly
                        # internally retried) rename means the first
                        # send's journalled event already applied
                        pass
                    except (IOError, OSError, TimeoutError,
                            ConnectionError):
                        # outcome unknown: drop src from the model and
                        # do not claim dst (at-least-once ambiguity)
                        st.ns_model.pop(src, None)
                        continue
                    st.ns_model.pop(src, None)
                    st.ns_model[dst] = "file"
                    st.ns_gone.add(src)
                    continue
            path = f"/fd/{'d' if op == 'mkdir' else 'f'}{self._ns_seq}"
            try:
                if op == "mkdir":
                    await st.fsc.mkdir(path)
                else:
                    await st.fsc.create(path)
            except FileExistsError:
                pass    # unique path: the journalled op survived a
                # crash and replay applied it before the retry landed
            except (IOError, OSError, TimeoutError, ConnectionError):
                continue                   # unacked: not judged
            st.ns_model[path] = "dir" if op == "mkdir" else "file"


# --------------------------------------------------------------- runner


async def run_frontdoor(sc: FrontdoorScenario, seed: int,
                        tmpdir: Optional[str] = None,
                        device=None) -> Verdict:
    """Boot, drive the front doors under the fault schedule, heal,
    reclaim, converge, judge.  Same shape as scenario.run_scenario —
    shared heal/converge/judge seams, shared Verdict.  ``device``: the
    card the cluster runs on (CUDA unless named; raises without one)."""
    from ceph_tpu_torch.chaos.scenario import _store_factory
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster
    from ceph_tpu_torch.utils.device import resolve_device_index

    device = resolve_device_index(device)
    schedule = build_schedule(sc, seed)
    wl = stream(seed, "workload")
    cfg = _fast_config()
    cfg.mon_osd_down_out_interval = 600.0
    cfg.chaos_seed = seed
    for k, v in sc.config:
        cfg.set(k, v)
    counters0 = dict(CHAOS.dump()["chaos"])
    cluster = await start_cluster(
        sc.osds, config=cfg, with_mgr=sc.load is not None,
        store_factory=_store_factory(sc, tmpdir), device=device)
    dmn = DaemonInjector(cluster)
    failures: List[str] = []
    ctx = None
    babysitter = None
    runner = None
    try:
        admin = await cluster.client()
        pool = await admin.pool_create(
            f"fd_{sc.name}"[:24], "replicated", pg_num=sc.pg_num,
            size=sc.pool_size)
        meta_pool = data_pool = pool
        if "mds" in sc.surfaces:
            meta_pool = await admin.pool_create(
                "fd_meta", "replicated", pg_num=sc.pg_num,
                size=sc.pool_size)
            data_pool = await admin.pool_create(
                "fd_data", "replicated", pg_num=sc.pg_num,
                size=sc.pool_size)
        runner = _Runner(sc, seed, cluster, admin, pool,
                         meta_pool, data_pool)
        await runner.setup()
        st = runner.st
        if "mds" in sc.surfaces:
            babysitter = asyncio.get_event_loop().create_task(
                runner.mds_babysitter())
        if sc.load is not None:
            from ceph_tpu_torch.load.driver import LoadContext

            ctx = await LoadContext.create(sc.load, seed,
                                           cluster=cluster)

        async def surfaces_round(rnd: int) -> None:
            coros = []
            if "rbd" in sc.surfaces:
                coros.append(runner.rbd_round(rnd))
            if "rgw" in sc.surfaces:
                coros.append(runner.rgw_round(rnd))
            if "mds" in sc.surfaces:
                coros.append(runner.mds_round(rnd))
            # each surface draws from its OWN stream, so concurrent
            # execution cannot perturb the seeded histories
            for r in await asyncio.gather(*coros,
                                          return_exceptions=True):
                if isinstance(r, BaseException) and \
                        not isinstance(r, asyncio.CancelledError):
                    raise r

        for rnd in range(sc.rounds):
            evs = [e for e in schedule if e["round"] == rnd]
            for e in [e for e in evs if not e["during_writes"]
                      and not e.get("after_writes")]:
                await apply_event(cluster, dmn, admin, st.io, e, wl,
                                  {}, pool)
            mid = [e for e in evs if e["during_writes"]]
            window = None
            if ctx is not None:
                from ceph_tpu_torch.load.driver import build_plan, drive

                plan = build_plan(sc.load, seed + rnd * 1000003)
                window = asyncio.get_event_loop().create_task(
                    drive(ctx, sc.load, seed, plan=plan))
            work = asyncio.get_event_loop().create_task(
                surfaces_round(rnd))
            try:
                if mid:
                    await asyncio.sleep(0.1 + wl.random() * 0.2)
                    for e in mid:
                        await apply_event(cluster, dmn, admin, st.io,
                                          e, wl, {}, pool)
                        await asyncio.sleep(wl.random() * 0.2)
                await work
                if window is not None:
                    await window
            except BaseException:
                for t in (work, window):
                    if t is not None and not t.done():
                        t.cancel()
                        try:
                            await t
                        except (asyncio.CancelledError, Exception):
                            pass
                raise
            for e in [e for e in evs if e.get("after_writes")]:
                await apply_event(cluster, dmn, admin, st.io, e, wl,
                                  {}, pool)

        # -- heal + reclaim + converge + judge -------------------------
        await heal_cluster(cluster, dmn)
        await wait_converged(cluster, sc.converge_timeout)
        if "mds" in sc.surfaces:
            await runner.ensure_mds()
        if babysitter is not None:
            runner._mds_stop.set()
            await babysitter
            babysitter = None
        if "rgw" in sc.surfaces:
            # the GC/repair pass the multipart invariant judges AFTER:
            # interrupted completes roll forward, aborts finish,
            # orphaned parts are collected, the index matches payloads
            await st.rgw.reclaim_multipart(st.BUCKET, abort_open=True)
        st.finish_clone_expect()
        failures += await judge_invariants(
            cluster, dmn, st.io, sc.invariants, {},
            timeout=sc.converge_timeout, frontdoor=st)
    finally:
        if babysitter is not None:
            runner._mds_stop.set()
            await babysitter
        if ctx is not None:
            await ctx.close()
        await cluster.stop()
    counters1 = CHAOS.dump()["chaos"]
    delta = {k: counters1[k] - counters0.get(k, 0) for k in counters1
             if counters1[k] - counters0.get(k, 0)}
    st = runner.st
    acked = (len(st.rbd_acked) + len(st.clone_acked)
             + len(st.mp_completed) + len(st.ns_model))
    return Verdict(name=sc.name, seed=seed, schedule=schedule,
                   passed=not failures, failures=failures,
                   acked_objects=acked, counters=delta)


# -------------------------------------------------------------- builtins


def frontdoor_scenarios(scale: float = 1.0) -> Dict[str, FrontdoorScenario]:
    """The front-door scenario library.

    ``frontdoor-smoke`` is the tier-1 gate: all three surfaces, one
    client interrupt or MDS crash per round, MemStore, scaled small.
    The slow trio each focus one surface at full size, composed with
    graft-load traffic and OSD bounces underneath."""
    from ceph_tpu_torch.chaos.scenario import ev
    from ceph_tpu_torch.load.driver import LoadSpec

    s = max(0.1, min(1.0, scale))
    full = s >= 1.0

    def _load(name: str) -> LoadSpec:
        # librados-only mix: background pressure that can never consume
        # a front-door interrupt seam (replay determinism)
        return LoadSpec(
            name=name, clients=max(8, int(24 * s)), sessions=2,
            rate=1.0, duration=1.5, objects=16, payload=1024,
            op_deadline=20.0, osds=4, pg_num=8, store="file",
            verbs=(("write", 4.0), ("read", 3.0), ("append", 1.0)))

    return {
        # tier-1: every front door, one seam per round, bit-identically
        # replayable; the three app-level invariants judge the verdict
        "frontdoor-smoke": FrontdoorScenario(
            name="frontdoor-smoke", osds=3, pool_size=3, pg_num=8,
            rounds=3, store="mem", regions=6, region_size=8 << 10,
            parts_per_upload=3, part_size=4 << 10, meta_ops=4,
            events=(
                # client seams pinned at=0: each fires on its FIRST
                # traversal in the round (one snap/complete/copy-up per
                # round — a seeded skip would outlive the round and be
                # silently re-armed over); the MDS seam sees several
                # mutating ops per round, so its skip stays seeded
                ev(0, "crash_point", target="client",
                   point="rbd_snap_pre_header", at=0),
                ev(0, "crash_point", target="mds.0",
                   point="mds_journal_mid"),
                ev(1, "crash_point", target="client",
                   point="rgw_complete_mid", at=0),
                ev(2, "crash_point", target="client",
                   point="rbd_copyup_mid", at=0),
            ),
            invariants=("snapshot", "multipart", "namespace", "acting",
                        "health", "lockdep"),
            converge_timeout=60.0),
        # RBD snapshots/clones under mid-write interrupts + OSD bounces
        # with sustained librados load underneath (slow)
        "rbd-snap-midwrite": FrontdoorScenario(
            name="rbd-snap-midwrite", osds=int(round(4 + s)),
            pool_size=3, pg_num=16 if full else 8,
            rounds=4 if full else 2, store="file",
            surfaces=("rbd",),
            regions=12 if full else 6, region_size=32 << 10,
            load=_load("rbd-snap-bg") if full else None,
            events=(
                ev(0, "crash_point", target="client",
                   point="rbd_snap_pre_header"),
                ev(1, "crash_point", target="client",
                   point="rbd_clone_mid"),
                ev(1, "restart_osd", during_writes=True),
                ev(2, "crash_point", target="client",
                   point="rbd_copyup_mid"),
                ev(2, "restart_osd", during_writes=True),
                ev(3, "crash_point", target="client",
                   point="rbd_copyup_mid"),
            ) if full else (
                ev(0, "crash_point", target="client",
                   point="rbd_snap_pre_header"),
                ev(1, "crash_point", target="client",
                   point="rbd_copyup_mid"),
            ),
            invariants=("snapshot", "acting", "health", "lockdep"),
            converge_timeout=180.0 if full else 90.0),
        # RGW multipart under part/complete/abort interrupts + an OSD
        # crash, reclaim pass proves all-or-nothing + zero orphans
        "rgw-multipart-crash": FrontdoorScenario(
            name="rgw-multipart-crash", osds=int(round(4 + s)),
            pool_size=3, pg_num=16 if full else 8,
            rounds=4 if full else 2, store="file",
            surfaces=("rgw",),
            parts_per_upload=5 if full else 3,
            part_size=(16 << 10) if full else (4 << 10),
            load=_load("rgw-mp-bg") if full else None,
            events=(
                ev(0, "crash_point", target="client",
                   point="rgw_part_mid"),
                ev(1, "crash_point", target="client",
                   point="rgw_complete_mid"),
                ev(1, "crash_osd", during_writes=True),
                ev(2, "revive_osd"),
                ev(2, "crash_point", target="client",
                   point="rgw_abort_mid"),
                ev(3, "crash_point", target="client",
                   point="rgw_complete_mid"),
            ) if full else (
                ev(0, "crash_point", target="client",
                   point="rgw_part_mid"),
                ev(1, "crash_point", target="client",
                   point="rgw_complete_mid"),
            ),
            invariants=("multipart", "acting", "health", "lockdep"),
            converge_timeout=180.0 if full else 90.0),
        # MDS journal write-ahead + boot replay under daemon crashes:
        # mid-append kills, then an armed mid-replay seam cuts the
        # NEXT boot's replay itself
        "mds-journal-replay": FrontdoorScenario(
            name="mds-journal-replay", osds=int(round(3 + s)),
            pool_size=3, pg_num=8,
            rounds=4 if full else 2, store="file",
            surfaces=("mds",),
            meta_ops=8 if full else 4,
            load=_load("mds-replay-bg") if full else None,
            events=(
                ev(0, "crash_point", target="mds.0",
                   point="mds_journal_mid"),
                # the CHAIN: crash mid-append (one journalled,
                # unapplied event), then crash the restarted rank's
                # boot replay of that very event — the restart resumes
                # the per-rank config, so the chain spans incarnations
                ev(1, "crash_point", target="mds.0",
                   point="mds_journal_mid,mds_replay_mid", at=0),
                ev(2, "crash_mds", target="mds.0",
                   during_writes=True),
                ev(2, "crash_point", target="mds.0",
                   point="mds_journal_mid"),
                ev(3, "restart_osd", during_writes=True),
            ) if full else (
                ev(0, "crash_point", target="mds.0",
                   point="mds_journal_mid"),
                ev(1, "crash_point", target="mds.0",
                   point="mds_journal_mid,mds_replay_mid", at=0),
            ),
            invariants=("namespace", "acting", "health", "lockdep"),
            converge_timeout=180.0 if full else 90.0),
    }
