"""graft-load: deterministic open-loop traffic driver.

Counterpart of ``ceph_tpu/load/driver.py``.  ``LoadContext.create`` and
``run_load`` boot their cluster on the ``device`` the caller names:
CUDA unless it names another (``device="cpu"`` for the plain versions);
they raise when CUDA is absent and no device was named.  A context
built on a caller's cluster runs on that cluster's device.

The workload generator: thousands of simulated clients
multiplexed over a BOUNDED pool of objecter sessions (the reference's
librados apps share a handful of RADOS connections the same way), each
client an independent seeded arrival process (fixed-rate or Poisson)
drawing verbs from a weighted mix (librados write/read/RMW/append/
delete, RBD striped image I/O + snapshot lifecycle + clone reads, RGW
object puts + full multipart transactions) and object targets from
a zipfian hot-set — all declared as a ``LoadSpec`` and resolved by
``build_plan(spec, seed)`` into a concrete per-client op schedule with
the same replay-key determinism contract as chaos scenarios: the same
seed produces a bit-identical plan, and ``plan_key`` is the replay
witness.

The driver is OPEN-LOOP: ops fire at their scheduled times whether or
not earlier ops completed (offered load is the independent variable the
saturation search in ``ramp.py`` sweeps; a closed loop would let the
cluster set its own pace and hide the knee).  ``max_inflight`` is a
runaway safety cap only — real flow control is the objecter's AIMD
congestion window, which is part of what the SLO judge grades.

Namespaces keep durability judgeable: ``write`` verbs target ``obj*``
oids with whole-payload ``write_full`` (last-acked-payload readback is
well-defined, chaos-style), while ``rmw``/``append``/``delete`` mutate
a separate ``mob*`` namespace whose byte history is deliberately not
durability-tracked (mixed mutations to one oid have no single expected
payload).  Reads hit the tracked namespace.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.load.dist import (
    arrival_offsets,
    client_stream,
    pick_weighted,
    zipf_pick,
)
from ceph_tpu_torch.utils.tasks import track_task

# librados-only default mix (RBD/RGW verbs opt in per spec)
DEFAULT_VERBS: Tuple[Tuple[str, float], ...] = (
    ("write", 4.0), ("read", 3.0), ("rmw", 1.0), ("append", 1.0),
    ("delete", 0.5))

DEFAULT_GATES: Tuple[Tuple[str, float], ...] = (
    ("goodput_min_frac", 0.5),   # scraped acked ops >= frac * offered
    ("p99_ms", 5000.0),          # scraped op-latency histogram p99
    ("cwnd_floor", 2.0),         # AIMD window converged, not collapsed
    ("qos_reservation_min", 0.0))  # dmclock conformance under contention


@dataclass(frozen=True)
class LoadSpec:
    """One declarative traffic shape (the chaos ``Scenario`` analog)."""

    name: str
    clients: int = 64                  # simulated clients
    sessions: int = 4                  # bounded objecter session pool
    rate: float = 1.0                  # ops/s per client (offered)
    duration: float = 3.0              # offered-load window, seconds
    arrival: str = "poisson"           # "poisson" | "fixed"
    verbs: Tuple[Tuple[str, float], ...] = DEFAULT_VERBS
    objects: int = 64                  # hot-object space per namespace
    zipf_alpha: float = 1.2
    payload: int = 2048                # approx bytes per write payload
    op_deadline: float = 25.0          # client budget per op (seconds)
    max_inflight: int = 512            # open-loop runaway cap
    # cluster shape
    osds: int = 3
    pool_kind: str = "replicated"      # "replicated" | "erasure"
    pool_size: int = 3
    pg_num: int = 4
    ec_profile: Optional[Tuple[Tuple[str, str], ...]] = None
    store: str = "mem"                 # "mem" | "file" | "blue"
    config: Tuple[Tuple[str, object], ...] = ()
    # SLO gate thresholds (see slo.judge)
    gates: Tuple[Tuple[str, float], ...] = DEFAULT_GATES

    def gate(self, name: str, default: float = 0.0) -> float:
        return dict(self.gates).get(name, default)

    def offered_ops(self, plan: List[List[Dict]]) -> int:
        return sum(len(ops) for ops in plan)

    def scaled(self, factor: float) -> "LoadSpec":
        """The same shape at ``factor``x the offered rate (ramp steps)."""
        return replace(self, rate=self.rate * factor)


# ----------------------------------------------------------------- plan


def build_plan(spec: LoadSpec, seed: int) -> List[List[Dict]]:
    """Resolve the spec to a concrete per-client op schedule.  Every
    random choice (arrival times, verbs, object ranks, payload nonces,
    offsets) comes from the client's OWN seeded stream, so the plan is
    a pure function of (spec, seed) — the determinism artifact the
    replay tests compare."""
    plan: List[List[Dict]] = []
    for cid in range(spec.clients):
        rng = client_stream(seed, cid)
        ops: List[Dict] = []
        for t in arrival_offsets(rng, spec.rate, spec.duration,
                                 spec.arrival):
            verb = pick_weighted(rng, spec.verbs)
            rank = zipf_pick(rng, spec.objects, spec.zipf_alpha)
            ops.append({"t": round(t, 6), "verb": verb, "obj": rank,
                        "nonce": rng.randrange(1 << 30)})
        plan.append(ops)
    return plan


def plan_key(plan: List[List[Dict]]) -> str:
    """Replay witness: sha256 over the canonical plan encoding (two
    runs of one seed must produce the same key bit-for-bit)."""
    blob = json.dumps(plan, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


# --------------------------------------------------------------- result


@dataclass
class LoadResult:
    """Client-observed outcome of one load window (the scrape-side
    telemetry lives in the slo snapshots, taken by the runner)."""

    spec_name: str
    seed: int
    plan_key: str
    offered: int = 0
    completed: Dict[str, int] = field(default_factory=dict)
    errors: Dict[str, int] = field(default_factory=dict)
    read_misses: int = 0
    late_acks: List[str] = field(default_factory=list)
    elapsed: float = 0.0               # before-scrape -> after-scrape
    # durability bookkeeping (soak): last acked payload per tracked oid
    acked: Dict[str, bytes] = field(default_factory=dict)
    attempted: Dict[str, set] = field(default_factory=dict)

    def count(self, table: Dict[str, int], key: str) -> None:
        table[key] = table.get(key, 0) + 1

    @property
    def acked_ops(self) -> int:
        return sum(self.completed.values())

    def as_dict(self) -> Dict:
        return {"spec": self.spec_name, "seed": self.seed,
                "plan_key": self.plan_key, "offered": self.offered,
                "completed": dict(self.completed),
                "errors": dict(self.errors),
                "read_misses": self.read_misses,
                "late_acks": len(self.late_acks),
                "elapsed_s": round(self.elapsed, 3)}


# -------------------------------------------------------------- context


class LoadContext:
    """A booted cluster + bounded session pool + workload surfaces
    (librados pool, RBD image + clone, RGW bucket), reusable across
    load windows (the ramp sweeps many windows over one cluster)."""

    RBD_IMAGE = "load_img"
    RBD_CLONE = "load_clone"
    RBD_SNAP = "load_base"
    RBD_SIZE = 8 << 20
    RGW_BUCKET = "loadb"

    def __init__(self):
        self.cluster = None
        self.sessions: List = []
        self.pool: Optional[int] = None
        self._owns_cluster = False
        self._images: Dict[int, object] = {}
        self._clones: Dict[int, object] = {}
        self._rgws: Dict[int, object] = {}
        self._rbd_ready = False
        self._rgw_ready = False

    @classmethod
    async def create(cls, spec: LoadSpec, seed: int, cluster=None,
                     tmpdir: Optional[str] = None,
                     device=None) -> "LoadContext":
        """Boot a cluster for ``spec`` on ``device`` (CUDA unless named;
        raises without one), or set up on the caller's ``cluster``,
        whose device a named ``device`` must be."""
        from ceph_tpu_torch.chaos.scenario import store_factory_for
        from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster
        from ceph_tpu_torch.utils.device import resolve_device_index

        ctx = cls()
        if cluster is not None:
            if device is not None and \
                    resolve_device_index(device) != cluster.device:
                raise ValueError(f"LoadContext: device {device} is not "
                                 f"the cluster's {cluster.device}")
        else:
            device = resolve_device_index(device)
            cfg = _fast_config()
            # soaks bounce daemons across minutes of wall time: a
            # crashed OSD must not be auto-marked OUT before its
            # scheduled revive (chaos scenarios use 120s; soak rounds
            # plus invariant sweeps outlive that)
            cfg.mon_osd_down_out_interval = 600.0
            cfg.chaos_seed = seed          # seeded messenger/backoff jitter
            for k, v in spec.config:
                cfg.set(k, v)
            cluster = await start_cluster(
                spec.osds, config=cfg, with_mgr=True,
                store_factory=store_factory_for(spec, tmpdir),
                device=device)
            ctx._owns_cluster = True
        ctx.cluster = cluster
        admin = await cluster.client(name="load_admin") \
            if not cluster.clients else cluster.clients[0]
        if spec.pool_kind == "erasure":
            ctx.pool = await admin.pool_create(
                f"load_{spec.name}"[:24], "erasure", pg_num=spec.pg_num,
                ec_profile=dict(spec.ec_profile or ()))
        else:
            ctx.pool = await admin.pool_create(
                f"load_{spec.name}"[:24], "replicated",
                pg_num=spec.pg_num, size=spec.pool_size)
        for j in range(spec.sessions):
            ctx.sessions.append(await cluster.client(name=f"load{j}"))
        verbs = {v for v, _w in spec.verbs}
        if verbs & {"rbd_write", "rbd_read", "rbd_snap",
                    "rbd_clone_read"}:
            await ctx._setup_rbd()
        if "rbd_clone_read" in verbs:
            await ctx._setup_rbd_clone()
        if verbs & {"rgw_put", "rgw_get", "rgw_multipart"}:
            await ctx._setup_rgw()
        return ctx

    def io(self, j: int):
        return self.sessions[j % len(self.sessions)].ioctx(self.pool)

    async def _setup_rbd(self) -> None:
        from ceph_tpu_torch.cluster.rbd import RBD

        rbd = RBD(self.io(0))
        try:
            await rbd.create(self.RBD_IMAGE, self.RBD_SIZE,
                             stripe_unit=64 << 10, stripe_count=2,
                             object_size=1 << 20)
        except FileExistsError:
            pass
        for j in range(len(self.sessions)):
            self._images[j] = await RBD(self.io(j)).open(self.RBD_IMAGE)
        self._rbd_ready = True

    async def _setup_rbd_clone(self) -> None:
        """Parent data + snapshot + COW clone for the rbd_clone_read
        verb: clone reads exercise the copy-up fall-through path under
        load (unwritten child extents resolve to the parent snap)."""
        from ceph_tpu_torch.cluster.rbd import RBD

        img = self._images[0]
        if self.RBD_SNAP not in img.snap_list():
            await img.write(0, b"load-clone-parent-" * 512)
            try:
                await img.snap_create(self.RBD_SNAP)
            except FileExistsError:
                pass
        try:
            await RBD(self.io(0)).clone(self.RBD_IMAGE, self.RBD_SNAP,
                                        self.RBD_CLONE)
        except FileExistsError:
            pass
        for j in range(len(self.sessions)):
            self._clones[j] = await RBD(self.io(j)).open(self.RBD_CLONE)

    async def _setup_rgw(self) -> None:
        from ceph_tpu_torch.cluster.rgw import RGW

        for j in range(len(self.sessions)):
            self._rgws[j] = RGW(self.io(j))
        try:
            await self._rgws[0].create_bucket(self.RGW_BUCKET)
        except FileExistsError:
            pass
        self._rgw_ready = True

    async def close(self) -> None:
        if self._owns_cluster and self.cluster is not None:
            await self.cluster.stop()


# --------------------------------------------------------------- runner


async def drive(ctx: LoadContext, spec: LoadSpec, seed: int,
                plan: Optional[List[List[Dict]]] = None,
                record_acked: bool = False) -> LoadResult:
    """Fire one open-loop window of ``plan`` over the context's session
    pool and wait for every op to resolve.  Pure client side — no
    scraping; the runner (``run_load`` / ramp / soak) brackets this
    with slo snapshots."""
    if plan is None:
        plan = build_plan(spec, seed)
    result = LoadResult(spec_name=spec.name, seed=seed,
                        plan_key=plan_key(plan),
                        offered=spec.offered_ops(plan))
    loop = asyncio.get_event_loop()
    sem = asyncio.Semaphore(spec.max_inflight)
    op_tasks: set = set()
    t0 = loop.time() + 0.05

    async def fire(cid: int, op: Dict) -> None:
        async with sem:
            await _one_op(ctx, spec, cid, op, result, record_acked)

    async def client_loop(cid: int, ops: List[Dict]) -> None:
        for op in ops:
            delay = t0 + op["t"] - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            # open loop: the op is a free-running task; completion of
            # earlier ops never gates later arrivals
            track_task(op_tasks, loop.create_task(fire(cid, op)))

    async def report_loop() -> None:
        # stream each session's AIMD/flow-control counters to the mgr
        # while the window runs, so the post-window scrape sees them
        while True:
            for c in ctx.sessions:
                await c.objecter.mgr_report()
            await asyncio.sleep(0.25)

    reporter = loop.create_task(report_loop())
    try:
        await asyncio.gather(*[client_loop(cid, ops)
                               for cid, ops in enumerate(plan)])
        while op_tasks:
            # _one_op contains its own error accounting; anything that
            # escapes here is a driver bug and should fail the run
            await asyncio.gather(*list(op_tasks))
    finally:
        reporter.cancel()
        try:
            await reporter
        except asyncio.CancelledError:
            pass
        if op_tasks:
            # abnormal exit (an escaped driver bug, or the window task
            # itself cancelled): the free-running op tasks must not
            # keep firing at a context the caller is about to close
            for t in list(op_tasks):
                t.cancel()
            drained = await asyncio.gather(*list(op_tasks),
                                           return_exceptions=True)
            for exc in drained:
                if isinstance(exc, Exception):
                    result.count(result.errors, "driver_abort")
    for c in ctx.sessions:
        await c.objecter.mgr_report()    # final cwnd state for the scrape
    return result


async def _one_op(ctx: LoadContext, spec: LoadSpec, cid: int, op: Dict,
                  result: LoadResult, record_acked: bool) -> None:
    """Serve one planned op on the client's assigned session.  Expected
    I/O failures are counted, never raised (open-loop drivers judge by
    counters, not exceptions)."""
    j = cid % len(ctx.sessions)
    io = ctx.io(j)
    verb, rank, nonce = op["verb"], op["obj"], op["nonce"]
    loop = asyncio.get_event_loop()
    start = loop.time()
    timeout = spec.op_deadline
    # EVERY verb carries the client deadline end-to-end (the RBD/RGW
    # libraries thread ONE wall deadline through their internal
    # fan-out via utils.deadline), so every ack is judged
    # against the zero-acked-past-deadline criterion
    deadline_tracked = True
    acked = False
    try:
        if verb == "write":
            oid = f"obj{rank}"
            data = _payload(spec, cid, oid, nonce)
            if record_acked:
                result.attempted.setdefault(oid, set()).add(data)
            await io.write_full(oid, data, timeout=timeout)
            if record_acked:
                result.acked[oid] = data
        elif verb == "read":
            try:
                await io.read(f"obj{rank}", timeout=timeout)
            except FileNotFoundError:
                result.read_misses += 1
        elif verb == "rmw":
            data = _payload(spec, cid, f"mob{rank}", nonce)[:256]
            await io.write(f"mob{rank}", data,
                           offset=nonce % 4096, timeout=timeout)
        elif verb == "append":
            await io.append(f"mob{rank}",
                            _payload(spec, cid, f"mob{rank}", nonce)[:256],
                            timeout=timeout)
        elif verb == "delete":
            try:
                await io.remove(f"mob{rank}", timeout=timeout)
            except FileNotFoundError:
                result.read_misses += 1
        elif verb == "rbd_write":
            img = ctx._images[j]
            off = (nonce % (ctx.RBD_SIZE - (64 << 10))) & ~0xFFF
            await img.write(off, _payload(spec, cid, "rbd", nonce)[:16384],
                            timeout=timeout)
        elif verb == "rbd_read":
            img = ctx._images[j]
            off = (nonce % (ctx.RBD_SIZE - (64 << 10))) & ~0xFFF
            await img.read(off, 16384, timeout=timeout)
        elif verb == "rbd_snap":
            # snapshot lifecycle under load: create + drop ONE snap on
            # a unique name, both halves inside the one op budget
            from ceph_tpu_torch.utils.deadline import deadline_of, remaining

            img = ctx._images[j]
            name = f"ls-c{cid}-{nonce}"
            dl = deadline_of(timeout)
            await img.snap_create(name, timeout=remaining(dl))
            try:
                await img.snap_remove(name, timeout=remaining(dl))
            except (KeyError, FileNotFoundError):
                # a concurrent snap_create's header save won the race
                # (load images share handles); the stray snap is
                # harmless to the ack bookkeeping
                pass
        elif verb == "rbd_clone_read":
            img = ctx._clones[j]
            off = (nonce % (ctx.RBD_SIZE - (64 << 10))) & ~0xFFF
            await img.read(off, 16384, timeout=timeout)
        elif verb == "rgw_put":
            await ctx._rgws[j].put_object(
                ctx.RGW_BUCKET, f"k{rank}",
                _payload(spec, cid, "rgw", nonce)[:4096],
                timeout=timeout)
        elif verb == "rgw_get":
            try:
                await ctx._rgws[j].get_object(ctx.RGW_BUCKET, f"k{rank}",
                                              timeout=timeout)
            except (FileNotFoundError, KeyError):
                result.read_misses += 1
        elif verb == "rgw_multipart":
            # a full 2-part multipart transaction (initiate -> parts ->
            # complete) through the durable registry, one op budget
            from ceph_tpu_torch.utils.deadline import deadline_of, remaining

            rgw = ctx._rgws[j]
            key = f"mpl{rank}"
            dl = deadline_of(timeout)
            uid = await rgw.create_multipart(ctx.RGW_BUCKET, key,
                                             timeout=remaining(dl))
            half = _payload(spec, cid, "mp", nonce)[:2048]
            for n in (1, 2):
                await rgw.upload_part(ctx.RGW_BUCKET, key, uid, n,
                                      half, timeout=remaining(dl))
            await rgw.complete_multipart(ctx.RGW_BUCKET, key, uid,
                                         timeout=remaining(dl))
        else:
            raise ValueError(f"unknown load verb {verb!r}")
        acked = True
    except (IOError, OSError, TimeoutError) as e:
        result.count(result.errors, type(e).__name__)
    if acked:
        result.count(result.completed, verb)
        elapsed = loop.time() - start
        if deadline_tracked and elapsed > timeout + 0.25:
            # the zero acked-past-deadline criterion (chaos "deadline"
            # invariant): an ack after the client's budget means
            # deadline shedding failed somewhere in the stack
            result.late_acks.append(
                f"deadline: {verb} obj{rank} acked {elapsed:.2f}s after "
                f"submit, past its {timeout}s budget")


def _payload(spec: LoadSpec, cid: int, oid: str, nonce: int) -> bytes:
    tag = f"load-c{cid}-{oid}-{nonce}-".encode()
    return tag * max(1, spec.payload // len(tag))


async def run_load(spec: LoadSpec, seed: int, ctx: Optional[LoadContext]
                   = None, tmpdir: Optional[str] = None,
                   record_acked: bool = False, device=None):
    """One judged load window: boot (or reuse) a context, snapshot
    telemetry, drive the plan, snapshot again.  Returns
    ``(result, report)`` where the report's gate verdicts are computed
    from the scraped/dumped telemetry (slo.judge).  A context booted
    here runs on ``device`` (CUDA unless named; raises without one)."""
    from ceph_tpu_torch.load import slo

    owns = ctx is None
    if ctx is None:
        ctx = await LoadContext.create(spec, seed, tmpdir=tmpdir,
                                       device=device)
    try:
        before = await slo.snapshot(ctx.cluster)
        result = await drive(ctx, spec, seed, record_acked=record_acked)
        # let the final heartbeat-carried MMgrReports land before the
        # closing scrape (heartbeat interval is 0.1s under _fast_config)
        await asyncio.sleep(0.4)
        after = await slo.snapshot(ctx.cluster)
        result.elapsed = max(1e-6, after.stamp - before.stamp)
        report = slo.judge(spec, result, before, after)
        if not report.passed and \
                getattr(ctx.cluster.config, "blackbox_enabled", 0):
            # graft-blackbox: a failed SLO judgment IS a trigger — the
            # bundle snapshots the cluster while the breach evidence
            # (historic ops, flight rings) is still in the rings
            # the reason stays a pure function of (spec, seed) — gate
            # counts/values are wire-level and ride the detail — so the
            # bundle path and replay_key are seeded-replay stable
            rec = await ctx.cluster.blackbox_trigger(
                "slo_gate",
                f"load {spec.name} seed={seed} failed SLO gates",
                detail={"spec": spec.name, "seed": seed,
                        "gates": report.failing_gates()},
                clients=ctx.sessions)
            report.postmortem = (rec or {}).get("path")
        return result, report
    finally:
        if owns:
            await ctx.close()


# -------------------------------------------------------------- builtins


def builtin_specs() -> Dict[str, LoadSpec]:
    """The shipped load-spec library (scripts/load.py `list`)."""
    return {
        # tier-1 smoke: ~64 simulated clients over a 4-session pool,
        # librados mix, toy cluster — every SLO gate must pass and the
        # plan must replay bit-identically from its seed
        "smoke": LoadSpec(
            name="smoke", clients=64, sessions=4, rate=1.2,
            duration=2.5, objects=32, payload=2048, osds=3, pg_num=4),
        # minimal shape for CLI exit-code tests (fast boot + window)
        "smoke-micro": LoadSpec(
            name="smoke-micro", clients=16, sessions=2, rate=1.5,
            duration=1.2, objects=16, payload=1024, osds=3, pg_num=4),
        # every front door at once: librados + RBD striped image I/O,
        # snapshots and clone reads + RGW object puts and multipart
        # transactions through rgw.py
        "mixed": LoadSpec(
            name="mixed", clients=96, sessions=6, rate=1.0,
            duration=3.0, objects=48, payload=4096, osds=3, pg_num=8,
            verbs=(("write", 3.0), ("read", 2.0), ("rmw", 1.0),
                   ("append", 1.0), ("rbd_write", 1.5),
                   ("rbd_read", 1.0), ("rgw_put", 1.5),
                   ("rgw_get", 1.0), ("rbd_snap", 0.5),
                   ("rbd_clone_read", 0.8), ("rgw_multipart", 0.8))),
        # the ramp shape: EC pool behind a deliberate admission budget,
        # so stepping the offered rate eventually trips pushback and
        # the knee is a real saturation point (AIMD cwnd + goodput
        # gates do the judging)
        "ramp-ec": LoadSpec(
            name="ramp-ec", clients=64, sessions=4, rate=0.8,
            duration=2.5, objects=32, payload=4096, osds=4,
            pool_kind="erasure", pool_size=3, pg_num=8,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            verbs=(("write", 4.0), ("read", 3.0), ("rmw", 1.0),
                   ("append", 1.0)),
            config=(("osd_op_throttle_ops", 24),)),
        # the verified-read path at rate — read-dominant mix
        # over an EC pool with verify-on-read (default on), judged by
        # the same gates plus the integrity-counters presence row
        "read-heavy": LoadSpec(
            name="read-heavy", clients=64, sessions=4, rate=1.2,
            duration=2.5, objects=32, payload=4096, osds=4,
            pool_kind="erasure", pool_size=3, pg_num=8,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            verbs=(("write", 1.5), ("read", 6.0), ("append", 0.5))),
        # reads racing the scheduled deep scrubber — scrub
        # traffic yields to client admission pressure while the SLO
        # gates (p99/goodput/deadline) must still hold
        "scrub-concurrent": LoadSpec(
            name="scrub-concurrent", clients=48, sessions=4, rate=1.0,
            duration=2.5, objects=24, payload=4096, osds=4,
            pool_kind="erasure", pool_size=3, pg_num=8,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            config=(("osd_scrub_interval", 0.5),),
            verbs=(("write", 2.0), ("read", 5.0), ("rmw", 0.5))),
        # dmclock conformance under contention: mclock queue with a
        # client reservation, so the conformance gate judges served_
        # reservation from the scrape
        "qos": LoadSpec(
            name="qos", clients=48, sessions=4, rate=1.5,
            duration=2.5, objects=24, payload=2048, osds=3, pg_num=4,
            config=(("osd_op_queue", "mclock"),
                    ("osd_mclock_default_reservation", 20.0),
                    ("osd_op_throttle_ops", 16)),
            gates=DEFAULT_GATES[:-1] + (("qos_reservation_min", 1.0),)),
    }
