"""Durability invariants checked after a chaos scenario converges.

Counterpart of ``ceph_tpu/chaos/invariants.py``.

The post-conditions that make a fault schedule a TEST instead of a
demolition derby (reference: teuthology's thrasher final checks +
``wait_for_clean``):

- ``durability``: every ACKED write reads back bit-identical and
  checksum-clean (crc32c of the read bytes matches the crc recorded at
  ack time).  ``attempted`` mode (for mid-write primary kills) accepts
  any WHOLE payload ever submitted for the object — a timed-out write
  may legitimately land after its client gave up (at-least-once), but
  torn or mixed-generation bytes never pass.
- ``health``: the cluster reaches HEALTH_OK (no down/out OSDs, no
  slow-op warnings, nothing full).
- ``acting``: no PG is stuck — every PG has a primary and a full acting
  set, and every primary's ``last_complete`` has caught up to
  ``last_update`` (peering finished, nothing left degraded).
- ``snapshots``: every snapshot reads back the contents recorded at
  snap time.
- ``scrub``: a full scrub pass over every primary PG finds zero
  unrepaired inconsistencies (silent divergence / bit-rot is caught and
  fixed, EC shards repair through decode).
- ``lockdep``: the runtime lock-order graph stayed acyclic under the
  fault schedule.

Each check returns a list of human-readable failure strings (empty =
invariant holds); the scenario runner aggregates them into the verdict.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops import crc32c as crcmod


def _crc(data: bytes) -> int:
    return crcmod.crc32c(0xFFFFFFFF, bytes(data))


async def check_durability(io, acked: Dict[str, bytes],
                           attempted: Optional[Dict[str, set]] = None,
                           mode: str = "acked",
                           acked_crcs: Optional[Dict[str, int]] = None,
                           timeout: float = 60.0) -> List[str]:
    failures: List[str] = []
    loop = asyncio.get_event_loop()
    overall = loop.time() + timeout
    for oid, data in sorted(acked.items()):
        want = {data} if mode == "acked" else \
            set((attempted or {}).get(oid, ())) | {data}
        got, err = None, None
        # retry to the shared deadline, but guarantee EVERY object a
        # minimum retry window: recovery may still be rewriting the last
        # objects checked, and a shared budget eaten by the first ones
        # would judge them on a single mid-recovery read
        deadline = max(overall, loop.time() + min(15.0, timeout))
        while asyncio.get_event_loop().time() < deadline:
            try:
                got = await io.read(oid, timeout=30)
                err = None
            except (IOError, OSError, TimeoutError) as e:
                err = e
                await asyncio.sleep(0.5)
                continue
            if got in want:
                break
            await asyncio.sleep(0.5)
        if err is not None:
            failures.append(f"durability: {oid} unreadable: {err!r}")
        elif got is None:
            failures.append(f"durability: {oid} never read back before "
                            "the deadline")
        elif got not in want:
            failures.append(
                f"durability: {oid} holds torn/unknown bytes "
                f"{got[:24]!r}... != acked {data[:24]!r}...")
        elif got == data and acked_crcs and \
                _crc(got) != acked_crcs.get(oid, _crc(data)):
            failures.append(f"durability: {oid} crc diverged from the "
                            "crc recorded at ack time")
    return failures


async def check_health(cluster, timeout: float = 30.0) -> List[str]:
    deadline = asyncio.get_event_loop().time() + timeout
    health = {}
    while asyncio.get_event_loop().time() < deadline:
        health = cluster.mon._health_data()
        if health["status"] == "HEALTH_OK":
            return []
        await asyncio.sleep(0.25)
    return [f"health: {health.get('status')} {health.get('checks')}"]


async def check_acting(cluster, timeout: float = 30.0) -> List[str]:
    deadline = asyncio.get_event_loop().time() + timeout
    failures: List[str] = []
    while asyncio.get_event_loop().time() < deadline:
        failures = _acting_once(cluster)
        if not failures:
            return []
        await asyncio.sleep(0.25)
    return failures


def _acting_once(cluster) -> List[str]:
    from ceph_tpu_torch.osdmap.osdmap import PGid

    failures: List[str] = []
    m = cluster.mon.osdmap
    for pool_id, pool in m.pools.items():
        want = pool.size
        for seed in range(pool.pg_num):
            pgid = PGid(pool_id, seed)
            _, _, acting, primary = m.pg_to_up_acting_osds(pgid)
            live = [o for o in acting if o != CRUSH_ITEM_NONE]
            if primary < 0:
                failures.append(f"acting: pg {pgid} has no primary")
            elif len(live) < want:
                failures.append(
                    f"acting: pg {pgid} undersized {live} < {want}")
            else:
                posd = cluster.osds.get(primary)
                st = posd.pgs.get(pgid) if posd else None
                if st is not None and st.last_complete < st.last_update:
                    failures.append(
                        f"acting: pg {pgid} incomplete "
                        f"({st.last_complete} < {st.last_update})")
    return failures


async def check_snapshots(io, snaps: Dict[int, Dict[str, bytes]],
                          timeout: float = 60.0) -> List[str]:
    failures: List[str] = []
    loop = asyncio.get_event_loop()
    overall = loop.time() + timeout
    for sid, objs in sorted(snaps.items()):
        for oid, data in sorted(objs.items()):
            got = None
            deadline = max(overall, loop.time() + min(10.0, timeout))
            while asyncio.get_event_loop().time() < deadline:
                try:
                    got = await io.read(oid, snapid=sid, timeout=30)
                except (IOError, OSError, TimeoutError):
                    await asyncio.sleep(0.5)
                    continue
                if got == data:
                    break
                await asyncio.sleep(0.5)
            if got != data:
                failures.append(
                    f"snapshots: {oid}@snap{sid} diverged "
                    f"(got {None if got is None else got[:24]!r})")
    return failures


async def check_scrub(cluster, timeout: float = 90.0) -> List[str]:
    deadline = asyncio.get_event_loop().time() + timeout
    bad: List[str] = []
    while True:
        bad = []
        for osd in list(cluster.osds.values()):
            for st in list(osd.pgs.values()):
                if st.primary != osd.osd_id:
                    continue
                try:
                    rep = await osd.scrub_pg(st)
                except Exception as e:
                    bad.append(f"scrub: pg {st.pgid} errored: {e!r}")
                    continue
                bad.extend(f"scrub: {oid} inconsistent in {st.pgid}"
                           for oid in rep["inconsistent"]
                           if oid not in rep["repaired"])
        if not bad or asyncio.get_event_loop().time() > deadline:
            break
        await asyncio.sleep(1.0)
    return bad


def check_shed(cluster) -> List[str]:
    """An overload scenario must actually exercise the shedding
    machinery: at least one throttle pushback, deadline shed, or QoS
    preemption across the cluster — a run where nothing shed means the
    offered load never exceeded the budget and the scenario proved
    nothing.  (SLOW_OPS staying clear is the existing ``health``
    invariant's job at convergence.)"""
    total = 0
    for osd in cluster.osds.values():
        for counter in ("osd_throttle_rejects", "osd_ops_shed_expired",
                        "osd_sub_ops_shed_expired", "osd_qos_preempted"):
            total += osd.perf.get(counter)  # 0 for never-bumped names
    if total:
        return []
    return ["shed: overload run produced zero throttle pushbacks / "
            "deadline sheds / QoS preemptions — budget never saturated"]


async def check_frontier(cluster, marks: Optional[Dict] = None,
                         timeout: float = 30.0) -> List[str]:
    """Commit-frontier consistency after convergence:

    - no PG keeps an OPEN pipeline/frontier entry (every in-flight or
      crash-reconstructed entry was resolved by acks, peering
      roll-forward, or rewind);
    - ``last_complete`` never exceeds ``last_update``, and on every
      primary the two are EQUAL (nothing left unresolved);
    - the persisted watermark matches the in-memory one (a crash at any
      instant reloads exactly what was blessed, nothing more);
    - across every store-preserving bounce the watermark is MONOTONE:
      the revived daemon's frontier never regressed below the value
      persisted before the crash (``marks`` from DaemonInjector).
    """
    deadline = asyncio.get_event_loop().time() + timeout
    failures: List[str] = []
    while True:
        failures = []
        for osd in list(cluster.osds.values()):
            for pgid, st in list(osd.pgs.items()):
                where = f"osd.{osd.osd_id} pg {pgid}"
                if st.last_complete > st.last_update:
                    failures.append(
                        f"frontier: {where} watermark "
                        f"{st.last_complete} ahead of last_update "
                        f"{st.last_update}")
                if st.primary == osd.osd_id:
                    if st.pipeline_pending:
                        failures.append(
                            f"frontier: {where} still holds open "
                            f"entries {list(st.pipeline_pending)[:4]}")
                    if st.frontier_recovering:
                        failures.append(
                            f"frontier: {where} never resolved "
                            f"crash-reconstructed entries "
                            f"{sorted(st.frontier_recovering)[:4]}")
                    if st.last_complete < st.last_update:
                        failures.append(
                            f"frontier: {where} incomplete "
                            f"({st.last_complete} < {st.last_update})")
        if not failures or \
                asyncio.get_event_loop().time() > deadline:
            break
        await asyncio.sleep(0.25)
    # persistence + monotonicity: checked once, post-convergence
    for osd in list(cluster.osds.values()):
        for pgid, st in list(osd.pgs.items()):
            stored = osd._load_last_complete(pgid)
            if stored != st.last_complete:
                failures.append(
                    f"frontier: osd.{osd.osd_id} pg {pgid} persisted "
                    f"watermark {stored} != in-memory "
                    f"{st.last_complete}")
            mark = (marks or {}).get((osd.osd_id, pgid))
            if mark is not None and st.last_complete < mark:
                failures.append(
                    f"frontier: osd.{osd.osd_id} pg {pgid} watermark "
                    f"regressed across crash-restart "
                    f"({st.last_complete} < pre-crash {mark})")
    return failures


async def check_repair(cluster, timeout: float = 30.0) -> List[str]:
    """A corruption scenario must actually exercise the self-healing
    machinery: at least one crc/EIO/stale detection AND at
    least one completed repair (verifying read or scrub) across the
    cluster, and zero objects left flagged inconsistent on any
    primary.  Converge-polls to a wall deadline: the detections the
    durability check's own reads just triggered arm ASYNC repairs
    that may still be landing when the judge reaches this invariant.
    Final bit-correctness of the served bytes is the durability
    invariant's job; this one proves detection and healing FIRED and
    CONVERGED."""
    def _once() -> List[str]:
        detected = repaired = 0
        out: List[str] = []
        for osd in cluster.osds.values():
            # NOT osd_scrub_errors: the scrub loop's generic exception
            # handler shares that counter, so a scrub that merely
            # CRASHED would masquerade as a detection.  Scrub-side
            # detections count through their repairs (a detected-but-
            # unrepaired object shows up as a leftover below instead).
            for c in ("osd_read_shard_crc_errors",
                      "osd_read_shard_errors",
                      "osd_scrub_errors_repaired"):
                detected += osd.perf.get(c)
            for c in ("osd_read_repairs", "osd_scrub_errors_repaired"):
                repaired += osd.perf.get(c)
            for pgid, st in osd.pgs.items():
                if st.primary == osd.osd_id and st.inconsistent:
                    out.append(
                        f"repair: osd.{osd.osd_id} pg {pgid} still "
                        f"holds inconsistent "
                        f"{sorted(st.inconsistent)[:4]}")
        if not detected:
            out.append("repair: corruption run produced zero "
                       "crc/EIO/stale detections — nothing verified "
                       "the injected rot")
        if not repaired:
            out.append("repair: zero completed repairs — detections "
                       "never healed")
        return out

    deadline = asyncio.get_event_loop().time() + timeout
    failures = _once()
    while failures and asyncio.get_event_loop().time() < deadline:
        await asyncio.sleep(0.25)
        failures = _once()
    return failures


def check_batch(cluster) -> List[str]:
    """A batch-chaos scenario must actually exercise the batched data
    plane: coalesced encode ticks ran (the deterministic signal — any
    concurrent same-profile writes coalesce).  Multi-item FRAME counts
    are left to the test layer: whether same-tick sub-writes share a
    frame depends on transport timing, so a hard per-run requirement
    would make seeded verdicts flappy (the replay contract forbids
    that); the mutator's per-item semantics are proven deterministically
    at unit level instead."""
    ticks = sum(osd.perf.get("osd_batch_ticks")
                for osd in cluster.osds.values())
    if not ticks:
        return ["batch: no coalesced encode tick ever ran — the "
                "scenario never hit the batched plane"]
    return []


# -- front-door invariants --------------------------------------------------
#
# Application-LEVEL post-conditions for the L8 services, judged against
# the workload's own bookkeeping (a FrontdoorState, chaos/frontdoor.py —
# or any duck-typed stand-in: the synthetic-history unit tests drive
# these checks with hand-built fakes).  Each check takes the surfaces it
# needs as attributes of ``fd`` so the verdict logic is testable without
# a cluster.


async def _read_retry(fn, deadline, *args, **kwargs):
    """Retry transient I/O errors until ``deadline``; returns
    (value, error) — recovery may still be rewriting what we judge."""
    while True:
        try:
            return await fn(*args, **kwargs), None
        except FileNotFoundError as e:
            # meaningful outcome for the caller, never retried away
            return None, e
        except (IOError, OSError, TimeoutError) as e:
            if asyncio.get_event_loop().time() > deadline:
                return None, e
            await asyncio.sleep(0.5)


async def check_snapshot(fd, timeout: float = 60.0) -> List[str]:
    """RBD snapshot/clone consistency:

    - every snapshot read is POINT-IN-TIME: each judged region holds one
      whole generation that had been attempted before the snap acked —
      never post-snap bytes (a COW miss), never a torn mix;
    - clone parents are immutable: the parent snap's bytes pinned at
      clone time read back identical after all child copy-up churn;
    - the clone itself resolves correctly: regions the child acked hold
      the child's bytes, untouched regions fall through to the pinned
      parent snap (copy-up preserved, not clobbered).
    """
    failures: List[str] = []
    deadline = asyncio.get_event_loop().time() + timeout
    rs = fd.region_size
    for snap in sorted(fd.snaps):
        img = await fd.open_image(fd.image_name)
        for region, allowed in sorted(fd.snaps[snap].items()):
            got, err = await _read_retry(img.read, deadline,
                                         region * rs, rs, snap_name=snap)
            if err is not None:
                failures.append(f"snapshot: {fd.image_name}@{snap} "
                                f"region {region} unreadable: {err!r}")
            elif bytes(got) not in allowed:
                failures.append(
                    f"snapshot: {fd.image_name}@{snap} region {region} "
                    f"holds torn or post-snap bytes "
                    f"{bytes(got)[:24]!r}...")
    if fd.parent_pin:
        img = await fd.open_image(fd.image_name)
        for region, pinned in sorted(fd.parent_pin.items()):
            got, err = await _read_retry(
                img.read, deadline, region * rs, rs,
                snap_name=fd.parent_snap)
            if err is not None or bytes(got) != pinned:
                failures.append(
                    f"snapshot: clone parent {fd.image_name}"
                    f"@{fd.parent_snap} region {region} MUTATED under "
                    f"child churn (err={err!r})")
    if fd.clone_expect:
        clone = await fd.open_image(fd.clone_name)
        for region, allowed in sorted(fd.clone_expect.items()):
            got, err = await _read_retry(clone.read, deadline,
                                         region * rs, rs)
            if err is not None:
                failures.append(f"snapshot: clone {fd.clone_name} "
                                f"region {region} unreadable: {err!r}")
            elif bytes(got) not in allowed:
                failures.append(
                    f"snapshot: clone {fd.clone_name} region {region} "
                    f"lost copy-up bytes ({bytes(got)[:24]!r}...)")
    return failures


async def check_multipart(fd, timeout: float = 60.0) -> List[str]:
    """RGW multipart consistency (judged AFTER the reclaim pass):

    - an ACKED complete is fully visible: listed in the bucket index
      and readable with exactly the manifest's bytes;
    - an interrupted (never-acked) complete is ALL-OR-NOTHING: either
      fully visible with exact bytes (reclaim rolled it forward) or
      fully absent (listing and head agree on 404) — never partial;
    - no orphaned part objects survive the reclaim pass;
    - the bucket-index listing matches readable objects: every listed
      key serves its payload.
    """
    failures: List[str] = []
    deadline = asyncio.get_event_loop().time() + timeout
    listing, err = await _read_retry(fd.rgw.list_objects, deadline,
                                     fd.bucket, "", "", 100000)
    if err is not None:
        return [f"multipart: bucket {fd.bucket} unlistable: {err!r}"]
    listed = {m.key for m in listing.keys}
    for key, payload in sorted(fd.mp_completed.items()):
        got, err = await _read_retry(fd.rgw.get_object, deadline,
                                     fd.bucket, key)
        if err is not None:
            failures.append(f"multipart: acked complete {key} "
                            f"unreadable: {err!r}")
        elif got[1] != payload:
            failures.append(f"multipart: acked complete {key} holds "
                            f"wrong bytes ({len(got[1])} != "
                            f"{len(payload)})")
        if key not in listed:
            failures.append(f"multipart: acked complete {key} missing "
                            f"from the bucket listing")
    for key, payload in sorted(fd.mp_pending.items()):
        if key in listed:
            got, err = await _read_retry(fd.rgw.get_object, deadline,
                                         fd.bucket, key)
            if err is not None or got[1] != payload:
                failures.append(
                    f"multipart: interrupted complete {key} is "
                    f"PARTIALLY visible (listed but wrong/unreadable "
                    f"bytes, err={err!r})")
        else:
            _, err = await _read_retry(fd.rgw.head_object, deadline,
                                       fd.bucket, key)
            if not isinstance(err, FileNotFoundError):
                failures.append(
                    f"multipart: interrupted complete {key} not listed "
                    f"but head disagrees (err={err!r})")
    orphans = await fd.part_oids()
    if orphans:
        failures.append(f"multipart: {len(orphans)} orphaned part "
                        f"object(s) survive the reclaim pass: "
                        f"{sorted(orphans)[:4]}")
    for key in sorted(listed):
        _, err = await _read_retry(fd.rgw.get_object, deadline,
                                   fd.bucket, key)
        if err is not None:
            failures.append(f"multipart: listed key {key} is not "
                            f"readable ({err!r}) — index diverged from "
                            f"objects")
    return failures


async def check_namespace(fd, timeout: float = 60.0) -> List[str]:
    """MDS namespace consistency after crash + journal replay:

    - every ACKED metadata op's effect is present post-replay (an acked
      mkdir/create resolves, an acked rename's destination exists) —
      journal trim never ate an unreplayed segment;
    - paths acked as REMOVED (rename source, unlink) stay gone — replay
      never resurrects superseded state;
    - unacked ops may have landed or not (at-least-once journalling),
      but the tree itself must be walkable: every model directory
      lists cleanly.
    """
    failures: List[str] = []
    deadline = asyncio.get_event_loop().time() + timeout
    for path, kind in sorted(fd.ns_model.items()):
        ino, err = await _read_retry(fd.fs_stat, deadline, path)
        if err is not None:
            failures.append(f"namespace: acked {kind} {path} lost "
                            f"post-replay ({err!r})")
        elif getattr(ino, "mode", kind) != kind:
            failures.append(f"namespace: {path} is {ino.mode}, acked "
                            f"as {kind}")
    for path in sorted(fd.ns_gone):
        _, err = await _read_retry(fd.fs_stat, deadline, path)
        if not isinstance(err, FileNotFoundError):
            failures.append(f"namespace: removed path {path} "
                            f"resurrected post-replay (err={err!r})")
    for path, kind in sorted(fd.ns_model.items()):
        if kind != "dir":
            continue
        _, err = await _read_retry(fd.fs_listdir, deadline, path)
        if err is not None:
            failures.append(f"namespace: dir {path} unlistable "
                            f"post-replay ({err!r})")
    return failures


def check_lockdep() -> List[str]:
    """The observed runtime lock graph must be acyclic (the same graph
    `lockdep dump` serves and graftlint merges)."""
    from ceph_tpu_torch.utils.lockdep import LockDep

    edges = LockDep.instance().dump()["edges"]
    state: Dict[str, int] = {}

    def dfs(node, path):
        state[node] = 1
        for nxt in edges.get(node, ()):
            if state.get(nxt) == 1:
                return path + [nxt]
            if state.get(nxt) is None:
                cyc = dfs(nxt, path + [nxt])
                if cyc:
                    return cyc
        state[node] = 2
        return None

    for node in edges:
        if state.get(node) is None:
            cyc = dfs(node, [node])
            if cyc:
                return [f"lockdep: cycle {' -> '.join(cyc)}"]
    return []
