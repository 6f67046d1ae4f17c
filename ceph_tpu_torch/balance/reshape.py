"""Elastic reshape: grow and drain as first-class resumable operations.

Counterpart of ``ceph_tpu/balance/reshape.py``.

The reference reshapes a cluster through a choreography the operator
usually scripts by hand: ``osd crush add`` + boot for growth,
``osd out`` -> wait for clean PGs -> stop daemon -> ``osd purge`` for
removal.  Here each choreography is a ``ReshapeOp`` whose CURRENT PHASE
is recomputed from the observed osdmap every time it is advanced —
nothing but the goal (which OSD ids, which direction) lives in mgr
memory, so a mgr restart, a dropped tick, or a replayed schedule all
resume exactly where the map says the operation stands.

Ops advance when ``advance()`` runs — from the balancer loop when the
subsystem is enabled, and from every ``balance status``/``balance
grow``/``balance drain`` admin command when it is not (pull-driven, so
``mgr_balancer_enabled=0`` still means zero background activity).

Grow:   "osd grow" mon command mints the ids + CRUSH hosts in one
        Incremental -> phase ``waiting-up`` until every new id boots
        (the operator/scenario starts the daemons) -> ``done``.
Drain:  weight->0 via "osd out" (data drains under CRUSH) -> phase
        ``wait-clean`` until no PG maps onto the drained ids and health
        shows no degraded PGs -> ``wait-down`` until the daemons are
        stopped -> "osd purge" -> ``done``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class ReshapeOp:
    op_id: int
    kind: str                    # "grow" | "drain"
    osd_ids: Tuple[int, ...]     # grow: minted ids; drain: retiring ids
    phase: str = "created"
    detail: str = ""

    def status(self) -> Dict:
        return {"id": self.op_id, "kind": self.kind,
                "osds": list(self.osd_ids), "phase": self.phase,
                "detail": self.detail, "done": self.phase == "done"}


class Reshaper:
    def __init__(self, mgr):
        self.mgr = mgr
        self.ops: Dict[int, ReshapeOp] = {}
        self._next_id = 0

    # -- op creation ----------------------------------------------------------

    async def grow(self, count: int, osds_per_host: int = 1) -> Dict:
        """Mint ``count`` new OSD ids (+ CRUSH hosts) through the mon.
        Returns the op status carrying the new ids; the caller boots the
        daemons and polls until the op reports done."""
        data = await self.mgr.mon_command(
            {"prefix": "osd grow", "count": int(count),
             "osds_per_host": int(osds_per_host)}, timeout=10.0)
        self._next_id += 1
        op = ReshapeOp(self._next_id, "grow",
                       tuple(data["new_osds"]), phase="waiting-up")
        self.ops[op.op_id] = op
        self.mgr.perf.inc("mgr_reshape_grows")
        await self.advance()
        return op.status()

    async def drain_osds(self, osd_ids: List[int]) -> Dict:
        """Start draining ``osd_ids``: mark them out (weight->0) so CRUSH
        moves their data, then follow the map to purge.  ONE batched
        "osd out" — one epoch — so a PG whose whole acting set drains is
        a visible wholesale replacement the mon answers with a pg_temp
        mint, instead of N epochs whose acting set walks away from the
        data one just-joined survivor at a time.

        Named drain_osds, not drain: the lock-graph linter resolves
        calls by attribute name, and bare ``drain`` is asyncio's
        StreamWriter.drain — awaited under send locks everywhere."""
        await self.mgr.mon_command(
            {"prefix": "osd out", "ids": [int(o) for o in osd_ids]},
            timeout=10.0)
        self._next_id += 1
        op = ReshapeOp(self._next_id, "drain", tuple(int(o) for o in osd_ids),
                       phase="wait-clean")
        self.ops[op.op_id] = op
        self.mgr.perf.inc("mgr_reshape_drains")
        await self.advance()
        return op.status()

    # -- phase derivation ------------------------------------------------------

    async def _backfill_pending(self) -> str:
        """Recovery-health witness: weight->0 remaps PGs off the
        drained OSDs INSTANTLY, but the data only follows via backfill.
        Until PG_RECOVERING (pg_temp handoffs + per-OSD unclean beacons,
        pessimistic across placement epochs) clears, the drained
        daemons may hold the sole replica of acked bytes — stopping
        them then is acked-then-lost.  Unavailable health reads as
        pending (safe)."""
        try:
            health = await self.mgr.mon_command({"prefix": "health"},
                                                timeout=5.0)
        except (RuntimeError, TimeoutError, ConnectionError, OSError):
            return "health unavailable"
        checks = (health or {}).get("checks", {})
        hits = [c for c in ("PG_RECOVERING", "PG_DEGRADED",
                            "PG_UNDERSIZED") if c in checks]
        return ",".join(hits)

    def _pgs_on(self, osds: Tuple[int, ...]) -> int:
        """How many PG slots the current map still places on ``osds`` —
        up placements PLUS live pg_temp references: a temp entry naming
        a drained OSD means some PG's acting data still lives there
        (the handoff backfill hasn't finished), so purging it now is
        acked-then-lost no matter what the up arrays say."""
        m = self.mgr.osdmap
        if m is None:
            return -1
        import numpy as np

        tset = set(int(o) for o in osds)
        targets = np.asarray(osds, dtype=np.int64)
        n = 0
        for pid in m.pools:
            up, _ = m.pool_mapping(pid)
            n += int(np.isin(up, targets).sum())
        for temp in m.pg_temp.values():
            n += sum(1 for o in temp if o in tset)
        return n

    async def advance(self) -> List[Dict]:
        """Recompute every open op's phase from the observed map and
        take at most one mon action per op per call."""
        m = self.mgr.osdmap
        out = []
        for op in self.ops.values():
            if op.phase == "done" or m is None:
                out.append(op.status())
                continue
            if op.kind == "grow":
                # ids past our map's max_osd: the grow Incremental has
                # not reached our subscription yet — treat as not-up
                down = [o for o in op.osd_ids
                        if o >= len(m.osd_up) or not m.osd_up[o]]
                if down:
                    op.phase = "waiting-up"
                    op.detail = f"{len(down)} of {len(op.osd_ids)} not up"
                else:
                    op.phase = "done"
                    op.detail = "all new osds up"
            else:  # drain
                # out-ness is re-derived, not remembered: a mon that lost
                # our "osd out" (or a mgr that restarted mid-drain) gets
                # the command again here
                not_out = [o for o in op.osd_ids
                           if o < len(m.osd_exists) and m.osd_exists[o]
                           and m.osd_weight[o] > 0]
                if not_out:
                    await self.mgr.mon_command(
                        {"prefix": "osd out", "ids": not_out},
                        timeout=10.0)
                remaining = self._pgs_on(op.osd_ids)
                still_up = [o for o in op.osd_ids
                            if o < len(m.osd_exists) and m.osd_exists[o]
                            and m.osd_up[o]]
                # only gate on health while the daemons still run: once
                # they are down the data either followed or didn't, and
                # purge is all that's left
                pending = await self._backfill_pending() \
                    if not remaining and still_up else ""
                if remaining:
                    op.phase = "wait-clean"
                    op.detail = f"{remaining} pg slots still mapped"
                elif pending:
                    op.phase = "wait-clean"
                    op.detail = f"backfill in flight: {pending}"
                elif still_up:
                    op.phase = "wait-down"
                    op.detail = (f"stop daemons: {still_up} drained but "
                                 "still running")
                else:
                    # the mon re-validates down+out under its own map —
                    # OUR map can transiently disagree (a daemon flap,
                    # an epoch of lag).  A refusal is "not yet", never
                    # fatal: stay in wait-down and re-derive next tick.
                    purged = 0
                    refused = None
                    for osd in op.osd_ids:
                        if osd < len(m.osd_exists) and \
                                not m.osd_exists[osd]:
                            purged += 1
                            continue
                        try:
                            await self.mgr.mon_command(
                                {"prefix": "osd purge", "id": osd,
                                 "sure": True}, timeout=10.0)
                            purged += 1
                        except (RuntimeError, TimeoutError,
                                ConnectionError, OSError) as e:
                            refused = f"osd.{osd}: {e}"
                            break
                    if refused is None:
                        op.phase = "done"
                        op.detail = f"purged {purged} osds"
                    else:
                        op.phase = "wait-down"
                        op.detail = f"purge deferred ({refused})"
            out.append(op.status())
        return out

    def status(self) -> List[Dict]:
        return [op.status() for op in self.ops.values()]
