"""OSD-out map changes: a new epoch's placement and what it moves.

Traffic: a closed loop of map changes on one erasure pool.  Change c
marks a seeded OSD out and the OSD of change c-1 back in, then does what
a daemon does with a new epoch (``osdmap.placement_snapshot``, which maps
every PG of the pool through ``OSDMap.pool_mapping``, and
``placement_delta`` against the previous epoch's snapshot).  A unit of
the window is one change; it completes when the new up sets, primaries
and the set of moved PGs are on the host.

The check draws ``check_changes`` changes of the window and
``check_pgs`` PGs from the seed.  For each drawn change it compares the
drawn PGs and every PG that has to move or that the program says moved:
those the program's rows show holding the OSD marked out (at the last
epoch or at this one) or the OSD marked back in (at this epoch or at the
one before it went out).  A PG's up set only changes where CRUSH drew one
of those two OSDs, so an epoch the program did not apply, to all PGs or
to some, shows in those rows whatever PGs the seed drew.  The up set and
primary of each compared PG are held to the frozen scalar CRUSH chain in
``portbench/reference/``, and its membership in the moved set to whether
the reference's up set or primary differs between the two epochs.  The
reference runs in ``ref_workers`` spawned processes.

The control (``control=True``) is the program on the rule that the
configuration's ``controls["osd_out"]`` names (``CONTROLS``).
"""

from __future__ import annotations

import copy
import dataclasses
import random
import time

import numpy as np

from portbench.drivers import common
from portbench.reference.placement import reference_rows


class ProgramMap:
    """The program's side: its OSDMap, mapped on ``device``."""

    def __init__(self, config, device):
        from ceph_tpu_torch.crush.types import Rule, build_three_level
        from ceph_tpu_torch.osdmap.osdmap import (
            POOL_TYPE_ERASURE, OSDMap, PGPool, placement_delta,
            placement_snapshot)

        cl, pl = config["cluster"], config["pool"]
        cmap, _ = build_three_level(
            int(cl["racks"]), int(cl["hosts_per_rack"]),
            int(cl["osds_per_host"]), weight=int(cl["osd_weight"]))
        root = next(b for b, bk in cmap.buckets.items() if bk.type == 3)
        steps = [tuple(root if a == "root" else int(a) for a in s)
                 for s in cl["rule_steps"]]
        rule = cmap.add_rule(Rule(steps=steps, type=POOL_TYPE_ERASURE))
        self.map = OSDMap(cmap, device=device)
        self.pool_id = int(pl["pool_id"])
        self.map.add_pool(PGPool(
            pool_id=self.pool_id, type=POOL_TYPE_ERASURE,
            size=int(pl["size"]), min_size=int(pl["min_size"]),
            pg_num=int(pl["pg_num"]), pgp_num=int(pl["pg_num"]),
            crush_rule=rule))
        self.n_osds = cmap.max_devices
        self._snapshot = placement_snapshot
        self._delta = placement_delta

    def snapshot(self):
        return self._snapshot(self.map, self.pool_id)

    def change(self, out: int, back_in, prev):
        """Mark ``out`` out and ``back_in`` in; the new epoch's snapshot
        and the seeds that moved since ``prev``."""
        self.map.mark_out(out)
        if back_in is not None:
            self.map.mark_in(back_in)
        snap = self.snapshot()
        return snap, self._delta(prev, snap)

    @staticmethod
    def rows(snap, pgs):
        return snap.up[pgs], snap.upp[pgs]

    @staticmethod
    def holding(snap, osds):
        """The PGs whose up set holds any of ``osds``."""
        if snap is None or not osds:
            return np.zeros(0, dtype=np.int64)
        return np.nonzero(np.isin(snap.up, osds).any(axis=1))[0]


def one_try(config):
    """The erasure rule with one try (``set_choose_tries 1``,
    ``set_chooseleaf_tries 1``, where Ceph's rule states 100 and 5): a
    collision or an out OSD leaves a hole instead of another draw, and the
    rule VM's retry loop, most of its launches, is gone."""
    cfg = copy.deepcopy(config)
    cfg["cluster"]["rule_steps"] = [
        [s[0], 1, 0] if s[0] in (8, 9) else s
        for s in cfg["cluster"]["rule_steps"]]
    return cfg


CONTROLS = {"one_try": one_try}


def _wrap_snapshot(patch, wrap):
    from ceph_tpu_torch.osdmap import osdmap

    patch(osdmap, "placement_snapshot", wrap(osdmap.placement_snapshot))


def state_unchanged(patch):
    """Every epoch's placement is the first one the program made: the map
    change is never applied, and nothing moves."""
    def wrap(real):
        first = {}

        def snapshot(m, pool_id, batch_min=0):
            if "snap" not in first:
                first["snap"] = real(m, pool_id, batch_min)
            return first["snap"]
        return snapshot
    _wrap_snapshot(patch, wrap)


def half_pool(patch):
    """The new epoch is applied to the first half of the PGs; the rest
    keep their rows of the last epoch."""
    def wrap(real):
        last = {}

        def snapshot(m, pool_id, batch_min=0):
            snap = real(m, pool_id, batch_min)
            if "snap" in last:
                h = snap.up.shape[0] // 2
                up, upp = snap.up.copy(), snap.upp.copy()
                up[h:], upp[h:] = last["snap"].up[h:], last["snap"].upp[h:]
                snap = dataclasses.replace(snap, up=up, upp=upp)
            last["snap"] = snap
            return snap
        return snapshot
    _wrap_snapshot(patch, wrap)


def answer_altered(patch):
    """Each PG's last slot given the OSD of its first, where the program
    makes the up sets."""
    def wrap(real):
        def snapshot(m, pool_id, batch_min=0):
            snap = real(m, pool_id, batch_min)
            up = snap.up.copy()
            up[:, -1] = up[:, 0]
            return dataclasses.replace(snap, up=up)
        return snapshot
    _wrap_snapshot(patch, wrap)


# the faults this cell can have, each planted in the program; one card,
# so no exchange between chips to leave out
FAULTS = {"state_unchanged": state_unchanged, "half_pool": half_pool,
          "answer_altered": answer_altered}


class Driver:
    def __init__(self, config, traffic, seed, device, control=False):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.control = control
        self.engine = None
        self.change_s = []
        self.kept = []
        self.changes = 0
        self.moved = 0
        self.profiling = False
        self.profile_work = {}

    def setup(self) -> None:
        config = self.config
        if self.control:
            config = CONTROLS[self.config["controls"]["osd_out"]](config)
        self.engine = ProgramMap(config, self.device)
        s_osd, s_pgs, s_pick = common.seeds(self.seed, 0, 1, 2)
        self.rng = random.Random(s_osd)
        self.s_pick = s_pick
        pg_num = int(self.config["pool"]["pg_num"])
        self.check_pgs = np.array(sorted(random.Random(s_pgs).sample(
            range(pg_num), min(int(self.traffic["check_pgs"]), pg_num))),
            dtype=np.int64)
        self.prev = self.engine.snapshot()
        self.prev2 = None
        self.out = None
        for _ in range(int(self.traffic.get("warm_units", 1))):
            self._change(record=False)

    def _next_osd(self) -> int:
        while True:
            o = self.rng.randrange(self.engine.n_osds)
            if o != self.out:
                return o

    def _change(self, record: bool = True) -> None:
        o = self._next_osd()
        t0 = time.perf_counter()
        snap, delta = self.engine.change(o, self.out, self.prev)
        dt = time.perf_counter() - t0
        before = self.out
        prev, prev2 = self.prev, self.prev2
        self.prev2, self.prev, self.out = prev, snap, o
        if not record:
            return
        moved = np.array(sorted(delta), dtype=np.int64)
        back = [] if before is None else [before]
        must = [self.engine.holding(s, osds) for s, osds in
                ((prev, [o]), (snap, [o] + back), (prev2, back))]
        pgs = np.unique(np.concatenate([self.check_pgs, moved] + must))
        up, upp = self.engine.rows(snap, pgs)
        self.kept.append({"out": o, "before": before, "moved": moved,
                          "pgs": pgs, "up": np.array(up),
                          "upp": np.array(upp)})
        self.change_s.append(dt)
        self.changes += 1
        self.moved += len(moved)
        if self.profiling:
            self.profile_work["changes"] = \
                self.profile_work.get("changes", 0) + 1

    def step(self) -> None:
        self._change()

    def units_to_check(self) -> int:
        """Changes that give the check its sample."""
        return int(self.traffic["check_changes"])

    def stats(self) -> dict:
        return {"attempted": self.changes, "failed": 0,
                "changes": self.changes, "moved_pgs": self.moved,
                "op_ms": [s * 1e3 for s in self.change_s]}

    def release(self) -> None:
        self.engine = None
        self.prev = self.prev2 = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> dict:
        want = int(self.traffic["check_changes"])
        picked = random.Random(self.s_pick).sample(
            self.kept, min(want, len(self.kept)))
        tasks, where = [], []
        for c, kept in enumerate(picked):
            now = (kept["out"],)
            before = () if kept["before"] is None else (kept["before"],)
            for j, pg in enumerate(kept["pgs"]):
                tasks.append((int(pg), now, before))
                where.append((c, j))
        ref = reference_rows(self.config["cluster"], self.config["pool"],
                             tasks, int(self.traffic.get("ref_workers", 1)))
        pgs_wrong = moved_wrong = 0
        for (c, j), ((up, p), (up0, p0)) in zip(where, ref):
            kept = picked[c]
            pg = int(kept["pgs"][j])
            got_up = [int(v) for v in kept["up"][j]]
            if got_up != up or int(kept["upp"][j]) != p:
                pgs_wrong += 1
            moved = up != up0 or p != p0
            said = bool(np.isin(pg, kept["moved"]))
            moved_wrong += moved != said
        return {"pgs_wrong": (pgs_wrong, 0),
                "moved_wrong": (moved_wrong, 0),
                "changes_unchecked": (want - len(picked), 0)}
