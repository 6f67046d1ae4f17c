"""The race sanitizer's cross-task access tracker.

Counterpart of ``ceph_tpu/analysis/racecheck.py``.

The schedule shim (``ceph_tpu_torch/utils/schedfuzz.py``) makes hostile
interleavings HAPPEN; this module makes them VISIBLE.  Hot cluster
seams carry two probes, piggybacked on the same per-task bookkeeping
lockdep already maintains:

- ``note_read(key, field)``  — a task snapshotted watched shared state
  (a PGState pulled from the registry at commit start, a self-info
  captured at recovery round start);
- ``note_write(key, field)`` — a task mutated that state (the registry
  entry replaced by peering, the log head advanced by a commit).

A conviction is a WRITE-AFTER-READ window that closed dirty: task B
wrote ``key`` after task A read it, A and B held no common DepLock at
their probes (``DepLock._held`` snapshots), and A finished without
ever RE-reading the key.  A later ``note_read`` by the same task
cancels the pending conviction — that is exactly what a revalidation
(the commit path's PG identity re-check, recovery's self-info refresh)
looks like at runtime, so fixed code convicts nothing while reverting
either fix re-convicts under the race smoke.  Each finding carries both probe
stacks, tasks, ticks, and held-lock sets — the interleaving is
attributed, not just detected.

No-op contract (the NULL_FLIGHT shape, ``ceph_tpu_torch/trace/flight.py``):
the module-global ``TRACKER`` is the falsy ``NULL_RACE`` singleton
unless a race run installs a real tracker, and every probe site guards
with one truthiness test — the disabled hot path is one global load
plus one bool, allocating and retaining nothing (pinned by
tests/test_racecheck.py).

This module never imports cluster code (the probes import US).  The
reference's seeded scenario runner (``race_run``) needs the scenario
layer, which the port does not have yet.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.utils.lockdep import DepLock


class _NullRace:
    """Shared disabled tracker: one falsy test at every probe site,
    zero allocation, zero retention (the NULL_FLIGHT analog)."""

    __slots__ = ()

    enabled = False

    def __bool__(self) -> bool:
        return False

    def note_read(self, key, field: str = "") -> None:
        pass

    def note_write(self, key, field: str = "") -> None:
        pass

    def advance_tick(self) -> None:
        pass

    def findings(self) -> List[Dict]:
        return []

    def report(self) -> Dict:
        return {"enabled": False, "seed": 0, "ticks": 0,
                "reads": 0, "writes": 0, "findings": []}


NULL_RACE = _NullRace()


class _Probe:
    """One probe firing: who, where, when, holding what."""

    __slots__ = ("seq", "tick", "task", "task_name", "held", "site",
                 "stack")

    def __init__(self, seq: int, tick: int, task, held: List[str],
                 stack: List[str]):
        self.seq = seq
        self.tick = tick
        self.task = task
        self.task_name = task.get_name() if task is not None else "<no-task>"
        self.held = held
        self.site = stack[-1] if stack else "<unknown>"
        self.stack = stack

    def as_dict(self) -> Dict:
        return {"task": self.task_name, "tick": self.tick,
                "seq": self.seq, "held": list(self.held),
                "site": self.site, "stack": list(self.stack)}


class RaceTracker:
    """The enabled tracker (installed per race run, never by default).

    Read records are kept per (key, task): a task's LATEST read of a
    key is the one that matters — re-reading IS revalidation.  A write
    over another live task's un-revalidated read with disjoint held
    locks opens a pending conviction; it becomes a finding only if the
    reader finishes without re-reading (``findings()`` checks
    ``task.done()``, so a scenario judges after its tasks drained)."""

    enabled = True

    def __init__(self, seed: int = 0, stack_depth: int = 6,
                 max_findings: int = 64):
        self.seed = seed
        self.stack_depth = stack_depth
        self.max_findings = max_findings
        self._seq = 0
        self._tick = 0
        self._reads: Dict[Tuple, Dict[int, _Probe]] = {}
        self._pending: List[Dict] = []
        self._convicted: set = set()
        self.reads = 0
        self.writes = 0

    def __bool__(self) -> bool:
        return True

    # -- probe plumbing ------------------------------------------------------

    def advance_tick(self) -> None:
        self._tick += 1

    def _probe(self) -> Optional[_Probe]:
        try:
            task = asyncio.current_task()
        except RuntimeError:
            task = None
        if task is None:
            return None  # probes outside a task can't interleave
        held = list(DepLock._held.get(id(task), ()))
        stack = []
        for fr in traceback.extract_stack(limit=self.stack_depth + 2)[:-2]:
            fn = fr.filename
            cut = fn.rfind("ceph_tpu")
            stack.append(f"{fn[cut:] if cut >= 0 else fn}:"
                         f"{fr.lineno}:{fr.name}")
        self._seq += 1
        return _Probe(self._seq, self._tick, task, held, stack)

    def note_read(self, key, field: str = "") -> None:
        """A task snapshotted (or re-read: revalidated) watched state."""
        p = self._probe()
        if p is None:
            return
        self.reads += 1
        k = (key, field)
        self._reads.setdefault(k, {})[id(p.task)] = p
        # a re-read cancels this task's pending convictions on the key:
        # the task looked again after the write — the fixed shape
        self._pending = [
            pc for pc in self._pending
            if not (pc["k"] == k and pc["reader_task"] is p.task
                    and pc["write"].seq < p.seq)]

    def note_write(self, key, field: str = "") -> None:
        """A task mutated watched state: convict every OTHER live
        task still holding an un-revalidated read of it, unless a
        common DepLock serialized the pair."""
        p = self._probe()
        if p is None:
            return
        self.writes += 1
        k = (key, field)
        readers = self._reads.get(k, {})
        for rp in list(readers.values()):
            if rp.task is p.task:
                # a task's own write neither convicts (no interleave)
                # nor revalidates (its local snapshot is still stale —
                # the single-task half of the self-info fix); the record stands
                # for later cross-task writes
                continue
            if rp.task.done():
                # the reader finished before this write: window closed
                readers.pop(id(rp.task), None)
                continue
            if set(rp.held) & set(p.held):
                continue  # a common lock serialized read and write
            sig = (k, rp.site, p.site)
            if sig in self._convicted:
                continue
            if len(self._pending) >= self.max_findings:
                continue
            self._convicted.add(sig)
            self._pending.append({"k": k, "reader_task": rp.task,
                                  "read": rp, "write": p})

    # -- judgment ------------------------------------------------------------

    def findings(self) -> List[Dict]:
        """Pending convictions whose reader finished without re-reading
        — the write-after-read window provably closed dirty."""
        out = []
        for pc in self._pending:
            if not pc["reader_task"].done():
                continue  # still open: not judgeable yet
            if pc["reader_task"].cancelled():
                # a cancelled reader (power-cut daemon, scenario
                # teardown) unwound without acting on the snapshot —
                # never a conviction, or every chaos kill would convict
                # its own victim's in-flight commits
                continue
            key, field = pc["k"]
            out.append({
                "rule": "write-after-read",
                "key": repr(key), "field": field,
                "message": (f"task {pc['write'].task_name!r} wrote "
                            f"{key!r}/{field} at tick "
                            f"{pc['write'].tick} after task "
                            f"{pc['read'].task_name!r} read it at tick "
                            f"{pc['read'].tick}; no common lock, no "
                            f"revalidation before the reader finished"),
                "read": pc["read"].as_dict(),
                "write": pc["write"].as_dict(),
            })
        return out

    def report(self) -> Dict:
        fnd = self.findings()
        return {"enabled": True, "seed": self.seed, "ticks": self._tick,
                "reads": self.reads, "writes": self.writes,
                "pending_open": sum(
                    1 for pc in self._pending
                    if not pc["reader_task"].done()),
                "findings": fnd}


# -- the global probe target -------------------------------------------------

TRACKER = NULL_RACE


def install(tracker):
    """Swap the probe target; returns the previous one (restore it)."""
    global TRACKER
    prev = TRACKER
    TRACKER = tracker
    return prev


def uninstall() -> None:
    global TRACKER
    TRACKER = NULL_RACE


def from_config(config):
    """NULL_RACE unless ``race_check_enabled=1`` (the blackbox/trace
    factory contract: default-off is a provable no-op)."""
    if not getattr(config, "race_check_enabled", 0):
        return NULL_RACE
    return RaceTracker(seed=getattr(config, "race_check_seed", 0))
