"""graft-race dynamic half, part 1: the schedule-perturbation loop.

asyncio's ready queue is FIFO, so every test run explores ONE
interleaving of the data plane's tasks — the one where whoever called
``call_soon`` first runs first.  Await-atomicity bugs (stale snapshot
across an ack-wait, check-then-act across a fan-out) only fire under
the interleavings FIFO never produces.  ``SchedFuzzLoop`` is a
SelectorEventLoop whose per-tick callback order is a seeded
Fisher-Yates permutation drawn from a chaos-rng stream
(``stream(seed, "schedfuzz")``), plus seeded DEFERRAL of ready
callbacks to the next tick — an injected yield window at every await
boundary, bounded per handle so nothing starves.  Same seed, same
workload => bit-identical permutation stream (``trace_digest``);
different seeds explore different interleavings of the same program.

Two hard safety rules keep the shim honest:

- at least one ready handle always runs per tick (deferring the whole
  queue would park the loop in ``select()`` with runnable work held
  hostage — a deadlock the PROGRAM doesn't have);
- a handle is deferred at most ``max_defer`` consecutive times, then
  it runs unconditionally (bounded starvation, so timeouts measure the
  program, not the shim).

The shim perturbs only ORDER and tick assignment, never drops or
duplicates a callback, so any invariant breach under it is a real
interleaving the unperturbed loop was licensed to produce all along.

``self._ready`` is CPython's private BaseEventLoop queue; the shim
gates on its existence and degrades to a plain (unperturbed) loop with
an empty trace when an implementation doesn't expose it.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Callable, List, Optional, Tuple

from ceph_tpu_torch.chaos.rng import stream


class SchedFuzzLoop(asyncio.SelectorEventLoop):
    """A SelectorEventLoop with seeded ready-queue perturbation."""

    def __init__(self, seed: int, defer_prob: float = 0.25,
                 max_defer: int = 4,
                 on_tick: Optional[Callable[[], None]] = None):
        super().__init__()
        self.seed = seed
        self._fuzz_rng = stream(seed, "schedfuzz")
        self._fuzz_defer_prob = float(defer_prob)
        self._fuzz_max_defer = max(0, int(max_defer))
        self._fuzz_on_tick = on_tick
        self._fuzz_tick = 0
        self._fuzz_trace: List[Tuple[int, int, Tuple[int, ...], int]] = []
        self._fuzz_deferred: List = []
        self._fuzz_defer_counts: dict = {}
        # private-API gate: no _ready => plain loop, empty trace
        self._fuzz_active = hasattr(self, "_ready")

    # -- the perturbation ----------------------------------------------------

    def _fuzz_perturb(self) -> None:
        ready = self._ready
        # handles deferred last tick re-enter ahead of this tick's
        # shuffle (they may be deferred again, up to max_defer)
        if self._fuzz_deferred:
            ready.extend(self._fuzz_deferred)
            self._fuzz_deferred.clear()
        if len(ready) <= 1:
            return
        # partition: only TASK steps and wakeups are perturbable —
        # they are the coroutine interleaving points the sanitizer
        # explores.  Loop and transport plumbing (sock-connect
        # completions, reader/writer lifecycle, _sock_write_done) must
        # keep FIFO order among themselves: deferring an fd-lifecycle
        # callback past the fd's reuse breaks asyncio itself, and a
        # crash the PROGRAM can't produce is a false conviction.
        fixed: List = []
        tasky: List = []
        for h in ready:
            cb = getattr(h, "_callback", None)
            owner = getattr(cb, "__self__", None)
            if isinstance(owner, asyncio.Task) \
                    and not getattr(h, "_cancelled", False):
                tasky.append(h)
            else:
                fixed.append(h)
        n = len(tasky)
        if n <= 1:
            return  # nothing to permute: queue left untouched
        self._fuzz_tick += 1
        if self._fuzz_on_tick is not None:
            self._fuzz_on_tick()
        # seeded Fisher-Yates over this tick's task handles
        perm = list(range(n))
        for i in range(n - 1, 0, -1):
            j = self._fuzz_rng.randrange(i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        items = [tasky[k] for k in perm]
        # seeded deferral: push a task step past the tick boundary —
        # the injected yield window.  Never the whole queue, never the
        # same handle more than max_defer times in a row.
        run_now: List = []
        deferred = 0
        for h in items:
            key = id(h)
            over = self._fuzz_defer_counts.get(key, 0)
            if ((fixed or run_now) and over < self._fuzz_max_defer
                    and self._fuzz_rng.random() < self._fuzz_defer_prob):
                self._fuzz_defer_counts[key] = over + 1
                self._fuzz_deferred.append(h)
                deferred += 1
            else:
                self._fuzz_defer_counts.pop(key, None)
                run_now.append(h)
        ready.clear()
        ready.extend(fixed)
        ready.extend(run_now)
        self._fuzz_trace.append((self._fuzz_tick, n, tuple(perm), deferred))

    def _run_once(self):
        if self._fuzz_active:
            self._fuzz_perturb()
        super()._run_once()

    # -- replay evidence -----------------------------------------------------

    def fuzz_trace(self) -> List[Tuple[int, int, Tuple[int, ...], int]]:
        """(tick, ready-set size, permutation, deferred count) per
        perturbed tick — the full decision record."""
        return list(self._fuzz_trace)

    def trace_digest(self) -> str:
        """Compact replay key over the decision record.  Two runs of
        the same seed over the same (IO-free) workload produce the same
        digest bit for bit; cluster scenarios with real sockets compare
        ``Verdict.replay_key()`` instead (select() readiness order is
        the OS's, not ours)."""
        h = hashlib.sha256(repr(self._fuzz_trace).encode())
        return h.hexdigest()


def run_fuzzed(factory, seed: int, defer_prob: float = 0.25,
               max_defer: int = 4,
               on_tick: Optional[Callable[[], None]] = None):
    """Run ``factory()`` (a coroutine factory) to completion on a fresh
    SchedFuzzLoop; returns ``(result, trace_digest)``.  The loop is
    installed as the thread's event loop for the duration (cluster code
    reaches it via ``get_event_loop``) and always restored + closed."""
    loop = SchedFuzzLoop(seed, defer_prob=defer_prob, max_defer=max_defer,
                         on_tick=on_tick)
    try:
        asyncio.set_event_loop(loop)
        result = loop.run_until_complete(factory())
        return result, loop.trace_digest()
    finally:
        asyncio.set_event_loop(None)
        loop.close()
