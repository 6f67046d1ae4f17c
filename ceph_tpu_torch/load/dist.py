"""Seeded distributions for graft-load (and graft-chaos).

Counterpart of ``ceph_tpu/load/dist.py``.

THE one implementation of object-popularity and arrival-process
sampling, shared by the chaos scenario runner and the load driver so
"zipfian hot objects" means the same bytes-on-the-wire everywhere
(``_zipf_pick`` moved here from ``chaos/scenario.py``; the
chaos runner re-imports it, preserving its stream consumption exactly —
one ``rng.random()`` per pick — so existing seeded scenarios replay
unchanged).

Everything here draws from a caller-supplied ``random.Random``; stream
derivation stays in ``chaos/rng.py`` (``stream(seed, name)``), and each
simulated client gets its own named stream (``client_stream``) so
adding or removing one client never perturbs another's schedule — the
same replay-key determinism contract as chaos injectors.
"""

from __future__ import annotations

import bisect
import random
from itertools import accumulate
from typing import Dict, List, Sequence, Tuple

_ZIPF_CUM: Dict[Tuple[int, float], List[float]] = {}


def zipf_pick(rng: random.Random, n: int, alpha: float = 1.2) -> int:
    """Rank drawn from a zipfian over [0, n): a few hot objects take
    most writes (the million-client hot-set shape).
    Cumulative weights are precomputed per (n, alpha) — one rng draw
    and a binary search per pick, so stream consumption is exactly one
    ``random()`` call (the chaos seed-replay contract depends on it)."""
    cum = _ZIPF_CUM.get((n, alpha))
    if cum is None:
        cum = _ZIPF_CUM[(n, alpha)] = list(accumulate(
            1.0 / ((r + 1) ** alpha) for r in range(n)))
    x = rng.random() * cum[-1]
    return min(bisect.bisect_left(cum, x), n - 1)


def client_stream(seed: int, client_id: int,
                  tag: str = "sched") -> random.Random:
    """The independent rng stream for one simulated client (per-client
    streams, like per-injector chaos streams: one client's draws never
    shift another's).  The chaos import is deliberately lazy: chaos/
    scenario imports THIS module for the shared zipf sampler, and a
    module-level import back into the chaos package would cycle."""
    from ceph_tpu_torch.chaos.rng import stream

    return stream(seed, f"load:client{client_id}:{tag}")


def arrival_offsets(rng: random.Random, rate: float, duration: float,
                    process: str = "poisson") -> List[float]:
    """Open-loop arrival times in [0, duration) for one client.

    ``poisson``: exponential inter-arrival gaps at ``rate`` ops/s (the
    memoryless per-client arrival process a large independent client
    population aggregates to).  ``fixed``: evenly spaced at 1/rate with
    a seeded phase, so a fleet of fixed-rate clients doesn't arrive in
    lockstep.  Both consume the rng deterministically."""
    if rate <= 0 or duration <= 0:
        return []
    out: List[float] = []
    if process == "fixed":
        gap = 1.0 / rate
        t = rng.random() * gap          # seeded phase
        while t < duration:
            out.append(t)
            t += gap
    elif process == "poisson":
        t = rng.expovariate(rate)
        while t < duration:
            out.append(t)
            t += rng.expovariate(rate)
    else:
        raise ValueError(f"unknown arrival process {process!r}")
    return out


def pick_weighted(rng: random.Random,
                  choices: Sequence[Tuple[str, float]]) -> str:
    """One weighted draw (verb-mix selection): a single ``random()``
    call walked over cumulative weights, so verb mixes of any length
    consume the stream identically."""
    total = sum(w for _, w in choices)
    x = rng.random() * total
    cum = 0.0
    for name, w in choices:
        cum += w
        if x <= cum:
            return name
    return choices[-1][0]
