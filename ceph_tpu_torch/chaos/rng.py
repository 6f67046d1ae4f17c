"""Seeded RNG stream derivation: the determinism root of graft-chaos.

Every injector draws from its own named stream derived from the single
scenario seed, so (a) two runs with the same ``--seed`` make identical
random decisions per injector, and (b) adding or removing one injector
never perturbs the streams of the others (the classic shared-RNG replay
bug: one extra ``random()`` call shifts every later decision).  The
reference's teuthology thrashers seed one ``random.Random`` per task for
the same reason.
"""

from __future__ import annotations

import hashlib
import random


def derive_seed(seed: int, name: str) -> int:
    """A 64-bit child seed for stream ``name``; stable across runs,
    processes, and Python versions (sha256, not ``hash()``, which is
    salted per-process)."""
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little")


def stream(seed: int, name: str) -> random.Random:
    """An independent deterministic RNG stream for one injector."""
    return random.Random(derive_seed(seed, name))
