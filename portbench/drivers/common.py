"""What the drivers share: inputs made from the seed, a seeded sample of
a window's answers, and a latency record."""

from __future__ import annotations

import math
import random
from typing import List, Tuple

import numpy as np
import torch

# rows made per device call (at 4 MiB a row, 256 MiB)
_ROWS_PER_CALL = 64


def payloads(count: int, nbytes: int, seed: int, device) -> np.ndarray:
    """(count, nbytes) uint8 on the host: uniform bytes drawn on ``device``
    from ``seed`` in a few large calls, copied to the host once."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = np.empty((count, nbytes), dtype=np.uint8)
    for lo in range(0, count, _ROWS_PER_CALL):
        n = min(_ROWS_PER_CALL, count - lo)
        t = torch.randint(0, 256, (n, nbytes), dtype=torch.uint8,
                          device=device, generator=g)
        out[lo:lo + n] = t.cpu().numpy()
        del t
    return out


class Sample:
    """A uniform sample of ``k`` of the items offered, drawn from the seed
    (reservoir sampling): the window's answers the check compares."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: List = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def cycle(n: int, seed: int) -> List[int]:
    """A seeded permutation of range(n)."""
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return order


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    rank = max(1, math.ceil(q * len(s) / 100))
    return s[min(rank, len(s)) - 1]


def bytes_wrong(got, want) -> int:
    """Bytes of ``got`` that differ from ``want``; a shape that differs
    counts every byte of ``want``."""
    g = np.asarray(got, dtype=np.uint8)
    w = np.asarray(want, dtype=np.uint8)
    if g.shape != w.shape:
        return int(w.size)
    return int(np.count_nonzero(g != w))


def altered(rows) -> np.ndarray:
    """A copy of ``rows`` with its last byte flipped."""
    a = np.array(rows, dtype=np.uint8, copy=True)
    a.reshape(-1)[-1] ^= 1
    return a


def seeds(seed: int, *salts: int) -> Tuple[int, ...]:
    """Independent sub-seeds of the run's seed."""
    r = random.Random(seed)
    base = [r.getrandbits(63) for _ in range(8)]
    return tuple(base[s % 8] for s in salts)
