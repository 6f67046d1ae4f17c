"""rjenkins1 hashing — the hash under every CRUSH decision.

Counterpart of ``ceph_tpu/ops/jenkins.py``, a behavioral mirror of
reference src/crush/hash.c: the crush_hashmix 9-line mix (hash.c:12-22),
seed 1315423911 (:24), and the 1/2/3/4/5-ary variants (:26-90).

The same code runs on Python ints and numpy arrays (the scalar oracle and
the OSDMap host pass) and on torch int64 tensors (the batched mapper on
the card).  Torch has thin uint32 coverage, so every value is held as a
non-negative int64 below 2^32: inputs are masked to their low 32 bits on
entry (a negative int64 bucket id masks to its two's-complement uint32),
and every subtraction and left shift is masked again.  Right shifts of
masked, non-negative values are then logical, as in C.
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911
CRUSH_HASH_RJENKINS1 = 0
M32 = 0xFFFFFFFF


def _u(v):
    """Low 32 bits of ``v`` as a non-negative value of its own kind: a
    Python int, a numpy int64 array (signed and unsigned inputs alike), or
    a torch int64 tensor."""
    if isinstance(v, (int, np.integer)):
        return int(v) & M32
    if isinstance(v, np.ndarray):
        return v.astype(np.int64) & M32
    return v.long() & M32


def _mix(a, b, c):
    """One crush_hashmix round on masked 32-bit values."""
    a = (a - b) & M32
    a = (a - c) & M32
    a = a ^ (c >> 13)
    b = (b - c) & M32
    b = (b - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a) & M32
    c = (c - b) & M32
    c = c ^ (b >> 13)
    a = (a - b) & M32
    a = (a - c) & M32
    a = a ^ (c >> 12)
    b = (b - c) & M32
    b = (b - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a) & M32
    c = (c - b) & M32
    c = c ^ (b >> 5)
    a = (a - b) & M32
    a = (a - c) & M32
    a = a ^ (c >> 3)
    b = (b - c) & M32
    b = (b - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a) & M32
    c = (c - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


_X = 231232
_Y = 1232


def hash1(a):
    a = _u(a)
    h = CRUSH_HASH_SEED ^ a
    b = a
    x, y = _X, _Y
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash2(a, b):
    a, b = _u(a), _u(b)
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash3(a, b, c):
    a, b, c = _u(a), _u(b), _u(c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash4(a, b, c, d):
    a, b, c, d = _u(a), _u(b), _u(c), _u(d)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash5(a, b, c, d, e):
    a, b, c, d, e = _u(a), _u(b), _u(c), _u(d), _u(e)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


def str_hash_rjenkins(data: bytes) -> int:
    """ceph_str_hash_rjenkins (reference src/common/ceph_hash.cc:21-78):
    the object-name hash feeding pg selection."""
    a = 0x9E3779B9
    b = 0x9E3779B9
    c = 0
    k = 0
    length = len(data)
    left = length
    while left >= 12:
        a = (a + int.from_bytes(data[k : k + 4], "little")) & M32
        b = (b + int.from_bytes(data[k + 4 : k + 8], "little")) & M32
        c = (c + int.from_bytes(data[k + 8 : k + 12], "little")) & M32
        a, b, c = _mix(a, b, c)
        k += 12
        left -= 12
    c = (c + length) & M32
    tail = data[k:]
    t = tail + bytes(12 - len(tail))
    if left >= 9:
        c = (c + (int.from_bytes(t[8:11], "little") << 8)) & M32
    if left >= 5:
        b = (b + (int.from_bytes(t[4:8], "little")
                  & (M32 >> (8 * (8 - min(left, 8)))))) & M32
    if left >= 1:
        a = (a + (int.from_bytes(t[0:4], "little")
                  & (M32 >> (8 * (4 - min(left, 4)))))) & M32
    a, b, c = _mix(a, b, c)
    return c
