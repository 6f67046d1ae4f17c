"""rjenkins1 on plain Python ints: the hash under every CRUSH decision.

Written for the benchmark's reference from the reference C (src/crush/
hash.c: the crush_hashmix 9-line mix, seed 1315423911, the 1..5-ary
variants).  Every value is an int in [0, 2^32); inputs are masked to their
low 32 bits, so a negative bucket id hashes as its two's complement.
Held to the C goldens' hash vectors by the benchmark's tests.
"""

from __future__ import annotations

CRUSH_HASH_SEED = 1315423911
M32 = 0xFFFFFFFF
_X = 231232
_Y = 1232


def _mix(a: int, b: int, c: int):
    a = (a - b - c) & M32
    a ^= c >> 13
    b = (b - c - a) & M32
    b ^= (a << 8) & M32
    c = (c - a - b) & M32
    c ^= b >> 13
    a = (a - b - c) & M32
    a ^= c >> 12
    b = (b - c - a) & M32
    b ^= (a << 16) & M32
    c = (c - a - b) & M32
    c ^= b >> 5
    a = (a - b - c) & M32
    a ^= c >> 3
    b = (b - c - a) & M32
    b ^= (a << 10) & M32
    c = (c - a - b) & M32
    c ^= b >> 15
    return a, b, c


def hash1(a) -> int:
    a = int(a) & M32
    h = CRUSH_HASH_SEED ^ a
    b, x, y = a, _X, _Y
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash2(a, b) -> int:
    a, b = int(a) & M32, int(b) & M32
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash3(a, b, c) -> int:
    a, b, c = int(a) & M32, int(b) & M32, int(c) & M32
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash4(a, b, c, d) -> int:
    a, b, c, d = int(a) & M32, int(b) & M32, int(c) & M32, int(d) & M32
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash5(a, b, c, d, e) -> int:
    a, b, c = int(a) & M32, int(b) & M32, int(c) & M32
    d, e = int(d) & M32, int(e) & M32
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
