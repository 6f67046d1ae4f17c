"""crush_ln: fixed-point 2^44*log2(x+1) (reference mapper.c:248-290).

Frozen copy of the port's ``crush/ln.py`` for the benchmark's reference.

The RH/LH halves of the LUT follow exact closed forms (verified entry-by-
entry against the reference table):

    RH[k] = ceil(2^48 * 128 / (128 + k))      k = 0..128
    LH[k] = floor(2^48 * log2(1 + k/128))     k = 0..127

with ONE deployed deviation: LH[128] in crush_ln_table.h is 0xffff00000000,
not the closed form's 2^48 (a rounding artifact of whatever script generated
the deployed table).  Entry 128 is reached whenever a straw2 16-bit draw is
0xFFFF, so bit-compatible placement requires the deployed value — it is
pinned below.  The LL half is pinned in _ll_table.py: the deployed table
deviates from its documented formula for most entries, and bit-compatible
placement requires the deployed values.
"""

from __future__ import annotations

import math

from portbench.reference.crush._ll_table import LL_TBL


def _gen_rh_lh():
    rh, lh = [], []
    for k in range(129):
        rh.append(-(-(2**48 * 128) // (128 + k)))  # exact ceil
        lh.append(math.floor((2**48) * math.log2(1 + k / 128)))
    lh[128] = 0xFFFF00000000  # deployed-table deviation from the closed form
    return tuple(rh), tuple(lh)


RH_TBL, LH_TBL = _gen_rh_lh()


def crush_ln(xin: int) -> int:
    """Exact integer mirror of the reference crush_ln (mapper.c:248-290)."""
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        bits = 32 - (x & 0x1FFFF).bit_length() - 16
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    k = (x >> 8) - 128
    xl64 = (x * RH_TBL[k]) >> 48
    index2 = xl64 & 0xFF
    return (iexpon << 44) + ((LH_TBL[k] + LL_TBL[index2]) >> 4)
