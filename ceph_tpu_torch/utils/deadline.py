"""Client deadline bookkeeping for multi-op front-door transactions.

The librados verbs carry a per-op ``timeout`` end-to-end (
op_submit caps its attempt budget at the remaining deadline, queues
shed expired work, and the chaos/load "deadline" invariant convicts any
ack arriving past it).  Front-door ops — an RBD striped write, an RGW
multipart complete — fan out into SEVERAL internal RADOS ops; handing
each the full budget would let the transaction ack at N x timeout.

These helpers thread ONE wall deadline through the fan-out: the caller
converts its budget once (``deadline_of``), and every internal op gets
only what remains (``remaining``), which raises TimeoutError the moment
the budget is gone — the op is never submitted, so nothing can ack past
the client's deadline.
"""

from __future__ import annotations

import asyncio
from typing import Optional


def deadline_of(timeout: Optional[float]) -> Optional[float]:
    """Absolute loop-time deadline for a relative budget (None = no
    deadline, the library-default behavior)."""
    if timeout is None:
        return None
    return asyncio.get_event_loop().time() + timeout


def remaining(deadline: Optional[float]) -> Optional[float]:
    """Budget left before ``deadline``; raises TimeoutError when spent
    so an expired transaction stops BEFORE submitting its next op."""
    if deadline is None:
        return None
    left = deadline - asyncio.get_event_loop().time()
    if left <= 0:
        raise TimeoutError("client deadline expired mid-transaction")
    return left
