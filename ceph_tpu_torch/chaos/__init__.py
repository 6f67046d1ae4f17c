"""Deterministic fault injection: the seeded streams, the counters and the
injectors the stores and the messenger call.

Counterpart of ``ceph_tpu/chaos/``.  The port holds ``rng`` (per-injector
streams of one scenario seed), ``counters`` (the process-wide ``CHAOS``
registry the admin socket's ``chaos report`` serves), ``clock`` (the
skewable per-daemon time source), ``points`` (client-library interrupt
seams), ``disk`` (store faults) and ``net`` (messenger faults).  The
daemon injector and the scenario runners arrive with the cluster.
"""

import asyncio as _asyncio


class ChaosCrash(_asyncio.CancelledError):
    """Raised by an armed crash point (OSD._chaos_point): unwinds the
    current coroutine exactly like a task dying mid-await — the closest
    in-process model of 'the process ceased at this instant'.  A
    CancelledError subclass so every ``except asyncio.CancelledError:
    raise`` hygiene path propagates it and the dying tasks never warn
    about unretrieved exceptions."""


from ceph_tpu_torch.chaos.clock import ChaosClock  # noqa: E402,F401
from ceph_tpu_torch.chaos.counters import (  # noqa: E402,F401
    CHAOS,
    chaos_report,
    chaos_total,
)
from ceph_tpu_torch.chaos.disk import DiskInjector  # noqa: E402,F401
from ceph_tpu_torch.chaos.net import (  # noqa: E402,F401
    NetInjector,
    ensure_injector,
)
from ceph_tpu_torch.chaos.points import (  # noqa: E402,F401
    ChaosInterrupt,
    maybe_interrupt,
)
from ceph_tpu_torch.chaos.rng import derive_seed, stream  # noqa: E402,F401
