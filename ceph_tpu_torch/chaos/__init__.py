"""Deterministic fault injection: the seeded streams, the counters and the
injectors the stores and the messenger call.

Counterpart of ``ceph_tpu/chaos/``.  The port holds ``rng`` (per-injector
streams of one scenario seed), ``counters`` (the process-wide ``CHAOS``
registry the admin socket's ``chaos report`` serves), ``clock`` (the
skewable per-daemon time source), ``points`` (client-library interrupt
seams), ``disk`` (store faults), ``net`` (messenger faults), ``daemons``
(kill / crash / revive / restart, partitions), ``invariants`` (the
post-convergence checks), ``scenario`` (the seeded scenario runner),
``integrity`` (the bitrot-under-load and disk-fill-drain runners),
``frontdoor`` (RBD / RGW / MDS under client interrupts and MDS crashes)
and ``balance`` (live expansion, drain and balancer convergence).  The
package exports both runners.
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
from ceph_tpu_torch.chaos.daemons import (  # noqa: E402,F401
    DaemonInjector,
    heal_partitions,
    partition,
    zero_rates,
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
from ceph_tpu_torch.chaos.scenario import (  # noqa: E402,F401
    Event,
    Scenario,
    Verdict,
    build_schedule,
    builtin_scenarios,
    ev,
    run_scenario,
)
from ceph_tpu_torch.chaos.frontdoor import (  # noqa: E402,F401
    FrontdoorScenario,
    FrontdoorState,
    frontdoor_scenarios,
    run_frontdoor,
)
from ceph_tpu_torch.chaos.balance import (  # noqa: E402,F401
    ElasticScenario,
    build_elastic_plan,
    elastic_scenarios,
    run_elastic,
)
