"""graft-trace: cross-daemon span tracing + event-loop profiling.

Counterpart of ``ceph_tpu/trace/``.  The observability instrument for
the cluster/device gap: one client op becomes one cross-daemon tree of
timed spans, its event timeline rolls up into a per-stage wall-time
breakdown, and an asyncio profiler watches the loop the whole daemon
runs on.  Everything is a provable no-op at default config — the same
contract the chaos injectors honor — so load-sensitive benchmarks are
untouched.

- ``span``        Tracer/Span/NULL_SPAN, header propagation, tree assembly.
- ``attribution`` event timeline -> per-stage latency attribution.
- ``loopmon``     sampled event-loop lag + task queue/wall profiling.
- ``perfetto``    chrome://tracing / Perfetto JSON export.
- ``flight``      graft-blackbox per-daemon flight-recorder rings.
- ``postmortem``  triggered POSTMORTEM_* bundles + breach attribution.
"""

from ceph_tpu_torch.trace.span import (  # noqa: F401
    CURRENT_SPAN,
    NULL_SPAN,
    Span,
    Tracer,
    assemble_tree,
)
from ceph_tpu_torch.trace.attribution import (  # noqa: F401
    aggregate,
    aggregate_tracker,
    attribute_events,
    spans_from_events,
    stage_for,
)
from ceph_tpu_torch.trace.loopmon import LoopProfiler  # noqa: F401
from ceph_tpu_torch.trace.flight import (  # noqa: F401
    NULL_FLIGHT,
    FlightRecorder,
    merged_timeline,
)
