"""Process-wide chaos perf counters (the injected-fault telemetry feed).

One shared ``PerfCounters`` registry, like the device-kernel ``KERNELS``
registry in utils/perf.py: every injector increments it, every daemon's
admin socket serves it via ``chaos report``, and bench.py checks it so a
benchmark run that ate injected faults can never masquerade as a clean
number.  ``chaos_total() == 0`` is the machine-checkable form of the
no-op contract: with all injectors disabled, nothing in the hot path
ever reaches an increment.
"""

from __future__ import annotations

from typing import Dict

from ceph_tpu_torch.utils.perf import PerfCounters

CHAOS = PerfCounters("chaos")

for _name, _desc in (
    ("net_drops", "frames dropped on the virtual wire"),
    ("net_dups", "frames duplicated on the virtual wire"),
    ("net_delays", "frames delayed in flight"),
    ("net_reorders", "frames deferred past later traffic"),
    ("net_resets", "sessions force-reset after a send"),
    ("net_partition_blocks", "connect attempts refused by a partition"),
    ("disk_read_errors", "reads failed with injected EIO"),
    ("disk_write_errors", "transactions failed with injected ENOSPC"),
    ("disk_bitrot_flips", "silent bit flips written to stored objects"),
    ("disk_crashes", "stores crash-stopped (journal tail at risk)"),
    ("disk_torn_journals", "journal tails torn mid-frame at crash"),
    ("disk_lost_frames", "committed journal frames discarded at crash"),
    ("daemon_kills", "daemons hard-stopped by the daemon injector"),
    ("daemon_revives", "daemons revived by the daemon injector"),
    ("daemon_restarts", "daemons bounced keeping their store"),
    ("clock_skews", "clock-skew changes applied to a daemon time source"),
    ("net_batch_item_drops",
     "sub-write items dropped INSIDE a delivered batch frame"),
    ("net_batch_ack_dups", "batched-ack result entries duplicated"),
    ("net_batch_ack_reorders", "batched-ack result lists shuffled"),
    ("crash_points_fired",
     "daemons power-cut at an armed tick/commit crash seam"),
    ("interrupt_points_fired",
     "client-library front-door ops cut at an armed interrupt seam"),
    ("interrupt_retries",
     "front-door transactions retried by a 'restarted' client"),
    ("mds_crash_points_fired",
     "MDS daemons crashed at an armed journal/replay seam"),
):
    CHAOS.add_u64(_name, desc=_desc)


def chaos_total() -> int:
    """Sum of every chaos counter — 0 proves no injector ever fired."""
    return sum(CHAOS.dump()["chaos"].values())


def chaos_report(config=None) -> Dict:
    """The ``chaos report`` admin-command payload: global fault counters
    plus this daemon's active chaos options (config-driven injectors are
    fully described by their chaos_* values)."""
    opts = {}
    if config is not None:
        opts = {k: v for k, v in config.show().items()
                if k.startswith("chaos_")}
    active = any(v for k, v in opts.items() if k != "chaos_seed")
    return {"counters": CHAOS.dump()["chaos"], "options": opts,
            "active": active}
