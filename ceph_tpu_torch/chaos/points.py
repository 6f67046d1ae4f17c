"""Named chaos seams for CLIENT LIBRARIES (round 15).

Counterpart of ``ceph_tpu/chaos/points.py``.

The round-12 ``chaos_crash_point`` machinery power-cuts a *daemon* at a
named seam (``OSD._chaos_point``).  The L8 front doors are different:
librbd and the RGW core are LIBRARIES living inside a client process —
there is no daemon to kill, and "crash" means *the application died
mid-transaction and a restarted application retries (or never does)*.

``maybe_interrupt`` is that model: when the client config's
``chaos_crash_point`` matches the named seam, it raises
``ChaosInterrupt`` — the library op unwinds at this instant, exactly as
if the process had ceased, but the event loop (the "machine") survives.
The armed point is ONE-SHOT: it clears itself on firing, so the
scenario's retry (the restarted application) runs clean and a seeded
schedule resolves exactly one interruption per armed event.

No-op contract: library call sites guard with a single falsy test on
``config.chaos_crash_point`` before importing this module, mirroring
the OSD seam — an unarmed front-door op pays one attribute read.

MDS points are NOT here: the MDS is a daemon, so its seams crash it
through the vstart callback like an OSD (``MDSDaemon._chaos_point``).
"""

from __future__ import annotations

from ceph_tpu_torch.chaos.counters import CHAOS


class ChaosInterrupt(Exception):
    """An armed client-library chaos point fired: the front-door op is
    cut at this instant.  A plain Exception (NOT CancelledError): the
    client process "died", but the scenario runner — the outside world
    observing it — keeps running and decides whether a restarted client
    retries the transaction or abandons it mid-flight."""


def resolve_fire(config, name: str) -> bool:
    """THE armed-point resolution, shared by the client seam below and
    the MDS daemon seam (``MDSDaemon._chaos_point``): chain-head match,
    seeded skip countdown (decremented through the config so a retry's
    traversals continue it), and pop-and-rearm of the chain remainder.
    Returns True when the point fires; the CALLER performs its seam
    action (raise ChaosInterrupt, or crash the daemon).  The armed
    value may be a comma-separated CHAIN: firing pops the head and
    arms the remainder, so one event can cut a transaction, then cut
    its retry (or the next incarnation's replay) at a later seam; an
    empty remainder disarms (one-shot per chain link).

    (``OSD._chaos_point`` keeps its own resolution on purpose: OSD skip
    state is instance-level and observer-re-armable — round-12
    semantics the seeded batch scenarios replay against.)
    """
    cp = config.chaos_crash_point
    if not cp:
        return False
    chain = cp.split(",")
    if chain[0] != name:
        return False
    skip = config.chaos_crash_point_skip
    if skip > 0:
        config.set("chaos_crash_point_skip", skip - 1)
        return False
    config.set("chaos_crash_point", ",".join(chain[1:]))
    return True


def maybe_interrupt(config, name: str) -> None:
    """Fire the armed interrupt seam if it matches ``name``."""
    if resolve_fire(config, name):
        CHAOS.inc("interrupt_points_fired")
        raise ChaosInterrupt(f"chaos interrupt point {name!r} fired")
