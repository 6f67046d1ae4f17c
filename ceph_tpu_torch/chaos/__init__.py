"""Deterministic fault injection: the seeded streams and the counters.

Counterpart of ``ceph_tpu/chaos/``.  The port holds so far the two
modules the host foundation imports: ``rng`` (per-injector streams of one
scenario seed) and ``counters`` (the process-wide ``CHAOS`` registry the
admin socket's ``chaos report`` serves).  The injectors arrive with the
cluster.
"""
