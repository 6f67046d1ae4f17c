"""Cluster map: pools, PG -> OSD placement pipeline, epochs.

Counterpart of ``ceph_tpu/osdmap/``.
"""

from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGPool, PGid  # noqa: F401
