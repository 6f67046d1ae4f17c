"""The mini-cluster around the port's device engines.

Counterpart of ``ceph_tpu/cluster/``.  The port holds so far:

- ``auth``: the cephx-lite tickets ``utils.config.Config.cephx_context``
  builds;
- ``optracker``: in-flight and historic op tracing;
- the object stores: ``store`` (``Transaction``, ``MemStore``), ``kv``,
  ``filestore`` (journaled) and ``bluestore`` (block device, allocator,
  csums verified on every read);
- ``messenger`` and ``messages``: sessions with replay over asyncio TCP,
  signed frames, and every wire message;
- ``batcher``: the tick batchers that put the stripe functions (kernels
  B1 and B2) behind the OSD.

The monitor, the manager, the OSD and the clients arrive in later slices.
"""
