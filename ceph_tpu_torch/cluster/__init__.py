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
  B1 and B2) behind the OSD;
- ``paxos`` (``Elector``, ``Paxos``), ``mon`` (``Monitor``: the map
  authority, its commands and the pg_temp mint on batched placements),
  ``monclient`` (``MonTargeter``) and ``mgr`` (``MgrDaemon``: reports,
  the balance loops of ``ceph_tpu_torch.balance``, ``render_prometheus``).

- the OSD (``osd``: ``OSDDaemon``) with its PG state and log (``pg``,
  ``pglog``), backends (``backend_replicated``, ``backend_ec``: encode,
  decode, verify and re-encode through the batchers on kernels B1 and
  B2), client ops, snapshots, object classes and cache tiering
  (``client_ops``, ``snaps``, ``objclass``, ``tiering``), recovery and
  scrub, the op shards and their QoS queue (``sharded_wq``,
  ``dmclock``);
- ``objecter`` (``Objecter``, ``RadosClient``, ``IoCtx``) and ``vstart``
  (``start_cluster``, ``Cluster``, ``Cluster.start_mds``): a whole
  in-process cluster on one device;
- the clients: ``striper``, ``rbd`` and ``rbd_mirror`` (block images),
  ``rgw``, ``rgw_http`` and ``rgw_sync`` (the object gateway, its S3 and
  Swift frontend, multisite sync), ``fs`` and ``mds`` (CephFS and its
  metadata server).
"""
