"""The mini-cluster around the port's device engines.

Counterpart of ``ceph_tpu/cluster/``.  The port holds so far ``auth``
(the cephx-lite tickets ``utils.config.Config.cephx_context`` builds);
the stores, messenger, monitor and OSD arrive in later slices.
"""
