"""Operator tools (reference src/tools/): crushtool and osdmaptool
analogs on the port's CRUSH and OSDMap, runnable as
``python -m ceph_tpu_torch.tools.<name>``.  Counterpart of
``ceph_tpu/tools/``, with ``rados``, ``ceph`` and ``objectstore_tool``
for the port's cluster and ``ec_sidecar``, the process the native EC
plugin shim (``native/ec_sidecar/``) reaches the port's codecs through."""
