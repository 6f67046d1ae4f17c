"""Operator tools (reference src/tools/): crushtool and osdmaptool
analogs on the port's CRUSH and OSDMap, runnable as
``python -m ceph_tpu_torch.tools.<name>``.  Counterpart of
``ceph_tpu/tools/``; rados and objectstore-tool come with the port's
cluster."""
