"""Erasure-code framework of the port: interface, registry, codecs.

Counterpart of ``ceph_tpu/ec``: the ``ErasureCodeInterface`` contract
(reference ErasureCodeInterface.h:170-462), a plugin registry and the
jerasure, ISA, LRC and SHEC codec families, with the bulk GF(2) math on a
torch device.
"""

from ceph_tpu_torch.ec.interface import ErasureCodeInterface, ECError  # noqa: F401
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry, factory  # noqa: F401
