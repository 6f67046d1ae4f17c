"""Device-mesh sharding: the data plane's distribution axes.

Counterpart of ``ceph_tpu/parallel/``.  Ceph distributes by declustered
sharding (PGs over OSDs) and intra-object striping; on a device mesh the
same axes become mesh dimensions:

- ``data``: the stripe batch (independent stripes; Ceph's PG/stripe
  parallelism), pure data parallelism;
- ``shard``: the chunk axis (Ceph's per-OSD EC shards): each column of
  the mesh owns a subset of the k+m shards, and decode gathers k
  survivors across the columns with device-to-device copies.

One controller process drives every device of the mesh, as JAX's mesh
does, so a pool's codec stays one object the in-process cluster calls.
"""

from ceph_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    distributed_ec_step,
)
from ceph_tpu_torch.parallel.engine import (  # noqa: F401
    MeshECEngine,
    crush_batch_sharded,
)
