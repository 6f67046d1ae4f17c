"""CRUSH placement: map structures, straw2, scalar oracle, batched mapper.

Counterpart of ``ceph_tpu/crush/``, a behavioral mirror of reference
src/crush/ (mapper.c, hash.c, builder.c, crush.h): deterministic
hierarchical placement with straw2 buckets, firstn/indep selection and
tunable retry semantics, rebuilt so a whole pool's PG->OSD mapping runs
as batched torch ops on the card (``mapper.TensorMapper``).
"""

from ceph_tpu_torch.crush.types import (  # noqa: F401
    Bucket,
    CrushMap,
    Rule,
    Tunables,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
)
from ceph_tpu_torch.crush.scalar import ScalarMapper  # noqa: F401


def bench_map(n_osds: int = 10_000, n_pgs: int = 1_000_000, iters: int = 3,
              device=None):
    """Whole-map placement throughput (mappings/s): the median wall time
    of ``iters`` ``do_rule_batch`` calls over ``n_pgs`` PGs, each
    bracketed by ``torch.cuda.synchronize()`` on a CUDA device."""
    import statistics
    import time

    import numpy as np
    import torch

    from ceph_tpu_torch.crush.mapper import TensorMapper
    from ceph_tpu_torch.crush.types import build_three_level

    # 10k OSDs as deployed: root -> 39 racks -> 16 hosts -> 16 osds
    n_racks = max(1, n_osds // 256)
    cmap, rule = build_three_level(
        n_racks=n_racks, hosts_per_rack=16, osds_per_host=16, numrep=3
    )
    mapper = TensorMapper(cmap, device=device)
    xs = np.arange(n_pgs, dtype=np.uint32)
    weights = np.full(cmap.max_devices, 0x10000, dtype=np.uint32)
    sync = (torch.cuda.synchronize if mapper.device.type == "cuda"
            else lambda: None)
    mapper.do_rule_batch(rule, xs, result_max=3, weights=weights)
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        mapper.do_rule_batch(rule, xs, result_max=3, weights=weights)
        sync()
        times.append(time.perf_counter() - t0)
    return n_pgs / statistics.median(times)
