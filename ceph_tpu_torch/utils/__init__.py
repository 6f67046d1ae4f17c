"""Common runtime: device choice, typed config schema, perf counters,
admin socket (counterpart of ``ceph_tpu/utils/``)."""

from ceph_tpu_torch.utils.admin_socket import AdminSocket  # noqa: F401
from ceph_tpu_torch.utils.backoff import ExpBackoff  # noqa: F401
from ceph_tpu_torch.utils.config import Config, Option  # noqa: F401
from ceph_tpu_torch.utils.lockdep import (  # noqa: F401
    DepLock,
    LockCycleError,
    LockDep,
)
from ceph_tpu_torch.utils.perf import (  # noqa: F401
    KERNELS,
    PerfCounters,
    PerfCountersCollection,
    PerfHistogram,
)
