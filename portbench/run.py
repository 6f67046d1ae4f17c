#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout that holds ``ceph_tpu_torch``.  It needs
a CUDA card: without one (or with fewer than the cell asks for) it exits
with code 2 and prints no result.  The last line of standard output is
the run's JSON result; the numbers that decided ``correct`` are the last
lines of standard error.  See ``portbench/README.md``.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixed_caches() -> None:
    """Every kernel cache a library may keep goes to a fixed directory
    inside the checkout, so the second run of a cell finds it built."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    _fixed_caches()
    # import this folder as the package ``portbench``, never its files as
    # top-level modules
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(argv, t0=T0, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
