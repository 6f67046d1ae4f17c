"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``ceph_tpu_torch/csrc/`` is one kernel library
with a plain C interface.  At first use each is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``ceph_tpu_torch/_build/<hash>/`` and loaded
with ``ctypes``.  The directory name is a hash of every source and of the
flags, so an edited source builds anew and an unchanged one is reused.
All sources compile in parallel, one ``nvcc`` process each.  A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source (ptxas register and shared-memory report)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    srcs = sorted(f for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, f) for f in srcs]


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source that is not built yet, in parallel,
    and load each library.  Returns {source stem: CDLL}."""
    with _lock:
        if _libs:
            return _libs
        out_dir = _build_dir()
        os.makedirs(out_dir, exist_ok=True)
        nvcc = None
        procs = {}
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            stem = os.path.splitext(os.path.basename(src))[0]
            lib = os.path.join(out_dir, f"lib{stem}.so")
            if os.path.exists(lib):
                continue
            nvcc = nvcc or _nvcc()
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
            procs[stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        failed = []
        for stem, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            build_logs[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        for src in _sources():
            if src.endswith(".cu"):
                stem = os.path.splitext(os.path.basename(src))[0]
                _libs[stem] = ctypes.CDLL(
                    os.path.join(out_dir, f"lib{stem}.so"))
        return _libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]
