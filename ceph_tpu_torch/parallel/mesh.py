"""Device meshes for the sharded erasure-code data plane.

Counterpart of ``ceph_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh``: one controller process over a ``(data, shard)``
grid of devices.  The port does the same in one Python process: a
``Mesh`` is a numpy grid of ``torch.device``, each piece of a sharded
batch is a tensor on its grid slot's device, and where XLA inserts
collectives the port copies between devices.

- ``data``: the stripe batch (independent stripes, Ceph's PG/stripe
  parallelism).  Stripe block ``i`` lives on row ``i`` of the grid.
- ``shard``: the chunk axis (Ceph's per-OSD EC shards).  Chunk rows
  ``[j*n/s, (j+1)*n/s)`` live on column ``j``; decode gathers the k
  survivors across the columns.

A grid may name one device more than once: eight slots of ``"cpu"`` give
the CPU tests a ``(2, 4)`` mesh, and eight of ``cuda:0`` a one-card
machine; a copy between two slots of one device is then a no-op.  Unlike
the JAX package, ``make_mesh`` never falls back to CPU devices: asked for
more CUDA devices than exist, it raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.utils.device import resolve_device


class Mesh:
    """A ``(data, shard)`` grid of torch devices (``jax.sharding.Mesh``'s
    ``devices``, ``shape`` and ``axis_names``)."""

    axis_names = ("data", "shard")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh grid must be 2-D, got {devices.shape}")
        self.devices = devices
        self.shape = {"data": devices.shape[0], "shard": devices.shape[1]}
        self._key = (devices.shape, tuple(str(d) for d in devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self._key[1])})"

    @property
    def first(self) -> torch.device:
        """Where outputs are gathered: the grid's slot (0, 0)."""
        return self.devices[0, 0]

    def distinct(self) -> List[torch.device]:
        """The grid's devices, each once, in slot order."""
        return list(dict.fromkeys(self.devices.flat))


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"{dev} asked for, {torch.cuda.device_count()} CUDA "
                "devices visible")
    return dev


def mesh_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The named devices (repeats allowed), or every visible CUDA device.
    Raises without CUDA unless the caller names other devices."""
    if devices is not None:
        return [_as_device(d) for d in devices]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              shard_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'shard') mesh over the first ``n_devices`` of
    ``devices`` (default: the visible CUDA devices)."""
    devs = mesh_devices(devices)
    if n_devices is None:
        n_devices = len(devs)
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devs[:n_devices]
    if shard_axis is None:
        shard_axis = 4 if n_devices % 4 == 0 else (
            2 if n_devices % 2 == 0 else 1)
    return Mesh(grid.reshape(n_devices // shard_axis, shard_axis))


def stripe_slices(mesh: Mesh, batch: int) -> List[List[slice]]:
    """The stripes of each grid slot in a batch sharded over ``data``:
    block ``i`` of ``batch / data`` stripes on row ``i``, split as evenly
    as it goes over the row's slots for the compute."""
    d, s = mesh.devices.shape
    if batch % d:
        raise ValueError(
            f"batch {batch} must divide the data axis ({d})")
    block = batch // d
    bounds = [block * j // s for j in range(s + 1)]
    return [[slice(i * block + bounds[j], i * block + bounds[j + 1])
             for j in range(s)] for i in range(d)]


def chunk_columns(mesh: Mesh, n: int) -> List[range]:
    """The chunk rows of each grid column in a batch sharded over
    ``shard``."""
    s = mesh.shape["shard"]
    if n % s:
        raise ValueError(f"k+m = {n} must divide the shard axis ({s})")
    per = n // s
    return [range(j * per, (j + 1) * per) for j in range(s)]


def distributed_ec_step(mesh: Mesh, k: int, m: int, batch: int, chunk: int):
    """The full EC pipeline step over ``mesh``, and its example input.

    The step encodes a stripe batch, lays the chunks out over the shard
    axis, loses shard 0, rebuilds it from rows 1..k (gathered across the
    shard columns) and returns ``(mismatches, chunks)``: the count of
    rebuilt bytes that differ, and the (batch, k+m, chunk) chunks, both
    gathered onto the mesh's first device.  The example is a seeded
    (batch, k, chunk) uint8 batch already placed on the mesh.

    Shapes must divide the mesh: batch % data == 0 and (k + m) % shard
    == 0."""
    from ceph_tpu_torch.parallel.engine import MeshECEngine

    stripe_slices(mesh, batch)          # each raises where the shapes
    chunk_columns(mesh, k + m)          # do not divide the mesh
    eng = MeshECEngine(mesh, k, m, matrices.isa_rs_matrix(k, m))
    src = tuple(range(1, k + 1))

    def step(placed):
        parity = eng.encode_placed(placed)
        chunks = eng.chunk_layout(
            [[torch.cat([d, p], dim=1) for d, p in zip(drow, prow)]
             for drow, prow in zip(placed, parity)])
        recon = eng.decode_placed(src, (0,), chunks)
        lost = eng.gather_rows(chunks, (0,))
        first = mesh.first
        mismatches = torch.zeros((), dtype=torch.int64, device=first)
        for rrow, lrow in zip(recon, lost):
            for r, lo in zip(rrow, lrow):
                mismatches += (r != lo).sum().to(first)
        return mismatches, eng.gather_chunks(chunks)

    example = np.random.default_rng(0).integers(
        0, 256, (batch, k, chunk), dtype=np.uint8)
    return step, (eng.place_stripes(example),)
