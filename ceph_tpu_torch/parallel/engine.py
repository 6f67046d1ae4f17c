"""MeshECEngine: the sharded EC data plane over a device mesh.

Counterpart of ``ceph_tpu/parallel/engine.py``: arbitrary erasure
patterns, delta-based RMW and mesh-sharded CRUSH placement, in one
controller process over the mesh's devices.  Stripes shard over the
``data`` axis and EC chunk rows over the ``shard`` axis, the way the
reference spreads shards across OSDs (src/osd/ECBackend.cc
handle_sub_write/handle_sub_read:921,986).  The decode's gather of the
survivors across the shard columns, XLA's all-gather in the JAX package,
is a device-to-device copy here (MOSDECSubOpRead's fan-out).

Parity is the byte-layout GF(2) matmul ``ops/gf8.encode_batch`` (a
float32 ``torch.matmul`` on unpacked bits), as the JAX engine computes it
with XLA's dot: the mesh path launches no hand-written kernel.  Each
distinct device keeps one copy of every bit-matrix it uses.

The engine has the same encode_batch/decode_batch contract as the
single-device codec engines (ec/codec.py), so a pool's codec can route
through it unchanged (``MeshCodecAdapter``, the ``osd_ec_mesh`` seam).
Inputs may be numpy or tensors on any device; outputs are gathered onto
the mesh's first device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.parallel.mesh import (Mesh, chunk_columns, make_mesh,
                                          mesh_devices, stripe_slices)

# a placed batch: one tensor per grid slot, rows of the grid outermost
Placed = List[List[torch.Tensor]]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))


class MeshECEngine:
    """Sharded GF(2^8) RS engine with the codec batch contract.

    Works for any codec whose engine exposes a GF(2^8) ``coding`` matrix
    (jerasure reed_sol, ISA).  ``mesh`` None builds the default mesh over
    the visible CUDA devices."""

    def __init__(self, mesh: Optional[Mesh], k: int, m: int,
                 coding: np.ndarray):
        self.mesh = make_mesh() if mesh is None else mesh
        self.k, self.m = k, m
        self.n = k + m
        self.coding = np.asarray(coding, dtype=np.uint8)
        self.generator = matrices.generator_matrix(self.coding)
        self._host_bits: Dict[Tuple, np.ndarray] = {
            ("enc",): gf8.expand_bitmatrix(self.coding)}
        self._dev_bits: Dict[Tuple, torch.Tensor] = {}

    # -- layout ------------------------------------------------------------

    def _bits(self, key: Tuple, dev: torch.device) -> torch.Tensor:
        """The bit-matrix ``key`` as float32 on ``dev``, uploaded once per
        distinct device."""
        t = self._dev_bits.get((key, dev))
        if t is None:
            t = torch.from_numpy(self._host_bits[key]).to(
                dev, torch.float32)
            self._dev_bits[(key, dev)] = t
        return t

    def place_stripes(self, x) -> Placed:
        """(B, c, S) -> each slot's stripes on its device."""
        x = _as_tensor(x)
        sl = stripe_slices(self.mesh, x.shape[0])
        return [[x[sl[i][j]].to(dev) for j, dev in enumerate(row)]
                for i, row in enumerate(self.mesh.devices)]

    def place_chunks(self, x) -> Placed:
        """(B, n, S) -> slot (i, j) holds block i's chunk rows of column
        j."""
        x = _as_tensor(x)
        d = self.mesh.shape["data"]
        if x.shape[0] % d:
            raise ValueError(
                f"batch {x.shape[0]} must divide the data axis ({d})")
        block = x.shape[0] // d
        cols = chunk_columns(self.mesh, x.shape[1])
        return [[x[i * block:(i + 1) * block, c.start:c.stop].to(dev)
                 for c, dev in zip(cols, row)]
                for i, row in enumerate(self.mesh.devices)]

    def _local(self, i: int, sl: slice, block: int) -> slice:
        return slice(sl.start - i * block, sl.stop - i * block)

    def chunk_layout(self, placed: Placed) -> Placed:
        """Stripe-sharded full chunks (b_ij, n, S) -> the chunk layout:
        every slot of row i sends column j's rows to slot (i, j)."""
        cols = chunk_columns(self.mesh, self.n)
        return [[torch.cat([p[:, c.start:c.stop].to(dev) for p in prow])
                 for c, dev in zip(cols, row)]
                for prow, row in zip(placed, self.mesh.devices)]

    def _take(self, crow: List[torch.Tensor], rows: Sequence[int],
              stripes: slice, cols: slice, dev: torch.device):
        """Chunk rows ``rows`` (block-local ``stripes``, byte ``cols``) of
        one grid row's chunk pieces, copied to ``dev`` as one
        (b, len(rows), width) tensor: one copy per run of rows that one
        column holds."""
        per = self.n // self.mesh.shape["shard"]
        parts, t = [], 0
        while t < len(rows):
            c, u = rows[t] // per, t
            while u + 1 < len(rows) and rows[u + 1] == rows[u] + 1 \
                    and rows[u + 1] // per == c:
                u += 1
            lo = rows[t] - c * per
            parts.append(crow[c][stripes, lo:lo + u - t + 1, cols].to(dev))
            t = u + 1
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def gather_rows(self, chunks: Placed, rows: Sequence[int]) -> Placed:
        """Chunk layout -> the stripe layout of chunk rows ``rows``: slot
        (i, j) gathers its stripes' rows from the columns that hold them
        (the survivor gather of a decode)."""
        block = chunks[0][0].shape[0]
        sl = stripe_slices(self.mesh, block * self.mesh.shape["data"])
        return [[self._take(crow, rows, self._local(i, sl[i][j], block),
                            slice(None), dev)
                 for j, dev in enumerate(row)]
                for i, (crow, row) in enumerate(zip(chunks,
                                                    self.mesh.devices))]

    def gather_stripes(self, placed: Placed) -> torch.Tensor:
        first = self.mesh.first
        return torch.cat([p.to(first) for row in placed for p in row])

    def gather_chunks(self, chunks: Placed) -> torch.Tensor:
        first = self.mesh.first
        return torch.cat([torch.cat([p.to(first) for p in row], dim=1)
                          for row in chunks])

    def _apply(self, key: Tuple, placed: Placed) -> Placed:
        return [[gf8.encode_batch(self._bits(key, p.device), p)
                 for p in row] for row in placed]

    # -- encode ------------------------------------------------------------

    def encode_placed(self, placed: Placed) -> Placed:
        return self._apply(("enc",), placed)

    def encode_batch(self, data) -> torch.Tensor:
        """(B, k, S) -> (B, m, S) parity, stripes sharded over 'data'."""
        return self.gather_stripes(
            self.encode_placed(self.place_stripes(data)))

    # -- decode (arbitrary erasure pattern) --------------------------------

    def _decode_rows(self, src: Tuple[int, ...],
                     want: Tuple[int, ...]) -> np.ndarray:
        """GF coefficient rows mapping survivor rows ``src`` -> rows
        ``want`` (submatrix inversion, ec/codec.py decode_matrix)."""
        inv = gf8.gf_invert_matrix(self.generator[list(src)])
        rows = [inv[w] if w < self.k else
                gf8.gf_matmul_ref(self.coding[w - self.k][None, :], inv)[0]
                for w in want]
        return np.stack(rows).astype(np.uint8)

    def decode_placed(self, src: Tuple[int, ...], want: Tuple[int, ...],
                      chunks: Placed) -> Placed:
        key = ("dec", src, want)
        if key not in self._host_bits:
            self._host_bits[key] = gf8.expand_bitmatrix(
                self._decode_rows(src, want))
        return self._apply(key, self.gather_rows(chunks, src))

    def decode_batch(self, erasures: Tuple[int, ...], chunks,
                     want: Tuple[int, ...] = None) -> torch.Tensor:
        """codec contract: chunks (B, k+m, S); rebuild ``want`` (default
        = erasures) from k survivors gathered across the 'shard' axis."""
        erasures = tuple(erasures)
        want = erasures if want is None else tuple(want)
        avail = tuple(i for i in range(self.n) if i not in erasures)
        return self.gather_stripes(self.decode_placed(
            avail[: self.k], want, self.place_chunks(chunks)))

    # -- RMW (delta parity update) -----------------------------------------

    def rmw_batch(self, chunks, update, col_start: int) -> torch.Tensor:
        """Partial-stripe overwrite: replace data columns
        [col_start, col_start+width) with ``update`` (B, k, width) and
        delta-update the parity.  The code is linear, so parity' =
        parity ^ encode(old ^ new) over the touched columns: a slot of
        parity rows gathers only those columns of the data rows
        (ECBackend's sub-range reads, ECBackend.cc:1785)."""
        update = _as_tensor(update)
        width = update.shape[2]
        placed = self.place_chunks(chunks)
        block = placed[0][0].shape[0]
        cols = chunk_columns(self.mesh, self.n)
        touched = slice(col_start, col_start + width)
        data_rows = list(range(self.k))
        out: Placed = []
        for i, (crow, row) in enumerate(zip(placed, self.mesh.devices)):
            upd = update[i * block:(i + 1) * block]
            orow = []
            for c, piece, dev in zip(cols, crow, row):
                new = piece.clone()
                drows = [r for r in c if r < self.k]
                prows = tuple(r - self.k for r in c if r >= self.k)
                u = upd.to(dev)
                if drows:
                    lo = drows[0] - c.start
                    new[:, lo:lo + len(drows), touched] = \
                        u[:, drows[0]:drows[-1] + 1]
                if prows:
                    key = ("rmw", prows)
                    if key not in self._host_bits:
                        self._host_bits[key] = gf8.expand_bitmatrix(
                            self.coding[list(prows)])
                    old = self._take(crow, data_rows, slice(None), touched,
                                     dev)
                    pdelta = gf8.encode_batch(self._bits(key, dev), old ^ u)
                    lo = prows[0] + self.k - c.start
                    new[:, lo:lo + len(prows), touched] ^= pdelta
                orow.append(new)
            out.append(orow)
        return self.gather_chunks(out)


class MeshCodecAdapter:
    """Wraps a single-device EC codec so the pool's batch paths
    (ec/stripe.py encode_stripes/decode_stripes) run on the mesh engine
    instead, the osd_ec_mesh seam.  Every other codec method (profiles,
    chunk math, scalar encode/decode) delegates unchanged.

    Batch sizes are padded up to the mesh's data axis with zero stripes
    (zero stripes encode to zero parity: the code is linear, so padding
    never changes real rows)."""

    def __init__(self, codec, mesh: Mesh):
        self._codec = codec
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        self._k, self._n = k, n
        self._mesh_engine = MeshECEngine(
            mesh, k, n - k, np.asarray(codec.engine.coding))
        self._data_axis = mesh.shape["data"]

    # the bit-planar entry points are single-device (the mesh engine
    # shards BYTE batches); hiding them steers ec/stripe.py's planar
    # routing back to encode_batch/decode_batch so mesh pools keep the
    # multi-device data plane
    _SINGLE_DEVICE_ONLY = frozenset(
        {"planar_supported", "to_planar", "encode_planar", "decode_planar"})

    def __getattr__(self, name):
        if name in self._SINGLE_DEVICE_ONLY:
            raise AttributeError(name)
        return getattr(self._codec, name)

    def _pad(self, arr):
        arr = _as_tensor(arr)
        b = arr.shape[0]
        pad = (-b) % self._data_axis
        if pad:
            arr = torch.cat([arr, arr.new_zeros((pad,) + arr.shape[1:])])
        return arr, b

    def encode_batch(self, data) -> torch.Tensor:
        data, b = self._pad(data)
        return self._mesh_engine.encode_batch(data)[:b]

    def decode_batch(self, erasures, chunks, want=None) -> torch.Tensor:
        chunks, b = self._pad(chunks)
        return self._mesh_engine.decode_batch(erasures, chunks, want)[:b]


def mesh_for_codec(codec, n_devices: int = 0,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Mesh whose shard axis divides this codec's k+m (falling back to
    pure data parallelism when no shard split fits), over the first
    ``n_devices`` (0: all) of ``devices`` (default: the visible CUDA
    devices)."""
    devs = mesh_devices(devices)
    n_dev = n_devices or len(devs)
    n = codec.get_chunk_count()
    shard_axis = 1
    for s in (4, 3, 2):
        if n_dev % s == 0 and n % s == 0:
            shard_axis = s
            break
    return make_mesh(n_dev, shard_axis=shard_axis, devices=devs)


def wrap_codec_for_mesh(codec, n_devices: int = 0,
                        devices: Optional[Sequence] = None):
    """Return a mesh-routed adapter for codecs with a GF(2^8) coding
    matrix, or the codec unchanged when it cannot ride the mesh engine
    (the wide-w and liberation families keep their single-device path).
    The rule is the reference's: jerasure's cauchy codecs have a coding
    matrix and are wrapped too, though the engine does not lay out their
    packets, so a wrapped cauchy codec gives wrong parity (ROADMAP §C)."""
    eng = getattr(codec, "engine", None)
    coding = getattr(eng, "coding", None)
    if coding is None or getattr(eng, "w", 8) != 8:
        return codec
    return MeshCodecAdapter(codec, mesh_for_codec(codec, n_devices, devices))


def _run_slots(mapper, slots: List[int], xs: np.ndarray, per: int,
               ruleno: int, result_max: int, weights: np.ndarray):
    dev = mapper.device
    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
        return [(s, mapper.do_rule_batch(
            ruleno, xs[s * per:(s + 1) * per], result_max, weights))
            for s in slots]


def crush_batch_sharded(mesh: Mesh, mapper, ruleno: int, xs,
                        result_max: int, weights):
    """Whole-map CRUSH placement sharded over every mesh slot: the per-x
    rule VM is embarrassingly parallel (reference crush_do_rule is a
    per-x scalar loop, src/crush/mapper.c:883).

    ``xs`` is padded to the flattened mesh and split evenly over its
    slots.  Each distinct device runs its slots' shards on its own
    mapper, ``mapper`` itself on its own device and a copy elsewhere
    (``TensorMapper`` keeps per-call state, so one mapper serves one
    thread), issued from its own host thread so the cards do
    not wait on each other's host syncs.  Returns ``(result, lens)`` on
    the mesh's first device, the padding cut."""
    from ceph_tpu_torch.crush.mapper import TensorMapper

    if isinstance(xs, torch.Tensor):
        xs = xs.cpu().numpy()
    xs = np.asarray(xs, dtype=np.uint32)
    weights = weights.cpu().numpy() if isinstance(weights, torch.Tensor) \
        else weights
    weights = np.asarray(weights, dtype=np.uint32)
    n_slots = mesh.devices.size
    pad = (-len(xs)) % n_slots
    if pad:
        xs = np.concatenate([xs, np.zeros(pad, dtype=np.uint32)])
    # one mapper per device: the mapper itself on its own device, a copy
    # on every other, kept ON the mapper so the copies die with the map
    # epoch and a reused id() can never serve a stale map
    copies = getattr(mapper, "_sharded_cache", None)
    if copies is None:
        own = mesh_devices([mapper.device])[0]
        copies = mapper._sharded_cache = {own: mapper}
    for d in mesh.distinct():
        if d not in copies:
            copies[d] = TensorMapper(mapper.map, chunk=mapper.chunk,
                                     device=d)
    per = len(xs) // n_slots
    groups: Dict[torch.device, List[int]] = {}
    for s, d in enumerate(mesh.devices.flat):
        groups.setdefault(d, []).append(s)
    jobs = [(copies[d], slots, xs, per, ruleno, result_max, weights)
            for d, slots in groups.items()]
    if len(jobs) == 1:
        done = _run_slots(*jobs[0])
    else:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            done = [r for part in pool.map(lambda j: _run_slots(*j), jobs)
                    for r in part]
    done.sort(key=lambda r: r[0])
    first = mesh.first
    res = torch.cat([r.to(first) for _, (r, _) in done])
    lens = torch.cat([ln.to(first) for _, (_, ln) in done])
    if pad:
        res, lens = res[:-pad], lens[:-pad]
    return res, lens
