"""EC stripe tessellation and the coalesced encode/decode of an OSD tick.

Counterpart of ``ceph_tpu/ec/stripe.py``.
``StripeInfo`` mirrors ECUtil::stripe_info_t (reference
src/osd/ECUtil.h:31-84): an EC object is a sequence of stripes, each
stripe_width = k * stripe_unit logical bytes, cut into k data chunks of
stripe_unit bytes; shard s is the concatenation of that shard's chunk from
every stripe.  The stripe axis is the batch axis, so a tick's ops encode
or decode in one pass over the codec's device.

Two families of entry points, as in the reference:

- byte at rest (``encode_stripes``/``decode_stripes``/``reencode_stripes``
  and their coalesced ``*_multi`` twins, what the OSD batcher runs for a
  pool whose shards are stored as bytes: every packet codec, and any
  pool with planar at-rest storage off): shard rows in and out, the
  stripe batch riding the codec's planar layout on the device (bitpack
  planes and kernel B1 for the matrix codecs, packet rows and kernel B2
  for the packet codecs);
- planar at rest (``encode_planes_multi``/``decode_planes_multi``/
  ``reencode_planes_multi``): shards stored as packed bit-planes of a w=8
  matrix code (ISA, jerasure reed_sol_*, SHEC).  Patterns without a
  survivor-submatrix solution, which SHEC's non-MDS plans reach, relayout
  to the byte entry points.

Engine choice follows the codec's device: on the card the GF(2) matmuls
launch the CUDA kernels, on the CPU they run their plain versions.  The
reference's CPU-backend host GF engine (``_host_engine_ok`` and its
branches) has no counterpart: on a CPU JAX backend it does not check for
``packetsize`` and computes cauchy parity bytewise, which the port must
not copy.  PyTorch runs eagerly, so the reference's power-of-two batch
bucketing (a bound on XLA compiles) has no counterpart either.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import planar_store as pstore
from ceph_tpu_torch.ec.codec import _to_device
from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.ops.crc32c import crc32c_planar_rows, crc32c_rows
from ceph_tpu_torch.ops.profiling import record_planar_at_rest
from ceph_tpu_torch.utils.perf import KERNELS


class StripeInfo:
    """stripe_info_t analog: all offset arithmetic for a (k, stripe_unit)
    layout (reference ECUtil.h:31-84)."""

    def __init__(self, k: int, stripe_unit: int):
        if stripe_unit <= 0 or k <= 0:
            raise ValueError("k and stripe_unit must be positive")
        self.k = k
        self.chunk_size = stripe_unit
        self.stripe_width = k * stripe_unit

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) // self.stripe_width) \
            * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset - rem + self.stripe_width if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> Tuple[int, int]:
        """(stripe-aligned offset, stripe-aligned length) covering the
        range (reference offset_len_to_stripe_bounds)."""
        off = self.logical_to_prev_stripe_offset(offset)
        ln = self.logical_to_next_stripe_offset((offset - off) + length)
        return off, ln

    def object_stripes(self, logical_size: int) -> int:
        return (logical_size + self.stripe_width - 1) // self.stripe_width \
            if logical_size else 0

    def shard_size(self, logical_size: int) -> int:
        return self.object_stripes(logical_size) * self.chunk_size


def _planar_ok(codec, unit: int) -> bool:
    """Does this codec carry the bit-planar layout contract for this
    stripe unit?"""
    sup = getattr(codec, "planar_supported", None)
    return bool(sup and sup(unit))


def _pack_batch(sinfo: StripeInfo, datas, counts) -> Tuple[np.ndarray, int]:
    """The tick's ops' bytes as one zero-padded (total, k, unit) stripe
    batch, and the padding byte count."""
    batch = np.zeros((sum(counts), sinfo.k, sinfo.chunk_size),
                     dtype=np.uint8)
    pad = 0
    ofs = 0
    for d, ns in zip(datas, counts):
        if ns == 0:
            continue
        flat = batch[ofs:ofs + ns].reshape(-1)
        flat[: len(d)] = np.frombuffer(d, dtype=np.uint8)
        pad += ns * sinfo.stripe_width - len(d)
        ofs += ns
    return batch, pad


def _encode_parity_batch(codec, batch: np.ndarray) -> np.ndarray:
    """(B, k, unit) -> (B, m, unit) parity, planar when the codec can."""
    if _planar_ok(codec, batch.shape[2]):
        pb = codec.to_planar(batch)
        return codec.encode_planar(pb).to_batch().cpu().numpy()
    return codec.encode_batch(batch).cpu().numpy()


def encode_stripes(codec, sinfo: StripeInfo, data: bytes) -> np.ndarray:
    """Encode a stripe-aligned-or-padded byte range in one device pass.

    Returns (k+m, nstripes * unit) uint8: shard rows, chunk-per-stripe
    concatenated.  ``data`` is zero-padded to the next stripe boundary."""
    n = codec.get_chunk_count()
    nstripes = sinfo.object_stripes(len(data))
    if nstripes == 0:
        return np.zeros((n, 0), dtype=np.uint8)
    batch, pad = _pack_batch(sinfo, [data], [nstripes])
    KERNELS.inc("ec_stripe_pad_bytes", pad)
    parity = _encode_parity_batch(codec, batch)
    full = np.concatenate([batch, parity], axis=1)          # (ns, n, unit)
    return full.transpose(1, 0, 2).reshape(n, nstripes * sinfo.chunk_size)


def encode_stripes_multi(codec, sinfo: StripeInfo, datas, want_crcs=None):
    """Coalesced encode: N ops' stripe ranges in ONE device round trip.

    Every op's stripe batch concatenates along the batch axis, the tick
    pays one planar conversion + one encode, and the shard rows of ops
    whose ``want_crcs`` flag is set checksum in one crc32c batch per shard
    length.  Bit-exact with per-op ``encode_stripes``: the code is
    stripe-local.  Returns ``[(shards, crcs), ...]`` aligned with
    ``datas``: the per-op (k+m, nstripes*unit) uint8 matrix and the
    per-shard ``ceph_crc32c(~0, row)`` list (or None)."""
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    if want_crcs is None:
        want_crcs = [False] * len(datas)
    counts = [sinfo.object_stripes(len(d)) for d in datas]
    total = sum(counts)
    out = [None] * len(datas)
    if total == 0:
        for i in range(len(datas)):
            shards = np.zeros((n, 0), dtype=np.uint8)
            out[i] = (shards, crc32c_rows(shards) if want_crcs[i] else None)
        return out
    KERNELS.inc("ec_coalesced_ticks")
    KERNELS.inc("ec_coalesced_ops", len(datas))
    batch, pad = _pack_batch(sinfo, datas, counts)
    KERNELS.inc("ec_stripe_pad_bytes", pad)
    parity = _encode_parity_batch(codec, batch)
    crc_rows = []
    ofs = 0
    for i, ns in enumerate(counts):
        full = np.concatenate(
            [batch[ofs:ofs + ns], parity[ofs:ofs + ns]], axis=1)
        shards = full.transpose(1, 0, 2).reshape(n, ns * unit)
        ofs += ns
        out[i] = (shards, None)
        if want_crcs[i]:
            crc_rows.append((i, shards))
    by_len: Dict[int, List] = {}
    for i, shards in crc_rows:
        by_len.setdefault(shards.shape[1], []).append((i, shards))
    for group in by_len.values():
        stacked = np.concatenate([s for _i, s in group], axis=0)
        crcs = crc32c_rows(stacked, device=codec.device)
        for gi, (i, _shards) in enumerate(group):
            out[i] = (out[i][0], crcs[gi * n:(gi + 1) * n])
    return out


def _assemble_logical(data_rows: Dict[int, np.ndarray], k: int,
                      nstripes: int, unit: int,
                      logical_size: int) -> bytes:
    """Interleave k data shard rows back into logical bytes."""
    stacked = np.stack([data_rows[s].reshape(nstripes, unit)
                        for s in range(k)], axis=1)
    return stacked.reshape(nstripes * k * unit)[:logical_size].tobytes()


def assemble_data_stripes(sinfo: StripeInfo, shards, logical_size: int) -> bytes:
    """The no-erasure decode: every data shard present, so the logical
    bytes are a pure host interleave (zero device work)."""
    k = sinfo.k
    unit = sinfo.chunk_size
    nstripes = sinfo.object_stripes(logical_size)
    if nstripes == 0:
        return b""
    shard_len = nstripes * unit
    rows: Dict[int, np.ndarray] = {}
    for s in range(k):
        arr = np.asarray(shards[s], dtype=np.uint8)
        if arr.shape[0] != shard_len:
            raise ValueError(
                f"shard {s}: {arr.shape[0]} bytes, want {shard_len}")
        rows[s] = arr
    return _assemble_logical(rows, k, nstripes, unit, logical_size)


def _shard_rows(shards: Mapping, shard_len: int) -> Dict[int, np.ndarray]:
    """Shard map -> {shard id: (shard_len,) uint8 row}, lengths checked."""
    rows: Dict[int, np.ndarray] = {}
    for s in sorted(shards):
        arr = np.asarray(shards[s], dtype=np.uint8)
        if arr.shape[0] != shard_len:
            raise ValueError(
                f"shard {s}: {arr.shape[0]} bytes, want {shard_len}")
        rows[s] = arr
    return rows


def _stripe_batch(items, n: int, unit: int) -> np.ndarray:
    """``[(shard rows, nstripes), ...]`` -> one zero-filled (total, n,
    unit) stripe batch, the items' stripes concatenated in order."""
    total = sum(ns for _rows, ns in items)
    full = np.zeros((total, n, unit), dtype=np.uint8)
    ofs = 0
    for rows, ns in items:
        for s, arr in rows.items():
            full[ofs:ofs + ns, s, :] = arr.reshape(ns, unit)
        ofs += ns
    return full


def _decode_batch(codec, full: np.ndarray, erasures: Tuple[int, ...],
                  want: Tuple[int, ...]) -> np.ndarray:
    """(B, n, unit) batch with ``erasures`` absent -> (B, len(want), unit)
    rebuilt chunks, planar when the codec can."""
    if _planar_ok(codec, full.shape[2]):
        pb = codec.to_planar(full)
        return codec.decode_planar(erasures, pb, want=want) \
            .to_batch().cpu().numpy()
    return codec.decode_batch(erasures, full, want=want).cpu().numpy()


def _reencode_batch(codec, full: np.ndarray, erasures: Tuple[int, ...],
                    missing: Tuple[int, ...]) -> np.ndarray:
    """(B, n, unit) batch -> all n chunks, without leaving the planar
    domain between decode and re-encode: one conversion in, the
    ``missing`` data chunks rebuilt, parity re-derived from the data, one
    conversion out."""
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    pb = codec.to_planar(full)
    if missing:
        dec = codec.decode_planar(erasures, pb, want=missing)
        order = tuple(n + missing.index(j) if j in missing else j
                      for j in range(k))
        data_pb = pb.concat(dec).select(order)
    else:
        data_pb = pb.select(tuple(range(k)))
    parity_pb = codec.encode_planar(data_pb)
    return data_pb.concat(parity_pb).to_batch().cpu().numpy()


def decode_stripes(codec, sinfo: StripeInfo, shards: Mapping,
                   logical_size: int) -> bytes:
    """Rebuild the logical bytes from >= k shard rows in one device pass.

    ``shards`` maps shard id -> (nstripes * unit) bytes.  Missing data
    shards are rebuilt batched, one erasure pattern for the whole object
    (reference ECBackend reply aggregation + ECUtil::decode)."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    nstripes = sinfo.object_stripes(logical_size)
    if nstripes == 0:
        return b""
    rows = _shard_rows(shards, nstripes * unit)
    data_rows = {s: a for s, a in rows.items() if s < k}
    want = tuple(s for s in range(k) if s not in rows)
    if want:
        if len(rows) < k:
            raise ValueError(f"only {len(rows)} of {k} shards")
        # erasures = every absent shard (absent parity is never a decode
        # source); want = only the missing DATA shards, since this returns
        # logical bytes
        erasures = tuple(s for s in range(n) if s not in rows)
        recovered = _decode_batch(
            codec, _stripe_batch([(rows, nstripes)], n, unit), erasures, want)
        for idx, e in enumerate(want):
            data_rows[e] = recovered[:, idx, :].reshape(-1)
    return _assemble_logical(data_rows, k, nstripes, unit, logical_size)


def reencode_stripes(codec, sinfo: StripeInfo, shards: Mapping,
                     logical_size: int) -> np.ndarray:
    """Recovery: rebuild ALL shard rows from >= k shard rows, decode and
    re-encode in the planar domain (one conversion each way).  Returns
    (k+m, nstripes * unit) uint8."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    nstripes = sinfo.object_stripes(logical_size)
    if nstripes == 0:
        return np.zeros((n, 0), dtype=np.uint8)
    if len(shards) < k:
        raise ValueError(f"only {len(shards)} of {k} shards")
    if not _planar_ok(codec, unit):
        data = decode_stripes(codec, sinfo, shards, logical_size)
        return encode_stripes(codec, sinfo, data)
    rows = _shard_rows(shards, nstripes * unit)
    erasures = tuple(s for s in range(n) if s not in rows)
    missing = tuple(s for s in range(k) if s not in rows)
    out = _reencode_batch(codec, _stripe_batch([(rows, nstripes)], n, unit),
                          erasures, missing)
    return out.transpose(1, 0, 2).reshape(n, nstripes * unit)


def decode_stripes_multi(codec, sinfo: StripeInfo, reqs):
    """Coalesced decode: N read gathers in one device pass per distinct
    erasure pattern, the decode twin of ``encode_stripes_multi``.

    ``reqs`` is a sequence of ``(shards, logical_size)`` pairs shaped like
    ``decode_stripes`` arguments; returns the logical byte strings,
    aligned with ``reqs``.  Ops with every data shard present never touch
    the device (a host interleave); the others group by their (erasures,
    want) pattern and each group pays one layout conversion and one
    decode for its concatenated stripe batch.  Bit-exact with per-op
    ``decode_stripes``: the code is stripe-local."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    out: List = [None] * len(reqs)
    groups: Dict[Tuple, List] = {}
    for i, (shards, logical_size) in enumerate(reqs):
        nstripes = sinfo.object_stripes(logical_size)
        if nstripes == 0:
            out[i] = b""
            continue
        rows = _shard_rows(shards, nstripes * unit)
        want = tuple(s for s in range(k) if s not in rows)
        if not want:
            out[i] = _assemble_logical(rows, k, nstripes, unit, logical_size)
            continue
        if len(rows) < k:
            raise ValueError(f"only {len(rows)} of {k} shards")
        erasures = tuple(s for s in range(n) if s not in rows)
        groups.setdefault((erasures, want), []).append(
            (i, rows, nstripes, logical_size))
    if not groups:
        return out
    KERNELS.inc("ec_coalesced_read_ticks")
    KERNELS.inc("ec_coalesced_reads", sum(len(g) for g in groups.values()))
    for (erasures, want), items in groups.items():
        recovered = _decode_batch(
            codec, _stripe_batch([(r, ns) for _i, r, ns, _ls in items],
                                 n, unit), erasures, want)
        ofs = 0
        for i, rows, ns, logical_size in items:
            data_rows = {s: a for s, a in rows.items() if s < k}
            for idx, e in enumerate(want):
                data_rows[e] = recovered[ofs:ofs + ns, idx, :].reshape(-1)
            ofs += ns
            out[i] = _assemble_logical(data_rows, k, ns, unit, logical_size)
    return out


def reencode_stripes_multi(codec, sinfo: StripeInfo, reqs):
    """Coalesced recovery rebuild: N objects' full shard-row matrices in
    one device pass per distinct missing-data pattern, the multi twin of
    ``reencode_stripes`` (returns the per-op (k+m, nstripes*unit) uint8
    matrices, aligned with ``reqs``).  A codec without the planar
    contract for this stripe unit falls back to a coalesced decode and a
    coalesced encode, which still batch the whole group."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    out: List = [None] * len(reqs)
    groups: Dict[Tuple, List] = {}
    for i, (shards, logical_size) in enumerate(reqs):
        nstripes = sinfo.object_stripes(logical_size)
        if nstripes == 0:
            out[i] = np.zeros((n, 0), dtype=np.uint8)
            continue
        if len(shards) < k:
            raise ValueError(f"only {len(shards)} of {k} shards")
        rows = _shard_rows(shards, nstripes * unit)
        erasures = tuple(s for s in range(n) if s not in rows)
        missing = tuple(s for s in range(k) if s not in rows)
        groups.setdefault((erasures, missing), []).append(
            (i, rows, nstripes, logical_size))
    if not groups:
        return out
    KERNELS.inc("ec_coalesced_reencode_ticks")
    KERNELS.inc("ec_coalesced_reencodes",
                sum(len(g) for g in groups.values()))
    planar = _planar_ok(codec, unit)
    for (erasures, missing), items in groups.items():
        if not planar:
            datas = decode_stripes_multi(
                codec, sinfo, [(rows, ls) for _i, rows, _ns, ls in items])
            encoded = encode_stripes_multi(codec, sinfo, datas)
            for (i, _r, _ns, _ls), (shards_i, _crcs) in zip(items, encoded):
                out[i] = shards_i
            continue
        full = _reencode_batch(
            codec, _stripe_batch([(r, ns) for _i, r, ns, _ls in items],
                                 n, unit), erasures, missing)
        ofs = 0
        for i, _rows, ns, _ls in items:
            out[i] = full[ofs:ofs + ns].transpose(1, 0, 2) \
                .reshape(n, ns * unit)
            ofs += ns
    return out


# ---------------------------------------------------------------------------
# Planar AT-REST entry points: shards enter and leave as packed bit-planes
# (ec/planar_store.py layout); the only layout conversions are the ingest
# of client bytes at encode and the egress of logical bytes at read.
# ---------------------------------------------------------------------------


def planar_at_rest_ok(codec, unit: int) -> bool:
    """Can this (codec, stripe_unit) pool store EC shards as packed
    bit-planes at rest?  Needs a w=8 matrix-codec engine with
    survivor-submatrix decode and a stripe unit that is a multiple of the
    8-byte packing quantum."""
    eng = getattr(codec, "engine", None)
    if eng is None or getattr(eng, "w", 0) != 8:
        return False
    if getattr(eng, "coding", None) is None:
        return False
    if not hasattr(eng, "decode_matrix"):
        return False
    if getattr(codec, "packetsize", None) is not None:
        return False
    if unit <= 0 or unit % 8:
        return False
    return _planar_ok(codec, unit)


def _planes_rows_for(codec, src: Tuple[int, ...], want: Tuple[int, ...],
                     src_planes):
    """Reconstruct ``want`` chunks' plane rows from ``src`` chunks' plane
    rows on the codec's device (the CUDA kernel on the card, its plain
    version on the CPU).  None when the pattern has no survivor-submatrix
    solution."""
    try:
        bitmat = codec.engine.decode_bitmat(tuple(src), tuple(want))
    except gf8.SingularMatrixError:
        return None
    return gf8.planar_matmul(bitmat, _to_device(src_planes, codec.device))


def _parity_planes_for(codec, data_planes) -> torch.Tensor:
    """(k*8, cols) data plane rows -> (m*8, cols) parity plane rows."""
    return gf8.planar_matmul(codec.engine._enc_bitmat,
                             _to_device(data_planes, codec.device))


def _select_shard_planes(full_planes: np.ndarray,
                         shards: Tuple[int, ...]) -> np.ndarray:
    """Row-select whole shards (8 plane rows each) from a chunk-major
    host plane matrix: a gather, no layout change."""
    cols = full_planes.shape[1]
    return full_planes.reshape(-1, 8, cols)[list(shards)].reshape(-1, cols)


def encode_planes_multi(codec, sinfo: StripeInfo, datas, want_crcs=None):
    """Coalesced encode emitting AT-REST PLANES.

    Returns ``[(planes, crcs), ...]`` aligned with ``datas``: ``planes``
    is the per-op (n, 8, shard_len/8) uint8 array (``planes[s]`` is shard
    s's at-rest plane matrix) and ``crcs`` (when the op's flag is set) the
    per-shard ``ceph_crc32c(~0, byte_view)`` values, computed through the
    planar row view on the device.  Client bytes pack into planes exactly
    once (the ingest seam); parity is derived in the plane domain and
    shard bytes are never materialized."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    if want_crcs is None:
        want_crcs = [False] * len(datas)
    counts = [sinfo.object_stripes(len(d)) for d in datas]
    total = sum(counts)
    out: List = [None] * len(datas)
    if total == 0:
        for i in range(len(datas)):
            planes = np.zeros((n, 8, 0), dtype=np.uint8)
            out[i] = (planes,
                      crc32c_planar_rows(planes.reshape(n * 8, 0))
                      if want_crcs[i] else None)
        return out
    KERNELS.inc("ec_coalesced_ticks")
    KERNELS.inc("ec_coalesced_ops", len(datas))
    batch, pad = _pack_batch(sinfo, datas, counts)
    KERNELS.inc("ec_stripe_pad_bytes", pad)
    record_planar_at_rest("ingest", total * k * unit)
    rows = _to_device(batch, codec.device).permute(1, 0, 2).reshape(
        k, total * unit)
    data_planes = gf8.bytes_to_planar(rows)
    all_planes = torch.cat(
        [data_planes, _parity_planes_for(codec, data_planes)], dim=0)
    host = all_planes.cpu().numpy()
    # per-op at-rest planes slice straight out of the tick's plane matrix:
    # op columns are contiguous (unit % 8 == 0), shard s is plane rows
    # s*8..s*8+8
    crc_groups: Dict[int, List] = {}
    c0 = 0
    for i, ns in enumerate(counts):
        cw = ns * unit // 8
        out[i] = (np.ascontiguousarray(host[:, c0:c0 + cw]).reshape(n, 8, cw),
                  None)
        if want_crcs[i]:
            crc_groups.setdefault(cw, []).append((i, c0))
        c0 += cw
    # one planar crc batch per shard length, over the device planes
    for cw, group in crc_groups.items():
        stacked = torch.cat([all_planes[:, c:c + cw] for _i, c in group],
                            dim=0)
        crcs = crc32c_planar_rows(stacked)
        for gi, (i, _c) in enumerate(group):
            out[i] = (out[i][0], crcs[gi * n:(gi + 1) * n])
    return out


def _normalize_planes(shards, cols: int) -> Dict[int, np.ndarray]:
    """Shard map values -> (8, cols) plane matrices (serialized blobs
    reshape in place; already-shaped arrays pass through)."""
    out: Dict[int, np.ndarray] = {}
    for s, v in shards.items():
        arr = pstore.blob_to_planes(v) if isinstance(
            v, (bytes, bytearray, memoryview)) \
            else np.ascontiguousarray(v, dtype=np.uint8).reshape(8, -1)
        if arr.shape[1] != cols:
            raise ValueError(
                f"shard {s}: {arr.shape[1]} plane cols, want {cols}")
        out[s] = arr
    return out


def _assemble_from_planes(data_planes: Dict[int, np.ndarray], k: int,
                          nstripes: int, unit: int,
                          logical_size: int) -> bytes:
    """Planar shards -> logical client bytes: THE sanctioned egress."""
    stacked = np.vstack([data_planes[s] for s in range(k)])
    record_planar_at_rest("egress", int(stacked.size))
    rows = pstore.planes_to_rows(stacked)          # (k, shard_len)
    return _assemble_logical({s: rows[s] for s in range(k)},
                             k, nstripes, unit, logical_size)


def decode_planes_multi(codec, sinfo: StripeInfo, reqs):
    """Coalesced decode from AT-REST PLANES to logical bytes.

    ``reqs`` is a sequence of ``(shard_planes, logical_size)`` pairs;
    ``shard_planes`` maps shard id -> (8, shard_len/8) plane matrix (or
    its serialized blob).  Missing data shards are rebuilt in the plane
    domain, one planar matmul per erasure pattern for the whole tick; the
    only conversion is the final planes -> logical-bytes assemble.  A
    pattern without a survivor-submatrix solution (SHEC's non-MDS plans)
    relayouts its group's shards to bytes, counted on the ``relayout``
    seam, and decodes them in one ``decode_stripes_multi`` call (the
    reference calls it once per op; the bytes are the same)."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    out: List = [None] * len(reqs)
    groups: Dict[Tuple, List] = {}
    for i, (shards, logical_size) in enumerate(reqs):
        nstripes = sinfo.object_stripes(logical_size)
        if nstripes == 0:
            out[i] = b""
            continue
        cols = nstripes * unit // 8
        arrs = _normalize_planes(shards, cols)
        missing = tuple(s for s in range(k) if s not in arrs)
        if not missing:
            out[i] = _assemble_from_planes(arrs, k, nstripes, unit,
                                           logical_size)
            continue
        if len(arrs) < k:
            raise ValueError(f"only {len(arrs)} of {k} shards")
        erasures = tuple(s for s in range(n) if s not in arrs)
        groups.setdefault((erasures, missing), []).append(
            (i, arrs, nstripes, logical_size))
    if not groups:
        return out
    KERNELS.inc("ec_coalesced_read_ticks")
    KERNELS.inc("ec_coalesced_reads", sum(len(g) for g in groups.values()))
    for (erasures, want), items in groups.items():
        src = tuple(s for s in range(n) if s not in erasures)[:k]
        total_cols = sum(ns for _i, _a, ns, _ls in items) * unit // 8
        src_planes = np.zeros((k * 8, total_cols), dtype=np.uint8)
        c0 = 0
        for _i, arrs, ns, _ls in items:
            cw = ns * unit // 8
            for j, s in enumerate(src):
                src_planes[j * 8:j * 8 + 8, c0:c0 + cw] = arrs[s]
            c0 += cw
        rec = _planes_rows_for(codec, src, want, src_planes)
        if rec is None:
            # no solution for the plane engine: relayout the group to the
            # byte machinery, one coalesced decode (counted; never the
            # steady state)
            datas = decode_stripes_multi(
                codec, sinfo, [(_relayout_to_bytes(arrs), logical_size)
                               for _i, arrs, _ns, logical_size in items])
            for (i, _a, _ns, _ls), data in zip(items, datas):
                out[i] = data
            continue
        rec = rec.cpu().numpy()
        c0 = 0
        for i, arrs, ns, logical_size in items:
            cw = ns * unit // 8
            data_planes = {s: arrs[s] for s in range(k) if s in arrs}
            for idx, e in enumerate(want):
                data_planes[e] = rec[idx * 8:idx * 8 + 8, c0:c0 + cw]
            c0 += cw
            out[i] = _assemble_from_planes(data_planes, k, ns, unit,
                                           logical_size)
    return out


def _relayout_to_bytes(arrs: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """At-rest plane matrices -> shard byte rows, booked on the
    ``relayout`` seam."""
    return {s: np.frombuffer(pstore.planes_to_shard(a, seam="relayout"),
                             dtype=np.uint8)
            for s, a in arrs.items()}


def reencode_planes_multi(codec, sinfo: StripeInfo, reqs):
    """Coalesced recovery rebuild in the plane domain: at-rest planes in,
    at-rest planes out, no layout conversion (recovery neither ingests
    client bytes nor egresses logical bytes).

    ``reqs`` mirrors ``decode_planes_multi``; returns the per-op
    (n, 8, shard_len/8) uint8 arrays, aligned with ``reqs``.  Each
    (erasures, missing) group goes to the device once: missing data
    chunks' plane rows rebuild through the recovery bit-matrix, parity
    re-derives from the data plane rows (two kernel B1 calls), and
    surviving shards pass through.  A pattern without a survivor-submatrix
    solution relayouts its group through one ``reencode_stripes_multi``
    call."""
    k = sinfo.k
    unit = sinfo.chunk_size
    n = codec.get_chunk_count()
    out: List = [None] * len(reqs)
    groups: Dict[Tuple, List] = {}
    for i, (shards, logical_size) in enumerate(reqs):
        nstripes = sinfo.object_stripes(logical_size)
        if nstripes == 0:
            out[i] = np.zeros((n, 8, 0), dtype=np.uint8)
            continue
        if len(shards) < k:
            raise ValueError(f"only {len(shards)} of {k} shards")
        arrs = _normalize_planes(shards, nstripes * unit // 8)
        erasures = tuple(s for s in range(n) if s not in arrs)
        missing = tuple(s for s in range(k) if s not in arrs)
        groups.setdefault((erasures, missing), []).append(
            (i, arrs, nstripes, logical_size))
    if not groups:
        return out
    KERNELS.inc("ec_coalesced_reencode_ticks")
    KERNELS.inc("ec_coalesced_reencodes", sum(len(g) for g in groups.values()))
    for (erasures, want), items in groups.items():
        src = tuple(s for s in range(n) if s not in erasures)[:k]
        total_cols = sum(ns for _i, _a, ns, _ls in items) * unit // 8
        full = np.zeros((n * 8, total_cols), dtype=np.uint8)
        c0 = 0
        for _i, arrs, ns, _ls in items:
            cw = ns * unit // 8
            for s, a in arrs.items():
                full[s * 8:s * 8 + 8, c0:c0 + cw] = a
            c0 += cw
        if want:
            # only the src rows go to the device, and only once the plane
            # engine has a solution for the pattern
            rec = _planes_rows_for(codec, src, want,
                                   _select_shard_planes(full, src))
            if rec is None:
                # relayout the group through one coalesced byte recovery
                # rebuild
                rebuilt = reencode_stripes_multi(
                    codec, sinfo, [(_relayout_to_bytes(arrs), logical_size)
                                   for _i, arrs, _ns, logical_size in items])
                for (i, _a, _ns, _ls), rows in zip(items, rebuilt):
                    out[i] = pstore.rows_to_planes(rows).reshape(
                        n, 8, rows.shape[1] // 8)
                    record_planar_at_rest("relayout", int(rows.size))
                continue
            rec = rec.cpu().numpy()
            for idx, e in enumerate(want):
                full[e * 8:e * 8 + 8] = rec[idx * 8:idx * 8 + 8]
        full[k * 8:] = _parity_planes_for(codec, full[: k * 8]).cpu().numpy()
        c0 = 0
        for i, _arrs, ns, _ls in items:
            cw = ns * unit // 8
            out[i] = np.ascontiguousarray(
                full[:, c0:c0 + cw]).reshape(n, 8, cw)
            c0 += cw
    return out


def merge_range(old: bytes, old_size: int, offset: int, data: bytes) -> bytes:
    """Overlay ``data`` at ``offset`` onto ``old`` (zero-extending holes);
    returns the new logical object bytes."""
    new_size = max(old_size, offset + len(data))
    buf = np.zeros(new_size, dtype=np.uint8)
    if old:
        buf[: len(old)] = np.frombuffer(old, dtype=np.uint8)
    buf[offset: offset + len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.tobytes()
