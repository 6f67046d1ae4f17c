#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's erasure-code hot paths, CRUSH placement and device mesh on the CUDA cards.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ``ceph_tpu_torch/csrc/`` (first use,
one ``nvcc`` per source, in parallel), then runs these phases and exits
non-zero if any of them fails:

1. kernels: B1 (``ops/gf8_cuda.planar_matmul``) and B2
   (``ops/gf8_bytes_cuda.bitmatrix_matmul``) against their plain versions
   on the card, bit-exact: B1 at its ragged check shapes, the shapes the
   ISA path gives it, and those of the SHEC k8m4c3 encode and decodes
   (plans of 4 and 8 sources), the LRC k4m2l3 flattened encode and local
   decode, and reed_sol_van k8m4 at w=16 ((64, 128), staged) and w=32
   ((128, 256), whose lists overflow the staged kernel's table: kept);
   B2 at the general ISA bit-matrices the TPU kernel was validated with,
   the lane-expanded matrices of the cauchy path (encode, decodes with 1,
   2 and 4 erasures, the tick), the encode matrices of liberation k=7
   w=7, blaum_roth k=6 w=6, liber8tion k=8 and cauchy_good w=16 (with a
   planar encode/decode of each against the host reference), a
   misaligned column slice and N in {1, 7, 4097}; both at the staged
   kernel's edges (N of one vector, a tile less or more one vector,
   several tiles and a vector, fewer tiles than CTAs, k=128 with r=64,
   k=49), each call checked to take the path it should (staged or kept),
   and B2 with its host-packed table and with the on-card packing;
2. ISA path (ISA k=8 m=4, bit-planar, kernel B1): 4096 stripes x 8 x
   512 B per step through ``to_planar`` -> ``encode_planar`` ->
   ``to_batch`` against the host GF reference, ``decode_planar`` for 1, 2
   and 4 erasures, ``encode``/``decode_concat`` of a 4 MiB object, and one
   OSD tick at ``StripeInfo(8, 4096)`` through ``encode_planes_multi`` /
   ``decode_planes_multi``;
3. jerasure path (cauchy_good k=8 m=4 w=8 packetsize=2048, packet rows,
   kernel B2): 128 stripes x 8 x 16 KiB = 16 MiB per step through the
   same planar calls against a host reference (the XOR of the packet rows
   the bit-matrix selects), ``encode``/``decode_concat`` of a 4 MiB
   object, one byte-at-rest OSD tick at ``StripeInfo(8, 16384)`` through
   ``encode_stripes_multi`` / ``decode_stripes_multi`` /
   ``reencode_stripes_multi``, and a small tick of Ceph's default profile
   (jerasure reed_sol_van k=2 m=1, kernel B1) through
   ``encode_planes_multi`` / ``decode_planes_multi``;
4. the erasure-code paths, all on kernel B1, each tick of the same op
   sizes as the ISA tick and each result also held against the port's
   plain version on the CPU:
   - SHEC k=8 m=4 c=3, planes at rest at ``StripeInfo(8, 4096)``:
     ``encode_planes_multi`` with CRCs, ``decode_planes_multi`` for lost
     shards (3, 9) (plane engine) and (4,) and (0, 1) (relayout to the
     byte decode), ``reencode_planes_multi`` for (4,) (relayout) and
     (0, 5, 11) (plane engine);
   - LRC k=4 m=2 l=3, bytes at rest at ``StripeInfo(4, 4096)``:
     ``encode_stripes_multi``, ``decode_stripes_multi`` for one local
     loss (which reads only its group) and a loss in each group,
     ``reencode_stripes_multi``;
   - jerasure reed_sol_van k=8 m=4 at w=16 and w=32: codec encode/decode
     on the byte layout and the bitpack planes, and the byte-at-rest tick
     at ``StripeInfo(8, 4096)``;
5. placement (CRUSH and the OSDMap pipeline, torch ops, no hand-written
   kernel) on bench_map's map, ``build_three_level(39, 16, 16)``: 9,984
   OSDs, straw2, optimal tunables.  (a) ``OSDMap.pool_mapping`` of a
   replicated size-3 pool of 1,048,576 PGs, then ``rebalance_diff``
   against a copy with one host's 16 OSDs out and one more OSD down;
   (b) ``pool_mapping`` of an LRC k4m2l3 pool of 65,536 PGs on the rule
   ``ErasureCodeLrc.create_rule`` writes for ``crush-locality=rack``;
   (c) ``TensorMapper.do_rule_batch`` of the replicated rule under a
   balancer weight set on the root's 39 racks, 65,536 PGs.  Checked: 2,000
   sampled PGs of each of (a), (b), (c) and of the diff against the
   scalar chain, the first 65,536 PGs of (a) against
   ``TensorMapper(device="cpu")``, distinct hosts in every PG, no scalar
   fallback and no padded lanes.  Then (d) ROADMAP §C1's repro on the
   card (``build_hierarchy(2, 4)``, an erasure pool of size 7 and 16,384
   PGs on ``chooseleaf indep 0 type 0`` with OSDs 1 and 5 out), every PG
   against the scalar chain, and the same rule as a 65,536-PG erasure
   pool of the 9,984-OSD map with one host out, 2,000 sampled PGs against
   it (the scalar chain runs in a pool of spawned worker processes);
   (e) one balancer round,
   ``balance.scorer.calc_pg_upmaps_vectorized`` with the mgr's defaults
   (``max_deviation_ratio=0.05``, ``max_moves=16``), on a replicated
   size-3 pool of 65,536 PGs on that map: at least 1000 candidates
   counted, at most 16 legal moves (one per PG, no shared failure
   domain), a lower sum((count - target)^2) under a fresh
   ``pool_mapping``, 1,000,000 sampled device scores equal to the plain
   float64 formula bit for bit, and the round split into measurement,
   enumeration, scoring, sort and pick on a fresh copy of the map; and
   the card's candidates and moves equal to ``device="cpu"``'s on
   ``build_three_level(4, 16, 16)`` with 8,192 PGs;
6. the mesh (``ceph_tpu_torch/parallel/``, torch ops, no hand-written
   kernel): one controller over every visible card when there are two or
   more, else eight slots of ``cuda:0`` shaped ``(2, 4)``.
   ``MeshECEngine`` on ISA k8m4, 4096 stripes x 8 x 512 B: encode, the
   nine erasure patterns of ``tests/test_parallel.py`` and an RMW of
   columns [128, 384) against the single-device codec, byte for byte;
   ``distributed_ec_step`` at the same shape (0 mismatches);
   ``MeshCodecAdapter`` on 4095 stripes (padded to the data axis); and
   ``crush_batch_sharded`` of the 1,000,000 ``BENCH_PGS`` on the
   9,984-OSD map against ``do_rule_batch``;
7. one launch: a torch.profiler trace of one cauchy ``encode_planar``
   call shows exactly one device kernel, B2's staged kernel, and no
   ``pack_blocks_kernel``;
8. timing: CUDA-event medians of B1 and B2 and of their plain versions at
   their headline shapes (L2 flushed before each launch), each kernel's
   share of its bound, a same-traffic yardstick (``torch.bitwise_xor`` of
   the two 8 MiB halves of a (64, 262144) uint8 tensor into 8 MiB), the
   encode step of each path split into its parts, and B1 at the w=16,
   w=32 and SHEC encode shapes with 16 MiB of input planes;
   ``ops/profiling.device_loop_slope`` of B1 at its headline shape (each
   L-step chain one CUDA graph) beside its CUDA-event median; then the
   placement entry points' wall medians over 3 calls (``do_rule_batch``
   of 1,000,000 PGs at the default chunk and in one chunk, with a
   torch.profiler count of device kernels, kernel time, host syncs and
   the device's idle share; ``pool_mapping``; ``rebalance_diff``;
   ``bench_map``); and the mesh encode and one-erasure decode against the
   single-device codec (CUDA events on every device of the mesh, and wall
   medians), and the wall medians of ``crush_batch_sharded`` and
   ``do_rule_batch`` on the 1,000,000 PGs.

Phases 2, 3, each path of phase 4, phase 5 (a)-(c), (d), (e) and phase 6
are main paths: kernel launch counts
are set to 0 just before each and read just after, every kernel of the
path must have launched, and every launch must have taken the staged
path, except on the w=32 path, whose encode and 4-erasure decode take the
kept one; the placement path launches neither kernel and its
``crush_map_*`` counters must show its five batched calls, the C1 path's
its two, the scorer path's ``balance_candidates_scored`` the
candidates the round reports, and the mesh path launches neither kernel
and maps one shard per mesh slot.  The last lines are the card's name and
power limit, one JSON object describing each kernel (B1's launches summed over every main
path), and ``{"ok": true, "device": {...}}``.  Without a CUDA device it
prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np

# the card's published rates (NVIDIA H100 SXM data sheet): device memory
# bandwidth, and the non-tensor 32-bit rate used for the XOR count
HBM_BYTES_PER_S = 3.35e12
OPS_32BIT_PER_S = 67e12

SEED = 20261016

# device clock cycles of the spin ahead of each timed call (~0.3 ms), and
# ahead of each timed encode step, whose dozens of small launches can take
# the host longer than that to enqueue
SPIN_CYCLES = 500_000
STEP_SPIN_CYCLES = 4 * SPIN_CYCLES

# one OSD tick: 256 ops of 64 KiB objects and a few ragged sizes
TICK_SIZES = [64 << 10] * 256 + [0, 100, 40000, 200 << 10, (1 << 20) + 1]

# the jerasure path: cauchy_good at the plugin's default w and packetsize
# (16 KiB chunk quantum), at the k/m of the ISA path; 128 stripes x 8 x
# 16 KiB = 16 MiB of client data per encode step
CAUCHY_PROFILE = {"plugin": "jerasure", "technique": "cauchy_good",
                  "k": "8", "m": "4", "packetsize": "2048"}
HEADLINE_STRIPES = 128

# the erasure-code slice's pools: the example profiles of Ceph's own
# documentation (erasure-code-shec.rst, erasure-code-lrc.rst) and
# reed_sol_van k=8 m=4 at the wide fields
SHEC_PROFILE = {"plugin": "shec", "k": "8", "m": "4", "c": "3"}
LRC_PROFILE = {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}
WIDE_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
                "m": "4"}

# the staged kernels' column tile (csrc/gf2_stream.cuh kTile) and the
# widths at its edges: one 16-byte vector, a tile less or more a vector,
# several tiles and a vector (each a single item or a few: fewer tiles
# than the persistent grid has CTAs)
TILE = 1024
EDGE_WIDTHS = [16, TILE - 16, TILE, TILE + 16, 5 * TILE + 16]

# the packet codecs checked at their own geometry (packetsize 2048)
PACKET_CHECKS = [
    {"technique": "liberation", "k": "7", "w": "7"},
    {"technique": "blaum_roth", "k": "6", "w": "6"},
    {"technique": "liber8tion", "k": "8"},
    {"technique": "cauchy_good", "k": "8", "m": "4", "w": "16"},
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int, flush=None, spin=SPIN_CYCLES) -> float:
    """Median over ``reps`` single calls, timed with CUDA events; the L2
    cache is overwritten before each call when ``flush`` is given.  A
    device-side spin before the start event keeps the card busy while the
    host enqueues the call, so the host's launch overhead does not show
    up as idle time between the events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_kernel_ms(fn, kernel_name: str, reps: int, flush):
    """Median device time of the kernel ``kernel_name`` over ``reps``
    calls, as torch.profiler's CUDA activity trace reports it (no event or
    launch overhead); None when the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = [getattr(e, "device_time", None) or e.cuda_time
             for e in prof.events() if kernel_name in e.name]
    return statistics.median(times) / 1e3 if times else None


def took_path(module, before: int) -> str:
    """"kept" when the wrapper's kept-path count moved since ``before``."""
    return "kept" if module.kept_launches > before else "staged"


def phase_kernel(codec, rng):
    """B1 against its plain version on the card at its check shapes and
    the ISA path's; returns max |diff|."""
    import torch

    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ops import gf8

    cases = []
    for (k, m, npk) in [(8, 4, 2048 * 3), (8, 4, 2048 * 2 + 100),
                        (4, 2, 5000), (10, 4, 2048), (2, 1, 2048)]:
        bm = gf8.expand_bitmatrix(matrices.isa_rs_matrix(k, m))
        cases.append((f"check k{k}m{m} npk={npk}",
                      torch.from_numpy(bm).cuda(), npk))
    eng = codec.engine
    headline_npk = 4096 * 512 // 8       # packed columns of one step
    cases.append(("headline encode", eng._enc_bitmat, headline_npk))
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        src = tuple(i for i in range(12) if i not in er)[:8]
        cases.append((f"headline decode {er}", eng.decode_bitmat(src, er),
                      headline_npk))
    # the stripe tick's shape: its stripes' packed columns
    cases.append(("stripe tick encode", eng._enc_bitmat,
                  tick_stripes(8, 4096) * 4096 // 8))
    # the staged kernel's edges, and k=128 with r=64 and k=49
    for npk in EDGE_WIDTHS:
        cases.append((f"staged edge npk={npk}", eng._enc_bitmat, npk))
    for rw, kw in [(64, 128), (32, 49)]:
        bm = torch.from_numpy(
            rng.integers(0, 2, (rw, kw), dtype=np.uint8)).cuda()
        cases.append((f"staged edge r={rw} k={kw}", bm, 4 * TILE + 16))
    return max(check_b1(name, bm, npk, rng) for name, bm, npk in cases)


def phase_codec(codec, rng):
    """ISA k8m4 at 4096 x 8 x 512 B: planar encode/decode and the object
    encode/decode_concat, against the host GF reference."""
    from ceph_tpu_torch.ops import gf8

    B, k, S = 4096, 8, 512
    data = rng.integers(0, 256, (B, k, S), dtype=np.uint8)
    t0 = time.perf_counter()
    pb = codec.to_planar(data)
    parity = codec.encode_planar(pb).to_batch().cpu().numpy()
    t_enc = time.perf_counter() - t0
    cols = data.transpose(1, 0, 2).reshape(k, B * S)
    ref = gf8.gf_matmul_ref(codec.engine.coding, cols)
    ref = ref.reshape(4, B, S).transpose(1, 0, 2)
    if not np.array_equal(parity, ref):
        raise AssertionError("planar encode parity differs from host reference")
    log(f"codec: planar encode of {B}x{k}x{S} B equals host GF reference "
        f"(host clock incl. copies {t_enc * 1e3:.3f} ms)")
    full = np.concatenate([data, parity], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec = codec.decode_planar(er, codec.to_planar(chunks))
        if not np.array_equal(dec.to_batch().cpu().numpy(),
                              full[:, list(er), :]):
            raise AssertionError(f"decode_planar {er} wrong")
        log(f"codec: decode_planar erasures {er} recovers the chunks")
    obj = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(12), obj)
    dchunks = np.stack([enc[i] for i in range(8)])
    if not np.array_equal(np.stack([enc[i] for i in range(8, 12)]),
                          gf8.gf_matmul_ref(codec.engine.coding, dchunks)):
        raise AssertionError("encode parity differs from host reference")
    for er in [(0,), (3, 10), (0, 5, 9, 11)]:
        avail = {i: c for i, c in enc.items() if i not in er}
        if codec.decode_concat(avail)[:len(obj)] != obj:
            raise AssertionError(f"decode_concat {er} wrong")
    log("codec: encode/decode_concat of a 4 MiB object round-trips")
    return data


def phase_stripe(codec):
    """One OSD tick at StripeInfo(8, 4096) through the at-rest planar
    entry points, against host references."""
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c, gf8

    rng = np.random.default_rng(SEED + 1)
    sinfo = stripe.StripeInfo(8, 4096)
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in TICK_SIZES]
    res = stripe.encode_planes_multi(codec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    n = 12
    by_len = {}
    for (planes, crcs), d in zip(res, datas):
        ns = sinfo.object_stripes(len(d))
        shards = pstore.planes_to_rows(planes.reshape(n * 8, -1))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        data_rows = buf.reshape(ns, 8, 4096).transpose(1, 0, 2).reshape(8, -1)
        want = np.vstack([data_rows,
                          gf8.gf_matmul_ref(codec.engine.coding, data_rows)])
        if not np.array_equal(shards, want):
            raise AssertionError(f"stripe shards differ for a {len(d)} B op")
        by_len.setdefault(shards.shape[1], []).append((shards, crcs))
    checked = 0
    for length, group in by_len.items():
        rows = np.vstack([s for s, _c in group])
        host = crc32c.crc32c_rows(rows)           # host table path
        got = [c for _s, crcs in group for c in crcs]
        if got != host:
            raise AssertionError(f"stripe CRCs differ at shard length {length}")
        for r in (0, len(rows) - 1):
            if crc32c.crc32c(0xFFFFFFFF, rows[r].tobytes()) != got[r]:
                raise AssertionError("stripe CRC differs from scalar crc32c")
        checked += len(rows)
    log(f"stripe: {len(datas)} ops, shards equal host reference, "
        f"{checked} shard CRCs equal host crc32c")
    for lost in [(3,), (0, 6)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        if stripe.decode_planes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"decode_planes_multi lost {lost} wrong")
        log(f"stripe: decode_planes_multi with data shards {lost} lost "
            "returns the original bytes")


def to_packet_rows(batch: np.ndarray, w: int, p: int) -> np.ndarray:
    """(B, c, S) chunks -> (c*w, B*ns*p) packet rows: packet t of every
    super-block of chunk j lands in row j*w + t (jerasure's layout)."""
    b, c, s = batch.shape
    ns = s // (w * p)
    return np.ascontiguousarray(batch.reshape(b, c, ns, w, p)
                                .transpose(1, 3, 0, 2, 4)
                                .reshape(c * w, b * ns * p))


def from_packet_rows(rows: np.ndarray, b: int, s: int, w: int,
                     p: int) -> np.ndarray:
    """(c*w, B*ns*p) packet rows -> (B, c, S) chunks."""
    c = rows.shape[0] // w
    ns = s // (w * p)
    return np.ascontiguousarray(rows.reshape(c, w, b, ns, p)
                                .transpose(2, 0, 3, 1, 4).reshape(b, c, s))


def host_xor_rows(m01: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Host reference of a packet code: output row r is the XOR of the
    input rows that the 0/1 matrix m01 selects in its row r."""
    out = np.zeros((m01.shape[0], rows.shape[1]), dtype=np.uint8)
    for r in range(m01.shape[0]):
        sel = np.nonzero(m01[r])[0]
        if sel.size:
            out[r] = np.bitwise_xor.reduce(rows[sel], axis=0)
    return out


def host_packet_parity(codec, batch: np.ndarray) -> np.ndarray:
    """(B, k, S) data chunks -> (B, m, S) parity chunks on the host."""
    w, p = codec.w, codec.packetsize
    b, _k, s = batch.shape
    prow = host_xor_rows(codec._encode_bits(), to_packet_rows(batch, w, p))
    return from_packet_rows(prow, b, s, w, p)


def check_b2(name, lane, rows, blocks=None):
    """B2 against its plain version on the same operands, with the host
    table ``blocks`` or packed on the card; checks that the call took the
    staged path exactly when its rows are 16-byte aligned.  Max |diff|."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda

    kept = gf8_bytes_cuda.kept_launches
    got = gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks)
    path = took_path(gf8_bytes_cuda, kept)
    want = gf8_bytes_cuda.bitmatrix_matmul_ref(lane, rows)
    torch.cuda.synchronize()
    diff = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if diff or not torch.equal(got, want):
        raise AssertionError(f"B2 differs from its plain version: {name}")
    n = rows.shape[1]
    aligned = (n % 16 == 0 and rows.data_ptr() % 16 == 0
               and (rows.shape[0] < 2 or rows.stride(0) % 16 == 0))
    if path != ("staged" if aligned else "kept"):
        raise AssertionError(f"B2 took the {path} path: {name}")
    log(f"kernel: B2 bit-exact, {name}, bitmat {tuple(lane.shape)} x data "
        f"{tuple(rows.shape)}, "
        f"{'host table' if blocks is not None else 'packed on the card'}, "
        f"{path} path")
    return diff


def phase_kernel_b2(codec, rng):
    """B2 against its plain version on the card at every shape of the
    jerasure slice; returns max |diff|."""
    import torch

    from ceph_tpu_torch.ec import factory, matrices
    from ceph_tpu_torch.ops import gf8

    worst = 0
    # the general bit-matrices the TPU kernel was validated with
    for (k, m, n) in [(8, 4, 16384 * 3), (8, 4, 16384 * 2 + 1000),
                      (4, 2, 5000), (10, 4, 16384)]:
        bm = torch.from_numpy(
            gf8.expand_bitmatrix(matrices.isa_rs_matrix(k, m))).cuda()
        data = torch.from_numpy(
            rng.integers(0, 256, (k, n), dtype=np.uint8)).cuda()
        worst = max(worst, check_b2(f"ISA k{k}m{m} N={n}", bm, data))
    # the lane-expanded matrices of the cauchy path at the headline width
    k, w, p = codec.k, codec.w, codec.packetsize
    n = HEADLINE_STRIPES * p
    rows = torch.from_numpy(
        rng.integers(0, 256, ((k + codec.m) * w, n + 8), dtype=np.uint8)
    ).cuda()
    enc, enc_blocks = codec._lane_and_blocks(codec._encode_bits())
    worst = max(worst, check_b2("cauchy headline encode, row stride N+8",
                                enc, rows[:k * w, :n], enc_blocks))
    headline = rows[:k * w, :n].contiguous()
    worst = max(worst, check_b2("cauchy headline encode", enc, headline,
                                enc_blocks))
    worst = max(worst, check_b2("cauchy headline encode", enc, headline))
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        src = tuple(i for i in range(k + codec.m) if i not in er)[:k]
        dec, dec_blocks = codec._lane_and_blocks(codec._decode_bits(src, er))
        sel = torch.cat([rows[s * w:(s + 1) * w, :n] for s in src])
        worst = max(worst, check_b2(f"cauchy headline decode {er}", dec, sel,
                                    dec_blocks))
    tick = torch.from_numpy(rng.integers(
        0, 256, (k * w, tick_stripes(8, 16384) * p), dtype=np.uint8)).cuda()
    worst = max(worst, check_b2("cauchy stripe tick encode", enc, tick,
                                enc_blocks))
    # a column slice off any word boundary, and ragged widths
    for n_edge in (n - 8, 1, 7, 4097):
        view = rows[:k * w, 3:3 + n_edge]
        worst = max(worst, check_b2(
            f"cauchy encode, slice at column 3, N={n_edge}", enc, view))
    # the staged kernel's edges
    for n_edge in EDGE_WIDTHS:
        worst = max(worst, check_b2(
            f"cauchy encode, staged edge N={n_edge}", enc,
            headline[:, :n_edge].contiguous(), enc_blocks))
    # the other packet codecs at their own geometry: kernel, then a planar
    # encode/decode against the host reference
    for prof in PACKET_CHECKS:
        pc = factory({"plugin": "jerasure", "packetsize": "2048", **prof})
        name = f"{pc.technique} k{pc.k}m{pc.m} w{pc.w}"
        lane, blocks = pc._lane_and_blocks(pc._encode_bits())
        batch = rng.integers(0, 256, (16, pc.k, pc.w * pc.packetsize),
                             dtype=np.uint8)
        prow = torch.from_numpy(to_packet_rows(batch, pc.w,
                                               pc.packetsize)).cuda()
        worst = max(worst, check_b2(f"{name} encode", lane, prow, blocks))
        worst = max(worst, check_b2(
            f"{name} encode, staged edge N={TILE + 16}", lane,
            prow[:, :TILE + 16].contiguous(), blocks))
        parity = pc.encode_planar(pc.to_planar(batch)).to_batch().cpu().numpy()
        if not np.array_equal(parity, host_packet_parity(pc, batch)):
            raise AssertionError(f"{name}: planar encode differs from host")
        full = np.concatenate([batch, parity], axis=1)
        er = (0, pc.k)
        got = pc.decode_planar(er, pc.to_planar(full)).to_batch()
        if not np.array_equal(got.cpu().numpy(), full[:, list(er), :]):
            raise AssertionError(f"{name}: planar decode {er} wrong")
        log(f"codec: {name} packetsize 2048 planar encode equals host "
            f"reference, decode {er} recovers the chunks")
    return worst


def phase_codec_cauchy(codec, rng):
    """cauchy_good k8m4 at 128 x 8 x 16 KiB = 16 MiB per step: planar
    encode/decode and the object encode/decode_concat, against the host
    reference.  Returns the step's data."""
    k, m, s = codec.k, codec.m, codec.w * codec.packetsize
    data = rng.integers(0, 256, (HEADLINE_STRIPES, k, s), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_planar(codec.to_planar(data)).to_batch()
    parity = parity.cpu().numpy()
    t_enc = time.perf_counter() - t0
    if not np.array_equal(parity, host_packet_parity(codec, data)):
        raise AssertionError("cauchy planar encode differs from host")
    log(f"codec: cauchy_good planar encode of {HEADLINE_STRIPES}x{k}x{s} B "
        f"equals the host reference (host clock incl. copies "
        f"{t_enc * 1e3:.3f} ms)")
    full = np.concatenate([data, parity], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec = codec.decode_planar(er, codec.to_planar(chunks))
        if not np.array_equal(dec.to_batch().cpu().numpy(),
                              full[:, list(er), :]):
            raise AssertionError(f"cauchy decode_planar {er} wrong")
        log(f"codec: cauchy_good decode_planar erasures {er} recovers the "
            "chunks")
    obj = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(k + m), obj)
    chunk = len(enc[0])
    dchunks = np.stack([enc[i] for i in range(k)])[None]     # (1, k, chunk)
    if not np.array_equal(np.stack([enc[i] for i in range(k, k + m)]),
                          host_packet_parity(codec, dchunks)[0]):
        raise AssertionError("cauchy encode parity differs from host")
    for er in [(0,), (3, 10), (0, 5, 9, 11)]:
        avail = {i: c for i, c in enc.items() if i not in er}
        if codec.decode_concat(avail)[:len(obj)] != obj:
            raise AssertionError(f"cauchy decode_concat {er} wrong")
    log(f"codec: cauchy_good encode/decode_concat of a 4 MiB object "
        f"({chunk} B chunks) round-trips")
    return data


def phase_stripe_cauchy(codec):
    """One byte-at-rest OSD tick of the cauchy pool at StripeInfo(8,
    16384): coalesced encode (shards and CRCs against the host
    reference), decode with lost data shards and recovery rebuild."""
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c

    rng = np.random.default_rng(SEED + 4)
    k, n = codec.k, codec.get_chunk_count()
    sinfo = stripe.StripeInfo(k, codec.stripe_unit(4096))
    unit = sinfo.chunk_size
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in TICK_SIZES]
    res = stripe.encode_stripes_multi(codec, sinfo, datas,
                                      want_crcs=[True] * len(datas))
    by_len = {}
    for (shards, crcs), d in zip(res, datas):
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        batch = buf.reshape(ns, k, unit)
        full = np.concatenate([batch, host_packet_parity(codec, batch)],
                              axis=1)
        want = full.transpose(1, 0, 2).reshape(n, ns * unit)
        if not np.array_equal(shards, want):
            raise AssertionError(f"cauchy shards differ for a {len(d)} B op")
        by_len.setdefault(shards.shape[1], []).append((shards, crcs))
    checked = 0
    for length, group in by_len.items():
        rows = np.vstack([sh for sh, _c in group])
        got = [c for _s, crcs in group for c in crcs]
        if got != crc32c.crc32c_rows(rows):      # host table path
            raise AssertionError(f"cauchy CRCs differ at length {length}")
        checked += len(rows)
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: cauchy_good tick at StripeInfo({k}, {unit}): {len(datas)} "
        f"ops, {stripes} stripes, shards equal the host reference, "
        f"{checked} shard CRCs equal host crc32c")
    for lost in [(3,), (0, 6)]:
        reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
                for (sh, _c), d in zip(res, datas)]
        if stripe.decode_stripes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"decode_stripes_multi lost {lost} wrong")
        log(f"stripe: cauchy_good decode_stripes_multi with data shards "
            f"{lost} lost returns the original bytes")
    lost = (1, 9)
    reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
            for (sh, _c), d in zip(res, datas)]
    for got, (sh, _c) in zip(stripe.reencode_stripes_multi(codec, sinfo,
                                                           reqs), res):
        if not np.array_equal(got, sh):
            raise AssertionError("reencode_stripes_multi shards differ")
    log(f"stripe: cauchy_good reencode_stripes_multi with shards {lost} "
        "lost rebuilds every shard")


def phase_default_profile_tick():
    """A small tick of Ceph's default pool profile (jerasure reed_sol_van
    k=2 m=1, bit-planar at rest) through the planar entry points."""
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import gf8

    codec = factory({})
    assert (codec.technique, codec.k, codec.m) == ("reed_sol_van", 2, 1)
    rng = np.random.default_rng(SEED + 5)
    sinfo = stripe.StripeInfo(2, codec.stripe_unit(4096))
    if not stripe.planar_at_rest_ok(codec, sinfo.chunk_size):
        raise AssertionError("default profile is not planar at rest")
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in [64 << 10] * 16 + [0, 5, 8192, 100000]]
    res = stripe.encode_planes_multi(codec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    for (planes, _crcs), d in zip(res, datas):
        shards = pstore.planes_to_rows(planes.reshape(3 * 8, -1))
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        rows = buf.reshape(ns, 2, sinfo.chunk_size).transpose(1, 0, 2) \
            .reshape(2, ns * sinfo.chunk_size)
        want = np.vstack([rows, gf8.gf_matmul_ref(codec.engine.coding, rows)])
        if not np.array_equal(shards, want):
            raise AssertionError("default-profile shards differ from host")
    for lost in [(0,), (1,)]:
        reqs = [({s: p[s] for s in range(3) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        if stripe.decode_planes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"default profile lost {lost} wrong")
    log(f"stripe: default profile jerasure reed_sol_van k2m1, "
        f"{len(datas)} ops through encode_planes_multi/decode_planes_multi "
        "round-trip with either data shard lost")


def b1_expected_path(rw: int, kw: int, npk: int) -> str:
    """The path B1's wrapper should pick for a fresh contiguous operand:
    staged for 16-byte rows whose lists fit the table, kept otherwise."""
    from ceph_tpu_torch.ops import gf8_cuda

    fits = gf8_cuda.list_bytes(rw, kw) <= gf8_cuda.TABLE_BYTES
    return "staged" if npk % 16 == 0 and fits else "kept"


def check_b1(name, bm, npk, rng):
    """B1 against its plain version on random planes at (bitmat, npk);
    asserts bit-exactness and the path the call took.  Max |diff|."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rw, kw = (int(x) for x in bm.shape)
    planes = torch.from_numpy(
        rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
    kept = gf8_cuda.kept_launches
    got = gf8_cuda.planar_matmul(bm, planes)
    path = took_path(gf8_cuda, kept)
    want = gf8_cuda.planar_matmul_ref(bm, planes)
    torch.cuda.synchronize()
    diff = int((got.int() - want.int()).abs().max())
    if diff or not torch.equal(got, want):
        raise AssertionError(f"B1 differs from its plain version: {name}")
    if path != b1_expected_path(rw, kw, npk):
        raise AssertionError(f"B1 took the {path} path: {name}")
    log(f"kernel: B1 bit-exact, {name}, bitmat {(rw, kw)} x planes "
        f"{(kw, npk)}, {path} path (lists "
        f"{gf8_cuda.list_bytes(rw, kw)} B)")
    return diff


def tick_stripes(k: int, unit: int) -> int:
    return sum(-(-s // (k * unit)) for s in TICK_SIZES)


def phase_kernel_b1_codecs(shec, lrc, wide, rng):
    """B1 at the shapes the SHEC, LRC and wide-field paths give it, with
    the planes of one tick; returns max |diff|."""
    worst = 0
    npk = tick_stripes(8, 4096) * 4096 // 8          # SHEC at-rest planes
    worst = max(worst, check_b1("SHEC k8m4c3 encode", shec.engine._enc_bitmat,
                                npk, rng))
    for er, want in [((4,), (4,)), ((0, 1), (0, 1)), ((3, 9), (3,)),
                     ((0, 5, 11), (0, 5, 11))]:
        bm, src = shec._planar_decode_plan(er, want)
        worst = max(worst, check_b1(
            f"SHEC decode {er} want {want} ({len(src)} sources)", bm, npk,
            rng))
    npk = tick_stripes(4, 4096) * 4096 // 8
    worst = max(worst, check_b1("LRC k4m2l3 flattened encode",
                                lrc._flat_encode_bitmat(), npk, rng))
    bm, src = lrc._decode_plan_for((1,), (1,))
    worst = max(worst, check_b1(f"LRC local decode (1,) from {src}", bm, npk,
                                rng))
    for codec in wide:
        w = codec.w
        npk = tick_stripes(8, 4096) * 4096 // w
        name = f"reed_sol_van k8m4 w={w}"
        worst = max(worst, check_b1(f"{name} encode",
                                    codec.engine._enc_bitmat, npk, rng))
        for er in [(2,), (1, 4, 8, 11)]:
            src = tuple(i for i in range(12) if i not in er)[:8]
            worst = max(worst, check_b1(f"{name} decode {er}",
                                        codec.engine.decode_bitmat(src, er),
                                        npk, rng))
    return worst


def tick_datas(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in TICK_SIZES]


def relayout_bytes() -> int:
    from ceph_tpu_torch.utils.perf import KERNELS

    return KERNELS.dump()["device_kernels"].get("ec_planar_relayout_bytes", 0)


def phase_shec_tick(shec, shec_cpu):
    """One OSD tick of a SHEC k=8 m=4 c=3 pool with planes at rest, at
    StripeInfo(8, 4096): encode with CRCs, decode for erasures the plane
    engine solves and for erasures that relayout, and the recovery rebuild
    in the plane domain; every result against the original data or the
    at-rest planes, and against the port's plain version on the CPU."""
    from ceph_tpu_torch.ec import planar_store as pstore
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c, gf8

    sinfo = stripe.StripeInfo(8, shec.stripe_unit(4096))
    if not stripe.planar_at_rest_ok(shec, sinfo.chunk_size):
        raise AssertionError("SHEC k8m4c3 is not planar at rest")
    n = shec.get_chunk_count()
    datas = tick_datas(SEED + 8)
    res = stripe.encode_planes_multi(shec, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    cpu = stripe.encode_planes_multi(shec_cpu, sinfo, datas,
                                     want_crcs=[True] * len(datas))
    for (planes, crcs), (cplanes, ccrcs), d in zip(res, cpu, datas):
        if not np.array_equal(planes, cplanes) or crcs != ccrcs:
            raise AssertionError("SHEC planes differ from the plain version")
        shards = pstore.planes_to_rows(planes.reshape(n * 8, -1))
        ns = sinfo.object_stripes(len(d))
        buf = np.zeros(ns * sinfo.stripe_width, dtype=np.uint8)
        buf[:len(d)] = np.frombuffer(d, dtype=np.uint8)
        rows = buf.reshape(ns, 8, 4096).transpose(1, 0, 2).reshape(8, -1)
        want = np.vstack([rows, gf8.gf_matmul_ref(shec.engine.coding, rows)])
        if not np.array_equal(shards, want):
            raise AssertionError(f"SHEC shards differ for a {len(d)} B op")
        if crcs != crc32c.crc32c_rows(shards):
            raise AssertionError("SHEC shard CRCs differ from host crc32c")
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: SHEC k8m4c3 tick at StripeInfo(8, 4096): {len(datas)} ops, "
        f"{stripes} stripes, planes equal the host reference and the plain "
        "version, shard CRCs equal host crc32c")
    for lost, solved in [((3, 9), True), ((4,), False), ((0, 1), False)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        before = relayout_bytes()
        got = stripe.decode_planes_multi(shec, sinfo, reqs)
        relayout = relayout_bytes() - before
        if got != datas:
            raise AssertionError(f"SHEC decode_planes_multi {lost} wrong")
        if (relayout == 0) != solved:
            raise AssertionError(f"SHEC decode {lost}: relayout {relayout} B")
        log(f"stripe: SHEC decode_planes_multi with shards {lost} lost "
            f"returns the original bytes ("
            + ("plane engine" if solved else f"relayout of {relayout} B")
            + ")")
    for lost, solved in [((4,), False), ((0, 5, 11), True)]:
        reqs = [({s: p[s] for s in range(n) if s not in lost}, len(d))
                for (p, _c), d in zip(res, datas)]
        before = relayout_bytes()
        got = stripe.reencode_planes_multi(shec, sinfo, reqs)
        relayout = relayout_bytes() - before
        plain = stripe.reencode_planes_multi(shec_cpu, sinfo, reqs)
        for g, c, (p, _c) in zip(got, plain, res):
            if not (np.array_equal(g, p) and np.array_equal(g, c)):
                raise AssertionError(f"SHEC reencode_planes_multi {lost}")
        if (relayout == 0) != solved:
            raise AssertionError(f"SHEC reencode {lost}: relayout {relayout}")
        log(f"stripe: SHEC reencode_planes_multi with shards {lost} lost "
            "rebuilds the at-rest planes, equal to the plain version ("
            + ("plane engine" if solved else f"relayout of {relayout} B")
            + ")")


def byte_tick(codec, codec_cpu, sinfo, datas, label, lost_sets, rebuild):
    """The byte-at-rest tick of a pool: coalesced encode with CRCs,
    decode with lost shards and the recovery rebuild, each against the
    port's plain version on the CPU (and the original bytes)."""
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.ops import crc32c

    n = codec.get_chunk_count()
    flags = [True] * len(datas)
    res = stripe.encode_stripes_multi(codec, sinfo, datas, want_crcs=flags)
    cpu = stripe.encode_stripes_multi(codec_cpu, sinfo, datas,
                                      want_crcs=flags)
    for (sh, crcs), (csh, ccrcs) in zip(res, cpu):
        if not np.array_equal(sh, csh) or crcs != ccrcs:
            raise AssertionError(f"{label}: shards differ from plain version")
        if crcs != crc32c.crc32c_rows(sh):
            raise AssertionError(f"{label}: shard CRCs differ from host")
    stripes = sum(sinfo.object_stripes(len(d)) for d in datas)
    log(f"stripe: {label} tick at StripeInfo({sinfo.k}, {sinfo.chunk_size}): "
        f"{len(datas)} ops, {stripes} stripes, shards and CRCs equal the "
        "plain version on the CPU")
    for lost in lost_sets:
        reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
                for (sh, _c), d in zip(res, datas)]
        if stripe.decode_stripes_multi(codec, sinfo, reqs) != datas:
            raise AssertionError(f"{label}: decode_stripes_multi {lost}")
        log(f"stripe: {label} decode_stripes_multi with shards {lost} lost "
            "returns the original bytes")
    reqs = [({s: sh[s] for s in range(n) if s not in rebuild}, len(d))
            for (sh, _c), d in zip(res, datas)]
    for got, (sh, _c) in zip(stripe.reencode_stripes_multi(codec, sinfo,
                                                           reqs), res):
        if not np.array_equal(got, sh):
            raise AssertionError(f"{label}: reencode_stripes_multi differs")
    log(f"stripe: {label} reencode_stripes_multi with shards {rebuild} lost "
        "rebuilds every shard")


def phase_lrc_tick(lrc, lrc_cpu):
    """One byte-at-rest tick of an LRC k=4 m=2 l=3 pool (8 chunks in 3
    layers) at StripeInfo(4, 4096): one local loss, which reads only its
    l+1 group, a loss in each group, and a recovery rebuild."""
    from ceph_tpu_torch.ec import stripe

    sinfo = stripe.StripeInfo(4, lrc.stripe_unit(4096))
    byte_tick(lrc, lrc_cpu, sinfo, tick_datas(SEED + 9), "LRC k4m2l3",
              [(1,), (1, 2)], (0, 6))
    _bm, src = lrc._decode_plan_for((1,), (1,))
    if len(src) != 3 or set(src) != {0, 4, 5}:
        raise AssertionError(f"LRC local loss of chunk 1 reads {src}")
    log(f"stripe: LRC single loss of chunk 1 gathers only chunks {src}, "
        "the rest of its local group")


def phase_wide_codec(codec, codec_cpu, rng):
    """reed_sol_van k8m4 at w=16 or 32: codec encode and decode on the
    byte layout (torch matmul on bits) and the bitpack planes (B1), equal
    to each other and to the plain version, and the object
    encode/decode_concat."""
    w = codec.w
    label = f"reed_sol_van k8m4 w={w}"
    data = rng.integers(0, 256, (64, 8, 4096), dtype=np.uint8)
    byte_par = codec.encode_batch(data).cpu().numpy()
    planar_par = codec.encode_planar(codec.to_planar(data)).to_batch()
    if not np.array_equal(planar_par.cpu().numpy(), byte_par):
        raise AssertionError(f"{label}: planar and byte parity differ")
    if not np.array_equal(byte_par, codec_cpu.encode_planar(
            codec_cpu.to_planar(data)).to_batch().numpy()):
        raise AssertionError(f"{label}: parity differs from plain version")
    full = np.concatenate([data, byte_par], axis=1)
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        chunks = full.copy()
        chunks[:, list(er), :] = 0
        dec_b = codec.decode_batch(er, chunks).cpu().numpy()
        dec_p = codec.decode_planar(er, codec.to_planar(chunks)).to_batch()
        if not (np.array_equal(dec_b, full[:, list(er), :])
                and np.array_equal(dec_p.cpu().numpy(), dec_b)):
            raise AssertionError(f"{label}: decode {er} wrong")
    obj = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    enc = codec.encode(range(12), obj)
    cenc = codec_cpu.encode(range(12), obj)
    if any(not np.array_equal(enc[i], cenc[i]) for i in range(12)):
        raise AssertionError(f"{label}: encode differs from plain version")
    avail = {i: c for i, c in enc.items() if i not in (0, 5, 9, 11)}
    if codec.decode_concat(avail)[:len(obj)] != obj:
        raise AssertionError(f"{label}: decode_concat wrong")
    log(f"codec: {label} byte and planar encode/decode of 64x8x4096 B "
        "agree with each other and the plain version; a 1 MiB object "
        "round-trips")


def phase_wide_tick(codec, codec_cpu):
    from ceph_tpu_torch.ec import stripe

    sinfo = stripe.StripeInfo(8, codec.stripe_unit(4096))
    byte_tick(codec, codec_cpu, sinfo, tick_datas(SEED + 10 + codec.w),
              f"reed_sol_van k8m4 w={codec.w}", [(3,), (0, 6, 9, 11)],
              (1, 9))


def phase_one_launch(codec, data):
    """One warm cauchy ``encode_planar`` call under torch.profiler: exactly
    one device kernel, B2's staged kernel, and no ``pack_blocks_kernel``
    (the codec passes its cached host-packed table)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pb = codec.to_planar(torch.from_numpy(data).cuda())
    codec.encode_planar(pb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        codec.encode_planar(pb)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    log(f"one launch: a cauchy encode_planar call ran {len(names)} device "
        f"kernel(s): {names}")
    if len(names) != 1 or "BytesPolicy" not in names[0] \
            or any("pack_blocks" in nm for nm in names):
        raise AssertionError("a cauchy encode_planar call is not one launch "
                             f"of B2's staged kernel: {names}")


def _bound(nbytes: int, xors: float):
    """(bound ms, "bytes" or "operations") for a kernel call that must
    move ``nbytes`` and do ``xors`` 32-bit XORs."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = xors / OPS_32BIT_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), bytes_ms, ops_ms


def time_encode_step(codec, data, flush, label: str, card: str) -> float:
    """The encode step of one path on device-resident data, split into
    to_planar, encode_planar and to_batch; returns the step's ms."""
    import torch

    data_dev = torch.from_numpy(data).cuda()
    enc_ms = cuda_median_ms(
        lambda: codec.encode_planar(codec.to_planar(data_dev)).to_batch(), 10,
        flush, STEP_SPIN_CYCLES)
    pb = codec.to_planar(data_dev)
    enc_planar_ms = cuda_median_ms(lambda: codec.encode_planar(pb), 20, flush)
    to_planar_ms = cuda_median_ms(lambda: codec.to_planar(data_dev), 10, flush,
                                  STEP_SPIN_CYCLES)
    par = codec.encode_planar(pb)
    to_batch_ms = cuda_median_ms(
        lambda: par.with_planes(par.planes).to_batch(), 10, flush,
        STEP_SPIN_CYCLES)
    step_bytes = data.size
    log(f"timing: {label} encode step (to_planar + encode_planar + to_batch,"
        f" device-resident {step_bytes} B) {enc_ms:.6f} ms = "
        f"{step_bytes / enc_ms / 1e6:.3f} GB/s; encode_planar alone "
        f"{enc_planar_ms:.6f} ms = {step_bytes / enc_planar_ms / 1e6:.3f} GB/s;"
        f" to_planar alone {to_planar_ms:.6f} ms; parity to_batch alone "
        f"{to_batch_ms:.6f} ms [{card}]")
    return enc_ms


class CleanL2Flush:
    """An L2 flush that leaves the cache clean: it writes 256 MiB, then
    reads 128 MiB, so the timed call finds no dirty lines of the flush to
    write back.  (The plain flush, ``zero_`` of 256 MiB, leaves the L2
    full of dirty lines, and every call timed after it pays for writing
    back as many as its own traffic evicts.)"""

    def __init__(self):
        import torch

        self.dirty = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.clean = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def zero_(self):
        self.dirty.zero_()
        self.clean.max()


def phase_clean_l2(isa, cauchy, card: str):
    """The yardstick, B1 and B2 at their headline shapes again, timed after
    the clean flush."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda, gf8_cuda

    rng = np.random.default_rng(SEED + 7)
    a = torch.from_numpy(
        rng.integers(0, 256, (64, 262144), dtype=np.uint8)).cuda()
    o = torch.empty((32, 262144), dtype=torch.uint8, device="cuda")
    lane, blocks = cauchy._lane_and_blocks(cauchy._encode_bits())
    bm = isa.engine._enc_bitmat
    flush = CleanL2Flush()
    yard = cuda_median_ms(lambda: torch.bitwise_xor(a[:32], a[32:], out=o),
                          50, flush)
    b1 = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, a), 50, flush)
    b2 = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, a, blocks), 50, flush)
    log(f"timing: after a flush that leaves the L2 clean: yardstick "
        f"{yard:.6f} ms, B1 {b1:.6f} ms, B2 {b2:.6f} ms [{card}]")


def phase_yardstick(card: str) -> float:
    """The same traffic as B1 and B2 at their headline shapes, by one
    PyTorch call: ``torch.bitwise_xor`` of the two (32, 262144) halves of
    a (64, 262144) uint8 tensor into (32, 262144), 16 MiB read and 8 MiB
    written; not the kernels' function, only what bandwidth the card
    reaches for this traffic."""
    import torch

    rng = np.random.default_rng(SEED + 6)
    a = torch.from_numpy(
        rng.integers(0, 256, (64, 262144), dtype=np.uint8)).cuda()
    o = torch.empty((32, 262144), dtype=torch.uint8, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(lambda: torch.bitwise_xor(a[:32], a[32:], out=o), 50,
                        flush)
    nbytes = 3 * o.numel()
    log(f"timing: same-traffic yardstick, torch.bitwise_xor (64x262144 ->"
        f" 32x262144 uint8, {nbytes} bytes) median {ms:.6f} ms = "
        f"{nbytes / ms / 1e6:.3f} GB/s [{card}]")
    return ms


def phase_timing(codec, data, card: str, yard_ms: float):
    """B1 at the ISA headline shape, and the ISA encode step; returns the
    kernel's numbers."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rng = np.random.default_rng(SEED + 2)
    bm = codec.engine._enc_bitmat
    rw, kw = (int(x) for x in bm.shape)
    npk = 4096 * 512 // 8                # packed columns of one step
    planes = torch.from_numpy(
        rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, planes), 50, flush)
    plain_ms = cuda_median_ms(
        lambda: gf8_cuda.planar_matmul_ref(bm, planes), 10, flush)
    dev_ms = profiled_kernel_ms(lambda: gf8_cuda.planar_matmul(bm, planes),
                                "PlanarPolicy", 30, flush)
    nbytes = kw * npk + rw * npk + rw * kw
    xors = int(bm.sum().item()) * npk / 4        # 32-bit XORs
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
    log(f"timing: B1 headline ({rw}x{kw} x {kw}x{npk}) median {ms:.6f} ms, "
        f"plain version {plain_ms:.6f} ms, bound {bound_ms:.6f} ms"
        f" ({nbytes} bytes -> {bytes_ms:.6f} ms; {xors:.0f} XORs -> "
        f"{ops_ms:.6f} ms), {100 * bound_ms / ms:.1f} % of the bound; "
        f"same-traffic yardstick {yard_ms:.6f} ms; profiler device time of "
        "the kernel alone "
        + ("not measured" if dev_ms is None else f"{dev_ms:.6f} ms")
        + f" [{card}]")
    time_encode_step(codec, data, flush, "ISA k8m4", card)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_timing_b1_shapes(shapes, card: str):
    """B1 at the w=16, w=32 and SHEC encode shapes with 16 MiB of input
    planes each, L2 flushed as in phase_timing; returns one dict per
    shape."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda

    rng = np.random.default_rng(SEED + 11)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for label, bm in shapes:
        rw, kw = (int(x) for x in bm.shape)
        npk = (16 << 20) // kw
        planes = torch.from_numpy(
            rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
        path = b1_expected_path(rw, kw, npk)
        ms = cuda_median_ms(lambda: gf8_cuda.planar_matmul(bm, planes), 50,
                            flush)
        plain_ms = cuda_median_ms(
            lambda: gf8_cuda.planar_matmul_ref(bm, planes), 5, flush)
        nbytes = kw * npk + rw * npk + rw * kw
        bits = int(bm.sum().item())
        xors = bits * npk / 4
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
        log(f"timing: B1 {label} ({rw}x{kw} x {kw}x{npk}, {bits} set bits, "
            f"{path} path) median {ms:.6f} ms, plain version "
            f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({nbytes} bytes -> "
            f"{bytes_ms:.6f} ms; {xors:.0f} XORs -> {ops_ms:.6f} ms), "
            f"{100 * bound_ms / ms:.1f} % of the bound [{card}]")
        out.append({"shape": label, "path": path, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
    return out


def phase_timing_b2(codec, data, card: str, yard_ms: float):
    """B2 at the cauchy headline lane shape, as the codec calls it (with
    its host-packed table), and the cauchy encode step; returns the
    kernel's numbers."""
    import torch

    from ceph_tpu_torch.ops import gf8_bytes_cuda

    rng = np.random.default_rng(SEED + 3)
    m01 = codec._encode_bits()
    lane, blocks = codec._lane_and_blocks(m01)
    rw, kw = (int(x) for x in lane.shape)
    n = HEADLINE_STRIPES * codec.packetsize   # packet-row bytes of one step
    rows = torch.from_numpy(
        rng.integers(0, 256, (kw // 8, n), dtype=np.uint8)).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks), 50,
        flush)
    plain_ms = cuda_median_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul_ref(lane, rows), 10, flush)
    dev_ms = profiled_kernel_ms(
        lambda: gf8_bytes_cuda.bitmatrix_matmul(lane, rows, blocks),
        "BytesPolicy", 30, flush)
    # the table is r*k block words and class entries, read once
    nbytes = (kw // 8) * n + (rw // 8) * n + int(blocks.numel()) * 8
    xors = int(m01.sum()) * n / 4                # 32-bit XORs of whole rows
    bound_ms, bound_by, bytes_ms, ops_ms = _bound(nbytes, xors)
    log(f"timing: B2 headline lane ({rw}x{kw} x {kw // 8}x{n}, host table) "
        f"median {ms:.6f} ms, plain version {plain_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({nbytes} bytes -> {bytes_ms:.6f} ms; "
        f"{xors:.0f} XORs -> {ops_ms:.6f} ms), "
        f"{100 * bound_ms / ms:.1f} % of the bound; same-traffic yardstick "
        f"{yard_ms:.6f} ms; profiler device time of the kernel alone "
        + ("not measured" if dev_ms is None else f"{dev_ms:.6f} ms")
        + f" [{card}]")
    time_encode_step(codec, data, flush, "cauchy_good k8m4 packetsize 2048",
                     card)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# -- placement: CRUSH and the OSDMap placement pipeline ----------------------

# bench_map's map (ceph_tpu/crush/__init__.py): root -> 39 racks -> 16
# hosts -> 16 osds, straw2 buckets and optimal tunables, 9,984 OSDs
RACKS, HOSTS_PER_RACK, OSDS_PER_HOST = 39, 16, 16
PLACEMENT_PGS = 1 << 20
LRC_PGS = CHOOSE_ARGS_PGS = CPU_CHECK_PGS = 1 << 16
BENCH_PGS = 1_000_000
SAMPLE = 2000
LRC_RULE_PROFILE = {**LRC_PROFILE, "crush-locality": "rack",
                    "crush-failure-domain": "host"}


def host_of(osd):
    return osd // OSDS_PER_HOST


def rack_of(osd):
    return osd // (OSDS_PER_HOST * HOSTS_PER_RACK)


def placement_maps():
    """The replicated pool (a), the LRC pool (b) and the balancer weight
    set (c) on bench_map's map, and the second map of the rebalance:
    one host's 16 OSDs marked out and one further OSD marked down."""
    import copy

    from ceph_tpu_torch.crush.types import ChooseArg, build_three_level
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.osdmap.osdmap import (POOL_TYPE_ERASURE, OSDMap,
                                              PGPool)

    cmap, rule = build_three_level(RACKS, HOSTS_PER_RACK, OSDS_PER_HOST,
                                   numrep=3)
    lrc = factory(LRC_RULE_PROFILE)
    lrc_rule = lrc.create_rule("lrc_k4m2l3", cmap)
    c1 = c1_rule(cmap)
    root = min(cmap.buckets)
    rack_w = cmap.buckets[root].weights
    rng = np.random.default_rng(SEED + 20)
    cmap.choose_args["balancer"] = {root: ChooseArg(weight_set=[
        [int(w * f) for w, f in zip(rack_w, rng.uniform(0.5, 1.5, RACKS))]
        for _ in range(3)])}
    m = OSDMap(cmap)
    m.add_pool(PGPool(pool_id=1, size=3, min_size=2, pg_num=PLACEMENT_PGS,
                      pgp_num=PLACEMENT_PGS, crush_rule=rule, name="rbd"))
    m.add_pool(PGPool(pool_id=2, type=POOL_TYPE_ERASURE,
                      size=lrc.get_chunk_count(), min_size=5, pg_num=LRC_PGS,
                      pgp_num=LRC_PGS, crush_rule=lrc_rule, name="lrc",
                      ec_profile=dict(LRC_RULE_PROFILE)))
    m2 = copy.deepcopy(m)
    out_host = int(rng.integers(0, RACKS * HOSTS_PER_RACK))
    for osd in range(out_host * OSDS_PER_HOST,
                     (out_host + 1) * OSDS_PER_HOST):
        m2.mark_out(osd)
    down = int((out_host + 1) * OSDS_PER_HOST + rng.integers(0, 64))
    m2.mark_down(down)
    log(f"placement: {cmap.max_devices} OSDs, {len(cmap.buckets)} buckets "
        f"(max depth {cmap.max_depth()}); pool 1 replicated size 3 "
        f"pg_num {PLACEMENT_PGS} (rule {cmap.rules[rule].steps}); pool 2 "
        f"LRC k4m2l3 size {lrc.get_chunk_count()} pg_num {LRC_PGS} (rule "
        f"{cmap.rules[lrc_rule].steps}); rebalance: host {out_host} out, "
        f"osd {down} down; C1 rule {cmap.rules[c1].steps}")
    return m, m2, rule, c1


def phase_placement(m, m2, rule):
    """The placement main path on the card: (a) the whole
    replicated pool and its rebalance diff, (b) the LRC pool, (c) the
    replicated rule under the balancer weight set."""
    import torch

    up, upp = m.pool_mapping(1)
    moved, frac = m.rebalance_diff(1, m2)
    lrc_up, lrc_upp = m.pool_mapping(2)
    pps = m.pools[1].raw_pg_to_pps_batch(
        np.arange(CHOOSE_ARGS_PGS, dtype=np.uint32))
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    ca_res, ca_len = m.tensor_mapper.do_rule_batch(
        rule, pps, 3, weights, choose_args="balancer")
    torch.cuda.synchronize()
    if m.tensor_mapper.device.type != "cuda" or \
            m2.tensor_mapper.device.type != "cuda":
        raise AssertionError("placement did not run on the card")
    log(f"placement: rebalance_diff moved {len(moved)} of {PLACEMENT_PGS} "
        f"PGs ({frac:.6f})")
    return {"up": up, "upp": upp, "moved": moved, "frac": frac,
            "lrc_up": lrc_up, "lrc_upp": lrc_upp, "pps": pps,
            "ca_res": ca_res.cpu().numpy(), "ca_len": ca_len.cpu().numpy()}


def scalar_row(m, pool_id, seed):
    """The full scalar chain's up set (padded as pool_mapping pads it) and
    up primary for one PG."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osdmap.osdmap import PGid

    u, p, _a, _ap = m.pg_to_up_acting_osds(PGid(pool_id, seed))
    return list(u) + [CRUSH_ITEM_NONE] * (m.pools[pool_id].size - len(u)), p


_SCALAR_MAP = None


def _scalar_rows_init(blob: bytes) -> None:
    global _SCALAR_MAP
    _SCALAR_MAP = pickle.loads(blob)


def _scalar_rows(args):
    pool_id, seeds = args
    return [scalar_row(_SCALAR_MAP, pool_id, s) for s in seeds]


def scalar_rows(m, pool_id, seeds):
    """``scalar_row`` for every seed, spread over the host's cores (the
    scalar chain takes milliseconds a PG where tries run out) by a pool
    of spawned workers that ends with the call."""
    import multiprocessing
    import os

    n = max(1, min(8, os.cpu_count() or 1))
    chunks = [c.tolist() for c in np.array_split(np.asarray(seeds), 4 * n)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n, initializer=_scalar_rows_init,
                  initargs=(pickle.dumps(m),)) as workers:
        parts = workers.map(_scalar_rows, [(pool_id, c) for c in chunks])
    return [row for part in parts for row in part]


def check_placement(m, m2, rule, got):
    """Every check of the placement path, each a hard failure."""
    from ceph_tpu_torch.crush import ScalarMapper
    from ceph_tpu_torch.crush.mapper import TensorMapper
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    for mp in (m, m2):
        if mp.scalar_fallbacks:
            raise AssertionError("a pool mapped on the scalar path")
    up, lrc_up = got["up"], got["lrc_up"]
    # (a) with every OSD up and in: three OSDs on three hosts per PG
    if (up == CRUSH_ITEM_NONE).any():
        raise AssertionError("a replicated PG has fewer than 3 OSDs")
    hosts = np.sort(host_of(up), axis=1)
    if ((hosts[:, 1:] == hosts[:, :-1]).any()):
        raise AssertionError("a replicated PG has two OSDs on one host")
    # (b) eight OSDs on eight hosts, four in each of two racks
    if (lrc_up == CRUSH_ITEM_NONE).any():
        raise AssertionError("an LRC PG has fewer than 8 OSDs")
    lh = np.sort(host_of(lrc_up), axis=1)
    racks = rack_of(lrc_up)
    if (lh[:, 1:] == lh[:, :-1]).any() or \
            (racks[:, :4] != racks[:, :1]).any() or \
            (racks[:, 4:] != racks[:, 4:5]).any() or \
            (racks[:, 0] == racks[:, 4]).any():
        raise AssertionError("an LRC PG is not 4+4 hosts in two racks")
    # (c) three OSDs on three hosts per PG
    ca_res, ca_len = got["ca_res"], got["ca_len"]
    ca_hosts = np.sort(host_of(ca_res), axis=1)
    if (ca_len != 3).any() or (ca_hosts[:, 1:] == ca_hosts[:, :-1]).any():
        raise AssertionError("a choose_args PG is short or shares a host")
    # samples against the scalar chain
    for label, pool_id, rows, prim in (("replicated", 1, up, got["upp"]),
                                       ("LRC", 2, lrc_up, got["lrc_upp"])):
        seeds = rng.choice(m.pools[pool_id].pg_num, SAMPLE, replace=False)
        for s in seeds:
            want, p = scalar_row(m, pool_id, int(s))
            if rows[s].tolist() != want or int(prim[s]) != p:
                raise AssertionError(
                    f"{label} PG {s}: card {rows[s].tolist()} "
                    f"{int(prim[s])}, scalar chain {want} {p}")
    sm = ScalarMapper(m.crush)
    weights = list(m.osd_weight)
    for i in rng.choice(CHOOSE_ARGS_PGS, SAMPLE, replace=False):
        want = sm.do_rule(rule, int(got["pps"][i]), 3, weights,
                          choose_args="balancer")
        if ca_res[i, :ca_len[i]].tolist() != want:
            raise AssertionError(f"choose_args PG {i} differs from scalar")
    moved = set(got["moved"].tolist())
    for s in rng.choice(PLACEMENT_PGS, SAMPLE, replace=False):
        s = int(s)
        if (scalar_row(m, 1, s)[0] != scalar_row(m2, 1, s)[0]) != \
                (s in moved):
            raise AssertionError(f"rebalance_diff wrong about PG {s}")
    # the first PGs against the port's mapper on the CPU
    cpu = TensorMapper(m.crush, device="cpu")
    card = m.tensor_mapper
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    pps = got["pps"][:CPU_CHECK_PGS]
    c_res, c_len = cpu.do_rule_batch(rule, pps, 3, weights)
    g_res, g_len = card.do_rule_batch(rule, pps, 3, weights)
    if not (np.array_equal(c_res.numpy(), g_res.cpu().numpy())
            and np.array_equal(c_len.numpy(), g_len.cpu().numpy())
            and np.array_equal(c_res.numpy(), up[:CPU_CHECK_PGS])):
        raise AssertionError("the card's placement differs from the CPU's")
    log(f"placement: checks pass in {time.perf_counter() - t0:.3f} s: "
        f"{SAMPLE} PGs each of the replicated pool, the LRC pool, the "
        f"choose_args batch and the rebalance diff equal the scalar chain; "
        f"the first {CPU_CHECK_PGS} PGs equal TensorMapper(device='cpu'); "
        "every PG on distinct hosts (LRC: 4+4 in two racks)")


# C1 (a chooseleaf indep type-0 slot that runs out of tries keeps its
# last out device): the OSDMap repro's shape, where it fires on every PG,
# and the same rule as an erasure pool of the 9,984-OSD map
C1_SMALL_PGS = 16_384
C1_PGS = 1 << 16
C1_SIZE = 7
# the balancer scorer round: a replicated size-3 pool on the 9,984-OSD
# map with the mgr's defaults (ceph_tpu/utils/config.py:233-238), and the
# card against device="cpu" on a 1,024-OSD map
SCORER_PGS = 1 << 16
SCORER_MOVES = 16
SCORER_DEVIATION = 0.05
SCORER_SAMPLE = 1_000_000
SMALL_SCORER_MAP = (4, 16, 16)
SMALL_SCORER_PGS = 8192


def c1_rule(cmap) -> int:
    """ROADMAP §C1's rule: ``chooseleaf indep 0 type 0`` from the root,
    with 5 leaf tries and 100 tries."""
    from ceph_tpu_torch.crush import Rule
    from ceph_tpu_torch.crush.types import (RULE_CHOOSELEAF_INDEP,
                                            RULE_EMIT,
                                            RULE_SET_CHOOSE_TRIES,
                                            RULE_SET_CHOOSELEAF_TRIES,
                                            RULE_TAKE)

    return cmap.add_rule(Rule(steps=[
        (RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0),
        (RULE_TAKE, min(cmap.buckets), 0), (RULE_CHOOSELEAF_INDEP, 0, 0),
        (RULE_EMIT, 0, 0)]))


def phase_c1(m2, big_rule):
    """C1 on the card: (a) ROADMAP's OSDMap repro at 16,384 PGs, every PG
    against the scalar chain; (b) the same rule as an erasure pool of the
    9,984-OSD map with one host out (``m2``), sampled PGs against the
    scalar chain.  Returns the PGs of (a) and (b) with an out OSD in
    their up set."""
    import torch

    from ceph_tpu_torch.osdmap.osdmap import (POOL_TYPE_ERASURE, PGPool,
                                              build_simple_osdmap)

    t0 = time.perf_counter()
    small = build_simple_osdmap(8, 4, C1_SMALL_PGS, POOL_TYPE_ERASURE,
                                C1_SIZE)
    small.pools[1].crush_rule = c1_rule(small.crush)
    small.mark_out(1)
    small.mark_out(5)
    up, upp = small.pool_mapping(1)
    m2.add_pool(PGPool(pool_id=3, type=POOL_TYPE_ERASURE, size=C1_SIZE,
                       min_size=5, pg_num=C1_PGS, pgp_num=C1_PGS,
                       crush_rule=big_rule, name="c1"))
    big_up, big_upp = m2.pool_mapping(3)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for mp in (small, m2):
        if mp.tensor_mapper.device.type != "cuda" or mp.scalar_fallbacks:
            raise AssertionError("C1 placement did not run on the card")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    for label, mp, pool_id, rows, prim, seeds in (
            ("C1 repro", small, 1, up, upp, np.arange(C1_SMALL_PGS)),
            ("C1 pool", m2, 3, big_up, big_upp,
             rng.choice(C1_PGS, SAMPLE, replace=False))):
        for s, (want, p) in zip(seeds, scalar_rows(mp, pool_id, seeds)):
            if rows[s].tolist() != want or int(prim[s]) != p:
                raise AssertionError(
                    f"{label} PG {s}: card {rows[s].tolist()} "
                    f"{int(prim[s])}, scalar chain {want} {p}")
    out_small = int(np.isin(up, [1, 5]).any(axis=1).sum())
    out_big = np.flatnonzero(np.asarray(m2.osd_weight) == 0)
    out_big = int(np.isin(big_up, out_big).any(axis=1).sum())
    log(f"C1: repro pool ({C1_SMALL_PGS} PGs, size {C1_SIZE}, 8 OSDs, "
        f"OSDs 1 and 5 out): every PG equals the scalar chain, "
        f"{out_small} PGs keep an out OSD; 9,984-OSD pool ({C1_PGS} PGs, "
        f"one host out): {SAMPLE} sampled PGs equal the scalar chain, "
        f"{out_big} PGs keep an out OSD; card {card_s:.3f} s, checks "
        f"{time.perf_counter() - t0:.3f} s")
    return out_small, out_big


def energy(stats) -> float:
    """The balance energy the scorer descends: sum((count - target)^2)."""
    return float(np.sum((stats.counts - stats.target) ** 2))


def scorer_map(cmap, rule, pg_num, device=None):
    from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGPool

    m = OSDMap(cmap, device=device)
    m.add_pool(PGPool(pool_id=4, size=3, min_size=2, pg_num=pg_num,
                      pgp_num=pg_num, crush_rule=rule, name="balance"))
    return m


def phase_scorer(cmap, rule, reset_counts):
    """The scorer round on the card: ``calc_pg_upmaps_vectorized`` with the
    mgr's defaults on a replicated pool of the 9,984-OSD map, counted
    from 0 just before and read just after.  Returns what the checks
    need."""
    import copy

    import torch

    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.utils.perf import KERNELS

    m = scorer_map(cmap, rule, SCORER_PGS)
    split = copy.deepcopy(m)
    before = scorer.deviation_stats(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    changes, scored = scorer.calc_pg_upmaps_vectorized(
        m, max_deviation_ratio=SCORER_DEVIATION, max_moves=SCORER_MOVES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = KERNELS.dump()["device_kernels"]
    peak = torch.cuda.max_memory_allocated()
    log(f"main path (balance scorer): counters "
        f"{json.dumps(counts, sort_keys=True)}")
    if m.tensor_mapper.device.type != "cuda":
        raise AssertionError("the scorer round did not run on the card")
    n = counts.get("balance_candidates_scored", 0)
    if n < 1000 or n != scored or counts.get("balance_score_calls", 0) < 1:
        raise AssertionError(f"the scorer round counted {n} candidates "
                             f"({scored} reported)")
    log(f"scorer: round on {cmap.max_devices} OSDs, pool of {SCORER_PGS} "
        f"PGs: {n} candidates scored in "
        f"{counts['balance_score_calls']} call(s), "
        f"{sum(len(v) for v in changes.values())} moves, wall "
        f"{wall * 1e3:.3f} ms, peak device memory {peak / 2**30:.3f} GiB")
    return m, split, before, changes, scored


def check_scorer(m, split, before, changes, rule, card: str):
    """The scorer round's checks, and its split on a fresh copy of the
    map: measurement, enumeration, scoring, sort and pick, each ended by
    a synchronise; the device scores of sampled candidates against the
    plain float64 formula, bit for bit."""
    import torch

    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.osdmap.balancer import _failure_domains

    moves = [(pg.seed, s, d) for pg, v in changes.items() for s, d in v]
    if not 0 < len(moves) <= SCORER_MOVES or \
            any(len(v) != 1 for v in changes.values()):
        raise AssertionError(f"the round made {len(moves)} moves: {changes}")
    dom = _failure_domains(m, rule)
    up0 = before.placements[4]
    for seed, src, dst in moves:
        members = [int(o) for o in up0[seed]]
        others = {dom[o] for o in members if o != src}
        if src not in members or dst in members or dom[dst] in others:
            raise AssertionError(f"illegal move of PG {seed}: {src}->{dst}"
                                 f" with members {members}")
    after = scorer.deviation_stats(m)
    e0, e1 = energy(before), energy(after)
    if not e1 < e0:
        raise AssertionError(f"the moves did not lower the energy: {e0} "
                             f"-> {e1}")
    log(f"scorer: {len(moves)} legal moves, one per PG; sum((count - "
        f"target)^2) {e0:.6f} -> {e1:.6f} under a fresh pool_mapping")

    sync = torch.cuda.synchronize
    times = {}

    def timed(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[label] = time.perf_counter() - t0
        return out

    st = timed("measurement", lambda: scorer.deviation_stats(split))
    domains = {4: _failure_domains(split, rule)}
    cand = timed("enumeration", lambda: scorer.generate_candidates(
        split, st, domains, SCORER_DEVIATION))
    scores = timed("scoring", lambda: scorer.score_candidates(st, cand))
    timed("sort alone", lambda: scorer.sorted_order(scores))
    picked = timed("pick (its sort and walk)",
                   lambda: scorer._pick_moves(st, cand, scores,
                                              SCORER_MOVES))
    if picked != [(pg.pool, pg.seed, s, d) for pg, v in changes.items()
                  for s, d in v]:
        raise AssertionError("the split run picked other moves")
    if not isinstance(scores, torch.Tensor) or not scores.is_cuda:
        raise AssertionError("the scores were not computed on the card")
    n = len(cand)
    rng = np.random.default_rng(SEED + 30)
    idx = np.unique(rng.integers(0, n, SCORER_SAMPLE + SCORER_SAMPLE // 10))
    if n >= SCORER_SAMPLE + SCORER_SAMPLE // 10:
        idx = idx[:SCORER_SAMPLE]
    it = torch.from_numpy(idx).cuda()
    sample = scorer.CandidateSet(*(a[it].cpu().numpy()
                                   for a in vars(cand).values()))
    plain = scorer.score_candidates(st, sample, engine="numpy")
    got = scores[it].cpu().numpy()
    if not np.array_equal(got.view(np.int64), plain.view(np.int64)):
        raise AssertionError("device scores differ from the plain formula")
    total = sum(times.values()) - times["sort alone"]
    log(f"scorer: {len(idx)} sampled device scores equal the plain float64 "
        f"formula bit for bit; {n} candidates")
    log("scorer: split of one round on a fresh copy: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in times.items())
        + f"; total {total * 1e3:.3f} ms [{card}]")


def phase_scorer_small():
    """The card's scorer against device="cpu" (the plain loops) on a
    1,024-OSD map: equal candidate sets and equal changes."""
    from ceph_tpu_torch.balance import scorer
    from ceph_tpu_torch.crush.types import build_three_level
    from ceph_tpu_torch.osdmap.balancer import _failure_domains

    t0 = time.perf_counter()
    cmap, rule = build_three_level(*SMALL_SCORER_MAP, numrep=3)
    maps = [scorer_map(cmap, rule, SMALL_SCORER_PGS, device=d)
            for d in (None, "cpu")]
    cands, results = [], []
    for m, engine in zip(maps, ("device", "numpy")):
        st = scorer.deviation_stats(m)
        cand = scorer.generate_candidates(
            m, st, {4: _failure_domains(m, rule)}, SCORER_DEVIATION)
        if isinstance(cand.src, np.ndarray) != (engine == "numpy"):
            raise AssertionError(f"the map on {m.device} did not run the "
                                 f"{engine} engine")
        cands.append([np.asarray(a.cpu() if engine == "device" else a)
                      for a in vars(cand).values()])
        results.append(scorer.calc_pg_upmaps_vectorized(
            m, max_deviation_ratio=SCORER_DEVIATION, max_moves=SCORER_MOVES))
    if not all(np.array_equal(a, b) for a, b in zip(*cands)):
        raise AssertionError("the card's candidates differ from the CPU's")
    (ch, n), (cch, cn) = results
    if ch != cch or n != cn or not ch:
        raise AssertionError(f"the card's changes differ from the CPU's: "
                             f"{ch} / {cch}")
    log(f"scorer: {cmap.max_devices} OSDs, {SMALL_SCORER_PGS} PGs: card and "
        f"device='cpu' give the same {len(cands[0][0])} candidates in the "
        f"same order and the same {sum(len(v) for v in ch.values())} moves "
        f"({n} candidates scored); {time.perf_counter() - t0:.3f} s")


# -------------------------------------------------------------------- mesh

MESH_STRIPES, MESH_CHUNK = 4096, 512
MESH_PATTERNS = [(0,), (5,), (8,), (11,), (0, 11), (2, 3), (9, 10),
                 (0, 4, 8), (1, 2, 3, 9)]
MESH_RMW_START, MESH_RMW_WIDTH = 128, 256


def mesh_case():
    """Every visible card when there are two or more; otherwise eight
    slots of ``cuda:0`` (a ``(2, 4)`` mesh whose copies between slots are
    no-ops, so the split and gather code still runs on the card).
    Returns the ``devices=`` argument for ``make_mesh`` (None: all cards)
    and a description of the case."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return None, f"{n} cards, one slot each"
    return ["cuda:0"] * 8, "one card: 8 slots of cuda:0"


def sync_all(devices) -> None:
    import torch

    for d in devices:
        torch.cuda.synchronize(d)


def mesh_median_ms(fn, devices, reps: int, spin=SPIN_CYCLES) -> float:
    """``cuda_median_ms`` over several cards: a spin and a start event on
    every device before the call, an end event on each after it; a call
    takes the longest of its devices' start-to-end times."""
    import torch

    fn()
    sync_all(devices)
    times = []
    for _ in range(reps):
        starts = []
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(spin)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
        fn()
        ends = []
        for d in devices:
            with torch.cuda.device(d):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ends.append(ev)
        for ev in ends:
            ev.synchronize()
        times.append(max(s.elapsed_time(e) for s, e in zip(starts, ends)))
    return statistics.median(times)


def mesh_reference(m, rule):
    """The single-device placement of the 1,000,000 ``BENCH_PGS`` the
    sharded placement is held to (computed outside the mesh's counted
    window)."""
    xs = np.arange(BENCH_PGS, dtype=np.uint32)
    weights = np.asarray(m.osd_weight, dtype=np.uint32)
    res, lens = m.tensor_mapper.do_rule_batch(rule, xs, 3, weights)
    return xs, weights, res, lens


def phase_mesh(isa, m, rule, ref):
    """The mesh main path on the card, at full width: the sharded EC
    engine (ISA k8m4, 4096 stripes x 8 x 512 B) against the single-device
    codec, ``distributed_ec_step``, the codec adapter on 4095 stripes and
    the sharded placement of 1,000,000 PGs against ``do_rule_batch``."""
    import torch

    from ceph_tpu_torch.parallel import (MeshECEngine, crush_batch_sharded,
                                         distributed_ec_step, make_mesh)
    from ceph_tpu_torch.parallel.engine import MeshCodecAdapter

    t0 = time.perf_counter()
    devices, case = mesh_case()
    mesh = make_mesh(devices=devices)
    distinct = mesh.distinct()
    if any(d.type != "cuda" for d in distinct):
        raise AssertionError(f"the mesh is not on the card: {mesh}")
    log(f"mesh: {torch.cuda.device_count()} CUDA device(s) visible; {case}; "
        f"mesh {mesh.shape} over {[str(d) for d in distinct]}")
    rng = np.random.default_rng(SEED + 30)
    eng = MeshECEngine(mesh, 8, 4, isa.engine.coding)
    data = torch.from_numpy(rng.integers(
        0, 256, (MESH_STRIPES, 8, MESH_CHUNK), dtype=np.uint8)).cuda()
    parity = eng.encode_batch(data)
    single = isa.encode_batch(data)
    if not parity.is_cuda or not torch.equal(parity, single):
        raise AssertionError("mesh encode differs from the codec's")
    chunks = torch.cat([data, single], dim=1)
    for er in MESH_PATTERNS:
        got = eng.decode_batch(er, chunks)
        if not torch.equal(got, isa.decode_batch(er, chunks)) or \
                not torch.equal(got, chunks[:, list(er)]):
            raise AssertionError(f"mesh decode {er} differs from the codec's")
    update = torch.from_numpy(rng.integers(
        0, 256, (MESH_STRIPES, 8, MESH_RMW_WIDTH), dtype=np.uint8)).cuda()
    got = eng.rmw_batch(chunks, update, MESH_RMW_START)
    patched = data.clone()
    patched[:, :, MESH_RMW_START:MESH_RMW_START + MESH_RMW_WIDTH] = update
    if not torch.equal(got, torch.cat([patched, isa.encode_batch(patched)],
                                      dim=1)):
        raise AssertionError("mesh RMW differs from a full re-encode")
    step, (placed,) = distributed_ec_step(mesh, 8, 4, MESH_STRIPES,
                                          MESH_CHUNK)
    mismatches, step_chunks = step(placed)
    example = eng.gather_stripes(placed)
    if int(mismatches) != 0 or not torch.equal(
            step_chunks, torch.cat([example, isa.encode_batch(example)], 1)):
        raise AssertionError(
            f"distributed_ec_step: {int(mismatches)} mismatches")
    # the adapter pads 4095 stripes to the data axis (two rows or more)
    amesh = make_mesh(devices=devices, shard_axis=1 if devices is None
                      else None)
    adapter = MeshCodecAdapter(isa, amesh)
    odd = data[:MESH_STRIPES - 1]
    pad = (-odd.shape[0]) % amesh.shape["data"]
    if not torch.equal(adapter.encode_batch(odd), isa.encode_batch(odd)) or \
            not torch.equal(adapter.decode_batch((3, 10), chunks[:-1]),
                            chunks[:-1, [3, 10]]):
        raise AssertionError("the mesh codec adapter differs from the codec")
    xs, weights, sres, slens = ref
    res, lens = crush_batch_sharded(mesh, m.tensor_mapper, rule, xs, 3,
                                    weights)
    if not torch.equal(res, sres) or not torch.equal(lens, slens):
        raise AssertionError("crush_batch_sharded differs from do_rule_batch")
    sync_all(distinct)
    log(f"mesh: encode, 9 erasure patterns, RMW at columns "
        f"[{MESH_RMW_START}, {MESH_RMW_START + MESH_RMW_WIDTH}), "
        f"distributed_ec_step (0 mismatches) on {MESH_STRIPES} x 8 x "
        f"{MESH_CHUNK} B equal the single-device codec byte for byte; the "
        f"adapter on mesh {amesh.shape} pads {MESH_STRIPES - 1} stripes by "
        f"{pad} and equals the codec; crush_batch_sharded of {len(xs)} PGs "
        f"over {mesh.devices.size} slots equals do_rule_batch; "
        f"{time.perf_counter() - t0:.3f} s")
    return {"mesh": mesh, "eng": eng, "data": data, "chunks": chunks,
            "slots": mesh.devices.size}


def phase_mesh_timing(isa, m, rule, ref, out, single_s: float, card: str):
    """CUDA-event medians of the mesh encode and a one-erasure decode
    against the single-device codec on the same batch, one profiled call
    of each (device kernels, kernel time, idle share), and the wall
    median of the sharded placement beside ``single_s``, the placement
    timing's median of ``do_rule_batch`` on the same PGs and weights."""
    from ceph_tpu_torch.parallel import crush_batch_sharded

    mesh, eng, data, chunks = out["mesh"], out["eng"], out["data"], \
        out["chunks"]
    devs = mesh.distinct()
    nbytes = data.numel()
    rows = [("encode", lambda: eng.encode_batch(data),
             lambda: isa.encode_batch(data)),
            ("decode (0,)", lambda: eng.decode_batch((0,), chunks),
             lambda: isa.decode_batch((0,), chunks))]
    for label, mesh_fn, single_fn in rows:
        ms = mesh_median_ms(mesh_fn, devs, 20)
        single_ms = cuda_median_ms(single_fn, 20)
        wall = wall_median_s(mesh_fn, 5, devs)
        single_wall = wall_median_s(single_fn, 5)
        log(f"timing: mesh {label} ISA k8m4 {MESH_STRIPES} x 8 x "
            f"{MESH_CHUNK} B on mesh {mesh.shape} ({len(devs)} device(s)): "
            f"CUDA-event median {ms:.6f} ms ({nbytes / ms / 1e6:.3f} GB/s "
            f"of data), single-device codec {single_ms:.6f} ms "
            f"({nbytes / single_ms / 1e6:.3f} GB/s); wall medians "
            f"{wall * 1e3:.3f} ms and {single_wall * 1e3:.3f} ms [{card}]")
        for who, fn, w in (("mesh", mesh_fn, wall),
                           ("single-device", single_fn, single_wall)):
            k, k_ms, dtoh, syncs, pwall, _top = profile_call(fn)
            log(f"timing: mesh {label}, {who} call profiled: {k} device "
                f"kernels, {k_ms:.3f} ms summed kernel time, {dtoh} DtoH "
                f"copies, {syncs} host syncs, {pwall * 1e3:.3f} ms wall; "
                f"device idle share {1 - k_ms / (w * 1e3 * len(devs)):.4f} "
                f"of the wall median summed over {len(devs)} device(s) "
                f"[{card}]")
    xs, weights, _, _ = ref
    if not (weights == 0x10000).all():
        raise AssertionError("the placement timing ran with other weights")
    s = wall_median_s(
        lambda: crush_batch_sharded(mesh, m.tensor_mapper, rule, xs, 3,
                                    weights), 2, devs)
    log(f"timing: mesh crush_batch_sharded {len(xs)} PGs over "
        f"{mesh.devices.size} slots on {len(devs)} device(s): wall median "
        f"{s * 1e3:.3f} ms = {len(xs) / s:.0f} mappings/s; do_rule_batch "
        f"{single_s * 1e3:.3f} ms = {len(xs) / single_s:.0f} mappings/s "
        f"[{card}]")


def phase_loop_slope(codec, kernel_ms: float, card: str):
    """``device_loop_slope`` on B1's headline ISA shape (the L-step chain
    as one CUDA graph), beside the CUDA-event median of phase_timing."""
    import torch

    from ceph_tpu_torch.ops import gf8_cuda
    from ceph_tpu_torch.ops.profiling import device_loop_slope

    rng = np.random.default_rng(SEED + 31)
    bm = codec.engine._enc_bitmat
    npk = 4096 * 512 // 8
    planes = torch.from_numpy(rng.integers(
        0, 256, (int(bm.shape[1]), npk), dtype=np.uint8)).cuda()

    def feedback(d, out):
        d[:1].bitwise_xor_(out[:1])
        return d

    med, best, worst = device_loop_slope(
        lambda d: gf8_cuda.planar_matmul(bm, d), feedback, planes,
        tag="b1_headline")
    log(f"timing: B1 headline device_loop_slope (L1=300, L2=1200, CUDA "
        f"graphs, L2 warm): median {med * 1e3:.6f} ms per step, best "
        f"{best * 1e3:.6f}, worst {worst * 1e3:.6f}; CUDA-event median "
        f"with the L2 flushed {kernel_ms:.6f} ms [{card}]")


def wall_median_s(fn, reps: int = 3, devices=(None,)) -> float:
    """Median host wall time of ``reps`` calls, each bracketed by
    ``torch.cuda.synchronize()`` of every device in ``devices`` (default:
    the current one), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        sync_all(devices)
        t0 = time.perf_counter()
        fn()
        sync_all(devices)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_call(fn):
    """One call under torch.profiler (CUDA activity) and the CUDA sync
    debug mode: (device kernels, summed kernel ms, DtoH copies, host syncs,
    wall s of the profiled call, the four kernel names with the most
    summed time as (name, launches, ms))."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("synchronizing" in str(w.message) for w in syncs)
    kernels, kernel_us, dtoh = 0, 0.0, 0
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("Memcpy"):
            dtoh += "DtoH" in e.name
        elif not e.name.startswith("Memset"):
            us = getattr(e, "device_time", None) or e.cuda_time
            kernels += 1
            kernel_us += us
            n, tot = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, tot + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return (kernels, kernel_us / 1e3, dtoh, n_sync, wall,
            [(name[:90], n, us / 1e3) for name, (n, us) in top])


def phase_placement_timing(m, m2, rule, card: str):
    """Wall times of the placement entry points, and one do_rule_batch
    call profiled at the default chunk and at one chunk for the batch."""
    from ceph_tpu_torch.crush import bench_map
    from ceph_tpu_torch.crush.mapper import TensorMapper

    xs = np.arange(BENCH_PGS, dtype=np.uint32)
    weights = np.full(m.crush.max_devices, 0x10000, dtype=np.uint32)
    mappers = {"default chunk": m.tensor_mapper,
               "one chunk": TensorMapper(m.crush, chunk=BENCH_PGS)}
    out = {}
    for label, mp in mappers.items():
        s = wall_median_s(lambda: mp.do_rule_batch(rule, xs, 3, weights))
        k, k_ms, dtoh, syncs, wall, top = profile_call(
            lambda: mp.do_rule_batch(rule, xs, 3, weights))
        out[label] = s
        log(f"timing: placement do_rule_batch {BENCH_PGS} PGs, "
            f"{label} ({mp.chunk} lanes): median {s * 1e3:.3f} ms = "
            f"{BENCH_PGS / s:.0f} mappings/s; profiled call: {k} device "
            f"kernels, {k_ms:.3f} ms summed kernel time, {dtoh} DtoH "
            f"copies, {syncs} host syncs, {wall * 1e3:.3f} ms wall; device "
            f"idle share {1 - k_ms / (s * 1e3):.4f} of the median call "
            f"[{card}]")
        for name, n, ms in top:
            log(f"timing: placement {label} kernel {name}: {n} launches, "
                f"{ms:.3f} ms ({ms / k_ms:.4f} of kernel time) [{card}]")
    s = wall_median_s(lambda: m.pool_mapping(1))
    log(f"timing: placement pool_mapping pool 1 ({PLACEMENT_PGS} PGs): "
        f"median {s * 1e3:.3f} ms = {PLACEMENT_PGS / s:.0f} mappings/s "
        f"[{card}]")
    s = wall_median_s(lambda: m.rebalance_diff(1, m2))
    log(f"timing: placement rebalance_diff pool 1 (two pool_mappings of "
        f"{PLACEMENT_PGS} PGs): median {s * 1e3:.3f} ms = "
        f"{2 * PLACEMENT_PGS / s:.0f} mappings/s [{card}]")
    rate = bench_map(n_osds=RACKS * 256, n_pgs=BENCH_PGS, iters=3)
    log(f"timing: placement bench_map(n_osds={RACKS * 256}, "
        f"n_pgs={BENCH_PGS}) {rate:.0f} mappings/s [{card}]")
    return out


def card_name() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ops import _build, gf8_bytes_cuda, gf8_cuda
    from ceph_tpu_torch.utils.perf import KERNELS

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(_build.build_logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.3f} s")
    for stem, text in _build.build_logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = ("staged" if "staged_kernel" in line else
                          "pack" if "pack_blocks" in line else "kept")
            elif "registers" in line or "spill" in line:
                log(f"build: {stem} {kernel} kernel: {line.strip()}")
    card = card_name()
    for name, mod in (("B1", gf8_cuda), ("B2", gf8_bytes_cuda)):
        ctas, threads, smem = mod.staged_config()
        log(f"build: {name} staged kernel: persistent grid of {ctas} CTAs x "
            f"{threads} threads, {smem} bytes of dynamic shared memory per "
            "CTA")
    rng = np.random.default_rng(SEED)
    isa = factory({"plugin": "isa", "k": "8", "m": "4"})
    cauchy = factory(CAUCHY_PROFILE)
    shec, shec_cpu = (factory(SHEC_PROFILE, device=d) for d in (None, "cpu"))
    lrc, lrc_cpu = (factory(LRC_PROFILE, device=d) for d in (None, "cpu"))
    wide = {w: tuple(factory({**WIDE_PROFILE, "w": str(w)}, device=d)
                     for d in (None, "cpu")) for w in (16, 32)}
    for codec in [isa, cauchy, shec, lrc] + [c for c, _ in wide.values()]:
        assert codec.device.type == "cuda"
    assert {layer.erasure_code.device.type for layer in lrc.layers} == \
        {"cuda"}
    b1_err = phase_kernel(isa, rng)
    b1_err = max(b1_err, phase_kernel_b1_codecs(
        shec, lrc, [c for c, _ in wide.values()], rng))
    b2_err = phase_kernel_b2(cauchy, rng)

    def reset_counts():
        for mod in (gf8_cuda, gf8_bytes_cuda):
            mod.launches = 0
            mod.kept_launches = 0
        KERNELS.reset()

    def path_counts(name, mod):
        return (f"{name} launches {mod.launches} ({mod.launches - mod.kept_launches}"
                f" staged, {mod.kept_launches} kept)")

    # main path of the ISA slice: counts from 0 just before, read just after
    reset_counts()
    data = phase_codec(isa, rng)
    phase_stripe(isa)
    torch.cuda.synchronize()
    b1_launches = gf8_cuda.launches
    isa_kept = gf8_cuda.kept_launches + gf8_bytes_cuda.kept_launches
    log(f"main path (ISA): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
    if b1_launches <= 0:
        raise AssertionError("the ISA path never launched kernel B1")
    if isa_kept:
        raise AssertionError("an ISA main-path launch took the kept path")

    # main path of the jerasure slice
    reset_counts()
    cdata = phase_codec_cauchy(cauchy, rng)
    phase_stripe_cauchy(cauchy)
    phase_default_profile_tick()
    torch.cuda.synchronize()
    b2_launches = gf8_bytes_cuda.launches
    j_b1 = gf8_cuda.launches
    j_kept = gf8_cuda.kept_launches + gf8_bytes_cuda.kept_launches
    log(f"main path (jerasure): {path_counts('B2', gf8_bytes_cuda)}, "
        f"{path_counts('B1', gf8_cuda)}; counters "
        f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
    if b2_launches <= 0:
        raise AssertionError("the jerasure path never launched kernel B2")
    if j_b1 <= 0:
        raise AssertionError("the default-profile tick never launched B1")
    if j_kept:
        raise AssertionError("a jerasure main-path launch took the kept path")
    b1_launches += j_b1

    # the main paths of the erasure-code slice: SHEC planar at rest, LRC
    # and reed_sol_van at w=16 and w=32 byte at rest, all on B1; each
    # counted from 0 just before and read just after
    paths = [
        ("SHEC k8m4c3", lambda: phase_shec_tick(shec, shec_cpu), False),
        ("LRC k4m2l3", lambda: phase_lrc_tick(lrc, lrc_cpu), False),
    ] + [(f"reed_sol_van k8m4 w={w}",
          (lambda c=c, cc=cc: (phase_wide_codec(c, cc, rng),
                               phase_wide_tick(c, cc))), w == 32)
         for w, (c, cc) in wide.items()]
    for label, run, kept_expected in paths:
        reset_counts()
        run()
        torch.cuda.synchronize()
        log(f"main path ({label}): {path_counts('B1', gf8_cuda)}, "
            f"{path_counts('B2', gf8_bytes_cuda)}; counters "
            f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
        if gf8_cuda.launches <= 0:
            raise AssertionError(f"the {label} path never launched kernel B1")
        if gf8_bytes_cuda.launches:
            raise AssertionError(f"the {label} path launched kernel B2")
        if bool(gf8_cuda.kept_launches) != kept_expected:
            raise AssertionError(
                f"the {label} path took the kept path "
                f"{gf8_cuda.kept_launches} times")
        b1_launches += gf8_cuda.launches

    # the placement main path: CRUSH and the OSDMap pipeline,
    # torch ops only (no hand-written kernel on this path)
    pmap, pmap2, crush_rule, crush_c1 = placement_maps()
    reset_counts()
    placed = phase_placement(pmap, pmap2, crush_rule)
    torch.cuda.synchronize()
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (placement): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    want = {"crush_map_calls": 5,
            "crush_map_pgs": 3 * PLACEMENT_PGS + LRC_PGS + CHOOSE_ARGS_PGS,
            "crush_map_pad_lanes": 0}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"placement counters are not {want}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the placement path launched an EC kernel")
    check_placement(pmap, pmap2, crush_rule, placed)

    # the C1 path: ROADMAP's repro and a 9,984-OSD erasure pool on
    # chooseleaf indep type 0, counted from 0 just before, read just after
    reset_counts()
    phase_c1(pmap2, crush_c1)
    torch.cuda.synchronize()
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (C1): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    want = {"crush_map_calls": 2, "crush_map_pgs": C1_SMALL_PGS + C1_PGS}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"C1 counters are not {want}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the C1 path launched an EC kernel")

    # the balancer scorer path (its own counted window inside)
    scored_map, split, before, changes, _ = phase_scorer(
        pmap.crush, crush_rule, reset_counts)
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the scorer path launched an EC kernel")
    check_scorer(scored_map, split, before, changes, crush_rule, card)
    del scored_map, split, before
    phase_scorer_small()

    # the mesh path: the sharded EC engine and the sharded placement over
    # every visible card (or eight slots of one), counted from 0 just
    # before and read just after; the single-device placement it is held
    # to runs first, outside the window
    mesh_ref = mesh_reference(pmap, crush_rule)
    reset_counts()
    mesh_out = phase_mesh(isa, pmap, crush_rule, mesh_ref)
    sync_all(mesh_out["mesh"].distinct())
    counts = KERNELS.dump()["device_kernels"]
    log(f"main path (mesh): {path_counts('B1', gf8_cuda)}, "
        f"{path_counts('B2', gf8_bytes_cuda)}; counters "
        f"{json.dumps(counts, sort_keys=True)}")
    if gf8_cuda.launches or gf8_bytes_cuda.launches:
        raise AssertionError("the mesh path launched an EC kernel")
    if counts.get("crush_map_calls", 0) != mesh_out["slots"]:
        raise AssertionError("the sharded placement did not map one shard "
                             "per mesh slot")

    phase_one_launch(cauchy, cdata)
    yard_ms = phase_yardstick(card)
    t1 = phase_timing(isa, data, card, yard_ms)
    phase_loop_slope(isa, t1["ms"], card)
    t2 = phase_timing_b2(cauchy, cdata, card, yard_ms)
    phase_timing_b1_shapes(
        [("reed_sol_van k8m4 w=16 encode", wide[16][0].engine._enc_bitmat),
         ("reed_sol_van k8m4 w=32 encode", wide[32][0].engine._enc_bitmat),
         ("SHEC k8m4c3 encode", shec.engine._enc_bitmat)], card)
    phase_clean_l2(isa, cauchy, card)
    placement_s = phase_placement_timing(pmap, pmap2, crush_rule, card)
    phase_mesh_timing(isa, pmap, crush_rule, mesh_ref, mesh_out,
                      placement_s["default chunk"], card)
    log(card)
    kernels = [{
        "name": "B1 planar GF(2) matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf8_planar.cu",
        "replaces": "ceph_tpu/ops/gf8_pallas.py:165",
        "launches": b1_launches,
        "max_abs_err": b1_err,
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": None,
    }, {
        "name": "B2 GF(2) bit-matrix map on raw bytes",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf8_bytes.cu",
        "replaces": "ceph_tpu/ops/gf8_pallas.py:58",
        "launches": b2_launches,
        "max_abs_err": b2_err,
        "ms": t2["ms"],
        "plain_ms": t2["plain_ms"],
        "bound_ms": t2["bound_ms"],
        "bound_by": t2["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
