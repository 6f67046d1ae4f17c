#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's erasure-code hot path on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ``ceph_tpu_torch/csrc/`` (first use),
then runs four phases and exits non-zero if any of them fails:

1. kernel: kernel B1 (``ops/gf8_cuda.planar_matmul``) against its plain
   version on the card, bit-exact, at the ragged check shapes and at the
   shapes the main path gives it;
2. codec: ISA k=8 m=4 at full width, 4096 stripes x 8 x 512 B per step:
   ``to_planar`` -> ``encode_planar`` -> ``to_batch`` against the host
   GF reference, ``decode_planar`` for 1, 2 and 4 erasures, and
   ``encode``/``decode_concat`` of a 4 MiB object;
3. stripe: one OSD tick at ``StripeInfo(8, 4096)`` (256 ops of 64 KiB and
   a few ragged sizes): ``encode_planes_multi`` shards and CRCs against
   the host reference, ``decode_planes_multi`` with one and two lost data
   shards back to the original bytes;
4. timing: CUDA-event medians of B1 and of its plain version at the
   headline shape (L2 flushed before each launch), and the encode rate.

Phases 2 and 3 are the main path: kernel launch counts are set to 0 just
before them and read just after, and every kernel must have launched.
The last lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.  Without
a CUDA device it prints no result and exits non-zero.
"""

from __future__ import annotations

import json
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

# device clock cycles of the spin ahead of each timed call (~0.3 ms)
SPIN_CYCLES = 500_000

# one OSD tick: 256 ops of 64 KiB objects and a few ragged sizes
TICK_SIZES = [64 << 10] * 256 + [0, 100, 40000, 200 << 10, (1 << 20) + 1]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int, flush=None) -> float:
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
        torch.cuda._sleep(SPIN_CYCLES)
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


def phase_kernel(codec, rng):
    """B1 against its plain version on the card; returns max |diff|."""
    import torch

    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.ops import gf8, gf8_cuda

    cases = []
    for (k, m, npk) in [(8, 4, 2048 * 3), (8, 4, 2048 * 2 + 100),
                        (4, 2, 5000), (10, 4, 2048), (2, 1, 2048)]:
        bm = gf8.expand_bitmatrix(matrices.isa_rs_matrix(k, m))
        cases.append((f"check k{k}m{m} npk={npk}",
                      torch.from_numpy(bm).cuda(), k * 8, npk))
    eng = codec.engine
    headline_npk = 4096 * 512 // 8       # packed columns of one step
    cases.append(("headline encode", eng._enc_bitmat, 64, headline_npk))
    for er in [(2,), (0, 9), (1, 4, 8, 11)]:
        src = tuple(i for i in range(12) if i not in er)[:8]
        cases.append((f"headline decode {er}", eng.decode_bitmat(src, er),
                      64, headline_npk))
    # the stripe tick's shape: its stripes' packed columns
    tick_stripes = sum(-(-s // (8 * 4096)) for s in TICK_SIZES)
    cases.append(("stripe tick encode", eng._enc_bitmat, 64,
                  tick_stripes * 4096 // 8))
    worst = 0
    for name, bm, kw, npk in cases:
        planes = torch.from_numpy(
            rng.integers(0, 256, (kw, npk), dtype=np.uint8)).cuda()
        got = gf8_cuda.planar_matmul(bm, planes)
        want = gf8_cuda.planar_matmul_ref(bm, planes)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max()) if npk else 0
        worst = max(worst, diff)
        if not torch.equal(got, want):
            raise AssertionError(f"B1 differs from its plain version: {name}")
        log(f"kernel: B1 bit-exact, {name}, bitmat {tuple(bm.shape)}")
    return worst


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


def phase_timing(codec, data):
    """CUDA-event medians at the headline shape; returns a dict."""
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
                                "planar_matmul_kernel", 30, flush)
    nbytes = kw * npk + rw * npk + rw * kw
    xors = int(bm.sum().item()) * npk / 4        # 32-bit XORs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = xors / OPS_32BIT_PER_S * 1e3
    data_dev = torch.from_numpy(data).cuda()
    enc_ms = cuda_median_ms(
        lambda: codec.encode_planar(codec.to_planar(data_dev)).to_batch(), 10,
        flush)
    pb = codec.to_planar(data_dev)
    enc_planar_ms = cuda_median_ms(lambda: codec.encode_planar(pb), 20, flush)
    to_planar_ms = cuda_median_ms(lambda: codec.to_planar(data_dev), 10, flush)
    par = codec.encode_planar(pb)
    to_batch_ms = cuda_median_ms(
        lambda: par.with_planes(par.planes).to_batch(), 10, flush)
    step_bytes = data.size
    log(f"timing: B1 headline ({rw}x{kw} x {kw}x{npk}) median {ms:.6f} ms, "
        f"plain version {plain_ms:.6f} ms, bound {max(bytes_ms, ops_ms):.6f} ms"
        f" ({nbytes} bytes -> {bytes_ms:.6f} ms; {xors:.0f} XORs -> "
        f"{ops_ms:.6f} ms); profiler device time of the kernel alone "
        + ("not measured" if dev_ms is None else f"{dev_ms:.6f} ms"))
    log(f"timing: encode step (to_planar + encode_planar + to_batch, "
        f"device-resident {step_bytes} B) {enc_ms:.6f} ms = "
        f"{step_bytes / enc_ms / 1e6:.3f} GB/s; encode_planar alone "
        f"{enc_planar_ms:.6f} ms = {step_bytes / enc_planar_ms / 1e6:.3f} GB/s;"
        f" to_planar alone {to_planar_ms:.6f} ms; parity to_batch alone "
        f"{to_batch_ms:.6f} ms")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ceph_tpu_torch.ec import factory
    from ceph_tpu_torch.ops import _build, gf8_cuda
    from ceph_tpu_torch.utils.perf import KERNELS

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {sorted(_build.build_logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.3f} s")
    for stem, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {stem}: {line.strip()}")
    rng = np.random.default_rng(SEED)
    codec = factory({"plugin": "isa", "k": "8", "m": "4"})
    assert codec.device.type == "cuda", codec.device
    max_err = phase_kernel(codec, rng)

    # the main path: counts from 0 just before, read just after
    gf8_cuda.launches = 0
    KERNELS.reset()
    data = phase_codec(codec, rng)
    phase_stripe(codec)
    torch.cuda.synchronize()
    launches = gf8_cuda.launches
    log(f"main path: B1 launches {launches}; counters "
        f"{json.dumps(KERNELS.dump()['device_kernels'], sort_keys=True)}")
    if launches <= 0:
        raise AssertionError("the main path never launched kernel B1")

    t = phase_timing(codec, data)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    kernels = [{
        "name": "B1 planar GF(2) matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf8_planar.cu",
        "replaces": "ceph_tpu/ops/gf8_pallas.py:165",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
