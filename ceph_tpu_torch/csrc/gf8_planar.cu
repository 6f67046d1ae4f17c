// Packed bit-planar GF(2) matmul for Hopper (sm_90a).
//
// Replaces ceph_tpu/ops/gf8_pallas.py::_planar_kernel (driven there by
// _planar_tiled and planar_matmul).  It computes, for a (rw, kw) {0,1}
// bit-matrix bm and (kw, npk) packed bit-planes,
//
//     out[r, c] = XOR over i with bm[r, i] = 1 of planes[i, c]
//
// bitwise over each packed byte: the mod-2 matrix product of the planes'
// bits, without unpacking them.  The TPU kernel unpacked to int8, stacked
// the matrix block-diagonally to fill the 128-wide matrix unit and
// repacked; none of that is needed where plain XOR on 32-bit words exists.
//
// What bounds it: device-memory bytes.  At the ISA k=8 m=4 headline step
// (rw=32, kw=64, npk=262144) it must read 16 MiB and write 8 MiB, about
// 7.5 us at 3.35 TB/s, while the XOR work is well under that.
//
// Design: each thread owns one 8-byte column word.  It streams the kw
// input rows once (sixteen loads in flight at a time) and XORs each row
// into the register accumulators of the output rows whose bit is set: at
// most 32 accumulators, so rw > 32 spreads groups of 32 output rows over
// grid.y.  The bit-matrix lives in shared memory as one 32-bit mask per
// input row (bit r set when output row r takes that input row), built by
// each block with one warp ballot per input row.  Every npk works: when the
// rows are not 8-byte aligned (npk % 8 != 0) the words are read and written
// bytewise, and the ragged edge is masked in the kernel.
//
// On the card this simple design is bound by memory latency rather than
// bandwidth: a thread has at most 16 loads in flight and a block per SM at
// the headline shape, too few bytes in flight to cover the DRAM latency.
// Staging rows through shared memory with cp.async/TMA is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordBytes = 8;   // column bytes a thread owns
constexpr int kGroup = 32;      // output rows held in registers at once
constexpr int kAhead = 16;      // input-row loads issued before their XORs
constexpr int kMaxKw = 12288;   // masks must fit 48 KiB of shared memory
constexpr int kLanes = kWordBytes / 4;

struct Word {
  uint32_t v[kLanes];
};

template <bool kAligned>
__device__ __forceinline__ Word load_word(const uint8_t* __restrict__ row,
                                          long long w, long long npk) {
  Word x;
  if (kAligned) {
    if (kLanes == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(row) + w);
      x.v[0] = t.x;
      x.v[kLanes - 1] = t.y;
    } else {
      x.v[0] = __ldg(reinterpret_cast<const uint32_t*>(row) + w);
    }
    return x;
  }
#pragma unroll
  for (int q = 0; q < kLanes; ++q) x.v[q] = 0u;
  const long long c = w * kWordBytes;
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (c + b < npk) {
      x.v[b >> 2] |= static_cast<uint32_t>(__ldg(row + c + b)) << (8 * (b & 3));
    }
  }
  return x;
}

template <bool kAligned>
__device__ __forceinline__ void store_word(uint8_t* __restrict__ row,
                                           long long w, long long npk,
                                           const Word& x) {
  if (kAligned) {
    if (kLanes == 2) {
      reinterpret_cast<uint2*>(row)[w] = make_uint2(x.v[0], x.v[kLanes - 1]);
    } else {
      reinterpret_cast<uint32_t*>(row)[w] = x.v[0];
    }
    return;
  }
  const long long c = w * kWordBytes;
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (c + b < npk) {
      row[c + b] = static_cast<uint8_t>(x.v[b >> 2] >> (8 * (b & 3)));
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
planar_matmul_kernel(const uint8_t* __restrict__ bm,
                     const uint8_t* __restrict__ planes,
                     uint8_t* __restrict__ out, int rw, int kw,
                     long long npk) {
  extern __shared__ uint32_t masks[];
  const long long nwords = (npk + kWordBytes - 1) / kWordBytes;
  const long long w = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool active = w < nwords;
  // grid.y picks this block's group of output rows
  const int g0 = blockIdx.y * kGroup;
  const int rows = min(kGroup, rw - g0);
  // one warp per input row: lane r reads bm[g0 + r, i] and the ballot is
  // that row's mask
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = threadIdx.x >> 5; i < kw; i += kThreads / 32) {
    const bool bit =
        lane < rows && (bm[static_cast<long long>(g0 + lane) * kw + i] & 1);
    const uint32_t m = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) masks[i] = m;
  }
  __syncthreads();
  if (!active) return;

  Word acc[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
#pragma unroll
    for (int q = 0; q < kLanes; ++q) acc[r].v[q] = 0u;
  }
  for (int i0 = 0; i0 < kw; i0 += kAhead) {
    Word x[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (i0 + j < kw) {
        x[j] = load_word<kAligned>(
            planes + static_cast<long long>(i0 + j) * npk, w, npk);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const uint32_t m = (i0 + j < kw) ? masks[i0 + j] : 0u;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (m & (1u << r)) {
#pragma unroll
          for (int q = 0; q < kLanes; ++q) acc[r].v[q] ^= x[j].v[q];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    if (r < rows) {
      store_word<kAligned>(out + static_cast<long long>(g0 + r) * npk, w,
                           npk, acc[r]);
    }
  }
}

}  // namespace

// bm (rw, kw) uint8, planes (kw, npk) uint8 and out (rw, npk) uint8, all
// contiguous on the current device.  ``aligned`` promises that every row
// start is 8-byte aligned (npk % 8 == 0 and both base pointers aligned).
// Launches on ``stream`` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int gf8_planar_matmul(const void* bm, const void* planes,
                                 void* out, int rw, int kw, long long npk,
                                 int aligned, void* stream) {
  if (rw < 0 || kw < 0 || npk < 0 || kw > kMaxKw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rw == 0 || npk == 0) return 0;
  const long long nwords = (npk + kWordBytes - 1) / kWordBytes;
  const dim3 blocks(static_cast<unsigned>((nwords + kThreads - 1) / kThreads),
                    static_cast<unsigned>((rw + kGroup - 1) / kGroup));
  const size_t smem = static_cast<size_t>(kw > 0 ? kw : 1) * sizeof(uint32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bm);
  const uint8_t* p = static_cast<const uint8_t*>(planes);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (aligned) {
    planar_matmul_kernel<true><<<blocks, kThreads, smem, s>>>(b, p, o, rw, kw,
                                                              npk);
  } else {
    planar_matmul_kernel<false><<<blocks, kThreads, smem, s>>>(b, p, o, rw,
                                                               kw, npk);
  }
  return static_cast<int>(cudaGetLastError());
}
