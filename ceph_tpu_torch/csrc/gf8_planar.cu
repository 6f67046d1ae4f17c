// Packed bit-planar GF(2) matmul for Hopper (sm_90a): kernel B1.
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
// What bounds it: by its traffic, device-memory bytes.  At the ISA k=8
// m=4 headline step (rw=32, kw=64, npk=262144) it must read 16 MiB and
// write 8 MiB, about 7.5 us at 3.35 TB/s.  The first version (one 8-byte
// word per thread, 16 loads in flight, one CTA per SM) reached 31 % of
// that: too few bytes in flight to hide DRAM latency.
//
// Design: the staged kernel of gf2_stream.cuh (persistent grid, a ring of
// bulk-copied stages per CTA fed by a producer warp, row lists in shared
// memory, 16-byte vectors XORed into register accumulators, 16-byte
// stores), which keeps enough bytes in flight; its XOR work, one list
// entry per set bit of bm, now sets its time.  Each CTA builds the lists
// from bm, read 4 bytes a thread, with shared-memory atomics while its
// first stages load.
//
// Calls the staged kernel does not take (rows not 16-byte aligned, or
// more lists than its table holds) run the kept kernel: one 8-byte word
// per thread read and written bytewise, the ragged edge masked, the
// masks built by one warp ballot per input row, output-row groups of 32
// on grid.y.

#include "gf2_stream.cuh"

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

__device__ __forceinline__ Word load_word(const uint8_t* __restrict__ row,
                                          long long w, long long npk) {
  Word x;
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

__device__ __forceinline__ void store_word(uint8_t* __restrict__ row,
                                           long long w, long long npk,
                                           const Word& x) {
  const long long c = w * kWordBytes;
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (c + b < npk) {
      row[c + b] = static_cast<uint8_t>(x.v[b >> 2] >> (8 * (b & 3)));
    }
  }
}

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
        x[j] = load_word(planes + static_cast<long long>(i0 + j) * npk, w,
                         npk);
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
      store_word(out + static_cast<long long>(g0 + r) * npk, w, npk, acc[r]);
    }
  }
}

// the staged kernel's matrix: the row lists alone
struct PlanarPolicy {
  static constexpr bool kGeneral = false;
  const uint8_t* bm;

  __device__ __forceinline__ bool build_table(uint32_t* lists, void*, int rw,
                                              int kw) const {
    const int tid = threadIdx.x;
    const int words = static_cast<int>(
        gf2::row_list_bytes((rw + gf2::kGroup - 1) / gf2::kGroup, kw) / 4);
    for (int e = tid; e < words; e += gf2::kConsumers) lists[e] = 0u;
    gf2::consumer_sync();
    // bm read 4 bytes a thread where it allows it, else bytewise
    const int total = rw * kw;
    auto set = [&](int e) {
      const int row = e / kw;
      gf2::list_set(lists, kw, row / gf2::kGroup, e % kw, row % gf2::kGroup);
    };
    if (total % 4 == 0 && reinterpret_cast<uintptr_t>(bm) % 4 == 0) {
      for (int e0 = tid * 4; e0 < total; e0 += gf2::kConsumers * 4) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(bm + e0));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((w >> (8 * b)) & 1u) set(e0 + b);
        }
      }
    } else {
      for (int e = tid; e < total; e += gf2::kConsumers) {
        if (bm[e] & 1) set(e);
      }
    }
    return false;
  }

  __device__ void apply_general(uint4 (&)[gf2::kRowsPerThread], const uint4&,
                                const void*, int, int, int, int) const {}
};

}  // namespace

// bm (rw, kw) uint8, planes (kw, npk) uint8 and out (rw, npk) uint8, all
// contiguous on the current device.  ``staged`` asks for the staged
// kernel, which wants 16-byte aligned row starts (npk % 16 == 0, both
// base pointers aligned) and its lists, 320 bytes for each group of 32
// output rows and 16 input rows, within its table; the kept kernel takes
// any call.  Launches on ``stream`` without
// synchronising; returns the launch's cudaGetLastError() (0 on success).
extern "C" int gf8_planar_matmul(const void* bm, const void* planes,
                                 void* out, int rw, int kw, long long npk,
                                 int staged, void* stream) {
  if (rw < 0 || kw < 0 || npk < 0 || kw > kMaxKw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rw == 0 || npk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bm);
  const uint8_t* p = static_cast<const uint8_t*>(planes);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (staged) {
    const long long table =
        gf2::list_bytes((rw + gf2::kGroup - 1) / gf2::kGroup, kw);
    if (!gf2::staged_ok(p, npk, o, npk, table)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(
        gf2::launch_staged(PlanarPolicy{b}, p, npk, o, rw, kw, npk, s));
  }
  const long long nwords = (npk + kWordBytes - 1) / kWordBytes;
  const dim3 blocks(static_cast<unsigned>((nwords + kThreads - 1) / kThreads),
                    static_cast<unsigned>((rw + kGroup - 1) / kGroup));
  const size_t smem = static_cast<size_t>(kw > 0 ? kw : 1) * sizeof(uint32_t);
  planar_matmul_kernel<<<blocks, kThreads, smem, s>>>(b, p, o, rw, kw, npk);
  return static_cast<int>(cudaGetLastError());
}

// the staged kernel's launch shape on the current device: CTAs of the
// persistent grid, threads per CTA and dynamic shared memory per CTA
extern "C" int gf8_planar_staged_config(int* ctas, int* threads,
                                        int* smem_bytes) {
  *threads = gf2::kThreads;
  *smem_bytes = gf2::kSmemBytes;
  return static_cast<int>(gf2::persistent_ctas<PlanarPolicy>(ctas));
}
