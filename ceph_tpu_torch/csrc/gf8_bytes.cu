// GF(2)-linear map on raw bytes for Hopper (sm_90a): kernel B2.
//
// Replaces ceph_tpu/ops/gf8_pallas.py::_kernel (driven there by
// _matmul_tiled and bitmatrix_matmul).  For an (8r, 8k) {0,1} bit-matrix
// bm and k rows of N data bytes it computes r rows of N bytes:
//
//     bit t of out[j, n] = parity over (i, u) of bm[8j+t, 8i+u] * bit u of
//                          data[i, n]
//
// Each (j, i) 8x8 block is a byte -> byte GF(2)-linear map, given by its
// eight column bytes col_u = block * e_u; out[j] is the XOR over i of the
// blocks applied to data[i].  The TPU kernel unpacked the bytes to int8,
// ran an MXU dot and repacked; there is no matrix unit to feed here, so a
// block is applied to four bytes at once with 32-bit integer ops:
//
//     y ^= (((x >> u) & 0x01010101) * 0xff) & (col_u * 0x01010101),
//     u = 0..7.
//
// The packet codecs (cauchy, liberation family) pass kron(m01, I8): all of
// their blocks are zero or the identity, so out[j] is the XOR of the data
// rows that m01 selects.  Blocks are classified once per CTA as zero
// (skipped), identity (the word is XORed as it is) or general (the
// multiply above), and a run of input rows without a general block takes
// a fast path that is only loads and XORs.
//
// What bounds it: device-memory bytes.  At the cauchy_good k=8 m=4 w=8
// packetsize=2048 headline step (r=32 output rows, k=64 input rows,
// N=262144) it must read 16 MiB and the 128 KiB matrix and write 8 MiB,
// about 7.55 us at 3.35 TB/s; its XORs take well under 1 us.
//
// Design: two launches from one entry point.  pack_blocks_kernel turns the
// bit-matrix into one 64-bit word per block (byte u = col_u), r*k*8 bytes
// in a scratch buffer the wrapper allocates.  bytes_matmul_kernel gives
// each thread one 8-byte column word and up to 32 output rows in register
// accumulators; rows beyond 32 spread over grid.y.  Input rows pass
// through shared memory in passes of kPass rows (their block words and a
// zero/identity/general mask per row), so any k works within a fixed
// 17 KiB.  Input rows may have any row stride and base alignment (a
// column slice of a packet-row matrix), and N any value: the unaligned
// instantiation reads and writes bytewise and masks the ragged edge.
//
// Like B1 this first version holds few loads in flight per thread and no
// cp.async/TMA staging, so it is bound by DRAM latency before bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordBytes = 8;   // column bytes a thread owns
constexpr int kLanes = kWordBytes / 4;
constexpr int kGroup = 32;      // output rows held in registers at once
constexpr int kPass = 64;       // input rows whose tables sit in shared memory
constexpr int kAhead = 16;      // input-row loads issued before their XORs
constexpr uint64_t kIdentity = 0x8040201008040201ull;  // col_u = 1 << u

struct Word {
  uint32_t v[kLanes];
};

template <bool kAligned>
__device__ __forceinline__ Word load_word(const uint8_t* __restrict__ row,
                                          long long w, long long n) {
  Word x;
  if (kAligned) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(row) + w);
    x.v[0] = t.x;
    x.v[1] = t.y;
    return x;
  }
#pragma unroll
  for (int q = 0; q < kLanes; ++q) x.v[q] = 0u;
  const long long c = w * kWordBytes;
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (c + b < n) {
      x.v[b >> 2] |= static_cast<uint32_t>(__ldg(row + c + b)) << (8 * (b & 3));
    }
  }
  return x;
}

template <bool kAligned>
__device__ __forceinline__ void store_word(uint8_t* __restrict__ row,
                                           long long w, long long n,
                                           const Word& x) {
  if (kAligned) {
    reinterpret_cast<uint2*>(row)[w] = make_uint2(x.v[0], x.v[1]);
    return;
  }
  const long long c = w * kWordBytes;
#pragma unroll
  for (int b = 0; b < kWordBytes; ++b) {
    if (c + b < n) {
      row[c + b] = static_cast<uint8_t>(x.v[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// the 8x8 block with column bytes ``cols`` (byte u = col_u) applied to
// each byte of x
__device__ __forceinline__ uint32_t apply_block(uint32_t x, uint64_t cols) {
  uint32_t y = 0u;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t sel = ((x >> u) & 0x01010101u) * 0xffu;
    const uint32_t col =
        (static_cast<uint32_t>(cols >> (8 * u)) & 0xffu) * 0x01010101u;
    y ^= sel & col;
  }
  return y;
}

// one thread per block: blocks[j * k + i] byte u = col_u of block (j, i)
__global__ void pack_blocks_kernel(const uint8_t* __restrict__ bm,
                                   uint64_t* __restrict__ blocks, int r,
                                   int k) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= static_cast<long long>(r) * k) return;
  const int j = static_cast<int>(b / k);
  const int i = static_cast<int>(b % k);
  const long long ld = 8ll * k;
  uint64_t c = 0ull;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint8_t* row = bm + (8ll * j + t) * ld + 8ll * i;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      c |= static_cast<uint64_t>(row[u] & 1) << (8 * u + t);
    }
  }
  blocks[b] = c;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
bytes_matmul_kernel(const uint64_t* __restrict__ blocks,
                    const uint8_t* __restrict__ data, long long ld,
                    uint8_t* __restrict__ out, int r, int k, long long n) {
  __shared__ uint64_t cols[kPass][kGroup];
  __shared__ uint32_t id_mask[kPass];
  __shared__ uint32_t gen_mask[kPass];

  const long long nwords = (n + kWordBytes - 1) / kWordBytes;
  const long long w = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool active = w < nwords;
  const int g0 = blockIdx.y * kGroup;
  const int rows = min(kGroup, r - g0);
  const int lane = threadIdx.x & 31;

  Word acc[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int q = 0; q < kLanes; ++q) acc[j].v[q] = 0u;
  }

  for (int i0 = 0; i0 < k; i0 += kPass) {
    const int pass = min(kPass, k - i0);
    __syncthreads();  // the previous pass is done with the tables
    // one warp per input row: lane j classifies block (g0 + j, i0 + ii)
    for (int ii = threadIdx.x >> 5; ii < pass; ii += kThreads / 32) {
      const uint64_t c =
          lane < rows ? blocks[static_cast<long long>(g0 + lane) * k + i0 + ii]
                      : 0ull;
      cols[ii][lane] = c;
      const uint32_t id = __ballot_sync(0xffffffffu, c == kIdentity);
      const uint32_t gen =
          __ballot_sync(0xffffffffu, c != 0ull && c != kIdentity);
      if (lane == 0) {
        id_mask[ii] = id;
        gen_mask[ii] = gen;
      }
    }
    __syncthreads();
    if (!active) continue;

    for (int a0 = 0; a0 < pass; a0 += kAhead) {
      const int ahead = min(kAhead, pass - a0);
      uint32_t any_gen = 0u;
      for (int a = 0; a < ahead; ++a) any_gen |= gen_mask[a0 + a];
      if (any_gen == 0u) {
        // zero and identity blocks only: loads and XORs
        Word x[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          if (a < ahead) {
            x[a] = load_word<kAligned>(data + (i0 + a0 + a) * ld, w, n);
          }
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const uint32_t m = a < ahead ? id_mask[a0 + a] : 0u;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            if (m & (1u << j)) {
#pragma unroll
              for (int q = 0; q < kLanes; ++q) acc[j].v[q] ^= x[a].v[q];
            }
          }
        }
        continue;
      }
#pragma unroll 1
      for (int a = 0; a < ahead; ++a) {
        const int ii = a0 + a;
        const Word x = load_word<kAligned>(data + (i0 + ii) * ld, w, n);
        const uint32_t idm = id_mask[ii];
        const uint32_t gm = gen_mask[ii];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (idm & (1u << j)) {
#pragma unroll
            for (int q = 0; q < kLanes; ++q) acc[j].v[q] ^= x.v[q];
          } else if (gm & (1u << j)) {
            const uint64_t c = cols[ii][j];
#pragma unroll
            for (int q = 0; q < kLanes; ++q) {
              acc[j].v[q] ^= apply_block(x.v[q], c);
            }
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < rows) {
      store_word<kAligned>(out + static_cast<long long>(g0 + j) * n, w, n,
                           acc[j]);
    }
  }
}

}  // namespace

// bm (8r, 8k) uint8 {0,1} contiguous; data: k rows of n bytes, row i at
// data + i * ld; out (r, n) uint8 contiguous; blocks: scratch of r*k
// 64-bit words.  All on the current device.  ``aligned`` promises that
// data, ld, out and n are multiples of 8.  Launches on ``stream`` without
// synchronising; returns the first launch error (0 on success).
extern "C" int gf8_bytes_matmul(const void* bm, const void* data,
                                long long ld, void* out, void* blocks, int r,
                                int k, long long n, int aligned,
                                void* stream) {
  if (r < 0 || k < 0 || n < 0 || ld < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* blk = static_cast<uint64_t*>(blocks);
  const long long nblocks = static_cast<long long>(r) * k;
  if (nblocks > 0) {
    pack_blocks_kernel<<<static_cast<unsigned>((nblocks + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, s>>>(static_cast<const uint8_t*>(bm),
                                           blk, r, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long nwords = (n + kWordBytes - 1) / kWordBytes;
  const dim3 grid(static_cast<unsigned>((nwords + kThreads - 1) / kThreads),
                  static_cast<unsigned>((r + kGroup - 1) / kGroup));
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (aligned) {
    bytes_matmul_kernel<true><<<grid, kThreads, 0, s>>>(blk, d, ld, o, r, k,
                                                        n);
  } else {
    bytes_matmul_kernel<false><<<grid, kThreads, 0, s>>>(blk, d, ld, o, r, k,
                                                         n);
  }
  return static_cast<int>(cudaGetLastError());
}
