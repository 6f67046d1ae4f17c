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
// rows that m01 selects.  Blocks are classified as zero (skipped),
// identity (the data is XORed as it is) or general (the multiply above,
// with the block word read from global memory; only general ISA matrices
// reach it).
//
// What bounds it: by its traffic, device-memory bytes.  At the
// cauchy_good k=8 m=4 w=8 packetsize=2048 headline step (r=32 output
// rows, k=64 input rows, N=262144) it must read 16 MiB and write 8 MiB,
// about 7.55 us at 3.35 TB/s.  The first version (one 8-byte word per
// thread, 16 loads in flight, one CTA per SM, and a second launch to pack
// the matrix) reached 23 % of that.
//
// Design: the staged kernel of gf2_stream.cuh (persistent grid, a ring of
// bulk-copied stages per CTA fed by a producer warp, row lists in shared
// memory, 16-byte vectors XORed into register accumulators, 16-byte
// stores), which keeps enough bytes in flight; its XOR work, one list
// entry per identity block, now sets its time.  The matrix arrives as a
// table of r*k block words (byte u = col_u) followed by one class entry
// per (group of 32 output rows, input row): the identity mask in the low
// and the general mask in the high 32 bits.  The identity masks become
// the row lists; a CTA that finds a general block runs every input row
// through the zero/identity/general path instead.  The matrix is a
// constant of the codec, so the caller packs the table once on the host
// and passes it: the call is one launch.  A caller without a table gets
// it from pack_blocks_kernel, launched first on the same stream.
//
// Calls the staged kernel does not take (row starts, row stride or N not
// multiples of 16 bytes: a column slice of a packet-row matrix, a ragged
// width) run the kept kernel: one 8-byte word per thread read and written
// bytewise with the edge masked, input rows through shared memory in
// passes of 64, output-row groups of 32 on grid.y.

#include "gf2_stream.cuh"

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

__device__ __forceinline__ Word load_word(const uint8_t* __restrict__ row,
                                          long long w, long long n) {
  Word x;
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

__device__ __forceinline__ void store_word(uint8_t* __restrict__ row,
                                           long long w, long long n,
                                           const Word& x) {
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

// the 64-bit word of block (j, i): byte u = col_u
__device__ __forceinline__ uint64_t block_word(const uint8_t* __restrict__ bm,
                                               int j, int i, int k) {
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
  return c;
}

// one thread per (row group g, input row i): the block words of rows
// 32g..32g+31 at blocks[j * k + i] and their class entry at
// blocks[r * k + g * k + i] (identity mask | general mask << 32)
__global__ void pack_blocks_kernel(const uint8_t* __restrict__ bm,
                                   uint64_t* __restrict__ blocks, int r,
                                   int k) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int ngroups = (r + kGroup - 1) / kGroup;
  if (e >= static_cast<long long>(ngroups) * k) return;
  const int g = static_cast<int>(e / k);
  const int i = static_cast<int>(e % k);
  uint32_t id = 0u, gen = 0u;
  for (int jj = 0; jj < kGroup && g * kGroup + jj < r; ++jj) {
    const int j = g * kGroup + jj;
    const uint64_t c = block_word(bm, j, i, k);
    blocks[static_cast<long long>(j) * k + i] = c;
    if (c == kIdentity) {
      id |= 1u << jj;
    } else if (c != 0ull) {
      gen |= 1u << jj;
    }
  }
  blocks[static_cast<long long>(r) * k + e] =
      id | (static_cast<uint64_t>(gen) << 32);
}

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
            x[a] = load_word(data + (i0 + a0 + a) * ld, w, n);
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
        const Word x = load_word(data + (i0 + ii) * ld, w, n);
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
      store_word(out + static_cast<long long>(g0 + j) * n, w, n, acc[j]);
    }
  }
}

// the staged kernel's matrix: the row lists of the identity blocks, and
// the class entries for the general path, where a general block's word is
// read from global memory as it is used
struct BytesPolicy {
  static constexpr bool kGeneral = true;
  const uint64_t* blocks;

  __device__ __forceinline__ bool build_table(uint32_t* lists, void* extra,
                                              int r, int k) const {
    const int tid = threadIdx.x;
    const int ngroups = (r + kGroup - 1) / kGroup;
    const int words = static_cast<int>(gf2::row_list_bytes(ngroups, k) / 4);
    for (int e = tid; e < words; e += gf2::kConsumers) lists[e] = 0u;
    gf2::consumer_sync();
    uint2* classes = static_cast<uint2*>(extra);
    const uint2* src =
        reinterpret_cast<const uint2*>(blocks + static_cast<long long>(r) * k);
    bool general = false;
    for (int e = tid; e < ngroups * k; e += gf2::kConsumers) {
      const uint2 c = src[e];
      classes[e] = c;
      general |= c.y != 0u;
      for (uint32_t m = c.x; m; m &= m - 1) {
        gf2::list_set(lists, k, e / k, e % k, __ffs(m) - 1);
      }
    }
    return general;
  }

  __device__ __forceinline__ void apply_general(
      uint4 (&acc)[gf2::kRowsPerThread], const uint4& x, const void* table,
      int g, int i, int sub, int k) const {
    const uint2 e = static_cast<const uint2*>(table)[g * k + i];
#pragma unroll
    for (int jj = 0; jj < gf2::kRowsPerThread; ++jj) {
      const int row = sub + gf2::kSubs * jj;  // in the group
      if ((e.x >> row) & 1u) {
        gf2::xor4(acc[jj], x);
      } else if ((e.y >> row) & 1u) {
        const int j = g * gf2::kGroup + row;
        const uint64_t c = __ldg(blocks + static_cast<long long>(j) * k + i);
        acc[jj].x ^= apply_block(x.x, c);
        acc[jj].y ^= apply_block(x.y, c);
        acc[jj].z ^= apply_block(x.z, c);
        acc[jj].w ^= apply_block(x.w, c);
      }
    }
  }
};

}  // namespace

// bm (8r, 8k) uint8 {0,1} contiguous; data: k rows of n bytes, row i at
// data + i * ld; out (r, n) uint8 contiguous; blocks: r*k block words and
// ceil(r/32)*k class entries (64-bit each).  All on the current device.
// With ``pack`` the table is built from bm first (pack_blocks_kernel);
// without it the caller's table is used as it is and bm is not read.
// ``staged`` asks for the staged kernel, which wants data, ld, out and n
// multiples of 16 and its lists (320 bytes for each group of 32 output
// rows and 16 input rows) and class entries within its table; the kept
// kernel takes any call.  Launches on ``stream`` without synchronising; returns
// the first launch error (0 on success).
extern "C" int gf8_bytes_matmul(const void* bm, const void* data,
                                long long ld, void* out, void* blocks, int r,
                                int k, long long n, int pack, int staged,
                                void* stream) {
  if (r < 0 || k < 0 || n < 0 || ld < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* blk = static_cast<uint64_t*>(blocks);
  const long long nclasses = (r + kGroup - 1LL) / kGroup * k;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  const long long table =
      gf2::list_bytes((r + kGroup - 1) / kGroup, k) + nclasses * 8;
  if (staged && !gf2::staged_ok(d, ld, o, n, table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pack && nclasses > 0) {
    pack_blocks_kernel<<<static_cast<unsigned>((nclasses + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, s>>>(static_cast<const uint8_t*>(bm),
                                           blk, r, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (staged) {
    return static_cast<int>(
        gf2::launch_staged(BytesPolicy{blk}, d, ld, o, r, k, n, s));
  }
  const long long nwords = (n + kWordBytes - 1) / kWordBytes;
  const dim3 grid(static_cast<unsigned>((nwords + kThreads - 1) / kThreads),
                  static_cast<unsigned>((r + kGroup - 1) / kGroup));
  bytes_matmul_kernel<<<grid, kThreads, 0, s>>>(blk, d, ld, o, r, k, n);
  return static_cast<int>(cudaGetLastError());
}

// the staged kernel's launch shape on the current device: CTAs of the
// persistent grid, threads per CTA and dynamic shared memory per CTA
extern "C" int gf8_bytes_staged_config(int* ctas, int* threads,
                                       int* smem_bytes) {
  *threads = gf2::kThreads;
  *smem_bytes = gf2::kSmemBytes;
  return static_cast<int>(gf2::persistent_ctas<BytesPolicy>(ctas));
}
