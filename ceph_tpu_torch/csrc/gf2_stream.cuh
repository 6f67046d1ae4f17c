// Staged streaming of GF(2) row products for Hopper (sm_90a): the design
// that kernels B1 (gf8_planar.cu) and B2 (gf8_bytes.cu) share.
//
// Both kernels compute out[j] = XOR over input rows i of f_ji(in[i]) for
// r output rows and k input rows of n bytes, where f_ji is zero, the
// identity or (B2 only) an 8x8 bit map on each byte.  They must read k*n
// and write r*n bytes; at the codecs' headline shapes that is about 7.5 us
// of device memory at 3.35 TB/s.
//
// The staged kernel:
// - Persistent grid: grid.x is the SM count times the CTAs that fit on an
//   SM (queried once per device).  A work item is one column tile of
//   kTile bytes for one group of 32 output rows; CTAs walk the items in a
//   grid-stride loop, the row groups of one tile next to each other so
//   that they share its input rows in L2.
// - One producer warp fills a ring of kStages stages in dynamic shared
//   memory, each holding kPass input rows of one tile, with one 1-D bulk
//   copy (cp.async.bulk, completion on the stage's mbarrier) per row.  It
//   runs up to kStages stages ahead of the consumers, across item
//   boundaries, so the next tile's loads overlap this tile's XORs and
//   stores.  It starts before the matrix table is built.
// - Sixteen consumer warps: each thread owns one 16-byte column vector of
//   the tile and kRowsPerThread output rows of the group.  It reads from
//   shared memory, once, each staged vector that any of its rows' lists
//   name, XORs it into the register accumulators of those rows, and frees
//   the stage by arriving on the stage's empty mbarrier.  After the last
//   pass of an item it writes its rows with 16-byte stores.
// - The matrix becomes lists in shared memory, built by the consumers
//   while the first stages load: row lists (the kernel's Policy makes
//   them), for each output row and stage a 16-bit mask of the input rows
//   it takes, and from them subset lists, for each thread's rows.
//
// What bounds it on the card: the consumers.  The bytes in flight are
// enough: with the XORs taken out the kernel runs about as fast as a plain
// copy of the same traffic.  The XORs, four per set bit of the matrix,
// and the 16-byte reads of the staged vectors from shared memory, at the
// codecs' densities of ones (about a third), set the time.  A thread
// walks the 15 subsets of its 4 rows, so that it reads each staged vector
// once and XORs it only into the rows whose bit is set: a third of the
// XORs that predicating every (input row, output row) pair would issue,
// and fewer shared-memory reads than walking each row's list alone.
//
// The staged kernel takes calls whose row starts, row stride and n are
// multiples of 16 bytes and whose table fits kTableBytes; the kernels
// keep a bytewise, masked path for every other call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gf2 {

constexpr int kTile = 1024;                  // column bytes per work item
constexpr int kVec = 16;                     // bytes a consumer thread owns
constexpr int kCols = kTile / kVec;          // column vectors per tile
constexpr int kGroup = 32;                   // output rows per work item
constexpr int kRowsPerThread = 4;
constexpr int kSubs = kGroup / kRowsPerThread;
constexpr int kConsumers = kCols * kSubs;    // 512
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kMinBlocks = 2;                // CTAs per SM the registers allow
constexpr int kPass = 16;                    // input rows per stage
constexpr int kStages = 4;
constexpr int kStageBytes = kPass * kTile;   // 16 KiB
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBarBytes = 2 * kStages * 8;   // full and empty mbarriers
constexpr int kTableBytes = 16 << 10;
constexpr int kSmemBytes = kRingBytes + kBarBytes + kTableBytes;
constexpr int kMaxDevices = 64;

static_assert(kCols * kVec == kTile && kConsumers % 32 == 0, "tile shape");
static_assert(kConsumers / kCols == kSubs, "row split");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// blocks until the phase of ``bar`` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void xor4(uint4& a, const uint4& x) {
  a.x ^= x.x;
  a.y ^= x.y;
  a.z ^= x.z;
  a.w ^= x.w;
}

// The shared table starts with the lists.  Row lists: for each (row
// group g, stage s of kPass input rows, output row of the group) a 16-bit
// mask of the stage's input rows that output row takes, two rows to a
// word.  A thread of row sub-group sub owns the group's rows sub + kSubs *
// jj, jj < kRowsPerThread (interleaved, so that dense and sparse rows of
// a matrix spread over the warps), and their lists sit together at slots
// sub * kRowsPerThread + jj.  Subset lists, made from the row lists: for
// each (g, s, sub) and each nonempty subset of the thread's 4 rows, a
// 16-bit mask of the input rows that go to exactly that subset (32 bytes,
// entry 0 unused).
static_assert(kPass <= 16 && kRowsPerThread == 4, "16-bit lists, 4 rows");
constexpr int kSubsets = 1 << kRowsPerThread;

__host__ __device__ constexpr int list_slot(int row_in_group) {
  return row_in_group % kSubs * kRowsPerThread + row_in_group / kSubs;
}

// bytes of the row lists, then of the subset lists, of ngroups x k
__host__ __device__ constexpr long long row_list_bytes(int ngroups, int k) {
  return static_cast<long long>(ngroups) * ((k + kPass - 1) / kPass) *
         kGroup * 2;
}

__host__ __device__ constexpr long long list_bytes(int ngroups, int k) {
  return row_list_bytes(ngroups, k) * (1 + kSubsets / kRowsPerThread);
}

// marks input row i in the list of output row j (of the group) of group g
__device__ __forceinline__ void list_set(uint32_t* lists, int k, int g, int i,
                                         int j) {
  const int nst = (k + kPass - 1) / kPass;
  const int slot = list_slot(j);
  atomicOr(&lists[((g * nst + i / kPass) * kGroup + slot) >> 1],
           1u << (16 * (slot & 1) + i % kPass));
}

// a barrier among the consumer warps only (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// the same, returning whether v was true in any consumer thread
__device__ __forceinline__ bool consumer_sync_or(bool v) {
  uint32_t any;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, %2, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(any)
      : "r"(static_cast<uint32_t>(v)), "n"(kConsumers)
      : "memory");
  return any != 0;
}

// Policy: build_table(lists, extra, r, k) zeroes and fills the row lists
// (list_set) and its own part of the table, ``extra``, from the matrix; it
// is called by the consumer threads (tid < kConsumers), which may
// consumer_sync() among themselves, and returns whether this thread saw a
// general block.  A Policy with kGeneral has apply_general(acc, x, extra,
// g, i, sub, k), which XORs input row i's vector x, through zero,
// identity or general blocks, into the accumulators of the thread's rows
// g*kGroup + sub + kSubs*jj; it runs in a loop of its own, apart from the
// lists.
template <class Policy>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
staged_kernel(Policy pol, const uint8_t* __restrict__ data, long long ld,
              uint8_t* __restrict__ out, int r, int k, long long n) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kStages;
  uint32_t* lists = reinterpret_cast<uint32_t*>(smem + kRingBytes + kBarBytes);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int ngroups = (r + kGroup - 1) / kGroup;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long nitems = ntiles * ngroups;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (warp == kConsumerWarps) {
    // producer: lane 0 issues every copy
    if (lane != 0) return;
    long long c = 0;  // stages issued so far
    for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
      const long long c0 = (item / ngroups) * kTile;
      const uint32_t width =
          static_cast<uint32_t>(n - c0 < kTile ? n - c0 : kTile);
      for (int i0 = 0; i0 < k; i0 += kPass, ++c) {
        const int rows = min(kPass, k - i0);
        const int stage = static_cast<int>(c % kStages);
        mbar_wait(&empty[stage], static_cast<uint32_t>(c / kStages & 1) ^ 1u);
        mbar_arrive_expect_tx(&full[stage], rows * width);
        uint8_t* dst = ring + stage * kStageBytes;
        for (int ii = 0; ii < rows; ++ii) {
          bulk_load(dst + ii * kTile, data + (i0 + ii) * ld + c0, width,
                    &full[stage]);
        }
      }
    }
    return;
  }

  // consumers: the table is built while the first stages load
  const int nst = (k + kPass - 1) / kPass;
  uint16_t* subsets = reinterpret_cast<uint16_t*>(
      reinterpret_cast<uint8_t*>(lists) + row_list_bytes(ngroups, k));
  void* extra = reinterpret_cast<uint8_t*>(lists) + list_bytes(ngroups, k);
  const bool general =
      consumer_sync_or(pol.build_table(lists, extra, r, k)) &&
      Policy::kGeneral;
  for (int e = tid; e < ngroups * nst * kSubs; e += kConsumers) {
    // entry e = (g * nst + s) * kSubs + sub: its rows' lists are 2 words
    const uint32_t m0 = lists[2 * e] & 0xffffu, m1 = lists[2 * e] >> 16;
    const uint32_t m2 = lists[2 * e + 1] & 0xffffu, m3 = lists[2 * e + 1] >> 16;
    uint16_t* o = subsets + e * kSubsets;
    o[0] = 0;
#pragma unroll
    for (int set = 1; set < kSubsets; ++set) {
      o[set] = static_cast<uint16_t>(
          ((set & 1) ? m0 : ~m0) & ((set & 2) ? m1 : ~m1) &
          ((set & 4) ? m2 : ~m2) & ((set & 8) ? m3 : ~m3));
    }
  }
  consumer_sync();
  const int col = tid % kCols;
  const int sub = tid / kCols;
  int stage = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int g = static_cast<int>(item % ngroups);
    const long long c0 = (item / ngroups) * kTile;
    const bool active = c0 + col * kVec < n;
    uint4 acc[kRowsPerThread];
#pragma unroll
    for (int jj = 0; jj < kRowsPerThread; ++jj) acc[jj] = make_uint4(0, 0, 0, 0);
    for (int i0 = 0; i0 < k; i0 += kPass) {
      const int rows = min(kPass, k - i0);
      mbar_wait(&full[stage], phase);
      const uint8_t* src = ring + stage * kStageBytes + col * kVec;
      if (active && general) {
#pragma unroll 1
        for (int ii = 0; ii < rows; ++ii) {
          const uint4 x = *reinterpret_cast<const uint4*>(src + ii * kTile);
          pol.apply_general(acc, x, extra, g, i0 + ii, sub, k);
        }
      } else if (active) {
        // each staged input row goes, read once, to the subset of the
        // thread's rows whose lists name it
        const uint4* sp = reinterpret_cast<const uint4*>(
            subsets + ((g * nst + i0 / kPass) * kSubs + sub) * kSubsets);
        const uint4 sa = sp[0], sb = sp[1];
        const uint32_t sw[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int set = 1; set < kSubsets; ++set) {
          uint32_t m = (sw[set >> 1] >> (16 * (set & 1))) & 0xffffu;
          while (m) {
            const uint4 x =
                *reinterpret_cast<const uint4*>(src + (__ffs(m) - 1) * kTile);
            m &= m - 1;
            if (set & 1) xor4(acc[0], x);
            if (set & 2) xor4(acc[1], x);
            if (set & 4) xor4(acc[2], x);
            if (set & 8) xor4(acc[3], x);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    if (!active) continue;
#pragma unroll
    for (int jj = 0; jj < kRowsPerThread; ++jj) {
      const int row = g * kGroup + sub + kSubs * jj;
      if (row < r) {
        *reinterpret_cast<uint4*>(out + row * n + c0 + col * kVec) = acc[jj];
      }
    }
  }
}

// CTAs of the persistent grid on the current device: SMs x CTAs resident
// per SM, queried once per device
template <class Policy>
cudaError_t persistent_ctas(int* ctas) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    auto kern = staged_kernel<Policy>;
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, kSmemBytes);
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *ctas = cached[dev];
  return cudaSuccess;
}

// whether the staged kernel takes this call
inline bool staged_ok(const void* data, long long ld, const void* out,
                      long long n, long long table_bytes) {
  return reinterpret_cast<uintptr_t>(data) % kVec == 0 &&
         reinterpret_cast<uintptr_t>(out) % kVec == 0 && ld % kVec == 0 &&
         n % kVec == 0 && table_bytes <= kTableBytes;
}

// launches the staged kernel on ``s``; returns its cudaGetLastError()
template <class Policy>
cudaError_t launch_staged(const Policy& pol, const uint8_t* data, long long ld,
                          uint8_t* out, int r, int k, long long n,
                          cudaStream_t s) {
  int ctas = 0;
  const cudaError_t err = persistent_ctas<Policy>(&ctas);
  if (err != cudaSuccess) return err;
  const long long nitems =
      ((n + kTile - 1) / kTile) * ((r + kGroup - 1) / kGroup);
  const unsigned grid =
      static_cast<unsigned>(nitems < ctas ? nitems : ctas);
  staged_kernel<Policy><<<grid, kThreads, kSmemBytes, s>>>(pol, data, ld, out,
                                                           r, k, n);
  return cudaGetLastError();
}

}  // namespace gf2
