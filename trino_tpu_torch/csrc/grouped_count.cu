// Grouped count of set flags for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_count_kernel` (wrapper
// `grouped_count`, gate `seg_count_maybe`), the per-group count behind
// the unfused aggregation path's `_seg_count` at small group capacities.
// The TPU version summed 0/1 float32 planes because its vector unit has
// no integer multiply-accumulate; here counts are integers throughout.
//
// Bound on the H100: memory, 1 byte of flag + 8 bytes of int64 group id
// a row against 3.35 TB/s (Q1 at SF10: 60 M rows, 0.161 ms).  The caller
// sends only capacities up to 32, where a thread can own a counter for
// every group, so no row needs any cross-lane work.  Design:
//   - private counters: each thread owns a column of a [cap][256] table
//     of uint32 counters in shared memory and adds one to its own counter
//     for each row whose flag is set and whose id lies in [0, cap).  Lane
//     i of a warp touches word i of every 256-word row, so the accesses
//     are free of bank conflicts.  No __match_any_sync, no shuffle and no
//     atomic in the row loop.  A counter never wraps: a thread sees at
//     most n / (blocks x 256) + 33 rows, and the launcher refuses
//     n >= 2^30 x blocks x 256; the block reduction widens to int64.
//   - streaming: the ids, 8 of the 9 bytes a row, come in 16-byte loads
//     (longlong2: two rows), evict-first (__ldcs), contiguous 512-byte
//     runs a warp; each id pair's two flags come in one 2-byte load
//     beside it (a warp reads 64 contiguous flag bytes), so a thread's
//     flags and ids are the same rows with no exchange between lanes.
//     kUnroll pairs of each stream are in flight a thread before any is
//     used.  An id pointer 8 bytes off 16 (a view such as gid[1:]) gives
//     a one-row scalar head; the flags must then lie at an even address
//     (the wrapper copies the stream that is off).  Rows past the last
//     whole tile are read one a thread.
//   - grid: persistent, the blocks that fit on the SMs by the occupancy
//     calculator (registers and cap x 1 KB of counters a block), walking
//     whole tiles of 2 x kUnroll x 256 rows.
//   - one reduction a block at the end: a warp sums each group's 256
//     counters (in uint64, 8 a lane, then a butterfly) and adds the total
//     to the output with one global 64-bit atomic.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, Q1's shape:
// 0.203-0.240 ms a launch timed alone (67-79% of the byte bound),
// 0.185-0.187 ms a launch back to back (86-87%).
// What was kept, and why: unrolls of 4, 8 and 16 and evict-first against
// read-only loads timed within a few percent of each other.  A variant
// that streamed both inputs with 1-D TMA bulk copies (cp.async.bulk into
// a 2- to 4-stage shared ring, one producer warp, mbarriers) was 3-4%
// faster, for a producer warp, mbarrier phases and an aligned-only input
// path; the plain loads stay as the simpler design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kThreads = 256;   // block size and the counter table's row length
constexpr int kUnroll = 8;      // id pairs (and their flags) in flight a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void count_row(unsigned* col, unsigned flag,
                                          long long g, int cap) {
  if (flag != 0u && (unsigned long long)g < (unsigned long long)cap) {
    col[(int)g * kThreads] += 1u;
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_count_kernel(const uint8_t* __restrict__ flags,
                     const long long* __restrict__ gid, long long n, int head,
                     int cap, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned cnt[];  // [cap][kThreads]
  unsigned* col = cnt + threadIdx.x;
  for (int k = 0; k < cap; ++k) col[k * kThreads] = 0u;
  // each thread touches only its own column until the reduction

  constexpr long long kTile = (long long)kThreads * kUnroll;  // row pairs
  const long long full = ((n - head) >> 1) / kTile;
  const longlong2* gv = reinterpret_cast<const longlong2*>(gid + head);
  const unsigned short* fv = reinterpret_cast<const unsigned short*>(flags + head);
  for (long long t = blockIdx.x; t < full; t += gridDim.x) {
    const long long j = t * kTile + threadIdx.x;
    longlong2 g[kUnroll];
    unsigned f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = __ldcs(gv + j + u * kThreads);
      f[u] = __ldcs(fv + j + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count_row(col, f[u] & 0xffu, g[u].x, cap);
      count_row(col, f[u] >> 8, g[u].y, cap);
    }
  }
  // the head row and the rows past the last whole tile, one a thread
  const long long rest = head + 2 * full * kTile;
  const long long nscalar = head + (n - rest);
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < nscalar; i += nthreads) {
    const long long r = i < head ? i : rest + (i - head);
    count_row(col, flags[r], gid[r], cap);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < cap; k += kThreads / 32) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int i = lane; i < kThreads; i += 32) s += cnt[k * kThreads + i];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0 && s != 0ull) atomicAdd(out + k, s);
  }
}

}  // namespace

// C entry (bound with ctypes).  `flags` is a bool/uint8 [n] tensor, `gid`
// an 8-byte aligned int64 [n] tensor; when `gid` is 8 bytes off 16 the
// flags lie at an odd address, else at an even one.  `out` is a zeroed
// int64 [cap] tensor.  Sizes its own persistent grid.  Returns
// cudaGetLastError().
extern "C" int grouped_count_launch(const void* flags, const void* gid,
                                    long long n, int cap, void* out,
                                    void* stream) {
  if (cap < 1 || cap > kMaxGroups || n < 0 || ((uintptr_t)gid & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int head = (n > 0 && ((uintptr_t)gid & 15) != 0) ? 1 : 0;
  if (n > 0 && (((uintptr_t)flags + head) & 1) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)cap * kThreads * 4;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grouped_count_kernel, kThreads, smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || per_sm < 1) {
    const int rc = (int)cudaGetLastError();
    return rc != 0 ? rc : (int)cudaErrorInvalidConfiguration;
  }
  const long long tile_rows = 2LL * kThreads * kUnroll;
  long long blocks = (n + tile_rows - 1) / tile_rows;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  if (n / (blocks * kThreads) >= (1LL << 30)) {
    return (int)cudaErrorInvalidValue;  // a uint32 counter could wrap
  }
  grouped_count_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const long long*)gid, n, head, cap,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
