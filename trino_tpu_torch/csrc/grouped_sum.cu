// Exact grouped int64 sum for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_plane_kernel` (wrapper
// `grouped_sum_i64`), which split each int64 value into four 16-bit
// planes, summed each plane per group in int32 (the TPU's vector unit has
// no 64-bit accumulate) and recombined the planes mod 2^64 in the wrapper.
// CUDA adds 64-bit integers, and unsigned 64-bit addition wraps mod 2^64,
// so the plane split is gone: addition mod 2^64 is associative, so any
// order of the adds gives the same residues as the recombined planes.
//
// Bound on the H100: memory, 8 bytes of value + 8 bytes of int64 group id
// a row against 3.35 TB/s (Q1 at SF10: 60 M rows, 0.287 ms).  The caller
// sends only capacities up to 32, where a thread can own a slot for every
// group, so no row needs any cross-lane work.  Design:
//   - private accumulators: each thread owns a column of a [cap][256]
//     table of uint64 slots in shared memory and adds each of its rows to
//     its own slot for that row's id (ids outside [0, cap) are skipped).
//     Lane i of a warp reads and writes word i of every 256-word row, so
//     a warp's slot accesses are free of bank conflicts whatever its ids.
//     No __match_any_sync, no shuffle and no atomic in the row loop: a
//     row costs a compare, a shared load, an add and a shared store at
//     any cap.  (Slots in registers, unrolled over a compile-time cap,
//     cost about three instructions a slot and a row: 48 a row at Q1's
//     cap 12 rounded to 16, against about 6 here.)
//   - streaming: 16-byte loads (longlong2: two rows) of values and ids,
//     evict-first (__ldcs), kUnroll of each stream in flight a thread
//     before any is used; a warp's loads are contiguous 512-byte runs.
//     Base pointers 8 bytes off 16 (a view such as values[1:]) give a
//     one-row scalar head; the two streams must share their 16-byte
//     phase (the wrapper copies one that does not).  Rows past the last
//     whole tile are read one a thread.
//   - grid: persistent, the blocks that fit on the SMs by the occupancy
//     calculator (registers and cap x 2 KB of slots a block), walking
//     whole tiles of 2 x kUnroll x 256 rows.
//   - one reduction a block at the end: a warp sums each slot's 256
//     words (8 a lane, then a butterfly) and adds the total to the output
//     with one global 64-bit atomic.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, Q1's shape:
// 0.332-0.345 ms a launch timed alone (83-86% of the byte bound),
// 0.313-0.315 ms a launch back to back (91%).
// What was kept, and why: unrolls of 2, 4 and 8 and evict-first against
// read-only loads timed within a few percent of each other.  A variant
// that streamed both inputs with 1-D TMA bulk copies (cp.async.bulk into
// a 2- to 4-stage shared ring, one producer warp, mbarriers) gained no
// more than a few percent for a producer warp, mbarrier phases and an
// aligned-only input path; the plain loads stay as the simpler design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kThreads = 256;   // block size and the slot table's row length
constexpr int kUnroll = 4;      // 16-byte loads of each stream in flight a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = kMaxGroups * kThreads * 8;

__device__ __forceinline__ void add_row(unsigned long long* col, long long g,
                                        long long v, int cap) {
  if ((unsigned long long)g < (unsigned long long)cap) {
    col[(int)g * kThreads] += (unsigned long long)v;
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_sum_kernel(const long long* __restrict__ values,
                   const long long* __restrict__ gid, long long n, int head,
                   int cap, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long tab[];  // [cap][kThreads]
  unsigned long long* col = tab + threadIdx.x;
  for (int k = 0; k < cap; ++k) col[k * kThreads] = 0ull;
  // each thread touches only its own column until the reduction

  constexpr long long kTile = (long long)kThreads * kUnroll;  // vectors
  const long long full = ((n - head) >> 1) / kTile;
  const longlong2* vv = reinterpret_cast<const longlong2*>(values + head);
  const longlong2* gv = reinterpret_cast<const longlong2*>(gid + head);
  for (long long t = blockIdx.x; t < full; t += gridDim.x) {
    const long long j = t * kTile + threadIdx.x;
    longlong2 v[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldcs(vv + j + u * kThreads);
      g[u] = __ldcs(gv + j + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_row(col, g[u].x, v[u].x, cap);
      add_row(col, g[u].y, v[u].y, cap);
    }
  }
  // the head row and the rows past the last whole tile, one a thread
  const long long rest = head + 2 * full * kTile;
  const long long nscalar = head + (n - rest);
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < nscalar; i += nthreads) {
    const long long r = i < head ? i : rest + (i - head);
    add_row(col, gid[r], values[r], cap);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < cap; k += kThreads / 32) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int i = lane; i < kThreads; i += 32) s += tab[k * kThreads + i];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0 && s != 0ull) atomicAdd(out + k, s);
  }
}

}  // namespace

// C entry (bound with ctypes).  `values` and `gid` are int64 [n] tensors
// at the same 16-byte phase (8-byte aligned), `out` a zeroed int64 [cap]
// tensor.  Sizes its own persistent grid.  Returns cudaGetLastError().
extern "C" int grouped_sum_launch(const void* values, const void* gid,
                                  long long n, int cap, void* out,
                                  void* stream) {
  if (cap < 1 || cap > kMaxGroups || n < 0 || ((uintptr_t)values & 7) != 0 ||
      (((uintptr_t)values ^ (uintptr_t)gid) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int head = (n > 0 && ((uintptr_t)values & 15) != 0) ? 1 : 0;
  // the blocks that fit on an SM, after raising the kernel's dynamic
  // shared memory limit to the 64 KB that cap 32 needs
  const size_t smem = (size_t)cap * kThreads * 8;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(grouped_sum_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grouped_sum_kernel, kThreads, smem) != cudaSuccess ||
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
  grouped_sum_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)values, (const long long*)gid, n, head, cap,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
