// Exact grouped int64 sum for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_plane_kernel` (wrapper
// `grouped_sum_i64`), which split each int64 value into four 16-bit
// planes, summed each plane per group in int32 (the TPU's vector unit has
// no 64-bit accumulate) and recombined the planes mod 2^64 in the wrapper.
// CUDA has 64-bit integer adds and a 64-bit atomicAdd on unsigned long
// long that wraps mod 2^64, so the plane split is gone: the sums here are
// the same residues mod 2^64 as the recombined planes.
//
// Bound on the H100: memory, 8 bytes of value + 8 bytes of int64 group id
// a row against 3.35 TB/s.  The caller's segment sums hit few hot slots
// (Q1: 12), where one global atomic per row serialises; design:
//   - warp-uniform grid-stride loop, rows >= n masked;
//   - rows whose group id lies outside [0, cap) are skipped;
//   - the lanes of a warp that share a group id are found with
//     __match_any_sync; for each distinct group the warp sums the group's
//     values with a butterfly shuffle and its first lane adds the total
//     to a per-block shared table of cap slots;
//   - one global atomic per slot and block at the end.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void grouped_sum_kernel(const long long* __restrict__ values,
                                   const long long* __restrict__ gid,
                                   long long n, int cap,
                                   unsigned long long* out) {
  __shared__ unsigned long long acc[kMaxGroups];
  for (int i = threadIdx.x; i < cap; i += blockDim.x) acc[i] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * 32; base < n; base += nwarps * 32) {
    const long long row = base + lane;
    long long g = -1;
    unsigned long long v = 0ull;
    if (row < n) {
      g = gid[row];
      v = (unsigned long long)values[row];
    }
    const bool ok = g >= 0 && g < cap;
    if (__ballot_sync(kFull, ok) == 0u) continue;
    // every lane takes part; the skipped lanes share the key -1
    const unsigned peers = __match_any_sync(kFull, ok ? (int)g : -1);
    unsigned leaders = __ballot_sync(kFull, ok && lane == __ffs(peers) - 1);
    while (leaders) {
      const int leader = __ffs(leaders) - 1;
      const unsigned group = __shfl_sync(kFull, peers, leader);
      unsigned long long s = ((group >> lane) & 1u) ? v : 0ull;
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == leader) atomicAdd(&acc[g], s);
      leaders &= leaders - 1u;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    if (acc[i] != 0ull) atomicAdd(&out[i], acc[i]);
  }
}

}  // namespace

// C entry (bound with ctypes).  `values` and `gid` are int64 [n] tensors,
// `out` a zeroed int64 [cap] tensor.  Returns cudaGetLastError().
extern "C" int grouped_sum_launch(const void* values, const void* gid,
                                  long long n, int cap, void* out,
                                  int blocks, void* stream) {
  if (cap < 1 || cap > kMaxGroups || blocks < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  grouped_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)values, (const long long*)gid, n, cap,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
