// Grouped count of set flags for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_count_kernel` (wrapper
// `grouped_count`, gate `seg_count_maybe`), the per-group count behind
// the unfused aggregation path's `_seg_count` at small group capacities.
//
// The TPU version summed 0/1 float32 planes because its vector unit has
// no integer multiply-accumulate; here counts are integers throughout.
// Bound on the H100: memory, 1 byte of flag + 8 bytes of int64 group id
// a row against 3.35 TB/s.  Design:
//   - warp-uniform grid-stride loop, rows >= n masked;
//   - rows whose flag is false or whose group id lies outside [0, cap)
//     are skipped;
//   - the lanes of a warp that share a group id are found with
//     __match_any_sync and counted with one shared-memory atomic by
//     their leader (popcount of the peer mask);
//   - one global int64 atomic per group and block at the end.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void grouped_count_kernel(const uint8_t* flags, const int64_t* gid,
                                     long long n, int cap,
                                     unsigned long long* out) {
  __shared__ unsigned long long cnt[kMaxGroups];
  for (int i = threadIdx.x; i < cap; i += blockDim.x) cnt[i] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * 32; base < n; base += nwarps * 32) {
    const long long row = base + lane;
    long long g = -1;
    if (row < n && flags[row] != 0) g = gid[row];
    const bool ok = g >= 0 && g < cap;
    const unsigned act = __ballot_sync(kFull, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(act, (int)g);
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&cnt[g], (unsigned long long)__popc(peers));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    if (cnt[i] != 0ull) atomicAdd(&out[i], cnt[i]);
  }
}

}  // namespace

// C entry (bound with ctypes).  `flags` is a bool/uint8 [n] tensor, `gid`
// an int64 [n] tensor, `out` a zeroed int64 [cap] tensor.  Returns
// cudaGetLastError().
extern "C" int grouped_count_launch(const void* flags, const void* gid,
                                    long long n, int cap, void* out,
                                    int blocks, void* stream) {
  if (cap < 1 || cap > kMaxGroups || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  grouped_count_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const int64_t*)gid, n, cap,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
