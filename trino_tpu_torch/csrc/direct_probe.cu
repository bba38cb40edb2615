// Direct-address join probe for Hopper (sm_90a).
//
// Replaces: the anonymous VMEM gather `kernel` of scripts/micro_probe.py
// (`out[i] = table[probe[i]]` with the build table resident in VMEM), the
// join-lookup gather behind trino_tpu/ops/join.py `probe_direct`.  This
// kernel computes the whole of probe_direct's function per probe row:
//   kv      = key - lo                       (int64, wrapping)
//   in_dom  = 0 <= kv < domain
//   slot    = table[clip(kv, 0, domain - 1)] (int32: build row + 1, 0 = empty)
//   matched = sel & ok & in_dom & (slot > 0)
//   row     = (int64)(slot - 1)              (int32 subtraction, as JAX)
// Every row reads its slot, matched or not, so the unmatched rows' `row`
// (which a left join carries under NULL) is the same as the reference's.
//
// Bound on the H100: memory.  Per probe row 8 (or 4) bytes of key, 1 of
// ok, 1 of sel read and 8 of row, 1 of matched written; the table is read
// once at best.  A table that fits the 50 MB L2 (custkey: 6 MB at SF10)
// is served from it; a larger one (orderkey: 240 MB) misses and each
// probe costs a 32-byte sector of device memory.  The TPU kernel kept the
// table in VMEM; here there is no 240 MB on-chip store, so the design
// hides the latency of the random reads instead:
//   - one thread per row, grid-stride; each thread takes kUnroll rows a
//     step (rows a block-width apart, so every load is coalesced across
//     the warp) and issues their kUnroll table reads before using any;
//   - table reads go through the read-only path (__ldg);
//   - key arithmetic in uint64 so the wrap is defined.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename Key>
__global__ void direct_probe_kernel(const int32_t* __restrict__ table,
                                    long long domain,
                                    const Key* __restrict__ key,
                                    const uint8_t* __restrict__ ok,
                                    const uint8_t* __restrict__ sel,
                                    long long lo, long long n,
                                    long long* __restrict__ row,
                                    uint8_t* __restrict__ matched) {
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < n; base += step) {
    long long kv[kUnroll];
    int32_t slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      kv[u] = 0;
      if (i < n) {
        kv[u] = (long long)((unsigned long long)(long long)key[i] -
                            (unsigned long long)lo);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      const long long c = kv[u] < 0 ? 0 : (kv[u] >= domain ? domain - 1 : kv[u]);
      slot[u] = i < n ? __ldg(table + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i >= n) continue;
      const bool in_dom = kv[u] >= 0 && kv[u] < domain;
      matched[i] = (sel[i] != 0) & (ok[i] != 0) & in_dom & (slot[u] > 0);
      row[i] = (long long)(int32_t)((uint32_t)slot[u] - 1u);
    }
  }
}

}  // namespace

// C entry (bound with ctypes).  `table` is an int32 [domain] tensor
// (domain >= 1), `key` an int64 (key_bytes 8) or int32 (key_bytes 4) [n]
// tensor, `ok`/`sel` bool [n], `row` an int64 [n] and `matched` a bool [n]
// output.  Returns cudaGetLastError().
extern "C" int direct_probe_launch(const void* table, long long domain,
                                   const void* key, int key_bytes,
                                   const void* ok, const void* sel,
                                   long long lo, long long n, void* row,
                                   void* matched, int blocks, void* stream) {
  if (domain < 1 || n < 0 || blocks < 1 || (key_bytes != 4 && key_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 8) {
    direct_probe_kernel<long long><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)table, domain, (const long long*)key,
        (const uint8_t*)ok, (const uint8_t*)sel, lo, n, (long long*)row,
        (uint8_t*)matched);
  } else {
    direct_probe_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)table, domain, (const int32_t*)key,
        (const uint8_t*)ok, (const uint8_t*)sel, lo, n, (long long*)row,
        (uint8_t*)matched);
  }
  return (int)cudaGetLastError();
}
