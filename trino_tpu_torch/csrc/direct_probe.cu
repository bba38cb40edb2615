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
// ok, 1 of sel read and 8 of row, 1 of matched written (19 B), plus the
// 32-byte table sectors the keys touch, each once at best.  A table that
// fits the 50 MB L2 (Q3's custkey join: 6 MB at SF10) is served from it,
// one 32-byte sector of L2 traffic a probe; a larger one (orderkey: 240
// MB, one sector in four touched by TPC-H's sparse order keys) misses to
// device memory, which moves 64-byte atoms, so each touched sector costs
// about twice its bytes there.  Custkey is therefore held by L2 (7.78 M
// random sectors = 249 MB of L2 reads beside 148 MB of streams), not by
// device memory.  The TPU kernel kept the table in VMEM; there is no 240
// MB on-chip store here, so the design hides the gathers' latency behind
// the streams instead:
//   - warp tiles: a warp owns tiles of kTile = 32 x kR rows (kR = 8) and
//     walks them persistently (grid-stride over all warps of the grid);
//     warps never wait on each other, so a warp whose gathers are slow
//     holds up no one (no block barrier);
//   - a two-stage ring a warp in shared memory: while the warp's table
//     reads of tile i wait, the cp.async copies of its tile i + 1 (keys,
//     ok, sel, 16 bytes a lane) are in flight; a stage is published with
//     cp.async.wait_group + __syncwarp;
//   - lane t takes rows t, t + 32, ... of the tile, so a warp instruction
//     reads 32 consecutive keys from the stage (conflict free) and its
//     gather touches the one or two table sectors of 32 neighbouring
//     rows when the keys are nearly sorted (TPC-H lineitem in order-key
//     order); each lane issues its kR table reads (ld.global.nc with an
//     L2 evict-last policy, so the streams do not push the table out)
//     before using any, and reads ok and sel from the stage while they
//     are in flight;
//   - outputs leave 16 bytes a store, evict-first: `matched` from one
//     __ballot_sync a row step (kept in the consumed stage), 16 bits
//     spread into 16 bytes by lanes 0-15; `row` through the consumed
//     stage's key region (8 bytes a row, also for int32 keys), read back
//     as row pairs;
//   - grid: kBlocksPerSm blocks of 8 warps an SM (16 warps), below the 4
//     that registers and shared memory allow: with 3 to 5 blocks an SM
//     custkey ran slower (more random requests queued at L2, presumably)
//     and orderkey no faster;
//   - key arithmetic in uint64 so the wrap is defined;
//   - the last, ragged tile takes the same path: cp.async copies the
//     bytes that exist (src-size) and only rows below n are stored.
// Streams start 16-byte aligned (the wrapper copies a view that does not).
// Measured times are in PERF.md (chip_smoke.py's [timing] lines).
// Tried on the card and not kept (an exploratory script, not in the
// repository, timing variants at Q3-like shapes in one call each):
//   - an L2 evict-first policy on the streams' cp.async: an illegal
//     instruction at run time with a source size, and without one in
//     most builds, though ptxas takes both; the streams go unhinted;
//   - 16 rows a lane (4 warps a block): slower at custkey, and spills;
//   - 3 stages, or 4 warps a block at 4 to 9 blocks an SM: no faster;
//   - 5 blocks an SM (launch bounds, 48 registers) or 4: custkey slower;
//   - table reads without the evict-last policy: custkey slightly slower.
// Not tried: 1-D TMA bulk copies in place of cp.async (grouped_count.cu's
// note finds them 3-4% faster for plain streaming); orderkey's streams
// and table atoms already move at close to the memory rate, and custkey
// is held by L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                       // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 8;                           // rows a lane a tile: table reads in flight
constexpr int kTile = 32 * kR;                  // rows a warp tile
constexpr int kStages = 2;                      // tiles a warp holds: this one + the next
constexpr int kBlocksPerSm = 2;                 // the grid's cap (see the note)
constexpr int kKeyBytes = kTile * 8;            // keys (and then rows) at 8 bytes a row
constexpr int kStageBytes = kKeyBytes + 2 * kTile;  // + ok + sel
constexpr int kSmem = kWarps * kStages * kStageBytes;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kR % 2 == 0 && kSmem <= 48 * 1024, "static shared memory");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes to shared memory, of which the first `bytes` (1-16) are read
// from `src` and the rest zero-filled; L2 only (.cg), at the default
// priority: a cp.async that carries an L2 cache policy faults on the card
// (an illegal instruction at run time, though ptxas takes it).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the oldest tile's copies: all but the kStages - 2 newest groups
__device__ __forceinline__ void cp_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ int ld_table(const int32_t* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;\n"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// The warp copies rows [base, base + kTile) of the three streams that
// exist (below n) into `stage`: 16-byte chunks, consecutive lanes on
// consecutive chunks.
template <typename Key>
__device__ __forceinline__ void issue(unsigned char* stage, const Key* key, const uint8_t* ok,
                                      const uint8_t* sel, long long base, long long n,
                                      int lane) {
  const long long left = n - base;
  const int rows = left < kTile ? (int)left : kTile;
  const int kbytes = rows * (int)sizeof(Key);
  const char* ksrc = reinterpret_cast<const char*>(key + base);
#pragma unroll
  for (int c = lane * 16; c < kTile * (int)sizeof(Key); c += 32 * 16) {
    if (c < kbytes) cp_async16(stage + c, ksrc + c, min(16, kbytes - c));
  }
#pragma unroll
  for (int c = lane; c < 2 * (kTile / 16); c += 32) {
    const int which = c / (kTile / 16), off = (c % (kTile / 16)) * 16;
    if (off < rows) {
      const uint8_t* src = (which ? sel : ok) + base + off;
      cp_async16(stage + kKeyBytes + which * kTile + off, src, min(16, rows - off));
    }
  }
}

// 16 bits of a ballot as 16 bytes of 0/1, lowest bit first
__device__ __forceinline__ uint4 spread16(unsigned b) {
  const auto nib = [](unsigned x) { return ((x & 0xFu) * 0x00204081u) & 0x01010101u; };
  return make_uint4(nib(b), nib(b >> 4), nib(b >> 8), nib(b >> 12));
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
direct_probe_kernel(const int32_t* __restrict__ table, long long domain,
                    const Key* __restrict__ key, const uint8_t* __restrict__ ok,
                    const uint8_t* __restrict__ sel, long long lo, long long n,
                    long long* __restrict__ row, uint8_t* __restrict__ matched) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = smem + warp * (kStages * kStageBytes);
  const uint64_t table_pol = policy_evict_last();
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long step = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + warp;
  // the copies of the next kStages - 1 tiles are in flight while a tile
  // is probed; one commit group a tile, empty past the end
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long ahead = tile + s * step;
    if (ahead < ntiles) {
      issue(ring + s * kStageBytes, key, ok, sel, ahead * kTile, n, lane);
    }
    cp_commit();
  }
  int st = 0;
  for (; tile < ntiles; tile += step) {
    // the tile's copies have landed (each lane waits for its own, the
    // warp barrier publishes them) and every lane is done with the stage
    // the next copy overwrites
    cp_wait_oldest();
    __syncwarp();
    const long long ahead = tile + (kStages - 1) * step;
    if (ahead < ntiles) {
      issue(ring + ((st + kStages - 1) % kStages) * kStageBytes, key, ok, sel, ahead * kTile, n,
            lane);
    }
    cp_commit();
    unsigned char* stage = ring + st * kStageBytes;
    const long long base = tile * kTile;
    const int rows = n - base < kTile ? (int)(n - base) : kTile;
    const Key* ks = reinterpret_cast<const Key*>(stage);
    long long kv[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int r = 32 * u + lane;
      kv[u] = r < rows ? (long long)((unsigned long long)(long long)ks[r] -
                                     (unsigned long long)lo)
                       : 0;
    }
    int slot[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const long long c = kv[u] < 0 ? 0 : (kv[u] >= domain ? domain - 1 : kv[u]);
      slot[u] = 32 * u + lane < rows ? ld_table(table + c, table_pol) : 0;
    }
    unsigned live = 0u;  // bit u: sel & ok & in_dom of row 32 u + lane
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int r = 32 * u + lane;
      const bool in_dom = kv[u] >= 0 && kv[u] < domain;
      const bool on = r < rows && (stage[kKeyBytes + r] != 0) &
                                      (stage[kKeyBytes + kTile + r] != 0) & in_dom;
      live |= (unsigned)on << u;
    }
    // every lane has read its keys, ok and sel: the stage takes the
    // outputs, the rows in the key region and the ballots in ok's
    __syncwarp();
    long long* out = reinterpret_cast<long long*>(stage);
    unsigned* bal = reinterpret_cast<unsigned*>(stage + kKeyBytes);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      out[32 * u + lane] = (long long)(int32_t)((uint32_t)slot[u] - 1u);
      const unsigned b = __ballot_sync(kFull, ((live >> u) & 1u) && slot[u] > 0);
      if (lane == 0) bal[u] = b;
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kR / 2; ++v) {
      const int p = 64 * v + 2 * lane;
      if (p + 1 < rows) {
        __stcs(reinterpret_cast<longlong2*>(row + base + p),
               reinterpret_cast<const longlong2*>(out)[32 * v + lane]);
      } else if (p < rows) {
        row[base + p] = out[p];
      }
    }
    for (int c = lane; c < kTile / 16; c += 32) {  // 16 rows of matched a lane
      const unsigned bits = (bal[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu;
      const int r0 = 16 * c;
      if (r0 + 16 <= rows) {
        __stcs(reinterpret_cast<uint4*>(matched + base + r0), spread16(bits));
      } else {
        for (int j = 0; r0 + j < rows; ++j) matched[base + r0 + j] = (bits >> j) & 1u;
      }
    }
    st = (st + 1) % kStages;
  }
}

template <typename Key>
cudaError_t resident_of(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, direct_probe_kernel<Key>,
                                                       kThreads, 0);
}

}  // namespace

// The persistent grid's blocks on the card `device`: kBlocksPerSm an SM,
// or fewer where the occupancy calculator fits fewer (the smaller of the
// two key types'), times the SMs, into *blocks.  The wrapper asks once a
// device and sizes each launch from it.  Returns a cudaError_t.
extern "C" int direct_probe_grid(int device, int* blocks) {
  int prev = 0, sms = 0, a = 0, b = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = resident_of<long long>(&a);
  if (e == cudaSuccess) e = resident_of<int32_t>(&b);
  const cudaError_t back = cudaSetDevice(prev);
  if (e != cudaSuccess) return (int)e;
  if (back != cudaSuccess) return (int)back;
  const int per_sm = a < b ? a : b;
  *blocks = (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm) * sms;
  return *blocks >= 1 ? (int)cudaSuccess : (int)cudaErrorInvalidConfiguration;
}

// C entry (bound with ctypes).  `table` is an int32 [domain] tensor
// (domain >= 1), `key` an int64 (key_bytes 8) or int32 (key_bytes 4) [n]
// tensor, `ok`/`sel` bool [n], `row` an int64 [n] and `matched` a bool [n]
// output; key, ok, sel, row and matched start 16-byte aligned.  `blocks`
// is the persistent grid (at least 1).  Returns cudaGetLastError().
extern "C" int direct_probe_launch(const void* table, long long domain,
                                   const void* key, int key_bytes,
                                   const void* ok, const void* sel,
                                   long long lo, long long n, void* row,
                                   void* matched, int blocks, void* stream) {
  if (domain < 1 || n < 0 || blocks < 1 || (key_bytes != 4 && key_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t any = (uintptr_t)key | (uintptr_t)ok | (uintptr_t)sel | (uintptr_t)row |
                        (uintptr_t)matched;
  if ((any & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 8) {
    direct_probe_kernel<long long><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)table, domain, (const long long*)key, (const uint8_t*)ok,
        (const uint8_t*)sel, lo, n, (long long*)row, (uint8_t*)matched);
  } else {
    direct_probe_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)table, domain, (const int32_t*)key, (const uint8_t*)ok,
        (const uint8_t*)sel, lo, n, (long long*)row, (uint8_t*)matched);
  }
  return (int)cudaGetLastError();
}
