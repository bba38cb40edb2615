// Fused scan -> filter -> aggregate megakernel for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_fused_agg_kernel` (wrapper
// `fused_agg_sums`), the TPU megakernel that streams every referenced
// scan column once and returns exact int64 per-(term, group) sums.
//
// On the TPU the per-row work was a Python closure traced into Mosaic.  A
// CUDA kernel cannot take a closure, and a .cu file per query would not be
// built from the repository's own sources, so the plan-time compiler
// (trino_tpu_torch/ops/megakernel.py) emits a short postfix program over
// int32 values instead and this one kernel interprets it per row:
//   program 0: predicate (empty = true)
//   program 1: mixed-radix group id (empty = group 0)
//   program 2..: one value per aggregate term
// The interval proofs of the compiler keep every value inside int32, and
// the arithmetic wraps like the plain version's int32 tensor ops.
//
// Bound on the H100: memory.  Each referenced int32 column and the 1-byte
// live mask are read once (Q1: 7 columns + mask = 29 bytes a row, ~0.5 ms
// at SF10 against 3.35 TB/s).  Design:
//   - warp-uniform grid-stride loop, 32 consecutive rows per warp step,
//     rows >= n masked, so every lane takes part in the shuffles;
//   - the program, its segment table and the per-block int64 accumulator
//     table [n_terms x groups] live in shared memory;
//   - each term value is summed across the lanes that share a group id
//     (ballot + butterfly shuffle in int64), and one lane per group adds
//     it to the shared table: one shared atomic per (warp step, term,
//     distinct group) instead of one per row;
//   - one global int64 atomic per table slot and block at the end.
// The TPU's lax.scan over [2048, 128] chunks was a Mosaic toolchain limit
// and is not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kMaxTerms = 64;
constexpr int kMaxCode = 2048;  // instructions (op, imm)
constexpr int kStack = 16;
constexpr unsigned kFull = 0xffffffffu;

enum Op : int32_t {
  OP_LOAD = 0, OP_CONST = 1, OP_ADD = 2, OP_SUB = 3, OP_NEG = 4,
  OP_MUL = 5, OP_LO16 = 6, OP_HI16 = 7, OP_EQ = 8, OP_NE = 9, OP_LT = 10,
  OP_LE = 11, OP_GT = 12, OP_GE = 13, OP_AND = 14, OP_OR = 15,
  OP_NOT = 16, OP_CLIP = 17,
};

__device__ __forceinline__ int32_t wrap(uint32_t v) {
  return static_cast<int32_t>(v);
}

// Evaluate one program for one row; the compiler proved its stack depth
// fits kStack.  Signed overflow is avoided by computing in uint32 (the
// same two's-complement wrap as torch int32 arithmetic).
__device__ int32_t run(const int2* code, int start, int len,
                       const int32_t* const* cols, long long row) {
  int32_t st[kStack];
  int sp = 0;
  for (int pc = start; pc < start + len; ++pc) {
    const int2 in = code[pc];
    switch (in.x) {
      case OP_LOAD: st[sp++] = __ldg(cols[in.y] + row); break;
      case OP_CONST: st[sp++] = in.y; break;
      case OP_ADD: --sp; st[sp - 1] = wrap((uint32_t)st[sp - 1] + (uint32_t)st[sp]); break;
      case OP_SUB: --sp; st[sp - 1] = wrap((uint32_t)st[sp - 1] - (uint32_t)st[sp]); break;
      case OP_NEG: st[sp - 1] = wrap(0u - (uint32_t)st[sp - 1]); break;
      case OP_MUL: --sp; st[sp - 1] = wrap((uint32_t)st[sp - 1] * (uint32_t)st[sp]); break;
      case OP_LO16: st[sp - 1] &= 0xFFFF; break;
      case OP_HI16: st[sp - 1] >>= 16; break;  // arithmetic shift
      case OP_EQ: --sp; st[sp - 1] = st[sp - 1] == st[sp]; break;
      case OP_NE: --sp; st[sp - 1] = st[sp - 1] != st[sp]; break;
      case OP_LT: --sp; st[sp - 1] = st[sp - 1] < st[sp]; break;
      case OP_LE: --sp; st[sp - 1] = st[sp - 1] <= st[sp]; break;
      case OP_GT: --sp; st[sp - 1] = st[sp - 1] > st[sp]; break;
      case OP_GE: --sp; st[sp - 1] = st[sp - 1] >= st[sp]; break;
      case OP_AND: --sp; st[sp - 1] = (st[sp - 1] != 0) & (st[sp] != 0); break;
      case OP_OR: --sp; st[sp - 1] = (st[sp - 1] != 0) | (st[sp] != 0); break;
      case OP_NOT: st[sp - 1] = st[sp - 1] == 0; break;
      case OP_CLIP: st[sp - 1] = min(max(st[sp - 1], 0), in.y - 1); break;
      default: break;
    }
  }
  return sp ? st[sp - 1] : 0;
}

__global__ void fused_agg_kernel(const int32_t* const* cols,
                                 const uint8_t* live, long long n,
                                 const int2* code, int code_len,
                                 const int32_t* seg, int n_terms, int groups,
                                 unsigned long long* out) {
  __shared__ int2 scode[kMaxCode];
  __shared__ int32_t sseg[2 * (2 + kMaxTerms)];
  extern __shared__ unsigned long long acc[];  // [n_terms * groups]
  const int slots = n_terms * groups;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) acc[i] = 0ull;
  for (int i = threadIdx.x; i < code_len; i += blockDim.x) scode[i] = code[i];
  for (int i = threadIdx.x; i < 2 * (2 + n_terms); i += blockDim.x) sseg[i] = seg[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * 32; base < n; base += nwarps * 32) {
    const long long row = base + lane;
    bool ok = row < n && live[row] != 0;
    if (ok && sseg[1] > 0) ok = run(scode, sseg[0], sseg[1], cols, row) != 0;
    int32_t gid = 0;
    if (ok && sseg[3] > 0) {
      gid = run(scode, sseg[2], sseg[3], cols, row);
      ok = gid >= 0 && gid < groups;
    }
    const unsigned alive = __ballot_sync(kFull, ok);
    if (alive == 0u) continue;
    for (int t = 0; t < n_terms; ++t) {
      const long long v =
          ok ? (long long)run(scode, sseg[4 + 2 * t], sseg[5 + 2 * t], cols, row) : 0ll;
      unsigned rest = alive;
      while (rest) {
        const int leader = __ffs(rest) - 1;
        const int32_t g = __shfl_sync(kFull, gid, leader);
        const bool mine = ok && gid == g;
        const unsigned peers = __ballot_sync(kFull, mine);
        long long s = mine ? v : 0ll;
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (lane == leader) atomicAdd(&acc[t * groups + g], (unsigned long long)s);
        rest &= ~peers;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    if (acc[i] != 0ull) atomicAdd(&out[i], acc[i]);
  }
}

}  // namespace

// C entry (bound with ctypes).  `cols` is a device array of n_cols int32
// column pointers; `code` holds code_len (op, imm) int32 pairs; `seg`
// holds (start, len) of the 2 + n_terms programs; `out` is a zeroed
// int64 [n_terms, groups] tensor.  Returns cudaGetLastError().
extern "C" int fused_agg_sums_launch(const void* cols, const void* live,
                                     long long n, const void* code,
                                     int code_len, const void* seg,
                                     int n_terms, int groups, void* out,
                                     int blocks, void* stream) {
  if (code_len < 0 || code_len > kMaxCode || n_terms < 1 ||
      n_terms > kMaxTerms || groups < 1 || groups > kMaxGroups ||
      blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const size_t smem = (size_t)n_terms * groups * sizeof(unsigned long long);
  fused_agg_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t* const*)cols, (const uint8_t*)live, n,
      (const int2*)code, code_len, (const int32_t*)seg, n_terms, groups,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
