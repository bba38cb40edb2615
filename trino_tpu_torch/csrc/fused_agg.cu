// Fused scan -> filter -> aggregate megakernel for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/pallas_kernels.py `_fused_agg_kernel` (wrapper
// `fused_agg_sums`), the TPU megakernel that streams every referenced
// scan column once and returns exact int64 per-(term, group) sums of
// int32 values, over live rows that pass the predicate and whose group
// id lies in [0, groups).
//
// On the TPU the per-row work was a Python closure traced into Mosaic.
// A CUDA kernel cannot take a closure and the repository builds no
// per-query source, so the plan-time encoder (ops/kernels.encode) turns
// the query's postfix program into one straight-line program with
// constants folded, common subexpressions shared, the predicate's
// conjuncts ANDed into a row mask one by one, and every value in a slot
// allocated at plan time.  The program and the lane pointers travel in
// the launch's own parameters (a __grid_constant__ struct), so a launch
// needs no copy and no host sync.
//
// Bound on the H100: memory.  Each lane is read once as the scan stores
// it: int64 or int32 values of the columns the program reads, each
// column's bool validity lane and the bool live lane (Q6: 3 x 8 + 4 +
// 5 x 1 = 33 bytes a row, 0.59 ms at SF10 against 3.35 TB/s).  Design:
//   - a block takes a tile of blockDim x kR rows (kR = 4) at a time; a
//     persistent grid, sized by the occupancy calculator and by the
//     shared memory a program needs (blocks of 256 down to 32 threads,
//     so wide programs still fit), strides over the tiles;
//   - while a tile is computed, the block copies the next one into the
//     other stage of a two-stage ring with cp.async: each lane's tile as
//     it lies, consecutive threads on consecutive 16-byte chunks, so a
//     warp instruction reads 512 contiguous bytes (a thread copying its
//     own rows would read int64 lanes in 16 of every 32 bytes); lanes
//     start 16-byte aligned (the wrapper copies a view that does not);
//     one barrier a tile publishes the copy and frees the stage read
//     before;
//   - a thread owns two pairs of rows, side by side with its warp's, so
//     reading them from the stage is free of bank conflicts; int64 lanes
//     are narrowed to their low word there (the wrap of .to(torch.int32));
//     validity and live lanes AND into a per-row mask bit in a register;
//   - one dispatch per instruction per tile: the opcode switch sits
//     outside the thread's rows, whose operands come from its slots in
//     shared memory ([slot][thread] int4, conflict free); nothing is
//     indexed at run time in registers, so there is no stack;
//   - terms run only in warps where some row passed;
//   - groups == 1: each thread sums its rows into its own int64
//     accumulator a term (shared memory), reduced once a block;
//     groups > 1: each thread sums its own rows of a group (low and high
//     16 bits apart, exact), one full-warp redux.sync pair adds them for
//     each group present in the warp's tile, and one lane adds the int64
//     to the block's table with a shared atomic;
//   - one global int64 atomic per (term, group) and block at the end.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// rows a thread per tile and stages of the copy ring (8 or 16 rows, or 3
// stages, take more shared memory a thread: fewer warps stay resident)
constexpr int kR = 4;
constexpr int kQ = kR / 4;       // int4 quads of a slot
constexpr int kStages = 2;       // tiles in flight a block + 1
static_assert(kR % 4 == 0 && kR <= 16 && kStages >= 2, "kR: 4, 8 or 16 rows");
// Limits of one launch.  Shared memory binds first: at 32 threads a
// block takes about 80 int64 columns with validity lanes (the wrapper's
// check_program); the lane table leaves room above that.  Slots are
// 8-bit fields of an instruction, 255 meaning none.
constexpr int kMaxCols = 128;
constexpr int kMaxLanes = 2 * kMaxCols + 1;
constexpr int kMaxSlots = 255;
constexpr int kMaxTerms = 64;
constexpr int kMaxGroups = 32;
constexpr int kMaxIns = 2048;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kImm = 1, kMask = 2, kNoDst = 255;

enum Op : int {
  OP_ADD = 2, OP_SUB = 3, OP_NEG = 4, OP_MUL = 5, OP_LO16 = 6, OP_HI16 = 7,
  OP_EQ = 8, OP_NE = 9, OP_LT = 10, OP_LE = 11, OP_GT = 12, OP_GE = 13,
  OP_AND = 14, OP_OR = 15, OP_NOT = 16, OP_CLIP = 17, OP_RSUB = 18,
  OP_MOV = 19, OP_ACC = 20,
};

// A lane's region in a stage follows the regions of the lanes before it:
// threads x kR x es bytes each.
struct Lane {
  const char* ptr;  // 16-byte aligned
  int es;           // element bytes: 8 or 4 (values), 1 (bool mask lanes)
  int slot;         // slot of the narrowed values; -1 for a mask lane
};

struct Params {
  Lane lane[kMaxLanes];
  long long n;
  unsigned long long* out;
  int n_lanes, stage_bytes, n_ins, n_pre, gid_flags, gid_val;
  int n_slots, n_terms, groups;
  int2 code[kMaxIns];  // x: op | flags << 8 | dst << 16 | a << 24; y: b
};
static_assert(sizeof(Params) <= 32764, "launch parameters over CUDA 12.1's limit");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(N) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for the oldest tile's copies: all but the kStages - 2 newest groups
__device__ __forceinline__ void cp_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// The block copies each lane's tile (threads x kR rows) as it lies, into
// its region of the stage: consecutive threads copy consecutive 16-byte
// chunks, so every warp instruction reads 512 contiguous bytes (a tile
// of any lane is a multiple of 16 bytes, and starts 16-byte aligned).
// The last tile, cut short, is copied an element at a time.
__device__ __forceinline__ void issue(const Params& p, char* stage, long long row0, int tid,
                                      int threads) {
  const long long tile_rows = (long long)threads * kR;
  const long long left = p.n - row0;
  const bool whole = left >= tile_rows;
  char* dst = stage;
  for (int l = 0; l < p.n_lanes; ++l) {
    const Lane& L = p.lane[l];
    const char* src = L.ptr + row0 * L.es;
    const int bytes = (int)((whole ? tile_rows : left) * L.es);
    if (whole) {
      for (int c = tid * 16; c < bytes; c += threads * 16) cp_async<16>(dst + c, src + c);
    } else if (L.es == 8) {
      for (int c = tid * 8; c < bytes; c += threads * 8) cp_async<8>(dst + c, src + c);
    } else if (L.es == 4) {
      for (int c = tid * 4; c < bytes; c += threads * 4) cp_async<4>(dst + c, src + c);
    } else {
      for (int c = tid; c < bytes; c += threads) dst[c] = src[c];
    }
    dst += tile_rows * L.es;
  }
}

template <class F>
__device__ __forceinline__ int4 map2(int4 a, int4 b, F f) {
  return make_int4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
}

template <class F>
__device__ __forceinline__ int4 map1(int4 b, F f) {
  return make_int4(f(b.x), f(b.y), f(b.z), f(b.w));
}

__device__ __forceinline__ int wrap(unsigned v) { return static_cast<int>(v); }

__device__ __forceinline__ int comp(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Tile {
  int4* slots;  // [n_slots][kQ][threads]
  unsigned long long* acc;
  int tid, threads, lane;
  unsigned mask;      // bit r: row r counts
  unsigned present;   // groups > 1: groups with a counted row in the warp
  int key[kR];        // groups > 1: each row's group id
};

__device__ __forceinline__ int4& slot_at(const Tile& t, int s, int q) {
  return t.slots[((size_t)s * kQ + q) * t.threads + t.tid];
}

#define FA_BINARY(EXPR)                                                     \
  _Pragma("unroll") for (int q = 0; q < kQ; ++q) r[q] =                     \
      map2(slot_at(t, a, q), b[q], [](int x, int y) { return (EXPR); });    \
  break;
#define FA_UNARY(EXPR)                                                      \
  _Pragma("unroll") for (int q = 0; q < kQ; ++q) r[q] =                     \
      map1(b[q], [](int y) { return (EXPR); });                             \
  break;

// One instruction over the thread's kR rows.
template <bool kOne>
__device__ __forceinline__ void step(const Params& p, int2 in, Tile& t) {
  const int op = in.x & 0xff, fl = (in.x >> 8) & 0xff;
  const int dst = (in.x >> 16) & 0xff, a = (in.x >> 24) & 0xff;
  int4 b[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    b[q] = (fl & kImm) ? make_int4(in.y, in.y, in.y, in.y) : slot_at(t, in.y, q);
  }
  int4 r[kQ];
  switch (op) {
    case OP_ADD: FA_BINARY(wrap((unsigned)x + (unsigned)y))
    case OP_SUB: FA_BINARY(wrap((unsigned)x - (unsigned)y))
    case OP_RSUB: FA_BINARY(wrap((unsigned)y - (unsigned)x))
    case OP_MUL: FA_BINARY(wrap((unsigned)x * (unsigned)y))
    case OP_EQ: FA_BINARY(int(x == y))
    case OP_NE: FA_BINARY(int(x != y))
    case OP_LT: FA_BINARY(int(x < y))
    case OP_LE: FA_BINARY(int(x <= y))
    case OP_GT: FA_BINARY(int(x > y))
    case OP_GE: FA_BINARY(int(x >= y))
    case OP_AND: FA_BINARY(int(x != 0 && y != 0))
    case OP_OR: FA_BINARY(int(x != 0 || y != 0))
    case OP_CLIP: FA_BINARY(min(max(x, 0), y - 1))
    case OP_NEG: FA_UNARY(wrap(0u - (unsigned)y))
    case OP_LO16: FA_UNARY(y & 0xFFFF)
    case OP_HI16: FA_UNARY(y >> 16)  // arithmetic
    case OP_NOT: FA_UNARY(int(y == 0))
    case OP_ACC: {
      if constexpr (kOne) {
        long long s = 0;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          s += ((t.mask >> i) & 1u) ? (long long)comp(b[i / 4], i % 4) : 0ll;
        }
        t.acc[dst * t.threads + t.tid] += (unsigned long long)s;
      } else {
        // a thread's rows of group g: the low 16 bits (< 2^20 for 16
        // rows) and the high 16 bits (signed) apart, so the warp's sums
        // fit 32 bits
        for (unsigned rest = t.present; rest != 0u; rest &= rest - 1u) {
          const int g = __ffs(rest) - 1;
          unsigned lo = 0u;
          int hi = 0;
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const int v = comp(b[i / 4], i % 4);
            const bool in_g = ((t.mask >> i) & 1u) && t.key[i] == g;
            lo += in_g ? ((unsigned)v & 0xFFFFu) : 0u;
            hi += in_g ? (v >> 16) : 0;
          }
          lo = __reduce_add_sync(kFull, lo);
          hi = __reduce_add_sync(kFull, hi);
          if (t.lane == 0 && (lo | (unsigned)hi) != 0u) {
            atomicAdd(&t.acc[dst * p.groups + g],
                      (unsigned long long)((long long)hi * 65536 + (long long)lo));
          }
        }
      }
      return;
    }
    default:  // OP_MOV
#pragma unroll
      for (int q = 0; q < kQ; ++q) r[q] = b[q];
      break;
  }
  if (fl & kMask) {
    unsigned keep = 0u;
#pragma unroll
    for (int i = 0; i < kR; ++i) keep |= (unsigned)(comp(r[i / 4], i % 4) != 0) << i;
    t.mask &= keep;
  }
  if (dst != kNoDst) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) slot_at(t, dst, q) = r[q];
  }
}

// The thread's kR rows of one tile, the block's copy of it in `stage`.
// A thread owns kR / 2 pairs of rows: pair j is rows 2 (j x threads +
// tid) and the one after, so that the pairs of a warp lie side by side
// and reading them is free of bank conflicts; row i of the thread is
// row i % 2 of pair i / 2.
template <bool kOne>
__device__ __forceinline__ void run_tile(const Params& p, Tile& t, const char* stage,
                                         long long row0) {
  const long long left = p.n - row0;
  t.mask = 0u;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (2 * ((long long)(i / 2) * t.threads + t.tid) + i % 2 < left) t.mask |= 1u << i;
  }
  // bool lanes hold 0 or 1 a byte: AND them a word at a time, then turn
  // each word's 4 bytes into 4 mask bits with one multiply
  unsigned word[kR / 4];
#pragma unroll
  for (int k = 0; k < kR / 4; ++k) word[k] = 0x01010101u;
  const char* region = stage;
  for (int l = 0; l < p.n_lanes; ++l) {
    const Lane& L = p.lane[l];
    if (L.slot < 0) {
      const unsigned short* w = reinterpret_cast<const unsigned short*>(region) + t.tid;
#pragma unroll
      for (int k = 0; k < kR / 4; ++k) {
        word[k] &= (unsigned)w[(2 * k) * t.threads] | (unsigned)w[(2 * k + 1) * t.threads] << 16;
      }
    } else if (L.es == 8) {
      const int4* pr = reinterpret_cast<const int4*>(region) + t.tid;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int4 a = pr[(2 * q) * t.threads], b = pr[(2 * q + 1) * t.threads];
        slot_at(t, L.slot, q) = make_int4(a.x, a.z, b.x, b.z);
      }
    } else {
      const int2* pr = reinterpret_cast<const int2*>(region) + t.tid;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int2 a = pr[(2 * q) * t.threads], b = pr[(2 * q + 1) * t.threads];
        slot_at(t, L.slot, q) = make_int4(a.x, a.y, b.x, b.y);
      }
    }
    region += (size_t)t.threads * kR * L.es;
  }
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < kR / 4; ++k) bits |= ((word[k] * 0x01020408u) >> 24) << (4 * k);
  t.mask &= bits;
  for (int pc = 0; pc < p.n_pre; ++pc) step<kOne>(p, p.code[pc], t);
  unsigned groups_seen = 0u;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int4 g = (p.gid_flags & kImm) ? make_int4(p.gid_val, p.gid_val, p.gid_val, p.gid_val)
                                        : slot_at(t, p.gid_val, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j, gv = comp(g, j);
      if ((unsigned)gv >= (unsigned)p.groups) t.mask &= ~(1u << i);
      if constexpr (!kOne) {
        t.key[i] = gv;
        if ((t.mask >> i) & 1u) groups_seen |= 1u << gv;
      }
    }
  }
  if constexpr (kOne) {
    if (!__any_sync(kFull, t.mask != 0u)) return;
  } else {
    t.present = __reduce_or_sync(kFull, groups_seen);
    if (t.present == 0u) return;
  }
  for (int pc = p.n_pre; pc < p.n_ins; ++pc) step<kOne>(p, p.code[pc], t);
}

template <bool kOne>
__global__ void __launch_bounds__(256)
fused_agg_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile t;
  t.threads = blockDim.x;
  t.tid = threadIdx.x;
  t.lane = t.tid & 31;
  t.slots = reinterpret_cast<int4*>(smem);
  char* stages = reinterpret_cast<char*>(smem) + (size_t)p.n_slots * kQ * t.threads * 16;
  // kOne: [n_terms][threads] per-thread sums; else the block's
  // [n_terms][groups] table
  t.acc = reinterpret_cast<unsigned long long*>(stages + kStages * (size_t)p.stage_bytes);
  t.present = 0u;
  if constexpr (kOne) {
    for (int i = 0; i < p.n_terms; ++i) t.acc[i * t.threads + t.tid] = 0ull;
  } else {
    for (int i = t.tid; i < p.n_terms * p.groups; i += t.threads) t.acc[i] = 0ull;
    __syncthreads();
  }
  const long long tile_rows = (long long)t.threads * kR;
  const long long ntiles = (p.n + tile_rows - 1) / tile_rows;
  // the copies of the next kStages - 1 tiles are in flight while a tile
  // is computed; one commit group a tile, empty past the end.  The
  // barrier makes the block's copies of the tile visible to every thread
  // and frees the stage read in the step before for the next copy.
  long long tile = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s) {
    const long long ahead = tile + (long long)s * gridDim.x;
    if (ahead < ntiles) {
      issue(p, stages + s * (size_t)p.stage_bytes, ahead * tile_rows, t.tid, t.threads);
    }
    cp_commit();
  }
  int st = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    cp_wait_oldest();
    __syncthreads();
    const long long ahead = tile + (long long)(kStages - 1) * gridDim.x;
    if (ahead < ntiles) {
      issue(p, stages + ((st + kStages - 1) % kStages) * (size_t)p.stage_bytes,
            ahead * tile_rows, t.tid, t.threads);
    }
    cp_commit();
    run_tile<kOne>(p, t, stages + st * (size_t)p.stage_bytes, tile * tile_rows);
    st = (st + 1) % kStages;
  }
  __syncthreads();
  if constexpr (kOne) {
    const int warp = t.tid >> 5, nwarps = t.threads >> 5;
    for (int i = warp; i < p.n_terms; i += nwarps) {
      unsigned long long s = 0ull;
      for (int j = t.lane; j < t.threads; j += 32) s += t.acc[i * t.threads + j];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (t.lane == 0 && s != 0ull) atomicAdd(p.out + i, s);
    }
  } else {
    for (int i = t.tid; i < p.n_terms * p.groups; i += t.threads) {
      if (t.acc[i] != 0ull) atomicAdd(p.out + i, t.acc[i]);
    }
  }
}

template <bool kOne>
int launch(const Params& p, int threads, size_t smem, long long ntiles, cudaStream_t stream) {
  auto kernel = fused_agg_kernel<kOne>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  kernel<<<(unsigned)(ntiles < cap ? ntiles : cap), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool valid_code(const int* code, int n_ins, int n_pre, int n_slots, int n_terms) {
  for (int i = 0; i < n_ins; ++i) {
    const int x = code[2 * i], b = code[2 * i + 1];
    const int op = x & 0xff, fl = (x >> 8) & 0xff, dst = (x >> 16) & 0xff, a = (x >> 24) & 0xff;
    const bool unary = op == OP_NEG || op == OP_LO16 || op == OP_HI16 || op == OP_NOT ||
                       op == OP_MOV || op == OP_ACC;
    if (op < OP_ADD || op > OP_ACC) return false;
    if (i < n_pre ? op == OP_ACC : (fl & kMask) != 0) return false;  // mask before terms
    if (!(fl & kImm) && (b < 0 || b >= n_slots)) return false;
    if (op == OP_ACC ? dst >= n_terms : (dst != kNoDst && dst >= n_slots)) return false;
    if (!unary && a >= n_slots) return false;
  }
  return true;
}

int fill_and_launch(const long long* lanes, int n_lanes, long long n, const int* code,
                    int n_ins, int n_pre, int gid_flags, int gid_val, int n_slots,
                    int n_terms, int groups, void* out, cudaStream_t stream) {
  Params p;  // host staging of the launch's parameters
  int dev = 0, optin = 0, sm_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e != cudaSuccess) return (int)e;
  int per_thread = 0;  // stage bytes a thread
  for (int l = 0; l < n_lanes; ++l) {
    const char* ptr = reinterpret_cast<const char*>(lanes[3 * l]);
    const int es = (int)lanes[3 * l + 1], slot = (int)lanes[3 * l + 2];
    if (!((es == 8 || es == 4) && slot >= 0 && slot < n_slots) && !(es == 1 && slot < 0)) {
      return (int)cudaErrorInvalidValue;
    }
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    p.lane[l] = Lane{ptr, es, slot};
    per_thread += kR * es;
  }
  // block size: the most resident warps an SM (shared memory decides),
  // the larger block on a tie; blocks of 32 threads only where 64 do not
  // fit (the widest programs check_program lets through)
  const int slot_bytes = n_slots * kR * 4, acc_row = groups == 1 ? n_terms * 8 : 0;
  const size_t table = groups == 1 ? 0 : (size_t)n_terms * groups * 8;
  int threads = 0, best = 0;
  size_t smem = 0;
  for (int th = 256; th >= (threads != 0 ? 64 : 32); th /= 2) {
    const size_t need = (size_t)th * (slot_bytes + kStages * per_thread + acc_row) + table;
    if (need > (size_t)optin) continue;
    long long blocks = sm_smem / (long long)(need + 1024);
    if (blocks > 2048 / th) blocks = 2048 / th;
    if (blocks > 32) blocks = 32;
    if (blocks * th > best) {
      best = (int)(blocks * th);
      threads = th;
      smem = need;
    }
  }
  if (threads == 0) return (int)cudaErrorInvalidValue;
  p.n = n;
  p.out = static_cast<unsigned long long*>(out);
  p.n_lanes = n_lanes;
  p.stage_bytes = threads * per_thread;
  p.n_ins = n_ins;
  p.n_pre = n_pre;
  p.gid_flags = gid_flags;
  p.gid_val = gid_val;
  p.n_slots = n_slots;
  p.n_terms = n_terms;
  p.groups = groups;
  for (int i = 0; i < n_ins; ++i) p.code[i] = make_int2(code[2 * i], code[2 * i + 1]);
  const long long tile_rows = (long long)threads * kR;
  const long long ntiles = (n + tile_rows - 1) / tile_rows;
  return groups == 1 ? launch<true>(p, threads, smem, ntiles, stream)
                     : launch<false>(p, threads, smem, ntiles, stream);
}

}  // namespace

// C entry (bound with ctypes); every pointer but the lanes' and `out` is
// host memory, copied into the launch's parameters.  `lanes` holds
// n_lanes (device pointer, element bytes, slot) triples: int64 or int32
// values of a column into its slot, or a bool mask lane with slot -1;
// every lane starts 16-byte aligned.
// `code` holds n_ins encoded instructions (two int32 words each), the
// first n_pre of them before the mask point; the group id is the
// immediate gid_val when gid_flags has bit 1, else slot gid_val.  `out`
// is a zeroed int64 [n_terms, groups] tensor.  Returns a cudaError_t.
extern "C" int fused_agg_sums_launch(const long long* lanes, int n_lanes, long long n,
                                     const int* code, int n_ins, int n_pre,
                                     int gid_flags, int gid_val, int n_slots,
                                     int n_terms, int groups, void* out, void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < 0 || n_ins < 1 || n_ins > kMaxIns ||
      n_pre < 0 || n_pre > n_ins || n_slots < 0 || n_slots > kMaxSlots ||
      n_terms < 1 || n_terms > kMaxTerms || groups < 1 || groups > kMaxGroups ||
      (!(gid_flags & kImm) && (gid_val < 0 || gid_val >= n_slots)) ||
      !valid_code(code, n_ins, n_pre, n_slots, n_terms)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fill_and_launch(lanes, n_lanes, n, code, n_ins, n_pre, gid_flags, gid_val, n_slots,
                         n_terms, groups, out, s);
}
