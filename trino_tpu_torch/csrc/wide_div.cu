// Rounded division of signed 128-bit lanes for Hopper (sm_90a).
//
// Replaces: trino_tpu/ops/wide_decimal.py `div_round`, a `jnp` restoring
// division of 128 fixed steps that XLA fuses into one program (no
// `pallas_call`).  The port ran the same loop as about 18 element-wise
// PyTorch calls a step, 2,338 launches a call, so the host's
// dispatch, not the card, set its time: a wide decimal average (Q1's
// three averages over 12 groups) cost tens of milliseconds of launches
// for a few hundred bytes of data.  Here a call is one launch.
//
// What it computes, per lane i: out[i] = round_half_away(w[i] / d[i]),
// with w a signed 128-bit value in the port's wide layout (two int64
// words a lane: the low limb as a uint64 bit pattern, then the signed high
// limb) and d an int64 divisor clamped below at 1.  The magnitude |w| is
// taken modulo 2^128 (|-2^127| = 2^127 as an unsigned value), divided as
// an unsigned 128-by-64 division, rounded up where 2r >= d (as r >= d - r,
// which cannot overflow), and negated modulo 2^128 where w < 0: bit for bit
// the restoring division of `wide_div_round_plain`.
//
// Bound on the H100: memory, 16 bytes of w and 8 of d read and 16 written
// a lane (40 B) against 3.35 TB/s; at the callers' sizes (12 lanes for
// Q1's groups) the launch itself.  Design:
//   - one thread a lane, a grid-stride loop over a grid capped at
//     kMaxBlocks blocks, so one launch serves 12 lanes and 10^8;
//   - the division in registers: the high limb by d with the hardware's
//     64-bit divide, then the two-digit remainder with the low limb by the
//     normalised two-step estimate of Hacker's Delight's divlu (base 2^32
//     digits, each estimate corrected by at most 2), so a lane costs three
//     64-bit divisions and no bit loop;
//   - scalar 8-byte loads: a warp's two loads of w cover one contiguous
//     512-byte run, so any 8-byte-aligned lane array is read whole.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 12 lanes
// 0.055-0.075 ms a launch timed alone (the host's launch included),
// against 25.1-28.4 ms for the 128-step loop; 100 M lanes 2.03-2.05 ms,
// 58-59% of the byte bound (1.19 ms): there the three emulated 64-bit
// divisions, not the bytes, come close to binding.
// It allocates nothing, does not synchronise and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

typedef unsigned long long u64;

// (numhi : numlo) / den for numhi < den, den > 0: the 64-bit quotient,
// the remainder in *rem.  Divisor and dividend are shifted so that the
// divisor's top bit is set; each base-2^32 quotient digit is estimated
// from the top two dividend digits over the divisor's top digit, and the
// estimate, at most 2 too large, is corrected against the next digit.
__device__ __forceinline__ u64 div_2by1(u64 numhi, u64 numlo, u64 den,
                                        u64* rem) {
  const u64 b = 1ull << 32;
  const int shift = __clzll((long long)den);
  den <<= shift;
  numhi <<= shift;
  // (-shift & 63) is 64 - shift without a shift by 64; the mask keeps
  // numlo out of numhi when shift is 0
  numhi |= (numlo >> (-shift & 63)) & (u64)(-(long long)shift >> 63);
  numlo <<= shift;
  const u64 num1 = numlo >> 32, num0 = numlo & 0xffffffffull;
  const u64 den1 = den >> 32, den0 = den & 0xffffffffull;

  u64 qhat = numhi / den1;
  u64 rhat = numhi - qhat * den1;
  u64 c1 = qhat * den0;
  u64 c2 = rhat * b + num1;
  if (c1 > c2) qhat -= (c1 - c2 > den) ? 2 : 1;
  const u64 q1 = qhat & 0xffffffffull;
  const u64 r = numhi * b + num1 - q1 * den;  // the partial remainder

  qhat = r / den1;
  rhat = r - qhat * den1;
  c1 = qhat * den0;
  c2 = rhat * b + num0;
  if (c1 > c2) qhat -= (c1 - c2 > den) ? 2 : 1;
  const u64 q0 = qhat & 0xffffffffull;
  *rem = (r * b + num0 - q0 * den) >> shift;
  return (q1 << 32) | q0;
}

__global__ void __launch_bounds__(kThreads)
wide_div_kernel(const long long* __restrict__ w, const long long* __restrict__ d,
                long long n, long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    u64 lo = (u64)w[2 * i];
    const long long hi_s = w[2 * i + 1];
    u64 hi = (u64)hi_s;
    const long long dd = d[i];
    const u64 den = dd < 1 ? 1ull : (u64)dd;
    const bool neg = hi_s < 0;
    if (neg) {  // |w| modulo 2^128
      lo = ~lo + 1;
      hi = ~hi + (lo == 0);
    }
    const u64 qhi0 = hi / den;
    u64 r;
    u64 qlo = div_2by1(hi - qhi0 * den, lo, den, &r);
    const u64 up = r >= den - r;  // 2r >= den: round half away from zero
    qlo += up;
    u64 qhi = qhi0 + (qlo < up);
    if (neg) {
      qlo = ~qlo + 1;
      qhi = ~qhi + (qlo == 0);
    }
    out[2 * i] = (long long)qlo;
    out[2 * i + 1] = (long long)qhi;
  }
}

}  // namespace

// C entry (bound with ctypes).  `w` and `out` are int64 [n, 2] lane
// arrays, `d` an int64 [n] array, all contiguous and 8-byte aligned.
// Returns cudaGetLastError().
extern "C" int wide_div_round_launch(const void* w, const void* d, long long n,
                                     void* out, void* stream) {
  if (n < 0 || ((uintptr_t)w & 7) != 0 || ((uintptr_t)d & 7) != 0 ||
      ((uintptr_t)out & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  wide_div_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)w, (const long long*)d, n, (long long*)out);
  return (int)cudaGetLastError();
}
