"""Wide (two-limb) decimal storage and aggregation: decimal(19..38).

Counterpart of trino_tpu/ops/wide_decimal.py, with the same layout:
  - a wide lane is one int64 tensor of shape (n, 2): [:, 0] the low limb
    (a uint64 bit pattern) and [:, 1] the high limb (signed);
  - SUM accumulator state is four 32-bit chunk sums in int64 lanes
    ($c0..$c3, little-endian, top chunk signed); chunk sums cannot
    overflow int64 below 2^31 rows and merge by plain addition, and
    carries are propagated once per group (`normalize_chunks`).
Unsigned limb arithmetic goes through ops/int128's explicit helpers.
"""
from __future__ import annotations

import torch

from . import kernels
from .int128 import MASK32 as _M32
from .int128 import SIGN64 as _SIGN64
from .int128 import as_i64, srl, uge, ugt, ult, umul128

WIDE_DIGITS = 18  # precision above this needs two limbs


def is_wide_type(t) -> bool:
    return (
        t is not None
        and getattr(t, "is_decimal", False)
        and t.precision > WIDE_DIGITS
    )


def is_wide(v: torch.Tensor) -> bool:
    """Is this lane value tensor a wide (two-limb) decimal?"""
    return v.dim() == 2


def widen(v: torch.Tensor) -> torch.Tensor:
    """Promote a narrow int64 lane to wide: hi = sign extension."""
    v = v.to(torch.int64)
    return torch.stack([v, v >> 63], dim=-1)


def make_wide(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.stack([lo.to(torch.int64), hi.to(torch.int64)], dim=-1)


def limbs(w: torch.Tensor):
    return w[..., 0], w[..., 1]


def narrow(w: torch.Tensor) -> torch.Tensor:
    """Low limb (callers must know the value fits 64 bits)."""
    return w[..., 0]


def fits_narrow(w: torch.Tensor) -> torch.Tensor:
    lo, hi = limbs(w)
    return hi == (lo >> 63)


def compare(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Elementwise signed 128-bit comparison of two wide lanes."""
    alo, ahi = limbs(a)
    blo, bhi = limbs(b)
    lt = (ahi < bhi) | ((ahi == bhi) & ult(alo, blo))
    eq = (ahi == bhi) & (alo == blo)
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    if op == ">=":
        return ~lt
    if op == "==":
        return eq
    if op == "!=":
        return ~eq
    raise ValueError(op)


def order_operands(w: torch.Tensor, descending: bool = False):
    """Two int64 sort operands whose joint lexicographic order equals
    signed 128-bit order (the low limb's sign bit flipped)."""
    lo, hi = limbs(w)
    lo_s = lo ^ _SIGN64
    if descending:
        return ~hi, ~lo_s
    return hi, lo_s


# -- arithmetic --------------------------------------------------------
def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """128-bit wraparound addition of two wide lanes."""
    alo, ahi = limbs(a)
    blo, bhi = limbs(b)
    lo = alo + blo
    carry = ult(lo, alo).to(torch.int64)
    return make_wide(lo, ahi + bhi + carry)


def negate(a: torch.Tensor) -> torch.Tensor:
    lo, hi = limbs(a)
    nlo = ~lo + 1
    carry = (nlo == 0).to(torch.int64)
    return make_wide(nlo, ~hi + carry)


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, negate(b))


def abs128(a: torch.Tensor):
    """(|a| as wide, sign) — sign is -1/+1 int64."""
    _lo, hi = limbs(a)
    neg = hi < 0
    mag = torch.where(neg[..., None], negate(a), a)
    return mag, torch.where(neg, -1, 1).to(torch.int64)


def rescale(w: torch.Tensor, up: int) -> torch.Tensor:
    """w * 10^up (up >= 0) in 128-bit wraparound arithmetic."""
    if up == 0:
        return w
    mag, sign = abs128(w)
    lo, hi = limbs(mag)
    c = 10**up
    if c >= 1 << 63:
        raise NotImplementedError("rescale beyond 10^18 in one step")
    hi_p, lo_p = umul128(lo, c)
    hi_p = hi_p + hi * c
    out = make_wide(lo_p, hi_p)
    return torch.where((sign < 0)[..., None], negate(out), out)


def div_round(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """round_half_away(w / d) for a wide lane over positive int64
    divisors d; a full 128-bit quotient (one launch of the wide_div_round
    kernel on the card, its plain restoring division on the CPU)."""
    return kernels.wide_div_round(w, d.to(torch.int64))


def _udiv128_const_wide(hi: torch.Tensor, lo: torch.Tensor, const: int):
    """Unsigned (hi:lo) / python-int const -> (qhi, qlo, rhi, rlo)."""
    dhi = as_i64(const >> 64)
    dlo = as_i64(const & ((1 << 64) - 1))
    z = torch.zeros_like(lo)
    rhi, rlo, qhi, qlo = z, z, z, z
    for i in range(128):
        bit_index = 127 - i
        word = hi if bit_index >= 64 else lo
        bit = srl(word, bit_index % 64) & 1
        rhi = (rhi << 1) | srl(rlo, 63)
        rlo = (rlo << 1) | bit
        ge = ugt(rhi, dhi) | ((rhi == dhi) & uge(rlo, dlo))
        borrow = ult(rlo, dlo).to(torch.int64)
        rhi = torch.where(ge, rhi - dhi - borrow, rhi)
        rlo = torch.where(ge, rlo - dlo, rlo)
        qhi = (qhi << 1) | srl(qlo, 63)
        qlo = (qlo << 1) | ge.to(torch.int64)
    return qhi, qlo, rhi, rlo


def _round_up_half(qhi, qlo, rhi, rlo, const: int):
    """Quotient + 1 where 2 * remainder >= const (round half away)."""
    r2hi = (rhi << 1) | srl(rlo, 63)
    r2lo = rlo << 1
    chi = as_i64(const >> 64)
    clo = as_i64(const & ((1 << 64) - 1))
    up = (ugt(r2hi, chi) | ((r2hi == chi) & uge(r2lo, clo))).to(torch.int64)
    qlo2 = qlo + up
    return qhi + ult(qlo2, qlo).to(torch.int64), qlo2


def mul_wide(l: torch.Tensor, r: torch.Tensor, down: int) -> torch.Tensor:
    """Exact signed product of two lanes (narrow or wide) rescaled down
    by 10^down with round-half-away, as a wide lane."""
    lm, ls = abs128(promote(l))
    rm, rs = abs128(promote(r))
    llo, lhi = limbs(lm)
    rlo, rhi = limbs(rm)
    hi, lo = umul128(llo, rlo)
    hi = hi + llo * rhi + lhi * rlo
    if down > 0:
        const = 10**down
        qhi, qlo, rhi_r, rlo_r = _udiv128_const_wide(hi, lo, const)
        hi, lo = _round_up_half(qhi, qlo, rhi_r, rlo_r, const)
    mag = make_wide(lo, hi)
    neg = (ls * rs) < 0
    return torch.where(neg[..., None], negate(mag), mag)


# -- chunked accumulator form ------------------------------------------
def narrow_row_chunks(v: torch.Tensor, live: torch.Tensor):
    """Per-row 32-bit chunks of a narrow int64 lane: [c0 (unsigned),
    c1 (signed high)] — v == c1*2^32 + c0 exactly."""
    vv = torch.where(live, v.to(torch.int64), 0)
    return [vv & _M32, vv >> 32]


def wide_row_chunks(w: torch.Tensor, live: torch.Tensor):
    """Per-row 32-bit chunks of a wide lane: [c0..c3], c3 signed."""
    lo, hi = limbs(w)
    lo = torch.where(live, lo, 0)
    hi = torch.where(live, hi, 0)
    return [lo & _M32, srl(lo, 32) & _M32, hi & _M32, hi >> 32]


def normalize_chunks(chunks):
    """Propagate carries so every chunk is back in 32-bit range (top
    chunk keeps the sign)."""
    out = []
    carry = torch.zeros_like(chunks[0])
    for i, c in enumerate(chunks):
        c = c + carry
        if i == len(chunks) - 1:
            out.append(c)
        else:
            out.append(c & _M32)
            carry = c >> 32  # arithmetic: signed carries work
    return out


def chunks_to_wide(chunks) -> torch.Tensor:
    """Canonical (normalized) chunks -> wide (..., 2) lane."""
    c0, c1, c2, c3 = chunks
    return make_wide((c1 << 32) | c0, (c3 << 32) | c2)


def seg_sum_chunks(row_chunks, gid: torch.Tensor, cap: int):
    """Segment-sum per-row chunk lanes and normalize: the wide SUM.
    Two-chunk (narrow) inputs pad with zero chunks."""
    from .aggregation import _seg_sum

    sums = [_seg_sum(c, gid, cap) for c in row_chunks]
    while len(sums) < 4:
        sums.append(torch.zeros_like(sums[0]))
    return normalize_chunks(sums)


def merge_chunk_lanes(chunk_lanes, w: torch.Tensor, gid: torch.Tensor, cap: int):
    """FINAL-step merge of shipped (canonical) chunk columns: plain
    segment sums and one carry pass.  Exact while the merged partial
    count stays below 2^31 (each chunk is below 2^32)."""
    return seg_sum_chunks([torch.where(w, c, 0) for c in chunk_lanes], gid, cap)


def promote(v: torch.Tensor) -> torch.Tensor:
    """Lane value -> wide form (no-op if already two-limb)."""
    return v if is_wide(v) else widen(v)


def decimal_rescale_wide(w: torch.Tensor, fs: int, ts: int) -> torch.Tensor:
    """Scale change on wide lanes with round-half-away; down-rescales
    keep a full 128-bit quotient."""
    if ts >= fs:
        return rescale(w, ts - fs)
    const = 10 ** (fs - ts)
    mag, sign = abs128(w)
    lo, hi = limbs(mag)
    qhi, qlo, rhi, rlo = _udiv128_const_wide(hi, lo, const)
    qhi, qlo2 = _round_up_half(qhi, qlo, rhi, rlo, const)
    out = make_wide(qlo2, qhi)
    return torch.where((sign < 0)[..., None], negate(out), out)


def to_double(w: torch.Tensor) -> torch.Tensor:
    """Wide -> float64 (rounds beyond 2^53 like any int64 cast)."""
    lo, hi = limbs(w)
    lo_f = lo.to(torch.float64) + (lo < 0).to(torch.float64) * 2.0**64
    return hi.to(torch.float64) * 2.0**64 + lo_f


def pad_rows(v: torch.Tensor, extra: int) -> torch.Tensor:
    """Pad axis 0 by `extra` zero rows, preserving limb dims."""
    pad = torch.zeros((extra,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return torch.cat([v, pad])


# -- device <-> host ----------------------------------------------------
def from_python_int(x: int):
    """Python int -> (lo, hi) int64 bit patterns."""
    return as_i64(x), as_i64(x >> 64)
