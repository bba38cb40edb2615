"""Emulated 128-bit integer arithmetic on int64 tensors.

Counterpart of trino_tpu/ops/int128.py.  PyTorch's uint64 coverage is
partial, so the limbs are int64 tensors holding uint64 bit patterns:
addition, subtraction, multiplication and left shifts wrap identically
for both readings, and the few places where signedness matters go
through the explicit helpers below (logical right shift, unsigned
compare).  Products split into 32-bit halves; 128/64 division is the
classic shift-subtract loop over 128 fixed iterations.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SIGN64 = -(2**63)  # the int64 bit pattern of 1 << 63


def as_i64(x: int) -> int:
    """A python int in [0, 2^64) as the int64 with the same bit pattern."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of uint64 bit patterns held in int64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b for uint64 bit patterns held in int64."""
    return (a ^ SIGN64) < (b ^ SIGN64)


def uge(a, b) -> torch.Tensor:
    return ~ult(a, b)


def ugt(a, b) -> torch.Tensor:
    return ult(b, a)


def umul128(a: torch.Tensor, b):
    """Unsigned 64x64 -> 128-bit product as (hi, lo) limbs."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, as_i64(int(b)))
    a0, a1 = a & MASK32, srl(a, 32)
    b0, b1 = b & MASK32, srl(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = srl(p00, 32) + (p01 & MASK32) + (p10 & MASK32)
    lo = (p00 & MASK32) | ((mid & MASK32) << 32)
    hi = p11 + srl(p01, 32) + srl(p10, 32) + srl(mid, 32)
    return hi, lo


def udiv128_64(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor):
    """(hi:lo) / d -> (quotient low 64 bits, remainder); 1 <= d < 2^63."""
    rem = torch.zeros_like(d)
    q = torch.zeros_like(d)
    for i in range(128):
        bit_index = 127 - i
        word = hi if bit_index >= 64 else lo
        bit = srl(word, bit_index % 64) & 1
        rem = (rem << 1) | bit
        ge = uge(rem, d)
        rem = torch.where(ge, rem - d, rem)
        q = (q << 1) | ge.to(torch.int64)
    return q, rem


def mul_shift_div_round(l: torch.Tensor, mul: int, den: torch.Tensor) -> torch.Tensor:
    """round_half_away((l * mul) / den) for signed int64 lanes with a
    128-bit intermediate product; `mul` a python power of ten."""
    sign = torch.sign(l) * torch.sign(den)
    al = torch.abs(l)
    ad = torch.abs(torch.where(den == 0, torch.ones_like(den), den))
    if mul < (1 << 64):
        hi, lo = umul128(al, mul)
    else:
        c1, c0 = mul >> 64, mul & ((1 << 64) - 1)
        hi, lo = umul128(al, c0)
        hi = hi + al * as_i64(c1)
    q, rem = udiv128_64(hi, lo, ad)
    q = q + uge(rem * 2, ad).to(torch.int64)
    return sign * q
