"""Mergeable approximate-aggregation sketches on PyTorch tensors.

Counterpart of trino_tpu/ops/sketches.py: the states that make
approx_distinct and approx_percentile decomposable, so they split
PARTIAL/FINAL (streaming tiles, spill batches) instead of gathering raw
rows.  The bits are the JAX package's: uint64 arithmetic runs in int64
(add and multiply wrap alike, right shifts are logical through
int128.srl), so the registers, samples and estimates are the same.

  - HLL: m = 512 8-bit registers per group, packed 8 per int64 lane into
    64 accumulator lanes.  A register update is one ``scatter_reduce``
    amax over [cap * m] slots; the rank is the exact bit length of the
    hash's 55-bit window (integer halving, no float log).
  - percentile: a k-minimum-hash uniform row sample (k = 256) per group:
    the k rows with the smallest per-row hash.  Merging unions the
    candidates and keeps the k smallest again, which is a uniform sample
    of the union.  Quantiles come from the sample, with exact min/max
    carried beside it.

Both bound device memory by cap * (m or k) slots; past 2^30 slots they
raise rather than estimate from truncated state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .int128 import srl

HLL_M = 512               # registers: std error 1.04/sqrt(512) ~= 4.6%
HLL_REG_PER_LANE = 8      # 8-bit registers packed into int64 lanes
HLL_LANES = HLL_M // HLL_REG_PER_LANE
_HLL_ALPHA = 0.7213 / (1 + 1.079 / HLL_M)

KMV_K = 256               # sample size: quantile rank error ~1/sqrt(256)

_H_EMPTY = 2**62          # hash of an empty sample slot
_H_BITS = 2**40           # sample hashes keep their low 40 bits


def _mix64(x: torch.Tensor) -> torch.Tensor:
    from .aggregation import _splitmix64

    return _splitmix64(x)


def _bitlength(w: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values (0 for 0)."""
    bl = torch.zeros_like(w)
    x = w
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        bl = bl + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return bl + (x > 0).to(torch.int64)


def _guard_cap(cap: int, width: int):
    if cap * width > (1 << 30):
        raise ValueError(
            f"approximate-aggregation sketch state ({cap} groups x "
            f"{width} slots) exceeds the 2^30-slot device guard; "
            "reduce the group count or use exact count(distinct)"
        )


# --- HyperLogLog ------------------------------------------------------


def _registers_max(vals: torch.Tensor, slot: torch.Tensor, cap: int):
    """[cap, HLL_M] register maxima of vals scattered to slot (vals of
    dead rows are -1 or 0, so they never raise a register)."""
    flat = torch.full((cap * HLL_M,), -1, dtype=torch.int64, device=vals.device)
    flat.scatter_reduce_(0, slot, vals.to(torch.int64), "amax")
    return torch.clamp(flat, min=0).reshape(cap, HLL_M)


def hll_accumulate(
    bits: torch.Tensor, live: torch.Tensor, gid: torch.Tensor, cap: int
) -> Dict[int, torch.Tensor]:
    """Per-group packed HLL registers from value bit material (int64).
    Returns {lane_index: [cap] int64 packed registers}."""
    _guard_cap(cap, HLL_M)
    h = _mix64(bits)
    reg = h & (HLL_M - 1)
    w = srl(h, 9)  # 55-bit window
    rank = torch.where(live, 56 - _bitlength(w), -1)
    slot = torch.where(live, gid.to(torch.int64) * HLL_M + reg, 0)
    return _pack(_registers_max(rank, slot, cap))


def _pack(regs: torch.Tensor) -> Dict[int, torch.Tensor]:
    cap = regs.shape[0]
    r = regs.to(torch.int64).reshape(cap, HLL_LANES, HLL_REG_PER_LANE)
    packed = torch.zeros((cap, HLL_LANES), dtype=torch.int64, device=regs.device)
    for j in range(HLL_REG_PER_LANE):
        packed = packed | (r[:, :, j] << (8 * j))
    return {i: packed[:, i] for i in range(HLL_LANES)}


def _unpack(lanes, n: int) -> torch.Tensor:
    """[n, HLL_M] int64 registers from the packed int64 lanes (register
    index lane-major)."""
    words = torch.stack([lanes[i].to(torch.int64) for i in range(HLL_LANES)], 1)
    shifts = torch.arange(0, 8 * HLL_REG_PER_LANE, 8, dtype=torch.int64,
                          device=words.device)
    # registers stay below 2^7, so a packed word is non-negative and the
    # arithmetic shift is the logical one
    return ((words[:, :, None] >> shifts) & 0xFF).reshape(n, HLL_M)


def hll_pmax_merge(shard_lanes, cap: int, device) -> Dict[int, torch.Tensor]:
    """The mesh's HLL union across shards: each shard's packed lanes
    unpacked to [cap, HLL_M] registers, the register-wise max taken
    across shards (a pmax collective), repacked on `device`.  A max of
    the packed words would compare each word's 8 registers
    lexicographically, not register by register."""
    from ..parallel import collectives

    _guard_cap(cap, HLL_M)
    return _pack(collectives.pmax([_unpack(l, cap) for l in shard_lanes], device))


def hll_merge(
    lanes, sel: torch.Tensor, gid: torch.Tensor, cap: int
) -> Dict[int, torch.Tensor]:
    """Merge partial packed-register rows into final groups (register-wise
    max)."""
    _guard_cap(cap, HLL_M)
    n = sel.shape[0]
    regs = torch.where(sel[:, None], _unpack(lanes, n), 0)
    slot = gid.to(torch.int64)[:, None] * HLL_M + torch.arange(
        HLL_M, dtype=torch.int64, device=gid.device)[None, :]
    slot = torch.where(sel[:, None], slot, 0)
    return _pack(_registers_max(regs.reshape(-1), slot.reshape(-1), cap))


def hll_cardinality(lanes, cap: int) -> torch.Tensor:
    """HLL estimator with linear-counting small-range correction."""
    regs = _unpack(lanes, cap).to(torch.float64)  # [cap, m]
    inv = torch.sum(torch.exp2(-regs), dim=1)
    raw = _HLL_ALPHA * HLL_M * HLL_M / inv
    zeros = torch.sum(regs == 0, dim=1).to(torch.float64)
    small = (raw <= 2.5 * HLL_M) & (zeros > 0)
    linear = HLL_M * torch.log(HLL_M / torch.clamp(zeros, min=1e-9))
    est = torch.where(small, linear, raw)
    return torch.round(est).to(torch.int64)


# --- k-minimum-hash uniform sample (percentile sketch) ----------------


def kmv_accumulate(
    v: torch.Tensor,
    live: torch.Tensor,
    gid: torch.Tensor,
    cap: int,
    salt: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group uniform sample: the k rows with the smallest per-row hash
    (the row index mixed with the value's bits).  Returns (values
    [cap*k], hashes [cap*k]); empty slots carry the hash _H_EMPTY."""
    from .aggregation import _key_bits

    _guard_cap(cap, KMV_K)
    n = v.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=v.device)
    h = _mix64(idx ^ _mix64(_key_bits(v)) ^ (salt * 2 + 1)) & (_H_BITS - 1)
    return _kmv_keep_smallest(v, h, live, gid.to(torch.int64), cap)


def _kmv_keep_smallest(v, h, live, gid, cap):
    n = v.shape[0]
    dev = v.device
    comp = torch.where(live, gid * _H_BITS + h, 2**62)
    order = torch.sort(comp, stable=True).indices
    live_s = live[order]
    gs = torch.where(live, gid, cap - 1)[order]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # live rows sort by group: a group's first row is its count's offset
    cnt = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(live_s, gs, 0), live_s.to(torch.int64))
    first = torch.cumsum(cnt, 0) - cnt
    rank = idx - first[gs]
    dest = torch.where(live_s & (rank < KMV_K), gs * KMV_K + rank, cap * KMV_K)
    vals = torch.zeros(cap * KMV_K + 1, dtype=v.dtype, device=dev)
    vals[dest] = v[order]
    hs = torch.full((cap * KMV_K + 1,), _H_EMPTY, dtype=torch.int64, device=dev)
    hs[dest] = h[order]
    return vals[:-1], hs[:-1]


def kmv_merge(
    vals: torch.Tensor,
    hs: torch.Tensor,
    sel: torch.Tensor,
    gid: torch.Tensor,
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union partial sample rows (k candidate slots a row) and keep the k
    smallest hashes per final group again."""
    _guard_cap(cap, KMV_K)
    live = torch.repeat_interleave(sel, KMV_K) & (hs.reshape(-1) != _H_EMPTY)
    gidr = torch.repeat_interleave(gid.to(torch.int64), KMV_K)
    return _kmv_keep_smallest(vals.reshape(-1), hs.reshape(-1), live, gidr, cap)


def kmv_quantile(
    vals: torch.Tensor, hs: torch.Tensor, cap: int, q: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-rank quantile of each group's sample.  Returns (value
    [cap], has_rows [cap])."""
    from .aggregation import f64_order_bits
    from .int128 import SIGN64
    from .sort import lex_perm

    dev = vals.device
    ntot = cap * KMV_K
    flat_live = hs != _H_EMPTY
    gidf = torch.arange(ntot, dtype=torch.int64, device=dev) // KMV_K
    if vals.is_floating_point():
        enc = f64_order_bits(vals) ^ SIGN64
    else:
        enc = vals.to(torch.int64)
    gkey = torch.where(flat_live, gidf, cap)  # dead slots last
    order = lex_perm([gkey, enc])
    sg = gkey[order]
    vs = vals[order]
    ls = sg < cap
    gs = torch.where(ls, sg, 0)
    counts = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
        0, gs, ls.to(torch.int64))
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ntot, dtype=torch.int64, device=dev) - first[gs]
    target = torch.floor(
        q * (torch.clamp(counts, min=1) - 1).to(torch.float64) + 0.5
    ).to(torch.int64)
    pick = ls & (rank == target[gs])
    # one picked slot a group with rows: a scatter of it is exact
    out = torch.zeros(cap + 1, dtype=vals.dtype, device=dev)
    out[torch.where(pick, gs, cap)] = vs
    return out[:cap], counts > 0
