"""The card's peaks and the work each kernel call needs.

A call's least time is the larger of its bytes over the device memory's
rate and its operations over the 32-bit vector rate (the kernels add,
compare and gather integers; none uses the tensor cores).  Bytes count
each input lane read once and each output written once, from the call's
argument shapes and dtypes; a direct-address probe reads of its table
only the 32-byte sectors that its selected keys address (the work
depends on the data), counted on the device beside the call.
Operations count one per row and term added or row compared: a floor,
well under the bytes' bound for these kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# the one card these peaks are of (run.py refuses any other): NVIDIA H100
# SXM5 80GB data sheet, dense rates, at its 700 W limit
DEVICE = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
SECTOR = 32
_SECTOR_CHUNK = 1 << 24


def least_seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / VECTOR_OPS_PER_S)


def _lane(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _probe_sectors(table: torch.Tensor, key: torch.Tensor, ok: torch.Tensor,
                   sel: torch.Tensor, lo: int) -> torch.Tensor:
    """Distinct 32-byte sectors of `table` that the selected valid keys
    address, as a device scalar (no host sync)."""
    per = SECTOR // table.element_size()
    nsec = (table.numel() + per - 1) // per
    seen = torch.zeros(nsec + 1, dtype=torch.bool, device=table.device)
    for s in range(0, key.numel(), _SECTOR_CHUNK):
        k = key[s:s + _SECTOR_CHUNK].to(torch.int64) - lo
        m = ok[s:s + _SECTOR_CHUNK] & sel[s:s + _SECTOR_CHUNK] & (k >= 0) & (k < table.numel())
        seen[torch.where(m, k // per, nsec)] = True
    return seen[:nsec].sum()


def work(name: str, args: tuple, kw: dict, out) -> Tuple[int, int, Optional[torch.Tensor]]:
    """(bytes, operations, pending sector count or None) of one call."""
    if name == "fused_agg_sums":
        cols, valids, live = args[0], args[1], args[2]
        n = live.numel()
        nbytes = sum(_lane(c) for c in cols) + sum(_lane(v) for v in valids) \
            + _lane(live) + _lane(out)
        return nbytes, n * max(1, out.shape[0]), None
    if name in ("grouped_count", "grouped_sum_i64"):
        vals, gid = args[0], args[1]
        return _lane(vals) + _lane(gid) + _lane(out), vals.numel(), None
    if name == "direct_probe":
        table, key, ok, sel, lo = args[:5]
        row, matched = out
        nbytes = _lane(key) + _lane(ok) + _lane(sel) + _lane(row) + _lane(matched)
        return nbytes, key.numel(), _probe_sectors(table, key, ok, sel, int(lo))
    raise KeyError(name)
