"""Collectives over a mesh of logical shards.

Counterpart of the jax.lax collectives the JAX package's mesh executor
runs over its mesh axis inside one shard_map program (all_gather with
tiled=True, psum / pmin / pmax, all_to_all).  Here one process drives
every shard in lockstep, so a collective is a plain function over the
list of the shards' tensors, in shard order:

  - all_gather: the shards' tensors concatenated along the first
    dimension, in shard order, on one device (the replicated result is
    held once a device, not once a shard);
  - psum / pmin / pmax: elementwise sum / min / max, folded in shard
    order (a fixed order: float sums repeat bit for bit);
  - all_to_all: each source shard's rows, already grouped by destination,
    split by the bucket sizes and concatenated at each destination in
    source order (buckets of any size: nothing is padded).

A move between devices is `tensor.to(device, non_blocking=True)`; shards
on one card move nothing.  Every call adds one to its kind in `CALLS`
(as ops/kernels.LAUNCHES counts launches): the witness that an exchange
ran as the collective it names.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

CALLS: Dict[str, int] = {
    "all_gather": 0, "psum": 0, "pmin": 0, "pmax": 0, "all_to_all": 0,
}


def reset_calls() -> None:
    for kind in CALLS:
        CALLS[kind] = 0


def all_gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Tiled all_gather: concatenation along dim 0 in shard order."""
    CALLS["all_gather"] += 1
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def _fold(kind: str, op, parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    CALLS[kind] += 1
    acc = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        acc = op(acc, p.to(device, non_blocking=True))
    return acc


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    return _fold("psum", torch.add, parts, device)


def pmin(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    return _fold("pmin", torch.minimum, parts, device)


def pmax(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    return _fold("pmax", torch.maximum, parts, device)


def all_to_all(send: Sequence[torch.Tensor], counts: Sequence[Sequence[int]],
               devices) -> List[torch.Tensor]:
    """send[src] is [planes, rows] with its rows grouped by destination
    (counts[src][dst] rows each, in destination order); returns, for each
    destination, [planes, sum over src of counts[src][dst]]: the sources'
    rows in source order, on that destination's device."""
    CALLS["all_to_all"] += 1
    pieces = [torch.split(t, list(c), dim=1) for t, c in zip(send, counts)]
    return [
        torch.cat([p[dst].to(dev, non_blocking=True) for p in pieces], dim=1)
        for dst, dev in enumerate(devices)
    ]
