"""Hash and range repartition: the FIXED_HASH and RANGE exchanges of the
mesh.

Counterpart of trino_tpu/parallel/shuffle.py.  Each source shard buckets
its rows (a splitmix64 hash of the key mod the shard count, or the
number of sampled splitters below the leading sort key), groups the kept
rows by destination with one stable sort, and one all_to_all per dtype
moves every lane of that dtype at once.  The JAX package packs the rows
into fixed-capacity chunks (XLA needs static shapes) and checks the
high-water mark afterwards through its retry ladder; here the buckets
have their exact sizes, read once per exchange (the counts whose maximum
the JAX package's ladder reads), so no chunk can overflow.  Hash values
and bucket choices are bit for bit the JAX package's, so each shard
receives the same rows in the same order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..ops import join as join_ops
from ..ops.int128 import as_i64, srl
from . import collectives

_M1 = as_i64(0xBF58476D1CE4E5B9)
_M2 = as_i64(0x94D049BB133111EB)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of each value's 64-bit pattern (uint64
    arithmetic in int64: multiplies wrap alike, the shifts are logical)."""
    x = x.to(torch.int64)
    x = (x ^ srl(x, 30)) * _M1
    x = (x ^ srl(x, 27)) * _M2
    return x ^ srl(x, 31)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 value of h's bits mod n, in int64 arithmetic."""
    return ((srl(h, 1) % n) * 2 + (h & 1)) % n


def bucket_of(key_lanes, sel, ndev: int, force_hash: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination shard per row: hash of the (composite) key mod ndev.
    Both sides of a join call this with corresponding key lanes and the
    same force_hash (the joint decision), so equal keys co-locate.
    Returns (bucket, key_ok)."""
    v, ok = join_ops.composite_key(key_lanes, sel, force_hash)
    return _umod(_mix64(v), ndev).to(torch.int32), ok


def range_buckets(key_lanes, sort_key, sels, ndev: int, devices, home
                  ) -> List[torch.Tensor]:
    """Destination shard per row of every shard for a RANGE exchange on
    the leading sort key: each shard samples 64 keys of its live rows in
    key order, the samples are all_gathered, ndev - 1 splitters are
    taken at sample quantiles, and a row's bucket is the number of
    splitters strictly below it.  Rows with equal leading keys share a
    bucket, so the shards' local sorts concatenate, in shard order, into
    the total order."""
    from ..ops import sort as sort_ops

    S = 64
    col = sort_key.column
    nf = sort_key.nulls_first
    samples_v, samples_ok = [], []
    for (v, ok), sel in zip(key_lanes, sels):
        if sel.shape[0] == 0:
            # an empty shard offers NULL samples (the JAX package's padded
            # shard samples its dead rows)
            samples_v.append(torch.zeros((S,) + tuple(v.shape[1:]), dtype=v.dtype,
                                         device=v.device))
            samples_ok.append(torch.zeros(S, dtype=torch.bool, device=v.device))
            continue
        # sample the live prefix only (sort_perm puts unselected rows
        # last): dead rows would fill the splitters with NULLs
        perm = sort_ops.sort_perm([sort_key], {col: (v, ok)}, sel)
        n_live = torch.clamp(sel.sum(), min=1)
        idx = torch.clamp(
            torch.arange(S, dtype=torch.int64, device=v.device)
            * torch.clamp(n_live // S, min=1), max=n_live - 1)
        rows = perm[idx]
        samples_v.append(v[rows])
        samples_ok.append(ok[rows] & sel[rows])
    all_v = collectives.all_gather(samples_v, home)
    all_ok = collectives.all_gather(samples_ok, home)
    total = all_v.shape[0]
    perm2 = sort_ops.sort_perm(
        [sort_key], {col: (all_v, all_ok)},
        torch.ones(total, dtype=torch.bool, device=all_v.device))
    gs_v, gs_ok = all_v[perm2], all_ok[perm2]
    pidx = [min((j * total) // ndev, total - 1) for j in range(1, ndev)]

    def null_bit(o):
        return o if nf else torch.logical_not(o)

    out = []
    for (v, ok), sel, dev in zip(key_lanes, sels, devices):
        bucket = torch.zeros(sel.shape[0], dtype=torch.int32, device=dev)
        nb_row = null_bit(ok & sel)
        for j in pidx:
            pv = gs_v[j].to(dev, non_blocking=True)
            pok = gs_ok[j].to(dev, non_blocking=True)
            if v.dim() == 2:
                from ..ops import wide_decimal as wd

                gt = wd.compare(v, pv.expand(v.shape),
                                ">" if sort_key.ascending else "<")
            else:
                gt = (v > pv) if sort_key.ascending else (v < pv)
            nb_piv = null_bit(pok)
            above = torch.where(nb_row == nb_piv, gt, nb_row & ~nb_piv)
            bucket = bucket + above.to(torch.int32)
        out.append(bucket)
    return out


def repartition(parts: Sequence[Tuple[Dict[str, tuple], torch.Tensor, torch.Tensor]],
                devices, read_counts: Callable[[torch.Tensor], list]
                ):
    """All-to-all exchange of each source shard's kept rows to their
    bucket's shard.

    parts[src] = (lanes, bucket, keep): lanes symbol -> (values, ok) of
    one length, the destination of each row, and the rows to send (a
    False row is dropped: a NULL key on an inner join's side can match
    nothing).  `read_counts` copies the [src, dst] row-count matrix to
    the host (one supervised read an exchange).  Returns the lanes each
    destination receives (the sources' rows in source order, each
    source's in its row order) and the count matrix."""
    ndev = len(devices)
    orders, counts = [], []
    for lanes, bucket, keep in parts:
        b = torch.where(keep, bucket.to(torch.int64), ndev)
        # stable sort by destination; dropped rows sink to the end
        orders.append(torch.argsort(b, stable=True))
        counts.append(torch.bincount(b, minlength=ndev + 1)[:ndev])
    home = devices[0]
    matrix = read_counts(torch.stack([c.to(home, non_blocking=True) for c in counts]))
    # every plane of one dtype crosses in one all_to_all (wide decimal
    # lanes as their two limbs)
    names = list(parts[0][0])
    groups: Dict[torch.dtype, list] = {}
    for s in names:
        v0, _ = parts[0][0][s]
        if v0.dim() == 2:
            groups.setdefault(v0.dtype, []).extend([(s, "v0"), (s, "v1")])
        else:
            groups.setdefault(v0.dtype, []).append((s, "v"))
        groups.setdefault(torch.bool, []).append((s, "ok"))

    def plane(lanes, key):
        v, ok = lanes[key[0]]
        part = key[1]
        return ok if part == "ok" else v if part == "v" else v[:, int(part[1])]

    received: Dict[tuple, List[torch.Tensor]] = {}
    for keys in groups.values():
        send = []
        for (lanes, _b, _k), order, row in zip(parts, orders, matrix):
            rows = order[: sum(row)]
            send.append(torch.stack([plane(lanes, k)[rows] for k in keys]))
        recv = collectives.all_to_all(send, matrix, devices)
        for i, k in enumerate(keys):
            received[k] = [r[i] for r in recv]
    out = []
    for d in range(ndev):
        lanes = {}
        for s in names:
            if (s, "v") in received:
                v = received[(s, "v")][d]
            else:
                v = torch.stack([received[(s, "v0")][d], received[(s, "v1")][d]], dim=-1)
            lanes[s] = (v, received[(s, "ok")][d])
        out.append(lanes)
    return out, matrix
