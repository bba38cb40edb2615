"""Chip smoke test of the PyTorch/H100 port (trino_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel from trino_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card,
     on random and edge inputs (exact equality); one fused call runs
     under torch.cuda.set_sync_debug_mode("error");
  3. TPC-H SF1: all 22 queries of tests/tpch_sql.py, plus UNION,
     INTERSECT, EXCEPT and two window statements of the CPU tests,
     through Session.execute with megakernels on (fused kernel), off
     (grouped-count and grouped-sum kernels) and with every kernel
     function replaced by its plain version: the pages must be
     byte-identical, and Q6, Q1 and Q3 agree with exact numpy references;
  4. TPC-H SF10, the main path: Q6, Q1 and Q3 warm with megakernels=auto
     and Q1 with megakernels=off, held against the numpy references;
     every kernel's launch count must move (direct_probe twice per Q3);
  5. TPC-H SF10, the relational path in the same session: Q4 (EXISTS),
     Q16 (NOT IN, count DISTINCT), Q18 (IN over a 15 M-group aggregate),
     Q21 (EXISTS with a residual, NOT EXISTS), Q22 (scalar subquery, NOT
     EXISTS, substring) and a running sum over all 15 M orders (its
     first 100 rows, and its count, sum, min and max over every row),
     warm, with their launches and peak device memory; Q4, Q18, Q22 and
     both window statements against exact numpy references, Q16 and Q21
     byte-identical to runs on the plain kernel versions;
  6. each kernel timed with CUDA events at the main path's shapes beside
     its bound, its plain version and, where one exists, one PyTorch call
     computing the same function.

--profile traces one warm run of every SF10 query (busy and idle share
of the device).  The last log line gives the run's seconds.

With --parent DIR (a checkout of an earlier commit), that commit's
direct_probe also runs the kernel cases and is timed beside this one's.

The line before the last is the kernels JSON, the last line the result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
VECTOR_OPS_PER_S = 67e12       # H100 SXM non-tensor-core 32-bit rate
SEED = 20261016
MAIN_SF = 10.0                 # TPC-H scale of the main path
MAIN_REPS = 3                  # warm repetitions of each main-path query (--reps)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


# ---------------------------------------------------------------------------
# phase 1: build


def phase_build():
    from trino_tpu_torch.ops import kernels as kn

    t0 = time.perf_counter()
    reports = kn.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                _log(f"[ptxas {name}] {line.strip()}")
                if (name == "direct_probe" and "spill" in line
                        and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)):
                    raise AssertionError(f"direct_probe spills: {line.strip()}")
    if "parent" in PARENT:
        PARENT["kn"] = _parent_kernels(PARENT["parent"])
        _log(f"[build] the parent's kernels from {PARENT['parent']}")
    _log(f"[build] {len(reports)} kernel sources compiled in "
         f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _rand_code(rng, n_cols, depth, k=None):
    """A random well-formed postfix program of expression depth <= depth."""
    from trino_tpu_torch.ops import kernels as kn

    if depth == 0 or rng.random() < 0.25:
        if rng.random() < 0.6:
            return ((kn.LOAD, int(rng.integers(0, n_cols))),)
        return ((kn.CONST, int(rng.integers(-(2**31), 2**31))),)
    if rng.random() < 0.3:
        op = int(rng.choice([kn.NEG, kn.LO16, kn.HI16, kn.NOT, kn.CLIP]))
        imm = int(rng.integers(1, 40)) if op == kn.CLIP else 0
        return _rand_code(rng, n_cols, depth - 1) + ((op, imm),)
    op = int(rng.choice([kn.ADD, kn.SUB, kn.MUL, kn.EQ, kn.NE, kn.LT,
                         kn.LE, kn.GT, kn.GE, kn.AND, kn.OR]))
    return (_rand_code(rng, n_cols, depth - 1)
            + _rand_code(rng, n_cols, depth - 1) + ((op, 0),))


def _tpch_programs():
    """(cols, valids, live, program, groups) of the port's own fused Q6
    and Q1 calls, on the CPU at SF 0.002 (megakernels on)."""
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    qs, _ = _queries()
    calls = []
    real = kn.fused_agg_sums

    def rec(*args):
        calls.append(args)
        return real(*args)

    kn.fused_agg_sums = rec
    try:
        s = tpch_session(0.002, device="cpu", megakernels="on")
        for q in ("Q6", "Q1"):
            s.execute(qs[q])
    finally:
        kn.fused_agg_sums = real
    return {"Q6": calls[0], "Q1": calls[1]}


def _longest_program(rng, k, groups):
    """64 terms over k columns plus a group-id column, encoded to exactly
    the kernel's MAX_INS instructions: chains of distinct constants that
    neither fold nor share."""
    from trino_tpu_torch.ops import kernels as kn

    ops = [kn.ADD, kn.SUB, kn.MUL]
    pred = ((kn.LOAD, 0), (kn.CONST, -(2**30)), (kn.GT, 0))
    gid = ((kn.LOAD, k), (kn.CLIP, groups))
    terms = [[(kn.LOAD, t % k)] for t in range(kn.MAX_TERMS)]
    # pred 1 + gid 1 + one ACC a term, the rest spread over the chains
    left = kn.MAX_INS - 2 - kn.MAX_TERMS
    for i in range(left):
        terms[i % kn.MAX_TERMS] += [(kn.CONST, int(rng.integers(2, 2**31))),
                                    (ops[i % 3], 0)]
    prog = kn.Program(pred, gid, tuple(tuple(t) for t in terms))
    assert len(kn.encode(prog).ins) == kn.MAX_INS
    return prog


def _deep_ops(cols, k0):
    """Products of columns and distinct constants summed right to left:
    stack depth len(cols) + 1, every operand a temporary."""
    from trino_tpu_torch.ops import kernels as kn

    return (sum((((kn.LOAD, c), (kn.CONST, k0 + i), (kn.MUL, 0))
                 for i, c in enumerate(cols)), ())
            + ((kn.ADD, 0),) * (len(cols) - 1))


def _widest_program(k, groups):
    """k columns (the last the group id), 64 terms, a predicate and a
    term at the postfix kernel's stack limit of 16: at 73 int64 columns
    with validity lanes, the widest program check_program lets through,
    in blocks of 32 threads."""
    from trino_tpu_torch.ops import kernels as kn

    terms = [((kn.LOAD, t % (k - 1)),) for t in range(kn.MAX_TERMS)]
    terms[0] = _deep_ops(range(15), 101)
    return kn.Program(_deep_ops(range(k - 16, k - 1), 3) + ((kn.CONST, 0), (kn.GT, 0)),
                      ((kn.LOAD, k - 1), (kn.CLIP, groups)), tuple(terms))


def _slot_pressure_program(n=250):
    """Two terms summing the same n products in opposite orders: shared,
    all n products would stay live from one term to the other, so the
    encoder evaluates each term on its own."""
    from trino_tpu_torch.ops import kernels as kn

    v = [((kn.LOAD, j % 16), (kn.CONST, 1000 + j), (kn.MUL, 0)) for j in range(n)]
    return kn.Program((), (), tuple(
        w[0] + sum((x + ((kn.ADD, 0),) for x in w[1:]), ()) for w in (v, v[::-1])))


def _fused_cases(dev):
    """(label, cols, valids, live, program, groups): the cases of the JAX
    package's megakernel unit tests, random programs, the lanes as the
    scan stores them (int64 values outside int32, validity lanes with
    false entries), Q6's and Q1's own programs, folding, ragged sizes
    around the tile and grid steps, misaligned views (which the wrapper
    copies), the longest and the widest programs the launch takes, and
    one whose shared values would overflow the slots."""
    from trino_tpu_torch.ops import kernels as kn

    rng = np.random.default_rng(SEED)
    i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)  # noqa: E731
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731
    rand_ok = lambda n, p=0.9: torch.as_tensor(rng.random(n) < p, device=dev)  # noqa: E731
    L, C = kn.LOAD, kn.CONST
    planes = ((((L, 0), (kn.LO16, 0)), ((L, 0), (kn.HI16, 0))))
    cases = []
    vals = rng.integers(0, 2**30, size=5000)
    cases.append(("plane recombination", [i32(vals)], ones(5000),
                  kn.Program((), (), planes), 1))
    cases.append(("saturated lanes", [i32(np.full(4096, (1 << 30) - 1))],
                  ones(4096), kn.Program((), (), planes), 1))
    a = rng.integers(90_000, 10_495_001, size=3000)
    b = rng.integers(0, 32_768, size=3000)
    p_lo = ((L, 0), (kn.LO16, 0), (L, 1), (kn.MUL, 0))
    p_hi = ((L, 0), (kn.HI16, 0), (L, 1), (kn.MUL, 0))
    cases.append(("limb split", [i32(a), i32(b)], ones(3000), kn.Program(
        (), (), (p_lo + ((kn.LO16, 0),), p_lo + ((kn.HI16, 0),),
                 p_hi + ((kn.LO16, 0),), p_hi + ((kn.HI16, 0),))), 1))
    keys = rng.integers(0, 3, size=2500)
    v = rng.integers(0, 100_000, size=2500)
    live = torch.as_tensor(rng.random(2500) < 0.6, device=dev)
    cases.append(("grouped with selection", [i32(keys), i32(v)], live,
                  kn.Program((), ((L, 0),), (((C, 1),), ((L, 1),))), 3))
    cases.append(("predicate", [i32(np.arange(1000))], ones(1000),
                  kn.Program(((L, 0), (C, 100), (kn.LT, 0)), (),
                             (((L, 0),),)), 1))
    cases.append(("no rows", [i32(np.zeros(0))],
                  torch.zeros(0, dtype=torch.bool, device=dev),
                  kn.Program((), (), (((C, 1),),)), 1))
    for r in range(12):
        n = int(rng.integers(1, 200_000))
        k = int(rng.integers(1, 5))
        cols = [i32(rng.integers(-(2**31), 2**31, size=n)) for _ in range(k)]
        groups = int(rng.integers(1, 33))
        cols.append(i32(rng.integers(-1, groups + 2, size=n)))
        gid = ((L, k), (kn.CLIP, groups)) if groups > 1 else ()
        pred = _rand_code(rng, k, 3) if r % 2 else ()
        terms = tuple(_rand_code(rng, k, 3) for _ in range(int(rng.integers(1, 12))))
        live = torch.as_tensor(rng.random(n) < 0.9, device=dev)
        cases.append((f"random program {r}", cols, live,
                      kn.Program(pred, gid, terms), groups))
    cases = [(lbl, cols, [None] * len(cols), live, prog, g)
             for lbl, cols, live, prog, g in cases]

    # lanes as stored: int64 values outside int32 narrow like
    # .to(torch.int32); validity lanes with false entries
    for r in range(6):
        n = int(rng.integers(1, 300_000))
        k = int(rng.integers(1, 5))
        groups = int(rng.integers(1, 33))
        cols = [i64(rng.integers(-(2**62), 2**62, size=n)) if j % 2 == 0
                else i32(rng.integers(-(2**31), 2**31, size=n)) for j in range(k)]
        cols.append(i64(rng.integers(-1, groups + 2, size=n) + (rng.integers(-2, 3, n) << 32)))
        gid = ((L, k), (kn.CLIP, groups)) if groups > 1 else ()
        pred = _rand_code(rng, k, 3) if r % 2 else ()
        terms = tuple(_rand_code(rng, k, 3) for _ in range(int(rng.integers(1, 12))))
        valids = [rand_ok(n) if j % 3 != 1 else None for j in range(k + 1)]
        cases.append((f"int64 lanes beyond int32, validity lanes {r}", cols, valids,
                      rand_ok(n, 0.95), kn.Program(pred, gid, terms), groups))
    # constants that fold with int32 wrap (constant predicate and terms)
    big = ((C, 2**31 - 1), (C, 2), (kn.MUL, 0))
    v = i64(rng.integers(-(2**40), 2**40, 100_000))
    cases.append(("folding with wrap", [v], [rand_ok(100_000)], ones(100_000),
                  kn.Program(big + ((C, -2), (kn.EQ, 0)), (),
                             (big, big + ((kn.NEG, 0),), ((C, -(2**31)), (kn.NEG, 0)),
                              ((L, 0), (C, 3), (C, 4), (kn.MUL, 0), (kn.SUB, 0)))), 1))
    cases.append(("predicate folds to false", [v], [None], ones(100_000),
                  kn.Program(((L, 0), (C, 0), (C, 1), (kn.GT, 0), (kn.AND, 0)), (),
                             (((C, 1),),)), 1))
    # Q6's and Q1's own programs (shared subexpressions) over their own
    # lanes' types, the SF 0.002 rows repeated to 1 M rows, with random
    # validity and live lanes
    for q, (cols, valids, live, prog, groups) in _tpch_programs().items():
        reps = -(-1_000_003 // live.shape[0])
        tile = lambda t: t.repeat(reps)[:1_000_003].to(dev)  # noqa: E731
        cols = [tile(c) for c in cols]
        cases.append((f"{q}'s program ({len(kn.encode(prog).ins)} instructions)", cols,
                      [rand_ok(1_000_003, 0.97) for _ in cols], rand_ok(1_000_003, 0.95),
                      prog, groups))
        if q == "Q6":  # l_quantity (column 2) at 25: quantity < 24 fails everywhere
            big_qty = [c if j != 2 else torch.full_like(c, 2500) for j, c in enumerate(cols)]
            cases.append(("Q6's program, no row passes", big_qty,
                          [None] * len(cols), ones(1_000_003), prog, groups))
    # sizes around a thread's 4 rows, the tiles of 256 / 512 / 1024 rows
    # (64, 128 or 256 threads) and one step of a 2-blocks-an-SM grid;
    # views one element in (int64 8 bytes and int32 4 bytes off 16,
    # bools off 4), 0 rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ns = {0, 1, 2, 3, 4, 5, 7, 8, 9}
    for s in (256, 512, 1024, 2 * sms * 1024):
        ns |= {s - 1, s, s + 1}
    prog = kn.Program(((L, 1), (C, 3), (kn.GT, 0)), ((L, 2), (kn.CLIP, 5)),
                      (((C, 1),), ((L, 0), (kn.LO16, 0)), ((L, 0), (L, 1), (kn.MUL, 0))))
    for n in sorted(ns):
        for off in (0, 1):
            a = rng.integers(-(2**40), 2**40, n)
            b = rng.integers(-10, 10, n)
            g = rng.integers(-1, 6, n)
            cols = [_dev_view(a, off, dev, 2**40 + 7), _dev_view(b.astype(np.int32), off, dev, 9),
                    _dev_view(g, off, dev, 1)]
            valids = [_dev_view(rng.random(n) < 0.9, off, dev, True), None,
                      _dev_view(rng.random(n) < 0.9, off, dev, True)]
            cases.append((f"n={n}, views {off} element in", cols, valids,
                          _dev_view(rng.random(n) < 0.9, off, dev, True), prog, 5))
    for off in (2, 3, 5):
        n = 300_001
        cols = [_dev_view(rng.integers(-(2**40), 2**40, n), off, dev, 2**40 + 7),
                _dev_view(rng.integers(-10, 10, n).astype(np.int32), off + 1, dev, 9),
                _dev_view(rng.integers(-1, 6, n), 0, dev, 1)]
        cases.append((f"views {off}/{off + 1}/0 elements in", cols,
                      [_dev_view(rng.random(n) < 0.9, off, dev, True), None, None],
                      _dev_view(rng.random(n) < 0.9, off + 2, dev, True), prog, 5))
    # the longest programs: 64 terms, MAX_INS instructions, 32 groups and
    # one group
    n = 500_000
    for groups in (32, 1):
        cols = [i64(rng.integers(-(2**62), 2**62, n)),
                i32(rng.integers(-(2**31), 2**31, n)), i32(rng.integers(-1, 34, n))]
        cases.append((f"64 terms, {groups} groups, {kn.MAX_INS} instructions", cols,
                      [rand_ok(n), None, rand_ok(n)], rand_ok(n),
                      _longest_program(rng, 2, groups), groups))
    # the widest: 73 int64 columns with validity lanes (blocks of 32
    # threads); shared values beyond the slots
    n = 300_001
    for groups in (32, 1):
        cols = [i64(rng.integers(-(2**62), 2**62, n)) for _ in range(72)]
        cols.append(i64(rng.integers(-1, 34, n)))
        cases.append((f"73 int64 columns with validity, {groups} groups", cols,
                      [rand_ok(n) for _ in cols], rand_ok(n),
                      _widest_program(73, groups), groups))
    cols = [i32(rng.integers(-(2**31), 2**31, n)) for _ in range(16)]
    for k, how in ((120, "shared: slots past 127"), (250, "unshared encoding")):
        prog = _slot_pressure_program(k)
        cases.append((f"{k} products live across two terms ({how}, "
                      f"{kn.encode(prog).n_slots} slots)", cols, [None] * 16,
                      rand_ok(n), prog, 1))
    return cases


def _dev_view(a, off, dev, fill):
    """`a` on the card as a contiguous view `off` elements into a larger
    tensor whose first `off` elements hold `fill`; its base pointer is
    off the 16-byte alignment of a fresh allocation unless off x itemsize
    is a multiple of 16."""
    pad = np.full(off, fill, dtype=a.dtype)
    return torch.as_tensor(np.concatenate([pad, a]), device=dev)[off:]


# rows in one unrolled step of a thread and of a block: 2 rows a vector x
# kUnroll (x 256 threads) in csrc/grouped_sum.cu and csrc/grouped_count.cu
SUM_STEP_ROWS = (8, 2048)
COUNT_STEP_ROWS = (16, 4096)
CAP_EDGES = (1, 4, 5, 8, 9, 16, 17, 32)
# (value or flag offset, id offset) of the misaligned views, in elements:
# int64 offsets 1 and 3 lie 8 bytes off 16, flag offsets 1 to 15 off too
VIEW_OFFSETS = ((1, 0), (0, 1), (1, 1), (2, 3), (3, 2), (5, 0), (5, 1), (3, 3))


def _edge_ns(step_rows):
    ns = {1, 2, 3, 15, 16, 17, 33}
    for s in step_rows:
        ns |= {s - 1, s, s + 1}
    return sorted(ns)


def _count_cases(dev):
    rng = np.random.default_rng(SEED + 1)
    cases = []
    flags = rng.integers(0, 2, 300_000).astype(bool)
    gid = rng.integers(0, 9, 300_000)
    cases.append(("JAX test shape", flags, gid, 9))
    for r in range(8):
        n = int(rng.integers(0, 3_000_000))
        cap = int(rng.integers(1, 33))
        flags = rng.random(n) < rng.random()
        gid = rng.integers(-3, cap + 3, n)  # out-of-range ids skipped
        cases.append((f"random {r} (out-of-range ids)", flags, gid, cap))
    cases.append(("all one group", np.ones(1 << 20, bool),
                  np.zeros(1 << 20, np.int64), 1))
    out = [(lbl, torch.as_tensor(f, device=dev),
            torch.as_tensor(g.astype(np.int64), device=dev), c)
           for lbl, f, g, c in cases]
    # edges of the private-counter design: ragged sizes around the
    # unrolled steps, every cap bucket edge, misaligned views
    edge = []
    for n in _edge_ns(COUNT_STEP_ROWS):
        for off in ((0, 0), (1, 1), (5, 0)):
            edge.append((f"n={n} flags[{off[0]}:] gid[{off[1]}:]",
                         rng.random(n) < 0.7, rng.integers(-1, 13, n), 12, off))
    for cap in CAP_EDGES:
        edge.append((f"cap edge {cap}", rng.random(100_001) < 0.6,
                     rng.integers(-2, cap + 2, 100_001), cap, (0, 0)))
    for off in VIEW_OFFSETS:
        edge.append((f"view flags[{off[0]}:], gid[{off[1]}:]",
                     rng.random(200_003) < 0.5,
                     rng.integers(-1, 13, 200_003), 12, off))
    n = (1 << 20) + 3
    edge.append(("all rows in group 7 of 12", np.ones(n, bool),
                 np.full(n, 7, np.int64), 12, (1, 1)))
    edge.append(("all ids out of range", np.ones(n, bool),
                 np.where(rng.random(n) < 0.5, -1, 12), 12, (0, 0)))
    edge.append(("all flags false", np.zeros(n, bool),
                 rng.integers(0, 12, n), 12, (5, 1)))
    # a view's hidden leading elements would count if read: set flags
    # and in-range ids
    return out + [(lbl, _dev_view(f, fo, dev, True),
                   _dev_view(g.astype(np.int64), go, dev, 0), c)
                  for lbl, f, g, c, (fo, go) in edge]


def _sum_cases(dev):
    """(label, values, gid, cap) for grouped_sum_i64: random, ids outside
    [0, cap), values near +-2^63 whose sums wrap, empty and one group,
    ragged sizes, cap bucket edges and misaligned views."""
    rng = np.random.default_rng(SEED + 2)
    cases = []
    for r in range(6):
        n = int(rng.integers(0, 3_000_000))
        cap = int(rng.integers(1, 33))
        cases.append((f"random {r} (out-of-range ids)",
                      rng.integers(-(2**40), 2**40, n),
                      rng.integers(-3, cap + 3, n), cap))
    n = 1 << 20
    near = np.where(rng.random(n) < 0.5, 2**63 - 1 - rng.integers(0, 1000, n),
                    -(2**63) + rng.integers(0, 1000, n))
    cases.append(("values near +-2^63 (wrapping sums)", near,
                  rng.integers(0, 12, n), 12))
    cases.append(("int64 extremes, one group", np.full(4097, 2**63 - 1),
                  np.zeros(4097, np.int64), 1))
    cases.append(("full range, cap 32", rng.integers(-(2**63), 2**63 - 1, 500_000),
                  rng.integers(0, 32, 500_000), 32))
    cases.append(("no rows", np.zeros(0, np.int64), np.zeros(0, np.int64), 5))
    cases = [(lbl, v, g, c, (0, 0)) for lbl, v, g, c in cases]
    for n in _edge_ns(SUM_STEP_ROWS):
        for off in ((0, 0), (1, 1), (1, 0)):
            cases.append((f"n={n} values[{off[0]}:] gid[{off[1]}:]",
                          rng.integers(-(2**62), 2**62, n),
                          rng.integers(-1, 13, n), 12, off))
    for cap in CAP_EDGES:
        cases.append((f"cap edge {cap}",
                      rng.integers(-(2**63), 2**63 - 1, 100_001),
                      rng.integers(-2, cap + 2, 100_001), cap, (0, 0)))
    for off in VIEW_OFFSETS:
        cases.append((f"view values[{off[0]}:], gid[{off[1]}:]",
                      rng.integers(-(2**63), 2**63 - 1, 200_003),
                      rng.integers(-1, 13, 200_003), 12, off))
    n = (1 << 20) + 3
    cases.append(("all rows in group 7 of 12 (wrapping)",
                  np.concatenate([near, [1, 2, 3]]),
                  np.full(n, 7, np.int64), 12, (1, 1)))
    cases.append(("all ids out of range", rng.integers(-(2**40), 2**40, n),
                  np.where(rng.random(n) < 0.5, -1, 12), 12, (0, 0)))
    # a view's hidden leading elements would count if read: large values
    # and in-range ids
    return [(lbl, _dev_view(np.asarray(v, np.int64), vo, dev, 2**62 + 1),
             _dev_view(np.asarray(g, np.int64), go, dev, 0), c)
            for lbl, v, g, c, (vo, go) in cases]


def _probe_cases(dev):
    """(label, table, key, ok, sel, lo) for direct_probe: the micro-probe's
    own shape, random tables and keys, out-of-domain, negative and
    extreme keys, NULL keys, int32 keys and empty inputs; lengths around
    the kernel's tiles and grid, wrapping slots, views off 16 bytes, and
    Q3's two joins at their SF10 sizes."""
    from trino_tpu_torch.ops import kernels as kn

    rng = np.random.default_rng(SEED + 3)
    cases = []
    # scripts/micro_probe.py: 150,000-entry table (30,000 build rows),
    # 4 M int32 probes, every key in the domain and live
    dom, nb, m = 150_000, 30_000, 4 << 20
    table = np.zeros(dom, np.int32)
    table[rng.choice(dom, size=nb, replace=False)] = np.arange(1, nb + 1, dtype=np.int32)
    cases.append(("micro-probe shape (150,000 slots, 4 M int32 probes)", table,
                  rng.integers(0, dom, m).astype(np.int32),
                  np.ones(m, bool), np.ones(m, bool), 0))
    for r in range(4):
        dom = int(rng.integers(1, 3_000_000))
        n = int(rng.integers(1, 4_000_000))
        lo = int(rng.integers(-(2**40), 2**40))
        table = np.where(rng.random(dom) < 0.3, 0,
                         rng.integers(1, 2**31 - 1, dom)).astype(np.int32)
        key = lo + rng.integers(-dom // 4 - 2, dom + dom // 4 + 2, n)
        cases.append((f"random {r} (out-of-domain keys)", table, key,
                      rng.random(n) < 0.9, rng.random(n) < 0.7, lo))
    table = rng.integers(-5, 50, 1000).astype(np.int32)
    key = np.concatenate([np.array([-(2**63), 2**63 - 1, -1, 0, 999, 1000, 1001]),
                          rng.integers(-(2**63), 2**63 - 1, 5_000),
                          rng.integers(-10, 1010, 5_000)])
    n = key.shape[0]
    cases.append(("extreme and negative keys, wrapping key - lo", table, key,
                  rng.random(n) < 0.5, np.ones(n, bool), 1))
    cases.append(("negative lo, int32 keys", rng.integers(0, 9, 77).astype(np.int32),
                  rng.integers(-100, 0, 5000).astype(np.int32),
                  np.ones(5000, bool), rng.random(5000) < 0.5, -60))
    cases.append(("all keys NULL", np.arange(10, dtype=np.int32),
                  np.arange(100), np.zeros(100, bool), np.ones(100, bool), 0))
    cases.append(("no rows", np.arange(4, dtype=np.int32), np.zeros(0, np.int64),
                  np.zeros(0, bool), np.zeros(0, bool), 0))
    cases = [(lbl, t, k, o, s, lo, (0, 0, 0)) for lbl, t, k, o, s, lo in cases]
    # the redesign's edges (csrc/direct_probe.cu): lengths around a warp's
    # tile, a block's tiles and one step of the full grid, and fewer
    # rows than one tile an SM; tables whose slots wrap (INT32_MIN - 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = kn.PROBE_TILE_ROWS
    block = tile * kn.PROBE_WARPS
    ns = {1, 2, 15, 16, 17, 31, 32, 33, sms * tile // 3, sms * tile - 1}
    for s in (tile, block, kn._probe_grid(torch.cuda.current_device()) * block):
        ns |= {s - 1, s, s + 1}
    slots = np.array([-(2**31), 2**31 - 1, 0, -1, 1, 2, 3], np.int32)
    for n in sorted(ns):
        for kdt in (np.int64, np.int32):
            lo = int(rng.integers(-3000, 3000))
            cases.append((f"n={n} {np.dtype(kdt).name} keys, wrapping slots",
                          rng.choice(slots, 5000), (lo + rng.integers(-40, 5040, n)).astype(kdt),
                          rng.random(n) < 0.9, rng.random(n) < 0.7, lo, (0, 0, 0)))
    # views off 16 bytes (the wrapper copies them): ok and sel 1 to 15
    # bytes off, int64 keys 8 bytes off, int32 keys 4 bytes off
    for o in range(1, 16):
        n = 100_003 + o
        kdt = np.int64 if o % 2 else np.int32
        koff = 1 if o % 3 else 0
        lo = -777
        cases.append((f"views: ok[{o}:], sel[{(o * 7) % 16}:], {np.dtype(kdt).name} "
                      f"key[{koff}:]", rng.choice(slots, 20_000),
                      (lo + rng.integers(-100, 20_100, n)).astype(kdt),
                      rng.random(n) < 0.8, rng.random(n) < 0.6, lo, (koff, o, (o * 7) % 16)))
    # Q3's orderkey join at 30 M probes: TPC-H order keys use 8 of every
    # 32 values, so the sorted lineitem keys touch one table sector in
    # four; a build side holding about a fifth of the orders
    orders = 7_600_000
    okeys = (np.arange(orders) // 8) * 32 + np.arange(orders) % 8 + 1
    key = np.repeat(okeys, rng.integers(1, 8, orders))[:30_000_000]
    table = np.zeros(int(okeys[-1]) + 1, np.int32)
    build = okeys[rng.random(orders) < 0.2]
    table[build] = np.arange(1, build.shape[0] + 1, dtype=np.int32)
    n = key.shape[0]
    cases.append((f"orderkey-like: {n} sorted int64 probes, one table sector in four",
                  table, key, np.ones(n, bool), rng.random(n) < 0.54, 0, (0, 0, 0)))
    r = rng.random(1_500_001)
    table = np.where(r < 0.2, np.arange(1_500_001, dtype=np.int32),
                     np.where(r < 0.3, -(2**31), 0)).astype(np.int32)
    n = 7_780_000
    cases.append((f"custkey-like: {n} random int64 probes, INT32_MIN slots",
                  table, rng.integers(0, 1_500_001, n), rng.random(n) < 0.99,
                  np.ones(n, bool), 0, (1, 3, 0)))
    views = {np.dtype(np.int32): 2**31 - 1, np.dtype(np.int64): 2**62, np.dtype(bool): True}
    return [(lbl, torch.as_tensor(np.asarray(t, np.int32), device=dev),
             _dev_view(k, ko, dev, views[k.dtype]), _dev_view(o, oo, dev, True),
             _dev_view(s, so, dev, True), lo)
            for lbl, t, k, o, s, lo, (ko, oo, so) in cases]


def _parent_kernels(path):
    """The ops/kernels.py of an earlier checkout of the repository at
    `path`, loaded on its own (it imports nothing else of its package)
    and built into that checkout's build directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(path, "trino_tpu_torch", "ops", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def phase_kernels(dev):
    from trino_tpu_torch.ops import kernels as kn

    bad = 0
    cases = _fused_cases(dev)
    for lbl, cols, valids, live, prog, groups in cases:
        got = kn.fused_agg_sums(cols, valids, live, prog, groups)
        want = kn.fused_agg_sums_plain(cols, valids, live, prog, groups)
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and not ("no row passes" in lbl and want.any())
        bad += not ok
        _log(f"[kernels] fused_agg_sums {lbl}: "
             f"{'exact' if ok else 'MISMATCH'} ({len(prog.terms)} terms, "
             f"{groups} groups, {live.shape[0]} rows, "
             f"{len(kn.encode(prog).ins)} instructions)")
    # the wrapper queues its launch without a host sync or a host copy
    # (a view off 16 bytes only gets a device copy): run it with PyTorch's
    # sync debug mode raising on any synchronising call
    for pick in ("Q6", "n=1025, views 1 element in"):
        lbl, cols, valids, live, prog, groups = next(c for c in cases if c[0].startswith(pick))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = kn.fused_agg_sums(cols, valids, live, prog, groups)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ok = torch.equal(got, kn.fused_agg_sums_plain(cols, valids, live, prog, groups))
        bad += not ok
        _log(f"[kernels] fused_agg_sums under set_sync_debug_mode('error'), {lbl}: "
             f"{'no sync, exact' if ok else 'MISMATCH'}")
    for lbl, flags, gid, cap in _count_cases(dev):
        got = kn.grouped_count(flags, gid, cap)
        want = kn.grouped_count_plain(flags, gid, cap)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        bad += not ok
        _log(f"[kernels] grouped_count {lbl}: "
             f"{'exact' if ok else 'MISMATCH'} (cap {cap}, "
             f"{flags.shape[0]} rows)")
    for lbl, vals, gid, cap in _sum_cases(dev):
        got = kn.grouped_sum_i64(vals, gid, cap)
        want = kn.grouped_sum_i64_plain(vals, gid, cap)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        bad += not ok
        _log(f"[kernels] grouped_sum_i64 {lbl}: "
             f"{'exact' if ok else 'MISMATCH'} (cap {cap}, {vals.shape[0]} rows)")
    kernels = [("direct_probe", kn)] + ([("parent's direct_probe", PARENT["kn"])]
                                        if "kn" in PARENT else [])
    for lbl, table, key, okl, sel, lo in _probe_cases(dev):
        want = kn.direct_probe_plain(table, key, okl, sel, lo)
        for name, mod in kernels:
            got = mod.direct_probe(table, key, okl, sel, lo)
            torch.cuda.synchronize()
            ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            if lbl.startswith("micro-probe"):
                # the micro-probe's own check: out[i] = table[probe[i]] (its
                # table held build row, ours build row + 1)
                ok = ok and torch.equal(got[0], (table[key.long()] - 1).long())
            bad += not ok
            _log(f"[kernels] {name} {lbl}: "
                 f"{'exact' if ok else 'MISMATCH'} ({table.shape[0]} slots, "
                 f"{key.shape[0]} {key.dtype} probes, {int(got[1].sum())} matched)")
    if bad:
        raise AssertionError(f"{bad} kernel cases disagree with the plain versions")


# ---------------------------------------------------------------------------
# TPC-H reference (numpy, exact integers) and the queries


def _tpch_sql():
    """The 22 TPC-H statements of tests/tpch_sql.py (a file of plain
    strings that imports neither package), as {"Q1": sql, ...}."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "tpch_sql.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tpch_sql", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {f"Q{n}": entry[0] for n, entry in sorted(mod.QUERIES.items())}


def _queries():
    """Q6, Q1 and Q3 of the main path and their date cuts."""
    from trino_tpu_torch.expr.functions import days_from_civil

    q1_cut = days_from_civil(1998, 12, 1) - 90
    q6_lo = days_from_civil(1994, 1, 1)
    q6_hi = days_from_civil(1995, 1, 1)
    q3_cut = days_from_civil(1995, 3, 15)
    qs = _tpch_sql()
    return ({q: qs[q] for q in ("Q6", "Q1", "Q3")},
            (q1_cut, q6_lo, q6_hi, q3_cut))


def _raw(col, i):
    """Exact python int of row i of a decimal/bigint column (two limbs
    for wide decimals)."""
    v = np.asarray(col.values)
    if v.ndim == 2:
        return (int(v[i, 1]) << 64) | int(np.uint64(v[i, 0]))
    return int(v[i])


def _half_away(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def check_reference(pages, cols, dicts):
    """Hold the Q6/Q1 pages against exact numpy/python arithmetic over
    the same lineitem columns (host arrays)."""
    _, (q1_cut, q6_lo, q6_hi, _) = _queries()
    sd = cols["l_shipdate"].astype(np.int64)
    qty = cols["l_quantity"].astype(np.int64)
    ext = cols["l_extendedprice"].astype(np.int64)
    disc = cols["l_discount"].astype(np.int64)
    m6 = (sd >= q6_lo) & (sd < q6_hi) & (disc >= 5) & (disc <= 7) & (qty < 2400)
    rev = int((ext[m6] * disc[m6]).sum())
    got = _raw(pages["Q6"].columns[0], 0)
    if got != rev:
        raise AssertionError(f"Q6 revenue {got} != reference {rev}")
    tax = cols["l_tax"].astype(np.int64)
    rf, ls = cols["l_returnflag"], cols["l_linestatus"]
    m1 = sd <= q1_cut
    rows = []
    for a in range(len(dicts["l_returnflag"])):
        for b in range(len(dicts["l_linestatus"])):
            m = m1 & (rf == a) & (ls == b)
            n = int(m.sum())
            if not n:
                continue
            sq, se = int(qty[m].sum()), int(ext[m].sum())
            dp = ext[m] * (100 - disc[m])
            sdp = int(dp.sum())
            sch = int((dp * (100 + tax[m])).sum())
            sdisc = int(disc[m].sum())
            rows.append((str(dicts["l_returnflag"][a]), str(dicts["l_linestatus"][b]),
                         sq, se, sdp, sch, _half_away(sq * 10**4, n),
                         _half_away(se * 10**4, n), _half_away(sdisc * 10**4, n), n))
    rows.sort(key=lambda r: (r[0], r[1]))
    p = pages["Q1"]
    if p.count != len(rows):
        raise AssertionError(f"Q1 has {p.count} groups, reference {len(rows)}")
    for i, want in enumerate(rows):
        got = tuple(p.columns[j].to_python(p.count)[i] for j in (0, 1)) + tuple(
            _raw(p.columns[j], i) for j in range(2, 10))
        if got != want:
            raise AssertionError(f"Q1 row {i}: {got} != reference {want}")


def check_q3(page, li, orders, cust, cdicts):
    """Hold Q3's page against an exact reference over the host arrays:
    joins by searchsorted, revenue = sum(ext * (100 - disc)) per orderkey
    in int64 (at most 7 lines of at most 1.05e9 each: no wrap), top 10 by
    revenue desc, orderdate asc.  Rows tied on both keys may come in any
    order, so each row is checked against its own order's values and the
    sequence of (revenue, orderdate) against the reference's."""
    _, (_, _, _, cut) = _queries()
    seg = list(cdicts["c_mktsegment"]).index("BUILDING")
    building = np.sort(cust["c_custkey"][cust["c_mktsegment"] == seg])
    ocust = orders["o_custkey"]
    pos = np.clip(np.searchsorted(building, ocust), 0, max(len(building) - 1, 0))
    om = (orders["o_orderdate"] < cut) & (building[pos] == ocust)
    okey = orders["o_orderkey"][om]
    order = np.argsort(okey)
    okey = okey[order]
    odate = orders["o_orderdate"][om][order]
    oprio = orders["o_shippriority"][om][order]
    lm = li["l_shipdate"] > cut
    lkey = li["l_orderkey"][lm]
    at = np.clip(np.searchsorted(okey, lkey), 0, max(len(okey) - 1, 0))
    hit = okey[at] == lkey
    rev = (li["l_extendedprice"][lm][hit].astype(np.int64)
           * (100 - li["l_discount"][lm][hit].astype(np.int64)))
    oidx = at[hit]
    sums = np.zeros(len(okey), np.int64)
    np.add.at(sums, oidx, rev)
    has = np.bincount(oidx, minlength=len(okey)) > 0
    keys, revs, dates, prios = okey[has], sums[has], odate[has], oprio[has]
    top = np.lexsort((dates, -revs))[:10]
    want = [(int(revs[i]), int(dates[i])) for i in top]
    if page.count != len(want):
        raise AssertionError(f"Q3 has {page.count} rows, reference {len(want)}")
    by_key = {int(k): (int(r), int(d), int(p)) for k, r, d, p in
              zip(keys, revs, dates, prios)}
    got = []
    for i in range(page.count):
        k = _raw(page.columns[0], i)
        row = (_raw(page.columns[1], i), _raw(page.columns[2], i),
               _raw(page.columns[3], i))
        if by_key.get(k) != row:
            raise AssertionError(f"Q3 row {i}: order {k} {row} != reference "
                                 f"{by_key.get(k)}")
        got.append(row[:2])
    if got != want:
        raise AssertionError(f"Q3 top 10 {got} != reference {want}")


def _scan_host_columns(session, needed, table="lineitem"):
    """The host arrays (and dictionaries) of the session's cached scan of
    `table` that holds every column in `needed`."""
    for key, entry in session._scan_cache.entries.items():
        if key[1] == table and set(needed) <= set(entry["merged"]):
            return ({c: v for c, (v, _ok) in entry["merged"].items()},
                    entry["dicts"])
    raise AssertionError(f"no cached {table} scan with columns {needed}")


def check_q3_page(session, page):
    li, _ = _scan_host_columns(session, ["l_orderkey", "l_shipdate"])
    orders, _ = _scan_host_columns(session, ["o_custkey"], "orders")
    cust, cdicts = _scan_host_columns(session, ["c_mktsegment"], "customer")
    check_q3(page, li, orders, cust, cdicts)


def _expect_rows(label, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{label} has {len(got)} rows, reference {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"{label} row {i}: {g} != reference {w}")


def check_q4(session, page):
    """Q4 (EXISTS): orders of 1993 Q3 with a line committed before its
    receipt, counted by priority."""
    from trino_tpu_torch.expr.functions import days_from_civil

    li, _ = _scan_host_columns(session, ["l_orderkey", "l_commitdate", "l_receiptdate"])
    orders, odicts = _scan_host_columns(session, ["o_orderpriority", "o_orderdate"],
                                        "orders")
    late = np.unique(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])
    od = orders["o_orderdate"]
    om = (od >= days_from_civil(1993, 7, 1)) & (od < days_from_civil(1993, 10, 1))
    hit = np.isin(orders["o_orderkey"][om], late)
    d = odicts["o_orderpriority"]
    counts = {}
    for code, n in enumerate(np.bincount(orders["o_orderpriority"][om][hit],
                                         minlength=len(d))):
        if n:
            counts[str(d[code])] = counts.get(str(d[code]), 0) + int(n)
    _expect_rows("Q4", page.to_pylist(), sorted(counts.items()))


def check_q18(session, page):
    """Q18 (IN over a grouped subquery): orders whose lines hold more than
    300 units, top 100 by total price desc, order date.  Rows tied on
    both keys may come in any order, so each row is checked against its
    own order's values and the sequence of keys against the
    reference's."""
    li, _ = _scan_host_columns(session, ["l_orderkey", "l_quantity"])
    orders, _ = _scan_host_columns(session, ["o_orderkey", "o_custkey", "o_totalprice",
                                             "o_orderdate"], "orders")
    cust, cdicts = _scan_host_columns(session, ["c_custkey", "c_name"], "customer")
    # quantities are x100 lanes: at most 7 lines of 5000 an order, exact
    # in float64
    qsum = np.bincount(li["l_orderkey"], weights=li["l_quantity"])
    big = np.nonzero(qsum > 30000)[0]
    ok_sorted = np.argsort(orders["o_orderkey"])
    at = ok_sorted[np.searchsorted(orders["o_orderkey"], big, sorter=ok_sorted)]
    price = orders["o_totalprice"][at].astype(np.int64)
    date = orders["o_orderdate"][at].astype(np.int64)
    cust_of = orders["o_custkey"][at]
    c_sorted = np.argsort(cust["c_custkey"])
    crow = c_sorted[np.searchsorted(cust["c_custkey"], cust_of, sorter=c_sorted)]
    names = cdicts["c_name"]
    by_key = {int(k): (str(names[cust["c_name"][r]]), int(c), int(d), int(p),
                       int(round(qsum[k])))
              for k, r, c, d, p in zip(big, crow, cust_of, date, price)}
    top = np.lexsort((date, -price))[:100]
    want = [(int(price[i]), int(date[i])) for i in top]
    if page.count != len(want):
        raise AssertionError(f"Q18 has {page.count} rows, reference {len(want)}")
    names_out = page.columns[0].to_python(page.count)
    got = []
    for i in range(page.count):
        k = _raw(page.columns[2], i)
        row = (names_out[i], _raw(page.columns[1], i), _raw(page.columns[3], i),
               _raw(page.columns[4], i), _raw(page.columns[5], i))
        if by_key.get(k) != row:
            raise AssertionError(f"Q18 row {i}: order {k} {row} != reference "
                                 f"{by_key.get(k)}")
        got.append((row[3], row[2]))
    if got != want:
        raise AssertionError(f"Q18 (price, date) sequence {got[:5]}... != "
                             f"reference {want[:5]}...")


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def check_q22(session, page):
    """Q22 (scalar subquery, NOT EXISTS, substring): customers of seven
    country codes with a balance above the codes' average positive
    balance (avg is decimal(18, 6), rounded half away) and no orders,
    counted and summed by code."""
    cust, cdicts = _scan_host_columns(session, ["c_custkey", "c_phone", "c_acctbal"],
                                      "customer")
    orders, _ = _scan_host_columns(session, ["o_custkey"], "orders")
    code_of = np.array([str(p)[:2] for p in cdicts["c_phone"]])
    cc = code_of[cust["c_phone"]]
    inset = np.isin(cc, Q22_CODES)
    bal = cust["c_acctbal"].astype(np.int64)
    pos = inset & (bal > 0)
    avg6 = _half_away(int(bal[pos].sum()) * 10**4, int(pos.sum()))
    buyers = np.isin(cust["c_custkey"], np.unique(orders["o_custkey"]))
    m = inset & (bal * 10**4 > avg6) & ~buyers
    want = [(c, int((m & (cc == c)).sum()), int(bal[m & (cc == c)].sum()))
            for c in sorted(Q22_CODES) if (m & (cc == c)).any()]
    codes_out = page.columns[0].to_python(page.count)
    got = [(codes_out[i], _raw(page.columns[1], i), _raw(page.columns[2], i))
           for i in range(page.count)]
    _expect_rows("Q22", got, want)


def check_window(session, page):
    """The running sum over orders: sum(o_totalprice) by customer in
    order-key order, the first 100 rows by (customer, order key)."""
    orders, _ = _scan_host_columns(session, ["o_custkey", "o_orderkey", "o_totalprice"],
                                   "orders")
    ck, okey = orders["o_custkey"], orders["o_orderkey"]
    first = np.lexsort((okey, ck))[:100]
    price = orders["o_totalprice"][first].astype(np.int64)
    want, run, prev = [], 0, None
    for i, p in zip(first, price):
        run = int(p) + (run if ck[i] == prev else 0)
        prev = ck[i]
        want.append((int(ck[i]), int(okey[i]), run))
    got = [(_raw(page.columns[0], i), _raw(page.columns[1], i), _raw(page.columns[2], i))
           for i in range(page.count)]
    _expect_rows("window", got, want)


def check_window_all(session, page):
    """The same running sum over every order, reduced to its row count,
    sum, least and greatest value: a wrong reset or bound in any
    partition moves the sum."""
    orders, _ = _scan_host_columns(session, ["o_custkey", "o_orderkey", "o_totalprice"],
                                   "orders")
    ck = orders["o_custkey"]
    order = np.lexsort((orders["o_orderkey"], ck))
    ck = ck[order]
    price = orders["o_totalprice"][order].astype(np.int64)
    run = np.cumsum(price)
    n = len(run)
    head = np.ones(n, dtype=bool)
    head[1:] = ck[1:] != ck[:-1]
    start = np.maximum.accumulate(np.where(head, np.arange(n), 0))
    s = run - run[start] + price[start]
    if n and int(np.abs(s).max()) * n >= 2**63:
        raise AssertionError("window reference sum would overflow int64")
    want = [(n, int(s.sum()), int(s.min()), int(s.max()))]
    got = [tuple(_raw(c, 0) for c in page.columns)] if page.count else []
    _expect_rows("window over every order", got, want)


# ---------------------------------------------------------------------------
# phase 3: SF1 parity across fused / unfused / plain


# statements of the CPU tests that the SF1 phase runs beside the 22
# TPC-H queries: set operations (tests/test_torch_relational.py) and two
# window statements (tests/test_window.py)
WINDOW_SQL = (
    "select o_custkey, o_orderkey, "
    "sum(o_totalprice) over (partition by o_custkey order by o_orderkey) s "
    "from orders order by o_custkey, o_orderkey limit 100")
WINDOW_ALL_SQL = (
    "select count(*), sum(s), min(s), max(s) from (select "
    "sum(o_totalprice) over (partition by o_custkey order by o_orderkey) s "
    "from orders)")
SF1_EXTRA = {
    "UNION": "select c_mktsegment from customer union "
             "select o_orderpriority from orders order by 1",
    "INTERSECT": "select n_regionkey from nation intersect "
                 "select r_regionkey from region order by 1",
    "EXCEPT": "select o_totalprice from orders where o_orderkey < 50 except "
              "select o_totalprice from orders where o_orderkey < 20 order by 1",
    "WINDOW-running-sum": WINDOW_SQL,
    "WINDOW-sliding-minmax": (
        "select o_custkey, o_orderkey, "
        "min(o_totalprice) over (partition by o_custkey order by o_orderkey "
        "  rows between 3 preceding and current row) mn, "
        "max(o_totalprice) over (partition by o_custkey order by o_orderkey "
        "  rows between 2 preceding and 1 following) mx "
        "from orders order by o_custkey, o_orderkey limit 200"),
}
# kernel wrappers each statement must launch with megakernels on and off
# (read from a CPU run of this phase at SF1 with counting shims)
_GC, _GS, _DP = "grouped_count", "grouped_sum_i64", "direct_probe"
SF1_KERNELS = {
    "Q2": (_DP,), "Q3": (_DP,), "Q4": (_GC,), "Q5": (_GC, _GS, _DP),
    "Q7": (_GS, _DP), "Q8": (_GS, _DP), "Q9": (_DP,), "Q10": (_DP,),
    "Q11": (_GC, _GS, _DP), "Q12": (_GC, _GS, _DP), "Q14": (_GC, _GS, _DP),
    "Q15": (_GC,), "Q16": (_DP,), "Q17": (_GC, _GS, _DP), "Q18": (_DP,),
    "Q19": (_GC, _GS, _DP), "Q20": (_DP,), "Q21": (_DP,), "Q22": (_GC, _GS),
    "INTERSECT": (_GC,), "EXCEPT": (_GC,),
}
SF1_WANT = {(q, mode): k for q, k in SF1_KERNELS.items() for mode in ("on", "off")}
SF1_WANT.update({
    ("Q6", "on"): ("fused_agg_sums",), ("Q1", "on"): ("fused_agg_sums",),
    ("Q6", "off"): (_GS,), ("Q1", "off"): (_GC, _GS),
})
KERNEL_FNS = ("fused_agg_sums", "grouped_count", "grouped_sum_i64", "direct_probe")
# launches each main-path run must make, per kernel (Q1 does not fuse at
# SF10: see PERF.md; Q3 probes both of its joins)
MAIN_WANT = {
    ("Q6", "auto"): {"fused_agg_sums": 1},
    ("Q1", "auto"): {"grouped_count": 1, "grouped_sum_i64": 1},
    ("Q1", "off"): {"grouped_count": 1, "grouped_sum_i64": 1},
    ("Q3", "auto"): {"direct_probe": 2},
}


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel function replaced by its plain version meanwhile; no
    launch may count."""
    from trino_tpu_torch.ops import kernels as kn

    real = {name: getattr(kn, name) for name in KERNEL_FNS}
    for name in KERNEL_FNS:
        setattr(kn, name, getattr(kn, f"{name}_plain"))
    kn.reset_counts()
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(kn, name, fn)
    if any(kn.LAUNCHES.values()):
        raise AssertionError("a kernel launched while replaced by its plain version")


def _launched(kn) -> str:
    return ", ".join(f"{k} {v}" for k, v in kn.LAUNCHES.items() if v) or "none"


def phase_sf1(dev, sf=1.0):
    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    statements = dict(_tpch_sql())
    statements.update(SF1_EXTRA)
    s = tpch_session(sf)
    pages = {}
    real = kn.fused_agg_sums

    def rec_fused(*args):
        MAIN["sf1_fused"] = args
        return real(*args)

    for mode in ("on", "off"):
        s.properties.set("megakernels", mode)
        for q, sql in statements.items():
            kn.reset_counts()
            if q == "Q1":  # Q1's fused call, timed in the timing phase
                kn.fused_agg_sums = rec_fused
            try:
                pages[(q, mode)] = s.execute(sql)
            finally:
                kn.fused_agg_sums = real
            torch.cuda.synchronize()
            for want in SF1_WANT.get((q, mode), ()):
                if kn.LAUNCHES[want] == 0:
                    raise AssertionError(f"{q} megakernels={mode}: {want} never launched")
            _log(f"[sf1] {q} megakernels={mode}: {pages[(q, mode)].count} rows, "
                 f"launches {_launched(kn)}")
    with _plain_kernels():
        for mode in ("on", "off"):
            s.properties.set("megakernels", mode)
            for q, sql in statements.items():
                pages[(q, "plain-" + mode)] = s.execute(sql)
    for q in statements:
        for mode in ("off", "plain-on", "plain-off"):
            convert.assert_pages_identical(pages[(q, "on")], pages[(q, mode)])
        if pages[(q, "on")].count == 0:
            raise AssertionError(f"{q} returned no rows at SF{sf:g}")
    _log(f"[sf1] all {len(statements)} statements: megakernels on, off and plain "
         f"pages byte-identical")
    cols, dicts = _scan_host_columns(s, ["l_tax", "l_returnflag", "l_shipdate"])
    check_reference({q: pages[(q, "on")] for q in ("Q6", "Q1")}, cols, dicts)
    check_q3_page(s, pages[("Q3", "on")])
    _log("[sf1] Q6, Q1 and Q3 agree exactly with the numpy references")
    for row in pages[("Q1", "on")].to_pylist():
        _log(f"[sf1] Q1 {row}")
    _log(f"[sf1] Q6 {pages[('Q6', 'on')].to_pylist()}")
    for row in pages[("Q3", "on")].to_pylist():
        _log(f"[sf1] Q3 {row}")


# ---------------------------------------------------------------------------
# phase 4: SF10 main path


MAIN = {}
PARENT = {}  # --parent: the earlier checkout's path and its kernels module
FUSED_RANGE = "chip_smoke.fused_aggregate"


def _profile(s, sql, label):
    """One traced run: device time by kernel name and the device's busy
    share of the wall."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from trino_tpu_torch.ops import megakernel

    # the fused aggregate's PyTorch ops (any cast, AND or copy the runner
    # launches around the kernel) under one host range
    real_run = megakernel._run

    def traced_run(ctx, node):
        with record_function(FUSED_RANGE):
            return real_run(ctx, node)

    torch.cuda.synchronize()
    megakernel._run = traced_run
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        megakernel._run = real_run

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): the host-side aten ops
    # and the range carry their kernels' time too and would count it twice
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and dev_us(e) > 0
           and e.key != FUSED_RANGE]
    # busy time and the fused aggregate's time from one list of device
    # events, so the part never exceeds the whole: the aggregate is the
    # device work of the runtime calls (launches, memsets, copies) made
    # inside its host range, matched by correlation id, and the fused
    # kernel (launched through ctypes)
    events = list(prof.events())
    dev_evs = [e for e in events if getattr(e, "device_type", None) == cuda
               and e.name != FUSED_RANGE and not getattr(e, "is_user_annotation", False)]
    span = lambda e: e.time_range.end - e.time_range.start  # noqa: E731
    busy = sum(span(e) for e in dev_evs) / 1e6
    for r in (e for e in events if e.name == FUSED_RANGE and e.device_type != cuda):
        inside = {e.id for e in events
                  if e.device_type != cuda and e.name.startswith("cuda")
                  and r.time_range.start <= e.time_range.start <= r.time_range.end}
        kern = [e for e in dev_evs if "fused_agg_kernel" in e.name]
        ops = [e for e in dev_evs if e.id in inside and "fused_agg_kernel" not in e.name]
        k_us, o_us = sum(span(e) for e in kern), sum(span(e) for e in ops)
        if not kern and not ops:
            continue  # the aggregate was refused (Reject) and ran unfused
        _log(f"[profile] {label}: fused aggregate {(k_us + o_us) / 1e3:.3f} ms device "
             f"time = fused_agg_kernel {k_us / 1e3:.3f} ms (x{len(kern)}) + other device "
             f"work launched inside the aggregate {o_us / 1e3:.3f} ms (x{len(ops)}: "
             f"{', '.join(sorted({e.name[:40] for e in ops}))})")
    _log(f"[profile] {label}: wall {wall * 1e3:.3f} ms, device busy "
         f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall, idle "
         f"{100 * (1 - busy / wall):.1f}%)")
    for e in sorted(evs, key=dev_us, reverse=True)[:10]:
        _log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    ours = ("fused_agg_kernel", "grouped_count_kernel", "grouped_sum_kernel",
            "direct_probe_kernel")
    for e in evs:
        hit = next((k for k in ours if k in e.key), None)
        if hit:
            _log(f"[profile]   the port's {hit}: {dev_us(e) / 1e3:.3f} ms "
                 f"x{e.count}")


def phase_sf10(dev, do_profile=False):
    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    qs, _ = _queries()
    sf = MAIN_SF
    s = tpch_session(sf)
    _log(f"[sf{sf:g}] scan cache budget {s._scan_cache.max_bytes} bytes "
         f"(the session's default on this card)")
    runs = [("Q6", "auto"), ("Q1", "auto"), ("Q1", "off"), ("Q3", "auto")]
    for q, mode in runs:  # cold: generation, upload, first run
        s.properties.set("megakernels", mode)
        t0 = time.perf_counter()
        s.execute(qs[q])
        torch.cuda.synchronize()
        _log(f"[sf{sf:g}] cold {q} megakernels={mode}: "
             f"{time.perf_counter() - t0:.3f} s")
    _log(f"[sf{sf:g}] scan cache after the cold runs: "
         f"{len(s._scan_cache.entries)} scans, {s._scan_cache.bytes} bytes")
    recorded = {}
    real = {name: getattr(kn, name) for name in KERNEL_FNS}

    def rec_fused(*args):  # (cols, valids, live, prog, groups)
        recorded[("fused", len(args[-2].terms))] = args
        return real["fused_agg_sums"](*args)

    def rec_count(flags, gid, cap):
        recorded["count"] = (flags, gid, cap)
        return real["grouped_count"](flags, gid, cap)

    def rec_sum(values, gid, cap):
        # the largest call: one of Q1-off's full-table segment sums
        prev = recorded.get("sum")
        if prev is None or values.shape[0] >= prev[0].shape[0]:
            recorded["sum"] = (values, gid, cap)
        return real["grouped_sum_i64"](values, gid, cap)

    def rec_probe(table, key, ok, sel, lo):
        # Q3's two joins, told apart by their table: orderkey and custkey
        recorded[("probe", table.shape[0])] = (table, key, ok, sel, lo)
        return real["direct_probe"](table, key, ok, sel, lo)

    shims = {"fused_agg_sums": rec_fused, "grouped_count": rec_count,
             "grouped_sum_i64": rec_sum, "direct_probe": rec_probe}
    for name, fn in shims.items():
        setattr(kn, name, fn)
    walls = {r: [] for r in runs}
    per_run = {r: dict.fromkeys(KERNEL_FNS, 0) for r in runs}
    pages = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        kn.reset_counts()  # the main path starts here
        for _ in range(MAIN_REPS):
            for q, mode in runs:
                s.properties.set("megakernels", mode)
                before = dict(kn.LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pages[(q, mode)] = s.execute(qs[q])
                torch.cuda.synchronize()
                walls[(q, mode)].append(time.perf_counter() - t0)
                for name in KERNEL_FNS:
                    per_run[(q, mode)][name] += kn.LAUNCHES[name] - before[name]
        launches = dict(kn.LAUNCHES)  # ... and ends here
    finally:
        for name, fn in real.items():
            setattr(kn, name, fn)
    _log(f"[sf{sf:g}] main path launches: {launches}")
    for (q, mode), n in per_run.items():
        _log(f"[sf{sf:g}]   {q} megakernels={mode} over {MAIN_REPS} runs: {n}")
    for (q, mode), w in walls.items():
        _log(f"[sf{sf:g}] warm {q} megakernels={mode}: median "
             f"{statistics.median(w) * 1e3:.3f} ms over {len(w)} runs "
             f"(all: {', '.join(f'{x * 1e3:.3f}' for x in w)})")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")
    for path, want in MAIN_WANT.items():
        for name, per in want.items():
            if per_run[path][name] < per * MAIN_REPS:
                raise AssertionError(f"{path}: {name} launched {per_run[path][name]} "
                                     f"times in {MAIN_REPS} runs, want >= {per} a run")
    convert.assert_pages_identical(pages[("Q1", "auto")], pages[("Q1", "off")])
    cols, dicts = _scan_host_columns(s, ["l_tax", "l_returnflag", "l_shipdate"])
    check_reference({"Q6": pages[("Q6", "auto")], "Q1": pages[("Q1", "auto")]},
                    cols, dicts)
    check_q3_page(s, pages[("Q3", "auto")])
    _log(f"[sf{sf:g}] Q6/Q1/Q3 agree exactly with the numpy references; "
         f"Q1 fused and unfused pages byte-identical")
    for row in pages[("Q3", "auto")].to_pylist():
        _log(f"[sf{sf:g}] Q3 {row}")
    _log(f"[sf{sf:g}] peak device memory over the warm main path "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s.execute(qs["Q3"])
    torch.cuda.synchronize()
    _log(f"[sf{sf:g}] Q3 alone: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of which "
         f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above "
         f"the resident scans ({base / 2**30:.2f} GiB)")
    MAIN.update(launches=launches, recorded=recorded, walls=walls, session=s)
    if do_profile:
        for q, mode in runs:
            s.properties.set("megakernels", mode)
            _profile(s, qs[q], f"sf{sf:g} {q} megakernels={mode}")


# ---------------------------------------------------------------------------
# phase 5: the SF10 relational path (semi, anti and scalar joins, DISTINCT
# aggregates, substring, a window over all orders)


REL_QUERIES = ("Q4", "Q16", "Q18", "Q21", "Q22", "WINDOW", "WINDOW-ALL")
REL_SQL = {"WINDOW": WINDOW_SQL, "WINDOW-ALL": WINDOW_ALL_SQL}
# launches each relational-path run must make, per kernel (the window
# launches none; no aggregate of the path fuses)
REL_WANT = {
    "Q4": {_GC: 2}, "Q16": {_DP: 1}, "Q18": {_DP: 2}, "Q21": {_DP: 3},
    "Q22": {_GC: 4, _GS: 2},
}
REL_CHECKS = {"Q4": check_q4, "Q18": check_q18, "Q22": check_q22,
              "WINDOW": check_window, "WINDOW-ALL": check_window_all}


def phase_sf10_rel(dev, do_profile=False):
    """Q4, Q16, Q18, Q21, Q22 and the running-sum window (its first rows
    and its reduction over every row) at SF10, in the main path's session
    (its scans stay resident): one cold run each, MAIN_REPS warm runs
    with every kernel's launches counted, the peak device memory, exact
    numpy references for Q4, Q18, Q22 and both window statements, and
    Q16 and Q21 byte-identical to a run on the plain kernel versions."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn

    sf = MAIN_SF
    s = MAIN["session"]
    s.properties.set("megakernels", "auto")
    qs = _tpch_sql()
    sqls = {q: REL_SQL.get(q) or qs[q] for q in REL_QUERIES}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for q, sql in sqls.items():  # cold: generation, upload, first run
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        _log(f"[rel{sf:g}] cold {q}: {time.perf_counter() - t0:.3f} s")
    _log(f"[rel{sf:g}] scan cache after the cold runs: "
         f"{len(s._scan_cache.entries)} scans, {s._scan_cache.bytes} bytes")
    walls = {q: [] for q in sqls}
    per_run = {q: dict.fromkeys(KERNEL_FNS, 0) for q in sqls}
    pages = {}
    kn.reset_counts()  # the relational path starts here
    for _ in range(MAIN_REPS):
        for q, sql in sqls.items():
            before = dict(kn.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pages[q] = s.execute(sql)
            torch.cuda.synchronize()
            walls[q].append(time.perf_counter() - t0)
            for name in KERNEL_FNS:
                per_run[q][name] += kn.LAUNCHES[name] - before[name]
    launches = dict(kn.LAUNCHES)  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    _log(f"[rel{sf:g}] relational path launches: {launches}")
    for q, n in per_run.items():
        _log(f"[rel{sf:g}]   {q} over {MAIN_REPS} runs: {n}")
    for q, w in walls.items():
        _log(f"[rel{sf:g}] warm {q}: median {statistics.median(w) * 1e3:.3f} ms over "
             f"{len(w)} runs (all: {', '.join(f'{x * 1e3:.3f}' for x in w)}), "
             f"{pages[q].count} rows")
    _log(f"[rel{sf:g}] peak device memory over the relational path (cold and warm) "
         f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above what was "
         f"allocated before it ({base / 2**30:.2f} GiB)")
    for q, want in REL_WANT.items():
        for name, per in want.items():
            if per_run[q][name] < per * MAIN_REPS:
                raise AssertionError(f"{q}: {name} launched {per_run[q][name]} times "
                                     f"in {MAIN_REPS} runs, want >= {per} a run")
    for q, check in REL_CHECKS.items():
        check(s, pages[q])
    _log(f"[rel{sf:g}] {', '.join(REL_CHECKS)} agree exactly with the numpy references")
    with _plain_kernels():
        plain = {q: s.execute(sqls[q]) for q in ("Q16", "Q21")}
    for q, page in plain.items():
        convert.assert_pages_identical(pages[q], page)
    _log(f"[rel{sf:g}] Q16 and Q21 byte-identical on the plain kernel versions")
    for q in ("Q4", "Q16", "Q18", "Q21", "Q22"):
        for row in pages[q].to_pylist()[:5]:
            _log(f"[rel{sf:g}] {q} {row}")
    MAIN.update(rel_launches=launches, rel_walls=walls)
    if do_profile:
        for q, sql in sqls.items():
            _profile(s, sql, f"sf{sf:g} {q}")


# ---------------------------------------------------------------------------
# phase 6: kernel timings at the main path's shapes


def _time_ms(fn, reps):
    """The median of `reps` calls each timed alone between its own events
    on an idle card, after a warm-up call: each time also holds the
    host's launch time before the card starts.  The kernels line's
    method."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _time_queued_ms(fn, reps=15):
    """The mean over `reps` calls queued back to back between one pair of
    CUDA events, after a warm-up call: the host queues each launch while
    the card runs the one before, so its launch time stays out wherever
    a call keeps the card busier than the host.  Logged beside the
    kernels line's times."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _enqueue_us(fn, calls=300):
    """Host time of one call in microseconds: `calls` calls on the host
    clock with no synchronisation between them (the card runs behind),
    after a warm-up call and a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _fused_work(cols, valids, live, prog, groups):
    """(bytes, operations) the fused function needs on these inputs:
    each lane it reads once at its own element size (the values of the
    columns the program reads, every validity lane, live), the sums
    written once; one operation per encoded instruction for the rows
    that evaluate it (the predicate and group id for every row, the
    terms for the rows that pass)."""
    from trino_tpu_torch.ops import kernels as kn

    enc = kn.encode(prog)
    n = live.numel()
    nbytes = (sum(cols[k].element_size() * n for k, _s in enc.col_slots)
              + n * (1 + sum(ok is not None for ok in valids))
              + len(prog.terms) * groups * 8)
    mask = live.clone()
    for ok in valids:
        if ok is not None:
            mask &= ok
    if prog.pred:
        mask &= kn._run_plain(prog.pred, [c.to(torch.int32) for c in cols], live) != 0
    n_pass = int(mask.sum())
    ops = enc.n_pre * n + (len(enc.ins) - enc.n_pre) * n_pass
    return nbytes, ops


def _row(name, launches, err, ms, plain_ms, nbytes, ops, library_ms):
    """One kernel's entry of the kernels line; the bound is the larger of
    bytes over the memory rate and operations over the 32-bit rate."""
    from trino_tpu_torch.ops import kernels as kn

    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / VECTOR_OPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda",
        "source": kn.KERNEL_REGISTRY[name]["source"],
        "replaces": kn.KERNEL_REGISTRY[name]["replaces"],
        "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": library_ms,
    }


def _time_sum(dev, values, gid, cap, launches):
    """grouped_sum_i64 at a main-path shape: bytes = 8-byte value + 8-byte
    id a row read, cap sums written; one add a row."""
    from trino_tpu_torch.ops import kernels as kn

    got = kn.grouped_sum_i64(values, gid, cap)
    want = kn.grouped_sum_i64_plain(values, gid, cap)
    err = int((got - want).abs().max())
    n = values.shape[0]
    return _row(
        "grouped_sum_i64", launches, err,
        _time_ms(lambda: kn.grouped_sum_i64(values, gid, cap), 15),
        _time_ms(lambda: kn.grouped_sum_i64_plain(values, gid, cap), 5),
        n * 16 + cap * 8, n,
        _time_ms(lambda: torch.zeros(cap, dtype=torch.int64, device=dev)
                 .index_add_(0, gid, values), 15),
    )


def _time_probe(table, key, ok, sel, lo, launches):
    """direct_probe at a main-path shape: bytes = key, ok and sel read and
    row and matched written per probe row, and of the table only the
    32-byte sectors that this run's keys touch, each once (TPC-H order
    keys fill one sector in four of the orderkey table); about ten
    integer operations a row (subtract, two compares, clip, three ands,
    decrement).  No single PyTorch call computes probe_direct, so the row
    has no library time.  Returns the row, the table bytes counted and a
    partial yardstick: the slot gather alone, table[clamp(key - lo)] with
    its index computed inside the timed window, and its own byte bound
    (key read and int32 slot written a probe, plus the same sectors)."""
    from trino_tpu_torch.ops import kernels as kn

    got = kn.direct_probe(table, key, ok, sel, lo)
    want = kn.direct_probe_plain(table, key, ok, sel, lo)
    err = max(int((got[0] - want[0]).abs().max()) if key.numel() else 0,
              int((got[1] != want[1]).sum()))
    n, dom = key.shape[0], table.shape[0]
    idx = torch.clamp(key.to(torch.int64) - lo, 0, dom - 1)
    table_bytes = min(dom * 4, torch.unique(idx // 8).numel() * 32)
    del idx
    gather_ms = _time_ms(
        lambda: table[torch.clamp(key.to(torch.int64) - lo, 0, dom - 1)], 15)
    gather_bytes = n * (key.element_size() + 4) + table_bytes
    return _row(
        "direct_probe", launches, err,
        _time_ms(lambda: kn.direct_probe(table, key, ok, sel, lo), 15),
        _time_ms(lambda: kn.direct_probe_plain(table, key, ok, sel, lo), 5),
        n * (key.element_size() + 1 + 1 + 8 + 1) + table_bytes, 10 * n, None,
    ), table_bytes, gather_ms, gather_bytes / HBM_BYTES_PER_S * 1e3


def phase_timing(dev):
    from trino_tpu_torch.ops import kernels as kn

    rec = MAIN["recorded"]
    launches = MAIN["launches"]
    rows = []
    fused_keys = sorted(k for k in rec if isinstance(k, tuple) and k[0] == "fused")
    for key in fused_keys:
        args = rec[key]
        cols, valids, live, prog, groups = args
        got = kn.fused_agg_sums(*args)
        want = kn.fused_agg_sums_plain(*args)
        err = int((got - want).abs().max())
        nbytes, ops = _fused_work(*args)
        row = _row(
            "fused_agg_sums", launches, err,
            _time_ms(lambda: kn.fused_agg_sums(*args), 15),
            _time_ms(lambda: kn.fused_agg_sums_plain(*args), 5),
            nbytes, ops, None,
        )
        queued = _time_queued_ms(lambda: kn.fused_agg_sums(*args))
        _log(f"[timing] fused_agg_sums {len(prog.terms)} terms x {groups} groups, "
             f"{live.shape[0]} rows, lanes {[str(c.dtype) for c in cols]}, "
             f"{len(kn.encode(prog).ins)} instructions, {nbytes} bytes, {ops} ops: "
             f"{json.dumps(row)}; back to back: {queued} ms")
        rows.append(row)
    if "sf1_fused" in MAIN:  # Q1's fused call at SF1 (logged, not in the line)
        args = MAIN["sf1_fused"]
        cols, valids, live, prog, groups = args
        nbytes, ops = _fused_work(*args)
        ms = _time_ms(lambda: kn.fused_agg_sums(*args), 15)
        pms = _time_ms(lambda: kn.fused_agg_sums_plain(*args), 5)
        queued = _time_queued_ms(lambda: kn.fused_agg_sums(*args))
        _log(f"[timing] fused_agg_sums SF1 Q1 {len(prog.terms)} terms x {groups} "
             f"groups, {live.shape[0]} rows: ms {ms} plain_ms {pms} bound_ms "
             f"{nbytes / HBM_BYTES_PER_S * 1e3} ({nbytes} bytes, {ops} ops); "
             f"back to back: {queued} ms")
    flags, gid, cap = rec["count"]
    got = kn.grouped_count(flags, gid, cap)
    want = kn.grouped_count_plain(flags, gid, cap)
    err = int((got - want).abs().max())
    n = flags.shape[0]
    row = _row(
        "grouped_count", launches, err,
        _time_ms(lambda: kn.grouped_count(flags, gid, cap), 15),
        _time_ms(lambda: kn.grouped_count_plain(flags, gid, cap), 5),
        n * (flags.element_size() + 8) + cap * 8, int(flags.sum()),
        _time_ms(lambda: torch.zeros(cap, dtype=torch.int64, device=dev)
                 .index_add_(0, gid, flags.long()), 15),
    )
    queued = _time_queued_ms(lambda: kn.grouped_count(flags, gid, cap))
    _log(f"[timing] grouped_count cap {cap}, {n} rows: {json.dumps(row)}; "
         f"back to back: {queued} ms")
    rows.append(row)
    line = [rows[-2], rows[-1]]
    values, gid, cap = rec["sum"]
    row = _time_sum(dev, values, gid, cap, launches)
    queued = _time_queued_ms(lambda: kn.grouped_sum_i64(values, gid, cap))
    _log(f"[timing] grouped_sum_i64 cap {cap}, {values.shape[0]} rows: "
         f"{json.dumps(row)}; back to back: {queued} ms")
    rows.append(row)
    line.append(row)
    probes = sorted(k for k in rec if isinstance(k, tuple) and k[0] == "probe")
    for key in probes:  # custkey join first, then orderkey
        table, pkey, ok, sel, lo = rec[key]
        row, table_bytes, g_ms, g_bound = _time_probe(table, pkey, ok, sel, lo,
                                                      launches)
        call = lambda mod: lambda: mod.direct_probe(table, pkey, ok, sel, lo)  # noqa: E731
        queued = _time_queued_ms(call(kn))
        _log(f"[timing] direct_probe {table.shape[0]} slots, {pkey.shape[0]} "
             f"{pkey.dtype} probes, {int(sel.sum())} selected, {table_bytes} "
             f"table bytes touched: {json.dumps(row)}; back to back: {queued} ms; "
             f"wrapper enqueue {_enqueue_us(call(kn))} us a call; partial yardstick, "
             f"the slot gather table[clamp(key - lo)] alone: ms {g_ms} "
             f"bound_ms {g_bound} (bytes)")
        if "kn" in PARENT:  # the earlier commit's kernel on the same inputs
            old = PARENT["kn"]
            got = old.direct_probe(table, pkey, ok, sel, lo)
            want = kn.direct_probe_plain(table, pkey, ok, sel, lo)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError("the parent's direct_probe disagrees with plain")
            _log(f"[timing] parent's direct_probe {table.shape[0]} slots: ms "
                 f"{_time_ms(call(old), 15)}; back to back: {_time_queued_ms(call(old))} ms; "
                 f"wrapper enqueue {_enqueue_us(call(old))} us a call")
        rows.append(row)
    line.append(rows[-1])
    bad = [r for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with plain at main-path shapes: {bad}")
    # one row per kernel in the result line.  The fused row is Q6's SF10
    # call (3 terms x 1 group): at SF10 Q1 is refused by the fusion proof
    # (SUM_GATE) and runs unfused, so Q1's fused shape is timed at SF1 only.
    # The direct_probe row is Q3's orderkey join, the larger of its two
    MAIN["kernels"] = line
    MAIN["all_rows"] = rows


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global MAIN_REPS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", default="all", choices=["all", "kernels", "main"],
                    help="run only the build and kernel phases, or only the build "
                         "and the SF10 main path (which also runs on the package "
                         "of an earlier commit, for comparisons)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm run of each SF10 query")
    ap.add_argument("--reps", type=int, default=MAIN_REPS,
                    help="warm repetitions of each main-path query")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit: its direct_probe runs the "
                         "kernel cases and is timed beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import trino_tpu_torch  # noqa: F401  (fails outside a checkout)

    MAIN_REPS = args.reps
    if args.parent:
        PARENT["parent"] = args.parent
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = _smi()
    _log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
         f"{torch.__version__} cuda {torch.version.cuda}")
    phases = [("build", phase_build)]
    main_path = ("main", lambda: phase_sf10(dev, args.profile))
    if args.phase == "main":
        phases.append(main_path)
    else:
        phases.append(("kernels", lambda: phase_kernels(dev)))
    if args.phase == "all":
        phases += [
            ("sf1", lambda: phase_sf1(dev)),
            main_path,
            ("rel", lambda: phase_sf10_rel(dev, args.profile)),
            ("timing", lambda: phase_timing(dev)),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            _log(f"[phase] {name} ok in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc()
            _log(f"[phase] {name} FAILED")
            failed.append(name)
            if name == "main":
                break  # the relational path and timing need the main path
    _log(f"[run] {time.perf_counter() - t_start:.1f} s in all")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(smi)
    if "kernels" in MAIN:
        print(json.dumps({"kernels": MAIN["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
