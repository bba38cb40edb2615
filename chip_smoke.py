"""Chip smoke test of the PyTorch/H100 port (trino_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel from trino_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card,
     on random and edge inputs (exact equality); one fused call runs
     under torch.cuda.set_sync_debug_mode("error");
  2b. `gen`: every TPC-H table at SF10, each column the on-device
     generator makes (connectors/tpch_device.py), generated on the card
     and held byte for byte against the port's host generator, lineitem
     whole and in three order ranges; the card's seconds against host
     generation plus the copy, and the peak memory of each generation;
  3. SF1: all 22 TPC-H queries of tests/tpch_sql.py, plus UNION,
     INTERSECT, EXCEPT and two window statements of the CPU tests, and
     the statements of tests/test_aggregates.py, test_functions.py,
     test_grouping_sets.py and test_arrays.py, the JSON/URL/digest tests
     of test_client_features.py and the TABLESAMPLE tests of
     test_session_features.py, on a TPC-H session; the TPC-DS path's 26
     statements on a TPC-DS session; each through Session.execute with
     megakernels on (fused kernel), off (grouped-count and grouped-sum
     kernels) and with every kernel function replaced by its plain
     version: the pages must be byte-identical, Q6, Q1 and Q3 agree
     with exact numpy references, and so do the
     TPC-DS statements that phase 7 checks; a fifth way runs the 22
     TPC-H queries over the host generator's scans (device_generation
     off), byte-identical to the card-generated runs;
  3b. `session` at SF1: SET/SHOW SESSION, a view over a join,
     PREPARE/EXECUTE ... USING and re-PREPARE, DESCRIBE INPUT/OUTPUT,
     ANALYZE then SHOW STATS against exact counts, EXPLAIN ANALYZE of
     Q1, Q3 and Q6 (its operator rows equal a plain run's) and a
     result-cache hit (the same page, no kernel launched);
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
  6. this slice at SF10 in the same session, a memory catalog added:
     UNNEST of split(p_name, ' ') over all 2 M parts (by word, and WITH
     ORDINALITY by position), array_agg(o_orderkey) over all 15 M orders
     per customer with cardinality and element_at over the groups,
     listagg over supplier and map_agg over partsupp, TABLESAMPLE
     BERNOULLI (10) and SYSTEM (100) over all 60 M lineitem rows, an ETL
     sequence into the memory catalog (CTAS of all 15 M orders, INSERT
     ... SELECT, DELETE, UPDATE, MERGE, each read back with the scan
     cache on), the JSON, md5, crc32 and base64 functions over 1.5 M
     customers and the URL functions over the 100,000 suppliers, and a
     MATCH_RECOGNIZE V shape over the orders of the first 15,000
     customers: cold once and warm once, with launches, peak memory and
     exact numpy or Python checks (the four customer string families
     read the first 150,000 customers);
  7. each kernel timed with CUDA events at the main path's shapes beside
     its bound, its plain version and, where one exists, one PyTorch call
     computing the same function;
  7b. queries larger than their memory budget at TPC-H SF10, in fresh
     sessions limited to 8 GiB (Q1), 1 GiB (Q6, Q1, Q3, Q18, a filtered
     lineitem-orders join, a grouped approx_distinct/approx_percentile;
     Q18 again with broadcast joins) and 256 MiB (count(distinct), a
     sort of all orders, a running sum over all orders): each cold and
     once warm, the streamed fragments and tiles or the spill taken
     against the JAX package's decisions, launches, peak memory beside
     the limit, pages identical to the in-memory runs and numpy checks
     (Q18 with its partitioned join is refused by both packages);
  7c. `mesh`: `distributed = true` over 8 logical shards on the card at
     TPC-H SF10: Q6 (fused on every shard, the partials all_gathered),
     Q1 with megakernels off (grouped_count and grouped_sum_i64 on every
     shard, psums), Q3 over broadcast joins (direct_probe on every shard
     against the one gathered build side) and over partitioned joins
     (all_to_all), a grouped count(DISTINCT) (repartitioned on the group
     keys), a global approx_distinct (gathered) and a grouped one (HLL
     registers merged by pmax): each cold once and warm twice, pages
     equal to the one-device pages byte for byte, every kernel's launches
     counted over the warm runs, the collectives by kind, the warm wall's
     host split (shard load, per-shard operators, exchanges, the final
     sync), the peak device memory; then a seeded device_loss at the
     first mesh step of Q6 shrinks the mesh to 7 shards (MESH_SHRINK
     journaled, the doctor's mesh_shrink after device_fault, every
     launch on the card, the same page) and the canary restores it;
  7d. `server`: a coordinator and two in-process workers on the card
     (each worker's device pool half the card), TPC-H SF10 through the
     StatementClient: Q6 (fused_agg_sums on every worker's partial
     fragment), Q1 with megakernels off, Q3 over broadcast and over
     partitioned joins (the hash exchange over HTTP), a grouped
     count(DISTINCT) and a selection of 250,000 rows paged under
     client_page_rows, each cold once and warm twice: every page held
     to the one-device page byte for byte and the client's JSON rows to
     its protocol rows, the host split (planning, dispatch, the
     workers' fragment_execute, blocked_exchange_s, partition and
     serialize, deserialize), the exchange bytes, the launches summed
     from the tasks' profiles, the peak device memory; then a
     worker_main subprocess worker joins on the card (Q6 over three
     workers, its own launches from its tasks), an in-process worker
     stops and discovery drops it (Q6 over the rest), a seeded device
     loss on the workers fails Q6 with DeviceFaultError in the client's
     error (the workers QUARANTINED, then restored by the canary), and
     no worker rebuilt the kernel libraries;
  7e. `fte`: fault-tolerant execution on the card at TPC-H SF10: a
     coordinator and two in-process workers (each half the card) under
     retry_policy = task, Q6 (fused on each worker's partial fragment),
     Q1 with megakernels off, Q3 over partitioned joins (its hash
     exchange through the spool) and a grouped count(DISTINCT) through
     the StatementClient, each cold once and warm twice with every stage
     output spooled to disk: pages held to the one-device pages byte for
     byte, the spool bytes written and read, the seconds of spool_write,
     spool_read and deserialize beside the same statements' `server`
     numbers, the launches summed from the tasks' profiles, the peak
     device memory; one instrumented run of each, then
     system.runtime.plan_signatures over SQL (a row a signature, device
     wall above 0); seeded faults, each giving the one-device page: a
     device_loss on worker 0 during Q6 (its task fails with
     DeviceFaultError and re-runs on worker 1; worker 0 QUARANTINED,
     then ACTIVE after the canary), a corrupt spool frame (the CRC
     fails, the producer re-runs), a stalled task (the speculative
     backup wins, a hedge flag), and retry_policy = query with a worker
     stopped mid-Q3 (retryCount >= 1); a subprocess coordinator with a
     recovery WAL and two subprocess workers on the card killed (-9
     semantics, the seeded coordinator_death site) mid-Q3 and restarted
     on its port: the client rides the 503 window, the resumed Q3's
     rows are the one-device page's and the WAL shows no committed task
     re-run; the autoscaler over Q6 at SF1 (AUTOSCALE_SF: the control
     loop is the subject, not the scan): a backlog scales out one
     worker_main subprocess on the card, thinner load scales it in, no
     query fails; no process rebuilt a kernel library;
  7f. `multihost`: the cross-host mesh on the card at TPC-H SF10: a
     coordinator in this process and two worker_main processes on the
     card, each a host with 2 logical shards (--local-devices 2), under
     cross_host_mesh: Q6, Q1 with megakernels off, Q3 over broadcast
     joins and a grouped count(DISTINCT) through the StatementClient,
     each cold once and warm once, pages held to the one-device pages
     byte for byte; every host ran its slice tasks over its shards
     (grouped_count, grouped_sum_i64 and direct_probe launched there, by
     the tasks' counts), compiled mesh-mode fragments and fetched pages
     from the other host (its /metrics); each host process's device
     peak; then a third host, stalled before each task, killed with -9
     mid-Q3 under retry_policy = task: the page the one-device page,
     tasks that ran once (committed spools reused), HOST_GONE
     journaled; no host rebuilt a kernel library;
  8. TPC-DS SF3 (8.6 M store_sales rows; SF10 until the mesh phase
     needed the call's time), the TPC-H session freed
     first: the 22 statements of tests/test_tpcds.py, its null-FK
     count, Q27 with ROLLUP (DS-Q27-ROLLUP), the aggregate families per
     store (DS-AGG) and the function library (DS-FN), cold once and warm
     three times with every kernel's launches (direct_probe, the grouped
     count and sum must launch) and the peak device memory; NULL-FK,
     Q96, Q13, DS-AGG and DS-Q27-ROLLUP against numpy references over
     the generated host arrays (exact, DS-AGG's float64 columns at
     relative 1e-9), the other 21 byte-identical to runs on the plain
     kernel versions;
  9. `faults`: seeded faults on the card in a TPC-H SF10 session of its
     own: Q6, Q1 and Q3 warm with the device supervisor's boundary and
     bare, in turns (its overhead), beside the main path's walls; a
     device_loss keyed to fused_agg_sums during Q6 raises DeviceFaultError
     naming the kernel and its shapes, quarantines the device, is
     journaled and is the flight recorder's last record; the canary
     (grouped_count on the card) restores the device and Q6 runs on the
     card again against the numpy reference; a device_wedge under a 2 s
     watchdog raises within twice the timeout; a third fault
     blacklists the device and execute refuses (the port has no CPU
     re-run: a fault fails the query);
 10. `lake`: a lakehouse table made by CTAS of lineitem's eight Q1/Q6/Q3
     columns at SF3 (18 M rows; SF10, 60 M rows and 3.12 GB of .npz,
     until the `fte` phase needed the call's time), an INSERT of one
     orderkey range and a DELETE of another, then ANALYZE of Q1's and
     Q6's columns; Q6 FOR VERSION AS OF each snapshot, Q1 at the last
     (megakernels auto, so ANALYZE's decimal bounds reach the fused
     gate) and Q3 with lineitem from the lake, cold once and warm twice, against
     numpy references; expire_snapshots and remove_orphan_files by
     counts; the same columns written as parquet (write_parquet_table)
     into a hive catalog, ANALYZE of its group keys and date (the
     decimals' bounds stay the footers'), Q1 and Q6 over it equal to the
     lake's pages and the references, and an orderkey range reading only
     the row groups its footers allow;
 11. `obs`: the observatories in a TPC-H SF10 session of its own
     (generated on the card) with the query history, the incident journal
     and the compile observatory on disk: Q6, Q1 (megakernels auto and
     off) and Q3 cold once and warm twice against the numpy references,
     every kernel launching and no warm run recording a compile; the
     system tables completed_queries, compiles, shape_census (one row a
     launch), diagnoses, events, nodes, caches, memory and metrics over
     SQL; HEALTHY for a warm Q6; a seeded device_loss on fused_agg_sums
     diagnosed as device_fault with cited events and the DEVICE_LOSS
     error code, then the canary; a Q6 denied by file-based access
     control that loads no scan and launches nothing; two subprocesses on
     one fresh compile_cache_dir, the first running four nvcc builds
     (first_compile), the second none (four persistent_load, its program
     prewarmed from the index); a subprocess running Q1 at SF10 killed
     with SIGKILL mid-query, whose RUNNING history record the doctor finds
     and diagnoses from disk; and the observatories' cost on warm Q6, Q1
     and Q3, on and off in turns.

Every phase but `faults` and `obs` ends with each of its sessions'
supervisors ACTIVE and no fault, or fails (`obs` ends ACTIVE after its
one fault).

--profile traces one warm run of every SF10 query, TPC-DS, the `ext`
and the out-of-core statements included (busy and idle share of the
device).  The last log line gives the run's seconds.

Every earlier phase runs in sessions whose memory limit is the card's
size and fails if a statement streams, spills or is forced to stream.
Scans are generated on the card (`device_generation`, the default)
wherever the generator makes every column a scan reads.  Every timed
session runs with `result_cache` off (a warm repeat would be a lookup).

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


def _valid(col, i) -> bool:
    return col.validity is None or bool(np.asarray(col.validity)[i])


def _half_away(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def check_reference(pages, cols, dicts):
    """Hold the Q6 page and, where given, the Q1 page against exact
    numpy/python arithmetic over the same lineitem columns (host arrays)."""
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
    if "Q1" not in pages:
        return
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


def _card_session(factory, sf, **props):
    """A session whose memory limit is the card's size, as an operator of
    an 80 GB card would set it: the in-memory path.  Every statement it
    runs must stay in memory (no streaming, no spill, no forced
    streaming), or the phase fails."""
    from trino_tpu_torch.memory import detect_device_bytes

    # timed runs repeat statements: the result cache would answer them
    props.setdefault("result_cache", False)
    s = factory(sf, query_max_memory_bytes=detect_device_bytes(), **props)
    run = s.execute

    def execute(sql, **kw):
        page = run(sql, **kw)
        prof = s.last_kernel_profile or {}
        if prof.get("forcedStreaming") or prof.get("outOfCore"):
            raise AssertionError(
                f"left the in-memory path ({prof.get('outOfCore')}, forcedStreaming "
                f"{prof.get('forcedStreaming', 0)}): {sql[:80]}")
        return page

    s.execute = execute
    return s


def _scan_host_columns(session, needed, table="lineitem"):
    """The host arrays (and dictionaries) of the session's cached scan of
    `table` that holds every column in `needed`: a device-generated scan
    has no host arrays, so its lanes are copied back (the gen phase holds
    them byte for byte to the host generator)."""
    for key, entry in session._scan_cache.entries.items():
        if key[1] == table and set(needed) <= set(entry["merged"]):
            if entry.get("devgen") is not None:
                return ({c: v.cpu().numpy() for c, (v, _ok) in entry["dev"].items()},
                        entry["dicts"])
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
# the out-of-core phase: TPC-H SF10 under three per-query memory limits
# (Trino's query.max-memory-per-node with spill to the host)
OOC_JOIN_SQL = (
    "select o_orderpriority, count(*) n, sum(l_extendedprice) s "
    "from lineitem join orders on l_orderkey = o_orderkey "
    "where l_shipdate >= date '1995-01-01' and o_orderdate < date '1995-03-15' "
    "group by o_orderpriority order by o_orderpriority")
OOC_APPROX_SQL = (
    "select l_returnflag, approx_distinct(l_partkey) d, "
    "approx_percentile(l_extendedprice, 0.5) p "
    "from lineitem group by l_returnflag order by l_returnflag")
OOC_DISTINCT_SQL = "select count(distinct l_orderkey) from lineitem"
OOC_SORT_SQL = ("select o_orderkey, o_totalprice from orders "
                "order by o_totalprice desc, o_orderkey")
# the sort again with o_clerk, whose generated dictionary holds one
# entry per row: the spill's host merge unifies 15 M entries
OOC_CLERK_SQL = ("select o_orderkey, o_clerk from orders "
                 "order by o_totalprice desc, o_orderkey")


def _ooc_statements():
    """(limit, session properties, [(label, sql), ...]) for the
    out-of-core phase's four sessions: the JAX package's default limit,
    1 GiB (twice: the second with broadcast joins) and 256 MiB."""
    qs = _tpch_sql()
    return [
        (8 << 30, {}, [("Q1", qs["Q1"])]),
        (1 << 30, {}, [("Q6", qs["Q6"]), ("Q1", qs["Q1"]), ("Q3", qs["Q3"]),
                       ("Q18", qs["Q18"]), ("OOC-JOIN", OOC_JOIN_SQL),
                       ("OOC-APPROX", OOC_APPROX_SQL)]),
        (1 << 30, {"join_distribution_type": "broadcast"},
         [("Q18-BROADCAST", qs["Q18"])]),
        (256 << 20, {}, [("OOC-DISTINCT", OOC_DISTINCT_SQL), ("OOC-SORT", OOC_SORT_SQL),
                         ("OOC-WINDOW", WINDOW_ALL_SQL), ("OOC-CLERK", OOC_CLERK_SQL)]),
    ]


# the JAX package's decisions for them (exec/streaming.py and
# exec/spill.py planned at SF10, the same with device_generation off and
# at its default, on; the CPU tests tests/test_torch_streaming.py and
# test_torch_tpch_device.py hold both packages to this table):
# the path, the fragment count and the tiles of each source fragment
OOC_WANT = {
    ("Q1", 8 << 30): ("stream", 3, (("lineitem", 2),)),
    ("Q6", 1 << 30): ("stream", 2, (("lineitem", 6),)),
    ("Q1", 1 << 30): ("stream", 3, (("lineitem", 9),)),
    ("Q3", 1 << 30): ("stream", 6, (("customer", 1), ("lineitem", 6), ("orders", 2))),
    ("Q18", 1 << 30): ("stream", 9, (("orders", 2), ("customer", 1), ("lineitem", 4),
                                     ("lineitem", 4))),
    ("Q18-BROADCAST", 1 << 30): ("stream", 7, (("customer", 1), ("orders", 2),
                                               ("lineitem", 4), ("lineitem", 4))),
    ("OOC-JOIN", 1 << 30): ("stream", 5, (("lineitem", 4), ("orders", 1))),
    ("OOC-APPROX", 1 << 30): ("stream", 3, (("lineitem", 4),)),
    ("OOC-DISTINCT", 256 << 20): ("stream", 3, (("lineitem", 7),)),
    ("OOC-SORT", 256 << 20): ("sort-spill",),
    ("OOC-WINDOW", 256 << 20): ("window-spill", 4),
    ("OOC-CLERK", 256 << 20): ("sort-spill",),
}
# statements whose spilled page numbers its strings another way than the
# in-memory page: the merged batches' dictionary of o_clerk holds each
# clerk once, the single-split load one entry per row (the rows agree)
OOC_ROWS_ONLY = {"OOC-CLERK"}
# statements both packages plan to stream and then refuse while running:
# Q18's lineitem-orders join is partitioned at SF10 (orders pass the
# broadcast threshold), so its join fragment gathers every lineitem row
# the tiles send it, and that fragment's own limit check raises the
# JAX package's ExceededMemoryLimitError
OOC_REFUSED = {("Q18", 1 << 30)}


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


def sql_statements(filename, skip=(), receivers=("session",), only=None):
    """{test name: sql} of every SELECT that a test of tests/<filename>
    runs through a session named in `receivers`: the SQL argument of its
    rows(), run() and check() helpers and of <session>.execute() (a test
    that runs several gets "#i" suffixes).  A call inside `with
    pytest.raises` (a statement the test expects to be rejected) is left
    out; an f-string is read with the test's own string constants.  Read
    from the source with ast, so the SQL is the test's own text and the
    file (which may import the JAX package) is not imported."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        filename)
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if (not isinstance(fn, ast.FunctionDef) or fn.name in skip
                or (only is not None and fn.name not in only)):
            continue
        consts = {n.targets[0].id: n.value.value for n in ast.walk(fn)
                  if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
                  and isinstance(n.targets[0], ast.Name)}
        rejected = {id(c) for w in ast.walk(fn) if isinstance(w, ast.With)
                    and any("raises" in ast.unparse(i.context_expr) for i in w.items)
                    for c in ast.walk(w)}
        found = []
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call) or id(call) in rejected:
                continue
            f = call.func
            if (isinstance(f, ast.Name) and f.id in ("rows", "run") and len(call.args) >= 2
                    and getattr(call.args[0], "id", None) in receivers):
                arg = call.args[1]
            elif isinstance(f, ast.Name) and f.id == "check" and len(call.args) >= 3:
                arg = call.args[2]
            elif (isinstance(f, ast.Attribute) and f.attr == "execute"
                  and getattr(f.value, "id", None) in receivers and call.args):
                arg = call.args[0]
            else:
                continue
            if isinstance(arg, ast.JoinedStr):
                try:
                    sql = "".join(
                        str(consts[p.value.id]) if isinstance(p, ast.FormattedValue)
                        else p.value for p in arg.values)
                except (KeyError, AttributeError):  # not the test's constant
                    continue
            else:
                try:
                    sql = ast.literal_eval(arg)
                except ValueError:  # a variable
                    continue
            if isinstance(sql, str) and sql.lstrip().lower().startswith("select"):
                found.append(sql)
        for i, sql in enumerate(found):
            out[fn.name if len(found) == 1 else f"{fn.name}#{i}"] = sql
    return out


# tests of tests/test_aggregates.py that do not run on the TPC-H session:
# the memory connector (test_array_map_listagg runs one statement on it),
# the distributed runner
AGG_TEST_SKIP = (
    "test_sketched_partial_final_distributed",
    "test_sum_distinct_distributed", "test_sum_overflow_fails_loudly",
    "test_sum_distinct_with_nulls",
)
# the JSON, URL, digest and levenshtein tests of test_client_features.py
CLIENT_TESTS = ("test_json_array_functions", "test_url_functions",
                "test_digest_functions", "test_levenshtein")


def _library_sql():
    """The TPC-H statements of the aggregate, function, grouping-set and
    array tests (tests/test_aggregates.py, test_functions.py,
    test_grouping_sets.py, test_arrays.py), the JSON/URL/digest tests of
    test_client_features.py and the TABLESAMPLE tests of
    test_session_features.py, with test_approx_percentile's f-string at
    each fraction it runs."""
    out = {}
    for fname, kw in (("test_aggregates.py", {"skip": AGG_TEST_SKIP}),
                      ("test_functions.py", {}), ("test_grouping_sets.py", {}),
                      ("test_arrays.py", {}),
                      ("test_client_features.py", {"only": CLIENT_TESTS}),
                      ("test_session_features.py",
                       {"only": ("test_tablesample", "test_tablesample_after_alias"),
                        "receivers": ("s",)})):
        for name, sql in sql_statements(fname, **kw).items():
            out[f"{fname[5:-3]}:{name}"] = sql
    for p in (0.0, 0.25, 0.5, 0.9, 1.0):
        out[f"aggregates:test_approx_percentile@{p}"] = (
            f"select approx_percentile(l_quantity, {p}) from lineitem")
    return out


def _tpcds_sql():
    """The 22 statements of tests/test_tpcds.py (Q90 with its web_page
    probe replaced as the test replaces it) and the null-FK count of its
    test_nullable_fk_join_drops_nulls, as {"Q3": sql, ..., "NULL-FK":
    sql}.  The file imports the JAX package, so its source is read with
    ast instead of imported."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_tpcds.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and node.targets[0].id.startswith("Q")):
            consts[node.targets[0].id] = node.value.value
        if (isinstance(node, ast.FunctionDef)
                and node.name == "test_nullable_fk_join_drops_nulls"):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign)
                        and getattr(sub.targets[0], "id", None) == "sql"):
                    consts["NULL-FK"] = ast.literal_eval(sub.value)
    consts["Q90"] = consts["Q90"].replace("web_page_probe", "(select 1 wp) wp")
    return consts


# the statements of the TPC-DS path beside those of tests/test_tpcds.py:
# Q27 in its published ROLLUP form (the test's filters; the published
# s_state list is dropped, as the generator gives its stores random
# states), the aggregate families per store, and the function library
DS_EXTRA = {
    "DS-Q27-ROLLUP": """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2002
group by rollup (i_item_id, s_state)
order by i_item_id, s_state
limit 100
""",
    "DS-AGG": """
select s_store_id, count(*) n,
       stddev_samp(ss_quantity) sd, var_pop(ss_net_profit) vp,
       corr(ss_list_price, ss_sales_price) cr, geometric_mean(ss_quantity) gm,
       approx_distinct(ss_customer_sk) ad,
       approx_percentile(ss_sales_price, 0.5) p50,
       max_by(ss_ticket_number, ss_net_profit) mb,
       bool_and(ss_quantity > 0) ba, bitwise_or_agg(ss_quantity) bo,
       checksum(ss_item_sk) ck
from store_sales, store
where ss_store_sk = s_store_sk
group by s_store_id
order by s_store_id
""",
    "DS-FN": """
select day_of_week(d_date) dow,
       width_bucket(cast(ss_net_paid as double), 0, 20000, 8) b,
       count(*) n, sum(ss_net_paid) s, max(ln(ss_quantity + 1)) l,
       min(date_diff('day', date '1998-01-01', d_date)) dd,
       max(date_trunc('month', d_date)) m,
       max(extract(quarter from d_date)) q
from store_sales, date_dim
where ss_sold_date_sk = d_date_sk and d_year = 2000
group by 1, 2 order by 1, 2
""",
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


def _four_ways(s, statements, want=None, spy=None, tag="sf1"):
    """Run every statement with megakernels on and off, then both again
    with every kernel function replaced by its plain version: the four
    pages must be byte-identical (float64 sums run in an order the rows
    fix, so they too repeat bit for bit).  `want` names the kernels a
    (statement, mode) must launch; `spy(q)` is a context around each
    on/off run.  Returns the pages of the "on" runs."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn

    pages = {}
    for mode in ("on", "off"):
        s.properties.set("megakernels", mode)
        for q, sql in statements.items():
            kn.reset_counts()
            with spy(q) if spy else contextlib.nullcontext():
                pages[(q, mode)] = s.execute(sql)
            torch.cuda.synchronize()
            for name in (want or {}).get((q, mode), ()):
                if kn.LAUNCHES[name] == 0:
                    raise AssertionError(f"{q} megakernels={mode}: {name} never launched")
            _log(f"[{tag}] {q} megakernels={mode}: {pages[(q, mode)].count} rows, "
                 f"launches {_launched(kn)}")
    with _plain_kernels():
        for mode in ("on", "off"):
            s.properties.set("megakernels", mode)
            for q, sql in statements.items():
                pages[(q, "plain-" + mode)] = s.execute(sql)
    for q in statements:
        for mode in ("off", "plain-on", "plain-off"):
            convert.assert_pages_identical(pages[(q, "on")], pages[(q, mode)])
    return {q: pages[(q, "on")] for q in statements}


def phase_sf1(dev, sf=1.0):
    """SF1 parity: the 22 TPC-H queries and SF1_EXTRA (each must return
    rows, with the kernels of SF1_WANT), the statements of the aggregate,
    function and grouping-set tests on the same TPC-H session, and the
    TPC-DS path's statements on a TPC-DS session with its numpy checks."""
    import gc

    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpcds_session, tpch_session

    statements = dict(_tpch_sql())
    statements.update(SF1_EXTRA)
    s = _card_session(tpch_session, sf)
    real = kn.fused_agg_sums

    def rec_fused(*args):
        MAIN["sf1_fused"] = args
        return real(*args)

    @contextlib.contextmanager
    def spy(q):
        if q == "Q1":  # Q1's fused call, timed in the timing phase
            kn.fused_agg_sums = rec_fused
        try:
            yield
        finally:
            kn.fused_agg_sums = real

    pages = _four_ways(s, statements, SF1_WANT, spy)
    for q, page in pages.items():
        if page.count == 0:
            raise AssertionError(f"{q} returned no rows at SF{sf:g}")
    _log(f"[sf1] all {len(statements)} statements: megakernels on, off and plain "
         f"pages byte-identical")
    cols, dicts = _scan_host_columns(s, ["l_tax", "l_returnflag", "l_shipdate"])
    check_reference({q: pages[q] for q in ("Q6", "Q1")}, cols, dicts)
    check_q3_page(s, pages["Q3"])
    _log("[sf1] Q6, Q1 and Q3 agree exactly with the numpy references")
    gen = [e for k, e in s._scan_cache.entries.items() if k[0] == "tpch"]
    _log(f"[sf1] scans in the cache: {sum(e.get('devgen') is not None for e in gen)} "
         f"generated on the card, {sum(e.get('devgen') is None for e in gen)} by the "
         f"host (columns the generator cannot make)")
    # the fifth way: every TPC-H query over the host generator's scans
    host = _card_session(tpch_session, sf, device_generation=False)
    for q, sql in _tpch_sql().items():
        page = host.execute(sql)
        if host.last_kernel_profile.get("deviceGeneratedScans"):
            raise AssertionError(f"{q}: a scan was generated on the card with "
                                 f"device_generation off")
        convert.assert_pages_identical(pages[q], page)
    _log("[sf1] the 22 TPC-H queries over the host generator's scans: pages "
         "byte-identical to the card-generated runs")
    del host
    for row in pages["Q1"].to_pylist():
        _log(f"[sf1] Q1 {row}")
    _log(f"[sf1] Q6 {pages['Q6'].to_pylist()}")
    for row in pages["Q3"].to_pylist():
        _log(f"[sf1] Q3 {row}")
    lib = _library_sql()
    _four_ways(s, lib, tag="sf1-lib")
    _log(f"[sf1] the {len(lib)} statements of the aggregate, function and "
         f"grouping-set tests: on, off and plain agree")
    del s
    ds = _ds_statements()
    s = _card_session(tpcds_session, sf)
    pages = _four_ways(s, ds, tag="sf1-ds")
    _log(f"[sf1] the {len(ds)} TPC-DS statements: on, off and plain agree")
    host = _DsHost(sf)
    for q, check in DS_CHECKS.items():
        check(host, pages[q])
    _log(f"[sf1] TPC-DS {', '.join(DS_CHECKS)} agree with the numpy references")
    del s, host
    gc.collect()
    torch.cuda.empty_cache()


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
    s = _card_session(tpch_session, sf)
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
    MAIN.update(launches=launches, recorded=recorded, walls=walls, session=s,
                pages=pages)
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
    if do_profile:
        for q, sql in sqls.items():
            _profile(s, sql, f"sf{sf:g} {q}")


# ---------------------------------------------------------------------------
# phase 6: this slice at SF10 (arrays and UNNEST, the array-valued
# aggregates, TABLESAMPLE, writes to the memory connector, the JSON/URL/
# hash functions, MATCH_RECOGNIZE), in the main path's session


# the one cut of scale: MATCH_RECOGNIZE's matcher is a row-at-a-time NFA
# on the host, so the pattern scan reads the orders of the first 1% of
# customers (about 150 k rows), not all 15 M
MR_CUSTKEY_MAX = 15000
# a cut of depth for the run's time: the five string families read the
# first 10% of customers (150,000), so their Python checks parse 150,000
# names, not 1.5 M; and the phase repeats its statements warm once
STR_CUSTKEY_MAX = 150000
EXT_REPS = 1                 # warm runs (cut from 2 for the call's budget)
JSON_DOC = "concat('{\"id\": \"', c_name, '\", \"tags\": [\"a\", \"b\"]}')"
# the URL functions read supplier names (100,000 at SF10): a host
# dictionary projection runs over the whole dictionary, and over the
# 1.5 M customer names its cold run took 43.5 s of the call's budget
URL_HOST = "concat('https://', replace(s_name, '#', '-'), '.shop.example.com:8080/c?q=1')"
URL_QUERY = "concat('https://shop.example.com/c?name=', replace(s_name, '#', '%23'), '&page=2')"
EXT_SQL = {
    "EXPLODE-WORDS":
        "select w, count(*) n from part cross join unnest(split(p_name, ' ')) as t(w) "
        "group by w order by w",
    "EXPLODE-ORD":
        "select o, count(*) n from part cross join unnest(split(p_name, ' ')) "
        "with ordinality as t(w, o) group by o order by o",
    "COLLECT":
        "select c, cardinality(a) n, element_at(a, 1) first_key from (select o_custkey c, "
        "array_agg(o_orderkey) a from orders group by o_custkey) order by c",
    "LISTAGG-SUPP":
        "select s_nationkey, listagg(s_name, ',') names from supplier "
        "group by s_nationkey order by s_nationkey",
    "MAPAGG-PS":
        "select ps_partkey, map_agg(ps_suppkey, ps_availqty) m from partsupp "
        "where ps_partkey <= 200000 group by ps_partkey order by ps_partkey",
    "SAMPLE-10":
        "select l_returnflag, l_linestatus, count(*) n, sum(l_quantity) q "
        "from lineitem tablesample bernoulli (10) "
        "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus",
    "SAMPLE-SYS100": "select count(*) from lineitem tablesample system (100)",
    "JSON":
        f"select count(v) n, count(distinct v) d, min(v) lo, max(v) hi from (select "
        f"json_extract_scalar({JSON_DOC}, '$.id') v from customer "
        f"where c_custkey <= {STR_CUSTKEY_MAX})",
    "URL":
        f"select count(distinct h) dh, max(h) mh, count(distinct p) dp, min(p) mp from "
        f"(select url_extract_host({URL_HOST}) h, url_extract_parameter({URL_QUERY}, "
        f"'name') p from supplier)",
    "MD5": "select count(distinct md5(c_name)) d, min(md5(c_name)) lo from customer "
           f"where c_custkey <= {STR_CUSTKEY_MAX}",
    "CRC32": f"select sum(crc32(c_phone)) from customer where c_custkey <= {STR_CUSTKEY_MAX}",
    "BASE64": "select count(distinct to_base64(c_name)) d, max(to_base64(c_name)) hi "
              f"from customer where c_custkey <= {STR_CUSTKEY_MAX}",
    "MR-V": f"""with o as (select o_custkey, o_orderdate, o_orderkey, o_totalprice
    from orders where o_custkey <= {MR_CUSTKEY_MAX})
select * from o match_recognize (
  partition by o_custkey order by o_orderdate, o_orderkey
  measures first(o_totalprice) as start_price, last(down.o_totalprice) as bottom,
           last(o_totalprice) as end_price, match_number() as mno
  one row per match after match skip past last row
  pattern (strt down+ up+)
  define down as o_totalprice < prev(o_totalprice), up as o_totalprice > prev(o_totalprice)
) mr order by o_custkey, mno""",
}
ETL_TABLE = "memory.etl.ords"
ETL_COLS = ("o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate, "
            "o_orderpriority, o_clerk, o_shippriority")
# the ETL sequence: statement, then the affected-row count and the table
# the numpy model (_EtlModel) says it must leave
ETL_SQL = {
    "CTAS": f"create table {ETL_TABLE} as select {ETL_COLS} from orders",
    "INSERT": f"insert into {ETL_TABLE} select {ETL_COLS} from orders "
              "where o_custkey % 5 = 0",
    "DELETE": f"delete from {ETL_TABLE} where o_orderkey % 2 = 0",
    "UPDATE": f"update {ETL_TABLE} set o_totalprice = o_totalprice + 1 "
              "where o_orderpriority = '5-LOW'",
    "MERGE": f"merge into {ETL_TABLE} t using (select o_orderkey k, o_totalprice p "
             "from orders where o_custkey % 7 = 0) s on t.o_orderkey = s.k "
             "when matched then update set o_shippriority = 9 "
             "when not matched then insert (o_orderkey, o_custkey, o_totalprice, "
             "o_shippriority) values (s.k, 0, s.p, 1)",
}
ETL_CHECK = (f"select count(*), sum(o_totalprice), sum(o_custkey), sum(o_shippriority), "
             f"count(o_orderpriority) from {ETL_TABLE}")


def _strings(cols, dicts, c):
    """A cached scan's varchar column as a numpy array of str."""
    d = np.array([str(x) for x in dicts[c]], dtype=object)
    return d[cols[c]]


def check_explode(s, pages):
    cols, dicts = _scan_host_columns(s, ["p_name"], "part")
    d = dicts["p_name"]
    per_entry = np.bincount(cols["p_name"], minlength=len(d))
    words, ords = {}, {}
    for entry, k in zip(d, per_entry):
        if k:
            for i, w in enumerate(str(entry).split(" "), 1):
                words[w] = words.get(w, 0) + int(k)
                ords[i] = ords.get(i, 0) + int(k)
    _expect_rows("EXPLODE-WORDS", pages["EXPLODE-WORDS"].to_pylist(), sorted(words.items()))
    _expect_rows("EXPLODE-ORD", pages["EXPLODE-ORD"].to_pylist(), sorted(ords.items()))
    _log(f"[ext] UNNEST: {len(words)} words over {int(per_entry.sum())} parts, "
         f"{sum(words.values())} element rows, as numpy and str.split count them")


def check_collect(s, page):
    cols, _ = _scan_host_columns(s, ["o_custkey", "o_orderkey"], "orders")
    cust, key = cols["o_custkey"], cols["o_orderkey"]
    counts = np.bincount(cust)
    cs, first = np.unique(cust, return_index=True)
    # orders are generated in orderkey order: the first key is the least
    if not (np.diff(key) > 0).all():
        raise AssertionError("COLLECT: orders are not in orderkey order")
    got = [np.asarray(c.values)[: page.count] for c in page.columns]
    if page.count != len(cs):
        raise AssertionError(f"COLLECT: {page.count} groups, numpy {len(cs)}")
    for name, g, w in (("custkey", got[0], cs), ("cardinality", got[1], counts[cs]),
                       ("element_at", got[2], key[first])):
        if not np.array_equal(g, w):
            raise AssertionError(f"COLLECT: {name} differs from numpy")
    _log(f"[ext] COLLECT: {page.count} customers, cardinality = np.bincount(o_custkey), "
         f"element_at(a, 1) = the least orderkey, exactly")


def check_listagg(s, page):
    cols, dicts = _scan_host_columns(s, ["s_nationkey", "s_name"], "supplier")
    names = _strings(cols, dicts, "s_name")
    want = [(int(n), ",".join(names[cols["s_nationkey"] == n]))
            for n in np.unique(cols["s_nationkey"])]
    _expect_rows("LISTAGG-SUPP", page.to_pylist(), want)


def check_map_agg(s, page):
    cols, _ = _scan_host_columns(s, ["ps_partkey", "ps_suppkey", "ps_availqty"], "partsupp")
    want: dict = {}
    for p, k, v in zip(cols["ps_partkey"].tolist(), cols["ps_suppkey"].tolist(),
                       cols["ps_availqty"].tolist()):
        if p <= 200000:
            want.setdefault(p, {}).setdefault(k, v)
    got = page.to_pylist()
    _expect_rows("MAPAGG-PS", got, sorted(want.items()))
    _log(f"[ext] MAPAGG-PS: {len(got)} parts' supplier maps as numpy builds them")


def check_sample(s, pages):
    cols, dicts = _scan_host_columns(s, ["l_returnflag", "l_linestatus", "l_quantity"])
    n = cols["l_quantity"].shape[0]
    u = (_splitmix64_np(np.arange(n, dtype=np.int64)) >> np.uint64(11)).astype(
        np.float64) / float(1 << 53)
    keep = u < 0.1
    flag = _strings(cols, dicts, "l_returnflag")
    status = _strings(cols, dicts, "l_linestatus")
    want = []
    for f in sorted(set(flag.tolist())):
        for st in sorted(set(status.tolist())):
            m = keep & (flag == f) & (status == st)
            if m.any():
                want.append((f, st, int(m.sum()), _isum(cols["l_quantity"][m])))
    page = pages["SAMPLE-10"]
    got = [(r[0], r[1], r[2], _raw(page.columns[3], i))
           for i, r in enumerate(page.to_pylist())]
    _expect_rows("SAMPLE-10", got, want)
    total = pages["SAMPLE-SYS100"].to_pylist()
    if total != [(n,)]:
        raise AssertionError(f"SAMPLE-SYS100 {total} != [({n},)]")
    _log(f"[ext] SAMPLE-10 keeps {int(keep.sum())} of {n} rows, the rows numpy's "
         f"splitmix64 of the positions keeps; SYSTEM (100) counts all {n}")


def check_strings(s, pages):
    import base64
    import hashlib
    import json as jsonlib
    import zlib
    from urllib.parse import parse_qs, urlparse

    cols, dicts = _scan_host_columns(s, ["c_name", "c_custkey"], "customer")
    names = _strings(cols, dicts, "c_name")[cols["c_custkey"] <= STR_CUSTKEY_MAX].tolist()
    ids = [jsonlib.loads('{"id": "' + c + '", "tags": ["a", "b"]}')["id"] for c in names]
    md5 = [hashlib.md5(c.encode()).hexdigest() for c in names]
    b64 = [base64.b64encode(c.encode()).decode() for c in names]
    want = {
        "JSON": [(len(ids), len(set(ids)), min(ids), max(ids))],
        "MD5": [(len(set(md5)), min(md5))],
        "BASE64": [(len(set(b64)), max(b64))],
    }
    cols, dicts = _scan_host_columns(s, ["s_name"], "supplier")
    supp = _strings(cols, dicts, "s_name").tolist()
    hosts = [urlparse("https://" + c.replace("#", "-") + ".shop.example.com:8080/c?q=1").hostname
             for c in supp]
    params = [parse_qs(urlparse("https://shop.example.com/c?name=" + c.replace("#", "%23")
                                + "&page=2").query)["name"][0] for c in supp]
    want["URL"] = [(len(set(hosts)), max(hosts), len(set(params)), min(params))]
    cols, dicts = _scan_host_columns(s, ["c_phone", "c_custkey"], "customer")
    d = dicts["c_phone"]
    crc = np.array([zlib.crc32(str(x).encode()) for x in d], dtype=np.int64)
    phones = cols["c_phone"][cols["c_custkey"] <= STR_CUSTKEY_MAX]
    want["CRC32"] = [(int(np.bincount(phones, minlength=len(d)) @ crc),)]
    for q, rows in want.items():
        _expect_rows(q, pages[q].to_pylist(), rows)
    _log(f"[ext] JSON, MD5, CRC32 and BASE64 over {len(names)} customers and URL over "
         f"{len(supp)} suppliers agree "
         f"with Python's json, urllib.parse, hashlib, zlib and base64")


def check_match_recognize(s, page):
    cols, _ = _scan_host_columns(
        s, ["o_custkey", "o_orderdate", "o_orderkey", "o_totalprice"], "orders")
    m = cols["o_custkey"] <= MR_CUSTKEY_MAX
    cust, date, key, price = (cols[c][m] for c in (
        "o_custkey", "o_orderdate", "o_orderkey", "o_totalprice"))
    order = np.lexsort((key, date, cust))
    cust, price = cust[order].tolist(), price[order].tolist()
    want = []
    i = 0
    while i < len(cust):  # one customer's orders at a time
        j = i
        while j < len(cust) and cust[j] == cust[i]:
            j += 1
        p, a, mno = price[i:j], 0, 0
        while a < len(p):  # strictly falling, then strictly rising
            b = a + 1
            while b < len(p) and p[b] < p[b - 1]:
                b += 1
            if b == a + 1 or b >= len(p) or not p[b] > p[b - 1]:
                a += 1
                continue
            c = b + 1
            while c < len(p) and p[c] > p[c - 1]:
                c += 1
            mno += 1
            want.append((cust[i], p[a], p[b - 1], p[c - 1], mno))
            a = c
        i = j
    got = [(r[0], _raw(page.columns[1], k), _raw(page.columns[2], k),
            _raw(page.columns[3], k), r[4]) for k, r in enumerate(page.to_pylist())]
    _expect_rows("MR-V", got, want)
    _log(f"[ext] MR-V: {len(want)} V shapes over {len(cust)} orders of "
         f"{MR_CUSTKEY_MAX} customers, as a plain Python scan finds them")


class _EtlModel:
    """The ETL table as numpy over the orders scan's host arrays: what
    each write must leave and report."""

    def __init__(self, s):
        cols, dicts = _scan_host_columns(
            s, ["o_orderkey", "o_custkey", "o_totalprice", "o_orderpriority",
                "o_shippriority"], "orders")
        self.src = {c: cols[c].astype(np.int64) for c in
                    ("o_orderkey", "o_custkey", "o_totalprice", "o_shippriority")}
        self.src["low"] = _strings(cols, dicts, "o_orderpriority") == "5-LOW"
        self.src["prio"] = np.ones(len(self.src["low"]), dtype=bool)

    def apply(self, label):
        src = self.src
        if label == "CTAS":
            self.t = {c: v.copy() for c, v in src.items()}
            return len(src["o_orderkey"])
        t = self.t
        if label == "INSERT":
            m = src["o_custkey"] % 5 == 0
            for c in t:
                t[c] = np.concatenate([t[c], src[c][m]])
            return int(m.sum())
        if label == "DELETE":
            keep = t["o_orderkey"] % 2 != 0
            for c in t:
                t[c] = t[c][keep]
            return int((~keep).sum())
        if label == "UPDATE":
            t["o_totalprice"] = t["o_totalprice"] + 100 * t["low"]
            return int(t["low"].sum())
        # MERGE
        m = src["o_custkey"] % 7 == 0
        skeys, sprice = src["o_orderkey"][m], src["o_totalprice"][m]
        hit = np.isin(t["o_orderkey"], skeys)
        t["o_shippriority"] = np.where(hit, 9, t["o_shippriority"])
        new = ~np.isin(skeys, t["o_orderkey"])
        add = {"o_orderkey": skeys[new], "o_custkey": np.zeros(int(new.sum()), np.int64),
               "o_totalprice": sprice[new], "o_shippriority": np.ones(int(new.sum()), np.int64),
               "low": np.zeros(int(new.sum()), bool), "prio": np.zeros(int(new.sum()), bool)}
        for c in t:
            t[c] = np.concatenate([t[c], add[c]])
        return int(hit.sum()) + int(new.sum())

    def expect(self):
        t = self.t
        return [(len(t["o_orderkey"]), _isum(t["o_totalprice"]), _isum(t["o_custkey"]),
                 _isum(t["o_shippriority"]), int(t["prio"].sum()))]


def _etl_run(s, model, walls, checked):
    """One pass of the ETL sequence: drop, then each write and its
    read-after-write check (count and sums, scan cache on)."""
    s.execute(f"drop table if exists {ETL_TABLE}")
    for label, sql in ETL_SQL.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        page = s.execute(sql)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
        want_rows = model.apply(label)
        _expect_rows(label, page.to_pylist(), [(want_rows,)])
        chk = s.execute(ETL_CHECK)
        got = [(r[0], _raw(chk.columns[1], 0), r[2], r[3], r[4]) for r in chk.to_pylist()]
        _expect_rows(f"{label} read-after-write", got, model.expect())
        checked.append((label, want_rows, got[0]))


# kernels the ext path must launch (read from a CPU run of this phase
# with counting shims): the sampled and string aggregates and the ETL
# read-back checks group at most 32 groups, and MERGE's join probes by
# direct address; no aggregate of the path fuses (a sample or a memory
# table stops fusion)
EXT_KERNELS = ("grouped_count", "grouped_sum_i64", "direct_probe")
EXT_CHECKS = {"COLLECT": check_collect, "LISTAGG-SUPP": check_listagg,
              "MAPAGG-PS": check_map_agg, "MR-V": check_match_recognize}


def phase_ext(dev, do_profile=False):
    """This slice at SF10 in the main path's session (its scans stay
    resident), a memory catalog added: each EXT_SQL statement cold once
    and EXT_REPS times warm, the ETL sequence (CTAS of all orders,
    INSERT ... SELECT, DELETE, UPDATE, MERGE) cold once and EXT_REPS
    times warm with a read-after-write check after every write, every
    kernel's launches over the warm runs, the phase's peak device memory
    and cold time; each statement held by its numpy or Python check."""
    from trino_tpu_torch.ops import kernels as kn

    sf = MAIN_SF
    s = MAIN.get("session")
    if s is None:  # --phase ext
        from trino_tpu_torch.session import tpch_session

        s = MAIN["session"] = _card_session(tpch_session, sf)
    s.properties.set("megakernels", "auto")
    if "memory" not in s.catalogs.names():
        s.create_catalog("memory", "memory", {})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_cold = time.perf_counter()
    for q, sql in EXT_SQL.items():  # cold: generation, upload, first run
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        _log(f"[ext{sf:g}] cold {q}: {time.perf_counter() - t0:.3f} s")
    s.execute(f"select {ETL_COLS} from orders limit 1")  # the CTAS's scan
    model = _EtlModel(s)
    etl_walls = {q: [] for q in ETL_SQL}
    checked = []
    _etl_run(s, model, etl_walls, checked)
    cold = {q: w[0] for q, w in etl_walls.items()}
    _log(f"[ext{sf:g}] cold ETL: " + ", ".join(f"{q} {w:.3f} s" for q, w in cold.items()))
    _log(f"[ext{sf:g}] all cold runs {time.perf_counter() - t_cold:.1f} s; scan cache "
         f"{len(s._scan_cache.entries)} scans, {s._scan_cache.bytes} bytes")
    walls = {q: [] for q in EXT_SQL}
    walls.update({q: [] for q in ETL_SQL})
    per_run = {q: dict.fromkeys(KERNEL_FNS, 0) for q in walls}
    pages = {}
    kn.reset_counts()  # the phase's warm runs start here
    for _ in range(EXT_REPS):
        for q, sql in EXT_SQL.items():
            before = dict(kn.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pages[q] = s.execute(sql)
            torch.cuda.synchronize()
            walls[q].append(time.perf_counter() - t0)
            for name in KERNEL_FNS:
                per_run[q][name] += kn.LAUNCHES[name] - before[name]
        before = dict(kn.LAUNCHES)
        _etl_run(s, model, walls, checked)
        for name in KERNEL_FNS:  # the sequence as one: writes and checks
            per_run["CTAS"][name] += kn.LAUNCHES[name] - before[name]
    launches = dict(kn.LAUNCHES)  # ... and end here
    peak = torch.cuda.max_memory_allocated()
    _log(f"[ext{sf:g}] launches over the warm runs: {launches}")
    for q, n in per_run.items():
        if q in ETL_SQL and q != "CTAS":
            continue
        _log(f"[ext{sf:g}]   {'ETL (all writes and checks)' if q == 'CTAS' else q} "
             f"over {EXT_REPS} runs: {n}")
    for q, w in walls.items():
        rows = f", {pages[q].count} rows" if q in pages else ""
        _log(f"[ext{sf:g}] warm {q}: median {statistics.median(w) * 1e3:.3f} ms over "
             f"{len(w)} runs (all: {', '.join(f'{x * 1e3:.3f}' for x in w)}){rows}")
    _log(f"[ext{sf:g}] peak device memory over the phase (cold and warm) "
         f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above what was "
         f"allocated before it ({base / 2**30:.2f} GiB)")
    for label, n, got in checked[: len(ETL_SQL)]:
        _log(f"[ext{sf:g}] {label}: {n} rows; then count, sum(o_totalprice), "
             f"sum(o_custkey), sum(o_shippriority), count(o_orderpriority) = {got}")
    _log(f"[ext{sf:g}] {len(checked)} writes, each read back with the scan cache on "
         f"as the numpy model says")
    check_explode(s, pages)
    for q, check in EXT_CHECKS.items():
        check(s, pages[q])
    check_sample(s, pages)
    check_strings(s, pages)
    for name in EXT_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the ext path")
    for q in ("EXPLODE-ORD", "SAMPLE-10", "LISTAGG-SUPP", "MR-V"):
        for row in pages[q].to_pylist()[:3]:
            _log(f"[ext{sf:g}] {q} {str(row)[:160]}")
    if do_profile:
        for q, sql in EXT_SQL.items():
            _profile(s, sql, f"ext{sf:g} {q}")
        s.execute(f"drop table if exists {ETL_TABLE}")
        for q, sql in ETL_SQL.items():
            _profile(s, sql, f"ext{sf:g} {q}")


# ---------------------------------------------------------------------------
# phase 6b: queries larger than their memory budget (streaming and spill)


# kernels each out-of-core statement must launch inside its tiles
OOC_KERNELS = {"Q6": ("fused_agg_sums",), "Q3": ("direct_probe",)}


def _check_ooc_path(label, limit, prof):
    """The path, fragments and tiles the card took against OOC_WANT."""
    want = OOC_WANT[(label, limit)]
    path = prof.get("outOfCore")
    if path != want[0] or prof.get("forcedStreaming"):
        raise AssertionError(f"{label} under {limit} bytes took {path} "
                             f"(forced {prof.get('forcedStreaming', 0)}), want {want[0]}")
    if path == "stream":
        tiles = sorted(prof["streamedTiles"].values())
        if (prof["streamedFragments"], tiles) != (want[1], sorted(t for _, t in want[2])):
            raise AssertionError(f"{label}: {prof['streamedFragments']} fragments, tiles "
                                 f"{tiles}; want {want[1]}, {want[2]}")
        return f"stream, {prof['streamedFragments']} fragments, tiles {tiles}"
    return path


def _expect_decoded(label, got, want):
    """The same rows: names, counts, validity and values, dictionary
    columns compared as their strings."""
    if got.names != want.names or got.count != want.count:
        raise AssertionError(f"{label}: {got.names} x{got.count} != {want.names} "
                             f"x{want.count}")
    for name, a, b in zip(got.names, got.columns, want.columns):
        va, vb = (np.asarray(c.values)[: got.count] for c in (a, b))
        if a.dictionary is not None:
            va = np.asarray([str(x) for x in a.dictionary], dtype=object)[va]
            vb = np.asarray([str(x) for x in b.dictionary], dtype=object)[vb]
        oka, okb = (np.ones(got.count, bool) if c.validity is None
                    else np.asarray(c.validity)[: got.count] for c in (a, b))
        if not (np.array_equal(oka, okb) and np.array_equal(va[oka], vb[okb])):
            raise AssertionError(f"{label}: column {name} differs from the in-memory run")


def check_ooc_distinct(ref, page):
    cols, _ = _scan_host_columns(ref, ["l_orderkey"])
    k = cols["l_orderkey"]
    n = (1 + int(np.count_nonzero(np.diff(k)))) if np.all(k[1:] >= k[:-1]) else len(np.unique(k))
    _expect_rows("OOC-DISTINCT", page.to_pylist(), [(n,)])


def check_ooc_sort(ref, page):
    """All 15 M orders by o_totalprice desc, o_orderkey, against numpy."""
    cols, _ = _scan_host_columns(ref, ["o_orderkey", "o_totalprice"], "orders")
    key, price = cols["o_orderkey"], cols["o_totalprice"]
    order = np.lexsort((key, -price))
    for j, want in enumerate((key[order], price[order])):
        got = np.asarray(page.columns[j].values)[: page.count]
        if page.count != len(want) or not np.array_equal(got, want):
            raise AssertionError(f"OOC-SORT column {j} differs from numpy's order")


def check_ooc_approx(ref, page, exact_page):
    """approx_distinct within three standard errors (3 x 1.04/sqrt(512))
    of numpy's exact distinct count per flag, which the in-memory run
    (the SINGLE step, exact) must give."""
    cols, dicts = _scan_host_columns(ref, ["l_partkey", "l_returnflag"])
    pk, rf = cols["l_partkey"], cols["l_returnflag"].astype(np.int64)
    seen = np.zeros((len(dicts["l_returnflag"]), int(pk.max()) + 1), dtype=bool)
    seen[rf, pk] = True
    exact = {str(f): int(n) for f, n in zip(dicts["l_returnflag"], seen.sum(1))}
    in_memory = {f: d for f, d, _p in exact_page.to_pylist()}
    if in_memory != exact:
        raise AssertionError(f"OOC-APPROX in memory {in_memory} != numpy {exact}")
    for flag, est, _p in page.to_pylist():
        want = exact[flag]
        if abs(est - want) > 3 * 1.04 / 512 ** 0.5 * want:
            raise AssertionError(f"OOC-APPROX {flag}: {est} vs exact {want}")
        _log(f"[ooc] OOC-APPROX {flag}: approx_distinct {est}, exact {want} "
             f"({(est - want) / want:+.4%})")


def phase_ooc(dev, do_profile=False):
    """TPC-H SF10 (no cut of scale) in three fresh sessions whose limits
    are smaller than the queries: the JAX package's default 8 GiB (Q1),
    1 GiB (Q6, Q1, Q3, Q18, a filtered lineitem-orders join, a grouped
    approx_distinct / approx_percentile) and 256 MiB (count(distinct),
    a sort of all orders, a running sum over all orders).  Each
    statement cold and once warm: the path, fragments and tiles against
    OOC_WANT, every kernel's launches, the peak device memory above what
    was allocated before it, beside the limit; the page byte-identical
    to the in-memory page of a session whose limit is the card's
    (float64 at relative 1e-12) and warm to cold, Q6, Q1 and Q3 against
    the numpy references, the approximate statement (exact in memory)
    identical to a run on the plain kernels and within its error of
    numpy's distinct count,
    the sort, window and distinct count against numpy."""
    import gc

    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    sf = MAIN_SF
    ref = MAIN.get("session") or _card_session(tpch_session, sf)
    ref.properties.set("megakernels", "auto")
    pages, totals = {}, dict.fromkeys(KERNEL_FNS, 0)
    from trino_tpu_torch.utils.memory import ExceededMemoryLimitError

    for limit, props, statements in _ooc_statements():
        s = tpch_session(sf, query_max_memory_bytes=limit, result_cache=False, **props)
        for label, sql in statements:
            if (label, limit) in OOC_REFUSED:
                t0 = time.perf_counter()
                try:
                    s.execute(sql)
                except ExceededMemoryLimitError as e:
                    _log(f"[ooc] {label} limit {limit} bytes: refused as planned after "
                         f"{time.perf_counter() - t0:.3f} s: {e}")
                    continue
                raise AssertionError(f"{label} ran under {limit} bytes; both packages "
                                     f"refuse it")
            kn.reset_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(2):  # cold, then warm
                t0 = time.perf_counter()
                page = s.execute(sql)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if len(walls) == 1:
                    cold = page
            peak = torch.cuda.max_memory_allocated() - base
            prof = s.last_kernel_profile
            path = _check_ooc_path(label, limit, prof)
            convert.assert_pages_identical(cold, page)
            launches = {k: v for k, v in kn.LAUNCHES.items() if v}
            for name in KERNEL_FNS:
                totals[name] += kn.LAUNCHES[name]
            for name in OOC_KERNELS.get(label, ()):
                if not kn.LAUNCHES[name]:
                    raise AssertionError(f"{label}: {name} never launched in its tiles")
            if label == "Q1" and not (kn.LAUNCHES["fused_agg_sums"] or (
                    kn.LAUNCHES["grouped_count"] and kn.LAUNCHES["grouped_sum_i64"])):
                raise AssertionError("Q1's tiles launched neither the fused nor the "
                                     "grouped kernels")
            over = " ABOVE the limit" if peak > limit else ""
            _log(f"[ooc] {label} limit {limit} bytes: {path}; cold {walls[0]:.3f} s, "
                 f"warm {walls[1]:.3f} s; peak {peak} bytes above the "
                 f"{base} allocated before it{over}; launches over both runs "
                 f"{launches or 'none'}; preuploads {prof.get('preuploads', 0)} "
                 f"({prof.get('preupload_bytes', 0)} bytes copied, "
                 f"{prof.get('pregenerated_bytes', 0)} generated); warm tiles: load "
                 f"{prof.get('streamLoadS', 0):.3f} s on the prefetch thread, wait "
                 f"{prof.get('streamWaitS', 0):.3f} s, run {prof.get('streamRunS', 0):.3f} s; "
                 f"scans generated on the card {prof.get('deviceGeneratedScans', 0)}, "
                 f"by the host {prof.get('hostGeneratedScans', 0)} (warm run)")
            if do_profile:
                _profile(s, sql, f"ooc {label} {limit >> 20} MiB")
            pages[(label, limit)] = page
            if label == "OOC-APPROX":
                # in memory the SINGLE step is exact: the sketches' page
                # is held to the plain kernels and to numpy instead
                with _plain_kernels():
                    convert.assert_pages_identical(page, s.execute(sql))
                pages["OOC-APPROX-EXACT"] = ref.execute(sql)
                continue
            t0 = time.perf_counter()
            want = ref.execute(sql)
            torch.cuda.synchronize()
            if label in OOC_ROWS_ONLY:
                _expect_decoded(label, page, want)
            else:
                convert.assert_pages_match(want, page, 1e-12)
            _log(f"[ooc] {label}: agrees with the in-memory run "
                 f"({time.perf_counter() - t0:.3f} s)")
        del s
        gc.collect()
        torch.cuda.empty_cache()
    check_reference({"Q6": pages[("Q6", 1 << 30)], "Q1": pages[("Q1", 1 << 30)]},
                    *_scan_host_columns(ref, ["l_tax", "l_returnflag", "l_shipdate"]))
    check_reference({"Q6": pages[("Q6", 1 << 30)], "Q1": pages[("Q1", 8 << 30)]},
                    *_scan_host_columns(ref, ["l_tax", "l_returnflag", "l_shipdate"]))
    check_q3_page(ref, pages[("Q3", 1 << 30)])
    check_ooc_approx(ref, pages[("OOC-APPROX", 1 << 30)], pages["OOC-APPROX-EXACT"])
    check_ooc_distinct(ref, pages[("OOC-DISTINCT", 256 << 20)])
    check_ooc_sort(ref, pages[("OOC-SORT", 256 << 20)])
    check_window_all(ref, pages[("OOC-WINDOW", 256 << 20)])
    _log(f"[ooc] Q6, Q1 (8 GiB and 1 GiB) and Q3 agree with the numpy references; "
         f"the distinct count, the 15 M sorted orders and the window sums with numpy")
    _log(f"[ooc] launches over the phase (cold and warm runs): {totals}")


# ---------------------------------------------------------------------------
# the on-device TPC-H generator at SF10 against the host generator


GEN_SPLITS = 3  # lineitem again in this many order ranges


def _gen_on_card(dev, table, cols, lo, hi, count):
    """(lanes, seconds, peak bytes above what was allocated before, the
    lanes' own bytes) of one generation on the card."""
    from trino_tpu_torch.connectors import tpch_device

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = tpch_device.device_lanes(table, cols, lo, hi, MAIN_SF, count, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    own = sum(v.numel() * v.element_size() for v, _ok in lanes.values()) + count
    return lanes, secs, peak, own


def _same_lanes(label, lanes, values):
    for c, want in values.items():
        got = lanes[c][0].cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0][:5] if got.shape == want.shape else "shape"
            raise AssertionError(f"{label}.{c}: card {got.dtype}{got.shape} differs "
                                 f"from the host generator {want.dtype}{want.shape} at {bad}")


def phase_gen(dev):
    """Every table and every column the generator makes, at SF10 on the
    card, byte for byte against the port's host generator
    (connectors/tpch.py, the native lineitem generator): lineitem whole
    and in GEN_SPLITS order ranges (the generator's row chunks end inside
    orders); the card's seconds (cold, then warm) against host generation
    plus the page-locked copy to the card, and the peak device memory of
    each generation beside its lanes' own bytes."""
    import gc

    from trino_tpu_torch import device as D
    from trino_tpu_torch.connectors import tpch, tpch_device

    sf = MAIN_SF
    n = tpch._counts(sf)
    rows = {}
    for table in sorted(tpch_device.DEVICE_COLS, key=lambda t: n[t]):
        cols = sorted(tpch_device.DEVICE_COLS[table])
        t0 = time.perf_counter()
        values, _dicts, count = tpch.generate(table, sf, columns=cols)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up = [D.to_device(np.asarray(values[c]), dev, pin=True) for c in cols]
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        del up
        base_rows = n["orders"] if table == "lineitem" else n[table]
        if table == "lineitem":
            t0 = time.perf_counter()
            count_s = tpch_device.lineitem_count(0, base_rows)
            count_host_s = time.perf_counter() - t0
            if count_s != count:
                raise AssertionError(f"lineitem_count {count_s} != {count}")
        lanes, cold_s, peak, own = _gen_on_card(dev, table, cols, 0, base_rows, count)
        _same_lanes(table, lanes, values)
        del lanes
        _lanes, warm_s, _peak, _own = _gen_on_card(dev, table, cols, 0, base_rows, count)
        del _lanes, values
        rows[table] = (count, len(cols), cold_s, warm_s, host_s, upload_s, peak, own)
        _log(f"[gen] {table}: {count} rows x {len(cols)} columns byte-identical to "
             f"the host generator; card {cold_s:.3f} s cold, {warm_s:.3f} s warm; host "
             f"{host_s:.3f} s + copy {upload_s:.3f} s; peak {peak} bytes above the "
             f"allocated, lanes {own} bytes, temporaries {peak - own} bytes "
             f"({(peak - own) / max(count, 1):.1f} B a row; the gate reserves "
             f"{8 * tpch_device.DEVGEN_TEMP_LANES})"
             + (f"; lineitem_count on the host {count_host_s:.3f} s"
                if table == "lineitem" else ""))
        gc.collect()
        torch.cuda.empty_cache()
    cols = sorted(tpch_device.DEVICE_COLS["lineitem"])
    for split in range(GEN_SPLITS):
        values, _d, count = tpch.generate("lineitem", sf, split=split,
                                          num_splits=GEN_SPLITS, columns=cols)
        lo = (n["orders"] * split) // GEN_SPLITS
        hi = (n["orders"] * (split + 1)) // GEN_SPLITS
        if tpch_device.lineitem_count(lo, hi) != count:
            raise AssertionError(f"lineitem split {split}: line count differs")
        lanes, secs, _peak, _own = _gen_on_card(dev, "lineitem", cols, lo, hi, count)
        _same_lanes(f"lineitem[{lo}:{hi}]", lanes, values)
        step = tpch_device.chunk_rows(count)
        ln = values["l_linenumber"]
        inside = sum(int(ln[e] != 1) for e in range(step, count, step))
        _log(f"[gen] lineitem orders [{lo}, {hi}): {count} rows byte-identical in "
             f"{secs:.3f} s; {inside} of its {(count - 1) // step} chunk edges fall "
             f"inside an order")
        del lanes, values
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the session's statements at SF1


SESSION_SF = 1.0
EXPLAINED = ("Q1", "Q3", "Q6")


def _frames(timeline):
    return [(f["operatorId"], f["operatorType"], f["inputRows"], f["outputRows"])
            for f in timeline["operators"]]


def phase_session(dev):
    """The session's statements on the card at SF1: SET / SHOW SESSION,
    a view over a join against the same query written out, PREPARE /
    EXECUTE ... USING against the literal query (and re-PREPARE), DESCRIBE
    INPUT / OUTPUT, ANALYZE then SHOW STATS against exact counts, EXPLAIN
    ANALYZE of Q1, Q3 and Q6 whose per-operator rows equal a plain run's
    (operator_stats) and the tables' counts, and a result-cache hit that
    returns the same page with no kernel launched."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    qs = _tpch_sql()
    s = _card_session(tpch_session, SESSION_SF)

    def rows(sql):
        return s.execute(sql).to_pylist()

    rows("set session double_buffer_depth = 2")
    rows("set session tpch.rows_per_split = 4096")
    shown = {r[0]: r[1] for r in rows("show session")}
    if (shown["double_buffer_depth"], shown["tpch.rows_per_split"],
            shown["device_generation"], shown["result_cache"]) != ("2", "4096", "True", "False"):
        raise AssertionError(f"SHOW SESSION: {shown}")
    rows("set session double_buffer_depth = 1")
    joined = ("select o_orderkey, c_mktsegment, o_totalprice from orders "
              "join customer on o_custkey = c_custkey")
    rows(f"create view ord_cust as {joined}")
    view_q = ("select c_mktsegment, count(*), sum(o_totalprice) from {} "
              "where o_totalprice > 300000 group by c_mktsegment order by c_mktsegment")
    convert.assert_pages_identical(s.execute(view_q.format(f"({joined})")),
                                   s.execute(view_q.format("ord_cust")))
    if rows("show columns from ord_cust") != [("o_orderkey", "bigint"), (
            "c_mktsegment", "varchar"), ("o_totalprice", "decimal(12,2)")]:
        raise AssertionError(f"view columns {rows('show columns from ord_cust')}")
    rows("drop view ord_cust")
    rows("prepare pq from select count(*), sum(l_extendedprice) from lineitem "
         "where l_quantity < ? and l_shipdate >= ?")
    convert.assert_pages_identical(
        s.execute("select count(*), sum(l_extendedprice) from lineitem "
                  "where l_quantity < 24 and l_shipdate >= date '1995-01-01'"),
        s.execute("execute pq using 24, date '1995-01-01'"))
    if rows("describe input pq") != [(1, "unknown"), (2, "unknown")]:
        raise AssertionError(f"DESCRIBE INPUT {rows('describe input pq')}")
    if rows("describe output pq") != [("count", "bigint"), ("sum", "decimal(38,2)")]:
        raise AssertionError(f"DESCRIBE OUTPUT {rows('describe output pq')}")
    rows("prepare pq from select count(*) from lineitem where l_quantity >= ?")
    n_li = rows("select count(*) from lineitem")[0][0]
    lo = rows("select count(*) from lineitem where l_quantity < 24")[0][0]
    if rows("execute pq using 24") != [(n_li - lo,)]:
        raise AssertionError("EXECUTE after re-PREPARE ran the old statement")
    rows("deallocate prepare pq")
    t0 = time.perf_counter()
    if rows("analyze lineitem (l_partkey, l_shipdate)") != [(n_li,)]:
        raise AssertionError("ANALYZE counted other rows")
    analyze_s = time.perf_counter() - t0
    stats = {r[0]: r for r in rows("show stats for lineitem")}
    exact = rows("select count(distinct l_partkey), min(l_shipdate), "
                 "max(l_shipdate) from lineitem")[0]
    ndv = stats["l_partkey"][1]
    if stats[None][3] != float(n_li) or abs(ndv - exact[0]) > 0.15 * exact[0]:
        raise AssertionError(f"SHOW STATS {stats[None]}, NDV {ndv} vs {exact[0]}")
    _log(f"[session] SET/SHOW SESSION, a view over a join, PREPARE/EXECUTE USING "
         f"(re-PREPARE too), DESCRIBE INPUT/OUTPUT; ANALYZE of lineitem "
         f"({analyze_s:.3f} s): {n_li} rows, l_partkey NDV {ndv:.0f} against "
         f"{exact[0]} exact, l_shipdate {stats['l_shipdate'][4]}..{stats['l_shipdate'][5]}")
    counts = {t: rows(f"select count(*) from {t}")[0][0]
              for t in ("lineitem", "orders", "customer")}
    for q in EXPLAINED:
        kn.reset_counts()
        lines = [r[0] for r in rows("explain analyze " + qs[q])]
        explained = _frames(s.last_timeline)
        launched = dict(kn.LAUNCHES)
        s.properties.set("operator_stats", True)
        page = s.execute(qs[q])
        plain = _frames(s.last_timeline)
        s.properties.set("operator_stats", False)
        if explained != plain:
            raise AssertionError(f"EXPLAIN ANALYZE {q}: {explained} != {plain}")
        convert.assert_pages_identical(page, s.execute(qs[q]))
        scans = sorted(f[3] for f in explained if f[1] == "TableScan")
        want = sorted(counts[t] for t in {"Q1": ["lineitem"], "Q6": ["lineitem"],
                                          "Q3": ["lineitem", "orders", "customer"]}[q])
        if scans and scans != want:
            raise AssertionError(f"EXPLAIN ANALYZE {q}: scan rows {scans} != {want}")
        if explained[0][3] != page.count:
            raise AssertionError(f"EXPLAIN ANALYZE {q}: root rows {explained[0][3]}")
        text = "\n".join(lines)
        for needed in ("Operator timeline", f"Kernel profile ({dev.type}",
                       "bandwidth ledger"):
            if needed not in text:
                raise AssertionError(f"EXPLAIN ANALYZE {q}: no {needed!r} block")
        _log(f"[session] EXPLAIN ANALYZE {q}: {len(explained)} operators, rows equal a "
             f"plain run's; launches {_launched(kn)}; "
             + "; ".join(line.strip() for line in lines
                         if line.strip().startswith(("kernel launches", "run eager"))))
        if not any(launched.values()):
            raise AssertionError(f"EXPLAIN ANALYZE {q} launched no kernel")
    # EXPLAIN ANALYZE runs the session's executor under its properties
    # (here no fusion and scans from the host generator), as execute does
    rows("set session megakernels = 'off'")
    rows("set session device_generation = false")
    counted = ("deviceGeneratedScans", "hostGeneratedScans", "fusedAggregates")
    rows("explain analyze " + qs["Q6"])
    explained = _frames(s.last_timeline)
    eprof = {k: s.last_kernel_profile.get(k, 0) for k in counted}
    s.properties.set("operator_stats", True)
    s.execute(qs["Q6"])
    s.properties.set("operator_stats", False)
    plain = _frames(s.last_timeline)
    pprof = {k: s.last_kernel_profile.get(k, 0) for k in counted}
    if explained != plain or eprof != pprof or pprof["fusedAggregates"]:
        raise AssertionError(f"EXPLAIN ANALYZE Q6 (megakernels off, host generation): "
                             f"{explained} {eprof} != {plain} {pprof}")
    rows("set session megakernels = 'auto'")
    rows("set session device_generation = true")
    _log(f"[session] EXPLAIN ANALYZE Q6 with megakernels off and host generation: "
         f"frames and profile counts equal a plain run's ({pprof})")
    s.properties.set("result_cache", True)
    first = s.execute(qs["Q6"])
    kn.reset_counts()
    t0 = time.perf_counter()
    hit = s.execute(qs["Q6"])
    hit_s = time.perf_counter() - t0
    convert.assert_pages_identical(first, hit)
    rc = s.caches.result_cache
    if rc.hits != 1 or any(kn.LAUNCHES.values()) or s.last_kernel_profile is not None:
        raise AssertionError(f"result cache: hits {rc.hits}, launches {kn.LAUNCHES}")
    s.execute("set session result_cache = false")
    _log(f"[session] result cache: Q6 answered from the cache in {hit_s * 1e3:.3f} ms, "
         f"the same page, no kernel launched ({rc.stats()})")
    del s


# ---------------------------------------------------------------------------
# phase 7: kernel timings at the main path's shapes


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


# ---------------------------------------------------------------------------
# phase 7c: the mesh (distributed = true) over 8 logical shards on the card


MESH_SHARDS = 8
MESH_WARM = 2                # warm runs of each statement after the cold one
MESH_FLOAT_RTOL = 1e-12      # a float64 column merged across shards (none here)
MESH_DISTINCT_SQL = ("select o_orderpriority, count(distinct o_custkey) from orders "
                     "group by o_orderpriority order by o_orderpriority")
MESH_APPROX_SQL = "select approx_distinct(o_custkey) from orders"
MESH_HLL_SQL = ("select o_orderpriority, approx_distinct(o_custkey) from orders "
                "group by o_orderpriority order by o_orderpriority")
# statement -> (SQL key or text, session properties, kernels a run must
# launch at least this often, collectives a run must make)
MESH_STATEMENTS = {
    "Q6": ("Q6", {"megakernels": "auto"}, {"fused_agg_sums": MESH_SHARDS},
           ("all_gather",)),
    "Q1": ("Q1", {"megakernels": "off"},
           {"grouped_count": MESH_SHARDS, "grouped_sum_i64": MESH_SHARDS}, ("psum",)),
    # the session names each Q3's join distribution: the cost-based
    # planner's own choice moves with the scale, and a threshold of one
    # row alone leaves its broadcast plan (the JAX package's too)
    "Q3": ("Q3", {"megakernels": "auto", "join_distribution_type": "broadcast"},
           {"direct_probe": 2 * MESH_SHARDS}, ("all_gather",)),
    "Q3-PART": ("Q3", {"megakernels": "auto", "broadcast_join_threshold_rows": 1,
                       "join_distribution_type": "partitioned"},
                {"direct_probe": 2 * MESH_SHARDS}, ("all_to_all",)),
    "DISTINCT": (MESH_DISTINCT_SQL, {}, {}, ("all_to_all",)),
    "APPROX": (MESH_APPROX_SQL, {}, {}, ("all_gather",)),
    "APPROX-HLL": (MESH_HLL_SQL, {}, {}, ("pmax",)),
}
MESH_DEFAULTS = {"megakernels": "auto", "broadcast_join_threshold_rows": 1 << 20,
                 "join_distribution_type": "automatic"}


def _set_session(s, props):
    """SET SESSION of each property (a planner property must clear the
    session's cached plans, which SET SESSION does)."""
    for k, v in props.items():
        s.execute(f"set session {k} = " + (f"'{v}'" if isinstance(v, str) else str(v)))


def _mesh_reference_pages(qs):
    """Each statement's page on one device at the same scale: the main
    path's pages where that phase ran, the rest in its session (or in a
    session of its own with --phase mesh)."""
    from trino_tpu_torch.session import tpch_session

    s = MAIN.get("session") or _card_session(tpch_session, MAIN_SF)
    done = MAIN.get("pages", {})
    pages = {}
    for label, (sql, props, _k, _c) in MESH_STATEMENTS.items():
        mode = props.get("megakernels", "auto")
        base = "Q3" if label == "Q3-PART" else label
        if (base, mode) in done:
            pages[label] = done[(base, mode)]
            continue
        _set_session(s, {**MESH_DEFAULTS, **props})
        pages[label] = s.execute(qs.get(sql, sql))
    _set_session(s, MESH_DEFAULTS)
    return pages


def _mesh_fault(qs, want_page):
    """A seeded device_loss at the first mesh step of Q6: the mesh shrinks
    from 8 shards to 7, MESH_SHRINK is journaled, the doctor lists
    mesh_shrink after device_fault, every launch is on the card (the
    port has no CPU re-run), the page is the one-device page; then the
    canary restores the shard and Q6 runs on all 8 again."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.parallel import collectives
    from trino_tpu_torch.session import tpch_session

    backoff = 0.5
    spec = json.dumps({"device_loss": {"nth": 1, "match": "mesh:"}})
    s = _card_session(tpch_session, MAIN_SF, distributed=True, num_devices=MESH_SHARDS,
                      fault_injection=spec, device_probe_backoff_s=backoff,
                      query_doctor=True)
    sup = s.device_supervisor
    kn.reset_counts()
    collectives.reset_calls()
    t0 = time.perf_counter()
    page = s.execute(qs["Q6"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = s.last_kernel_profile
    if prof.get("meshShrinks", 0) < 1 or prof["mesh"]["shards"] != MESH_SHARDS - 1:
        raise AssertionError(f"the mesh did not shrink to {MESH_SHARDS - 1}: "
                             f"{prof.get('meshShrinks')}, {prof.get('mesh')}")
    if sup.device_state(device_id=0) != "QUARANTINED":
        raise AssertionError(f"shard 0 is {sup.device_state(device_id=0)}")
    if kn.LAUNCHES["fused_agg_sums"] != 2 * MESH_SHARDS - 1:
        raise AssertionError(f"fused_agg_sums launched {kn.LAUNCHES['fused_agg_sums']} "
                             f"times, want {MESH_SHARDS} + {MESH_SHARDS - 1} on the card")
    evs = [e for e in journal.get_journal().tail(500)
           if e.get("eventType") == journal.MESH_SHRINK]
    detail = (evs[-1].get("detail") or {}) if evs else {}
    if (detail.get("fromSize"), detail.get("toSize")) != (MESH_SHARDS, MESH_SHARDS - 1):
        raise AssertionError(f"MESH_SHRINK {detail}")
    codes = [f.get("code") for f in (s.last_diagnosis or {}).get("findings", ())]
    if not ("device_fault" in codes and "mesh_shrink" in codes
            and codes.index("device_fault") < codes.index("mesh_shrink")):
        raise AssertionError(f"the doctor's findings {codes}")
    convert.assert_pages_identical(want_page, page)
    _log(f"[mesh] fault: device_loss at the first mesh step of Q6 -> shrank "
         f"{MESH_SHARDS} -> {MESH_SHARDS - 1} shards in {wall:.3f} s (cold), shard 0 "
         f"QUARANTINED, MESH_SHRINK {detail}, doctor {codes}, launches {_launched(kn)} "
         f"(all on the card), page equal to the one-device page")
    _recover(s, backoff)
    page = s.execute(qs["Q6"])
    torch.cuda.synchronize()
    if sup.device_state(device_id=0) != "ACTIVE" or \
            s.last_kernel_profile["mesh"]["shards"] != MESH_SHARDS:
        raise AssertionError("the canary did not restore shard 0")
    convert.assert_pages_identical(want_page, page)
    _log(f"[mesh] fault: the canary restored shard 0; Q6 over {MESH_SHARDS} shards again, "
         f"the same page")
    SUPERVISED.remove(sup)  # it faulted on purpose


def phase_mesh(dev, do_profile=False):
    """The mesh at SF10: 8 logical shards on the card, each statement cold
    once and warm MESH_WARM times, against the one-device pages."""
    import gc

    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.parallel import collectives
    from trino_tpu_torch.session import tpch_session

    qs = _tpch_sql()
    sf = MAIN_SF
    t_ref = time.perf_counter()
    want = _mesh_reference_pages(qs)
    _log(f"[mesh] one-device reference pages in {time.perf_counter() - t_ref:.1f} s")
    s = _card_session(tpch_session, sf, distributed=True, num_devices=MESH_SHARDS)
    # the grouped approx_distinct merges HLL registers, where one device
    # counts exactly: its reference is the sketch over every row, a mesh
    # of one shard (the register max of a union is the union's registers),
    # and the exact count bounds it
    exact = want["APPROX-HLL"].to_pylist()
    _set_session(s, {"num_devices": 1})
    want["APPROX-HLL"] = s.execute(MESH_HLL_SQL)
    _set_session(s, {"num_devices": MESH_SHARDS})
    for (k, est), (k2, n) in zip(want["APPROX-HLL"].to_pylist(), exact):
        if k != k2 or abs(est - n) > max(0.2 * n, 4):
            raise AssertionError(f"HLL estimate {k} {est} against the exact {k2} {n}")
    cold, gen = {}, {}
    for label, (sql, props, _k, _c) in MESH_STATEMENTS.items():
        _set_session(s, {**MESH_DEFAULTS, **props})
        t0 = time.perf_counter()
        page = s.execute(qs.get(sql, sql))
        torch.cuda.synchronize()
        cold[label] = time.perf_counter() - t0
        convert.assert_pages_match(want[label], page, rtol=MESH_FLOAT_RTOL)
        prof = s.last_kernel_profile
        gen[label] = (prof.get("deviceGeneratedScans", 0), prof.get("hostGeneratedScans", 0))
    walls = {q: [] for q in MESH_STATEMENTS}
    splits, peaks, calls = {}, {}, {}
    per_run = {q: dict.fromkeys(KERNEL_FNS, 0) for q in MESH_STATEMENTS}
    kn.reset_counts()  # the mesh path starts here
    for label, (sql, props, want_k, want_c) in MESH_STATEMENTS.items():
        _set_session(s, {**MESH_DEFAULTS, **props})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_calls()
        for _ in range(MESH_WARM):
            before = dict(kn.LAUNCHES)
            t0 = time.perf_counter()
            page = s.execute(qs.get(sql, sql))
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            for name in KERNEL_FNS:
                per_run[label][name] += kn.LAUNCHES[name] - before[name]
            convert.assert_pages_match(want[label], page, rtol=MESH_FLOAT_RTOL)
        peaks[label] = torch.cuda.max_memory_allocated()
        splits[label] = dict(s.last_kernel_profile["mesh"])
        calls[label] = {k: v for k, v in collectives.CALLS.items() if v}
        for name, per in want_k.items():
            if per_run[label][name] < per * MESH_WARM:
                raise AssertionError(f"mesh {label}: {name} launched "
                                     f"{per_run[label][name]} times in {MESH_WARM} runs, "
                                     f"want >= {per} a run")
        for kind in want_c:
            if not calls[label].get(kind):
                raise AssertionError(f"mesh {label}: no {kind} ({calls[label]})")
        if label == "Q3" and calls[label].get("all_to_all"):
            raise AssertionError(f"mesh Q3 repartitioned its broadcast joins: {calls[label]}")
    launches = dict(kn.LAUNCHES)  # ... and ends here
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the mesh path")
    MAIN["mesh_launches"] = launches
    _log(f"[mesh] mesh path launches over {MESH_WARM} warm runs of each statement: "
         f"{launches}")
    for label in MESH_STATEMENTS:
        w = walls[label]
        sp = splits[label]
        _log(f"[mesh] {label}: cold {cold[label]:.3f} s, warm median "
             f"{statistics.median(w) * 1e3:.3f} ms (all: "
             f"{', '.join(f'{x * 1e3:.3f}' for x in w)}); last warm run's host split: "
             f"shard load {sp['loadS'] * 1e3:.3f} ms, per-shard operators "
             f"{sp['shardOpsS'] * 1e3:.3f} ms, exchanges and replicated operators "
             f"{sp['exchangeS'] * 1e3:.3f} ms, checks and output copy "
             f"{sp['syncS'] * 1e3:.3f} ms; peak device memory "
             f"{peaks[label] / 2**30:.2f} GiB; launches {per_run[label]}; "
             f"collectives {calls[label]}; page equal to the one-device page")
    _log(f"[mesh] the cold runs' shard scans (generated on the card, on the host): {gen}")
    if do_profile:
        for label, (sql, props, _k, _c) in MESH_STATEMENTS.items():
            _set_session(s, {**MESH_DEFAULTS, **props})
            _profile(s, qs.get(sql, sql), f"mesh {label}")
    _mesh_fault(qs, want["Q6"])
    del s
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7d: the server path: a coordinator and workers on the card, TPC-H
# SF10 through the statement protocol's client


SERVER_WORKERS = 2           # in-process workers (each gets half the card's pool)
SERVER_WARM = 2              # warm runs of each statement after the cold one
SERVER_SELECT_SQL = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
                     "o_orderdate from orders where o_orderkey < 1000000 "
                     "order by o_orderkey")
SERVER_SELECT_MIN_ROWS = 200_000
# statement -> (SQL key or text, session properties, kernels its tasks must
# launch at least this often a run, summed over the workers' tasks)
SERVER_STATEMENTS = {
    "Q6": ("Q6", {"megakernels": "auto"}, {"fused_agg_sums": SERVER_WORKERS}),
    "Q1": ("Q1", {"megakernels": "off"},
           {"grouped_count": SERVER_WORKERS, "grouped_sum_i64": SERVER_WORKERS}),
    "Q3": ("Q3", {"megakernels": "auto", "join_distribution_type": "broadcast"},
           {"direct_probe": SERVER_WORKERS}),
    "Q3-PART": ("Q3", {"megakernels": "auto", "join_distribution_type": "partitioned"},
                {"direct_probe": SERVER_WORKERS}),
    "DISTINCT": (MESH_DISTINCT_SQL, {}, {}),
    "SELECT": (SERVER_SELECT_SQL, {}, {}),
}
SERVER_DEFAULTS = {"megakernels": "auto", "join_distribution_type": "automatic"}


def _server_reference_pages(qs):
    """Each statement's page on one device: the main path's pages where
    that phase ran, the rest in its session (or in a session of its own
    with --phase server)."""
    from trino_tpu_torch.session import tpch_session

    s = MAIN.get("session") or _card_session(tpch_session, MAIN_SF)
    done = MAIN.get("pages", {})
    pages = {}
    for label, (sql, props, _k) in SERVER_STATEMENTS.items():
        mode = props.get("megakernels", "auto")
        base = "Q3" if label == "Q3-PART" else label
        if (base, mode) in done:
            pages[label] = done[(base, mode)]
            continue
        _set_session(s, {**SERVER_DEFAULTS, **props})
        pages[label] = s.execute(qs.get(sql, sql))
    _set_session(s, SERVER_DEFAULTS)
    return pages


def _last_query(co):
    return max(co.queries.values(), key=lambda q: q.created)


def _built_libraries():
    """Each kernel library in the build directory, by name, with its
    modification time: a library rebuilt or newly built under another
    name changes it."""
    from trino_tpu_torch.ops import kernels as kn

    return {f: os.path.getmtime(os.path.join(kn.build_dir(), f))
            for f in os.listdir(kn.build_dir()) if f.endswith(".so")}


def _server_run(runner, sql, want_page):
    """One statement through the client: its wall on the client's clock,
    the coordinator's query (its page held exactly to the one-device page,
    the client's JSON rows to that page's protocol rows) and the host
    split and launches of its tasks."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.server import protocol

    co = runner.coordinator.coordinator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _cols, rows = runner.execute(sql)
    wall = time.perf_counter() - t0
    q = _last_query(co)
    if q.state != "FINISHED" or q.sql != sql:
        raise AssertionError(f"server: {q.state} {q.error} for {sql[:60]}")
    convert.assert_pages_identical(want_page, q.page)
    if rows != json.loads(json.dumps(protocol.data_json(want_page))):
        raise AssertionError(f"server: the client's rows differ from the one-device "
                             f"page's protocol rows: {sql[:60]}")
    tasks = q.task_stats
    launches = dict.fromkeys(KERNEL_FNS, 0)
    for t in tasks:
        for k, n in (t.get("kernelLaunches") or {}).items():
            launches[k] += n
        prof = t.get("kernelProfile") or {}
        if prof.get("outOfCore") or prof.get("forcedStreaming"):
            raise AssertionError(f"server: task {t['taskId']} left the in-memory "
                                 f"path ({prof.get('outOfCore')})")
    tm = q.sched_timings
    split = {
        "planS": q.plan_s,
        "scheduleS": tm.get("scheduleS", 0.0),
        "fragmentExecuteS": sum(t.get("wallMillis", 0) for t in tasks) / 1e3,
        "blockedExchangeS": sum(t.get("blockedExchangeS", 0.0) for t in tasks),
        "serializeS": sum(t.get("serializeS", 0.0) + t.get("partitionS", 0.0)
                          for t in tasks),
        "deserializeS": sum(t.get("deserializeS", 0.0) for t in tasks)
        + tm.get("rootDeserializeS", 0.0),
        "rootFetchS": tm.get("rootFetchS", 0.0),
        "exchangeBytes": sum(t.get("exchangeBytes", 0) for t in tasks)
        + tm.get("rootBytes", 0),
    }
    return wall, rows, tasks, launches, split


def _fmt_split(sp):
    return (f"plan {sp['planS'] * 1e3:.1f} ms, schedule {sp['scheduleS'] * 1e3:.1f} ms, "
            f"fragment_execute {sp['fragmentExecuteS'] * 1e3:.1f} ms (summed over "
            f"tasks), blocked_exchange_s {sp['blockedExchangeS'] * 1e3:.1f} ms, "
            f"partition+serialize {sp['serializeS'] * 1e3:.1f} ms, deserialize "
            f"{sp['deserializeS'] * 1e3:.1f} ms, root fetch {sp['rootFetchS'] * 1e3:.1f} "
            f"ms; exchange bytes {sp['exchangeBytes']}")


def phase_server(dev):
    """The server path at SF10: a coordinator and SERVER_WORKERS in-process
    workers on the card, every statement through the StatementClient cold
    once and warm SERVER_WARM times, each page held to the one-device
    page; then a worker_main subprocess worker joins (Q6 over three
    workers), and an in-process worker stops and discovery drops it (Q6
    over the rest)."""
    import gc

    from trino_tpu_torch.memory import detect_device_bytes
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.testing import DistributedQueryRunner

    qs = _tpch_sql()
    t_ref = time.perf_counter()
    want = _server_reference_pages(qs)
    _log(f"[server] one-device reference pages in {time.perf_counter() - t_ref:.1f} s")
    _serialize_device_page(want["SELECT"], dev)
    libs = _built_libraries()
    card = detect_device_bytes(device=dev)
    t0 = time.perf_counter()
    runner = DistributedQueryRunner(
        workers=SERVER_WORKERS,
        catalogs=(("tpch", "tpch", {"tpch.scale-factor": MAIN_SF}),),
        # every task stays in memory within its worker's share of the card;
        # repeats must run, not come from the result cache
        properties={"result_cache": False,
                    "query_max_memory_bytes": card // SERVER_WORKERS},
        startup_timeout=60.0, device=dev,
    )
    _log(f"[server] coordinator and {SERVER_WORKERS} workers up in "
         f"{time.perf_counter() - t0:.2f} s; each worker's device pool "
         f"{runner.worker_device_bytes} bytes of the card's {card}")
    try:
        select_rows = None
        kn.reset_counts()  # the server path starts here
        per_task_launches = dict.fromkeys(KERNEL_FNS, 0)
        for label, (sql, props, want_k) in SERVER_STATEMENTS.items():
            for k, v in {**SERVER_DEFAULTS, **props}.items():
                runner.execute(f"set session {k} = '{v}'")
            text = qs.get(sql, sql)
            cold, _rows, _tasks, cold_launch, cold_split = _server_run(
                runner, text, want[label])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls, per_run = [], dict.fromkeys(KERNEL_FNS, 0)
            for _ in range(SERVER_WARM):
                wall, rows, tasks, launches, split = _server_run(
                    runner, text, want[label])
                walls.append(wall)
                for k, n in launches.items():
                    per_run[k] += n
            peak = torch.cuda.max_memory_allocated()
            MAIN.setdefault("server_splits", {})[label] = split
            MAIN.setdefault("server_walls", {})[label] = statistics.median(walls)
            for k, n in cold_launch.items():
                per_task_launches[k] += n
            for k, n in per_run.items():
                per_task_launches[k] += n
            for name, per in want_k.items():
                if per_run[name] < per * SERVER_WARM:
                    raise AssertionError(f"server {label}: {name} launched "
                                         f"{per_run[name]} times in {SERVER_WARM} runs' "
                                         f"tasks, want >= {per} a run")
            if label == "SELECT":
                select_rows = len(rows)
                if select_rows < SERVER_SELECT_MIN_ROWS:
                    raise AssertionError(f"the selection returned {select_rows} rows")
            _log(f"[server] {label}: cold {cold:.3f} s ({_fmt_split(cold_split)}); "
                 f"warm median {statistics.median(walls) * 1e3:.3f} ms (all: "
                 f"{', '.join(f'{x * 1e3:.3f}' for x in walls)}) on the client's clock; "
                 f"last warm run: {len(tasks)} tasks, {_fmt_split(split)}; launches "
                 f"over {SERVER_WARM} warm runs' tasks {per_run}; peak device memory "
                 f"{peak / 2**30:.2f} GiB; {len(rows)} rows, page equal to the "
                 f"one-device page, client rows equal to its protocol rows")
        launches = dict(kn.LAUNCHES)  # ... and ends here (in-process workers)
        for name in KERNEL_FNS:
            if launches[name] == 0 or per_task_launches[name] == 0:
                raise AssertionError(f"{name} never launched on the server path "
                                     f"({launches}, tasks {per_task_launches})")
        MAIN["server_launches"] = launches
        _log(f"[server] server path launches in this process: {launches}; summed "
             f"over the tasks' profiles: {per_task_launches}; the selection paged "
             f"{select_rows} rows under client_page_rows 10000")
        _server_changes(runner, qs, want["Q6"], card)
        for w in runner.workers:
            if w.supervisor.device_state() != "ACTIVE" or w.supervisor.faults():
                raise AssertionError(f"worker {w.node_id}: {w.supervisor.snapshot()}")
        _server_fault(runner, qs, want["Q6"])
    finally:
        runner.stop()
    now = _built_libraries()
    if now != libs:
        raise AssertionError(f"a worker rebuilt the kernel libraries: {libs} -> {now}")
    _log(f"[server] the subprocess worker loaded the {len(libs)} built libraries "
         f"(none rebuilt)")
    del runner
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _serialize_device_page(host, dev):
    """A page whose lanes lie on the card serializes to the host page's
    frame with one device-to-host copy (every lane packed first)."""
    from trino_tpu_torch.page import Column, Page
    from trino_tpu_torch.serde import serialize_page

    def lane(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    page = Page([Column(c.type, lane(c.values), lane(c.validity), c.dictionary)
                 for c in host.columns], host.count, host.names)
    copies = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(self.numel() * self.element_size())
        return real(self, *a, **k)

    torch.cuda.synchronize()
    torch.Tensor.cpu = counted
    try:
        t0 = time.perf_counter()
        frame = serialize_page(page)
        wall = time.perf_counter() - t0
    finally:
        torch.Tensor.cpu = real
    if frame != serialize_page(host) or len(copies) != 1:
        raise AssertionError(f"serialize_page of a device page: {len(copies)} copies, "
                             f"frame equal {frame == serialize_page(host)}")
    _log(f"[server] serialize_page of a {host.count}-row device page: one "
         f"device-to-host copy of {copies[0]} bytes, {len(frame)}-byte frame equal to "
         f"the host page's, {wall * 1e3:.1f} ms")


def _worker_info(uri, what="info"):
    import urllib.request

    with urllib.request.urlopen(f"{uri}/v1/{what}", timeout=5.0) as r:
        return json.loads(r.read())


def _server_fault(runner, qs, want_q6):
    """A seeded device_loss at each worker's first fused launch: Q6 fails
    with DeviceFaultError in the client's error (no worker re-runs it on
    the CPU) and the faulted workers announce QUARANTINED; the spec spent,
    each worker's announce loop runs the canary, every worker returns to
    ACTIVE in discovery's view and Q6 answers the one-device page again."""
    from trino_tpu_torch.client.client import ClientError

    nm = runner.coordinator.coordinator.node_manager
    uris = [w.uri for w in runner.workers] + [e[2] for e in runner.subprocess_workers]
    spec = json.dumps({"device_loss": {"nth": 1, "match": "fused_agg_sums"}})
    runner.execute("set session device_probe_backoff_s = 0.5")
    runner.execute(f"set session fault_injection = '{spec}'")
    t0 = time.perf_counter()
    try:
        runner.execute(qs["Q6"])
    except ClientError as e:
        err = str(e)
    else:
        raise AssertionError("Q6 under a seeded device loss on the workers answered")
    failed = time.perf_counter() - t0
    if "DeviceFaultError" not in err:
        raise AssertionError(f"Q6's error names no DeviceFaultError: {err[:300]}")
    states = {u: _worker_info(u)["state"] for u in uris}
    out = [u for u, st in states.items() if st == "QUARANTINED"]
    if not out:
        raise AssertionError(f"no worker quarantined after the loss: {states}")
    runner.execute("set session fault_injection = ''")
    t1 = time.perf_counter()
    deadline = time.time() + 30.0
    while time.time() < deadline and not (
            all(_worker_info(u)["state"] == "ACTIVE" for u in uris)
            and all((nm.device_states().get(n) or {}).get("state", "ACTIVE") == "ACTIVE"
                    for n, _u in nm.alive())):
        time.sleep(0.1)
    back = {u: _worker_info(u)["state"] for u in uris}
    if any(st != "ACTIVE" for st in back.values()):
        raise AssertionError(f"the canary did not restore the workers: {back}")
    recovered = time.perf_counter() - t1
    wall, _rows, tasks, launches, _split = _server_run(runner, qs["Q6"], want_q6)
    _log(f"[server] fault: device_loss at each worker's first fused launch -> Q6 failed "
         f"in {failed:.3f} s with DeviceFaultError in the client's error; "
         f"{len(out)} of {len(uris)} workers QUARANTINED; the canary restored them in "
         f"{recovered:.2f} s; Q6 over {len({t['uri'] for t in tasks})} workers "
         f"{wall * 1e3:.3f} ms, launches {launches}, page equal to the one-device page")
    runner.execute("set session device_probe_backoff_s = 1.0")


def _server_changes(runner, qs, want_q6, card):
    """A worker_main subprocess worker joins on the card (Q6 over three
    workers, its tasks' launches counted from their profiles); then an
    in-process worker stops, discovery drops it, and Q6 runs over the
    rest."""
    co = runner.coordinator.coordinator
    nm = co.node_manager
    t0 = time.perf_counter()
    _proc, node_id, uri = runner.add_subprocess_worker(
        startup_timeout=120.0, device_memory_bytes=card // (SERVER_WORKERS + 1))
    _log(f"[server] subprocess worker {node_id} announced in "
         f"{time.perf_counter() - t0:.1f} s")
    runner.execute("set session megakernels = 'auto'")
    for run in ("cold", "warm"):
        wall, _rows, tasks, launches, split = _server_run(runner, qs["Q6"], want_q6)
        on = {}
        for t in tasks:
            on.setdefault(t["uri"], {})
            for k, n in (t.get("kernelLaunches") or {}).items():
                on[t["uri"]][k] = on[t["uri"]].get(k, 0) + n
        if len(on) != SERVER_WORKERS + 1 or not on[uri].get("fused_agg_sums"):
            raise AssertionError(f"Q6 over three workers: launches by worker {on}")
        _log(f"[server] Q6 over {len(on)} workers ({run}): {wall * 1e3:.3f} ms; the "
             f"subprocess worker's tasks launched {on[uri]}; {_fmt_split(split)}; "
             f"page equal to the one-device page")
    gone = runner.workers[0]
    t0 = time.perf_counter()
    runner.kill_worker(0)
    deadline = time.time() + 60.0
    while time.time() < deadline and any(n == gone.node_id for n, _ in nm.alive()):
        time.sleep(0.05)
    if any(n == gone.node_id for n, _ in nm.alive()):
        raise AssertionError("discovery never dropped the stopped worker")
    dropped = time.perf_counter() - t0
    wall, _rows, tasks, launches, split = _server_run(runner, qs["Q6"], want_q6)
    uris = {t["uri"] for t in tasks}
    if gone.uri in uris or len(uris) != SERVER_WORKERS:
        raise AssertionError(f"Q6 after the drop ran on {uris}")
    _log(f"[server] worker {gone.node_id} stopped; discovery dropped it after "
         f"{dropped:.2f} s; Q6 over the other {len(uris)} workers: {wall * 1e3:.3f} ms, "
         f"launches {launches}, page equal to the one-device page")


# ---------------------------------------------------------------------------
# phase 7e: fault-tolerant execution on the card: retry_policy = task over
# the spooled exchange, seeded faults, whole-query retries, a coordinator
# killed with -9 and resumed, the autoscaler, the serving observatory


# statement -> (SERVER_STATEMENTS key, kernels its tasks must launch at
# least this often a run, summed over the workers' tasks)
FTE_STATEMENTS = {
    "Q6": ("Q6", {"fused_agg_sums": SERVER_WORKERS}),
    "Q1": ("Q1", {"grouped_count": SERVER_WORKERS, "grouped_sum_i64": SERVER_WORKERS}),
    "Q3-PART": ("Q3-PART", {"direct_probe": SERVER_WORKERS}),
    "DISTINCT": ("DISTINCT", {}),
}
FTE_STALL_S = 5.0            # the seeded straggler's sleep
AUTOSCALE_SF = 1.0           # the autoscaler's Q6 (its subject is the control loop)
AUTOSCALE_CLIENTS = 6        # closed-loop sessions while the backlog builds


def _fte_spool(q):
    """A finished FTE query's spool traffic from its tasks' stats and the
    root read: bytes written and read, and the seconds of the spool
    write, the spool read (file read and decode) and the decode alone."""
    tasks, tm = q.task_stats, q.sched_timings
    return {
        "writeBytes": sum(t.get("spoolWriteBytes", 0) for t in tasks),
        "readBytes": sum(t.get("spoolReadBytes", 0) for t in tasks)
        + tm.get("rootBytes", 0),
        "writeS": sum(t.get("spoolWriteS", 0.0) for t in tasks),
        "readS": sum(t.get("spoolReadS", 0.0) for t in tasks) + tm.get("rootFetchS", 0.0),
        "deserializeS": sum(t.get("deserializeS", 0.0) for t in tasks)
        + tm.get("rootDeserializeS", 0.0),
    }


def _fmt_spool(sp, server):
    out = (f"spool written {sp['writeBytes']} bytes in {sp['writeS'] * 1e3:.1f} ms "
           f"(spool_write), read {sp['readBytes']} bytes in {sp['readS'] * 1e3:.1f} ms "
           f"(spool_read), deserialize {sp['deserializeS'] * 1e3:.1f} ms")
    if server is None:
        return out + "; server: not measured in this call"
    return (out + f"; server (HTTP): exchange bytes {server['exchangeBytes']}, "
            f"partition+serialize {server['serializeS'] * 1e3:.1f} ms, deserialize "
            f"{server['deserializeS'] * 1e3:.1f} ms")


def _journal_events(kind, query_id):
    from trino_tpu_torch.obs import journal

    return [e for e in journal.get_journal().tail()
            if e["eventType"] == kind and e.get("queryId") == query_id]


def phase_fte(dev, profile=False):
    """Fault-tolerant execution at SF10: a coordinator and SERVER_WORKERS
    in-process workers on the card under retry_policy = task, each
    statement cold once and warm twice through the StatementClient with
    its stage outputs spooled to disk, pages held to the one-device
    pages; then seeded faults (a device loss, a corrupt spool, a
    straggler), retry_policy = query with a worker stopped mid-Q3, a
    subprocess coordinator killed with -9 mid-Q3 and resumed, the
    autoscaler and the signature census over SQL.  With ``profile``, a
    breakdown of Q3 partitioned's spool read (_fte_spool_breakdown)."""
    import gc

    from trino_tpu_torch.memory import detect_device_bytes
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.testing import DistributedQueryRunner

    qs = _tpch_sql()
    t_ref = time.perf_counter()
    want = _server_reference_pages(qs)
    _log(f"[fte] one-device reference pages in {time.perf_counter() - t_ref:.1f} s")
    libs = _built_libraries()
    card = detect_device_bytes(device=dev)
    t0 = time.perf_counter()
    runner = DistributedQueryRunner(
        workers=SERVER_WORKERS,
        catalogs=(("tpch", "tpch", {"tpch.scale-factor": MAIN_SF}),),
        properties={"result_cache": False, "retry_policy": "task",
                    "query_max_memory_bytes": card // SERVER_WORKERS},
        startup_timeout=60.0, device=dev,
    )
    _log(f"[fte] coordinator and {SERVER_WORKERS} workers up in "
         f"{time.perf_counter() - t0:.2f} s under retry_policy = task; each worker's "
         f"device pool {runner.worker_device_bytes} bytes of the card's {card}")
    co = runner.coordinator.coordinator
    signatures = {}
    try:
        kn.reset_counts()  # the fte path starts here
        per_task = dict.fromkeys(KERNEL_FNS, 0)
        for label, (key, want_k) in FTE_STATEMENTS.items():
            sql, props, _k = SERVER_STATEMENTS[key]
            for k, v in {**SERVER_DEFAULTS, **props}.items():
                runner.execute(f"set session {k} = '{v}'")
            text = qs.get(sql, sql)
            cold, _rows, _tasks, cold_launch, _split = _server_run(runner, text, want[key])
            cold_spool = _fte_spool(_last_query(co))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls, per_run = [], dict.fromkeys(KERNEL_FNS, 0)
            for _ in range(SERVER_WARM):
                wall, rows, tasks, launches, split = _server_run(runner, text, want[key])
                walls.append(wall)
                for k, n in launches.items():
                    per_run[k] += n
            peak = torch.cuda.max_memory_allocated()
            q = _last_query(co)
            signatures[label] = q.plan_signature
            spool = _fte_spool(q)
            for k in KERNEL_FNS:
                per_task[k] += cold_launch[k] + per_run[k]
            for name, per in want_k.items():
                if per_run[name] < per * SERVER_WARM:
                    raise AssertionError(f"fte {label}: {name} launched {per_run[name]} "
                                         f"times in {SERVER_WARM} runs' tasks")
            if not spool["writeBytes"] or not spool["readBytes"]:
                raise AssertionError(f"fte {label}: no spool traffic {spool}")
            server = MAIN.get("server_splits", {}).get(key)
            server_wall = MAIN.get("server_walls", {}).get(key)
            _log(f"[fte] {label}: cold {cold:.3f} s (spool written "
                 f"{cold_spool['writeBytes']} bytes); warm median "
                 f"{statistics.median(walls) * 1e3:.3f} ms (all: "
                 f"{', '.join(f'{x * 1e3:.3f}' for x in walls)}; server warm median "
                 + ("not measured in this call" if server_wall is None
                    else f"{server_wall * 1e3:.3f} ms")
                 + f") on the client's clock; last warm run: {len(tasks)} tasks, "
                 f"{_fmt_split(split)}; {_fmt_spool(spool, server)}; launches over "
                 f"{SERVER_WARM} warm runs' tasks {per_run}; peak device memory "
                 f"{peak / 2**30:.2f} GiB; {len(rows)} rows, page equal to the "
                 f"one-device page")
        launches = dict(kn.LAUNCHES)
        for name in KERNEL_FNS:
            if launches[name] == 0 or per_task[name] == 0:
                raise AssertionError(f"{name} never launched under FTE ({launches}, "
                                     f"tasks {per_task})")
        MAIN["fte_launches"] = launches
        _log(f"[fte] FTE path launches in this process: {launches}; summed over the "
             f"tasks' profiles: {per_task}")
        if profile:
            _fte_spool_breakdown(runner, qs, want)
        _fte_census(runner, qs, want, signatures)
        _fte_faults(runner, qs, want)
    finally:
        runner.stop()
        del runner
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    _fte_recovery(dev, qs, want["Q3"], card)
    _fte_autoscaler(dev, qs, card)
    now = _built_libraries()
    if now != libs:
        raise AssertionError(f"a worker rebuilt the kernel libraries: {libs} -> {now}")
    _log(f"[fte] no process rebuilt the {len(libs)} kernel libraries (no nvcc run)")


def _spool_files(base, query_id):
    """The buffer files of a query's committed spool attempts, with the
    buffer id (the consumer task) each one feeds."""
    out = []
    for d, _dirs, names in os.walk(os.path.join(base, query_id)):
        if "_COMMIT" in names:
            out += [(os.path.join(d, f), int(f[len("buffer_"):-len(".bin")]))
                    for f in sorted(names) if f.startswith("buffer_")]
    return out


def _fte_spool_breakdown(runner, qs, want):
    """Where Q3 partitioned's spool read goes (--profile): one warm run
    whose spool tree is kept, then its committed buffer files read back
    in this process.  First by one thread, split into the file read, the
    copy of each frame out of the file's bytes (what the reader paid
    before it decoded from a view of them), and each frame's CRC, zstd
    decompression and column decode; then by pools of 2 to 64 threads over
    all the files, as the consumers' exchange clients read them together
    at the stage barrier, summing each frame's decode wall as the tasks'
    stats do."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from trino_tpu_torch import serde
    from trino_tpu_torch.exchange import filesystem as fs

    kept = []
    cleanup = fs.FileSystemExchangeManager.cleanup_query
    fs.FileSystemExchangeManager.cleanup_query = lambda self, qid: kept.append((self, qid))
    try:
        sql, props, _k = SERVER_STATEMENTS["Q3-PART"]
        for k, v in {**SERVER_DEFAULTS, **props}.items():
            runner.execute(f"set session {k} = '{v}'")
        wall, _rows, tasks, _launch, _split = _server_run(runner, qs.get(sql, sql),
                                                          want["Q3-PART"])
        q = _last_query(runner.coordinator.coordinator)
        spool = _fte_spool(q)
    finally:
        fs.FileSystemExchangeManager.cleanup_query = cleanup
    try:
        files = [f for mgr, qid in kept for f in _spool_files(mgr.base, qid)]
        consumers = len({b for _p, b in files})
        read_s = copy_s = crc_s = zstd_s = decode_s = 0.0
        nbytes = nframes = 0
        t_all = time.perf_counter()
        for path, _b in files:
            t = time.perf_counter()
            with open(path, "rb") as f:
                data = f.read()
            read_s += time.perf_counter() - t
            mv = memoryview(data)
            (n,) = struct.unpack_from("<I", mv, 0)
            off = 4
            for _ in range(n):
                (ln,) = struct.unpack_from("<I", mv, off)
                off += 4
                fr = mv[off:off + ln]
                t = time.perf_counter()
                bytes(fr)
                copy_s += time.perf_counter() - t
                _n, markers, usize, csize = serde._HEADER_FIELDS.unpack_from(fr, 4)
                body = fr[serde.HEADER_V2:serde.HEADER_V2 + csize]
                t = time.perf_counter()
                zlib.crc32(body)
                crc_s += time.perf_counter() - t
                if markers & serde.MARKER_COMPRESSED:
                    t = time.perf_counter()
                    serde._decompressor().decompress(body, max_output_size=usize)
                    zstd_s += time.perf_counter() - t
                t = time.perf_counter()
                serde.deserialize_page(fr)
                decode_s += time.perf_counter() - t
                off += ln
                nbytes += ln
                nframes += 1
        serial_s = time.perf_counter() - t_all
        _log(f"[fte] spool breakdown, Q3 partitioned (one warm run {wall:.3f} s, "
             f"{len(tasks)} tasks; its tasks' spool_read {spool['readS'] * 1e3:.1f} ms, "
             f"deserialize {spool['deserializeS'] * 1e3:.1f} ms summed): {len(files)} "
             f"committed buffer files for {consumers} consumer buffers, {nframes} frames, "
             f"{nbytes} bytes; read back by one thread in {serial_s * 1e3:.1f} ms: file "
             f"read {read_s * 1e3:.1f} ms, a copy of every frame {copy_s * 1e3:.1f} ms, "
             f"CRC {crc_s * 1e3:.1f} ms, zstd {zstd_s * 1e3:.1f} ms, deserialize_page "
             f"(CRC, zstd and the column decode) {decode_s * 1e3:.1f} ms; "
             f"{len(os.sched_getaffinity(0))} host cores")
        for threads in (2, 4, 8, 16, 32, 64):
            stats = []

            def read(path):
                st = {"bytes": 0, "deserializeS": 0.0}
                stats.append(st)
                t = time.perf_counter()
                fs.read_spool_pages(path, stats=st)
                st["readS"] = time.perf_counter() - t

            t = time.perf_counter()
            with ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(read, [p for p, _b in files]))
            elapsed = time.perf_counter() - t
            _log(f"[fte] spool breakdown, {threads} threads over the {len(files)} files: "
                 f"{elapsed * 1e3:.1f} ms elapsed; summed over the reads: spool_read "
                 f"{sum(st['readS'] for st in stats) * 1e3:.1f} ms, deserialize "
                 f"{sum(st['deserializeS'] for st in stats) * 1e3:.1f} ms")
    finally:
        for mgr, qid in kept:
            cleanup(mgr, qid)


def _fte_census(runner, qs, want, signatures):
    """One instrumented warm run of each statement (operator_stats: the
    frames carry device walls), then system.runtime.plan_signatures over
    SQL: one row for each of the phase's signatures, device_wall_s > 0."""
    runner.execute("set session operator_stats = true")
    try:
        for label, (key, _k) in FTE_STATEMENTS.items():
            sql, props, _k2 = SERVER_STATEMENTS[key]
            for k, v in {**SERVER_DEFAULTS, **props}.items():
                runner.execute(f"set session {k} = '{v}'")
            _server_run(runner, qs.get(sql, sql), want[key])
    finally:
        runner.execute("set session operator_stats = false")
    _cols, rows = runner.execute(
        "select signature, count, device_wall_s, host_wall_s, p50_s "
        "from system.runtime.plan_signatures")
    by_sig = {r[0]: r for r in rows}
    for label, sig in signatures.items():
        r = by_sig.get(sig)
        if r is None or not r[2] > 0:
            raise AssertionError(f"plan_signatures: {label} ({sig}) -> {r}; rows {rows}")
    _log("[fte] system.runtime.plan_signatures: " + "; ".join(
        f"{label} count {by_sig[sig][1]}, device_wall_s {by_sig[sig][2]:.4f}, "
        f"host_wall_s {by_sig[sig][3]:.4f}, p50 {by_sig[sig][4]:.3f} s"
        for label, sig in signatures.items()))


def _fte_faults(runner, qs, want):
    """Seeded faults under retry_policy = task, each giving the one-device
    page: (a) a device loss on worker 0 during Q6 fails its task with
    DeviceFaultError and the task re-runs on worker 1 (worker 0 reads
    QUARANTINED, then ACTIVE after the canary); (b) a corrupt spool frame
    fails the consumer's CRC and the producer re-runs; (c) a straggler
    is out-raced by a speculative backup (a hedge flag); (d) under
    retry_policy = query a worker stopped mid-Q3 costs a whole-query
    retry."""
    import threading
    import urllib.request

    from trino_tpu_torch.client.client import StatementClient
    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.server import protocol
    from trino_tpu_torch.utils.faults import FaultInjector

    co = runner.coordinator.coordinator
    for k, v in SERVER_DEFAULTS.items():
        runner.execute(f"set session {k} = '{v}'")
    # (a) device loss on worker 0's card at its first fused launch
    bad, good = runner.workers[0], runner.workers[1]
    runner.execute("set session device_probe_backoff_s = 30.0")
    bad.supervisor.fault_injector = FaultInjector(
        {"device_loss": {"nth": 1, "match": "fused_agg_sums"}})
    wall, _rows, tasks, launches, _split = _server_run(runner, qs["Q6"], want["Q6"])
    q = _last_query(co)
    moved = [e for e in _journal_events(journal.FTE_REASSIGN, q.query_id)
             if e["detail"].get("excludedUri") == bad.uri]
    lost = [e for e in journal.get_journal().tail()
            if e["eventType"] == journal.DEVICE_QUARANTINE and e.get("nodeId") == bad.node_id]
    state = _worker_info(bad.uri)["state"]
    if not moved or not lost or state != "QUARANTINED":
        raise AssertionError(f"device loss: reassigned {moved}, quarantine {lost}, "
                             f"worker 0 {state}")
    if journal.CPU_FALLBACK in {e["eventType"] for e in journal.get_journal().tail()}:
        raise AssertionError("a task re-ran on the CPU")
    bad.supervisor.fault_injector = None
    runner.execute("set session device_probe_backoff_s = 1.0")
    t1 = time.perf_counter()
    with bad.supervisor._lock:
        for d in bad.supervisor._devices.values():
            d.next_probe = 0.0
    deadline = time.time() + 30.0
    while time.time() < deadline and _worker_info(bad.uri)["state"] != "ACTIVE":
        time.sleep(0.05)
    if _worker_info(bad.uri)["state"] != "ACTIVE":
        raise AssertionError("the canary did not restore worker 0")
    _log(f"[fte] (a) device_loss on worker 0's first fused launch: Q6 {wall * 1e3:.1f} ms, "
         f"{len(moved)} task(s) failed with DeviceFaultError and re-ran on worker 1 "
         f"({sum(t['uri'] == good.uri for t in tasks)} of {len(tasks)} winning tasks "
         f"there), launches {launches}; worker 0 QUARANTINED, ACTIVE after the canary "
         f"in {time.perf_counter() - t1:.2f} s; page equal to the one-device page")
    # (b) a bit flipped in the first spooled frame after serialization
    runner.execute("set session fault_injection = "
                   "'{\"seed\": 5, \"spool_write_corrupt\": {\"nth\": 1}}'")
    wall, _rows, _tasks, _l, _split = _server_run(runner, qs["Q6"], want["Q6"])
    q = _last_query(co)
    runner.execute("set session fault_injection = ''")
    heals = _journal_events(journal.SPOOL_HEAL, q.query_id)
    if not heals:
        raise AssertionError("spool_write_corrupt: no heal journaled")
    _log(f"[fte] (b) spool_write_corrupt: the consumer's CRC check failed, "
         f"{len(heals)} spool attempt(s) decommitted and their producers re-ran "
         f"({heals[0]['detail'].get('corruptPath')}); Q6 {wall * 1e3:.1f} ms, page equal")
    # (c) fragment 1's task 0 sleeps FTE_STALL_S before it runs
    spec = json.dumps({"task_stall": {"stall_s": FTE_STALL_S, "match": ".1.0.0",
                                      "times": 1}})
    runner.execute(f"set session fault_injection = '{spec}'")
    wall, _rows, _tasks, _l, _split = _server_run(runner, qs["Q6"], want["Q6"])
    q = _last_query(co)
    runner.execute("set session fault_injection = ''")
    hedges = [f for f in q.straggler_flags if f.get("action") == "hedge"]
    if not hedges or wall >= FTE_STALL_S:
        raise AssertionError(f"task_stall: hedges {q.straggler_flags}, wall {wall:.2f} s")
    _log(f"[fte] (c) task_stall of {FTE_STALL_S} s: the speculative backup won, hedge "
         f"flag {hedges[0]['task']} after {hedges[0]['elapsedS']:.2f} s; Q6 "
         f"{wall * 1e3:.1f} ms, page equal")
    # (d) retry_policy = query, a worker stopped while Q3 runs
    runner.execute("set session retry_policy = 'query'")
    runner.execute("set session query_retry_attempts = 4")
    runner.execute("set session join_distribution_type = 'broadcast'")
    out = {}

    def go():
        try:
            out["rows"] = StatementClient(runner.coordinator.uri).execute(qs["Q3"])[1]
        except Exception as e:  # noqa: BLE001 — reported below
            out["error"] = e

    t2 = time.perf_counter()
    th = threading.Thread(target=go)
    th.start()
    victim = runner.workers[-1]
    deadline = time.time() + 60.0
    while time.time() < deadline and not any(
            t.state == "RUNNING" for t in list(victim.task_manager.tasks.values())):
        time.sleep(0.01)
    runner.kill_worker(-1)
    th.join(300.0)
    if "error" in out or th.is_alive():
        raise AssertionError(f"retry_policy = query: {out.get('error')}")
    if out["rows"] != json.loads(json.dumps(protocol.data_json(want["Q3"]))):
        raise AssertionError("retry_policy = query: Q3's rows differ")
    q = max((q for q in co.queries.values() if q.sql == qs["Q3"]),
            key=lambda q: q.created)
    with urllib.request.urlopen(f"{runner.coordinator.uri}/v1/query/{q.query_id}",
                                timeout=5.0) as r:
        doc = json.loads(r.read())
    if doc["retryCount"] < 1:
        raise AssertionError(f"retry_policy = query: retryCount {doc['retryCount']}")
    _log(f"[fte] (d) retry_policy = query: worker {victim.node_id} stopped mid-Q3; "
         f"retryCount {doc['retryCount']}, Q3 answered in "
         f"{time.perf_counter() - t2:.2f} s on the client's clock, rows equal to the "
         f"one-device page's")


def _fte_recovery(dev, qs, want_q3, card):
    """A subprocess coordinator with a recovery WAL and two subprocess
    workers on the card: the seeded coordinator_death site kills it
    (-9 semantics) right after the second task_committed record of Q3
    under FTE; it restarts on the same port, the client rides the 503
    window, the resumed Q3 answers the one-device page's rows, and the
    WAL shows no committed task re-run."""
    import shutil
    import tempfile
    import threading

    from trino_tpu_torch.client.client import StatementClient
    from trino_tpu_torch.server import protocol
    from trino_tpu_torch.server import recovery as rec
    from trino_tpu_torch.testing.runner import SubprocessCoordinator

    root = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    props = {"retry_policy": "task", "coordinator_recovery_dir": os.path.join(root, "wal"),
             "coordinator_recovery_window_s": 60.0, "result_cache": False,
             "join_distribution_type": "broadcast", "node_gone_grace_s": 5.0,
             "query_max_memory_bytes": card // 3}
    t0 = time.perf_counter()
    coord = SubprocessCoordinator(
        catalogs=(("tpch", "tpch", {"tpch.scale-factor": MAIN_SF}),),
        properties=props, device=dev, worker_device_bytes=card // 3,
        fault_injection={"coordinator_death": {"match": rec.TASK_COMMITTED, "nth": 2}})
    try:
        coord.add_worker(startup_timeout=120.0)
        coord.add_worker(startup_timeout=120.0)
        _log(f"[fte] recovery: subprocess coordinator and 2 subprocess workers up in "
             f"{time.perf_counter() - t0:.1f} s")
        fired = []

        def restart_when_dead():
            coord.proc.wait()
            fired.append((coord.proc.returncode, time.perf_counter()))
            coord.restart()
            coord.wait_for_workers(2, timeout=120.0)

        mon = threading.Thread(target=restart_when_dead, daemon=True)
        mon.start()
        client = StatementClient(coord.uri, restart_grace_s=120.0)
        t1 = time.perf_counter()
        _cols, rows = client.execute(qs["Q3"])
        resumed = time.perf_counter() - t1
        mon.join(timeout=180.0)
        if not fired:
            raise AssertionError("the coordinator was never killed")
        want_rows = json.loads(json.dumps(protocol.data_json(want_q3)))
        if rows != want_rows:
            raise AssertionError("the resumed Q3's rows differ from the one-device page's")
        t2 = time.perf_counter()
        _cols, rows2 = client.execute(qs["Q3"])
        again = time.perf_counter() - t2
        if rows2 != rows:
            raise AssertionError("an undisturbed Q3 after the restart differs")
        status = coord.status()
        if status.get("recoveredQueries", 0) < 1:
            raise AssertionError(f"recovery: {status}")
        records = rec.read_wal_dir(props["coordinator_recovery_dir"])
        qid = next(r["queryId"] for r in records
                   if r["recordType"] == rec.QUERY_SUBMITTED and r.get("sql") == qs["Q3"])
        mine = [r for r in records if r["queryId"] == qid]
        before = {(r["fragmentSig"], r["taskIndex"]) for r in mine
                  if r["recordType"] == rec.TASK_COMMITTED
                  and f"{os.sep}{qid}{os.sep}" in r["spoolPath"]}
        after = {(r["fragmentSig"], r["taskIndex"]) for r in mine
                 if r["recordType"] == rec.TASK_COMMITTED
                 and f"{os.sep}{qid}_rec{os.sep}" in r["spoolPath"]}
        rerun_dispatch = [r for r in mine if r["recordType"] == rec.TASK_DISPATCHED
                          and r["taskId"].startswith(f"{qid}_rec.")]
        terminal = rec.replay_wal(records)[qid].terminal
        if not before or not after or (before & after) or terminal != "FINISHED":
            raise AssertionError(f"recovery WAL: committed before {before}, after {after}, "
                                 f"terminal {terminal}")
        _log(f"[fte] recovery: coordinator_death after the 2nd task_committed record "
             f"(exit {fired[0][0]}); restarted on port {coord.port}; the client's Q3 "
             f"answered {resumed:.2f} s after submission, rows equal to the one-device "
             f"page's; recoveredQueries {status.get('recoveredQueries')}; the WAL: "
             f"{len(before)} task(s) committed before the kill, none of them re-run; "
             f"{len(rerun_dispatch)} task(s) dispatched and {len(after)} committed after "
             f"the restart; an undisturbed Q3 {again:.2f} s, the same rows")
    finally:
        coord.stop()
        shutil.rmtree(root, ignore_errors=True)


def _fte_autoscaler(dev, qs, card):
    """The autoscaler: a one-worker cluster (Q6 at AUTOSCALE_SF, one slot)
    under AUTOSCALE_CLIENTS closed-loop clients builds a backlog, scales
    out one worker_main subprocess on the card, then thinner load scales
    it in; every query answers the one-device page's rows."""
    import threading

    from trino_tpu_torch.client.client import StatementClient
    from trino_tpu_torch.server import protocol
    from trino_tpu_torch.session import tpch_session
    from trino_tpu_torch.testing import DistributedQueryRunner

    ref = _card_session(tpch_session, AUTOSCALE_SF)
    want = json.loads(json.dumps(protocol.data_json(ref.execute(qs["Q6"]))))
    del ref
    failures, results = [], []
    stop, heavy = threading.Event(), threading.Event()
    heavy.set()
    with DistributedQueryRunner(
        workers=1, catalogs=(("tpch", "tpch", {"tpch.scale-factor": AUTOSCALE_SF}),),
        properties={"result_cache": False},
        resource_groups={"groups": [{"name": "global", "hardConcurrencyLimit": 1,
                                     "maxQueued": 500}]},
        startup_timeout=60.0, device=dev,
    ) as runner:
        scaler = runner.enable_autoscaler(min_workers=1, max_workers=2, backlog_high=3,
                                          hold_s=0.1, cooldown_s=0.5, idle_grace_s=0.8)

        def loop(i):
            client = StatementClient(runner.coordinator.uri)
            while not stop.is_set() and (i == 0 or heavy.is_set()):
                try:
                    _c, rows = client.execute(qs["Q6"])
                    results.append(rows == want)
                except Exception as e:  # noqa: BLE001 — the assertion
                    failures.append(str(e))
                if not heavy.is_set():
                    time.sleep(0.3)

        threads = [threading.Thread(target=loop, args=(i,), daemon=True)
                   for i in range(AUTOSCALE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.time() + 120.0
        while runner.alive_workers() < 2 and time.time() < deadline:
            time.sleep(0.1)
        out_s = time.perf_counter() - t0
        if runner.alive_workers() != 2:
            raise AssertionError(f"the autoscaler never scaled out: {scaler.stats()}")
        n_out = len(results)
        heavy.clear()
        t1 = time.perf_counter()
        deadline = time.time() + 90.0
        while runner.alive_workers() != 1 and time.time() < deadline:
            time.sleep(0.1)
        in_s = time.perf_counter() - t1
        if runner.alive_workers() != 1:
            raise AssertionError(f"the autoscaler never scaled in: {scaler.stats()}")
        n = len(results)
        deadline = time.time() + 30.0
        while len(results) < n + 3 and time.time() < deadline:
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        actions = [e["action"] for e in scaler.stats()["events"]]
        if failures or not all(results) or len(results) <= n or \
                "scale_out" not in actions or "scale_in" not in actions:
            raise AssertionError(f"autoscaler: {len(failures)} failures {failures[:3]}, "
                                 f"{results.count(False)} wrong answers, actions {actions}")
    _log(f"[fte] autoscaler (Q6 at SF{AUTOSCALE_SF:g}, one slot, {AUTOSCALE_CLIENTS} "
         f"clients): scaled out to 2 workers {out_s:.1f} s after the load began "
         f"({n_out} queries by then), scaled in {in_s:.1f} s after it thinned; "
         f"{len(results)} queries, 0 failed, every answer the one-device page's; "
         f"actions {actions}; the subprocess worker's device pool "
         f"{runner.autoscale_device_bytes} bytes")


# ---------------------------------------------------------------------------
# phase 7f: the cross-host mesh: worker processes as hosts of one cluster,
# each running the slice-eligible fragments over its own shards of the card


MH_HOSTS = 2                 # host processes (worker_main --local-devices MH_SHARDS)
MH_SHARDS = 2                # logical shards of the card in each host
MH_STALL_S = 3.0             # the victim host's stall before each of its tasks
# statement -> (SQL key or text, session properties, kernels the hosts'
# slice tasks must launch at least this often a run, summed over them)
MH_STATEMENTS = {
    "Q6": ("Q6", {"megakernels": "auto"},
           {"grouped_count": MH_HOSTS * MH_SHARDS, "grouped_sum_i64": MH_HOSTS * MH_SHARDS}),
    "Q1": ("Q1", {"megakernels": "off"},
           {"grouped_count": MH_HOSTS * MH_SHARDS, "grouped_sum_i64": MH_HOSTS * MH_SHARDS}),
    # a broadcast build side is what makes Q3's probe fragments slices
    "Q3": ("Q3", {"megakernels": "auto", "join_distribution_type": "broadcast"},
           {"direct_probe": 2 * MH_HOSTS * MH_SHARDS}),
    "QD": (MESH_DISTINCT_SQL, {}, {}),
}


def _multihost_reference_pages(qs):
    """Each statement's page on one device at SF10: the main path's pages
    where that phase ran, the rest in its session (or in a session of
    its own with --phase multihost)."""
    from trino_tpu_torch.session import tpch_session

    s = MAIN.get("session") or _card_session(tpch_session, MAIN_SF)
    done = MAIN.get("pages", {})
    pages = {}
    for label, (sql, props, _k) in MH_STATEMENTS.items():
        if (label, props.get("megakernels", "auto")) in done:
            pages[label] = done[(label, props.get("megakernels", "auto"))]
            continue
        _set_session(s, {**SERVER_DEFAULTS, **props})
        pages[label] = s.execute(qs.get(sql, sql))
    _set_session(s, SERVER_DEFAULTS)
    return pages


def _host_metrics(uri):
    """A host's mesh-mode compile events and cross-host fetch bytes, from
    its /metrics."""
    import urllib.request

    with urllib.request.urlopen(f"{uri}/metrics", timeout=5.0) as r:
        text = r.read().decode()

    def value(pattern):
        m = re.search(pattern, text, re.M)
        return float(m.group(1)) if m else 0.0

    return (value(r'^trino_tpu_compile_events_total\{[^}]*mode="mesh"[^}]*\} (\S+)'),
            value(r"^trino_tpu_exchange_cross_host_fetch_bytes (\S+)"))


def _by_host(tasks):
    """The tasks of a run by host: slice tasks (run over the host's
    shards), one-device tasks, the slice tasks' launches, the process's
    device peak."""
    out = {}
    for t in tasks:
        h = out.setdefault(t["uri"], {"slices": 0, "one": 0, "peak": 0,
                                      "launches": dict.fromkeys(KERNEL_FNS, 0)})
        shards = ((t.get("kernelProfile") or {}).get("mesh") or {}).get("shards")
        if shards:
            if shards != MH_SHARDS:
                raise AssertionError(f"a slice task ran over {shards} shards")
            h["slices"] += 1
            for k, n in (t.get("kernelLaunches") or {}).items():
                h["launches"][k] += n
        else:
            h["one"] += 1
        h["peak"] = max(h["peak"], t.get("devicePeakBytes") or 0)
    return out


def phase_multihost(dev):
    """The cross-host mesh at SF10: a coordinator in this process and
    MH_HOSTS worker_main processes on the card, each a host with
    MH_SHARDS logical shards (--local-devices), under cross_host_mesh:
    Q6, Q1 with megakernels off, Q3 over broadcast joins and a grouped
    count(DISTINCT), each cold once and warm once through the
    StatementClient, pages held to the one-device pages; every host ran
    slice tasks over its shards (their launches from the tasks'
    profiles), compiled mesh-mode fragments and fetched bytes from the
    other host; then a third, stalled host killed with -9 mid-Q3 under
    retry_policy = task, the page the one-device page, committed spools
    reused, HOST_GONE journaled."""
    import threading

    from trino_tpu_torch import convert
    from trino_tpu_torch.memory import detect_device_bytes
    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.server.fte import FaultTolerantScheduler
    from trino_tpu_torch.sql.parser import parse
    from trino_tpu_torch.testing import DistributedQueryRunner

    qs = _tpch_sql()
    t_ref = time.perf_counter()
    want = _multihost_reference_pages(qs)
    _log(f"[multihost] one-device reference pages in {time.perf_counter() - t_ref:.1f} s")
    libs = _built_libraries()
    card = detect_device_bytes(device=dev)
    # each host's device pool: a sixth of the card, so MH_HOSTS + 1 hosts
    # and this process's resident main-path scans fit on it together
    share = card // 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = DistributedQueryRunner(
        workers=0, catalogs=(("tpch", "tpch", {"tpch.scale-factor": MAIN_SF}),),
        properties={"result_cache": False, "cross_host_mesh": True,
                    "query_max_memory_bytes": share, "node_gone_grace_s": 1.5},
        startup_timeout=60.0, device=dev)
    co = runner.coordinator.coordinator
    try:
        threads = [threading.Thread(target=runner.add_subprocess_worker, kwargs=dict(
            startup_timeout=120.0, local_devices=MH_SHARDS, process_index=i,
            device_memory_bytes=share)) for i in range(MH_HOSTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        hosts = [uri for _p, _n, uri in runner.subprocess_workers]
        topo = co.cluster_topology
        if len(hosts) != MH_HOSTS or topo.global_device_count() != MH_HOSTS * MH_SHARDS:
            raise AssertionError(f"hosts {hosts}, topology {[vars(x) for x in topo.slices()]}")
        _log(f"[multihost] coordinator and {MH_HOSTS} host processes up in "
             f"{time.perf_counter() - t0:.1f} s: {topo.hosts()}, {MH_SHARDS} shards each "
             f"({topo.global_device_count()} in the cluster), device pool {share} bytes "
             f"a host of the card's {card}")
        total = {h: dict.fromkeys(KERNEL_FNS, 0) for h in hosts}
        peaks = dict.fromkeys(hosts, 0)
        warm = {}
        for label, (sql, props, want_k) in MH_STATEMENTS.items():
            for k, v in {**SERVER_DEFAULTS, **props}.items():
                runner.execute(f"set session {k} = '{v}'")
            text = qs.get(sql, sql)
            walls = []
            for run in ("cold", "warm"):
                wall, rows, tasks, _l, split = _server_run(runner, text, want[label])
                walls.append(wall)
                per = _by_host(tasks)
                for h in hosts:
                    if not per.get(h, {}).get("slices"):
                        raise AssertionError(f"multihost {label}: host {h} ran no slice "
                                             f"task ({per})")
                    for k, n in per[h]["launches"].items():
                        total[h][k] += n
                    peaks[h] = max(peaks[h], per[h]["peak"])
                got = {k: sum(p["launches"][k] for p in per.values()) for k in KERNEL_FNS}
                for name, n in want_k.items():
                    if got[name] < n:
                        raise AssertionError(f"multihost {label} ({run}): {name} launched "
                                             f"{got[name]} times in the slice tasks, want "
                                             f">= {n}")
                _log(f"[multihost] {label} ({run}): {wall * 1e3:.3f} ms on the client's "
                     f"clock; {len(tasks)} tasks ("
                     + "; ".join(f"host {h[-5:]}: {p['slices']} slice, {p['one']} one-device, "
                                 f"slice launches {p['launches']}"
                                 for h, p in per.items())
                     + f"); {_fmt_split(split)}; {len(rows)} rows, page equal to the "
                     f"one-device page")
            warm[label] = walls[1]
        launches = {k: sum(t[k] for t in total.values()) for k in KERNEL_FNS}
        for name in ("grouped_count", "grouped_sum_i64", "direct_probe"):
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched in a slice task ({total})")
        MAIN["multihost_launches"] = launches
        for h in hosts:
            compiles, fetched = _host_metrics(h)
            if compiles <= 0 or fetched <= 0:
                raise AssertionError(f"host {h}: mesh-mode compiles {compiles}, cross-host "
                                     f"fetch bytes {fetched}")
            _log(f"[multihost] host {h}: slice-task launches {total[h]}; mesh-mode compile "
                 f"events {compiles:g}; cross-host fetch bytes {fetched:g}; process device "
                 f"peak {peaks[h] / 2**30:.2f} GiB")
        _log(f"[multihost] slice launches summed over the hosts' tasks: {launches}; warm "
             f"walls " + ", ".join(f"{k} {w * 1e3:.3f} ms" for k, w in warm.items())
             + f"; this process's device peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
             f" GiB (the coordinator, with the main path's resident scans)")

        # a third host, stalled before each task, killed with -9 mid-Q3
        runner.execute("set session join_distribution_type = 'broadcast'")
        t1 = time.perf_counter()
        _p, victim_id, victim = runner.add_subprocess_worker(
            startup_timeout=120.0, local_devices=MH_SHARDS, device_memory_bytes=share,
            fault_injection={"task_stall": {"stall_s": MH_STALL_S}})
        up = time.perf_counter() - t1
        fired = []

        def kill_when_busy():
            deadline = time.time() + 120.0
            while time.time() < deadline:
                try:
                    if _worker_info(victim, "status")["activeTasks"] >= 1:
                        break
                except Exception:  # noqa: BLE001 — dead already: kill below
                    break
                time.sleep(0.02)
            runner.sigkill_subprocess_worker()
            fired.append(time.perf_counter())

        killer = threading.Thread(target=kill_when_busy, daemon=True)
        killer.start()
        fte = FaultTolerantScheduler(
            runner.session.catalogs, co.node_manager,
            properties={**co._task_properties(), "retry_policy": "task",
                        "cross_host_mesh": True, "speculative_execution": False})
        plan = runner.session._plan_stmt(parse(qs["Q3"]))
        t2 = time.perf_counter()
        page = fte.run(plan, "q_multihost_kill9")
        wall = time.perf_counter() - t2
        killer.join(timeout=120.0)
        if not fired:
            raise AssertionError("the victim host was never killed")
        convert.assert_pages_identical(want["Q3"], page)
        attempts = {}
        for uri, task_id in fte._created_tasks:
            _q, frag, idx, _att = task_id.rsplit(".", 3)
            attempts.setdefault((frag, idx), []).append(uri)
        retried = {k: v for k, v in attempts.items() if len(v) > 1}
        single = [k for k, v in attempts.items() if len(v) == 1]
        if not any(victim in v for v in retried.values()) or not single:
            raise AssertionError(f"kill -9: attempts {attempts}")
        deadline = time.time() + 30.0
        while time.time() < deadline and not any(
                e["eventType"] == journal.HOST_GONE and e.get("nodeId") == victim_id
                for e in journal.get_journal().tail()):
            time.sleep(0.1)
        gone = [e for e in journal.get_journal().tail()
                if e["eventType"] == journal.HOST_GONE and e.get("nodeId") == victim_id]
        if not gone or topo.slice_for(victim_id) is not None:
            raise AssertionError("the killed host was never journaled HOST_GONE")
        _log(f"[multihost] kill -9: a third host (stalled {MH_STALL_S:g} s a task) up in "
             f"{up:.1f} s, killed {fired[0] - t2:.2f} s into Q3 under retry_policy = "
             f"task; Q3 answered in {wall:.2f} s, page equal to the one-device page; "
             f"{len(retried)} task(s) re-run after an attempt on the dead host, "
             f"{len(single)} ran once (committed spools reused); HOST_GONE "
             f"{gone[-1].get('detail')}")
        failed = [q.query_id for q in co.queries.values() if q.state == "FAILED"]
        if failed:
            raise AssertionError(f"failed queries: {failed}")
    finally:
        runner.stop()
    now = _built_libraries()
    if now != libs:
        raise AssertionError(f"a host rebuilt the kernel libraries: {libs} -> {now}")
    _log(f"[multihost] no host rebuilt the {len(libs)} kernel libraries (no nvcc run); "
         f"0 failed queries")


# ---------------------------------------------------------------------------
# phase 8: the TPC-DS path at SF3 (GROUPING SETS, the aggregate families,
# the function library, the surrogate-key star joins)


DS_SF = 3.0                   # cut from 10 for the call's budget (PERF.md section 4)


def _ds_statements():
    out = dict(_tpcds_sql())
    out.update(DS_EXTRA)
    return out


class _DsHost:
    """The generated TPC-DS host arrays the numpy references read, from
    the port's connector (numpy, the arrays the session loaded): per
    table {column: (values, valid)} and the varchar dictionaries, each
    table generated once with the columns the checks need."""

    COLUMNS = {
        "store_sales": [
            "ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk", "ss_customer_sk",
            "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk",
            "ss_ticket_number", "ss_quantity", "ss_list_price", "ss_sales_price",
            "ss_ext_sales_price", "ss_ext_wholesale_cost", "ss_coupon_amt",
            "ss_net_profit"],
        "date_dim": ["d_date_sk", "d_year"],
        "time_dim": ["t_time_sk", "t_hour", "t_minute"],
        "household_demographics": ["hd_demo_sk", "hd_dep_count"],
        "customer_demographics": ["cd_demo_sk", "cd_gender", "cd_marital_status",
                                  "cd_education_status"],
        "customer_address": ["ca_address_sk", "ca_country", "ca_state"],
        "store": ["s_store_sk", "s_store_id", "s_state"],
        "item": ["i_item_sk", "i_item_id"],
    }

    def __init__(self, sf):
        from trino_tpu_torch.connectors import tpcds

        self.sf = sf
        self.tables = {}
        self.dicts = {}
        t0 = time.perf_counter()
        for table, cols in self.COLUMNS.items():
            values, validity, dicts, n = tpcds.generate(table, sf, columns=cols)
            self.tables[table] = {
                c: (values[c], validity[c] if c in validity
                    else np.ones(n, dtype=bool)) for c in cols}
            self.dicts[table] = dicts
        _log(f"[ds] host reference arrays generated in "
             f"{time.perf_counter() - t0:.1f} s")

    def col(self, table, c):
        return self.tables[table][c]

    def strings(self, table, c):
        """The varchar column as python strings (None for NULL)."""
        v, ok = self.col(table, c)
        d = np.array([str(x) for x in self.dicts[table][c]], dtype=object)
        out = d[np.clip(v, 0, max(len(d) - 1, 0))] if len(d) else np.full(
            v.shape, None, dtype=object)
        return np.where(ok & (v >= 0), out, None)

    def fk(self, fact_col, table, sk_col, fact="store_sales"):
        """Row of `table` each fact key refers to (-1: NULL or no match)."""
        v, ok = self.col(fact, fact_col)
        sk, sk_ok = self.col(table, sk_col)
        top = int(sk[sk_ok].max())
        pos = np.full(top + 1, -1, dtype=np.int64)
        pos[sk[sk_ok]] = np.nonzero(sk_ok)[0]
        inr = ok & (v >= 0) & (v <= top)
        return np.where(inr, pos[np.where(inr, v, 0)], -1)

    def where(self, table, c, pred):
        """Per dimension row: valid and pred(value) (strings decoded)."""
        if c in self.dicts[table]:
            vals = self.strings(table, c)
            return np.array([x is not None and bool(pred(x)) for x in vals])
        v, ok = self.col(table, c)
        return ok & pred(v)


def _isum(a) -> int:
    """Exact python int sum of an int64 array (chunks small enough that
    no partial sum wraps for |a| < 2^40)."""
    a = np.asarray(a, dtype=np.int64)
    return sum(int(a[i:i + (1 << 20)].sum()) for i in range(0, a.shape[0], 1 << 20))


def _close(got, want, rtol=1e-9) -> bool:
    return got is not None and abs(got - want) <= rtol * abs(want)


def _dim_mask(rows, mask):
    """Fact rows whose dimension row exists and passes `mask`."""
    ok = rows >= 0
    out = np.zeros(rows.shape[0], dtype=bool)
    out[ok] = mask[rows[ok]]
    return out


def check_ds_null_fk(h, page):
    """count(*) of store_sales joined to date_dim: rows with a non-NULL
    ss_sold_date_sk that names a date."""
    want = int((h.fk("ss_sold_date_sk", "date_dim", "d_date_sk") >= 0).sum())
    _expect_rows("NULL-FK", page.to_pylist(), [(want,)])


def check_ds_q96(h, page):
    """Q96: sales at 20:30-20:59 by households of 7 dependents, in a
    store."""
    m = (_dim_mask(h.fk("ss_sold_time_sk", "time_dim", "t_time_sk"),
                   h.where("time_dim", "t_hour", lambda v: v == 20)
                   & h.where("time_dim", "t_minute", lambda v: v >= 30))
         & _dim_mask(h.fk("ss_hdemo_sk", "household_demographics", "hd_demo_sk"),
                     h.where("household_demographics", "hd_dep_count",
                             lambda v: v == 7))
         & (h.fk("ss_store_sk", "store", "s_store_sk") >= 0))
    _expect_rows("Q96", page.to_pylist(), [(int(m.sum()),)])


def _avg_decimal(vals, ok, out_scale, in_scale=2):
    """avg of a decimal column as the engine rounds it: the exact sum at
    the output scale, divided with round-half-away."""
    n = int(ok.sum())
    if n == 0:
        return None
    return _half_away(_isum(vals[ok]) * 10 ** (out_scale - in_scale), n)


def check_ds_q13(h, page):
    """Q13 (one global row): the averages and the sum over the sales of
    2001 in a store, by married college-educated customers of households
    of 3 dependents, shipped to TX, OH or CA in the United States."""
    m = (_dim_mask(h.fk("ss_sold_date_sk", "date_dim", "d_date_sk"),
                   h.where("date_dim", "d_year", lambda v: v == 2001))
         & (h.fk("ss_store_sk", "store", "s_store_sk") >= 0)
         & _dim_mask(h.fk("ss_hdemo_sk", "household_demographics", "hd_demo_sk"),
                     h.where("household_demographics", "hd_dep_count",
                             lambda v: v == 3))
         & _dim_mask(h.fk("ss_cdemo_sk", "customer_demographics", "cd_demo_sk"),
                     h.where("customer_demographics", "cd_marital_status",
                             lambda x: x == "M")
                     & h.where("customer_demographics", "cd_education_status",
                               lambda x: x == "College"))
         & _dim_mask(h.fk("ss_addr_sk", "customer_address", "ca_address_sk"),
                     h.where("customer_address", "ca_country",
                             lambda x: x == "United States")
                     & h.where("customer_address", "ca_state",
                               lambda x: x in ("TX", "OH", "CA"))))
    q, qok = h.col("store_sales", "ss_quantity")
    e, eok = h.col("store_sales", "ss_ext_sales_price")
    w, wok = h.col("store_sales", "ss_ext_wholesale_cost")
    nq = int((m & qok).sum())
    want_q = float(_isum(q[m & qok])) / nq if nq else None
    cols = page.columns
    want = (want_q, _avg_decimal(e, m & eok, cols[1].type.scale),
            _avg_decimal(w, m & wok, cols[2].type.scale),
            _isum(w[m & wok]) if (m & wok).any() else None)
    got = (page.to_pylist()[0][0],) + tuple(
        _raw(c, 0) if _valid(c, 0) else None for c in cols[1:])
    if page.count != 1 or got != want:
        raise AssertionError(f"Q13 {got} != reference {want}")


def _splitmix64_np(v):
    from trino_tpu_torch.connectors.tpch import mix64

    return mix64(v.astype(np.uint64))


def check_ds_agg(h, page):
    """DS-AGG per store: count, approx_distinct, approx_percentile,
    max_by (a ticket of a row at the maximal net profit), bool_and,
    bitwise_or_agg and checksum exactly; stddev_samp, var_pop, corr and
    geometric_mean at relative 1e-9 against exact integer moments and a
    math.fsum of logs."""
    import math

    srow = h.fk("ss_store_sk", "store", "s_store_sk")
    ids = h.strings("store", "s_store_id")
    keys = sorted({x for x in ids if x is not None})
    code = np.array([keys.index(x) if x is not None else -1 for x in ids])
    g = np.where(srow >= 0, code[np.maximum(srow, 0)], -1)
    rows = np.nonzero(g >= 0)[0]
    order = rows[np.argsort(g[rows], kind="stable")]
    bounds = np.searchsorted(g[order], np.arange(len(keys) + 1))
    c = {k: h.col("store_sales", k) for k in (
        "ss_quantity", "ss_net_profit", "ss_list_price", "ss_sales_price",
        "ss_customer_sk", "ss_ticket_number", "ss_item_sk")}
    got_rows = page.to_pylist()
    if [r[0] for r in got_rows] != keys:
        raise AssertionError(f"DS-AGG stores {[r[0] for r in got_rows][:5]}... != "
                             f"reference {keys[:5]}...")
    for gi, key in enumerate(keys):
        idx = order[bounds[gi]:bounds[gi + 1]]
        got = got_rows[gi]
        q, qok = (a[idx] for a in c["ss_quantity"])
        qv = q[qok]
        n = qv.shape[0]
        sq, sqq = _isum(qv), _isum(qv * qv)
        sd = math.sqrt((n * sqq - sq * sq) / (n * (n - 1)))
        p, pok = (a[idx] for a in c["ss_net_profit"])
        pv = p[pok]
        npf = pv.shape[0]
        vp = (npf * _isum(pv * pv) - _isum(pv) ** 2) / (npf * npf * 10**4)
        (x, xok), (y, yok) = ((a[idx] for a in c["ss_list_price"]),
                              (a[idx] for a in c["ss_sales_price"]))
        both = xok & yok
        xv, yv = x[both], y[both]
        nb = int(both.sum())
        cxy = nb * _isum(xv * yv) - _isum(xv) * _isum(yv)
        cxx = nb * _isum(xv * xv) - _isum(xv) ** 2
        cyy = nb * _isum(yv * yv) - _isum(yv) ** 2
        cr = cxy / (math.sqrt(cxx) * math.sqrt(cyy))
        gm = math.exp(math.fsum(np.log(qv[qv > 0].astype(np.float64))) / n)
        cu, cuok = (a[idx] for a in c["ss_customer_sk"])
        ad = int(np.unique(cu[cuok]).shape[0])
        sp, spok = (a[idx] for a in c["ss_sales_price"])
        spv = np.sort(sp[spok])
        p50 = int(spv[int(math.floor(0.5 * (spv.shape[0] - 1) + 0.5))])
        t, tok = (a[idx] for a in c["ss_ticket_number"])
        top = pv.max()
        at = np.nonzero(pok)[0][pv == top]
        tickets = {int(t[i]) if tok[i] else None for i in at}
        it, itok = (a[idx] for a in c["ss_item_sk"])
        ck = int(np.sum(np.where(itok, _splitmix64_np(it), np.uint64(0x6E676C6C7561)),
                        dtype=np.uint64).astype(np.int64))
        exact = {"n": (got[1], idx.shape[0]), "ad": (got[6], ad),
                 "ba": (got[9], bool((qv > 0).all())),
                 "bo": (got[10], int(np.bitwise_or.reduce(qv))),
                 "ck": (got[11], ck)}
        bad = {k: v for k, v in exact.items() if v[0] != v[1]}
        if _raw(page.columns[7], gi) != p50:
            bad["p50"] = (_raw(page.columns[7], gi), p50)
        if got[8] not in tickets:
            bad["mb"] = (got[8], sorted(tickets, key=str)[:5])
        for k, gv, wv in (("sd", got[2], sd), ("vp", got[3], vp),
                          ("cr", got[4], cr), ("gm", got[5], gm)):
            if not _close(gv, wv):
                bad[k] = (gv, wv)
        if bad:
            raise AssertionError(f"DS-AGG store {key}: {bad}")


def check_ds_q27_rollup(h, page):
    """DS-Q27-ROLLUP: the detail rows (item, state), the per-item totals
    and the grand total, each average as the engine rounds it, ordered
    by item and state (NULLs last) and cut at 100 rows."""
    m = (_dim_mask(h.fk("ss_sold_date_sk", "date_dim", "d_date_sk"),
                   h.where("date_dim", "d_year", lambda v: v == 2002))
         & _dim_mask(h.fk("ss_cdemo_sk", "customer_demographics", "cd_demo_sk"),
                     h.where("customer_demographics", "cd_gender", lambda x: x == "M")
                     & h.where("customer_demographics", "cd_marital_status",
                               lambda x: x == "S")
                     & h.where("customer_demographics", "cd_education_status",
                               lambda x: x == "College")))
    irow = h.fk("ss_item_sk", "item", "i_item_sk")
    srow = h.fk("ss_store_sk", "store", "s_store_sk")
    m &= (irow >= 0) & (srow >= 0)
    rows = np.nonzero(m)[0]
    items = h.strings("item", "i_item_id")[irow[rows]]
    states = h.strings("store", "s_state")[srow[rows]]
    names = ("ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price")
    lanes = [tuple(a[rows] for a in h.col("store_sales", c)) for c in names]
    acc = {}
    for j in range(rows.shape[0]):
        for key in ((items[j], states[j]), (items[j], None), (None, None)):
            a = acc.setdefault(key, [[0, 0] for _ in names])
            for k, (v, ok) in enumerate(lanes):
                if ok[j]:
                    a[k][0] += int(v[j])
                    a[k][1] += 1
    scales = [page.columns[3 + k].type.scale for k in range(1, 4)]
    want = []
    for (item, state), a in acc.items():
        (sq, nq), *decs = a
        row = [item, state, 1 if state is None else 0,
               float(sq) / nq if nq else None]
        for (sm, n), sc in zip(decs, scales):
            row.append(_half_away(sm * 10 ** (sc - 2), n) if n else None)
        want.append(tuple(row))
    want.sort(key=lambda r: (r[0] is None, r[0] or "", r[1] is None, r[1] or ""))
    want = want[:100]
    got = []
    py = page.to_pylist()
    for i in range(page.count):
        got.append(tuple(py[i][:4]) + tuple(
            _raw(page.columns[k], i) if _valid(page.columns[k], i) else None
            for k in range(4, 7)))
    _expect_rows("DS-Q27-ROLLUP", got, want)


# kernels the TPC-DS path must launch (read from a CPU run of this phase
# with counting shims): the star joins probe by direct address, and the
# global counts and sums run the grouped kernels; no aggregate of the
# path fuses, as each sits above a join
DS_KERNELS = ("grouped_count", "grouped_sum_i64", "direct_probe")
DS_CHECKS = {"NULL-FK": check_ds_null_fk, "Q96": check_ds_q96, "Q13": check_ds_q13,
             "DS-AGG": check_ds_agg, "DS-Q27-ROLLUP": check_ds_q27_rollup}


def phase_ds(dev, do_profile=False):
    """The TPC-DS path at DS_SF in a session of its own (the TPC-H SF10
    session freed first, so the peak memory is this path's): every
    statement cold once, then MAIN_REPS warm runs with the kernels'
    launches counted from zero; the numpy references of DS_CHECKS, and
    every other statement byte-identical to a run on the plain kernel
    versions."""
    import gc

    from trino_tpu_torch import convert
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpcds_session

    for k in ("session", "recorded", "sf1_fused"):
        MAIN.pop(k, None)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sf = DS_SF
    s = _card_session(tpcds_session, sf)
    # each statement scans its own column set of store_sales: the budget
    # holds all of them, so the warm runs regenerate nothing
    s._scan_cache.max_bytes = torch.cuda.get_device_properties(dev).total_memory // 2
    _log(f"[ds{sf:g}] device memory allocated before the path "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; scan cache budget "
         f"{s._scan_cache.max_bytes} bytes")
    sqls = _ds_statements()
    torch.cuda.reset_peak_memory_stats()
    t_cold = time.perf_counter()
    for q, sql in sqls.items():  # cold: generation, upload, first run
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        _log(f"[ds{sf:g}] cold {q}: {time.perf_counter() - t0:.3f} s")
    _log(f"[ds{sf:g}] all cold runs {time.perf_counter() - t_cold:.1f} s; scan cache "
         f"{len(s._scan_cache.entries)} scans, {s._scan_cache.bytes} bytes")
    walls = {q: [] for q in sqls}
    per_run = {q: dict.fromkeys(KERNEL_FNS, 0) for q in sqls}
    pages = {}
    kn.reset_counts()  # the TPC-DS path starts here
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
    _log(f"[ds{sf:g}] TPC-DS path launches: {launches}")
    for q, n in per_run.items():
        _log(f"[ds{sf:g}]   {q} over {MAIN_REPS} runs: {n}")
    for q, w in walls.items():
        _log(f"[ds{sf:g}] warm {q}: median {statistics.median(w) * 1e3:.3f} ms over "
             f"{len(w)} runs (all: {', '.join(f'{x * 1e3:.3f}' for x in w)}), "
             f"{pages[q].count} rows")
    _log(f"[ds{sf:g}] peak device memory over the TPC-DS path (cold and warm) "
         f"{peak / 2**30:.2f} GiB")
    for name in DS_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the TPC-DS path")
    host = _DsHost(sf)
    for q, check in DS_CHECKS.items():
        check(host, pages[q])
    _log(f"[ds{sf:g}] {', '.join(DS_CHECKS)} agree with the numpy references")
    del host
    others = [q for q in sqls if q not in DS_CHECKS]
    with _plain_kernels():
        plain = {q: s.execute(sqls[q]) for q in others}
    for q in others:
        convert.assert_pages_identical(pages[q], plain[q])
    _log(f"[ds{sf:g}] the other {len(others)} statements byte-identical on the "
         f"plain kernel versions")
    for q in ("DS-Q27-ROLLUP", "DS-AGG", "DS-FN", "Q96", "Q13"):
        for row in pages[q].to_pylist()[:4]:
            _log(f"[ds{sf:g}] {q} {row}")
    if do_profile:
        for q, sql in sqls.items():
            _profile(s, sql, f"ds{sf:g} {q}")


# ---------------------------------------------------------------------------
# phase 9: the fault path (seeded faults on the card, the supervisor's
# quarantine, canary recovery, watchdog, blacklist)


FAULT_SF = 10.0
FAULT_REPS = 3
WATCHDOG_S = 2.0
SUPERVISED = []              # every session's supervisor but the faults phase's


@contextlib.contextmanager
def _bare(sup):
    """The supervisor's boundary as bare calls meanwhile: the walls
    without the breadcrumbs, the flight recorder and the watchdog."""
    sup.dispatch = lambda thunk, bc, device_id=0: thunk()
    sup.device_get = lambda fn, bc, device=None, device_id=0: fn()
    try:
        yield
    finally:
        del sup.dispatch, sup.device_get


def _expect_fault(s, sql, kind, kernel):
    """Run `sql`, which must raise DeviceFaultError of `kind` naming
    `kernel`; returns (error, seconds to the raise)."""
    from trino_tpu_torch.runtime import DeviceFaultError

    t0 = time.perf_counter()
    try:
        s.execute(sql)
    except DeviceFaultError as e:
        wall = time.perf_counter() - t0
        if e.kind != kind or (kernel and e.breadcrumb.kernel != kernel):
            raise AssertionError(f"expected {kind} at {kernel}, got {e}") from e
        return e, wall
    raise AssertionError(f"no {kind} raised by {sql[:60]}")


def _recover(s, backoff):
    """Wait out the backoff; the next execute probes the canary."""
    from trino_tpu_torch.ops import kernels as kn

    time.sleep(backoff * 1.5)
    before = kn.LAUNCHES["grouped_count"]
    if not s.device_supervisor.maybe_probe():
        raise AssertionError("the canary did not restore the device")
    if kn.LAUNCHES["grouped_count"] != before + 1:
        raise AssertionError("the canary did not launch grouped_count on the card")


def phase_faults(dev):
    """Seeded faults on the card in a TPC-H SF10 session of its own:
    (timing) Q6/Q1/Q3 warm with the supervisor's boundary and bare, in
    turns; (a) a device_loss keyed to fused_agg_sums during Q6 raises
    DeviceFaultError naming it and its shapes, quarantines the device,
    is journaled and is the flight recorder's last record; (b) the
    canary (grouped_count on the card) restores it and Q6 runs again on
    the card against the numpy reference; (c) a device_wedge under a
    2 s watchdog raises within twice the timeout; (d) a third fault
    blacklists the device and execute refuses."""
    import gc

    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    qs, _ = _queries()
    sf = FAULT_SF
    backoff = 0.05
    kn.reset_counts()  # the phase's launches, canaries included
    s = _card_session(tpch_session, sf, device_probe_backoff_s=backoff)
    sup = s.device_supervisor
    runs = [("Q6", "auto"), ("Q1", "auto"), ("Q3", "auto")]
    for q, mode in runs:  # cold: generation, upload, first run
        s.properties.set("megakernels", mode)
        s.execute(qs[q])
    torch.cuda.synchronize()
    walls = {(q, how): [] for q, _ in runs for how in ("supervised", "bare")}
    for how in ("bare", "supervised", "supervised", "bare") * FAULT_REPS:
        for q, mode in runs:
            s.properties.set("megakernels", mode)
            with _bare(sup) if how == "bare" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.execute(qs[q])
                torch.cuda.synchronize()
                walls[(q, how)].append(time.perf_counter() - t0)
    main_walls = MAIN.get("walls") or {}
    for q, mode in runs:
        sup_ms = statistics.median(walls[(q, "supervised")]) * 1e3
        bare_ms = statistics.median(walls[(q, "bare")]) * 1e3
        main = main_walls.get((q, mode))
        _log(f"[faults] warm {q} megakernels={mode}: supervised median {sup_ms:.3f} ms, "
             f"bare {bare_ms:.3f} ms ({len(walls[(q, 'bare')])} runs each, in turns), "
             f"overhead {sup_ms - bare_ms:.3f} ms; main path (phase 4) "
             + (f"{statistics.median(main) * 1e3:.3f} ms" if main else "not run"))
    if sup.device_state() != "ACTIVE" or sup.faults():
        raise AssertionError("the supervisor left ACTIVE with no fault injected")
    cols, dicts = _scan_host_columns(s, ["l_tax", "l_returnflag", "l_shipdate"])

    # (a) a lost device at the fused kernel's launch
    s.properties.set("megakernels", "auto")
    s.properties.set("fault_injection", json.dumps(
        {"device_loss": {"match": "fused_agg_sums", "nth": 1}}))
    journal._reset_journal()
    e, _ = _expect_fault(s, qs["Q6"], "device_loss", "fused_agg_sums")
    shapes = e.breadcrumb.shapes
    if not shapes.get("live", "").startswith("bool(") or e.surfaced_at is None:
        raise AssertionError(f"the fault's breadcrumb lacks its shapes: {e}")
    if sup.device_state() != "QUARANTINED":
        raise AssertionError(f"device {sup.device_state()} after a loss")
    kinds = [ev["eventType"] for ev in journal.get_journal().tail()]
    if journal.DEVICE_FAULT not in kinds or journal.DEVICE_QUARANTINE not in kinds:
        raise AssertionError(f"the loss was not journaled: {kinds}")
    last = sup.flight_recorder.tail(1)[0]
    if (last["recordType"], last["kernel"], last["faultKind"]) != (
            "fault", "fused_agg_sums", "device_loss"):
        raise AssertionError(f"the flight recorder's last record is {last}")
    _log(f"[faults] (a) {e}")
    _log(f"[faults] (a) journal {kinds}; flight recorder last record "
         f"{last['recordType']} {last['kernel']} {last['faultKind']}")

    # (b) recovery through the canary, then Q6 on the card again
    s.properties.set("fault_injection", "")
    _recover(s, backoff)
    before = kn.LAUNCHES["fused_agg_sums"]
    page = s.execute(qs["Q6"])
    torch.cuda.synchronize()
    if kn.LAUNCHES["fused_agg_sums"] == before or sup.device_state() != "ACTIVE":
        raise AssertionError("Q6 did not run on the card after recovery")
    check_reference({"Q6": page, "Q1": s.execute(qs["Q1"])}, cols, dicts)
    _log(f"[faults] (b) the canary restored the device; Q6 on the card again "
         f"({kn.LAUNCHES['fused_agg_sums'] - before} fused launches), Q6 and Q1 "
         f"agree with the numpy references")

    # (c) a wedged device under a 2 s watchdog
    s.properties.set("device_watchdog_timeout_s", WATCHDOG_S)
    s.properties.set("fault_injection", json.dumps(
        {"device_wedge": {"match": "fused_agg_sums", "nth": 1}}))
    e, wall = _expect_fault(s, qs["Q6"], "device_wedge", "fused_agg_sums")
    if not WATCHDOG_S <= wall < 2 * WATCHDOG_S:
        raise AssertionError(f"the wedge raised after {wall:.3f} s, watchdog "
                             f"{WATCHDOG_S} s")
    _log(f"[faults] (c) device_wedge raised after {wall:.3f} s (watchdog "
         f"{WATCHDOG_S:g} s): {e}")

    # (d) the third strike blacklists the device
    s.properties.set("fault_injection", "")
    _recover(s, backoff * 2)
    s.properties.set("fault_injection", json.dumps(
        {"device_loss": {"match": "direct_probe", "nth": 1}}))
    _expect_fault(s, qs["Q3"], "device_loss", "direct_probe")
    if sup.device_state() != "BLACKLISTED" or sup.faults() != 3:
        raise AssertionError(f"{sup.faults()} faults left the device {sup.device_state()}")
    s.properties.set("fault_injection", "")
    time.sleep(backoff * 4)
    _expect_fault(s, qs["Q6"], "device_blacklisted", None)
    _log(f"[faults] (d) {sup.faults()} strikes: BLACKLISTED, execute refuses "
         f"(device_blacklisted); journal "
         f"{[ev['eventType'] for ev in journal.get_journal().tail()][-3:]}")
    _log(f"[faults] launches over the phase (cold, timing, faults, canaries): "
         f"{dict(kn.LAUNCHES)}")
    del s, cols, dicts
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the data connectors (lakehouse snapshots and time travel, hive
# parquet with row-group pruning)


LAKE_SF = 3.0                 # cut from 10 for the call's budget (PERF.md section 4)
LAKE_COLS = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
             "l_returnflag", "l_linestatus", "l_shipdate")
LAKE_REPS = 2                # warm runs after the cold one
HIVE_ROWS_PER_GROUP = 1 << 20


def _lake_ranges(sf):
    """The INSERT's and the DELETE's l_orderkey ranges (orderkeys run to
    6,000,000 x SF, sparsely)."""
    top = int(6_000_000 * sf)
    return (top // 10, top // 10 + top // 50), (top // 2, top // 2 + top // 25)


def _timed(mod, name, acc):
    """Wrap mod.name to add its seconds to acc[name]; returns the undo."""
    real = getattr(mod, name)

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, real)


def phase_lake(dev):
    """Lakehouse and hive tables at TPC-H LAKE_SF: CTAS of lineitem's eight
    Q1/Q6/Q3 columns into lake.default.lineitem, an INSERT of one
    orderkey range and a DELETE of another (three snapshots with data);
    Q6 FOR VERSION AS OF each snapshot, Q1 at the last and Q3 with
    lineitem from the lake, cold once and warm twice, against numpy references over
    the generated host arrays; expire_snapshots and remove_orphan_files
    checked by counts; the same columns written with
    write_parquet_table into hive, Q1 and Q6 over hive equal to the lake's
    pages and the references, and an l_orderkey range whose row groups
    are pruned as the footers' statistics say.  Every query runs with
    megakernels auto: ANALYZE's and the footers' decimal bounds (value
    units) reach the fused gate, which converts them to the lanes'
    units."""
    import gc
    import tempfile

    import pyarrow.parquet as pq

    from trino_tpu_torch import convert
    from trino_tpu_torch.connectors import hive as hive_mod
    from trino_tpu_torch.connectors import lakehouse
    from trino_tpu_torch.connectors.hive import write_parquet_table
    from trino_tpu_torch.exec.local import LocalExecutor
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.session import tpch_session

    qs, _ = _queries()
    sf = LAKE_SF
    root = tempfile.mkdtemp(prefix="chip_smoke_lake_")
    lake_dir, hive_dir = os.path.join(root, "lake"), os.path.join(root, "hive")
    s = _card_session(tpch_session, sf)
    s.create_catalog("lake", "lakehouse", {"lake.warehouse-dir": lake_dir})
    s.create_catalog("hive", "hive", {"hive.warehouse-dir": hive_dir})
    conn = s.catalogs.get("lake")
    cols = ", ".join(LAKE_COLS)
    src = "tpch.default.lineitem"
    (i_lo, i_hi), (d_lo, d_hi) = _lake_ranges(sf)
    secs = {}
    undo = [_timed(lakehouse, "_decode_data_file", secs),
            _timed(lakehouse, "_encode_data_file", secs),
            _timed(LocalExecutor, "_device_lanes", secs)]
    try:
        torch.cuda.reset_peak_memory_stats()
        writes = (
            ("ctas", f"create table lake.default.lineitem as select {cols} from {src}"),
            ("insert", f"insert into lake.default.lineitem select {cols} from {src} "
                       f"where l_orderkey between {i_lo} and {i_hi}"),
            ("delete", f"delete from lake.default.lineitem where l_orderkey between "
                       f"{d_lo} and {d_hi}"),
        )
        for what, sql in writes:
            t0 = time.perf_counter()
            s.execute(sql)
            secs[what] = time.perf_counter() - t0
            if what == "ctas":
                host, dicts = _scan_host_columns(s, list(LAKE_COLS))
        # the current snapshot's statistics of Q1's and Q6's columns: the
        # fused aggregate needs bounded null-free column stats (as in the
        # JAX package), so both reach the fused gate at version 3 and run
        # unfused at 1 and 2
        t0 = time.perf_counter()
        s.execute("analyze lake.default.lineitem (l_shipdate, l_discount, "
                  "l_quantity, l_extendedprice, l_tax, l_returnflag, l_linestatus)")
        secs["analyze"] = time.perf_counter() - t0
        snaps = [r for r in conn.snapshots_rows() if r[0] == "lineitem"]
        if [(r[1], r[3]) for r in snaps] != [(0, "create"), (1, "append"),
                                              (2, "append"), (3, "overwrite")]:
            raise AssertionError(f"snapshots {snaps}")
        files = conn.fs.list_files("lineitem/data")
        _log(f"[lake] CTAS {secs['ctas']:.3f} s, INSERT {secs['insert']:.3f} s, "
             f"DELETE {secs['delete']:.3f} s, ANALYZE (Q1's and Q6's columns, "
             f"snapshot 3) "
             f"{secs['analyze']:.3f} s; data files "
             f"{[e.size for e in files]} bytes; snapshots "
             f"{[(r[1], r[3], r[5]) for r in snaps]} (id, operation, rows)")
        # the host arrays of each snapshot: the scan, + the INSERT's rows,
        # - the DELETE's rows
        key = host["l_orderkey"]
        ins = (key >= i_lo) & (key <= i_hi)
        v2 = {c: np.concatenate([host[c], host[c][ins]]) for c in LAKE_COLS}
        keep = ~((v2["l_orderkey"] >= d_lo) & (v2["l_orderkey"] <= d_hi))
        v3 = {c: v2[c][keep] for c in LAKE_COLS}
        versions = {1: host, 2: v2, 3: v3}
        for v, arrays in versions.items():
            if snaps[v][5] != len(arrays["l_orderkey"]):
                raise AssertionError(f"snapshot {v} holds {snaps[v][5]} rows, "
                                     f"reference {len(arrays['l_orderkey'])}")
        # Q6 at every snapshot (time travel), Q1 at the last (its cold
        # whole-file loads at the earlier ones were cut for the call's
        # budget)
        lake_sql = {}
        for v in versions:
            for q in ("Q6", "Q1") if v == 3 else ("Q6",):
                lake_sql[(q, v)] = qs[q].replace(
                    "from lineitem", f"from lake.default.lineitem for version as of {v}")
        lake_sql[("Q3", 3)] = qs["Q3"].replace(
            "from customer, orders, lineitem",
            "from tpch.default.customer, tpch.default.orders, lake.default.lineitem")
        walls = {k: [] for k in lake_sql}
        pages, fused, rejects = {}, {}, {}
        write_secs = dict(secs)
        secs.clear()
        kn.reset_counts()  # the lake path starts here
        for rep in range(1 + LAKE_REPS):
            for k, sql in lake_sql.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pages[k] = s.execute(sql)
                torch.cuda.synchronize()
                walls[k].append(time.perf_counter() - t0)
                fused[k] = s.last_kernel_profile.get("fusedAggregates") or 0
                rejects[k] = s.last_kernel_profile.get("lastFusionReject")
            if rep == 0:
                cold_secs = dict(secs)
        launches = dict(kn.LAUNCHES)  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
    finally:
        for u in undo:
            u()
    for v, arrays in versions.items():
        check_reference({q: pages[(q, v)] for q in ("Q6", "Q1") if (q, v) in pages},
                        arrays, dicts)
    orders, _ = _scan_host_columns(s, ["o_custkey"], "orders")
    cust, cdicts = _scan_host_columns(s, ["c_mktsegment"], "customer")
    check_q3(pages[("Q3", 3)], v3, orders, cust, cdicts)
    if (launches["direct_probe"] == 0 or launches["fused_agg_sums"] == 0
            or not fused[("Q6", 3)]):
        raise AssertionError(f"the lake path launched {launches}")
    for k, w in walls.items():
        _log(f"[lake] {k[0]} version {k[1]} megakernels=auto (fused aggregates "
             f"{fused[k]}, last fusion reject {rejects[k]!r}): cold {w[0] * 1e3:.3f} ms, warm "
             f"{', '.join(f'{x * 1e3:.3f}' for x in w[1:])} ms, {pages[k].count} rows")
    _log(f"[lake] launches {launches}; peak device memory {peak / 2**30:.2f} GiB "
         f"(writes and queries); the writes' seconds in np.savez (_encode_data_file) "
         f"{write_secs.get('_encode_data_file', 0):.3f}, np.load (_decode_data_file) "
         f"{write_secs.get('_decode_data_file', 0):.3f}, upload (_device_lanes) "
         f"{write_secs.get('_device_lanes', 0):.3f}; the queries' cold pass np.load "
         f"{cold_secs.get('_decode_data_file', 0):.3f}, upload "
         f"{cold_secs.get('_device_lanes', 0):.3f}; all three passes np.load "
         f"{secs.get('_decode_data_file', 0):.3f}, upload "
         f"{secs.get('_device_lanes', 0):.3f}")
    _log("[lake] Q6 at every snapshot, Q1 at the last and Q3 agree exactly with the "
         "numpy references")
    # maintenance
    conn.fs.write_file("lineitem/data/crashed-writer-leftover.npz", b"\0" * 4096)
    res = conn.expire_snapshots("lineitem", keep=1)
    if (res["expiredSnapshots"], res["removedFiles"], res["currentSnapshotId"]) != (3, 2, 3):
        raise AssertionError(f"expire_snapshots {res}")
    orphans = conn.remove_orphan_files("lineitem", older_than_s=0.0)
    if (orphans["removedFiles"], orphans["freedBytes"]) != (1, 4096):
        raise AssertionError(f"remove_orphan_files {orphans}")
    left = conn.fs.list_files("lineitem/data")
    if len(left) != 1:
        raise AssertionError(f"{len(left)} data files left after maintenance")
    convert.assert_pages_identical(pages[("Q6", 3)], s.execute(
        qs["Q6"].replace("from lineitem", "from lake.default.lineitem")))
    _log(f"[lake] expire_snapshots {res}; remove_orphan_files {orphans}; one data "
         f"file left, the current snapshot reads the same")

    # hive: the first snapshot's columns as parquet
    table = s.execute(f"select {cols} from {src}")
    t0 = time.perf_counter()
    write_parquet_table(hive_dir, "lineitem", table, rows_per_group=HIVE_ROWS_PER_GROUP)
    hive_write = time.perf_counter() - t0
    del table
    # the group keys' and the date's statistics, which footers do not
    # give, so that Q1 and Q6 reach the fused gate with the decimals'
    # footer bounds
    t0 = time.perf_counter()
    s.execute("analyze hive.default.lineitem (l_returnflag, l_linestatus, l_shipdate)")
    hive_analyze = time.perf_counter() - t0
    hsecs = {}
    undo = _timed(hive_mod.HivePageSource, "_to_column", hsecs)
    undo_read = _timed(hive_mod.pq.ParquetFile, "read_row_group", hsecs)
    try:
        hwalls, hpages, hfused = {}, {}, {}
        for q in ("Q6", "Q1"):
            sql = qs[q].replace("from lineitem", "from hive.default.lineitem")
            hwalls[q] = []
            for _ in range(1 + LAKE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hpages[q] = s.execute(sql)
                torch.cuda.synchronize()
                hwalls[q].append(time.perf_counter() - t0)
            prof = s.last_kernel_profile
            hfused[q] = (prof.get("fusedAggregates") or 0, prof.get("lastFusionReject"))
    finally:
        undo()
        undo_read()
    check_reference(hpages, host, dicts)
    if hpages["Q6"].to_pylist() != pages[("Q6", 1)].to_pylist():
        raise AssertionError("hive Q6 differs from the lake's version 1")
    for q in ("Q6", "Q1"):
        _log(f"[hive] {q} megakernels=auto (fused aggregates {hfused[q][0]}, last "
             f"fusion reject {hfused[q][1]!r}): cold {hwalls[q][0] * 1e3:.3f} ms, warm "
             f"{', '.join(f'{x * 1e3:.3f}' for x in hwalls[q][1:])} ms")
    path = os.path.join(hive_dir, "lineitem", "part-0.parquet")
    md = pq.ParquetFile(path).metadata
    lo, hi = i_lo, i_hi
    ci = md.schema.names.index("l_orderkey")
    want = sum(1 for g in range(md.num_row_groups)
               if not (md.row_group(g).column(ci).statistics.max < lo
                       or md.row_group(g).column(ci).statistics.min > hi))
    rng_sql = (f"select count(*), sum(l_quantity) from hive.default.lineitem "
               f"where l_orderkey between {lo} and {hi}")
    splits = s.catalogs.get("hive").split_manager().get_splits(
        "lineitem", 1, (("l_orderkey", float(lo), float(hi)),))
    rng = s.execute(rng_sql)
    got = rng.to_pylist()[0]
    if (len(splits) != want or got[0] != int(ins.sum())
            or _raw(rng.columns[1], 0) != int(host["l_quantity"][ins].sum())):
        raise AssertionError(f"range scan read {len(splits)} row groups (footers say "
                             f"{want}), answered {got}")
    _log(f"[hive] write_parquet_table {hive_write:.3f} s ({os.path.getsize(path)} bytes, "
         f"{md.num_row_groups} row groups), ANALYZE of three columns {hive_analyze:.3f} s; "
         f"seconds reading row groups "
         f"{hsecs.get('read_row_group', 0):.3f} and converting them "
         f"{hsecs.get('_to_column', 0):.3f}; the l_orderkey range [{lo}, {hi}] read "
         f"{len(splits)} of {md.num_row_groups} row groups ({md.num_row_groups - len(splits)} "
         f"pruned, as the footer statistics say), {got[0]} rows; Q1 and Q6 over hive "
         f"equal the lake's and the numpy references")
    del s, host, v2, v3, versions, pages, hpages
    gc.collect()
    torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: the observatories (query history, doctor, compile observatory
# and compile cache, system catalog, access control)


OBS_SF = 10.0
OBS_WARM = 2                 # warm runs after the cold one
OBS_TURNS = 4                # (on, off, off, on) rounds of the overhead turns
OBS_CHILD_SF = 0.01          # the cold-build subprocesses' scale

# a subprocess on a fresh compile_cache_dir: its session's prewarm builds
# (or loads) the four libraries, then Q6 runs; prints the observatory's
# ledger as JSON.  With forbid_nvcc set, any nvcc run raises.
_BUILD_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from trino_tpu_torch.obs import compile_observatory as co
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.session import tpch_session
if sys.argv[4] == "1":
    def _no_nvcc():
        raise RuntimeError("nvcc run on a warm compile_cache_dir")
    kn._nvcc = _no_nvcc
s = tpch_session(float(sys.argv[3]), result_cache=False, compile_cache_dir=sys.argv[2],
                 compile_prewarm=True)
boot = len(co.get_observatory().tail())
page = s.execute(sys.argv[5])
kn.reset_counts()
s.execute(sys.argv[5])
print(json.dumps({"events": co.get_observatory().tail(), "boot": boot,
                  "prewarm": s.last_prewarm, "rows": page.count,
                  "warm_launches": dict(kn.LAUNCHES), "build_dir": kn.build_dir()},
                 default=str))
"""

# a subprocess that runs Q1 at SF10 on the card (in memory, as the main
# path) with the history, journal and observatory directories set; the
# unfused path's first grouped sum announces itself and stalls, so the
# parent's SIGKILL lands mid-query
_KILL_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from trino_tpu_torch.memory import detect_device_bytes
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.session import tpch_session
s = tpch_session(float(sys.argv[2]), result_cache=False, query_history_dir=sys.argv[3],
                 event_journal_dir=sys.argv[4], compile_observatory_dir=sys.argv[5],
                 query_max_memory_bytes=detect_device_bytes())
s.execute("select count(*) from nation")  # a finished query before the crash
real = kn.grouped_sum_i64
def stalled(*args):
    out = real(*args)
    print("MID-QUERY", flush=True)
    time.sleep(300)
    return out
kn.grouped_sum_i64 = stalled
s.execute(sys.argv[6])
"""


@contextlib.contextmanager
def _observatories(s, on, dirs):
    """The session's observatories on (the history, journal and compile
    observatory on disk, the doctor at finalize) or off (no history
    record, no doctor, journal and observatory in memory) meanwhile."""
    from trino_tpu_torch.obs import compile_observatory as co
    from trino_tpu_torch.obs import journal

    keep = s.history
    if on:
        journal.configure(dirs["journal"])
        co.configure(dirs["compiles"])
    else:
        s.history = type("NoHistory", (), {"put": lambda self, entry: None})()
        journal.configure(None)
        co.configure(None)
    s.properties.set("query_doctor", bool(on))
    try:
        yield
    finally:
        s.history = keep
        s.properties.set("query_doctor", True)
        journal.configure(dirs["journal"])
        co.configure(dirs["compiles"])


def _obs_sql_reads(s, launches, finished, encoded):
    """system.* over SQL after the warm runs: every read must hold.
    `encoded`: the cold Q6 encoded its program (a fresh process) rather
    than finding it in the process's compile cache (an earlier phase's)."""
    from trino_tpu_torch.obs import compile_observatory as co

    def rows(sql):
        return s.execute(sql).to_pylist()

    done = rows("select query, state, error_code from system.runtime.completed_queries")
    ran = [r for r in done if r[0] in finished]
    if len(ran) < len(finished) * (1 + OBS_WARM) or any(r[1:] != ("FINISHED", "")
                                                       for r in ran):
        raise AssertionError(f"completed_queries: {ran}")
    compiles = rows("select cause, kernel, mode from system.runtime.compiles")
    if encoded != any(c == co.FIRST_COMPILE and k.startswith("fused_agg_sums:")
                      and m == "encode" for c, k, m in compiles) \
            or any(c not in co.CAUSES or c == co.SHAPE_MISS for c, _, _ in compiles):
        raise AssertionError(f"compiles: {compiles}")
    census = rows("select family, bucket, count, min_rows, max_rows "
                  "from system.runtime.shape_census")
    by_family = {}
    for fam, _b, n, _lo, _hi in census:
        by_family[fam] = by_family.get(fam, 0) + n
    if any(by_family.get(k, 0) != launches[k] for k in KERNEL_FNS):
        raise AssertionError(f"shape_census {by_family} against launches {launches}")
    diags = rows("select verdict, root_cause from system.runtime.diagnoses")
    if not diags or any(v != "HEALTHY" and rc != "fusion_reject" for v, rc in diags):
        raise AssertionError(f"diagnoses: {diags}")
    events = rows("select event_type, severity from system.runtime.events")
    if any(sev == "error" for _t, sev in events):
        raise AssertionError(f"error events on a healthy run: {events}")
    nodes = rows("select node_id, state, device_state, device_strikes "
                 "from system.runtime.nodes")
    if nodes != [("local", "active", "ACTIVE", 0)]:
        raise AssertionError(f"nodes: {nodes}")
    caches = {r[0]: r[1:] for r in rows(
        "select name, hits, misses, puts from system.runtime.caches")}
    if caches["scan_cache"][0] <= 0 or caches["compile_cache"][0] <= 0 \
            or caches["result_cache"][2] != 0:
        raise AssertionError(f"caches: {caches}")
    memory = rows("select pool, size_bytes from system.runtime.memory")
    if sorted(p for p, _ in memory) != ["device", "general", "reserved"]:
        raise AssertionError(f"memory: {memory}")
    names = {r[0] for r in rows("select name from system.runtime.metrics")}
    want = {"trino_tpu_doctor_diagnoses_total", "trino_tpu_journal_events_total",
            "trino_tpu_cache_op_total", "trino_tpu_compile_events_total",
            "trino_tpu_device_state", "trino_tpu_memory_pool_size_bytes"}
    if not want <= names:
        raise AssertionError(f"metrics lack {want - names}")
    _log(f"[obs] SQL: {len(ran)} finished queries of this phase in completed_queries; "
         f"compiles {compiles}; shape_census {len(census)} rows, launches by family "
         f"{by_family}; {len(diags)} diagnoses "
         f"{sorted(set(diags))}; {len(events)} events; nodes {nodes}; caches "
         f"{caches}; memory {memory}; {len(names)} metric names")


def _obs_host_costs(s, qs):
    """The observatories' host work per query, each piece timed alone on
    the card's host (host clock over many calls, in µs a call)."""
    from trino_tpu_torch.obs import compile_observatory as co

    plan = s.plan(qs["Q6"])
    cc = s.caches.compile_cache
    key = next(iter(cc._entries))
    now = time.time()
    entry = {"query_id": "q_cost", "sql": qs["Q1"], "state": "FINISHED",
             "user": "user", "created": now, "finished": now, "rows": 4,
             "wall_s": 0.35}

    def per_call_us(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return round((time.perf_counter() - t0) / n * 1e6, 3)

    costs = {
        "history record on disk (two a query)": per_call_us(
            lambda: s.history.put(entry), 500),
        "doctor at finalize": per_call_us(
            lambda: s._finalize_doctor("q_cost", time.time() - 0.01), 200),
        "access walk of Q6's plan": per_call_us(
            lambda: s._check_plan_access(plan, s.identity), 2000),
        "compile-cache hit of Q6's program": per_call_us(
            lambda: cc.program(*key), 5000),
        "census observation of a launch": per_call_us(
            lambda: co.get_observatory().observe_launch("fused_agg_sums", 1), 20000),
        "the observatory's counts, read twice a query": per_call_us(
            lambda: co.get_observatory().counts_by_cause(), 20000),
    }
    _log(f"[obs] host cost a call, µs (the card's host): {json.dumps(costs)}")


def _obs_children():
    """The two cold-build subprocesses on one fresh compile_cache_dir."""
    import shutil
    import tempfile

    from trino_tpu_torch.obs import compile_observatory as co

    here = os.path.dirname(os.path.abspath(__file__))
    cdir = tempfile.mkdtemp(prefix="chip_smoke_cc_")
    q6 = _queries()[0]["Q6"]
    out = []
    try:
        for forbid in ("0", "1"):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-c", _BUILD_CHILD, here, cdir, str(OBS_CHILD_SF),
                 forbid, q6], capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cold-build child failed:\n{r.stderr[-3000:]}")
            doc = json.loads(r.stdout.strip().splitlines()[-1])
            doc["wall"] = time.perf_counter() - t0
            out.append(doc)
    finally:
        shutil.rmtree(cdir, ignore_errors=True)

    def causes(doc, mode):
        return [e["cause"] for e in doc["events"] if e["mode"] == mode]

    first, second = out
    if causes(first, "nvcc") != [co.FIRST_COMPILE] * 4 or \
            causes(first, "encode") != [co.FIRST_COMPILE]:
        raise AssertionError(f"first child's ledger: {first['events']}")
    if causes(second, "nvcc") != [co.PERSISTENT_LOAD] * 4 or \
            causes(second, "prewarm") != [co.PERSISTENT_LOAD] or \
            causes(second, "encode") or second["prewarm"]["entries"] != 1:
        raise AssertionError(f"second child's ledger: {second['events']}, prewarm "
                             f"{second['prewarm']}")
    for doc in out:
        if doc["warm_launches"]["fused_agg_sums"] != 1 or doc["rows"] != 1:
            raise AssertionError(f"a child's Q6 did not run on the card: {doc}")
    walls = [e["compileWallS"] for e in first["events"] if e["mode"] == "nvcc"]
    _log(f"[obs] cold-build children on one fresh compile_cache_dir: first "
         f"{causes(first, 'nvcc')} (nvcc walls {[round(w, 3) for w in walls]} s) + "
         f"{causes(first, 'encode')} encode, {first['wall']:.1f} s; second "
         f"{causes(second, 'nvcc')} + {causes(second, 'prewarm')} prewarm, no nvcc, "
         f"prewarm {second['prewarm']}, {second['wall']:.1f} s")


def _obs_sigkill(q1):
    """Q1 at SF10 in a subprocess killed mid-query: the history shows its
    RUNNING record, and the doctor finds and diagnoses it from disk."""
    import signal
    import shutil
    import tempfile

    from trino_tpu_torch.obs import doctor, history, journal

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    hd, jd, cd = (os.path.join(root, k) for k in ("history", "journal", "compiles"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, here, str(OBS_SF), hd, jd, cd, q1],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if line.strip() != "MID-QUERY":
            proc.kill()
            raise AssertionError(f"the child never reached Q1's kernels:\n"
                                 f"{proc.stderr.read()[-3000:]}")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    try:
        records = history.read_history_dir(hd)
        latest = {}
        for r in records:
            latest[r["queryId"]] = r
        running = [r for r in latest.values() if r["state"] == "RUNNING"]
        if len(running) != 1 or running[0]["sql"] != q1:
            raise AssertionError(f"history after the kill: {latest}")
        qid = running[0]["queryId"]
        events = journal.read_journal_dir(jd)
        if doctor.find_crashed_query(events, records) != qid:
            raise AssertionError(f"find_crashed_query missed {qid}: {events}")
        diag = doctor.diagnose_from_dir(jd, history_dir=hd)
        if diag is None or diag["queryId"] != qid or not diag["eventIds"]:
            raise AssertionError(f"diagnose_from_dir: {diag}")
        _log(f"[obs] SIGKILL mid-query (child exit {proc.returncode}, "
             f"{time.perf_counter() - t0:.1f} s): history RUNNING {qid}; "
             f"find_crashed_query -> {qid}; diagnose_from_dir -> {diag['verdict']} "
             f"{diag['rootCause']} [events {diag['eventIds']}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_obs(dev):
    """The observatories on the card in a TPC-H SF10 session of its own
    (generated on the card) with the history, journal and compile
    observatory on disk: Q6, Q1 (megakernels auto and off) and Q3 cold
    once and warm twice against the numpy references, every kernel
    launching, the warm runs recording no compile event; the system
    tables over SQL; HEALTHY for a warm Q6; a seeded device_loss on
    fused_agg_sums diagnosed as device_fault with cited events and an
    errorCode, then the canary; a denied Q6 that loads no scan and runs
    no kernel; the two cold-build subprocesses; the SIGKILL post-mortem;
    the observatories' cost on warm Q6, Q1 and Q3, in turns."""
    import gc
    import shutil
    import tempfile

    from trino_tpu_torch import convert
    from trino_tpu_torch.obs import compile_observatory as co
    from trino_tpu_torch.obs import doctor, history, journal
    from trino_tpu_torch.ops import kernels as kn
    from trino_tpu_torch.security import AccessDeniedError, FileBasedAccessControl
    from trino_tpu_torch.session import tpch_session

    qs, _ = _queries()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    dirs = {k: os.path.join(root, k) for k in ("history", "journal", "compiles")}
    journal._reset_journal()
    doctor._reset_diagnoses()
    co._reset_observatory()
    backoff = 0.05
    s = _card_session(tpch_session, OBS_SF, query_history_dir=dirs["history"],
                      event_journal_dir=dirs["journal"],
                      compile_observatory_dir=dirs["compiles"],
                      device_probe_backoff_s=backoff)
    obs = co.get_observatory()
    runs = [("Q6", "auto"), ("Q1", "auto"), ("Q1", "off"), ("Q3", "auto")]
    kn.reset_counts()
    cc = s.caches.compile_cache
    pages, per_run = {}, {r: dict.fromkeys(KERNEL_FNS, 0) for r in runs}
    for rep in range(1 + OBS_WARM):
        for q, mode in runs:
            s.properties.set("megakernels", mode)
            n_events, before, hits = len(obs.tail()), dict(kn.LAUNCHES), cc.hits
            t0 = time.perf_counter()
            pages[(q, mode)] = s.execute(qs[q])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            new = obs.tail()[n_events:]
            if rep:
                for name in KERNEL_FNS:
                    per_run[(q, mode)][name] += kn.LAUNCHES[name] - before[name]
                if new:
                    raise AssertionError(f"warm {q} megakernels={mode} recorded "
                                         f"compiles {new}")
            d = s.last_diagnosis
            _log(f"[obs] {'warm' if rep else 'cold'} {q} megakernels={mode}: "
                 f"{wall * 1e3:.3f} ms, {len(new)} compile events "
                 f"{[(e['cause'], e['mode']) for e in new]}, doctor {d['verdict']}"
                 f"{' ' + d['rootCause'] if d['rootCause'] else ''}")
            if q == "Q6" and rep and d["verdict"] != doctor.HEALTHY:
                raise AssertionError(f"warm Q6 diagnosed {d}")
            if q == "Q6" and not rep:
                # a fresh process encodes the program; after the main path
                # this session finds it in the process's compile cache
                encoded = [(e["cause"], e["mode"]) for e in new] == [
                    (co.FIRST_COMPILE, "encode")]
                if not encoded and (new or cc.hits != hits + 1):
                    raise AssertionError(f"cold Q6: compiles {new}, cache hits "
                                         f"{cc.hits - hits}")
                _log(f"[obs] cold Q6 "
                     + ("encoded its program" if encoded else
                        "found its program in the process's compile cache"))
    launches = dict(kn.LAUNCHES)
    for path, want in MAIN_WANT.items():
        for name, per in want.items():
            if per_run[path][name] < per * OBS_WARM:
                raise AssertionError(f"{path}: {name} launched {per_run[path][name]} "
                                     f"times in {OBS_WARM} warm runs")
    convert.assert_pages_identical(pages[("Q1", "auto")], pages[("Q1", "off")])
    cols, dicts = _scan_host_columns(s, ["l_tax", "l_returnflag", "l_shipdate"])
    if "pages" in MAIN:
        # the main path's pages, which met the numpy references over the
        # same generated data: Q6 against numpy again, Q1 and Q3 byte for
        # byte against them (the references at SF10 take seconds)
        check_reference({"Q6": pages[("Q6", "auto")]}, cols, dicts)
        for key in runs:
            convert.assert_pages_identical(pages[key], MAIN["pages"][key])
        how = "Q6 the numpy reference, Q1 and Q3 the main path's pages"
    else:
        check_reference({"Q6": pages[("Q6", "auto")], "Q1": pages[("Q1", "auto")]},
                        cols, dicts)
        check_q3_page(s, pages[("Q3", "auto")])
        how = "the numpy references"
    _log(f"[obs] Q6/Q1/Q3 agree with {how}; launches over the "
         f"phase's runs {launches}; warm, per query: "
         f"{ {f'{q} {m}': {k: v for k, v in n.items() if v} for (q, m), n in per_run.items()} }")
    # completed_queries keeps a statement's first 200 characters
    _obs_sql_reads(s, launches, {qs[q][:200] for q, _ in runs}, encoded)
    recs = history.read_history_dir(dirs["history"])
    ondisk = co.read_observatory_dir(dirs["compiles"])
    if [e["compileId"] for e in ondisk] != [e["compileId"] for e in obs.tail()]:
        raise AssertionError("the observatory's segments lost events")
    _log(f"[obs] on disk: {len(recs)} history records, {len(ondisk)} compile events, "
         f"{len(journal.read_journal_dir(dirs['journal']))} journal events")

    # the observatories' cost on warm Q6, Q1 and Q3, in turns
    timed = [("Q6", "auto"), ("Q1", "auto"), ("Q3", "auto")]
    walls = {(q, how): [] for q, _ in timed for how in ("on", "off")}
    for how in ("on", "off", "off", "on") * OBS_TURNS:
        with _observatories(s, how == "on", dirs):
            for q, mode in timed:
                s.properties.set("megakernels", mode)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.execute(qs[q])
                torch.cuda.synchronize()
                walls[(q, how)].append(time.perf_counter() - t0)
    main_walls = MAIN.get("walls") or {}
    for q, mode in timed:
        on = statistics.median(walls[(q, "on")]) * 1e3
        off = statistics.median(walls[(q, "off")]) * 1e3
        main = main_walls.get((q, mode))
        _log(f"[obs] overhead warm {q} megakernels={mode}: observatories on median "
             f"{on:.3f} ms, off {off:.3f} ms ({len(walls[(q, 'on')])} runs each, in "
             f"turns), difference {on - off:.3f} ms (on: "
             f"{', '.join(f'{x * 1e3:.3f}' for x in walls[(q, 'on')])}; off: "
             f"{', '.join(f'{x * 1e3:.3f}' for x in walls[(q, 'off')])}); main path "
             + (f"{statistics.median(main) * 1e3:.3f} ms" if main else "not run"))
    _obs_host_costs(s, qs)
    _log(f"[obs] runs, SQL reads and turns in {time.perf_counter() - t_phase:.1f} s")

    # a seeded device loss at the fused kernel, diagnosed; then the canary
    s.properties.set("megakernels", "auto")
    s.properties.set("fault_injection", json.dumps(
        {"device_loss": {"match": "fused_agg_sums", "nth": 1}}))
    _expect_fault(s, qs["Q6"], "device_loss", "fused_agg_sums")
    d = s.last_diagnosis
    ids = {e["eventId"]: e["eventType"] for e in journal.get_journal().tail()}
    if (d["rootCause"] != "device_fault" or d["errorCode"] != "DEVICE_LOSS"
            or not d["eventIds"] or not set(d["eventIds"]) <= set(ids)
            or "CPU degraded" in d["summary"]):
        raise AssertionError(f"device loss diagnosed {d}")
    failed = [r for r in s.query_history if r["state"] == "FAILED"]
    if failed[-1]["error_code"] != "DEVICE_LOSS":
        raise AssertionError(f"history of the failed Q6: {failed[-1]}")
    s.properties.set("fault_injection", "")
    _recover(s, backoff)
    page = s.execute(qs["Q6"])
    check_reference({"Q6": page}, cols, dicts)
    _log(f"[obs] device loss: {doctor.format_diagnosis(d)!r} (cited "
         f"{[ids[i] for i in d['eventIds']]}); the canary restored the device; Q6 "
         f"again {s.last_diagnosis['verdict']}")

    # access control before the card: a denied Q6 loads and launches nothing
    s.access_control.add(FileBasedAccessControl({"catalogs": [
        {"user": "analyst", "catalog": "tpch", "allow": "read-only"}]}))
    before, misses = dict(kn.LAUNCHES), s._scan_cache.misses
    hits = s._scan_cache.hits
    try:
        s.execute(qs["Q6"])
        raise AssertionError("Q6 ran for a user the rules deny")
    except AccessDeniedError as e:
        denied = str(e)
    if dict(kn.LAUNCHES) != before or (s._scan_cache.misses, s._scan_cache.hits) != (
            misses, hits):
        raise AssertionError("the denied Q6 reached the card")
    s.execute(qs["Q6"], user="analyst")
    if kn.LAUNCHES["fused_agg_sums"] != before["fused_agg_sums"] + 1:
        raise AssertionError("the allowed Q6 did not run on the card")
    s.access_control.controls.clear()
    _log(f"[obs] denied Q6: {denied}; no launch, no scan; as analyst: one fused launch")
    if s.device_supervisor.device_state() != "ACTIVE":
        raise AssertionError(f"the phase ends {s.device_supervisor.device_state()}")
    _log(f"[obs] launches over the phase (cold, warm, turns, fault, canary, "
         f"access): {dict(kn.LAUNCHES)}")
    del s, cols, dicts, pages, page
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[obs] the session's part in {time.perf_counter() - t_phase:.1f} s")
    _obs_children()
    _obs_sigkill(qs["Q1"])
    journal._reset_journal()
    co._reset_observatory()
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------


def _track_supervisors():
    """Keep every session's device supervisor (SUPERVISED), so a phase
    can be held to no fault."""
    from trino_tpu_torch import session as tsession

    init = tsession.Session.__init__

    def tracked(self, *args, **kw):
        init(self, *args, **kw)
        SUPERVISED.append(self.device_supervisor)

    tsession.Session.__init__ = tracked
    SUPERVISED.clear()


def _check_supervisors(name):
    """With the fault injector off, every session made so far (a phase
    may reuse an earlier phase's) must end the phase with its supervisor
    ACTIVE and no fault."""
    bad = [(sup.device_state(), sup.faults()) for sup in SUPERVISED
           if sup.device_state() != "ACTIVE" or sup.faults()]
    if bad:
        raise AssertionError(f"{name}: supervisors (state, faults) {bad}")
    _log(f"[supervisor] after {name}: {len(SUPERVISED)} sessions so far, every "
         f"supervisor ACTIVE, 0 faults")


def main(argv=None) -> int:
    global MAIN_REPS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", default="all",
                    choices=["all", "kernels", "gen", "session", "main", "ext", "ooc",
                             "ds", "faults", "lake", "obs", "mesh", "server", "fte",
                             "multihost"],
                    help="run only the build and kernel phases, only the build "
                         "and the SF10 on-device generator against the host "
                         "generator, only the build and the SF1 session "
                         "statements, only the build "
                         "and the SF10 main path (which also runs on the package "
                         "of an earlier commit, for comparisons), only the build "
                         "and the SF10 array/JSON/write phase (in a fresh session), "
                         "only the build and the out-of-core phase (streaming and "
                         "spill under 8 GiB, 1 GiB and 256 MiB limits), only "
                         "the build and the TPC-DS path, only the build and the "
                         "fault path (seeded faults, supervisor, canary, watchdog), "
                         "only the build and the lakehouse/hive path, or only the build "
                         "and the observatories (history, doctor, compile observatory and "
                         "cache, system catalog, access control), only the build and the "
                         "mesh (distributed = true over 8 shards on the card), only the "
                         "build and the server path (a coordinator and workers on the card, "
                         "through the statement client), or only the build and fault-"
                         "tolerant execution (retry_policy = task over the spool, seeded "
                         "faults, coordinator recovery, the autoscaler), or only the "
                         "build and the cross-host mesh (worker processes as hosts, each "
                         "running slices over its own shards of the card)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm run of each SF10 query; in the fte phase, "
                         "also break down Q3 partitioned's spool read")
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
    elif args.phase == "ds":
        phases.append(("ds", lambda: phase_ds(dev, args.profile)))
    elif args.phase == "ext":
        phases.append(("ext", lambda: phase_ext(dev, args.profile)))
    elif args.phase == "ooc":
        phases.append(("ooc", lambda: phase_ooc(dev, args.profile)))
    elif args.phase == "gen":
        phases.append(("gen", lambda: phase_gen(dev)))
    elif args.phase == "session":
        phases.append(("session", lambda: phase_session(dev)))
    elif args.phase == "faults":
        phases.append(("faults", lambda: phase_faults(dev)))
    elif args.phase == "lake":
        phases.append(("lake", lambda: phase_lake(dev)))
    elif args.phase == "obs":
        phases.append(("obs", lambda: phase_obs(dev)))
    elif args.phase == "mesh":
        phases.append(("mesh", lambda: phase_mesh(dev, args.profile)))
    elif args.phase == "server":
        phases.append(("server", lambda: phase_server(dev)))
    elif args.phase == "fte":
        phases.append(("fte", lambda: phase_fte(dev, args.profile)))
    elif args.phase == "multihost":
        phases.append(("multihost", lambda: phase_multihost(dev)))
    else:
        phases.append(("kernels", lambda: phase_kernels(dev)))
    if args.phase == "all":
        phases += [
            ("gen", lambda: phase_gen(dev)),
            ("sf1", lambda: phase_sf1(dev)),
            ("session", lambda: phase_session(dev)),
            main_path,
            ("rel", lambda: phase_sf10_rel(dev, args.profile)),
            ("ext", lambda: phase_ext(dev, args.profile)),
            ("timing", lambda: phase_timing(dev)),
            ("mesh", lambda: phase_mesh(dev, args.profile)),
            ("server", lambda: phase_server(dev)),
            ("fte", lambda: phase_fte(dev, args.profile)),
            ("multihost", lambda: phase_multihost(dev)),
            ("ooc", lambda: phase_ooc(dev, args.profile)),
            ("ds", lambda: phase_ds(dev, args.profile)),
            ("faults", lambda: phase_faults(dev)),
            ("lake", lambda: phase_lake(dev)),
            ("obs", lambda: phase_obs(dev)),
        ]
    _track_supervisors()
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        first = len(SUPERVISED)
        try:
            fn()
            if name in ("faults", "obs"):  # the phases that inject faults
                del SUPERVISED[first:]
            else:
                _check_supervisors(name)
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
        # the mesh, server, FTE and cross-host paths' launches of each
        # kernel beside the main path's (multihost: summed over the hosts'
        # slice tasks, counted in the host processes)
        for row in MAIN["kernels"]:
            row["mesh_launches"] = MAIN.get("mesh_launches", {}).get(row["name"])
            row["server_launches"] = MAIN.get("server_launches", {}).get(row["name"])
            row["fte_launches"] = MAIN.get("fte_launches", {}).get(row["name"])
            row["multihost_launches"] = MAIN.get("multihost_launches", {}).get(row["name"])
        print(json.dumps({"kernels": MAIN["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
