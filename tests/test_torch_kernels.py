"""The port's kernels (trino_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels (the direct probe's parity tests are in
tests/test_torch_join.py).

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, as its own tests do.  Inputs
are made with numpy from fixed seeds and every comparison is exact
(integer sums and counts).  The fused kernel's per-row work is a postfix
program on the port's side and the equivalent closure on the JAX side;
the closure is built by interpreting the same program over jnp tiles.
The straight-line encoding that the CUDA kernel runs is held against the
postfix programs by a test-only evaluator of its own.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.ops import pallas_kernels as jpk
from trino_tpu_torch.ops import kernels as kn

L, C = kn.LOAD, kn.CONST


def _jnp_eval(code, tiles):
    """Interpret a postfix program over jnp tiles (the JAX-side emit)."""
    st = []
    for op, imm in code:
        if op == kn.LOAD:
            st.append(tiles[f"c{imm}"])
        elif op == kn.CONST:
            st.append(jnp.int32(imm))
        elif op in (kn.NEG, kn.LO16, kn.HI16, kn.NOT, kn.CLIP):
            a = st.pop()
            st.append({
                kn.NEG: lambda: -a,
                kn.LO16: lambda: a & 0xFFFF,
                kn.HI16: lambda: a >> 16,
                kn.NOT: lambda: (a == 0).astype(jnp.int32),
                kn.CLIP: lambda: jnp.clip(a, 0, imm - 1),
            }[op]())
        else:
            b = st.pop()
            a = st.pop()
            r = {
                kn.ADD: lambda: a + b, kn.SUB: lambda: a - b,
                kn.MUL: lambda: a * b, kn.EQ: lambda: a == b,
                kn.NE: lambda: a != b, kn.LT: lambda: a < b,
                kn.LE: lambda: a <= b, kn.GT: lambda: a > b,
                kn.GE: lambda: a >= b,
                kn.AND: lambda: (a != 0) & (b != 0),
                kn.OR: lambda: (a != 0) | (b != 0),
            }[op]()
            st.append(r.astype(jnp.int32))
    return st[-1]


def _emit(prog):
    def emit(tiles):
        p = _jnp_eval(prog.pred, tiles) != 0 if prog.pred else None
        g = _jnp_eval(prog.gid, tiles) if prog.gid else None
        vals = []
        for t in prog.terms:
            v = _jnp_eval(t, tiles)
            vals.append(jnp.broadcast_to(v, tiles["c0"].shape).astype(jnp.int32))
        return p, g, vals
    return emit


PLANES = (((L, 0), (kn.LO16, 0)), ((L, 0), (kn.HI16, 0)))
P_LO = ((L, 0), (kn.LO16, 0), (L, 1), (kn.MUL, 0))
P_HI = ((L, 0), (kn.HI16, 0), (L, 1), (kn.MUL, 0))


def _fused_cases():
    """(label, columns, live, program, groups): the cases of
    tests/test_megakernel.py's kernel unit tests, plus one program that
    uses every opcode on bounded values."""
    rng = np.random.default_rng(7)
    out = []
    out.append(("plane_recombination", [rng.integers(0, 2**30, 5000)],
                np.ones(5000, bool), kn.Program((), (), PLANES), 1))
    out.append(("all_lanes_saturated", [np.full(4096, (1 << 30) - 1)],
                np.ones(4096, bool), kn.Program((), (), PLANES), 1))
    rng = np.random.default_rng(11)
    a = rng.integers(90_000, 10_495_001, 3000)
    b = rng.integers(0, 32_768, 3000)
    out.append(("limb_split_product", [a, b], np.ones(3000, bool),
                kn.Program((), (), (
                    P_LO + ((kn.LO16, 0),), P_LO + ((kn.HI16, 0),),
                    P_HI + ((kn.LO16, 0),), P_HI + ((kn.HI16, 0),))), 1))
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 3, 2500)
    vals = rng.integers(0, 100_000, 2500)
    live = rng.random(2500) < 0.6
    out.append(("grouped_with_selection", [keys, vals], live,
                kn.Program((), ((L, 0),), (((C, 1),), ((L, 1),))), 3))
    out.append(("predicate_masks_rows", [np.arange(1000)], np.ones(1000, bool),
                kn.Program(((L, 0), (C, 100), (kn.LT, 0)), (), (((L, 0),),)), 1))
    rng = np.random.default_rng(5)
    n = 7000
    cols = [rng.integers(0, 100, n), rng.integers(-1, 6, n), rng.integers(0, 9, n)]
    pred = ((L, 0), (C, 50), (kn.LT, 0), (L, 1), (C, 3), (kn.EQ, 0),
            (kn.NOT, 0), (kn.AND, 0), (L, 2), (C, 7), (kn.GE, 0), (kn.OR, 0),
            (L, 0), (C, 90), (kn.LE, 0), (kn.AND, 0), (L, 2), (C, 1),
            (kn.NE, 0), (L, 0), (C, 5), (kn.GT, 0), (kn.OR, 0), (kn.AND, 0))
    gid = ((L, 1), (kn.CLIP, 5), (C, 4), (kn.MUL, 0), (L, 2), (kn.CLIP, 4),
           (kn.ADD, 0))
    terms = (((C, 1),), ((L, 0), (L, 1), (kn.ADD, 0)),
             ((L, 0), (L, 2), (kn.SUB, 0)), ((L, 2), (kn.NEG, 0)),
             ((L, 0), (L, 2), (kn.MUL, 0)), ((L, 0), (C, 70000), (kn.MUL, 0),
                                              (kn.LO16, 0)),
             ((L, 0), (C, 70000), (kn.MUL, 0), (kn.HI16, 0)))
    out.append(("every_opcode", cols, rng.random(n) < 0.8,
                kn.Program(pred, gid, terms), 20))
    # a SUM list wider than lineitem: 40 columns, one term each and one
    # over all of them
    n = 3000
    cols = [rng.integers(0, 1000, n) for _ in range(40)]
    every = ((L, 0),) + sum((((L, i), (kn.ADD, 0)) for i in range(1, 40)), ())
    out.append(("wide_sum_list_40_columns", cols, rng.random(n) < 0.9,
                kn.Program(((L, 0), (C, 500), (kn.LT, 0), (L, 39), (C, 10), (kn.GE, 0),
                            (kn.AND, 0)), ((L, 1), (kn.CLIP, 3)),
                           tuple(((L, i),) for i in range(40)) + (every,)), 3))
    return out


def _jax_fused(cols, live, prog, groups):
    """The JAX fused_agg_sums in interpret mode on lanes prepared as the
    reference's runner prepares them: astype(int32), live & ok."""
    jcols = {f"c{i}": jnp.asarray(np.asarray(c).astype(np.int32))
             for i, c in enumerate(cols)}
    return np.asarray(jpk.fused_agg_sums(
        jcols, jnp.asarray(live), _emit(prog), len(prog.terms), groups,
        interpret=True,
    ))


@pytest.mark.parametrize("case", _fused_cases(), ids=lambda c: c[0])
def test_fused_agg_sums_plain_matches_jax_interpret(case):
    _label, cols, live, prog, groups = case
    tcols = [torch.as_tensor(np.asarray(c, np.int32)) for c in cols]
    got = kn.fused_agg_sums(tcols, [None] * len(cols), torch.as_tensor(live),
                            prog, groups)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _jax_fused(cols, live, prog, groups))


@pytest.mark.parametrize("case", _fused_cases(), ids=lambda c: c[0])
def test_fused_agg_sums_lanes_as_stored_match_jax_interpret(case):
    """int64 lanes holding values outside int32 (their low words are the
    case's values) and validity lanes with false entries, against the
    JAX kernel on the narrowed lanes and live & ok."""
    _label, cols, live, prog, groups = case
    rng = np.random.default_rng(len(live))
    wide = [np.asarray(c, np.int64) + (rng.integers(-3, 4, len(c)) << 32)
            for c in cols]
    oks = [rng.random(len(live)) < 0.9 for _ in cols]
    oks[0] = None  # a lane without validity
    got = kn.fused_agg_sums(
        [torch.as_tensor(c) for c in wide],
        [None if ok is None else torch.as_tensor(ok) for ok in oks],
        torch.as_tensor(live), prog, groups)
    jlive = live & np.logical_and.reduce([ok for ok in oks[1:]] or [live])
    assert any(int(c.max()) > 2**31 for c in wide)
    assert np.array_equal(got.numpy(), _jax_fused(wide, jlive, prog, groups))


def _rand_code(rng, n_cols, depth):
    """A random well-formed postfix program (chip_smoke.py's generator):
    full-range int32 constants, so folding wraps."""
    if depth == 0 or rng.random() < 0.25:
        if rng.random() < 0.6:
            return ((L, int(rng.integers(0, n_cols))),)
        return ((C, int(rng.integers(-(2**31), 2**31))),)
    if rng.random() < 0.3:
        op = int(rng.choice([kn.NEG, kn.LO16, kn.HI16, kn.NOT, kn.CLIP]))
        imm = int(rng.integers(1, 40)) if op == kn.CLIP else 0
        return _rand_code(rng, n_cols, depth - 1) + ((op, imm),)
    op = int(rng.choice([kn.ADD, kn.SUB, kn.MUL, kn.EQ, kn.NE, kn.LT,
                         kn.LE, kn.GT, kn.GE, kn.AND, kn.OR]))
    return (_rand_code(rng, n_cols, depth - 1)
            + _rand_code(rng, n_cols, depth - 1) + ((op, 0),))


def _run_encoded(enc, cols, live, groups, n_terms):
    """Test-only evaluator of the kernel's straight-line encoding
    (csrc/fused_agg.cu's semantics over whole numpy int32 columns)."""
    n = live.shape[0]
    slots = {s: np.asarray(cols[k]).astype(np.int32) for k, s in enc.col_slots}
    mask = live.copy()
    sums = np.zeros((n_terms, groups), np.int64)
    gid = None
    for i, (op, fl, dst, a, b) in enumerate(enc.ins):
        if i == enc.n_pre:
            gf, gv = enc.gid
            gid = np.full(n, gv, np.int32) if gf & kn.F_IMM else slots[gv]
            mask &= (gid >= 0) & (gid < groups)
        y = np.full(n, b, np.int32) if fl & kn.F_IMM else slots[b]
        if op == kn.ACC:
            np.add.at(sums[dst], gid[mask].astype(np.int64),
                      y[mask].astype(np.int64))
            continue
        x = slots.get(a)
        with np.errstate(over="ignore"):
            r = {
                kn.ADD: lambda: x + y, kn.SUB: lambda: x - y,
                kn.RSUB: lambda: y - x, kn.MUL: lambda: x * y,
                kn.EQ: lambda: x == y, kn.NE: lambda: x != y,
                kn.LT: lambda: x < y, kn.LE: lambda: x <= y,
                kn.GT: lambda: x > y, kn.GE: lambda: x >= y,
                kn.AND: lambda: (x != 0) & (y != 0),
                kn.OR: lambda: (x != 0) | (y != 0),
                kn.CLIP: lambda: np.clip(x, 0, y - 1),
                kn.NEG: lambda: -y, kn.LO16: lambda: y & 0xFFFF,
                kn.HI16: lambda: y >> 16, kn.NOT: lambda: y == 0,
                kn.MOV: lambda: y,
            }[op]().astype(np.int32)
        if fl & kn.F_MASK:
            mask &= r != 0
        if dst != kn.NO_DST:
            slots[dst] = r
    return sums


def _random_programs():
    rng = np.random.default_rng(2026)
    out = []
    for r in range(24):
        n, k = 3000, int(rng.integers(1, 5))
        groups = int(rng.integers(1, 33))
        cols = [rng.integers(-(2**31), 2**31, n) for _ in range(k)]
        cols.append(rng.integers(-1, groups + 2, n))
        gid = ((L, k), (kn.CLIP, groups)) if r % 3 else _rand_code(rng, k + 1, 2)
        pred = _rand_code(rng, k, 3) if r % 2 else ()
        terms = tuple(_rand_code(rng, k, int(rng.integers(1, 5)))
                      for _ in range(int(rng.integers(1, 12))))
        if r % 4 == 0:  # repeated subexpressions across every part
            shared = _rand_code(rng, k, 3)
            pred = shared + ((C, 7), (kn.GT, 0)) + (pred + ((kn.AND, 0),) if pred else ())
            terms = terms + tuple(shared + t + ((kn.ADD, 0),) for t in terms)
        out.append((f"random_{r}", cols, rng.random(n) < 0.9,
                    kn.Program(pred, gid, terms), groups))
    # constants that fold, with int32 wrap, down to a constant predicate
    # and constant terms
    big = ((C, 2**31 - 1), (C, 2), (kn.MUL, 0))
    out.append(("folding_with_wrap", [rng.integers(-5, 5, 500)],
                np.ones(500, bool),
                kn.Program(big + ((C, -2), (kn.EQ, 0)), (),
                           (big, big + ((kn.NEG, 0),), ((C, -(2**31)), (kn.NEG, 0)),
                            ((L, 0), (C, 3), (C, 4), (kn.MUL, 0), (kn.SUB, 0)))), 1))
    out.append(("predicate_never_true", [rng.integers(0, 9, 500)],
                np.ones(500, bool),
                kn.Program(((L, 0), (C, 0), (C, 1), (kn.GT, 0), (kn.AND, 0)), (),
                           (((C, 1),),)), 1))
    return out


@pytest.mark.parametrize("case", _random_programs() + _fused_cases(),
                         ids=lambda c: c[0])
def test_encoding_matches_postfix_programs(case):
    """The straight-line encoding, run by a test-only evaluator, gives
    exactly the sums of the postfix programs' plain version."""
    _label, cols, live, prog, groups = case
    kn.check_program(prog, len(cols), groups)
    enc = kn.encode(prog)
    want = kn.fused_agg_sums_plain(
        [torch.as_tensor(np.asarray(c, np.int64)) for c in cols],
        [None] * len(cols), torch.as_tensor(live), prog, groups)
    got = _run_encoded(enc, cols, live, groups, len(prog.terms))
    assert np.array_equal(got, want.numpy())
    assert len(enc.ins) <= kn.MAX_INS and enc.n_slots <= kn.MAX_SLOTS


def _deep_ops(cols, k0):
    """Products of columns and distinct constants summed right to left:
    stack depth len(cols) + 1, every operand a temporary."""
    return (sum((((L, c), (C, k0 + i), (kn.MUL, 0)) for i, c in enumerate(cols)), ())
            + ((kn.ADD, 0),) * (len(cols) - 1))


def _widest_program(k, groups):
    """k columns (the last the group id), 64 terms, a predicate and a
    term at the postfix kernel's stack limit of 16."""
    terms = [((L, t % (k - 1)),) for t in range(kn.MAX_TERMS)]
    terms[0] = _deep_ops(range(15), 101)
    return kn.Program(_deep_ops(range(k - 16, k - 1), 3) + ((C, 0), (kn.GT, 0)),
                      ((L, k - 1), (kn.CLIP, groups)), tuple(terms))


def _slot_pressure_program(n=250):
    """Two terms summing the same n products in opposite orders: shared,
    all n products stay live from one term to the other."""
    v = [((L, j % 16), (C, 1000 + j), (kn.MUL, 0)) for j in range(n)]
    return kn.Program((), (), tuple(
        w[0] + sum((x + ((kn.ADD, 0),) for x in w[1:]), ()) for w in (v, v[::-1])))


def _postfix_limit_programs():
    """(label, n_cols, program, groups): programs within the limits of
    the postfix kernel this one replaced (2,048 instructions, stack depth
    16, 64 terms, 32 groups), up to 73 columns."""
    rng = np.random.default_rng(99)
    out = [(f"73_columns_{g}_groups", 73, _widest_program(73, g), g) for g in (1, 32)]
    out.append(("250_products_live_across_terms", 16, _slot_pressure_program(), 1))
    terms, left = [], 2048 - 40
    for _ in range(kn.MAX_TERMS):  # lineitem's 16 columns, random programs
        t = _rand_code(rng, 16, 4)
        if len(t) <= left - (kn.MAX_TERMS - len(terms)):
            terms.append(t)
            left -= len(t)
        else:
            terms.append(((L, len(terms) % 16),))
            left -= 1
    out.append(("16_columns_64_random_terms", 16, kn.Program(
        _deep_ops(range(15), 7) + ((C, 0), (kn.NE, 0)), ((L, 15), (kn.CLIP, 32)),
        tuple(terms)), 32))
    return out


@pytest.mark.parametrize("case", _postfix_limit_programs(), ids=lambda c: c[0])
def test_programs_within_the_postfix_limits_fit_the_launch(case):
    """Every program the postfix kernel took over at most 73 columns
    passes check_program (no new Reject), encodes to no more instructions
    than its postfix code, and its encoding gives the plain sums."""
    _label, k, prog, groups = case
    codes = (prog.pred, prog.gid) + prog.terms
    assert sum(len(c) for c in codes) <= 2048
    assert max(kn.stack_depth(c) for c in codes) <= 16
    kn.check_program(prog, k, groups)
    enc = kn.encode(prog)
    assert len(enc.ins) <= sum(len(c) for c in codes)
    rng = np.random.default_rng(k)
    n = 2000
    cols = [rng.integers(-(2**31), 2**31, n) for _ in range(k - 1)]
    cols.append(rng.integers(-1, groups + 1, n))
    live = rng.random(n) < 0.9
    want = kn.fused_agg_sums_plain([torch.as_tensor(c) for c in cols], [None] * k,
                                   torch.as_tensor(live), prog, groups)
    assert np.array_equal(_run_encoded(enc, cols, live, groups, len(prog.terms)),
                          want.numpy())


def test_code_words_decode_as_the_kernel_reads_them():
    """Slots past 127 set the top bit of an instruction's first word:
    the kernel's signed shifts and masks still give each field back."""
    enc = kn.encode(_slot_pressure_program(120))
    assert enc.n_slots > 128
    words = list(kn._words(kn.encode(_slot_pressure_program(120))))
    assert any(w < 0 for w in words[0::2])
    got = [(x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, (x >> 24) & 0xFF, y)
           for x, y in zip(words[0::2], words[1::2])]
    assert got == list(enc.ins)


def test_encoding_without_sharing_matches_postfix_programs():
    """The encoding a program falls back to when shared values would
    take more than MAX_SLOTS slots, over the random programs: exact, and
    never more temporaries than the postfix stack depth."""
    for _label, cols, live, prog, groups in _random_programs() + _fused_cases():
        enc = kn._encode(prog, share=False)
        codes = (prog.pred, prog.gid) + prog.terms
        depth = max(kn.stack_depth(c) for c in codes)
        assert enc.n_slots <= len(enc.col_slots) + depth + 1
        want = kn.fused_agg_sums_plain(
            [torch.as_tensor(np.asarray(c, np.int64)) for c in cols],
            [None] * len(cols), torch.as_tensor(live), prog, groups)
        assert np.array_equal(_run_encoded(enc, cols, live, groups, len(prog.terms)),
                              want.numpy())


@pytest.fixture(scope="module")
def tpch_fused_calls():
    """The fused calls of the port's Q6 and Q1 (CPU, megakernels on)."""
    from tpch_sql import QUERIES
    from trino_tpu_torch.session import tpch_session

    calls = []
    real = kn.fused_agg_sums

    def shim(*args):
        calls.append(args)
        return real(*args)

    kn.fused_agg_sums = shim
    try:
        s = tpch_session(0.002, device="cpu", megakernels="on")
        for q in (6, 1):
            s.execute(QUERIES[q][0])
    finally:
        kn.fused_agg_sums = real
    return {"q6": calls[0], "q1": calls[1]}


@pytest.mark.parametrize("q,want", [("q6", (4, 11, 30)), ("q1", (7, 29, 93))])
def test_encoding_of_tpch_programs(tpch_fused_calls, q, want):
    """Q6's and Q1's programs: lanes as stored (int64 decimals, bool
    validity), folded and shared down to the instruction counts below,
    and the encoding's sums equal to the plain version's."""
    cols, valids, live, prog, groups = tpch_fused_calls[q]
    assert {c.dtype for c in cols} == {torch.int32, torch.int64}
    assert all(ok is not None and ok.dtype == torch.bool for ok in valids)
    enc = kn.encode(prog)
    postfix = len(prog.pred) + len(prog.gid) + sum(len(t) for t in prog.terms)
    assert (len(enc.col_slots), len(enc.ins), postfix) == want
    mask = live.numpy() & np.logical_and.reduce([ok.numpy() for ok in valids])
    got = _run_encoded(enc, [c.numpy() for c in cols], mask, groups,
                       len(prog.terms))
    assert np.array_equal(got, kn.fused_agg_sums_plain(
        cols, valids, live, prog, groups).numpy())


# Sizes around the CUDA kernels' unrolled steps (rows a thread and rows a
# block in one step: 8 and 2048 for grouped_sum_i64, 16 and 4096 for
# grouped_count), tiny sizes and the cap bucket edges 1/4/5/8/9/16/17/32.
@pytest.mark.parametrize("n,groups,lo,hi", [
    (300_000, 9, 0, 9),      # tests/test_pallas.py::test_grouped_count_exact
    (50_000, 12, -3, 15),    # out-of-range ids are skipped on both sides
    (4096, 32, 0, 32),       # the largest capacity the kernel takes
    (1, 12, 0, 12), (2, 12, -1, 13), (3, 12, 0, 12), (15, 12, -1, 13),
    (16, 12, 0, 12), (17, 12, -1, 13), (33, 12, 0, 12),
    (4095, 12, -1, 13), (4097, 12, -1, 13),
    (10_001, 1, -1, 2), (10_001, 4, 0, 4), (10_001, 5, -1, 6),
    (10_001, 8, 0, 8), (10_001, 9, 0, 9), (10_001, 16, 0, 16),
    (10_001, 17, -2, 19),
    (20_000, 12, 7, 8),      # every row in one group
    (20_000, 12, 12, 16),    # every id out of range
])
def test_grouped_count_plain_matches_jax_interpret(n, groups, lo, hi):
    rng = np.random.default_rng(3)
    flags = rng.integers(0, 2, n).astype(bool)
    gid = rng.integers(lo, hi, n)
    got = kn.grouped_count(torch.as_tensor(flags), torch.as_tensor(gid), groups)
    want = np.asarray(jpk.grouped_count(
        jnp.asarray(flags), jnp.asarray(gid), groups, interpret=True
    ))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,groups,lo,hi,vmag", [
    (100_000, 12, 0, 12, 2**40),      # Q1's capacity, ordinary magnitudes
    (50_000, 9, -3, 14, 2**40),       # out-of-range ids are skipped
    (70_000, 32, 0, 32, 2**63),       # full int64 range: the sums wrap
    (4096, 1, 0, 1, 2**63),           # one group of int64 extremes
    (1, 12, 0, 12, 2**40), (2, 12, -1, 13, 2**40), (3, 12, 0, 12, 2**40),
    (7, 12, -1, 13, 2**40), (8, 12, 0, 12, 2**40), (9, 12, -1, 13, 2**40),
    (15, 12, 0, 12, 2**40), (16, 12, -1, 13, 2**40), (17, 12, 0, 12, 2**40),
    (33, 12, -1, 13, 2**40), (2047, 12, 0, 12, 2**63),
    (2048, 12, -1, 13, 2**63), (2049, 12, 0, 12, 2**63),
    (10_001, 4, 0, 4, 2**63), (10_001, 5, -1, 6, 2**63),
    (10_001, 8, 0, 8, 2**63), (10_001, 9, 0, 9, 2**63),
    (10_001, 16, -2, 18, 2**63), (10_001, 17, 0, 17, 2**63),
    (20_000, 12, 7, 8, 2**63),        # every row in one group (wrapping)
    (20_000, 12, -3, 0, 2**40),       # every id out of range
])
def test_grouped_sum_i64_plain_matches_jax_interpret(n, groups, lo, hi, vmag):
    rng = np.random.default_rng(n + groups)
    vals = rng.integers(-vmag, vmag - 1, n, dtype=np.int64)
    if groups == 1:
        vals[:] = np.where(rng.random(n) < 0.5, 2**63 - 1, -(2**63))
    gid = rng.integers(lo, hi, n)
    got = kn.grouped_sum_i64(torch.as_tensor(vals), torch.as_tensor(gid), groups)
    want = np.asarray(jpk.grouped_sum_i64(
        jnp.asarray(vals), jnp.asarray(gid), groups, interpret=True
    ))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_grouped_count_all_flags_false_matches_jax_interpret():
    rng = np.random.default_rng(4)
    gid = rng.integers(0, 12, 4097)
    got = kn.grouped_count(torch.zeros(4097, dtype=torch.bool), torch.as_tensor(gid), 12)
    want = np.asarray(jpk.grouped_count(
        jnp.zeros(4097, bool), jnp.asarray(gid), 12, interpret=True
    ))
    assert np.array_equal(got.numpy(), want) and not want.any()


@pytest.mark.parametrize("voff,goff", [(1, 0), (0, 1), (1, 1), (5, 3)])
def test_grouped_kernels_on_views_match_jax_interpret(voff, goff):
    """Views at element offsets into larger tensors (on the card their
    base pointers lie off 16-byte alignment) give the same sums and
    counts as the JAX kernels on the same rows."""
    rng = np.random.default_rng(voff * 10 + goff)
    n = 4099
    vals = rng.integers(-(2**63), 2**63 - 1, n + voff, dtype=np.int64)
    flags = rng.random(n + voff) < 0.5
    gid = rng.integers(-1, 13, n + goff)
    tv, tf, tg = (torch.as_tensor(a) for a in (vals, flags, gid))
    got_s = kn.grouped_sum_i64(tv[voff:], tg[goff:], 12)
    got_c = kn.grouped_count(tf[voff:], tg[goff:], 12)
    want_s = np.asarray(jpk.grouped_sum_i64(
        jnp.asarray(vals[voff:]), jnp.asarray(gid[goff:]), 12, interpret=True))
    want_c = np.asarray(jpk.grouped_count(
        jnp.asarray(flags[voff:]), jnp.asarray(gid[goff:]), 12, interpret=True))
    assert np.array_equal(got_s.numpy(), want_s)
    assert np.array_equal(got_c.numpy(), want_c)


def test_seg_sum_routes_small_int64_sums_to_the_kernel(monkeypatch):
    """_seg_sum sends 1-D int64 sums at capacities <= 32 to
    grouped_sum_i64; floats and larger capacities stay segment sums."""
    from trino_tpu_torch.ops import aggregation as tagg

    calls = []

    def shim(v, g, cap):
        calls.append(cap)
        return kn.grouped_sum_i64_plain(v, g, cap)

    monkeypatch.setattr(kn, "grouped_sum_i64", shim)
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.integers(0, 40, 1000))
    v = torch.as_tensor(rng.integers(-(2**62), 2**62, 1000))
    small = g % 12
    want = torch.zeros(12, dtype=torch.int64).index_add_(0, small, v)
    assert torch.equal(tagg._seg_sum(v, small, 12), want)
    assert calls == [12]
    tagg._seg_sum(v, g, 40)
    tagg._seg_sum(v.double(), small, 12)
    assert calls == [12]


def test_seg_count_gate_mirrors_capacity_bound():
    v = torch.zeros(10, dtype=torch.bool)
    g = torch.zeros(10, dtype=torch.int64)
    assert kn.seg_count_maybe(v, g, kn.MAX_GROUPS + 1) is None
    assert kn.seg_count_maybe(v, g, 4).tolist() == [0, 0, 0, 0]
    assert kn.MAX_GROUPS == jpk.MAX_GROUPS


def test_wrappers_check_their_inputs():
    prog = kn.Program((), (), (((L, 0),),))
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):  # int16 column
        kn.fused_agg_sums([torch.zeros(4, dtype=torch.int16)], [None], live, prog, 1)
    with pytest.raises(ValueError):  # a validity lane that is not bool
        kn.fused_agg_sums([torch.zeros(4, dtype=torch.int64)],
                          [torch.ones(4, dtype=torch.uint8)], live, prog, 1)
    with pytest.raises(ValueError):  # no validity entry for the column
        kn.fused_agg_sums([torch.zeros(4, dtype=torch.int64)], [], live, prog, 1)
    with pytest.raises(ValueError):  # LOAD beyond the column list
        kn.fused_agg_sums([], [], live, prog, 1)
    with pytest.raises(ValueError):  # stack underflow
        kn.check_program(kn.Program((), (), (((kn.ADD, 0),),)), 1, 1)
    with pytest.raises(ValueError):  # more columns than the launch takes
        kn.check_program(prog, kn.MAX_COLS + 1, 1)
    with pytest.raises(ValueError):  # lanes beyond shared memory at 32 threads
        kn.check_program(_widest_program(74, 1), 74, 1)
    long = ((L, 0),) + sum((((C, 1000 + i), (kn.ADD, 0)) for i in range(40)), ())
    with pytest.raises(ValueError):  # more instructions than the launch takes
        kn.check_program(kn.Program((), (), tuple(
            ((L, 0),) + sum((((C, 7919 * t + i), (kn.ADD, 0)) for i in range(40)), ())
            for t in range(kn.MAX_TERMS))), 1, 1)
    assert len(kn.encode(kn.Program((), (), (long,))).ins) == 41
    with pytest.raises(ValueError):
        kn.grouped_count(torch.ones(3, dtype=torch.bool),
                         torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):  # capacity above the shared table
        kn.grouped_sum_i64(torch.zeros(3, dtype=torch.int64),
                           torch.zeros(3, dtype=torch.int64), kn.MAX_GROUPS + 1)
    with pytest.raises(ValueError):
        kn.grouped_sum_i64(torch.zeros(3, dtype=torch.int64),
                           torch.zeros(4, dtype=torch.int64), 2)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    for _label, cols, live, prog, groups in _fused_cases() + _random_programs():
        for dt in (np.int32, np.int64):
            tcols = [torch.as_tensor(np.asarray(c).astype(dt), device=dev) for c in cols]
            oks = [torch.as_tensor(np.arange(len(live)) % 7 != k, device=dev)
                   for k in range(len(cols))]
            tl = torch.as_tensor(live, device=dev)
            assert torch.equal(kn.fused_agg_sums(tcols, oks, tl, prog, groups),
                               kn.fused_agg_sums_plain(tcols, oks, tl, prog, groups))
    rng = np.random.default_rng(3)
    flags = torch.as_tensor(rng.integers(0, 2, 100_000).astype(bool), device=dev)
    gid = torch.as_tensor(rng.integers(-2, 14, 100_000), device=dev)
    assert torch.equal(kn.grouped_count(flags, gid, 12),
                       kn.grouped_count_plain(flags, gid, 12))
    vals = torch.as_tensor(rng.integers(-(2**63), 2**63 - 1, 100_000), device=dev)
    assert torch.equal(kn.grouped_sum_i64(vals, gid, 12),
                       kn.grouped_sum_i64_plain(vals, gid, 12))
    # aligned and misaligned views (int64 offsets 1 and 3 lie 8 bytes off
    # 16, flag offsets 1 to 15 off too) at ragged lengths and cap edges
    for voff, goff in ((0, 0), (1, 0), (0, 1), (1, 1), (2, 3), (5, 1)):
        for n in (1, 2, 17, 2049, 4097, 99_991):
            for cap in (1, 5, 12, 17, 32):
                v, f, g = vals[voff:voff + n], flags[voff:voff + n], gid[goff:goff + n]
                assert torch.equal(kn.grouped_sum_i64(v, g, cap),
                                   kn.grouped_sum_i64_plain(v, g, cap))
                assert torch.equal(kn.grouped_count(f, g, cap),
                                   kn.grouped_count_plain(f, g, cap))
    table = torch.as_tensor(rng.integers(0, 5000, 150_000).astype(np.int32), device=dev)
    key = torch.as_tensor(rng.integers(-10, 150_010, 100_000), device=dev)
    got = kn.direct_probe(table, key, flags, flags, 0)
    want = kn.direct_probe_plain(table, key, flags, flags, 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the probe's edges: slots that wrap (INT32_MIN), int32 keys, lengths
    # around a warp's tile and a block's tiles, views whose ok/sel start
    # 1-15 bytes off and whose keys start 8 (int64) or 4 (int32) bytes off
    table[::7] = -(2**31)
    table[1::7] = 2**31 - 1
    tile, block = kn.PROBE_TILE_ROWS, kn.PROBE_TILE_ROWS * kn.PROBE_WARPS
    for kdt in (torch.int64, torch.int32):
        k = key.to(kdt)
        for n in (0, 1, 15, 17, tile - 1, tile, tile + 1, block - 1, block + 1, 99_000):
            for koff, ooff, soff in ((0, 0, 0), (1, 1, 15), (1, 7, 3), (0, 13, 0)):
                args = (table, k[koff:koff + n], flags[ooff:ooff + n],
                        flags[soff:soff + n], -5)
                got = kn.direct_probe(*args)
                want = kn.direct_probe_plain(*args)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_concurrent_first_use_builds_and_loads_once(monkeypatch, tmp_path):
    """Eight threads of one process (a worker's tasks, two in-process
    workers on one card) ask for the same kernel's library together: one
    build runs and the library is loaded once; every thread gets that
    handle."""
    import ctypes
    import threading
    import time

    builds, loads = [], []

    def build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a build takes a while: the others arrive meanwhile
        return {}

    class Lib:
        def __init__(self, path):
            loads.append(path)
            for fn in ("grouped_count_launch",):
                setattr(self, fn, type("Fn", (), {})())

    monkeypatch.setattr(kn, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    monkeypatch.setattr(kn, "_LIBS", {})
    kn.set_build_dir(str(tmp_path))
    try:
        start = threading.Barrier(8)
        got = []

        def ask():
            start.wait()
            got.append(kn._lib("grouped_count"))

        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        kn.set_build_dir(None)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_build_names_its_temporary_library_per_thread(monkeypatch, tmp_path):
    """Two threads of one process building at once would write the same
    `lib*.so.<pid>.tmp`: the name carries the thread too."""
    import subprocess
    import threading

    seen = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])

        def communicate(self):
            return "stop here", None

    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(kn, "_nvcc", lambda: "nvcc")
    kn.set_build_dir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kn.build()
    finally:
        kn.set_build_dir(None)
    assert seen and all(
        p.endswith(f".{os.getpid()}.{threading.get_ident()}.tmp") for p in seen)
