"""The port's kernels (trino_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels (the direct probe's parity tests are in
tests/test_torch_join.py).

On the CPU each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, as its own tests do.  Inputs
are made with numpy from fixed seeds and every comparison is exact
(integer sums and counts).  The fused kernel's per-row work is a postfix
program on the port's side and the equivalent closure on the JAX side;
the closure is built by interpreting the same program over jnp tiles.
"""
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
    return out


@pytest.mark.parametrize("case", _fused_cases(), ids=lambda c: c[0])
def test_fused_agg_sums_plain_matches_jax_interpret(case):
    _label, cols, live, prog, groups = case
    tcols = [torch.as_tensor(np.asarray(c, np.int32)) for c in cols]
    got = kn.fused_agg_sums(tcols, torch.as_tensor(live), prog, groups)
    jcols = {f"c{i}": jnp.asarray(np.asarray(c, np.int32)) for i, c in enumerate(cols)}
    want = np.asarray(jpk.fused_agg_sums(
        jcols, jnp.asarray(live), _emit(prog), len(prog.terms), groups,
        interpret=True,
    ))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


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
    with pytest.raises(ValueError):  # int64 column
        kn.fused_agg_sums([torch.zeros(4, dtype=torch.int64)], live, prog, 1)
    with pytest.raises(ValueError):  # LOAD beyond the column list
        kn.fused_agg_sums([], live, prog, 1)
    with pytest.raises(ValueError):  # stack underflow
        kn.check_program(kn.Program((), (), (((kn.ADD, 0),),)), 1, 1)
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
    for _label, cols, live, prog, groups in _fused_cases():
        tcols = [torch.as_tensor(np.asarray(c, np.int32), device=dev) for c in cols]
        tl = torch.as_tensor(live, device=dev)
        assert torch.equal(kn.fused_agg_sums(tcols, tl, prog, groups),
                           kn.fused_agg_sums_plain(tcols, tl, prog, groups))
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
