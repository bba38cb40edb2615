"""The port's join and hash-sort grouping modules against the JAX package.

Each function of trino_tpu_torch/ops/join.py and the hash-sort path of
trino_tpu_torch/ops/aggregation.py runs on the same seeded numpy inputs
as its trino_tpu counterpart; every function here is integer, so every
comparison is exact (hashes bit for bit, including negative keys, NULLs,
multi-column and wide keys).  On the CPU the direct probe runs its plain
version (ops/kernels.direct_probe_plain).  The end of the file mirrors
the JAX package's join-exactness tests on the port's session: a weak
locator hash patched into the port's join module, and a forged direct
join annotation that stale statistics would give.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.ops.aggregation as jagg
import trino_tpu.ops.join as jjoin
import trino_tpu_torch.ops.aggregation as tagg
import trino_tpu_torch.ops.join as tjoin
from trino_tpu_torch.ops import kernels as kn


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64) if a.dtype == np.uint64 else a,
                          b.astype(np.int64) if b.dtype == np.uint64 else b), (a, b)


def _lane(v, ok):
    return ((jnp.asarray(v), jnp.asarray(ok)),
            (torch.as_tensor(v), torch.as_tensor(ok)))


def _keys(rng, n, lo=-50, hi=50, null=0.1):
    return rng.integers(lo, hi, n).astype(np.int64), rng.random(n) >= null


# -- merge_rank ---------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("nb,m", [(1000, 3000), (1, 50), (0, 10), (500, 0)])
def test_merge_rank_matches_jax(side, nb, m):
    rng = np.random.default_rng(nb + m)
    build = np.sort(rng.integers(-40, 40, nb)).astype(np.int64)
    probe = rng.integers(-50, 50, m).astype(np.int64)
    want = jjoin.merge_rank(jnp.asarray(build), jnp.asarray(probe), side)
    got = tjoin.merge_rank(torch.as_tensor(build), torch.as_tensor(probe), side)
    _eq(got, want)


# -- unique, direct and expansion joins -----------------------------------


@pytest.mark.parametrize("dup", [False, True])
def test_build_unique_and_probe_match_jax(dup):
    rng = np.random.default_rng(1 + dup)
    nb, m = 400, 2000
    if dup:
        bv = rng.integers(-300, 300, nb).astype(np.int64)
    else:
        bv = rng.choice(np.arange(-600, 600), nb, replace=False).astype(np.int64)
    bv[:3] = [2**63 - 1, -(2**63), 2**62]  # the sentinel region is a value
    bok = rng.random(nb) > 0.1
    bsel = rng.random(nb) > 0.2
    pv = np.concatenate([bv[:50], rng.integers(-700, 700, m - 50)]).astype(np.int64)
    pok, psel = rng.random(m) > 0.1, rng.random(m) > 0.2
    (jb, tb), (jp, tp) = _lane(bv, bok), _lane(pv, pok)
    js = jjoin.build_unique(jb, jnp.asarray(bsel))
    ts = tjoin.build_unique(tb, torch.as_tensor(bsel))
    for a, b in zip(ts, js):
        _eq(a, b)
    assert (int(ts.dup_count) > 0) == dup
    jr = jjoin.probe(js, jp, jnp.asarray(psel))
    tr = tjoin.probe(ts, tp, torch.as_tensor(psel))
    _eq(tr[0], jr[0])
    _eq(tr[1], jr[1])


@pytest.mark.parametrize("case", ["unique", "duplicates", "out_of_domain"])
def test_build_direct_and_probe_direct_match_jax(case):
    rng = np.random.default_rng(7)
    lo, domain, nb, m = 1000, 5000, 1500, 20_000
    bv = lo + rng.choice(domain, nb, replace=False).astype(np.int64)
    if case == "duplicates":
        bv[10:20] = bv[:10]
    elif case == "out_of_domain":
        bv[:5] = [lo - 1, lo + domain, -(2**63), 2**63 - 1, 0]
    bok, bsel = rng.random(nb) > 0.05, rng.random(nb) > 0.1
    pv = np.concatenate([
        bv[:500], lo + rng.integers(-500, domain + 500, m - 505),
        np.array([-(2**63), 2**63 - 1, lo, lo + domain - 1, lo + domain]),
    ]).astype(np.int64)
    pok, psel = rng.random(m) > 0.1, rng.random(m) > 0.2
    (jb, tb), (jp, tp) = _lane(bv, bok), _lane(pv, pok)
    js = jjoin.build_direct(jb, jnp.asarray(bsel), lo, domain)
    ts = tjoin.build_direct(tb, torch.as_tensor(bsel), lo, domain)
    _eq(ts.table, js.table)
    assert int(ts.violations) == int(js.violations)
    assert (int(ts.violations) > 0) == (case != "unique")
    jr = jjoin.probe_direct(js, jp, jnp.asarray(psel))
    tr = tjoin.probe_direct(ts, tp, torch.as_tensor(psel))
    _eq(tr[0], jr[0])
    _eq(tr[1], jr[1])


@pytest.mark.parametrize("outer", [False, True])
def test_probe_counts_and_expand_join_slots_match_jax(outer):
    rng = np.random.default_rng(11 + outer)
    nb, m = 300, 500
    bv, bok = _keys(rng, nb, -30, 30)
    pv, pok = _keys(rng, m, -40, 40)
    bsel, psel = rng.random(nb) > 0.1, rng.random(m) > 0.1
    (jb, tb), (jp, tp) = _lane(bv, bok), _lane(pv, pok)
    js = jjoin.build_multi(jb, jnp.asarray(bsel))
    ts = tjoin.build_multi(tb, torch.as_tensor(bsel))
    for a, b in zip(ts, js):
        _eq(a, b)
    jc, jlo = jjoin.probe_counts(js, jp, jnp.asarray(psel))
    tc, tlo = tjoin.probe_counts(ts, tp, torch.as_tensor(psel))
    _eq(tc, jc)
    _eq(tlo, jlo)
    eff = np.maximum(_np(tc), 1) if outer else _np(tc)
    for capacity in (int(eff.sum()), int(eff.sum()) + 37):
        want = jjoin.expand_join_slots(js, jc, jlo, capacity, outer=outer)
        got = tjoin.expand_join_slots(ts, tc, tlo, capacity, outer=outer)
        for a, b in zip(got, want):
            _eq(a, b)


def test_verify_rows_and_gather_build_match_jax():
    rng = np.random.default_rng(5)
    n = 400
    b1, b2 = _keys(rng, n, 0, 5), _keys(rng, n, 0, 5)
    p1, p2 = _keys(rng, n, 0, 5), _keys(rng, n, 0, 5)
    row = rng.integers(0, n, n)
    matched = rng.random(n) > 0.3
    lanes = [_lane(*k) for k in (b1, b2, p1, p2)]
    want = jjoin.verify_rows([lanes[0][0], lanes[1][0]], [lanes[2][0], lanes[3][0]],
                             jnp.asarray(row))
    got = tjoin.verify_rows([lanes[0][1], lanes[1][1]], [lanes[2][1], lanes[3][1]],
                            torch.as_tensor(row))
    _eq(got, want)
    jg = jjoin.gather_build({"a": lanes[0][0]}, jnp.asarray(row), jnp.asarray(matched))
    tg = tjoin.gather_build({"a": lanes[0][1]}, torch.as_tensor(row),
                            torch.as_tensor(matched))
    _eq(tg["a"][0], jg["a"][0])
    _eq(tg["a"][1], jg["a"][1])


# -- hashes, bit for bit ------------------------------------------------------


def _wide(rng, n):
    """Two-limb decimals: half fit one limb, half are genuinely 128-bit."""
    lo = rng.integers(-(2**63), 2**63 - 1, n)
    hi = np.where(rng.random(n) < 0.5, np.where(lo < 0, -1, 0),
                  rng.integers(-(2**40), 2**40, n))
    return np.stack([lo, hi], axis=1).astype(np.int64)


def test_mix_and_composite_key_bit_identical():
    rng = np.random.default_rng(3)
    n = 2000
    a = rng.integers(-(2**63), 2**63 - 1, n).astype(np.int64)
    b = rng.integers(-5, 5, n).astype(np.int32)
    w = _wide(rng, n)
    oks = [rng.random(n) > 0.2 for _ in range(3)]
    h0 = rng.integers(-(2**63), 2**63 - 1, n).astype(np.int64)
    want = jjoin._mix(jnp.asarray(h0).astype(jnp.uint64), jnp.asarray(a).astype(jnp.uint64))
    got = tjoin._mix(torch.as_tensor(h0), torch.as_tensor(a))
    _eq(got, want)
    _eq(tjoin._canonical_bits(torch.as_tensor(w)), jjoin._canonical_bits(jnp.asarray(w)))
    for cols in ([a, b], [b, w], [w], [a]):
        lanes = [_lane(c, ok) for c, ok in zip(cols, oks)]
        jk = jjoin.composite_key([l[0] for l in lanes], None, force_hash=True)
        tk = tjoin.composite_key([l[1] for l in lanes], None, force_hash=True)
        _eq(tk[0], jk[0])
        _eq(tk[1], jk[1])
    assert tjoin.needs_verification([(torch.as_tensor(w), None)])
    assert not tjoin.needs_verification([(torch.as_tensor(a), None)])


@pytest.mark.parametrize("salt", [0, 3])
def test_group_hash_bit_identical(salt):
    rng = np.random.default_rng(9)
    n = 3000
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    f[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324, 1.7976931348623157e308]
    cols = [
        rng.integers(-(2**63), 2**63 - 1, n).astype(np.int64),
        rng.integers(-3, 3, n).astype(np.int32),
        f,
        _wide(rng, n),
        rng.random(n) < 0.5,
    ]
    oks = [rng.random(n) > 0.15 for _ in cols]
    lanes = [_lane(c, ok) for c, ok in zip(cols, oks)]
    _eq(tagg.f64_order_bits(torch.as_tensor(f)), jagg.f64_order_bits(jnp.asarray(f)))
    for pick in ([0], [1, 2], [3, 4, 0], [2]):
        want = jagg._group_hash([lanes[i][0] for i in pick], salt)
        got = tagg._group_hash([lanes[i][1] for i in pick], salt)
        _eq(got, want)


# -- hash-sort grouping -----------------------------------------------------------


@pytest.mark.parametrize("salt", [0, 1])
@pytest.mark.parametrize("cap_extra", [0, 25])
def test_sort_group_ids_and_sorted_segments_match_jax(salt, cap_extra):
    rng = np.random.default_rng(21 + salt)
    n = 5000
    k1, ok1 = _keys(rng, n, -20, 20)
    k2 = rng.integers(0, 4, n).astype(np.int32)
    ok2 = rng.random(n) > 0.05
    sel = rng.random(n) > 0.2
    (j1, t1), (j2, t2) = _lane(k1, ok1), _lane(k2, ok2)
    ngroups = int(jagg.sort_group_ids([j1, j2], jnp.asarray(sel), n, salt)[2])
    cap = ngroups + cap_extra
    want = jagg.sort_group_ids([j1, j2], jnp.asarray(sel), cap, salt)
    got = tagg.sort_group_ids([t1, t2], torch.as_tensor(sel), cap, salt)
    for a, b in zip(got, want):
        _eq(a, b)
    assert int(got[3]) == 0
    gid_j, gid_t = want[1], got[1]
    jss, tss = jagg.SortedSegments(gid_j, cap), tagg.SortedSegments(gid_t, cap)
    _eq(tss.starts, jss.starts)
    _eq(tss.ends, jss.ends)
    perm = _np(got[0])
    vals = rng.integers(-(2**62), 2**62, n)[perm].astype(np.int64)
    live = (sel & ok1)[perm]
    _eq(tss.sum(torch.as_tensor(vals)), jss.sum(jnp.asarray(vals)))
    _eq(tss.count(torch.as_tensor(live)), jss.count(jnp.asarray(live)))
    for sent, op in ((2**62, "min"), (-(2**62), "max")):
        vv = np.where(live, vals, sent)
        _eq(getattr(tss, op)(torch.as_tensor(vv)), getattr(jss, op)(jnp.asarray(vv)))


def test_sort_group_ids_counts_collisions_under_a_weak_hash(monkeypatch):
    """Keys that share one locator are counted as collisions on both
    sides (the executor then retries under a new salt)."""
    rng = np.random.default_rng(4)
    n = 600
    k, ok = _keys(rng, n, 0, 6, null=0.0)
    jl, tl = _lane(k, ok)
    sel = np.ones(n, bool)
    monkeypatch.setattr(jagg, "_group_hash",
                        lambda lanes, salt: jnp.zeros(n, jnp.int64))
    monkeypatch.setattr(tagg, "_group_hash",
                        lambda lanes, salt: torch.zeros(n, dtype=torch.int64))
    want = jagg.sort_group_ids([jl], jnp.asarray(sel), n, 0)
    got = tagg.sort_group_ids([tl], torch.as_tensor(sel), n, 0)
    for a, b in zip(got, want):
        _eq(a, b)
    assert int(got[3]) > 0


@pytest.mark.parametrize("sorted_path", [False, True])
def test_accumulate_with_arbitrary_matches_jax(sorted_path):
    rng = np.random.default_rng(13)
    n, cap = 3000, 40
    gid = np.sort(rng.integers(0, cap - 5, n)) if sorted_path else rng.integers(0, cap, n)
    gid = gid.astype(np.int64)
    sel = rng.random(n) > 0.2
    lanes = {
        "x": (rng.integers(-(2**40), 2**40, n).astype(np.int64), rng.random(n) > 0.1),
        "d": (rng.integers(8000, 11000, n).astype(np.int32), rng.random(n) > 0.3),
    }
    out = {}
    for side, agg, arr in (("jax", jagg, jnp.asarray), ("torch", tagg, torch.as_tensor)):
        specs = [
            agg.AggSpec("sum", "x", "s"), agg.AggSpec("count", "x", "c"),
            agg.AggSpec("min", "x", "mn"), agg.AggSpec("max", "x", "mx"),
            agg.AggSpec("count_star", None, "cs"), agg.AggSpec("arbitrary", "d", "a"),
        ]
        ln = {k: (arr(v), arr(ok)) for k, (v, ok) in lanes.items()}
        g = arr(gid)
        seg = agg.SortedSegments(g, cap) if sorted_path else None
        accs = agg.accumulate(specs, ln, g, arr(sel), cap, seg=seg)
        out[side] = (accs, agg.finalize(specs, accs))
    for name, v in out["jax"][0].items():
        _eq(out["torch"][0][name], v)
    for name, (v, ok) in out["jax"][1].items():
        _eq(out["torch"][1][name][0], v)
        _eq(out["torch"][1][name][1], ok)


def test_group_keys_output_with_run_starts_matches_jax():
    rng = np.random.default_rng(17)
    n, cap = 2000, 60
    gid = np.sort(rng.integers(0, cap - 10, n)).astype(np.int64)
    sel = rng.random(n) > 0.3
    k, ok = _keys(rng, n)
    jl, tl = _lane(k, ok)
    jss = jagg.SortedSegments(jnp.asarray(gid), cap)
    tss = tagg.SortedSegments(torch.as_tensor(gid), cap)
    want = jagg.group_keys_output([jl], jnp.asarray(gid), jnp.asarray(sel), cap,
                                  starts=jss.starts)
    got = tagg.group_keys_output([tl], torch.as_tensor(gid), torch.as_tensor(sel),
                                 cap, starts=tss.starts)
    _eq(got[0][0], want[0][0])
    _eq(got[0][1], want[0][1])


# -- the direct probe's plain version -----------------------------------------


def test_direct_probe_plain_is_the_micro_probe_gather():
    """scripts/micro_probe.py's own check, `out = table[probe]`, at a
    reduced probe count: a table of build row + 1 returns build row."""
    rng = np.random.default_rng(0)
    dom, nb, m = 150_000, 30_000, 1 << 18
    table = np.full(dom, -1, np.int32)
    table[rng.choice(dom, size=nb, replace=False)] = np.arange(nb, dtype=np.int32)
    probe = rng.integers(0, dom, m).astype(np.int32)
    ones = torch.ones(m, dtype=torch.bool)
    row, matched = kn.direct_probe(torch.as_tensor(table + 1), torch.as_tensor(probe),
                                   ones, ones, 0)
    assert np.array_equal(row.numpy(), table[probe].astype(np.int64))
    assert np.array_equal(matched.numpy(), table[probe] >= 0)


I32_MIN, I32_MAX, I64_MIN, I64_MAX = -(2**31), 2**31 - 1, -(2**63), 2**63 - 1


def _edge_probe(case):
    """(table, keys, ok, sel, lo) at an edge the kernel must keep."""
    rng = np.random.default_rng(len(case))
    slots = np.array([I32_MIN, I32_MAX, 0, -1, -7, 1, 2], np.int32)
    if case == "wrapping slots":
        table = rng.choice(slots, 5000).astype(np.int32)
        keys, lo = rng.integers(-100, 5100, 20_000), 0
    elif case == "lo near -2^63":
        table = rng.choice(slots, 300).astype(np.int32)
        lo = I64_MIN + 5
        keys = np.concatenate([lo + rng.integers(-5, 310, 3000),
                               [I64_MIN, I64_MAX, 0, -1, lo - 1, lo + 299, lo + 300]])
    elif case == "lo near +2^63":
        table = rng.choice(slots, 300).astype(np.int32)
        lo = I64_MAX - 200
        keys = np.concatenate([lo + rng.integers(-300, 201, 3000),
                               [I64_MIN, I64_MAX, 0, -1, lo, lo - 1]])
    elif case == "int32 keys":
        table = rng.choice(slots, 900).astype(np.int32)
        lo = -450
        keys = np.concatenate([rng.integers(-1000, 1000, 4000),
                               [I32_MIN, I32_MAX]]).astype(np.int32)
    elif case == "int32 keys, lo beyond int32":
        table = rng.choice(slots, 64).astype(np.int32)
        lo = I32_MIN - 10
        keys = np.concatenate([rng.integers(I32_MIN, I32_MIN + 80, 2000),
                               [I32_MAX]]).astype(np.int32)
    elif case == "domain 1":
        table = np.array([I32_MIN], np.int32)
        lo = 42
        keys = rng.integers(40, 45, 500)
    elif case == "domain 1, empty slot":
        table = np.zeros(1, np.int32)
        lo = 0
        keys = rng.integers(-2, 3, 500)
    else:  # no rows
        table = np.arange(1, 5, dtype=np.int32)
        keys, lo = np.zeros(0, np.int64), 0
    if keys.dtype != np.int32:
        keys = keys.astype(np.int64)
    n = keys.shape[0]
    return table, keys, rng.random(n) > 0.2, rng.random(n) > 0.3, lo


@pytest.mark.parametrize("case", [
    "wrapping slots", "lo near -2^63", "lo near +2^63", "int32 keys",
    "int32 keys, lo beyond int32", "domain 1", "domain 1, empty slot", "no rows",
])
def test_direct_probe_matches_probe_direct_at_the_edges(case):
    """kn.direct_probe (the plain version on CPU tensors) against the JAX
    package's probe_direct on a hand-built DirectLookupSource: slots
    INT32_MIN (slot - 1 wraps), INT32_MAX, 0 and negatives; key - lo
    wrapping near +-2^63; int32 keys; a one-slot domain; no rows."""
    table, keys, ok, sel, lo = _edge_probe(case)
    src = jjoin.DirectLookupSource(jnp.asarray(table), lo, jnp.int64(0))
    want = jjoin.probe_direct(src, (jnp.asarray(keys), jnp.asarray(ok)), jnp.asarray(sel))
    got = kn.direct_probe(torch.as_tensor(table), torch.as_tensor(keys),
                          torch.as_tensor(ok), torch.as_tensor(sel), lo)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    if case == "wrapping slots":  # the edges are present and some rows match
        assert (got[0] == I32_MAX).any() and got[1].any() and not got[1].all()


@pytest.mark.parametrize("n,grid,want", [
    (0, 264, 1), (1, 264, 1), (kn.PROBE_TILE_ROWS, 264, 1),
    (kn.PROBE_TILE_ROWS * kn.PROBE_WARPS, 264, 1),
    (kn.PROBE_TILE_ROWS * kn.PROBE_WARPS + 1, 264, 2),
    (30_480_000, 660, 660), (7_780_000, 660, 660), (100_000, 660, 49),
])
def test_probe_blocks_sizes_the_persistent_grid(n, grid, want):
    """One warp a tile, PROBE_WARPS warps a block, never more blocks than
    the card's full grid, never none."""
    assert kn.probe_blocks(n, grid) == want


@pytest.mark.parametrize("dtype,off", [
    (torch.int64, 0), (torch.int64, 1), (torch.int64, 2), (torch.int32, 1),
    (torch.int32, 4), (torch.bool, 3), (torch.bool, 16), (torch.bool, 15),
])
def test_aligned_lane_copies_only_lanes_off_16_bytes(dtype, off):
    """A lane that starts 16-byte aligned and is contiguous is used as it
    is; any other is copied to a fresh (aligned) tensor with equal
    values."""
    base = torch.arange(64).to(dtype)
    t = base[off:]
    got = kn.aligned_lane(t)
    assert torch.equal(got, t) and got.data_ptr() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) == (t.data_ptr() % 16 == 0)
    strided = base[::2]
    assert kn.aligned_lane(strided).stride(0) == 1
    assert torch.equal(kn.aligned_lane(strided), strided)


def test_direct_probe_wrapper_checks_its_inputs():
    t = torch.zeros(4, dtype=torch.int32)
    k = torch.zeros(3, dtype=torch.int64)
    b = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError):  # int64 table
        kn.direct_probe(t.long(), k, b, b, 0)
    with pytest.raises(ValueError):  # float key
        kn.direct_probe(t, k.double(), b, b, 0)
    with pytest.raises(ValueError):  # mask of another length
        kn.direct_probe(t, k, torch.ones(2, dtype=torch.bool), b, 0)
    with pytest.raises(ValueError):  # empty table
        kn.direct_probe(t[:0], k, b, b, 0)


# -- the JAX package's join-exactness tests, on the port's session ------------

L_ROWS = "(values (1, 10, 100), (1, 11, 101), (2, 10, 102), (3, 30, 103), " \
         "(4, 40, 104), (5, 50, 105)) as l(a, b, lv)"
R_ROWS = "(values (1, 10, 200), (1, 11, 201), (2, 10, 202), (3, 31, 203), " \
         "(9, 90, 209)) as r(a, b, rv)"


@pytest.fixture()
def port_session():
    from trino_tpu_torch.session import tpch_session

    return tpch_session(0.002, device="cpu")


@pytest.fixture(scope="module")
def jax_session():
    from trino_tpu.session import tpch_session

    return tpch_session(0.002, result_cache=False)


def _same_as_reference(jax_session, port_page, sql):
    """The port's page is byte-identical to the JAX package's on `sql`."""
    from trino_tpu_torch import convert

    convert.assert_pages_identical(jax_session.execute(sql), port_page)


@pytest.fixture()
def weak_hash(monkeypatch):
    """Every composite key collides into 4 buckets in the port's join
    module: only exact verification keeps multi-key joins right."""
    monkeypatch.setattr(tjoin, "_mix", lambda h, x: (h + x) & 3)


@pytest.mark.parametrize("sql,want", [
    (f"select l.lv, r.rv from {L_ROWS} join {R_ROWS} on l.a = r.a and l.b = r.b "
     "order by l.lv", [(100, 200), (101, 201), (102, 202)]),
    (f"select l.lv, r.rv from {L_ROWS} left join {R_ROWS} on l.a = r.a "
     "and l.b = r.b order by l.lv",
     [(100, 200), (101, 201), (102, 202), (103, None), (104, None), (105, None)]),
    ("select l.lv, r.rv from (values (1, 1, 10), (2, 2, 20), (3, 3, 30)) as l(a, b, lv) "
     "join (values (1, 1, 7), (1, 1, 8), (2, 2, 9), (2, 3, 5)) as r(a, b, rv) "
     "on l.a = r.a and l.b = r.b order by l.lv, r.rv", [(10, 7), (10, 8), (20, 9)]),
    ("select l.lv, r.rv from (values (1, cast(null as bigint), 10), (2, 2, 20)) "
     "as l(a, b, lv) join (values (1, cast(null as bigint), 7), (2, 2, 9)) "
     "as r(a, b, rv) on l.a = r.a and l.b = r.b order by l.lv", [(20, 9)]),
])
def test_multikey_joins_stay_exact_under_a_weak_hash(port_session, jax_session,
                                                     weak_hash, sql, want):
    # the patched hash moves which build row an unmatched probe row
    # carries under NULL, so the rows, not the bytes, match the reference
    rows = port_session.execute(sql).to_pylist()
    assert rows == want
    assert rows == jax_session.execute(sql).to_pylist()


@pytest.mark.parametrize("sql,want", [
    # several key matches that all fail the residual: one null-extended row
    ("select l.lv, r.rv from (values (1, 10), (2, 20)) as l(a, lv) left join "
     "(values (1, 5), (1, 6), (2, 100)) as r(a, rv) on l.a = r.a and r.rv > 50 "
     "order by l.lv", [(10, None), (20, 100)]),
    # exactly one match passes the residual: no extra null-extended row
    ("select l.lv, r.rv from (values (1, 10)) as l(a, lv) left join "
     "(values (1, 5), (1, 60), (1, 6)) as r(a, rv) on l.a = r.a and r.rv > 50 "
     "order by l.lv", [(10, 60)]),
    # duplicate single-column build keys fall back to the expansion join
    ("select l.lv, r.rv from (values (1, 10), (2, 20), (3, 30)) as l(a, lv) join "
     "(values (1, 1), (1, 2), (3, 3)) as r(a, rv) on l.a = r.a order by l.lv, r.rv",
     [(10, 1), (10, 2), (30, 3)]),
    # keys at 2^62 and NULL build keys behave like any other value
    (f"select l.lv, r.rv from (values ({2**62}, 1), ({2**62 - 1}, 2), (3, 3)) as "
     f"l(a, lv) join (values ({2**62}, 10), (cast(null as bigint), 99), (3, 30)) "
     "as r(a, rv) on l.a = r.a order by l.lv", [(1, 10), (3, 30)]),
])
def test_join_edge_cases_on_the_port(port_session, jax_session, sql, want):
    page = port_session.execute(sql)
    assert page.to_pylist() == want
    _same_as_reference(jax_session, page, sql)


@pytest.mark.parametrize("domain", [(1, 70000), (1, 100)])
def test_stale_stats_reroute_keeps_results_exact(port_session, jax_session, domain):
    """A forged direct_domain annotation (stats that lied: the JAX
    package's test forges (1, 70000); (1, 100) leaves most build keys
    outside the domain) reroutes through the violation/duplicate retry
    to the exact sorted kernels, never a wrong row: the forged and the
    unforged plans give the JAX package's page, byte for byte."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.exec.local import LocalExecutor
    from trino_tpu_torch.plan import nodes as P

    s = port_session
    sql = ("select count(*), sum(l_quantity) from orders, lineitem "
           "where o_orderkey = l_orderkey")
    expected = jax_session.execute(sql)
    convert.assert_pages_identical(expected, s.execute(sql))
    plan = s.plan(sql)

    def forge(n):
        sources = tuple(forge(x) for x in n.sources)
        if sources:
            updates, i = {}, 0
            for f in dataclasses.fields(n):
                if isinstance(getattr(n, f.name), P.PlanNode):
                    updates[f.name] = sources[i]
                    i += 1
            n = dataclasses.replace(n, **updates) if updates else n
        if isinstance(n, P.Join) and n.criteria and not n.expansion:
            return dataclasses.replace(n, direct_domain=domain)
        return n

    forged = forge(plan)
    joins = []

    def find(n):
        if isinstance(n, P.Join):
            joins.append(n)
        for x in n.sources:
            find(x)

    find(forged)
    ex = LocalExecutor(s.catalogs, {"device": "cpu"})
    convert.assert_pages_identical(expected, ex.execute(forged))
    if domain == (1, 100):
        # out-of-domain build keys: the join left the direct table
        assert {id(j) for j in joins} <= ex.force_no_direct
