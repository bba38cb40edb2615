"""The rounded wide division (ops/kernels.py `wide_div_round`,
csrc/wide_div.cu) and its plain version.

On the CPU the wrapper runs `wide_div_round_plain`, the restoring
division held here to Python integers: round_half_away(w / d) for a
signed 128-bit lane w (the wide layout: low limb as a uint64 bit pattern,
signed high limb) over int64 divisors clamped below at 1, the quotient
negated modulo 2^128 where w < 0.  The wrapper's refusals, and that every
wide division of the port goes through it, are checked here too; the
CUDA kernel is held to the plain version by a test that needs a card,
and on a card by `python3 chip_smoke.py --phase kernels` (edge lanes,
1 M and 100 M random lanes).
"""
import numpy as np
import pytest
import torch

from chip_smoke import WIDE_EDGE as EDGE
from chip_smoke import WIDE_MAX_D as MAX_D
from chip_smoke import WIDE_TOP as TOP
from chip_smoke import wide_lane as _lane
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.ops import wide_decimal as wd


def _value(lo: int, hi: int) -> int:
    v = (int(hi) << 64) | (int(lo) & ((1 << 64) - 1))
    return v - (1 << 128) if v >= TOP else v


def _want(v: int, d: int) -> int:
    """round_half_away(v / d) with d clamped to 1, wrapped to 128 bits."""
    d = max(d, 1)
    q, r = divmod(abs(v), d)
    q += 2 * r >= d
    return _value(*_lane(-q if v < 0 else q))


def _check(vals, ds, fn=kn.wide_div_round_plain):
    w = torch.tensor([_lane(v) for v in vals], dtype=torch.int64).reshape(-1, 2)
    d = torch.tensor(ds, dtype=torch.int64)
    got = fn(w, d)
    assert got.shape == (len(vals), 2) and got.dtype == torch.int64
    for (lo, hi), v, dd in zip(got.tolist(), vals, ds):
        assert _value(lo, hi) == _want(v, dd), (v, dd)


@pytest.mark.parametrize("case", sorted(EDGE))
def test_plain_matches_python_integers_on_edge_lanes(case):
    vals, ds = EDGE[case]
    _check(vals, ds)


def _random(seed, n):
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 128, n)
    vals = []
    for b in bits.tolist():
        v = int(rng.integers(0, 1 << 63)) << 64 | int(rng.integers(0, 1 << 63)) << 1
        v &= (1 << b) - 1
        vals.append(-v if rng.random() < 0.5 else v)
    ds = [int(x) for x in rng.integers(-3, MAX_D, n) >> rng.integers(0, 63, n)]
    return vals, ds


def test_plain_matches_python_integers_on_random_lanes():
    vals, ds = _random(20261018, 10_000)
    _check(vals, ds)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    vals, ds = _random(7, 500)
    _check(vals, ds, kn.wide_div_round)
    w = torch.tensor([_lane(v) for v in vals], dtype=torch.int64).reshape(-1, 2)
    for one in (torch.tensor(12345), torch.tensor([12345])):
        assert torch.equal(kn.wide_div_round(w, one),
                           kn.wide_div_round_plain(w, torch.full((500,), 12345)))


@pytest.mark.parametrize("bad", [
    "w-int32", "d-float", "w-1d", "w-three-limbs", "d-length", "d-2d",
    "devices", "meta",
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    w = torch.zeros((4, 2), dtype=torch.int64)
    d = torch.ones(4, dtype=torch.int64)
    args = {
        "w-int32": (w.to(torch.int32), d),
        "d-float": (w, d.to(torch.float64)),
        "w-1d": (w.reshape(-1), d),
        "w-three-limbs": (torch.zeros((4, 3), dtype=torch.int64), d),
        "d-length": (w, torch.ones(5, dtype=torch.int64)),
        "d-2d": (w, torch.ones((4, 1), dtype=torch.int64)),
        "devices": (w, d.to("meta")),
        "meta": (w.to("meta"), d.to("meta")),
    }[bad]
    with pytest.raises(ValueError):
        kn.wide_div_round(*args)


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = kn.wide_div_round

    def counting(w, d):
        calls.append(w.shape[0])
        return real(w, d)

    monkeypatch.setattr(kn, "wide_div_round", counting)
    return calls


def test_div_round_goes_through_the_wrapper(spy):
    vals, ds = EDGE["ties"][0][:4], EDGE["ties"][1][:4]  # int32 divisors
    w = torch.tensor([_lane(v) for v in vals], dtype=torch.int64).reshape(-1, 2)
    got = wd.div_round(w, torch.tensor(ds, dtype=torch.int32))
    assert spy == [len(vals)]
    assert torch.equal(got, kn.wide_div_round_plain(w, torch.tensor(ds)))


def test_sql_wide_average_goes_through_the_wrapper(spy):
    """Q1's three averages over DECIMAL(38, s) sums: one call each, one
    lane a group slot (at least one a group of the page)."""
    from tpch_sql import QUERIES
    from trino_tpu_torch.session import tpch_session

    s = tpch_session(0.002, device="cpu", result_cache=False)
    page = s.execute(QUERIES[1][0])
    assert len(spy) == 3 and len(set(spy)) == 1 and spy[0] >= page.count == 4


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version on the card: every edge
    lane above, and 1 M random lanes of every magnitude over divisors of
    every width (some below 1), one divisor a lane and one for all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py --phase kernels)")
    dev = torch.device("cuda")
    vals = [v for vs, _ in EDGE.values() for v in vs]
    ds = [d for _, dd in EDGE.values() for d in dd]
    w = torch.tensor([_lane(v) for v in vals], dtype=torch.int64).reshape(-1, 2)
    d = torch.tensor(ds, dtype=torch.int64)
    got = kn.wide_div_round(w.to(dev), d.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kn.wide_div_round_plain(w, d))
    rng = np.random.default_rng(20261018)
    n = 1_000_000
    w = rng.integers(-(2**63), 2**63 - 1, (n, 2), dtype=np.int64, endpoint=True)
    w[:, 1] >>= rng.integers(0, 64, n)
    d = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
    d = np.where(rng.random(n) < 0.97, np.abs(d >> rng.integers(1, 64, n)), d)
    w, d = torch.as_tensor(w, device=dev), torch.as_tensor(d, device=dev)
    assert torch.equal(kn.wide_div_round(w, d), kn.wide_div_round_plain(w, d))
    one = d[:1]
    assert torch.equal(kn.wide_div_round(w, one), kn.wide_div_round_plain(w, one))
    # a lane array that is not contiguous (every other lane) is copied
    assert torch.equal(kn.wide_div_round(w[::2], d[::2]),
                       kn.wide_div_round_plain(w[::2], d[::2]))
