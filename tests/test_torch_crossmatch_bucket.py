"""The single-bucket join's decomposition (K1) held to the JAX reference.

On the card K1 is an instance of the cross-match kernel: the real probe
rows only, each walking its bucket rows (``ref.bucket_rows``: the real
rows, or those of its band's tiles, on the reference's tile grid over the
padded shapes) cut into splits and merged in split order.
``ref.crossmatch_splits_ref`` mirrors that; fed the inputs the card path
builds, it must give the JAX reference's results bit for bit (the jnp
path, and with a band the Pallas kernel in interpret mode): the tolerance
is zero, ties included.  The wrapper's plain version on those inputs
(the grid passed apart) must give the padded inputs' results, bit for bit.
Buckets here have at least 33 rows, from where jnp.dot on the CPU takes
the port's dot order.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.sfc import htm_id  # noqa: E402
from repro.kernels.crossmatch import ops as jops  # noqa: E402
from repro_torch.kernels.crossmatch import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossmatch import ops as tops  # noqa: E402
from repro_torch.kernels.crossmatch import ref as tref  # noqa: E402
from test_torch_kernels_cuda import BUCKET_CASES as CASES  # noqa: E402
from test_torch_kernels_cuda import TIE_EDGES, _unit  # noqa: E402
from test_torch_kernels_cuda import bucket_case as _case  # noqa: E402
from test_torch_kernels_cuda import bucket_inputs, bucket_split_ref  # noqa: E402

SPLITS = (1, 3, 16)
CPU = torch.device("cpu")


def _assert_bits(got, want):
    gi, gd, gc = (np.asarray(x) for x in got)
    wi, wd, wc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)


def _reference(bucket, probes, thr, band, bm, bn):
    """The JAX reference: the jnp path, or with a band the Pallas kernel
    (the jnp path has none) in interpret mode."""
    if band is None:
        return jops.crossmatch(bucket, probes, thr, use_pallas=False)
    return jops.crossmatch(bucket, probes, thr, use_pallas=True, bm=bm, bn=bn,
                           band=band, interpret=True)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", CASES)
def test_k1_split_ref_equals_reference_bit_for_bit(name, splits):
    case = _case(name)
    bucket, probes, thr, band, bm, bn = case
    b8, p8, n_real, m_grid = bucket_inputs(case, CPU)
    got = tops._finish(*bucket_split_ref(b8, p8, n_real, m_grid, thr, band,
                                         bm, bn, splits),
                       len(bucket), len(probes))
    _assert_bits(got, _reference(bucket, probes, thr, band, bm, bn))
    _assert_bits(got, tops.crossmatch(bucket, probes, thr, device="cpu",
                                      bm=bm, bn=bn, band=band))


@pytest.mark.parametrize("name", CASES)
def test_k1_card_inputs_give_the_padded_results(name):
    """The real probe rows alone, with the real bucket row count and the
    padded probe count passed apart, through the wrapper's plain version
    give the padded inputs' results bit for bit: at a probe count that is
    no power of two, an odd bm and cos_thr = -2."""
    case = _case(name)
    bucket, probes, thr, band, bm, bn = case
    b8, p8, n_real, m_grid = bucket_inputs(case, CPU)
    assert p8.shape == (len(probes), tkernel.COORD_PAD)
    assert n_real == len(bucket) and m_grid % bm == 0
    got = tkernel.crossmatch_kernel(b8, p8, thr, bm=bm, bn=bn, band=band,
                                    n_real=n_real, m_grid=m_grid)
    _assert_bits(tops._finish(*got, len(bucket), len(probes)),
                 tops.crossmatch(bucket, probes, thr, device="cpu", bm=bm,
                                 bn=bn, band=band))


def test_k1_ties_take_the_lowest_index_across_splits():
    """The duplicates of rows 17, 99, 149, 199, 280 one row on sit on the
    edges of 3 and of 16 splits: every probe near them takes the lower
    row, in every split plan."""
    case = _case("ties across splits")
    b8, p8, n_real, m_grid = bucket_inputs(case, CPU)
    thr, band, bm, bn = case[2:]
    for splits in SPLITS:
        idx, _, _ = bucket_split_ref(b8, p8, n_real, m_grid, thr, band, bm,
                                     bn, splits)
        assert not np.isin(np.asarray(idx), TIE_EDGES).any()
        assert np.isin(np.asarray(idx)[:40], np.subtract(TIE_EDGES, 1)).all()


def test_k1_probes_at_the_last_real_row():
    """The probes next to the last real bucket row take it: the walk ends
    at the real rows, not before."""
    case = _case("last real row")
    b8, p8, n_real, m_grid = bucket_inputs(case, CPU)
    for splits in SPLITS:
        idx, _, cnt = bucket_split_ref(b8, p8, n_real, m_grid, *case[2:],
                                       splits)
        assert (np.asarray(idx)[:9] == n_real - 1).all()
        assert (np.asarray(cnt)[:9] >= 1).all()


@pytest.mark.parametrize("band", [None, 0, 2])
@pytest.mark.parametrize("bm,bn", [(128, 512), (7, 128), (16, 64)])
def test_bucket_rows_are_the_band_mask(band, bm, bn):
    """Each probe's range is its row of ``band_keep``'s pair mask (all
    rows without a band), clipped to the rows the kernel takes."""
    m, rows, n_grid = 100, 1000, 1024
    m_grid = -(-128 // bm) * bm
    lo, hi = tref.bucket_rows(m, rows, band, bm, bn, m_grid, n_grid)
    cols = torch.arange(n_grid)
    want = (cols < rows)[None, :].expand(m, n_grid)
    if band is not None:
        want = want & tref.band_keep(m_grid, n_grid, bm, bn, band, CPU)(0, m)
    got = (cols[None, :] >= lo[:, None]) & (cols[None, :] < hi[:, None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("thr,want", [
    (0.9, 10_000),
    (-1.0, 10_000),
    (-2.0, 16_384),  # the reference counts marker rows
    (-3.0, 16_384),
])
def test_bucket_rows_taken(thr, want):
    """The rows K1 takes of an (N = 16,384) bucket of 10,000 real rows."""
    assert tkernel.bucket_rows_taken(16_384, 10_000, thr) == want


@pytest.mark.parametrize("band", [0, 1])
def test_band_counts_only_its_tiles_at_threshold_minus_two(band):
    """At cos_thr = -2 every pair passes; the Pallas kernel counts the
    pairs of the kept tiles only (marker rows among them), and so does the
    port's plain version."""
    pts = _unit(np.random.default_rng(band), 300)
    pts = pts[np.argsort(htm_id(pts, level=8), kind="stable")]
    got = tops.crossmatch(pts, pts, -2.0, device="cpu", bm=128, bn=128,
                          band=band)
    _assert_bits(got, jops.crossmatch(pts, pts, -2.0, use_pallas=True, bm=128,
                                      bn=128, band=band, interpret=True))
    n_i, n_j = 512 // 128, 512 // 128
    centers = np.arange(n_i) * n_j // n_i
    tiles = np.minimum(centers + band + 1, n_j) - np.maximum(centers - band, 0)
    np.testing.assert_array_equal(np.asarray(got[2]),
                                  np.repeat(tiles * 128, 128)[:300])


@pytest.mark.parametrize("m,walked,want", [
    (256, 10_000, (1, 9)),       # phase 2's M = 256: rows cap the splits
    (3900, 10_000, (16, 9)),     # run A's typical batch
    (54_471, 10_000, (213, 9)),  # run A's largest
    (54_471, 1536, (213, 1)),    # too few rows to split
])
def test_k1_split_plan(monkeypatch, m, walked, want):
    """K1 plans with the real probe count and the rows a probe walks."""
    monkeypatch.setattr(tkernel, "SPLIT_BLOCKS_PER_SM", 32)
    monkeypatch.setattr(tkernel, "MIN_SPLIT_ROWS", 1024)
    assert tkernel.split_plan(m, walked, 132, 256) == want


def test_k1_wrapper_checks_the_grid():
    b = torch.zeros(512, tkernel.COORD_PAD)
    p = torch.zeros(100, tkernel.COORD_PAD)
    with pytest.raises(ValueError):  # the grid is no multiple of bm
        tkernel.crossmatch_kernel(b, p, 0.9, m_grid=100)
    with pytest.raises(ValueError):  # more probe rows than the grid
        tkernel.crossmatch_kernel(b, p, 0.9, bm=64, m_grid=64)
    with pytest.raises(ValueError):  # more real rows than the bucket
        tkernel.crossmatch_kernel(b, p, 0.9, m_grid=128, n_real=513)
    idx, dot, cnt = tkernel.crossmatch_kernel(b, p, 0.9, m_grid=128,
                                              n_real=0)
    assert idx.shape == dot.shape == cnt.shape == (100,)
