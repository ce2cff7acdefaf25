"""The segment kernel's decomposition (K2/K3) held to the JAX reference.

``ref.crossmatch_splits_ref`` mirrors what the CUDA kernel does: each
probe's segment range (``ref.segment_rows``) cut into splits, each
split's (best, index, count), the merge in split order on (dot, lowest
index) with the counts summed.  Fed the inputs the card path builds (the real probe rows only),
it must give the JAX reference's results (``repro``'s jnp path and its
Pallas kernels in interpret mode) bit for bit: the tolerance is zero,
ties included.  The plain versions on those inputs must give every real
row of the padded inputs' results, bit for bit.  Buckets here have at
least 33 rows, from where jnp.dot on the CPU takes the port's dot order.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.crossmatch import ops as jops  # noqa: E402
from repro_torch.kernels.crossmatch import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossmatch import ops as tops  # noqa: E402
from repro_torch.kernels.crossmatch import ref as tref  # noqa: E402
from test_torch_kernels_cuda import SEGMENT_CASES as CASES  # noqa: E402
from test_torch_kernels_cuda import _near, _unit  # noqa: E402
from test_torch_kernels_cuda import segment_case as _case  # noqa: E402

SPLITS = (1, 2, 3, 7)


def _card_inputs(bucket, bseg, probes, pseg, thr=None):
    """The inputs the card path hands the kernel: padded bucket, real probe
    rows only; as CPU tensors."""
    b8, p8, bs, ps, _, m = tops._segmented_inputs(
        bucket, probes, bseg, pseg, 128, 512, pad_probes=False
    )
    assert p8.shape[0] == m
    out = [torch.from_numpy(x) for x in (b8, p8, bs, ps)]
    if thr is not None:
        out.append(torch.from_numpy(np.asarray(thr, np.float32)))
    return out


def _assert_bits(got, want):
    gi, gd, gc = (np.asarray(x) for x in got)
    wi, wd, wc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", CASES)
def test_split_ref_equals_reference_bit_for_bit(name, splits):
    bucket, bseg, probes, pseg, thr = _case(name)
    b8, p8, bs, ps, thr_t = _card_inputs(bucket, bseg, probes, pseg, thr)
    cos_thr = float(np.cos(2e-3))
    rows = tref.segment_rows(bs, ps)
    fused = tref.crossmatch_splits_ref(b8, p8, *rows, cos_thr, splits)
    shared = tref.crossmatch_splits_ref(b8, p8, *rows, thr_t, splits)
    for kw in (dict(use_pallas=False, interpret=False),
               dict(use_pallas=True, bm=8, bn=128, interpret=True)):
        _assert_bits(fused, jops.crossmatch_fused(
            bucket, probes, bseg, pseg, cos_thr, **kw))
        _assert_bits(shared, jops.crossmatch_shared(
            bucket, probes, bseg, pseg, thr, **kw))


def test_ties_take_the_lowest_index_across_splits():
    """The duplicates of row 29 at row 30 straddle the boundary of two
    splits: every probe near them takes row 29, in every split plan."""
    bucket, bseg, probes, pseg, thr = _case("ties across splits")
    b8, p8, bs, ps = _card_inputs(bucket, bseg, probes, pseg)
    for splits in SPLITS:
        idx, _, _ = tref.crossmatch_splits_ref(
            b8, p8, *tref.segment_rows(bs, ps), 0.9, splits)
        assert not np.isin(np.asarray(idx), [30, 20, 40, 9, 50]).any()
        assert np.isin(np.asarray(idx), [29, 19, 39, 8, 17]).any()


@pytest.mark.parametrize("name", CASES)
def test_card_inputs_give_the_padded_results(name):
    """The real probe rows alone, through the plain versions on the CPU,
    give every real row of the padded inputs' results bit for bit."""
    bucket, bseg, probes, pseg, thr = _case(name)
    b8, p8, bs, ps, thr_t = _card_inputs(bucket, bseg, probes, pseg, thr)
    cos_thr = float(np.cos(5e-2))
    got = tops._finish(*tref.crossmatch_fused_ref(b8, p8, bs, ps, cos_thr),
                       len(bucket), len(probes))
    _assert_bits(got, tops.crossmatch_fused(
        bucket, probes, bseg, pseg, cos_thr, device="cpu"))
    got = tops._finish(*tref.crossmatch_shared_ref(b8, p8, bs, ps, thr_t),
                       len(bucket), len(probes))
    _assert_bits(got, tops.crossmatch_shared(
        bucket, probes, bseg, pseg, thr, device="cpu"))


def test_card_inputs_at_the_engine_shape():
    """Four 700-row segments and 2,900 sorted probes: the card path's
    inputs have the real rows only (M = 2,900, not 4,096), and give the
    padded results; so does the split mirror at 5 splits."""
    rng = np.random.default_rng(16)
    bucket = _unit(rng, 2800)
    bseg = np.repeat(np.arange(4), 700)
    parts = np.array_split(np.arange(2900), 4)
    probes = np.concatenate([_near(rng, bucket[700 * s:700 * (s + 1)], len(p))
                             for s, p in enumerate(parts)])
    pseg = np.repeat(np.arange(4), [len(p) for p in parts])
    b8, p8, bs, ps = _card_inputs(bucket, bseg, probes, pseg)
    assert p8.shape == (2900, tkernel.COORD_PAD)
    thr = float(np.cos(2e-3))
    want = tops.crossmatch_fused(bucket, probes, bseg, pseg, thr, device="cpu")
    _assert_bits(tops._finish(*tref.crossmatch_fused_ref(b8, p8, bs, ps, thr),
                              2800, 2900), want)
    _assert_bits(tref.crossmatch_splits_ref(
        b8, p8, *tref.segment_rows(bs, ps), thr, 5), want)


def test_no_probe_rows_keep_one_padded_row():
    b8, p8, _, ps, _, m = tops._segmented_inputs(
        _unit(np.random.default_rng(0), 40), np.zeros((0, 3)), np.zeros(40),
        np.zeros(0), 128, 512, pad_probes=False)
    assert m == 0 and p8.shape == (1, tkernel.COORD_PAD)
    assert ps.tolist() == [tkernel.PAD_SEG]


@pytest.mark.parametrize("m,n,want", [
    (256, 16384, (1, 64)),        # phase 2's M = 256: rows cap the splits
    (4096, 16384, (16, 64)),
    (32768, 16384, (128, 33)),
    (101545, 65536, (397, 11)),   # phase 4's real shape
    (131072, 65536, (512, 9)),    # phase 4's old padded shape
    (1_200_000, 65536, (4688, 1)),  # enough blocks: no split
    (1, 100, (1, 1)),             # a bucket under MIN_SPLIT_ROWS
])
def test_split_plan_from_shapes(monkeypatch, m, n, want):
    """Blocks of 256 probes (2 a thread) on 132 SMs, split until the grid
    holds 32 blocks an SM, each split at least 256 bucket rows."""
    monkeypatch.setattr(tkernel, "SPLIT_BLOCKS_PER_SM", 32)
    monkeypatch.setattr(tkernel, "MIN_SPLIT_ROWS", 256)
    assert tkernel.split_plan(m, n, 132, 256) == want


def test_split_plan_caps_at_the_grid():
    blocks, splits = tkernel.split_plan(1, 1 << 30, 1 << 20, 512)
    assert blocks == 1 and splits == 65535
