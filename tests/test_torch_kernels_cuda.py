"""The join contract, and the CUDA kernels held to it on a card.

``assert_join_close`` is the tolerance every port test of the join uses:
``best_dot`` within ``DOT_TOL`` = 2**-23, one ulp at 1.0 (the bound on a
unit-vector dot and each of its terms); ``best_idx`` exact except between
two candidates whose dots lie within ``DOT_TOL`` (lowest index wins ties);
``n_cand`` exact except on a probe with a pair whose dot lies within
``DOT_TOL`` of its threshold.  The port takes every dot as the fused
multiply-add chain over the columns in order, in the kernels and, on the
CPU, through ``torch.mm`` at the padded power-of-two shapes; the JAX
reference's jnp.dot on the CPU takes that order from a padded bucket of 64
rows up, and another one below, where the two differ by up to 2**-23.

The paged decode-attention kernel (K4) is held to its plain version at the
reference's tolerances for it: rtol = atol = 5e-2 in bfloat16 and 2e-5 in
float32 (``tests/test_kernels.py:220``, ``:235``), at the serving path's
shape and at ``benchmarks/kernel_bench.py``'s; where it splits a sequence
across blocks it is held to ``paged_attention_splits_ref`` with the same
chunk too, at the same tolerances, and two calls give the same bits.
K4's partials (``ops.paged_attention_partials``: the row's max score m and
softmax sum l beside the output, for a sequence-sharded cache) are held to
``paged_attention_partials_ref`` on the card at one split (64 slots), at a
decode_32k shard (16,384 slots, 32 splits), on an empty shard and with a
bad page: ``out`` to K4's rule, and bit-equal to the call without
partials; m within 1e-4 absolute (the kernel's base-2 max times ln 2; an
f32 dot of D = 128 unit normals is good to 128 * 2**-24 * sum|q k| /
sqrt(D), ~6e-5) and l within 2e-4 relative (exp of that); an empty row
gives m = -1e30, l = 0 and out = 0 exactly, a bad page NaN in all three.
Merging the two halves of a 32,768-slot cache with
``attention._local_decode``'s formula equals K4 on the whole cache.  K4's
tensor-core instance (bf16, G = H / KV > 2 query heads a KV head, D =
64-256) is held the same way at G = 3, 4, 6, 8, 12 and each D, at one
split and at two, with its partials, an empty row and a bad page; f32
calls with G > 2 take the pair instance, and G > 16 runs the chunk once
for each 16 rows.

The grouped matmul (K5) is held to its plain version at the reference's
tolerances for it, rtol = atol = 5e-2 in bfloat16 and 1e-5 in float32
(``tests/test_kernels.py:173``), at aligned row tiles with ragged column
and depth edges, with and without counts of real rows a tile (the TMA
kernel for bf16 rows of a 16-byte pitch, the async one else), with
weights at the model's init scale 1/sqrt(d) (what K5
sees on the MoE path).  The reference's 1e-5 is set for its depths (d <=
512); two f32 sums over d terms in different orders drift apart by about
sqrt(d) ulps of the partial sums (at d = 2048 with weights x0.1 the card
and the CPU differed by 1.3e-5 on an element of 0.04, neither wrong).  So
at d > 512 both the kernel and the plain version are held to the float64
product within the f32 dot-product bound sqrt(d) * 2**-24 * sum|x||w|
(Higham's probabilistic bound), elementwise; a wrong group or tile would be
off by O(1).  The MoE decode at smoke size on the card is held to the same
decode on the CPU, and so is the decode of each family the model zoo adds
(SSM, hybrid, encoder-decoder, VLM); K4 and K5 are held at those
families' full-width decode shapes too (K4 at D = 256 with eight query
heads on one KV head and at D = 64; K5 at jamba's 16 experts of d = 4096,
f = 14336, against the plain version on the card).  K5's backward (dX,
K5 on the transposed weights; dW, its own kernel) is held to its plain
versions on the CPU at 1e-2 (bf16) and 1e-5 (f32) of the largest value
(the sums run over at most 256 rows here), and one MoE layer's backward
on the card to the same layer's on the CPU at 1e-4 (f32).  The TMA dW
kernel loads whole 64-row boxes and zeroes the rows past each tile's
count itself, so it is held with noise, and NaN in one tile, past the
counts; dX read from w through its tensor map equals K5 on a contiguous
copy of w^T bit for bit, and a backward makes no device-to-device copy.
In both dtypes K5 has two kernels for each product: the TMA-fed one
(``kernel_path`` "tma" / "f32") and the async one ("async" /
"f32_async", taken where TMA cannot describe an operand: d or f not a
multiple of 8 (bf16) or 4 (f32), or a base off 16 bytes), which runs the
TMA kernel's consumers on a ring filled through cp.async at each
operand's copy width (16, 8, 4 or, in bf16, 2 bytes,
``kernel.copy_bytes``).  The forward, dX and dW of the async kernels are
held to their plain versions at each width, with counts, noise and NaN
past them, an empty group and a bad group id, to the TMA kernels bit for
bit on copies of aligned inputs whose bases lie off 16 bytes (bf16 8, 4
or 2 bytes; f32 4, 8 or 12: each f32 output is one fmaf chain in the
same order on both), to themselves from call to call, and dX at an
output width TMA cannot describe allocates no w^T.

The tests here are marked ``cuda``: they run the CUDA kernels on a card
against the plain versions on the CPU, and skip without one.  They import
only the port (the card's machine has no JAX):

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import crossmatch as tcm  # noqa: E402
from repro_torch.core.sfc import htm_id  # noqa: E402
from repro_torch.kernels.crossmatch import kernel as tkernel  # noqa: E402
from repro_torch.kernels.crossmatch import ops as tops  # noqa: E402
from repro_torch.kernels.crossmatch import ref as tref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_partials_ref, paged_attention_splits_ref,
)
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gops  # noqa: E402
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref  # noqa: E402
from repro_torch.benchmarks.common import misaligned, same_bits  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import registry as tmodels  # noqa: E402

CPU = "cpu"
DOT_TOL = 2.0**-23  # one ulp at 1.0


def _np(out):
    return tuple(np.asarray(x) for x in out)


def assert_join_close(got, want, bucket, probes, thr, bseg=None, pseg=None,
                      tol=DOT_TOL):
    """(idx, dot, cnt) of two joins agree under the join contract.

    ``bucket``/``probes`` are the unpadded (?, 3) inputs and ``thr`` the
    threshold (scalar or per probe); with segments, a pair of different
    segments dots to -2 (it takes no part).  ``tol=0`` asks for
    bit-identical dots."""
    gi, gd, gc = _np(got)
    wi, wd, wc = _np(want)
    assert gi.shape == wi.shape == gd.shape == gc.shape

    def dots(rows):
        p = np.asarray(probes, np.float32)[rows].astype(np.float64)
        d = p @ np.asarray(bucket, np.float32).astype(np.float64).T
        if bseg is not None:
            same = np.asarray(pseg)[rows][:, None] == np.asarray(bseg)[None, :]
            d = np.where(same, d, -2.0)
        return d

    diff = np.abs(gd.astype(np.float64) - wd.astype(np.float64))
    assert (diff <= tol).all(), diff.max()
    rows = np.nonzero(gi != wi)[0]
    if rows.size:
        d = dots(rows)
        a = d[np.arange(rows.size), gi[rows]]
        c = d[np.arange(rows.size), wi[rows]]
        assert (np.abs(a - c) <= tol).all(), (rows, gi[rows], wi[rows])
    rows = np.nonzero(gc != wc)[0]
    if rows.size:
        t = np.broadcast_to(np.asarray(thr, np.float32), gc.shape)[rows]
        near = np.abs(dots(rows) - t.astype(np.float64)[:, None]) <= tol
        assert near.any(axis=1).all(), (rows, gc[rows], wc[rows])


# ------------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _near(rng, rows, m, scale=2e-3):
    """``m`` probes within ~``scale`` rad of random ``rows``: thresholds bite."""
    p = rows[rng.integers(0, len(rows), m)] + rng.normal(scale=scale, size=(m, 3))
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,band", [
    (700, 300, None), (10_000, 4096, None), (1024, 1024, 0), (33, 513, None),
])
def test_k1_kernel_matches_plain(card, n, m, band):
    rng = np.random.default_rng(n + m)
    bkt = _unit(rng, n)
    bkt = bkt[np.argsort(htm_id(bkt, level=8), kind="stable")]
    prb = _near(rng, bkt, m)
    for thr in (float(np.cos(5e-3)), float(np.cos(2.0)), -2.0):
        kw = dict(bm=128, bn=128, band=band)
        cpu = tops.crossmatch(bkt, prb, thr, device=CPU, **kw)
        before = tkernel.LAUNCHES["crossmatch"]
        got = tops.crossmatch(bkt, prb, thr, device=card, **kw)
        assert tkernel.LAUNCHES["crossmatch"] == before + 1
        assert all(x.is_cuda for x in got)
        assert_join_close([x.cpu() for x in got], cpu, bkt, prb, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[100, 0, 57], [3000, 3000, 0, 4000], [1] * 9])
def test_k2_k3_kernels_match_plain(card, sizes):
    rng = np.random.default_rng(len(sizes))
    parts = [_unit(rng, s) for s in sizes]
    bucket = np.concatenate(parts)
    bseg = np.repeat(np.arange(len(sizes)), sizes)
    probes = np.concatenate([_near(rng, p if len(p) else bucket, 50) for p in parts])
    pseg = np.repeat(np.arange(len(sizes)), 50)
    order = rng.permutation(len(probes))  # probes in any segment order
    probes, pseg = probes[order], pseg[order]
    thr = np.cos(rng.choice([1e-3, 2e-3, 5e-3, 1e-2, 2.0], len(probes)))
    thr = thr.astype(np.float32)
    for name, call, t in (
        ("crossmatch_fused", lambda dev: tops.crossmatch_fused(
            bucket, probes, bseg, pseg, 0.99999, device=dev), 0.99999),
        ("crossmatch_shared", lambda dev: tops.crossmatch_shared(
            bucket, probes, bseg, pseg, thr, device=dev), thr),
    ):
        before = tkernel.LAUNCHES[name]
        got = call(card)
        assert tkernel.LAUNCHES[name] == before + 1
        assert_join_close([x.cpu() for x in got], call(CPU), bucket, probes, t,
                          bseg, pseg)


def segment_case(name):
    """(bucket, bseg, probes, pseg, per-probe thresholds) of one segmented
    layout; buckets of at least 33 rows."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties across splits":
        # One segment of 60 rows; duplicates at the middle (the boundary of
        # 2 splits), at 20/40 (3 splits) and across rows 8/9 (7 splits).
        bucket = _unit(rng, 60)
        for a, b in ((29, 30), (19, 20), (39, 40), (8, 9), (17, 50)):
            bucket[b] = bucket[a]
        bseg = np.zeros(60)
        probes = _near(rng, bucket[[29, 19, 39, 8, 17, 30, 50]], 40, 1e-4)
        pseg = np.zeros(40)
    elif name == "empty segments":
        # Segment 1 has probes and no rows; segment 2 rows and no probes.
        sizes = [30, 0, 25, 20]
        bucket = _unit(rng, sum(sizes))
        bseg = np.repeat([0, 1, 2, 3], sizes)
        probes = np.concatenate([_near(rng, bucket[:30], 12), _unit(rng, 5),
                                 _near(rng, bucket[55:], 9)])
        pseg = np.repeat([0, 1, 3], [12, 5, 9])
    elif name == "one-row segments":
        bucket = _unit(rng, 40)
        bseg = np.arange(40)
        probes = _near(rng, bucket, 60, 0.05)
        pseg = np.sort(rng.integers(0, 40, 60))
    elif name == "probes in any order":
        sizes = [20, 35, 14]
        bucket = _unit(rng, sum(sizes))
        bseg = np.repeat([0, 1, 2], sizes)
        probes = _near(rng, bucket, 50)
        pseg = rng.integers(0, 3, 50)  # unsorted, and not the rows' own
    elif name == "M = 1":
        bucket = _unit(rng, 48)
        bseg = np.repeat([0, 1], [20, 28])
        probes = _near(rng, bucket[30:], 1)
        pseg = np.array([1])
    else:
        raise KeyError(name)
    thr = np.cos(rng.choice([1e-4, 2e-3, 5e-2, 2.0], len(probes)))
    return bucket, bseg, probes, pseg, thr.astype(np.float32)


SEGMENT_CASES = ["ties across splits", "empty segments", "one-row segments",
                 "probes in any order", "M = 1"]


# Split edges of 3 and of 16 splits of 300 rows: the tie case's duplicates.
TIE_EDGES = [18, 100, 150, 200, 281]


def _sorted_near(rng, bucket, m, scale=2e-3):
    """``m`` probes near ascending bucket rows, in that order: with an
    HTM-sorted bucket, probes and rows both follow the band's diagonal."""
    rows = np.sort(rng.integers(0, len(bucket), m))
    p = bucket[rows] + rng.normal(scale=scale, size=(m, 3))
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


def _htm_sorted(rng, n):
    b = _unit(rng, n)
    return b[np.argsort(htm_id(b, level=8), kind="stable")]


def bucket_case(name):
    """(bucket, probes, cos_thr, band, bm, bn) of one single-bucket layout;
    buckets of at least 33 rows."""
    rng = np.random.default_rng(sum(map(ord, name)))
    thr, band, bm, bn = float(np.cos(2e-3)), None, 128, 128
    if name == "ties across splits":
        bucket = _unit(rng, 300)
        for e in TIE_EDGES:
            bucket[e] = bucket[e - 1]
        probes = np.concatenate([
            _near(rng, bucket[[e - 1 for e in TIE_EDGES]], 40, 1e-4),
            _near(rng, bucket, 260)])
    elif name == "last real row":
        bucket = _unit(rng, 300)
        probes = np.concatenate([_near(rng, bucket[[299]], 9, 1e-4),
                                 _near(rng, bucket, 91)])
    elif name == "band at tile edges":
        # 700 probes (grid 1024 = 8 tile rows) on 1,000 rows (grid 1024 = 8
        # tiles): each tile row's last 8 probes sit at its band's last row.
        bucket = _htm_sorted(rng, 1000)
        probes = _sorted_near(rng, bucket, 700)
        band = 1
        for i in range(700 // bm):
            center = i * 8 // 8
            last = min((center + band + 1) * bn, 1000) - 1
            probes[i * bm + bm - 8:(i + 1) * bm] = _near(rng, bucket[[last]], 8,
                                                        1e-4)
    elif name == "band, odd bm":
        # bm = 7: two probes of a thread straddle two tile rows in turn.
        bucket = _htm_sorted(rng, 400)
        probes = _sorted_near(rng, bucket, 100)
        band, bm = 0, 7
    elif name == "threshold -2":
        bucket = _unit(rng, 300)
        probes = _near(rng, bucket, 50)
        thr = -2.0
    elif name == "threshold -2, band":
        bucket = _htm_sorted(rng, 300)
        probes = _sorted_near(rng, bucket, 50)
        thr, band, bm = -2.0, 1, 16
    elif name == "M = 1":
        bucket = _unit(rng, 40)
        probes = _near(rng, bucket[[39]], 1, 1e-4)
    else:
        raise KeyError(name)
    return bucket, probes, thr, band, bm, bn


BUCKET_CASES = ["ties across splits", "last real row", "band at tile edges",
                "band, odd bm", "threshold -2", "threshold -2, band", "M = 1"]


def bucket_inputs(case, dev):
    """A single-bucket layout's inputs as the card path builds them: the
    padded bucket, the real probe rows only, the real bucket row count and
    the padded probe count (the band's grid), on ``dev``."""
    bucket, probes, _, _, bm, bn = case
    b8, p8, n_real, m_true = tops._host_prepare(bucket, probes, bm, bn,
                                                pad_probes=False)
    return (torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev),
            n_real, tops._probe_grid(m_true, bm))


def bucket_split_ref(b8, p8, n_real, m_grid, thr, band, bm, bn, splits):
    """The split mirror over each probe's rows as the card takes them."""
    rows = tkernel.bucket_rows_taken(b8.shape[0], n_real, thr)
    lo, hi = tref.bucket_rows(p8.shape[0], rows, band, bm, bn, m_grid,
                              b8.shape[0], device=p8.device)
    return tref.crossmatch_splits_ref(b8, p8, lo, hi, thr, splits)


def _segment_inputs(case, dev):
    """A layout's inputs as the card path builds them (the real probe rows
    only), on ``dev``, and its per-probe thresholds."""
    bucket, bseg, probes, pseg, thr = case
    b8, p8, bs, ps, _, _ = tops._segmented_inputs(
        bucket, probes, bseg, pseg, 128, 512, pad_probes=False)
    return ([torch.from_numpy(x).to(dev) for x in (b8, p8, bs, ps)],
            torch.from_numpy(thr).to(dev))


def _assert_bits(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["split", "no split"])
@pytest.mark.parametrize("name", SEGMENT_CASES)
def test_k2_k3_segment_kernel_matches_split_ref(card, monkeypatch, name, plan):
    """The segment kernel gives the split mirror's bits at its own plan
    (split: 8-row parts; no split: one block walks each range), and the
    plain versions' on the CPU and, under the join contract, on the card."""
    monkeypatch.setattr(tkernel, "MIN_SPLIT_ROWS", 8)
    if plan == "no split":
        monkeypatch.setattr(tkernel, "SPLIT_BLOCKS_PER_SM", 0)
    case = segment_case(name)
    (b8, p8, bs, ps), thr = _segment_inputs(case, card)
    _, splits = tkernel.segment_plan(p8.shape[0], b8.shape[0], card)
    assert (splits > 1) == (plan == "split")
    cpu = [x.cpu() for x in (b8, p8, bs, ps)]
    cos_thr = float(np.cos(2e-3))
    for name_k, kern, plain, t in (
        ("crossmatch_fused", tkernel.crossmatch_fused_kernel,
         tref.crossmatch_fused_ref, cos_thr),
        ("crossmatch_shared", tkernel.crossmatch_shared_kernel,
         tref.crossmatch_shared_ref, thr),
    ):
        before = tkernel.LAUNCHES[name_k]
        got = kern(b8, p8, bs, ps, t)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES[name_k] == before + 1
        t_cpu = t.cpu() if torch.is_tensor(t) else t
        _assert_bits(got, tref.crossmatch_splits_ref(
            cpu[0], cpu[1], *tref.segment_rows(cpu[2], cpu[3]), t_cpu, splits))
        _assert_bits(got, plain(*cpu, t_cpu))
        assert_join_close([x.cpu() for x in got],
                          [x.cpu() for x in plain(b8, p8, bs, ps, t)],
                          b8.cpu()[:, :3], p8.cpu()[:, :3],
                          t_cpu.numpy() if torch.is_tensor(t) else t,
                          bs.cpu(), ps.cpu())


@pytest.mark.cuda
def test_k2_k3_segment_kernel_same_bits_every_run(card):
    """Four 3,000-row segments, 3,000 sorted probes (six blocks, split
    across the card): two calls, and a call after a call of another
    shape on the same stream, give the same bits."""
    rng = np.random.default_rng(7)
    bucket = _unit(rng, 12_000)
    bseg = np.repeat(np.arange(4), 3000)
    probes = _near(rng, bucket, 3000)
    pseg = np.sort(rng.integers(0, 4, 3000))
    thr = np.cos(rng.choice([2e-3, 5e-3], 3000)).astype(np.float32)
    (b8, p8, bs, ps), thr_t = _segment_inputs(
        (bucket, bseg, probes, pseg, thr), card)
    assert tkernel.segment_plan(3000, b8.shape[0], card)[1] > 1
    first = tkernel.crossmatch_shared_kernel(b8, p8, bs, ps, thr_t)
    again = tkernel.crossmatch_shared_kernel(b8, p8, bs, ps, thr_t)
    tkernel.crossmatch_shared_kernel(b8, p8[:7], bs, ps[:7], thr_t[:7])
    third = tkernel.crossmatch_shared_kernel(b8, p8, bs, ps, thr_t)
    _assert_bits(first, again)
    _assert_bits(first, third)
    cpu = [x.cpu() for x in (b8, p8, bs, ps)]
    _assert_bits(first, tref.crossmatch_shared_ref(*cpu, thr_t.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["split", "no split"])
@pytest.mark.parametrize("name", BUCKET_CASES)
def test_k1_kernel_matches_split_ref(card, monkeypatch, name, plan):
    """K1's instance of the kernel gives the split mirror's bits at its own
    plan (split: 8-row parts; no split: one block walks each range), and
    the plain version's on the CPU and, under the join contract, on the
    card."""
    monkeypatch.setattr(tkernel, "MIN_SPLIT_ROWS", 8)
    if plan == "no split":
        monkeypatch.setattr(tkernel, "SPLIT_BLOCKS_PER_SM", 0)
    case = bucket_case(name)
    bucket, probes, thr, band, bm, bn = case
    b8, p8, n_real, m_grid = bucket_inputs(case, card)
    rows = tkernel.bucket_rows_taken(b8.shape[0], n_real, thr)
    _, splits = tkernel.segment_plan(p8.shape[0], rows, card)
    assert (splits > 1) == (plan == "split")
    kw = dict(band=band, bm=bm, bn=bn)
    before = tkernel.LAUNCHES["crossmatch"]
    got = tkernel.crossmatch_kernel(b8, p8, thr, n_real=n_real, m_grid=m_grid,
                                    **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["crossmatch"] == before + 1
    b8c, p8c = b8.cpu(), p8.cpu()
    _assert_bits(got, bucket_split_ref(b8c, p8c, n_real, m_grid, thr, band,
                                       bm, bn, splits))
    _assert_bits(got, tref.crossmatch_ref(b8c, p8c, thr, m_grid=m_grid, **kw))
    assert_join_close(
        tops._finish(*[x.cpu() for x in got], len(bucket), len(probes)),
        tops._finish(*[x.cpu() for x in tref.crossmatch_ref(
            b8, p8, thr, m_grid=m_grid, **kw)], len(bucket), len(probes)),
        bucket, probes, thr)


@pytest.mark.cuda
def test_k1_kernel_same_bits_every_run(card):
    """10,000 rows and 3,900 probes (16 probe blocks, split across the
    card, as run A's batches): two calls, and a call after a call of
    another shape on the same stream, give the same bits; so does the
    band."""
    rng = np.random.default_rng(17)
    bucket = _htm_sorted(rng, 10_000)
    probes = _sorted_near(rng, bucket, 3900)
    for band in (None, 2):
        case = (bucket, probes, float(np.cos(5e-3)), band, 128, 512)
        b8, p8, n_real, m_grid = bucket_inputs(case, card)
        assert tkernel.segment_plan(3900, n_real, card)[1] > 1
        kw = dict(band=band, bm=128, bn=512, n_real=n_real, m_grid=m_grid)
        thr = case[2]
        first = tkernel.crossmatch_kernel(b8, p8, thr, **kw)
        again = tkernel.crossmatch_kernel(b8, p8, thr, **kw)
        tkernel.crossmatch_kernel(b8, p8[:7], thr, **kw)
        third = tkernel.crossmatch_kernel(b8, p8, thr, **kw)
        _assert_bits(first, again)
        _assert_bits(first, third)
        _assert_bits(first, tref.crossmatch_ref(
            b8.cpu(), p8.cpu(), thr, band=band, bm=128, bn=512, m_grid=m_grid))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernel_does_not_take(card):
    b = torch.zeros(512, 8, device=card)
    p = torch.zeros(128, 8, device=card)
    with pytest.raises(ValueError):
        tkernel.crossmatch_kernel(b.double(), p.double(), 0.9)
    with pytest.raises(ValueError):
        tkernel.crossmatch_kernel(b, torch.zeros(8, 128, device=card).t(), 0.9,
                                  bm=8)
    with pytest.raises(ValueError):
        tkernel.crossmatch_kernel(b, p[:100], 0.9)  # not a multiple of bm
    with pytest.raises(ValueError):  # more probe rows than the grid
        tkernel.crossmatch_kernel(b, p, 0.9, m_grid=64, bm=64)
    with pytest.raises(ValueError):  # more real rows than the bucket
        tkernel.crossmatch_kernel(b, p, 0.9, n_real=513)
    with pytest.raises(ValueError):  # no probe row
        tkernel.crossmatch_kernel(b, p[:0], 0.9, m_grid=128)
    with pytest.raises(ValueError):
        tkernel.crossmatch_kernel(b, p, 0.9, band=-1)
    with pytest.raises(ValueError):
        tkernel.crossmatch_fused_kernel(b, p, torch.zeros(512, device=card),
                                        torch.zeros(128), 0.9)  # seg on cpu
    with pytest.raises(ValueError):  # no probe row
        tkernel.crossmatch_fused_kernel(b, p[:0], torch.zeros(512, device=card),
                                        torch.zeros(0, device=card), 0.9)


@pytest.mark.cuda
def test_concurrent_shards_match_the_cpu(card):
    """Drain threads launch on the current stream concurrently (the ctypes
    call releases the GIL); results equal a CPU run of the same shards."""
    cat = tcm.make_catalog(n_objects=8_000, objects_per_bucket=200,
                           htm_level=7, seed=5)
    cfg = tcm.TraceConfig(n_queries=24, arrival_rate=2.0, objects_median=60,
                          seed=9)
    out = {}
    for device in (CPU, card):
        tkernel.reset_launches()
        sharded = tcm.ShardedCrossMatch(cat, 4, match_radius_rad=4e-3,
                                        fuse_k=2, device=device)
        out[str(device)] = sharded.run(tcm.make_trace(cat, cfg))
        launched = sum(tkernel.LAUNCHES.values())
    assert launched > 0
    flat = {
        k: {(qid, int(p), int(m), float(d), int(c))
            for qid, groups in res.items() for r in groups
            for p, m, d, c in zip(r.probe_idx, r.match_obj, r.best_dot,
                                  r.n_candidates)}
        for k, res in out.items()
    }
    assert flat["cpu"] == flat["cuda"]


# ------------------------------------------------------------------ K4
PAGED_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-5}


def _paged_case(rng, B, H, KV, D, page, pages, max_len, dtype):
    """Pools of B * pages pages in a shuffled order (the table is a
    permutation, not the identity) and ragged lengths in [1, max_len]."""
    n = B * pages
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(n, page, KV, D)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n, page, KV, D)).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(n).astype(np.int32).reshape(B, pages))
    lens = rng.integers(1, max_len + 1, B).astype(np.int32)
    lens[0] = max_len
    return [x.to(dtype) for x in (q, kp, vp)] + [pt, torch.from_numpy(lens)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 32, 32, 128, 16, 4, 16),  # (a) the serving path: S_alloc 64, lens 16
    (16, 16, 8, 128, 64, 32, 64 * 32),  # (b) kernel_bench's shape
    (3, 12, 4, 64, 8, 5, 40),  # G = 3, D = 64, a ragged last page
], ids=["serve", "kernel_bench", "ragged"])
def test_k4_kernel_matches_plain(card, shape, dtype):
    B, H, KV, D, page, pages, max_len = shape
    args = _paged_case(np.random.default_rng(B * H), B, H, KV, D, page,
                       pages, max_len, dtype)
    want = pops.paged_attention(*args)
    before = pkernel.LAUNCHES["paged_attention"]
    got = pops.paged_attention(*[x.to(card) for x in args])
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES["paged_attention"] == before + 1
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_k4_zero_length_and_bad_pages(card):
    """seq_len 0 gives 0 (as the Pallas kernel); a page index out of range
    gives NaN rows instead of a read out of bounds."""
    args = _paged_case(np.random.default_rng(1), 2, 4, 2, 32, 8, 2, 16,
                       torch.float32)
    q, kp, vp, pt, lens = [x.to(card) for x in args]
    lens[0] = 0
    out = pops.paged_attention(q, kp, vp, pt, lens)
    assert torch.count_nonzero(out[0]).item() == 0
    pt[1, 0] = kp.shape[0]
    out = pops.paged_attention(q, kp, vp, pt, lens)
    assert torch.isnan(out[1]).all() and not torch.isnan(out[0]).any()


@pytest.mark.cuda
def test_k4_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, kp, vp, pt, lens = [x.to(card) for x in _paged_case(
        np.random.default_rng(2), 2, 4, 2, 32, 8, 2, 16, torch.float32)]
    k = pkernel.paged_attention_kernel
    with pytest.raises(ValueError):
        k(q.half(), kp.half(), vp.half(), pt, lens)  # dtype
    with pytest.raises(ValueError):
        k(q, kp.bfloat16(), vp, pt, lens)  # mixed dtypes
    with pytest.raises(ValueError):
        k(q, kp, vp, pt.long(), lens)  # table type
    with pytest.raises(ValueError):
        k(q, kp, vp, pt, lens.cpu())  # device
    with pytest.raises(ValueError):
        k(q[:, :3], kp, vp, pt, lens)  # H % KV
    big = torch.zeros(2, 4, 512, device=card)
    with pytest.raises(ValueError):
        k(big, torch.zeros(4, 8, 2, 512, device=card),
          torch.zeros(4, 8, 2, 512, device=card), pt, lens)  # head_dim
    with pytest.raises(ValueError):
        k(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, pt, lens)


SPLIT_SHAPES = {
    # (B, H, KV, D, page, pages, max_len)
    "kernel_bench": (16, 16, 8, 128, 64, 32, 64 * 32),
    "one_long": (1, 32, 32, 128, 64, 64, 4096),
}


def _splits(args):
    q, kp = args[0], args[1]
    B, _, _ = q.shape
    _, page, KV, _ = kp.shape
    return pkernel.split_plan(args[3].shape[1] * page)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SPLIT_SHAPES), ids=list(SPLIT_SHAPES))
def test_k4_split_matches_plain_and_split_ref(card, shape, dtype):
    """A sequence cut across blocks and merged in the launch: against the
    plain version and against the split arithmetic with the same chunk;
    one launch a call, and the same bits from two calls."""
    B, H, KV, D, page, pages, max_len = SPLIT_SHAPES[shape]
    args = _paged_case(np.random.default_rng(B + H), B, H, KV, D, page,
                       pages, max_len, dtype)
    splits, chunk = _splits(args)
    assert splits > 1
    dev = [x.to(card) for x in args]
    assert pkernel.kernel_path(*dev[:3]) == "async"
    before = pkernel.LAUNCHES["paged_attention"]
    got = pops.paged_attention(*dev)
    again = pops.paged_attention(*dev)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES["paged_attention"] == before + 2
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    tol = PAGED_TOL[dtype]
    got = got.float().cpu().numpy()
    for want in (pops.paged_attention(*args),
                 paged_attention_splits_ref(*args, chunk)):
        want = want.float().numpy()
        # Averages over thousands of slots are small: atol scales with them.
        np.testing.assert_allclose(
            got, want, rtol=tol, atol=tol * min(1.0, float(np.abs(want).max())))


@pytest.mark.cuda
def test_k4_split_zero_length_and_a_late_bad_page(card):
    """With splits > 1: seq_len 0 gives 0; a bad page met only by a late
    split makes that sequence's rows NaN and no other's."""
    B, H, KV, D, page, pages = 3, 8, 4, 64, 16, 128
    args = _paged_case(np.random.default_rng(9), B, H, KV, D, page, pages,
                       page * pages, torch.float32)
    q, kp, vp, pt, lens = [x.to(card) for x in args]
    splits, chunk = _splits(args)
    assert splits > 2
    lens[:] = torch.tensor([0, page * pages, page * pages])
    pt[2, (splits - 1) * chunk // page] = -1  # read by the last split only
    out = pops.paged_attention(q, kp, vp, pt, lens)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]).item() == 0
    assert not torch.isnan(out[:2]).any()
    assert torch.isnan(out[2]).all()
    want = pops.paged_attention(*args[:3], pt.cpu(), lens.cpu())
    np.testing.assert_allclose(out[1].cpu().numpy(), want[1].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k4_scalar_instance(card, dtype):
    """D = 40: not 8, 16, 32 or 64 16-byte vectors a row, so the scalar-load
    instance, split and not."""
    for pages, max_len in ((4, 30), (40, 640)):
        args = _paged_case(np.random.default_rng(pages), 3, 6, 2, 40, 16,
                           pages, max_len, dtype)
        dev = [x.to(card) for x in args]
        assert pkernel.kernel_path(*dev[:3]) == "scalar"
        got = pops.paged_attention(*dev)
        tol = PAGED_TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   pops.paged_attention(*args).float().numpy(),
                                   rtol=tol, atol=tol)


# K4's partials: m (absolute, natural units) and l (relative); see the
# module docstring.
PARTIALS_M_TOL = 1e-4
PARTIALS_L_TOL = 2e-4
PARTIAL_SHAPES = {
    # (B, H, KV, D, page, pages, max_len): CodeQwen's heads
    "one_split": (8, 32, 32, 128, 16, 4, 64),  # the serving path's 64 slots
    "decode_32k_shard": (2, 32, 32, 128, 16, 1024, 16384),  # 32 splits
}


def _partials_close(got, want, dtype):
    (out, m, l_), (w_out, w_m, w_l) = got, want
    tol = PAGED_TOL[dtype]
    w_out = w_out.float()
    np.testing.assert_allclose(
        out.float().cpu().numpy(), w_out.cpu().numpy(), rtol=tol,
        atol=tol * min(1.0, float(w_out.abs().max())))
    np.testing.assert_allclose(m.cpu().numpy(), w_m.cpu().numpy(),
                               rtol=0, atol=PARTIALS_M_TOL)
    np.testing.assert_allclose(l_.cpu().numpy(), w_l.cpu().numpy(),
                               rtol=PARTIALS_L_TOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(PARTIAL_SHAPES),
                         ids=list(PARTIAL_SHAPES))
def test_k4_partials_match_plain(card, shape, dtype):
    """Both exits: the one-split write and the merge of 32 splits; one
    launch a call, the output bit-equal to the call without partials."""
    B, H, KV, D, page, pages, max_len = PARTIAL_SHAPES[shape]
    args = [x.to(card) for x in _paged_case(
        np.random.default_rng(B + pages), B, H, KV, D, page, pages, max_len,
        dtype)]
    splits, _ = _splits(args)
    assert (splits == 1) == (shape == "one_split")
    before = pkernel.LAUNCHES["paged_attention"]
    got = pops.paged_attention_partials(*args)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES["paged_attention"] == before + 1
    out, m, l_ = got
    assert out.dtype == dtype and m.dtype == l_.dtype == torch.float32
    assert m.shape == l_.shape == (B, H) and m.is_cuda and l_.is_cuda
    _partials_close(got, paged_attention_partials_ref(*args), dtype)
    assert torch.equal(out.view(torch.uint8),
                       pops.paged_attention(*args).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PARTIAL_SHAPES),
                         ids=list(PARTIAL_SHAPES))
def test_k4_partials_empty_shard_and_bad_page(card, shape):
    """A shard no slot of which is valid yet (seq_len 0: m = -1e30, l = 0,
    out = 0, as the plain version gives), beside a sequence that holds
    slots; then a bad page met by the last split makes that sequence's
    out, m and l NaN and no other's."""
    B, H, KV, D, page, pages, max_len = PARTIAL_SHAPES[shape]
    args = [x.to(card) for x in _paged_case(
        np.random.default_rng(7), B, H, KV, D, page, pages, max_len,
        torch.bfloat16)]
    q, kp, vp, pt, lens = args
    lens[0] = 0
    out, m, l_ = pops.paged_attention_partials(*args)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]).item() == 0
    assert bool((m[0] == -1e30).all()) and bool((l_[0] == 0).all())
    _partials_close((out, m, l_), paged_attention_partials_ref(*args),
                    torch.bfloat16)
    splits, chunk = _splits(args)
    lens[1] = max_len
    pt[1, (splits - 1) * chunk // page] = kp.shape[0]  # the last split's
    out, m, l_ = pops.paged_attention_partials(*args)
    torch.cuda.synchronize()
    for x in (out, m, l_):
        assert torch.isnan(x[1]).all() and not torch.isnan(x[0]).any()
        assert not torch.isnan(x[2:]).any()


@pytest.mark.cuda
def test_k4_partials_of_two_halves_merge_to_the_whole(card):
    """A 32,768-slot cache cut in two 16,384-slot shards, as a (1, 2) mesh
    cuts decode_32k's: each half's partials merged by _local_decode's
    formula (m = max m_s, w_s = exp(m_s - m) l_s, out = sum w_s out_s /
    sum w_s) equal K4 on the whole cache, at K4's rule; one sequence
    reaches past the half, one ends in the first (its second shard
    empty)."""
    B, H, KV, D, page, pages = 2, 32, 32, 128, 16, 2048
    args = [x.to(card) for x in _paged_case(
        np.random.default_rng(3), B, H, KV, D, page, pages, page * pages,
        torch.bfloat16)]
    q, kp, vp, pt, lens = args
    half = page * pages // 2
    lens[:] = torch.tensor([page * pages - 5, half - 1000])
    parts = []
    for lo in (0, half):
        table = pt[:, lo // page:(lo + half) // page].contiguous()
        shard = torch.clamp(lens - lo, 0, half).to(torch.int32)
        parts.append(pops.paged_attention_partials(q, kp, vp, table, shard))
    m_all = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(m - m_all) * l_ for _, m, l_ in parts]
    num = sum(w_s[..., None] * out.float() for w_s, (out, _, _) in zip(w, parts))
    merged = (num / torch.clamp(w[0] + w[1], min=1e-30)[..., None]).to(q.dtype)
    assert bool((parts[1][1][1] == -1e30).all())  # the empty second shard
    want = pops.paged_attention(*args).float()
    tol = PAGED_TOL[torch.bfloat16]
    np.testing.assert_allclose(
        merged.float().cpu().numpy(), want.cpu().numpy(), rtol=tol,
        atol=tol * min(1.0, float(want.abs().max())))


# ------------------------------------------------------------------ K5
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,full", [
    ((8, 8, 1, 256, 16, 4, 16), False),  # paligemma: MQA, G = 8, D = 256
    ((8, 16, 16, 64, 16, 4, 16), False),  # seamless's self-attention, D = 64
    ((8, 16, 16, 64, 16, 1, 16), True),  # its cross-attention: 16 slots, full
], ids=["paligemma", "seamless_self", "seamless_cross"])
def test_k4_zoo_decode_shapes_match_plain(card, shape, full, dtype):
    """K4 at the decode shapes of the families the zoo adds: eight query
    heads on one KV head at D = 256 (the tensor-core instance in bf16) and
    an 8-vector row (bf16 D = 64)."""
    B, H, KV, D, page, pages, max_len = shape
    args = _paged_case(np.random.default_rng(D + H), B, H, KV, D, page,
                       pages, max_len, dtype)
    if full:
        args[4].fill_(max_len)
    want = pops.paged_attention(*args)
    on_card = [x.to(card) for x in args]
    assert pkernel.kernel_path(*on_card[:3]) == (
        "mma" if dtype == torch.bfloat16 and H // KV > 2 else "async")
    before = pkernel.LAUNCHES["paged_attention"]
    got = pops.paged_attention(*on_card)
    torch.cuda.synchronize()
    assert pkernel.LAUNCHES["paged_attention"] == before + 1
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


# Query-head groups (G = H / KV > 2) on 2 KV heads: jamba G = 4,
# mixtral-8x22b 6, paligemma and qwen1.5-110b 8, mistral-large-123b and
# nemotron-4-340b 12 (D = 192), and G = 3, at each head_dim the
# tensor-core instance takes.
HEAD_GROUP_GS = (3, 4, 6, 8, 12)
HEAD_GROUP_DS = (64, 128, 192, 256)


def _pair_path(d, dtype):
    """The pair instance a row of ``d`` elements takes (f32 at any G)."""
    vecs = d * torch.tensor([], dtype=dtype).element_size() // 16
    return "async" if vecs in (8, 16, 32, 64) else "scalar"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", HEAD_GROUP_DS, ids=[f"d{d}" for d in HEAD_GROUP_DS])
@pytest.mark.parametrize("g", HEAD_GROUP_GS, ids=[f"g{g}" for g in HEAD_GROUP_GS])
def test_k4_head_groups_match_plain(card, g, d, dtype):
    """K4 with G = H / KV > 2 query heads a KV head, at one split (64
    slots) and at two (640 slots, merged in the launch): bf16 on the
    tensor-core instance (all G rows in one pass over the chunk), f32 on
    the pair instance; one launch a call, counted under its path, and the
    same bits from two calls."""
    h, kv = 2 * g, 2
    path = "mma" if dtype == torch.bfloat16 else _pair_path(d, dtype)
    for pages, max_len in ((4, 64), (40, 600)):
        args = _paged_case(np.random.default_rng(h + d + pages), 3, h, kv, d,
                           16, pages, max_len, dtype)
        want = pops.paged_attention(*args)
        on_card = [x.to(card) for x in args]
        assert pkernel.kernel_path(*on_card[:3]) == path
        assert pkernel.split_plan(pages * 16)[0] == (1 if pages == 4 else 2)
        before = pkernel.LAUNCHES["paged_attention"]
        by_path = pkernel.PATH_LAUNCHES[path]
        got = pops.paged_attention(*on_card)
        again = pops.paged_attention(*on_card)
        torch.cuda.synchronize()
        assert pkernel.LAUNCHES["paged_attention"] == before + 2
        assert pkernel.PATH_LAUNCHES[path] == by_path + 2
        assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
        tol = PAGED_TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (3, 40, 2, 128, 16, 40, 600),  # G = 20: the chunk once a 16 rows
    (2, 48, 1, 64, 8, 3, 24),  # G = 48, one split, a page of 8
], ids=["g20_two_splits", "g48"])
def test_k4_more_than_16_query_rows(card, shape):
    """G > 16 (no config of the repo): the tensor-core instance runs the
    chunk once for each 16 rows and holds every row to the plain version."""
    B, H, KV, D, page, pages, max_len = shape
    args = _paged_case(np.random.default_rng(H), B, H, KV, D, page, pages,
                       max_len, torch.bfloat16)
    on_card = [x.to(card) for x in args]
    assert pkernel.kernel_path(*on_card[:3]) == "mma"
    got = pops.paged_attention(*on_card)
    tol = PAGED_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               pops.paged_attention(*args).float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_GROUP_DS, ids=[f"d{d}" for d in HEAD_GROUP_DS])
@pytest.mark.parametrize("pages", [4, 40], ids=["one_split", "two_splits"])
def test_k4_head_groups_partials_empty_row_and_bad_page(card, d, pages):
    """The tensor-core instance (bf16, G = 6) with its partials against
    ``paged_attention_partials_ref``, bit-equal to the call without them;
    a row of seq_len 0 gives out 0, m -1e30, l 0; a bad page met by the
    last split makes that sequence's out, m and l NaN and no other's."""
    B, H, KV, page = 3, 12, 2, 16
    args = [x.to(card) for x in _paged_case(
        np.random.default_rng(d + pages), B, H, KV, d, page, pages,
        page * pages, torch.bfloat16)]
    q, kp, vp, pt, lens = args
    assert pkernel.kernel_path(q, kp, vp) == "mma"
    lens[0] = 0
    got = pops.paged_attention_partials(*args)
    torch.cuda.synchronize()
    out, m, l_ = got
    assert torch.count_nonzero(out[0]).item() == 0
    assert bool((m[0] == -1e30).all()) and bool((l_[0] == 0).all())
    _partials_close(got, paged_attention_partials_ref(*args), torch.bfloat16)
    assert torch.equal(out.view(torch.uint8),
                       pops.paged_attention(*args).view(torch.uint8))
    splits, chunk = _splits(args)
    lens[1] = page * pages
    pt[1, (splits - 1) * chunk // page] = kp.shape[0]  # the last split's
    out, m, l_ = pops.paged_attention_partials(*args)
    torch.cuda.synchronize()
    for x in (out, m, l_):
        assert torch.isnan(x[1]).all() and not torch.isnan(x[0]).any()
        assert not torch.isnan(x[2:]).any()


GMM_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-5}


def _gmm_path(d, f, dtype):
    """The kernel K5 should take: TMA for rows of a 16-byte pitch (d and f
    multiples of 8 in bf16, of 4 in f32); else the async one of the
    dtype."""
    if dtype == torch.float32:
        return "f32" if d % 4 == 0 and f % 4 == 0 else "f32_async"
    return "tma" if d % 8 == 0 and f % 8 == 0 else "async"


def _gmm_case(rng, sizes, d, f, dtype, scale=None):
    scale = d ** -0.5 if scale is None else scale
    T, G = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(G, d, f)) * scale).astype(np.float32))
    return x.to(dtype), torch.tensor(sizes), w.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("sizes,d,f", [
    ([256] * 4, 2048, 1408),  # moonshot's gate/up widths: f = 11 x 128
    ([256] * 4, 1408, 2048),  # its down product: d = 1408
    ([128, 256, 128, 512], 256, 192),  # f = 192: a ragged column tile
    ([256, 256], 100, 37),  # d, f not multiples of 8: the async kernel
], ids=["moe_up", "moe_down", "f192", "odd"])
def test_k5_kernel_matches_plain(card, sizes, d, f, dtype):
    x, gs, w = _gmm_case(np.random.default_rng(d + f), sizes, d, f, dtype)
    want = gops.grouped_matmul(x, gs, w)
    x_, w_ = x.to(card), w.to(card)
    assert gkernel.kernel_path(x_, w_) == _gmm_path(d, f, dtype)
    before = gkernel.LAUNCHES["grouped_matmul"]
    got = gops.grouped_matmul(x_, gs.to(card), w_)
    torch.cuda.synchronize()
    assert gkernel.LAUNCHES["grouped_matmul"] == before + 1
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    tol = GMM_TOL[dtype]
    if dtype == torch.float32 and d > 512:
        exact = grouped_matmul_ref(x.double(), gs, w.double())
        bound = d ** 0.5 * 2.0**-24 * grouped_matmul_ref(
            x.double().abs(), gs, w.double().abs())
        for out in (got.cpu(), want):
            assert bool(((out.double() - exact).abs() <= bound).all())
    else:
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_k5_row_tiles_and_bad_groups(card):
    """The wrapper's row tiles are the source's; a group id outside [0, G)
    gives NaN rows instead of a read out of bounds."""
    lib = gkernel.build()
    assert lib.grouped_matmul_row_tile(0) == gkernel.ROW_TILE[torch.float32]
    assert lib.grouped_matmul_row_tile(1) == gkernel.ROW_TILE[torch.bfloat16]
    x, _, w = _gmm_case(np.random.default_rng(1), [128, 128], 64, 32,
                        torch.bfloat16)
    gid = torch.tensor([0, 2], dtype=torch.int32, device=card)
    out = gkernel.grouped_matmul_kernel(x.to(card), gid, w.to(card), 128)
    assert not torch.isnan(out[:128]).any() and torch.isnan(out[128:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,d,f,dtype", [
    ([256] * 4, 2048, 1408, torch.bfloat16),
    ([256] * 4, 1408, 2048, torch.bfloat16),
    ([256, 256], 100, 37, torch.bfloat16),
    ([128, 256, 128, 512], 256, 192, torch.float32),
], ids=["moe_up", "moe_down", "odd", "f32"])
def test_k5_tile_rows_match_plain(card, sizes, d, f, dtype):
    """Rows past each tile's count are taken as zero (x holds noise there)
    and come out +0; a tile with no real row and a group id out of range
    still comes out NaN; the other tiles equal the plain version."""
    x, gs, w = _gmm_case(np.random.default_rng(d * f), sizes, d, f, dtype)
    T, G, bt = x.shape[0], w.shape[0], 128
    gid = gops.tile_groups(gs, T, bt, G)
    pattern = [8, 0, 128, 65, 1, 64, 0, 127]
    rows = torch.tensor((pattern * 2)[: T // bt], dtype=torch.int32)
    want = gkernel.grouped_matmul_kernel(x, gid, w, bt, rows)
    bad = gid.clone()
    bad[1] = G  # tile 1 has no real row and no group
    x_, w_ = x.to(card), w.to(card)
    assert gkernel.kernel_path(x_, w_) == _gmm_path(d, f, dtype)
    got = gkernel.grouped_matmul_kernel(x_, bad.to(card), w_, bt,
                                        rows.to(card))
    torch.cuda.synchronize()
    got = got.cpu()
    assert torch.isnan(got[bt:2 * bt]).all()
    keep = torch.ones(T, dtype=torch.bool)
    keep[bt:2 * bt] = False
    tol = GMM_TOL[dtype]
    np.testing.assert_allclose(got[keep].float().numpy(),
                               want[keep].float().numpy(), rtol=tol, atol=tol)
    past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(T) & keep
    assert bool((got[past] == 0).all()) and not torch.signbit(got[past]).any()


@pytest.mark.cuda
def test_k5_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, _, w = [t.to(card) for t in _gmm_case(
        np.random.default_rng(2), [256, 256], 64, 32, torch.bfloat16)]
    gid = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=card)
    k = gkernel.grouped_matmul_kernel
    with pytest.raises(ValueError):
        k(x, gid[:2].repeat(4), w, 64)  # bt below the bf16 row tile
    with pytest.raises(ValueError):
        k(x[:500], gid, w, 128)  # T % bt
    with pytest.raises(ValueError):
        k(x, gid[:3], w, 128)  # tile_gid length
    with pytest.raises(ValueError):
        k(x, gid.long(), w, 128)  # tile_gid type
    with pytest.raises(ValueError):
        k(x, gid, w[:, :32], 128)  # d
    with pytest.raises(ValueError):
        k(x, gid, w.float(), 128)  # mixed dtypes
    with pytest.raises(ValueError):
        k(x.half(), gid, w.half(), 128)  # dtype
    with pytest.raises(ValueError):
        k(x, gid.cpu(), w, 128)  # device
    with pytest.raises(ValueError):
        k(x.t().contiguous().t(), gid, w, 128)  # layout
    rows = torch.full((4,), 128, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        k(x, gid, w, 128, rows.long())  # tile_rows type
    with pytest.raises(ValueError):
        k(x, gid, w, 128, rows[:3])  # tile_rows length
    with pytest.raises(ValueError):
        k(x, gid, w, 128, rows.cpu())  # tile_rows device
    with pytest.raises(ValueError):
        k(x, gid, w, 128, [128] * 4)  # not a tensor
    assert k(x, gid, w, 128, rows).shape == (512, 32)
    xf, wf = x.float(), w.float()
    with pytest.raises(ValueError):
        k(xf, torch.zeros(16, dtype=torch.int32, device=card), wf, 32)
    assert k(xf, torch.zeros(8, dtype=torch.int32, device=card), wf, 64).shape \
        == (512, 32)  # f32's 64-row tile takes bt = 64


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_moe_decode_on_card_matches_cpu(card, arch):
    """Four greedy decode steps of the MoE smoke config (f32) from the same
    weights: logits within 1e-4 and the same tokens on the card as on the
    CPU; every expert product went through K5, every attention through
    K4."""
    cfg = smoke_config(arch)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _tree_to(params, card)
    step = tmodels.decode_fn(cfg, 32)
    caches = {CPU: tmodels.make_cache(cfg, 8, 32, device=CPU),
              "cuda": tmodels.make_cache(cfg, 8, 32, device=card)}
    tok = torch.zeros((8, 1), dtype=torch.int32)
    g0, p0 = gkernel.LAUNCHES["grouped_matmul"], pkernel.LAUNCHES["paged_attention"]
    for _ in range(4):
        lc, caches[CPU] = step(params, tok, caches[CPU])
        lg, caches["cuda"] = step(on_card, tok.to(card), caches["cuda"])
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                                   atol=1e-4)
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(lg[:, -1].argmax(-1).cpu(), tok[:, 0].long())
    assert gkernel.LAUNCHES["grouped_matmul"] - g0 == 4 * 3 * cfg.n_layers
    assert pkernel.LAUNCHES["paged_attention"] - p0 == 4 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(4096, 14336), (14336, 4096)],
                         ids=["gate_up", "down"])
def test_k5_jamba_decode_call_matches_plain(card, d, f):
    """K5 at jamba's decode call: 8 tokens routed top-2 over 16 experts of
    C = 256 rows (``moe.expert_tiles``), d = 4096 and f = 14336, bf16 at
    the init scale; x is noise past each tile's real rows.  Held to the
    plain version on the card (the CPU's would take minutes at this
    size)."""
    _k5_decode_call_matches_plain(card, 16, d, f, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(6144, 16384), (16384, 6144)],
                         ids=["gate_up", "down"])
def test_k5_mixtral_decode_call_matches_plain(card, d, f):
    """K5 at mixtral-8x22b's decode call: 8 tokens top-2 over its 8
    experts of C = 256 rows, d = 6144 and f = 16384 (a weight stack of
    805 M elements, 1.61 GB), as at jamba's call."""
    _k5_decode_call_matches_plain(card, 8, d, f, seed=6)


def _k5_decode_call_matches_plain(card, E, d, f, seed):
    """8 tokens routed top-2 over E experts of C = 256 rows
    (``moe.expert_tiles``), bf16 at the init scale, x noise past each
    tile's real rows: K5 against its plain version on the card, the rows
    past the counts +0."""
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_tiles_ref
    from repro_torch.models import moe as tmoe

    C, bt = 256, tmoe.EXPERT_BT
    gen = torch.Generator(device=card).manual_seed(seed)
    top = torch.rand(8, E, device=card, generator=gen).argsort(dim=1)[:, :2]
    gid, rows = tmoe.expert_tiles(top, E, C, bt)
    x = torch.randn(E * C, d, device=card, generator=gen).to(torch.bfloat16)
    w = (torch.randn(E, d, f, device=card, generator=gen)
         * d ** -0.5).to(torch.bfloat16)
    assert gkernel.kernel_path(x, w) == "tma"
    before = gkernel.LAUNCHES["grouped_matmul"]
    got = gkernel.grouped_matmul_kernel(x, gid, w, bt, rows)
    torch.cuda.synchronize()
    assert gkernel.LAUNCHES["grouped_matmul"] == before + 1
    want = grouped_matmul_tiles_ref(x, gid, w, bt, rows)
    tol = GMM_TOL[torch.bfloat16]
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    past = (torch.arange(bt, device=card)[None, :] >= rows[:, None]).reshape(-1)
    assert bool((got[past] == 0).all()) and int(rows.sum()) == 16


def _close_to_max(got, want, tol):
    want = want.float()
    scale = float(want.abs().max()) or 1.0
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               rtol=tol, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,dtype,with_rows", [
    (192, 160, torch.bfloat16, True),
    (100, 37, torch.bfloat16, True),  # the async kernels
    (192, 160, torch.float32, True),
    (192, 160, torch.bfloat16, False),
], ids=["bf16", "bf16_odd", "f32", "bf16_dense"])
def test_k5_backward_matches_plain(card, d, f, dtype, with_rows):
    """K5's backward on the card: dX (K5 on the transposed weights) and dW
    (the dW kernel) against their plain versions on the CPU, at 4 groups
    of 256 rows with an empty group, a partly filled tile and noise past
    each tile's count; tolerances 1e-2 (bf16) and 1e-5 (f32) of the
    largest value.  The empty group's dW and the rows past the counts' dX
    are +0, and each backward launched one of each."""
    from repro_torch.kernels.grouped_matmul.ref import (
        grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
    )

    rng = np.random.default_rng(d + f)
    G, C, bt = 4, 256, 128
    x, _, w = _gmm_case(rng, [C] * G, d, f, dtype)
    dy = torch.from_numpy(rng.normal(size=(G * C, f)).astype(np.float32)
                          ).to(dtype)
    gid = torch.arange(G * C // bt, dtype=torch.int32) // (C // bt)
    rows = (torch.tensor([128, 128, 0, 0, 128, 77, 5, 0], dtype=torch.int32)
            if with_rows else None)
    want_dx = grouped_matmul_tiles_ref(dy, gid, w.transpose(1, 2).contiguous(),
                                       bt, rows)
    want_dw = grouped_matmul_dw_ref(x, dy, gid, G, bt, rows)
    x_ = x.to(card).requires_grad_()
    w_ = w.to(card).requires_grad_()
    before = dict(gkernel.LAUNCHES)
    y = gkernel.grouped_matmul_fn(x_, gid.to(card), w_, bt,
                                  None if rows is None else rows.to(card))
    y.backward(dy.to(card))
    torch.cuda.synchronize()
    for k in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"):
        assert gkernel.LAUNCHES[k] == before[k] + 1, k
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert x_.grad.dtype == w_.grad.dtype == dtype
    _close_to_max(x_.grad, want_dx, tol)
    _close_to_max(w_.grad, want_dw, tol)
    if rows is not None:
        assert bool((w_.grad[1] == 0).all())
        past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(-1)
        dx = x_.grad.cpu()[past]
        assert bool((dx == 0).all()) and not torch.signbit(dx).any()


# dW's ragged case: 4 groups of 4 tiles of 128 rows.  Counts that are not
# multiples of 16 or 64, group 1 with no real row, tile 13's id outside
# [0, G), and NaN in x and dy past tile 2's count (noise past the others').
DW_BT = 128
DW_ROWS = [1, 5, 63, 65, 0, 0, 0, 0, 77, 127, 128, 64, 128, 17, 32, 100]
DW_NAN_TILE = 2


def _dw_case(d, f, G=4, dtype=torch.bfloat16):
    rng = np.random.default_rng(d * f)
    T = len(DW_ROWS) * DW_BT
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(T, f)).astype(np.float32))
    rows = torch.tensor(DW_ROWS, dtype=torch.int32)
    past = (torch.arange(DW_BT)[None, :] >= rows[:, None]).reshape(T)
    nan = past.clone()
    nan[: DW_NAN_TILE * DW_BT] = False
    nan[(DW_NAN_TILE + 1) * DW_BT:] = False
    x[nan], dy[nan] = float("nan"), float("nan")
    gid = torch.arange(len(DW_ROWS), dtype=torch.int32) // (len(DW_ROWS) // G)
    gid[13] = G + 5
    return x.to(dtype), dy.to(dtype), gid, rows


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,path", [
    (192, 160, "tma"),  # d, f not multiples of 64 or 128
    (256, 176, "tma"),
    (2048, 1408, "tma"),  # moonshot's gate/up widths
    (100, 37, "async"),  # not multiples of 8: the async kernel
], ids=["192x160", "256x176", "moe", "odd"])
def test_k5_dw_kernel_masks_rows_past_the_counts(card, d, f, path):
    """The dW kernel against ``grouped_matmul_dw_ref`` (1e-2 of the largest
    value, bf16) with counts of 1, 5, 63, 65, 77 and 127 rows, noise past
    every count and NaN past one, an empty group and a tile id outside
    [0, G): the kernel ``dw_kernel_path`` names ran once, its output is
    finite, and the empty group's dW is +0 (no negative zero)."""
    x, dy, gid, rows = _dw_case(d, f)
    want = gkernel.grouped_matmul_dw_kernel(x, dy, gid, 4, DW_BT, rows)
    x_, dy_ = x.to(card), dy.to(card)
    assert gkernel.dw_kernel_path(x_, dy_) == path
    before = gkernel.LAUNCHES["grouped_matmul_dw"]
    got = gkernel.grouped_matmul_dw_kernel(x_, dy_, gid.to(card), 4, DW_BT,
                                           rows.to(card))
    torch.cuda.synchronize()
    assert gkernel.LAUNCHES["grouped_matmul_dw"] == before + 1
    got = got.cpu()
    assert bool(torch.isfinite(got).all())
    _close_to_max(got, want, 1e-2)
    assert bool((got[1] == 0).all()) and not torch.signbit(got[1]).any()
    assert (got[0] != 0).any() and (got[3] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k5_dw_same_bits_every_run(card, dtype):
    """dW sums each output element in one block in row order: two calls
    give the same bits (on the TMA kernel of the dtype)."""
    x, dy, gid, rows = [t.to(card) for t in _dw_case(256, 176, dtype=dtype)]
    assert gkernel.dw_kernel_path(x, dy) == _gmm_path(256, 176, dtype)
    a = gkernel.grouped_matmul_dw_kernel(x, dy, gid, 4, DW_BT, rows)
    b = gkernel.grouped_matmul_dw_kernel(x, dy, gid, 4, DW_BT, rows)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


# The f32 kernels against each other: 4 groups of 2 tiles of 128 rows,
# (d, f, each tile's real rows or None).  Group 1 (tiles 2, 3) has no real
# row, and tile 2's id lies outside [0, G) in the forward and dX.
F32_BITS_CASES = {
    "dense": (256, 192, None),
    "rows": (176, 200, [128, 77, 0, 0, 5, 128, 63, 65]),
    "moe_up": (2048, 1408, [128, 3, 0, 0, 128, 128, 64, 65]),
    "narrow": (100, 36, [1, 127, 0, 0, 33, 128, 8, 17]),
}


def _f32_twins(card, d, f, pattern, nbytes):
    """K5's float32 forward, dX and dW on the TMA-fed kernels and on the
    async ones, given copies of the same inputs whose bases lie ``nbytes``
    past 16 bytes: equal bit for bit (each output one fmaf chain in the
    same order), with and without tile_rows, at ragged d and f edges, with
    an empty group, noise past every count and NaN past tile 1's, and a
    bad group id (its tile NaN); each path launched its own kernel."""
    rng = np.random.default_rng(d + 7 * f)
    G, bt, T = 4, 128, 8 * 128
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(T, f)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(G, d, f)) * d ** -0.5)
                         .astype(np.float32))
    gid = torch.arange(T // bt, dtype=torch.int32) // 2
    rows = None
    if pattern is not None:
        rows = torch.tensor(pattern, dtype=torch.int32)
        past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(T)
        nan = past & (torch.arange(T) // bt == 1)
        x[nan], dy[nan] = float("nan"), float("nan")
        rows = rows.to(card)
    x, dy, w, gid = x.to(card), dy.to(card), w.to(card), gid.to(card)
    bad = gid.clone()
    bad[2] = G + 1
    xm, dym = misaligned(x, nbytes), misaligned(dy, nbytes)
    assert gkernel.copy_bytes(xm) == gkernel.copy_bytes(dym) == (
        8 if nbytes == 8 else 4)
    assert gkernel.kernel_path(x, w) == gkernel.kernel_path(dy, w) == "f32"
    assert gkernel.dw_kernel_path(x, dy) == "f32"
    assert gkernel.kernel_path(xm, w) == gkernel.dw_kernel_path(xm, dym) \
        == gkernel.kernel_path(dym, w) == "f32_async"
    before = dict(gkernel.KERNEL_LAUNCHES)
    y = gkernel.grouped_matmul_kernel(x, bad, w, bt, rows)
    y_elem = gkernel.grouped_matmul_kernel(xm, bad, w, bt, rows)
    dx = gkernel._k5(dy, bad, w, bt, rows, "grouped_matmul_dx",
                     w_transposed=True)
    dx_elem = gkernel._k5(dym, bad, w, bt, rows, "grouped_matmul_dx",
                          w_transposed=True)
    dw = gkernel.grouped_matmul_dw_kernel(x, dy, gid, G, bt, rows)
    dw_elem = gkernel.grouped_matmul_dw_kernel(xm, dym, gid, G, bt, rows)
    torch.cuda.synchronize()
    launched = {k: gkernel.KERNEL_LAUNCHES[k] - before[k] for k in before}
    assert launched == {**{k: 0 for k in before}, "gmm_f32_tma": 2,
                        "gmm_f32_async": 2, "gmm_dw_f32_tma": 1,
                        "gmm_dw_f32_async": 1}, launched
    assert same_bits(y, y_elem) and same_bits(dx, dx_elem)
    assert same_bits(dw, dw_elem)
    for out in (y, dx):
        assert bool(torch.isnan(out[2 * bt:3 * bt]).all())
    assert bool(torch.isfinite(dw).all())
    if pattern is not None:
        assert bool((dw[1] == 0).all()) and not torch.signbit(dw[1]).any()
    # the real rows against the plain version (the rule of
    # test_k5_kernel_matches_plain), the others +0
    keep = torch.ones(T, dtype=torch.bool)
    keep[2 * bt:3 * bt] = False
    real = keep.clone()
    if rows is not None:
        real &= (torch.arange(bt)[None, :] < rows.cpu()[:, None]).reshape(T)
    xc, wc, sizes = x.cpu().nan_to_num(), w.cpu(), torch.full((G,), 2 * bt)
    got = y.cpu()
    assert bool((got[keep & ~real] == 0).all())
    assert not torch.signbit(got[keep & ~real]).any()
    if d > 512:
        exact = grouped_matmul_ref(xc.double(), sizes, wc.double())[real]
        bound = d ** 0.5 * 2.0**-24 * grouped_matmul_ref(
            xc.double().abs(), sizes, wc.double().abs())[real]
        assert bool(((got[real].double() - exact).abs() <= bound).all())
    else:
        want = grouped_matmul_ref(xc, sizes, wc)[real]
        tol = GMM_TOL[torch.float32]
        np.testing.assert_allclose(got[real].numpy(), want.numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,pattern", list(F32_BITS_CASES.values()),
                         ids=list(F32_BITS_CASES))
def test_k5_f32_tma_equals_elem_bit_for_bit(card, d, f, pattern):
    """The f32 async kernels (the path TMA cannot describe) on copies of
    the inputs 4 bytes off give the TMA kernels' bits (``_f32_twins``)."""
    _f32_twins(card, d, f, pattern, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [8, 12])
@pytest.mark.parametrize("d,f,pattern", list(F32_BITS_CASES.values()),
                         ids=list(F32_BITS_CASES))
def test_k5_f32_async_equals_tma_bit_for_bit(card, d, f, pattern, nbytes):
    """The same on copies 8 bytes off (x and dy in 8-byte copies) and 12
    bytes off (4-byte copies)."""
    _f32_twins(card, d, f, pattern, nbytes)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,with_rows,bad_gid,dtype", [
    (176, 200, True, False, torch.bfloat16),  # ragged columns and depth
    (2048, 1408, True, False, torch.bfloat16),  # moonshot's dX of gate/up
    (1408, 2048, False, False, torch.bfloat16),
    (176, 200, True, True, torch.float32),
    (2048, 1408, True, False, torch.float32),
    # d, dX's output width, not a multiple of 4 (f32) or 8 (bf16): the
    # TMA kernels' 16-byte fills do not fit it, so the async kernel of the
    # dtype takes the call and reads w K-major in place
    (98, 36, True, True, torch.float32),
    (98, 40, True, True, torch.bfloat16),
], ids=["ragged", "moe_up", "moe_down_dense", "f32_ragged", "f32_moe_up",
        "f32_narrow", "narrow"])
def test_k5_dx_reads_w_transposed_bit_for_bit(card, d, f, with_rows,
                                              bad_gid, dtype):
    """K5's dX reads the forward's w (G, d, f) through its tensor map
    (K-major): equal bit for bit to K5 on a contiguous copy of w^T, on the
    TMA kernel of the dtype both times where TMA describes w^T too, with
    empty tiles and a bad group id (its tile NaN)."""
    rng = np.random.default_rng(d + 3 * f)
    G, bt = 4, 128
    w = torch.from_numpy((rng.normal(size=(G, d, f)) * d ** -0.5)
                         .astype(np.float32)).to(dtype).to(card)
    dy = torch.from_numpy(rng.normal(size=(G * 256, f)).astype(np.float32)
                          ).to(dtype).to(card)
    gid = (torch.arange(G * 256 // bt, dtype=torch.int32) // 2).to(card)
    if bad_gid:
        gid[1] = G + 1
    rows = (torch.tensor([128, 77, 0, 0, 5, 128, 63, 65], dtype=torch.int32)
            .to(card) if with_rows else None)
    wt = w.transpose(1, 2).contiguous()
    path, path_t = gkernel.kernel_path(dy, w), gkernel.kernel_path(dy, wt)
    assert path == _gmm_path(d, f, dtype)
    assert path_t == _gmm_path(f, d, dtype)
    before = dict(gkernel.KERNEL_LAUNCHES)
    got = gkernel._k5(dy, gid, w, bt, rows, "grouped_matmul_dx",
                      w_transposed=True)
    want = gkernel._k5(dy, gid, wt, bt, rows, "grouped_matmul_dx")
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in gkernel.KERNEL_LAUNCHES.items()
                if n != before[k]}
    kernels = [gkernel.KERNELS[path], gkernel.KERNELS[path_t]]
    assert launched == {k: kernels.count(k) for k in kernels}, launched
    assert got.shape == (G * 256, d)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    if bad_gid:
        assert bool(torch.isnan(got[bt:2 * bt]).all())


# K5's bf16 async instances at each copy tier: (d, f) and the widths
# ``copy_bytes`` gives x, w and y (dX reads dy (T, f), w and writes (T, d)).
ASYNC_CASES = {
    "f1020": (1024, 1020),  # w and y 8 bytes, x 16 (phase 7's (b elem))
    "f1021": (1024, 1021),  # w and y 2 bytes (plain loads and stores)
    "d1020": (1020, 1024),  # x 8 bytes; dX's output 1020 wide
    "d1022": (1022, 200),  # x 4 bytes
    "odd": (100, 37),  # 8 and 2 bytes, ragged boxes everywhere
}


def _async_case(d, f, seed, dtype=torch.bfloat16):
    """4 groups of 2 tiles of 128 rows: tile 2's group has no real row,
    counts that cut 16-row steps, NaN in x and dy past tile 1's count and
    noise past the others'; x, dy and w in ``dtype``."""
    rng = np.random.default_rng(seed)
    G, bt, T = 4, 128, 8 * 128
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(T, f)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(G, d, f)) * d ** -0.5)
                         .astype(np.float32))
    rows = torch.tensor([128, 77, 0, 0, 5, 128, 63, 65], dtype=torch.int32)
    past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(T)
    nan = past & (torch.arange(T) // bt == 1)
    x[nan], dy[nan] = float("nan"), float("nan")
    gid = torch.arange(T // bt, dtype=torch.int32) // 2
    return x.to(dtype), dy.to(dtype), w.to(dtype), gid, rows


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", list(ASYNC_CASES.values()),
                         ids=list(ASYNC_CASES))
def test_k5_async_matches_plain(card, d, f):
    """The bf16 async instances (the path TMA cannot describe) against the
    plain versions: forward and dX at the reference's 5e-2, dW at 1e-2 of
    the largest value, rows past the counts +0, a bad group id's tile NaN
    (forward and dX), the empty group's dW +0; each launched once, dX on
    w as it is.  Two calls give the same bits."""
    from repro_torch.kernels.grouped_matmul.ref import (
        grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
    )

    x, dy, w, gid, rows = _async_case(d, f, d + f)
    G, bt, T = w.shape[0], 128, x.shape[0]
    bad = gid.clone()
    bad[2] = G + 1
    x_, dy_, w_ = x.to(card), dy.to(card), w.to(card)
    bad_, gid_, rows_ = bad.to(card), gid.to(card), rows.to(card)
    assert gkernel.kernel_path(x_, w_) == gkernel.kernel_path(dy_, w_) \
        == gkernel.dw_kernel_path(x_, dy_) == "async"
    before = dict(gkernel.KERNEL_LAUNCHES)

    def run():
        return (gkernel.grouped_matmul_kernel(x_, bad_, w_, bt, rows_),
                gkernel._k5(dy_, bad_, w_, bt, rows_, "grouped_matmul_dx",
                            w_transposed=True),
                gkernel.grouped_matmul_dw_kernel(x_, dy_, gid_, G, bt,
                                                 rows_))

    y, dx, dw = run()
    again = run()
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in gkernel.KERNEL_LAUNCHES.items()
                if n != before[k]}
    assert launched == {"gmm_bf16_async": 4, "gmm_dw_bf16_async": 2}
    for a, b in zip((y, dx, dw), again):
        assert same_bits(a, b)
    keep = torch.ones(T, dtype=torch.bool)
    keep[2 * bt:3 * bt] = False
    for out in (y, dx):
        assert bool(torch.isnan(out[2 * bt:3 * bt]).all())
    xc = x.nan_to_num()
    want_y = grouped_matmul_tiles_ref(xc, gid, w, bt, rows)
    want_dx = grouped_matmul_tiles_ref(dy.nan_to_num(), gid,
                                       w.transpose(1, 2).contiguous(), bt,
                                       rows)
    tol = GMM_TOL[torch.bfloat16]
    for got, want in ((y, want_y), (dx, want_dx)):
        got = got.cpu()[keep]
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.float().numpy(),
                                   want[keep].float().numpy(), rtol=tol,
                                   atol=tol)
        past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(T)[keep]
        assert bool((got[past] == 0).all()) and not torch.signbit(
            got[past]).any()
    want_dw = grouped_matmul_dw_ref(x, dy, gid, G, bt, rows)
    assert bool(torch.isfinite(dw).all())
    _close_to_max(dw, want_dw, 1e-2)
    dw = dw.cpu()
    assert bool((dw[1] == 0).all()) and not torch.signbit(dw[1]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [8, 4, 2])
def test_k5_async_equals_tma_bit_for_bit(card, nbytes):
    """On copies of aligned inputs whose bases lie ``nbytes`` past 16
    bytes, the async instances run the TMA instances' consumers on the
    same bytes: forward, dX and dW equal the TMA kernels' bit for bit,
    with counts, NaN past one, an empty group and a bad group id."""
    d, f = 256, 192
    x, dy, w, gid, rows = [t.to(card) for t in _async_case(d, f, 11)]
    G, bt = w.shape[0], 128
    bad = gid.clone()
    bad[2] = G + 1
    xm, dym = misaligned(x, nbytes), misaligned(dy, nbytes)
    assert gkernel.copy_bytes(xm) == gkernel.copy_bytes(dym) == nbytes
    assert gkernel.kernel_path(x, w) == gkernel.dw_kernel_path(x, dy) == "tma"
    assert gkernel.kernel_path(xm, w) == gkernel.dw_kernel_path(xm, dym) \
        == gkernel.kernel_path(dym, w) == "async"
    before = dict(gkernel.KERNEL_LAUNCHES)
    pairs = [
        (gkernel.grouped_matmul_kernel(x, bad, w, bt, rows),
         gkernel.grouped_matmul_kernel(xm, bad, w, bt, rows)),
        (gkernel._k5(dy, bad, w, bt, rows, "grouped_matmul_dx",
                     w_transposed=True),
         gkernel._k5(dym, bad, w, bt, rows, "grouped_matmul_dx",
                     w_transposed=True)),
        (gkernel.grouped_matmul_dw_kernel(x, dy, gid, G, bt, rows),
         gkernel.grouped_matmul_dw_kernel(xm, dym, gid, G, bt, rows)),
    ]
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in gkernel.KERNEL_LAUNCHES.items()
                if n != before[k]}
    assert launched == {"gmm_bf16_tma": 2, "gmm_bf16_async": 2,
                        "gmm_dw_bf16_tma": 1, "gmm_dw_bf16_async": 1}
    for tma, asy in pairs:
        assert same_bits(tma, asy)
    assert bool(torch.isfinite(pairs[2][0]).all())


@pytest.mark.cuda
def test_k5_async_dw_walks_f_tiles_as_tma(card):
    """The async dW takes as many f-tiles a block as the grid allows (one
    at the shapes above); at 64 groups x 2 d-tiles x 5 f-tiles a block
    walks several.  On copies of the operands 8 bytes off it still gives
    the TMA kernel's bits, with counts, an empty group and a bad id."""
    rng = np.random.default_rng(13)
    G, bt, d, f = 64, 128, 256, 1280
    T = G * bt
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32)).to(
        torch.bfloat16).to(card)
    dy = torch.from_numpy(rng.normal(size=(T, f)).astype(np.float32)).to(
        torch.bfloat16).to(card)
    gid = torch.arange(G, dtype=torch.int32)
    gid[5] = G + 3  # no group
    gid[9] = 8  # group 9 has no tile, group 8 two
    rows = torch.from_numpy(rng.integers(0, bt + 1, size=G).astype(np.int32))
    gid, rows = gid.to(card), rows.to(card)
    xm, dym = misaligned(x, 8), misaligned(dy, 8)
    assert gkernel.dw_kernel_path(xm, dym) == "async"
    want = gkernel.grouped_matmul_dw_kernel(x, dy, gid, G, bt, rows)
    got = gkernel.grouped_matmul_dw_kernel(xm, dym, gid, G, bt, rows)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    assert bool((got[9] == 0).all()) and bool((got[5] == 0).all())


@pytest.mark.cuda
def test_k5_async_dx_allocates_no_transposed_weights(card):
    """dX at an output width of 1020 (dy (T, 1024) against w (G, 1020,
    1024)) takes the async instance and reads w K-major in place: the
    call's peak memory holds its output, not a copy of w^T."""
    d, f = 1020, 1024
    _, dy, w, gid, rows = [t.to(card) for t in _async_case(d, f, 12)]
    assert gkernel.kernel_path(dy, w) == "async"
    gkernel._k5(dy, gid, w, 128, rows, "grouped_matmul_dx",
                w_transposed=True)
    torch.cuda.synchronize()
    before = gkernel.KERNEL_LAUNCHES["gmm_bf16_async"]
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    dx = gkernel._k5(dy, gid, w, 128, rows, "grouped_matmul_dx",
                     w_transposed=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert gkernel.KERNEL_LAUNCHES["gmm_bf16_async"] == before + 1
    out_bytes = dx.numel() * dx.element_size()
    assert out_bytes <= peak < out_bytes + w.numel() * w.element_size() // 2


# K5's f32 async kernels at widths TMA cannot describe: (d, f) and the
# widths ``copy_bytes`` gives x, w and y (dX reads dy (T, f), w K-major and
# writes (T, d); dW reads x and dy and writes (G, d, f)).
F32_ASYNC_CASES = {
    "f1022": (1024, 1022),  # w, y, dy and dw 8 bytes, x 16
    "f1021": (1024, 1021),  # w, y, dy and dw 4 bytes; dX's depth odd
    "d_odd": (1021, 256),  # x and w read K-major 4 bytes; dX's output 1021
    "odd": (98, 37),  # 8 and 4 bytes, ragged boxes everywhere
}


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", list(F32_ASYNC_CASES.values()),
                         ids=list(F32_ASYNC_CASES))
def test_k5_f32_async_matches_plain(card, d, f):
    """The f32 async kernels (the path TMA cannot describe) against the
    plain versions at 1e-5 of the largest value (the backward's rule: the
    sums run over up to 1024 terms in another order), with counts that cut
    the tiles, NaN past one and noise past the others, an empty group and
    a bad group id (its tile NaN in the forward and dX): each launched its
    kernel, dX on w as it is; the rows past the counts and the empty
    group's dW are +0."""
    from repro_torch.kernels.grouped_matmul.ref import (
        grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
    )

    x, dy, w, gid, rows = _async_case(d, f, d + 3 * f, torch.float32)
    G, bt, T = w.shape[0], 128, x.shape[0]
    bad = gid.clone()
    bad[2] = G + 1
    x_, dy_, w_ = x.to(card), dy.to(card), w.to(card)
    bad_, gid_, rows_ = bad.to(card), gid.to(card), rows.to(card)
    assert gkernel.kernel_path(x_, w_) == gkernel.kernel_path(dy_, w_) \
        == gkernel.dw_kernel_path(x_, dy_) == "f32_async"
    before = dict(gkernel.KERNEL_LAUNCHES)
    y = gkernel.grouped_matmul_kernel(x_, bad_, w_, bt, rows_)
    dx = gkernel._k5(dy_, bad_, w_, bt, rows_, "grouped_matmul_dx",
                     w_transposed=True)
    dw = gkernel.grouped_matmul_dw_kernel(x_, dy_, gid_, G, bt, rows_)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in gkernel.KERNEL_LAUNCHES.items()
                if n != before[k]}
    assert launched == {"gmm_f32_async": 2, "gmm_dw_f32_async": 1}
    keep = torch.ones(T, dtype=torch.bool)
    keep[2 * bt:3 * bt] = False
    for out in (y, dx):
        assert bool(torch.isnan(out[2 * bt:3 * bt]).all())
    want_y = grouped_matmul_tiles_ref(x.nan_to_num(), gid, w, bt, rows)
    want_dx = grouped_matmul_tiles_ref(dy.nan_to_num(), gid,
                                       w.transpose(1, 2).contiguous(), bt,
                                       rows)
    past = (torch.arange(bt)[None, :] >= rows[:, None]).reshape(T)[keep]
    for got, want in ((y, want_y), (dx, want_dx)):
        got = got.cpu()[keep]
        assert bool(torch.isfinite(got).all())
        _close_to_max(got, want[keep], 1e-5)
        assert bool((got[past] == 0).all()) and not torch.signbit(
            got[past]).any()
    want_dw = grouped_matmul_dw_ref(x, dy, gid, G, bt, rows)
    assert bool(torch.isfinite(dw).all())
    _close_to_max(dw, want_dw, 1e-5)
    dw = dw.cpu()
    assert bool((dw[1] == 0).all()) and not torch.signbit(dw[1]).any()


@pytest.mark.cuda
def test_k5_f32_async_dw_walks_f_tiles_as_tma(card):
    """The f32 dW's blocks walk several f-tiles where the grid is large (64
    groups x 4 d-tiles x 10 f-tiles); on copies of x and dy 8 bytes off the
    async kernel still gives the TMA kernel's bits, with counts, an empty
    group and a bad id."""
    rng = np.random.default_rng(14)
    G, bt, d, f = 64, 128, 256, 1280
    T = G * bt
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.normal(size=(T, f)).astype(np.float32)).to(card)
    gid = torch.arange(G, dtype=torch.int32)
    gid[5] = G + 3  # no group
    gid[9] = 8  # group 9 has no tile, group 8 two
    rows = torch.from_numpy(rng.integers(0, bt + 1, size=G).astype(np.int32))
    gid, rows = gid.to(card), rows.to(card)
    xm, dym = misaligned(x, 8), misaligned(dy, 8)
    assert gkernel.dw_kernel_path(x, dy) == "f32"
    assert gkernel.dw_kernel_path(xm, dym) == "f32_async"
    want = gkernel.grouped_matmul_dw_kernel(x, dy, gid, G, bt, rows)
    got = gkernel.grouped_matmul_dw_kernel(xm, dym, gid, G, bt, rows)
    torch.cuda.synchronize()
    assert same_bits(got, want)
    assert bool((got[9] == 0).all()) and bool((got[5] == 0).all())


@pytest.mark.cuda
def test_k5_f32_async_dx_allocates_no_transposed_weights(card):
    """f32 dX at an output width of 1022 (dy (T, 1024) against w (G, 1022,
    1024)) takes the async instance and reads w K-major in place: the
    call's peak memory holds its output, not a copy of w^T."""
    d, f = 1022, 1024
    _, dy, w, gid, rows = [t.to(card) for t in _async_case(d, f, 12,
                                                            torch.float32)]
    assert gkernel.kernel_path(dy, w) == "f32_async"
    gkernel._k5(dy, gid, w, 128, rows, "grouped_matmul_dx",
                w_transposed=True)
    torch.cuda.synchronize()
    before = gkernel.KERNEL_LAUNCHES["gmm_f32_async"]
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    dx = gkernel._k5(dy, gid, w, 128, rows, "grouped_matmul_dx",
                     w_transposed=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert gkernel.KERNEL_LAUNCHES["gmm_f32_async"] == before + 1
    out_bytes = dx.numel() * dx.element_size()
    assert out_bytes <= peak < out_bytes + w.numel() * w.element_size() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,f", [(torch.bfloat16, 256, 192),
                                       (torch.float32, 256, 192),
                                       (torch.float32, 98, 190)],
                         ids=["bf16", "f32", "f32_async"])
def test_k5_backward_copies_nothing(card, dtype, d, f):
    """One ``grouped_matmul_fn`` backward at TMA shapes (bf16 and f32), and
    at f32 widths TMA cannot describe (the async kernels), runs K5's dX
    and the dW kernel and no device-to-device copy (torch.profiler's
    device events): w^T is read K-major as w lies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, _, w = _gmm_case(np.random.default_rng(4), [256] * 4, d, f, dtype)
    assert gkernel.kernel_path(x.to(card), w.to(card)) == _gmm_path(d, f,
                                                                    dtype)
    x_ = x.to(card).requires_grad_()
    w_ = w.to(card).requires_grad_()
    gid = (torch.arange(8, dtype=torch.int32) // 2).to(card)
    rows = torch.tensor([128, 77, 0, 0, 5, 128, 63, 65], dtype=torch.int32,
                        device=card)
    y = gkernel.grouped_matmul_fn(x_, gid, w_, 128, rows)
    dy = torch.randn(y.shape, device=card).to(dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dx, dw = torch.autograd.grad(y, (x_, w_), dy)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("gmm_" in n for n in names) == 2, names
    assert not [n for n in names if "copy" in n.lower()
                or "memcpy" in n.lower()], names
    assert dx.shape == x.shape and dw.shape == w.shape


@pytest.mark.cuda
def test_k5_raw_kernel_refuses_grad(card):
    """The raw wrapper has no backward: with grad mode on and an input that
    requires grad it raises instead of returning a detached output."""
    x, _, w = _gmm_case(np.random.default_rng(3), [128, 128], 64, 32,
                        torch.bfloat16)
    gid = torch.tensor([0, 1], dtype=torch.int32, device=card)
    w_ = w.to(card).requires_grad_()
    with pytest.raises(RuntimeError, match="grouped_matmul_fn"):
        gkernel.grouped_matmul_kernel(x.to(card), gid, w_, 128)
    with torch.no_grad():
        assert gkernel.grouped_matmul_kernel(x.to(card), gid, w_, 128).shape \
            == (256, 32)


@pytest.mark.cuda
def test_moe_layer_backward_on_card_matches_cpu(card):
    """One MoE layer of the moonshot smoke config (f32), the sum of its
    output times a fixed cotangent plus its aux loss: the loss and the
    gradients of every weight and of the input on the card equal the
    CPU's within 1e-4 of each leaf's largest value; the card ran 3
    forward, 3 dX and 3 dW launches."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import ParamFactory

    cfg = smoke_config("moonshot-v1-16b-a3b")
    p = tmoe.init_moe(cfg, ParamFactory(torch.Generator().manual_seed(8),
                                        torch.float32))
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 64, cfg.d_model, generator=gen)
    r = torch.randn(4, 64, cfg.d_model, generator=gen)
    grads = {}
    for dev in (CPU, card):
        pd = {k: v.detach().to(dev, copy=True).requires_grad_()
              for k, v in p.items()}
        xd = x.to(dev, copy=True).requires_grad_()
        before = dict(gkernel.LAUNCHES)
        y, aux = tmoe.moe_apply_with_aux(cfg, pd, xd)
        loss = torch.sum(y * r.to(dev)) + aux
        loss.backward()
        grads[str(dev)] = (float(loss.detach()), {k: v.grad.cpu()
                                                  for k, v in pd.items()},
                           xd.grad.cpu())
        if dev == card:
            torch.cuda.synchronize()
            for k in ("grouped_matmul", "grouped_matmul_dx",
                      "grouped_matmul_dw"):
                assert gkernel.LAUNCHES[k] - before[k] == 3, k
    (lc, gc, xc), (lg, gg, xg) = grads[CPU], grads[str(card)]
    assert lg == pytest.approx(lc, rel=1e-5)
    for k in gc:
        _close_to_max(gg[k], gc[k], 1e-4)
        assert bool((gg[k] != 0).any())
    _close_to_max(xg, xc, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_zoo_decode_on_card_matches_cpu(card, arch):
    """Four greedy decode steps of each family the zoo adds (its smoke
    config, f32; the encoder-decoder after ``prefill_cross_kv`` filled the
    cross K/V) from the same weights: logits within 1e-4 and the same
    tokens on the card as on the CPU; K4 once an attention layer (twice an
    encoder-decoder layer) a step, K5 three times an MoE layer a step."""
    from repro_torch.models import encdec as tencdec

    cfg = smoke_config(arch)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _tree_to(params, card)
    step = tmodels.decode_fn(cfg, 32)
    caches = {CPU: tmodels.make_cache(cfg, 8, 32, device=CPU, enc_len=12),
              "cuda": tmodels.make_cache(cfg, 8, 32, device=card, enc_len=12)}
    if cfg.family == "encdec":
        frames = torch.randn(8, 12, cfg.d_model,
                             generator=torch.Generator().manual_seed(1))
        for key, p, dev in ((CPU, params, CPU), ("cuda", on_card, card)):
            _, ck, cv = tencdec.prefill_cross_kv(cfg, p, frames.to(dev))
            caches[key]["cross_k"].copy_(ck)
            caches[key]["cross_v"].copy_(cv)
    attn = sum(cfg.uses_attention(i) for i in range(cfg.n_layers))
    attn *= 2 if cfg.family == "encdec" else 1
    moe = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    tok = torch.zeros((8, 1), dtype=torch.int32)
    g0, p0 = gkernel.LAUNCHES["grouped_matmul"], pkernel.LAUNCHES["paged_attention"]
    for _ in range(4):
        lc, caches[CPU] = step(params, tok, caches[CPU])
        lg, caches["cuda"] = step(on_card, tok.to(card), caches["cuda"])
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                                   atol=1e-4)
        tok = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(lg[:, -1].argmax(-1).cpu(), tok[:, 0].long())
    assert gkernel.LAUNCHES["grouped_matmul"] - g0 == 4 * 3 * moe
    assert pkernel.LAUNCHES["paged_attention"] - p0 == 4 * attn
    for k in caches[CPU]:
        if k != "pos":
            np.testing.assert_allclose(caches["cuda"][k].cpu().numpy(),
                                       caches[CPU][k].numpy(), rtol=1e-4,
                                       atol=1e-4)
