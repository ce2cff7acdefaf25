"""The port's cross-match joins held against the JAX reference.

The same numpy inputs, made from a seed, go through ``repro``'s ops (the
jnp path, and at small sizes the Pallas kernels in interpret mode) and
through ``repro_torch``'s ops on the CPU (the plain PyTorch versions the
CUDA kernels are held to on the card), under the join contract of
``test_torch_kernels_cuda.assert_join_close``.
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
from test_torch_kernels_cuda import _np, assert_join_close  # noqa: E402

CPU = "cpu"


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ K1
class TestCrossmatch:
    @pytest.mark.parametrize("n,m", [(256, 128), (700, 300), (1024, 1), (33, 513)])
    @pytest.mark.parametrize("radius", [0.01, 0.1])
    def test_matches_reference(self, n, m, radius):
        bkt, prb = _unit(n, 1), _unit(m, 2)
        thr = float(np.cos(radius))
        want = jops.crossmatch(bkt, prb, thr, use_pallas=False)
        got = tops.crossmatch(bkt, prb, thr, device=CPU)
        assert all(x.device.type == "cpu" for x in got)
        assert_join_close(got, want, bkt, prb, thr)

    @pytest.mark.parametrize("n,m", [(256, 128), (33, 60)])
    def test_matches_pallas_interpret(self, n, m):
        bkt, prb = _unit(n, 3), _unit(m, 4)
        thr = float(np.cos(0.05))
        want = jops.crossmatch(bkt, prb, thr, use_pallas=True, bm=128, bn=256)
        got = tops.crossmatch(bkt, prb, thr, device=CPU, bm=128, bn=256)
        assert_join_close(got, want, bkt, prb, thr)

    @pytest.mark.parametrize("bm,bn", [(128, 256), (128, 512), (256, 128)])
    def test_block_shape_sweep(self, bm, bn):
        bkt, prb = _unit(500, 3), _unit(200, 4)
        thr = float(np.cos(0.05))
        want = jops.crossmatch(bkt, prb, thr, use_pallas=False)
        got = tops.crossmatch(bkt, prb, thr, device=CPU, bm=bm, bn=bn)
        assert_join_close(got, want, bkt, prb, thr)

    def test_self_match(self):
        pts = _unit(300, 5)
        thr = float(np.cos(0.01))
        _, d, c = _np(tops.crossmatch(pts, pts, thr, device=CPU))
        assert (c >= 1).all()
        np.testing.assert_allclose(d, 1.0, atol=1e-5)
        assert_join_close(
            tops.crossmatch(pts, pts, thr, device=CPU),
            jops.crossmatch(pts, pts, thr, use_pallas=False), pts, pts, thr,
        )

    @pytest.mark.parametrize("band", [0, 1])
    def test_banded_matches_pallas_band(self, band):
        """The band skip is the Pallas kernel's, tile for tile: the same
        pairs take part, so counts agree exactly with interpret mode."""
        pts = _unit(1024, 6)
        pts = pts[np.argsort(htm_id(pts, level=8), kind="stable")]
        thr = float(np.cos(0.01))
        kw = dict(bm=128, bn=128, band=band)
        want = jops.crossmatch(pts, pts, thr, use_pallas=True, **kw)
        got = tops.crossmatch(pts, pts, thr, device=CPU, **kw)
        assert_join_close(got, want, pts, pts, thr)
        full = _np(tops.crossmatch(pts, pts, thr, device=CPU, bm=128, bn=128))
        _, bd, bc = _np(got)
        np.testing.assert_allclose(bd, 1.0, atol=1e-5)  # self-match survives
        assert (bc >= 1).all() and (bc <= full[2]).all()

    @pytest.mark.parametrize("n,m", [(1, 1), (7, 400), (399, 9), (129, 257), (400, 400)])
    def test_any_shape(self, n, m):
        bkt, prb = _unit(n, n), _unit(m, m + 1)
        thr = float(np.cos(0.05))
        want = jops.crossmatch(bkt, prb, thr, use_pallas=False)
        assert_join_close(
            tops.crossmatch(bkt, prb, thr, device=CPU), want, bkt, prb, thr
        )

    @pytest.mark.parametrize("n,m", [(33, 100), (64, 8), (200, 1000), (1000, 4096), (5000, 300)])
    def test_dots_bit_identical_to_jnp(self, n, m):
        """From a padded bucket of 64 rows up, jnp.dot on the CPU takes the
        fused multiply-add chain in column order, as the port does: the
        joins then agree bit for bit, not just within the contract."""
        rng = np.random.default_rng(n * m)
        bkt = _unit(n, n)
        near = bkt[rng.integers(0, n, m)] + rng.normal(scale=2e-3, size=(m, 3))
        prb = (near / np.linalg.norm(near, axis=1, keepdims=True)).astype(np.float32)
        thr = float(np.cos(2e-3))
        gi, gd, gc = _np(tops.crossmatch(bkt, prb, thr, device=CPU))
        wi, wd, wc = _np(jops.crossmatch(bkt, prb, thr, use_pallas=False))
        np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)

    @pytest.mark.parametrize("radius", [1.7, 2.0, 3.0])
    def test_padded_rows_not_counted_at_large_radius(self, radius):
        """cos_thr <= 0: padded rows (marker dot -2) must not be counted."""
        bkt, prb = _unit(700, 7), _unit(300, 8)
        thr = float(np.cos(radius))
        assert thr <= 0.0
        want = jops.crossmatch(bkt, prb, thr, use_pallas=False)
        got = tops.crossmatch(bkt, prb, thr, device=CPU, bm=128, bn=256)
        assert_join_close(got, want, bkt, prb, thr)
        assert (np.asarray(got[2]) <= 700).all()

    def test_wrapper_runs_plain_version_on_cpu_without_counting(self):
        bkt, prb = _unit(64, 9), _unit(16, 10)
        before = dict(tkernel.LAUNCHES)
        b8, p8, _, _ = tops._host_prepare(bkt, prb, 8, 8)
        got = tkernel.crossmatch_kernel(
            torch.from_numpy(b8), torch.from_numpy(p8), 0.99, bm=8, bn=8
        )
        want = tref.crossmatch_ref(torch.from_numpy(b8), torch.from_numpy(p8), 0.99)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert tkernel.LAUNCHES == before


# ------------------------------------------------------------------ K2
def _segments(sizes_b, sizes_p, seed=0):
    bkts = [_unit(n, seed + 10 + i) for i, n in enumerate(sizes_b)]
    prbs = [_unit(m, seed + 50 + i) for i, m in enumerate(sizes_p)]
    B, P = np.concatenate(bkts), np.concatenate(prbs)
    bseg = np.repeat(np.arange(len(sizes_b)), sizes_b)
    pseg = np.repeat(np.arange(len(sizes_p)), sizes_p)
    return B, P, bseg, pseg


class TestCrossmatchFused:
    @pytest.mark.parametrize("radius", [0.05, 0.5])
    @pytest.mark.parametrize("pallas", [False, True])
    def test_matches_reference(self, radius, pallas):
        B, P, bseg, pseg = _segments([100, 100, 57], [40, 1, 130])
        thr = float(np.cos(radius))
        want = jops.crossmatch_fused(
            B, P, bseg, pseg, thr, use_pallas=pallas, bm=128, bn=128
        )
        got = tops.crossmatch_fused(B, P, bseg, pseg, thr, device=CPU, bm=128, bn=128)
        assert_join_close(got, want, B, P, thr, bseg, pseg)

    def test_probe_segment_without_bucket_rows(self):
        B, P = _unit(64, 1), _unit(10, 2)
        bseg, pseg = np.zeros(64, np.int32), np.full(10, 3, np.int32)
        thr = float(np.cos(3.0))
        got = tops.crossmatch_fused(B, P, bseg, pseg, thr, device=CPU)
        want = jops.crossmatch_fused(B, P, bseg, pseg, thr, use_pallas=False)
        assert_join_close(got, want, B, P, thr, bseg, pseg)
        _, d, c = _np(got)
        assert (c == 0).all() and (d <= -1.5).all()

    def test_empty_middle_segment(self):
        """Segment 1 has probes but no bucket rows; its neighbours match."""
        B, P, bseg, pseg = _segments([80, 0, 90], [30, 20, 40], seed=3)
        thr = float(np.cos(0.5))
        got = tops.crossmatch_fused(B, P, bseg, pseg, thr, device=CPU)
        want = jops.crossmatch_fused(B, P, bseg, pseg, thr, use_pallas=False)
        assert_join_close(got, want, B, P, thr, bseg, pseg)
        assert (np.asarray(got[2])[30:50] == 0).all()

    def test_unsorted_bucket_segments_are_refused(self):
        B, P = _unit(16, 1), _unit(4, 2)
        with pytest.raises(ValueError, match="sorted"):
            tops.crossmatch_fused(
                B, P, np.array([1] * 8 + [0] * 8), np.zeros(4), 0.9, device=CPU
            )

    def test_probes_in_any_segment_order(self):
        B, P, bseg, pseg = _segments([60, 70, 50], [30, 20, 40], seed=5)
        order = np.random.default_rng(0).permutation(len(P))
        thr = float(np.cos(0.5))
        got = tops.crossmatch_fused(B, P[order], bseg, pseg[order], thr, device=CPU)
        want = jops.crossmatch_fused(B, P[order], bseg, pseg[order], thr,
                                     use_pallas=False)
        assert_join_close(got, want, B, P[order], thr, bseg, pseg[order])


# ------------------------------------------------------------------ K3
def _unit_rows(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _shared_case(seed, n_buckets, n_queries, rows_hi, n_empty):
    """The reference suite's shared-plan layout (test_sharedplan.py)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 30)) for _ in range(n_buckets + n_empty)]
    payloads = [_unit_rows(rng, s) for s in sizes]
    row_off = np.cumsum([0] + sizes[:-1])
    bucket_cat = np.concatenate(payloads)
    bseg = np.concatenate([np.full(s, i, np.int64) for i, s in enumerate(sizes)])
    queries = []
    for _ in range(n_queries):
        b = int(rng.integers(0, n_buckets))
        m = int(rng.integers(1, rows_hi + 1))
        base = payloads[b][rng.integers(0, sizes[b], m)]
        probes = base + rng.normal(scale=2e-3, size=(m, 3))
        probes /= np.linalg.norm(probes, axis=1, keepdims=True)
        thr = float(rng.choice([0.95, 0.999, 0.999998]))
        queries.append((b, probes, thr))
    probes_cat = np.concatenate([p for _, p, _ in queries])
    pseg = np.concatenate([np.full(len(p), b, np.int64) for b, p, _ in queries])
    thr_row = np.concatenate([np.full(len(p), t, np.float32) for _, p, t in queries])
    return bucket_cat, bseg, row_off, payloads, queries, probes_cat, pseg, thr_row


SHARED_CASES = [(1, 1, 1, 0), (2, 3, 5, 1), (3, 4, 12, 1), (4, 6, 20, 2), (2, 6, 17, 0)]


class TestCrossmatchShared:
    @pytest.mark.parametrize("shape", SHARED_CASES)
    def test_matches_reference(self, shape):
        seed = 100_000 * shape[0] + 10_000 * shape[1] + 13 * shape[2] + shape[3]
        bucket_cat, bseg, _, _, _, probes_cat, pseg, thr_row = _shared_case(
            seed, *shape
        )
        got = tops.crossmatch_shared(
            bucket_cat, probes_cat, bseg, pseg, thr_row, device=CPU
        )
        # interpret=False is ignored by the jnp path but keys its own jit
        # cache entries: test_sharedplan counts the entries one shape pair
        # adds, and may share this worker process.
        for kw in (dict(use_pallas=False, interpret=False),
                   dict(use_pallas=True, bm=8, bn=8, interpret=True)):
            want = jops.crossmatch_shared(
                bucket_cat, probes_cat, bseg, pseg, thr_row, **kw
            )
            assert_join_close(got, want, bucket_cat, probes_cat, thr_row, bseg, pseg)

    @pytest.mark.parametrize("shape", SHARED_CASES)
    def test_shared_equals_per_query_loop_bit_for_bit(self, shape):
        """One shared call == the per-query K1 loop, bit for bit: both
        take their dots in the same order (the reference's own two paths
        differ here by 1 ulp)."""
        seed = 7 + sum(shape)
        bucket_cat, bseg, row_off, payloads, queries, probes_cat, pseg, thr_row = (
            _shared_case(seed, *shape)
        )
        s_idx, s_dot, s_cnt = _np(tops.crossmatch_shared(
            bucket_cat, probes_cat, bseg, pseg, thr_row, device=CPU
        ))
        at = 0
        for b, probes, thr in queries:
            idx, dot, cnt = _np(tops.crossmatch(payloads[b], probes, thr, device=CPU))
            sl = slice(at, at + len(probes))
            np.testing.assert_array_equal(s_idx[sl] - row_off[b], idx)
            np.testing.assert_array_equal(s_dot[sl].view(np.int32), dot.view(np.int32))
            np.testing.assert_array_equal(s_cnt[sl], cnt)
            at += len(probes)

    def test_single_query_single_probe(self):
        bucket = np.array([[1.0, 0.0, 0.0]])
        idx, dot, cnt = tops.crossmatch_shared(
            bucket, bucket, np.zeros(1), np.zeros(1), np.array([0.99]), device=CPU
        )
        assert int(idx[0]) == 0 and int(cnt[0]) == 1
        assert float(dot[0]) == pytest.approx(1.0)
