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
    for thr in (float(np.cos(5e-3)), float(np.cos(2.0))):
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
    with pytest.raises(ValueError):
        tkernel.crossmatch_fused_kernel(b, p, torch.zeros(512, device=card),
                                        torch.zeros(128), 0.9)  # seg on cpu


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
