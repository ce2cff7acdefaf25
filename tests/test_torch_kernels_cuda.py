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

The grouped matmul (K5) is held to its plain version at the reference's
tolerances for it, rtol = atol = 5e-2 in bfloat16 and 1e-5 in float32
(``tests/test_kernels.py:173``), at aligned row tiles with ragged column
and depth edges, with and without counts of real rows a tile (the TMA
kernel for bf16 rows of a 16-byte pitch, the element-load one else), with weights at the model's init scale 1/sqrt(d) (what K5
sees on the MoE path).  The reference's 1e-5 is set for its depths (d <=
512); two f32 sums over d terms in different orders drift apart by about
sqrt(d) ulps of the partial sums (at d = 2048 with weights x0.1 the card
and the CPU differed by 1.3e-5 on an element of 0.04, neither wrong).  So
at d > 512 both the kernel and the plain version are held to the float64
product within the f32 dot-product bound sqrt(d) * 2**-24 * sum|x||w|
(Higham's probabilistic bound), elementwise; a wrong group or tile would be
off by O(1).  The MoE decode at smoke size on the card is held to the same
decode on the CPU.

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
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_splits_ref  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gops  # noqa: E402
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref  # noqa: E402
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


# ------------------------------------------------------------------ K5
GMM_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-5}


def _gmm_path(d, f, dtype):
    """The kernel K5 should take: TMA + wgmma for bf16 whose d and f are
    multiples of 8 (a 16-byte row pitch), element loads for other bf16."""
    if dtype == torch.float32:
        return "f32"
    return "tma" if d % 8 == 0 and f % 8 == 0 else "elem"


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
    ([256, 256], 100, 37),  # d, f not multiples of 8: element loads
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
