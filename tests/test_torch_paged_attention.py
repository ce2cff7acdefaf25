"""The port's paged decode attention (K4's plain version) and its page pool,
held against the JAX reference on the same inputs.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs as ``tests/test_kernels.py`` runs it: the Pallas kernel in
interpret mode (``use_pallas=True``) and the jnp oracle
(``paged_attention_ref``).  Tolerances are the reference's own for this
kernel: rtol = atol = 2e-5 in float32 (the reference's kernel-vs-oracle
bound: a different summation order over at most 128 slots) and 5e-2 in
bfloat16 (where the Pallas kernel rounds unnormalised probabilities and the
oracle normalised ones).  On the CPU the port's wrapper runs the plain
version and launches nothing.  ``paged_attention_splits_ref``, the CUDA
kernel's split arithmetic written plainly (each chunk's own softmax, the
chunks merged in order), is held to the same references at the same
tolerances: the split only moves where a probability is rounded.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import dense_to_pages as j_dense_to_pages  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref  # noqa: E402
from repro.serving.kvcache import PagePool as JPagePool  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref as t_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_splits_ref  # noqa: E402
from repro_torch.serving.kvcache import PagePool as TPagePool  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 5e-2


def _jax_out(use_pallas, q, kp, vp, pt, lens):
    if use_pallas:
        out = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(pt), jnp.asarray(lens), use_pallas=True)
    else:
        out = j_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(pt), jnp.asarray(lens))
    return np.asarray(out, np.float32)


def _port_out(q, kp, vp, pt, lens, dtype=torch.float32):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q, kp, vp)]
    before = dict(tkernel.LAUNCHES)
    out = tops.paged_attention(
        *[x.to(dtype) for x in t], torch.from_numpy(pt), torch.from_numpy(lens)
    )
    assert tkernel.LAUNCHES == before  # the CPU launches no kernel
    assert out.dtype == dtype
    return out.float().numpy()


def _paged_inputs(rng, B, h, kv, D, page, pages, permute=True):
    """q, pools and a page table: the dense (B, S, KV, D) cache paged as
    ``dense_to_pages`` pages it, with the pool's pages shuffled (so the
    table is a permutation, not the identity) when ``permute``; lengths
    in [1, S]."""
    S = page * pages
    q = rng.normal(size=(B, h, D)).astype(np.float32)
    k = rng.normal(size=(B, S, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, kv, D)).astype(np.float32)
    kp = k.reshape(B * pages, page, kv, D)
    vp = v.reshape(B * pages, page, kv, D)
    pt = np.arange(B * pages, dtype=np.int32).reshape(B, pages)
    if permute:
        perm = rng.permutation(B * pages)  # new position of each page
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        kp, vp = kp[inv], vp[inv]
        pt = perm[pt].astype(np.int32)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    return q, kp, vp, pt, lens


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (8, 1), (16, 2)])
@pytest.mark.parametrize("page,pages", [(16, 4), (32, 2), (8, 16)])
def test_plain_matches_reference(use_pallas, h, kv, page, pages):
    rng = np.random.default_rng(0)
    args = _paged_inputs(rng, 3, h, kv, 32, page, pages)
    np.testing.assert_allclose(_port_out(*args), _jax_out(use_pallas, *args),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
def test_bf16(use_pallas):
    rng = np.random.default_rng(1)
    B, H, KV, D, page, P = 2, 8, 4, 64, 16, 4
    q, kp, vp, pt, _ = _paged_inputs(rng, B, H, KV, D, page, P)
    lens = np.array([page * P, page * P // 2], np.int32)
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, kp, vp)]
    want = _jax_out(use_pallas, *bf, pt, lens)
    got = _port_out(q, kp, vp, pt, lens, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_shared_pages_across_sequences():
    """Two sequences pointing at the SAME pages (prefix sharing -- the
    bucket-contention case) attend identically, and as the reference."""
    rng = np.random.default_rng(2)
    B, H, KV, D, page, P = 2, 4, 4, 16, 8, 4
    q1 = rng.normal(size=(1, H, D)).astype(np.float32)
    q = np.concatenate([q1, q1], axis=0)
    kp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    pt = np.tile(np.arange(P, dtype=np.int32)[None], (B, 1))
    lens = np.array([page * P, page * P], np.int32)
    out = _port_out(q, kp, vp, pt, lens)
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out, _jax_out(True, q, kp, vp, pt, lens),
                               rtol=F32_TOL, atol=F32_TOL)


def test_length_masking():
    """Slots past seq_len must not contribute: perturbing them is a no-op."""
    rng = np.random.default_rng(3)
    q, kp, vp, pt, _ = _paged_inputs(rng, 1, 4, 2, 16, 8, 4, permute=False)
    lens = np.array([10], np.int32)
    out1 = _port_out(q, kp, vp, pt, lens)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[2:], vp2[2:] = 99.0, -99.0
    np.testing.assert_array_equal(_port_out(q, kp2, vp2, pt, lens), out1)
    np.testing.assert_allclose(out1, _jax_out(True, q, kp, vp, pt, lens),
                               rtol=F32_TOL, atol=F32_TOL)


def test_zero_length_gives_the_oracles_mean():
    """``seq_len == 0``: the plain version follows the jnp oracle (a
    softmax over all-masked scores is uniform: the mean of v); the Pallas
    kernel, and the CUDA kernel after it, give 0 there.  The decode path
    never asks for 0 (ROADMAP.md §3)."""
    rng = np.random.default_rng(4)
    q, kp, vp, pt, _ = _paged_inputs(rng, 2, 4, 2, 16, 8, 2, permute=False)
    lens = np.array([0, 5], np.int32)
    got = _port_out(q, kp, vp, pt, lens)
    np.testing.assert_allclose(got, _jax_out(False, q, kp, vp, pt, lens),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        got[0], vp[pt[0]].reshape(-1, 2, 16).mean(0).repeat(2, axis=0),
        rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(_jax_out(True, q, kp, vp, pt, lens)[0]).max() == 0.0


def _splits_out(q, kp, vp, pt, lens, chunk, dtype=torch.float32):
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
         for x in (q, kp, vp)]
    out = paged_attention_splits_ref(*t, torch.from_numpy(pt),
                                     torch.from_numpy(lens), chunk)
    assert out.dtype == dtype
    return out.float().numpy()


# (page, pages, chunk, lens cap): chunks that end inside a page, that end
# on a page edge, and lengths that leave the last splits empty.
SPLIT_CASES = {
    "inside_page": (16, 4, 24, None),
    "page_edge": (16, 4, 32, None),
    "one_slot_chunks": (8, 2, 1, None),
    "last_splits_empty": (16, 8, 16, 40),
}


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("case", list(SPLIT_CASES), ids=list(SPLIT_CASES))
def test_split_arithmetic_matches_reference(use_pallas, h, kv, case):
    page, pages, chunk, cap = SPLIT_CASES[case]
    rng = np.random.default_rng(10)
    q, kp, vp, pt, lens = _paged_inputs(rng, 3, h, kv, 32, page, pages)
    if cap is not None:
        lens = np.minimum(lens, cap).astype(np.int32)
        assert lens.max() <= page * pages - 2 * chunk  # two empty splits
    np.testing.assert_allclose(_splits_out(q, kp, vp, pt, lens, chunk),
                               _jax_out(use_pallas, q, kp, vp, pt, lens),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("chunk", [24, 64])
def test_split_arithmetic_bf16(use_pallas, chunk):
    rng = np.random.default_rng(11)
    B, H, KV, D, page, P = 2, 8, 4, 64, 16, 8
    q, kp, vp, pt, _ = _paged_inputs(rng, B, H, KV, D, page, P)
    lens = np.array([page * P, page * P // 3], np.int32)
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, kp, vp)]
    want = _jax_out(use_pallas, *bf, pt, lens)
    got = _splits_out(q, kp, vp, pt, lens, chunk, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_split_arithmetic_zero_length_gives_zero():
    """``seq_len == 0`` gives 0, as the Pallas kernel and the CUDA kernel
    do (every split is empty; the merge divides 0 by max(0, 1e-30))."""
    rng = np.random.default_rng(12)
    q, kp, vp, pt, _ = _paged_inputs(rng, 2, 4, 2, 16, 8, 4)
    lens = np.array([0, 20], np.int32)
    got = _splits_out(q, kp, vp, pt, lens, 8)
    assert np.abs(got[0]).max() == 0.0
    want = _jax_out(True, q, kp, vp, pt, lens)
    assert np.abs(want[0]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("B,KV,slots,want", [
    (8, 32, 64, (1, 512)),  # the decode path: one split, no workspace
    (8, 16, 64, (1, 512)),
    (16, 8, 2048, (4, 512)),  # kernel_bench's shape
    (8, 32, 4096, (8, 512)),
    (1, 32, 4096, (8, 512)),
    (64, 64, 512, (1, 512)),  # a chunk exactly
    (64, 64, 9000, (18, 512)),  # the last chunk partly past the table
])
def test_split_plan_from_shapes(B, KV, slots, want):
    splits, chunk = tkernel.split_plan(slots)
    assert (splits, chunk) == want
    assert splits * chunk >= slots and (splits - 1) * chunk < slots
    assert (tkernel.workspace_bytes(B, 2 * KV, KV, 128, splits) == 0) == (
        splits == 1)
    with pytest.raises(ValueError):  # more splits than gridDim.z takes
        tkernel.split_plan(65535 * tkernel.CHUNK + 1)


@pytest.mark.parametrize("D,dtype,G,path", [
    (128, torch.bfloat16, 2, "async"), (64, torch.bfloat16, 2, "async"),
    (256, torch.float32, 2, "async"), (32, torch.float32, 2, "async"),
    (40, torch.bfloat16, 2, "scalar"), (192, torch.bfloat16, 2, "scalar"),
    (16, torch.bfloat16, 2, "scalar"), (40, torch.float32, 2, "scalar"),
    # query-head groups: bf16 at G > 2 and D = 64-256 on the tensor cores
    (128, torch.bfloat16, 6, "mma"), (192, torch.bfloat16, 6, "mma"),
    (64, torch.bfloat16, 3, "mma"), (256, torch.bfloat16, 8, "mma"),
    (192, torch.bfloat16, 12, "mma"), (128, torch.bfloat16, 20, "mma"),
    (128, torch.bfloat16, 1, "async"), (128, torch.float32, 6, "async"),
    (192, torch.float32, 12, "scalar"), (40, torch.bfloat16, 6, "scalar"),
    (16, torch.bfloat16, 6, "scalar"), (32, torch.bfloat16, 4, "scalar"),
])
def test_kernel_path_by_shape(D, dtype, G, path):
    """bf16 with G = H / KV > 2 query heads a KV head at D = 64, 128, 192
    or 256 takes the tensor-core instance; the rest the pair instance: the
    16-byte one for rows of 8, 16, 32 or 64 16-byte vectors, the scalar one
    for every other head_dim."""
    q = torch.zeros(2, 2 * G, D, dtype=dtype)
    pool = torch.zeros(4, 8, 2, D, dtype=dtype)
    assert tkernel.kernel_path(q, pool, pool) == path


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_path_of_unaligned_pools(dtype):
    """Pools whose base is off 16 bytes take element loads, whatever G."""
    q = torch.zeros(2, 12, 128, dtype=dtype)
    flat = torch.zeros(4 * 8 * 2 * 128 + 1, dtype=dtype)
    pool = flat[1:].view(4, 8, 2, 128)
    assert pool.data_ptr() % 16 != 0
    assert tkernel.kernel_path(q, pool, pool) == "scalar"
    assert tkernel.kernel_path(q, pool.clone(), pool.clone()) == (
        "mma" if dtype == torch.bfloat16 else "async")


def test_dense_to_pages_is_a_view_with_the_references_table():
    rng = np.random.default_rng(5)
    k = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 32, 2, 16)).astype(np.float32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    kp, vp, pt = tops.dense_to_pages(tk, tv, 8)
    jkp, jvp, jpt = j_dense_to_pages(jnp.asarray(k), jnp.asarray(v), 8)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvp))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    assert pt.dtype == torch.int32
    assert kp.data_ptr() == tk.data_ptr() and vp.data_ptr() == tv.data_ptr()
    with pytest.raises(ValueError):
        tops.dense_to_pages(tk, tv, 12)


# ------------------------------------------------------------------ page pool
def _drive_pools(rng, n_kv=2, head_dim=8, page=4):
    """The same operation sequence on both pools: three sequences, one
    sharing another's prefix (copy-on-write on its first append), one
    released and its pages reused."""
    jp = JPagePool(24, page, n_kv, head_dim, dtype=jnp.float32)
    tp = TPagePool(24, page, n_kv, head_dim, dtype=torch.float32, device="cpu")

    def append(sid, n):
        for _ in range(n):
            a, b = jp.append_token_slot(sid), tp.append_token_slot(sid)
            assert a == b
            k = rng.normal(size=(n_kv, head_dim)).astype(np.float32)
            v = rng.normal(size=(n_kv, head_dim)).astype(np.float32)
            jp.write_kv(*a, jnp.asarray(k), jnp.asarray(v))
            tp.write_kv(*b, torch.from_numpy(k), torch.from_numpy(v))

    for pool in (jp, tp):
        pool.create(0)
        pool.create(1)
    append(0, 6)
    append(1, 9)
    for pool in (jp, tp):
        pool.create(2, prefix_of=0)  # shares seq 0's two pages
    append(2, 3)  # copy-on-write of the shared tail page, then appends
    append(0, 1)
    for pool in (jp, tp):
        pool.release(1)
        pool.create(3)
    append(3, 5)  # reuses seq 1's freed pages
    return jp, tp


def test_page_pool_matches_reference():
    jp, tp = _drive_pools(np.random.default_rng(6))
    seqs = [0, 2, 3]
    jpt, jlens = jp.page_table(seqs, pad_to=4)
    tpt, tlens = tp.page_table(seqs, pad_to=4)
    assert tpt.dtype == torch.int32 and tlens.dtype == torch.int32
    np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(tp._refcount, jp._refcount)
    assert tp._free == jp._free and tp.free_pages == jp.free_pages
    assert tp.utilization() == jp.utilization()
    np.testing.assert_array_equal(tp.k_pages.numpy(), np.asarray(jp.k_pages))
    np.testing.assert_array_equal(tp.v_pages.numpy(), np.asarray(jp.v_pages))
    # copy-on-write left seq 0's tail page untouched by seq 2's appends
    assert tp._seqs[0].pages[1] != tp._seqs[2].pages[1]
    assert tp._seqs[0].pages[0] == tp._seqs[2].pages[0]


def test_attention_over_pool_tables_matches_reference():
    """K4's plain version over the pool's own page tables (shared pages,
    a copy-on-write page, a reused page: not the identity)."""
    rng = np.random.default_rng(7)
    jp, tp = _drive_pools(rng)
    seqs = [0, 2, 3]
    jpt, jlens = jp.page_table(seqs, pad_to=4)
    tpt, tlens = tp.page_table(seqs, pad_to=4)
    q = rng.normal(size=(3, 4, 8)).astype(np.float32)  # G = 2
    got = tops.paged_attention(torch.from_numpy(q), tp.k_pages, tp.v_pages,
                               tpt, tlens)
    want = j_paged(jnp.asarray(q), jp.k_pages, jp.v_pages, jpt, jlens,
                   use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_version_is_the_cpu_path():
    """The wrapper takes the plain version because the tensors lie on the
    CPU, and it equals ``ref`` exactly there."""
    rng = np.random.default_rng(8)
    q, kp, vp, pt, lens = [torch.from_numpy(x) for x in
                           _paged_inputs(rng, 2, 8, 2, 16, 8, 3)]
    np.testing.assert_array_equal(
        tkernel.paged_attention_kernel(q, kp, vp, pt, lens).numpy(),
        t_ref(q, kp, vp, pt, lens).numpy())
    # meta tensors (the dry-run's shards): the output's shape, no launch,
    # the kernel's flops and bytes over the table's slots reported
    from repro_torch.kernels import shapes

    before = tkernel.LAUNCHES["paged_attention"]
    seen = []
    with shapes.recording(lambda *rec: seen.append(rec)):
        out = tkernel.paged_attention_kernel(q.to("meta"), kp.to("meta"),
                                             vp.to("meta"), pt.to("meta"),
                                             lens.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert tkernel.LAUNCHES["paged_attention"] == before
    B, H, D = q.shape
    _, page, KV, _ = kp.shape
    T = pt.shape[1] * page
    moved = (2 * B * T * KV * D * 4 + 2 * q.numel() * 4
             + pt.numel() * pt.element_size() + lens.numel() * 4)
    assert seen == [("paged_attention", 4.0 * B * H * T * D, moved)]
