"""The port's grouped matmul (K5's wrappers, on the CPU) held against the
JAX reference.

The reference runs its kernel path as ``tests/test_kernels.py`` does: the
Pallas kernel in interpret mode (``use_pallas=True``).  The port's
``grouped_matmul`` on CPU tensors runs K5's plain version
(``grouped_matmul_tiles_ref``).  Inputs come from numpy seeds.
Tolerances are the reference's own for this kernel
(``tests/test_kernels.py:173``, ``:187``, ``:201``): 1e-5 in float32 and
5e-2 in bfloat16; both sides sum in f32, in other orders.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grouped_matmul import ops as jops  # noqa: E402
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as j_ref  # noqa: E402
from repro.kernels.grouped_matmul.ref import row_groups as j_row_groups  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as tkernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.grouped_matmul.ref import (  # noqa: E402
    grouped_matmul_ref, grouped_matmul_tiles_ref, row_groups,
)

F32_TOL = 1e-5
BF16_TOL = 5e-2
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _both(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _close(got: torch.Tensor, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("sizes,d,f", [
    ([128, 256, 128, 512], 256, 192),
    ([128, 128], 512, 512),
    ([384, 128, 128, 128, 256], 128, 64),
    # widths TMA cannot describe (the card's async kernels): rows of 2040
    # and 2042 bytes, and an output 1020 wide as K5's dX makes it; the
    # reference pads f and d on every call (its ops.py:65-74)
    ([128, 128], 64, 1020),
    ([128, 128], 64, 1021),
    ([128, 128], 1020, 64),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_matches_reference_kernel_path(sizes, d, f, dtype):
    """``tests/test_kernels.py::test_matches_ref``'s cases, and widths
    that are not multiples of 8: the port's ``grouped_matmul`` equals the
    reference's Pallas path (interpret mode) and the f32 oracle, at the
    reference's tolerances (module docstring; at d = 1020 both sides sum
    1020 products in f32, in other orders, well inside 1e-5 of values
    ~0.3)."""
    rng = np.random.default_rng(0)
    T, G = sum(sizes), len(sizes)
    jx, tx = _both(rng.normal(size=(T, d)), dtype)
    jw, tw = _both(rng.normal(size=(G, d, f)) * 0.1, dtype)
    want = jops.grouped_matmul(jx, jnp.array(sizes), jw, bt=128, bf=64,
                               bk=128, use_pallas=True)
    oracle = j_ref(jx.astype(jnp.float32), jnp.array(sizes),
                   jw.astype(jnp.float32))
    got = tops.grouped_matmul(tx, torch.tensor(sizes), tw, bt=128, bf=64,
                              bk=128)
    assert got.dtype == tx.dtype and got.shape == (T, f)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    _close(got, want, tol, tol)
    _close(got, oracle, tol, tol)


@pytest.mark.parametrize("bt,bf,bk", [(128, 128, 128), (256, 256, 384),
                                      (128, 64, 192)])
def test_block_sweep(bt, bf, bk):
    """``tests/test_kernels.py::test_block_sweep``: every block choice of
    the reference gives the reference's answer."""
    rng = np.random.default_rng(1)
    sizes = [256, 256, 512]
    x = rng.normal(size=(1024, 384)).astype(np.float32)
    w = (rng.normal(size=(3, 384, 256)) * 0.1).astype(np.float32)
    want = jops.grouped_matmul(jnp.asarray(x), jnp.array(sizes),
                               jnp.asarray(w), bt=bt, bf=bf, bk=bk,
                               use_pallas=True)
    got = tops.grouped_matmul(torch.from_numpy(x), sizes, torch.from_numpy(w),
                              bt=bt, bf=bf, bk=bk)
    _close(got, want, 1e-4, F32_TOL)


@pytest.mark.parametrize("threshold", [129, 16, 300])
def test_hybrid_matches_reference(threshold):
    """``test_hybrid_paths_agree``'s case, and thresholds that put no group
    or two groups on the indexed path."""
    rng = np.random.default_rng(2)
    sizes = [128, 128, 256]
    x = rng.normal(size=(512, 128)).astype(np.float32)
    w = (rng.normal(size=(3, 128, 64)) * 0.1).astype(np.float32)
    want = jops.hybrid_grouped_matmul(
        jnp.asarray(x), jnp.array(sizes), jnp.asarray(w),
        threshold_rows=threshold, bt=128, bf=64, bk=128)
    got = tops.hybrid_grouped_matmul(
        torch.from_numpy(x), torch.tensor(sizes), torch.from_numpy(w),
        threshold_rows=threshold, bt=128, bf=64, bk=128)
    _close(got, want, 1e-4, F32_TOL)
    _close(got, j_ref(jnp.asarray(x), jnp.array(sizes), jnp.asarray(w)),
           1e-4, F32_TOL)


def test_hybrid_indexed_rows_need_no_kernel_path_weights():
    """Rows of a small group take the indexed path: with that group's
    tile mapped to another group by an unaligned boundary, the hybrid
    still gives the row's own group (as the reference does)."""
    rng = np.random.default_rng(3)
    sizes = [8, 248]  # group 0 is small and shares tile 0 with group 1
    x = rng.normal(size=(256, 32)).astype(np.float32)
    w = rng.normal(size=(2, 32, 16)).astype(np.float32)
    want = jops.hybrid_grouped_matmul(jnp.asarray(x), jnp.array(sizes),
                                      jnp.asarray(w), threshold_rows=16,
                                      bt=128, bf=16, bk=32)
    got = tops.hybrid_grouped_matmul(torch.from_numpy(x), sizes,
                                     torch.from_numpy(w), threshold_rows=16)
    _close(got, want, 1e-4, F32_TOL)
    np.testing.assert_allclose(got[:8].numpy(), x[:8] @ w[0], rtol=1e-5,
                               atol=F32_TOL)


@pytest.mark.parametrize("sizes,n", [([2, 3, 1], 6), ([2, 3, 1], 9),
                                     ([0, 4, 0, 2], 7), ([5], 3)])
def test_row_groups(sizes, n):
    want = np.asarray(j_row_groups(jnp.array(sizes), n))
    got = row_groups(torch.tensor(sizes), n)
    np.testing.assert_array_equal(got.numpy(), want)
    if sizes == [2, 3, 1] and n == 6:
        np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 1, 1, 2])


@pytest.mark.parametrize("sizes,bt", [([2, 3, 1], 4), ([128, 5, 0, 70], 128),
                                      ([7], 8)])
def test_pad_groups_to_tiles(sizes, bt):
    """(row_map, padded_sizes, starts), as the reference's code returns."""
    T = sum(sizes)
    x = np.zeros((T, 4), np.float32)
    want = jops.pad_groups_to_tiles(jnp.asarray(x), jnp.array(sizes), bt)
    got = tops.pad_groups_to_tiles(torch.from_numpy(x), torch.tensor(sizes), bt)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rows_past_the_groups_total_take_the_last_group():
    rng = np.random.default_rng(4)
    sizes = [128, 128]  # 256 of the 512 rows
    x = rng.normal(size=(512, 64)).astype(np.float32)
    w = (rng.normal(size=(2, 64, 32)) * 0.1).astype(np.float32)
    want = jops.grouped_matmul(jnp.asarray(x), jnp.array(sizes),
                               jnp.asarray(w), bt=128, bf=32, bk=64,
                               use_pallas=True)
    got = tops.grouped_matmul(torch.from_numpy(x), sizes, torch.from_numpy(w))
    _close(got, want, F32_TOL, F32_TOL)
    _close(got[256:], x[256:] @ w[1], F32_TOL, F32_TOL)
    oracle = grouped_matmul_ref(torch.from_numpy(x), torch.tensor(sizes),
                                torch.from_numpy(w))
    _close(oracle, j_ref(jnp.asarray(x), jnp.array(sizes), jnp.asarray(w)),
           F32_TOL, F32_TOL)


def test_unaligned_groups_follow_the_reference_kernel_path():
    """Sizes [100, 156] with bt = 128: the reference's kernel path gives
    rows 100-127 group 0's weights (its docstring promises a fall-back to
    the oracle that its code does not make).  The port does the same, and
    the per-row oracle stays the per-row oracle (ROADMAP.md §3)."""
    rng = np.random.default_rng(5)
    sizes = [100, 156]
    x = rng.normal(size=(256, 128)).astype(np.float32)
    w = rng.normal(size=(2, 128, 64)).astype(np.float32)
    want = jops.grouped_matmul(jnp.asarray(x), jnp.array(sizes),
                               jnp.asarray(w), bt=128, bf=64, bk=128,
                               use_pallas=True)
    got = tops.grouped_matmul(torch.from_numpy(x), sizes, torch.from_numpy(w))
    _close(got, want, F32_TOL, F32_TOL)
    _close(got[100:128], x[100:128] @ w[0], F32_TOL, F32_TOL)
    oracle = grouped_matmul_ref(torch.from_numpy(x), torch.tensor(sizes),
                                torch.from_numpy(w))
    _close(oracle, j_ref(jnp.asarray(x), jnp.array(sizes), jnp.asarray(w)),
           F32_TOL, F32_TOL)
    assert float((got - oracle).abs().max()) > 1.0


def test_tiles_ref_runs_and_refusals():
    """The plain version: a run of equal tile ids is one product; tile ids
    may repeat out of order; T must be whole tiles."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 32, 8)).astype(np.float32))
    gid = torch.tensor([2, 0, 0, 2], dtype=torch.int32)
    got = grouped_matmul_tiles_ref(x, gid, w, 128)
    for t, g in enumerate(gid.tolist()):
        rows = slice(128 * t, 128 * (t + 1))
        torch.testing.assert_close(got[rows], x[rows] @ w[g], rtol=1e-5,
                                   atol=F32_TOL)
    with pytest.raises(ValueError):
        grouped_matmul_tiles_ref(x[:500], gid, w, 128)
    with pytest.raises(ValueError):
        grouped_matmul_tiles_ref(x, gid[:3], w, 128)
    with pytest.raises(ValueError):
        grouped_matmul_tiles_ref(x, torch.tensor([0, 0, 3, 0]), w, 128)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 64, 32)).astype(np.float32))
    before = tkernel.LAUNCHES["grouped_matmul"]
    gid = tops.tile_groups(torch.tensor([128, 128]), 256, 128, 2)
    assert gid.dtype == torch.int32 and gid.tolist() == [0, 1]
    got = tkernel.grouped_matmul_kernel(x, gid, w, 128)
    torch.testing.assert_close(got, grouped_matmul_tiles_ref(x, gid, w, 128))
    assert tkernel.LAUNCHES["grouped_matmul"] == before
    # meta tensors (the dry-run's shards): the output's shape, no launch,
    # the kernel's flops and bytes reported to kernels.shapes
    from repro_torch.kernels import shapes

    seen = []
    with shapes.recording(lambda *rec: seen.append(rec)):
        out = tkernel.grouped_matmul_kernel(x.to("meta"), gid.to("meta"),
                                            w.to("meta"), 128)
    assert out.device.type == "meta" and tuple(out.shape) == (256, 32)
    assert tkernel.LAUNCHES["grouped_matmul"] == before
    assert seen == [("grouped_matmul", 2.0 * 256 * 64 * 32,
                     4 * (256 * 64 + 2 * 64 * 32 + 256 * 32) + 4 * 2)]


TILE_ROWS = {  # real leading rows of each of the 8 tiles of 128 rows
    "zero": [0] * 8,
    "partial": [5, 1, 127, 64, 100, 3, 77, 2],
    "full": [128] * 8,
    "mixed": [0, 128, 37, 0, 128, 1, 0, 90],
}


@pytest.mark.parametrize("rows", list(TILE_ROWS))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_tile_rows_match_reference_on_zeroed_rows(rows, dtype):
    """With ``tile_rows`` the plain version of K5 gives the reference's
    kernel path (interpret mode) on x with the rows past each tile's count
    zeroed, whatever those rows of x hold; they come out +0."""
    rng = np.random.default_rng(8)
    sizes, d, f, bt = [128, 256, 128, 512], 256, 192, 128
    T, G = sum(sizes), len(sizes)
    counts = np.array(TILE_ROWS[rows], np.int32)
    real = (np.arange(bt)[None, :] < counts[:, None]).reshape(T)
    x = rng.normal(size=(T, d))
    jx, _ = _both(np.where(real[:, None], x, 0.0), dtype)
    _, tx = _both(x, dtype)  # rows past the counts keep their values
    jw, tw = _both(rng.normal(size=(G, d, f)) * 0.1, dtype)
    want = jops.grouped_matmul(jx, jnp.array(sizes), jw, bt=bt, bf=64,
                               bk=128, use_pallas=True)
    gid = tops.tile_groups(torch.tensor(sizes), T, bt, G)
    got = grouped_matmul_tiles_ref(tx, gid, tw, bt, torch.from_numpy(counts))
    assert got.dtype == tx.dtype and got.shape == (T, f)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    _close(got, want, tol, tol)
    past = got[torch.from_numpy(~real)]
    assert bool((past == 0).all()) and not bool(torch.signbit(past).any())
    # the wrapper on CPU tensors is the plain version, counts and all
    torch.testing.assert_close(
        tkernel.grouped_matmul_kernel(tx, gid, tw, bt,
                                      torch.from_numpy(counts)), got)


def test_tile_rows_refusals_of_the_plain_version():
    x = torch.zeros(256, 16)
    w = torch.zeros(2, 16, 8)
    gid = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        grouped_matmul_tiles_ref(x, gid, w, 128, torch.tensor([1, 2, 3]))
    assert grouped_matmul_tiles_ref(x, gid, w, 128, None).shape == (256, 8)
