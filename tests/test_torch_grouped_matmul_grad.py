"""K5's backward (``grouped_matmul_fn``, on the CPU) and the MoE layer's
gradients held against the JAX reference.

On CPU tensors ``grouped_matmul_fn``'s forward and backward are the plain
versions: dX is ``grouped_matmul_tiles_ref`` on each group's transposed
weights, dW is ``grouped_matmul_dw_ref``.  The reference has no Pallas
backward: its MoE is an ``einsum("ecd,edf->ecf")`` that ``jax.grad``
transposes, and that is what the port's gradients are held to.  Inputs
come from numpy seeds; weights of the MoE layer are the reference's own.
Tolerances, in float32:

* the Function against torch autograd through ``grouped_matmul_tiles_ref``
  (the same f32 products, other association): rtol = atol = 1e-6 of the
  largest value; bfloat16: 1e-2, a bf16 rounding of either side;
* against ``jax.grad`` of the einsum: 1e-5, the reference's f32
  tolerance for the grouped matmul (``tests/test_kernels.py:173``);
* an empty group's dW and the dX of rows past ``tile_rows``: exactly +0;
* dX read from w as it is (``w_transposed``) against the plain version on
  a contiguous copy of w^T: bit for bit;
* one MoE layer's value and gradients (router, experts, through dispatch
  and combine) against ``jax.value_and_grad``: 1e-5 of each leaf's
  largest value; measured up to 2.8e-7.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro_torch.benchmarks.common import misaligned, same_bits  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gops  # noqa: E402
from repro_torch.kernels.grouped_matmul.ref import (  # noqa: E402
    grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
)
from repro_torch.models import moe as tmoe  # noqa: E402

FN_TOL = 1e-6
BF16_TOL = 1e-2
REF_TOL = 1e-5


def _case(seed, G=4, C=16, bt=8, d=24, f=20, empty=True, dtype=torch.float32):
    """x (G*C, d), w (G, d, f), tile ids of G groups of C rows in bt-row
    tiles, per-tile real rows (group 1 with none when ``empty``; group 2
    with a partly filled tile), and the output's cotangent; x is nonzero
    past the counts too, which the Function must ignore."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(G * C, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(G, d, f)) / d ** 0.5)
                         .astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(G * C, f)).astype(np.float32))
    gid = torch.arange(G * C // bt, dtype=torch.int32) // (C // bt)
    real = np.full(G, C)
    if empty:
        real[1], real[2] = 0, C - bt - 3
    rows = np.clip(real[:, None] - np.arange(0, C, bt), 0, bt)
    rows = torch.from_numpy(rows.reshape(-1).astype(np.int32))
    return (x.to(dtype), w.to(dtype), r.to(dtype), gid, rows, bt)


def _grads(fn, x, w, r, *args):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y = fn(x, args[0], w, *args[1:])
    (y.float() * r.float()).sum().backward()
    return y.detach(), x.grad, w.grad


def _close(got, want, tol):
    want = want.float()
    scale = float(want.abs().max()) or 1.0
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_rows", [True, False], ids=["rows", "dense"])
def test_fn_backward_equals_autograd_through_the_plain_version(dtype,
                                                               with_rows):
    """dX and dW of the Function equal torch autograd through K5's plain
    version, with and without per-tile real rows."""
    x, w, r, gid, rows, bt = _case(0, dtype=dtype)
    rows = rows if with_rows else None
    y, dx, dw = _grads(gkernel.grouped_matmul_fn, x, w, r, gid, bt, rows)
    y0, dx0, dw0 = _grads(grouped_matmul_tiles_ref, x, w, r, gid, bt, rows)
    tol = FN_TOL if dtype == torch.float32 else BF16_TOL
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert torch.equal(y, y0)
    _close(dx, dx0, tol)
    _close(dw, dw0, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("with_rows", [True, False], ids=["rows", "dense"])
def test_transposed_w_equals_the_plain_version_on_w_t(dtype, with_rows):
    """``_k5`` with ``w_transposed`` (w as it is, read as each group's w^T:
    K5's dX) equals the plain version on a contiguous copy of w^T bit for
    bit, and the Function's dX is exactly that call."""
    x, w, r, gid, rows, bt = _case(5, dtype=dtype)
    rows = rows if with_rows else None
    wt = w.transpose(1, 2).contiguous()
    got = gkernel._k5(r, gid, w, bt, rows, "grouped_matmul_dx",
                      w_transposed=True)
    want = grouped_matmul_tiles_ref(r, gid, wt, bt, rows)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    _, dx, _ = _grads(gkernel.grouped_matmul_fn, x, w, r, gid, bt, rows)
    assert torch.equal(dx, want)


# (dtype, d, f, offset of x's base in elements, the path): TMA takes rows
# of a whole number of 16 bytes (d and f multiples of 8 in bf16, 4 in f32)
# on 16-byte aligned bases.
PATH_CASES = {
    "moe": (torch.bfloat16, 2048, 1408, 0, "tma"),
    "ragged": (torch.bfloat16, 192, 160, 0, "tma"),
    "odd": (torch.bfloat16, 100, 37, 0, "async"),
    "unaligned": (torch.bfloat16, 64, 32, 1, "async"),
    "d_odd": (torch.bfloat16, 100, 160, 0, "async"),
    "f32": (torch.float32, 192, 160, 0, "f32"),
    "f32_moe": (torch.float32, 2048, 1408, 0, "f32"),
    "f32_d_odd": (torch.float32, 98, 160, 0, "f32_async"),
    "f32_f_odd": (torch.float32, 192, 162, 0, "f32_async"),
    "f32_odd": (torch.float32, 100, 37, 0, "f32_async"),
    "f32_unaligned": (torch.float32, 192, 160, 1, "f32_async"),
    "f32_unaligned_2": (torch.float32, 192, 160, 2, "f32_async"),
    "f32_aligned_4": (torch.float32, 192, 160, 4, "f32"),
}


@pytest.mark.parametrize("dtype,d,f,offset,path", list(PATH_CASES.values()),
                         ids=list(PATH_CASES))
def test_dw_kernel_path_by_dtype_shape_and_alignment(dtype, d, f, offset,
                                                     path):
    """``dw_kernel_path`` names the dW kernel a call takes: the TMA one of
    the dtype where TMA can describe x and dy (bf16 "tma", f32 "f32"), the
    async one of the dtype else ("async", "f32_async")."""
    T = 256
    x = torch.zeros(T * d + offset, dtype=dtype)[offset:].view(T, d)
    dy = torch.zeros(T, f, dtype=dtype)
    assert gkernel.dw_kernel_path(x, dy) == path
    assert gkernel.DW_KERNELS[path] in gkernel.KERNEL_LAUNCHES


@pytest.mark.parametrize("dtype,d,f,offset,path", list(PATH_CASES.values()),
                         ids=list(PATH_CASES))
def test_kernel_path_by_dtype_shape_and_alignment(dtype, d, f, offset, path):
    """``kernel_path`` names the forward's kernel by the same rule: x (T,
    d) at the offset and w (G, d, f); and K5's dX, dy (T, f) against the
    forward's w read transposed, takes the TMA kernel only where dy's
    width f, its output's width d and both bases suit it (a misaligned dy,
    or a d the TMA kernels' 16-byte stores do not fit, sends it to the
    async kernel of the dtype, which reads w in place too)."""
    T, G = 256, 2
    x = torch.zeros(T * d + offset, dtype=dtype)[offset:].view(T, d)
    w = torch.zeros(G, d, f, dtype=dtype)
    assert gkernel.kernel_path(x, w) == path
    assert gkernel.KERNELS[path] in gkernel.KERNEL_LAUNCHES
    dy = torch.zeros(T * f + offset, dtype=dtype)[offset:].view(T, f)
    dx_path = gkernel.kernel_path(dy, w)
    vec = 4 if dtype == torch.float32 else 8
    tma = f % vec == 0 and d % vec == 0 and offset * \
        dy.element_size() % 16 == 0
    assert dx_path == {(torch.float32, True): "f32",
                       (torch.float32, False): "f32_async",
                       (torch.bfloat16, True): "tma",
                       (torch.bfloat16, False): "async"}[dtype, tma]


@pytest.mark.parametrize("dtype,path", [(torch.float32, "f32_async"),
                                        (torch.bfloat16, "async")],
                         ids=["f32", "bf16"])
def test_misaligned_copy_takes_the_element_load_path(dtype, path):
    """``misaligned`` (the card checks' way onto the kernels TMA cannot
    feed: the async kernels of both dtypes) copies x one element past a
    16-byte boundary by default, or ``nbytes`` past: the same bits, a base
    TMA cannot describe; ``same_bits`` tells one flipped bit apart."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(128, 64)).astype(np.float32)).to(dtype)
    w = torch.zeros(2, 64, 32, dtype=dtype)
    xm = misaligned(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    assert gkernel.kernel_path(xm, w) == path
    assert gkernel.dw_kernel_path(xm, torch.zeros(128, 32, dtype=dtype)) \
        == path
    assert same_bits(x, xm) and not same_bits(x, xm.double())
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    flipped = xm.clone()
    flipped.view(bits)[3, 5] ^= 1
    assert not same_bits(x, flipped)
    x8 = misaligned(x, 8)
    assert x8.data_ptr() % 16 == 8 and same_bits(x, x8)
    assert gkernel.kernel_path(x8, w) == path


def test_library_variant_writes_the_source_with_one_edit(tmp_path):
    """``CudaLibrary.variant`` (the tuning sweeps' copies of K5's source)
    writes the source with each edit made once and builds nothing until
    loaded; text that is not in the source once is refused."""
    old = "constexpr int kF32Stages = 4;"
    lib = gkernel.LIBRARY.variant(
        [(old, "constexpr int kF32Stages = 3;")], tmp_path / "v" / "g.cu")
    text = lib.source.read_text()
    assert lib.name == gkernel.LIBRARY.name and lib.source != \
        gkernel.LIBRARY.source
    assert text == gkernel.LIBRARY.source.read_text().replace(
        old, "constexpr int kF32Stages = 3;")
    assert lib.info() == {}
    with pytest.raises(ValueError, match="once"):
        gkernel.LIBRARY.variant([("no such text", "")], tmp_path / "w.cu")


def test_fn_matches_jax_grad_of_the_einsum():
    """The (E, C, d) layout of the MoE experts: the Function's gradients
    equal ``jax.grad`` of the reference's ``einsum("ecd,edf->ecf")``; with
    tile_rows, on the real rows (x zero past them, as the expert buffer
    is), while the rows past the counts get dX = +0 and the expert with no
    token dW = +0."""
    x, w, r, gid, rows, bt = _case(1)
    G, d, f = w.shape
    C = x.shape[0] // G

    def loss(xe, we, re):
        return jnp.sum(jnp.einsum("ecd,edf->ecf", xe, we) * re)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x.numpy().reshape(G, C, d)), jnp.asarray(w.numpy()),
        jnp.asarray(r.numpy().reshape(G, C, f)))
    _, dx, dw = _grads(gkernel.grouped_matmul_fn, x, w, r, gid, bt, None)
    _close(dx, torch.from_numpy(np.array(jdx).reshape(G * C, d)), REF_TOL)
    _close(dw, torch.from_numpy(np.array(jdw)), REF_TOL)

    real = (torch.arange(bt)[None, :] < rows[:, None]).reshape(-1)
    xz = x * real[:, None]
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(xz.numpy().reshape(G, C, d)), jnp.asarray(w.numpy()),
        jnp.asarray(r.numpy().reshape(G, C, f)))
    _, dx, dw = _grads(gkernel.grouped_matmul_fn, x, w, r, gid, bt, rows)
    jdx = torch.from_numpy(np.array(jdx).reshape(G * C, d))
    _close(dx[real], jdx[real], REF_TOL)
    _close(dw, torch.from_numpy(np.array(jdw)), REF_TOL)
    assert torch.equal(dx[~real], torch.zeros_like(dx[~real]))
    assert not torch.signbit(dx[~real]).any()
    assert torch.equal(dw[1], torch.zeros_like(dw[1]))
    assert (dw[0] != 0).any() and (dw[2] != 0).any()


def test_dw_plain_version_groups_and_ids():
    """``grouped_matmul_dw_ref``: a group that owns no tile gets +0, a tile
    id outside [0, G) counts for no group, and tiles of one group apart
    from each other add up."""
    rng = np.random.default_rng(2)
    bt, d, f = 4, 6, 5
    x = torch.from_numpy(rng.normal(size=(5 * bt, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(5 * bt, f)).astype(np.float32))
    gid = torch.tensor([0, 2, 0, 7, -1], dtype=torch.int32)
    dw = grouped_matmul_dw_ref(x, dy, gid, 3, bt)
    t = [slice(i * bt, (i + 1) * bt) for i in range(5)]
    want0 = x[t[0]].T @ dy[t[0]] + x[t[2]].T @ dy[t[2]]
    _close(dw[0], want0, FN_TOL)
    _close(dw[2], x[t[1]].T @ dy[t[1]], FN_TOL)
    assert torch.equal(dw[1], torch.zeros(d, f))
    rows = torch.tensor([2, 0, 4, 4, 4], dtype=torch.int32)
    dw = grouped_matmul_dw_ref(x, dy, gid, 3, bt, rows)
    want0 = x[0:2].T @ dy[0:2] + x[t[2]].T @ dy[t[2]]
    _close(dw[0], want0, FN_TOL)
    assert torch.equal(dw[2], torch.zeros(d, f))


def test_fn_without_grad_is_the_raw_wrapper():
    """With no input that requires grad (or under no_grad) the Function is
    not entered: the output has no graph and equals the raw wrapper's."""
    x, w, _, gid, rows, bt = _case(3)
    y = gkernel.grouped_matmul_fn(x, gid, w, bt, rows)
    assert y.grad_fn is None
    assert torch.equal(y, gkernel.grouped_matmul_kernel(x, gid, w, bt, rows))
    with torch.no_grad():
        y = gkernel.grouped_matmul_fn(x, gid, w.requires_grad_(), bt, rows)
    assert y.grad_fn is None and not y.requires_grad
    y = gkernel.grouped_matmul_fn(x, gid, w, bt, rows)
    assert type(y.grad_fn).__name__ == "_GroupedMatmulBackward"


def test_ops_grouped_matmul_is_differentiable():
    """``ops.grouped_matmul`` (and the hybrid's kernel path) carry
    gradients into w: the einsum's, group by group."""
    rng = np.random.default_rng(4)
    sizes = [8, 16, 8]
    x = torch.from_numpy(rng.normal(size=(32, 12)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 12, 10)).astype(np.float32))
    for fn in (gops.grouped_matmul, gops.hybrid_grouped_matmul):
        wg = w.clone().requires_grad_()
        fn(x, sizes, wg, bt=8).sum().backward()
        lo = np.cumsum([0] + sizes)
        want = torch.stack([x[lo[g]:lo[g + 1]].T @ torch.ones(sizes[g], 10)
                            for g in range(3)])
        _close(wg.grad, want, FN_TOL)


def _moe_cfgs(**kw):
    return (dataclasses.replace(j_smoke("moonshot-v1-16b-a3b"), **kw),
            dataclasses.replace(t_smoke("moonshot-v1-16b-a3b"), **kw))


@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_moe_layer_grads_match_reference(case):
    """One MoE layer, the sum of its output times a fixed cotangent plus its
    aux loss: the value and the gradients of the router, wg, wu, wd and
    the input equal ``jax.value_and_grad`` of the reference's.  At decode
    (8 tokens, 16 experts) some experts get no token: their weights'
    gradients are +0 on both sides."""
    kw, shape = ((dict(n_experts=16), (8, 1)) if case == "decode"
                 else (dict(), (4, 32)))
    jcfg, tcfg = _moe_cfgs(**kw)
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(
        jcfg, JFactory(jax.random.PRNGKey(6), jnp.float32)))
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape + (jcfg.d_model,)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def jloss(pp, xx):
        y, aux = jmoe.moe_apply_with_aux(jcfg, pp, xx)
        return jnp.sum(y * r) + aux

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        p, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply_with_aux(tcfg, tp, tx)
    tl = torch.sum(y * torch.from_numpy(r)) + aux
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=REF_TOL, abs=REF_TOL)
    for k, v in tp.items():
        _close(v.grad, torch.from_numpy(np.array(jgp[k])), REF_TOL)
    _close(tx.grad, torch.from_numpy(np.array(jgx)), REF_TOL)
    for k in ("wg", "wu", "wd"):
        assert (tp[k].grad != 0).any()
        if case == "decode":
            idle = (tp[k].grad == 0).flatten(1).all(dim=1)
            jidle = (np.asarray(jgp[k]) == 0).reshape(16, -1).all(axis=1)
            assert idle.any() and np.array_equal(idle.numpy(), jidle)
