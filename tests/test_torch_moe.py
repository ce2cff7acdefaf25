"""The port's MoE layer and MoE decode held against the JAX reference.

Weights are the reference's own, initialised by ``repro`` and carried into
the port through numpy (``models.convert.params_from_numpy``, bit for
bit); activations are made with numpy from a seed.  The reference runs its
plain path (XLA einsums for the experts); the port's expert products go
through K5's wrapper, which on the CPU runs K5's plain version.
Tolerances, in float32:

* one MoE layer (router, dispatch, three expert products, combine):
  rtol = atol = 1e-5, the reference's f32 tolerance for the grouped matmul
  (``tests/test_kernels.py:173``); measured 4.8e-7 on outputs up to 2.9;
* the whole model's logits after 16 decode steps: 1e-4, as for the dense
  family (``tests/test_torch_serving.py``), with identical greedy tokens.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x22b"]
DISPATCH = ["onehot", "sort"]
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def _layer(jcfg, seed=0):
    """One MoE layer's f32 parameters, initialised by the reference."""
    return _numpy_tree(jmoe.init_moe(
        jcfg, JFactory(jax.random.PRNGKey(seed), jnp.float32)))


def _apply_both(jcfg, tcfg, p, x):
    jy, jaux = jmoe.moe_apply_with_aux(jcfg, p, jnp.asarray(x))
    ty, taux = tmoe.moe_apply_with_aux(tcfg, _torch_tree(p), torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


# ------------------------------------------------------------------ one layer
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, dispatch):
    """Decode-size input (B=8, S=1: C = 256) and a prefill-size one."""
    jcfg, tcfg = _cfgs(arch, moe_dispatch=dispatch)
    p = _layer(jcfg)
    rng = np.random.default_rng(0)
    for shape in ((8, 1, jcfg.d_model), (4, 96, jcfg.d_model)):
        x = rng.normal(size=shape).astype(np.float32)
        (jy, jaux), (ty, taux) = _apply_both(jcfg, tcfg, p, x)
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)
        assert taux == pytest.approx(jaux, rel=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_capacity_drop_matches_reference(dispatch):
    """capacity_factor 0.1 at T = 4096: C = 256 slots for ~2048 choices an
    expert, so most choices are dropped; the dropped ones add nothing."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", moe_dispatch=dispatch,
                       capacity_factor=0.1)
    p = _layer(jcfg, seed=1)
    x = np.random.default_rng(1).normal(
        size=(64, 64, jcfg.d_model)).astype(np.float32)
    T, E, k = 4096, tcfg.n_experts, tcfg.top_k
    C = tmoe.moe_capacity(tcfg, T)
    assert C == jmoe.moe_capacity(jcfg, T) == 256
    gates = torch.softmax(torch.from_numpy(x.reshape(T, -1))
                          @ torch.from_numpy(np.array(p["router"])), dim=-1)
    top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]
    dispatch_fn = (tmoe._dispatch_sort if dispatch == "sort"
                   else tmoe._dispatch_onehot)
    dest, within = dispatch_fn(top_idx, E, C)
    assert int(within.sum()) == E * C < T * k  # every slot full, the rest dropped
    assert bool((dest[~within] == E * C).all())
    (jy, jaux), (ty, taux) = _apply_both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)
    assert taux == pytest.approx(jaux, rel=1e-6)
    # a token whose every choice was dropped gets exactly 0
    dropped = ~within.view(T, k).any(dim=1)
    assert bool(dropped.any())
    assert float(np.abs(ty.reshape(T, -1)[dropped.numpy()]).max()) == 0.0


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_dispatch_ranks_match_reference(dispatch):
    """dest and within, choice by choice, against the reference's own
    dispatch function, on expert ids with heavy repeats."""
    rng = np.random.default_rng(2)
    E, C = 8, 5
    top_idx = rng.integers(0, E, size=(40, 3)).astype(np.int32)
    j = (jmoe._dispatch_sort if dispatch == "sort" else jmoe._dispatch_onehot)(
        jnp.asarray(top_idx), E, C)
    t = (tmoe._dispatch_sort if dispatch == "sort" else tmoe._dispatch_onehot)(
        torch.from_numpy(top_idx).long(), E, C)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_top_k_ties_take_the_lower_expert(tie):
    """``jax.lax.top_k`` takes the lower index first among equal gates;
    so does the port (a stable descending sort), choice for choice."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", n_experts=6, top_k=2)
    p = _layer(jcfg, seed=2)
    if tie == "all":  # every gate 1/E: experts 0 and 1
        p["router"] = np.zeros_like(p["router"])
    else:  # experts 2 and 4 always tie, and lead
        p["router"] = np.zeros_like(p["router"])
        col = np.abs(np.random.default_rng(3).normal(size=jcfg.d_model))
        p["router"][:, 2] = p["router"][:, 4] = col.astype(np.float32)
    x = np.abs(np.random.default_rng(4).normal(
        size=(2, 4, jcfg.d_model))).astype(np.float32)
    gates = jax.nn.softmax(jnp.asarray(x.reshape(8, -1)) @ p["router"], axis=-1)
    want = np.asarray(jax.lax.top_k(gates, 2)[1])
    assert (want == ([0, 1] if tie == "all" else [2, 4])).all()
    tg = torch.softmax(torch.from_numpy(x.reshape(8, -1))
                       @ torch.from_numpy(p["router"]), dim=-1)
    got = torch.sort(tg, dim=-1, descending=True, stable=True)[1][:, :2]
    np.testing.assert_array_equal(got.numpy(), want)
    (jy, _), (ty, _) = _apply_both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)


def test_capacity_matches_reference():
    for arch in ARCHS + ["jamba-v0.1-52b"]:
        for T in (1, 8, 100, 4096, 65536):
            for cf in (0.1, 1.25, 2.0):
                jcfg = dataclasses.replace(j_get_config(arch), capacity_factor=cf)
                tcfg = dataclasses.replace(t_get_config(arch), capacity_factor=cf)
                assert tmoe.moe_capacity(tcfg, T) == jmoe.moe_capacity(jcfg, T)


# ------------------------------------------------------------------ decode
@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """The smoke config's weights, initialised by the reference."""
    jcfg, tcfg = j_smoke(request.param), t_smoke(request.param)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, _numpy_tree(jp), "cpu")


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_decode_matches_reference(carried, dispatch):
    """16 greedy decode steps from zero tokens at B=8: logits within 1e-4
    at every step, identical tokens; K5's wrapper ran on the CPU and
    launched nothing."""
    jcfg, tcfg, jp, tp = carried
    jcfg = dataclasses.replace(jcfg, moe_dispatch=dispatch)
    tcfg = dataclasses.replace(tcfg, moe_dispatch=dispatch)
    assert "moe" in tp["layers"] and "mlp" not in tp["layers"]
    B, S = 8, 64
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jcache = JR.make_cache(jcfg, B, S)
    tcache = TR.make_cache(tcfg, B, S, device="cpu")
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    before = gkernel.LAUNCHES["grouped_matmul"]
    seen = set()
    for _ in range(16):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        seen.add(int(tt[0, 0]))
    assert tcache["pos"] == int(jcache["pos"]) == 16
    assert len(seen) > 1  # the greedy path does move
    assert gkernel.LAUNCHES["grouped_matmul"] == before


def test_moonshot_full_config_shapes_match_reference():
    """moonshot-v1-16b-a3b at full size, shapes only: the reference's
    abstract init and the port's meta init give the same tree, 28.06 G
    parameters (56.1 GB in bf16: it fits on one 80 GB card)."""
    arch = "moonshot-v1-16b-a3b"
    jshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        JR.init_params(j_get_config(arch), mode="abstract"))
    tparams = TR.init_params(t_get_config(arch), device="meta")
    tshapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        tparams)
    assert tshapes == jshapes
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(tparams))
    assert n == pytest.approx(28.06e9, rel=1e-3)
    assert tparams["layers"]["moe"]["wg"].shape == (48, 64, 2048, 1408)


def _summary_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  ")]


def test_launcher_serves_moe_with_the_references_summary(capsys, monkeypatch):
    arch = "moonshot-v1-16b-a3b"
    args = ["--arch", arch, "--requests", "6"]
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--no-decode"])
    j_serve.main()
    want = _summary_lines(capsys.readouterr().out)
    before = gkernel.LAUNCHES["grouped_matmul"]
    t_serve.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert _summary_lines(out) == want and len(want) > 10
    assert "decode: 6 calls, 96 steps" in out
    assert gkernel.LAUNCHES["grouped_matmul"] == before


# ------------------------------------------------------------------ K5's tiles
@pytest.mark.parametrize("case", ["decode", "overflow"])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_expert_tiles_count_the_buffers_real_rows(case, dispatch,
                                                  monkeypatch):
    """The ``tile_rows`` the MoE layer hands K5 are the rows of each tile of
    its expert buffer that hold a token: exactly the leading nonzero rows
    (random x), at decode with experts that get no token and with experts
    past their capacity; ``tile_gid`` is each tile's expert.  The three
    expert products share both, and the layer still equals the reference."""
    if case == "decode":  # 16 choices over 16 experts: some get none
        kw, shape = dict(n_experts=16), (8, 1)
    else:  # ~512 choices an expert for C = 256 slots
        kw, shape = dict(capacity_factor=0.1), (4, 256)
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", moe_dispatch=dispatch, **kw)
    p = _layer(jcfg, seed=3)
    x = np.random.default_rng(5).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    calls = []

    def spy(h, tile_gid, w, bt, tile_rows):
        calls.append((h, tile_gid, bt, tile_rows))
        return gkernel.grouped_matmul_fn(h, tile_gid, w, bt, tile_rows)

    monkeypatch.setattr(tmoe, "grouped_matmul_fn", spy)
    (jy, _), (ty, _) = _apply_both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)
    assert len(calls) == 3
    xe, tile_gid, bt, tile_rows = calls[0]
    assert all(c[1] is tile_gid and c[3] is tile_rows for c in calls)
    E, T = tcfg.n_experts, shape[0] * shape[1]
    C = tmoe.moe_capacity(tcfg, T)
    assert bt == tmoe.EXPERT_BT and xe.shape[0] == E * C
    assert tile_gid.dtype == tile_rows.dtype == torch.int32
    np.testing.assert_array_equal(tile_gid.numpy(),
                                  np.arange(E * C // bt) // (C // bt))
    nonzero = (xe != 0).any(dim=1).view(-1, bt)
    leading = torch.arange(bt)[None, :] < tile_rows[:, None]
    assert torch.equal(nonzero, leading)
    per_expert = tile_rows.view(E, -1).sum(dim=1)
    if case == "decode":
        assert (per_expert == 0).any() and (per_expert > 0).any()
    else:
        assert (per_expert == C).any()
