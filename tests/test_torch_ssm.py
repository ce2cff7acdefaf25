"""The port's Mamba-1 block and the SSM family held against the JAX reference.

Weights are the reference's own (``repro.models.ssm.init_mamba``, or the
whole falcon-mamba smoke model), carried into the port through numpy bit
for bit; activations and tokens are made with numpy from a seed.  Both
packages run their plain paths: the reference's selective scan is
``jax.lax.scan`` over time in plain ``jnp``, the port's a Python loop in
the same order.  Tolerances, in float32:

* one block's ``mamba_full`` over 24 positions, and 24 ``mamba_decode``
  steps (outputs, conv tails and f32 states): rtol 2e-5 and atol 2e-5 of
  the largest reference value.  The scan sums up to 24 decayed terms a
  state and the two packages round the projections' sums in their own
  orders.  Measured: 3.3e-6 on outputs of magnitude 7.1 (the full
  block), 1.9e-6 on states of magnitude 11.8 (decode);
* the whole model's logits over 16 greedy decode steps: 1e-4, as for the
  dense family (``tests/test_torch_serving.py``), with identical tokens;
  measured 2.2e-6 (logits and final states);
* bf16, two steps: ``BF16_LOGIT_TOL`` = 2e-2, as for the dense family;
  measured 7.8e-3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import ParamFactory as TFactory  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "falcon-mamba-7b"
BLOCK_TOL = 2e-5
LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 2e-2


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=BLOCK_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def block():
    """One Mamba block's weights, made by the reference, with a non-zero
    conv bias and per-channel ``dt_bias``/``A_log``/``D`` (the init makes
    them constants), so every term of the block is exercised."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    rng = np.random.default_rng(5)
    p = _numpy_tree(jssm.init_mamba(jcfg, JFactory(jax.random.PRNGKey(2),
                                                   jnp.float32)))
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2, 0.5, p["dt_bias"].shape).astype(np.float32)
    p["A_log"] = rng.uniform(-1, 1.5, p["A_log"].shape).astype(np.float32)
    p["D"] = rng.normal(size=p["D"].shape).astype(np.float32)
    return jcfg, tcfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def test_init_mamba_matches_reference_tree():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    want = _numpy_tree(jssm.init_mamba(jcfg, JFactory(jax.random.PRNGKey(0),
                                                      jnp.float32), layers=3))
    got = tssm.init_mamba(tcfg, TFactory(torch.Generator().manual_seed(0),
                                         torch.float32), layers=3)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
    for k in ("dt_bias", "A_log", "D"):  # f32 constants, equal
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert not got["conv_b"].any()


def test_mamba_full_matches_reference(block):
    jcfg, tcfg, p, tp = block
    x = np.random.default_rng(6).normal(size=(3, 24, jcfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jssm.mamba_full(jcfg, p, x))(p, jnp.asarray(x))
    _close(tssm.mamba_full(tcfg, tp, torch.from_numpy(x)), want)


def test_mamba_decode_matches_reference_in_place(block):
    """24 steps: outputs, the conv tail and the f32 state, each step; the
    port writes the states it was given."""
    jcfg, tcfg, p, tp = block
    B = 3
    cs, hs = tssm.mamba_state_shapes(tcfg, B)
    assert (cs, hs) == jssm.mamba_state_shapes(jcfg, B)
    jconv, jh = jnp.zeros(cs, jnp.float32), jnp.zeros(hs, jnp.float32)
    tconv, th = torch.zeros(cs), torch.zeros(hs, dtype=torch.float32)
    jstep = jax.jit(lambda p, x, c, h: jssm.mamba_decode(jcfg, p, x, c, h))
    rng = np.random.default_rng(7)
    for _ in range(24):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jo, jconv, jh = jstep(p, jnp.asarray(x), jconv, jh)
        to, c2, h2 = tssm.mamba_decode(tcfg, tp, torch.from_numpy(x), tconv, th)
        assert c2 is tconv and h2 is th
        for got, want in ((to, jo), (tconv, jconv), (th, jh)):
            _close(got, want)


def test_mamba_decode_continues_the_full_scan(block):
    """Port only: decoding a sequence token by token from zero states gives
    the full-sequence block's output at every position."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 12, tcfg.d_model)).astype(np.float32))
    full = tssm.mamba_full(tcfg, tp, x)
    cs, hs = tssm.mamba_state_shapes(tcfg, 2)
    conv, h = torch.zeros(cs), torch.zeros(hs)
    for t in range(12):
        out, _, _ = tssm.mamba_decode(tcfg, tp, x[:, t:t + 1], conv, h)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


# ------------------------------------------------------------------ the family
@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, _numpy_tree(jp), "cpu")


def test_ssm_cache_matches_reference(carried):
    jcfg, tcfg, _, _ = carried
    want = JR.make_cache(jcfg, 8, 64)
    got = TR.make_cache(tcfg, 8, 64, device="cpu")
    assert set(got) == set(want) == {"conv", "h", "pos"}
    for k in ("conv", "h"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()
    assert got["h"].dtype == torch.float32 and got["pos"] == 0


def test_ssm_decode_matches_reference(carried):
    """16 greedy decode steps from zero tokens at B=8: logits within 1e-4
    at every step, identical tokens, the states written in place and equal
    to the reference's."""
    jcfg, tcfg, jp, tp = carried
    B, S = 8, 64
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jcache = JR.make_cache(jcfg, B, S)
    tcache = TR.make_cache(tcfg, B, S, device="cpu")
    conv, h = tcache["conv"], tcache["h"]
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
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
    assert len(seen) > 1
    assert tcache["conv"] is conv and tcache["h"] is h
    assert tcache["pos"] == int(jcache["pos"]) == 16
    _close(conv, jcache["conv"])
    _close(h, jcache["h"])


def test_ssm_bf16_step_matches_reference():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    jp = JR.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    assert tp["layers"]["mixer"]["A_log"].dtype == torch.float32
    tok = np.array([[0], [5], [17], [300]], np.int32)
    jcache, tcache = JR.make_cache(jcfg, 4, 32), TR.make_cache(tcfg, 4, 32,
                                                               device="cpu")
    assert tcache["conv"].dtype == torch.bfloat16
    for _ in range(2):
        jl, jcache = JR.decode_fn(jcfg, 32)(jp, jnp.asarray(tok), jcache)
        tl, tcache = TR.decode_fn(tcfg, 32)(tp, torch.from_numpy(tok), tcache)
        assert tl.dtype == torch.bfloat16
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), rtol=0,
                                   atol=BF16_LOGIT_TOL)
