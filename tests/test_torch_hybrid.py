"""The port's Jamba-style hybrid (Mamba + attention + MoE) against the reference.

Weights are the reference's own (``repro.models.hybrid.init_hybrid`` at
the jamba smoke config: 8 layers in two periods of 4, attention at offset
2, experts on the odd layers), carried into the port through numpy bit for
bit; tokens are made with numpy from a seed.  Both packages run their
plain paths; the port's expert products go through K5's wrapper and its
decode attention through K4's, which on the CPU run their plain versions.
Tolerances, in float32:

* ``hybrid_forward``'s logits: 1e-4, as for the other families (logits
  below 1; measured 9.8e-6); its load-balance aux loss: rtol 1e-5;
* 16 greedy decode steps over the two periods: logits 1e-4 at every step
  and identical tokens; the caches (K/V at ``[p]``, conv tails and f32
  states at ``[p, mi]``), written in place, within rtol 2e-5 and atol 2e-5
  of their largest value (as one layer's decode, ``test_torch_ssm.py``;
  measured 1.7e-4 on states of magnitude 14.5);
* bf16, one step: ``BF16_LOGIT_TOL`` = 2e-2, as for the dense family
  (measured 1.03e-2).  Only one: in bf16 the 8 layers' roundings compound
  through the Mamba states from step to step, and the reference's own
  jitted and eager runs drift apart as fast as the port and the reference
  do (logits 1.0e-2, 3.5e-2, 4.5e-2, 8.2e-2 apart over four steps).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as gkernel  # noqa: E402
from repro_torch.models import hybrid as thyb  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "jamba-v0.1-52b"
STATE_TOL = 2e-5
LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 2e-2


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=STATE_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, _numpy_tree(jp), "cpu")


def test_smoke_config_has_two_periods_of_each_kind(carried):
    _, tcfg, _, tp = carried
    assert tcfg.n_layers // tcfg.attn_period == 2 and tcfg.attn_period == 4
    layers = tp["periods"]
    assert sorted(layers) == [f"layer{i}" for i in range(4)]
    assert "attn" in layers["layer2"] and "mixer" in layers["layer1"]
    assert "moe" in layers["layer1"] and "mlp" in layers["layer2"]
    assert layers["layer0"]["mixer"]["in_proj"].shape[0] == 2  # P = 2


def test_hybrid_forward_matches_reference(carried):
    jcfg, tcfg, jp, tp = carried
    toks = np.random.default_rng(51).integers(0, jcfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jhyb.hybrid_forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    tl, taux = thyb.hybrid_forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0
    th, _ = thyb.hybrid_forward(tcfg, tp, torch.from_numpy(toks),
                                return_hidden=True)
    assert torch.equal(torch.einsum("bsd,vd->bsv", th, tp["unembed"]), tl)


def test_hybrid_cache_matches_reference(carried):
    jcfg, tcfg, _, _ = carried
    want = JR.make_cache(jcfg, 8, 64)
    got = TR.make_cache(tcfg, 8, 64, device="cpu")
    assert set(got) == set(want)
    for k in ("k", "v", "conv", "h"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
    assert got["conv"].shape[:2] == (2, 3)  # [p, mi]: 2 periods, 3 mixers


def test_hybrid_decode_matches_reference(carried):
    """16 greedy steps from zero tokens at B=8 over the two periods:
    logits, tokens, and every cache slot [p] / [p, mi], written in place;
    each slot of the Mamba states is touched.  On the CPU K5's wrapper
    runs its plain version and counts no launch."""
    jcfg, tcfg, jp, tp = carried
    B, S = 8, 64
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jcache = JR.make_cache(jcfg, B, S)
    tcache = TR.make_cache(tcfg, B, S, device="cpu")
    held = {k: tcache[k] for k in ("k", "v", "conv", "h")}
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    before = gkernel.LAUNCHES["grouped_matmul"]
    for _ in range(16):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert gkernel.LAUNCHES["grouped_matmul"] == before  # the CPU: plain
    assert tcache["pos"] == int(jcache["pos"]) == 16
    for k, t in held.items():
        assert tcache[k] is t
        _close(t, jcache[k])
    P, M = held["h"].shape[:2]
    for p in range(P):
        for mi in range(M):  # each mixer wrote its own state
            assert held["h"][p, mi].abs().sum() > 0
            assert not torch.equal(held["h"][p, mi],
                                   held["h"][(p + 1) % P, (mi + 1) % M])


def test_hybrid_bf16_step_matches_reference():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    jp = JR.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    tok = np.array([[0], [5], [17], [300]], np.int32)
    jstep = jax.jit(JR.decode_fn(jcfg, 32))
    jcache = JR.make_cache(jcfg, 4, 32)
    tcache = TR.make_cache(tcfg, 4, 32, device="cpu")
    jl, _ = jstep(jp, jnp.asarray(tok), jcache)
    tl, _ = TR.decode_fn(tcfg, 32)(tp, torch.from_numpy(tok), tcache)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=BF16_LOGIT_TOL)


def test_periods_must_be_whole():
    cfg = dataclasses.replace(t_smoke(ARCH), n_layers=6)
    with pytest.raises(ValueError, match="whole"):
        TR.init_params(cfg, device="meta")
