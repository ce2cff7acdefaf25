"""The port's train step for the families beyond the dense and MoE ones,
held against the JAX reference on the CPU: the SSM (falcon-mamba), the
Jamba hybrid with its 8-bit AdamW, the encoder-decoder (seamless) and the
VLM (paligemma), each at its float32 smoke widths; and 8-bit AdamW over a
leaf that spans several of the update's chunks.

Weights are the reference's own, carried into the port through numpy
(``models.convert.params_from_numpy``); tokens come from
``TokenPipeline``, frames and patches are seeded normals in the
reference's batch keys.  The rules and tolerances are those of
``test_torch_train.test_train_step_matches_reference`` (its
``_steps_match_reference``): loss and grad norm within 1e-4 relative each
step, parameters within 8 lr, the 8-bit update's blown elements counted
and held under 1%; ``ZOO`` says where a family's case departs from them
and why (the encoder-decoder's grad norm within 1e-3; its and the
hybrid's steps each from the reference's parameters and state).  The hybrid runs at the cut the H100 trains (the chip
smoke's phase 16): periods of 2 layers, attention then Mamba with its
MoE, two periods.  The chunked 8-bit update is held to the reference's
one-pass update by ``_compare_state``'s rule: codes equal except at most
1 in 1,000 off by one, scales and parameters within 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.models.convert import state_to_numpy  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from test_torch_train import (  # noqa: E402
    FAMILIES, OPT_TOL, _cfgs, _compare_state, _leaves, _numpy_tree, _pick,
    _steps_match_reference, _to_torch,
)

# family -> (optimizer, config changes, _steps_match_reference's options)
ZOO = {
    "ssm": ("adamw", {}, {}),
    # Free-running, a few 8-bit codes one apart after step 2 (where v's
    # code rounds to 0 the update is m / eps) move step 3's grad norm by
    # more than 1e-3, while the port's step 3 from the reference's own
    # parameters and state matches it within 1e-4: so each step starts
    # from the reference's state.
    "hybrid": ("adamw8bit", dict(n_layers=4, attn_period=2, attn_offset=0),
               dict(forced=True)),
    # At the reference's init the encoder-decoder's attention softmaxes
    # are near one-hot, and their backward cancels digits of an f32
    # gradient: step 1's grad norms differ by more than 1e-4 (the port's
    # is the nearer to a float64 evaluation), and carried on through
    # AdamW the gap grows, so each step starts from the reference's state.
    "encdec": ("adamw", {}, dict(gn_tol=1e-3, forced=True)),
    "vlm": ("adamw", {}, {}),
}


@pytest.mark.parametrize("family", list(ZOO),
                         ids=[f"{f}-{o}" for f, (o, _, _) in ZOO.items()])
def test_zoo_train_step_matches_reference(family):
    """3 steps of ``make_train_step`` against the reference's jitted step;
    every parameter leaf moves."""
    opt, kw, rules = ZOO[family]
    jcfg, tcfg = _cfgs(FAMILIES[family], **kw)
    start, tp = _steps_match_reference(jcfg, tcfg, opt, **rules)
    still = [path for path, w in _leaves(start)
             if np.array_equal(_pick(tp, path).numpy(), w)]
    assert not still, still


def test_adamw8bit_over_chunks_matches_reference(monkeypatch):
    """3 8-bit AdamW updates with the update's chunk cut to 3 blocks of
    256: a leaf of 37 x 61 (2,257 elements, a partial last block, three
    chunks) and one smaller than a chunk; the parameters and every state
    leaf against the reference's one-pass update."""
    monkeypatch.setattr(topt, "_CHUNK", 3 * topt._QBLOCK)
    rng = np.random.default_rng(24)

    def tree(scale):
        return {"w": (rng.normal(size=(37, 61)) * scale).astype(np.float32),
                "b": (rng.normal(size=(300,)) * scale).astype(np.float32)}

    params, grads = tree(1.0), [tree(10.0 ** -k) for k in range(3)]
    jo = jopt.make_optimizer("adamw8bit", lr=1e-2)
    to = topt.make_optimizer("adamw8bit", lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        jp, js, jm = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(_to_torch(g), ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=OPT_TOL)
        for path, w in _leaves(_numpy_tree(jp)):
            np.testing.assert_allclose(_pick(tp, path).numpy(), w,
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=f"step {i}: {path}")
        _compare_state(state_to_numpy(ts), _numpy_tree(js), f"step {i}")


def test_float64_evaluation_restores_float32():
    """``benchmarks.grad_conditioning.float64`` turns ``Tensor.float`` and
    every config's activation dtype to float64 only while it runs: a leak
    would run every later model in the process in double."""
    from repro_torch.benchmarks import grad_conditioning as gc
    from repro_torch.configs import base, smoke_config

    cfg = smoke_config("seamless-m4t-large-v2")
    saved = torch.Tensor.float, base.ModelConfig.activation_dtype
    with gc.float64():
        assert torch.ones(2).float().dtype == torch.float64
        assert cfg.activation_dtype == torch.float64
    assert (torch.Tensor.float, base.ModelConfig.activation_dtype) == saved
    assert torch.ones(2, dtype=torch.float64).float().dtype == torch.float32
    assert cfg.activation_dtype == torch.float32
    cut = gc.cut_of(cfg)
    assert (cut.n_layers, cut.n_enc_layers, cut.dtype) == (2, 2, "float32")
    assert set(gc.batch_of(cut)) == {"frames", "dec_tokens", "labels"}
