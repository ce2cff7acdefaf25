"""The port's full-sequence (prefill) path held against the JAX reference.

Weights are the reference's own, initialised by ``repro`` and carried into
the port through numpy (``models.convert.params_from_numpy``, bit for
bit); tokens, patches and activations are made with numpy from a seed.
Both packages run their plain paths (the reference's prefill attention and
Mamba scan are plain ``jnp``; no Pallas kernel computes them).
Tolerances, in float32 at the smoke configs:

* one layer's ``attn_full`` (causal, windowed, prefix-LM, non-causal,
  GQA): rtol 2e-5 and atol 2e-5 of the largest reference value, as for
  ``attn_decode`` (``tests/test_torch_serving.py``): the scores reach
  ~100 at these init scales, so a one-ulp difference in q or k moves the
  softmax weights by ~1e-5 relative.  Measured: up to 6.4e-5 on outputs of
  magnitude 55 (MQA with a prefix), 1.3e-5 without GQA;
* the whole model's logits (``lm_forward``, ``forward_fn``): 1e-4, as for
  the decode (logits below 1).  Measured: up to 2.7e-5 (seamless),
  1.2e-5 (jamba, 8 layers), 5.6e-7 to 1.4e-5 for the others;
* ``make_prefill_step``'s tokens: equal;
* a decode over the prompt against the forward's last position (the
  reference's ``test_decode_matches_prefill_tail``), port only: 1e-4;
  measured 4.0e-7 at most.

The launcher's ``--device cpu`` summary for each family this slice adds
equals the reference launcher's (the virtual clock decides the schedule).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as jlm  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro.training.train_step import make_prefill_step as j_prefill  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as tlm  # noqa: E402
from repro_torch.models.common import ParamFactory as TFactory  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training.train_step import make_prefill_step as t_prefill  # noqa: E402

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4
NEW_FAMILIES = ["falcon-mamba-7b", "jamba-v0.1-52b", "seamless-m4t-large-v2",
                "paligemma-3b"]
B, S = 2, 16


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


def batch_for(cfg, rng, b=B, s=S):
    """The reference's prefill batch keys, as numpy arrays."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "dec_tokens": toks}
    if cfg.family == "vlm":
        return {"patches": rng.normal(
                    size=(b, cfg.n_prefix, cfg.d_model)).astype(np.float32),
                "tokens": toks}
    return {"tokens": toks}


@pytest.fixture(scope="module")
def carried():
    """arch -> (jcfg, tcfg, reference params, carried port params), each
    arch's smoke config initialised once by the reference."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = j_smoke(arch), t_smoke(arch)
            jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
            cache[arch] = (jcfg, tcfg, jp,
                           params_from_numpy(tcfg, _numpy_tree(jp), "cpu"))
        return cache[arch]

    return get


# ------------------------------------------------------------------ attn_full
ATTN_VARIANTS = {
    "causal": dict(kw={}, cfg={}),
    "window": dict(kw={"window": 6}, cfg={}),
    "prefix": dict(kw={"prefix_len": 5}, cfg={}),
    "non_causal": dict(kw={"causal": False}, cfg={}),
    "gqa": dict(kw={}, cfg={"n_kv_heads": 2}),
    "mqa_prefix": dict(kw={"prefix_len": 7}, cfg={"n_kv_heads": 1}),
}


@pytest.mark.parametrize("variant", list(ATTN_VARIANTS))
def test_attn_full_matches_reference(variant):
    """One attention layer over 20 positions with carried weights (and
    random QKV biases), under each mask the reference builds."""
    v = ATTN_VARIANTS[variant]
    jcfg = dataclasses.replace(j_smoke("codeqwen1.5-7b"), **v["cfg"])
    tcfg = dataclasses.replace(t_smoke("codeqwen1.5-7b"), **v["cfg"])
    assert jcfg.qkv_bias
    rng = np.random.default_rng(21)
    p = _numpy_tree(jattn.init_attention(
        jcfg, JFactory(jax.random.PRNGKey(5), jnp.float32)))
    for b in ("bq", "bk", "bv"):
        p[b] = rng.normal(size=p[b].shape).astype(np.float32)
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    x = rng.normal(size=(3, 20, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jattn.attn_full(jcfg, p, jnp.asarray(x),
                                      jnp.arange(20, dtype=jnp.int32),
                                      **v["kw"]))
    got = tattn.attn_full(tcfg, tp, torch.from_numpy(x),
                          torch.arange(20, dtype=torch.int32), **v["kw"])
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL * float(np.abs(want).max()))


def test_attn_full_masks_differ():
    """The masks are live: each variant's output differs from the causal
    one where the mask says it should (a prefix reaches later keys only
    inside the prefix; a window cuts the far past)."""
    tcfg = t_smoke("codeqwen1.5-7b")
    p = tattn.init_attention(
        tcfg, TFactory(torch.Generator().manual_seed(2), torch.float32))
    x = torch.randn(2, 12, tcfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    pos = torch.arange(12, dtype=torch.int32)
    causal = tattn.attn_full(tcfg, p, x, pos)
    prefix = tattn.attn_full(tcfg, p, x, pos, prefix_len=4)
    window = tattn.attn_full(tcfg, p, x, pos, window=3)
    assert not torch.equal(prefix[:, :3], causal[:, :3])
    assert torch.equal(prefix[:, 4:], causal[:, 4:])
    assert torch.equal(window[:, :3], causal[:, :3])
    assert not torch.equal(window[:, 3:], causal[:, 3:])


# ------------------------------------------------------------------ lm_forward
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "moonshot-v1-16b-a3b",
                                  "falcon-mamba-7b", "paligemma-3b"],
                         ids=["dense", "moe", "ssm", "vlm"])
def test_lm_forward_matches_reference(carried, arch):
    """Logits and the load-balance aux loss of ``lm_forward``; with
    ``return_hidden``, the state the logits are unembedded from."""
    jcfg, tcfg, jp, tp = carried(arch)
    b = batch_for(jcfg, np.random.default_rng(31))
    pe = b.get("patches")
    jl, jaux = jax.jit(lambda p, t, e: jlm.lm_forward(jcfg, p, t, e))(
        jp, jnp.asarray(b["tokens"]), None if pe is None else jnp.asarray(pe))
    tpe = None if pe is None else torch.from_numpy(pe)
    tl, taux = tlm.lm_forward(tcfg, tp, torch.from_numpy(b["tokens"]), tpe)
    P = 0 if pe is None else pe.shape[1]
    assert tl.shape == (B, P + S, jl.shape[-1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)
    if tcfg.n_experts:
        assert float(taux) > 0
    th, haux = tlm.lm_forward(tcfg, tp, torch.from_numpy(b["tokens"]), tpe,
                              return_hidden=True)
    table = tp["embed"] if tcfg.tie_embeddings else tp["unembed"]
    assert torch.equal(haux, taux)
    assert torch.equal(torch.einsum("bsd,vd->bsv", th, table), tl)


def test_vlm_forward_needs_its_prefix(carried):
    _, tcfg, _, tp = carried("paligemma-3b")
    with pytest.raises(ValueError, match="prefix_embeds"):
        tlm.lm_forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.int32))


# ------------------------------------------------------------------ every arch
@pytest.mark.parametrize("arch", list_archs())
def test_prefill_step_matches_reference(carried, arch):
    """``forward_fn`` logits within 1e-4 and ``make_prefill_step``'s
    greedy tokens equal, for every arch of the registry."""
    jcfg, tcfg, jp, tp = carried(arch)
    b = batch_for(jcfg, np.random.default_rng(41))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jl, jt = jax.jit(lambda p, b: (JR.forward_fn(jcfg)(p, b),
                                   j_prefill(jcfg)(p, b)))(jp, jb)
    tl = TR.forward_fn(tcfg)(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    tt = t_prefill(tcfg)(tp, tb)
    assert tt.dtype == torch.int32 and tt.shape == (B,)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if j_smoke(a).family not in ("encdec", "vlm")])
def test_decode_matches_prefill_tail(carried, arch):
    """The port's greedy decode over 8 prompt tokens gives the logits of
    its full forward's last position (cache correctness), for the
    token-only families: the reference's own test, on the port."""
    _, tcfg, _, tp = carried(arch)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, 8)).astype(np.int32))
    full = TR.forward_fn(tcfg)(tp, {"tokens": toks})
    cache = TR.make_cache(tcfg, B, 16, device="cpu")
    step = TR.decode_fn(tcfg, 16)
    for t in range(8):
        logits, cache = step(tp, toks[:, t:t + 1], cache)
    assert cache["pos"] == 8
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_trees_carry_bit_for_bit(arch):
    """bf16 weights of the new families' trees (``vision_proj``,
    ``frontend_proj``, ``periods/layer{i}``, the SSM's f32 constants)
    arrive bit for bit, each leaf in the reference's dtype."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(t_smoke(arch), dtype="bfloat16")
    jp = _numpy_tree(JR.init_params(jcfg, jax.random.PRNGKey(7)))
    tp = params_from_numpy(tcfg, jp, "cpu")
    flat = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert set(got) == set(flat)
    for key, want in flat.items():
        t = got[key]
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), key
        bits = np.int16 if want.dtype.itemsize == 2 else np.int32
        np.testing.assert_array_equal(
            t.view(torch.int16 if bits is np.int16 else torch.int32).numpy(),
            want.view(bits), err_msg=key)
    assert any(t.dtype == torch.float32 for t in got.values()) == (
        tcfg.family in ("ssm", "hybrid"))
    bad = dict(jp)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tcfg, bad, "cpu")


# ------------------------------------------------------------------ launcher
def _summary_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  ")]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_launcher_summary_matches_reference(capsys, monkeypatch, arch):
    """The port's launcher decodes each new family on the CPU (smoke
    config) and prints the reference launcher's engine summary."""
    args = ["--arch", arch, "--requests", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--no-decode"])
    j_serve.main()
    want = _summary_lines(capsys.readouterr().out)
    before = pkernel.LAUNCHES["paged_attention"]
    t_serve.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert _summary_lines(out) == want and len(want) > 10
    assert "decode: 4 calls, 64 steps" in out
    assert pkernel.LAUNCHES["paged_attention"] == before
