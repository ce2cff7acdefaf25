"""The port's cross-attention and encoder-decoder held against the reference.

Weights are the reference's own (``repro.models.attention`` for one
cross-attention layer, ``repro.models.encdec`` at the seamless smoke
config), carried into the port through numpy bit for bit; frames, memory
and tokens are made with numpy from a seed.  The reference runs its plain
path (``jnp`` softmax attention); the port's ``cross_attn_decode`` goes
through K4's wrapper over a page view of the static cross K/V, which on
the CPU runs K4's plain version.  Tolerances, in float32:

* one layer's ``cross_attn_full`` / ``precompute_cross_kv`` /
  ``cross_attn_decode``: rtol 2e-5 and atol 2e-5 of the largest reference
  value, as for ``attn_decode`` (``tests/test_torch_serving.py``; the
  scores reach ~100 at these init scales); measured 1.6e-5 on outputs of
  magnitude 37;
* ``encdec_encode`` (memory), ``encdec_forward`` (logits) and
  ``prefill_cross_kv``: rtol 1e-4 and atol 1e-4 of the largest reference
  value, as the other families' logits; measured 1.1e-5 (memory and
  logits), 1.3e-4 on cross K/V of magnitude 16.7;
* 16 greedy decode steps after ``prefill_cross_kv`` has filled the
  cache's cross K/V: logits 1e-4 at every step and identical tokens, the
  self-attention K/V as one layer's (measured 3.1e-4 on K of magnitude
  14.7); and the launcher's own decode, on zero cross K/V, for 4 steps
  (measured 2.1e-7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "seamless-m4t-large-v2"
ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------------ one layer
@pytest.fixture(scope="module", params=["mha", "gqa_bias"])
def layer(request):
    """One cross-attention layer: seamless's heads (H = KV), or GQA with
    random QKV biases."""
    kw = {} if request.param == "mha" else {"n_kv_heads": 2, "qkv_bias": True}
    jcfg = dataclasses.replace(j_smoke(ARCH), **kw)
    tcfg = dataclasses.replace(t_smoke(ARCH), **kw)
    rng = np.random.default_rng(61)
    p = _numpy_tree(jattn.init_cross_attention(
        jcfg, JFactory(jax.random.PRNGKey(6), jnp.float32)))
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = rng.normal(size=p[b].shape).astype(np.float32)
    return jcfg, tcfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("enc_len", [16, 12])
def test_cross_attention_matches_reference(layer, enc_len):
    """The full layer over 10 decoder positions, the precomputed K/V and
    one decode token against them (K4's plain version over pages of
    gcd(enc_len, 16) slots: 16 and 4)."""
    jcfg, tcfg, p, tp = layer
    rng = np.random.default_rng(enc_len)
    x = rng.normal(size=(3, 10, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(3, enc_len, jcfg.d_model)).astype(np.float32)
    jx, jm, tx, tm = (jnp.asarray(x), jnp.asarray(mem), torch.from_numpy(x),
                      torch.from_numpy(mem))
    _close(tattn.cross_attn_full(tcfg, tp, tx, tm),
           jattn.cross_attn_full(jcfg, p, jx, jm), ATTN_TOL)
    jk, jv = jattn.precompute_cross_kv(jcfg, p, jm)
    tk, tv = tattn.precompute_cross_kv(tcfg, tp, tm)
    assert tk.is_contiguous() and tv.is_contiguous()
    _close(tk, jk, ATTN_TOL)
    _close(tv, jv, ATTN_TOL)
    for t in (0, 9):
        _close(tattn.cross_attn_decode(tcfg, tp, tx[:, t:t + 1], tk, tv),
               jattn.cross_attn_decode(jcfg, p, jx[:, t:t + 1], jk, jv),
               ATTN_TOL)


# ------------------------------------------------------------------ the family
@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, _numpy_tree(jp), "cpu")


def _frames(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def test_encode_and_forward_match_reference(carried):
    jcfg, tcfg, jp, tp = carried
    frames = _frames(jcfg, 2, 12, 71)
    toks = np.random.default_rng(72).integers(0, jcfg.vocab_size,
                                              (2, 9)).astype(np.int32)
    jmem = jax.jit(lambda p, f: jed.encdec_encode(jcfg, p, f))(
        jp, jnp.asarray(frames))
    _close(ted.encdec_encode(tcfg, tp, torch.from_numpy(frames)), jmem,
           LOGIT_TOL)
    jl = jax.jit(lambda p, f, t: jed.encdec_forward(jcfg, p, f, t))(
        jp, jnp.asarray(frames), jnp.asarray(toks))
    tl = ted.encdec_forward(tcfg, tp, torch.from_numpy(frames),
                            torch.from_numpy(toks))
    assert tl.shape == (2, 9, jl.shape[-1])
    _close(tl, jl, LOGIT_TOL)
    th = ted.encdec_forward(tcfg, tp, torch.from_numpy(frames),
                            torch.from_numpy(toks), return_hidden=True)
    assert torch.equal(torch.einsum("bsd,vd->bsv", th, tp["unembed"]), tl)


def test_prefill_cross_kv_matches_reference(carried):
    jcfg, tcfg, jp, tp = carried
    frames = _frames(jcfg, 2, 12, 73)
    jmem, jk, jv = jax.jit(lambda p, f: jed.prefill_cross_kv(jcfg, p, f))(
        jp, jnp.asarray(frames))
    tmem, tk, tv = ted.prefill_cross_kv(tcfg, tp, torch.from_numpy(frames))
    assert tk.shape == jk.shape == (jcfg.n_layers, 2, 12, jcfg.n_kv_heads,
                                    jcfg.head_dim)
    for got, want in ((tmem, jmem), (tk, jk), (tv, jv)):
        _close(got, want, LOGIT_TOL)


def test_decode_after_prefill_cross_kv_matches_reference(carried):
    """The cache's cross K/V filled by ``prefill_cross_kv`` from 16 frames
    (the port writes them into its cache in place), then 16 greedy
    decode steps at B=4: logits, tokens, the self-attention K/V."""
    jcfg, tcfg, jp, tp = carried
    B, S, T = 4, 32, 16
    frames = _frames(jcfg, B, T, 74)
    _, jk, jv = jed.prefill_cross_kv(jcfg, jp, jnp.asarray(frames))
    jcache = dict(JR.make_cache(jcfg, B, S, enc_len=T), cross_k=jk, cross_v=jv)
    tcache = TR.make_cache(tcfg, B, S, device="cpu", enc_len=T)
    _, tk, tv = ted.prefill_cross_kv(tcfg, tp, torch.from_numpy(frames))
    tcache["cross_k"].copy_(tk)
    tcache["cross_v"].copy_(tv)
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    k_held = tcache["k"]
    for _ in range(16):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        _close(tl, jl, LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tcache["k"] is k_held and tcache["pos"] == 16
    _close(k_held, jcache["k"], ATTN_TOL)


def test_launcher_decode_on_zero_cross_kv_matches_reference(carried):
    """The launcher's decode: a fresh cache of ``enc_len`` = 16 zero cross
    slots (K4 then averages zeros), 4 greedy steps at B=8."""
    jcfg, tcfg, jp, tp = carried
    B, S = 8, 64
    jcache = JR.make_cache(jcfg, B, S, enc_len=16)
    tcache = TR.make_cache(tcfg, B, S, device="cpu", enc_len=16)
    assert tcache["cross_k"].shape == jcache["cross_k"].shape
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(4):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        _close(tl, jl, LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
