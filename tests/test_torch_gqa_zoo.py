"""The four largest published configs' attention grouping held against the
JAX reference on the CPU: mixtral-8x22b (48 query heads on 8 KV heads,
G = 6), qwen1.5-110b (64 on 8, G = 8), mistral-large-123b (96 on 8, G =
12) and nemotron-4-340b (96 on 8, G = 12, head_dim 192).

The smoke configs give every arch 4 heads of 16 on at most 4 KV heads, so
at smoke size these configs run as MHA.  Here each is a variant of its
smoke config (``dataclasses.replace``, the same in both packages; the
vocabulary of 500 of ``tests/test_torch_train.py``'s configs) that
keeps its published grouping and head_dim: n_heads = 2 G on n_kv_heads =
2, head_dim 128 or 192; mixtral also keeps its 8 experts, top-2, and its
smoke window of 16.  Weights are the reference's, initialised by ``repro``
and carried through numpy (``models.convert.params_from_numpy``); tokens,
K/V and attention inputs are made with numpy from a seed.  Tolerances,
in float32:

* ``forward_fn``'s logits within 1e-4 and ``make_prefill_step``'s tokens
  equal (``tests/test_torch_prefill.py``'s);
* 16 greedy decode steps from a cache holding seeded K/V below position
  8, every step's logits within 1e-4 and the tokens equal
  (``tests/test_torch_serving.py``'s); mixtral's cache of 32 slots is a
  ring of its 16-slot window, so its steps wrap at position 16;
* K4's plain versions (``paged_attention_ref`` and the kernel's split
  arithmetic, ``paged_attention_splits_ref``) at (H, KV, D) = (12, 2, 128),
  (16, 2, 128), (24, 2, 128) and (24, 2, 192) against the reference's
  Pallas kernel in interpret mode and its jnp oracle: 2e-5 in float32 and
  5e-2 in bfloat16 (``tests/test_torch_paged_attention.py``'s);
* mixtral's loss and every gradient leaf against ``jax.value_and_grad``
  (1e-5 relative; 1e-3 of each leaf's largest value), and
  ``make_train_step`` with ``adamw8bit`` against the reference's jitted
  step (``tests/test_torch_train.py``'s tolerances and rule for 8-bit
  AdamW's chaotic elements).
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
from repro.training.train_step import make_prefill_step as j_prefill  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training.train_step import make_prefill_step as t_prefill  # noqa: E402
from test_torch_paged_attention import (  # noqa: E402
    BF16_TOL, F32_TOL, _jax_out, _paged_inputs, _port_out, _splits_out,
)
from test_torch_train import (  # noqa: E402
    LOSS_TOL, _batch, _cfgs, _check_grads, _numpy_tree, _port_grads,
    _steps_match_reference,
)

LOGIT_TOL = 1e-4
ARCHS = ["mixtral-8x22b", "qwen1.5-110b", "mistral-large-123b",
         "nemotron-4-340b"]
B, S = 2, 16  # prefill prompts, tokens
DECODE_B, MAX_SEQ, START, STEPS = 4, 32, 8, 16


def _variant(cfg, arch):
    """``cfg`` (a smoke config of ``arch``) with the published config's
    grouping and head_dim on 2 KV heads, and its experts and top-k."""
    full = t_get_config(arch)
    kw = dict(n_heads=2 * (full.n_heads // full.n_kv_heads), n_kv_heads=2,
              head_dim=full.head_dim)
    if full.n_experts:
        kw.update(n_experts=full.n_experts, top_k=full.top_k)
    return dataclasses.replace(cfg, **kw)


def _pair(arch):
    """``arch``'s variant in the reference and the port."""
    return tuple(_variant(cfg, arch) for cfg in _cfgs(arch))


def _init(jcfg):
    """The reference's ``init_params`` from key 0, jitted (eagerly it
    dispatches each draw: seconds at 8 experts)."""
    return jax.jit(JR.init_params, static_argnums=0)(jcfg,
                                                      jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def carried():
    """arch -> (jcfg, tcfg, reference params, carried port params), each
    variant initialised once by the reference for all its tests."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = _pair(arch)
            jp = _init(jcfg)
            cache[arch] = (jcfg, tcfg, jp,
                           params_from_numpy(tcfg, _numpy_tree(jp), "cpu"))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_variants_keep_the_published_grouping(arch):
    full = t_get_config(arch)
    tcfg = _variant(t_smoke(arch), arch)
    assert tcfg.n_heads // tcfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert tcfg.head_dim == full.head_dim and tcfg.n_kv_heads == 2
    assert (tcfg.n_experts, tcfg.top_k) == (full.n_experts, full.top_k)
    assert dataclasses.asdict(_variant(j_smoke(arch), arch)) == \
        dataclasses.asdict(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(carried, arch):
    """``forward_fn``'s logits at B prompts of S tokens within 1e-4, and
    ``make_prefill_step``'s greedy tokens equal."""
    jcfg, tcfg, jp, tp = carried(arch)
    toks = np.random.default_rng(41).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl = jax.jit(JR.forward_fn(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    tl = TR.forward_fn(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jt = j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    tt = t_prefill(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(carried, arch):
    """STEPS greedy decode steps from a cache holding seeded K/V below
    position START: every step's logits within 1e-4 and the same tokens;
    the caches' K/V equal at the end.  Mixtral's cache is a ring of its
    window, and its steps wrap."""
    jcfg, tcfg, jp, tp = carried(arch)
    layout = tattn.cache_layout(tcfg, MAX_SEQ)
    if tcfg.sliding_window:
        assert layout == (16, True) and START + STEPS > layout.seq
    else:
        assert layout == (MAX_SEQ, False)
    rng = np.random.default_rng(42)
    shape = (tcfg.n_layers, DECODE_B, layout.seq, tcfg.n_kv_heads,
             tcfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jcache = dict(JR.make_cache(jcfg, DECODE_B, MAX_SEQ), k=jnp.asarray(k),
                  v=jnp.asarray(v), pos=jnp.int32(START))
    tcache = TR.make_cache(tcfg, DECODE_B, MAX_SEQ, device="cpu")
    tcache["k"].copy_(torch.from_numpy(k))
    tcache["v"].copy_(torch.from_numpy(v))
    tcache["pos"] = START
    jstep = jax.jit(JR.decode_fn(jcfg, MAX_SEQ))
    tstep = TR.decode_fn(tcfg, MAX_SEQ)
    jt = jnp.zeros((DECODE_B, 1), jnp.int32)
    tt = torch.zeros((DECODE_B, 1), dtype=torch.int32)
    before = dict(pkernel.LAUNCHES)
    for _ in range(STEPS):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tcache["pos"] == int(jcache["pos"]) == START + STEPS
    for name in ("k", "v"):
        want = np.asarray(jcache[name])
        np.testing.assert_allclose(tcache[name].numpy(), want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * float(np.abs(want).max()))
    assert pkernel.LAUNCHES == before  # the CPU launches no kernel


# (H, KV, D): the variants' decode shapes
HEAD_GROUPS = [(12, 2, 128), (16, 2, 128), (24, 2, 128), (24, 2, 192)]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h,kv,d", HEAD_GROUPS,
                         ids=[f"h{h}_kv{kv}_d{d}" for h, kv, d in HEAD_GROUPS])
def test_k4_plain_versions_at_head_groups(use_pallas, dtype, h, kv, d):
    """K4's plain version and its split arithmetic (chunks of 24 slots,
    inside the pages of 16) at the grouping of each config against the
    reference's Pallas kernel and its oracle, ragged lengths over a
    permuted page table."""
    rng = np.random.default_rng(h + d)
    q, kp, vp, pt, lens = _paged_inputs(rng, 3, h, kv, d, 16, 4)
    lens[0] = 64
    if dtype == "bf16":
        bf = [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, kp, vp)]
        want = _jax_out(use_pallas, *bf, pt, lens)
        got = [_port_out(q, kp, vp, pt, lens, dtype=torch.bfloat16),
               _splits_out(q, kp, vp, pt, lens, 24, dtype=torch.bfloat16)]
        tol = BF16_TOL
    else:
        want = _jax_out(use_pallas, q, kp, vp, pt, lens)
        got = [_port_out(q, kp, vp, pt, lens), _splits_out(q, kp, vp, pt,
                                                           lens, 24)]
        tol = F32_TOL
    for out in got:
        np.testing.assert_allclose(out, want, rtol=tol, atol=tol)


def test_mixtral_loss_and_grads_match_reference(carried):
    """Mixtral's variant: ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, jp, _ = carried("mixtral-8x22b")
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    batch = _batch(jcfg, np.random.default_rng(43))
    jl, jg = jax.jit(jax.value_and_grad(JR.loss_fn(jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(tcfg, tp, batch)
    assert loss == pytest.approx(float(jl), rel=LOSS_TOL)
    _check_grads(grads, _numpy_tree(jg), "mixtral variant")


def test_mixtral_adamw8bit_steps_match_reference(carried):
    """Mixtral's variant under ``make_train_step`` with its own 8-bit
    AdamW against the reference's jitted step (``_steps_match_reference``:
    each step's loss and grad norm, the parameters after it), each step
    one step from the reference's parameters and optimizer state carried
    anew (``forced``: 8-bit AdamW's chaotic elements compound over free
    steps, and a free third step's grad norm parts by 1.5e-3); the experts
    move."""
    jcfg, tcfg, jp, _ = carried("mixtral-8x22b")
    assert tcfg.optimizer == "adamw8bit"
    start, tp = _steps_match_reference(jcfg, tcfg, "adamw8bit", forced=True,
                                       params=jp)
    assert not np.array_equal(tp["layers"]["moe"]["wu"].numpy(),
                              start["layers"]["moe"]["wu"])
