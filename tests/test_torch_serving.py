"""The port's serving decode path held against the JAX reference.

Weights are the reference's own, initialised by ``repro`` and carried into
the port through numpy (``models.convert.params_from_numpy``, bit for
bit); token and activation inputs are made with numpy from a seed.  The
JAX side is the reference's plain path (its decode attention is the jnp
softmax; K4's Pallas kernel is held separately in
``test_torch_paged_attention.py``).  Tolerances, in float32:

* one layer's ``attn_decode``: rtol 2e-5, the reference's own for its
  attention core (``tests/test_kernels.py:220``), and atol 2e-5 of the
  step's largest reference value.  The error is set by the largest terms,
  not by an element's own size: at the smoke config's init scales the
  scores reach ~100, so a one-ulp difference in q or k (the projections
  are summed in another order) moves the softmax weights by ~1e-5
  relative, and the outputs reach ~40.  Measured: up to 5.8e-5 on outputs
  of magnitude 41 (GQA), where a fixed 1e-5 does not hold;
* the whole model's logits after 16 steps (two layers, eight matmuls
  deep, logits below 1): 1e-4.  The engine is a copy and must replay the reference's
``serving_*`` goldens bit-identically.
"""
from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import replay  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.common import ParamFactory as JFactory  # noqa: E402
from repro.serving import AdapterSpec as JAdapterSpec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import ShardedServingEngine as JSharded  # noqa: E402
from repro.training.train_step import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch import serving as tsrv  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as tkernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.common import ParamFactory as TFactory  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training.train_step import make_serve_step as t_make_serve_step  # noqa: E402

ARCH = "codeqwen1.5-7b"
ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4
# bf16, one step: logits of magnitude < 1; XLA and PyTorch round the bf16
# matmul outputs, norms and residual sums at other places, each a relative
# 2^-8 at most, so a logit may move by a few bf16 ulps of the hidden state
# (measured: 3.9e-3, one ulp at |logit| in [0.5, 1)).
BF16_LOGIT_TOL = 2e-2


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs():
    base = j_smoke(ARCH)
    return {
        "codeqwen": (base, 64),
        "gqa": (dataclasses.replace(base, n_kv_heads=2), 64),
        "ring": (dataclasses.replace(base, sliding_window=16), 64),
    }


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("variant", ["codeqwen", "gqa", "ring"])
def test_attn_decode_matches_reference(variant):
    """24 decode steps of one attention layer with carried weights (and
    random QKV biases): outputs and both caches, step by step."""
    jcfg, max_seq = _configs()[variant]
    tcfg = t_smoke(ARCH)
    tcfg = dataclasses.replace(tcfg, n_kv_heads=jcfg.n_kv_heads,
                               sliding_window=jcfg.sliding_window)
    rng = np.random.default_rng(11)
    p = _numpy_tree(jattn.init_attention(
        jcfg, JFactory(jax.random.PRNGKey(3), jnp.float32)))
    for b in ("bq", "bk", "bv"):
        p[b] = rng.normal(size=p[b].shape).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jlayout = jattn.cache_layout(jcfg, max_seq)
    tlayout = tattn.cache_layout(tcfg, max_seq)
    assert tuple(jlayout) == tuple(tlayout)
    B = 3
    shape = (B, tlayout.seq, jcfg.n_kv_heads, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for pos in range(24):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jo, jk, jv = jattn.attn_decode(jcfg, p, jnp.asarray(x), jk, jv,
                                       jnp.int32(pos), jlayout)
        to, tk2, tv2 = tattn.attn_decode(tcfg, tp, torch.from_numpy(x), tk,
                                         tv, pos, tlayout)
        assert tk2 is tk and tv2 is tv  # updated in place
        for got, want in ((to, jo), (tk, jk), (tv, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=ATTN_TOL,
                atol=ATTN_TOL * max(1.0, float(np.abs(want).max())))


def test_decode_tables_follow_batch_and_layout():
    """K4's page table and lengths come from tables cached per (B, cache
    layout, device): in one process, a plain cache at B=3, then B=5, a
    ring at B=3 and the plain B=3 again each decode as the reference
    does, and the tables are the identity pages and min(pos + 1, S)."""
    rng = np.random.default_rng(12)
    runs = [("codeqwen", 3), ("codeqwen", 5), ("ring", 3), ("codeqwen", 3)]
    for variant, B in runs:
        jcfg, max_seq = _configs()[variant]
        tcfg = dataclasses.replace(t_smoke(ARCH),
                                   sliding_window=jcfg.sliding_window)
        p = _numpy_tree(jattn.init_attention(
            jcfg, JFactory(jax.random.PRNGKey(4), jnp.float32)))
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        layout = tattn.cache_layout(tcfg, max_seq)
        jlayout = jattn.cache_layout(jcfg, max_seq)
        assert tuple(jlayout) == tuple(layout)
        shape = (B, layout.seq, jcfg.n_kv_heads, jcfg.head_dim)
        jk = jv = jnp.zeros(shape, jnp.float32)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        for pos in range(layout.seq + 2 if layout.ring else 18):
            x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
            jo, jk, jv = jattn.attn_decode(jcfg, p, jnp.asarray(x), jk, jv,
                                           jnp.int32(pos), jlayout)
            to, _, _ = tattn.attn_decode(tcfg, tp, torch.from_numpy(x), tk,
                                         tv, pos, layout)
            want = np.asarray(jo)
            np.testing.assert_allclose(
                to.numpy(), want, rtol=ATTN_TOL,
                atol=ATTN_TOL * max(1.0, float(np.abs(want).max())))
            table, lens = tattn._decode_tables(B, layout, pos, "cpu")
            page = math.gcd(layout.seq, tattn.DECODE_PAGE)
            assert table.dtype == lens.dtype == torch.int32
            assert torch.equal(table, torch.arange(
                B * layout.seq // page, dtype=torch.int32).view(B, -1))
            assert lens.tolist() == [min(pos + 1, layout.seq)] * B


# ------------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def carried():
    """The smoke config's weights, initialised by the reference."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, _numpy_tree(jp), "cpu")


def test_decode_matches_reference(carried):
    """16 greedy decode steps from zero tokens at B=8: logits within 1e-4
    at every step, identical tokens, identical caches' positions."""
    jcfg, tcfg, jp, tp = carried
    B, S = 8, 64
    jstep, tstep = jax.jit(JR.decode_fn(jcfg, S)), TR.decode_fn(tcfg, S)
    jcache = JR.make_cache(jcfg, B, S)
    tcache = TR.make_cache(tcfg, B, S, device="cpu")
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    before = dict(tkernel.LAUNCHES)
    for _ in range(16):
        jl, jcache = jstep(jp, jt, jcache)
        tl, tcache = tstep(tp, tt, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tcache["pos"] == int(jcache["pos"]) == 16
    want = np.asarray(jcache["k"])
    np.testing.assert_allclose(tcache["k"].numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL * float(np.abs(want).max()))
    assert tkernel.LAUNCHES == before


def test_serve_step_tokens_match_reference(carried):
    jcfg, tcfg, jp, tp = carried
    B, S = 8, 64
    jstep = jax.jit(j_make_serve_step(jcfg, S))
    tstep = t_make_serve_step(tcfg, S)
    jcache = JR.make_cache(jcfg, B, S)
    tcache = TR.make_cache(tcfg, B, S, device="cpu")
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.int32)
    seen = []
    for _ in range(16):
        jt, jcache = jstep(jp, jt, jcache)
        tt, tcache = tstep(tp, tt, tcache)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        seen.append(int(tt[0, 0]))
    assert len(set(seen)) > 1  # the greedy path does move


def test_bf16_step_matches_reference():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    jp = JR.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["mlp"]["wd"].view(torch.int16).numpy(),
        np.asarray(jp["layers"]["mlp"]["wd"]).view(np.int16))  # bit for bit
    tok = np.array([[0], [5], [17], [300]], np.int32)
    jl, _ = JR.decode_fn(jcfg, 32)(jp, jnp.asarray(tok),
                                   JR.make_cache(jcfg, 4, 32))
    tl, _ = TR.decode_fn(tcfg, 32)(tp, torch.from_numpy(tok),
                                   TR.make_cache(tcfg, 4, 32, device="cpu"))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=BF16_LOGIT_TOL)


def test_full_config_shapes_match_reference():
    """CodeQwen1.5-7B at full size, shapes only: the reference's abstract
    init and the port's meta init give the same tree."""
    jshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        JR.init_params(j_get_config(ARCH), mode="abstract"))
    tparams = TR.init_params(t_get_config(ARCH), device="meta")
    tshapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        tparams)
    assert tshapes == jshapes
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(tparams))
    assert n == pytest.approx(8.19e9, rel=1e-3)


def test_param_scale_rule_and_chunked_draws(monkeypatch):
    """fan_in = shape[-2] (H for a stacked (L, d, H, D) weight), drawn in
    chunks straight into the output dtype; the same seed gives the same
    weights."""
    from repro_torch.models import common

    gen = torch.Generator().manual_seed(0)
    w = TFactory(gen, torch.float32).param(
        (2, 64, 4, 16), ("layers", "embed", "heads", "head_dim"))
    assert w.std().item() == pytest.approx(1 / np.sqrt(4), rel=0.05)
    monkeypatch.setattr(common, "_DRAW", 1000)  # many chunks
    shape, axes = (3, 256, 64), ("layers", "embed", "ff")
    big = TFactory(torch.Generator().manual_seed(0), torch.bfloat16).param(
        shape, axes)
    assert big.dtype == torch.bfloat16
    assert big.float().std().item() == pytest.approx(1 / 16, rel=0.02)
    again = TFactory(torch.Generator().manual_seed(0), torch.bfloat16).param(
        shape, axes)
    assert torch.equal(big, again)
    with pytest.raises(ValueError):
        TFactory(None, torch.float32, "cpu").param((2, 2), ("a", "b"))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_other_families_name_their_roadmap_item(arch):
    """The dense and MoE families decode (the MoE one is held in
    ``test_torch_moe.py``); every other family raises."""
    cfg = t_smoke(arch)
    for call in (lambda: TR.init_params(cfg, device="cpu"),
                 lambda: TR.decode_fn(cfg, 16),
                 lambda: TR.make_cache(cfg, 2, 16, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()


def test_hybrid_with_experts_is_not_taken_for_moe():
    """jamba has experts on every other layer but is the hybrid family:
    admitting MoE does not admit it."""
    cfg = t_smoke("jamba-v0.1-52b")
    assert cfg.n_experts and cfg.family == "hybrid"
    with pytest.raises(NotImplementedError, match="hybrid family"):
        TR.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid family"):
        t_serve.main(["--arch", cfg.name, "--requests", "2", "--device", "cpu"])


# ------------------------------------------------------------------ engine
def _port_serving_scenario(name):
    """``replay.serving_scenario`` with the port's engine: the same trace,
    adapters and engine arguments (tests/replay.py)."""
    n_adapters = 8
    w = 1.0 / np.arange(1, n_adapters + 1) ** 1.5
    w /= w.sum()
    adapters = [tsrv.AdapterSpec(i, 8 << 30) for i in range(n_adapters)]

    def trace(seed, n, rate, prompt_lo, prompt_hi, max_new):
        rng = np.random.default_rng(seed)
        t, reqs = 0.0, []
        for i in range(n):
            t += float(rng.exponential(1.0 / rate))
            reqs.append(
                tsrv.Request(i, int(rng.choice(n_adapters, p=w)), t,
                             int(rng.integers(prompt_lo, prompt_hi)), max_new)
            )
        return reqs

    if name == "serving_static":
        reqs = trace(31, 160, 150.0, 8, 64, 16)
        cfg = tsrv.ServeConfig(policy="liferaft", alpha=0.25, fuse_k=2)
    elif name == "serving_adaptive":
        reqs = trace(31, 160, 150.0, 8, 64, 16)
        cfg = tsrv.ServeConfig(policy="liferaft", adaptive=True, fuse_k_max=4)
    elif name == "serving_prefetch":
        adapters = [tsrv.AdapterSpec(i, 48 << 30) for i in range(n_adapters)]
        reqs = trace(61, 200, 300.0, 16, 96, 32)
        cfg = tsrv.ServeConfig(
            policy="liferaft", adaptive=True, fuse_k_max=4, max_batch=8,
            control_halflife_s=1.0, prefetch=True, prefetch_horizon=2,
            prefetch_horizon_max=6, prefetch_depth=4,
        )
    else:
        reqs = trace(53, 220, 400.0, 16, 96, 48)
        cfg = tsrv.ServeConfig(
            policy="liferaft", adaptive=True, fuse_k_max=4, max_batch=8,
            spill_budget_bytes=25_000.0, spill_penalty_s=0.05,
            kv_bytes_per_token=16.0, control_halflife_s=1.0,
            rate_knee=200.0, depth_knee=64.0,
        )
    eng = tsrv.LifeRaftEngine(adapters, cfg)
    rec = replay.TraceRecorder()
    eng.loop.add_round_tap(rec)
    eng.run(reqs)
    return rec.entries


@pytest.mark.parametrize("name", ["serving_static", "serving_adaptive",
                                  "serving_prefetch", "serving_spill_paged"])
def test_golden_replays_through_port(name):
    expect = replay.load_trace(replay.GOLDEN_DIR / f"{name}.json")
    divergence = replay.diff_traces(expect, _port_serving_scenario(name))
    assert not divergence, "\n".join(divergence)


@pytest.mark.parametrize("steal", [False, True])
def test_sharded_engine_matches_reference(steal):
    from repro.core.shard import StealConfig as JSteal
    from repro_torch.core.shard import StealConfig as TSteal

    rng = np.random.default_rng(9)
    rows = []
    t = 0.0
    for i in range(120):
        t += float(rng.exponential(1 / 200.0))
        rows.append((i, int(rng.integers(0, 6)), t, int(rng.integers(8, 64))))
    kw = dict(n_shards=3)
    jeng = JSharded([JAdapterSpec(a, (a + 1) << 30) for a in range(6)],
                    JServeConfig(fuse_k=2), steal=JSteal() if steal else None,
                    **kw)
    teng = tsrv.ShardedServingEngine(
        [tsrv.AdapterSpec(a, (a + 1) << 30) for a in range(6)],
        tsrv.ServeConfig(fuse_k=2), steal=TSteal() if steal else None, **kw)
    js = jeng.run([JRequest(*r, 16) for r in rows])
    ts = teng.run([tsrv.Request(*r, 16) for r in rows])
    assert ts == js


# ------------------------------------------------------------------ launcher
def _summary_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  ")]


def test_launcher_gives_the_references_summary(capsys, monkeypatch):
    """The port's launcher decodes on the CPU (smoke config) and prints
    the engine summary the reference's launcher prints: the virtual clock
    decides the schedule, so the decode does not change it."""
    args = ["--arch", ARCH, "--requests", "12"]
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--no-decode"])
    j_serve.main()
    want = _summary_lines(capsys.readouterr().out)
    before = tkernel.LAUNCHES["paged_attention"]
    t_serve.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert _summary_lines(out) == want and len(want) > 10
    assert "decode: 12 calls, 192 steps" in out
    assert tkernel.LAUNCHES["paged_attention"] == before
    summary, stats = t_serve.serve(
        t_serve.build_parser().parse_args([*args, "--no-decode"]))
    assert stats.calls == 0
    assert [f"  {k:20s} {v}" for k, v in summary.items()] == want

