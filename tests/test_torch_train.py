"""The port's training path held against the JAX reference on the CPU:
the losses and their gradients for every family, the optimizers, the
train step and the token pipeline.

Weights are the reference's own, initialised by ``repro`` at the float32
smoke configs and carried into the port through numpy
(``models.convert.params_from_numpy``, bit for bit); tokens, frames,
patches, gradients and parameters of the optimizer cases are made with
numpy from a seed.  The reference's training path reaches no Pallas
kernel (attention, the Mamba scan and the losses are plain ``jnp``; its
MoE experts are einsums), so it runs as is; the port's expert products
go through K5's autograd Function, on the CPU its plain versions.
Optimizer states compare leaf for leaf through
``models.convert.state_to_numpy``.  Tolerances:

* ``loss_fn`` (vocab 500, padded to 512, so the -1e30 mask is live):
  the loss within 1e-5 relative; each gradient leaf within 1e-3 of that
  leaf's largest reference value.  Measured: losses within 1.6e-7
  relative, leaves up to 1.9e-4 (jamba's, seamless's and paligemma's:
  the deepest graphs, and the attention's near one-hot softmax at the
  init scale).  ``loss_chunk`` set
  gives the same within those tolerances; remat on gives exactly the
  values of remat off (the recomputed forward is the same arithmetic);
* the optimizers, 3 updates from the same f32 parameters and gradients:
  parameters, moments and metrics within 1e-6 relative (1e-6 absolute);
  the 8-bit moments' codes equal except at most 1 in 1,000 codes off by
  one (a moment one ulp apart at a rounding boundary), their scales
  within 1e-6; a bfloat16 leaf within one bf16 ulp;
* 3 steps of ``make_train_step``: loss and grad norm within 1e-4
  relative each step; parameters within 8 lr absolute, since a gradient
  near zero makes Adam's first step about sign(g) x lr on either side
  (measured 0.017 lr for AdamW and Adafactor).  8-bit AdamW is not
  bit-for-bit reproducible across two frameworks' gradients: where a v
  code rounds to 0 its update is m / eps, so one code off moves a
  parameter by ~0.1; those elements are counted, not compared (the
  test's docstring);
* ``TokenPipeline``: batches equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy, state_from_numpy, state_to_numpy,
)
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import make_train_step as t_train_step  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
OPT_TOL = 1e-6
STEP_TOL = 1e-4
LR = 3e-4
B, S = 2, 8
FAMILIES = {"dense": "codeqwen1.5-7b", "moe": "moonshot-v1-16b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "encdec": "seamless-m4t-large-v2", "vlm": "paligemma-3b"}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


def _pick(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _cfgs(arch, **kw):
    kw = dict(vocab_size=500, **kw)
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def _batch(cfg, rng, b=B, s=S):
    """The reference's training batch keys, as numpy arrays."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32), "dec_tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(b, cfg.n_prefix, cfg.d_model))
                .astype(np.float32), "tokens": toks, "labels": labels}
    return {"tokens": toks, "labels": labels}


def _port_grads(tcfg, tp, batch):
    live = topt.tree_map(lambda p: p.clone().requires_grad_(), tp)
    loss = TR.loss_fn(tcfg)(live, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    leaves = topt.tree_leaves(live)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return float(loss.detach()), topt.tree_map(lambda _: next(grads), live)


def _check_grads(got, want, where):
    for path, w in _leaves(want):
        g = _pick(got, path)
        assert g is not None, f"{where}: {path} got no gradient"
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"{where}: {path}")


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's; the port with ``loss_chunk`` unset and set (two
    chunks) against the same, and with ``remat`` on equal to off."""
    jcfg, tcfg = _cfgs(FAMILIES[family])
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    batch = _batch(jcfg, np.random.default_rng(11))
    jl, jg = jax.value_and_grad(JR.loss_fn(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = _numpy_tree(jg)
    runs = {}
    for name, kw in {"plain": {}, "chunked": dict(loss_chunk=S // 2),
                     "remat": dict(remat=True)}.items():
        runs[name] = _port_grads(dataclasses.replace(tcfg, **kw), tp, batch)
        loss, grads = runs[name]
        assert loss == pytest.approx(float(jl), rel=LOSS_TOL)
        _check_grads(grads, jg, f"{family} {name}")
    plain, remat = runs["plain"], runs["remat"]
    assert remat[0] == plain[0]
    for path, g in _leaves(plain[1]):
        assert torch.equal(_pick(remat[1], path), g), path


def test_chunked_loss_matches_the_references_chunked_loss():
    """``cross_entropy``'s unrolled chunks (three, the last one short)
    against the reference's own chunked path."""
    jcfg, tcfg = _cfgs("codeqwen1.5-7b", loss_chunk=3)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    batch = _batch(jcfg, np.random.default_rng(12))
    jl, jg = jax.value_and_grad(JR.loss_fn(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(tcfg, tp, batch)
    assert loss == pytest.approx(float(jl), rel=LOSS_TOL)
    _check_grads(grads, _numpy_tree(jg), "chunked")


def test_padded_vocab_is_masked():
    """The padding columns of the vocab take no probability: raising their
    logits (their unembedding rows) leaves the loss as it was."""
    _, tcfg = _cfgs("codeqwen1.5-7b")
    tp = TR.init_params(tcfg, torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, np.random.default_rng(13)).items()}
    loss = TR.loss_fn(tcfg)(tp, batch)
    tp["unembed"][tcfg.vocab_size:] = 100.0
    assert torch.equal(TR.loss_fn(tcfg)(tp, batch), loss)


# ------------------------------------------------------------------ optimizers
def _opt_case(seed):
    """Parameters (2-D, 3-D, 1-D f32 leaves and a 2-D bf16 one; sizes that
    leave the 8-bit tail block partial) and 3 gradient trees, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (24, 40), "stack": {"e": (3, 16, 20)}, "b": (40,)}

    def tree(scale):
        return {"w": (rng.normal(size=shapes["w"]) * scale).astype(np.float32),
                "stack": {"e": (rng.normal(size=shapes["stack"]["e"])
                                * scale).astype(np.float32)},
                "b": (rng.normal(size=shapes["b"]) * scale).astype(np.float32)}

    return tree(1.0), [tree(10.0 ** -k) for k in range(3)]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _compare_state(got: dict, want: dict, name: str):
    for path, w in _leaves(want):
        g = _pick(got, path)
        if path.endswith("_q"):
            off = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (name, path)
        else:
            np.testing.assert_allclose(g, w, rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=f"{name}: {path}")


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_matches_reference(name):
    """3 updates of each optimizer, with a cosine schedule, from the same
    parameters and gradients (one update's norm above the clip): the
    parameters, every state leaf and the metrics equal the reference's."""
    params, grads = _opt_case(21)
    kw = dict(lr=None, weight_decay=0.1, clip_norm=1.0)
    jo = jopt.make_optimizer(name, **dict(kw, lr=jopt.cosine_schedule(
        1e-2, 1, 10)))
    to = topt.make_optimizer(name, **dict(kw, lr=topt.cosine_schedule(
        1e-2, 1, 10)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    _compare_state(state_to_numpy(ts), _numpy_tree(js), f"{name} init")
    for i, g in enumerate(grads):
        jp, js, jm = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(_to_torch(g), ts, tp)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=OPT_TOL)
        for path, w in _leaves(_numpy_tree(jp)):
            np.testing.assert_allclose(_pick(tp, path).numpy(), w,
                                       rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=f"{name} step {i}: {path}")
        _compare_state(state_to_numpy(ts), _numpy_tree(js),
                       f"{name} step {i}")
    assert float(_numpy_tree(js)["step"]) == int(ts["step"]) == 3


def test_bf16_leaf_and_state_round_trip():
    """A bfloat16 leaf's AdamW update is the reference's within one bf16
    ulp; the state carried from the reference through numpy
    (``state_from_numpy``) updates as the port's own does."""
    rng = np.random.default_rng(22)
    p = rng.normal(size=(16, 32)).astype(np.float32)
    g = (rng.normal(size=(16, 32)) * 0.1).astype(np.float32)
    jo, to = jopt.make_optimizer("adamw"), topt.make_optimizer("adamw")
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    js = jo.init(jp)
    ts = state_from_numpy(_numpy_tree(js), to.init(tp), "cpu")
    jp, js, _ = jo.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
    tp, ts, _ = to.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp)
    want = np.asarray(jp["w"].astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
    assert (np.abs(tp["w"].float().numpy() - want) <= ulp).all()
    _compare_state(state_to_numpy(ts), _numpy_tree(js), "bf16")
    with pytest.raises(ValueError, match="mu.w.m"):
        state_from_numpy({"mu": {"w": {"m": np.zeros((2, 2), np.float32),
                                       "v": np.zeros((16, 32), np.float32)}},
                          "step": np.zeros((), np.int32)}, ts, "cpu")


def test_cosine_schedule_and_clip_match_reference():
    for warmup, total in [(10, 110), (0, 5), (3, 3)]:
        jl = jopt.cosine_schedule(2e-3, warmup, total)
        tl = topt.cosine_schedule(2e-3, warmup, total)
        for step in [0, 1, warmup, warmup + 1, total // 2, total, total + 7]:
            assert float(tl(torch.tensor(step, dtype=torch.int32))) == \
                pytest.approx(float(jl(jnp.int32(step))), rel=1e-6, abs=1e-12)
    params, grads = _opt_case(23)
    for max_norm in (0.5, 1e6):
        jc, jn = jopt.clip_by_global_norm(grads[0], max_norm)
        tc, tn = topt.clip_by_global_norm(_to_torch(grads[0]), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for path, w in _leaves(_numpy_tree(jc)):
            np.testing.assert_allclose(_pick(tc, path).numpy(), w, rtol=1e-6)
    assert float(topt.global_norm(_to_torch(params))) == pytest.approx(
        float(jopt.global_norm(params)), rel=1e-6)


# ------------------------------------------------------------------ the step
def _step_batch(cfg, data, rng) -> dict:
    """The next ``TokenPipeline`` batch in the family's keys: the
    encoder-decoder takes its tokens as ``dec_tokens`` beside seeded
    normal frames, the VLM seeded normal patches before them."""
    b = data.next_batch()
    rows, seq = b["tokens"].shape
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(rows, seq, cfg.d_model)).astype(
            np.float32), "dec_tokens": b["tokens"], "labels": b["labels"]}
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(rows, cfg.n_prefix, cfg.d_model))
                .astype(np.float32), **b}
    return b


def _steps_match_reference(jcfg, tcfg, opt, seed=2, gn_tol=STEP_TOL,
                           forced=False, params=None):
    """3 steps of ``make_train_step`` against the reference's jitted step
    from the same carried weights, on ``TokenPipeline`` batches of 4 x 8
    (``_step_batch``): each step's loss and grad norm (within
    ``STEP_TOL``; the grad norm within ``gn_tol``), and the parameters
    after each step.  With ``forced`` each step starts from the
    reference's parameters and optimizer state, carried into the port
    anew.  ``params``: the reference's parameters to start from (default
    ``init_params`` from key ``seed``).  Returns the port's parameters
    before (as numpy) and after.

    8-bit AdamW (the reference's scheme) is chaotic where a block's v code
    rounds to 0 while m's does not: the update there is m / eps, some 1e4
    lr, so a code one off at a rounding boundary (the gradients differ in
    their last bits) moves the parameter by ~1e-1 on one side only.  An
    element more than 8 lr from the reference's must be one where a side's
    step exceeded 8 lr; those are counted and held under 1% of the
    parameters for 8-bit AdamW (none for the others; with ``forced``, at
    each step); every other element within 8 lr; after a step with such
    elements the grad norm within 1e-3 (measured 3.0e-4)."""
    jp = (JR.init_params(jcfg, jax.random.PRNGKey(seed)) if params is None
          else params)
    tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
    start = state_to_numpy(tp)
    jo, to = jopt.make_optimizer(opt, lr=LR), topt.make_optimizer(opt, lr=LR)
    jstep = jax.jit(j_train_step(jcfg, jo))
    tstep = t_train_step(tcfg, to)
    js, ts = jo.init(jp), to.init(tp)
    data = tpipe.TokenPipeline(tpipe.DataConfig(tcfg.vocab_size, S, 4))
    rng = np.random.default_rng(seed)
    n_all = sum(w.size for _, w in _leaves(start))
    limit = 0.01 * n_all if opt == "adamw8bit" else 0
    blown = {path: np.zeros(w.shape, bool) for path, w in _leaves(start)}
    for i in range(3):
        b = _step_batch(tcfg, data, rng)
        if forced and i:
            tp = params_from_numpy(tcfg, _numpy_tree(jp), "cpu")
            ts = state_from_numpy(_numpy_tree(js), ts, "cpu")
            blown = {path: np.zeros_like(m) for path, m in blown.items()}
        before_j, before_t = _numpy_tree(jp), state_to_numpy(tp)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        tol = 1e-3 if any(m.any() for m in blown.values()) else gn_tol
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=STEP_TOL), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=tol), i
        for path, w in _leaves(_numpy_tree(jp)):
            got = _pick(tp, path).numpy()
            off = (np.abs(got - w) > 8 * LR) & ~blown[path]
            big = ((np.abs(w - _pick(before_j, path)) > 8 * LR)
                   | (np.abs(got - _pick(before_t, path)) > 8 * LR))
            assert not (off & ~big).any(), f"step {i}: {path}"
            blown[path] |= off
        if forced:
            assert sum(int(m.sum()) for m in blown.values()) <= limit, i
    assert sum(int(m.sum()) for m in blown.values()) <= limit
    return start, tp


@pytest.mark.parametrize("family,opt,micro", [
    ("moe", "adamw", None), ("dense", "adamw8bit", 2), ("moe", "adafactor", 2),
], ids=["moe-adamw", "dense-adamw8bit-micro", "moe-adafactor-micro"])
def test_train_step_matches_reference(family, opt, micro):
    """3 steps of ``make_train_step`` against the reference's
    (``_steps_match_reference``); the MoE's experts move."""
    jcfg, tcfg = _cfgs(FAMILIES[family], microbatch=micro)
    start, tp = _steps_match_reference(jcfg, tcfg, opt)
    if family == "moe":
        assert not np.array_equal(tp["layers"]["moe"]["wu"].numpy(),
                                  start["layers"]["moe"]["wu"])


def test_microbatches_average_the_full_batch():
    """With microbatching the step's loss is the mean of the microbatches'
    and its gradients their mean: the same update as one pass over the
    batch, within f32 summation order."""
    _, tcfg = _cfgs("codeqwen1.5-7b")
    base = TR.init_params(tcfg, torch.Generator().manual_seed(4))
    b = tpipe.TokenPipeline(tpipe.DataConfig(tcfg.vocab_size, S, 4)).next_batch()
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for micro in (None, 2):
        p = topt.tree_map(torch.clone, base)
        o = topt.make_optimizer("adamw", lr=LR)
        step = t_train_step(dataclasses.replace(tcfg, microbatch=micro), o)
        out[micro] = step(p, o.init(p), b)
    assert float(out[2][2]["loss"]) == pytest.approx(
        float(out[None][2]["loss"]), rel=1e-6)
    assert float(out[2][2]["grad_norm"]) == pytest.approx(
        float(out[None][2]["grad_norm"]), rel=1e-5)


# ------------------------------------------------------------------ data
def test_token_pipeline_equals_reference():
    """Batches, ranks' shards and a restored stream equal the reference's
    bit for bit."""
    cfg_j = jpipe.DataConfig(vocab_size=500, seq_len=12, global_batch=6, seed=3)
    cfg_t = tpipe.DataConfig(vocab_size=500, seq_len=12, global_batch=6, seed=3)
    for rank in range(3):
        jd = jpipe.TokenPipeline(cfg_j, dp_rank=rank, dp_size=3)
        td = tpipe.TokenPipeline(cfg_t, dp_rank=rank, dp_size=3)
        for _ in range(3):
            jb, tb = jd.next_batch(), td.next_batch()
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    jd = jpipe.TokenPipeline.restore(cfg_j, {"step": 5, "seed": 3})
    td = tpipe.TokenPipeline.restore(cfg_t, {"step": 5, "seed": 3})
    np.testing.assert_array_equal(td.next_batch()["tokens"],
                                  jd.next_batch()["tokens"])
    assert td.state() == jd.state()
