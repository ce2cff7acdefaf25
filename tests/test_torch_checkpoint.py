"""The port's checkpointer held against the JAX reference's on the CPU.

* Format: for the same tree (the reference's test tree of f32, int32 and
  a 0-dim f32 in nested dicts; a trainer's parameters and AdamW state at
  a tiny dense and a tiny MoE config) the port writes a ``manifest.json``
  equal to the reference's, text for text, and every array equal bit for
  bit, dtype included; with ``_CHUNK_BYTES`` set small on both sides the
  chunking is the same.
* Crossing over: the port restores the reference's checkpoints bit for
  bit, bfloat16 leaves included (the reference's own restore gives those
  leaves back as raw ``V2`` void: the test shows it); the reference
  restores the port's f32 checkpoints bit for bit.
* The reference's own checkpoint tests (``tests/test_substrate.py``:
  roundtrip, latest step and ``.tmp`` atomicity, async, a shape mismatch
  raising) pass on the port; so does a dtype mismatch.
* Snapshot isolation: ``AsyncCheckpointer.save`` copies the tree before
  it returns, so a tree changed in place before ``wait`` is saved as it
  was at ``save``.

Every comparison is exact: nothing here computes, it only moves bits.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jck  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import checkpointer as tck  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy, state_from_numpy,
)
from repro_torch.training import optimizer as topt  # noqa: E402


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree))


def _jtree(seed=0):
    """The reference's ``TestCheckpoint._tree``."""
    k = jax.random.PRNGKey(seed)
    return {
        "a": jax.random.normal(k, (4, 8)),
        "nested": {"b": jnp.arange(10, dtype=jnp.int32), "c": jnp.float32(3.5)},
    }


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_same_files(d_ref, d_port):
    """Equal manifests (as text) and, leaf by leaf, equal arrays and dtypes
    as ``np.load`` gives them back."""
    assert (d_port / "manifest.json").read_text() == \
        (d_ref / "manifest.json").read_text()
    man = json.loads((d_ref / "manifest.json").read_text())
    assert sorted(p.name for p in d_port.iterdir()) == \
        sorted(p.name for p in d_ref.iterdir())
    for leaf in man["leaves"]:
        fname = man["files"][leaf["file"]]
        with np.load(d_ref / fname) as zr, np.load(d_port / fname) as zp:
            a, b = zr[leaf["key"]], zp[leaf["key"]]
            assert a.dtype == b.dtype and a.shape == b.shape, leaf
            assert np.array_equal(_bits(a), _bits(b)), leaf


def _assert_tensors_equal(got, want):
    """Nested dicts of tensors: the same keys in the same order, and each
    leaf the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tensors_equal(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8) if got.dim() else got,
                       want.view(torch.uint8) if want.dim() else want)


@functools.lru_cache(maxsize=None)
def _trainer_state(arch):
    """A trainer's checkpoint tree at a tiny config (the reference's params
    and AdamW state, after one update so the moments are nonzero), in both
    packages.  Shared between tests: read only."""
    kw = dict(n_layers=1, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2,
              head_dim=16, vocab_size=128)
    jcfg = dataclasses.replace(j_smoke(arch), **kw)
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    params = JR.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jopt.make_optimizer(jcfg.optimizer)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 1e-3, params)
    params, state, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    jtree = {"params": params, "opt": state}
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    tp = params_from_numpy(tcfg, np_tree["params"], "cpu")
    ts = state_from_numpy(np_tree["opt"], topt.make_optimizer(
        tcfg.optimizer).init(tp), "cpu")
    return jtree, {"params": tp, "opt": ts}


# ------------------------------------------------------------------ format
def test_same_tree_same_manifest_and_arrays(tmp_path):
    jtree = _jtree()
    jck.save_checkpoint(tmp_path / "ref", 7, jtree)
    tck.save_checkpoint(tmp_path / "port", 7, _to_torch(jtree))
    _assert_same_files(tmp_path / "ref" / "step_00000007",
                       tmp_path / "port" / "step_00000007")
    man = json.loads((tmp_path / "port" / "step_00000007" /
                      "manifest.json").read_text())
    assert [leaf["path"] for leaf in man["leaves"]] == [
        "['a']", "['nested']/['b']", "['nested']/['c']"]


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "moonshot-v1-16b-a3b"])
def test_trainer_tree_same_manifest_and_arrays(tmp_path, arch):
    """The port's parameter dicts keep ``init_params``'s insertion order;
    the checkpoint walks them in the reference's sorted order."""
    jtree, ttree = _trainer_state(arch)
    jck.save_checkpoint(tmp_path / "ref", 3, jtree)
    tck.save_checkpoint(tmp_path / "port", 3, ttree)
    _assert_same_files(tmp_path / "ref" / "step_00000003",
                       tmp_path / "port" / "step_00000003")


@pytest.mark.parametrize("chunk", [1, 100, 200, 1 << 10])
def test_chunking_matches(tmp_path, monkeypatch, chunk):
    monkeypatch.setattr(jck, "_CHUNK_BYTES", chunk)
    monkeypatch.setattr(tck, "_CHUNK_BYTES", chunk)
    jtree = _jtree(1)
    jck.save_checkpoint(tmp_path / "ref", 2, jtree)
    tck.save_checkpoint(tmp_path / "port", 2, _to_torch(jtree))
    _assert_same_files(tmp_path / "ref" / "step_00000002",
                       tmp_path / "port" / "step_00000002")
    man = json.loads((tmp_path / "port" / "step_00000002" /
                      "manifest.json").read_text())
    assert len(man["files"]) == {1: 3, 100: 2, 200: 1, 1 << 10: 1}[chunk]


# ------------------------------------------------------------------ crossing over
def _bf16_jtree():
    rng = np.random.default_rng(5)
    return {
        "w": jnp.asarray(rng.normal(size=(6, 40)), jnp.bfloat16),
        "layers": {"b": jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16),
                   "scale": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32)},
        "step": jnp.int32(4),
    }


def test_port_restores_reference_bf16_where_reference_cannot(tmp_path):
    jtree = _bf16_jtree()
    jck.save_checkpoint(tmp_path, 4, jtree)
    man = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert {leaf["dtype"] for leaf in man["leaves"]} == {
        "bfloat16", "float32", "int32"}
    # the reference's fault: its restore hands bf16 leaves back as void
    jgot, _ = jck.restore_checkpoint(tmp_path, 4, jtree)
    assert jgot["w"].dtype.kind == "V" and jgot["w"].dtype.itemsize == 2
    # the port restores them bit for bit
    want = _to_torch(jtree)
    got, step = tck.restore_checkpoint(tmp_path, None, want)
    assert step == 4
    assert got["w"].dtype == torch.bfloat16
    _assert_tensors_equal(got, want)


def test_port_bf16_checkpoint_has_reference_bytes(tmp_path):
    jtree = _bf16_jtree()
    jck.save_checkpoint(tmp_path / "ref", 1, jtree)
    tck.save_checkpoint(tmp_path / "port", 1, _to_torch(jtree))
    _assert_same_files(tmp_path / "ref" / "step_00000001",
                       tmp_path / "port" / "step_00000001")


def test_reference_restores_port_f32_checkpoint(tmp_path):
    jtree, ttree = _trainer_state("moonshot-v1-16b-a3b")
    tck.save_checkpoint(tmp_path, 9, ttree)
    got, step = jck.restore_checkpoint(tmp_path, None, jtree)
    assert step == 9
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(jtree)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def test_port_restores_reference_trainer_tree(tmp_path):
    jtree, ttree = _trainer_state("codeqwen1.5-7b")
    jck.save_checkpoint(tmp_path, 2, jtree)
    like = topt.tree_map(torch.zeros_like, ttree)
    got, step = tck.restore_checkpoint(tmp_path, 2, like)
    assert step == 2
    _assert_tensors_equal(got, ttree)


# ------------------------------------------------------------------ the reference's tests
def _tree(seed=0):
    return _to_torch(_jtree(seed))


def test_roundtrip(tmp_path):
    tree = _tree()
    tck.save_checkpoint(tmp_path, 7, tree)
    restored, step = tck.restore_checkpoint(tmp_path, None, tree)
    assert step == 7
    _assert_tensors_equal(restored, tree)


def test_latest_step_and_atomicity(tmp_path):
    tck.save_checkpoint(tmp_path, 1, _tree(1))
    tck.save_checkpoint(tmp_path, 5, _tree(2))
    assert tck.latest_step(tmp_path) == 5
    # a stale .tmp dir must not be picked up
    (tmp_path / "step_00000009.tmp").mkdir()
    assert tck.latest_step(tmp_path) == 5
    assert tck.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(tmp_path / "absent", None, _tree())


def test_async_checkpointer(tmp_path):
    ck = tck.AsyncCheckpointer(tmp_path)
    tree = _tree(3)
    ck.save(2, tree)
    ck.wait()
    restored, step = tck.restore_checkpoint(tmp_path, None, tree)
    assert step == 2
    _assert_tensors_equal(restored, tree)


def test_structure_mismatch_raises(tmp_path):
    tck.save_checkpoint(tmp_path, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(AssertionError):
        tck.restore_checkpoint(tmp_path, 1, {"a": torch.zeros((3, 3))})


def test_dtype_mismatch_raises(tmp_path):
    tck.save_checkpoint(tmp_path, 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(AssertionError):
        tck.restore_checkpoint(tmp_path, 1,
                               {"a": torch.zeros((2, 2), dtype=torch.bfloat16)})


# ------------------------------------------------------------------ snapshot isolation
def test_async_save_snapshots_before_returning(tmp_path):
    """The optimizer writes the parameters and moments in place right after
    a save: what lands on disk is the tree as it was at ``save``."""
    tree = _to_torch(_bf16_jtree())
    want = topt.tree_map(torch.clone, tree)
    ck = tck.AsyncCheckpointer(tmp_path)
    ck.save(3, tree)
    for leaf in topt.tree_leaves(tree):
        leaf.add_(1)
    ck.wait()
    got, _ = tck.restore_checkpoint(tmp_path, 3, want)
    _assert_tensors_equal(got, want)
    assert not torch.equal(tree["w"], want["w"])


def test_restored_leaves_are_fresh_and_writable(tmp_path):
    """Each restored leaf is a tensor of its own: updating it in place (as
    the optimizer does) touches neither ``like`` nor another leaf."""
    tree = _tree(4)
    tck.save_checkpoint(tmp_path, 1, tree)
    like = topt.tree_map(torch.zeros_like, tree)
    got, _ = tck.restore_checkpoint(tmp_path, 1, like)
    before = topt.tree_map(torch.clone, got)
    for leaf in topt.tree_leaves(got):
        leaf.add_(1)
    assert all(float(x.abs().sum()) == 0 for x in topt.tree_leaves(like))
    for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(before)):
        assert torch.equal(a, b + 1)
