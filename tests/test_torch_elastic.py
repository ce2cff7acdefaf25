"""The port's elastic restore held against the JAX reference.

A training state -- the ``SMALL`` codeqwen parameters in bfloat16 and an
AdamW state (f32 moments, int32 step) -- is written by the reference's
``save_checkpoint``.  The port's ``elastic_restore`` reads it, each
process-group run in a subprocess of its own:

* on a 1-rank ``gloo`` (1, 1) mesh with zero1, every leaf comes back a
  DTensor whose local tensor equals the reference's own restore bit for
  bit (bf16 compared as its 16-bit patterns);
* on a ``fake`` 8-rank (2, 4) mesh, rank 0's local shard of every leaf is
  the first block of its spec (each sharded dim cut into equal blocks),
  and zero1 puts ``data`` on dim 0 of the moments wherever dim 0 is free
  and divisible.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512, dtype="bfloat16")

_RESTORE = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import elastic_restore
from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.sharding.logical import DEFAULT_RULES, ShardingRules
from repro_torch.training.optimizer import make_optimizer, tree_map
from repro_torch.training.train_step import tree_shardings

directory, out, backend, shape = sys.argv[1], sys.argv[2], sys.argv[3], \
    tuple(json.loads(sys.argv[4]))
n = int(np.prod(shape))
if backend == "gloo":
    dist.init_process_group("gloo", init_method="tcp://localhost:%(port)d",
                            rank=0, world_size=n)
else:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
rules = ShardingRules(mesh, dict(DEFAULT_RULES))
cfg = dataclasses.replace(get_config("codeqwen1.5-7b"), **%(small)s)
opt = make_optimizer("adamw")
params = R.abstract_params(cfg)
like = {"params": params, "opt": opt.init(params)}
paxes = R.param_axes(cfg)
axes = {"params": paxes, "opt": opt.state_axes(paxes)}
tree, step = elastic_restore(directory, None, like, axes, rules, zero1=True)
sh = tree_shardings(rules, axes, like, zero1=True)
arrays, specs, dtensors = {}, {}, []

def walk(t, s, path):
    if isinstance(t, dict):
        for k in t:
            walk(t[k], s[k], f"{path}/{k}")
        return
    dtensors.append(type(t).__name__ == "DTensor" and str(t.device) == "cpu")
    local = t.to_local()
    if local.dtype == torch.bfloat16:
        local = local.view(torch.int16)
    arrays[path] = local.numpy()
    specs[path] = [list(p) if isinstance(p, tuple) else p for p in s.spec]

walk(tree, sh, "")
np.savez(out, **{k.replace("/", "|"): v for k, v in arrays.items()})
dist.destroy_process_group()
print(json.dumps({"step": step, "specs": specs, "all_dtensors": all(dtensors)}))
"""


def _ref_checkpoint(directory):
    """The reference's training state, saved and restored by the
    reference; returns its leaves by path as raw-bit numpy arrays."""
    import dataclasses

    from repro.checkpoint.checkpointer import restore_checkpoint, save_checkpoint
    from repro.configs import get_config
    from repro.models import registry as RR
    from repro.training.optimizer import make_optimizer

    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"), **SMALL)
    params = RR.init_params(cfg, jax.random.PRNGKey(3))
    opt = make_optimizer("adamw")
    state = opt.init(params)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape).astype(np.float32)
                   if x.dtype == np.float32 else x), state)
    state["step"] = np.int32(7)
    tree = {"params": params, "opt": state}
    save_checkpoint(directory, 5, tree)
    restored, _ = restore_checkpoint(directory, 5, tree)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}/{k}")
            return
        a = np.asarray(t)
        flat[path] = a.view(np.int16) if a.dtype.itemsize == 2 and \
            a.dtype.kind in "Vf" else a
    walk(restored, "")
    return flat


def _restore(directory, tmp_path, backend, shape):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / f"{backend}.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = _RESTORE % dict(small=repr(SMALL), port=port)
    proc = subprocess.run([sys.executable, "-c", script, str(directory), out,
                           backend, json.dumps(shape)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        arrays = {k.replace("|", "/"): z[k] for k in z.files}
    return info, arrays


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ckpt")
    return directory, _ref_checkpoint(directory)


def test_one_rank_gloo_restore_is_bit_equal(saved, tmp_path):
    directory, want = saved
    info, got = _restore(directory, tmp_path, "gloo", [1, 1])
    assert info["step"] == 5 and info["all_dtensors"]
    assert set(got) == set(want)
    bf16 = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert g.tobytes() == w.tobytes(), path
        bf16 += path.startswith("/params") and g.dtype == np.int16
    assert bf16 > 0  # bf16 leaves went through


def _first_block(a: np.ndarray, spec, sizes) -> np.ndarray:
    index = []
    for dim, entry in zip(a.shape, list(spec) + [None] * (a.ndim - len(spec))):
        axes = [] if entry is None else ([entry] if isinstance(entry, str)
                                          else list(entry))
        n = int(np.prod([sizes[x] for x in axes])) if axes else 1
        index.append(slice(0, dim // n))
    return a[tuple(index)]


def test_fake_eight_rank_restore_keeps_rank0_block(saved, tmp_path):
    directory, want = saved
    info, got = _restore(directory, tmp_path, "fake", [2, 4])
    assert info["all_dtensors"]
    sizes = {"data": 2, "model": 4}
    sharded = 0
    for path, w in want.items():
        spec = info["specs"][path]
        block = _first_block(w, spec, sizes)
        assert got[path].tobytes() == block.tobytes(), path
        sharded += got[path].size < w.size
    assert sharded > 0
    # zero1: data on dim 0 of every moment whose dim 0 is free and divisible
    for path, spec in info["specs"].items():
        if not path.startswith("/opt/mu") or not spec:
            continue
        param = info["specs"]["/params" + path[len("/opt/mu"):].rsplit("/", 1)[0]]
        if param and param[0] is None and want[path].shape[0] % 2 == 0 and \
                "data" not in json.dumps(param):
            assert spec[0] == "data", path
