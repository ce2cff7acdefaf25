"""The port's multi-pod dry-run held against the JAX reference.

Each process-group run is a subprocess of its own, as
``tests/test_dryrun_integration.py`` runs the reference's:

* the port: the reference test's cells -- ``SMALL`` codeqwen train,
  prefill and decode on its (2, 4) and (2, 2, 2) meshes, and the mixtral
  MoE with ``expert_cap=("data",)`` -- traced on a ``fake`` process group
  of 8 ranks (``make_mesh_shape`` / ``make_production_mesh`` patched down
  to the test's meshes), plus one cell's calibrated counts beside its
  raw full-depth counts;
* the reference: the same cells lowered and compiled on 8 forced host
  devices with ``AxisType.Auto`` meshes (``jax.make_mesh``'s default
  Explicit axes make the reference's ``shard_hint`` raise in this JAX),
  for ``memory_analysis().argument_size_in_bytes`` per chip;
* a 2-rank ``gloo`` run (mesh (1, 2), real values) of the ``SMALL``
  codeqwen prefill's logits under the rules.

Per-chip argument bytes must equal the reference's (on (2, 4): 4,691,588
train, 2,262,912 prefill, 268,601,476 decode) less the int32 scalars the
port holds as Python ints: the decode cache's ``pos`` (4 bytes).  The
sharded logits must equal the unsharded ones within the f32 logit
tolerance of ``tests/test_torch_prefill.py`` (1e-4).
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOGIT_TOL = 1e-4
# (2, 4) argument bytes per chip of the reference's Auto-axis compile.
REF_ARG_BYTES = {"train_4k": 4_691_588, "prefill_32k": 2_262_912,
                 "decode_32k": 268_601_476}
# int32 scalars the reference holds where the port holds a Python int.
PYTHON_INT_SCALARS = {"train_4k": 0, "prefill_32k": 0,
                      "decode_32k": 4}  # the decode cache's pos

_SMALL = ('dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
          'head_dim=16, d_ff=128, vocab_size=512, dtype="float32")')
_MOE = 'dict(SMALL, n_experts=4, top_k=2, moe_d_ff=128, moe_dispatch="sort")'

_PORT = r"""
import json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun

def shape(multi_pod=False):
    if multi_pod:
        return (2, 2, 2), ("pod", "data", "model")
    return (2, 4), ("data", "model")

def small_mesh(*, multi_pod=False, device_type="cpu"):
    s, a = shape(multi_pod)
    return init_device_mesh(device_type, s, mesh_dim_names=a)

dryrun.make_mesh_shape = shape
dryrun.make_production_mesh = small_mesh
SMALL = %(small)s
out = {}
for name in ("train_4k", "prefill_32k", "decode_32k"):
    for mp in (False, True):
        tr, meta, cfg, sh = dryrun.lower_cell("codeqwen1.5-7b", name,
                                              multi_pod=mp, overrides=SMALL)
        out[f"{name}|{'multi' if mp else 'single'}"] = {
            "args": tr.argument_bytes, "flops": tr.flops, "bytes": tr.bytes,
            "collectives": sum(tr.coll.counts.values()),
            "wire": tr.coll.wire_bytes_per_chip, "kernels": tr.kernels}
tr, *_ = dryrun.lower_cell("mixtral-8x22b", "train_4k", overrides=%(moe)s,
                           rule_overrides={"expert_cap": ("data",)})
out["moe"] = {"args": tr.argument_bytes, "kernels": tr.kernels,
              "collectives": sum(tr.coll.counts.values())}
r = dryrun.run_cell("codeqwen1.5-7b", "prefill_32k",
                    overrides=dict(SMALL, n_layers=5), out_dir=%(out)r)
out["calibrated"] = {k: r[k] for k in ("flops_per_chip", "bytes_per_chip",
                     "raw_flops_uncalibrated", "raw_bytes_uncalibrated",
                     "wire_bytes_per_chip", "raw_wire_uncalibrated")}
dist.destroy_process_group()
print(json.dumps(out))
"""

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import AxisType
from repro.launch import dryrun

def small_mesh(*, multi_pod=False):
    s, a = ((2, 2, 2), ("pod", "data", "model")) if multi_pod else \
        ((2, 4), ("data", "model"))
    return jax.make_mesh(s, a, axis_types=(AxisType.Auto,) * len(s))

dryrun.make_production_mesh = small_mesh
SMALL = %(small)s
out = {}
for name in ("train_4k", "prefill_32k", "decode_32k"):
    for mp in (False, True):
        lowered, *_ = dryrun.lower_cell("codeqwen1.5-7b", name, multi_pod=mp,
                                        overrides=SMALL)
        mem = lowered.compile().memory_analysis()
        out[f"{name}|{'multi' if mp else 'single'}"] = \
            mem.argument_size_in_bytes
lowered, *_ = dryrun.lower_cell("mixtral-8x22b", "train_4k", overrides=%(moe)s,
                                rule_overrides={"expert_cap": ("data",)})
out["moe"] = lowered.compile().memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


def _run(script: str, timeout: int = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    return _run(_PORT % dict(small=_SMALL, moe=_MOE, out=out))


@pytest.fixture(scope="module")
def reference():
    return _run(_REF % dict(small=_SMALL, moe=_MOE))


CELLS = [f"{s}|{m}" for s in ("train_4k", "prefill_32k", "decode_32k")
         for m in ("single", "multi")]


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_reference(port, reference, cell):
    shape = cell.split("|")[0]
    assert port[cell]["args"] == reference[cell] - PYTHON_INT_SCALARS[shape]


@pytest.mark.parametrize("shape", sorted(REF_ARG_BYTES))
def test_argument_bytes_on_2x4_equal_recorded_oracle(port, shape):
    assert port[f"{shape}|single"]["args"] == \
        REF_ARG_BYTES[shape] - PYTHON_INT_SCALARS[shape]


def test_moe_rule_override_traces(port, reference):
    assert port["moe"]["args"] == reference["moe"]
    assert port["moe"]["collectives"] > 0
    calls = {k: v[0] for k, v in port["moe"]["kernels"].items()}
    # 2 layers x 3 products forward (x2: remat recomputes), x3 backward
    assert calls == {"grouped_matmul": 12, "grouped_matmul_dx": 6,
                     "grouped_matmul_dw": 6}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_has_collectives(port, mesh):
    r = port[f"train_4k|{mesh}"]
    assert r["collectives"] > 0
    assert r["wire"] > 0
    assert r["flops"] > 0 and r["bytes"] > 0


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_runs_k4_sequence_parallel(port, mesh):
    r = port[f"decode_32k|{mesh}"]
    calls, flops, _ = r["kernels"]["paged_attention"]
    assert calls == 2  # one a layer
    assert flops > 0 and r["collectives"] > 0


def test_calibration_matches_full_depth(port):
    c = port["calibrated"]
    for k in ("flops", "bytes", "wire"):
        cal = c[f"{k}_per_chip"] if k != "wire" else c["wire_bytes_per_chip"]
        raw = c[f"raw_{k}_uncalibrated"]
        assert cal == pytest.approx(raw, rel=1e-9), k


# ---------------------------------------------------------------- pure copies
def _ref_dryrun():
    """The reference's dry-run module, imported without leaving its
    XLA_FLAGS (512 host devices) in this process's environment."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_model_flops_and_depth_pairs_equal_reference():
    from repro.configs import SHAPES as RS
    from repro.configs import get_config as rget
    from repro_torch.configs import SHAPES, cells, get_config
    from repro_torch.launch import dryrun

    ref = _ref_dryrun()
    for arch, shape in cells():
        assert dryrun._model_flops(get_config(arch), SHAPES[shape]) == \
            ref._model_flops(rget(arch), RS[shape])
        assert dryrun._depth_field_and_pair(get_config(arch)) == \
            ref._depth_field_and_pair(rget(arch))


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_calibrated_costs_equal_reference(arch, monkeypatch):
    """The affine depth extrapolation on the same shallow counts."""
    from repro.configs import get_config as rget
    from repro.launch.roofline import CollectiveStats
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    ref = _ref_dryrun()

    def counts(ovr):
        L = ovr["n_layers"]
        return 1.5e12 + 3.25e11 * L, 7e10 + 1.1e10 * L, 4e8 + 2.5e7 * L

    def port_measure(arch_, shape, mp, z, ovr, rules):
        f, b, w = counts(ovr)
        return None, None, f, b, w, {}

    seen = []

    def ref_lower(arch_, shape, mp, z, ovr, rules=None):
        seen.append(ovr)
        return ovr, None, None, None

    def ref_measure(lowered):
        f, b, w = counts(lowered)
        return None, f, b, CollectiveStats({}, {}, w)

    monkeypatch.setattr(dryrun, "_measure", port_measure)
    monkeypatch.setattr(ref, "lower_cell", ref_lower)
    monkeypatch.setattr(ref, "_measure", ref_measure)
    got = dryrun._calibrated_costs(arch, "train_4k", False, False, None,
                                   get_config(arch))
    want = ref._calibrated_costs(arch, "train_4k", False, False, None,
                                 rget(arch))
    assert got == want
    assert all(o["microbatch"] is None and o["scan_layers"] is False
               for o in seen)


# ---------------------------------------------------------------- gloo, 2 ranks
_GLOO = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.sharding.logical import DEFAULT_RULES, ShardingRules, activate
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_step import tree_shardings

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
cfg = dataclasses.replace(get_config("codeqwen1.5-7b"), **%(small)s)
params = R.init_params(cfg, torch.Generator().manual_seed(0))
tokens = torch.from_numpy(
    np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32))
want = R.forward_fn(cfg)(params, {"tokens": tokens})
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
rules = ShardingRules(mesh, dict(DEFAULT_RULES))

def place(t, sh):
    return DTensor.from_local(t[sh.local_slices(t.shape)].contiguous(), mesh,
                              sh.placements, run_check=False, shape=t.shape,
                              stride=t.stride())

sharded = tree_map(place, params,
                   tree_shardings(rules, R.param_axes(cfg), params))
batch = {"tokens": tokens}
batch = tree_map(place, batch,
                 tree_shardings(rules, {"tokens": ("batch", "seq")}, batch))
with activate(rules), implicit_replication():
    got = R.forward_fn(cfg)(sharded, batch)
n_sharded = sum(1 for t in sharded["layers"]["attn"].values()
                if any(p.is_shard() for p in t.placements))
got = got.full_tensor()
if rank == 0:
    np.save(sys.argv[3], np.stack([got.numpy(), want.numpy()]))
    print(json.dumps({"sharded_attn_leaves": n_sharded}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_two_rank_prefill_equals_unsharded(tmp_path):
    import numpy as np

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = _GLOO % dict(small=_SMALL)
    port_ = str(_free_port())
    out = str(tmp_path / "logits.npy")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), port_, out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for r in (0, 1)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    info = json.loads(results[0][0].strip().splitlines()[-1])
    # wq wk wv wo and the biases bq bk bv, heads over "model"
    assert info["sharded_attn_leaves"] == 7
    got, want = np.load(out)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
