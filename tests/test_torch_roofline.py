"""The port's roofline tools held against the JAX reference.

``parse_collectives`` and ``roofline_terms`` are copies of the
reference's and must give its numbers on the reference test's synthetic
HLO texts and on any ``Hardware`` values passed to both.  The new
``collectives_from_trace`` and the dry-run's per-rank counting run in a
subprocess of their own (a single-process ``fake`` process group of 256
ranks, destroyed at its end): collectives of known sizes traced on a
16 x 16 mesh, and the flops of a sharded product counted on its local
shards (2 x 2 x 64 x 8 = 2,048), not the global product's 524,288 that
``FlopCounterMode`` reports over DTensors.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import roofline as ref  # noqa: E402
from repro_torch.launch import roofline as port  # noqa: E402

_HLO = [
    """
  %ar = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %x), replica_groups=[4,8]<=[32], to_apply=%add
  %ag = f32[64,32]{1,0} all-gather(f32[8,32]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %cp = s8[100]{0} collective-permute(s8[100]{0} %z), source_target_pairs={{0,1}}
""",
    """
  %s = bf16[16]{0} all-gather-start(bf16[2]{0} %x), replica_groups={{0,1,2,3,4,5,6,7}}
  %d = bf16[16]{0} all-gather-done(bf16[16]{0} %s)
""",
    """
  %rs = f32[4,256]{1,0} reduce-scatter(f32[64,256]{1,0} %g), replica_groups=[16,16]<=[256], dimensions={0}
  %a2a = (bf16[2,64]{1,0}, bf16[2,64]{1,0}) all-to-all(bf16[2,64]{1,0} %p, bf16[2,64]{1,0} %q), replica_groups={{0,1}}
  %ars = f32[1024]{0} all-reduce-start(f32[1024]{0} %r), replica_groups={{0,1,2,3}}
  %ard = f32[1024]{0} all-reduce-done(f32[1024]{0} %ars)
  %one = f32[8]{0} all-reduce(f32[8]{0} %u), replica_groups={{0}}
""",
]


@pytest.mark.parametrize("hlo", _HLO)
def test_parse_collectives_equals_reference(hlo):
    got, want = port.parse_collectives(hlo), ref.parse_collectives(hlo)
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.wire_bytes_per_chip == want.wire_bytes_per_chip
    assert got.total_result_bytes() == want.total_result_bytes()


def test_synthetic_hlo_wire_bytes():
    """The reference test's own expectation, on the port."""
    st = port.parse_collectives(_HLO[0])
    assert st.counts == {"all-reduce": 1, "all-gather": 1,
                         "collective-permute": 1}
    expected = 2 * 7 / 8 * 2048 + 7 / 8 * (64 * 32 * 4) + 100
    assert st.wire_bytes_per_chip == pytest.approx(expected, rel=1e-12)
    assert port.parse_collectives(_HLO[1]).counts == {"all-gather": 1}


@pytest.mark.parametrize("hw_fields", [
    dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
         hbm_bytes=80e9),
    dict(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
         hbm_bytes=16e9),
])
@pytest.mark.parametrize("model_flops", [None, 3.1e18])
def test_roofline_terms_equal_reference(hw_fields, model_flops):
    hlo = _HLO[0] + _HLO[2]
    got = port.roofline_terms(2.5e14, 7.5e11, port.parse_collectives(hlo),
                              hw=port.Hardware(**hw_fields),
                              model_flops_global=model_flops, chips=512)
    want = ref.roofline_terms(2.5e14, 7.5e11, ref.parse_collectives(hlo),
                              hw=ref.Hardware(**hw_fields),
                              model_flops_global=model_flops, chips=512)
    assert got == want


def test_hardware_defaults_are_the_h100_data_sheet():
    hw = port.Hardware()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(ref.Hardware)]


def test_wire_bytes_formula():
    assert port.wire_bytes("all-reduce", 800.0, 8) == 2 * 7 / 8 * 800
    assert port.wire_bytes("all-gather", 800.0, 8) == 7 / 8 * 800
    assert port.wire_bytes("reduce-scatter", 100.0, 8) == 7 * 100
    assert port.wire_bytes("all-to-all", 800.0, 8) == 7 / 8 * 800
    assert port.wire_bytes("collective-permute", 64.0, 1) == 64.0
    assert port.wire_bytes("all-reduce", 800.0, 1) == 0.0


_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import collectives_from_trace

dryrun._fake_world(256)
mesh = dryrun.make_production_mesh(multi_pod=False, device_type="cpu")
out = {}
c = dryrun._Counter()
with c:
    x = torch.empty(64, 32, device="meta")  # 8 KiB f32
    funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, 1)))
    funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (mesh, 0)))
    funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, (mesh, 1)))
out["records"] = c.collectives
st = collectives_from_trace(c.collectives)
out["counts"], out["result"], out["wire"] = st.counts, st.result_bytes, st.wire_bytes_per_chip

def dt(shape, placements):
    local = torch.empty(shape, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False)

a = dt((2, 64), [Shard(0), Replicate()])   # (32, 64) global
b = dt((64, 8), [Replicate(), Shard(1)])   # (64, 128) global
with FlopCounterMode(display=False) as fc:
    a @ b
out["flop_counter_global"] = fc.get_total_flops()
c = dryrun._Counter()
with c:
    y = a @ b
out["local_flops"] = c.flops
out["local_shape"] = list(y.to_local().shape)
ra = dt((32, 64), [Replicate(), Replicate()])
rb = dt((64, 128), [Replicate(), Replicate()])
c = dryrun._Counter()
with c:
    ra @ rb
out["replicated_flops"] = c.flops
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collectives_from_trace(traced):
    size = 64 * 32 * 4
    assert traced["records"] == [["all_reduce", size, 16],
                                 ["all_gather_into_tensor", 16 * size, 16],
                                 ["reduce_scatter_tensor", size // 16, 16]]
    assert traced["counts"] == {"all-reduce": 1, "all-gather": 1,
                                "reduce-scatter": 1}
    want = (2 * 15 / 16 * size + 15 / 16 * 16 * size + 15 * size / 16)
    assert traced["wire"] == pytest.approx(want, rel=1e-12)


def test_local_flop_count(traced):
    assert traced["flop_counter_global"] == 2 * 32 * 64 * 128 == 524_288
    assert traced["local_shape"] == [2, 8]
    assert traced["local_flops"] == 2 * 2 * 64 * 8 == 2_048
    assert traced["replicated_flops"] == 524_288
