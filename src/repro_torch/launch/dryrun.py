"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on DTensors.

The port of ``repro.launch.dryrun``.  Where the reference forces 512 host
devices and lowers + compiles each cell's jitted step on a
``jax.sharding.Mesh``, the port starts a process group on the ``fake``
backend with as many ranks as the mesh, in this one process, over a
``cpu`` ``DeviceMesh`` (shapes only), and runs the cell's step eagerly on
DTensors whose local shards are ``meta`` tensors, laid out by
``tree_shardings``, under ``activate(rules)``:

  train    make_train_step(cfg, opt)(params, opt_state, batch)
  prefill  make_prefill_step(cfg)(params, batch)
  decode   make_serve_step(cfg, seq_len)(params, token, cache)

Nothing is allocated: the trace is the counterpart of lower + compile.
Importing this module starts nothing; ``lower_cell`` starts the fake group
(again, when the next mesh has another size) and refuses to run beside a
process group it did not start.

Counts are per rank, taken on rank 0's local shards by a dispatch mode
(``_Counter``) that lets DTensor unwrap each op and sees the local ops:

  flops        torch's flop-counter formulas (the matmul family) on the
               local ops, plus K4's and K5's own (their meta branches,
               ``kernels.shapes``);
  bytes        bytes read plus written by every local op that is not a
               view or an empty allocation, plus K4's and K5's;
  collectives  every ``_c10d_functional`` collective, its result bytes and
               group size (``roofline.collectives_from_trace``);
  argument_bytes  the sum of rank 0's local shard bytes of the step's
               tensor arguments at full depth (``memory_analysis``; its
               other fields have no eager counterpart and are left out).

Strategy costs.  DTensor prices each candidate sharding of an op by
planning the redistribution to it; on a 3-D mesh its planner took over
half an hour for a two-layer cell.  On a mesh of three or more dims the
trace prices candidates instead one mesh dim at a time with DTensor's
own per-dim transition costs (``_dim_cost``), so the strategies it picks
there may differ from DTensor's stock choice; 2-D meshes keep the stock
costs (the per-dim ones pick strategies on which nemotron's train step
fails to propagate).

``compile_s`` becomes ``trace_s``.  The reference calibrates its costs
with two shallow depths (XLA counts a scanned layer once); the port keeps
that calibration (``_calibrated_costs``), though an eager trace counts
every layer, so the calibrated and raw counts agree for costs affine in
depth.  The selective scan of the SSM families loops over time in Python,
so their full-sequence cells trace the scan at two lengths
(``SCAN_STEPS``) and extrapolate affinely to the sequence (recorded under
``calibration``): the scan's steps are alike, so this is exact but for
one (B, S, d_inner) copy that places the untraced steps.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, cells, get_config
from ..kernels import shapes as kernel_shapes
from ..models import registry as R
from ..models.ssm import scan_steps
from ..sharding.logical import (
    DECODE_RULES,
    DEFAULT_RULES,
    ShardingRules,
    activate,
)
from ..training.optimizer import make_optimizer, tree_leaves, tree_map
from ..training.train_step import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
    tree_shardings,
)
from .mesh import make_mesh_shape, make_production_mesh
from .roofline import (FUNCTIONAL_OPS, HW, collectives_from_trace,
                       roofline_terms)

__all__ = ["lower_cell", "run_cell", "Trace", "SCAN_STEPS"]

# Scan lengths traced for the SSM families' full-sequence cells.
SCAN_STEPS = (2, 4)

_OWN = {"group": None}  # the fake process group this module started

# Ops that move no bytes: allocation without a write, autograd plumbing.
_NO_BYTES = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.detach.default",
    "aten.lift_fresh.default",
}


def _fake_world(n: int) -> None:
    """A process group of ``n`` ranks on the ``fake`` backend (rank 0)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if _OWN["group"] is None or dist.group.WORLD is not _OWN["group"]:
            raise RuntimeError("the dry-run needs its own process group; "
                               "another is active")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    _OWN["group"] = dist.group.WORLD


def _mesh(multi_pod: bool):
    shape, _ = make_mesh_shape(multi_pod)
    _fake_world(math.prod(shape))
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _dim_cost(current_spec, target_spec) -> float:
    """A redistribution's cost as the sum of DTensor's one-mesh-dim
    transition costs, in mesh-dim order (no path planning)."""
    from torch.distributed.tensor import _collective_utils as cu

    if current_spec.mesh != target_spec.mesh:
        return float("inf")
    if (current_spec.is_replicated()
            or current_spec.placements == target_spec.placements):
        return 0.0
    topo = cu.MeshTopoInfo.build_from_mesh(current_spec.mesh)
    comm = cu.spec_to_bytes(current_spec) / current_spec.num_shards / 2 ** 30
    cost = 0.0
    for i, (c, t) in enumerate(zip(current_spec.placements,
                                   target_spec.placements)):
        step, comm = cu._compute_placement_transition_cost(c, t, topo, i, comm)
        cost += step
    return cost


@contextlib.contextmanager
def _dim_costs():
    """DTensor's strategy costs priced by ``_dim_cost`` within (where this
    torch has the private pieces it needs)."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor._ops import utils as ops_utils

    if not all(hasattr(cu, n) for n in (
            "MeshTopoInfo", "spec_to_bytes", "_compute_placement_transition_cost",
            "redistribute_cost")) or not hasattr(ops_utils, "redistribute_cost"):
        yield  # a torch without these keeps its own costs
        return
    saved = cu.redistribute_cost, ops_utils.redistribute_cost
    cu.redistribute_cost = ops_utils.redistribute_cost = _dim_cost
    try:
        yield
    finally:
        cu.redistribute_cost, ops_utils.redistribute_cost = saved


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size()


def _leaves_of(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves_of(v)


class _Counter(TorchDispatchMode):
    """Counts the local ops of a DTensor trace (see the module note)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, float, int]] = []
        self.kernels: dict[str, list] = {}

    def kernel(self, name: str, flops: float, moved: float) -> None:
        self.flops += flops
        self.bytes += moved
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor unwraps; its local ops come back
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape propagation, not a local op
        if func.namespace == "_c10d_functional":
            name = func._opname
            if name in FUNCTIONAL_OPS:
                self.collectives.append(
                    (name, float(_tensor_bytes(out)), _group_size(args[-1])))
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or str(func) in _NO_BYTES:
            return out
        moved = sum(_tensor_bytes(t) for t in _leaves_of(args))
        moved += sum(_tensor_bytes(t) for t in _leaves_of(out))
        self.bytes += moved
        return out


def _group_size(group_name: str) -> int:
    import torch.distributed as dist

    return dist.distributed_c10d._resolve_process_group(group_name).size()


@dataclasses.dataclass
class Trace:
    """One cell's traced step: per-rank counts and the trace's seconds."""

    flops: float
    bytes: float
    collectives: list
    kernels: dict
    argument_bytes: int
    trace_s: float

    @property
    def coll(self):
        return collectives_from_trace(self.collectives)


def _place(tree, shardings):
    """Meta tensors -> DTensors of meta local shards; None stays as is."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        if sh is None:
            return t
        local = torch.empty(sh.shard_shape(t.shape), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    return tree_map(one, tree, shardings)


def _argument_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                total += _tensor_bytes(getattr(leaf, "_local_tensor", leaf))
    return total


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    zero1: bool = False,
    overrides: dict | None = None,
    rule_overrides: dict | None = None,
    scan: int | None = None,
):
    """Trace one cell; returns (trace, meta, cfg, shape).  No allocation.
    ``scan``: the selective scan's traced steps (None: all)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = _mesh(multi_pod)
    rule_table = dict(DECODE_RULES if shape.kind == "decode" else DEFAULT_RULES)
    if rule_overrides:
        rule_table.update(rule_overrides)
    rules = ShardingRules(mesh, rule_table)
    chips = mesh.size()

    params_abs = R.abstract_params(cfg)
    paxes = R.param_axes(cfg)
    params = _place(params_abs, tree_shardings(rules, paxes, params_abs))
    batch_abs = R.input_specs(cfg, shape)
    batch = _place(batch_abs,
                   tree_shardings(rules, R.batch_axes(cfg, shape), batch_abs))
    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        opt_abs = opt.init(params_abs)
        opt_state = _place(opt_abs, tree_shardings(
            rules, opt.state_axes(paxes), opt_abs, zero1=zero1))
        step = make_train_step(cfg, opt)
        args = (params, opt_state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        args = (params, batch)
    else:  # decode
        enc_len = min(shape.seq_len, 32768)
        cache_abs = R.make_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta", enc_len=enc_len)
        caxes = R.cache_axes(cfg, shape.global_batch, shape.seq_len,
                             enc_len=enc_len)
        cache = _place(cache_abs, tree_shardings(rules, caxes, cache_abs))
        step = make_serve_step(cfg, shape.seq_len)
        args = (params, batch["token"], cache)
    arg_bytes = _argument_bytes(*args)

    counter = _Counter()
    t0 = time.perf_counter()
    costs = _dim_costs() if mesh.ndim >= 3 else contextlib.nullcontext()
    with costs, activate(rules), implicit_replication(), scan_steps(scan), \
            kernel_shapes.recording(counter.kernel), counter:
        step(*args)
    trace = Trace(counter.flops, counter.bytes, counter.collectives,
                  counter.kernels, arg_bytes, time.perf_counter() - t0)
    meta = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "zero1": zero1,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "rule_overrides": {k: str(v) for k, v in (rule_overrides or {}).items()},
    }
    return trace, meta, cfg, shape


def _model_flops(cfg, shape) -> float:
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


# ------------------------------------------------------------------ calibration
# XLA's HLO cost analysis counts a while-loop (lax.scan) body ONCE, so the
# reference's flops/bytes of a scanned-layer model are depth-independent.
# Cost is affine in depth (embed/head + L x body), so two shallow variants
# (depths L1 < L2, all widths full) extrapolate linearly to the real depth.
# The port's eager trace counts every layer; it keeps the calibration as
# the reference's, and its raw full-depth counts beside it.
def _depth_field_and_pair(cfg):
    if cfg.family == "hybrid":
        return {"n_layers": (cfg.attn_period, 2 * cfg.attn_period)}
    if cfg.family == "encdec":
        return {"n_layers": (2, 4), "n_enc_layers": (2, 4)}
    return {"n_layers": (2, 4)}


def _affine(y1: float, y2: float, scale: float) -> float:
    return y1 + (y2 - y1) * scale


def _scans(cfg, shape):
    """The scan lengths to trace: two for an SSM family's full-sequence
    cell, else (None,) (every step)."""
    if cfg.family in ("ssm", "hybrid") and shape.kind != "decode":
        return SCAN_STEPS
    return (None,)


def _measure(arch, shape_name, multi_pod, zero1, overrides, rule_overrides):
    """(trace at the longest scan, meta, flops, bytes, wire, scan
    calibration):
    counts extrapolated to the full sequence where the scan was cut."""
    cfg = dataclasses.replace(get_config(arch), **(overrides or {}))
    S = SHAPES[shape_name].seq_len
    runs = [lower_cell(arch, shape_name, multi_pod, zero1, overrides,
                       rule_overrides, scan=n)
            for n in _scans(cfg, SHAPES[shape_name])]
    meta = runs[-1][1]
    if len(runs) == 1:
        t = runs[0][0]
        return t, meta, t.flops, t.bytes, t.coll.wire_bytes_per_chip, {}
    (t1, t2), (n1, n2) = [r[0] for r in runs], SCAN_STEPS
    scale = (S - n1) / (n2 - n1)
    w1, w2 = t1.coll.wire_bytes_per_chip, t2.coll.wire_bytes_per_chip
    calib = {"scan_steps": [n1, n2], "seq_len": S,
             "scan_flops": [t1.flops, t2.flops],
             "scan_bytes": [t1.bytes, t2.bytes]}
    return (t2, meta, _affine(t1.flops, t2.flops, scale),
            _affine(t1.bytes, t2.bytes, scale), _affine(w1, w2, scale), calib)


def _calibrated_costs(arch, shape_name, multi_pod, zero1, overrides, cfg,
                      rule_overrides=None):
    """(flops, bytes, wire_bytes) extrapolated to full depth."""
    pairs = _depth_field_and_pair(cfg)
    L_full = cfg.n_layers
    ovr = dict(overrides or {})
    ovr["microbatch"] = None  # accumulation would also split the batch
    ovr["scan_layers"] = False  # the reference's unrolled layers
    o1 = dict(ovr, **{k: v[0] for k, v in pairs.items()})
    o2 = dict(ovr, **{k: v[1] for k, v in pairs.items()})
    _, _, f1, b1, c1, _ = _measure(arch, shape_name, multi_pod, zero1, o1,
                                   rule_overrides)
    _, _, f2, b2, c2, _ = _measure(arch, shape_name, multi_pod, zero1, o2,
                                   rule_overrides)
    L1, L2 = pairs["n_layers"]
    scale = (L_full - L1) / (L2 - L1)
    flops = f1 + (f2 - f1) * scale
    byt = b1 + (b2 - b1) * scale
    wire = c1 + (c2 - c1) * scale
    return flops, byt, wire, {"L1": L1, "L2": L2, "f1": f1, "f2": f2}


def run_cell(arch, shape_name, multi_pod=False, zero1=False, overrides=None,
             out_dir="build/dryrun", tag="", calibrate=True,
             rule_overrides=None):
    t0 = time.perf_counter()
    trace, meta, raw_flops, raw_bytes, raw_wire, scan_calib = _measure(
        arch, shape_name, multi_pod, zero1, overrides, rule_overrides)
    t_cell = time.perf_counter() - t0
    cfg = dataclasses.replace(get_config(arch), **(overrides or {}))
    shape = SHAPES[shape_name]
    coll = trace.coll
    if calibrate:
        flops, byt, wire, calib = _calibrated_costs(
            arch, shape_name, multi_pod, zero1, overrides, cfg, rule_overrides
        )
    else:
        flops, byt, wire, calib = raw_flops, raw_bytes, raw_wire, {}
    coll.wire_bytes_per_chip = wire
    calib.update(scan_calib)
    terms = roofline_terms(
        flops, byt, coll,
        model_flops_global=_model_flops(cfg, shape), chips=meta["chips"],
    )
    result = {
        **meta,
        "ok": True,
        "trace_s": round(trace.trace_s, 2),
        "cell_s": round(t_cell, 2),
        "flops_per_chip": flops,
        "bytes_per_chip": byt,
        "raw_flops_uncalibrated": raw_flops,
        "raw_bytes_uncalibrated": raw_bytes,
        "raw_wire_uncalibrated": raw_wire,
        "calibration": calib,
        "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                    for k, v in trace.kernels.items()},
        "memory_analysis": {"argument_bytes": trace.argument_bytes},
        "hbm_bytes": HW.hbm_bytes,
        **terms,
    }
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{result['mesh']}{('__' + tag) if tag else ''}.json"
    (out / name).write_text(json.dumps(result, indent=2, default=str))
    return result


def main():
    ap = argparse.ArgumentParser(description="LifeRaft port multi-pod dry-run")
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every live cell")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (int/float/bool literal)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding-rule override name=axis1,axis2 (or 'none')")
    args = ap.parse_args()

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    rule_overrides = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rule_overrides[k] = None if v == "none" else tuple(v.split(","))

    todo = cells() if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in todo:
        try:
            r = run_cell(arch, shape, args.multi_pod, args.zero1,
                         overrides or None, args.out, args.tag,
                         rule_overrides=rule_overrides or None)
            print(
                f"OK  {arch:26s} {shape:12s} {r['mesh']:8s} "
                f"trace={r['trace_s']:7.1f}s flops/chip={r['flops_per_chip']:.3e} "
                f"tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                f"tx={r['t_collective_s']:.4f} dom={r['dominant']}"
            )
            print("  memory_analysis:", json.dumps(r["memory_analysis"]))
            print("  cost_analysis: flops={:.3e} bytes={:.3e}".format(
                r["flops_per_chip"], r["bytes_per_chip"]))
        except Exception:
            failures += 1
            print(f"FAIL {arch} {shape} multi_pod={args.multi_pod}")
            traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
