"""The port's sequence-parallel decode held against the unsharded port and
the JAX reference, on the CPU.

Two ``gloo`` ranks (subprocesses) hold a (1, 2) ("data", "model") mesh with
``DECODE_RULES`` active, so the decode cache's sequence is sharded over
"model": each rank's K4 call returns its shard's (out, max, sum)
(``ops.paged_attention_partials``) and ``attention._local_decode`` merges
them with all-reduces.  The weights are the reference's smoke-config init,
carried in bit for bit (``models.convert.params_from_numpy``) and placed
by the rules as ``tests/test_torch_dryrun.py``'s gloo prefill places
them.  B = 2 sequences decode ``STEPS`` = 12 greedy steps from seeded
tokens into a 16-slot cache: each rank holds 8 slots, so in steps 0-7 the
second shard is still empty (its K4 call sees length 0) and in steps
8-11 both shards hold slots.

Tolerances, in float32, over the padded vocab's logits at every step:

* sharded against the unsharded port: 1e-5.  The two differ only in the
  order of f32 sums: the row-parallel products' partial sums reduced
  across the ranks, and the softmax merged from two shards' (max, sum)
  where one call takes the whole cache (logits here are below 1;
  measured 1.1e-6);
* against the reference's jitted decode: 1e-4, the port's decode
  tolerance (``tests/test_torch_serving.py``; measured 4.7e-6).

The greedy tokens of all three are equal at every step.
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import registry as JR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHARD_TOL = 1e-5
LOGIT_TOL = 1e-4
B, SLOTS, STEPS = 2, 16, 12
# dense (heads, ff and vocab over "model") and MoE (experts over "model")
ARCHS = ["codeqwen1.5-7b", "moonshot-v1-16b-a3b"]

_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import smoke_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding.logical import DECODE_RULES, ShardingRules, activate
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_step import tree_shardings

rank, port, arch, where = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
B, S, STEPS = %(B)d, %(S)d, %(STEPS)d
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
cfg = smoke_config(arch)
flat = np.load(f"{where}/params.npz")
tree = {}
for key in flat.files:
    *path, leaf = key.split("/")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = flat[key]
params = params_from_numpy(cfg, tree, "cpu")
tokens = torch.from_numpy(np.load(f"{where}/tokens.npy"))
step = R.decode_fn(cfg, S)

def run(params, cache, put=lambda t: t, full=lambda t: t):
    logits, toks, token = [], [], tokens
    for _ in range(STEPS):
        out, cache = step(params, put(token), cache)
        out = full(out)
        logits.append(out[:, -1].numpy())
        token = torch.argmax(out[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(token[:, 0].numpy())
    return np.stack(logits), np.stack(toks)

want = run(params, R.make_cache(cfg, B, S, device="cpu"))

mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
rules = ShardingRules(mesh, dict(DECODE_RULES))

def place(t, sh):
    if sh is None:
        return t
    return DTensor.from_local(t[sh.local_slices(t.shape)].contiguous(), mesh,
                              sh.placements, run_check=False, shape=t.shape,
                              stride=t.stride())

sharded = tree_map(place, params,
                   tree_shardings(rules, R.param_axes(cfg), params))
cache = R.make_cache(cfg, B, S, device="cpu")
cache = tree_map(place, cache,
                 tree_shardings(rules, R.cache_axes(cfg, B, S), cache))
tok_sh = rules.sharding_for(("batch", "seq"), tokens.shape)

lens = []
partials = ops.paged_attention_partials

def counted(q, kp, vp, table, seq_lens):
    lens.append(int(seq_lens.max()))
    return partials(q, kp, vp, table, seq_lens)

ops.paged_attention_partials = counted
with activate(rules), implicit_replication():
    got = run(sharded, cache, put=lambda t: place(t, tok_sh),
              full=lambda t: t.full_tensor())
info = {"cache": [str(p) for p in cache["k"].placements],
        "lens": lens, "local_slots": cache["k"].to_local().shape[2]}
if rank == 0:
    np.savez(f"{where}/out.npz", got_logits=got[0], got_tokens=got[1],
             want_logits=want[0], want_tokens=want[1])
print(json.dumps(info))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _reference(jcfg, jp, tokens):
    """The reference's jitted greedy decode: logits (STEPS, B, V) and
    tokens (STEPS, B)."""
    jstep = jax.jit(JR.decode_fn(jcfg, SLOTS))
    cache = JR.make_cache(jcfg, B, SLOTS)
    tok = jnp.asarray(tokens)
    logits, toks = [], []
    for _ in range(STEPS):
        out, cache = jstep(jp, tok, cache)
        logits.append(np.asarray(out[:, -1]))
        tok = jnp.argmax(out[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok[:, 0]))
    return np.stack(logits), np.stack(toks)


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request, tmp_path_factory):
    """Both ranks' run of one arch: the sharded and unsharded port's
    logits and tokens, each rank's record, and the reference's."""
    arch = request.param
    where = tmp_path_factory.mktemp(arch.replace(".", "_"))
    jcfg = j_smoke(arch)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    np.savez(where / "params.npz", **_flatten(jax.device_get(jp)))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    np.save(where / "tokens.npy", tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = _SCRIPT % dict(B=B, S=SLOTS, STEPS=STEPS)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), port, arch, str(where)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in (0, 1)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    infos = [json.loads(out.strip().splitlines()[-1]) for out, _ in results]
    port_out = dict(np.load(where / "out.npz"))
    return arch, jcfg, infos, port_out, _reference(jcfg, jp, tokens)


def test_cache_is_sequence_sharded_and_the_second_shard_starts_empty(decoded):
    """The cache's batch over "data" and its slots over "model" (Shard(1)
    and Shard(2) of (L, B, S, KV, D)), 8 slots a rank; one partials call a layer a step on each rank; rank 1's shard
    holds no slot before step 8."""
    arch, jcfg, infos, _, _ = decoded
    half = SLOTS // 2
    for rank, info in enumerate(infos):
        assert info["cache"] == ["S(1)", "S(2)"]
        assert info["local_slots"] == half
        assert len(info["lens"]) == STEPS * jcfg.n_layers
        want = [min(max(s + 1 - rank * half, 0), half)
                for s in range(STEPS) for _ in range(jcfg.n_layers)]
        assert info["lens"] == want
    assert infos[1]["lens"][:half * jcfg.n_layers] == [0] * half * jcfg.n_layers


def test_sharded_decode_equals_unsharded_port(decoded):
    _, _, _, out, _ = decoded
    np.testing.assert_allclose(out["got_logits"], out["want_logits"],
                               rtol=SHARD_TOL, atol=SHARD_TOL)
    np.testing.assert_array_equal(out["got_tokens"], out["want_tokens"])


def test_sharded_decode_equals_reference(decoded):
    _, _, _, out, (ref_logits, ref_tokens) = decoded
    np.testing.assert_allclose(out["got_logits"], ref_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(out["got_tokens"], ref_tokens)
    assert len(set(ref_tokens[:, 0].tolist())) > 1  # the greedy path moves


def test_unsharded_port_equals_reference(decoded):
    _, _, _, out, (ref_logits, ref_tokens) = decoded
    np.testing.assert_allclose(out["want_logits"], ref_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(out["want_tokens"], ref_tokens)
