"""The port's logical sharding rules held against the JAX reference.

The reference's own cases of ``tests/test_sharding.py`` run against the
port (``spec_for``'s divisibility fallback and used-axis exclusion,
``tree_shardings``' zero1 augmentation, param-axes coverage); then every
leaf's spec of ``param_axes``, ``batch_axes``, ``cache_axes`` and every
optimizer's ``state_axes``, with and without zero1, is compared exactly
(as ``tuple(spec)``) for all 10 archs x their live shapes x both
production meshes.  The reference's side is built on an ``AbstractMesh``
of the production shape, which needs no devices; the port's on a
shape-only stand-in of a ``DeviceMesh`` (``mesh_dim_names`` and a
``shape`` tuple, all the rules read).  A cache's ``pos`` is an int32
scalar in the reference (spec ``()``) and a Python int in the port
(sharding ``None``).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import cells as ref_cells  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.sharding import logical as RL  # noqa: E402
from repro.training.optimizer import make_optimizer as ref_optimizer  # noqa: E402
from repro.training.train_step import tree_shardings as ref_tree_shardings  # noqa: E402
from repro_torch.configs import SHAPES, cells, get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh_shape  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.sharding import logical as L  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_step import tree_shardings  # noqa: E402

P = L.PartitionSpec
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")


class _Mesh:
    """Shape-only stand-in of a DeviceMesh (the rules read these two)."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)


def _rules(shape=(2, 16, 16), names=("pod", "data", "model"), table=None):
    return L.ShardingRules(_Mesh(shape, names),
                           dict(L.DEFAULT_RULES if table is None else table))


class TestSpecFor:
    """The reference's ``TestSpecFor`` cases, on the port."""

    def test_batch_takes_pod_and_data(self):
        spec = _rules().spec_for(("batch", "seq"), (256, 4096))
        assert spec == P(("pod", "data"), None)

    def test_divisibility_fallback_drops_axis(self):
        assert _rules().spec_for(("kv_heads",), (8,)) == P(None)

    def test_divisibility_fallback_prefix(self):
        assert _rules().spec_for(("batch",), (16,)) == P("pod")

    def test_used_axis_not_reassigned(self):
        spec = _rules().spec_for(("experts", "embed", "expert_ff"),
                                 (64, 1024, 2048))
        assert spec == P("model", None, None)

    def test_expert_ff_picks_up_when_experts_cant(self):
        spec = _rules().spec_for(("experts", "embed", "expert_ff"),
                                 (8, 1024, 2048))
        assert spec == P(None, None, "model")

    def test_decode_rules_shard_cache_seq(self):
        spec = _rules(table=L.DECODE_RULES).spec_for(
            ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim"),
            (32, 128, 32768, 8, 128))
        assert spec[2] == "model"
        assert spec[3] is None

    def test_vocab_padded_shards(self):
        assert _rules().spec_for(("vocab", "embed"), (256256, 1024)) == \
            P("model", None)

    def test_unknown_logical_name_replicates(self):
        assert _rules().spec_for(("nonexistent", None), (7, 13)) == \
            P(None, None)

    @pytest.mark.parametrize("logical,shape", [
        (("batch", "seq"), (256, 4096)), (("kv_heads",), (8,)),
        (("batch",), (16,)), (("experts", "embed", "expert_ff"), (64, 1024, 2048)),
        (("experts", "embed", "expert_ff"), (8, 1024, 2048)),
        (("vocab", "embed"), (256256, 1024)), (("nonexistent", None), (7, 13)),
        (("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim"),
         (32, 128, 32768, 8, 128)),
    ])
    @pytest.mark.parametrize("decode", [False, True])
    def test_equals_reference(self, logical, shape, decode):
        table = L.DECODE_RULES if decode else L.DEFAULT_RULES
        ref = RL.ShardingRules(AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                               dict(RL.DECODE_RULES if decode else RL.DEFAULT_RULES))
        assert tuple(_rules(table=table).spec_for(logical, shape)) == \
            tuple(ref.spec_for(logical, shape))


class TestTreeShardings:
    """The reference's ``TestTreeShardings`` cases, on the port."""

    def _rules(self):
        return _rules((1, 1), ("data", "model"))

    def test_zero1_augments_dim0(self):
        sh = tree_shardings(self._rules(), {"m": ("embed", "ff")},
                            {"m": torch.empty(64, 32, device="meta")}, zero1=True)
        assert sh["m"].spec[0] == "data"

    def test_zero1_skips_when_data_already_used(self):
        sh = tree_shardings(self._rules(), {"m": ("batch", "ff")},
                            {"m": torch.empty(64, 32, device="meta")}, zero1=True)
        assert sh["m"].spec[0] in (("pod", "data"), "data", ("data",))

    def test_structure_preserved(self):
        sh = tree_shardings(
            self._rules(), {"a": {"b": ("embed",)}, "c": ()},
            {"a": {"b": torch.empty(8, device="meta")},
             "c": torch.empty((), dtype=torch.int32, device="meta")})
        assert set(sh) == {"a", "c"}

    def test_python_int_leaf_maps_to_none(self):
        sh = tree_shardings(self._rules(), {"pos": ()}, {"pos": 0})
        assert sh == {"pos": None}


@pytest.mark.parametrize("arch", sorted({a for a, _ in cells()}))
def test_param_axes_match_abstract_shapes(arch):
    """Every leaf of ``param_axes`` is a tuple as long as its rank."""
    cfg = get_config(arch)
    axes, abstract = R.param_axes(cfg), R.abstract_params(cfg)

    def walk(ax, ab):
        if isinstance(ab, dict):
            assert set(ax) == set(ab)
            for k in ab:
                walk(ax[k], ab[k])
        else:
            assert isinstance(ax, tuple) and len(ax) == ab.dim(), (arch, ax)
            assert ab.device.type == "meta"

    walk(axes, abstract)


def _compare(port_sh, ref_sh, where):
    """Key for key; each leaf's spec equal as a tuple (None: pos)."""
    if isinstance(port_sh, dict):
        assert set(port_sh) == set(ref_sh), where
        for k in port_sh:
            _compare(port_sh[k], ref_sh[k], f"{where}/{k}")
        return
    if port_sh is None:  # a Python-int pos; the reference's int32 scalar
        assert tuple(ref_sh.spec) == (), where
        return
    assert tuple(port_sh.spec) == tuple(ref_sh.spec), (
        where, tuple(port_sh.spec), tuple(ref_sh.spec))


def _ref_abstract_opt(opt, params_abs):
    return jax.eval_shape(opt.init, params_abs)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted({a for a, _ in cells()}))
def test_every_leaf_spec_equals_reference(arch, multi_pod):
    assert cells() == ref_cells()
    shape, names = make_mesh_shape(multi_pod)
    ref_mesh = AbstractMesh(shape, names)
    mesh = _Mesh(shape, names)
    cfg, rcfg = get_config(arch), ref_config(arch)
    paxes, rpaxes = R.param_axes(cfg), RR.param_axes(rcfg)
    pabs, rpabs = R.abstract_params(cfg), RR.init_params(rcfg, mode="abstract")
    for table, rtable in ((L.DEFAULT_RULES, RL.DEFAULT_RULES),
                          (L.DECODE_RULES, RL.DECODE_RULES)):
        rules = L.ShardingRules(mesh, dict(table))
        rrules = RL.ShardingRules(ref_mesh, dict(rtable))
        _compare(tree_shardings(rules, paxes, pabs),
                 ref_tree_shardings(rrules, rpaxes, rpabs), f"{arch}/params")
        for name in OPTIMIZERS:
            opt, ropt = make_optimizer(name), ref_optimizer(name)
            oaxes, roaxes = opt.state_axes(paxes), ropt.state_axes(rpaxes)
            oabs = opt.init(pabs)
            roabs = _ref_abstract_opt(ropt, rpabs)
            for zero1 in (False, True):
                _compare(tree_shardings(rules, oaxes, oabs, zero1=zero1),
                         ref_tree_shardings(rrules, roaxes, roabs, zero1=zero1),
                         f"{arch}/{name}/zero1={zero1}")
    for a, sname in cells():
        if a != arch:
            continue
        sh, rsh = SHAPES[sname], REF_SHAPES[sname]
        rules = L.ShardingRules(mesh, dict(
            L.DECODE_RULES if sh.kind == "decode" else L.DEFAULT_RULES))
        rrules = RL.ShardingRules(ref_mesh, dict(
            RL.DECODE_RULES if sh.kind == "decode" else RL.DEFAULT_RULES))
        _compare(tree_shardings(rules, R.batch_axes(cfg, sh),
                                R.input_specs(cfg, sh)),
                 ref_tree_shardings(rrules, RR.batch_axes(rcfg, rsh),
                                    RR.input_specs(rcfg, rsh)),
                 f"{arch}/{sname}/batch")
        if sh.kind != "decode":
            continue
        B, S, enc = sh.global_batch, sh.seq_len, min(sh.seq_len, 32768)
        cabs = R.make_cache(cfg, B, S, device="meta", enc_len=enc)
        rcabs = RR.make_cache(rcfg, B, S, mode="abstract", enc_len=enc)
        _compare(tree_shardings(rules, R.cache_axes(cfg, B, S, enc_len=enc), cabs),
                 ref_tree_shardings(rrules, RR.cache_axes(rcfg, B, S, enc_len=enc),
                                    rcabs),
                 f"{arch}/{sname}/cache")


def test_input_specs_match_reference_shapes_and_dtypes():
    for arch, sname in cells():
        cfg, rcfg = get_config(arch), ref_config(arch)
        got = R.input_specs(cfg, SHAPES[sname])
        want = RR.input_specs(rcfg, REF_SHAPES[sname])
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


class TestPlacements:
    def test_pod_data_maps_to_two_shards_of_dim0(self):
        from torch.distributed.tensor import Replicate, Shard

        sh = L.NamedSharding(_Mesh((2, 16, 16), ("pod", "data", "model")),
                             P(("pod", "data"), None))
        assert list(sh.placements) == [Shard(0), Shard(0), Replicate()]

    def test_model_axis_on_dim1(self):
        from torch.distributed.tensor import Replicate, Shard

        sh = L.NamedSharding(_Mesh((16, 16), ("data", "model")),
                             P(None, "model", None))
        assert list(sh.placements) == [Replicate(), Shard(1)]
        assert sh.shard_shape((4, 32, 8)) == (4, 2, 8)


class TestShardHint:
    def test_noop_without_rules(self):
        x = torch.randn(2, 3, 4)
        assert L.current_rules() is None
        assert L.shard_hint(x, ("batch", "seq", "embed")) is x

    def test_noop_on_plain_tensor_under_rules(self):
        x = torch.randn(2, 3, 4)
        with L.activate(_rules((16, 16), ("data", "model"))):
            assert L.shard_hint(x, ("batch", "seq", "embed")) is x
        assert L.current_rules() is None
