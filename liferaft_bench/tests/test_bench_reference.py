"""The reference against the port's plain CPU path at a tiny cut: in
float32 the two agree to rounding, and the reference rounded to bf16 (the
step below float32) fails the comparison; in bf16, the fp8 control fails
where the port passes."""
import pytest

from liferaft_bench import check, control
from liferaft_bench.reference.decoder import spec_from_config

from .conftest import MOE_CELL, TINY_DENSE, TINY_MOE, tiny_cell

F32_LIMITS = {"numbers": {"token_gap": {"limit": 1e-3},
                          "kv_rel_err": {"limit": 1e-4}}}


@pytest.mark.parametrize("config,name", [(TINY_DENSE, None),
                                         (TINY_MOE, MOE_CELL)],
                         ids=["dense", "moe"])
def test_f32_port_matches_and_bf16_fails(config, name):
    cfg = dict(config, torch_dtype="float32")
    cell = tiny_cell(cfg, F32_LIMITS, **({"name": name} if name else {}))
    for seed in (5, 2**31 + 7):
        r = control.readings(cell, seed, "cpu", "bf16", log=lambda *a: None)
        ok, _ = check.judge(r, F32_LIMITS)
        assert ok, r
        assert r["token_gap"] < 1e-4 and r["kv_rel_err"] < 1e-5, r
        ctl = {k: r[f"control_{k}"] for k in F32_LIMITS["numbers"]}
        assert not check.judge(ctl, F32_LIMITS)[0], r


# The tiny dense bf16 cut's limits, from 8 seeds (100-107) on the CPU
# (largest program reading / smallest control reading): token_gap_mean
# 0.00049 / 0.00437, kv_rel_err 0.00546 / 0.0678.
BF16_LIMITS = {"numbers": {"token_gap_mean": {"limit": 0.0015},
                           "kv_rel_err": {"limit": 0.02}}}


def test_fp8_control_fails_where_the_bf16_port_passes():
    cell = tiny_cell(TINY_DENSE, BF16_LIMITS, new_tokens=16, cache_slots=48,
                     batch=8, check_sequences=4)
    for seed in (21, 22, 2**31 + 23):
        r = control.readings(cell, seed, "cpu", "fp8", log=lambda *a: None)
        assert check.judge(r, BF16_LIMITS)[0], r
        ctl = {k: r[f"control_{k}"] for k in BF16_LIMITS["numbers"]}
        assert not check.judge(ctl, BF16_LIMITS)[0], r


def test_spec_from_the_cells_configs(bench):
    from liferaft_bench.manifest import cell
    s = spec_from_config(cell(bench, MOE_CELL).config)
    assert (s.d_model, s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff,
            s.n_experts, s.top_k, s.n_layers) == (6144, 48, 8, 128, 16384,
                                                   8, 2, 8)
