"""On the card: a tiny cut through K4 and K5 served by the harness comes
out correct and the fp8 control does not (``-m cuda``; skips without a
card)."""
import pytest
import torch

from liferaft_bench import check, control, run

from .conftest import MOE_CELL, TINY_DENSE, TINY_MOE, tiny_cell
from .test_bench_reference import BF16_LIMITS

# The tiny MoE cut on the card, from 8 seeds (31-38) at B = 4 x 8 tokens:
# its mean gap does not separate (program up to 0.00119, fp8 control from
# 0.00106), its K/V over the positions of routing margin > 0.1 does
# (program up to 0.00526, control from 0.0677).
CARD_MOE_LIMITS = {"routing_margin": 0.1,
                   "numbers": {"kv_rel_err": {"limit": 0.02}}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run._environment()
    from liferaft_bench import serve
    serve.build_kernels(lambda *a: None)
    return "cuda"


# K4's tensor-core instance takes head_dim 64-256: the tiny cut's heads
# are widened to 64 here.
WIDE = {"head_dim": 64}


@pytest.mark.cuda
@pytest.mark.parametrize("config,name,limits", [
    (TINY_DENSE, None, BF16_LIMITS), (TINY_MOE, MOE_CELL, CARD_MOE_LIMITS)],
    ids=["dense", "moe"])
def test_tiny_cut_on_the_card(bench, card, config, name, limits):
    cell = tiny_cell(dict(config, **WIDE), limits,
                     **({"name": name} if name else {}))
    r = run.run_cell(bench, cell, 2**31 + 3, 0.5, True, card, 0.0,
                     log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_fp8_control_fails_on_the_card(card):
    cell = tiny_cell(dict(TINY_DENSE, **WIDE), BF16_LIMITS, new_tokens=16,
                     cache_slots=48, batch=8, check_sequences=4)
    for seed in (31, 32, 33):
        r = control.readings(cell, seed, card, "fp8", log=lambda *a: None)
        ctl = {k: r[f"control_{k}"] for k in BF16_LIMITS["numbers"]}
        assert not check.judge(ctl, BF16_LIMITS)[0], r
