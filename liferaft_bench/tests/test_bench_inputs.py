"""The inputs are the seed's: the same seed gives the same weights, K/V,
first tokens and sample; another seed gives others; large seeds work."""
import numpy as np
import torch

from liferaft_bench import check, inputs
from liferaft_bench.reference.decoder import spec_from_config

from .conftest import TINY_MOE

SPEC = spec_from_config(TINY_MOE)
BIG = 2**31 + 12345


def _flat(tree):
    return torch.cat([v.float().reshape(-1) for _, v in sorted(_leaves(tree))])


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def test_weights_repeat_for_a_seed():
    a, b = (inputs.make_weights(SPEC, BIG, "cpu") for _ in range(2))
    assert torch.equal(_flat(a), _flat(b))
    assert not torch.equal(_flat(a), _flat(inputs.make_weights(SPEC, BIG + 1, "cpu")))


def test_weight_scales():
    w = inputs.make_weights(SPEC, 3, "cpu")
    d = SPEC.d_model
    assert abs(float(w["layers"]["attn"]["wq"].float().std()) * d**0.5 - 1) < 0.1
    assert abs(float(w["layers"]["attn"]["wk"].float().std()) * d**0.5
               - inputs.K_STD) < 0.25
    assert abs(float(w["final_norm"].float().mean()) - 1) < 0.05


def test_prefill_and_tokens_repeat():
    k1, v1 = inputs.prefill_kv(SPEC, BIG, 1, 4, 24, "cpu")
    k2, v2 = inputs.prefill_kv(SPEC, BIG, 1, 4, 24, "cpu")
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    k3, _ = inputs.prefill_kv(SPEC, BIG, 0, 4, 24, "cpu")
    assert not torch.equal(k1, k3)
    t = inputs.first_tokens(BIG, 3, 128, 32768)
    assert np.array_equal(t, inputs.first_tokens(BIG, 3, 128, 32768))
    assert not np.array_equal(t, inputs.first_tokens(BIG, 4, 128, 32768))
    assert t.min() >= 0 and t.max() < 32768 and len(np.unique(t)) > 100


def test_sample_repeats_and_holds_the_last_batch():
    batches = [[np.zeros(16, np.int32)] * 9 for _ in range(3)]
    a = check.draw_sample(batches, 8, 4, BIG)
    assert a == check.draw_sample(batches, 8, 4, BIG)
    assert len(set(a)) == 8 and sum(b == 2 for b, _ in a) >= 4
