"""The yardstick's arithmetic against hand-worked values."""
import pytest

from liferaft_bench import roofline
from liferaft_bench.reference.decoder import spec_from_config
from liferaft_bench.manifest import cell, load


def test_bound():
    ms, by = roofline.bound(3.35e9, 1e9, 989e12)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(1.0, 989e9, 989e12)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_k4_call():
    # 2 sequences x 10 slots x 2 KV heads x 4 dims x 2 bytes, K and V; q and
    # out 2 x 6 heads x 4 x 2 bytes each.
    nbytes, flops = roofline.k4_call(2, 6, 2, 4, 10, 2)
    assert nbytes == 2 * (2 * 10 * 2 * 4 * 2) + 2 * (2 * 6 * 4 * 2)
    assert flops == 4 * 2 * 6 * 10 * 4


def test_k5_call():
    nbytes, flops = roofline.k5_call(3, 10, 8, 16, 2)
    assert nbytes == 3 * 8 * 16 * 2 + 10 * (8 + 16) * 2
    assert flops == 2 * 10 * 8 * 16


def test_token_flops_mixtral():
    spec = spec_from_config(cell(load(), "mixtral-8x22b.decode-spread-b384").config)
    d = 6144
    attn = d * (48 + 16) * 128 + 48 * 128 * d
    ffn = 2 * 3 * d * 16384 + d * 8
    want = 2 * (8 * (attn + ffn) + 32768 * d) + 4 * 1792 * 48 * 128 * 8
    assert roofline.token_flops(spec, 1792) == want
    assert 11.5e9 < want < 12.0e9  # the issue's 11.8 GFLOP a token


def test_shares_from_readers():
    from types import SimpleNamespace

    from liferaft_bench import manifest, trace
    spec = spec_from_config(cell(load(), "mistral-large-123b.decode-1k-b64").config)
    kern = [("void paged_attention_tc_kernel<128>(Args)", 0, 1_000_000)] * 8
    kern += [("nvjet_tst_128x64", 0, 3_000_000)]
    tr = trace.Trace(window_s=0.02, kernels=kern, busy_s=0.011,
                     idle_by_host={}, n_copies=0)
    ctx = SimpleNamespace(spec=spec, mix={}, batch=64, itemsize=2, steps=1,
                          positions=[1023], trace=tr, untraced_s=0.02,
                          untraced_positions=[1023], k5_calls=None,
                          memory_peak_bytes=2**31)
    b, f = roofline.k4_call(64, 96, 8, 128, 1024, 2)
    want = 100 * 8 * roofline.bound(b, f, 989e12)[0] / 1e3 / 8e-3
    assert manifest.reader("k4_roofline.decode")(ctx) == pytest.approx(want)
    assert manifest.reader("dense_ms_per_step.decode")(ctx) == pytest.approx(3.0)
    assert manifest.reader("launches_per_step.decode")(ctx) == 9
    assert manifest.reader("device_idle.decode")(ctx) == pytest.approx(45.0)
    assert manifest.reader("peak_mem_gib.decode")(ctx) == 2.0
    assert manifest.reader("k5_roofline.decode")(ctx) is None
    mfu = 100 * 64 * roofline.token_flops(spec, 1024) / (0.02 * 989e12)
    assert manifest.reader("mfu.decode")(ctx) == pytest.approx(mfu)
    ctx.trace = tr = trace.Trace(0.02, kern[:7], 0.01, {}, 0)  # a launch lost
    assert manifest.reader("k4_roofline.decode")(ctx) is None
