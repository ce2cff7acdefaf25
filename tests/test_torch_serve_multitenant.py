"""``repro_torch.examples.serve_multitenant`` held against
``examples/serve_multitenant.py``, on the CPU.

The reference's weights (``init_params`` from ``PRNGKey(0)``) and adapter
deltas (``PRNGKey(10 + a)``) are made here with JAX and carried into the
port through ``models.convert.params_from_numpy``, bit for bit; the
reference runs as its script (``runpy``, its ``--requests`` cut to 24 from
60 for time: each of its runs compiles the decode step anew).  The
printed report -- the engine summary, the controller or per-tenant
lines, the real tokens decoded per tenant, the Prometheus exposition --
must equal the reference's line for line, and ``--metrics-json``'s
snapshot its snapshot (the serving engine's clock is simulated).  The
port's own seeded weights (torch generators on the CPU) decode the same
schedule.
"""
from __future__ import annotations

import json
import pathlib
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.examples import serve_multitenant as t_serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REQUESTS = "24"
FLAGS = {
    "liferaft": [],
    "rr": ["--policy", "rr"],
    "adaptive": ["--adaptive", "--metrics"],
    "per-tenant": ["--per-tenant", "--metrics-json", "snap.json"],
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small ops: the test workers share the
    host's cores, and thread pools fighting over them cost more than the
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    """The reference's parameters and adapter deltas, in the port."""
    cfg = j_smoke(t_serve.ARCH)
    params = JR.init_params(cfg, jax.random.PRNGKey(0))
    deltas = [
        np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(10 + a),
                                            params["unembed"].shape))
        for a in range(t_serve.N_ADAPTERS)
    ]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (params_from_numpy(t_smoke(t_serve.ARCH), tree, "cpu"),
            [torch.from_numpy(np.array(d)) for d in deltas])


def _reference(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["serve_multitenant.py", "--requests",
                                      REQUESTS, *flags])
    runpy.run_path(str(ROOT / "examples" / "serve_multitenant.py"),
                   run_name="__main__")
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("mode", list(FLAGS))
def test_serve_multitenant_matches_reference(mode, carried, monkeypatch,
                                             capsys, tmp_path):
    # each writes its snapshot into its own working directory
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    want = _reference(monkeypatch, capsys, FLAGS[mode])
    monkeypatch.chdir(tmp_path / "port")
    params, deltas = carried
    args = t_serve.build_parser().parse_args(
        ["--requests", REQUESTS, "--device", "cpu",
         "--out", str(tmp_path / "report.json"), *FLAGS[mode]])
    report = t_serve.run(args, params=params, deltas=deltas)
    got = [line for line in capsys.readouterr().out.splitlines()
           if not line.startswith("  decode: ")]
    assert got == want
    tokens = {str(a): n for a, n in report["decoded_tokens"].items()}
    assert sum(tokens.values()) == report["summary"]["n_completed"] * 16
    assert report["decode_steps"] == 16 * report["decode_calls"]
    on_disk = json.loads((tmp_path / "report.json").read_text())
    assert on_disk["device"] == "cpu" and on_disk["decoded_tokens"] == tokens
    if mode == "per-tenant":
        assert json.loads((tmp_path / "port" / "snap.json").read_text()) == \
            json.loads((tmp_path / "ref" / "snap.json").read_text())


def test_seeded_weights_decode_the_same_schedule(carried, tmp_path):
    """The port's own weights (seeded generators on the CPU) change the
    tokens, not the schedule: the summary and counts equal the carried
    run's."""
    params, deltas = carried

    def run(**kw):
        args = t_serve.build_parser().parse_args(
            ["--requests", "12", "--device", "cpu", "--out", ""])
        return t_serve.run(args, verbose=False, **kw)

    seeded, ref = run(), run(params=params, deltas=deltas)
    for k in ("summary", "decoded_tokens", "decode_calls", "decode_steps"):
        assert seeded[k] == ref[k]
    again = t_serve.make_params(t_smoke(t_serve.ARCH), "cpu")
    first = t_serve.make_params(t_smoke(t_serve.ARCH), "cpu")
    assert torch.equal(again["unembed"], first["unembed"])
