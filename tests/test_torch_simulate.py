"""The port's event-driven simulator held against the JAX reference's.

The eight ``sim_*`` goldens replay bit-identically through the port's
``simulate_batched`` / ``simulate_sharded`` / ``run_policy``, built by the
very scenario code of ``tests/replay.py`` with every ``repro`` import
pointed at ``repro_torch`` (``port_replay``), and recorded through the
port's own journal codec.  The same traces through both packages' harness
give equal ``SimResult`` rows.
"""
from __future__ import annotations

import pathlib
import types

import pytest

pytest.importorskip("torch")

import replay  # noqa: E402
from repro.core import CostModel as JCost  # noqa: E402
from repro.core import run_policy as j_run_policy  # noqa: E402
from repro_torch.core import CostModel as TCost  # noqa: E402
from repro_torch.core import run_policy as t_run_policy  # noqa: E402

SIM_GOLDENS = sorted(n for n in replay.SCENARIOS if n.startswith("sim_"))


def _port_replay() -> types.ModuleType:
    """``tests/replay.py`` compiled with ``from repro.`` read as ``from
    repro_torch.``: the same scenarios, traces and recorders, built of the
    port's simulator, engines and journal codec; its cross-match engines
    run on ``device="cpu"`` (the port's default is the card)."""
    path = pathlib.Path(replay.__file__)
    src = path.read_text().replace("from repro.", "from repro_torch.")
    engine = "CrossMatchEngine(\n            catalog,"
    assert src.count(engine) == 2, "tests/replay.py's engines moved"
    src = src.replace(engine, engine + ' device="cpu",')
    mod = types.ModuleType("port_replay")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


port_replay = _port_replay()


def test_port_replay_uses_the_port():
    assert port_replay.encode_outcome.__module__ == "repro_torch.core.journal"
    assert replay.encode_outcome.__module__ == "repro.core.journal"


def test_all_eight_sim_goldens_are_covered():
    assert len(SIM_GOLDENS) == 8


@pytest.mark.parametrize("name", SIM_GOLDENS)
def test_sim_golden_replays_through_port(name):
    expect = replay.load_trace(replay.GOLDEN_DIR / f"{name}.json")
    got = port_replay.SCENARIOS[name]()
    divergence = replay.diff_traces(expect, got)
    assert not divergence, "\n".join(divergence)
    assert got == expect  # every field, not only the ones diff compares


@pytest.mark.parametrize("policy,fuse_k", [("liferaft", 1), ("liferaft", 3),
                                           ("rr", 1), ("noshare", 1)])
def test_run_policy_rows_match_reference(policy, fuse_k):
    kw = dict(alpha=0.25, cache_capacity=8, fuse_k=fuse_k)
    j = j_run_policy(policy, replay.sim_trace(11), replay._identity_range,
                     JCost(T_b=0.8, T_m=2e-4), **kw)
    t = t_run_policy(policy, port_replay.sim_trace(11),
                     port_replay._identity_range, TCost(T_b=0.8, T_m=2e-4),
                     **kw)
    assert t.row() == j.row()
