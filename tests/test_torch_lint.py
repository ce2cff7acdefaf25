"""liferaft-lint over the port: its decision paths guarded as the
reference's are.

``tools.analysis`` checks ``src/repro`` with the determinism pass scoped to
the reference's decision paths (``AnalyzerConfig.decision_paths``: core/,
serving/, crossmatch/engine.py), where everything journal replay
re-derives must be bit-stable.  Here every pass runs over
``src/repro_torch`` with those paths named in the port, and must find
nothing.  A copy of the determinism fixture placed under each of the
port's decision paths must be found there, so the scope is not empty.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.analysis.framework import AnalyzerConfig, analyze_paths  # noqa: E402
from tools.analysis.passes import ALL_PASSES  # noqa: E402
from tools.analysis.passes.determinism import DeterminismPass  # noqa: E402

DECISION_PATHS = ("src/repro_torch/core/", "src/repro_torch/serving/",
                  "src/repro_torch/crossmatch/engine.py")
PORT_CONFIG = AnalyzerConfig(decision_paths=DECISION_PATHS)
FIXTURE = REPO / "tests" / "lint_fixtures" / "det_bad.py"


def test_port_has_no_findings():
    findings = analyze_paths([str(REPO / "src" / "repro_torch")], ALL_PASSES,
                             PORT_CONFIG, root=str(REPO))
    assert findings == []


@pytest.mark.parametrize("path", DECISION_PATHS)
def test_each_decision_path_names_port_modules(path):
    target = REPO / path
    assert target.is_file() if path.endswith(".py") else \
        any(target.glob("*.py"))


@pytest.mark.parametrize("path", DECISION_PATHS)
def test_a_violation_on_a_decision_path_is_found(tmp_path, path):
    """det_bad.py's six findings (RNG, set order, wall clock), once copied
    to where a module of that path lives; none outside the paths."""
    where = tmp_path / (path if path.endswith("/") else path.rsplit("/", 1)[0])
    where.mkdir(parents=True)
    name = path.rsplit("/", 1)[1] if path.endswith(".py") else "planted.py"
    shutil.copy(FIXTURE, where / name)
    findings = analyze_paths([str(tmp_path)], [DeterminismPass()],
                             PORT_CONFIG, root=str(tmp_path))
    assert sorted(f.rule for f in findings) == [
        "det-rng", "det-rng", "det-set-order", "det-set-order",
        "det-wallclock", "det-wallclock"]
    outside = tmp_path / "src" / "repro_torch" / "models"
    outside.mkdir(parents=True)
    shutil.move(str(where / name), str(outside / name))
    assert analyze_paths([str(tmp_path)], [DeterminismPass()], PORT_CONFIG,
                         root=str(tmp_path)) == []
