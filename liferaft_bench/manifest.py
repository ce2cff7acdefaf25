"""``BENCHMARK.json``: loaded, checked, and resolved to a cell's files.

Every configuration, traffic mix, cell's limits and per-layer metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json`` (the entry's ``file``),
``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.  Adding one of them is adding a file and an
entry; no shared code changes.

``validate`` is the manifest check that every run makes before it
touches the device: the keys and the characters of every name and unit,
that each cell reports what its per-layer metrics move, and that no cell
asks for more than one chip.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

from . import PACKAGE, ROOT

__all__ = ["ManifestError", "load", "validate", "Cell", "cell",
           "end_to_end_of", "per_layer_of", "reader"]

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
_UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
_PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
_TOP = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
_CONFIG = {"name", "source", "file", "reduced", "why"}
_CELL = {"name", "config", "traffic", "chips", "why"}
_E2E = {"name", "unit", "better", "bound", "source"}
_LAYER = {"name", "unit", "better", "source", "layer", "moves"}
_SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CHIPS = 1  # every cell of this benchmark runs on one card


class ManifestError(ValueError):
    pass


def _fail(msg: str):
    raise ManifestError(msg)


def _line(text, what: str) -> None:
    if (not isinstance(text, str) or not 1 <= len(text) <= 200
            or "\n" in text or "\t" in text):
        _fail(f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not _NAME.match(text):
        _fail(f"{what} {text!r}: a letter, digit or _ first, then at most 63 "
              f"of letters, digits, _, . and -")


def _keys(entry: dict, required: set, what: str, optional=()) -> None:
    keys = set(entry)
    if not required <= keys or keys - required - set(optional):
        _fail(f"{what}: keys {sorted(keys)}, want {sorted(required)}"
              + (f" and optionally {sorted(optional)}" if optional else ""))


def _metric(m: dict, what: str, required: set, cells: set,
            sources: set) -> None:
    _keys(m, required, what, optional=("workloads",))
    _name(m["name"], f"{what} name")
    if not isinstance(m["unit"], str) or not _UNIT.match(m["unit"]):
        _fail(f"{what} {m['name']}: unit {m['unit']!r}: 1 to 16 of letters, "
              f"digits, _, /, %, . and -")
    if m["better"] not in ("lower", "higher"):
        _fail(f"{what} {m['name']}: better is lower or higher")
    if m["source"] not in sources:
        _fail(f"{what} {m['name']}: source {m['source']!r} not in "
              f"{sorted(sources)}")
    ws = m.get("workloads")
    if ws is not None and (not ws or not set(ws) <= cells):
        _fail(f"{what} {m['name']}: workloads {ws} are not cells")


def validate(m: dict, root: pathlib.Path = ROOT) -> None:
    """Raise ``ManifestError`` where ``m`` breaks the benchmark's rules."""
    _keys(m, _TOP, "BENCHMARK.json")
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        _fail("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "a word of command")
        if word.startswith("/") or ".." in word.split("/"):
            _fail(f"command word {word!r} leaves the checkout")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        _fail("paths: 1 to 16 directories")
    for p in paths:
        if (not isinstance(p, str) or not _PATH.match(p) or p.startswith("/")
                or ".." in p.split("/")):
            _fail(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        _fail("run_seconds: a whole number from 1 to 51")

    configs = m["configs"]
    if not (isinstance(configs, list) and 1 <= len(configs) <= 24):
        _fail("configs: 1 to 24 entries")
    for c in configs:
        _keys(c, _CONFIG, "a config")
        _name(c["name"], "config name")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            _fail(f"config {c['name']}: file {c['file']} is outside paths")
        if not (root / c["file"]).is_file():
            _fail(f"config {c['name']}: no file {c['file']}")
        red = c["reduced"]
        if not isinstance(red, list) or len(red) > 16:
            _fail(f"config {c['name']}: reduced is a list of at most 16 keys")
        for k in red:
            _name(k, f"config {c['name']} reduced key")
    names = [c["name"] for c in configs]
    files = [c["file"] for c in configs]
    if len(set(names)) != len(names) or len(set(files)) != len(files):
        _fail("two configs share a name or a file")

    cells = m["workloads"]
    if not (isinstance(cells, list) and 1 <= len(cells) <= 24):
        _fail("workloads: 1 to 24 cells")
    pairs = set()
    for w in cells:
        _keys(w, _CELL, "a cell")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"cell {k}")
        _line(w["why"], f"cell {w['name']} why")
        if w["config"] not in names:
            _fail(f"cell {w['name']}: no config {w['config']}")
        if w["chips"] != CHIPS:
            _fail(f"cell {w['name']}: asks for {w['chips']} chips; every cell "
                  f"of this benchmark takes {CHIPS}")
        if (w["config"], w["traffic"]) in pairs:
            _fail(f"cell {w['name']}: its config and traffic pair repeats")
        pairs.add((w["config"], w["traffic"]))
        for f in (PACKAGE / "traffic" / f"{w['traffic']}.json",
                  PACKAGE / "limits" / f"{w['name']}.json"):
            if not f.is_file():
                _fail(f"cell {w['name']}: no file {f.relative_to(PACKAGE)}")
    cell_names = {w["name"] for w in cells}
    if len(cell_names) != len(cells):
        _fail("two cells share a name")
    unused = set(names) - {w["config"] for w in cells}
    if unused:
        _fail(f"configs {sorted(unused)} are used by no cell")

    e2e, layer = m["end_to_end"], m["per_layer"]
    if not (isinstance(e2e, list) and 1 <= len(e2e) <= 16):
        _fail("end_to_end: 1 to 16 metrics")
    if not (isinstance(layer, list) and 1 <= len(layer) <= 128):
        _fail("per_layer: 1 to 128 metrics")
    for e in e2e:
        _metric(e, "end_to_end metric", _E2E, cell_names,
                {"host_clock", "device_trace"})
        b = e["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            _fail(f"end_to_end {e['name']}: bound in [0.01, 0.25]")
    if "setup_s" not in {e["name"] for e in e2e}:
        _fail("end_to_end has no setup_s")
    e2e_names = {e["name"] for e in e2e}
    for p in layer:
        _metric(p, "per_layer metric", _LAYER, cell_names, _SOURCES)
        _line(p["layer"], f"per_layer {p['name']} layer")
        if p["moves"] not in e2e_names - {"setup_s"}:
            _fail(f"per_layer {p['name']}: moves {p['moves']!r}, not an "
                  f"end-to-end metric")
        if not (PACKAGE / "metrics" / f"{p['name']}.py").is_file():
            _fail(f"per_layer {p['name']}: no reader metrics/{p['name']}.py")
    if len({x["name"] for x in e2e + layer}) != len(e2e) + len(layer):
        _fail("two metrics share a name")
    for w in cells:
        mine = {e["name"] for e in end_to_end_of(m, w["name"])}
        if "setup_s" not in mine or len(mine) < 2:
            _fail(f"cell {w['name']}: reports setup_s and one more "
                  f"end-to-end metric")
        if not per_layer_of(m, w["name"]):
            _fail(f"cell {w['name']}: reports no per-layer metric")
    for p in layer:
        for w in p.get("workloads") or sorted(cell_names):
            if p["moves"] not in {e["name"] for e in end_to_end_of(m, w)}:
                _fail(f"per_layer {p['name']}: cell {w} does not report "
                      f"{p['moves']}")


def load(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` at ``root``, validated."""
    path = root / "BENCHMARK.json"
    try:
        m = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise ManifestError(f"{path}: {exc}") from None
    validate(m, root)
    return m


def _of(metrics: list, cell_name: str) -> list:
    return [x for x in metrics
            if x.get("workloads") is None or cell_name in x["workloads"]]


def end_to_end_of(m: dict, cell_name: str) -> list:
    return _of(m["end_to_end"], cell_name)


def per_layer_of(m: dict, cell_name: str) -> list:
    return _of(m["per_layer"], cell_name)


class Cell:
    """One cell's entry and the files it names: ``config`` (the
    configuration as run), ``mix`` (the traffic's parameters) and
    ``limits`` (the correctness limits)."""

    def __init__(self, entry: dict, config: dict, mix: dict, limits: dict):
        self.name = entry["name"]
        self.entry = entry
        self.config = config
        self.mix = mix
        self.limits = limits


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell(m: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest ``m``, its files read."""
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise ManifestError(f"no cell {name!r}; cells: "
                            f"{[w['name'] for w in m['workloads']]}")
    w = found[0]
    (c,) = [c for c in m["configs"] if c["name"] == w["config"]]
    return Cell(w, _json(root / c["file"]),
                _json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
                _json(PACKAGE / "limits" / f"{name}.json"))


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = PACKAGE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "liferaft_bench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
