"""BENCHMARK.json and the files it names: each found by name, and the
manifest check refusing what the benchmark's rules refuse."""
import copy

import pytest

from liferaft_bench import PACKAGE, ROOT, manifest


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        c = manifest.cell(bench, w["name"])
        assert c.config["name"] == w["config"]
        assert c.mix["prompt_len"] + c.mix["new_tokens"] <= c.mix["cache_slots"]
        assert c.limits["numbers"]
        assert all("limit" in v for v in c.limits["numbers"].values())


def test_every_metric_finds_its_reader(bench):
    for p in bench["per_layer"]:
        assert callable(manifest.reader(p["name"]))


def test_paths_hold_the_files(bench):
    assert bench["paths"] == ["liferaft_bench"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).resolve().is_relative_to(PACKAGE)


def test_cells_report_what_their_metrics_move(bench):
    for w in bench["workloads"]:
        e2e = {e["name"] for e in manifest.end_to_end_of(bench, w["name"])}
        assert {"setup_s", "decode_tokens_per_s", "decode_itl_p95_ms"} <= e2e
        for p in manifest.per_layer_of(bench, w["name"]):
            assert p["moves"] in e2e


def _broken(bench, edit):
    m = copy.deepcopy(bench)
    edit(m)
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


@pytest.mark.parametrize("edit", [
    lambda m: m["workloads"][0].update(chips=4),
    lambda m: m["per_layer"][0].update(unit="tokens per second"),
    lambda m: m["per_layer"][0].update(unit="x" * 17),
    lambda m: m["per_layer"][0].update(name="k4 roofline"),
    lambda m: m["workloads"][0].update(name="a/b"),
    lambda m: m["end_to_end"][0].update(bound=0.3),
    lambda m: m["end_to_end"].pop(),  # setup_s
    lambda m: m["per_layer"][0].update(moves="setup_s"),
    lambda m: m["per_layer"][1].update(workloads=["nope"]),
    lambda m: m["per_layer"][0].update(why="a key the contract has not"),
    lambda m: m["workloads"].append(dict(m["workloads"][0], name="again")),
    lambda m: m["configs"][0].update(file="elsewhere/x.json"),
    lambda m: m["workloads"][0].update(traffic="no-such-mix"),
], ids=["four-chips", "unit-space", "unit-long", "name-space", "name-slash",
        "bound", "no-setup", "moves-setup", "cells", "extra-key",
        "pair-twice", "file-outside", "missing-mix"])
def test_manifest_check_refuses(bench, edit):
    _broken(bench, edit)


def test_a_metric_without_its_moved_metric_is_refused(bench):
    def edit(m):
        e = next(x for x in m["end_to_end"] if x["name"] == "decode_itl_p95_ms")
        e["workloads"] = [m["workloads"][0]["name"]]
    _broken(bench, edit)
