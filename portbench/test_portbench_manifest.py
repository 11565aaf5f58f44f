"""The manifest keeps to the benchmark's contract, and every cell finds
its configuration, traffic, capture, limits, drive, check and metric
readers by name.  Run: ``python -m pytest portbench -q``."""

import json
import re

import pytest

from portbench import manifest

BENCH = manifest.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = len(BENCH["workloads"])
    # A full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s of
    # compiling a cell, 1,200 s spare; with 24 cells, within 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files_by_name(name):
    cell = manifest.cell(name)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    manifest.load_module("drives", cell.traffic["drive"]).Drive
    check = manifest.load_module("checks", cell.traffic["check"])
    assert callable(check.compare)
    for m in cell.per_layer:
        assert callable(manifest.load_module("metrics", m["name"]).read)
        # A per-layer metric moves an end-to-end metric its cells report.
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    # Every number the check compares has a limit above zero.
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_configs_keep_the_published_widths():
    # NeuS2's configs/nerf/base.json: a 14 x 2 grid of 2^19 rows a level,
    # SDF MLP 64 x 1, RGB MLP 64 x 2.
    base = manifest.cell("base.b0").config
    enc = base["encoding"]
    assert (enc["n_levels"], enc["n_features_per_level"], enc["log2_hashmap_size"]) == (14, 2, 19)
    assert (base["network"]["n_neurons"], base["network"]["n_hidden_layers"]) == (64, 1)
    assert (base["rgb_network"]["n_neurons"], base["rgb_network"]["n_hidden_layers"]) == (64, 2)
