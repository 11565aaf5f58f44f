"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<name>.json``), its traffic
(``traffic/<name>.json``), the traffic's capture (``captures/<name>.json``)
and its limits (``limits/<cell>.json``); the drive and the check the
traffic names (``drives/<name>.py``, ``checks/<name>.py``); each per-layer
metric's reader (``metrics/<name>.py``).  A new cell, configuration,
traffic mix or metric is new files and new entries: nothing here names
one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _read(ROOT / "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names read in."""

    name: str
    chips: int
    config_path: Path
    config: dict
    traffic: dict
    capture: dict
    limits: dict
    end_to_end: tuple  # the end-to-end metric entries this cell reports
    per_layer: tuple  # the per-layer metric entries this cell reports


def _reports(metric: dict, cell: str, end_to_end_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def cell(name: str) -> Cell:
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = _read(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name, names))
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_path=ROOT / conf["file"],
        config=_read(ROOT / conf["file"]),
        traffic=traffic,
        capture=_read(HERE / "captures" / f"{traffic['capture']}.json"),
        limits=_read(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported by path (names
    may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
