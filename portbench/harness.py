"""One run of one cell: the capture from the seed, the program's set-up
and warm-up, the measured window, a traced window with ``--trace 1``,
then the check against the plain reference once the program is freed,
and the result.

``run_cell`` takes its device, so the tests can run a cell on the CPU;
``run.py`` is the command, which insists on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import torch

from portbench import manifest, scene
from portbench import trace as tracing

# Top-level module names the process may not hold once the window has
# closed: JAX and the package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "neus2_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What one run measured and compared."""

    cell: manifest.Cell
    setup_s: float
    window: dict
    trace: tracing.Trace | None
    memory_peak_bytes: int
    numbers: dict
    extras: dict
    per_layer: dict

    @property
    def correct(self) -> bool:
        return self.window["failed"] == 0 and all(
            v == v and v <= self.cell.limits[k] for k, v in self.numbers.items())


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> Run:
    t_start = time.perf_counter() if t_start is None else t_start
    traffic = cell.traffic
    capture = scene.make_capture(cell.capture, seed, device)
    if torch.device(device).type == "cuda":
        # The peak is the program's (with the capture it holds), not the tracing's.
        torch.cuda.reset_peak_memory_stats(device)
    drive = manifest.load_module("drives", traffic["drive"]).Drive(cell, capture, seed, device)
    drive.setup()
    setup_s = time.perf_counter() - t_start
    window = drive.window(seconds)
    tr = None
    if trace:
        tr = drive.trace(int(traffic["trace_units"]), host=False)
        if int(traffic["trace_host_units"]):
            tr.gaps = drive.trace(int(traffic["trace_host_units"]), host=True).gaps
    peak = _peak(device)
    outputs = drive.outputs()
    del drive
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    check = manifest.load_module("checks", traffic["check"])
    numbers, extras = check.compare(cell, capture, seed, outputs)
    per_layer = {}
    if trace:
        ctx = {"cell": cell, "window": window, "trace": tr, "extras": extras}
        for m in cell.per_layer:
            value = manifest.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    return Run(cell, setup_s, window, tr, peak, numbers, extras, per_layer)


def result(run: Run, device_info: dict) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, ``metrics``
    (end-to-end without a trace, per-layer with one), ``device``, with a
    trace ``breakdown``, and last the numbers compared with their limits."""
    if run.trace is None:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
        for name, value in run.window["metrics"].items():
            metrics[name] = {"value": value, "unit": units[name]}
    else:
        metrics = run.per_layer
    device = dict(device_info, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": run.correct, "attempted": run.window["attempted"],
           "failed": run.window["failed"], "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = tracing.breakdown(run.trace)
    out["compared"] = {k: {"value": v, "limit": run.cell.limits[k]} for k, v in run.numbers.items()}
    return out


def compared_lines(run: Run) -> list[str]:
    return [f"compared {k}: {v!r} (limit {run.cell.limits[k]!r})" for k, v in run.numbers.items()]


def dumps(obj) -> str:
    return json.dumps(obj, separators=(", ", ": "))
