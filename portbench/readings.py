"""The readings a cell's limits are set from (not part of a benchmark
run): on each seed, the program's gaps against the reference, and on the
first ``--control`` seeds the gaps of the control and of the planted
faults, each put in the program's place.

- control: the reference with TF32 operands in every MLP product;
- ``half`` (training): the reference taking half of the candidates and of
  the kept rays, the mean over the rest;
- ``unchanged`` (training) reads 1 on ``change`` and ``ema`` by their
  definition and needs no run.

    python3 portbench/readings.py --workload base.b0 --seeds 101 102 --control 1

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import manifest, scene

    cell = manifest.cell(args.workload)
    check = manifest.load_module("checks", cell.traffic["check"])
    drives = manifest.load_module("drives", cell.traffic["drive"])
    train = cell.traffic["check"] == "train"
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cap = scene.make_capture(cell.capture, seed, "cuda")
        drive = drives.Drive(cell, cap, seed, "cuda")
        if train:
            drive.setup()
            prog = drive.outputs()
        else:
            views = check.sample_views(cell.traffic["views"], seed,
                                       int(cell.traffic["checked_views"]))
            prog = {v: drive.render(v)[0] for v in views}
            drive.tb = None
        del drive
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        row = {"seed": seed, "program_s": t1 - t0}
        if train:
            n = len(prog["loss"])
            ref = check.reference(cell, cap, seed, n)
            row["reference_s"] = time.perf_counter() - t1
            row["sound"] = check.worst(prog, ref)
            row["left_out"] = sorted(set(ref["grad"]) - set(check.moved_leaves(ref)))
            row["loss_program"], row["loss_reference"] = prog["loss"], ref["loss"]
            if i < args.control:
                row["control"] = check.worst(check.reference(cell, cap, seed, n, tf32=True), ref)
                row["half"] = check.worst(check.reference(cell, cap, seed, n, batch_share=0.5),
                                          ref)
        else:
            ref = check.reference(cell, cap, seed, list(prog))
            row["reference_s"] = time.perf_counter() - t1
            row["sound"] = check.gaps(prog, ref)
            row["hit_rays"] = {v: r[1] for v, r in ref.items()}
            if i < args.control:
                ctl = check.reference(cell, cap, seed, list(prog), tf32=True)
                row["control"] = check.gaps({v: r[0] for v, r in ctl.items()}, ref)
        row["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        print(json.dumps(row), flush=True)
        del cap
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
