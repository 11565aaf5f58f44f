"""Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload base.b0 --seed 7 --seconds 10 --trace 0

The last line of standard output is the result (JSON); the numbers the
check compared, each beside its limit, are the last lines of standard
error.  Without a CUDA card, with fewer cards than the cell asks for, or
in a checkout without the program, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "portbench_out"


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().replace("\n", "; ") or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache the run writes stays at a fixed place in the checkout.
    cache = OUT / "cache" / "torch_kernels"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache)
    sys.path.insert(0, str(ROOT))
    import torch

    try:
        import neus2_tpu_torch
    except ModuleNotFoundError as e:
        print(f"portbench: the program is missing ({e})", file=sys.stderr)
        return 2
    if ROOT not in Path(neus2_tpu_torch.__file__).resolve().parents:
        print(f"portbench: neus2_tpu_torch comes from {neus2_tpu_torch.__file__}, "
              f"not this checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card only", file=sys.stderr)
        return 2
    from portbench import harness, manifest

    cell = manifest.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    out = harness.result(run, info)
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"extras: {harness.dumps(run.extras)}", file=sys.stderr)
    for line in harness.compared_lines(run):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
