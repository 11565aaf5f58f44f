"""Which of the port's order-free forms a training step on the card needs
to hold against the same step on the CPU.

The port takes two things otherwise than the JAX package does, so that the
card and the CPU take the same discrete decisions in a step (which
candidate a probe lands in, which cell a sample falls in):

  * ``spacing``: ``engine/march.py::coarse_intervals`` takes the
    exponential spacing's r and r^i in float64, each rounded once to
    float32 (the JAX package: float32 ``pow``, which rounds by device);
  * ``rotation``: ``engine/rays.py::_rotate_unit`` writes the camera
    rotation of a ray direction and its norm out in one order (the JAX
    package: a reduction over the last axis and a norm).

A third candidate, ``float64 sums``, sums the occupied lengths
(``probe_candidates``' total, ``draw_from_probe``'s cumulative sum) in
float64 and rounds once, where the port sums in float32 as the JAX package
does.

This script trains chip_smoke.py's aabb_scale-4 scene (``cascade_train``:
base.json width, 900 steps, every gate of that phase) on the card, then
runs chip_smoke.py's step check (``cascade_step_vs_cpu``: one step's loss
and gradients on the card against the CPU, within CASCADE_STEP_LIMITS)
for each seed of SEEDS: once as committed, once with each of the two forms
put back to the JAX package's, and once with float64 sums, on both
devices.  It prints one ``step_agreement`` JSON line per variant and
seed, then a summary.

    python3 step_agreement.py          # needs one card; ~4 minutes

Exits non-zero without a card.  It gates nothing: it reads.
"""

from __future__ import annotations

import __future__
import dataclasses
import inspect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEEDS = (5, 6, 7, 8)


def rebuilt(fn, old: str, new: str):
    """``fn`` compiled again from its source with ``old`` (once in it)
    replaced by ``new``, in ``fn``'s own module globals."""
    src = inspect.getsource(fn)
    if src.count(old) != 1:
        raise AssertionError(f"{fn.__qualname__}: {old!r} is not in its source once")
    ns: dict = {}
    exec(compile(src.replace(old, new), inspect.getsourcefile(fn), "exec",
                 flags=__future__.annotations.compiler_flag, dont_inherit=True),
         fn.__globals__, ns)
    return ns[fn.__name__]


class Swapped:
    """Every reference to each function of ``swaps`` ({function:
    replacement}) held by a module of the port replaced inside a with
    block (train.py imports the marcher's functions by name)."""

    def __init__(self, swaps: dict):
        self.swaps, self.done = swaps, []

    def __enter__(self):
        for mod in [m for n, m in list(sys.modules.items()) if n.startswith("neus2_tpu_torch")]:
            for name, value in list(vars(mod).items()):
                for fn, new in self.swaps.items():
                    if value is fn:
                        setattr(mod, name, new)
                        self.done.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.done:
            setattr(mod, name, fn)


def variants(torch) -> dict:
    """{name: {function: its replacement}}; "committed" swaps none."""
    from neus2_tpu_torch.engine import march, rays

    def rotate_by_reduction(rot, v):
        d = (rot * v[..., None, :]).sum(-1)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    return {
        "committed": {},
        "spacing": {march.coarse_intervals: rebuilt(
            march.coarse_intervals,
            "r = ((t_hi / t_lo).double() ** (1.0 / n_candidates)).float()\n"
            "    t0 = t_lo[:, None] * (r.double()[:, None] ** steps.double()).float()",
            "r = (t_hi / t_lo) ** (1.0 / n_candidates)\n"
            "    t0 = t_lo[:, None] * r[:, None] ** steps")},
        "rotation": {rays._rotate_unit: rotate_by_reduction},
        "float64 sums": {
            march.probe_candidates: rebuilt(march.probe_candidates,
                                            "seg.sum(-1)", "seg.double().sum(-1).float()"),
            march.draw_from_probe: rebuilt(march.draw_from_probe,
                                           "torch.cumsum(probe.seg, dim=-1)",
                                           "torch.cumsum(probe.seg.double(), dim=-1).float()")},
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from neus2_tpu_torch.api.testbed import config_from_json
    from neus2_tpu_torch.ops import segment_tile as st
    from neus2_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(verbose=False)
    cfg, hyper = config_from_json(REPO / "configs" / "base.json")
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(
        cfg.field, init_radius=cs.CASCADE_INIT_RADIUS))
    t0 = time.perf_counter()
    _, tb = cs.cascade_train(torch, st, cfg, hyper)
    print(f"trained in {time.perf_counter() - t0:.1f} s", flush=True)

    summary = {}
    for name, swaps in variants(torch).items():
        for seed in SEEDS:
            cs.CASCADE_STEP_SEEDS = (seed,)
            with Swapped(swaps):
                try:
                    rec = cs.cascade_step_vs_cpu(torch, tb)[seed]
                    row = {"held": True, "loss_rel": rec["loss_rel"],
                           "tables": rec["tables"], "mlp": rec["mlp"]}
                except AssertionError as e:
                    row = {"held": False, "missed": str(e)}
            print("step_agreement " + json.dumps({"variant": name, "seed": seed, **row}),
                  flush=True)
            summary.setdefault(name, []).append(row["held"])
    print("step_agreement summary (seeds held, of " + str(len(SEEDS)) + ") "
          + json.dumps({k: sum(v) for k, v in summary.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
