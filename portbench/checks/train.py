"""The training check: the plain reference follows the checked steps from
the same seed, and each number is a gap between the two sides, taken by
the worst leaf:

- ``loss``: each checked step's loss, |program - reference| / |reference|,
  the largest over the steps;
- ``grad``: the first step's gradient as Adam holds it (mu / (1 - beta1)):
  | |g_prog| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
- ``change``: the parameters' change over the checked steps, the same gap
  of norms;
- ``ema``: the EMA copy's change over the checked steps, likewise.

Leaves whose first reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam and are left out of ``change``
and ``ema``.  Gaps of norms, not norms of differences: Adam takes every
touched element a full step whatever its gradient's size, so elementwise
differences measure round-off in the gradient's sign, not the step.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.nets import load_config
from portbench.reference.steps import train


def _norms(tree: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tree.items()}


def _gap(prog: dict, ref: dict, names) -> tuple[float, str]:
    """(the worst leaf's gap of norms, that leaf)."""
    names = list(names)
    if not names:
        return 0.0, ""
    med = float(torch.tensor([ref[n] for n in names], dtype=torch.float64).median())
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n) for n in names)


def _change(out: dict, key: str) -> dict:
    return _norms({n: out[key][n] - out["start"][n] for n in out["start"]})


def moved_leaves(ref: dict) -> list[str]:
    """The leaves whose first reference gradient is a thousandth of the
    median leaf's or more."""
    g_ref = _norms(ref["grad"])
    med = float(torch.tensor(list(g_ref.values()), dtype=torch.float64).median())
    return [n for n, v in g_ref.items() if v >= 1e-3 * med]


def worst(prog: dict, ref: dict) -> dict:
    """Each number compared with the step or leaf it was read at."""
    g_ref = _norms(ref["grad"])
    moved = moved_leaves(ref)
    return {
        "loss": max((abs(a - b) / abs(b), f"step {k + 1}")
                    for k, (a, b) in enumerate(zip(prog["loss"], ref["loss"]))),
        "grad": _gap(_norms(prog["grad"]), g_ref, g_ref),
        "change": _gap(_change(prog, "params"), _change(ref, "params"), moved),
        "ema": _gap(_change(prog, "ema"), _change(ref, "ema"), moved),
    }


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared, program (or a stand-in) against reference."""
    return {k: v for k, (v, _) in worst(prog, ref).items()}


def reference(cell, capture, seed: int, n_steps: int, tf32: bool = False,
              batch_share: float = 1.0) -> dict:
    cfg = load_config(cell.config_path)
    if tf32:
        cfg = dataclasses.replace(cfg, tf32=True)
    return train(capture, cfg, seed, n_steps, int(cell.traffic.get("bucket", 0)), batch_share)


def compare(cell, capture, seed: int, outputs: dict) -> tuple[dict, dict]:
    """-> (numbers, what the per-layer readers may use)."""
    ref = reference(cell, capture, seed, len(outputs["loss"]))
    start = max(float((outputs["start"][n] - ref["start"][n]).abs().max()) for n in ref["start"])
    return gaps(outputs, ref), {"start_max_abs": start}
