"""Adaptive-bucket quality A/B: the bench's flagship config (bf16 L14/F2,
adaptive buckets on, the Testbed's loop) trained end to end at one
``adaptive_samples_factor``, then the held-out PSNR / SSIM, the mean |SDF|
on a shell of ground-truth points and the bucket history (port of the TPU
package's ``tools_bucket_ab.py``).

The factor decides how early the Testbed trades samples for rays at a
constant sample budget: bucket b trains (4096 << b) rays x (64 >> b)
samples once the occupied chord is short enough.  Equal steps across
factors; only the switch point differs.  The sphere scene trains on 16
views at 256^2 and is held out on 4 views of a 20-view ring (every pose
differs from the training ring's); ``--scene csg`` (or dumbbell, bowl)
trains on 24 views and holds out 2.

Resumable in chunks.  No snapshot holds the bucket, so the history
([step, bucket, occ_len EMA] at each switch) is kept beside the snapshot
and a resumed chunk restores the bucket and the EMA from its last entry.
Files in ``--workdir``: ``bucket_ab_<tag>.msgpack``, ``.json`` (the
result), ``_hist.json`` and ``_record.json`` (each chunk's cost).

  python -m neus2_tpu_torch.tools.bucket_ab [FACTOR=0.75] [TARGET=2000]
      [--scene csg] [--budget-s S] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import SCENES
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("factor", type=float, nargs="?", default=0.75,
                   help="adaptive_samples_factor")
    p.add_argument("target", type=int, nargs="?", default=2000, help="steps to train to")
    p.add_argument("--scene", choices=["sphere", *sorted(SCENES)], default="sphere")
    p.add_argument("--res", type=int, default=256, help="image side")
    p.add_argument("--budget-s", type=float, default=420.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run_tag(opts) -> str:
    tag = f"f{opts.factor:g}".replace(".", "p")
    tag += "" if opts.scene == "sphere" else f"_{opts.scene}"
    tag += "" if opts.res == 256 else f"_{opts.res}"
    return tag + (f"_seed{opts.seed}" if opts.seed else "")


def build(opts, config: TrainConfig | None = None):
    """(Testbed with the training views loaded, eval dataset, eval view
    ids, shell points) for ``opts``; ``config`` defaults to the flagship
    config, and takes ``opts.factor`` either way."""
    config = dataclasses.replace(config or protocol.flagship_config(),
                                 adaptive_samples_factor=opts.factor)
    train_ds, eval_ds, eval_ids = protocol.ab_scene(opts.scene, opts.res, opts.workdir)
    if opts.scene == "sphere":
        shell = protocol.sphere_shell(2048, float32_first=True)
    else:
        shell = protocol.csg_surface_points(SCENES[opts.scene][0])
        config = dataclasses.replace(config, mask_loss_weight=0.1)
    tb = Testbed(config=config, hyper=Hyperparams(first_frame_max_training_step=opts.target),
                 seed=opts.seed, device=opts.device)
    tb.load_training_data_from_datasets([train_ds])
    return tb, eval_ds, eval_ids, shell


def restore_bucket(tb, hist: list) -> None:
    """The bucket and occ_len EMA of the history's last switch."""
    if hist:
        tb.batch_bucket = hist[-1][1]
        tb._occ_len_ema = hist[-1][2]


def evaluate(tb, opts, eval_ds, eval_ids, shell, hist: list) -> dict:
    psnrs, ssims = protocol.heldout_eval(tb.state, tb.config.field, eval_ds, eval_ids)
    for k, p, s in zip(eval_ids, psnrs, ssims):
        print(f"eval view {k}: PSNR {p:.2f}  SSIM {s:.4f}", flush=True)
    return {
        "factor": opts.factor,
        "scene": opts.scene,
        "steps": tb.training_step,
        "held_out_psnr": float(np.mean(psnrs)),
        "held_out_ssim": float(np.mean(ssims)),
        "per_view_psnr": psnrs,
        "shell_sdf_err": protocol.surface_sdf_err(tb.state.ema_params, tb.config.field, shell),
        "bucket_history": hist,
        "final_occ_len_ema": tb._occ_len_ema,
    }


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once the target is reached, else
    None (a snapshot and the history to resume from are on disk)."""
    resolve_device(opts.device)  # no card: fail before rendering a view
    opts.workdir.mkdir(parents=True, exist_ok=True)
    stem = opts.workdir / f"bucket_ab_{run_tag(opts)}"
    snap, meta = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    hist_path = stem.with_name(stem.name + "_hist.json")
    record_path = stem.with_name(stem.name + "_record.json")
    tb, eval_ds, eval_ids, shell = build(opts, config)
    hist = []
    if snap.exists():
        tb.load_snapshot(snap)
        hist = protocol.read_json(hist_path, [])
        restore_bucket(tb, hist)
        print(f"resumed at step {tb.training_step}", flush=True)

    rec = protocol.train_chunk(tb, opts.target, opts.budget_s, opts.chunk_steps, hist,
                               log_every=200)
    tb.save_snapshot(snap)
    protocol.write_json(hist_path, hist)
    protocol.record_chunk(record_path, rec)
    print(f"paused/finished at step {tb.training_step} [{rec['wall_s']:.0f}s]", flush=True)
    if tb.training_step < opts.target:
        return None
    out = evaluate(tb, opts, eval_ds, eval_ids, shell, hist)
    protocol.write_json(meta, out)
    print("DONE", json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
