"""Hit-ray compaction quality A/B: the bench's flagship config (bf16
L14/F2, adaptive buckets on, the Testbed's loop) trained end to end at one
``hit_oversample``, then the held-out PSNR / SSIM, the mean |SDF| on the
true surface, the mean contributing-sample fraction and the wall time a
step (port of the TPU package's ``tools_compact_ab.py``).

The sphere trains on 16 views at 256^2 and is held out on 4 views of a
20-view ring, its surface read at 4,096 points of the true sphere;
``--scene csg`` (or dumbbell, bowl) trains on 24 views with mask loss 0.1,
holds out 2, and reads its surface at the first 4,096 of 200,000 uniform
points in [0.2, 0.8]^3 within 0.01 of it.

Resumable in chunks; a resumed chunk starts in bucket 0 and re-votes, as
the TPU tool's does.  Files in ``--workdir``: ``compact_ab_<tag>.msgpack``
(tag ``x<OVERSAMPLE>_<scene>[_s<seed>]``, the TPU tool's), ``.json``
(the valid fractions and timed seconds so far, then the TPU tool's
result keys) and ``_record.json`` (each chunk's cost and the occ_len
trace).

  python -m neus2_tpu_torch.tools.compact_ab OVERSAMPLE [TARGET=2000]
      [--scene csg] [--seed N] [--budget-s S] [--workdir DIR] [--device cpu]
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

RES = 256  # the views' side
VALID_EVERY = 100  # steps between reads of the contributing-sample fraction


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("oversample", type=int, nargs="?", default=1, help="hit_oversample")
    p.add_argument("target", type=int, nargs="?", default=2000, help="steps to train to")
    p.add_argument("--scene", choices=["sphere", *sorted(SCENES)], default="sphere")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--budget-s", type=float, default=420.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run_tag(opts) -> str:
    return f"x{opts.oversample}_{opts.scene}" + (f"_s{opts.seed}" if opts.seed else "")


def snapshot_path(workdir: Path, oversample: int = 1, scene: str = "sphere",
                  seed: int = 0) -> Path:
    """Where the run of these arguments keeps its snapshot."""
    opts = argparse.Namespace(oversample=oversample, scene=scene, seed=seed)
    return Path(workdir) / f"compact_ab_{run_tag(opts)}.msgpack"


def tool_config(oversample: int, scene: str, config: TrainConfig | None = None) -> TrainConfig:
    """``config`` (default the flagship config) at ``oversample``, with mask
    loss 0.1 on an analytic scene (the TPU tool's :54, :67)."""
    config = dataclasses.replace(config or protocol.flagship_config(), hit_oversample=oversample)
    return config if scene == "sphere" else dataclasses.replace(config, mask_loss_weight=0.1)


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once the target is reached, else
    None (a snapshot to resume from is on disk).  ``config`` defaults to
    the flagship config, and takes ``tool_config``'s changes either way."""
    resolve_device(opts.device)
    config = tool_config(opts.oversample, opts.scene, config)
    opts.workdir.mkdir(parents=True, exist_ok=True)
    snap = snapshot_path(opts.workdir, opts.oversample, opts.scene, opts.seed)
    meta_path = snap.with_suffix(".json")
    record_path = snap.with_name(snap.stem + "_record.json")
    train_ds, eval_ds, eval_ids = protocol.ab_scene(opts.scene, RES, opts.workdir)
    if opts.scene == "sphere":
        pts = protocol.sphere_shell(4096, float32_first=False)
    else:
        pts = protocol.csg_surface_points(SCENES[opts.scene][0])
    tb = Testbed(config=config, hyper=Hyperparams(first_frame_max_training_step=opts.target),
                 seed=opts.seed, device=opts.device)
    tb.load_training_data_from_datasets([train_ds])
    meta = {"train_s": 0.0, "steps_timed": 0, "valid_frac": []}
    if snap.exists():
        tb.load_snapshot(snap)
        meta.update(protocol.read_json(meta_path, {}))
        print(f"resumed at step {tb.training_step}", flush=True)

    budget_cap = config.n_rays * config.samples_per_ray
    chunk = protocol.Chunk(tb, opts.budget_s)
    stop = (opts.target if opts.chunk_steps is None
            else min(opts.target, tb.training_step + opts.chunk_steps))
    while tb.training_step < stop and chunk.running():
        chunk.step(tb.train)
        if tb.training_step % VALID_EVERY == 0 and tb.last_aux is not None:
            vf = float(tb.last_aux.n_valid_samples) / budget_cap  # the 16-step host copy
            meta["valid_frac"].append([tb.training_step, round(vf, 4)])
            print(f"step {tb.training_step} loss={tb.loss_scalar:.5f} bucket={tb.batch_bucket} "
                  f"valid_frac={vf:.3f} [{chunk.elapsed():.0f}s]", flush=True)
    rec = chunk.close()
    meta["train_s"] += rec["wall_s"]
    meta["steps_timed"] += rec["steps"]
    tb.save_snapshot(snap)
    protocol.write_json(meta_path, meta)
    protocol.record_chunk(record_path, rec)
    print(f"paused/finished at step {tb.training_step} [{meta['train_s']:.0f}s total train]",
          flush=True)
    if tb.training_step < opts.target:
        return None

    psnrs, ssims = protocol.heldout_eval(tb.state, config.field, eval_ds, eval_ids)
    for k, p, s in zip(eval_ids, psnrs, ssims):
        print(f"eval view {k}: PSNR {p:.2f}  SSIM {s:.4f}", flush=True)
    out = {
        "oversample": opts.oversample,
        "scene": opts.scene,
        "seed": opts.seed,
        "steps": tb.training_step,
        "held_out_psnr": float(np.mean(psnrs)),
        "held_out_ssim": float(np.mean(ssims)),
        "surface_sdf_err": protocol.surface_sdf_err(tb.state.ema_params, config.field, pts),
        "train_s": meta["train_s"],
        "ms_per_step": 1000.0 * meta["train_s"] / max(meta["steps_timed"], 1),
        "mean_valid_frac": float(np.mean([v for _, v in meta["valid_frac"][-10:]])),
    }
    protocol.write_json(meta_path, {**meta, **out})
    print("DONE", json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
