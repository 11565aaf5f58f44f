"""Dynamic-scene quality: train frame 0 of the moving sphere, then each
next frame (pose refinement of the frame's delta first), and after each
frame the held-out view's PSNR and the pose error of the effective
transform (port of the TPU package's ``tools_dynamic_quality.py``; the
reference's scripts/run_dynamic.py:183-201 logs the same per frame).

The scene translates rigidly by (0.035, 0, 0) a frame, the motion the
delta network models, so the canonical field (frame 0) is pulled back to
frame k by a transform whose translation should be -k (0.035, 0, 0).
Each frame renders ``--views`` + 1 views; the last one is held out of
training.  Reports each frame's PSNR and |t + k shift|, and their mean.

The default model is small (an 8-level 2^15 grid, 1024 rays x 32
samples); ``--full`` trains the bench's flagship config (bf16 L14/F2,
4096 x 64; ``--config`` picks the grid).  Resumable: a call stops after
``--budget-s`` seconds with a snapshot, and the frames done so far stay in
``<stem>_partial.json``.  Files in ``--workdir``:
``dynamic_quality[_nopredict][_seed<n>][_b<B>][_<tag>].msgpack``, ``.json``,
``_partial.json``, ``_record.json``.

  python -m neus2_tpu_torch.tools.dynamic_quality [--full --views 48
      --res 256 --frame0-steps 1000 --refine-steps 250 --next-steps 450
      --delta-lr 1e-2 --c2f] [--no-predict] [--motion-prior] [--bucket B]
      [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.variants import FLAGSHIP_VARIANTS

SHIFT = (0.035, 0.0, 0.0)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--views", type=int, default=12, help="training views (one more held out)")
    p.add_argument("--res", type=int, default=64, help="image side")
    p.add_argument("--frame0-steps", type=int, default=800)
    p.add_argument("--refine-steps", type=int, default=100, help="pose refinement a frame")
    p.add_argument("--next-steps", type=int, default=300, help="steps of each later frame")
    p.add_argument("--delta-lr", type=float, default=5e-3)
    p.add_argument("--no-predict", action="store_true", help="no pose refinement phase")
    p.add_argument("--motion-prior", action="store_true",
                   help="start each delta at the previous frame's")
    p.add_argument("--c2f", action="store_true", help="coarse-to-fine pose refinement")
    p.add_argument("--full", action="store_true", help="the flagship model scale")
    p.add_argument("--bucket", type=int, choices=range(4), default=None,
                   help="train in this adaptive bucket throughout (adaptive_batch off)")
    p.add_argument("--config", choices=sorted(FLAGSHIP_VARIANTS), default="parity",
                   help="the flagship grid under --full")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--tag", default="", help="a suffix of the file names")
    p.add_argument("--budget-s", type=float, default=3000.0, help="seconds a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_config(opts) -> TrainConfig:
    if opts.full:
        return dataclasses.replace(protocol.flagship_config(opts.config), delta_lr=opts.delta_lr)
    return TrainConfig(
        field=FieldConfig(
            grid=HashGridConfig(
                n_levels=8,
                log2_hashmap_size=15,
                base_resolution=16,
                per_level_scale=HashGridConfig.per_level_scale_from_top(16, 256, 8),
            ),
        ),
        n_rays=1024,
        samples_per_ray=32,
        n_candidates=96,
        ek_loss_weight=0.1,
        mask_loss_weight=0.1,
        delta_lr=opts.delta_lr,
    )


def make_hyper(opts) -> Hyperparams:
    return Hyperparams(
        refine_coarse_to_fine=opts.c2f,
        first_frame_max_training_step=opts.frame0_steps,
        next_frame_max_training_step=opts.next_steps,
        predict_global_movement=not opts.no_predict,
        predict_global_movement_training_step=opts.refine_steps,
        # The shipped config's setting (base.json:127): the delta keeps
        # refining while the canonical field trains.
        finetune_global_movement=True,
        delta_motion_prior=opts.motion_prior,
        mask_loss_weight=0.1,
        ek_loss_weight=0.1,
    )


def eval_frame(tb, heldout_ds, spp: int = 2) -> float:
    """The held-out view's PSNR for the frame in training: the last view of
    ``heldout_ds`` rendered through the effective transform (the
    accumulated one and the live delta) at 64 samples, 128 candidates and
    ``spp`` on black (reference scripts/run.py:264-271)."""
    i = heldout_ds.n_images - 1
    psnrs, _ = protocol.heldout_eval(tb.state, tb.config.field, heldout_ds, [i], samples=64,
                                     candidates=128, spp=spp, acc=tb.effective_acc, seed=0,
                                     aabb_scale=tb.config.aabb_scale)
    return psnrs[0]


def pose_error(tb, k: int) -> float:
    """|t + k shift|: the effective translation against the one that pulls
    frame k's samples back to frame 0."""
    t = tb.effective_acc["transition"].detach().cpu().numpy()
    return float(np.linalg.norm(t + k * np.asarray(SHIFT)))


def drop_last(ds):
    return ds.subset(slice(0, ds.n_images - 1))


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once every frame is done, else None
    (a snapshot and the frames done so far are on disk)."""
    resolve_device(opts.device)  # no card: fail before rendering a view
    opts.workdir.mkdir(parents=True, exist_ok=True)
    suffix = ("_nopredict" if opts.no_predict else "") + (f"_seed{opts.seed}" if opts.seed else "")
    suffix += "" if opts.bucket is None else f"_b{opts.bucket}"
    suffix += f"_{opts.tag}" if opts.tag else ""
    stem = opts.workdir / f"dynamic_quality{suffix}"
    snap, out_path = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    partial = stem.with_name(stem.name + "_partial.json")
    record_path = stem.with_name(stem.name + "_record.json")

    frames_full = make_moving_sphere_frames(n_frames=opts.frames, translation_per_frame=SHIFT,
                                            n_views=opts.views + 1, resolution=opts.res)
    config = config or make_config(opts)
    if opts.bucket is not None:
        config = protocol.fixed_bucket(config, opts.bucket)
    tb = Testbed(config=config, hyper=make_hyper(opts), seed=opts.seed,
                 device=opts.device)
    tb.load_training_data_from_datasets([drop_last(ds) for ds in frames_full])
    results = protocol.read_json(partial, {"per_frame_psnr": [], "pose_err": [],
                                           "predict": not opts.no_predict,
                                           "motion_prior": opts.motion_prior})
    if snap.exists():
        # The snapshot's meta block replays the frame and its phase flags.
        tb.load_snapshot(snap)
        print(f"resumed frame {tb.current_training_time_frame} step {tb.training_step}",
              flush=True)

    chunk = protocol.Chunk(tb, opts.budget_s)

    def on_complete(tb_, k):
        p = eval_frame(tb_, frames_full[k])
        t_err = pose_error(tb_, k)
        while len(results["per_frame_psnr"]) <= k:
            results["per_frame_psnr"].append(None)
            results["pose_err"].append(None)
        results["per_frame_psnr"][k] = p
        results["pose_err"][k] = t_err
        protocol.write_json(partial, results)
        print(f"frame {k}: held-out PSNR {p:.2f} dB, |t err| {t_err:.4f}", flush=True)

    tb.on_frame_complete = on_complete
    frame_launches = {}
    while True:
        before = protocol.segment_sum_rows.launches
        if not chunk.step(tb.frame):
            break
        frame = tb.current_training_time_frame
        frame_launches[frame] = (frame_launches.get(frame, 0)
                                 + protocol.segment_sum_rows.launches - before)
        if chunk.steps % 100 == 0:
            print(f"frame {tb.current_training_time_frame} local {tb.training_step} "
                  f"loss={tb.loss_scalar:.5f} [{chunk.elapsed():.0f}s]", flush=True)
        if not chunk.running() or chunk.steps == opts.chunk_steps:
            rec = chunk.close()
            tb.save_snapshot(snap)
            protocol.record_chunk(record_path, dict(rec, frame_launches=frame_launches))
            print(f"chunk ended; snapshot at frame {tb.current_training_time_frame} step "
                  f"{tb.training_step}; call again to resume", flush=True)
            return None
    rec = chunk.close()
    protocol.record_chunk(record_path, dict(rec, frame_launches=frame_launches))

    done = [p for p in results["per_frame_psnr"] if p is not None]
    results["mean_psnr"] = float(np.mean(done)) if done else None
    out_path.write_text(json.dumps(results, indent=1))
    print("DONE", json.dumps(results), flush=True)
    snap.unlink(missing_ok=True)
    partial.unlink(missing_ok=True)
    return results


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
