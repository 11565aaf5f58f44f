"""CLI runner for static scenes: train, evaluate, export a mesh (port of the
static path of ``neus2_tpu/run.py``; reference scripts/run.py: the train
loop over testbed.frame() at 207, the PSNR/SSIM eval against a held-out
transforms json at 251-344, the marching-cubes export at 241-243).

Usage:
  python -m neus2_tpu_torch.run --scene data/scan24/transforms.json \\
      --network configs/base.json --n_steps 2000 --name exp1 \\
      --save_mesh --test_transforms data/scan24/transforms_test.json

Runs on the card unless ``--device cpu`` is given.  Dynamic scenes,
snapshots, multi-GPU and the sdf and image modes are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True, help="transforms.json of a static scene")
    p.add_argument("--network", default=None, help="network config json (reference format)")
    p.add_argument("--name", default="exp", help="experiment name -> <output_dir>/<name>/")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--n_steps", type=int, default=None,
                   help="override first_frame_max_training_step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_rays", type=int, default=None)
    p.add_argument("--samples_per_ray", type=int, default=None)
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--test_transforms", default=None,
                   help="held-out transforms json for PSNR/SSIM eval")
    p.add_argument("--eval_spp", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--mode", choices=("nerf", "sdf", "image"), default="nerf")
    p.add_argument("--snapshot", default=None, help="load a snapshot before training")
    p.add_argument("--multichip", choices=("auto", "on", "off"), default="auto")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode != "nerf":
        raise NotImplementedError(f"--mode {args.mode} is not ported yet")
    if args.snapshot:
        raise NotImplementedError("snapshots are not ported yet")
    if args.multichip == "on":
        raise NotImplementedError("multi-GPU training is not ported yet")

    from neus2_tpu_torch.api.testbed import Hyperparams, Testbed, config_from_json
    from neus2_tpu_torch.engine.train import TrainConfig

    out = Path(args.output_dir) / args.name
    for sub in ("mesh", "logs"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    log_path = out / "log.txt"

    def log(msg: str):
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(msg + "\n")

    config, hyper = config_from_json(args.network) if args.network else (
        TrainConfig(), Hyperparams())
    changes = {}
    if args.n_rays:
        changes["n_rays"] = args.n_rays
    if args.samples_per_ray:
        changes["samples_per_ray"] = args.samples_per_ray
    if changes:
        config = dataclasses.replace(config, **changes)
    if args.n_steps:
        hyper.first_frame_max_training_step = args.n_steps

    tb = Testbed(config=config, hyper=hyper, seed=args.seed, device=args.device)
    log(f"loading scene {args.scene}")
    try:
        tb.load_training_data(args.scene)
    except FileNotFoundError as e:
        print(f"error: scene not found: {e}", file=sys.stderr)
        sys.exit(2)
    log(f"{tb.dataset.n_images} images @ {tb.dataset.resolution}, device={tb.device}")

    t0 = time.time()
    step = 0
    while tb.frame():
        step += 1
        if step % 100 == 0:
            log(f"step {step} loss={tb.loss_scalar:.5f} ek={tb.ek_loss_scalar:.5f} "
                f"mask={tb.mask_loss_scalar:.5f} [{time.time() - t0:.1f}s]")
    log(f"training done: {step} steps in {time.time() - t0:.1f}s")
    tb.prepare_for_test()

    if args.save_mesh:
        mesh_path = out / "mesh" / "mesh.obj"
        log(f"extracting mesh @ {args.mesh_resolution}^3 -> {mesh_path}")
        verts, tris = tb.compute_and_save_marching_cubes_mesh(
            mesh_path, resolution=args.mesh_resolution)
        log(f"mesh: {len(verts)} vertices, {len(tris)} triangles")

    if args.test_transforms:
        psnrs, ssims = evaluate(tb, args.test_transforms, args.eval_spp, log)
        metrics = {
            "psnr_mean": float(np.mean(psnrs)),
            "ssim_mean": float(np.mean(ssims)),
            "psnr": [float(p) for p in psnrs],
        }
        with open(out / "metrics.json", "w") as f:
            json.dump(metrics, f, indent=2)
        log(f"eval: PSNR {metrics['psnr_mean']:.2f} dB  SSIM {metrics['ssim_mean']:.4f}")
    return tb


def evaluate(tb, test_transforms: str, spp: int, log) -> tuple[list, list]:
    """PSNR / SSIM on held-out views (reference run.py:251-344 protocol:
    black background, ``spp`` jittered passes, min transmittance 1e-4,
    sRGB space)."""
    from neus2_tpu_torch.data.dataset import load_dataset
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim

    ds = load_dataset(test_transforms)
    images, cams = ds.to_device(tb.device)
    cfg = RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                       min_transmittance=1e-4)
    psnrs, ssims = [], []
    for i in range(ds.n_images):
        rgb, _, _ = render_image(
            tb.state.ema_params, tb.effective_acc, tb.state.occupancy, cams,
            cams.poses[i], cams.focal[i], cams.principal[i],
            torch.Generator(device=tb.device).manual_seed(i), cfg,
            background=0.0, spp=spp,
        )
        target = srgb_eval_target(images[i])
        p, s = float(psnr(rgb, target)), float(ssim(rgb, target))
        psnrs.append(p)
        ssims.append(s)
        log(f"  view {i}: PSNR {p:.2f}  SSIM {s:.4f}")
    return psnrs, ssims


if __name__ == "__main__":
    main(sys.argv[1:])
