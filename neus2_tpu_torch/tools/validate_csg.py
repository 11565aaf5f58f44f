"""Quality at length on an analytic scene: train the flagship grid on the
CSG scene (or dumbbell, bowl), then the held-out PSNR / SSIM, the mean
|SDF| on ground-truth surface points and the Chamfer distance of the
extracted mesh (port of the TPU package's ``tools_tpu_validate_csg.py``).

The CSG scene (``data/synthetic.py::make_csg_dataset``) is non-convex with
thin features and a high-frequency texture: geometry the sphere init
cannot solve alone.  It stands in for the reference's DTU protocol
(scripts/run.py:264-344).  The default protocol: 24 training + 2 held-out
views at 256^2, the L14/F2 grid in fp32, 4096 rays x 64 samples,
hit-ray compaction 2, 2,000 steps.

Resumable in chunks: each call trains until the target, ``--budget-s``
seconds or ``--chunk-steps`` steps, writes a snapshot, and evaluates once
the target is reached; call again until it prints DONE.  The adaptive
(rays, samples) bucket is host state that no snapshot holds, so a resumed
chunk starts again in bucket 0 and re-votes; ``--bucket B`` trains in
bucket B throughout (``protocol.fixed_bucket``).  Everything goes to
``--workdir``: ``<tag>.msgpack`` (snapshot), ``<tag>.json`` (the result,
the TPU tool's keys), ``<tag>_record.json`` (each chunk's wall time, host
and traced device ms a step, kernel-1 launches, bucket switches, and each
evaluation) and the dataset cache ``csg_ds_<scene>_<n>v_<res>.npz``.

  python -m neus2_tpu_torch.tools.validate_csg [target_steps] [--views 48]
      [--res 1024 --fp16-texels] [--error-map] [--config l4f8 --bf16]
      [--oversample 1] [--scene dumbbell] [--bucket B] [--budget-s S] [--workdir DIR]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import SCENES
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.variants import FLAGSHIP_VARIANTS, flagship_grid

N_GT_POINTS = 16384
MESH_RES = 256  # the Chamfer mesh's lattice over [0.15, 0.85]^3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("target", type=int, nargs="?", default=2000, help="steps to train to")
    p.add_argument("--views", type=int, default=24, help="training views")
    p.add_argument("--eval-views", type=int, default=2, help="held-out views after them")
    p.add_argument("--res", type=int, default=256, help="image side")
    p.add_argument("--error-map", action="store_true", help="error-map ray sampling")
    p.add_argument("--scene", choices=sorted(SCENES), default="csg")
    p.add_argument("--config", choices=sorted(FLAGSHIP_VARIANTS), default="parity")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (fp32 master params)")
    p.add_argument("--fp16-texels", action="store_true", help="half-precision image storage")
    p.add_argument("--oversample", type=int, default=2, help="hit-ray compaction factor")
    p.add_argument("--bucket", type=int, choices=range(4), default=None,
                   help="train in this adaptive bucket throughout (adaptive_batch off)")
    p.add_argument("--budget-s", type=float, default=330.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def csg_config(variant: str = "parity", bf16: bool = False, error_map: bool = False,
               oversample: int = 2) -> TrainConfig:
    """The protocol's config: ``variant``'s flagship grid, 4096 rays x 64
    samples, 256 candidates, eikonal and mask loss 0.1."""
    return TrainConfig(
        field=FieldConfig(grid=flagship_grid(variant),
                          compute_dtype=torch.bfloat16 if bf16 else None),
        n_rays=4096,
        samples_per_ray=64,
        n_candidates=256,
        ek_loss_weight=0.1,
        mask_loss_weight=0.1,
        use_error_map=error_map,
        hit_oversample=oversample,
    )


def run_tag(opts) -> str:
    """The run's file stem: every flag that changes what it trains."""
    tag = f"validate_{opts.scene}_{opts.views}+{opts.eval_views}v_{opts.res}_{opts.config}"
    for flag, name in ((opts.bf16, "bf16"), (opts.fp16_texels, "fp16tex"),
                       (opts.error_map, "emap")):
        tag += f"_{name}" if flag else ""
    tag += f"_os{opts.oversample}"
    tag += "" if opts.bucket is None else f"_b{opts.bucket}"
    return tag + (f"_seed{opts.seed}" if opts.seed else "")


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result dict once the target is reached,
    else None (a snapshot to resume from is on disk)."""
    resolve_device(opts.device)  # no card: fail before rendering a view
    config = config or csg_config(opts.config, opts.bf16, opts.error_map, opts.oversample)
    if opts.bucket is not None:
        config = protocol.fixed_bucket(config, opts.bucket)
    opts.workdir.mkdir(parents=True, exist_ok=True)
    tag = run_tag(opts)
    snap = opts.workdir / f"{tag}.msgpack"
    meta = opts.workdir / f"{tag}.json"
    record_path = opts.workdir / f"{tag}_record.json"
    n_train, n_eval = opts.views, opts.eval_views
    ds = protocol.scene_dataset(opts.scene, n_train + n_eval, opts.res, opts.workdir)
    tb = Testbed(config=config, hyper=Hyperparams(first_frame_max_training_step=opts.target),
                 seed=opts.seed, device=opts.device,
                 image_dtype=torch.float16 if opts.fp16_texels else None)
    tb.load_training_data_from_datasets([ds.subset(slice(0, n_train))])
    if snap.exists():
        tb.load_snapshot(snap)
        print(f"resumed at step {tb.training_step}", flush=True)

    history = protocol.read_json(record_path, {}).get("bucket_history", [])
    chunk = protocol.train_chunk(tb, opts.target, opts.budget_s, opts.chunk_steps, history)
    tb.save_snapshot(snap)
    protocol.record_chunk(record_path, chunk, bucket_history=history)
    print(f"paused/finished at step {tb.training_step} [{chunk['wall_s']:.0f}s]", flush=True)
    if tb.training_step < opts.target:
        return None

    t0 = time.perf_counter()
    psnrs, ssims = protocol.heldout_eval(tb.state, config.field, ds,
                                         range(n_train, n_train + n_eval))
    for k, p, s in zip(range(n_train, n_train + n_eval), psnrs, ssims):
        print(f"eval view {k}: PSNR {p:.2f} dB  SSIM {s:.4f}", flush=True)
    sdf, _ = SCENES[opts.scene]
    gt_pts = protocol.gt_surface_points(sdf, N_GT_POINTS)
    surf_err = protocol.surface_sdf_err(tb.state.ema_params, config.field, gt_pts)
    chamfer, n_verts = protocol.mesh_chamfer(tb.state.ema_params, config.field, gt_pts,
                                             MESH_RES)
    out = {
        "steps": tb.training_step,
        "held_out_psnr": float(np.mean(psnrs)),
        "held_out_ssim": float(np.mean(ssims)),
        "per_view_psnr": psnrs,
        "surface_sdf_err": surf_err,
        "chamfer": chamfer,
    }
    protocol.write_json(meta, out)
    rec = protocol.read_json(record_path, {})
    rec.setdefault("evals", []).append(
        dict(out, mesh_vertices=n_verts, eval_s=time.perf_counter() - t0))
    protocol.write_json(record_path, rec)
    print("DONE", json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
