"""CLI runner for static and dynamic scenes: train, evaluate, export a mesh
(port of the nerf mode of ``neus2_tpu/run.py``; reference scripts/run.py:
the train loop over testbed.frame() at 207, the PSNR/SSIM eval against a
held-out transforms json at 251-344, the marching-cubes export at 241-243;
scripts/run_dynamic.py for per-frame dynamic scenes).

Usage:
  python -m neus2_tpu_torch.run --scene data/scan24/transforms.json \\
      --network configs/base.json --n_steps 2000 --name exp1 \\
      --save_mesh --test_transforms data/scan24/transforms_test.json
  python -m neus2_tpu_torch.run --scene data/dynamic_scene_dir/ --name dyn1 \\
      --next_frame_steps 1000 --dynamic_save_mesh --eval_per_frame
  python -m neus2_tpu_torch.run --scene data/scan24/transforms.json \\
      --network configs/base.json --snapshot output/exp1/checkpoints/final.msgpack \\
      --no_train --test_transforms data/scan24/transforms_test.json \\
      --save_eval_images --render_path orbit --screenshot_transforms <json>

Training writes ``checkpoints/final.msgpack`` (and ``<step>.msgpack``
every ``--save_snapshot_every`` steps), in the JAX package's native
format, so either package's CLI resumes from the other's.  A dynamic scene
writes ``checkpoints/frame_{k}.msgpack`` (incremental: no optimizer state)
and ``checkpoints/transform_{k}.txt`` (the accumulated rigid transform)
when frame k finishes, and the transform for the last frame.  Runs on the
card unless ``--device cpu`` is given.  ``--fp16-images`` stores the
training texels in fp16, ``--bf16`` runs the MLPs and the encoder's
backward on bf16 operands with fp32 sums, and ``--save_density_png``
writes the SDF grid's slice mosaic.  The mesh outputs: with
``--save_eval_images``, each eval view's mesh rasterized as
``view_{i:03d}_mesh.png`` (Lambertian with ``--shaded_mesh``, a normal map
with ``--save_mesh`` alone), ``--ref_mesh`` (Chamfer distance to a reference OBJ, in the
dataset's space), ``--mesh_largest_component`` and ``--grid_stats``.

The other modes take ``--scene`` as their input:
  python -m neus2_tpu_torch.run --mode sdf --scene mesh.obj --save_mesh
      fits a neural SDF to the mesh (``engine/sdf_mode.py``; 2,000 steps by
      default) and writes logs/sdf_eval.json (IoU), sdf_render.png (a
      sphere-traced normal map at ``--sdf_render_res``) and
      mesh/sdf_mesh.obj;
  python -m neus2_tpu_torch.run --mode image --scene image.png
      fits rgb(x, y) (``engine/image_mode.py``; 1,000 steps by default)
      and writes logs/image_eval.json (PSNR) and image_recon.png.

Data-parallel training (``--multichip on``, or ``auto`` with more than one
card): one rank a card, each training its share of the ``--n_rays``
global batch (``parallel/train.py``; ``--zero1`` shards the hash tables'
optimizer state).  Started plainly, the CLI spawns one rank a card itself;
under ``torchrun`` each process is a rank (``--device cpu`` trains on
gloo); ``--multihost`` joins a world given by ``--coordinator host:port``,
``--num_processes`` and ``--process_id``.  Rank 0 writes every file:
  torchrun --standalone --nproc_per_node 2 -m neus2_tpu_torch.run \\
      --scene <json> --device cpu --multichip on [--zero1]
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
    p.add_argument("--scene", required=True,
                   help="transforms.json (static) or a directory of per-frame jsons (dynamic)")
    p.add_argument("--network", default=None, help="network config json (reference format)")
    p.add_argument("--name", default="exp", help="experiment name -> <output_dir>/<name>/")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--n_steps", type=int, default=None,
                   help="override first_frame_max_training_step")
    p.add_argument("--next_frame_steps", type=int, default=None,
                   help="dynamic scenes: override next_frame_max_training_step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_rays", type=int, default=None)
    p.add_argument("--samples_per_ray", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 operands for the MLPs and the encoder's backward "
                        "(fp32 sums and master params)")
    p.add_argument("--fp16-images", action="store_true",
                   help="store the training images in fp16 (half the device memory)")
    p.add_argument("--depth_supervision_lambda", type=float, default=None,
                   help="L2 depth-supervision weight; depth maps load from per-frame "
                        "depth_path + integer_depth_scale")
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--dynamic_save_mesh", action="store_true",
                   help="dynamic scenes: export the canonical mesh when each frame finishes")
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--save_density_png", action="store_true",
                   help="save a slice mosaic PNG of the SDF grid "
                        "(reference save_density_grid_to_png)")
    p.add_argument("--mesh_largest_component", action="store_true",
                   help="drop disconnected floaters from the exported mesh")
    p.add_argument("--ref_mesh", default=None,
                   help="reference mesh (.obj) for a Chamfer-distance eval")
    p.add_argument("--shaded_mesh", action="store_true",
                   help="with --save_eval_images: rasterize the extracted mesh from each "
                        "eval view, Lambertian-shaded (with --save_mesh and without this "
                        "flag the panel is a normal map)")
    p.add_argument("--test_transforms", default=None,
                   help="held-out transforms json for PSNR/SSIM eval")
    p.add_argument("--eval_per_frame", action="store_true",
                   help="dynamic scenes: log view 0's PSNR when each frame finishes")
    p.add_argument("--eval_spp", type=int, default=8)
    p.add_argument("--save_eval_images", action="store_true",
                   help="write each eval view's render | GT | 4 |render - GT| panel as a PNG")
    p.add_argument("--screenshot_transforms", default=None,
                   help="render the views of this transforms json to PNGs")
    p.add_argument("--screenshot_dir", default=None,
                   help="output dir for --screenshot_transforms "
                        "(default <output_dir>/<name>/screenshots)")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--screenshot_frames", nargs="*", type=int, default=None,
                   help="the view indices to render (default: all)")
    p.add_argument("--render_path", default=None,
                   help="render PNG frames along a camera path: a CameraPath json, or "
                        "'orbit' for a circular orbit")
    p.add_argument("--render_n_frames", type=int, default=60)
    p.add_argument("--hit_oversample", type=int, default=None,
                   help="probe N * n_rays candidate pixels and fill the batch with rays "
                        "that hit the occupancy grid; 1 = off")
    p.add_argument("--near_distance", type=float, default=None,
                   help="training rays start this far from the camera (< 0 or unset: "
                        "the config's)")
    p.add_argument("--tensorboard", action="store_true",
                   help="log the losses every 100 steps as TensorBoard scalars under "
                        "<output_dir>/<name>/logs (dynamic scenes: also logs/frame_<k>)")
    p.add_argument("--grid_stats", action="store_true",
                   help="log per-level hash-grid weight stats after training")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--mode", choices=("nerf", "sdf", "image"), default="nerf",
                   help="nerf (NeuS2 reconstruction), sdf (fit a mesh's SDF; --scene is an "
                        "OBJ) or image (fit an image; --scene is a PNG/JPEG)")
    p.add_argument("--sdf_render_res", type=int, default=512)
    p.add_argument("--snapshot", default=None,
                   help="load a snapshot (native, from either package, or reference format) "
                        "after the scene")
    p.add_argument("--save_snapshot_every", type=int, default=0)
    p.add_argument("--no_train", action="store_true")
    p.add_argument("--multichip", choices=("auto", "on", "off"), default="auto",
                   help="data-parallel training, one rank a card (auto: on with more than "
                        "one card)")
    p.add_argument("--zero1", action="store_true",
                   help="multichip: shard the hash tables' gradient reduction and optimizer "
                        "state over the ranks (ZeRO-1)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process world given by --coordinator, --num_processes "
                        "and --process_id (one process a card); rank 0 writes every file")
    p.add_argument("--coordinator", default=None, help="multihost: rank 0's host:port")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    out = Path(args.output_dir) / args.name
    if args.mode == "sdf":
        return main_sdf(args, out)
    if args.mode == "image":
        return main_image(args, out)

    from neus2_tpu_torch.parallel import distributed

    world = (args.coordinator, args.num_processes, args.process_id) if args.multihost else ()
    started = distributed.initialize(*world, device=args.device)
    if not torch.distributed.is_initialized() and args.multichip != "off":
        n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
        if n > 1 or args.multichip == "on":
            distributed.launch(_main_rank, n, argv, device=args.device)
            return None
    try:
        return main_nerf(args, out)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _main_rank(ctx, argv) -> None:
    """One rank of a run ``main`` spawned."""
    main(argv)


def main_nerf(args, out: Path):
    """The static and dynamic NeuS2 mode: train, then rank 0 writes the
    outputs the flags ask for -> the Testbed."""
    from neus2_tpu_torch.api.testbed import Hyperparams, Testbed, config_from_json
    from neus2_tpu_torch.engine.train import TrainConfig
    from neus2_tpu_torch.parallel import distributed

    for sub in ("checkpoints", "mesh", "logs"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    log_path = out / "log.txt"
    primary = distributed.is_primary()

    def log(msg: str):
        if not primary:  # the ranks train alike; rank 0 reports
            return
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
    if args.hit_oversample:
        changes["hit_oversample"] = args.hit_oversample
    if args.depth_supervision_lambda is not None:
        changes["depth_supervision_lambda"] = args.depth_supervision_lambda
    if args.near_distance is not None and args.near_distance >= 0:
        changes["near"] = args.near_distance
    if args.bf16:
        changes["field"] = dataclasses.replace(config.field, compute_dtype=torch.bfloat16)
    if changes:
        config = dataclasses.replace(config, **changes)
    if args.n_steps:
        hyper.first_frame_max_training_step = args.n_steps
    if args.next_frame_steps:
        hyper.next_frame_max_training_step = args.next_frame_steps

    tb = Testbed(config=config, hyper=hyper, seed=args.seed, device=args.device,
                 image_dtype=torch.float16 if args.fp16_images else None)
    if torch.distributed.is_initialized() and args.multichip != "off":
        n = tb.enable_multichip(zero1=args.zero1)
        log(f"multichip: data-parallel over {n} ranks ({config.n_rays} rays/batch global, "
            f"{max(1, config.n_rays // n)} a rank" + (", zero1 table sharding" if args.zero1
                                                      else "") + ")")
    log(f"loading scene {args.scene}")
    try:
        tb.load_training_data(args.scene)
    except FileNotFoundError as e:
        print(f"error: scene not found: {e}", file=sys.stderr)
        sys.exit(2)
    log(f"{tb.dataset.n_images} images @ {tb.dataset.resolution}, "
        f"{tb.all_training_time_frame} time frame(s), device={tb.device}")
    if args.snapshot:
        tb.load_snapshot(args.snapshot)
        log(f"restored snapshot {args.snapshot}")
    if args.eval_per_frame and primary:
        tb.on_frame_complete = _make_per_frame_eval(log)

    if not args.no_train:
        train(tb, args, out, log)
    tb.prepare_for_test()
    if primary and args.grid_stats:
        from neus2_tpu_torch.utils.introspect import format_level_stats, hashgrid_level_stats

        log("hashgrid level stats:\n" + format_level_stats(hashgrid_level_stats(tb.state.params)))

    # Every rank reaches the mesh write: the Testbed writes on rank 0 and
    # then holds the ranks at a barrier.  The outputs after it are rank 0's.
    mesh = None
    if args.save_mesh or args.ref_mesh:
        mesh_path = out / "mesh" / ("mesh.obj" if args.save_mesh else "eval_mesh.obj")
        if args.save_mesh:
            log(f"extracting mesh @ {args.mesh_resolution}^3 -> {mesh_path}")
        mesh = tb.compute_and_save_marching_cubes_mesh(
            mesh_path, resolution=args.mesh_resolution,
            keep_largest_component=args.save_mesh and args.mesh_largest_component)
    if not primary:
        return tb
    if args.save_mesh:
        log(f"mesh: {len(mesh[0])} vertices, {len(mesh[1])} triangles")

    if args.save_density_png:
        from neus2_tpu_torch.engine.mesh import save_density_grid_png
        from neus2_tpu_torch.ops.warp import scene_aabb

        png_path = out / "mesh" / "density_grid.png"
        nvox, nnear = save_density_grid_png(
            tb.state.ema_params, tb.config.field, png_path,
            resolution=min(args.mesh_resolution, 128), aabb=scene_aabb(tb.config.aabb_scale))
        log(f"density grid png -> {png_path} "
            f"({nvox} surface voxels, {nnear} near-crossing lattice points)")

    if args.ref_mesh:
        from neus2_tpu_torch.engine.mesh import chamfer_distance
        from neus2_tpu_torch.engine.sdf_mode import load_mesh_obj

        # OBJ exports live in the dataset's space ((v - offset) / scale):
        # compare both meshes there.
        verts_ds = (mesh[0] - np.asarray(tb.dataset.offset, np.float32)) / tb.dataset.scale
        cd = chamfer_distance(verts_ds, load_mesh_obj(args.ref_mesh)[0], device=tb.device)
        log(f"chamfer vs {args.ref_mesh}: {cd:.6f}")

    if args.render_path:
        log(f"rendering {args.render_n_frames} frames along {args.render_path}")
        render_camera_path(tb, args.render_path, args.render_n_frames, out / "frames",
                           args.eval_spp, log)

    if args.screenshot_transforms:
        shot_dir = Path(args.screenshot_dir) if args.screenshot_dir else out / "screenshots"
        screenshot(tb, args.screenshot_transforms, shot_dir, args.screenshot_spp,
                   args.screenshot_frames, log)

    if args.test_transforms:
        # The eval's mesh panel (reference render_utils.py:418-421): the
        # extracted mesh rasterized from each eval view.
        eval_mesh = None
        if args.save_eval_images and (args.save_mesh or args.shaded_mesh):
            if args.save_mesh:
                eval_mesh = mesh
            else:
                from neus2_tpu_torch.engine.mesh import extract_mesh
                from neus2_tpu_torch.ops.warp import scene_aabb

                eval_mesh = extract_mesh(tb.state.ema_params, tb.config.field,
                                         resolution=args.mesh_resolution,
                                         box=scene_aabb(tb.config.aabb_scale))
        psnrs, ssims = evaluate(tb, args.test_transforms, args.eval_spp, log,
                                save_dir=(out / "evaluation") if args.save_eval_images else None,
                                mesh=eval_mesh, mesh_shaded=args.shaded_mesh)
        metrics = {
            "psnr_mean": float(np.mean(psnrs)),
            "ssim_mean": float(np.mean(ssims)),
            "psnr": [float(p) for p in psnrs],
        }
        with open(out / "metrics.json", "w") as f:
            json.dump(metrics, f, indent=2)
        log(f"eval: PSNR {metrics['psnr_mean']:.2f} dB  SSIM {metrics['ssim_mean']:.4f}")
    return tb


def train(tb, args, out: Path, log):
    """``while tb.frame()`` with the CLI's outputs: a log line every 100
    steps, ``<step>.msgpack`` every ``--save_snapshot_every`` steps and
    ``final.msgpack`` at the end; for a dynamic scene, when frame k
    finishes, its incremental snapshot, its transform and (with
    ``--dynamic_save_mesh``) its canonical mesh.  With ``--tensorboard``
    (on every rank, as the JAX CLI opens its writers), every 100 steps the
    three losses go to logs/ at the global step and, for a dynamic scene,
    the rgb loss to logs/frame_<k> (opened on first use) at the frame's
    step; every writer is closed on the way out."""
    from neus2_tpu_torch.utils.event_file import EventFileWriter

    ckpt = out / "checkpoints"
    writer = EventFileWriter(out / "logs") if args.tensorboard else None
    frame_writers = {}
    try:
        t0 = time.time()
        # From the frame a snapshot resumed in (the JAX CLI starts at 0, so a
        # resume into frame k >= 1 rewrites frame 0's files with frame k's state).
        step, last_frame = 0, tb.current_training_time_frame
        while tb.frame():
            step += 1
            if tb.current_training_time_frame != last_frame:
                # The switch has folded frame last_frame's delta into acc.
                last_frame = tb.current_training_time_frame
                log(f"-> time frame {last_frame} at step {step} [{time.time() - t0:.1f}s]")
                tb.save_snapshot(ckpt / f"frame_{last_frame - 1}.msgpack", incremental=True)
                tb.save_transform(ckpt / f"transform_{last_frame - 1}.txt")
                if args.dynamic_save_mesh:
                    mesh_path = out / "mesh" / f"frame_{last_frame - 1:04d}.obj"
                    tb.compute_and_save_marching_cubes_mesh(mesh_path,
                                                            resolution=args.mesh_resolution)
                    log(f"  per-frame mesh -> {mesh_path}")
            if step % 100 == 0:
                log(f"step {step} (frame {tb.current_training_time_frame} local "
                    f"{tb.training_step}) loss={tb.loss_scalar:.5f} ek={tb.ek_loss_scalar:.5f} "
                    f"mask={tb.mask_loss_scalar:.5f} [{time.time() - t0:.1f}s]")
                if writer is not None:
                    writer.add_scalar("loss/rgb", tb.loss_scalar, step)
                    writer.add_scalar("loss/ek", tb.ek_loss_scalar, step)
                    writer.add_scalar("loss/mask", tb.mask_loss_scalar, step)
                    if tb.is_dynamic:  # reference run_dynamic.py:296-305 logs both
                        k = tb.current_training_time_frame
                        if k not in frame_writers:
                            frame_writers[k] = EventFileWriter(out / "logs" / f"frame_{k}")
                        frame_writers[k].add_scalar("loss/rgb", tb.loss_scalar, tb.training_step)
            if args.save_snapshot_every and step % args.save_snapshot_every == 0:
                tb.save_snapshot(ckpt / f"{step}.msgpack")
        log(f"training done: {step} steps in {time.time() - t0:.1f}s")
        tb.save_snapshot(ckpt / "final.msgpack")
        if tb.is_dynamic:
            # The last frame's delta is never folded; save_transform includes it.
            tb.save_transform(ckpt / f"transform_{tb.current_training_time_frame}.txt")
    finally:
        for w in [writer, *frame_writers.values()]:
            if w is not None:
                w.close()


def _write_png(path: Path, rgb) -> None:
    """An (H, W, 3) image in [0, 1] (tensor or array) as an 8-bit PNG."""
    from PIL import Image

    if torch.is_tensor(rgb):
        rgb = rgb.cpu().numpy()
    Image.fromarray((np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)).save(path)


def _eval_render_config(tb):
    from neus2_tpu_torch.engine.render import RenderConfig

    return RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                        min_transmittance=1e-4)


def screenshot(tb, transforms: str, out_dir: Path, spp: int, frames, log):
    """Render the views of a transforms json to PNGs (reference run.py
    screenshot mode, scripts/run.py:46-49, 345-377)."""
    from neus2_tpu_torch.data.dataset import load_dataset
    from neus2_tpu_torch.engine.render import render_image

    ds = load_dataset(transforms)
    cams = tb.render_cameras(ds.cameras(tb.device))
    cfg = _eval_render_config(tb)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in (frames if frames else range(ds.n_images)):
        rgb, _, _ = render_image(
            tb.state.ema_params, tb.effective_acc, tb.state.occupancy, cams,
            cams.poses[i], cams.focal[i], cams.principal[i],
            torch.Generator(device=tb.device).manual_seed(i), cfg, background=0.0, spp=spp,
            **tb._render_extras(),
        )
        fp = out_dir / f"{i:04d}.png"
        _write_png(fp, rgb)
        log(f"  screenshot {fp}")


def render_camera_path(tb, path_spec: str, n_frames: int, out_dir, spp: int, log) -> Path:
    """PNG frames along a camera path (reference camera_path.cu's spline,
    rendered headless): a CameraPath json, or "orbit" for a circular orbit
    around the scene centre, at the dataset's resolution."""
    from neus2_tpu_torch.engine.render import render_image
    from neus2_tpu_torch.engine.rays import Cameras
    from neus2_tpu_torch.utils.camera_path import CameraPath, orbit_path

    path = orbit_path() if path_spec == "orbit" else CameraPath.load(path_spec)
    w, h = tb.dataset.resolution
    cfg = _eval_render_config(tb)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    denom = n_frames if path.loop else max(n_frames - 1, 1)
    f32 = dict(dtype=torch.float32, device=tb.device)
    for k in range(n_frames):
        kf = path.eval(k / denom)
        focal = 0.5 * h / np.tan(0.5 * np.deg2rad(kf.fov_deg))
        cams = Cameras(poses=torch.as_tensor(kf.pose, **f32)[None],
                       focal=torch.full((1, 2), float(focal), **f32),
                       principal=torch.full((1, 2), 0.5, **f32), resolution=(w, h))
        rgb, _, _ = render_image(
            tb.state.ema_params, tb.effective_acc, tb.state.occupancy, cams,
            cams.poses[0], cams.focal[0], cams.principal[0],
            torch.Generator(device=tb.device).manual_seed(k), cfg, background=0.0, spp=spp,
            **tb._render_extras(),
        )
        fp = out_dir / f"frame_{k:04d}.png"
        _write_png(fp, rgb)
        log(f"  rendered {fp}")
    return out_dir


def _make_per_frame_eval(log):
    """A frame hook logging view 0's PSNR (reference run_dynamic.py:183-201:
    64 samples, spp 1, black background)."""
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target

    def hook(tb, frame_idx):
        cfg = RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                           samples_per_ray=64, n_candidates=192)
        cams = tb.render_cameras()
        w, h = tb._image_size(0)
        rgb, _, _ = render_image(
            tb.state.ema_params, tb.effective_acc, tb.state.occupancy, cams,
            cams.poses[0], cams.focal[0], cams.principal[0],
            torch.Generator(device=tb.device).manual_seed(0), cfg, background=0.0, spp=1,
            resolution=(w, h), **tb._render_extras(),
        )
        target = srgb_eval_target(tb.images[0, :h, :w].float())
        log(f"frame {frame_idx} view-0 PSNR: {float(psnr(rgb, target)):.2f} dB")

    return hook


def evaluate(tb, test_transforms: str, spp: int, log, save_dir: Path | None = None,
             mesh=None, mesh_shaded: bool = False) -> tuple[list, list]:
    """PSNR / SSIM on held-out views (reference run.py:251-344 protocol:
    black background, ``spp`` jittered passes, min transmittance 1e-4,
    sRGB space), through the views' lens as loaded, whatever the
    Testbed's ``render_with_camera_distortion`` (which drops only the
    learned distortion grid, in ``_render_extras``), as the JAX package's
    ``evaluate`` does.  A view of a mixed-size set
    renders at its true size and is scored on its true pixels only, not on
    the loader's zero padding.  ``save_dir``: each view's render | GT | 4
    |render - GT| as ``view_{i:03d}.png`` (the reference's cal_psnr image
    dumps) and, given ``mesh`` (verts, tris), the mesh rasterized from the
    view as ``view_{i:03d}_mesh.png``: a normal map, or Lambertian grey
    when ``mesh_shaded`` (``native.render_mesh_image``)."""
    from neus2_tpu_torch.data.dataset import load_dataset
    from neus2_tpu_torch.engine.render import render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim

    ds = load_dataset(test_transforms)
    images, cams = ds.to_device(tb.device)
    cfg = _eval_render_config(tb)
    psnrs, ssims = [], []
    for i in range(ds.n_images):
        w_i, h_i = (int(v) for v in ds.sizes[i]) if ds.sizes is not None else ds.resolution
        rgb, _, _ = render_image(
            tb.state.ema_params, tb.effective_acc, tb.state.occupancy, cams,
            cams.poses[i], cams.focal[i], cams.principal[i],
            torch.Generator(device=tb.device).manual_seed(i), cfg,
            background=0.0, spp=spp, resolution=(w_i, h_i), **tb._render_extras(),
        )
        target = srgb_eval_target(images[i][:h_i, :w_i])
        p, s = float(psnr(rgb, target)), float(ssim(rgb, target))
        psnrs.append(p)
        ssims.append(s)
        log(f"  view {i}: PSNR {p:.2f}  SSIM {s:.4f}")
        if save_dir is not None:
            save_dir.mkdir(parents=True, exist_ok=True)
            _write_png(save_dir / f"view_{i:03d}.png",
                       torch.cat([rgb, target, (rgb - target).abs() * 4], dim=1))
            if mesh is not None:
                from neus2_tpu_torch.native import render_mesh_image

                mrgb, _ = render_mesh_image(
                    mesh[0], mesh[1], ds.poses[i], ds.focal[i], ds.principal[i], (w_i, h_i),
                    shaded=mesh_shaded)
                _write_png(save_dir / f"view_{i:03d}_mesh.png", mrgb)
    return psnrs, ssims


def main_sdf(args, out: Path) -> dict:
    """The SDF-from-mesh mode (reference main.cu's mode dispatch ->
    testbed_sdf.cu): fit ``--scene`` (an OBJ) for ``--n_steps`` (2,000)
    steps, log the IoU to logs/sdf_eval.json, write sdf_render.png (a
    sphere-traced normal map from eye (0.5, -1.1, 1.0)) and, with
    ``--save_mesh``, mesh/sdf_mesh.obj.  Returns the run's parts."""
    from neus2_tpu_torch.data.synthetic import _look_at
    from neus2_tpu_torch.engine import sdf_mode
    from neus2_tpu_torch.engine.mesh import extract_mesh, save_mesh_obj

    out.mkdir(parents=True, exist_ok=True)
    steps = args.n_steps or 2000
    params, cfg, bvh, mesh = sdf_mode.fit_mesh_sdf(args.scene, n_steps=steps, seed=args.seed,
                                                   device=args.device)
    iou = sdf_mode.eval_iou(params, cfg, bvh)
    print(f"sdf mode: {steps} steps, IoU {iou:.4f}", flush=True)
    (out / "logs").mkdir(parents=True, exist_ok=True)
    (out / "logs" / "sdf_eval.json").write_text(json.dumps({"steps": steps, "iou": iou}))

    dev = params["variance"].device
    pose = _look_at(np.array([0.5, -1.1, 1.0], np.float32), np.full(3, 0.5, np.float32),
                    np.array([0.0, 0.0, 1.0], np.float32))
    res = args.sdf_render_res
    focal = torch.full((2,), 0.5 * res / np.tan(0.35), dtype=torch.float32, device=dev)
    rgb, _, _ = sdf_mode.render_sdf_sphere_traced(
        params, torch.as_tensor(pose, device=dev), focal, cfg, resolution=(res, res))
    _write_png(out / "sdf_render.png", rgb)
    result = {"params": params, "config": cfg, "bvh": bvh, "mesh": mesh, "iou": iou}
    if args.save_mesh:
        v, f = extract_mesh(params, cfg.field, resolution=args.mesh_resolution)
        (out / "mesh").mkdir(parents=True, exist_ok=True)
        save_mesh_obj(out / "mesh" / "sdf_mesh.obj", v, f)
        print(f"mesh saved ({v.shape[0]} verts)", flush=True)
        result["sdf_mesh"] = (v, f)
    return result


def _read_image(path) -> np.ndarray:
    """An image file as float32 (H, W, C) in [0, 1] (8-bit values scaled
    by 1/255, as the JAX CLI scales them), read with Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGB")
        img = np.asarray(im, np.float32)
    return img / 255.0 if img.max() > 1.5 else img


def main_image(args, out: Path) -> dict:
    """The image-fit mode (reference testbed_image.cu:220): fit ``--scene``
    for ``--n_steps`` (1,000) steps, log the PSNR to logs/image_eval.json
    and write image_recon.png.  Returns the run's parts."""
    from neus2_tpu_torch.engine import image_mode

    out.mkdir(parents=True, exist_ok=True)
    img = _read_image(args.scene)
    steps = args.n_steps or 1000
    params, psnr = image_mode.fit_image(img, n_steps=steps, seed=args.seed, device=args.device)
    print(f"image mode: {steps} steps, reconstruction PSNR {psnr:.2f} dB", flush=True)
    (out / "logs").mkdir(parents=True, exist_ok=True)
    (out / "logs" / "image_eval.json").write_text(json.dumps({"steps": steps, "psnr": psnr}))
    cfg = image_mode.Image2DConfig()
    recon = image_mode.render_image_fit(params, cfg, (img.shape[1], img.shape[0]))
    _write_png(out / "image_recon.png", recon)
    return {"params": params, "config": cfg, "psnr": psnr, "recon": recon}


if __name__ == "__main__":
    main(sys.argv[1:])
