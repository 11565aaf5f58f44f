"""What the quality protocols share (port of the TPU package's root tools:
``bench.py::flagship_config`` and ``tools_tpu_validate_csg.py`` :65-88,
:120-135, :173-238).

- ``flagship_config``: the bench's batch (4096 rays x 64 samples, 256
  candidates, mask loss 0.1) at bf16 compute on a flagship grid.
- ``gt_surface_points``: points on an analytic scene's zero set, in numpy,
  so both packages draw the same points bit for bit.
- ``scene_dataset``: an analytic scene's views, every pose drawn first in
  view order from the one jitter stream, then the views sphere-traced in a
  pool of processes and cached as ``.npz``: the same arrays as the serial
  ``make_csg_dataset``.
- ``heldout_eval``, ``surface_sdf_err``, ``mesh_chamfer``: the held-out
  PSNR / SSIM, the mean |SDF| on ground-truth points, and the Chamfer
  distance of the largest component of a 256^3 mesh in [0.15, 0.85]^3
  (the mean of the two directed mean nearest-neighbour distances against
  the ground-truth cloud, the vertices subsampled by stride).  A mesh that
  cannot be made fails the run.
- ``Chunk``: a budgeted stretch of training that records what it cost (wall
  time, host ms and, on the card, traced device ms a step, kernel-1
  launches), every adaptive-bucket switch, the occ_len trace
  (``tools_occlen_run.py`` :71-89: [step, occ_len EMA, bucket], then the
  loss and the step's own occ_len, every 16 steps, read from the Testbed's
  own 16-step host fetch)
  and the rays/s by bucket over stable stretches.
- ``fixed_bucket``: a config trained in one adaptive bucket throughout
  (``tools_bucket_cont.py`` :52-57).
- ``sphere_shell``, ``csg_surface_points``, ``ab_scene``: the sphere and
  analytic-scene A/B protocols' points and datasets, as the root tools
  draw them.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import time
from concurrent.futures import ProcessPoolExecutor
from itertools import repeat
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.data.dataset import NerfDataset
from neus2_tpu_torch.data.synthetic import (
    SCENES,
    csg_dataset,
    csg_poses,
    make_sphere_dataset,
    render_csg_view,
)
from neus2_tpu_torch.engine.mesh import extract_mesh, largest_component
from neus2_tpu_torch.engine.render import RenderConfig, render_image
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig, sdf_fn
from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim
from neus2_tpu_torch.ops.segment_tile import segment_sum_rows
from neus2_tpu_torch.ops.warp import AABB
from neus2_tpu_torch.utils.variants import flagship_grid

#: The default working directory of the tools' snapshots, dataset caches
#: and results: outside any checkout.
DEFAULT_WORKDIR = Path.home() / ".cache" / "neus2_quality"
PROFILE_WINDOW = 16  # traced steps a device-time window
PROFILE_EVERY = 1000  # one window in each stretch of as many steps
TRACE_EVERY = 16  # the Testbed's host fetch: the occ_len trace's cadence
RATE_STRETCH = 64  # steps in one bucket before its rays/s is read
SPHERE_EVAL_IDS = [3, 9, 14, 17]  # the sphere protocols' held-out views of the 20-view ring


def flagship_config(variant: str = "parity") -> TrainConfig:
    """The bench's flagship config: ``variant``'s grid (parity L14/F2,
    tpu_opt L7/F4, l4f8 L4/F8) at bf16 compute, 4096 rays x 64 samples,
    256 candidates, mask loss 0.1."""
    return TrainConfig(
        field=FieldConfig(compute_dtype=torch.bfloat16, grid=flagship_grid(variant)),
        n_rays=4096,
        samples_per_ray=64,
        n_candidates=256,
        mask_loss_weight=0.1,
    )


def fixed_bucket(config: TrainConfig, bucket: int) -> TrainConfig:
    """``config`` trained in adaptive bucket ``bucket`` throughout: (rays
    << bucket) x (samples >> bucket), the same samples a step, and the
    adaptive switch off."""
    return dataclasses.replace(config, n_rays=config.n_rays << bucket,
                               samples_per_ray=config.samples_per_ray >> bucket,
                               adaptive_batch=False)


def sphere_shell(n: int, float32_first: bool) -> np.ndarray:
    """(n, 3) float32 points on the synthetic sphere (centre 0.5, radius
    0.25) along directions drawn from ``default_rng(0)``: computed in
    float64 and cast (``tools_tpu_validate.py``, ``tools_compact_ab.py``),
    or cast first and computed in float32 (``tools_bucket_ab.py``,
    ``tools_bucket_cont.py``)."""
    d = np.random.default_rng(0).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if float32_first:
        return np.float32(0.5) + np.float32(0.25) * d.astype(np.float32)
    return (0.5 + 0.25 * d).astype(np.float32)


def csg_surface_points(sdf) -> np.ndarray:
    """The A/B tools' surface points of an analytic scene: the first 4,096
    of 200,000 uniform points in [0.2, 0.8]^3 with |sdf| < 0.01."""
    pts = np.random.default_rng(0).uniform(0.2, 0.8, size=(200000, 3)).astype(np.float32)
    return pts[np.abs(sdf(pts)) < 0.01][:4096]


def ab_scene(scene: str, res: int, workdir: Path | None):
    """(training views, eval dataset, held-out ids) of the A/B protocols:
    the sphere on 16 views, held out on ``SPHERE_EVAL_IDS`` of a 20-view
    ring; an analytic scene on the first 24 of 26 views, held out on the
    last two."""
    if scene == "sphere":
        return (make_sphere_dataset(n_views=16, resolution=res),
                make_sphere_dataset(n_views=20, resolution=res), SPHERE_EVAL_IDS)
    eval_ds = scene_dataset(scene, 26, res, workdir)
    return eval_ds.subset(slice(0, 24)), eval_ds, [24, 25]


def gt_surface_points(sdf, n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 points on ``sdf``'s zero set: uniform candidates in
    [0.2, 0.8]^3 within 0.08 of the surface, 12 Newton projections along
    the finite-difference normal, and those within 1e-4 of it kept."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.2, 0.8, size=(n * 40, 3)).astype(np.float32)
    pts = pts[np.abs(sdf(pts)) < 0.08][: n * 4]
    eps = 1e-4
    for _ in range(12):
        d = sdf(pts)[..., None]
        g = np.stack(
            [
                sdf(pts + np.array([eps, 0, 0], np.float32))
                - sdf(pts - np.array([eps, 0, 0], np.float32)),
                sdf(pts + np.array([0, eps, 0], np.float32))
                - sdf(pts - np.array([0, eps, 0], np.float32)),
                sdf(pts + np.array([0, 0, eps], np.float32))
                - sdf(pts - np.array([0, 0, eps], np.float32)),
            ],
            axis=-1,
        ) / (2 * eps)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
        pts = pts - d * g
    pts = pts[np.abs(sdf(pts)) < 1e-4]
    return pts[:n].astype(np.float32)


def default_workers() -> int:
    return len(os.sched_getaffinity(0))


def render_views(scene: str, n_views: int, resolution: int, workers: int) -> NerfDataset:
    """``scene``'s first ``n_views`` views at ``resolution``^2, the
    sphere tracing spread over ``workers`` spawned processes."""
    sdf, albedo = SCENES[scene]
    poses = csg_poses(n_views)
    args = (poses, repeat(resolution), repeat(50.0), repeat(sdf), repeat(albedo))
    if workers <= 1:
        images = list(map(render_csg_view, *args))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, n_views), mp_context=ctx) as ex:
            images = list(ex.map(render_csg_view, *args))
    return csg_dataset(poses, images, resolution)


def scene_dataset(scene: str, n_views: int, resolution: int, cache_dir: Path | None,
                  workers: int | None = None) -> NerfDataset:
    """``render_views``, read from ``cache_dir``'s
    ``csg_ds_<scene>_<n>v_<res>.npz`` when it holds one, else rendered and
    written there (beside the file, then renamed over it)."""
    cache = None
    if cache_dir is not None:
        cache = Path(cache_dir) / f"csg_ds_{scene}_{n_views}v_{resolution}.npz"
        if cache.exists():
            with np.load(cache) as z:
                ds = csg_dataset(z["poses"], z["images"], resolution)
            print(f"dataset from cache {cache}", flush=True)
            return ds
    t0 = time.perf_counter()
    ds = render_views(scene, n_views, resolution, workers or default_workers())
    print(f"dataset: {n_views} views of {scene} at {resolution}^2 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if cache is not None:
        tmp = cache.with_name(cache.stem + ".tmp.npz")
        np.savez(tmp, images=ds.images, poses=ds.poses, focal=ds.focal, principal=ds.principal)
        os.replace(tmp, cache)
    return ds


@torch.no_grad()
def heldout_eval(state, field: FieldConfig, dataset: NerfDataset, ids, samples: int = 128,
                 candidates: int = 256, spp: int = 8, acc=None, seed: int | None = None,
                 aabb_scale: int = 1) -> tuple[list, list]:
    """(PSNR, SSIM) of each view in ``ids`` of ``dataset``: the EMA field
    rendered through ``acc`` (default: the state's accumulated transform)
    on black at ``spp``, min transmittance 1e-4, against the view's
    sRGB-on-black target.  Jittered passes draw from a generator seeded
    with ``seed``, or with the view's index when ``seed`` is None."""
    dev = state.occupancy.density.device
    cams = dataset.cameras(dev)
    rcfg = RenderConfig(field=field, samples_per_ray=samples, n_candidates=candidates,
                        aabb_scale=aabb_scale, chunk=1 << 13)
    psnrs, ssims = [], []
    for k in ids:
        gen = torch.Generator(device=dev).manual_seed(int(k if seed is None else seed))
        rgb, _, _ = render_image(state.ema_params, state.acc if acc is None else acc,
                                 state.occupancy, cams, cams.poses[k], cams.focal[k],
                                 cams.principal[k], gen, rcfg, background=0.0, spp=spp)
        target = srgb_eval_target(torch.from_numpy(dataset.images[k]).to(dev))
        psnrs.append(float(psnr(rgb, target)))
        ssims.append(float(ssim(rgb, target)))
    return psnrs, ssims


@torch.no_grad()
def surface_sdf_err(params, field: FieldConfig, pts: np.ndarray) -> float:
    """Mean |SDF| of the field at ``pts``."""
    x = torch.from_numpy(np.ascontiguousarray(pts)).to(_device_of(params))
    return float(sdf_fn(params, x, field)[0].abs().mean())


def _device_of(params) -> torch.device:
    return params["hashgrid"][0].device


def directed_mean_nn(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024) -> float:
    """Mean over ``a``'s points of the distance to the nearest of ``b``."""
    outs = [torch.linalg.norm(a[i:i + chunk, None, :] - b[None, :, :], dim=-1).min(dim=1).values
            for i in range(0, a.shape[0], chunk)]
    return float(torch.cat(outs).mean())


@torch.no_grad()
def mesh_chamfer(params, field: FieldConfig, gt_pts: np.ndarray,
                 resolution: int = 256) -> tuple[float, int]:
    """(symmetric Chamfer distance, vertices kept) of the field's mesh:
    marching cubes on a ``resolution``^3 grid over [0.15, 0.85]^3, the
    largest component kept (the mask-free stand-in for the reference DTU
    protocol's object-mask crop), its vertices subsampled by stride to
    about 16,384 against ``gt_pts``.  Raises on an empty mesh."""
    dev = _device_of(params)
    verts, faces = extract_mesh(params, field, resolution=resolution,
                                box=AABB((0.15, 0.15, 0.15), (0.85, 0.85, 0.85)))
    verts, faces = largest_component(np.asarray(verts), np.asarray(faces))
    if verts.shape[0] == 0:
        raise RuntimeError("the field's mesh is empty: no Chamfer distance")
    v = torch.from_numpy(np.asarray(verts, np.float32)).to(dev)
    g = torch.from_numpy(gt_pts).to(dev)
    sub = v[:: max(1, v.shape[0] // 16384)]
    return 0.5 * (directed_mean_nn(sub, g) + directed_mean_nn(g, sub)), int(verts.shape[0])


def card_name() -> str | None:
    """``name, power.limit`` of the first card as ``nvidia-smi`` gives
    them (None on the CPU)."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Chunk:
    """One budgeted stretch of training: ``step()`` runs the Testbed's
    step (``frame`` or ``train``) while ``running()``; ``close()`` returns
    what the stretch cost.  On the card, every ``PROFILE_EVERY`` steps a
    window of ``PROFILE_WINDOW`` steps is traced (device ms and launches a
    step, with the bucket it ran in).  ``history`` gets [step, bucket,
    occ_len EMA] at each adaptive-bucket switch.  Every ``TRACE_EVERY``
    steps, right after the Testbed's host fetch, ``occ_hist`` gets [step,
    occ_len EMA, bucket, loss, occ_len] (the EMA is the adaptive switch's,
    0 with the switch off; the last field the fetched step's own occupied
    chord; then the time frame on a dynamic scene, whose step counts from
    each frame's start), and once a bucket has trained
    ``RATE_STRETCH`` steps since the stretch began or the bucket last
    changed, ``rates`` holds its trained rays/s over them (host clock)."""

    clock = staticmethod(time.perf_counter)

    def __init__(self, tb, budget_s: float, history: list | None = None):
        self.tb, self.budget_s = tb, budget_s
        self.history = [] if history is None else history
        self.cuda = tb.device.type == "cuda"
        self.from_step = tb.training_step
        self.steps = 0
        self.losses_finite = True
        self.launches0 = segment_sum_rows.launches
        self.windows = []
        self.occ_hist, self.rates = [], {}
        self._prof = None
        self._last_bucket = tb.batch_bucket
        self._sync()
        self.t0 = self.clock()
        self._rate_from = (self.t0, tb.training_step, tb.batch_bucket)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.tb.device)

    def elapsed(self) -> float:
        return self.clock() - self.t0

    def running(self) -> bool:
        return self.elapsed() < self.budget_s

    def step(self, fn) -> bool:
        """``fn()`` (a Testbed step) under the meters; returns its value
        (``frame`` returns False, and trains no step, once the last frame
        is done)."""
        if self.cuda and self._prof is None and self.steps % PROFILE_EVERY == PROFILE_EVERY // 2:
            from torch.profiler import ProfilerActivity, profile

            self._sync()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._prof_bucket, self._prof_from = self.tb.batch_bucket, self.steps
        out = fn()
        if out is False:
            return out
        self.steps += 1
        if self._prof is not None and self.steps - self._prof_from == PROFILE_WINDOW:
            self._close_window()
        if self.tb.batch_bucket != self._last_bucket:
            self.history.append([self.tb.training_step, self.tb.batch_bucket,
                                 self.tb._occ_len_ema])
            self._last_bucket = self.tb.batch_bucket
        loss = self.tb.loss_scalar
        self.losses_finite &= loss == loss and abs(loss) != float("inf")
        if self.tb.training_step % TRACE_EVERY == 0:
            self._trace()
        return out

    def _trace(self):
        tb = self.tb
        step, bucket = tb.training_step, tb.batch_bucket
        occ_len = float(tb.last_aux.mean_occ_len) if tb.last_aux is not None else 0.0
        row = [step, round(float(tb._occ_len_ema or 0.0), 5), bucket, tb.loss_scalar,
               round(occ_len, 5)]
        self.occ_hist.append(row + [tb.current_training_time_frame] if tb.is_dynamic else row)
        t0, step0, bucket0 = self._rate_from
        if bucket != bucket0:
            self._rate_from = (self.clock(), step, bucket)
        elif step - step0 >= RATE_STRETCH:
            rays = tb.config.n_rays << bucket
            self.rates[str(bucket)] = round(rays * (step - step0) / (self.clock() - t0), 1)

    def _close_window(self):
        from torch.autograd import DeviceType

        self._sync()
        self._prof.stop()
        evs = [e for e in self._prof.key_averages() if e.device_type == DeviceType.CUDA]
        self.windows.append({
            "step": self.tb.training_step, "bucket": self._prof_bucket,
            "device_ms_per_step": sum(e.self_device_time_total for e in evs) / 1e3
            / PROFILE_WINDOW,
            "device_launches_per_step": sum(e.count for e in evs) / PROFILE_WINDOW,
        })
        self._prof = None

    def close(self) -> dict:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        self._sync()
        wall = self.elapsed()
        return {
            "from_step": self.from_step, "to_step": self.tb.training_step,
            "steps": self.steps, "wall_s": wall,
            "host_ms_per_step": wall * 1e3 / max(self.steps, 1),
            "kernel1_launches": segment_sum_rows.launches - self.launches0,
            "losses_finite": self.losses_finite,
            "device_windows": self.windows,
            "rates": self.rates,
            "occ_hist": self.occ_hist,
        }


def train_chunk(tb, target: int, budget_s: float, chunk_steps: int | None = None,
                history: list | None = None, log_every: int = 100) -> dict:
    """Train ``tb`` (its ``train`` step) towards step ``target`` for one
    chunk: until the target, ``budget_s`` seconds or ``chunk_steps`` steps,
    logging every ``log_every`` steps; returns the chunk's record."""
    chunk = Chunk(tb, budget_s, history)
    stop = target if chunk_steps is None else min(target, tb.training_step + chunk_steps)
    while tb.training_step < stop and chunk.running():
        chunk.step(tb.train)
        if tb.training_step % log_every == 0:
            print(f"step {tb.training_step} loss={tb.loss_scalar:.5f} bucket={tb.batch_bucket} "
                  f"occ_len={tb._occ_len_ema or 0.0:.4f} "
                  f"[{chunk.elapsed():.0f}s]", flush=True)
    return chunk.close()


def read_json(path: Path, default):
    return json.loads(path.read_text()) if path.exists() else default


def write_json(path: Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def record_chunk(path: Path, chunk: dict, **extra) -> dict:
    """Append ``chunk`` to the run record at ``path`` ({"card", "chunks",
    "occ_hist"} and ``extra``), its occ_len trace to the run's; returns the
    record."""
    rec = read_json(path, {"card": card_name(), "chunks": []})
    chunk = dict(chunk)
    rec.setdefault("occ_hist", []).extend(chunk.pop("occ_hist", []))
    rec["chunks"].append(chunk)
    rec.update(extra)
    write_json(path, rec)
    return rec
