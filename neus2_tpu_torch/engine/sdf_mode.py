"""SDF-from-mesh mode (port of ``neus2_tpu/engine/sdf_mode.py``; reference
src/testbed_sdf.cu: train_sdf :1221, generate_training_samples_sdf :1084,
render_sdf :811 sphere tracing, the IoU eval; ground truth from the triangle
BVH of src/triangle_bvh.cu).

A neural SDF is fitted to a ground-truth MESH rather than to images:

  * the ground-truth oracle runs on the host: ``native.TriangleBVH``
    (threaded C++, signed distance by closest triangle and parity stabs);
  * training runs on the device: the hash grid + SDF MLP of
    ``models/field.py`` fitted to (point, signed distance) pairs drawn from
    a host pool in the reference's 4:3:1 mix of surface, surface + offset
    and uniform points.  Every step's table gradient goes through the
    encoder's backward, so on the card each step launches the all-levels
    segment-sum kernel (kernel 1) once;
  * rendering is a fixed 64-step sphere trace with a done mask (the
    reference's alive-list march, advance_pos_kernel_sdf :150, is
    data-dependent), shaded as a normal map from the field's gradient;
  * the eval is the IoU of sign agreement on uniform points.

Defaults are instant-ngp's sdf defaults (the reference ships no
configs/sdf/*.json): a 14 x 2 hash grid, a 64 x 2 SDF MLP, relative L2.

The batch indices come from an explicit ``torch.Generator``, or are given
(``idx``), so a test can pass another package's draw in.  The Adam is the
textbook one with eps 1e-15 (``utils/optim.py::plain_adam_update``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.models.field import FieldConfig, init_field, sdf_fn, sdf_normal_features
from neus2_tpu_torch.native import TriangleBVH
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.optim import plain_adam_apply, plain_adam_init, value_and_grads

ADAM_EPS = 1e-15  # the Adam eps of the JAX package's fit modes


# --- mesh IO ----------------------------------------------------------------


def load_mesh_obj(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: v/f records, 1-based and negative indices, the
    v/vt/vn slash syntax, polygons fan-triangulated -> (verts (V, 3)
    float32, faces (F, 3) int32)."""
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def normalize_mesh(verts: np.ndarray, margin: float = 0.15
                   ) -> tuple[np.ndarray, float, np.ndarray]:
    """Scale and centre the mesh into the unit cube with ``margin`` on each
    side -> (verts * scale + offset, scale, offset)."""
    lo, hi = verts.min(0), verts.max(0)
    scale = float((1.0 - 2.0 * margin) / max(np.max(hi - lo), 1e-9))
    offset = 0.5 - (lo + hi) * 0.5 * scale
    return verts * scale + offset, scale, offset.astype(np.float32)


# --- config -----------------------------------------------------------------


def default_sdf_field() -> FieldConfig:
    return FieldConfig(
        grid=HashGridConfig(n_levels=14, n_features_per_level=2, log2_hashmap_size=19,
                            base_resolution=16, per_level_scale=1.5),
        sdf_hidden_dim=64,
        sdf_n_hidden=2,
        geometric_init=True,
    )


@dataclasses.dataclass(frozen=True)
class SdfFitConfig:
    field: FieldConfig = dataclasses.field(default_factory=default_sdf_field)
    batch_size: int = 1 << 16
    pool_size: int = 1 << 21  # host-labelled points
    lr: float = 1e-3
    # Surface-offset stddev factor on a bounding_radius / 1024 base
    # (reference surface_offset_scale, testbed_sdf.cu:1109).
    surface_offset_scale: float = 8.0
    loss: str = "relative_l2"  # relative_l2 | l2 | l1


# --- training pool (host) ---------------------------------------------------


def generate_training_pool(bvh, verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0,
                           surface_offset_scale: float = 8.0, n_threads: int = 0
                           ) -> tuple[np.ndarray, np.ndarray]:
    """(points (n, 3), signed distances (n,)) in the reference's mix
    (testbed_sdf.cu:1084-1093): 4/8 on the surface (distance 0, no BVH
    query), 3/8 on the surface plus a normal offset, 1/8 uniform in the
    unit cube; triangles drawn by area.  numpy ``default_rng(seed)`` draws
    in the JAX package's order, so the points are its points."""
    rng = np.random.default_rng(seed)
    n_base = n // 8
    n_exact = 4 * n_base
    n_off = 3 * n_base
    n_uni = n - n_exact - n_off

    tri = verts[faces]  # (F, 3, 3)
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    ti = rng.choice(len(faces), size=n_exact + n_off, p=area / area.sum())
    u = rng.uniform(size=(n_exact + n_off, 2)).astype(np.float32)
    flip = u.sum(-1) > 1.0
    u[flip] = 1.0 - u[flip]
    t = tri[ti]
    surf = (t[:, 0] + u[:, :1] * (t[:, 1] - t[:, 0])
            + u[:, 1:] * (t[:, 2] - t[:, 0])).astype(np.float32)

    stddev = 0.5 * np.sqrt(3.0) / 1024.0 * surface_offset_scale
    off_pts = surf[n_exact:] + rng.normal(0.0, stddev, size=(n_off, 3)).astype(np.float32)
    uni_pts = rng.uniform(0.0, 1.0, size=(n_uni, 3)).astype(np.float32)

    queried = np.concatenate([off_pts, uni_pts])
    d = bvh.signed_distance(queried, n_threads=n_threads)
    pts = np.concatenate([surf[:n_exact], queried])
    dist = np.concatenate([np.zeros(n_exact, np.float32), d])
    return pts, dist


# --- the fit step -----------------------------------------------------------


def fit_loss(pred: torch.Tensor, target: torch.Tensor, kind: str) -> torch.Tensor:
    """Mean tcnn RelativeL2 ((pred - y)^2 / (pred^2 + 1e-2), the
    denominator's pred detached), L2 or L1."""
    if kind == "relative_l2":
        return ((pred - target) ** 2 / (pred.detach() ** 2 + 1e-2)).mean()
    if kind == "l1":
        return (pred - target).abs().mean()
    if kind == "l2":
        return ((pred - target) ** 2).mean()
    raise ValueError(f"unknown loss {kind!r}")


def sdf_fit_step(params, opt_state, pool_pts: torch.Tensor, pool_d: torch.Tensor,
                 config: SdfFitConfig, generator: torch.Generator | None = None,
                 idx: torch.Tensor | None = None):
    """One fit step on ``config.batch_size`` pool points -> (params,
    opt_state, loss).  The batch indices are ``idx``, or drawn uniformly
    from ``generator`` on the pool's device."""
    if idx is None:
        idx = torch.randint(0, pool_pts.shape[0], (config.batch_size,), generator=generator,
                            device=pool_pts.device)
    pts, target = pool_pts[idx], pool_d[idx]
    loss, grads = value_and_grads(
        lambda p: fit_loss(sdf_fn(p, pts, config.field)[0], target, config.loss), params)
    params, opt_state = plain_adam_apply(params, opt_state, grads, config.lr, ADAM_EPS)
    return params, opt_state, loss


# --- sphere-traced render ---------------------------------------------------


def _ray_box_near(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    ta = (0.0 - o) * inv
    tb = (1.0 - o) * inv
    tmin = torch.minimum(ta, tb).amax(-1)
    return torch.clamp_min(tmin, 0.0) + 1e-4


@torch.no_grad()
def render_sdf_sphere_traced(params, pose: torch.Tensor, focal: torch.Tensor,
                             config: SdfFitConfig, resolution: tuple[int, int] = (256, 256),
                             n_steps: int = 64, hit_thresh: float = 5e-4):
    """Sphere trace the learned SDF from a (3, 4) camera-to-world ``pose``
    with (2,) ``focal`` in pixels -> (normal-map rgb (H, W, 3), depth (H,
    W), hit mask (H, W)).  A fixed ``n_steps`` march from the unit cube's
    entry: a ray stops moving once |sdf| < ``hit_thresh`` or t > 3, and
    hits where the final |sdf| < 10 ``hit_thresh`` and t < 3.  Normals are
    the field's gradient from ``sdf_normal_features``' forward tangent (the
    JAX package differentiates sdf_fn per point: the same derivative)."""
    w, h = resolution
    dev = pose.device
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    xy = torch.stack([(uu - 0.5) * w / focal[0], (vv - 0.5) * h / focal[1]], dim=-1)
    dir_cam = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    dirs = (pose[None, None, :, :3] * dir_cam[..., None, :]).sum(-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    flat_d = dirs.reshape(-1, 3)
    flat_o = pose[:, 3].expand_as(flat_d)

    t = _ray_box_near(flat_o, flat_d)
    done = torch.zeros(t.shape, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        d, _ = sdf_fn(params, flat_o + t[:, None] * flat_d, config.field)
        step = torch.where(done, torch.zeros_like(d), d)
        done = done | (d.abs() < hit_thresh) | (t > 3.0)
        t = t + step
    pos = flat_o + t[:, None] * flat_d
    d_final, grad, _ = sdf_normal_features(params, pos, config.field)
    hit = (d_final.abs() < 10 * hit_thresh) & (t < 3.0)
    n = grad / torch.clamp_min(torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-9)
    rgb = torch.where(hit[:, None], 0.5 * n + 0.5, torch.zeros_like(n))
    return (rgb.reshape(h, w, 3), torch.where(hit, t, torch.zeros_like(t)).reshape(h, w),
            hit.reshape(h, w))


# --- eval (reference calculate_iou) -----------------------------------------


@torch.no_grad()
def eval_iou(params, config: SdfFitConfig, bvh, n: int = 200_000, seed: int = 0,
             chunk: int = 1 << 16) -> float:
    """Sign-agreement IoU on ``n`` uniform points of the unit cube:
    |inside both| / |inside either|, the field evaluated on the params'
    device."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    gt_in = bvh.signed_distance(pts) < 0.0
    dev = params["variance"].device
    x = torch.from_numpy(pts).to(dev)
    pred = torch.cat([sdf_fn(params, c, config.field)[0] for c in torch.split(x, chunk)])
    pred_in = pred.cpu().numpy() < 0.0
    inter = np.sum(gt_in & pred_in)
    union = np.sum(gt_in | pred_in)
    return float(inter) / max(float(union), 1.0)


# --- the whole fit ----------------------------------------------------------


def init_sdf_fit(config: SdfFitConfig, seed: int = 0, device="cuda"):
    """(params, Adam state): the field drawn from ``seed`` on the CPU, moved
    to ``device``."""
    params = init_field(torch.Generator().manual_seed(seed), config.field, resolve_device(device))
    return params, plain_adam_init(params)


def fit_mesh_sdf(mesh_path: str | Path, n_steps: int = 2000, config: SdfFitConfig | None = None,
                 seed: int = 0, log_every: int = 200, verbose: bool = True, device="cuda"):
    """Load -> normalize -> BVH -> pool -> ``n_steps`` fit steps on
    ``device`` -> (params, config, bvh, (verts, faces) normalized)."""
    dev = resolve_device(device)
    config = config or SdfFitConfig()
    verts, faces = load_mesh_obj(mesh_path)
    verts, _, _ = normalize_mesh(verts)
    bvh = TriangleBVH(verts, faces)
    pts, dist = generate_training_pool(bvh, verts, faces, config.pool_size, seed=seed,
                                       surface_offset_scale=config.surface_offset_scale)
    pool_pts, pool_d = torch.from_numpy(pts).to(dev), torch.from_numpy(dist).to(dev)
    params, opt_state = init_sdf_fit(config, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for step in range(n_steps):
        params, opt_state, loss = sdf_fit_step(params, opt_state, pool_pts, pool_d, config,
                                               generator=gen)
        if verbose and (step + 1) % log_every == 0:
            print(f"sdf-fit step {step + 1}: loss {float(loss):.3e}", flush=True)
    return params, config, bvh, (verts, faces)
