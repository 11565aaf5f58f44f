"""The benchmark's captures, made on the device from ``--seed``: posed RGBA
views of an analytic scene, sphere-traced in torch.

The scene is the repo's DTU stand-in (``neus2_tpu_torch/data/synthetic.py``:
``csg_sdf``, ``_csg_albedo``, ``csg_poses``), copied here so that the
yardstick does not move with the program: a rounded box minus a corner
sphere, a torus and a thin plate, with a banded and checkered albedo,
seen from a golden-angle spiral of cameras whose aim the seed jitters by
1e-3.  The views are traced in float64 as the numpy original traces them,
on the device, a few views at a time.  Both sides of the comparison get
the same ``Capture``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

CENTER = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class Capture:
    images: torch.Tensor  # (N, H, W, 4) premultiplied linear RGBA
    poses: torch.Tensor  # (N, 3, 4) camera-to-world, +z forward
    focal: torch.Tensor  # (N, 2) pixels
    principal: torch.Tensor  # (N, 2) relative to the image size
    wh: tuple[int, int]
    aabb_scale: int


def _length(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant (as the original states it) in ``like``'s dtype."""
    return torch.tensor(values, dtype=torch.float32, device=like.device).to(like.dtype)


def csg_sdf(x: torch.Tensor) -> torch.Tensor:
    """Rounded box minus a corner sphere, plus a torus and a thin plate."""
    p = x - _vec(CENTER, x)
    q = torch.abs(p) - 0.21
    box = _length(torch.clamp_min(q, 0.0)) + torch.clamp_max(q.amax(-1), 0.0) - 0.02
    carve = 0.20 - _length(p - 0.17)
    pz = p - _vec((0.0, 0.0, 0.30), x)
    ring = torch.stack([_length(pz[..., :2]) - 0.16, pz[..., 2]], -1)
    torus = _length(ring) - 0.045
    pp = p - _vec((-0.30, 0.0, 0.0), x)
    qp = torch.abs(pp) - _vec((0.12, 0.16, 0.015), x)
    plate = _length(torch.clamp_min(qp, 0.0)) + torch.clamp_max(qp.amax(-1), 0.0)
    return torch.minimum(torch.minimum(torch.maximum(box, carve), torus), plate)


def csg_albedo(p: torch.Tensor) -> torch.Tensor:
    """Bands and a checker in linear RGB."""
    s = torch.sin(40.0 * p[..., 0]) * torch.sin(37.0 * p[..., 1])
    c = torch.remainder(torch.floor(p[..., 0] * 24) + torch.floor(p[..., 2] * 24), 2.0)
    r = 0.25 + 0.5 * (0.5 + 0.5 * s)
    g = 0.25 + 0.5 * c
    b = 0.3 + 0.4 * (0.5 + 0.5 * torch.sin(29.0 * p[..., 2]))
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 1.0)


def csg_poses(n_views: int, cam_distance: float, seed: int) -> np.ndarray:
    """(N, 3, 4) float32 poses on a golden-angle spiral around the centre,
    each aimed at the centre jittered by one normal(0, 1e-3) draw of a
    single ``default_rng(seed)`` stream, in view order."""
    rng = np.random.default_rng(seed)
    center = np.array(CENTER, np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    poses = []
    for k in range(n_views):
        phi = 2.0 * np.pi * ((k * 0.618034) % 1.0)
        cos_t = np.clip((1.0 - 2.0 * (k + 0.5) / n_views) * 0.9, -0.85, 0.85)
        sin_t = np.sqrt(1.0 - cos_t * cos_t)
        eye = center + cam_distance * np.array(
            [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], np.float32)
        fwd = center + rng.normal(0, 1e-3, 3).astype(np.float32) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses.append(np.stack([right, down, fwd, eye], axis=1).astype(np.float32))
    return np.stack(poses)


@torch.no_grad()
def trace_views(poses: torch.Tensor, w: int, h: int, focal: float, shift=(0.0, 0.0, 0.0),
                max_rays: int = 1 << 23) -> torch.Tensor:
    """Sphere-trace each pose through the scene moved by ``shift`` -> (N,
    H, W, 4) float32 premultiplied linear RGBA: 192 steps from t = 0.3 at
    most, a ray stops once a step is under 1e-4 or t reaches 3;
    central-difference normals (eps 1e-4), shading 0.3 + 0.7 max(0, n . l)."""
    dev = poses.device
    shift = torch.tensor(shift, dtype=torch.float64, device=dev)
    p64 = poses.double()
    u = (torch.arange(w, device=dev, dtype=torch.float64) + 0.5) / w
    v = (torch.arange(h, device=dev, dtype=torch.float64) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dir_cam = torch.stack([(uu - 0.5) * w / focal, (vv - 0.5) * h / focal,
                           torch.ones_like(uu)], -1).reshape(-1, 3)
    light = torch.tensor((0.4, 0.5, 0.77), dtype=torch.float32, device=dev)
    light = light / _length(light)
    eps = torch.eye(3, dtype=torch.float64, device=dev) * 1e-4
    per = max(1, max_rays // (w * h))
    out = []
    for lo in range(0, poses.shape[0], per):
        pose = p64[lo:lo + per]
        dirs = torch.einsum("vij,pj->vpi", pose[:, :, :3], dir_cam)
        dirs = (dirs / _length(dirs)[..., None]).reshape(-1, 3)
        o = pose[:, None, :, 3].expand(-1, w * h, 3).reshape(-1, 3)
        t = torch.full((o.shape[0],), 0.3, dtype=torch.float64, device=dev)
        live = torch.arange(o.shape[0], device=dev)
        for _ in range(192):
            tl = t[live]
            step = csg_sdf(o[live] + tl[:, None] * dirs[live] - shift)
            tl = tl + step
            t[live] = tl
            live = live[(step > 1e-4) & (tl < 3.0)]
            if live.numel() == 0:
                break
        still = torch.zeros_like(t, dtype=torch.bool)
        still[live] = True
        hit = (t < 3.0) & ~still
        pos = o + t[:, None] * dirs - shift
        n = torch.stack([csg_sdf(pos + eps[i]) - csg_sdf(pos - eps[i]) for i in range(3)], -1)
        n = n / torch.clamp_min(_length(n), 1e-9)[:, None]
        lam = torch.clamp((n * light).sum(-1, keepdim=True), 0.0, 1.0)
        rgb = torch.clamp(csg_albedo(pos) * (0.3 + 0.7 * lam), 0.0, 1.0)
        a = hit.to(torch.float64)[:, None]
        out.append(torch.cat([rgb * a, a], -1).float().reshape(-1, h, w, 4))
    return torch.cat(out)


def make_capture(spec: dict, seed: int, device, frame: int = 0) -> Capture:
    """The capture ``spec`` (a captures/*.json) describes, from ``seed``:
    time frame ``frame`` of it, in which the scene has moved by ``frame``
    times the spec's ``motion_per_frame`` (none when it has none) and the
    cameras have not."""
    if spec["scene"] != "csg":
        raise ValueError(f"unknown scene {spec['scene']!r}")
    w, h, n = int(spec["width"]), int(spec["height"]), int(spec["n_views"])
    focal = 0.5 * h / math.tan(0.5 * math.radians(float(spec["fov_y_deg"])))
    poses = torch.as_tensor(csg_poses(n, float(spec["cam_distance"]), seed), device=device)
    shift = [frame * float(m) for m in spec.get("motion_per_frame", (0.0, 0.0, 0.0))]
    return Capture(
        images=trace_views(poses, w, h, focal, shift),
        poses=poses,
        focal=torch.full((n, 2), focal, dtype=torch.float32, device=device),
        principal=torch.full((n, 2), 0.5, dtype=torch.float32, device=device),
        wh=(w, h),
        aabb_scale=int(spec["aabb_scale"]),
    )
