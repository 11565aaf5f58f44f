"""Synthetic multi-view sphere scenes (numpy; port of
``neus2_tpu/data/synthetic.py::make_sphere_dataset``,
``make_multi_sphere_dataset`` and ``make_moving_sphere_frames``).

Images are rendered analytically through the training camera model, so
training against them exercises the whole ray -> march -> field ->
composite -> loss path with a known ground-truth SDF.
"""

from __future__ import annotations

import numpy as np

from neus2_tpu_torch.data.dataset import NerfDataset

SPHERE_CENTER = np.array([0.5, 0.5, 0.5], np.float32)
SPHERE_RADIUS = 0.25


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world (3, 4) with +z forward."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def ray_sphere(o, d, center, radius):
    """(hit mask, t of the first intersection) for unit directions."""
    oc = o - center
    b = np.sum(oc * d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return hit & (t > 0), t


def shade_sphere(normal: np.ndarray) -> np.ndarray:
    """View-independent Lambertian-ish shading in linear RGB."""
    light = np.array([0.4, 0.5, 0.77], np.float32)
    light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(normal * light, axis=-1, keepdims=True), 0.0, 1.0)
    base = 0.5 + 0.5 * normal
    return np.clip(base * (0.25 + 0.75 * lam), 0.0, 1.0)


def make_sphere_dataset(n_views: int = 16, resolution: int = 64,
                        cam_distance: float = 1.2, fov_deg: float = 45.0,
                        seed: int = 0, center=None) -> NerfDataset:
    """Cameras on a sphere looking at the scene center, one shaded sphere."""
    obj_center = SPHERE_CENTER if center is None else np.asarray(center, np.float32)
    return make_multi_sphere_dataset(
        [(obj_center, SPHERE_RADIUS)], n_views=n_views, resolution=resolution,
        cam_distance=cam_distance, fov_deg=fov_deg, seed=seed, aabb_scale=1,
    )


def make_multi_sphere_dataset(spheres, n_views: int = 16, resolution: int = 64,
                              cam_distance: float = 1.2, fov_deg: float = 45.0,
                              seed: int = 0, aabb_scale: int = 1) -> NerfDataset:
    """N shaded spheres with nearest-hit compositing."""
    rng = np.random.default_rng(seed)
    w = h = resolution
    focal = 0.5 * w / np.tan(0.5 * np.deg2rad(fov_deg))
    centers = np.stack([np.asarray(c, np.float32) for c, _ in spheres])
    radii = np.array([r for _, r in spheres], np.float32)
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    uu, vv = np.meshgrid(u, v)
    xy = np.stack([(uu - 0.5) * w / focal, (vv - 0.5) * h / focal], axis=-1)
    dir_cam = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)

    poses, images = [], []
    for k in range(n_views):
        phi = 2.0 * np.pi * ((k * 0.618034) % 1.0)
        cos_t = np.clip((1.0 - 2.0 * (k + 0.5) / n_views) * 0.8, -0.75, 0.75)
        sin_t = np.sqrt(1.0 - cos_t * cos_t)
        eye = SPHERE_CENTER + cam_distance * np.array(
            [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], np.float32
        )
        pose = _look_at(
            eye, SPHERE_CENTER + rng.normal(0, 1e-3, 3).astype(np.float32),
            np.array([0.0, 0.0, 1.0], np.float32),
        )
        poses.append(pose)
        dirs = dir_cam @ pose[:, :3].T
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        o = np.broadcast_to(pose[:, 3], dirs.shape)
        best_t = np.full(dirs.shape[:-1], np.inf, np.float32)
        best_n = np.zeros_like(dirs)
        any_hit = np.zeros(dirs.shape[:-1], bool)
        for c, r in zip(centers, radii):
            hit, t = ray_sphere(o, dirs, c, r)
            closer = hit & (t < best_t)
            best_t = np.where(closer, t, best_t)
            n_s = (o + t[..., None] * dirs - c) / r
            best_n = np.where(closer[..., None], n_s, best_n)
            any_hit |= hit
        alpha = any_hit.astype(np.float32)[..., None]
        images.append(
            np.concatenate([shade_sphere(best_n) * alpha, alpha], -1).astype(np.float32)
        )
    n = n_views
    return NerfDataset(
        images=np.stack(images),
        poses=np.stack(poses),
        focal=np.full((n, 2), focal, np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        scale=1.0,
        offset=(0.5, 0.5, 0.5),
        aabb_scale=aabb_scale,
        from_na=True,
    )


def make_moving_sphere_frames(n_frames: int = 3, translation_per_frame=(0.02, 0.0, 0.0),
                              n_views: int = 12, resolution: int = 48) -> list[NerfDataset]:
    """A dynamic scene, one dataset a frame: frame k is frame 0's sphere
    moved by k * ``translation_per_frame`` (cameras drawn with seed k), so
    the delta a frame should learn is the inverse of that translation."""
    t = np.asarray(translation_per_frame, np.float32)
    return [make_sphere_dataset(n_views=n_views, resolution=resolution, seed=k,
                                center=SPHERE_CENTER + k * t) for k in range(n_frames)]
