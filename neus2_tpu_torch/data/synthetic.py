"""Synthetic multi-view scenes (numpy; port of
``neus2_tpu/data/synthetic.py``): the analytic spheres
(``make_sphere_dataset``, ``make_multi_sphere_dataset``,
``make_moving_sphere_frames``) and the analytic SDF scenes of the quality
sweeps (``sphere_sdf``, ``csg_sdf``, ``dumbbell_sdf``, ``bowl_sdf``, their
albedos, ``SCENES`` and ``make_csg_dataset``, copied so that their outputs
are bitwise the JAX package's).

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


def sphere_sdf(x: np.ndarray) -> np.ndarray:
    """Ground-truth SDF of the synthetic scene (for mesh/eval tests)."""
    return np.linalg.norm(x - SPHERE_CENTER, axis=-1) - SPHERE_RADIUS


# ---------------------------------------------------------------------------
# CSG validation scene: non-convex, textured, thin features — a scene the
# sphere-prior geometric init cannot trivially solve (round-2 validation
# target; the reference's equivalent protocol is DTU evaluation,
# scripts/run.py:264-344, no DTU data exists in this environment).
# ---------------------------------------------------------------------------


def csg_sdf(x: np.ndarray) -> np.ndarray:
    """Analytic SDF: rounded box minus a corner sphere, plus a torus and a
    thin plate.  Exact enough for sphere tracing and Chamfer/SDF eval
    (CSG min/max bounds the true distance)."""
    p = x - SPHERE_CENTER

    # Rounded box, half extents 0.21.
    q = np.abs(p) - 0.21
    box = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(
        np.max(q, axis=-1), 0.0
    ) - 0.02

    # Subtracted sphere at the (+,+,+) corner -> concavity.
    carve = 0.20 - np.linalg.norm(p - 0.17, axis=-1)

    # Torus around the z axis above the box (ring: thin curved feature).
    pz = p - np.array([0.0, 0.0, 0.30], np.float32)
    ring = np.stack(
        [np.linalg.norm(pz[..., :2], axis=-1) - 0.16, pz[..., 2]], axis=-1
    )
    torus = np.linalg.norm(ring, axis=-1) - 0.045

    # Thin plate sticking out in -x (thickness 0.03).
    pp = p - np.array([-0.30, 0.0, 0.0], np.float32)
    qp = np.abs(pp) - np.array([0.12, 0.16, 0.015], np.float32)
    plate = np.linalg.norm(np.maximum(qp, 0.0), axis=-1) + np.minimum(
        np.max(qp, axis=-1), 0.0
    )

    return np.minimum(np.minimum(np.maximum(box, carve), torus), plate)


def _csg_albedo(p: np.ndarray) -> np.ndarray:
    """Procedural high-frequency texture (bands + checker) in linear RGB."""
    s = np.sin(40.0 * p[..., 0]) * np.sin(37.0 * p[..., 1])
    c = (np.floor(p[..., 0] * 24) + np.floor(p[..., 2] * 24)) % 2.0
    r = 0.25 + 0.5 * (0.5 + 0.5 * s)
    g = 0.25 + 0.5 * c
    b = 0.3 + 0.4 * (0.5 + 0.5 * np.sin(29.0 * p[..., 2]))
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def csg_poses(n_views: int, cam_distance: float = 1.35, seed: int = 0) -> list[np.ndarray]:
    """The CSG protocol's camera-to-world poses, in view order: a
    golden-angle spiral, each camera looking at the centre jittered by one
    draw of a single ``default_rng(seed)`` stream, so view k's pose
    depends on every view before it."""
    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_views):
        phi = 2.0 * np.pi * ((k * 0.618034) % 1.0)
        cos_t = 1.0 - 2.0 * (k + 0.5) / n_views
        cos_t = np.clip(cos_t * 0.9, -0.85, 0.85)
        sin_t = np.sqrt(1.0 - cos_t * cos_t)
        eye = SPHERE_CENTER + cam_distance * np.array(
            [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], np.float32
        )
        poses.append(_look_at(
            eye,
            SPHERE_CENTER + rng.normal(0, 1e-3, 3).astype(np.float32),
            np.array([0.0, 0.0, 1.0], np.float32),
        ))
    return poses


def csg_focal(resolution: int, fov_deg: float = 50.0) -> float:
    return 0.5 * resolution / np.tan(0.5 * np.deg2rad(fov_deg))


def render_csg_view(pose: np.ndarray, resolution: int, fov_deg: float = 50.0,
                    sdf=None, albedo=None) -> np.ndarray:
    """One sphere-traced (H, W, 4) premultiplied-linear RGBA view of an
    analytic scene (default: the CSG scene) through ``pose``.  A view
    depends on its pose alone, so views may be rendered in any order or
    process."""
    sdf = sdf or csg_sdf
    albedo = albedo or _csg_albedo
    w = h = resolution
    focal = csg_focal(resolution, fov_deg)
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    uu, vv = np.meshgrid(u, v)
    xy = np.stack([(uu - 0.5) * w / focal, (vv - 0.5) * h / focal], axis=-1)
    dir_cam = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)
    dirs = dir_cam @ pose[:, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.broadcast_to(pose[:, 3], dirs.shape).copy()

    # Vectorized sphere tracing over the rays still marching: each ray
    # takes the same elementwise steps as it would in the whole image, so
    # the result is the same bit for bit, in a fraction of the time.
    t = np.full(dirs.shape[:-1], 0.3, np.float32)
    t_flat, o_flat, d_flat = t.reshape(-1), o.reshape(-1, 3), dirs.reshape(-1, 3)
    live = np.arange(t_flat.shape[0])
    for _ in range(192):
        t_live = t_flat[live]
        d = sdf(o_flat[live] + t_live[:, None] * d_flat[live]).astype(np.float32)
        t_live = t_live + d
        t_flat[live] = t_live
        live = live[(d > 1e-4) & (t_live < 3.0)]
        if live.size == 0:
            break
    alive = np.zeros(t_flat.shape[0], bool)
    alive[live] = True
    hit = (t < 3.0) & ~alive.reshape(t.shape)
    pos = o + t[..., None] * dirs
    eps = 1e-4
    n_fd = np.stack(
        [
            sdf(pos + np.array([eps, 0, 0])) - sdf(pos - np.array([eps, 0, 0])),
            sdf(pos + np.array([0, eps, 0])) - sdf(pos - np.array([0, eps, 0])),
            sdf(pos + np.array([0, 0, eps])) - sdf(pos - np.array([0, 0, eps])),
        ],
        axis=-1,
    )
    n_fd = n_fd / np.maximum(np.linalg.norm(n_fd, axis=-1, keepdims=True), 1e-9)
    light = np.array([0.4, 0.5, 0.77], np.float32)
    light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(n_fd * light, axis=-1, keepdims=True), 0.0, 1.0)
    rgb = np.clip(albedo(pos) * (0.3 + 0.7 * lam), 0.0, 1.0)
    alpha = hit.astype(np.float32)[..., None]
    return np.concatenate([rgb * alpha, alpha], axis=-1).astype(np.float32)


def csg_dataset(poses, images, resolution: int, fov_deg: float = 50.0) -> NerfDataset:
    """The dataset of rendered views (unit scene box, identity transform)."""
    n = len(poses)
    return NerfDataset(
        images=np.stack(images),
        poses=np.stack(poses),
        focal=np.full((n, 2), csg_focal(resolution, fov_deg), np.float32),
        principal=np.full((n, 2), 0.5, np.float32),
        scale=1.0,
        offset=(0.5, 0.5, 0.5),
        aabb_scale=1,
        from_na=True,
        paths=(),
    )


def make_csg_dataset(
    n_views: int = 24,
    resolution: int = 128,
    cam_distance: float = 1.35,
    fov_deg: float = 50.0,
    seed: int = 0,
    sdf=None,
    albedo=None,
) -> NerfDataset:
    """Sphere-traced renders of an analytic scene through the training camera
    model (held-out protocol: reserve trailing views for eval).

    ``sdf``/``albedo``: scene functions over (..., 3) points (defaults: the
    CSG scene).  See ``SCENES`` for the multi-scene sweep registry — the
    stand-in for the reference's multi-scan DTU Chamfer sweep (BASELINE
    tracked config 3)."""
    poses = csg_poses(n_views, cam_distance, seed)
    images = [render_csg_view(p, resolution, fov_deg, sdf, albedo) for p in poses]
    return csg_dataset(poses, images, resolution, fov_deg)


# ---------------------------------------------------------------------------
# Multi-scene sweep scenes (BASELINE tracked config 3 analog: the reference
# protocol evaluates Chamfer across several DTU scans; with no DTU data in
# this environment the sweep runs over analytic scenes with distinct
# topology/pathologies instead).
# ---------------------------------------------------------------------------


def dumbbell_sdf(x: np.ndarray) -> np.ndarray:
    """Two unequal spheres joined by a thin oblique capsule, plus a small
    torus handle: disconnected-looking blobs + a thin neck (the classic
    failure mode for a single-sphere geometric prior)."""
    p = x - SPHERE_CENTER

    a = np.array([-0.22, -0.05, -0.08], np.float32)  # big sphere center
    b = np.array([0.24, 0.08, 0.10], np.float32)  # small sphere center
    s1 = np.linalg.norm(p - a, axis=-1) - 0.17
    s2 = np.linalg.norm(p - b, axis=-1) - 0.12

    # Capsule from a to b, radius 0.035 (the thin neck).
    ab = b - a
    t = np.clip(
        np.sum((p - a) * ab, axis=-1) / float(np.dot(ab, ab)), 0.0, 1.0
    )
    neck = np.linalg.norm(p - (a + t[..., None] * ab), axis=-1) - 0.035

    # Torus handle on the big sphere (xz plane), thin curved feature.
    pt = p - (a + np.array([0.0, 0.0, 0.20], np.float32))
    ring = np.stack(
        [np.linalg.norm(pt[..., [0, 2]], axis=-1) - 0.10, pt[..., 1]], axis=-1
    )
    handle = np.linalg.norm(ring, axis=-1) - 0.025

    return np.minimum(np.minimum(np.minimum(s1, s2), neck), handle)


def _dumbbell_albedo(p: np.ndarray) -> np.ndarray:
    s = 0.5 + 0.5 * np.sin(55.0 * p[..., 0] + 31.0 * p[..., 1])
    c = (np.floor(p[..., 1] * 30) + np.floor(p[..., 2] * 18)) % 2.0
    r = 0.2 + 0.6 * s
    g = 0.3 + 0.4 * (0.5 + 0.5 * np.sin(47.0 * p[..., 2]))
    b = 0.25 + 0.5 * c
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def bowl_sdf(x: np.ndarray) -> np.ndarray:
    """An open hollow bowl (interior surfaces seen at grazing angles through
    the opening) on a box pedestal: strong concavity + a thin shell."""
    p = x - SPHERE_CENTER

    # Hollow sphere shell (outer 0.26, thickness 0.035), opened above z=0.08.
    r = np.linalg.norm(p, axis=-1)
    shell = np.maximum(r - 0.26, -(r - 0.225))
    bowl = np.maximum(shell, p[..., 2] - 0.08)

    # Pedestal: squat rounded box under the bowl.
    q = np.abs(p - np.array([0.0, 0.0, -0.30], np.float32)) - np.array(
        [0.14, 0.14, 0.05], np.float32
    )
    ped = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(
        np.max(q, axis=-1), 0.0
    ) - 0.01

    # A small solid sphere resting inside the bowl (eval must reconstruct
    # geometry visible only through the opening).
    ball = np.linalg.norm(
        p - np.array([0.05, -0.03, -0.16], np.float32), axis=-1
    ) - 0.055

    return np.minimum(np.minimum(bowl, ped), ball)


def _bowl_albedo(p: np.ndarray) -> np.ndarray:
    s = 0.5 + 0.5 * np.sin(36.0 * p[..., 0]) * np.sin(42.0 * p[..., 2])
    c = (np.floor((p[..., 0] + p[..., 1]) * 20) + np.floor(p[..., 2] * 26)) % 2.0
    r = 0.3 + 0.45 * c
    g = 0.2 + 0.6 * s
    b = 0.35 + 0.35 * (0.5 + 0.5 * np.sin(33.0 * p[..., 1]))
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


#: scene name -> (sdf, albedo): the multi-scene sweep registry.
SCENES = {
    "csg": (csg_sdf, _csg_albedo),
    "dumbbell": (dumbbell_sdf, _dumbbell_albedo),
    "bowl": (bowl_sdf, _bowl_albedo),
}
