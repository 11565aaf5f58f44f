"""The NeuS2 training step, its phases and its occupancy upkeep (port of
``neus2_tpu/engine/train.py``; reference testbed_nerf.cu:3440 train_nerf,
3723 train_nerf_step, 1475-1998 loss).

One step: draw candidate pixels (uniformly or from the error map) -> rays,
moved by the accumulated rigid transform -> occupancy probe -> keep the
hitting rays (``hit_oversample`` compaction) -> inverse-CDF samples -> the
per-frame delta transform on the warped samples -> field -> NeuS alpha ->
composite -> losses -> autograd -> Adam -> error-map deposit -> EMA.

The phase flags of a dynamic scene are Python booleans, and each phase is
its own autograd graph: the canonical field (``train_canonical``), the
delta transform (``train_delta``), or both; pure pose refinement builds no
table gradient at all.

The learned camera group (``TrainState.cam``): per-image extrinsic
offsets, exposure and latent codes, the shared focal scale, the envmap and
the distortion grid.  It trains with its own Adam in canonical phases
(``wants_cam_training``), and only the leaves the config puts into the loss
are differentiated: the extrinsics, focal and distortion move the rays, so
they need the encoder's position gradient; the others do not.

Every random number of a step is drawn up front into a ``StepDraws`` from
the state's ``torch.Generator`` (on the step's device); callers may pass
their own draws instead, which is how the tests hold a step against the
JAX package.

Loss normalization as in the reference: rgb is the mean over rays of the
channel-mean Huber/5; eikonal is ek_weight * mean over the compacted
samples; mask is BCE on the clamped weight sum; depth is the L2 of the ray
depth over the rays with ground truth.  Candidates that the
compaction rejects are misses whose rgb/mask losses do not depend on the
field; they are counted analytically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from neus2_tpu_torch.constants import NERF_GRIDSIZE, STEPSIZE, TRAIN_TRANSMITTANCE_EPS
from neus2_tpu_torch.engine import error_map as emap
from neus2_tpu_torch.engine import occupancy as occ
from neus2_tpu_torch.engine.march import (
    CandidateProbe,
    cone_angle_for_scene,
    draw_from_probe,
    march_rays,
    probe_candidates,
)
from neus2_tpu_torch.engine.rays import Cameras, pixel_to_ray, rays_from_pixels
from neus2_tpu_torch.models import delta as delta_mod
from neus2_tpu_torch.models.field import FieldConfig, field_forward, init_field, sdf_fn
from neus2_tpu_torch.ops import losses as L
from neus2_tpu_torch.ops.envmap import (
    apply_distortion,
    composite_envmap_background,
    init_distortion,
    init_envmap,
)
from neus2_tpu_torch.ops.neus_math import (
    composite_rays,
    cos_anneal_ratio,
    neus_alpha,
    sdf_to_logistic_density,
    clip,
    variance_to_inv_s,
)
from neus2_tpu_torch.ops.rotation import identity_6d, rotation_6d_to_matrix
from neus2_tpu_torch.ops.warp import AABB, scene_aabb, warp_direction, warp_position
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.optim import (
    OptimConfig,
    adam_init,
    adam_update,
    ema_update,
    plain_adam_init,
    plain_adam_update,
)
from neus2_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``."""

    field: FieldConfig = FieldConfig()
    optim: OptimConfig = OptimConfig()
    n_rays: int = 4096
    samples_per_ray: int = 64
    # The Testbed's adaptive (n_rays << b, samples_per_ray >> b) buckets
    # (desired_batch_bucket; reference rays/batch auto-tune,
    # testbed_nerf.cu:3434-3435).
    adaptive_batch: bool = True
    min_samples_per_ray: int = 16
    adaptive_samples_factor: float = 0.45
    n_candidates: int = 192
    aabb_scale: int = 1
    near: float = 0.0
    rgb_loss_type: str = "Huber"
    ek_loss_weight: float = 0.1
    mask_loss_weight: float = 0.0
    anneal_end: int = 0
    # Dynamic frames >= 1 unlock grid levels on (frame_step - this offset)
    # (testbed.cu:2652-2657).
    valid_level_step_offset: int = 0
    random_bg: bool = True
    ema_decay: float = 0.95
    # The delta transform's Adam (base.json "globalmove"), and the ray batch
    # of pure pose refinement (9 DoF need far fewer rays).
    delta_lr: float = 1e-4
    delta_n_rays: int = 1024
    occ_n_probe: int = 1 << 17
    occ_cascades: int = 1
    # Error-map importance sampling (reference wants_importance_sampling)
    # and its sharpness-weighted deposits (include_sharpness_in_error,
    # testbed_nerf.cu:1748-1756; needs Cameras.sharpness).
    use_error_map: bool = False
    error_map_res: int = 32
    include_sharpness_in_error: bool = False
    # The learned camera group (reference optimize_extrinsics / exposure /
    # focal_length, testbed_nerf.cu:3641-3692) and its Adam's lr.
    optimize_extrinsics: bool = False
    optimize_exposure: bool = False
    optimize_focal_length: bool = False
    cam_lr: float = 1e-4
    # Per-ray max level U[0, 1) * 2, so ~half the rays train every level
    # (reference m_max_level_rand_training, testbed_nerf.cu:1315).
    max_level_rand_training: bool = False
    # Weight of the L2 depth term (reference depth_supervision_lambda).
    depth_supervision_lambda: float = 0.0
    # The learned envmap and distortion grid and their resolutions.
    use_envmap: bool = False
    envmap_res: tuple = (16, 32)
    use_distortion: bool = False
    distortion_res: tuple = (32, 32)
    cone_angle_constant: float = 1.0 / 256.0
    hit_oversample: int = 2

    @property
    def cone_angle(self) -> float:
        return cone_angle_for_scene(self.aabb_scale, self.cone_angle_constant)

    def aabb(self) -> AABB:
        return scene_aabb(self.aabb_scale)


class TrainState(NamedTuple):
    params: Params  # {"hashgrid": [tables], "sdf_mlp", "rgb_mlp", "variance"}
    ema_params: Params
    opt_state: dict
    delta: Params  # the per-frame rigid transform {"rotation6d", "transition"}
    delta_opt_state: dict  # its plain Adam
    acc: Params  # the accumulated transform {"rotation" (3, 3), "transition"}
    # The camera group {"rot6d" (N, 6), "trans" (N, 3), "exposure" (N, 3),
    # "focal_ln" (2,)}, with "envmap", "distortion" and "latent" when on.
    cam: Params
    cam_opt_state: dict  # its plain Adam, one count for the group
    occupancy: occ.OccupancyGrid
    error_map: emap.ErrorMapState
    step: int
    frame_step: int  # steps within the current time frame
    generator: torch.Generator  # on the state's device


class StepAux(NamedTuple):
    loss: torch.Tensor
    rgb_loss: torch.Tensor
    ek_loss: torch.Tensor
    mask_loss: torch.Tensor
    n_valid_samples: torch.Tensor
    psnr_proxy: torch.Tensor
    mean_occ_len: torch.Tensor
    # All candidates minus the over-budget hits the batch excluded.
    n_rays_counted: torch.Tensor


class StepExtras(NamedTuple):
    """What the error-map deposit takes from the loss: every candidate's
    image, uv and detached loss, and the updated sharpness grid."""

    img_idx: torch.Tensor  # (C,)
    uv: torch.Tensor  # (C, 2)
    ray_loss: torch.Tensor  # (C,)
    sharpness_grid: torch.Tensor | None = None


class StepDraws(NamedTuple):
    """Every random number one step uses (C = n_rays * hit_oversample).
    Pixels come from ``img_idx`` / ``uv0``, or with the error map on from
    its CDF at ``em_u`` jittered by ``em_jitter``; the other pair is None."""

    img_idx: torch.Tensor | None  # (C,) int64
    uv0: torch.Tensor | None  # (C, 2)
    probe_u: torch.Tensor  # (C, n_candidates) probe jitter
    xi: torch.Tensor  # (n_rays, samples_per_ray) stratified draws
    bg: torch.Tensor  # (C, 3) random background
    drop_u: torch.Tensor  # (C,) uniforms of the black-pixel drop
    em_u: torch.Tensor | None = None  # (C,) error-map CDF uniforms
    em_jitter: torch.Tensor | None = None  # (C, 2) in-cell jitter
    # (n_rays,) uniforms of the per-ray max level, with
    # max_level_rand_training on (drawn last, so every other stream stays
    # as it is without it).
    max_level_u: torch.Tensor | None = None

    def to(self, device) -> StepDraws:
        return StepDraws(*(None if d is None else d.to(device) for d in self))


def sample_step_draws(generator: torch.Generator, config: TrainConfig,
                      n_images: int) -> StepDraws:
    R, S = config.n_rays, config.samples_per_ray
    C = R * config.hit_oversample
    kw = dict(generator=generator, device=generator.device)
    img_idx = uv0 = em_u = em_jitter = None
    if config.use_error_map:
        em_u = torch.rand((C,), **kw)
        em_jitter = torch.rand((C, 2), **kw)
    else:
        img_idx = torch.randint(0, n_images, (C,), **kw)
        uv0 = torch.rand((C, 2), **kw)
    probe_u = torch.rand((C, config.n_candidates), **kw)
    xi = torch.rand((R, S), **kw)
    bg = torch.rand((C, 3), **kw) if config.random_bg else torch.zeros(
        (C, 3), device=generator.device
    )
    drop_u = torch.rand((C,), **kw)
    max_level_u = torch.rand((R,), **kw) if config.max_level_rand_training else None
    return StepDraws(img_idx, uv0, probe_u, xi, bg, drop_u, em_u, em_jitter, max_level_u)


def init_train_state(config: TrainConfig, n_images: int = 1, seed: int = 0,
                     device="cuda") -> TrainState:
    """Fresh state: field init drawn from a CPU generator seeded ``seed``,
    step draws from a generator on ``device`` seeded ``seed + 1``."""
    dev = resolve_device(device)
    params = init_field(torch.Generator().manual_seed(seed), config.field, dev)
    delta = delta_mod.init_delta(dev)
    cam = init_cam_params(n_images, config, dev)
    return TrainState(
        params=params,
        ema_params=tree_map(torch.clone, params),
        opt_state=adam_init(params),
        delta=delta,
        delta_opt_state=plain_adam_init(delta),
        acc=delta_mod.init_accumulated(dev),
        cam=cam,
        cam_opt_state=plain_adam_init(cam),
        occupancy=occ.init_occupancy(config.occ_cascades, device=dev),
        error_map=init_error_map_for(config, n_images, dev),
        step=0,
        frame_step=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
    )


def init_cam_params(n_images: int, config: TrainConfig | None = None,
                    device="cpu") -> Params:
    """The camera group at the identity: no extrinsic offset, exposure 0,
    focal scale 1 (one correction shared by every image, as the reference's
    m_focal_length_gradient, testbed_nerf.cu:3679-3692); the envmap
    (``ops/envmap.py``: its own seeded draw, not the JAX package's), the
    zero distortion grid and zero latent codes when the config has them."""
    n = max(n_images, 1)
    f32 = dict(dtype=torch.float32, device=device)
    cam = {
        "rot6d": identity_6d(device)[None].repeat(n, 1),
        "trans": torch.zeros((n, 3), **f32),
        "exposure": torch.zeros((n, 3), **f32),
        "focal_ln": torch.zeros((2,), **f32),
    }
    if config is not None and config.use_envmap:
        cam["envmap"] = init_envmap(config.envmap_res, device)
    if config is not None and config.use_distortion:
        cam["distortion"] = init_distortion(config.distortion_res, device)
    if config is not None and config.field.latent_dim > 0:
        cam["latent"] = torch.zeros((n, config.field.latent_dim), **f32)
    return cam


def wants_cam_training(config: TrainConfig) -> bool:
    """Whether any leaf of the camera group is in the loss."""
    return bool(cam_leaves_in_loss(config))


def cam_leaves_in_loss(config: TrainConfig) -> tuple[str, ...]:
    """The camera leaves the config puts into the loss: the only ones the
    step differentiates.  The JAX package differentiates the whole group;
    the others' gradients are zero there, and are given as zeros here."""
    keys = []
    if config.optimize_extrinsics:
        keys += ["rot6d", "trans"]
    if config.optimize_exposure:
        keys.append("exposure")
    if config.optimize_focal_length:
        keys.append("focal_ln")
    if config.use_envmap:
        keys.append("envmap")
    if config.use_distortion:
        keys.append("distortion")
    if config.field.latent_dim > 0:
        keys.append("latent")
    return tuple(keys)


def adjusted_cameras(cam: Params, cameras: Cameras, config: TrainConfig) -> Cameras:
    """The cameras with the learned corrections: per-image extrinsic
    offsets (R_cam R, t + t_cam) and the shared focal scale."""
    if config.optimize_extrinsics:
        rot = rotation_6d_to_matrix(cam["rot6d"])  # (N, 3, 3)
        r = rot @ cameras.poses[..., :3]
        t = cameras.poses[..., 3] + cam["trans"]
        cameras = cameras._replace(poses=torch.cat([r, t[..., None]], -1))
    if config.optimize_focal_length:
        cameras = cameras._replace(focal=cameras.focal * torch.exp(cam["focal_ln"])[None, :])
    return cameras


def init_error_map_for(config: TrainConfig, n_images: int, device) -> emap.ErrorMapState:
    """A fresh error map at ``config.error_map_res``, with a sharpness grid
    over the occupancy cells when the sharpness weighting is on."""
    cells = config.occ_cascades * NERF_GRIDSIZE**3 if config.include_sharpness_in_error else 0
    return emap.init_error_map(max(n_images, 1), config.error_map_res, sharpness_cells=cells,
                               device=device)


def _forward_loss(params: Params, delta: Params, cam: Params, state: TrainState,
                  images: torch.Tensor, cameras: Cameras, draws: StepDraws,
                  config: TrainConfig, use_delta: bool, depths: torch.Tensor | None = None):
    """-> (total loss, StepAux, StepExtras or None without the error map).

    Gradients reach the cameras through the rays: the probe and the sample
    draw see detached rays, so sample distances are data, and positions
    are o + t d with t constant."""
    aabb = config.aabb()
    R, S = config.n_rays, config.samples_per_ray
    C = R * config.hit_oversample
    if config.use_error_map:
        img_idx, uv0 = emap.sample_pixels(state.error_map, draws.em_u, draws.em_jitter,
                                          cameras.n_images)
    else:
        img_idx, uv0 = draws.img_idx, draws.uv0
    cams_adj = adjusted_cameras(cam, cameras, config)
    origins, dirs, rgba, uv = rays_from_pixels(cams_adj, images, img_idx, uv0)
    if config.use_distortion:
        # The learned distortion moves ray generation, not the texel fetch.
        origins, dirs = pixel_to_ray(cams_adj, img_idx, apply_distortion(cam["distortion"], uv))
    origins, dirs = delta_mod.apply_accumulated_to_rays(state.acc, origins, dirs)
    img_c, uv_c, rgba_c, dirs_c = img_idx, uv, rgba, dirs
    rest = rest_hit = None
    if config.hit_oversample > 1:
        probe = probe_candidates(
            origins.detach(), dirs.detach(), aabb, state.occupancy, config.n_candidates,
            draws.probe_u, cone_angle=config.cone_angle, near=config.near,
        )
        # Hitting candidates first, stable, so the first R hits are an
        # unbiased subset; the tail is the rejected candidates.
        order = torch.argsort((~probe.hit).to(torch.uint8), stable=True)
        sel, rest = order[:R], order[R:]
        probe_sel = CandidateProbe(*(x[sel] for x in probe))
        rest_hit = probe.hit[rest]
        origins, dirs, rgba, uv, img_idx = (
            origins[sel], dirs[sel], rgba[sel], uv[sel], img_idx[sel]
        )
        samples = draw_from_probe(probe_sel, origins.detach(), dirs.detach(), S, draws.xi)
    else:
        samples = march_rays(
            origins.detach(), dirs.detach(), aabb, state.occupancy, config.n_candidates, S,
            draws.probe_u, draws.xi, cone_angle=config.cone_angle,
            near=config.near,
        )
    t, dt, mask = samples.t, samples.dt, samples.mask

    pos = origins[:, None, :] + t[..., None] * dirs[:, None, :]
    pos_w = warp_position(pos, aabb).reshape(R * S, 3)
    dir_w = warp_direction(dirs)[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    if use_delta:  # the per-frame transform on the warped samples (transform_network.h:49)
        pos_w, dir_w = delta_mod.apply_delta(delta, pos_w, dir_w)
    unlock = config.field.grid.valid_level(state.frame_step - config.valid_level_step_offset)
    latent = max_level = None
    if config.field.latent_dim > 0:
        ld = config.field.latent_dim
        latent = cam["latent"][img_idx][:, None, :].expand(R, S, ld).reshape(R * S, ld)
    if config.max_level_rand_training:
        # U[0, 1) * 2 a ray, the same for its samples (testbed_nerf.cu:1315).
        max_level = (draws.max_level_u * 2.0)[:, None].expand(R, S).reshape(R * S)
    out = field_forward(params, pos_w, dir_w, config.field, valid_level=unlock,
                        max_level=max_level, latent=latent)
    rgb_s = out.rgb.reshape(R, S, 3)
    sdf_s = out.sdf.reshape(R, S)
    normal_s = out.normal.reshape(R, S, 3)

    anneal = cos_anneal_ratio(state.step, config.anneal_end)
    # dt in the warp metric: the SDF lives in warped coordinates.
    dt_w = dt / float(config.aabb_scale)
    alpha = neus_alpha(sdf_s, normal_s, dirs[:, None, :], dt_w, out.inv_s, anneal)
    comp = composite_rays(rgb_s, alpha, t, mask, TRAIN_TRANSMITTANCE_EPS)

    # Per-candidate, field-independent quantities (testbed_nerf.cu:1310-1312,
    # 1669-1677): background, sRGB target, the 10% drop of black pixels,
    # mask ground truth.
    bg_c = draws.bg
    if config.use_envmap:
        # The learned envmap behind the background, composited in linear
        # space (testbed_nerf.cu:1646-1655), then back to sRGB.
        bg_lin = composite_envmap_background(cam["envmap"], dirs_c, L.srgb_to_linear(bg_c))
        bg_c = L.linear_to_srgb(clip(bg_lin, 0.0, 1.0))
    texrgb_c = rgba_c[:, :3]
    if config.optimize_exposure:
        # On the premultiplied linear texels, before the unpremultiply.
        texrgb_c = texrgb_c * torch.exp2(cam["exposure"][img_c])
    a_c = rgba_c[:, 3:4]
    safe_a = torch.where(a_c > 0, a_c, torch.ones_like(a_c))
    target_c = torch.where(
        a_c > 0, L.linear_to_srgb(texrgb_c / safe_a) * a_c + (1.0 - a_c) * bg_c, bg_c
    )
    drop_c = (rgba_c[:, 0] <= 0.0) & (draws.drop_u >= 0.9)
    ray_w_c = torch.where(drop_c, 0.0, 1.0)
    mask_gt_c = (rgba_c[:, 3] > 0.9999).to(torch.float32)

    if rest is None:
        bg, target, ray_w, mask_gt = bg_c, target_c, ray_w_c, mask_gt_c
        n_rest_live = rest_rgb_sum = rest_mask_sum = rest_mse_sum = 0.0
    else:
        bg, target, ray_w, mask_gt = (x[sel] for x in (bg_c, target_c, ray_w_c, mask_gt_c))
        # Rejected candidates are misses (prediction == background) unless
        # more than R hit; over-budget hits get weight 0.
        w_rest = ray_w_c[rest] * (1.0 - rest_hit.to(torch.float32))
        target_rest, bg_rest = target_c[rest], bg_c[rest]
        rgb_l_rest = L.rgb_loss(target_rest, bg_rest, config.rgb_loss_type).mean(-1)
        mask_l_rest = L.mask_bce_loss(torch.zeros_like(w_rest), mask_gt_c[rest])
        n_rest_live = w_rest.sum()
        rest_rgb_sum = (rgb_l_rest * w_rest).sum()
        rest_mask_sum = (mask_l_rest * w_rest).sum()
        rest_mse_sum = (((bg_rest - target_rest) ** 2).mean(-1) * w_rest).sum()

    pred = comp.rgb + comp.trans[:, None] * bg
    n_live = torch.clamp_min(ray_w.sum() + n_rest_live, 1.0)
    rgb_l = L.rgb_loss(target, pred, config.rgb_loss_type).mean(-1)
    rgb_loss = ((rgb_l * ray_w).sum() + rest_rgb_sum) / n_live

    eff = comp.sample_mask & (ray_w[:, None] > 0)
    norm = torch.sqrt((normal_s * normal_s).sum(-1) + 1e-6)
    ek_res = torch.where(eff, (norm - 1.0) ** 2, torch.zeros_like(norm))
    n_samp = torch.clamp_min(eff.sum().to(torch.float32), 1.0)
    ek_loss = ek_res.sum() / n_samp

    mask_l = L.mask_bce_loss(comp.weight_sum, mask_gt)
    mask_loss = ((mask_l * ray_w).sum() + rest_mask_sum) / n_live

    total = (
        rgb_loss
        + config.ek_loss_weight * ek_loss
        + config.mask_loss_weight * mask_loss
    )
    if depths is not None and config.depth_supervision_lambda > 0.0:
        # L2 on the ray depth where ground truth exists, over those rays
        # (reference depth supervision, testbed_nerf.cu:1903-1906).
        wh = cameras.size_of(img_idx)
        px = torch.minimum((uv[:, 0] * wh[:, 0]).to(torch.int64), wh[:, 0].to(torch.int64) - 1)
        py = torch.minimum((uv[:, 1] * wh[:, 1]).to(torch.int64), wh[:, 1].to(torch.int64) - 1)
        depth_gt = depths[img_idx, py, px]
        has_d = (depth_gt > 0.0).to(torch.float32) * ray_w
        depth_loss = (has_d * (comp.depth - depth_gt) ** 2).sum() / torch.clamp_min(has_d.sum(), 1.0)
        total = total + config.depth_supervision_lambda * depth_loss
    with torch.no_grad():
        mse = (((pred - target) ** 2).mean(-1) * ray_w).sum() + rest_mse_sum
        mse = mse / n_live
        hit_ray = mask.any(-1)
        total_len = dt.sum(-1) * hit_ray
        n_counted = (
            t.new_full((), float(R))
            if rest is None
            else float(C) - rest_hit.to(torch.float32).sum()
        )
        aux = StepAux(
            loss=total.detach(),
            rgb_loss=rgb_loss.detach(),
            ek_loss=ek_loss.detach(),
            mask_loss=mask_loss.detach(),
            n_valid_samples=mask.sum().to(torch.int32),
            psnr_proxy=-10.0 * torch.log10(torch.clamp_min(mse, 1e-12)),
            mean_occ_len=total_len.sum()
            / torch.clamp_min(hit_ray.to(torch.float32).sum(), 1.0),
            n_rays_counted=n_counted,
        )
        extras = None
        if config.use_error_map:
            extras = _deposit_extras(state, cameras, config, img_idx, uv, origins, dirs,
                                     comp.depth, hit_ray, ray_w, rgb_l * ray_w)
            if rest is not None:
                # Every candidate deposits; rejected ones carry their miss
                # loss, over-budget hits weight 0.
                extras = extras._replace(
                    img_idx=torch.cat([extras.img_idx, img_c[rest]]),
                    uv=torch.cat([extras.uv, uv_c[rest]]),
                    ray_loss=torch.cat([extras.ray_loss, rgb_l_rest * w_rest]),
                )
    return total, aux, extras


def _deposit_extras(state: TrainState, cameras: Cameras, config: TrainConfig,
                    img_idx, uv, origins, dirs, depth, hit_ray, ray_w,
                    dep_loss) -> StepExtras:
    """The selected rays' deposit, weighted by sharpness when that is on
    (testbed_nerf.cu:1748-1756): how sharp the ray's image is at its pixel
    against the sharpest observation of its hit cell."""
    grid = state.error_map.sharpness_grid
    if not (config.include_sharpness_in_error and cameras.sharpness is not None
            and grid is not None):
        return StepExtras(img_idx, uv, dep_loss)
    aabb = config.aabb()
    sm = cameras.sharpness  # (N_img, sh, sw)
    sh, sw = sm.shape[1], sm.shape[2]
    sx = torch.clamp((uv[:, 0] * sw).to(torch.int64), 0, sw - 1)
    sy = torch.clamp((uv[:, 1] * sh).to(torch.int64), 0, sh - 1)
    sharp = sm[img_idx, sy, sx] + 1e-6
    hitpoint = origins + depth[:, None] * dirs
    lo, hi = aabb._lo_hi(hitpoint)
    in_box = ((hitpoint >= lo) & (hitpoint <= hi)).all(-1)
    valid = hit_ray & in_box & (ray_w > 0)
    mip = occ.mip_from_pos(hitpoint, config.occ_cascades - 1)
    scale = torch.exp2(-mip.to(torch.float32))[:, None]
    cxyz = torch.clamp((((hitpoint - 0.5) * scale + 0.5) * NERF_GRIDSIZE).to(torch.int64),
                       0, NERF_GRIDSIZE - 1)
    g = NERF_GRIDSIZE
    cell = mip * g**3 + cxyz[:, 0] + cxyz[:, 1] * g + cxyz[:, 2] * g * g
    w_sharp, new_grid = emap.sharpness_weight_and_update(grid, cell, sharp, valid)
    return StepExtras(img_idx, uv, dep_loss * w_sharp, new_grid)


def loss_and_grads(diff: dict, state: TrainState, images: torch.Tensor, cameras: Cameras,
                   draws: StepDraws, config: TrainConfig, use_delta: bool = False,
                   depths: torch.Tensor | None = None):
    """Gradients for the param groups in ``diff`` ({"params": ...,
    "delta": ..., "cam": ...}; "cam" may hold a subset of the group's
    leaves); a group or leaf left out is read from ``state`` as a constant,
    so autograd spends no backward work on it -> (grads with ``diff``'s
    structure, StepAux, StepExtras or None without the error map)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), diff)
    total, aux, extras = _forward_loss(
        live.get("params", state.params), live.get("delta", state.delta),
        {**state.cam, **live.get("cam", {})}, state, images, cameras, draws, config,
        use_delta, depths,
    )
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return tree_unflatten_like(live, grads), aux, extras


def phase_config(config: TrainConfig, train_canonical: bool = True,
                 train_delta: bool = False) -> TrainConfig:
    """The config a step of this phase runs: error-map sampling is off
    during pure pose refinement, where rays concentrated on a few
    high-error cells make the delta's gradient ill-conditioned."""
    if config.use_error_map and train_delta and not train_canonical:
        return dataclasses.replace(config, use_error_map=False)
    return config


def train_step(state: TrainState, images: torch.Tensor, cameras: Cameras,
               config: TrainConfig, draws: StepDraws | None = None,
               train_canonical: bool = True, train_delta: bool = False,
               use_delta: bool = False, depths: torch.Tensor | None = None):
    """One optimization step -> (new state, aux).

    The phases (testbed.cu:2659-2667): a static scene or frame 0 trains
    the canonical field only; pose refinement ``train_delta`` only; the
    finetune phase both.  The camera group trains with the canonical field
    only: it and the delta are gauge-ambiguous.  The step runs
    ``phase_config``; ``draws`` given by the caller must be drawn for it.
    ``depths`` (N, H, W), 0 where there is no ground truth, feed the depth
    term.  The EMA copy moves every step, as in the reference, even when
    the canonical field does not train."""
    config = phase_config(config, train_canonical, train_delta)
    if draws is None:
        draws = sample_step_draws(state.generator, config, cameras.n_images)
    cam_keys = cam_leaves_in_loss(config) if train_canonical else ()
    diff = {}
    if train_canonical:
        diff["params"] = state.params
    if train_delta:
        diff["delta"] = state.delta
    if cam_keys:
        diff["cam"] = {k: state.cam[k] for k in cam_keys}
    if not diff:
        diff["params"] = state.params  # neither trains: the loss alone, no update
    grads, aux, extras = loss_and_grads(diff, state, images, cameras, draws, config,
                                        use_delta or train_delta, depths)
    new_params, new_opt = state.params, state.opt_state
    if train_canonical:
        updates, new_opt = adam_update(grads["params"], state.opt_state, state.params,
                                       config.optim)
        new_params = tree_map(lambda p, u: p + u, state.params, updates)
    new_delta, new_delta_opt = state.delta, state.delta_opt_state
    if train_delta:
        updates, new_delta_opt = plain_adam_update(grads["delta"], state.delta_opt_state,
                                                   config.delta_lr)
        new_delta = tree_map(lambda p, u: p + u, state.delta, updates)
    new_cam, new_cam_opt = state.cam, state.cam_opt_state
    if cam_keys:
        # The whole group steps with one count; the leaves out of the loss
        # take zero gradients, as they get in the JAX package.
        cam_grads = {k: grads["cam"][k] if k in grads["cam"] else torch.zeros_like(v)
                     for k, v in state.cam.items()}
        updates, new_cam_opt = plain_adam_update(cam_grads, state.cam_opt_state,
                                                 config.cam_lr, eps=1e-8)
        new_cam = tree_map(lambda p, u: p + u, state.cam, updates)
    new_emap = state.error_map
    if config.use_error_map:
        new_emap = emap.deposit(state.error_map, extras.img_idx, extras.uv, extras.ray_loss)
        if extras.sharpness_grid is not None:
            new_emap = new_emap._replace(sharpness_grid=extras.sharpness_grid)
    new_ema = ema_update(state.ema_params, new_params, config.ema_decay)
    return (
        state._replace(
            params=new_params,
            ema_params=new_ema,
            opt_state=new_opt,
            delta=new_delta,
            delta_opt_state=new_delta_opt,
            cam=new_cam,
            cam_opt_state=new_cam_opt,
            error_map=new_emap,
            step=state.step + 1,
            frame_step=state.frame_step + 1,
        ),
        aux,
    )


def rebuild_error_cdf(state: TrainState) -> TrainState:
    return state._replace(error_map=emap.rebuild_cdf(state.error_map))


@torch.no_grad()
def occupancy_update(state: TrainState, config: TrainConfig,
                     jitter: torch.Tensor | None = None) -> TrainState:
    """Probe the next sweep slice -> logistic density -> EMA-max -> bits.

    The decay is calibrated to the sweep period: one full sweep may forget
    at most half of a cell's stored density."""
    if jitter is None:
        g = state.generator
        jitter = torch.rand((config.occ_n_probe, 3), generator=g, device=g.device)
    flat_idx, _, pos = occ.probe_cells(state.occupancy, config.occ_n_probe, jitter)
    n_cells = config.occ_cascades * NERF_GRIDSIZE**3
    sweep = max(1, -(-n_cells // config.occ_n_probe))
    decay = 0.5 ** (1.0 / sweep)
    pos_w = warp_position(pos, config.aabb())
    unlock = config.field.grid.valid_level(state.frame_step - config.valid_level_step_offset)
    sdf, _ = sdf_fn(state.params, pos_w, config.field, valid_level=unlock)
    density = sdf_to_logistic_density(sdf, variance_to_inv_s(state.params["variance"]))
    grid = occ.merge_probes(state.occupancy, flat_idx, density, decay=decay)
    return state._replace(occupancy=occ.update_bitfield(grid))


def occupancy_prior_sweep(state: TrainState, config: TrainConfig,
                          max_updates: int = 256) -> TrainState:
    """Whole-grid probe sweep before the first step (the reference probes
    all cells for its first 256 steps, testbed_nerf.cu:4010-4012); a
    budget that cannot finish the sweep in ``max_updates`` gets 16."""
    n_cells = config.occ_cascades * NERF_GRIDSIZE**3
    sweeps_needed = -(-n_cells // config.occ_n_probe)
    sweeps = sweeps_needed if sweeps_needed <= max_updates else 16
    for _ in range(sweeps):
        state = occupancy_update(state, config)
    return state


def desired_batch_bucket(occ_len_ema: float, config: TrainConfig) -> int:
    """Adaptive-batch bucket: bucket b trades samples for rays at a constant
    sample budget, (n_rays << b) x (samples_per_ray >> b), once the occupied
    chord is short enough to keep ``adaptive_samples_factor`` of the
    reference's marching density (occ_len / STEPSIZE samples a ray)."""
    s_needed = config.adaptive_samples_factor * occ_len_ema / STEPSIZE
    s0 = config.samples_per_ray
    b = 0
    while (
        b < 3
        and (s0 >> (b + 1)) >= config.min_samples_per_ray
        and (s0 >> (b + 1)) >= s_needed
    ):
        b += 1
    return b


def should_update_occupancy(step: int, interval: int = 4) -> bool:
    """Every step for the first 256, then every ``interval``."""
    return step < 256 or step % interval == 0


def train_static(state: TrainState, images: torch.Tensor, cameras: Cameras,
                 config: TrainConfig, n_steps: int, log_every: int = 16,
                 log_fn: Callable[[int, StepAux], None] | None = None) -> TrainState:
    """Host loop over ``train_step`` with the occupancy and error-map
    rebuild cadences."""
    for i in range(n_steps):
        if should_update_occupancy(state.step):
            state = occupancy_update(state, config)
        if config.use_error_map and emap.should_rebuild(state.step):
            state = rebuild_error_cdf(state)
        state, aux = train_step(state, images, cameras, config)
        if log_fn is not None and i % log_every == 0:
            log_fn(state.step, aux)
    return state
