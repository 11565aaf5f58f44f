"""The static-scene NeuS2 training step and its occupancy upkeep
(port of the canonical phase of ``neus2_tpu/engine/train.py``; reference
testbed_nerf.cu:3440 train_nerf, 3723 train_nerf_step, 1475-1998 loss).

One step: draw candidate pixels -> rays -> occupancy probe -> keep the
hitting rays (``hit_oversample`` compaction) -> inverse-CDF samples ->
field -> NeuS alpha -> composite -> losses -> autograd -> Adam -> EMA.

Every random number of a step is drawn up front into a ``StepDraws`` from
the state's ``torch.Generator`` (on the step's device); callers may pass
their own draws instead, which is how the tests hold a step against the
JAX package.

Loss normalization as in the reference: rgb is the mean over rays of the
channel-mean Huber/5; eikonal is ek_weight * mean over the compacted
samples; mask is BCE on the clamped weight sum.  Candidates that the
compaction rejects are misses whose rgb/mask losses do not depend on the
field; they are counted analytically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from neus2_tpu_torch.constants import NERF_GRIDSIZE, STEPSIZE, TRAIN_TRANSMITTANCE_EPS
from neus2_tpu_torch.engine import occupancy as occ
from neus2_tpu_torch.engine.march import (
    CandidateProbe,
    cone_angle_for_scene,
    draw_from_probe,
    march_rays,
    probe_candidates,
)
from neus2_tpu_torch.engine.rays import Cameras, rays_from_pixels
from neus2_tpu_torch.models.field import FieldConfig, field_forward, init_field, sdf_fn
from neus2_tpu_torch.ops import losses as L
from neus2_tpu_torch.ops.neus_math import (
    composite_rays,
    cos_anneal_ratio,
    neus_alpha,
    sdf_to_logistic_density,
    variance_to_inv_s,
)
from neus2_tpu_torch.ops.warp import AABB, scene_aabb, warp_direction, warp_position
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.optim import OptimConfig, adam_init, adam_update, ema_update
from neus2_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The static-step fields of the JAX package's ``TrainConfig``."""

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
    random_bg: bool = True
    ema_decay: float = 0.95
    occ_n_probe: int = 1 << 17
    occ_cascades: int = 1
    cone_angle_constant: float = 1.0 / 256.0
    hit_oversample: int = 2
    # Error-map importance sampling is not ported yet.
    use_error_map: bool = False

    def __post_init__(self):
        if self.use_error_map:
            raise NotImplementedError("error-map sampling is not ported yet")

    @property
    def cone_angle(self) -> float:
        return cone_angle_for_scene(self.aabb_scale, self.cone_angle_constant)

    def aabb(self) -> AABB:
        return scene_aabb(self.aabb_scale)


class TrainState(NamedTuple):
    params: Params  # {"hashgrid": [tables], "sdf_mlp", "rgb_mlp", "variance"}
    ema_params: Params
    opt_state: dict
    occupancy: occ.OccupancyGrid
    step: int
    frame_step: int
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


class StepDraws(NamedTuple):
    """Every random number one step uses (C = n_rays * hit_oversample)."""

    img_idx: torch.Tensor  # (C,) int64
    uv0: torch.Tensor  # (C, 2)
    probe_u: torch.Tensor  # (C, n_candidates) probe jitter
    xi: torch.Tensor  # (n_rays, samples_per_ray) stratified draws
    bg: torch.Tensor  # (C, 3) random background
    drop_u: torch.Tensor  # (C,) uniforms of the black-pixel drop


def sample_step_draws(generator: torch.Generator, config: TrainConfig,
                      n_images: int) -> StepDraws:
    R, S = config.n_rays, config.samples_per_ray
    C = R * config.hit_oversample
    kw = dict(generator=generator, device=generator.device)
    img_idx = torch.randint(0, n_images, (C,), **kw)
    uv0 = torch.rand((C, 2), **kw)
    probe_u = torch.rand((C, config.n_candidates), **kw)
    xi = torch.rand((R, S), **kw)
    bg = torch.rand((C, 3), **kw) if config.random_bg else torch.zeros(
        (C, 3), device=generator.device
    )
    drop_u = torch.rand((C,), **kw)
    return StepDraws(img_idx, uv0, probe_u, xi, bg, drop_u)


def init_train_state(config: TrainConfig, n_images: int = 1, seed: int = 0,
                     device="cuda") -> TrainState:
    """Fresh state: field init drawn from a CPU generator seeded ``seed``,
    step draws from a generator on ``device`` seeded ``seed + 1``."""
    dev = resolve_device(device)
    del n_images  # no per-image parameters in the static slice
    params = init_field(torch.Generator().manual_seed(seed), config.field, dev)
    return TrainState(
        params=params,
        ema_params=tree_map(torch.clone, params),
        opt_state=adam_init(params),
        occupancy=occ.init_occupancy(config.occ_cascades, device=dev),
        step=0,
        frame_step=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
    )


def _forward_loss(params: Params, state: TrainState, images: torch.Tensor,
                  cameras: Cameras, draws: StepDraws, config: TrainConfig):
    """-> (total loss, StepAux) for the canonical phase."""
    aabb = config.aabb()
    R, S = config.n_rays, config.samples_per_ray
    C = R * config.hit_oversample
    img_idx = draws.img_idx
    origins, dirs, rgba, uv = rays_from_pixels(cameras, images, img_idx, draws.uv0)
    img_c, uv_c, rgba_c, dirs_c = img_idx, uv, rgba, dirs
    rest = rest_hit = None
    if config.hit_oversample > 1:
        probe = probe_candidates(
            origins, dirs, aabb, state.occupancy, config.n_candidates,
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
        samples = draw_from_probe(probe_sel, origins, dirs, S, draws.xi)
    else:
        samples = march_rays(
            origins, dirs, aabb, state.occupancy, config.n_candidates, S,
            draws.probe_u, draws.xi, cone_angle=config.cone_angle,
            near=config.near,
        )
    t, dt, mask = samples.t, samples.dt, samples.mask

    pos = origins[:, None, :] + t[..., None] * dirs[:, None, :]
    pos_w = warp_position(pos, aabb).reshape(R * S, 3)
    dir_w = warp_direction(dirs)[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    unlock = config.field.grid.valid_level(state.frame_step)
    out = field_forward(params, pos_w, dir_w, config.field, valid_level=unlock)
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
    texrgb_c = rgba_c[:, :3]
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
    return total, aux


def loss_and_grads(params: Params, state: TrainState, images: torch.Tensor,
                   cameras: Cameras, draws: StepDraws, config: TrainConfig):
    """-> (grads with ``params``' structure, StepAux)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten_like(params, leaves)
    total, aux = _forward_loss(live, state, images, cameras, draws, config)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return tree_unflatten_like(params, grads), aux


def train_step(state: TrainState, images: torch.Tensor, cameras: Cameras,
               config: TrainConfig, draws: StepDraws | None = None):
    """One optimization step of the canonical field -> (new state, aux)."""
    if draws is None:
        draws = sample_step_draws(state.generator, config, cameras.n_images)
    grads, aux = loss_and_grads(state.params, state, images, cameras, draws, config)
    updates, new_opt = adam_update(grads, state.opt_state, state.params, config.optim)
    new_params = tree_map(lambda p, u: p + u, state.params, updates)
    new_ema = ema_update(state.ema_params, new_params, config.ema_decay)
    return (
        state._replace(
            params=new_params,
            ema_params=new_ema,
            opt_state=new_opt,
            step=state.step + 1,
            frame_step=state.frame_step + 1,
        ),
        aux,
    )


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
    unlock = config.field.grid.valid_level(state.frame_step)
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
    """Host loop over ``train_step`` with the occupancy cadence."""
    for i in range(n_steps):
        if should_update_occupancy(state.step):
            state = occupancy_update(state, config)
        state, aux = train_step(state, images, cameras, config)
        if log_fn is not None and i % log_every == 0:
            log_fn(state.step, aux)
    return state
