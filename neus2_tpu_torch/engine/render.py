"""Inference rendering: occupancy-compacted marching, chunked over rays
(port of the static path of ``neus2_tpu/engine/render.py``; reference
src/testbed_nerf.cu:2397-2595 NerfTracer, 936-1045 composite_kernel_nerf).

Every ray gets a fixed sample budget from the occupancy-guided inverse CDF
and one batched field evaluation; the composite is the training path's
SDF -> alpha math.  Rays whose chord crosses no occupied cell are found
first (``probe_hit_rays``, one host sync) and skipped: they composite to
exactly nothing.  Jittered multi-spp passes draw their stratified offsets
from a ``torch.Generator`` the caller passes; the candidate probes stay at
the deterministic midpoints, so one probe serves every pass.

``acc``, the accumulated rigid transform of a dynamic scene ({"rotation",
"transition"}, or None for the identity), moves the rays before marching,
as in training (testbed_nerf.cu:1380-1387).  ``render_image`` takes the
learned extras: the envmap behind every ray, the distortion grid on ray
generation, and the render buffer's exposure and tonemap curve.
"""

from __future__ import annotations

import dataclasses

import torch

from neus2_tpu_torch.engine.march import march_probe, march_rays
from neus2_tpu_torch.engine.rays import Cameras, pixel_to_ray
from neus2_tpu_torch.models.delta import apply_accumulated_to_rays
from neus2_tpu_torch.models.field import FieldConfig, field_forward
from neus2_tpu_torch.ops.envmap import apply_distortion, composite_envmap_background
from neus2_tpu_torch.ops.losses import linear_to_srgb
from neus2_tpu_torch.ops.neus_math import clip, composite_rays, neus_alpha
from neus2_tpu_torch.ops.tonemap import apply_output_tonemap
from neus2_tpu_torch.ops.warp import scene_aabb, warp_direction, warp_position


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    field: FieldConfig = FieldConfig()
    samples_per_ray: int = 128
    n_candidates: int = 384
    aabb_scale: int = 1
    near: float = 0.0
    cone_angle: float = 0.0
    min_transmittance: float = 1e-4  # eval protocol (reference run.py:271)
    chunk: int = 1 << 12
    spp: int = 1


def _render_chunk(params, acc, occupancy, origins: torch.Tensor, dirs: torch.Tensor,
                  generator: torch.Generator | None, config: RenderConfig, jitter: bool):
    """rays -> samples -> field -> composite for one chunk ->
    (rgb, depth, opacity, normal, cost = valid samples per ray)."""
    origins, dirs = apply_accumulated_to_rays(acc, origins, dirs)
    aabb = scene_aabb(config.aabb_scale)
    R, S = origins.shape[0], config.samples_per_ray
    xi = None
    if jitter:
        xi = torch.rand((R, S), generator=generator, device=generator.device).to(origins.device)
    samples = march_rays(origins, dirs, aabb, occupancy, config.n_candidates, S,
                         None, xi, cone_angle=config.cone_angle, near=config.near)
    pos = origins[:, None, :] + samples.t[..., None] * dirs[:, None, :]
    pos_w = warp_position(pos, aabb).reshape(R * S, 3)
    dir_w = warp_direction(dirs)[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    out = field_forward(params, pos_w, dir_w, config.field)
    rgb_s = out.rgb.reshape(R, S, 3)
    normal_s = out.normal.reshape(R, S, 3)
    # dt in the warp metric, as in training.
    alpha = neus_alpha(out.sdf.reshape(R, S), normal_s, dirs[:, None, :],
                       samples.dt / float(config.aabb_scale), out.inv_s, 1.0)
    comp = composite_rays(rgb_s, alpha, samples.t, samples.mask, config.min_transmittance)
    n_acc = (comp.weights[..., None] * normal_s).sum(-2)
    n_acc = n_acc / torch.clamp_min(torch.linalg.norm(n_acc, dim=-1, keepdim=True), 1e-8)
    return comp.rgb, comp.depth, comp.weight_sum, n_acc, samples.n_valid.to(torch.float32)


@torch.no_grad()
def render_rays(params, acc, occupancy, origins: torch.Tensor, dirs: torch.Tensor,
                generator: torch.Generator | None, config: RenderConfig,
                jitter: bool = False, compact: bool = False):
    """Chunked render -> (rgb (N, 3) sRGB before the background, depth (N,),
    opacity (N,), normal (N, 3), cost (N,)).

    ``compact``: probe the occupancy march first and evaluate the field only
    for rays that cross occupied space (misses are exact zeros either way).
    ``render_image`` compacts by itself, sharing one probe across passes."""
    n = origins.shape[0]
    if compact and occupancy is not None:
        hit_idx = probe_hit_rays(acc, occupancy, origins, dirs, config)
        empty = (origins.new_zeros((n, 3)), origins.new_zeros((n,)), origins.new_zeros((n,)),
                 origins.new_zeros((n, 3)), origins.new_zeros((n,)))
        if hit_idx.numel() == 0:
            return empty
        sub = render_rays(params, acc, occupancy, origins[hit_idx], dirs[hit_idx],
                          generator, config, jitter=jitter)
        return tuple(e.index_copy(0, hit_idx, s) for e, s in zip(empty, sub))
    outs = [
        _render_chunk(params, acc, occupancy, o, d, generator, config, jitter)
        for o, d in zip(torch.split(origins, config.chunk), torch.split(dirs, config.chunk))
    ]
    return tuple(torch.cat(parts) for parts in zip(*outs))


@torch.no_grad()
def probe_hit_rays(acc, occupancy, origins: torch.Tensor, dirs: torch.Tensor,
                   config: RenderConfig) -> torch.Tensor:
    """Indices of the rays whose chord crosses occupied space (int64, on the
    rays' device): one chunked march-only probe and one host sync."""
    aabb = scene_aabb(config.aabb_scale)
    origins, dirs = apply_accumulated_to_rays(acc, origins, dirs)
    totals = torch.cat([
        march_probe(o, d, aabb, occupancy, config.n_candidates,
                    cone_angle=config.cone_angle, near=config.near)
        for o, d in zip(torch.split(origins, config.chunk), torch.split(dirs, config.chunk))
    ])
    return torch.nonzero(totals > 0.0).squeeze(1)


@torch.no_grad()
def render_image(params, acc, occupancy, cameras: Cameras, pose: torch.Tensor,
                 focal: torch.Tensor, principal: torch.Tensor,
                 generator: torch.Generator | None, config: RenderConfig,
                 background=0.0, spp: int | None = None, mode: str = "shade",
                 resolution: tuple[int, int] | None = None, envmap=None,
                 distortion=None, exposure: float = 0.0, tonemap: str = "identity"):
    """Render a full image -> ((H, W, 3) image, (H, W) depth, (H, W) alpha).

    ``mode``: "shade" (sRGB colour over ``background``), "depth", "normals"
    (0.5 (n + 1) times opacity) or "cost" (samples per ray over the budget),
    the reference's ERenderMode menu.  ``spp`` > 1 averages jittered passes,
    drawn from ``generator``.  Eval protocol (reference scripts/run.py:
    264-271): black background, spp 8, min transmittance 1e-4; the network's
    colour is already sRGB.

    ``cameras`` gives the resolution (unless ``resolution`` is) and its
    Brown-Conrady lens.  ``envmap``: a learned (H, W, 4) map composited
    behind every ray over the flat background in linear space, as in
    training (reference init_rays_from_camera, testbed_nerf.cu:2298-2299).
    ``distortion``: a
    learned (H, W, 2) uv offset grid on ray generation (2208-2331).
    ``exposure`` / ``tonemap``: the render buffer's output controls
    (render_buffer.cu:313-332), on the shaded frame."""
    if mode not in ("shade", "normals", "depth", "cost"):
        raise ValueError(f"unknown render mode {mode!r}")
    dev = pose.device
    w, h = resolution or cameras.resolution
    # The dataset's lens: a render casts the rays training cast (reference
    # init_rays_from_camera, testbed_nerf.cu:2208-2331).  Ray files and
    # rolling shutter are per-training-image data; FTheta is left out as
    # the JAX package leaves it out.
    one_cam = Cameras(poses=pose[None], focal=torch.as_tensor(focal, device=dev)[None],
                      principal=torch.as_tensor(principal, device=dev)[None],
                      resolution=(w, h), distortion=cameras.distortion)
    u = (torch.arange(w, device=dev) + 0.5) / w
    v = (torch.arange(h, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
    if distortion is not None:
        uv = apply_distortion(distortion, uv)
    origins, dirs = pixel_to_ray(one_cam, torch.zeros(uv.shape[0], dtype=torch.int64,
                                                      device=dev), uv)

    spp = spp or config.spp
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev).expand(3)
    if envmap is not None:
        bg_srgb = linear_to_srgb(clip(composite_envmap_background(envmap, dirs, bg[None, :]),
                                      0.0, 1.0))
    else:
        bg_srgb = linear_to_srgb(bg).expand(w * h, 3)

    n = w * h
    if occupancy is not None:
        hit_idx = probe_hit_rays(acc, occupancy, origins, dirs, config)
        o_h, d_h, bg_h = origins[hit_idx], dirs[hit_idx], bg_srgb[hit_idx]
    else:
        hit_idx = None
        o_h, d_h, bg_h = origins, dirs, bg_srgb
    m = o_h.shape[0]

    rgb_acc = origins.new_zeros((m, 3))
    depth_acc = origins.new_zeros((m,))
    op_acc = origins.new_zeros((m,))
    for _ in range(spp if m else 0):
        rgb, depth, opacity, normal, cost = render_rays(
            params, acc, occupancy, o_h, d_h, generator, config, jitter=spp > 1
        )
        if mode == "shade":
            rgb_acc += rgb + (1.0 - opacity)[:, None] * bg_h
        elif mode == "normals":
            rgb_acc += 0.5 * (normal + 1.0) * opacity[:, None]
        elif mode == "depth":
            rgb_acc += depth[:, None].expand(m, 3)
        else:
            rgb_acc += cost[:, None].expand(m, 3) / config.samples_per_ray
        depth_acc += depth
        op_acc += opacity
    if hit_idx is not None:
        # Misses composite to zero plus the background.
        miss = bg_srgb * float(spp) if mode == "shade" else origins.new_zeros((n, 3))
        rgb_acc = miss.index_copy_(0, hit_idx, rgb_acc)
        depth_acc = origins.new_zeros((n,)).index_copy_(0, hit_idx, depth_acc)
        op_acc = origins.new_zeros((n,)).index_copy_(0, hit_idx, op_acc)
    rgb_img = (rgb_acc / spp).reshape(h, w, 3)
    if mode == "shade":
        rgb_img = torch.clamp(apply_output_tonemap(rgb_img, exposure, tonemap), 0.0, 1.0)
    return rgb_img, (depth_acc / spp).reshape(h, w), (op_acc / spp).reshape(h, w)
