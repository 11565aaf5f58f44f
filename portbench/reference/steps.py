"""NeuS2's training step and renderer in plain PyTorch, over the field of
``nets.py``: the occupancy grid and its sweep, pixel rays, the occupancy
probe and the inverse-CDF sample draw, NeuS alpha, compositing, the loss,
tcnn's Adam and the EMA copy.

Sources: NeuS2's ``testbed_nerf.cu`` (train_nerf_step, the loss kernels,
the density-grid update), the tcnn Adam (``adam.h``: L2 on matrices, no
update where a non-matrix gradient is exactly zero, per-element step
counts) and NeuS (Wang et al., 2021) for alpha.  Every random number a
step uses comes from one generator on the device seeded ``seed + 1``,
drawn in the order the program's loop draws them, so both sides take the
same rays and probes from the same seed.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.nets import RefConfig, field, init_params, sdf_out

GRID = 128
STEPSIZE = math.sqrt(3.0) / 1024
MIN_OPTICAL_THICKNESS = 0.1
_PROBE_PRIME = 2654435761
_U32 = 0xFFFFFFFF


# --- occupancy ----------------------------------------------------------------


class Occupancy:
    """One 128^3 cascade over the unit cube: an EMA-max density and its bits."""

    def __init__(self, device):
        self.density = torch.zeros(GRID**3, dtype=torch.float32, device=device)
        self.bits = torch.zeros(GRID**3, dtype=torch.bool, device=device)
        self.updates = 0

    @torch.no_grad()
    def update(self, params: dict, cfg: RefConfig, jitter: torch.Tensor, valid_level: int):
        """Probe the next ``occ_n_probe`` cells of a fixed permutation at
        ``jitter`` inside each, keep max(old * decay, density), threshold
        at min(mean density, 0.1)."""
        n = cfg.occ_n_probe
        i = (torch.arange(n, dtype=torch.int64, device=jitter.device)
             + ((self.updates * n) & _U32)) & _U32
        cell = ((i * _PROBE_PRIME) & _U32) % GRID**3
        xyz = torch.stack([cell % GRID, (cell // GRID) % GRID, cell // (GRID * GRID)],
                          -1).to(torch.float32)
        pos = ((xyz + jitter) / GRID - 0.5) * 1.0 + 0.5
        sdf = sdf_out(params, pos, cfg, valid_level)[:, 0] + cfg.sdf_bias
        inv_s = torch.exp(10.0 * params["variance"])
        sig = torch.sigmoid(sdf * inv_s)
        density = inv_s * sig * (1.0 - sig)
        probe = torch.zeros_like(self.density).scatter_reduce_(0, cell, density, reduce="amax",
                                                               include_self=True)
        sweep = -(-GRID**3 // n)
        decay = 0.5 ** (1.0 / sweep)
        self.density = torch.where(self.density < 0.0, self.density,
                                   torch.maximum(self.density * decay, probe))
        self.updates += 1
        thresh = torch.clamp_max(torch.clamp_min(self.density, 0.0).mean(), MIN_OPTICAL_THICKNESS)
        self.bits = self.density > thresh

    def at(self, pos: torch.Tensor) -> torch.Tensor:
        cell = torch.floor(pos * GRID).to(torch.int64)
        inside = ((cell >= 0) & (cell < GRID)).all(-1)
        cell = torch.clamp(cell, 0, GRID - 1)
        return self.bits[(cell[..., 2] * GRID + cell[..., 1]) * GRID + cell[..., 0]] & inside


# --- rays and the march ---------------------------------------------------------


def pixel_rays(poses, focal, principal, wh: tuple[int, int], img_idx, uv):
    """(origins, unit directions) of pinhole pixels at ``uv`` in [0, 1]^2."""
    w, h = wh
    size = torch.tensor((float(w), float(h)), device=uv.device)
    pose = poses[img_idx]
    xy = (uv - principal[img_idx]) * size / focal[img_idx]
    x, y = xy[..., 0], xy[..., 1]
    rot = pose[..., :3]
    d = [rot[..., i, 0] * x + rot[..., i, 1] * y + rot[..., i, 2] for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return pose[..., 3], torch.stack([c / norm for c in d], -1)


def probe(o, d, occ: Occupancy, n_cand: int, u):
    """The chord through the unit cube in ``n_cand`` equal intervals, each
    probed at t0 + u * dt (u None: the midpoints) -> (t0, occupied
    lengths, total, hit)."""
    inv = 1.0 / d
    t0 = (0.0 - o) * inv
    t1 = (1.0 - o) * inv
    tmin = torch.clamp_min(torch.minimum(t0, t1).amax(-1), 0.0)
    tmax = torch.maximum(t0, t1).amin(-1)
    enters = tmin < tmax
    steps = torch.arange(n_cand, dtype=torch.float32, device=o.device)[None]
    dt = torch.clamp_min(torch.clamp_min(tmax - tmin, 0.0) / n_cand, STEPSIZE)[:, None]
    start = tmin[:, None] + steps * dt
    dt = dt.expand_as(start)
    mid = start + (0.5 if u is None else u) * dt
    valid = (mid < tmax[:, None]) & enters[:, None]
    valid &= occ.at(o[:, None, :] + mid[..., None] * d[:, None, :])
    seg = torch.where(valid, dt, torch.zeros_like(dt))
    total = seg.sum(-1)
    return start, seg, total, (total > 0.0) & enters


def draw(start, seg, total, hit, budget: int, xi):
    """``budget`` stratified samples from the occupied length's inverse
    CDF (xi None: the strata's centres) -> (t, dt, mask)."""
    cum = torch.cumsum(seg, -1)
    if xi is None:
        xi = torch.full((seg.shape[0], budget), 0.5, device=seg.device)
    strata = torch.arange(budget, dtype=torch.float32, device=seg.device)[None]
    u = torch.minimum((strata + xi) / budget * total[:, None], total[:, None] * (1.0 - 1e-7))
    idx = torch.clamp_max(torch.searchsorted(cum.contiguous(), u.contiguous(), right=True),
                          seg.shape[1] - 1)
    seg_at = torch.gather(seg, 1, idx)
    t = torch.gather(start, 1, idx) + torch.minimum(
        torch.clamp_min(u - (torch.gather(cum, 1, idx) - seg_at), 0.0), seg_at)
    dt = torch.clamp_min(total[:, None] / budget, 1e-10).expand_as(t)
    return t, dt, hit[:, None].expand_as(t)


def neus_alpha(sdf, normal, d, dt, inv_s):
    """NeuS's discrete opacity from the SDF at either end of a sample's
    interval (cos annealing finished: ratio 1)."""
    cos = (d * normal).sum(-1)
    iter_cos = -torch.relu(-cos)
    nxt = torch.sigmoid((sdf + iter_cos * dt * 0.5) * inv_s)
    prev = torch.sigmoid((sdf - iter_cos * dt * 0.5) * inv_s)
    return torch.clamp((prev - nxt + 1e-5) / (prev + 1e-5), 0.0, 1.0)


def composite(rgb, alpha, mask, eps: float):
    """Front to back, samples past transmittance ``eps`` dropped ->
    (rgb, weight sum, transmittance left, weights, live mask)."""
    alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], -1), -1)
    live = trans >= eps
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    w = alpha * trans
    left = torch.where(live, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)
    return (w[..., None] * rgb).sum(-2), w.sum(-1), left, w, mask & live


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.clamp_min(c, 0.0031308), 1.0 / 2.4) - 0.055)


def huber5(target, pred):
    """Huber with delta 0.1, divided by 5 (testbed_nerf.cu)."""
    d = torch.abs(pred - target)
    return torch.where(d > 0.1, 0.1 * (d - 0.05), 0.5 * d * d) / 5.0


# --- the training step ------------------------------------------------------------


def draws(gen: torch.Generator, cfg: RefConfig, n_images: int, n_rays: int, spr: int) -> dict:
    """One step's random numbers, in the order the loop draws them."""
    c = n_rays * cfg.hit_oversample
    kw = dict(generator=gen, device=gen.device)
    return {"img": torch.randint(0, n_images, (c,), **kw), "uv": torch.rand((c, 2), **kw),
            "probe": torch.rand((c, cfg.n_candidates), **kw), "xi": torch.rand((n_rays, spr), **kw),
            "bg": torch.rand((c, 3), **kw), "drop": torch.rand((c,), **kw)}


def loss(params: dict, cap, occ: Occupancy, dr: dict, cfg: RefConfig, n_rays: int, spr: int,
         valid_level: int, batch_share: float = 1.0) -> torch.Tensor:
    """The step's loss: Huber/5 colour over the candidates (misses against
    their background), plus ek_weight x the eikonal mean over the kept
    samples.  Of the candidates, the first ``n_rays`` whose probe hits go
    through the field.  ``batch_share`` < 1 keeps that share of the
    candidates and of the kept rays: a fault, for the readings."""
    w, h = cap.wh
    size = torch.tensor((float(w), float(h)), device=dr["uv"].device)
    px = torch.minimum((dr["uv"] * size).to(torch.int64), size.to(torch.int64) - 1)
    uv = (px + 0.5) / size
    img = dr["img"]
    rgba = cap.images[img, px[:, 1], px[:, 0]].to(torch.float32)
    o, d = pixel_rays(cap.poses, cap.focal, cap.principal, cap.wh, img, uv)
    start, seg, total, hit = probe(o, d, occ, cfg.n_candidates, dr["probe"])
    order = torch.argsort((~hit).to(torch.uint8), stable=True)
    sel, rest = order[:n_rays], order[n_rays:]
    t, dt, mask = draw(start[sel], seg[sel], total[sel], hit[sel], spr, dr["xi"])
    o_s, d_s = o[sel], d[sel]
    pos = (o_s[:, None, :] + t[..., None] * d_s[:, None, :]).reshape(-1, 3)
    d_w = ((d_s + 1.0) * 0.5)[:, None, :].expand(n_rays, spr, 3).reshape(-1, 3)
    rgb, sdf, normal, inv_s = field(params, pos, d_w, cfg, valid_level, create_graph=True)
    normal = normal.reshape(n_rays, spr, 3)
    alpha = neus_alpha(sdf.reshape(n_rays, spr), normal, d_s[:, None, :], dt, inv_s)
    c_rgb, _, left, _, eff = composite(rgb.reshape(n_rays, spr, 3), alpha, mask,
                                       cfg.train_transmittance_eps)

    a = rgba[:, 3:4]
    target = torch.where(a > 0, linear_to_srgb(rgba[:, :3] / torch.where(a > 0, a, torch.ones_like(a)))
                         * a + (1.0 - a) * dr["bg"], dr["bg"])
    ray_w = torch.where((rgba[:, 0] <= 0.0) & (dr["drop"] >= 0.9), 0.0, 1.0)
    if batch_share < 1.0:
        ray_w = ray_w * (torch.arange(ray_w.shape[0], device=ray_w.device)
                         < batch_share * ray_w.shape[0])
    w_rest = ray_w[rest] * (1.0 - hit[rest].to(torch.float32))
    rest_sum = (huber5(target[rest], dr["bg"][rest]).mean(-1) * w_rest).sum()
    ray_sel = ray_w[sel]
    pred = c_rgb + left[:, None] * dr["bg"][sel]
    n_live = torch.clamp_min(ray_sel.sum() + w_rest.sum(), 1.0)
    rgb_loss = ((huber5(target[sel], pred).mean(-1) * ray_sel).sum() + rest_sum) / n_live
    eff = eff & (ray_sel[:, None] > 0)
    norm = torch.sqrt((normal * normal).sum(-1) + 1e-6)
    ek = torch.where(eff, (norm - 1.0) ** 2, torch.zeros_like(norm)).sum() / torch.clamp_min(
        eff.sum().to(torch.float32), 1.0)
    return rgb_loss + cfg.ek_loss_weight * ek


def leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


class Adam:
    """tcnn's Adam: L2 on matrix weights ("w"), which always step; other
    leaves skip the elements whose gradient is exactly zero (no decay, no
    count); per-element step counts for the debias; no lr decay before
    step 20,000."""

    def __init__(self, params: dict, cfg: RefConfig):
        self.cfg = cfg
        self.mu = {n: torch.zeros_like(p) for n, p in leaves(params)}
        self.nu = {n: torch.zeros_like(p) for n, p in leaves(params)}
        self.steps = {n: torch.zeros_like(p, dtype=torch.int32) for n, p in leaves(params)}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        cfg = self.cfg
        lr = float(torch.tensor(cfg.learning_rate, dtype=torch.float32))
        b1, b2 = cfg.beta1, cfg.beta2
        for name, p in leaves(params):
            g = grads[name]
            if name.endswith(".w"):
                g = g + cfg.l2_reg * p
                active = torch.ones_like(g, dtype=torch.bool)
            else:
                active = g != 0.0
            mu = torch.where(active, b1 * self.mu[name] + (1 - b1) * g, self.mu[name])
            nu = torch.where(active, b2 * self.nu[name] + (1 - b2) * g * g, self.nu[name])
            st = self.steps[name] + active.to(torch.int32)
            t = torch.clamp_min(st, 1).to(torch.float32)
            debias = torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
            eff = torch.clamp_min(lr * debias / (torch.sqrt(nu) + cfg.epsilon), 0.0)
            p += torch.where(active, -eff * mu, torch.zeros_like(mu))
            self.mu[name], self.nu[name], self.steps[name] = mu, nu, st


def start(cfg: RefConfig, seed: int, device):
    """The scene's start from ``seed``: the field's init, the step
    generator (on ``device``, seeded ``seed + 1``) and the occupancy grid
    after the whole-grid sweep it makes before the first step."""
    params = init_params(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    occ = Occupancy(device)
    for _ in range(-(-GRID**3 // cfg.occ_n_probe)):
        occ.update(params, cfg, torch.rand((cfg.occ_n_probe, 3), generator=gen, device=device),
                   cfg.n_levels)
    return params, gen, occ


def train(cap, cfg: RefConfig, seed: int, n_steps: int, bucket: int,
          batch_share: float = 1.0) -> dict:
    """``n_steps`` steps of the loop from the start (an occupancy update
    before each step, as in its first 256) in adaptive bucket ``bucket``:
    (n_rays << bucket) x (samples_per_ray >> bucket) -> {"loss": each
    step's loss, "start", "grad": the first step's gradient as Adam holds
    it (mu / (1 - beta1)), "params" and "ema" after the last step}, the
    last four dicts of leaves."""
    dev = cap.images.device
    params, gen, occ = start(cfg, seed, dev)
    first = {n: p.clone() for n, p in leaves(params)}
    ema = {n: p.clone() for n, p in leaves(params)}
    adam = Adam(params, cfg)
    n_rays, spr = cfg.n_rays << bucket, cfg.samples_per_ray >> bucket
    out = {"loss": [], "start": first}
    for k in range(n_steps):
        vl = cfg.valid_level(k)
        occ.update(params, cfg, torch.rand((cfg.occ_n_probe, 3), generator=gen, device=dev), vl)
        dr = draws(gen, cfg, cap.images.shape[0], n_rays, spr)
        live = dict(leaves(params))
        for p in live.values():
            p.requires_grad_(True)
        total = loss(params, cap, occ, dr, cfg, n_rays, spr, vl, batch_share)
        grads = torch.autograd.grad(total, list(live.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(live.items(), grads)}
        for p in live.values():
            p.requires_grad_(False)
        adam.step(params, grads)
        for n, p in leaves(params):
            ema[n] = cfg.ema_decay * ema[n] + (1.0 - cfg.ema_decay) * p
        out["loss"].append(float(total.detach()))
        if k == 0:
            out["grad"] = {n: m / (1.0 - cfg.beta1) for n, m in adam.mu.items()}
    out["params"] = {n: p.detach().clone() for n, p in leaves(params)}
    out["ema"] = ema
    return out


# --- rendering ----------------------------------------------------------------------


@torch.no_grad()
def render_view(params: dict, occ: Occupancy, cap, view: int, cfg: RefConfig,
                chunk: int = 1 << 14) -> tuple[torch.Tensor, int]:
    """Training view ``view`` at the capture's size over black, one
    sample a pixel at the pixel centre -> (sRGB image (H, W, 3), rays that
    cross occupied space).  Each such ray takes ``render_samples_per_ray``
    samples at its strata's centres; the others are background."""
    w, h = cap.wh
    dev = cap.poses.device
    u = (torch.arange(w, device=dev) + 0.5) / w
    v = (torch.arange(h, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    idx = torch.full((uv.shape[0],), view, dtype=torch.int64, device=dev)
    o, d = pixel_rays(cap.poses, cap.focal, cap.principal, cap.wh, idx, uv)
    total = torch.cat([probe(oc, dc, occ, cfg.render_candidates, None)[2]
                       for oc, dc in zip(torch.split(o, chunk), torch.split(d, chunk))])
    hit = torch.nonzero(total > 0.0).squeeze(1)
    out = torch.zeros((w * h, 3), device=dev)
    spr = cfg.render_samples_per_ray
    for part in torch.split(hit, chunk):
        oc, dc = o[part], d[part]
        start, seg, tot, hp = probe(oc, dc, occ, cfg.render_candidates, None)
        t, dt, mask = draw(start, seg, tot, hp, spr, None)
        n = oc.shape[0]
        pos = (oc[:, None, :] + t[..., None] * dc[:, None, :]).reshape(-1, 3)
        d_w = ((dc + 1.0) * 0.5)[:, None, :].expand(n, spr, 3).reshape(-1, 3)
        rgb, sdf, normal, inv_s = field(params, pos, d_w, cfg, cfg.n_levels, create_graph=False)
        alpha = neus_alpha(sdf.reshape(n, spr), normal.reshape(n, spr, 3), dc[:, None, :], dt,
                           inv_s)
        c_rgb, _, _, _, _ = composite(rgb.reshape(n, spr, 3), alpha, mask,
                                      cfg.render_min_transmittance)
        out[part] = c_rgb
    return torch.clamp(out, 0.0, 1.0).reshape(h, w, 3), int(hit.numel())
