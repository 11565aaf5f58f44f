"""The field of NeuS2 in plain PyTorch: the configuration, the seeded
initialisation, the multiresolution hash encoding, the two MLPs and the
SDF's spatial gradient by autograd.

Sources: NeuS2 (Wang et al., ICCV 2023; its ``configs/nerf/base.json`` and
``nerf_network.h``), the tcnn hash grid (Mueller et al., 2022: corners
hashed by the XOR of coordinate-prime products, levels dense-indexed while
they fit) and the SAL/IGR sphere initialisation.  The normal and the
eikonal term's second-order path are plain autograd through the gathers
and the MLPs (``create_graph``), not the hand-built Jacobian and backward
of the program.  The draws of the initialisation follow the order the
published code makes them in, so that the same seed gives the same start.

``RefConfig.tf32`` rounds both operands of every MLP product to TF32 (10
mantissa bits, to nearest, ties away from zero, as the tensor cores'
conversion does) with fp32 sums: the control that a lower precision must
fail.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
_CORNERS = tuple(tuple((c >> d) & 1 for d in range(3)) for c in range(8))


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """What the reference reads from a configuration file: the published
    keys, and the sizes under ``assumed`` that the file states for the
    program's defaults."""

    n_levels: int
    n_features: int
    log2_hashmap_size: int
    base_resolution: int
    per_level_scale: float
    valid_level_scale: float
    base_valid_level_scale: float
    base_training_step: int
    sdf_hidden: int
    sdf_n_hidden: int
    rgb_hidden: int
    rgb_n_hidden: int
    sdf_out_dim: int
    sh_degree: int
    sdf_bias: float
    init_radius: float
    variance_init: float
    learning_rate: float
    beta1: float
    beta2: float
    epsilon: float
    l2_reg: float
    ema_decay: float
    ek_loss_weight: float
    n_rays: int
    samples_per_ray: int
    n_candidates: int
    hit_oversample: int
    occ_n_probe: int
    train_transmittance_eps: float
    render_samples_per_ray: int
    render_candidates: int
    render_min_transmittance: float
    tf32: bool = False

    @property
    def encoding_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def sdf_in_dim(self) -> int:
        return 3 + self.encoding_dim

    @property
    def rgb_in_dim(self) -> int:
        # [sdf outputs | SH(dir) | xyz | normal] (nerf_network.h)
        return self.sdf_out_dim + self.sh_degree**2 + 3 + 3

    def levels(self) -> list[tuple[int, float, int, bool]]:
        """(resolution, lookup scale, table rows, hashed) a level (tcnn
        grid.h: scale = resolution - 1, rows rounded up to 8 and capped
        at 2^log2_hashmap_size)."""
        out = []
        for lvl in range(self.n_levels):
            raw = math.exp2(lvl * math.log2(self.per_level_scale)) * self.base_resolution - 1.0
            res = int(math.ceil(raw)) + 1
            dense = min(res**3, (2**32 - 1) // 2)
            rows = min(-(-dense // 8) * 8, 1 << self.log2_hashmap_size)
            out.append((res, float(res - 1), rows, res**3 > rows))
        return out

    def valid_level(self, frame_step: int) -> int:
        """The progressive unlock (grid.h): every level at step 0, then
        ceil(L * base_scale + scale * (step - base_step)) in float32."""
        if frame_step <= 0:
            return self.n_levels
        raw = np.ceil(np.float32(self.base_valid_level_scale * self.n_levels)
                      + np.float32(self.valid_level_scale)
                      * np.float32(max(0, frame_step - self.base_training_step)))
        return int(min(self.n_levels, int(raw)))


def load_config(path) -> RefConfig:
    """The reference's reading of a NeuS2 network configuration file."""
    with open(path) as f:
        return config_from_dict(json.load(f))


def config_from_dict(cfg: dict) -> RefConfig:
    enc, net, rgb = cfg["encoding"], cfg["network"], cfg["rgb_network"]
    ema = cfg["optimizer"]
    adam = ema
    while "nested" in adam:
        adam = adam["nested"]
    top = int(enc.get("top_resolution", 2048))
    base = int(enc["base_resolution"])
    n_levels = int(enc["n_levels"])
    a = cfg["assumed"]
    return RefConfig(
        n_levels=n_levels,
        n_features=int(enc["n_features_per_level"]),
        log2_hashmap_size=int(enc["log2_hashmap_size"]),
        base_resolution=base,
        per_level_scale=math.exp(math.log(top / base) / (n_levels - 1)),
        valid_level_scale=float(enc["valid_level_scale"]),
        base_valid_level_scale=float(enc["base_valid_level_scale"]),
        base_training_step=int(enc["base_training_step"]),
        sdf_hidden=int(net["n_neurons"]),
        sdf_n_hidden=int(net["n_hidden_layers"]),
        rgb_hidden=int(rgb["n_neurons"]),
        rgb_n_hidden=int(rgb["n_hidden_layers"]),
        sdf_out_dim=int(a["sdf_out_dim"]),
        sh_degree=int(a["sh_degree"]),
        sdf_bias=float(a["sdf_bias"]),
        init_radius=float(a["init_radius"]),
        variance_init=float(a["variance_init"]),
        learning_rate=float(adam["learning_rate"]),
        beta1=float(adam["beta1"]),
        beta2=float(adam["beta2"]),
        epsilon=float(adam["epsilon"]),
        l2_reg=float(adam["l2_reg"]),
        ema_decay=float(ema["decay"]) if ema.get("otype") == "Ema" else 1.0,
        ek_loss_weight=float(cfg["hyperparams"]["ek_loss_weight"]),
        n_rays=int(a["n_rays"]),
        samples_per_ray=int(a["samples_per_ray"]),
        n_candidates=int(a["n_candidates"]),
        hit_oversample=int(a["hit_oversample"]),
        occ_n_probe=int(a["occ_n_probe"]),
        train_transmittance_eps=float(a["train_transmittance_eps"]),
        render_samples_per_ray=int(a["render_samples_per_ray"]),
        render_candidates=int(a["render_candidates"]),
        render_min_transmittance=float(a["render_min_transmittance"]),
    )


# --- initialisation ---------------------------------------------------------


def _sphere_fit(layers: list[dict], cfg: RefConfig) -> list[dict]:
    """Least-squares fit of the last layer's SDF column to |x - 0.5| - r -
    bias over 8,192 points drawn from a CPU generator seeded 7, with the
    grid features at zero: float64, 256-row chunks summed in order, a
    ridge of 1e-4 and a Cholesky solve written out (no BLAS call, so any
    host draws the same weights)."""
    x = torch.rand((8192, 3), generator=torch.Generator().manual_seed(7)).double().numpy()
    hidden = [(l["w"].double().numpy(), l["b"].double().numpy()) for l in layers[:-1]]
    target = np.sqrt(((x - 0.5) ** 2).sum(-1)) - cfg.init_radius - cfg.sdf_bias
    n = layers[-1]["w"].shape[0] + 1
    gram, rhs = np.zeros((n, n)), np.zeros(n)
    for lo in range(0, x.shape[0], 256):
        xc = x[lo:lo + 256]
        h = np.concatenate([xc, np.zeros((len(xc), cfg.encoding_dim))], -1)
        for w, b in hidden:
            h = np.maximum((h[:, :, None] * w[None]).sum(1) + b, 0.0)
        design = np.concatenate([h, np.ones((len(h), 1))], -1)
        gram += (design[:, :, None] * design[:, None, :]).sum(0)
        rhs += (design * target[lo:lo + 256, None]).sum(0)
    a = gram + 1e-4 * np.eye(n)
    low = np.zeros_like(a)
    for j in range(n):
        low[j, j] = np.sqrt(a[j, j] - (low[j, :j] * low[j, :j]).sum())
        low[j + 1:, j] = (a[j + 1:, j] - (low[j + 1:, :j] * low[j, :j]).sum(1)) / low[j, j]
    y = np.zeros(n)
    for i in range(n):
        y[i] = (rhs[i] - (low[i, :i] * y[:i]).sum()) / low[i, i]
    beta = np.zeros(n)
    for i in reversed(range(n)):
        beta[i] = (y[i] - (low[i + 1:, i] * beta[i + 1:]).sum()) / low[i, i]
    beta = torch.from_numpy(beta).float()
    last = {"w": layers[-1]["w"].clone(), "b": layers[-1]["b"].clone()}
    last["w"][:, 0] = beta[:-1]
    last["b"][0] = beta[-1]
    return layers[:-1] + [last]


def init_params(cfg: RefConfig, seed: int, device) -> dict:
    """The field's start from ``seed``: tables ~ U(-1e-4, 1e-4) a level,
    the SDF MLP's sphere init (then the fit), He-uniform RGB weights, zero
    biases, the variance at its published start; drawn in that order from
    one CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    tables = [torch.rand((rows, cfg.n_features), generator=gen) * 2e-4 - 1e-4
              for _, _, rows, _ in cfg.levels()]
    dims = [cfg.sdf_in_dim] + [cfg.sdf_hidden] * cfg.sdf_n_hidden + [cfg.sdf_out_dim]
    sdf_layers = []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        w = torch.randn((fan_in, fan_out), generator=gen)
        if i == len(dims) - 2:
            w = w * 1e-4
            w[:, 0] += math.sqrt(math.pi / fan_in)
            b = torch.zeros(fan_out)
            b[0] = -(cfg.init_radius + cfg.sdf_bias)
        elif i == 0:
            w = w * math.sqrt(2.0 / fan_out)
            w[3:, :] *= 1e-2
            b = -w[:3, :].sum(0) * 0.5
        else:
            w = w * math.sqrt(2.0 / fan_out)
            b = torch.zeros(fan_out)
        sdf_layers.append({"w": w, "b": b})
    sdf_layers = _sphere_fit(sdf_layers, cfg)
    dims = [cfg.rgb_in_dim] + [cfg.rgb_hidden] * cfg.rgb_n_hidden + [3]
    rgb_layers = []
    for i in range(len(dims) - 1):
        s = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        w = torch.rand((dims[i], dims[i + 1]), generator=gen) * (2 * s) - s
        rgb_layers.append({"w": w, "b": torch.zeros(dims[i + 1])})
    params = {"hashgrid": tables, "sdf_mlp": {"layers": sdf_layers},
              "rgb_mlp": {"layers": rgb_layers},
              "variance": torch.tensor(cfg.variance_init, dtype=torch.float32)}
    return tree_to(params, device)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# --- the field --------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, the gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def mlp(layers: list[dict], h: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    """ReLU hidden layers and a linear output."""
    for i, layer in enumerate(layers):
        w = layer["w"]
        h = (_tf32(h) @ _tf32(w) if cfg.tf32 else h @ w) + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _corner_rows(pos_grid: torch.Tensor, res: int, rows: int, hashed: bool) -> torch.Tensor:
    if hashed:
        g = pos_grid & _U32
        idx = (((g[..., 0] * _PRIMES[0]) & _U32) ^ ((g[..., 1] * _PRIMES[1]) & _U32)
               ^ ((g[..., 2] * _PRIMES[2]) & _U32))
    else:
        idx = pos_grid[..., 0] + pos_grid[..., 1] * res + pos_grid[..., 2] * res * res
    return idx % rows


def encode(tables: list[torch.Tensor], x: torch.Tensor, cfg: RefConfig,
           valid_level: int) -> torch.Tensor:
    """Trilinear features of the 8 corners a level, levels above
    ``valid_level`` at zero -> (N, L * F); differentiable in the tables
    and in x (twice, through the corner weights)."""
    corners = torch.tensor(_CORNERS, device=x.device)
    feats = []
    for lvl, (res, scale, rows, hashed) in enumerate(cfg.levels()):
        pos = x * scale + 0.5
        floor = torch.floor(pos)
        frac = pos - floor
        idx = _corner_rows(floor.to(torch.int64)[:, None, :] + corners[None], res, rows, hashed)
        vals = tables[lvl][idx]  # (N, 8, F)
        terms = torch.where(corners.bool()[None], frac[:, None, :], 1.0 - frac[:, None, :])
        # Written out where autograd will differentiate it: prod's backward
        # is several times the forward's cost.
        w = (terms[..., 0] * terms[..., 1] * terms[..., 2] if x.requires_grad
             else terms.prod(-1))
        feats.append((w[..., None] * vals).sum(1) * (1.0 if lvl <= valid_level else 0.0))
    return torch.cat(feats, -1)


def sdf_out(params: dict, x: torch.Tensor, cfg: RefConfig, valid_level: int) -> torch.Tensor:
    """The SDF MLP's outputs (N, sdf_out_dim); column 0 plus the bias is the SDF."""
    enc = encode(params["hashgrid"], x, cfg, valid_level)
    return mlp(params["sdf_mlp"]["layers"], torch.cat([x, enc], -1), cfg)


def sh_encode(d_warped: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics of the unwarped direction, degrees 1-4."""
    d = d_warped * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, -1)


def field(params: dict, x: torch.Tensor, d_warped: torch.Tensor, cfg: RefConfig,
          valid_level: int, create_graph: bool):
    """(rgb (N, 3), sdf (N,), normal (N, 3), inv_s) at warped positions;
    the normal is dSDF/dx by autograd, kept in the graph for the eikonal
    term when ``create_graph``."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        h = sdf_out(params, x, cfg, valid_level)
        sdf = h[:, 0] + cfg.sdf_bias
        (normal,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        h, sdf = h.detach(), sdf.detach()
    rgb_in = torch.cat([h, sh_encode(d_warped, cfg.sh_degree), x.detach(), normal], -1)
    rgb = torch.sigmoid(mlp(params["rgb_mlp"]["layers"], rgb_in, cfg))
    return rgb, sdf, normal, torch.exp(10.0 * params["variance"])
