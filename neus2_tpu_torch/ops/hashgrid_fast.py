"""Hash-grid encoding with its analytic spatial Jacobian and a hand-built
backward (port of ``neus2_tpu/ops/hashgrid_fast.py``).

The encoder returns features and d(features)/dx, as the reference caches
``dy_dx`` in its forward (tcnn grid.h:175-369).  The NeuS normal is then
first order in the Jacobian output, so the eikonal loss needs no
grad-of-grad through the gathers: the backward below covers the
contractions the reference implements as its second-order kernels
(grid.h:881 d(dL/dx)->dGrid, 1010 d(dL/dx)->dx).

Every level gathers its 8 corners with per-corner indices and emits
per-corner (N*8, F) table updates; the JAX package's dense-level corner
fusion and table rolls only worked around TPU gather limits.  The table
gradient of all levels is one call to ``segment_dense_sum_multi`` (exact
scatter on the CPU, the segment-sum kernel on the card).

With ``compute_dtype`` (bf16) the backward's contractions take bf16-rounded
operands with fp32 sums, and the table update is emitted in bf16 (the
reference caches and contracts dy_dx in fp16, grid.h:372-1250; the kernel
sums bf16 payloads either way); the forward's features and Jacobian stay
fp32.
"""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.hashgrid import HashGridConfig, _corner_indices
from neus2_tpu_torch.ops.scatter import segment_dense_sum_multi
from neus2_tpu_torch.utils.device import constant, round_operand

# Corner offsets (8, 3): corner >> d & 1 per dimension, and the sign of each
# trilinear factor's derivative.
_CORNERS = tuple(tuple((c >> d) & 1 for d in range(3)) for c in range(8))
_SIGNS = tuple(tuple(2.0 * b - 1.0 for b in corner) for corner in _CORNERS)


def init_hashgrid_tables(
    generator: torch.Generator, config: HashGridConfig, device="cpu"
) -> list[torch.Tensor]:
    """Per-level (T_l, F) tables ~ U(-1e-4, 1e-4) (tcnn initialize_params),
    drawn on the generator's device and moved to ``device``."""
    _, _, _, sizes, _ = config.level_tables()
    gen_dev = generator.device
    return [
        (
            torch.rand(
                (s, config.n_features_per_level),
                generator=generator,
                device=gen_dev,
            )
            * 2e-4
            - 1e-4
        ).to(device)
        for s in sizes
    ]


def _weights_and_grads(frac: torch.Tensor, scale: float):
    """Trilinear weights w (N,8), dw/dx (N,8,3), the per-axis factors
    terms (N,8,3) and their derivative signs (8,3)."""
    corners = constant(_CORNERS, torch.bool, frac.device)
    terms = torch.where(corners[None], frac[:, None, :], 1.0 - frac[:, None, :])
    signs = constant(_SIGNS, frac.dtype, frac.device)
    w = terms.prod(-1)
    prod_excl = torch.stack(
        [
            terms[..., 1] * terms[..., 2],
            terms[..., 0] * terms[..., 2],
            terms[..., 0] * terms[..., 1],
        ],
        dim=-1,
    )
    dw = signs[None] * prod_excl * scale
    return w, dw, terms, signs


def _level_gate(l, n_levels, valid_level, max_level, x):
    """Level l's output gate: 0 above ``valid_level`` (grid.h:198) and, per
    sample, 0 where l >= max_level * L (grid.h:217-240).  (N, 1) or a
    float."""
    gate = 1.0 if l <= valid_level else 0.0
    if max_level is None:
        return gate
    per_sample = (l < max_level * n_levels + 1e-3).to(x.dtype)
    return gate * per_sample[:, None]


class _EncodeJac(torch.autograd.Function):
    @staticmethod
    def forward(ctx, config, compute_dtype, x, valid_level, max_level, *tables):
        L = config.n_levels
        resolutions, scales, _, sizes, use_hash = config.level_tables()
        corners = constant(_CORNERS, torch.int64, x.device)
        want_dx = ctx.needs_input_grad[2]
        feats, jacs, residuals = [], [], []
        for l in range(L):
            pos = x * scales[l] + 0.5
            pos_floor = torch.floor(pos)
            frac = pos - pos_floor
            pos_grid = pos_floor.to(torch.int64)
            idx = _corner_indices(
                pos_grid[:, None, :] + corners[None],
                resolutions[l], sizes[l], use_hash[l],
            )  # (N, 8)
            vals = tables[l][idx]  # (N, 8, F)
            w, dw, _, _ = _weights_and_grads(frac, scales[l])
            gate = _level_gate(l, L, valid_level, max_level, x)
            feats.append((w[..., None] * vals).sum(1) * gate)
            g3 = gate if isinstance(gate, float) else gate[:, None, :]
            jacs.append((dw[..., None] * vals[:, :, None, :]).sum(1) * g3)
            residuals.append((idx, frac, gate, vals if want_dx else None))
        ctx.config = config
        ctx.compute_dtype = compute_dtype
        ctx.residuals = residuals
        ctx.sizes = sizes
        ctx.scales = scales
        return torch.cat(feats, -1), torch.cat(jacs, -1)

    @staticmethod
    def backward(ctx, ct_feat, ct_jac):
        F = ctx.config.n_features_per_level
        dt = ctx.compute_dtype
        want_dx = ctx.needs_input_grad[2]
        # No table trains (the pose-refinement phase of a dynamic scene):
        # skip the table gradient, its sort and its segment-sum kernel.
        want_tables = any(ctx.needs_input_grad[5:])
        idx_list, upd_list = [], []
        d_x = 0.0
        for l, (idx, frac, gate, vals) in enumerate(ctx.residuals):
            scale = ctx.scales[l]
            w, dw, terms, signs = _weights_and_grads(frac, scale)
            g3 = gate if isinstance(gate, float) else gate[:, None, :]
            ctf = round_operand(ct_feat[:, l * F : (l + 1) * F] * gate, dt)  # (N, F)
            ctj = round_operand(ct_jac[:, :, l * F : (l + 1) * F] * g3, dt)  # (N, 3, F)
            dw_c = round_operand(dw, dt)
            if want_tables:
                # d table from both the feat and the jac outputs (grid.h:372,
                # 881).  These contractions are broadcast-multiply-sums, not
                # einsums: an einsum becomes a cuBLAS batched product of N
                # tiny matrices.
                first = round_operand(w, dt)[..., None] * ctf[:, None, :]
                second = (dw_c[..., None] * ctj[:, None, :, :]).sum(2)  # (N, 8, F)
                if dt is None:
                    upd = first + second
                else:  # the bf16 product, the fp32 sum rounded, a bf16 add
                    upd = first.to(dt) + second.to(dt)
                idx_list.append(idx.reshape(-1))
                upd_list.append(upd.reshape(-1, F))
            if not want_dx:
                continue
            vals = round_operand(vals, dt)
            # d positions, first order through feat (grid.h:804) ...
            vc = (vals * ctf[:, None, :]).sum(-1)  # (N, 8)
            d_x = d_x + (round_operand(vc, dt)[..., None] * dw_c).sum(1)
            # ... and second order through jac (grid.h:1010): d2w/dx_j dx_k
            # = sign_j sign_k * term_excl(j,k) * scale^2, 0 when j == k.
            vj = (vals[:, :, None, :] * ctj[:, None, :, :]).sum(-1)  # (N, 8, 3)
            s2 = scale * scale
            t0, t1, t2 = terms[..., 0], terms[..., 1], terms[..., 2]
            s0, s1, s2_ = signs[:, 0], signs[:, 1], signs[:, 2]
            e01 = s0[None] * s1[None] * t2 * s2
            e02 = s0[None] * s2_[None] * t1 * s2
            e12 = s1[None] * s2_[None] * t0 * s2
            dx0 = vj[..., 1] * e01 + vj[..., 2] * e02
            dx1 = vj[..., 0] * e01 + vj[..., 2] * e12
            dx2 = vj[..., 0] * e02 + vj[..., 1] * e12
            d_x = d_x + torch.stack([dx0.sum(1), dx1.sum(1), dx2.sum(1)], -1)
        if want_tables:
            d_tables = segment_dense_sum_multi(idx_list, upd_list, ctx.sizes)
        else:
            d_tables = [None] * len(ctx.sizes)
        return (None, None, d_x if want_dx else None, None, None, *d_tables)


def make_encode_jac(config: HashGridConfig, compute_dtype: torch.dtype | None = None):
    """Returns encode_jac(tables, positions, valid_level, max_level) ->
    (feat (N, L*F), jac (N, 3, L*F)).

    ``valid_level``: int, levels above it output zeros.  ``max_level``:
    optional per-sample (N,) fraction in [0, 1]; level l is zeroed where
    l >= max_level * L.  ``compute_dtype``: the backward's operand dtype
    (None = fp32)."""

    def encode_jac(tables, positions, valid_level=None, max_level=None):
        vl = 10**9 if valid_level is None else int(valid_level)
        return _EncodeJac.apply(config, compute_dtype, positions, vl, max_level, *tables)

    return encode_jac


def encode_jac_reference(tables, positions: torch.Tensor, config: HashGridConfig,
                         valid_level=None):
    """Oracle: plain per-corner trilinear features (the JAX package's
    ``hashgrid_encode``) and their Jacobian by autograd, one output column
    at a time (slow) -> (feat (N, L*F), jac (N, 3, L*F))."""
    resolutions, scales, _, sizes, use_hash = config.level_tables()
    x = positions.detach().requires_grad_(True)
    outs = []
    for l in range(config.n_levels):
        pos = x * scales[l] + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        feat = 0.0
        for corner in _CORNERS:
            co = torch.tensor(corner, device=x.device)
            w = torch.where(co == 1, frac, 1.0 - frac).prod(-1)
            idx = _corner_indices(pos_floor.to(torch.int64) + co, resolutions[l], sizes[l],
                                  use_hash[l])
            feat = feat + w[:, None] * tables[l][idx]
        outs.append(feat * (1.0 if valid_level is None or l <= valid_level else 0.0))
    feat = torch.cat(outs, -1)
    cols = [torch.autograd.grad(feat[:, k].sum(), x, retain_graph=True)[0]
            for k in range(feat.shape[1])]
    return feat.detach(), torch.stack(cols, -1)
