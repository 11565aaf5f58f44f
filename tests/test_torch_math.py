"""Port parity: warps, SH, NeuS alpha, compositing and losses against
``neus2_tpu`` on the same numpy inputs (fp32, rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.ops import losses as jl
from neus2_tpu.ops import neus_math as jm
from neus2_tpu.ops import sh as jsh
from neus2_tpu.ops import warp as jw
from neus2_tpu_torch.ops import losses as tl
from neus2_tpu_torch.ops import neus_math as tm
from neus2_tpu_torch.ops import sh as tsh
from neus2_tpu_torch.ops import warp as tw

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_warp_and_ray_intersect(aabb_scale):
    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 2, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ja, ta = jw.scene_aabb(aabb_scale), tw.scene_aabb(aabb_scale)
    jt = ja.ray_intersect(jnp.asarray(o), jnp.asarray(d))
    tt = ta.ray_intersect(torch.from_numpy(o), torch.from_numpy(d))
    for a, b in zip(jt, tt):
        _close(a, b)
    _close(jw.warp_position(jnp.asarray(o), ja), tw.warp_position(torch.from_numpy(o), ta))
    _close(jw.warp_direction(jnp.asarray(d)), tw.warp_direction(torch.from_numpy(d)))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    rng = np.random.default_rng(degree)
    d = rng.uniform(0, 1, (128, 3)).astype(np.float32)
    _close(jsh.sh_encode(jnp.asarray(d), degree), tsh.sh_encode(torch.from_numpy(d), degree))
    assert tsh.sh_output_dim(degree) == jsh.sh_output_dim(degree)


@pytest.mark.parametrize("anneal", [1.0, 0.3])
def test_neus_alpha_and_density(anneal):
    rng = np.random.default_rng(1)
    sdf = rng.normal(0, 0.1, (32, 16)).astype(np.float32)
    normal = rng.normal(size=(32, 16, 3)).astype(np.float32)
    direction = rng.normal(size=(32, 1, 3)).astype(np.float32)
    dt = rng.uniform(0.001, 0.05, (32, 16)).astype(np.float32)
    inv_s = np.float32(20.0)
    ja = jm.neus_alpha(*map(jnp.asarray, (sdf, normal, direction, dt, inv_s)), anneal)
    ta = tm.neus_alpha(*map(torch.as_tensor, (sdf, normal, direction, dt, inv_s)), anneal)
    _close(ja, ta)
    _close(
        jm.sdf_to_logistic_density(jnp.asarray(sdf), inv_s),
        tm.sdf_to_logistic_density(torch.from_numpy(sdf), torch.tensor(inv_s)),
    )
    _close(jm.variance_to_inv_s(jnp.float32(0.3)), tm.variance_to_inv_s(torch.tensor(0.3)))


def test_cos_anneal_ratio():
    for step, end in ((0, 0), (5, 0), (5, 10), (20, 10)):
        assert tm.cos_anneal_ratio(step, end) == pytest.approx(
            float(jm.cos_anneal_ratio(jnp.int32(step), end))
        )


@pytest.mark.parametrize("trans_eps", [1e-4, 0.3])
def test_composite_rays(trans_eps):
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    alpha = rng.uniform(0, 0.4, (16, 24)).astype(np.float32)
    t = np.cumsum(rng.uniform(0.01, 0.02, (16, 24)), -1).astype(np.float32)
    mask = rng.uniform(size=(16, 24)) > 0.2
    jo = jm.composite_rays(*map(jnp.asarray, (rgb, alpha, t, mask)), trans_eps)
    to = tm.composite_rays(*map(torch.as_tensor, (rgb, alpha, t, mask)), trans_eps)
    for a, b in zip(jo, to):
        if b.dtype == torch.bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b)


@pytest.mark.parametrize("loss_type", ["Huber", "L2", "L1", "RelativeL2"])
def test_rgb_loss(loss_type):
    rng = np.random.default_rng(3)
    tgt = rng.uniform(size=(64, 3)).astype(np.float32)
    pred = (tgt + rng.normal(0, 0.2, (64, 3))).astype(np.float32)
    _close(
        jl.rgb_loss(jnp.asarray(tgt), jnp.asarray(pred), loss_type),
        tl.rgb_loss(torch.from_numpy(tgt), torch.from_numpy(pred), loss_type),
    )


def test_mask_bce_and_srgb():
    rng = np.random.default_rng(4)
    w = rng.uniform(-0.1, 1.1, 256).astype(np.float32)
    m = (rng.uniform(size=256) > 0.5).astype(np.float32)
    _close(jl.mask_bce_loss(jnp.asarray(w), jnp.asarray(m)),
           tl.mask_bce_loss(torch.from_numpy(w), torch.from_numpy(m)))
    c = rng.uniform(0, 1, 512).astype(np.float32)
    _close(jl.srgb_to_linear(jnp.asarray(c)), tl.srgb_to_linear(torch.from_numpy(c)))
    _close(jl.linear_to_srgb(jnp.asarray(c)), tl.linear_to_srgb(torch.from_numpy(c)))


def test_constants_match():
    from neus2_tpu import constants as jc
    from neus2_tpu_torch import constants as tc

    names = sorted(n for n in vars(jc) if n.isupper())
    assert names == sorted(n for n in vars(tc) if n.isupper()) and names
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


def test_clip_gradient_splits_ties_like_jnp_clip():
    """``clip`` differentiates as ``jnp.clip``: half the gradient at a tie."""
    import jax

    x = np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32)
    jg = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm.clip(xt, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(np.asarray(jg), xt.grad.numpy())
