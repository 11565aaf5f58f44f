"""Port parity of the NeuS field: ``field_forward`` outputs and the gradient
of a scalar of all four outputs with respect to every parameter, for the
same parameters (carried from the JAX package by ``interop``).

Tolerances (fp32): outputs rtol 1e-5 (atol 1e-6); gradients 1e-4 of each
leaf's reference max magnitude -- the normal's second-order path sums
over many samples in another order than XLA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.models import field as jf
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.models.mlp import apply_mlp
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)


def _configs(F=2):
    g = dict(_GRID, n_features_per_level=F)
    return (jf.FieldConfig(grid=JGrid(**g), **_FIELD),
            tf.FieldConfig(grid=TGrid(**g), **_FIELD))


def _jax_params(jc, seed=0):
    p = jf.init_field(jax.random.PRNGKey(seed), jc)
    # Tables large enough that the grid features matter.
    p["hashgrid"] = tuple(t * 1e3 for t in p["hashgrid"])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("F,valid_level", [(2, None), (2, 2), (8, None)])
def test_field_forward_and_param_grads(F, valid_level):
    jc, tc = _configs(F)
    pj = _jax_params(jc, seed=F)
    rng = np.random.default_rng(F)
    n = 128
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    c_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    c_sdf = rng.normal(size=n).astype(np.float32)
    c_nrm = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(params):
        out = jf.field_forward(params, jnp.asarray(x), jnp.asarray(d), jc, valid_level)
        s = (jnp.sum(out.rgb * c_rgb) + jnp.sum(out.sdf * c_sdf)
             + jnp.sum(out.normal * c_nrm) + out.inv_s)
        return s, out

    pj_dev = jax.tree_util.tree_map(jnp.asarray, pj)
    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(pj_dev)

    pt = interop.params_from_jax(pj)
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    tout = tf.field_forward(pt, torch.from_numpy(x), torch.from_numpy(d), tc, valid_level)
    s = ((tout.rgb * torch.from_numpy(c_rgb)).sum() + (tout.sdf * torch.from_numpy(c_sdf)).sum()
         + (tout.normal * torch.from_numpy(c_nrm)).sum() + tout.inv_s)
    tgrads = torch.autograd.grad(s, leaves)

    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for a, b in zip(jleaves, tgrads):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(b.numpy() - a).max() <= 1e-4 * max(np.abs(a).max(), 1e-8)


def test_sdf_fn_matches_and_init_is_a_sphere():
    jc, tc = _configs()
    pj = _jax_params(jc)
    x = np.random.default_rng(1).uniform(0, 1, (64, 3)).astype(np.float32)
    js, jfeat = jf.sdf_fn(jax.tree_util.tree_map(jnp.asarray, pj), jnp.asarray(x), jc)
    ts, tfeat = tf.sdf_fn(interop.params_from_jax(pj), torch.from_numpy(x), tc)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-6)

    # The port's own init calibrates to the init sphere, as the JAX one does
    # (mean |error| of either package's init is ~0.02-0.03 at width 16).
    p = tf.init_field(torch.Generator().manual_seed(0), tc)
    sdf, _ = tf.sdf_fn(p, torch.from_numpy(x), tc)
    target = np.linalg.norm(x - 0.5, axis=-1) - 0.5
    assert np.abs(sdf.numpy() - target).mean() < 0.05
    # Parameter trees line up leaf for leaf with the JAX package's.
    shapes = [tuple(l.shape) for l in tree_leaves(p)]
    assert shapes == [tuple(np.shape(l)) for l in jax.tree_util.tree_leaves(pj)]


def test_mlp_layout_is_in_by_out():
    jc, tc = _configs()
    pj = _jax_params(jc)
    pt = interop.params_from_jax(pj)
    h = np.random.default_rng(2).normal(size=(8, tc.rgb_in_dim)).astype(np.float32)
    from neus2_tpu.models.mlp import apply_mlp as japply

    np.testing.assert_allclose(
        apply_mlp(pt["rgb_mlp"], torch.from_numpy(h)).numpy(),
        np.asarray(japply(jax.tree_util.tree_map(jnp.asarray, pj["rgb_mlp"]), jnp.asarray(h))),
        rtol=1e-5, atol=1e-6,
    )
    back = interop.params_to_jax(pt)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(tc.grid) == dataclasses.asdict(jc.grid)


def test_init_is_the_same_on_hosts_of_more_threads():
    """The sphere-init fit's Gram product sums 8192 rows in an order the
    CPU's BLAS picks by thread count, and its ill-conditioned ridge solve
    turned that into calibrated weights up to ~1e-2 apart: an 8-thread and
    a 32-thread host drew other inits, and every run after differed.  The
    fit runs on at most 8 threads now, so any count from 8 up draws the
    8-thread init bitwise."""
    tc = tf.FieldConfig(grid=TGrid(n_levels=4, log2_hashmap_size=12),
                        sdf_hidden_dim=32, rgb_hidden_dim=16)
    threads = torch.get_num_threads()
    draws = []
    try:
        for n in (8, 13, 32):
            torch.set_num_threads(n)
            draws.append(tree_leaves(tf.init_field(torch.Generator().manual_seed(0), tc)))
            assert torch.get_num_threads() == n
    finally:
        torch.set_num_threads(threads)
    for other in draws[1:]:
        assert all(torch.equal(a, b) for a, b in zip(draws[0], other))
