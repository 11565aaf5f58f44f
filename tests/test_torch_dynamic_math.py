"""Port parity of the dynamic scenes' math: the 6D rotation helpers, the
per-frame delta and the accumulated transform, and the residual hash grid
of the field, each against ``neus2_tpu`` on the same numpy inputs.

Tolerances (fp32): rotations, transforms and positions within 1e-6 abs
(values of order 1; ``accumulate_delta`` against the maps applied one after
another within 2e-6, two roundings more); the residual-grid field's outputs
rtol 1e-5 (atol 1e-6), its parameter gradients within 1e-4 of each leaf's
reference max magnitude, as in tests/test_torch_field.py; the freeze
exactly (a sum of two floats on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.models import delta as jdelta
from neus2_tpu.models import field as jf
from neus2_tpu.ops import rotation as jrot
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.models import delta as tdelta
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.ops import rotation as trot
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
T = torch.from_numpy


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _rand_delta(rng):
    """A non-identity delta: a perturbed 6D identity and a small shift."""
    return {"rotation6d": (np.array([1, 0, 0, 0, 1, 0], np.float32)
                           + rng.normal(0, 0.2, 6).astype(np.float32)),
            "transition": rng.normal(0, 0.05, 3).astype(np.float32)}


def _rand_acc(rng):
    d = _rand_delta(rng)
    return {"rotation": np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d["rotation6d"]))),
            "transition": d["transition"]}


def test_rotation_functions_match_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(5, 6)).astype(np.float32)
    jm = jrot.rotation_6d_to_matrix(jnp.asarray(d6))
    tm = trot.rotation_6d_to_matrix(T(d6))
    _close(tm, jm)
    eye = tm @ tm.transpose(-1, -2)
    _close(eye, np.broadcast_to(np.eye(3, dtype=np.float32), (5, 3, 3)))
    _close(trot.matrix_to_rotation_6d(tm), jrot.matrix_to_rotation_6d(jm))
    np.testing.assert_array_equal(trot.identity_6d().numpy(), np.asarray(jrot.identity_6d()))
    np.testing.assert_array_equal(trot.rotation_6d_to_matrix(trot.identity_6d()).numpy(),
                                  np.eye(3, dtype=np.float32))

    r, r2 = np.array(jm[0]), np.array(jm[1])
    t, t2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(7, 4, 3)).astype(np.float32)  # writable: T() shares it
    _close(trot.apply_rotation(T(r), T(pts)), jrot.apply_rotation(jnp.asarray(r), pts))
    _close(trot.apply_rigid(T(r), T(t), T(pts)),
           jrot.apply_rigid(jnp.asarray(r), jnp.asarray(t), pts))
    for got, ref in zip(trot.compose_rigid(T(r), T(t), T(r2), T(t2)),
                        jrot.compose_rigid(*map(jnp.asarray, (r, t, r2, t2)))):
        _close(got, ref)
    # Identity maps every vector to itself exactly (the static step's rays).
    np.testing.assert_array_equal(
        trot.apply_rotation(torch.eye(3), T(pts)).numpy(), pts)


@pytest.mark.parametrize("seed", [1, 5])
def test_delta_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    for a, b in zip(tree_leaves(tdelta.init_delta()),
                    jax.tree_util.tree_leaves(jdelta.init_delta())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(tdelta.init_accumulated()),
                    jax.tree_util.tree_leaves(jdelta.init_accumulated())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    delta, acc = _rand_delta(rng), _rand_acc(rng)
    td, ta = interop.tree_to_torch(delta), interop.tree_to_torch(acc)
    pos = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dir_w = (dirs + 1.0) * 0.5
    for got, ref in zip(tdelta.apply_delta(td, T(pos), T(dir_w)),
                        jdelta.apply_delta(delta, jnp.asarray(pos), jnp.asarray(dir_w))):
        _close(got, ref)
    for got, ref in zip(tdelta.apply_accumulated_to_rays(ta, T(pos), T(dirs)),
                        jdelta.apply_accumulated_to_rays(acc, jnp.asarray(pos),
                                                         jnp.asarray(dirs))):
        _close(got, ref)
    o, d = tdelta.apply_accumulated_to_rays(None, T(pos), T(dirs))
    assert o is not None and torch.equal(o, T(pos)) and torch.equal(d, T(dirs))
    jacc = jdelta.accumulate_delta(acc, delta)
    tacc = tdelta.accumulate_delta(ta, td)
    _close(tacc["rotation"], jacc["rotation"])
    _close(tacc["transition"], jacc["transition"])


def test_accumulate_delta_is_the_maps_one_after_another():
    """acc' applied to a point == the delta map x -> R_d (x + t_d) after the
    ray map x -> R_a x + t_a, over three frames folded in turn."""
    rng = np.random.default_rng(2)
    pts = T(rng.normal(size=(32, 3)).astype(np.float32))
    acc = tdelta.init_accumulated()
    want = pts.clone()
    for _ in range(3):
        delta = interop.tree_to_torch(_rand_delta(rng))
        rot = trot.rotation_6d_to_matrix(delta["rotation6d"])
        want = trot.apply_rotation(rot, want + delta["transition"])
        acc = tdelta.accumulate_delta(acc, delta)
        got = trot.apply_rigid(acc["rotation"], acc["transition"], pts)
        _close(got, want.numpy(), atol=2e-6)


_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16, residual_grid=True)


def _residual_params():
    """JAX residual-grid params with a nonzero base and residual."""
    jc = jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD)
    p = jf.init_field(jax.random.PRNGKey(3), jc)
    assert "hashgrid_base" in p
    rng = np.random.default_rng(3)
    p["hashgrid"] = tuple(np.asarray(t) * 1e3 for t in p["hashgrid"])
    p["hashgrid_base"] = tuple(rng.normal(0, 0.3, np.shape(t)).astype(np.float32)
                               for t in p["hashgrid"])
    return jc, jax.tree_util.tree_map(np.asarray, p)


def test_residual_grid_field_matches_jax():
    jc, pj = _residual_params()
    tc = tf.FieldConfig(grid=TGrid(**_GRID), **_FIELD)
    init = tf.init_field(torch.Generator().manual_seed(0), tc)
    assert [t.shape for t in init["hashgrid_base"]] == [t.shape for t in init["hashgrid"]]
    assert all(not t.any() for t in init["hashgrid_base"])

    rng = np.random.default_rng(4)
    n = 128
    x = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    c = [rng.normal(size=s).astype(np.float32) for s in ((n, 3), (n,), (n, 3))]

    def jloss(params):
        out = jf.field_forward(params, jnp.asarray(x), jnp.asarray(d), jc)
        return (jnp.sum(out.rgb * c[0]) + jnp.sum(out.sdf * c[1])
                + jnp.sum(out.normal * c[2]) + out.inv_s), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, pj))
    pt = interop.params_from_jax(pj)
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    tout = tf.field_forward(pt, T(x), T(d), tc)
    s = ((tout.rgb * T(c[0])).sum() + (tout.sdf * T(c[1])).sum()
         + (tout.normal * T(c[2])).sum() + tout.inv_s)
    tgrads = torch.autograd.grad(s, leaves, allow_unused=True)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, a, b in zip(paths, jax.tree_util.tree_leaves(jgrads), tgrads):
        a = np.asarray(a)
        if "hashgrid_base" in name:  # the base is out of autograd on both sides
            assert b is None and not a.any(), name
            continue
        assert np.abs(b.numpy() - a).max() <= 1e-4 * max(np.abs(a).max(), 1e-8), name

    # The frame switch's freeze: the base takes the residual, which restarts
    # at zero, and the field the lookups see is unchanged.
    frozen_j = jf.freeze_grid_into_base(pj)
    frozen_t = tf.freeze_grid_into_base(interop.params_from_jax(pj))
    for a, b in zip(jax.tree_util.tree_leaves(frozen_j), tree_leaves(frozen_t)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert all(not t.any() for t in frozen_t["hashgrid"])
    before, _ = tf.sdf_fn(interop.params_from_jax(pj), T(x), tc)
    after, _ = tf.sdf_fn(frozen_t, T(x), tc)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5, atol=1e-6)
    no_base = {k: v for k, v in frozen_t.items() if k != "hashgrid_base"}
    assert tf.freeze_grid_into_base(no_base) is no_base
