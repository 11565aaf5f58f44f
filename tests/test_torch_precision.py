"""bf16 compute in the port held against ``neus2_tpu``'s
(``FieldConfig.compute_dtype``): the encoder's backward, ``apply_mlp``,
``sdf_normal_features`` and three training steps, each on the same seeded
inputs as the JAX package's bf16 path, and the config conversion that maps
``jnp.bfloat16`` to ``torch.bfloat16``.

The port rounds each operand to bf16 and multiplies in fp32
(``utils/device.py::round_operand``): a bf16 x bf16 product is exact in
fp32, so a forward differs from JAX's ``preferred_element_type=f32``
product only in summation order, and a gradient by a bf16 rounding that the
order flips.  Tolerances, on the CPU: forwards within 1e-4 of their max
magnitude (a hidden activation that the order moves across a bf16
rounding boundary moves the output by 1e-5 of it; bf16 itself moves it by
1e-2); gradients within 1e-2 of their max (one bf16 ulp is 2^-8 =
3.9e-3 of a value); the encoder's bf16 backward within 2e-2 of the fp32
one (JAX's own gate, tests/test_hashgrid_fast.py:124); a step's loss and
aux rtol 1e-4, and after three steps every param and EMA leaf within 1e-4
of its max magnitude, but a hash table within one Adam step (the learning
rate) on every entry: a table entry whose gradient cancels to near zero
takes an Adam step of about the learning rate whatever its sign, and a
bf16 rounding can flip that sign (5-15% of the dense levels' entries, up
to 0.4 of a step).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.api.testbed import config_from_json as jax_config_from_json
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu.models import field as jf
from neus2_tpu.models import mlp as jmlp
from neus2_tpu.ops import hashgrid_fast as jhf
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.models import mlp as tmlp
from neus2_tpu_torch.ops import hashgrid_fast as thf
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.utils.tree import tree_leaves
from test_torch_train_step import _step_draws

torch.set_num_threads(2)
BF16 = torch.bfloat16


def _rel(got, ref) -> float:
    got, ref = (t.detach().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)
                for t in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("f", [2, 8])
def test_encoder_bf16_backward_matches_jax(f):
    """The gradients of sum(feat^2) + sum(jac^2) wrt the tables and the
    positions: bf16 against JAX's bf16 (1e-2), and against the port's
    fp32 (JAX's 2e-2 gate); the forward stays fp32, bitwise the fp32
    path's."""
    grid = dict(n_levels=4, n_features_per_level=f, log2_hashmap_size=12, base_resolution=8,
                per_level_scale=1.5)
    jcfg, tcfg = JGrid(**grid), TGrid(**grid)
    tables = [np.array(t) * 1e4 for t in jhf.init_hashgrid_tables(jax.random.PRNGKey(0), jcfg)]
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (256, 3)))

    def jgrads(dtype):
        fn = jhf.make_encode_jac(jcfg, compute_dtype=dtype)

        def loss(tb, xx):
            feat, jac = fn(tb, xx)
            return jnp.sum(feat**2) + jnp.sum(jac**2)

        return jax.grad(loss, argnums=(0, 1))(tuple(map(jnp.asarray, tables)), jnp.asarray(x))

    def tgrads(dtype):
        tb = [torch.from_numpy(t).requires_grad_(True) for t in tables]
        xx = torch.from_numpy(x).requires_grad_(True)
        feat, jac = thf.make_encode_jac(tcfg, dtype)(tb, xx)
        g = torch.autograd.grad((feat**2).sum() + (jac**2).sum(), [*tb, xx])
        return (feat, jac), g

    (f16, j16), g16 = tgrads(BF16)
    (f32, j32), g32 = tgrads(None)
    assert torch.equal(f16, f32) and torch.equal(j16, j32)
    ref16 = jax.tree_util.tree_leaves(jgrads(jnp.bfloat16))
    for got, ref, full in zip(g16, ref16, g32):
        assert _rel(got, ref) <= 1e-2
        assert _rel(got, full) < 2e-2
        assert not torch.equal(got, full)  # the bf16 path ran


def test_encoder_matches_reference_oracle():
    """The encoder's features and Jacobian against the plain per-corner
    oracle ``encode_jac_reference`` (JAX :317), and the oracle against
    JAX's."""
    grid = dict(n_levels=3, log2_hashmap_size=11, base_resolution=4, per_level_scale=2.0)
    tables = [np.array(t) * 1e3 for t in jhf.init_hashgrid_tables(jax.random.PRNGKey(0),
                                                                   JGrid(**grid))]
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (48, 3), minval=0.05, maxval=0.95))
    tt_ = [torch.from_numpy(t) for t in tables]
    feat, jac = thf.make_encode_jac(TGrid(**grid))(tt_, torch.from_numpy(x))
    rfeat, rjac = thf.encode_jac_reference(tt_, torch.from_numpy(x), TGrid(**grid))
    jfeat, jjac = jhf.encode_jac_reference(tuple(map(jnp.asarray, tables)), jnp.asarray(x),
                                           JGrid(**grid))
    np.testing.assert_allclose(feat.numpy(), rfeat.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), rjac.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rfeat.numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rjac.numpy(), np.asarray(jjac), rtol=1e-4, atol=1e-4)


def test_apply_mlp_bf16_matches_jax():
    """The bf16 MLP (rounded operands, fp32 sums and bias, fp32 out) and
    its gradients wrt the input, weights and biases, against JAX's."""
    params = jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(0), 19, 32, 2, 5))
    params["layers"][0]["b"] = np.linspace(-0.2, 0.2, 32, dtype=np.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (128, 19)))
    coef = np.array(jax.random.normal(jax.random.PRNGKey(2), (128, 5)))

    def jloss(p, xx):
        return jnp.sum(jmlp.apply_mlp(p, xx, dtype=jnp.bfloat16) * coef)

    jout = jmlp.apply_mlp(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                          dtype=jnp.bfloat16)
    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params),
                                         jnp.asarray(x))
    p = interop.tree_to_torch(params)
    p = {"layers": [{k: v.requires_grad_(True) for k, v in l.items()} for l in p["layers"]]}
    xx = torch.from_numpy(x).requires_grad_(True)
    out = tmlp.apply_mlp(p, xx, BF16)
    assert out.dtype == torch.float32
    assert _rel(out, jout) <= 1e-4
    assert _rel(tmlp.apply_mlp(p, xx), jout) > 1e-4  # bf16 is not fp32
    g = torch.autograd.grad((out * torch.from_numpy(coef)).sum(), [*tree_leaves(p), xx])
    ref = [*jax.tree_util.tree_leaves(jg[0]), jg[1]]
    for got, r in zip(g, ref):
        assert _rel(got, r) <= 1e-2


def _field_pair(dtype):
    grid = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=1.5)
    jc = jf.FieldConfig(grid=JGrid(**grid), sdf_hidden_dim=32, rgb_hidden_dim=32,
                        compute_dtype=dtype)
    return jc, interop.config_from_jax(jc)


def test_sdf_normal_features_bf16_matches_jax():
    """sdf, normal (the tangent pass rounded as jax.linearize of the bf16
    MLP rounds it) and features, and the gradients of a weighted sum of all
    three wrt every param, against JAX's bf16 field."""
    jc, tc = _field_pair(jnp.bfloat16)
    assert tc.compute_dtype is BF16
    p = jax.device_get(jf.init_field(jax.random.PRNGKey(0), jc))
    p["hashgrid"] = tuple(t * 1e3 for t in p["hashgrid"])
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (256, 3), minval=0.1, maxval=0.9))
    c = [np.array(jax.random.normal(jax.random.PRNGKey(2 + i), s))
         for i, s in enumerate([(256,), (256, 3), (256, tc.sdf_out_dim)])]

    def jloss(pp):
        outs = jf.sdf_normal_features(pp, jnp.asarray(x), jc)
        return sum(jnp.sum(o * ci) for o, ci in zip(outs, c)), outs

    (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p))
    tp = interop.tree_to_torch(interop.params_from_jax(p))
    live = [t.requires_grad_(True) for t in tree_leaves(tp)]
    outs = tf.sdf_normal_features(tp, torch.from_numpy(x), tc)
    for o, r in zip(outs, jouts):
        assert _rel(o, r) <= 1e-4
    f32 = tf.sdf_normal_features(tp, torch.from_numpy(x), dataclasses.replace(tc,
                                                                             compute_dtype=None))
    assert _rel(outs[1], f32[1]) > 1e-4  # the bf16 normal is not the fp32 one
    g = torch.autograd.grad(sum((o * torch.from_numpy(ci)).sum() for o, ci in zip(outs, c)),
                            live, allow_unused=True)  # the RGB MLP and the variance
    for got, ref in zip(g, jax.tree_util.tree_leaves(jg)):
        assert _rel(torch.zeros(ref.shape) if got is None else got, ref) <= 1e-2


def test_bf16_steps_match_jax():
    """Three training steps with bf16 compute against the JAX package's,
    its draws injected, from the same state."""
    def shrink(cfg):
        grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
        return dataclasses.replace(cfg, field=dataclasses.replace(
            cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16,
            compute_dtype=jnp.bfloat16), n_rays=64, samples_per_ray=16, n_candidates=32,
            occ_n_probe=1 << 15)

    jcfg = shrink(jax_config_from_json("configs/base.json")[0])
    tcfg = interop.config_from_jax(jcfg)
    assert tcfg.field.compute_dtype is BF16 and tcfg.n_rays == 64
    ds = jax_sphere(n_views=4, resolution=32, seed=0)
    images = jnp.asarray(ds.images)
    jcams = JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                     (32, 32))
    state = jt.init_train_state(jax.random.PRNGKey(0), jcfg, 4)
    state = jt.occupancy_prior_sweep(state, jcfg)
    state = jt.occupancy_update(state, jcfg)
    host = jax.device_get(state)
    t_images, t_cams = make_sphere_dataset(4, 32, seed=0).to_device("cpu")
    jstate, tstate = state, interop.train_state_from_jax(host)
    key = host.key
    for i in range(3):
        draws, _, key = _step_draws(key, tcfg, 4)
        jstate, jaux = jt.train_step(jstate, images, jcams, jcfg)
        tstate, taux = tt.train_step(tstate, t_images, t_cams, tcfg, draws=draws)
        for f in jt.StepAux._fields:
            np.testing.assert_allclose(float(getattr(taux, f)), float(getattr(jaux, f)),
                                       rtol=1e-4, err_msg=f"step {i} {f}")
    jhost = jax.device_get(jstate)
    for ref, got in ((jhost.params, tstate.params), (jhost.ema_params, tstate.ema_params)):
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for (path, a), b in zip(flat, tree_leaves(got), strict=True):
            name, a, b = jax.tree_util.keystr(path), np.asarray(a), b.detach().numpy()
            bound = tcfg.optim.learning_rate if "hashgrid" in name else 1e-4 * np.abs(a).max()
            assert np.abs(b - a).max() <= bound, name


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_config_from_jax_maps_compute_dtype(dtype):
    """``interop.config_from_jax`` of base.json's JAX config equals the
    port's ``config_from_json`` of the same file, with ``compute_dtype``
    mapped (jnp.bfloat16 -> torch.bfloat16, None -> None)."""
    jcfg = jax_config_from_json("configs/base.json")[0]
    tcfg = config_from_json("configs/base.json")[0]
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, field=dataclasses.replace(jcfg.field,
                                                                   compute_dtype=jnp.bfloat16))
        tcfg = dataclasses.replace(tcfg, field=dataclasses.replace(tcfg.field, compute_dtype=BF16))
    assert interop.config_from_jax(jcfg) == tcfg
