"""The port's training step with the learned camera group held against
``neus2_tpu``'s: each knob alone (extrinsics, exposure, focal length,
envmap, distortion grid, latent codes, per-ray max level, depth
supervision), all of them together, and error-map sampling with pose and
exposure refinement, for three steps.

Both packages start from the same state: a JAX state after its prior
sweep and two steps with every knob off, given the knob's camera group
(the JAX package's own ``init_cam_params``, moved off the identity by
seeded noise so that every path sees a non-trivial value) and, for latent
codes, a field drawn with the wider RGB input; ``interop`` carries it
across.  The port gets every random number the JAX step draws
(``test_torch_train_step._step_draws`` and the per-ray max-level uniforms
at ``fold_in(k_march, 7)``).  The table-gradient sum is counted: once a
step.  Depth supervision and the per-ray max level put no camera leaf
into the loss: the group does not train with either alone.

Tolerances, fp32 on the CPU: the loss and aux of every step rtol 1e-5;
the error map within 1e-4 of its max (tests/test_torch_dynamic_step.py);
the field's params, EMA and Adam moments under the rule of
tests/test_torch_dynamic_step.py (every leaf within 1e-4 of its max
magnitude, a hash table on all but 0.5% of its entries and within one
Adam step); every camera leaf within 1e-5 of its max magnitude plus
0.01 cam_lr a step (an Adam step of a near-zero gradient is of order
cam_lr whatever the gradient's rounding), its moments within 1e-4 of
their max, and the Adam count exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.api.testbed import config_from_json as jax_config_from_json
from neus2_tpu.data.synthetic import SPHERE_CENTER, SPHERE_RADIUS, ray_sphere
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu.engine.rays import rays_for_image
from neus2_tpu.models.field import init_field as jax_init_field
from neus2_tpu.utils.optim import make_optimizer
from neus2_tpu_torch import interop
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.ops import hashgrid_fast
from test_torch_dynamic_step import _close, _same
from test_torch_train_step import _step_draws

torch.set_num_threads(2)
N_VIEWS, RES, STEPS = 4, 32, 3

KNOBS = {
    "extrinsics": dict(optimize_extrinsics=True),
    "exposure": dict(optimize_exposure=True),
    "focal": dict(optimize_focal_length=True),
    "envmap": dict(use_envmap=True, envmap_res=(8, 16)),
    "distortion": dict(use_distortion=True, distortion_res=(8, 8)),
    "latent": dict(latent_dim=4),
    "max_level": dict(max_level_rand_training=True),
    "depth": dict(depth_supervision_lambda=0.5),
}
KNOBS["all"] = {k: v for knob in KNOBS.values() for k, v in knob.items()}
# tests/test_error_map_cam.py:63: error-map sampling with pose and exposure.
KNOBS["error_map"] = dict(use_error_map=True, optimize_extrinsics=True, optimize_exposure=True)


def _shrink(cfg, latent_dim=0, **kw):
    grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
    field = dataclasses.replace(cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16,
                                latent_dim=latent_dim)
    return dataclasses.replace(cfg, field=field, n_rays=64, samples_per_ray=16,
                               n_candidates=32, occ_n_probe=1 << 15, **kw)


def _configs(**kw):
    return (_shrink(jax_config_from_json("configs/base.json")[0], **kw),
            _shrink(config_from_json("configs/base.json")[0], **kw))


def _gt_depths(jcams):
    """Analytic depth maps of the sphere scene, 0 where a ray misses."""
    out = []
    for i in range(N_VIEWS):
        o, d = rays_for_image(jcams, i)
        hit, t = ray_sphere(np.asarray(o), np.asarray(d), SPHERE_CENTER, SPHERE_RADIUS)
        out.append(np.where(hit, t, 0.0).reshape(RES, RES))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    """The JAX scene and a JAX state (knobs off) after its prior sweep and
    two steps."""
    jcfg, _ = _configs()
    ds = jax_sphere(n_views=N_VIEWS, resolution=RES, seed=0)
    images = jnp.asarray(ds.images)
    jcams = JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                     (RES, RES))
    state = jt.init_train_state(jax.random.PRNGKey(0), jcfg, N_VIEWS)
    state = jt.occupancy_prior_sweep(state, jcfg)
    for _ in range(2):
        state = jt.occupancy_update(state, jcfg)
        state, _ = jt.train_step(state, images, jcams, jcfg)
    t_images, t_cams = make_sphere_dataset(N_VIEWS, RES, seed=0).to_device("cpu")
    depths = _gt_depths(jcams)
    return dict(images=images, jcams=jcams, state=jax.device_get(state), t_images=t_images,
                t_cams=t_cams, depths=depths)


def _with_cam(host, jcfg, seed=0):
    """``host`` with ``jcfg``'s camera group, moved off the identity, its
    fresh Adam, and a field of ``jcfg``'s width."""
    rng = np.random.default_rng(seed)
    cam = {k: np.asarray(v) for k, v in jt.init_cam_params(N_VIEWS, jcfg).items()}
    noise = {"rot6d": 0.01, "trans": 0.005, "exposure": 0.1, "focal_ln": 0.01,
             "distortion": 0.002, "latent": 0.1}
    for k, s in noise.items():
        if k in cam:
            cam[k] = (cam[k] + rng.normal(0.0, s, cam[k].shape)).astype(np.float32)
    if "envmap" in cam:
        cam["envmap"] = (cam["envmap"] + rng.uniform(0.0, 0.3, cam["envmap"].shape)
                         ).astype(np.float32)
    host = host._replace(cam=cam, cam_opt_state=jax.device_get(
        jt.make_cam_optimizer(jcfg).init(jax.tree_util.tree_map(jnp.asarray, cam))))
    if jcfg.field.latent_dim:
        params = jax.device_get(jax_init_field(jax.random.PRNGKey(5), jcfg.field))
        host = host._replace(
            params=params, ema_params=params,
            opt_state=jax.device_get(make_optimizer(jcfg.optim).init(params)))
    return host


def _draws(key, jcfg, tcfg):
    """The port's draws of the JAX step at ``key`` -> (draws, next key)."""
    draws, k_step, key = _step_draws(key, tcfg, N_VIEWS)
    if jcfg.max_level_rand_training:
        _, k_march, _, _ = jax.random.split(k_step, 4)
        u = jax.random.uniform(jax.random.fold_in(k_march, 7), (jcfg.n_rays,))
        draws = draws._replace(max_level_u=torch.from_numpy(np.array(u)))
    return draws, key


def _close_cam(ref, got, lr_steps):
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].numpy()
        bound = 1e-5 * np.abs(a).max() + 0.01 * lr_steps
        assert np.abs(b - a).max() <= bound, (k, np.abs(b - a).max(), bound)


@pytest.fixture
def calls(monkeypatch):
    n = [0]
    real = hashgrid_fast.segment_dense_sum_multi

    def counted(*a, **kw):
        n[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(hashgrid_fast, "segment_dense_sum_multi", counted)
    return n


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_camera_steps_match_jax(base, knob, calls):
    jcfg, tcfg = _configs(**KNOBS[knob])
    host = _with_cam(base["state"], jcfg)
    depths = base["depths"] if jcfg.depth_supervision_lambda > 0 else None
    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    tstate = interop.train_state_from_jax(host)
    assert sorted(tstate.cam) == sorted(host.cam)
    key = host.key
    calls[0] = 0
    for i in range(STEPS):
        draws, key = _draws(key, jcfg, tcfg)
        jstate, jaux = jt.train_step(jstate, base["images"], base["jcams"], jcfg,
                                     depths=None if depths is None else jnp.asarray(depths))
        tstate, taux = tt.train_step(tstate, base["t_images"], base["t_cams"], tcfg, draws=draws,
                                     depths=None if depths is None else torch.from_numpy(depths))
        for f in jt.StepAux._fields:
            np.testing.assert_allclose(float(getattr(taux, f)), float(getattr(jaux, f)),
                                       rtol=1e-5, err_msg=f"step {i} {f}")
        if i in (0, STEPS - 1):
            jhost = jax.device_get(jstate)
            _close_cam(jhost.cam, tstate.cam, tcfg.cam_lr * (i + 1))
            jopt = jhost.cam_opt_state[0]
            for key_ in ("mu", "nu"):
                _close(getattr(jopt, key_), tstate.cam_opt_state[key_])
            n_cam = i + 1 if tt.wants_cam_training(tcfg) else 0
            assert tstate.cam_opt_state["count"] == int(jopt.count) == n_cam
            _close(jhost.params, tstate.params, params=True)
            _close(jhost.ema_params, tstate.ema_params, params=True)
            for key_ in ("mu", "nu"):
                _close(jhost.opt_state[key_], tstate.opt_state[key_])
            _same(jhost.opt_state["steps"], tstate.opt_state["steps"])
            if jcfg.use_error_map:
                ref = np.asarray(jhost.error_map.error_map)
                got = tstate.error_map.error_map.numpy()
                assert ref.any() and np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert calls[0] == STEPS
    # Each leaf the knob puts into the loss moved; the others did not.
    live = tt.cam_leaves_in_loss(tcfg)
    for k, v in host.cam.items():
        moved = not np.array_equal(tstate.cam[k].numpy(), v)
        assert moved == (k in live), k


def test_refinement_leaves_the_camera_group(base, calls):
    """Pose refinement (the delta alone) neither differentiates nor steps
    the camera group, which the delta could trade against."""
    jcfg, tcfg = _configs(**KNOBS["all"])
    host = _with_cam(base["state"], jcfg)
    refine = dict(train_canonical=False, train_delta=True, use_delta=True)
    jr = dataclasses.replace(jcfg, n_rays=32, hit_oversample=1)
    tr = dataclasses.replace(tcfg, n_rays=32, hit_oversample=1)
    draws, _ = _draws(host.key, jr, tt.phase_config(tr, False, True))
    jnew, jaux = jt.train_step(jax.tree_util.tree_map(jnp.asarray, host), base["images"],
                               base["jcams"], jr, **refine)
    calls[0] = 0
    tnew, taux = tt.train_step(interop.train_state_from_jax(host), base["t_images"],
                               base["t_cams"], tr, draws=draws, **refine)
    assert calls[0] == 0
    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)
    _same(host.cam, tnew.cam)
    assert tnew.cam_opt_state["count"] == 0
    _close(jax.device_get(jnew).delta, tnew.delta)


def test_camera_gradients_match_jax(base):
    """The camera group's gradients with every knob on, against jax.grad of
    the same loss (the leaves the config puts into the loss)."""
    jcfg, tcfg = _configs(**KNOBS["all"])
    host = _with_cam(base["state"], jcfg, seed=1)
    draws, k_step, _ = _step_draws(host.key, tcfg, N_VIEWS)
    _, k_march, _, _ = jax.random.split(k_step, 4)
    u = jax.random.uniform(jax.random.fold_in(k_march, 7), (jcfg.n_rays,))
    draws = draws._replace(max_level_u=torch.from_numpy(np.array(u)))
    jst = jax.tree_util.tree_map(jnp.asarray, host)
    grad_fn = jax.jit(lambda diff, st, k, d: jax.value_and_grad(jt._forward_loss, has_aux=True)(
        diff, st, base["images"], base["jcams"], k, jcfg, False, d))
    (_, (jaux, _)), jg = grad_fn({"params": jst.params, "cam": jst.cam}, jst, k_step,
                                 jnp.asarray(base["depths"]))
    tstate = interop.train_state_from_jax(host)
    tg, taux, _ = tt.loss_and_grads({"params": tstate.params, "cam": tstate.cam}, tstate,
                                    base["t_images"], base["t_cams"], draws, tcfg,
                                    depths=torch.from_numpy(base["depths"]))
    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)
    for k in sorted(host.cam):
        a, b = np.asarray(jg["cam"][k]), tg["cam"][k].numpy()
        assert np.abs(a).max() > 0, k
        assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max(), (k, np.abs(b - a).max())
    _close(jg["params"], tg["params"])
