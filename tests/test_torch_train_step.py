"""The port's static training step held against ``neus2_tpu``'s.

Both packages start from the same state (the JAX one after its prior
sweep and two steps, converted by ``interop``), and the port gets exactly
the random numbers the JAX step draws: the test reproduces train.py's key
splits (train_step :741, _forward_loss :401, :415-417, :438, :535, :562)
and occupancy_update's (:853).

Tolerances, fp32 on the CPU: loss and aux rtol 1e-5; every gradient leaf
within 1e-4 of its reference max magnitude (sums over samples run in
another order than XLA's), and so are the new params, Adam moments and
EMA (a moment of a near-zero table gradient carries that gradient's
rounding);
step counters and occupancy bits exactly.  ``clip`` reproduces
``jnp.clip``'s gradient at ties, so no tolerance is widened for it.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.api.testbed import config_from_json as jax_config_from_json
from neus2_tpu.data.synthetic import make_multi_sphere_dataset as jax_multi_sphere
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu_torch import interop
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data.synthetic import make_multi_sphere_dataset, make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.engine.rays import Cameras
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
N_VIEWS, RES = 4, 32


def _shrink(cfg):
    grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
    field = dataclasses.replace(cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16)
    return dataclasses.replace(
        cfg, field=field, n_rays=64, samples_per_ray=16, n_candidates=32,
        occ_n_probe=1 << 15,
    )


@pytest.mark.parametrize("name", ["base.json", "l4f8.json", "tpu_opt.json"])
def test_config_from_json_matches(name):
    tc, th = config_from_json(f"configs/{name}")
    jc, jh = jax_config_from_json(f"configs/{name}")
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    assert dataclasses.asdict(tc.field.grid) == dataclasses.asdict(jc.field.grid)
    for f in dataclasses.fields(tc.field):
        if f.name != "grid":
            assert getattr(tc.field, f.name) == getattr(jc.field, f.name), f.name
    for f in dataclasses.fields(tc.optim):
        assert getattr(tc.optim, f.name) == getattr(jc.optim, f.name), f.name
    for f in dataclasses.fields(tc):
        if f.name not in ("field", "optim"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.ek_loss_weight == (0.01 if name == "base.json" else jc.ek_loss_weight)
    # The dynamic scenes' learning rates: the next frames' and the delta's
    # ("globalmove").
    assert tc.optim.after_learning_rate == jc.optim.after_learning_rate == 1e-3
    assert tc.delta_lr == jc.delta_lr == 1e-4


def test_synthetic_scene_matches():
    a = make_sphere_dataset(n_views=N_VIEWS, resolution=RES, seed=3)
    b = jax_sphere(n_views=N_VIEWS, resolution=RES, seed=3)
    for k in ("images", "poses", "focal", "principal"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _step_draws(key, cfg, n_images):
    """The draws of one JAX train_step, in the port's StepDraws layout:
    pixels uniformly or, with the error map, its uniforms and jitter
    (error_map.sample_pixels :183); the probe and sample draws in the
    compaction's split order or march_rays' (march.py:240)."""
    key, k_step = jax.random.split(key)
    return _forward_draws(k_step, cfg, n_images), k_step, key


def _forward_draws(k_step, cfg, n_images):
    """The draws ``_forward_loss`` makes from the key it is given."""
    R, S = cfg.n_rays, cfg.samples_per_ray
    C = R * cfg.hit_oversample
    k_pix, k_march, k_bg, k_drop = jax.random.split(k_step, 4)
    k_a, k_b = jax.random.split(k_pix)
    if cfg.hit_oversample > 1:
        k_probe, k_draw = jax.random.split(k_march)
    else:
        k_draw, k_probe = jax.random.split(k_march)
    t = lambda a: torch.from_numpy(np.array(a))
    pixels = dict(img_idx=t(jax.random.randint(k_a, (C,), 0, n_images)).long(),
                  uv0=t(jax.random.uniform(k_b, (C, 2))))
    if cfg.use_error_map:
        pixels = dict(img_idx=None, uv0=None, em_u=t(jax.random.uniform(k_a, (C,))),
                      em_jitter=t(jax.random.uniform(k_b, (C, 2))))
    return tt.StepDraws(
        probe_u=t(jax.random.uniform(k_probe, (C, cfg.n_candidates))),
        xi=t(jax.random.uniform(k_draw, (R, S))),
        bg=t(jax.random.uniform(k_bg, (C, 3))),
        drop_u=t(jax.random.uniform(k_drop, (C,))),
        **pixels,
    )


def _close_tree(a_tree, b_leaves, rel):
    """Every leaf within ``rel`` of its reference max magnitude."""
    a_leaves = jax.tree_util.tree_leaves(a_tree)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(b.detach().numpy() - a).max() <= rel * max(np.abs(a).max(), 1e-12)


def _start(name, derive=lambda cfg: cfg, scene=None):
    jcfg = derive(_shrink(jax_config_from_json(f"configs/{name}")[0]))
    tcfg = derive(_shrink(config_from_json(f"configs/{name}")[0]))
    scene = scene or jax_sphere(n_views=N_VIEWS, resolution=RES, seed=0)
    images = jnp.asarray(scene.images)
    cams = JCameras(jnp.asarray(scene.poses), jnp.asarray(scene.focal),
                    jnp.asarray(scene.principal), (RES, RES))
    state = jt.init_train_state(jax.random.PRNGKey(0), jcfg, N_VIEWS)
    state = jt.occupancy_prior_sweep(state, jcfg)
    for _ in range(2):  # a non-initial Adam state and occupancy
        state = jt.occupancy_update(state, jcfg)
        state, _ = jt.train_step(state, images, cams, jcfg)
    state = jax.device_get(state)
    return jcfg, tcfg, scene, images, cams, state


@pytest.fixture(scope="module")
def start():
    return _start("base.json")


@pytest.fixture(scope="module", params=["tpu_opt.json", "l4f8.json"])
def wide_start(request):
    """The repo's wider-row configurations, shrunk as ``_shrink`` does
    with their features per level kept (4 and 8)."""
    return _start(request.param)


# tests/test_cascades.py's scene: a sphere in the unit cube and one outside it.
SPHERES = [(np.array([0.5, 0.5, 0.5], np.float32), 0.25),
           (np.array([1.25, 0.5, 0.5], np.float32), 0.3)]


def _derive_for(aabb_scale):
    """What the Testbed derives for a scene of ``aabb_scale``
    (``_derive_config``: 1 + ceil(log2 S) cascades, the candidates times as
    many, capped at 512), with tests/test_cascades.py's init radius 0.2.
    The probe budget stays below a full sweep in 256 updates, so the prior
    sweep takes its 16-update branch (a full one probes 3-5 x 128^3 cells,
    too many for a CPU test)."""
    n_cascades = 1 + math.ceil(math.log2(aabb_scale))

    def derive(cfg):
        return dataclasses.replace(
            cfg, field=dataclasses.replace(cfg.field, init_radius=0.2), aabb_scale=aabb_scale,
            occ_cascades=n_cascades, n_candidates=min(512, cfg.n_candidates * n_cascades),
            occ_n_probe=1 << 14)
    return derive


@pytest.fixture(scope="module", params=[4, 16])
def aabb_start(request):
    scene = jax_multi_sphere(SPHERES, n_views=N_VIEWS, resolution=RES, cam_distance=2.6,
                             aabb_scale=request.param)
    return _start("base.json", _derive_for(request.param), scene)


def _to_torch(state):
    occ = state.occupancy
    return interop.state_from_jax(
        state.params, state.ema_params, state.opt_state,
        (occ.density, occ.bitfield, occ.ema_step), state.step, state.frame_step,
    )


def test_train_step_matches_jax(start):
    _step_matches_jax(*start)


def test_train_step_matches_jax_at_wider_rows(wide_start):
    """tpu_opt.json (F=4) and l4f8.json (F=8): the loss, aux and gradients
    under base.json's tolerances; the new params, EMA and moments under
    tests/test_torch_dynamic_step.py's rule, which base.json's step also
    meets: a hash table's entries within 1e-4 of its max on all but 0.5% of
    them, and its params within one Adam step (the learning rate 1e-3).  A
    table entry whose gradient is rounding noise takes an Adam step of
    either sign (a few of l4f8's level-1 entries do, on the CPU)."""
    jcfg, tcfg = wide_start[:2]
    assert tcfg.field.grid.n_features_per_level in (4, 8)
    assert dataclasses.asdict(tcfg.field.grid) == dataclasses.asdict(jcfg.field.grid)
    _step_matches_jax(*wide_start, tables_rule=True)


def test_train_step_matches_jax_at_aabb_scale(aabb_start):
    """A scene larger than the unit cube (aabb_scale 4: 3 cascades, 96
    candidates; 16: 5 cascades, 160), both spheres of
    tests/test_cascades.py: the multi-cascade probe and lookup, the
    exponential candidate spacing of the cone angle and the warp-metric dt
    in the step, and the occupancy update after it.  The loss, aux and
    gradients under base.json's tolerances; the new params, EMA and
    moments under the tables rule of
    ``test_train_step_matches_jax_at_wider_rows``; the occupancy density
    after it rtol 5e-4, atol 1e-6, as tests/test_torch_testbed_dynamic.py
    holds it: the logistic density s sig (1 - sig) loses digits to the
    difference 1 - sig, so one ulp of the packages' sigmoids moves it by
    2^-24 / (1 - sig), ~2e-4 relative at s sdf ~ 8, where a probe of the
    outer cascades lands (seen: 2.9e-4); the bits exactly."""
    jcfg, tcfg, scene = aabb_start[:3]
    assert tcfg.cone_angle == 1.0 / 256 and tcfg.occ_cascades in (3, 5)
    ds = make_multi_sphere_dataset(SPHERES, n_views=N_VIEWS, resolution=RES, cam_distance=2.6,
                                   aabb_scale=tcfg.aabb_scale)
    assert ds.aabb_scale == scene.aabb_scale == tcfg.aabb_scale
    for k in ("images", "poses", "focal", "principal"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(scene, k))
    _step_matches_jax(*aabb_start, tables_rule=True, density_rtol=5e-4)


def _step_matches_jax(jcfg, tcfg, scene, images, cams, state, tables_rule=False,
                      density_rtol=1e-4):
    tstate = _to_torch(state)
    t_images = torch.from_numpy(np.asarray(scene.images))
    t_cams = Cameras(*(torch.from_numpy(np.asarray(a))
                       for a in (scene.poses, scene.focal, scene.principal)), (RES, RES))
    draws, k_step, _ = _step_draws(state.key, tcfg, N_VIEWS)

    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    grad_fn = jax.jit(lambda diff, st, k: jax.value_and_grad(jt._forward_loss, has_aux=True)(
        diff, st, images, cams, k, jcfg, False
    ))
    (_, (jaux, _)), jgrads = grad_fn({"params": jstate.params}, jstate, k_step)
    tgrads, taux, _ = tt.loss_and_grads({"params": tstate.params}, tstate, t_images, t_cams,
                                        draws, tcfg)
    for f in jt.StepAux._fields:
        np.testing.assert_allclose(
            float(getattr(taux, f)), float(getattr(jaux, f)), rtol=1e-5, err_msg=f
        )
    assert 0 < int(taux.n_valid_samples) <= tcfg.n_rays * tcfg.samples_per_ray
    jg = jax.tree_util.tree_leaves(jgrads["params"])
    tg = tree_leaves(tgrads["params"])
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-4 * max(np.abs(a).max(), 1e-12)

    jnew, jaux2 = jt.train_step(jstate, images, cams, jcfg)
    jnew = jax.device_get(jnew)
    tnew, _ = tt.train_step(tstate, t_images, t_cams, tcfg, draws=draws)
    assert tnew.step == int(jnew.step) and tnew.frame_step == int(jnew.frame_step)
    np.testing.assert_allclose(float(jaux2.loss), float(taux.loss), rtol=1e-5)
    if tables_rule:
        from test_torch_dynamic_step import _close  # it imports this module

        _close(jnew.params, tnew.params, params=True)
        _close(jnew.ema_params, tnew.ema_params, params=True)
        for key in ("mu", "nu"):
            _close(jnew.opt_state[key], tnew.opt_state[key])
    else:
        _close_tree(jnew.params, tree_leaves(tnew.params), 1e-4)
        _close_tree(jnew.ema_params, tree_leaves(tnew.ema_params), 1e-4)
        for key in ("mu", "nu"):
            _close_tree(jnew.opt_state[key], tree_leaves(tnew.opt_state[key]), 1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jnew.opt_state["steps"]),
                    tree_leaves(tnew.opt_state["steps"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tnew.opt_state["count"] == int(jnew.opt_state["count"])

    # The occupancy update that follows, with its jitter injected.
    _, k_probe = jax.random.split(jnew.key)
    jitter = torch.from_numpy(np.array(jax.random.uniform(k_probe, (tcfg.occ_n_probe, 3))))
    jocc = jax.device_get(jt.occupancy_update(jax.tree_util.tree_map(jnp.asarray, jnew), jcfg))
    tocc = tt.occupancy_update(tnew, tcfg, jitter=jitter)
    np.testing.assert_allclose(tocc.occupancy.density.numpy(),
                               np.asarray(jocc.occupancy.density), rtol=density_rtol, atol=1e-6)
    np.testing.assert_array_equal(tocc.occupancy.bitfield.numpy(),
                                  np.asarray(jocc.occupancy.bitfield))
    assert tocc.occupancy.ema_step == int(jocc.occupancy.ema_step)


def test_train_static_cpu_five_steps():
    tcfg = dataclasses.replace(_shrink(config_from_json("configs/base.json")[0]),
                               occ_n_probe=4096)
    images, cams = make_sphere_dataset(N_VIEWS, RES, seed=1).to_device("cpu")
    state = tt.init_train_state(tcfg, N_VIEWS, seed=1, device="cpu")
    state = tt.occupancy_prior_sweep(state, tcfg)
    assert state.occupancy.bitfield.any()
    auxes = []
    state = tt.train_static(state, images, cams, tcfg, 5, log_every=1,
                            log_fn=lambda step, aux: auxes.append(aux))
    assert state.step == 5 and len(auxes) == 5
    assert all(np.isfinite(float(a.loss)) for a in auxes)
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))
