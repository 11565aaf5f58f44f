"""One port ``train_step`` against ``neus2_tpu``'s in each dynamic setting:
pose refinement (the delta alone, ``hit_oversample`` 1, ``delta_n_rays``),
finetune (field and delta, the delta applied), frame 0 with the error map
and its sharpness weighting, and the residual hash grid.

Both packages start from the same state (a JAX state after its prior sweep
and a step, with a non-identity delta and accumulated transform where
they matter, converted by ``interop``), and the port gets the random
numbers the JAX step draws (``test_torch_train_step._step_draws``).  The
table-gradient sum is counted with a wrapper: pure refinement makes no
call, every step that trains the field makes one.

Tolerances, fp32 on the CPU: loss and aux rtol 1e-5; every leaf of the
new params, EMA, Adam moments, delta and delta moments within 1e-4 of its
reference max magnitude, with the hash-table rule of
tests/test_torch_testbed_loop.py (all but 0.5% of a table's entries, and
its params within one Adam step: an entry whose gradient is rounding noise
takes a step of any size up to the learning rate); the delta's
gradient within 1e-4 of its max (a sum over every sample); counters,
occupancy bits and the leaves a phase must not touch exactly; the error
map within 1e-4 of its max (a deposit of per-ray losses equal to 1e-5)
and the sharpness grid exactly but for cells whose hit point lies within
1e-4 of a cell face.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.api.testbed import config_from_json as jax_config_from_json
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import error_map as jem
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu.ops.image import sharpness_maps as jax_sharpness_maps
from neus2_tpu_torch import interop
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.ops import hashgrid_fast
from neus2_tpu_torch.utils.tree import tree_leaves
from test_torch_train_step import _step_draws

torch.set_num_threads(2)
N_VIEWS, RES = 4, 32


def _shrink(cfg, residual=False, **kw):
    grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
    field = dataclasses.replace(cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16,
                                residual_grid=residual)
    return dataclasses.replace(cfg, field=field, n_rays=64, samples_per_ray=16,
                               n_candidates=32, occ_n_probe=1 << 15, delta_n_rays=32, **kw)


def _configs(**kw):
    return (_shrink(jax_config_from_json("configs/base.json")[0], **kw),
            _shrink(config_from_json("configs/base.json")[0], **kw))


@pytest.fixture(scope="module")
def scene():
    ds = jax_sphere(n_views=N_VIEWS, resolution=RES, seed=0)
    sharp = jax_sharpness_maps(ds.images)
    jcams = JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                     (RES, RES), sharpness=jnp.asarray(sharp))
    images, tcams = make_sphere_dataset(N_VIEWS, RES, seed=0).to_device("cpu")
    return jnp.asarray(ds.images), jcams, images, tcams._replace(sharpness=torch.from_numpy(sharp))


def _start(jcfg, scene, moved=False, emap=False):
    """A JAX state after the prior sweep and one step (host copy)."""
    images, jcams = scene[0], scene[1]
    state = jt.init_train_state(jax.random.PRNGKey(0), jcfg, N_VIEWS)
    state = jt.occupancy_prior_sweep(state, jcfg)
    if emap:  # a non-uniform CDF from a random window of losses
        em = np.random.default_rng(0).gamma(0.5, 1.0, state.error_map.error_map.shape)
        state = state._replace(error_map=jem.rebuild_cdf(
            state.error_map._replace(error_map=jnp.asarray(em, jnp.float32))
        )._replace(sharpness_grid=state.error_map.sharpness_grid))
    state, _ = jt.train_step(state, images, jcams, jcfg)
    if moved:  # a frame >= 1: a folded transform and a live delta
        state = state._replace(
            acc={"rotation": jnp.asarray(_rot(0.03)), "transition": jnp.array([0.01, -0.02, 0.0])},
            delta={"rotation6d": jnp.array([1.0, 0.02, 0.0, -0.02, 1.0, 0.01]),
                   "transition": jnp.array([-0.015, 0.005, 0.01])})
    return jax.device_get(state)


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _close(ref, got, params=False):
    """Each leaf within 1e-4 of its reference max magnitude; a hash table
    on all but 0.5% of its entries (tests/test_torch_testbed_loop.py's
    rule), and its params within one Adam step (the learning rate)."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    b_leaves = tree_leaves(got)
    assert len(flat) == len(b_leaves)
    for (path, a), b in zip(flat, b_leaves):
        name, a, b = jax.tree_util.keystr(path), np.asarray(a), b.detach().numpy()
        assert b.shape == a.shape, name
        diff = np.abs(b - a)
        bound = 1e-4 * max(np.abs(a).max(), 1e-12)
        if "hashgrid" not in name:
            assert diff.max() <= bound, name
            continue
        assert (diff > bound).mean() <= 0.005, name
        if params:
            assert diff.max() <= 1e-3, name


def _same(ref, got):
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(got)):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the table-gradient sum."""
    n = [0]
    real = hashgrid_fast.segment_dense_sum_multi

    def counted(*a, **kw):
        n[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(hashgrid_fast, "segment_dense_sum_multi", counted)
    return n


def _step(host, jcfg, tcfg, scene, **phase):
    """One JAX and one port step from ``host``, their aux compared ->
    (JAX state, port state, port start state, the port's draws)."""
    j_images, jcams, t_images, tcams = scene
    cfg = tt.phase_config(tcfg, phase.get("train_canonical", True), phase.get("train_delta", False))
    draws, _, _ = _step_draws(host.key, cfg, N_VIEWS)
    jnew, jaux = jt.train_step(jax.tree_util.tree_map(jnp.asarray, host), j_images, jcams,
                               jcfg, **phase)
    tstart = interop.train_state_from_jax(host)
    tnew, taux = tt.train_step(tstart, t_images, tcams, tcfg, draws=draws, **phase)
    for f in jt.StepAux._fields:
        np.testing.assert_allclose(float(getattr(taux, f)), float(getattr(jaux, f)),
                                   rtol=1e-5, err_msg=f)
    jnew = jax.device_get(jnew)
    assert (tnew.step, tnew.frame_step) == (int(jnew.step), int(jnew.frame_step))
    return jnew, tnew, tstart, draws


def _check_delta(jnew, tnew):
    _close(jnew.delta, tnew.delta)
    _close(jnew.delta_opt_state[0].mu, tnew.delta_opt_state["mu"])
    _close(jnew.delta_opt_state[0].nu, tnew.delta_opt_state["nu"])
    assert tnew.delta_opt_state["count"] == int(jnew.delta_opt_state[0].count)


def _check_field(jnew, tnew):
    _close(jnew.params, tnew.params, params=True)
    _close(jnew.ema_params, tnew.ema_params, params=True)
    for key in ("mu", "nu"):
        _close(jnew.opt_state[key], tnew.opt_state[key])
    _same(jnew.opt_state["steps"], tnew.opt_state["steps"])
    assert tnew.opt_state["count"] == int(jnew.opt_state["count"])


def test_refinement_then_finetune_match_jax(scene, calls):
    jcfg, tcfg = _configs(use_error_map=True)
    host = _start(jcfg, scene, moved=True)
    refine = dict(train_canonical=False, train_delta=True, use_delta=True)
    # The refinement batch the Testbed's _frame_config sets.
    jr = dataclasses.replace(jcfg, n_rays=jcfg.delta_n_rays, hit_oversample=1)
    tr = dataclasses.replace(tcfg, n_rays=tcfg.delta_n_rays, hit_oversample=1)

    # The delta's gradient alone, against jax.grad of the same loss.
    tstate = interop.train_state_from_jax(host)
    tr_eff = tt.phase_config(tr, train_canonical=False, train_delta=True)
    assert not tr_eff.use_error_map  # the error map is off in pure refinement
    draws, k_step, _ = _step_draws(host.key, tr_eff, N_VIEWS)
    jst = jax.tree_util.tree_map(jnp.asarray, host)
    (_, (jaux, _)), jg = jax.value_and_grad(jt._forward_loss, has_aux=True)(
        {"delta": jst.delta}, jst, scene[0], scene[1], k_step,
        dataclasses.replace(jr, use_error_map=False), True)
    calls[0] = 0
    tg, taux, _ = tt.loss_and_grads({"delta": tstate.delta}, tstate, scene[2], scene[3], draws,
                                    tr_eff, True)
    assert calls[0] == 0  # no table gradient in pure refinement
    assert set(tg) == {"delta"}
    _close(jg["delta"], tg["delta"])
    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)

    calls[0] = 0
    jnew, tnew, tstart, _ = _step(host, jr, tr, scene, **refine)
    assert calls[0] == 0
    _check_delta(jnew, tnew)
    assert not np.allclose(np.asarray(jnew.delta["transition"]), host.delta["transition"])
    # The field and its Adam stay; the EMA still moves (toward equal params).
    _same(host.params, tnew.params)
    _same(host.opt_state["mu"], tnew.opt_state["mu"])
    assert tnew.opt_state["count"] == int(host.opt_state["count"])
    _close(jnew.ema_params, tnew.ema_params)
    # The error map is off while the pose is refined.
    _same(host.error_map.error_map, tnew.error_map.error_map)
    _same(jnew.error_map.error_map, tnew.error_map.error_map)

    # Finetune from the JAX state after refinement: both groups, full batch.
    calls[0] = 0
    both = dict(train_canonical=True, train_delta=True, use_delta=True)
    jnew2, tnew2, _, _ = _step(jnew, jcfg, tcfg, scene, **both)
    assert calls[0] == 1
    _check_delta(jnew2, tnew2)
    assert tnew2.delta_opt_state["count"] == 2
    _check_field(jnew2, tnew2)
    ref = np.asarray(jnew2.error_map.error_map)
    assert np.abs(tnew2.error_map.error_map.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_frame0_error_map_with_sharpness_matches_jax(scene, calls):
    jcfg, tcfg = _configs(use_error_map=True, include_sharpness_in_error=True)
    host = _start(jcfg, scene, emap=True)
    assert host.error_map.sharpness_grid is not None and host.error_map.sharpness_grid.any()
    calls[0] = 0
    jnew, tnew, _, draws = _step(host, jcfg, tcfg, scene)
    assert calls[0] == 1 and draws.img_idx is None and draws.em_u is not None
    _check_field(jnew, tnew)
    _same(host.delta, tnew.delta)
    ref, got = np.asarray(jnew.error_map.error_map), tnew.error_map.error_map.numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() and ref.any()
    np.testing.assert_array_equal(tnew.error_map.cdf.numpy(), np.asarray(jnew.error_map.cdf))
    ref_g, got_g = np.asarray(jnew.error_map.sharpness_grid), tnew.error_map.sharpness_grid.numpy()
    assert (got_g != np.asarray(host.error_map.sharpness_grid) * 0.95).any()
    assert (got_g != ref_g).sum() <= max(2, int(0.01 * (ref_g > 0).sum()))


def test_residual_grid_step_matches_jax(scene, calls):
    jcfg, tcfg = _configs(residual=True)
    host = _start(jcfg, scene)
    rng = np.random.default_rng(1)
    base = tuple(rng.normal(0, 1e-2, t.shape).astype(np.float32)
                 for t in host.params["hashgrid"])
    host = host._replace(params={**host.params, "hashgrid_base": base},
                         ema_params={**host.ema_params, "hashgrid_base": base})
    calls[0] = 0
    jnew, tnew, tstart, _ = _step(host, jcfg, tcfg, scene)
    assert calls[0] == 1
    _check_field(jnew, tnew)
    _same(base, tnew.params["hashgrid_base"])  # frozen: no gradient, no step
    assert not all(torch.equal(a, b) for a, b in  # the unlocked levels' residuals train
                   zip(tstart.params["hashgrid"], tnew.params["hashgrid"]))


def test_state_round_trips_through_interop(scene):
    """Every dynamic part of the state (delta and its Adam, acc, the error
    map with its sharpness grid, the residual base) goes to the port and
    back to the JAX layout unchanged."""
    jcfg, _ = _configs(residual=True, use_error_map=True, include_sharpness_in_error=True)
    host = _start(jcfg, scene, moved=True, emap=True)
    host = host._replace(delta_opt_state=(host.delta_opt_state[0]._replace(
        mu={k: v + 0.5 for k, v in host.delta_opt_state[0].mu.items()}, count=np.int32(3)),)
        + tuple(host.delta_opt_state[1:]))
    back = interop.train_state_to_jax(interop.train_state_from_jax(host), host)
    for field in ("params", "ema_params", "opt_state", "delta", "delta_opt_state", "acc",
                  "occupancy", "error_map", "step", "frame_step"):
        a, b = getattr(host, field), getattr(back, field)
        assert (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)), field
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=field)
