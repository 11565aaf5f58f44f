"""The port's dynamic-scene Testbed held against the JAX package's Testbed
on ``make_moving_sphere_frames(n_frames=2)``, step by step through frame 0,
the frame switch, pose refinement, the phase switch (with its occupancy
reset) and the finetune phase, with the error map, its sharpness weighting,
the residual grid and an ``after_learning_rate`` on.

As in tests/test_torch_testbed_loop.py, before each step the port's state
is set to the JAX Testbed's, the port's Testbed runs its own host logic
(frame bookkeeping, phase flags, ``_frame_config``, the switch), and it
takes the random numbers the JAX Testbed draws from the JAX state's key.
The steps stop long before the first error-map rebuild (step 128).

Tolerances: frame results, frame index, phase flags, steps, counters,
occupancy bits, the frame's config and the state a switch resets exactly;
the fold of the delta into the accumulated transform within 1e-6; the
fetched scalars rtol 1e-5; occupancy density rtol 5e-4, atol 1e-6 (the
logistic density multiplies its SDF's rounding by inv_s |sdf|: after the
phase switch's reset, a fresh probe near the surface sets it); every
leaf of params, EMA, Adam first moments, the square roots of the second
moments (a squared gradient doubles the gradient's relative error: the
first finetune step trains the field on the 32-ray refinement batch), the
delta and its moments within 1e-4 of its reference max magnitude, with the
hash-table rule of tests/test_torch_testbed_loop.py, but the variance and
its moments within 1e-3 (its gradient cancels over the samples: the JAX
package's jitted and op-by-op gradients of it differ by 2e-4 on a finetune
step of this test); the error map within 1e-4 of its max and the
sharpness grid exactly but for 1% of its nonzero cells; the render at
spp 1 within 3e-4 (tests/test_torch_render_mesh.py, whose
marching configuration it takes); ``save_transform``'s numbers within 1e-6
in the same layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.synthetic import make_moving_sphere_frames as jax_frames
from neus2_tpu.engine import render as jrender
from neus2_tpu.engine import train as jtrain
from neus2_tpu.models import delta as jdelta
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.utils.optim import OptimConfig as JOptim
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames
from neus2_tpu_torch.engine import render as trender
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.optim import OptimConfig
from neus2_tpu_torch.utils.tree import tree_map
from test_torch_render_mesh import MARCH_TIES
from test_torch_testbed_loop import _close_leaves, _JaxDraws

torch.set_num_threads(2)

_GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.45)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16, residual_grid=True)
_TRAIN = dict(n_rays=64, samples_per_ray=32, n_candidates=32, delta_n_rays=32,
              use_error_map=True, include_sharpness_in_error=True)
_OPTIM = dict(after_learning_rate=5e-4)
_HYPER = dict(first_frame_max_training_step=3, next_frame_max_training_step=5,
              predict_global_movement_training_step=2,
              reset_density_grid_after_global_movement=True)
_FRAMES = dict(n_frames=2, translation_per_frame=(0.02, 0.0, 0.0), n_views=4, resolution=32)
_CONFIG_FIELDS = ("n_rays", "samples_per_ray", "hit_oversample", "valid_level_step_offset",
                  "use_error_map", "error_map_res", "include_sharpness_in_error",
                  "ek_loss_weight", "mask_loss_weight", "anneal_end")


def _same_config(tc, jc):
    for name in _CONFIG_FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.optim.learning_rate == jc.optim.learning_rate


def _phase(tb):
    return (tb.current_training_time_frame, tb.training_step, tb.train_canonical,
            tb.train_delta, tb.use_delta)


def _close_field(ref, got, params):
    """_close_leaves on a field tree, but ``variance`` within 1e-3 of its
    magnitude: its gradient sums every sample's term with cancellation, and
    on a finetune step here the JAX package's own jitted and op-by-op
    gradients of it differ by 2e-4."""
    _close_leaves({k: v for k, v in ref.items() if k != "variance"},
                  {k: v for k, v in got.items() if k != "variance"}, params)
    a, b = np.asarray(ref["variance"]), got["variance"].detach().numpy()
    assert abs(float(b) - float(a)) <= 1e-3 * abs(float(a)) + 1e-12


def _close_state(ref, got):
    assert (got.step, got.frame_step) == (int(ref.step), int(ref.frame_step))
    assert got.opt_state["count"] == int(ref.opt_state["count"])
    assert got.delta_opt_state["count"] == int(ref.delta_opt_state[0].count)
    assert got.occupancy.ema_step == int(ref.occupancy.ema_step)
    np.testing.assert_array_equal(got.occupancy.bitfield.numpy(),
                                  np.asarray(ref.occupancy.bitfield))
    np.testing.assert_allclose(got.occupancy.density.numpy(),
                               np.asarray(ref.occupancy.density), rtol=5e-4, atol=1e-6)
    _close_field(ref.params, got.params, params=True)
    _close_field(ref.ema_params, got.ema_params, params=True)
    _close_field(ref.opt_state["mu"], got.opt_state["mu"], params=False)
    _close_field(jax.tree_util.tree_map(np.sqrt, ref.opt_state["nu"]),
                 tree_map(torch.sqrt, got.opt_state["nu"]), params=False)
    _close_leaves(ref.delta, got.delta, params=False)
    _close_leaves(ref.delta_opt_state[0].mu, got.delta_opt_state["mu"], params=False)
    _close_leaves(jax.tree_util.tree_map(np.sqrt, ref.delta_opt_state[0].nu),
                  tree_map(torch.sqrt, got.delta_opt_state["nu"]), params=False)
    for k in ("rotation", "transition"):
        np.testing.assert_allclose(got.acc[k].numpy(), np.asarray(ref.acc[k]), rtol=0, atol=1e-6)
    em, jem = got.error_map, ref.error_map
    assert np.abs(em.error_map.numpy() - np.asarray(jem.error_map)).max() <= (
        1e-4 * np.abs(np.asarray(jem.error_map)).max())
    np.testing.assert_array_equal(em.cdf.numpy(), np.asarray(jem.cdf))
    g, jg = em.sharpness_grid.numpy(), np.asarray(jem.sharpness_grid)
    assert (g != jg).sum() <= max(2, int(0.01 * (jg > 0).sum()))


def test_dynamic_testbed_matches_jax(monkeypatch, tmp_path):
    jcfg = jtrain.TrainConfig(field=JFieldConfig(grid=JGrid(**_GRID), **_FIELD),
                              optim=JOptim(**_OPTIM), **_TRAIN)
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(**_HYPER))
    jtb.load_training_data_from_datasets(jax_frames(**_FRAMES))
    tcfg = tt.TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD),
                          optim=OptimConfig(**_OPTIM), **_TRAIN)
    tb = interop.testbed_from_jax(jax.device_get(jtb.state), jtb.hyper, tcfg, None,
                                  datasets=make_moving_sphere_frames(**_FRAMES), phase=jtb)
    assert tb.is_dynamic and tb.all_training_time_frame == jtb.all_training_time_frame == 2
    assert tb.cameras.sharpness is not None
    _same_config(tb.config, jtb.config)
    done_j, done_t = [], []
    jtb.on_frame_complete = lambda t, k: done_j.append((k, t.training_step))
    tb.on_frame_complete = lambda t, k: done_t.append((k, t.training_step))
    draws = _JaxDraws()
    monkeypatch.setattr(ttb, "train_step", draws.train_step)
    monkeypatch.setattr(ttb, "occupancy_update", draws.occupancy_update)

    phases = []
    while True:
        start = jax.device_get(jtb.state)
        tb.state = interop.train_state_from_jax(start)
        draws.key = start.key
        assert _phase(tb) == _phase(jtb)
        _same_config(tb._frame_config(), jtb._frame_config())
        going = jtb.frame()
        assert tb.frame() == going
        if not going:
            break
        phases.append(_phase(tb))
        assert _phase(tb) == _phase(jtb)
        ref, got = jax.device_get(jtb.state), tb.state
        _close_state(ref, got)
        for name in ("loss_scalar", "ek_loss_scalar", "mask_loss_scalar"):
            np.testing.assert_allclose(getattr(tb, name), getattr(jtb, name), rtol=1e-5)
        if len(phases) == _HYPER["first_frame_max_training_step"] + 1:
            # The switch: the delta folded into acc and restarted at the
            # identity, the residual frozen into the base, the field's Adam
            # and the error map fresh, then one refinement step.
            acc = jdelta.accumulate_delta(start.acc, start.delta)
            for k in ("rotation", "transition"):
                np.testing.assert_allclose(got.acc[k].numpy(), np.asarray(acc[k]), atol=1e-6)
            for base, grid, b2, g2 in zip(start.params["hashgrid_base"],
                                          start.params["hashgrid"],
                                          got.params["hashgrid_base"], got.params["hashgrid"]):
                np.testing.assert_array_equal(b2.numpy(), np.asarray(base) + np.asarray(grid))
                assert not g2.any()
            assert got.opt_state["count"] == 0 and got.frame_step == 1
            assert not any(m.any() for m in tt.tree_leaves(got.opt_state["mu"]))
            assert not got.error_map.error_map.any()
            assert got.delta_opt_state["count"] == 1

    # Frame 0: 3 canonical steps; frame 1: 2 refinement steps, then the
    # phase switch and 3 finetune steps.
    canon, refine, both = (True, False, False), (False, True, True), (True, True, True)
    assert [p[0] for p in phases] == [0, 0, 0, 1, 1, 1, 1, 1]
    assert [p[2:] for p in phases] == [canon] * 3 + [refine] * 2 + [both] * 3
    assert done_t == done_j == [(0, 3), (1, 5)]

    # _frame_config of frame 1 both ways of refine_coarse_to_fine, in each
    # phase: refinement's small uncompacted batch and the unlock offset.
    final = jax.device_get(jtb.state)
    tb.state = interop.train_state_from_jax(final)
    for c2f in (True, False):
        for flags in (refine, both):
            for t in (tb, jtb):
                t.hyper.refine_coarse_to_fine = c2f
                t.train_canonical, t.train_delta, t.use_delta = flags
            tc, jc = tb._frame_config(), jtb._frame_config()
            _same_config(tc, jc)
            assert tc.valid_level_step_offset == (0 if c2f else 2)
            assert tc.optim.learning_rate == 5e-4
            assert (tc.n_rays, tc.hit_oversample) == ((32, 1) if flags == refine else (64, 2))

    # Renders apply the accumulated transform composed with the live delta.
    tb.prepare_for_test()
    jtb.prepare_for_test()
    assert tb.use_delta and jtb.use_delta
    tacc, jacc = tb.effective_acc, jtb.effective_acc
    for k in ("rotation", "transition"):
        np.testing.assert_allclose(tacc[k].numpy(), np.asarray(jacc[k]), rtol=0, atol=1e-6)
    assert not np.array_equal(tacc["transition"].numpy(), np.asarray(final.acc["transition"]))
    tb.save_transform(tmp_path / "t.txt")
    jtb.save_transform(tmp_path / "j.txt")
    t_rows = [l.split() for l in (tmp_path / "t.txt").read_text().splitlines()]
    j_rows = [l.split() for l in (tmp_path / "j.txt").read_text().splitlines()]
    assert len(t_rows) == 3 and all(len(r) == 4 for r in t_rows)
    assert all(len(v.split(".")[1]) == 8 for r in t_rows for v in r)
    np.testing.assert_allclose(np.float64(t_rows), np.float64(j_rows), rtol=0, atol=1e-6)

    tcam, jcam = tb.cameras, jtb.cameras
    trc = trender.RenderConfig(field=tb.config.field, **MARCH_TIES)
    jrc = jrender.RenderConfig(field=jtb.config.field, **MARCH_TIES)
    ref = jrender.render_image(jax.tree_util.tree_map(jnp.asarray, final.ema_params), jacc,
                               jtb.state.occupancy, jcam, jcam.poses[1], jcam.focal[1],
                               jcam.principal[1], jax.random.PRNGKey(0), jrc,
                               background=0.0, spp=1)
    got = trender.render_image(tb.state.ema_params, tacc, tb.state.occupancy, tcam,
                               tcam.poses[1], tcam.focal[1], tcam.principal[1], None, trc,
                               background=0.0, spp=1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=3e-4)
    assert float(got[2].max()) > 0.1
    tb.change_to_frame(0)
    assert tb.current_training_time_frame == 0 and not tb.use_delta
    assert tb.effective_acc is tb.state.acc


def test_next_frame_reinit_and_motion_prior():
    """``incremental_reinit_sdf_mlp`` re-inits the SDF MLP at a switch from
    the port's own generator seeded 1337 (JAX's threefry stream cannot be
    matched), in params and EMA alike as separate tensors; with
    ``delta_motion_prior`` the next frame's delta starts at the last one."""
    from neus2_tpu_torch.models.field import init_field

    hyper = ttb.Hyperparams(first_frame_max_training_step=1, next_frame_max_training_step=1,
                            incremental_reinit_sdf_mlp=True, incremental_reinit_sdf_mlp_iters=1,
                            delta_motion_prior=True)
    cfg = tt.TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD),
                         **dict(_TRAIN, use_error_map=False, include_sharpness_in_error=False))
    tb = ttb.Testbed(config=cfg, hyper=hyper, device="cpu")
    tb.load_training_data_from_datasets(make_moving_sphere_frames(**_FRAMES))
    delta = {"rotation6d": torch.tensor([1.0, 0.1, 0.0, 0.0, 1.0, 0.0]),
             "transition": torch.tensor([0.01, 0.0, -0.02])}
    tb.state = tb.state._replace(delta=delta)
    assert tb.training_network_next_frame()
    fresh = init_field(torch.Generator().manual_seed(1337), tb.config.field)["sdf_mlp"]
    for a, b, e in zip(tt.tree_leaves(fresh), tt.tree_leaves(tb.state.params["sdf_mlp"]),
                       tt.tree_leaves(tb.state.ema_params["sdf_mlp"])):
        assert torch.equal(a, b) and torch.equal(a, e) and b.data_ptr() != e.data_ptr()
    for k in delta:
        assert torch.equal(tb.state.delta[k], delta[k])
    assert tb.state.delta["transition"] is not delta["transition"]
    assert (tb.train_canonical, tb.train_delta, tb.use_delta) == (False, True, True)
    assert not tb.training_network_next_frame()  # the last frame
