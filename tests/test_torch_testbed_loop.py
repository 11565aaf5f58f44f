"""The port's static Testbed loop held against the JAX package's Testbed,
frame by frame, through an occupancy update on every step, the
hyperparameter overrides of ``_frame_config``, the 16-step fetch of the
step's scalars and a switch of the adaptive (rays, samples) bucket.

Both Testbeds start from the JAX Testbed's loaded state (its prior sweep
included), and before each frame the port's state is set to the JAX
Testbed's, so each frame is compared from equal numbers.  The port's
Testbed runs its own host logic and takes the random numbers the JAX
Testbed draws, from the JAX state's key, in the JAX order: an occupancy
update out of cadence would shift every draw after it.  Over tens of free
steps the two trajectories part (see the hash-table rule below), which is
why each frame starts from the JAX state.

Tolerances: frame results, steps, bucket, the frame's config, Adam and
occupancy counters and the occupancy bits exactly; the fetched scalars
rtol 1e-5; occupancy density rtol 1e-4, atol 1e-6; every MLP and variance
leaf of params, EMA and Adam moments within 1e-4 of its reference max
magnitude, as in tests/test_torch_train_step.py.  A hash table is held to
that bound on all but 0.5% of its entries: an entry whose gradient is
rounding noise (|g| ~ 1e-10 of the table's largest) takes an Adam step of
any size up to the learning rate, and a sample one rounding away from a
hash-cell face changes side and with it its SDF gradient; those entries'
params and EMA stay within one Adam step (the learning rate).
"""

import jax
import numpy as np
import torch

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jtrain
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.tree import tree_leaves
from test_torch_train_step import _step_draws

torch.set_num_threads(2)

_GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.45)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
# A small adaptive_samples_factor wants bucket 1 from the first read, so
# the three agreeing reads (steps 1, 16, 32) switch it at step 32.
_TRAIN = dict(n_rays=64, samples_per_ray=32, n_candidates=32, adaptive_samples_factor=0.01)
# The overrides differ from the config's weights (0.1, 0.0).
_HYPER = dict(first_frame_max_training_step=34, ek_loss_weight=0.05, mask_loss_weight=0.1)
N_VIEWS, RES = 4, 32


class _JaxDraws:
    """The port's train_step and occupancy_update, fed the draws the JAX
    Testbed's step and update take from ``key``."""

    def __init__(self):
        self.key = None

    def train_step(self, state, images, cameras, config):
        draws, _, self.key = _step_draws(self.key, config, cameras.n_images)
        return tt.train_step(state, images, cameras, config, draws=draws)

    def occupancy_update(self, state, config):
        self.key, k_probe = jax.random.split(self.key)
        jitter = torch.from_numpy(np.array(jax.random.uniform(k_probe, (config.occ_n_probe, 3))))
        return tt.occupancy_update(state, config, jitter=jitter)


def _close_leaves(ref_tree, got_tree, params: bool):
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    for name, a, b in zip(paths, jax.tree_util.tree_leaves(ref_tree), tree_leaves(got_tree)):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, name
        diff = np.abs(b - a)
        bound = 1e-4 * max(np.abs(a).max(), 1e-12)
        if "hashgrid" not in name:
            assert diff.max() <= bound, name
            continue
        assert (diff > bound).mean() <= 0.005, name
        if params:
            assert diff.max() <= 1e-3, name  # the learning rate


def test_testbed_loop_matches_jax(monkeypatch):
    jcfg = jtrain.TrainConfig(field=JFieldConfig(grid=JGrid(**_GRID), **_FIELD), **_TRAIN)
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(**_HYPER))
    jtb.load_training_data_from_datasets([jax_sphere(N_VIEWS, RES, seed=0)])
    tcfg = tt.TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD), **_TRAIN)
    tb = interop.testbed_from_jax(jax.device_get(jtb.state), jtb.hyper, tcfg,
                                  make_sphere_dataset(N_VIEWS, RES, seed=0))
    assert tcfg.optim.learning_rate == 1e-3
    draws = _JaxDraws()
    monkeypatch.setattr(ttb, "train_step", draws.train_step)
    monkeypatch.setattr(ttb, "occupancy_update", draws.occupancy_update)

    frames = 0
    while True:
        start = jax.device_get(jtb.state)
        tb.state = interop.train_state_from_jax(start)
        draws.key = start.key
        jc, tc = jtb._frame_config(), tb._frame_config()
        for name in ("n_rays", "samples_per_ray", "ek_loss_weight", "mask_loss_weight",
                     "anneal_end"):
            assert getattr(tc, name) == getattr(jc, name), name
        going = jtb.frame()
        assert tb.frame() == going
        if not going:
            break
        frames += 1
        assert tb.training_step == jtb.training_step == frames
        assert tb.batch_bucket == jtb.batch_bucket
        for name in ("loss_scalar", "ek_loss_scalar", "mask_loss_scalar"):
            np.testing.assert_allclose(getattr(tb, name), getattr(jtb, name), rtol=1e-5,
                                       err_msg=name)
        for f in jtrain.StepAux._fields:
            np.testing.assert_allclose(float(getattr(tb.last_aux, f)),
                                       float(getattr(jtb.last_aux, f)), rtol=1e-5, err_msg=f)

        ref, got = jax.device_get(jtb.state), tb.state
        assert (got.step, got.frame_step) == (int(ref.step), int(ref.frame_step))
        assert got.opt_state["count"] == int(ref.opt_state["count"])
        assert got.occupancy.ema_step == int(ref.occupancy.ema_step)
        np.testing.assert_array_equal(got.occupancy.bitfield.numpy(),
                                      np.asarray(ref.occupancy.bitfield))
        np.testing.assert_allclose(got.occupancy.density.numpy(),
                                   np.asarray(ref.occupancy.density), rtol=1e-4, atol=1e-6)
        _close_leaves(ref.params, got.params, params=True)
        _close_leaves(ref.ema_params, got.ema_params, params=True)
        for key in ("mu", "nu"):
            _close_leaves(ref.opt_state[key], got.opt_state[key], params=False)

    assert frames == _HYPER["first_frame_max_training_step"]
    # The bucket switched on the step-32 fetch, and two steps ran in it.
    assert tb.batch_bucket == 1
    assert tb._frame_config().n_rays == 2 * _TRAIN["n_rays"]
