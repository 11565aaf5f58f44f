"""Port parity of the optimizer: ``neus2_adam`` + ``ema_update`` over a
fixed gradient sequence with exact-zero rows (the lazy skip), plus the lr
schedule.  Step counters must be equal; moments and params within fp32
rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neus2_tpu.utils import optim as jo
from neus2_tpu_torch import interop
from neus2_tpu_torch.utils import optim as to
from neus2_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)


def _params(rng):
    return {
        "hashgrid": (rng.normal(size=(64, 2)).astype(np.float32),
                     rng.normal(size=(32, 2)).astype(np.float32)),
        "sdf_mlp": {"layers": [{"w": rng.normal(size=(7, 5)).astype(np.float32),
                                "b": rng.normal(size=5).astype(np.float32)}]},
        "rgb_mlp": {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32),
                                "b": rng.normal(size=3).astype(np.float32)}]},
        "variance": np.float32(0.3),
    }


def _grad_seq(params, rng, n):
    seq = []
    for i in range(n):
        g = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=np.shape(p)) * 1e-2).astype(np.float32), params
        )
        # Exact-zero table rows and bias entries exercise the lazy skip.
        for t in g["hashgrid"]:
            t[rng.uniform(size=t.shape[0]) < 0.5] = 0.0
        g["sdf_mlp"]["layers"][0]["b"][i % 5] = 0.0
        if i % 2:
            g["variance"] = np.float32(0.0)
        seq.append(g)
    return seq


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"decay_start": 3, "decay_interval": 2, "non_matrix_lr_factor": 0.5},
        {"components": (("rgb_network", False),), "adabound": True},
    ],
)
def test_adam_and_ema_match_over_steps(kw):
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = jo.OptimConfig(**kw), to.OptimConfig(**kw)
    p_np = _params(rng)
    grads = _grad_seq(p_np, rng, 8)

    tx = jo.neus2_adam(cfg_j)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jstate, jema = tx.init(jp), jp
    tp = interop.params_from_jax(p_np)
    tstate, tema = to.adam_init(tp), tree_map(torch.clone, tp)
    for g in grads:
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jo.ema_update(jema, jp, 0.95)
        tupd, tstate = to.adam_update(interop.params_from_jax(g), tstate, tp, cfg_t)
        tp = tree_map(lambda a, b: a + b, tp, tupd)
        tema = to.ema_update(tema, tp, 0.95)

    assert tstate["count"] == int(jstate["count"])
    for a, b in zip(jax.tree_util.tree_leaves(jstate["steps"]), tree_leaves(tstate["steps"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[key]), tree_leaves(tstate[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-12)
    for tree_j, tree_t in ((jp, tp), (jema, tema)):
        for a, b in zip(jax.tree_util.tree_leaves(tree_j), tree_leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


def test_exp_decay_schedule():
    cfg = dict(learning_rate=1e-3, decay_start=10, decay_interval=4, decay_base=0.33)
    js = jo.exp_decay_schedule(jo.OptimConfig(**cfg))
    ts = to.exp_decay_schedule(to.OptimConfig(**cfg))
    for step in range(0, 30):
        assert ts(step) == float(js(jnp.int32(step)))


def test_interop_round_trip_of_adam_state():
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(jnp.asarray, _params(rng))
    st = jo.neus2_adam(jo.OptimConfig()).init(p)
    st = jax.tree_util.tree_map(np.asarray, st)
    back = interop.adam_to_jax(interop.adam_from_jax(st))
    for a, b in zip(jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
