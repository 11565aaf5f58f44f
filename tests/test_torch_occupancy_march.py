"""Port parity of the occupancy grid and the marcher, with the random
draws (probe jitter, stratified xi, cell jitter) made in numpy and fed to
both packages.  Indices, masks and bits must agree exactly; positions,
t and dt within fp32 rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.engine import march as jmarch
from neus2_tpu.engine import occupancy as jocc
from neus2_tpu.ops.warp import scene_aabb as jaabb
from neus2_tpu_torch.engine import march as tmarch
from neus2_tpu_torch.engine import occupancy as tocc
from neus2_tpu_torch.ops.warp import scene_aabb as taabb

torch.set_num_threads(2)
G = 128


def _grids(n_cascades, seed=0, ema_step=3):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0, 0.2, (n_cascades, G, G, G)).astype(np.float32)
    dens[rng.uniform(size=dens.shape) < 0.6] = 0.0
    dens[rng.uniform(size=dens.shape) < 0.01] = -1.0
    # Occupied only within a ball, so that some rays miss.
    c = (np.arange(G) + 0.5) / G - 0.5
    ball = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 < 0.15**2
    for k in range(n_cascades):
        dens[k][~ball] = np.minimum(dens[k][~ball], 0.0)
    j = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(dens > 0.05), jnp.int32(ema_step))
    t = tocc.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(dens > 0.05), ema_step)
    return j, t, rng


@pytest.mark.parametrize("n_cascades,ema_step", [(1, 3), (3, 40000)])
def test_probe_cells(n_cascades, ema_step):
    j, t, _ = _grids(n_cascades, ema_step=ema_step)
    n_probe = 4096
    key = jax.random.PRNGKey(ema_step)
    jitter = np.array(jax.random.uniform(key, (n_probe, 3)))  # as probe_cells draws it
    jflat, jcas, jpos = jocc.probe_cells(j, key, n_probe)
    tflat, tcas, tpos = tocc.probe_cells(t, n_probe, torch.from_numpy(jitter))
    np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
    np.testing.assert_array_equal(np.asarray(jcas), tcas.numpy())
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_cascades", [1, 3])
def test_merge_update_and_lookup(n_cascades):
    j, t, rng = _grids(n_cascades, seed=n_cascades)
    flat = rng.integers(0, n_cascades * G**3, 8192)
    dens = rng.uniform(0, 0.3, 8192).astype(np.float32)
    jg = jocc.update_bitfield(jocc.merge_probes(j, jnp.asarray(flat), jnp.asarray(dens), 0.9))
    tg = tocc.update_bitfield(tocc.merge_probes(t, torch.from_numpy(flat), torch.from_numpy(dens), 0.9))
    np.testing.assert_array_equal(np.asarray(jg.density), tg.density.numpy())
    np.testing.assert_array_equal(np.asarray(jg.bitfield), tg.bitfield.numpy())
    assert tg.ema_step == int(jg.ema_step)
    pos = rng.uniform(-1.5, 2.5, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jocc.occupancy_at(jg, jnp.asarray(pos))),
        tocc.occupancy_at(tg, torch.from_numpy(pos)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jocc.mip_from_pos(jnp.asarray(pos), n_cascades - 1)),
        tocc.mip_from_pos(torch.from_numpy(pos), n_cascades - 1).numpy(),
    )


def _rays(n, rng, spread=0.05):
    target = 0.5 + rng.normal(0, spread, (n, 3))
    o = 0.5 + rng.normal(size=(n, 3))
    o = 0.5 + 1.3 * (o - 0.5) / np.linalg.norm(o - 0.5, axis=-1, keepdims=True)
    d = target - o
    d[: n // 2] = rng.normal(size=(n // 2, 3))  # half aim anywhere
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("aabb_scale,n_cascades", [(1, 1), (4, 3)])
def test_probe_and_draw(aabb_scale, n_cascades):
    j, t, rng = _grids(n_cascades, seed=7)
    R, C, S = 64, 32, 16
    o, d = _rays(R, rng, spread=0.15)
    cone = jmarch.cone_angle_for_scene(aabb_scale)
    assert cone == tmarch.cone_angle_for_scene(aabb_scale)
    k_probe, k_draw = jax.random.split(jax.random.PRNGKey(aabb_scale))
    # The uniforms exactly as the JAX functions draw them from their keys.
    u_c = np.array(jax.random.uniform(k_probe, (R, C)))
    xi = np.array(jax.random.uniform(k_draw, (R, S)))
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)

    jp = jmarch.probe_candidates(k_probe, jo, jd, jaabb(aabb_scale), j, C, cone_angle=cone)
    tp = tmarch.probe_candidates(to, td, taabb(aabb_scale), t, C,
                                 torch.from_numpy(u_c), cone_angle=cone)
    np.testing.assert_array_equal(np.asarray(jp.hit), tp.hit.numpy())
    assert tp.hit.any() and not tp.hit.all()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)

    js = jmarch.draw_from_probe(k_draw, jp, jo, jd, S)
    ts = tmarch.draw_from_probe(tp, to, td, S, torch.from_numpy(xi))
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)

    # march_rays = probe + draw, with the same key split as the JAX package.
    key = jax.random.PRNGKey(11)
    k_rest, k_p = jax.random.split(key)
    jm = jmarch.march_rays(key, jo, jd, jaabb(aabb_scale), j, C, S, cone_angle=cone)
    tmr = tmarch.march_rays(
        to, td, taabb(aabb_scale), t, C, S,
        torch.from_numpy(np.array(jax.random.uniform(k_p, (R, C)))),
        torch.from_numpy(np.array(jax.random.uniform(k_rest, (R, S)))),
        cone_angle=cone,
    )
    for a, b in zip(jm, tmr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def _sweep_configs(n_cascades, n_probe):
    """Both packages' configs of a small field over a scene of
    2^(n_cascades - 1) (aabb_scale 4: 3 cascades; 16: 5)."""
    from neus2_tpu.engine.train import TrainConfig as JTrainConfig
    from neus2_tpu.models.field import FieldConfig as JFieldConfig
    from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
    from neus2_tpu_torch.engine.train import TrainConfig
    from neus2_tpu_torch.models.field import FieldConfig
    from neus2_tpu_torch.ops.hashgrid import HashGridConfig

    grid = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.45)
    kw = dict(aabb_scale=2 ** (n_cascades - 1), occ_cascades=n_cascades, occ_n_probe=n_probe)
    field = dict(sdf_hidden_dim=16, rgb_hidden_dim=16, init_radius=0.2)
    return (JTrainConfig(field=JFieldConfig(grid=JGrid(**grid), **field), **kw),
            TrainConfig(field=FieldConfig(grid=HashGridConfig(**grid), **field), **kw))


@pytest.mark.parametrize("n_cascades,n_probe,updates", [
    (3, 1 << 17, 48), (5, 1 << 17, 80), (3, 1 << 14, 16), (5, 1 << 14, 16)])
def test_prior_sweep_length(monkeypatch, n_cascades, n_probe, updates):
    """The prior sweep probes every cell of 3 or 5 cascades in
    ceil(cells / probes) updates (base.json's 2^17 probes: 48 and 80), and
    takes 16 when a full sweep does not fit in 256, in both packages."""
    from neus2_tpu.engine import train as jt
    from neus2_tpu_torch.engine import train as tt

    jcfg, tcfg = _sweep_configs(n_cascades, n_probe)
    for mod, cfg in ((jt, jcfg), (tt, tcfg)):
        calls = []
        monkeypatch.setattr(mod, "occupancy_update", lambda s, c: calls.append(c) or s)
        assert mod.occupancy_prior_sweep("state", cfg) == "state"
        assert len(calls) == updates and all(c is cfg for c in calls)


@pytest.mark.parametrize("n_cascades", [3, 5])
def test_prior_sweep_and_update_match_jax(monkeypatch, n_cascades):
    """``occupancy_prior_sweep`` (16 updates of 2^14 probes: a full sweep
    of 3-5 x 128^3 cells is too many for a CPU test) and one
    ``occupancy_update`` more, from the same field, with the jitter the JAX
    package draws from its key injected: every update's probes over 3 or 5
    cascades, the logistic density, the EMA-max merge and the cascade
    max-pool.  Bits exactly; densities rtol 1e-4 (the SDF's rounding) plus
    atol 4 s 2^-24: the logistic density s sig (1 - sig) loses digits to
    the difference 1 - sig, so each ulp (2^-24 near 1) by which the
    packages' sigmoids differ moves it by up to s 2^-24 whatever its size
    (seen: two ulps, 2.4e-6 at s ~ 20, 3e-3 of a density of 8e-4 on a probe
    far from the surface)."""
    from neus2_tpu.engine import train as jt
    from neus2_tpu_torch import interop
    from neus2_tpu_torch.engine import train as tt

    jcfg, tcfg = _sweep_configs(n_cascades, 1 << 14)
    jstate = jt.init_train_state(jax.random.PRNGKey(0), jcfg, 1)
    start = jax.device_get(jstate)
    jstate = jt.occupancy_update(jt.occupancy_prior_sweep(jstate, jcfg), jcfg)

    key, jitters = start.key, []
    for _ in range(17):
        key, k_probe = jax.random.split(key)
        jitters.append(torch.from_numpy(np.array(jax.random.uniform(k_probe, (1 << 14, 3)))))
    occ = start.occupancy
    tstate = interop.state_from_jax(start.params, start.ema_params, start.opt_state,
                                    (occ.density, occ.bitfield, occ.ema_step), start.step,
                                    start.frame_step)
    update = tt.occupancy_update
    monkeypatch.setattr(tt, "occupancy_update",
                        lambda s, c: update(s, c, jitter=jitters.pop(0)))
    tstate = tt.occupancy_update(tt.occupancy_prior_sweep(tstate, tcfg), tcfg)
    assert not jitters

    got, ref = tstate.occupancy, jax.device_get(jstate.occupancy)
    assert got.n_cascades == n_cascades and got.ema_step == int(ref.ema_step) == 17
    np.testing.assert_array_equal(got.bitfield.numpy(), np.asarray(ref.bitfield))
    inv_s = float(np.exp(10.0 * np.asarray(start.params["variance"])).max())
    np.testing.assert_allclose(got.density.numpy(), np.asarray(ref.density), rtol=1e-4,
                               atol=4 * inv_s * 2.0**-24)
    # Every cascade was probed, and the outer ones hold occupied cells.
    assert all(bool((got.density[k] != 0).any()) for k in range(n_cascades))
    assert bool(got.bitfield[-1].any())
