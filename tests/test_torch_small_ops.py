"""The JAX package's small functions, each held against its port on the
same numpy inputs: the tcnn loss family, the eikonal loss, the
background composite and the training target (``ops/losses.py``); the
frequency, Hann-window, OneBlob and triangle-wave encodings
(``ops/sh.py``); ``unit_aabb``, ``unwarp_position``, ``warp_dt`` and
``unwarp_dt`` (``ops/warp.py``); ``hashgrid_encode`` with its table and
position gradients on a carried-across table (``ops/hashgrid.py``);
``StepEma`` and ``trace`` (``utils/meters.py``); ``sample_training_rays``
with the JAX draws (``engine/rays.py``), ``blocked_cumsum``
(``engine/error_map.py``) and ``flagship_grid`` (``utils/variants.py``),
field for field.

Tolerances, fp32 on the CPU: elementwise functions within 1e-6 relative
(libm's and XLA's transcendentals may differ by an ulp, and XLA may fuse a
multiply-add into one rounding), or bitwise where
both sides do the same exact arithmetic (the warps,
``StepEma`` in Python floats, the ray sampler's gathers); reductions
(the eikonal mean, ``blocked_cumsum``, the hash-grid encoding and its
gradients, sums in another order) within 1e-6 of the reference's max
magnitude.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import error_map as jem
from neus2_tpu.engine import rays as jrays
from neus2_tpu.ops import hashgrid as jhg
from neus2_tpu.ops import losses as jl
from neus2_tpu.ops import sh as jsh
from neus2_tpu.ops import warp as jw
from neus2_tpu.utils import meters as jmeters
from neus2_tpu.utils import variants as jvariants
from neus2_tpu_torch import interop
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import error_map as tem
from neus2_tpu_torch.engine import rays as trays
from neus2_tpu_torch.ops import hashgrid as thg
from neus2_tpu_torch.ops import losses as tl
from neus2_tpu_torch.ops import sh as tsh
from neus2_tpu_torch.ops import warp as tw
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.utils import meters as tmeters
from neus2_tpu_torch.utils import variants as tvariants

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _close(got, ref, rel=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "log_l1_loss", "relative_l2_loss",
                                  "mape_loss", "smape_loss"])
def test_loss_family_matches_jax(name):
    t, p = RNG.normal(size=(2, 257, 3)).astype(np.float32)
    _close(getattr(tl, name)(torch.from_numpy(t), torch.from_numpy(p)),
           getattr(jl, name)(jnp.asarray(t), jnp.asarray(p)))


def test_rgb_loss_menu_uses_the_family():
    t, p = RNG.uniform(size=(2, 64, 3)).astype(np.float32)
    for kind in ("L2", "L1", "Huber", "LogL1", "RelativeL2", "Mape", "Smape"):
        _close(tl.rgb_loss(torch.from_numpy(t), torch.from_numpy(p), kind),
               jl.rgb_loss(jnp.asarray(t), jnp.asarray(p), kind))


def test_eikonal_loss_matches_jax():
    normals = RNG.normal(size=(33, 17, 3)).astype(np.float32)
    mask = RNG.uniform(size=(33, 17)) < 0.6
    mask[3] = False  # a ray with no valid sample divides by 1
    got = tl.eikonal_loss(torch.from_numpy(normals), torch.from_numpy(mask))
    ref = jl.eikonal_loss(jnp.asarray(normals), jnp.asarray(mask))
    _close(got, ref)
    assert float(got[3]) == 0.0


def test_composite_and_target_match_jax():
    rgb, bg = RNG.uniform(size=(2, 50, 3)).astype(np.float32)
    alpha, trans = RNG.uniform(size=(2, 50)).astype(np.float32)
    _close(tl.composite_background(*map(torch.from_numpy, (rgb, alpha, trans, bg))),
           jl.composite_background(*map(jnp.asarray, (rgb, alpha, trans, bg))))
    tex = RNG.uniform(size=(50, 4)).astype(np.float32)
    tex[:10, 3] = 0.0  # empty texels take the background
    tex[:, :3] *= tex[:, 3:]  # premultiplied
    got = tl.target_from_rgba(torch.from_numpy(tex), torch.from_numpy(bg))
    ref = jl.target_from_rgba(jnp.asarray(tex), jnp.asarray(bg))
    _close(got, ref)
    np.testing.assert_array_equal(got[:10].numpy(),
                                  tl.linear_to_srgb(torch.from_numpy(bg)).numpy()[:10])


@pytest.mark.parametrize("name,arg", [("frequency_encode", 6), ("oneblob_encode", 16),
                                      ("trianglewave_encode", 8)])
def test_encodings_match_jax(name, arg):
    x = RNG.uniform(size=(129, 3)).astype(np.float32)
    got = getattr(tsh, name)(torch.from_numpy(x), arg)
    ref = getattr(jsh, name)(jnp.asarray(x), arg)
    assert got.shape == (129, 3 * arg * (2 if name == "frequency_encode" else 1))
    _close(got, ref)


@pytest.mark.parametrize("alpha", [0.0, 2.5, 6.0])
def test_hann_window_frequency_encode_matches_jax(alpha):
    x = RNG.uniform(size=(65, 3)).astype(np.float32)
    _close(tsh.hann_window_frequency_encode(torch.from_numpy(x), 6, alpha),
           jsh.hann_window_frequency_encode(jnp.asarray(x), 6, alpha))


def test_warps_match_jax():
    pos = RNG.uniform(size=(100, 3)).astype(np.float32)
    dt = RNG.uniform(0, 0.05, size=(100,)).astype(np.float32)
    box = tw.unit_aabb()
    jbox = jw.unit_aabb()
    assert box.lo == tuple(np.asarray(jbox.lo)) and box.hi == tuple(np.asarray(jbox.hi))
    for scale in (1, 4):
        got = tw.unwarp_position(torch.from_numpy(pos), tw.scene_aabb(scale))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jw.unwarp_position(jnp.asarray(pos), jw.scene_aabb(scale))))
        np.testing.assert_allclose(tw.warp_position(got, tw.scene_aabb(scale)).numpy(), pos,
                                   atol=1e-6)
    w = tw.warp_dt(torch.from_numpy(dt))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw.warp_dt(jnp.asarray(dt))))
    np.testing.assert_array_equal(tw.unwarp_dt(w).numpy(),
                                  np.asarray(jw.unwarp_dt(jw.warp_dt(jnp.asarray(dt)))))


GRID = jhg.HashGridConfig(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
                          base_resolution=8, per_level_scale=2.0)


def test_init_hashgrid_is_the_table_shape():
    cfg = interop.config_from_jax(GRID)
    t = thg.init_hashgrid(torch.Generator().manual_seed(3), cfg)
    assert t.shape == jhg.init_hashgrid(jax.random.PRNGKey(0), GRID).shape
    assert t.dtype == torch.float32 and float(t.abs().max()) <= 1e-4
    assert torch.equal(t, thg.init_hashgrid(torch.Generator().manual_seed(3), cfg))


@pytest.mark.parametrize("gates", [{}, {"valid_level": 1}, {"max_level": True}])
def test_hashgrid_encode_and_gradients_match_jax(gates):
    """On a carried-across table (the port's init is its own draw); the
    table gradient goes through the fixed-order sum, the position gradient
    through autograd."""
    cfg = interop.config_from_jax(GRID)
    table = np.asarray(jhg.init_hashgrid(jax.random.PRNGKey(1), GRID)) * 1e3
    pos = RNG.uniform(size=(300, 3)).astype(np.float32)
    ct = RNG.normal(size=(300, GRID.n_levels * 2)).astype(np.float32)
    kw = dict(gates)
    if gates.get("max_level"):
        kw["max_level"] = RNG.uniform(size=(300,)).astype(np.float32)

    def jf(t, p):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        return jnp.sum(jhg.hashgrid_encode(t, p, GRID, **jkw) * ct)

    jout = jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(pos), GRID,
                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                  for k, v in kw.items()})
    jgt, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pos))
    tt_ = torch.from_numpy(table).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    out = thg.hashgrid_encode(tt_, tp, cfg, **tkw)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out.detach(), jout)
    _close(tt_.grad, jgt)
    _close(tp.grad, jgp, rel=1e-5)


def test_step_ema_matches_jax():
    samples = [1.0, 0.5, 2.0, 0.25, 3.0]
    for decay in (0.5, 0.9):
        a, b = tmeters.StepEma(decay), jmeters.StepEma(decay)
        assert math.isnan(a.value) and math.isnan(b.value)
        assert [a.update(s) for s in samples] == [b.update(s) for s in samples]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tmeters.trace(tmp_path / "tr") as prof:
        torch.ones(64).cumsum(0)
    path = tmp_path / "tr" / "trace.json"
    assert prof is not None and path.exists()
    assert json.loads(path.read_text())["traceEvents"]


def test_sample_training_rays_matches_jax():
    ds = jax_sphere(n_views=4, resolution=24, seed=2)
    key = jax.random.PRNGKey(5)
    jo, jd, jrgba, jidx = jrays.sample_training_rays(key, ds.cameras(), ds.images_device(), 200)
    k_img, k_uv = jax.random.split(key)  # the function's own split
    idx = torch.from_numpy(np.array(jax.random.randint(k_img, (200,), 0, 4))).long()
    uv = torch.from_numpy(np.array(jax.random.uniform(k_uv, (200, 2))))
    images, cams = make_sphere_dataset(4, 24, seed=2).to_device("cpu")
    o, d, rgba, got_idx = trays.sample_training_rays(cams, images, 200, img_idx=idx, uv=uv)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgba.numpy(), np.asarray(jrgba))
    _close(o, jo)
    _close(d, jd)
    # Drawn from a generator instead: the shapes and ranges the draws give.
    o, d, rgba, got_idx = trays.sample_training_rays(cams, images, 64,
                                                     generator=torch.Generator().manual_seed(0))
    assert o.shape == d.shape == (64, 3) and rgba.shape == (64, 4)
    assert 0 <= int(got_idx.min()) and int(got_idx.max()) < 4


@pytest.mark.parametrize("n", [1000, 4096, 10_007])
def test_blocked_cumsum_matches_jax(n):
    """Up to one block it is ``cumsum``; past it (10,007 at block 4,096, a
    block that does not divide the length) the two-level sum."""
    x = RNG.uniform(size=(n,)).astype(np.float32)
    got = tem.blocked_cumsum(torch.from_numpy(x), block=4096)
    _close(got, jem.blocked_cumsum(jnp.asarray(x), block=4096))
    _close(got, np.cumsum(x.astype(np.float64)), rel=1e-5)


# The level-unlock schedule, which a variant leaves at its default:
# tpu_opt.json unlocks at 0.04 a step where the variant keeps 0.02.
_SCHEDULE = ("valid_level_scale", "base_valid_level_scale", "base_training_step")


@pytest.mark.parametrize("variant, json_name", [("parity", "base.json"),
                                                ("tpu_opt", "tpu_opt.json"),
                                                ("l4f8", "l4f8.json")])
def test_flagship_grid_matches_jax_and_its_config(variant, json_name):
    """The port's ``flagship_grid`` is the JAX package's field for field,
    and the grid ``config_from_json`` reads from the matching JSON in every
    field of the table's shape (the level tables equal too); the unlock
    schedule agrees but for tpu_opt.json's own valid_level_scale."""
    got = dataclasses.asdict(tvariants.flagship_grid(variant))
    assert got == dataclasses.asdict(jvariants.flagship_grid(variant))
    assert tvariants.FLAGSHIP_VARIANTS == jvariants.FLAGSHIP_VARIANTS
    grid = config_from_json(f"configs/{json_name}")[0].field.grid
    from_json = dataclasses.asdict(grid)
    assert {k: v for k, v in got.items() if k not in _SCHEDULE} == {
        k: v for k, v in from_json.items() if k not in _SCHEDULE}
    assert tvariants.flagship_grid(variant).level_tables() == grid.level_tables()
    differ = {k for k in _SCHEDULE if got[k] != from_json[k]}
    assert differ == ({"valid_level_scale"} if variant == "tpu_opt" else set())
    assert tvariants.flagship_grid(None) == tvariants.flagship_grid("parity")
