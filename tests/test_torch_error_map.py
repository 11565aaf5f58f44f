"""Port parity of the error map (``engine/error_map.py``) and the load-time
sharpness maps (``ops/image.py::sharpness_maps``) against ``neus2_tpu``,
on the same numpy inputs; the JAX sampler's uniforms and jitter are drawn
from its key and injected into the port's.

Tolerances: sizes, cells, image indices and the rebuild schedule exactly;
the sharpness update exactly (a max and one product per ray on both
sides) and the sharpness maps within 1e-6 relative (the same numpy
arithmetic); deposits within 1e-6 of the map's max (adds to one cell go in
another order: four passes in the JAX package, one accumulating
``index_put_`` here); the CDF within one ulp at 1.0 (2^-23) abs: both
packages take the same two-level blocked prefix sum, whose sums still
round in another order within a block (the bound was 2e-6 while the port
took one 1-D ``torch.cumsum``); sampled uv within 1e-7.

The JAX package's ``rebuild_cdf`` drops the sharpness grid (ROADMAP Queue
3); the port keeps it, and ``test_rebuild_cdf_keeps_the_sharpness_grid``
asserts that divergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.engine import error_map as jem
from neus2_tpu.ops.image import sharpness_maps as jax_sharpness_maps
from neus2_tpu_torch import interop
from neus2_tpu_torch.engine import error_map as tem
from neus2_tpu_torch.ops.image import sharpness_maps

torch.set_num_threads(2)
T = torch.from_numpy
N_IMG, RES = 3, 48  # 6,912 cells: past the JAX package's 4,096-cell block


def _random_state(seed, sharpness_cells=0):
    rng = np.random.default_rng(seed)
    em = rng.gamma(0.5, 1.0, (N_IMG, RES, RES)).astype(np.float32)
    em[1, :4] = 0.0  # empty rows and cells get the uniform floors only
    js = jem.init_error_map(N_IMG, RES, sharpness_cells)._replace(error_map=jnp.asarray(em))
    return js, interop.error_map_from_jax(jax.device_get(js))


def test_resolution_and_init_match():
    for args in [(4096, 16, 256), (1024, 100, 512), (64, 4, 32), (8, 1000, 8)]:
        assert tem.resolution_for(*args) == jem.resolution_for(*args)
    for cells in (0, 4096):
        j, t = jem.init_error_map(N_IMG, RES, cells), tem.init_error_map(N_IMG, RES, cells)
        np.testing.assert_array_equal(t.error_map.numpy(), np.asarray(j.error_map))
        np.testing.assert_array_equal(t.cdf.numpy(), np.asarray(j.cdf))
        assert (t.sharpness_grid is None) == (j.sharpness_grid is None)
        if cells:
            np.testing.assert_array_equal(t.sharpness_grid.numpy(), np.asarray(j.sharpness_grid))
        assert t.res == j.res == RES


def test_should_rebuild_schedule():
    steps = range(3000)
    assert [tem.should_rebuild(s) for s in steps] == [jem.should_rebuild(s) for s in steps]
    assert tem.should_rebuild(128) and tem.should_rebuild(192) and not tem.should_rebuild(129)


def test_sharpness_weight_and_update_matches():
    rng = np.random.default_rng(1)
    grid = rng.uniform(0, 2, 512).astype(np.float32)
    cells = rng.integers(0, 64, 300)  # repeated cells: several maxes into one
    sharp = rng.uniform(0, 3, 300).astype(np.float32)
    valid = rng.uniform(size=300) < 0.7
    jw, jg = jem.sharpness_weight_and_update(jnp.asarray(grid), jnp.asarray(cells),
                                             jnp.asarray(sharp), jnp.asarray(valid))
    tw, tg = tem.sharpness_weight_and_update(T(grid), T(cells), T(sharp), T(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (tw[~T(valid)] == 1.0).all()


def test_deposit_matches():
    js, ts = _random_state(2)
    rng = np.random.default_rng(2)
    n = 2000
    img = rng.integers(0, N_IMG, n)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5 / RES] * 2, [1 - 0.5 / RES] * 2,
              [0.999999, 0.0], [0.25, 0.999999]]  # edges: the clamp to res - 2
    loss = rng.uniform(0, 1, n).astype(np.float32)
    jd = jem.deposit(js, jnp.asarray(img), jnp.asarray(uv), jnp.asarray(loss))
    td = tem.deposit(ts, T(img), T(uv), T(loss))
    ref = np.asarray(jd.error_map)
    assert np.abs(td.error_map.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(td.cdf.numpy(), np.asarray(jd.cdf))


@pytest.mark.parametrize("seed", [3, 4])
def test_rebuild_cdf_matches(seed):
    js, ts = _random_state(seed)
    jr, tr = jem.rebuild_cdf(js), tem.rebuild_cdf(ts)
    np.testing.assert_allclose(tr.cdf.numpy(), np.asarray(jr.cdf), rtol=0, atol=2.0**-23)
    assert float(tr.cdf[-1]) == 1.0
    assert (tr.cdf[1:] >= tr.cdf[:-1]).all()
    np.testing.assert_array_equal(tr.error_map.numpy(), np.asarray(jr.error_map))
    assert not tr.error_map.any()


def test_rebuild_cdf_keeps_the_sharpness_grid():
    """The reference defect the port does not copy: after the JAX package's
    rebuild the grid is gone (the weighting turns itself off at step 128);
    the port's rebuild keeps it, as the reference does."""
    js, ts = _random_state(5, sharpness_cells=4096)
    grid = np.random.default_rng(5).uniform(0, 1, 4096).astype(np.float32)
    js = js._replace(sharpness_grid=jnp.asarray(grid))
    ts = ts._replace(sharpness_grid=T(grid))
    jr, tr = jem.rebuild_cdf(js), tem.rebuild_cdf(ts)
    assert jr.sharpness_grid is None
    np.testing.assert_array_equal(tr.sharpness_grid.numpy(), grid)
    np.testing.assert_allclose(tr.cdf.numpy(), np.asarray(jr.cdf), rtol=0, atol=2.0**-23)


def test_sample_pixels_with_injected_draws():
    js, ts = _random_state(6)
    js, ts = jem.rebuild_cdf(js), tem.rebuild_cdf(ts)
    ts = ts._replace(cdf=T(np.array(js.cdf)))  # the same CDF: draws compare exactly
    key = jax.random.PRNGKey(6)
    n = 4096
    j_img, j_uv = jem.sample_pixels(js, key, n, N_IMG)
    k_u, k_j = jax.random.split(key)
    u = T(np.array(jax.random.uniform(k_u, (n,))))
    jitter = T(np.array(jax.random.uniform(k_j, (n, 2))))
    t_img, t_uv = tem.sample_pixels(ts, u, jitter, N_IMG)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), rtol=0, atol=1e-7)

    # side="left" at ties: a uniform equal to a CDF value takes that cell,
    # as jnp.searchsorted(..., side="left") does; 1.0 takes the last cell.
    cdf = np.asarray(js.cdf)
    u_tie = np.concatenate([cdf[[0, 17, 500, 6000]], [0.0, 1.0]]).astype(np.float32)
    want = np.minimum(np.asarray(jnp.searchsorted(js.cdf, u_tie, side="left")),
                      N_IMG * RES * RES - 1)
    t_img, _ = tem.sample_pixels(ts, T(u_tie), torch.zeros(6, 2), N_IMG)
    np.testing.assert_array_equal(t_img.numpy(), want // (RES * RES))


def test_sharpness_maps_match():
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (2, 40, 56, 4)).astype(np.float32)
    for res in [(128, 72), (16, 8)]:
        got, ref = sharpness_maps(imgs, res), jax_sharpness_maps(imgs, res)
        assert got.shape == ref.shape == (2, res[1], res[0]) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
