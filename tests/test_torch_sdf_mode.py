"""The port's SDF-from-mesh mode (``neus2_tpu_torch/engine/sdf_mode.py``
and the ``TriangleBVH`` binding of ``native/triangle_bvh.cpp``) held
against the JAX package's on the JAX tests' cube mesh.

Tolerances: the BVH's distances, hits and face normals within 1e-6 (the
two packages build the same source with other compiler flags, so a
distance may move by an ulp); the OBJ reader, ``normalize_mesh`` and the
pool's points bitwise (numpy draws in the same order), the pool's
distances within 1e-6.  Fit steps at a small width with the JAX package's
batch indices injected: losses rtol 1e-5; MLP leaves within 1e-4 of their
max; a hash table on all but 0.5% of its entries within 1e-4 of its max
and everywhere within the learning rate (with eps 1e-15, Adam turns a
gradient of rounding size into a full step; tests/test_torch_testbed_loop.py
states the rule).  The sphere-traced render of the same params: hit masks
equal but on at most 1% of the pixels (a ray whose march ends within a
rounding of the hit threshold, or next to a hash-cell face, where the
SDF's gradient jumps); on pixels both hit, depth within 5e-4 (one march
step may stop a step apart: steps below the 5e-4 hit threshold) and the
normal map within 1e-3 on all but 1% of them.  IoU within 1e-4.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.data.synthetic import _look_at as jlook_at
from neus2_tpu.engine import sdf_mode as jsdf
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.native import TriangleBVH as JBVH
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.engine import sdf_mode
from neus2_tpu_torch.native import TriangleBVH
from neus2_tpu_torch.utils.optim import plain_adam_init
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
LO, HI = 0.32, 0.68
LR = 3e-3


def cube_mesh():
    """tests/test_sdf_mode.py's cube, [0.32, 0.68]^3, 12 outward triangles."""
    v = np.array([[x, y, z] for z in (LO, HI) for y in (LO, HI) for x in (LO, HI)], np.float32)

    def q(a, b, c, d):
        return [[a, b, c], [a, c, d]]

    f = q(0, 2, 3, 1) + q(4, 5, 7, 6) + q(0, 1, 5, 4) + q(2, 6, 7, 3) + q(0, 4, 6, 2) + q(1, 3, 7, 5)
    return v, np.array(f, np.int32)


def write_cube_obj(path):
    v, f = cube_mesh()
    lines = ["# cube"] + [f"v {a} {b} {c}" for a, b, c in v] + [
        f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}" for a, b, c in f]
    path.write_text("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def bvhs():
    v, f = cube_mesh()
    return TriangleBVH(v, f), JBVH(v, f)


def test_bvh_matches_jax(bvhs):
    bvh, jbvh = bvhs
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.1, 0.9, (4000, 3)).astype(np.float32)
    for fn in ("signed_distance", "unsigned_distance"):
        got, ref = getattr(bvh, fn)(pts), getattr(jbvh, fn)(pts)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=fn)
    sd = bvh.signed_distance(pts, n_threads=1)
    inside = np.all((pts > LO) & (pts < HI), axis=-1)
    np.testing.assert_array_equal(sd < 0, inside)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    (t, tri), (jt, jtri) = bvh.raycast(pts, d), jbvh.raycast(pts, d)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tri, jtri)
    assert (t[inside] > 0).all() and (t[~inside] < 0).any()  # inside, every ray hits a face
    np.testing.assert_allclose(bvh.face_normals(), jbvh.face_normals(), rtol=0, atol=1e-6)
    assert bvh.face_normals().shape == (12, 3)


def test_bvh_rejects_empty_mesh():
    v, _ = cube_mesh()
    with pytest.raises(ValueError, match="face"):
        TriangleBVH(v, np.zeros((0, 3), np.int32))


@pytest.mark.parametrize("side, hit", [(1e-5, False), (1e-4, True)])
def test_bvh_raycast_keeps_the_absolute_det_cut(side, hit):
    """triangle_bvh.cpp's Moller-Trumbore skips |det| < 1e-9: a ray along
    +z through a right triangle of legs ``side`` in the z = 0.5 plane has
    |det| = side^2, so a 1e-5 triangle is missed and a 1e-4 one hit, in
    both packages."""
    v = np.array([[0.5, 0.5, 0.5], [0.5 + side, 0.5, 0.5], [0.5, 0.5 + side, 0.5]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    o = np.array([[0.5 + side / 4, 0.5 + side / 4, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, tri = TriangleBVH(v, f).raycast(o, d)
    jt, _ = JBVH(v, f).raycast(o, d)
    assert (t[0] > 0) == hit and (tri[0] == 0) == hit
    np.testing.assert_array_equal(t, jt)
    if hit:
        np.testing.assert_allclose(t[0], 0.5, atol=1e-6)


def test_obj_roundtrip_and_normalize_bitwise(tmp_path):
    path = write_cube_obj(tmp_path / "cube.obj")
    (v, f), (jv, jf) = sdf_mode.load_mesh_obj(path), jsdf.load_mesh_obj(path)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(f, cube_mesh()[1])
    (nv, s, off), (jnv, js, joff) = sdf_mode.normalize_mesh(v), jsdf.normalize_mesh(jv)
    np.testing.assert_array_equal(nv, jnv)
    np.testing.assert_array_equal(off, joff)
    assert s == js and nv.min() > 0.1 and nv.max() < 0.9


def test_training_pool_matches_jax(bvhs):
    bvh, jbvh = bvhs
    v, f = cube_mesh()
    pts, dist = sdf_mode.generate_training_pool(bvh, v, f, 8000, seed=1)
    jpts, jdist = jsdf.generate_training_pool(jbvh, v, f, 8000, seed=1)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dist[:4000], 0.0)


def _configs():
    jcfg = jsdf.SdfFitConfig(
        field=JFieldConfig(grid=JGrid(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                                      per_level_scale=1.6),
                           sdf_hidden_dim=16, sdf_n_hidden=2),
        batch_size=512, pool_size=4096, lr=LR)
    return jcfg, interop.sdf_config_from_jax(jcfg)


@pytest.fixture(scope="module")
def stepped(bvhs):
    """3 fit steps in each package from the JAX init, with the JAX step's
    batch indices given to the port."""
    jcfg, cfg = _configs()
    v, f = cube_mesh()
    pts, dist = jsdf.generate_training_pool(bvhs[1], v, f, jcfg.pool_size, seed=0)
    jparams = jsdf.init_field(jax.random.PRNGKey(0), jcfg.field)
    jopt = jsdf.make_sdf_optimizer(jcfg).init(jparams)
    params = interop.params_from_jax(jax.device_get(jparams))
    opt = plain_adam_init(params)
    pool_pts, pool_d = torch.from_numpy(pts), torch.from_numpy(dist)
    key = jax.random.PRNGKey(1)
    losses, jlosses = [], []
    for _ in range(3):
        key, k = jax.random.split(key)
        idx = torch.from_numpy(np.array(jax.random.randint(k, (jcfg.batch_size,), 0, len(pts))))
        jparams, jopt, jloss = jsdf.sdf_fit_step(jparams, jopt, k, jnp.asarray(pts),
                                                 jnp.asarray(dist), jcfg)
        params, opt, loss = sdf_mode.sdf_fit_step(params, opt, pool_pts, pool_d, cfg, idx=idx)
        losses.append(float(loss))
        jlosses.append(float(jloss))
    return jcfg, cfg, jax.device_get(jparams), params, losses, jlosses


def test_fit_steps_match_jax(stepped):
    _, cfg, jparams, params, losses, jlosses = stepped
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert cfg.loss == "relative_l2" and cfg.batch_size == 512
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for name, a, b in zip(paths, jax.tree_util.tree_leaves(jparams), tree_leaves(params)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        diff = np.abs(b - a)
        bound = 1e-4 * max(np.abs(a).max(), 1e-12)
        if "hashgrid" in name:
            assert (diff > bound).mean() <= 0.005, name
            assert diff.max() <= LR * 1.001, name
        else:
            assert diff.max() <= bound, name


def test_sphere_trace_matches_jax(stepped):
    jcfg, cfg, jparams, _, _, _ = stepped
    params = interop.params_from_jax(jparams)
    res = 32
    pose = jlook_at(np.array([0.5, -0.75, 0.9], np.float32), np.full(3, 0.5, np.float32),
                    np.array([0.0, 0.0, 1.0], np.float32))
    focal = np.full((2,), 0.5 * res / np.tan(0.35), np.float32)
    jrgb, jdepth, jhit = (np.asarray(a) for a in jsdf.render_sdf_sphere_traced(
        jparams, jnp.asarray(pose), jnp.asarray(focal), jcfg, resolution=(res, res)))
    rgb, depth, hit = (a.numpy() for a in sdf_mode.render_sdf_sphere_traced(
        params, torch.from_numpy(pose), torch.from_numpy(focal), cfg, resolution=(res, res)))
    assert rgb.shape == (res, res, 3) and depth.shape == hit.shape == (res, res)
    assert jhit.sum() > 100
    assert (hit != jhit).mean() <= 0.01
    both = hit & jhit
    np.testing.assert_allclose(depth[both], jdepth[both], rtol=0, atol=5e-4)
    assert (np.abs(rgb[both] - jrgb[both]).max(-1) > 1e-3).mean() <= 0.01
    assert (rgb[~hit] == 0).all() and rgb.min() >= 0 and rgb.max() <= 1


def test_eval_iou_matches_jax(stepped, bvhs):
    jcfg, cfg, jparams, _, _, _ = stepped
    params = interop.params_from_jax(jparams)
    iou = sdf_mode.eval_iou(params, cfg, bvhs[0], n=20_000, seed=2, chunk=4096)
    jiou = jsdf.eval_iou(jparams, jcfg, bvhs[1], n=20_000, seed=2)
    assert abs(iou - jiou) <= 1e-4 and 0.0 < iou <= 1.0


def test_cpu_fit_reaches_iou(bvhs):
    """tests/test_sdf_mode.py::test_fit_converges_iou's bar, in 300 port
    steps on the CPU at that test's width."""
    cfg = interop.sdf_config_from_jax(jsdf.SdfFitConfig(
        field=JFieldConfig(grid=JGrid(n_levels=6, log2_hashmap_size=13, base_resolution=8,
                                      per_level_scale=1.6), sdf_hidden_dim=32, sdf_n_hidden=1),
        batch_size=4096, pool_size=1 << 16, lr=3e-3))
    v, f = cube_mesh()
    bvh = bvhs[0]
    pts, dist = sdf_mode.generate_training_pool(bvh, v, f, cfg.pool_size, seed=0)
    params, opt = sdf_mode.init_sdf_fit(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    pool_pts, pool_d = torch.from_numpy(pts), torch.from_numpy(dist)
    t0 = time.perf_counter()
    for _ in range(300):
        params, opt, loss = sdf_mode.sdf_fit_step(params, opt, pool_pts, pool_d, cfg, gen)
    assert time.perf_counter() - t0 < 60
    iou = sdf_mode.eval_iou(params, cfg, bvh, n=50_000)
    assert iou > 0.9, (iou, float(loss))
    surf, _ = sdf_mode.generate_training_pool(bvh, v, f, 4096, seed=3)
    pred, _ = sdf_mode.sdf_fn(params, torch.from_numpy(surf[:2048]), cfg.field)
    assert float(pred.abs().mean()) < 0.01


def test_cli_sdf_mode(tmp_path):
    """``--mode sdf`` on the cube OBJ at the default width: the eval json,
    the render and the mesh written, the IoU the Python API's."""
    from PIL import Image

    obj = write_cube_obj(tmp_path / "cube.obj")
    res = run.main(["--mode", "sdf", "--scene", str(obj), "--device", "cpu", "--n_steps", "1",
                    "--sdf_render_res", "24", "--save_mesh", "--mesh_resolution", "24",
                    "--output_dir", str(tmp_path / "out"), "--name", "s"])
    out = tmp_path / "out" / "s"
    import json

    ev = json.loads((out / "logs" / "sdf_eval.json").read_text())
    params, cfg, bvh, _ = sdf_mode.fit_mesh_sdf(obj, n_steps=1, seed=0, verbose=False,
                                                device="cpu")
    assert ev == {"steps": 1, "iou": sdf_mode.eval_iou(params, cfg, bvh)} and ev["iou"] == res["iou"]
    assert cfg == sdf_mode.SdfFitConfig() and cfg.field.grid.n_levels == 14
    with Image.open(out / "sdf_render.png") as im:
        assert im.size == (24, 24) and im.mode == "RGB"
    v, f = sdf_mode.load_mesh_obj(out / "mesh" / "sdf_mesh.obj")
    assert len(f) > 100 and len(v) == len(res["sdf_mesh"][0])
