"""Port parity of the quality tools' protocol code (``neus2_tpu_torch/tools/
protocol.py``, ``dynamic_quality.py``) with the TPU package's root tools
(``tools_tpu_validate_csg.py``, ``tools_dynamic_quality.py``), on the same
inputs at a small width.

The root tools set the TPU package's persistent compile cache when they
are imported, so they run in a subprocess (``jax_tools``), never in a test
worker.  The held-out eval, the |SDF| on ground-truth points and the mesh
are compared on one field carried across by ``interop``, the renders at
spp 1 without jitter (as tests/test_torch_render_mesh.py does; at spp > 1
each package draws its passes from its own generator).

Tolerances: the ground-truth points and the datasets bitwise (the same
numpy code on the same draws; the dataset's views rendered in a pool of
processes); renders agree to 3e-4 a pixel (test_torch_render_mesh.py), so
PSNR to 0.03 dB and SSIM to 1e-3; the |SDF| mean to 1e-6; the mesh's
vertex count after ``largest_component`` exactly and the Chamfer distance
to 1e-6 (the SDF grids agree to 1e-5 and no grid value lies that close to
the level set).  A chunked run resumed from its snapshot equals a straight
run bitwise.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.data import synthetic as jsyn
from neus2_tpu.engine import mesh as jmesh
from neus2_tpu.engine import occupancy as jocc
from neus2_tpu.engine import render as jrender
from neus2_tpu.models import delta as jdelta
from neus2_tpu.models import field as jf
from neus2_tpu.ops import image as jimage
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.ops.warp import AABB as JAABB
from neus2_tpu_torch import interop
from neus2_tpu_torch.engine import occupancy as tocc
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.tools import dynamic_quality, protocol, validate_csg

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SCENES = ("csg", "dumbbell", "bowl")
N_GT = 16384  # the tools' own count
G = 128
_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
MESH_RES = 48
RES = 24

# Runs in a subprocess with the repo root as its working directory: the
# root tools' ``gt_surface_points`` for each scene (the tool reads
# CSG_SCENE when it is imported) and ``eval_frame`` with the pose error of
# its frame callback, on the pickled field of ``carried``.
JAX_TOOLS = textwrap.dedent("""
    import importlib, json, os, pickle, sys
    from types import SimpleNamespace
    import numpy as np
    sys.path.insert(0, os.getcwd())
    out_dir, n_gt = sys.argv[1], int(sys.argv[2])
    sys.argv = sys.argv[:1]
    import jax
    import jax.numpy as jnp
    tool = None
    for scene in ("csg", "dumbbell", "bowl"):
        os.environ["CSG_SCENE"] = scene
        tool = importlib.reload(tool) if tool else importlib.import_module("tools_tpu_validate_csg")
        np.save(f"{out_dir}/gt_{scene}.npy", tool.gt_surface_points(n_gt))
    import tools_dynamic_quality as tdq
    jax.config.update("jax_compilation_cache_dir", None)
    from neus2_tpu.engine.occupancy import OccupancyGrid
    from neus2_tpu.models.field import FieldConfig
    from neus2_tpu.ops.hashgrid import HashGridConfig
    with open(f"{out_dir}/carried.pkl", "rb") as f:
        c = pickle.load(f)
    render = tdq.render_image
    tdq.render_image = lambda *a, **kw: render(*a, **dict(kw, spp=1))  # no jitter
    tb = SimpleNamespace(
        state=SimpleNamespace(ema_params=jax.tree_util.tree_map(jnp.asarray, c["params"]),
                              occupancy=OccupancyGrid(jnp.asarray(c["density"]),
                                                      jnp.asarray(c["density"] > 0.05),
                                                      jnp.int32(5))),
        effective_acc={k: jnp.asarray(v) for k, v in c["acc"].items()},
        config=SimpleNamespace(field=FieldConfig(grid=HashGridConfig(**c["grid"]), **c["field"]),
                               aabb_scale=1))
    frames = tdq.make_moving_sphere_frames(n_frames=2, translation_per_frame=tdq.SHIFT,
                                           n_views=3, resolution=c["res"])
    k = 1
    acc = jax.device_get(tb.effective_acc)
    t_err = float(np.linalg.norm(np.asarray(acc["transition"]) + k * np.asarray(tdq.SHIFT)))
    with open(f"{out_dir}/dynamic.json", "w") as f:
        json.dump({"psnr": tdq.eval_frame(tb, frames[k]), "pose_err": t_err}, f)
""")


@pytest.fixture(scope="module")
def carried():
    """A textured field (the sphere init, tables x 30), an occupancy ball of
    radius 0.3 and a rigid transform, in both packages."""
    jc = jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD)
    tc = tf.FieldConfig(grid=TGrid(**_GRID), **_FIELD)
    p = jf.init_field(jax.random.PRNGKey(0), jc)
    p["hashgrid"] = tuple(t * 30.0 for t in p["hashgrid"])
    pj = jax.tree_util.tree_map(np.asarray, p)
    c = (np.arange(G) + 0.5) / G - 0.5
    ball = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 < 0.3**2
    dens = np.where(ball, 0.1, 0.0).astype(np.float32)[None]
    ang = 0.05
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    acc = {"rotation": rot, "transition": np.array([-0.03, 0.004, -0.002], np.float32)}
    return {
        "jc": jc, "tc": tc, "pj": pj,
        "jp": jax.tree_util.tree_map(jnp.asarray, pj), "tp": interop.params_from_jax(pj),
        "dens": dens, "acc": acc,
        "jocc": jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(dens > 0.05), jnp.int32(5)),
        "tocc": tocc.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(dens > 0.05), 5),
    }


@pytest.fixture(scope="module")
def jax_tools(carried, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tools")
    with open(out / "carried.pkl", "wb") as f:
        pickle.dump({"params": carried["pj"], "density": carried["dens"], "acc": carried["acc"],
                     "grid": _GRID, "field": _FIELD, "res": RES}, f)
    res = subprocess.run([sys.executable, "-c", JAX_TOOLS, str(out), str(N_GT)], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_gt_surface_points_match_the_tool_bitwise(jax_tools, scene):
    ref = np.load(jax_tools / f"gt_{scene}.npy")
    got = protocol.gt_surface_points(protocol.SCENES[scene][0], N_GT)
    assert got.dtype == np.float32 and got.shape == (N_GT, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scene", SCENES)
def test_pooled_cached_dataset_matches_make_csg_dataset_bitwise(tmp_path, monkeypatch, scene):
    """Poses drawn first in view order, views rendered in two spawned
    processes, then read back from the ``.npz`` cache: the serial
    function's arrays, bit for bit."""
    sdf, albedo = jsyn.SCENES[scene]
    ref = jsyn.make_csg_dataset(n_views=3, resolution=20, sdf=sdf, albedo=albedo)
    pooled = protocol.scene_dataset(scene, 3, 20, tmp_path, workers=2)
    assert (tmp_path / f"csg_ds_{scene}_3v_20.npz").exists()

    def no_render(*a, **kw):
        raise AssertionError("the cached dataset was rendered again")

    monkeypatch.setattr(protocol, "render_views", no_render)
    cached = protocol.scene_dataset(scene, 3, 20, tmp_path)
    for ds in (pooled, cached):
        for f in ("images", "poses", "focal", "principal"):
            np.testing.assert_array_equal(getattr(ds, f), getattr(ref, f), err_msg=f)
        assert (ds.scale, ds.offset, ds.aabb_scale, ds.from_na) == (
            ref.scale, ref.offset, ref.aabb_scale, ref.from_na)


def _jax_heldout(c, ds, k):
    """The root validation tool's eval of view ``k`` (its :186-206) at spp 1."""
    cams = ds.cameras()
    rcfg = jrender.RenderConfig(field=c["jc"], samples_per_ray=128, n_candidates=256,
                                chunk=1 << 13)
    rgb, _, _ = jrender.render_image(c["jp"], jdelta.init_accumulated(), c["jocc"], cams,
                                     cams.poses[k], cams.focal[k], cams.principal[k],
                                     jax.random.PRNGKey(k), rcfg, background=0.0, spp=1)
    target = jimage.srgb_eval_target(jnp.asarray(ds.images[k]))
    return float(jimage.psnr(rgb, target)), float(jimage.ssim(rgb, target))


def _jax_chamfer(verts, gt):
    """The root validation tool's Chamfer distance (its :218-236)."""
    v, g = jnp.asarray(np.asarray(verts, np.float32)), jnp.asarray(gt)

    def directed(a, b):
        def one(chunk):
            return jnp.linalg.norm(chunk[:, None, :] - b[None, :, :], axis=-1).min(axis=1)
        return float(jnp.concatenate([one(a[i:i + 1024]) for i in range(0, a.shape[0], 1024)])
                     .mean())

    sub = v[:: max(1, v.shape[0] // 16384)]
    return 0.5 * (directed(sub, g) + directed(g, sub))


def test_heldout_eval_sdf_and_chamfer_match_the_tool(carried, jax_tools):
    c = carried
    ds = jsyn.make_csg_dataset(n_views=3, resolution=RES)
    state = SimpleNamespace(ema_params=c["tp"], acc=None, occupancy=c["tocc"])
    psnrs, ssims = protocol.heldout_eval(state, c["tc"], interop.dataset_from_jax(ds), [1, 2],
                                         spp=1)
    for k, p, s in zip([1, 2], psnrs, ssims):
        rp, rs = _jax_heldout(c, ds, k)
        assert abs(p - rp) < 0.03 and abs(s - rs) < 1e-3, (k, p, rp, s, rs)
        assert 5.0 < p < 40.0

    gt = np.load(jax_tools / "gt_csg.npy")
    ref_sdf = float(jnp.abs(jf.sdf_fn(c["jp"], jnp.asarray(gt), c["jc"])[0]).mean())
    assert abs(protocol.surface_sdf_err(c["tp"], c["tc"], gt) - ref_sdf) < 1e-6

    box = JAABB(jnp.full((3,), 0.15), jnp.full((3,), 0.85))
    jv, jt = jmesh.extract_mesh(c["jp"], c["jc"], resolution=MESH_RES, box=box)
    jv, jt = jmesh.largest_component(np.asarray(jv), np.asarray(jt))
    chamfer, n_verts = protocol.mesh_chamfer(c["tp"], c["tc"], gt, resolution=MESH_RES)
    assert n_verts == jv.shape[0] > 100
    assert abs(chamfer - _jax_chamfer(jv, gt)) < 1e-6


def test_eval_frame_and_pose_error_match_the_tool(carried, jax_tools):
    c = carried
    ref = json.loads((jax_tools / "dynamic.json").read_text())
    frames = dynamic_quality.make_moving_sphere_frames(
        n_frames=2, translation_per_frame=dynamic_quality.SHIFT, n_views=3, resolution=RES)
    acc = {k: torch.from_numpy(v) for k, v in c["acc"].items()}
    tb = SimpleNamespace(state=SimpleNamespace(ema_params=c["tp"], acc=None, occupancy=c["tocc"]),
                         effective_acc=acc, config=SimpleNamespace(field=c["tc"], aabb_scale=1))
    got = dynamic_quality.eval_frame(tb, frames[1], spp=1)
    assert abs(got - ref["psnr"]) < 0.03 and 5.0 < got < 40.0, (got, ref)
    assert abs(dynamic_quality.pose_error(tb, 1) - ref["pose_err"]) < 1e-7


def small_config(opts):
    """``validate_csg``'s config at a small width."""
    import dataclasses

    cfg = validate_csg.csg_config(error_map=opts.error_map)
    return dataclasses.replace(
        cfg, field=dataclasses.replace(cfg.field, grid=TGrid(**_GRID), **_FIELD),
        n_rays=128, samples_per_ray=32, n_candidates=64, occ_n_probe=1 << 12)


def _validate(workdir, *flags):
    opts = validate_csg.parse_args(["136", "--views", "4", "--eval-views", "1", "--res", "24",
                                    "--error-map", "--budget-s", "1e9", "--device", "cpu",
                                    "--workdir", str(workdir), *flags])
    return validate_csg.run(opts, small_config(opts)), opts


def test_chunked_run_equals_a_straight_run_bitwise(tmp_path, monkeypatch):
    """With the error map on, a run paused at step 130, past the error
    CDF's first rebuild (step 128), and resumed in a fresh Testbed from its
    snapshot ends with the straight run's parameters, optimizer, occupancy
    and error-map state and metrics, bit for bit (no bucket switch in
    either)."""
    monkeypatch.setattr(validate_csg, "N_GT_POINTS", 2048)
    monkeypatch.setattr(validate_csg, "MESH_RES", 32)
    monkeypatch.setattr(protocol, "default_workers", lambda: 1)
    straight, opts = _validate(tmp_path / "straight")
    assert _validate(tmp_path / "chunked", "--chunk-steps", "130")[0] is None
    chunked, _ = _validate(tmp_path / "chunked")
    assert chunked == straight
    tag = validate_csg.run_tag(opts)
    recs = [json.loads((tmp_path / d / f"{tag}_record.json").read_text())
            for d in ("straight", "chunked")]
    assert [(c["from_step"], c["to_step"]) for c in recs[1]["chunks"]] == [(0, 130), (130, 136)]
    assert recs[0]["bucket_history"] == recs[1]["bucket_history"] == []
    from neus2_tpu_torch.api import msgpack_codec

    a, b = (msgpack_codec.unpackb((tmp_path / d / f"{tag}.msgpack").read_bytes())["leaves"]
            for d in ("straight", "chunked"))
    assert sorted(a) == sorted(b) and any("error_map" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
