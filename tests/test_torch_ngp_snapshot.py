"""Reference-format (instant-ngp/NeuS2) snapshots in the port
(``api/ngp_snapshot.py``): counterparts of tests/test_ngp_snapshot.py's 5
tests and tests/test_ngp_snapshot_golden.py's 4, with the golden document
assembled inside the test as there, and the port's export of the JAX
package's params byte for byte the JAX package's export.

Tolerances: none beyond fp16 rounding, which the format applies and both
sides apply the same way (``f2``); exports compare byte for byte.
"""

import copy
import math

import jax
import msgpack
import numpy as np
import pytest
import torch

from neus2_tpu.api import ngp_snapshot as jngp
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.models.field import init_field as jinit_field
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.api.ngp_snapshot import (
    field_config_from_ngp, load_reference_snapshot, morton3d, ngp_n_params,
    save_reference_snapshot,
)
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine.occupancy import update_bitfield
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig, init_field
from neus2_tpu_torch.ops.hashgrid import HashGridConfig

torch.set_num_threads(2)

_CFG = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=1.6)
_MLPS = dict(sdf_hidden_dim=32, sdf_n_hidden=1, rgb_hidden_dim=32, rgb_n_hidden=2)
CFG = FieldConfig(grid=HashGridConfig(**_CFG), **_MLPS)


def f2(a):
    return np.asarray(a, np.float32).astype("<f2").astype(np.float32)


def numpy_params(seed: int) -> dict:
    return interop.tree_to_numpy(init_field(torch.Generator().manual_seed(seed), CFG))


# -- tests/test_ngp_snapshot.py ------------------------------------------------


def test_morton_convention():
    """tcnn morton3D: x in the lowest bit (testbed_nerf.cu:555-565)."""
    x, y, z = np.array([1, 0, 0, 3]), np.array([0, 1, 0, 5]), np.array([0, 0, 1, 7])
    m = morton3d(x, y, z)
    assert m[0] == 1 and m[1] == 2 and m[2] == 4
    expect = 0
    for b in range(3):
        expect |= ((3 >> b) & 1) << (3 * b)
        expect |= ((5 >> b) & 1) << (3 * b + 1)
        expect |= ((7 >> b) & 1) << (3 * b + 2)
    assert m[3] == expect
    np.testing.assert_array_equal(m, jngp.morton3d(x, y, z))


def test_roundtrip_params_exact(tmp_path):
    """Export -> import puts every weight (up to fp16) in its place: MLP
    transposes, input-column slices, per-level tables, variance, the
    Morton-ordered density grid, the accumulated transform."""
    params = numpy_params(3)
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    acc = {"rotation": rng.normal(size=(3, 3)).astype(np.float32),
           "transition": rng.normal(size=(3,)).astype(np.float32)}
    fp = tmp_path / "ref.msgpack"
    save_reference_snapshot(fp, params, CFG, density_grid=grid, acc=acc, aabb_scale=2,
                            training_step=123, loss=0.5)
    out = load_reference_snapshot(fp)
    assert out["config"].grid == CFG.grid and out["config"].sdf_hidden_dim == 32
    assert out["aabb_scale"] == 2 and out["training_step"] == 123 and out["loss"] == 0.5
    for ours, theirs in zip(params["hashgrid"], out["params"]["hashgrid"]):
        np.testing.assert_array_equal(f2(ours), theirs)
    for mlp in ("sdf_mlp", "rgb_mlp"):
        for la, lb in zip(params[mlp]["layers"], out["params"][mlp]["layers"]):
            np.testing.assert_array_equal(f2(la["w"]), lb["w"])
            assert (lb["b"] == 0).all()  # the reference's MLPs are bias-free
    assert out["params"]["variance"] == f2(params["variance"])
    np.testing.assert_array_equal(out["density_grid"], f2(grid))
    for k in ("rotation", "transition"):
        np.testing.assert_array_equal(out["acc"][k], f2(acc[k]))


def test_param_count_and_mismatch_guard(tmp_path):
    fp = tmp_path / "ref.msgpack"
    save_reference_snapshot(fp, numpy_params(0), CFG)
    data = fp.read_bytes()
    assert msgpack.unpackb(data, raw=False)["snapshot"]["n_params"] == ngp_n_params(CFG)
    assert ngp_n_params(CFG) == jngp.ngp_n_params(JFieldConfig(grid=JGrid(**_CFG), **_MLPS))
    other = FieldConfig(grid=HashGridConfig(n_levels=3, log2_hashmap_size=10, base_resolution=8,
                                            per_level_scale=1.5))
    with pytest.raises(ValueError, match="mismatch"):
        load_reference_snapshot(data, other)


def test_field_config_from_ngp_base_json_schema():
    """top_resolution configs derive per_level_scale the reset_network way
    (testbed.cu:2183-2189)."""
    cfg = field_config_from_ngp({
        "encoding": {"n_levels": 14, "n_features_per_level": 2, "log2_hashmap_size": 19,
                     "base_resolution": 16, "top_resolution": 2048},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
        "dir_encoding": {"nested": [{"otype": "SphericalHarmonics", "degree": 4}]},
    })
    assert cfg.grid.n_levels == 14 and cfg.sh_degree == 4
    assert abs(cfg.grid.per_level_scale
               - HashGridConfig.per_level_scale_from_top(16, 2048, 14)) < 1e-12


def test_testbed_loads_reference_snapshot_and_renders(tmp_path):
    """Testbed.load_snapshot sends a reference-format file to the shim,
    which installs params, density grid and accumulated transform; the
    imported model renders, and trains on with a fresh Adam."""
    cfg = TrainConfig(field=CFG, n_rays=32, samples_per_ray=8, n_candidates=16,
                      occ_n_probe=1 << 9)
    tb = ttb.Testbed(cfg, ttb.Hyperparams(first_frame_max_training_step=4), device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=2, resolution=24)])
    tb2 = copy.deepcopy(tb)
    for _ in range(3):
        tb.train()
    dg = tb.state.occupancy.density.numpy()
    fp = tmp_path / "ref_snapshot.msgpack"
    save_reference_snapshot(fp, interop.tree_to_numpy(tb.state.ema_params), CFG,
                            density_grid=dg, acc=interop.tree_to_numpy(tb.state.acc),
                            training_step=tb.training_step)
    tb2.load_snapshot(fp)
    assert tb2.training_step == tb.training_step
    np.testing.assert_array_equal(tb2.state.params["hashgrid"][0].numpy(),
                                  f2(tb.state.ema_params["hashgrid"][0].numpy()))
    np.testing.assert_array_equal(tb2.state.ema_params["sdf_mlp"]["layers"][0]["w"].numpy(),
                                  f2(tb.state.ema_params["sdf_mlp"]["layers"][0]["w"].numpy()))
    np.testing.assert_array_equal(tb2.state.occupancy.density.numpy(), f2(dg))
    occupancy = tb2.state.occupancy
    assert torch.equal(occupancy.bitfield, update_bitfield(occupancy).bitfield)
    assert occupancy.bitfield.any()
    assert tb2.state.opt_state["count"] == 0
    rgb, depth, alpha = tb2.render(0, spp=1)
    assert np.isfinite(rgb).all() and rgb.shape == (24, 24, 3)
    assert np.isfinite(tb.render(0, spp=1)[0]).all()
    tb2.train()
    assert tb2.state.opt_state["count"] == 1 and tb2.training_step == 4


# -- tests/test_ngp_snapshot_golden.py -----------------------------------------

GRID = HashGridConfig(n_levels=3, n_features_per_level=2, log2_hashmap_size=7, base_resolution=4,
                      per_level_scale=2.0)
CONFIG = FieldConfig(grid=GRID, sdf_hidden_dim=16, sdf_n_hidden=1, rgb_hidden_dim=16,
                     rgb_n_hidden=2, sh_degree=4)
D_IN, D_OUT, RGB_IN, RGB_OUT, W = 16, 16, 48, 16, 16  # all hand-derived


def ref_level_sizes():
    """Per-level (resolution, rows) the reference's way (grid.h), apart
    from ops/hashgrid.py."""
    out = []
    for lvl in range(GRID.n_levels):
        scale = math.exp(lvl * math.log(GRID.per_level_scale)) * GRID.base_resolution - 1.0
        res = int(math.ceil(scale)) + 1
        out.append((res, min(((res**3 + 7) // 8) * 8, 1 << GRID.log2_hashmap_size)))
    return out


def test_level_tables_match_reference_sizing():
    resolutions, _, offsets, sizes, _ = GRID.level_tables()
    ref = ref_level_sizes()
    assert list(resolutions) == [r for r, _ in ref] == [4, 8, 16]
    assert list(sizes) == [p for _, p in ref] == [64, 128, 128]
    assert list(offsets) == list(np.cumsum([0] + [p for _, p in ref])[:-1])


def _golden_params():
    """The flat fp16 params vector, assembled by hand, and what it holds."""
    rng = np.random.default_rng(7)

    def r16(*s):
        return rng.standard_normal(s).astype("<f2").astype(np.float32)

    d_in_used = r16(W, 9)  # padding columns [9:16] hold a sentinel to drop
    d_in_full = np.full((W, D_IN), 777.0, np.float32)
    d_in_full[:, :9] = d_in_used
    d_out = r16(D_OUT, W)
    r_in_full = np.full((W, RGB_IN), 777.0, np.float32)
    r_in_used = r16(W, 38)
    r_in_full[:, :38] = r_in_used
    r_hidden = r16(W, W)
    r_out_full = np.full((RGB_OUT, W), 777.0, np.float32)
    r_out_used = r16(3, W)
    r_out_full[:3] = r_out_used
    tables = [r16(n, 2) for n in (64, 128, 128)]
    variance = np.array([0.8125, 0.0, 0.0, 0.0], np.float32)
    parts = [d_in_full, d_out, r_in_full, r_hidden, r_out_full,
             np.concatenate([t.reshape(-1) for t in tables]), variance]
    flat = np.concatenate([p.reshape(-1) for p in parts]).astype("<f2")
    return flat, {"sdf_in": d_in_used, "sdf_out": d_out, "rgb_in": r_in_used,
                  "rgb_hidden": r_hidden, "rgb_out": r_out_used, "tables": tables,
                  "variance": 0.8125}


def _golden_density_grid(g=16, cascades=2):
    """The Morton-ordered fp16 buffer as the reference serializes it."""
    rng = np.random.default_rng(3)
    cells = rng.standard_normal((cascades, g, g, g)).astype("<f2").astype(np.float32)
    z, y, x = np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij")
    m = morton3d(x.ravel(), y.ravel(), z.ravel())
    buf = np.empty(cascades * g**3, np.float32)
    for k in range(cascades):
        buf[k * g**3 + m] = cells[k].reshape(-1)  # position morton(x,y,z) holds cell (x,y,z)
    return buf.astype("<f2"), cells


def _golden_doc():
    flat, expected = _golden_params()
    dg, cells = _golden_density_grid()
    rot = np.zeros(12, np.float32)
    rot[:9] = np.arange(1, 10)
    tra = np.array([0.25, -0.5, 0.75, 0.0], np.float32)
    doc = {
        "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                     "log2_hashmap_size": 7, "base_resolution": 4, "per_level_scale": 2.0},
        "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1},
        "rgb_network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"}]},
        "snapshot": {
            "n_params": int(flat.size), "params_binary": flat.tobytes(),
            "density_grid_size": 16, "density_grid_binary": dg.tobytes(),
            "rotation": rot.astype("<f2").tobytes(), "transition": tra.astype("<f2").tobytes(),
            "training_step": 1234, "loss": 0.0625, "nerf": {"aabb_scale": 2},
        },
    }
    return doc, expected, cells


def test_golden_fixture_loads():
    doc, expected, cells = _golden_doc()
    out = load_reference_snapshot(msgpack.packb(doc, use_bin_type=True))
    cfg = out["config"]
    assert cfg.grid == GRID
    assert (cfg.sdf_hidden_dim, cfg.sdf_n_hidden, cfg.rgb_hidden_dim, cfg.rgb_n_hidden) == (
        16, 1, 16, 2)
    p = out["params"]
    np.testing.assert_array_equal(p["sdf_mlp"]["layers"][0]["w"], expected["sdf_in"].T)
    np.testing.assert_array_equal(p["sdf_mlp"]["layers"][1]["w"], expected["sdf_out"].T)
    np.testing.assert_array_equal(p["rgb_mlp"]["layers"][0]["w"], expected["rgb_in"].T)
    np.testing.assert_array_equal(p["rgb_mlp"]["layers"][1]["w"], expected["rgb_hidden"].T)
    np.testing.assert_array_equal(p["rgb_mlp"]["layers"][2]["w"], expected["rgb_out"].T)
    assert not np.any(p["sdf_mlp"]["layers"][0]["b"]) and not np.any(p["rgb_mlp"]["layers"][2]["b"])
    assert len(p["hashgrid"]) == 3
    for got, want in zip(p["hashgrid"], expected["tables"]):
        np.testing.assert_array_equal(got, want)
    assert float(p["variance"]) == expected["variance"]
    np.testing.assert_array_equal(out["density_grid"], cells)
    g, rngc = 16, np.random.default_rng(11)
    dgbuf = np.frombuffer(doc["snapshot"]["density_grid_binary"], "<f2")
    for _ in range(20):
        k = int(rngc.integers(0, 2))
        x, y, z = (int(v) for v in rngc.integers(0, g, 3))
        m = int(morton3d(np.array([x]), np.array([y]), np.array([z]))[0])
        assert out["density_grid"][k, z, y, x] == float(dgbuf[k * g**3 + m])
    np.testing.assert_array_equal(out["acc"]["rotation"],
                                  np.arange(1.0, 10.0, dtype=np.float32).reshape(3, 3))
    np.testing.assert_array_equal(out["acc"]["transition"],
                                  np.array([0.25, -0.5, 0.75], np.float32))
    assert (out["training_step"], out["loss"], out["aabb_scale"]) == (1234, 0.0625, 2)


def test_export_emits_reference_required_keys(tmp_path):
    """Keys Testbed::load_snapshot indexes with no .contains() guard
    (testbed.cu:3197-3254, nerf_network.h:1207/:1249)."""
    doc, _, _ = _golden_doc()
    params = load_reference_snapshot(msgpack.packb(doc, use_bin_type=True))["params"]
    path = tmp_path / "snap.msgpack"
    save_reference_snapshot(path, params, CONFIG)
    snap = msgpack.unpackb(path.read_bytes(), raw=False, strict_map_key=False)["snapshot"]
    for key in ("n_params", "params_binary", "density_grid_size", "density_grid_binary",
                "rotation", "transition", "local_rotation", "local_transition",
                "training_step", "loss"):
        assert key in snap, key
    for key in ("rays_per_batch", "measured_batch_size", "measured_batch_size_before_compaction"):
        assert snap["nerf"]["rgb"][key] > 0
    np.testing.assert_array_equal(np.frombuffer(snap["rotation"], "<f2")[:9].reshape(3, 3),
                                  np.eye(3))
    np.testing.assert_array_equal(np.frombuffer(snap["local_rotation"], "<f2")[:6],
                                  [1, 0, 0, 0, 1, 0])


def test_export_import_density_grid_matches_reference_semantics(tmp_path):
    """The exported buffer decoded by hand with the reference's Morton rule."""
    g = 16
    cells = np.random.default_rng(5).standard_normal((1, g, g, g)).astype("<f2").astype(
        np.float32)
    doc, _, _ = _golden_doc()
    params = load_reference_snapshot(msgpack.packb(doc, use_bin_type=True))["params"]
    path = tmp_path / "snap.msgpack"
    save_reference_snapshot(path, params, CONFIG, density_grid=cells)
    saved = msgpack.unpackb(path.read_bytes(), raw=False, strict_map_key=False)
    buf = np.frombuffer(saved["snapshot"]["density_grid_binary"], "<f2")
    z, y, x = np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij")
    m = morton3d(x.ravel(), y.ravel(), z.ravel())
    np.testing.assert_array_equal(np.asarray(buf)[m].reshape(g, g, g), cells[0])


# -- against the JAX package's shim ---------------------------------------------


@pytest.mark.parametrize("with_extras", [False, True])
def test_export_is_the_jax_export(tmp_path, with_extras):
    """The JAX package's params exported by both shims: the same file, byte
    for byte; each shim imports the other's file to the same arrays."""
    jcfg = JFieldConfig(grid=JGrid(**_CFG), **_MLPS)
    params = jax.device_get(jinit_field(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    kw = {}
    if with_extras:
        kw = dict(density_grid=rng.normal(size=(2, 16, 16, 16)).astype(np.float32),
                  acc={"rotation": rng.normal(size=(3, 3)).astype(np.float32),
                       "transition": rng.normal(size=(3,)).astype(np.float32)},
                  aabb_scale=4, training_step=77, loss=0.25)
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jngp.save_reference_snapshot(jpath, params, jcfg, **kw)
    save_reference_snapshot(tpath, params, CFG, **kw)
    jdoc = msgpack.unpackb(jpath.read_bytes(), raw=False)["snapshot"]
    tdoc = msgpack.unpackb(tpath.read_bytes(), raw=False)["snapshot"]
    for key in ("params_binary", "density_grid_binary", "rotation", "transition"):
        assert tdoc[key] == jdoc[key], key
    assert tpath.read_bytes() == jpath.read_bytes()
    if not with_extras:
        # The JAX shim cannot read its own export without a density grid
        # (np.stack of no cascades); the port's reads it as no grid.
        with pytest.raises(ValueError):
            jngp.load_reference_snapshot(jpath)
        assert load_reference_snapshot(jpath)["density_grid"] is None
    else:
        ours, theirs = load_reference_snapshot(jpath), jngp.load_reference_snapshot(tpath)
        for a, b in zip(jax.tree_util.tree_leaves(ours["params"]),
                        jax.tree_util.tree_leaves(theirs["params"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(ours["density_grid"], theirs["density_grid"])
