"""Reference-format (instant-ngp/NeuS2) msgpack snapshots (port of
``neus2_tpu/api/ngp_snapshot.py``, read and written through the port's own
``msgpack_codec``).

The reference saves a snapshot as the msgpack of its network config with a
``snapshot`` key (reference src/testbed.cu:3144-3196 save_snapshot,
3197-3254 load_snapshot):

  snapshot.n_params            params in the flat fp16 vector
  snapshot.params_binary       fp16 INFERENCE (EMA) params in the order of
                               NerfNetwork::set_params (nerf_network.h:
                               741-785): density MLP, rgb MLP, hash grid,
                               dir encoding (0 params), variance (4, [0] used)
  snapshot.density_grid_binary fp16 density grid, cascades-major, MORTON
                               cell order within a cascade
                               (testbed_nerf.cu:555-565)
  snapshot.density_grid_size   128 (NERF_GRIDSIZE)
  snapshot.nerf.aabb_scale     the dataset's aabb scale
  snapshot.rotation/transition the accumulated global movement (fp16;
                               3x3 row-major in [0:9] / xyz in [0:3],
                               nerf_network.h:1179-1204)
  snapshot.training_step, snapshot.loss

MLP matrices are bias-free row-major (out, in) blocks in layer order
[input (W x in_w), hidden^(k-1) (W x W), output (out_pad x W)]
(tcnn fully_fused_mlp.cu:815-889).  Input layouts (nerf_network.h:52-80,
195-283):

  density input  [xyz (3) | grid features (L*F)] padded to a multiple of 16
  rgb input      [density out (16) | SH dir (16) | xyz (3) | dSDF/dx (3)]
                 padded to a multiple of 16

which are the orders of ``models/field.py``, so an import is a transpose
and a column slice a matrix.  The port's MLPs carry biases, which the
reference's lack: an import sets them to zero and an export drops them.
Arrays in and out are numpy; the Testbed moves them to its device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from neus2_tpu_torch.api import msgpack_codec
from neus2_tpu_torch.constants import NERF_GRIDSIZE
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.sh import sh_output_dim

_ALIGN = 16  # tcnn's minimum alignment for FullyFusedMLP


def _next_multiple(x: int, m: int = _ALIGN) -> int:
    return ((x + m - 1) // m) * m


# -- the Morton (z-order) cell order of the density grid ----------------------


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x to every 3rd bit (tcnn expand_bits)."""
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleaved Morton code, x in the lowest bit (tcnn morton3D)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def _morton_of_flat(g: int) -> np.ndarray:
    """Flat (z, y, x; x fastest) cell index -> Morton code, for one G^3
    cascade.  The reference's buffer index is morton(x, y, z)
    (testbed_nerf.cu:555-565), so an import reads ``buffer[m]`` and an
    export writes ``buffer[m] = cells``.  The inverse permutation is not
    the same map: bit interleaving is an involution only at G = 8."""
    z, y, x = np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij")
    return morton3d(x.ravel(), y.ravel(), z.ravel()).astype(np.int64)


# -- config <-> FieldConfig ---------------------------------------------------


def field_config_from_ngp(config: dict) -> FieldConfig:
    """A FieldConfig from the reference's network-config dict (the
    configs/base.json schema; per_level_scale from top_resolution as in
    Testbed::reset_network, src/testbed.cu:2183-2189)."""
    enc = config["encoding"]
    if "per_level_scale" in enc:
        pls = float(enc["per_level_scale"])
    else:
        pls = HashGridConfig.per_level_scale_from_top(
            int(enc.get("base_resolution", 16)), int(enc.get("top_resolution", 2048)),
            int(enc.get("n_levels", 14)))
    grid = HashGridConfig(
        n_levels=int(enc.get("n_levels", 14)),
        n_features_per_level=int(enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
        base_resolution=int(enc.get("base_resolution", 16)),
        per_level_scale=pls,
    )
    net = config.get("network", {})
    rgb = config.get("rgb_network", {})
    sh_degree = 4
    for nested in config.get("dir_encoding", {}).get("nested", []):
        if str(nested.get("otype", "")).lower().startswith("spherical"):
            sh_degree = int(nested.get("degree", 4))
    return FieldConfig(
        grid=grid,
        sdf_hidden_dim=int(net.get("n_neurons", 64)),
        sdf_n_hidden=int(net.get("n_hidden_layers", 1)),
        rgb_hidden_dim=int(rgb.get("n_neurons", 64)),
        rgb_n_hidden=int(rgb.get("n_hidden_layers", 2)),
        sh_degree=sh_degree,
    )


def _mlp_matrix_shapes(in_w: int, width: int, n_hidden: int, out_pad: int):
    """FullyFusedMLP matrix shapes in storage order (fully_fused_mlp.cu:
    839-874): input, (n_hidden - 1) hidden, output."""
    return [(width, in_w)] + [(width, width)] * (n_hidden - 1) + [(out_pad, width)]


def _layout(config: FieldConfig) -> dict:
    """The composite network's blocks in set_params order."""
    if config.residual_grid:
        raise NotImplementedError(
            "reference-snapshot interop covers the NeuS2 composite network; a residual "
            "grid has no counterpart in the params_binary layout")
    density_in = _next_multiple(3 + config.grid.output_dim)
    density_out = _next_multiple(config.sdf_out_dim)
    sh_pad = _next_multiple(sh_output_dim(config.sh_degree))
    rgb_in = _next_multiple(3 + 3 + sh_pad + density_out)
    return {
        # n_hidden_layers = k -> k + 1 matrices (fully_fused_mlp.cu:835),
        # the count of the port's k-hidden MLP's layer list.
        "density": _mlp_matrix_shapes(density_in, config.sdf_hidden_dim,
                                      config.sdf_n_hidden, density_out),
        "rgb": _mlp_matrix_shapes(rgb_in, config.rgb_hidden_dim, config.rgb_n_hidden,
                                  _next_multiple(16)),
        "grid": config.grid.n_params,
        "variance": 4,
        "sh_pad": sh_pad,
        "density_out": density_out,
    }


def ngp_n_params(config: FieldConfig) -> int:
    lay = _layout(config)
    n = sum(r * c for r, c in lay["density"]) + sum(r * c for r, c in lay["rgb"])
    return n + lay["grid"] + lay["variance"]


def _input_columns(config: FieldConfig, lay: dict) -> tuple[list, list]:
    """The used column ranges of the density and rgb input matrices."""
    sh_dim = sh_output_dim(config.sh_degree)
    d_out, sh_pad = lay["density_out"], lay["sh_pad"]
    rgb = [(0, config.sdf_out_dim),  # density features
           (d_out, d_out + sh_dim),  # SH
           (d_out + sh_pad, d_out + sh_pad + 6)]  # xyz + dSDF/dx
    return [(0, 3 + config.grid.output_dim)], rgb


# -- import -------------------------------------------------------------------


def _take(flat: np.ndarray, pos: int, n: int):
    if pos + n > flat.size:
        raise ValueError(f"snapshot params too short: need {pos + n}, have {flat.size}")
    return flat[pos:pos + n], pos + n


def _import_mlp(flat, pos, shapes, col_slices, out_rows=None):
    """One MLP's matrices -> ``{"layers": [{"w" (in, out), "b"}]}``, the
    input matrix's padding columns and the output's padding rows dropped."""
    layers = []
    for i, (r, c) in enumerate(shapes):
        block, pos = _take(flat, pos, r * c)
        w_ref = block.reshape(r, c).astype(np.float32)  # (out, in) row-major
        if i == 0 and col_slices is not None:
            w_ref = np.concatenate([w_ref[:, a:b] for a, b in col_slices], axis=1)
        if i == len(shapes) - 1 and out_rows is not None:
            w_ref = w_ref[:out_rows]
        layers.append({"w": w_ref.T.copy(), "b": np.zeros((w_ref.shape[0],), np.float32)})
    return {"layers": layers}, pos


def load_reference_snapshot(path: str | Path | bytes,
                            config: FieldConfig | None = None) -> dict[str, Any]:
    """Parse a reference msgpack snapshot -> {"params", "density_grid" (C,
    G, G, G) float32 or None, "acc" {"rotation", "transition"} or None,
    "config", "aabb_scale", "training_step", "loss"} as numpy.  ``params``
    holds the reference's inference (EMA) values; its Adam state is not
    in the file (tied to its fused kernels)."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    doc = msgpack_codec.unpackb(data)
    if not isinstance(doc, dict) or "snapshot" not in doc:
        raise ValueError("file does not contain a snapshot")
    snap = doc["snapshot"]
    config = config or field_config_from_ngp(doc)
    lay = _layout(config)

    flat = np.frombuffer(snap["params_binary"], dtype="<f2")
    if int(snap.get("n_params", flat.size)) != flat.size:
        raise ValueError("n_params does not match params_binary size")
    want = ngp_n_params(config)
    if flat.size != want:
        raise ValueError(f"snapshot has {flat.size} params but the config implies {want} "
                         "— config/snapshot mismatch")

    density_cols, rgb_cols = _input_columns(config, lay)
    sdf_mlp, pos = _import_mlp(flat, 0, lay["density"], density_cols)
    rgb_mlp, pos = _import_mlp(flat, pos, lay["rgb"], rgb_cols, out_rows=3)
    grid_flat, pos = _take(flat, pos, lay["grid"])
    F = config.grid.n_features_per_level
    _, _, offsets, sizes, _ = config.grid.level_tables()
    tables = tuple(grid_flat[o * F:(o + s) * F].reshape(s, F).astype(np.float32)
                   for o, s in zip(offsets, sizes))
    var_buf, pos = _take(flat, pos, lay["variance"])
    params = {"hashgrid": tables, "sdf_mlp": sdf_mlp, "rgb_mlp": rgb_mlp,
              "variance": np.float32(var_buf[0])}

    density_grid = None
    if "density_grid_binary" in snap:
        g = int(snap.get("density_grid_size", NERF_GRIDSIZE))
        dg = np.frombuffer(snap["density_grid_binary"], dtype="<f2")
        if dg.size % (g**3):
            raise ValueError("density grid size is not a whole cascade count")
        m = _morton_of_flat(g)
        # Morton order puts x fastest, as the port's (z, y, x) cells do
        # (engine/occupancy.py cell_position), so the reshape lands.
        cas = [dg[k * g**3:(k + 1) * g**3][m].reshape(g, g, g) for k in range(dg.size // g**3)]
        density_grid = np.stack(cas).astype(np.float32) if cas else None

    acc = None
    if "rotation" in snap and "transition" in snap:
        rot = np.frombuffer(snap["rotation"], dtype="<f2").astype(np.float32)
        tra = np.frombuffer(snap["transition"], dtype="<f2").astype(np.float32)
        acc = {"rotation": rot[:9].reshape(3, 3), "transition": tra[:3]}

    return {
        "params": params, "density_grid": density_grid, "acc": acc, "config": config,
        "aabb_scale": int(snap.get("nerf", {}).get("aabb_scale", 1)),
        "training_step": int(snap.get("training_step", 0)),
        "loss": float(snap.get("loss", 0.0)),
    }


# -- export -------------------------------------------------------------------


def _export_mlp(layers, shapes, col_slices, out_rows=None) -> np.ndarray:
    """The port's MLP layers -> the reference's flat fp16 block (biases
    dropped)."""
    out = []
    for i, ((r, c), layer) in enumerate(zip(shapes, layers)):
        w = np.zeros((r, c), np.float32)
        ours = np.asarray(layer["w"], np.float32).T  # (out, in)
        if i == 0 and col_slices is not None:
            k = 0
            for a, b in col_slices:
                w[:ours.shape[0], a:b] = ours[:, k:k + (b - a)]
                k += b - a
        elif i == len(shapes) - 1 and out_rows is not None:
            w[:out_rows, :ours.shape[1]] = ours[:out_rows]
        else:
            w[:ours.shape[0], :ours.shape[1]] = ours
        out.append(w.reshape(-1))
    return np.concatenate(out).astype("<f2")


def save_reference_snapshot(path: str | Path, params, config: FieldConfig, density_grid=None,
                            acc=None, aabb_scale: int = 1, training_step: int = 0,
                            loss: float = 0.0, network_config: dict | None = None) -> None:
    """Write params (numpy trees) as a reference-format msgpack snapshot,
    the inverse of ``load_reference_snapshot`` (fp16, bias-free)."""
    lay = _layout(config)
    density_cols, rgb_cols = _input_columns(config, lay)
    flat = np.concatenate([
        _export_mlp(params["sdf_mlp"]["layers"], lay["density"], density_cols),
        _export_mlp(params["rgb_mlp"]["layers"], lay["rgb"], rgb_cols, out_rows=3),
        np.concatenate([np.asarray(t, np.float32).reshape(-1)
                        for t in params["hashgrid"]]).astype("<f2"),
        np.array([float(params["variance"]), 0.0, 0.0, 0.0], "<f2"),
    ])

    # Keys the reference's Testbed::load_snapshot reads without a
    # .contains() guard (testbed.cu:3197-3254; load_global_movement and
    # load_local_movement, nerf_network.h:1207, :1249), with defaults the
    # reference reads back as its own: a zero-length density grid is its
    # "never populated" state; the local movement is the identity 6d
    # rotation in an 8-buffer and a zero transition in a 4-buffer
    # (transform_network.h:30-35).
    snap: dict[str, Any] = {
        "n_params": int(flat.size),
        "params_binary": flat.tobytes(),
        "training_step": int(training_step),
        "loss": float(loss),
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {"rays_per_batch": 4096, "measured_batch_size": 1 << 18,
                    "measured_batch_size_before_compaction": 1 << 18},
        },
        "density_grid_size": NERF_GRIDSIZE,
        "density_grid_binary": b"",
        "local_rotation": np.array([1, 0, 0, 0, 1, 0, 0, 0], "<f2").tobytes(),
        "local_transition": np.zeros(4, "<f2").tobytes(),
    }
    if density_grid is not None:
        dg = np.asarray(density_grid, np.float32)
        g = dg.shape[-1]
        m = _morton_of_flat(g)
        cas = []
        for c in dg.reshape(-1, g**3):
            buf = np.empty(g**3, np.float32)
            buf[m] = c  # buffer position morton(x, y, z) <- cell (z, y, x)
            cas.append(buf)
        snap["density_grid_size"] = g
        snap["density_grid_binary"] = np.concatenate(cas).astype("<f2").tobytes()
    # The accumulated movement in its 12/4-buffer layout (nerf_network.h:
    # 89-93), the identity when none is given.
    rot = np.zeros(12, np.float32)
    tra = np.zeros(4, np.float32)
    rot[:9] = (np.eye(3, dtype=np.float32) if acc is None
               else np.asarray(acc["rotation"], np.float32)).reshape(-1)
    if acc is not None:
        tra[:3] = np.asarray(acc["transition"], np.float32).reshape(-1)
    snap["rotation"] = rot.astype("<f2").tobytes()
    snap["transition"] = tra.astype("<f2").tobytes()

    doc = dict(network_config or {})
    doc.setdefault("encoding", {
        "otype": "HashGrid",
        "n_levels": config.grid.n_levels,
        "n_features_per_level": config.grid.n_features_per_level,
        "log2_hashmap_size": config.grid.log2_hashmap_size,
        "base_resolution": config.grid.base_resolution,
        "per_level_scale": config.grid.per_level_scale,
    })
    doc.setdefault("network", {"otype": "FullyFusedMLP", "n_neurons": config.sdf_hidden_dim,
                               "n_hidden_layers": config.sdf_n_hidden})
    doc.setdefault("rgb_network", {"otype": "FullyFusedMLP", "n_neurons": config.rgb_hidden_dim,
                                   "n_hidden_layers": config.rgb_n_hidden})
    doc.setdefault("dir_encoding", {
        "otype": "Composite",
        "nested": [{"n_dims_to_encode": 3, "otype": "SphericalHarmonics",
                    "degree": config.sh_degree},
                   {"otype": "Identity"}],
    })
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack_codec.packb(doc))
