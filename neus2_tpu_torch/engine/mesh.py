"""SDF grid query and marching-cubes mesh export (port of
``neus2_tpu/engine/mesh.py``; reference Testbed::get_density_on_grid,
src/testbed_nerf.cu:4096-4130, marching_cubes_gpu, src/marching_cubes.cu:794,
and the OBJ/PLY export with the dataset un-warp, src/testbed.cu:308-320).

The SDF is evaluated on the device in chunks of 2^16 points; marching cubes
runs on the host (``native.py``) over the grid, copied back once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.models.field import FieldConfig, field_forward, sdf_fn
from neus2_tpu_torch.native import marching_cubes
from neus2_tpu_torch.ops.warp import AABB, warp_direction


def _vec3(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(3)


@torch.no_grad()
def sdf_grid(params, config: FieldConfig, lo, hi, aabb_lo, aabb_diag,
             resolution: int = 256, chunk: int = 1 << 16) -> torch.Tensor:
    """The SDF on a uniform (R, R, R) grid of cell centres over [lo, hi]
    (world space; the field sees (x - aabb_lo) / aabb_diag), on the
    params' device."""
    dev = params["variance"].device
    r = resolution
    xs = (torch.arange(r, device=dev) + 0.5) / r
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1).reshape(-1, 3)
    lo, hi = _vec3(lo, dev), _vec3(hi, dev)
    pts_w = (lo + grid * (hi - lo) - _vec3(aabb_lo, dev)) / _vec3(aabb_diag, dev)
    vals = torch.cat([sdf_fn(params, p, config)[0] for p in torch.split(pts_w, chunk)])
    return vals.reshape(r, r, r)


def extract_mesh(params, config: FieldConfig, resolution: int = 256,
                 box: AABB | None = None, aabb: AABB | None = None,
                 thresh: float = 0.0):
    """Marching-cubes mesh of the SDF's ``thresh`` level set -> (verts (V, 3)
    world space float32, tris (T, 3) int32).  ``box`` limits where the grid
    is sampled; ``aabb`` is the scene warp frame."""
    if aabb is None:
        aabb = AABB((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    if box is None:
        box = aabb
    grid = sdf_grid(params, config, box.lo, box.hi, aabb.lo, aabb.diag, resolution=resolution)
    verts, tris = marching_cubes(grid.cpu().numpy(), thresh=thresh)
    lo = np.asarray(box.lo, np.float32)
    hi = np.asarray(box.hi, np.float32)
    # Grid samples sit at cell centres: vertex i maps to (i + 0.5) / r.
    return lo + (verts + 0.5) / resolution * (hi - lo), tris


def save_density_grid_png(params, config: FieldConfig, path, resolution: int = 128,
                          aabb: AABB | None = None) -> tuple[int, int]:
    """Diagnostic mosaic PNG of the SDF grid over ``aabb`` (reference
    marching_cubes.cu:962-1024, save_density_grid_to_png, with threshold 0,
    range 1 and y as the slice axis): slices tiled about sqrt(Z) down, values
    in [-1, +1] mapped to [0, 255] around 128, an 8-bit grey PNG written with
    Pillow.  Returns the stats the reference logs: (surface voxels, lattice
    points next to a zero crossing)."""
    from PIL import Image

    if aabb is None:
        aabb = AABB((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    g = sdf_grid(params, config, aabb.lo, aabb.hi, aabb.lo, aabb.diag,
                 resolution=resolution).cpu().numpy()
    r = resolution
    inside = g < 0.0
    # Surface voxels: 2x2x2 corner blocks of mixed sign, anchored in
    # [1, r - 2] on each axis as the reference loops.
    c = sum(inside[dx:r - 1 + dx, dy:r - 1 + dy, dz:r - 1 + dz].astype(np.int32)
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))[1:, 1:, 1:]
    n_voxels = int(np.count_nonzero((c > 0) & (c < 8)))
    # Interior lattice points whose 6-neighbourhood crosses the threshold.
    i = inside[1:-1, 1:-1, 1:-1]
    near = np.zeros_like(i)
    for sl in (np.s_[2:, 1:-1, 1:-1], np.s_[:-2, 1:-1, 1:-1], np.s_[1:-1, 2:, 1:-1],
               np.s_[1:-1, :-2, 1:-1], np.s_[1:-1, 1:-1, 2:], np.s_[1:-1, 1:-1, :-2]):
        near |= inside[sl] != i
    n_near = int(np.count_nonzero(near))

    # y is the slice axis (the reference's swap_y_z).
    vol = np.transpose(g, (1, 2, 0))
    z, h, w = vol.shape
    ndown = int(np.sqrt(z))
    nacross = -(-z // ndown)
    sheet = np.zeros((h * ndown, w * nacross), np.uint8)
    # clamp(v * 128 + 128.5, 0, 255), truncated (marching_cubes.cu:1019).
    px = np.clip(vol * 128.0 + 128.5, 0, 255).astype(np.uint8)
    for k in range(z):
        row, col = divmod(k, nacross)
        sheet[row * h:(row + 1) * h, col * w:(col + 1) * w] = px[k]
    Image.fromarray(sheet).save(str(path), format="PNG")
    return n_voxels, n_near


def largest_component(verts: np.ndarray, tris: np.ndarray):
    """Keep only the largest connected component (by triangle count): drops
    floater blobs, the mask-free analog of the reference DTU protocol's
    object-mask cropping."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    t = np.asarray(tris, np.int64)
    if t.shape[0] == 0:
        return verts, tris
    rows = np.concatenate([t[:, 0], t[:, 1], t[:, 2]])
    cols = np.concatenate([t[:, 1], t[:, 2], t[:, 0]])
    adj = coo_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    tri_label = labels[t[:, 0]]
    vals, counts = np.unique(tri_label, return_counts=True)
    keep_tris = t[tri_label == vals[np.argmax(counts)]]
    used = np.unique(keep_tris)
    remap = np.full(n, -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    return verts[used], remap[keep_tris].astype(tris.dtype)


@torch.no_grad()
def vertex_colors(params, config: FieldConfig, verts: torch.Tensor, aabb_lo, aabb_diag,
                  chunk: int = 1 << 14) -> torch.Tensor:
    """Per-vertex sRGB colours (V, 3) from the RGB head, viewed along the
    outward direction normalize(x - 0.5) (reference
    compute_mesh_vertex_colors, src/testbed_nerf.cu:4071-4094)."""
    dev = verts.device
    x_w = (verts - _vec3(aabb_lo, dev)) / _vec3(aabb_diag, dev)
    out = []
    for x in torch.split(x_w, chunk):
        d = x - 0.5
        d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)
        out.append(field_forward(params, x, warp_direction(d), config).rgb)
    return torch.clamp(torch.cat(out), 0.0, 1.0)


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted 1-ring vertex normals (reference accumulate_1ring,
    src/marching_cubes.cu:331-360; a deterministic bincount here)."""
    v = np.asarray(verts, np.float64)
    t = np.asarray(tris)
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        for c in range(3):
            n[:, c] += np.bincount(t[:, k], weights=fn[:, c], minlength=len(v))
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n.astype(np.float32)


def save_mesh_obj(path: str | Path, verts: np.ndarray, tris: np.ndarray,
                  scale: float = 1.0, offset=(0.0, 0.0, 0.0),
                  normals: np.ndarray | None = None):
    """OBJ export in the dataset's space: (v - offset) / scale
    (src/testbed.cu:315)."""
    v = (verts - np.asarray(offset, np.float32)) / scale
    with open(Path(path), "w") as f:
        f.write("# neus2_tpu_torch marching cubes export\n")
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            for t in tris:
                f.write(f"f {t[0]+1}//{t[0]+1} {t[1]+1}//{t[1]+1} {t[2]+1}//{t[2]+1}\n")
        else:
            for t in tris:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def save_mesh_ply(path: str | Path, verts: np.ndarray, tris: np.ndarray,
                  scale: float = 1.0, offset=(0.0, 0.0, 0.0),
                  colors: np.ndarray | None = None, normals: np.ndarray | None = None):
    """ASCII PLY export in the dataset's space, with optional normals and
    8-bit colours."""
    v = (verts - np.asarray(offset, np.float32)) / scale
    with open(Path(path), "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        c8 = None if colors is None else np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        for i, p in enumerate(v):
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if normals is not None:
                n = normals[i]
                row += f" {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}"
            if c8 is not None:
                c = c8[i]
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
