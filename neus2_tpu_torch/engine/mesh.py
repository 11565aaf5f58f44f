"""SDF grid query, marching-cubes mesh export and the mesh tools (port of
``neus2_tpu/engine/mesh.py``; reference Testbed::get_density_on_grid,
src/testbed_nerf.cu:4096-4130, marching_cubes_gpu, src/marching_cubes.cu:794,
the OBJ/PLY export with the dataset un-warp, src/testbed.cu:308-320, and the
mesh-vertex optimization, src/marching_cubes.cu:720-762).

The SDF is evaluated on the device in chunks of 2^16 points; marching cubes
runs on the host (``native.py``) over the grid, copied back once.  The
Chamfer distance and the vertex refinement run on the device too.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.models.field import FieldConfig, field_forward, sdf_fn, sdf_normal_features
from neus2_tpu_torch.native import marching_cubes
from neus2_tpu_torch.ops.warp import AABB, warp_direction
from neus2_tpu_torch.utils.device import resolve_device


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


def smooth_vertices_1ring(verts: np.ndarray, tris: np.ndarray,
                          amount: float = 0.5) -> np.ndarray:
    """1-ring centroid smoothing (accumulate_1ring's vertex average,
    blended by ``amount`` as k_smooth_amount blends it), in float64 on the
    host; vertices on no triangle stay put."""
    v = np.asarray(verts, np.float64)
    t = np.asarray(tris)
    acc = np.zeros_like(v)
    cnt = np.zeros(len(v))
    # Each triangle gives each corner its two other vertices.
    for k in range(3):
        for other in ((k + 1) % 3, (k + 2) % 3):
            cnt += np.bincount(t[:, k], minlength=len(v))
            for c in range(3):
                acc[:, c] += np.bincount(t[:, k], weights=v[t[:, other], c], minlength=len(v))
    ring = acc / np.maximum(cnt, 1.0)[:, None]
    has = cnt > 0
    out = v.copy()
    out[has] = v[has] * (1.0 - amount) + ring[has] * amount
    return out.astype(np.float32)


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


@torch.no_grad()
def chamfer_distance(a: np.ndarray, b: np.ndarray, n_sample: int = 30000, seed: int = 0,
                     device="cuda", chunk: int = 1024) -> float:
    """Symmetric Chamfer distance between two point sets: sqrt(mean nearest
    squared distance) each way, summed.  A set larger than ``n_sample`` is
    subsampled with numpy ``default_rng(seed).choice(replace=False)`` as
    the JAX package subsamples it.  The squared distances are summed from
    the coordinate differences on ``device``, ``chunk`` points at a time
    (the matrix-product form |p|^2 - 2 p.q + |q|^2 cancels near 0)."""
    rng = np.random.default_rng(seed)
    if len(a) > n_sample:
        a = a[rng.choice(len(a), n_sample, replace=False)]
    if len(b) > n_sample:
        b = b[rng.choice(len(b), n_sample, replace=False)]
    dev = resolve_device(device)
    pa = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pb = torch.as_tensor(np.asarray(b, np.float32), device=dev)

    def one_way(p, q):
        mins = [((q[None] - c[:, None]) ** 2).sum(-1).amin(1) for c in torch.split(p, chunk)]
        return torch.cat(mins).mean()

    return float(torch.sqrt(one_way(pa, pb)) + torch.sqrt(one_way(pb, pa)))


def ring_centroids(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Each vertex's 1-ring centroid (reference compute_mesh_1ring /
    accumulate_1ring, src/marching_cubes.cu:720-727: every triangle gives
    each corner its two other vertices, weights normalized); a vertex on no
    triangle keeps its position.  ``index_add_``: on the card its adds
    land in atomic order, so sums may differ in the last bit."""
    faces = faces.long()
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    pos = torch.zeros_like(verts)
    w = torch.zeros(verts.shape[0], dtype=verts.dtype, device=verts.device)
    for i, j, k in ((a, b, c), (b, c, a), (c, a, b)):
        pos.index_add_(0, i, verts[j] + verts[k])
        w.index_add_(0, i, torch.full_like(i, 2, dtype=verts.dtype))
    return torch.where(w[:, None] > 0, pos / torch.clamp_min(w, 1.0)[:, None], verts)


@torch.no_grad()
def refine_vertices(params, config: FieldConfig, verts_w: torch.Tensor, n_iters: int = 5,
                    step: float = 0.8, faces: torch.Tensor | None = None,
                    k_smooth: float = 0.0, k_inflate: float = 0.0) -> torch.Tensor:
    """Mesh-vertex optimization (reference compute_mesh_opt_gradients,
    src/marching_cubes.cu:728-762) on warped-coordinate vertices: each
    iteration moves a vertex by a Newton projection onto the SDF's zero set
    (s n / |n|^2, scaled by ``step``), minus ``k_smooth`` times its offset
    from the 1-ring centroid (needs ``faces``), plus ``k_inflate`` along
    the unit normal.  The normal is ``sdf_normal_features``' forward
    tangent."""
    v = verts_w
    for _ in range(n_iters):
        s, n, _ = sdf_normal_features(params, v, config)
        n2 = (n * n).sum(-1, keepdim=True)
        v_new = v - step * s[:, None] * n / torch.clamp_min(n2, 1e-8)
        if k_smooth and faces is not None:
            v_new = v_new - k_smooth * (v - ring_centroids(v, faces))
        if k_inflate:
            v_new = v_new + k_inflate * (n / torch.sqrt(torch.clamp_min(n2, 1e-12)))
        v = v_new
    return v
