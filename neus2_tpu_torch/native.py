"""ctypes bindings to the repo's host C++ in ``native/`` (the port's own
counterpart of ``neus2_tpu/native/__init__.py``: marching cubes, the
threaded PNG/JPEG decoder, the triangle BVH of the SDF-from-mesh mode and
the eval's z-buffer mesh rasterizer).

Each source is compiled on first use by ``utils/host_build.py`` into
``neus2_tpu_torch/_build/``.  This is host code, not a GPU kernel: the
mesh's SDF grid is evaluated on the card (``engine/mesh.py``) and copied to
the host once; the BVH labels the SDF mode's training points on the host,
as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np

from neus2_tpu_torch.utils import host_build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _mc_lib() -> ctypes.CDLL:
    lib = host_build.load("marching_cubes")
    lib.mc_run.restype = ctypes.c_void_p
    lib.mc_run.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mc_num_vertices.restype = ctypes.c_int64
    lib.mc_num_vertices.argtypes = [ctypes.c_void_p]
    lib.mc_num_triangles.restype = ctypes.c_int64
    lib.mc_num_triangles.argtypes = [ctypes.c_void_p]
    lib.mc_copy_vertices.argtypes = [ctypes.c_void_p, _F32P]
    lib.mc_copy_triangles.argtypes = [ctypes.c_void_p, _I32P]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(grid: np.ndarray, thresh: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate the ``thresh`` level set of an (nx, ny, nz) float32 grid
    -> (vertices (V, 3) float32 in grid-index units, triangles (T, 3) int32)
    (reference marching_cubes_gpu, src/marching_cubes.cu:794)."""
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"marching_cubes needs a 3-D grid, got shape {grid.shape}")
    nx, ny, nz = grid.shape
    lib = _mc_lib()
    # mc_run indexes x fastest; a C-order (x, y, z) array has z fastest, so
    # pass the dims reversed and flip the vertex coordinates back below.
    h = lib.mc_run(grid.ctypes.data_as(_F32P), nz, ny, nx, float(thresh))
    try:
        nv, nt = lib.mc_num_vertices(h), lib.mc_num_triangles(h)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int32)
        if nv:
            lib.mc_copy_vertices(h, verts.ctypes.data_as(_F32P))
        if nt:
            lib.mc_copy_triangles(h, tris.ctypes.data_as(_I32P))
    finally:
        lib.mc_free(h)
    return verts[:, ::-1].copy(), tris


@functools.cache
def _image_lib() -> ctypes.CDLL | None:
    """The decoder's library, or None where it cannot be built or loaded
    (no libpng/libjpeg): the reason is printed once, and later loads go
    straight to the caller's fallback."""
    try:
        lib = host_build.load("image_loader", ("-lpng", "-ljpeg", "-lz", "-pthread"))
    except (RuntimeError, OSError) as e:
        lines = [l.strip() for l in str(e).splitlines() if l.strip()] or [type(e).__name__]
        reason = next((l for l in lines if "error" in l), lines[0])
        print(f"[neus2-torch] native image decoder unavailable ({reason}); "
              "decoding with Pillow", file=sys.stderr, flush=True)
        return None
    lib.il_load_batch.restype = ctypes.c_void_p
    lib.il_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    for fn in ("il_width", "il_height", "il_ok"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.il_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, _F32P]
    lib.il_free.argtypes = [ctypes.c_void_p]
    return lib


def decode_images(paths, n_threads: int = 0) -> list:
    """Decode PNG/JPEG files on the native thread pool -> list of (H, W, 4)
    float32 premultiplied-linear RGBA arrays, None for a file that failed
    (the caller decodes those another way), and None for every file where
    the decoder cannot be built."""
    paths = [str(p) for p in paths]
    lib = _image_lib() if paths else None
    if lib is None:
        return [None] * len(paths)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    h = lib.il_load_batch(arr, len(paths), int(n_threads))
    out = []
    try:
        for i in range(len(paths)):
            if not lib.il_ok(h, i):
                out.append(None)
                continue
            img = np.empty((lib.il_height(h, i), lib.il_width(h, i), 4), np.float32)
            lib.il_copy(h, i, img.ctypes.data_as(_F32P))
            out.append(img)
    finally:
        lib.il_free(h)
    return out


@functools.cache
def _bvh_lib() -> ctypes.CDLL:
    lib = host_build.load("triangle_bvh", ("-pthread",))
    lib.tbvh_build.restype = ctypes.c_void_p
    lib.tbvh_build.argtypes = [_F32P, ctypes.c_int64, _I32P, ctypes.c_int64]
    lib.tbvh_free.argtypes = [ctypes.c_void_p]
    for fn in ("tbvh_signed_distance", "tbvh_unsigned_distance"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64, _F32P,
                                     ctypes.c_int]
    lib.tbvh_raycast.argtypes = [ctypes.c_void_p, _F32P, _F32P, ctypes.c_int64, _F32P,
                                 _I32P, ctypes.c_int]
    lib.tbvh_face_normals.argtypes = [ctypes.c_void_p, _F32P]
    lib.tbvh_n_tris.restype = ctypes.c_int64
    lib.tbvh_n_tris.argtypes = [ctypes.c_void_p]
    return lib


def _points(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).reshape(-1, 3)


class TriangleBVH:
    """Host triangle BVH over ``native/triangle_bvh.cpp``: the ground-truth
    signed-distance and raycast oracle of the SDF-from-mesh mode (reference
    src/triangle_bvh.cu TriangleBvh4: unsigned_distance :405, the raystab
    signed distance :419, raytrace).  The sign is negative inside (a
    majority of three parity stabs).  ``raycast`` keeps the source's
    absolute Moller-Trumbore cut, |det| < 1e-9 (triangle_bvh.cpp:115-119):
    a ray misses a triangle whose determinant lies below it, however the
    triangle is scaled.

    A mesh with no face raises ``ValueError``: ``tbvh_build`` would read
    past its node array there."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self._verts = _points(verts)
        self._faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
        if self._faces.shape[0] == 0:
            raise ValueError("TriangleBVH needs a mesh with at least one face")
        if self._faces.min() < 0 or self._faces.max() >= self._verts.shape[0]:
            raise ValueError("TriangleBVH: a face indexes past the vertex array")
        self._lib = _bvh_lib()
        self._h = self._lib.tbvh_build(self._verts.ctypes.data_as(_F32P), self._verts.shape[0],
                                       self._faces.ctypes.data_as(_I32P), self._faces.shape[0])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tbvh_free(self._h)
            self._h = None

    def _distance(self, fn, pts, n_threads: int) -> np.ndarray:
        pts = _points(pts)
        out = np.empty(pts.shape[0], np.float32)
        fn(self._h, pts.ctypes.data_as(_F32P), pts.shape[0], out.ctypes.data_as(_F32P),
           int(n_threads))
        return out

    def signed_distance(self, pts: np.ndarray, n_threads: int = 0) -> np.ndarray:
        """(N,) signed distance of (N, 3) points, negative inside;
        ``n_threads`` 0 = every hardware thread."""
        return self._distance(self._lib.tbvh_signed_distance, pts, n_threads)

    def unsigned_distance(self, pts: np.ndarray, n_threads: int = 0) -> np.ndarray:
        return self._distance(self._lib.tbvh_unsigned_distance, pts, n_threads)

    def raycast(self, origins: np.ndarray, dirs: np.ndarray, n_threads: int = 0):
        """Closest hit -> (t (N,), triangle (N,) in the BVH's order); t = -1
        and triangle -1 on a miss."""
        o, d = _points(origins), _points(dirs)
        t = np.empty(o.shape[0], np.float32)
        tri = np.empty(o.shape[0], np.int32)
        self._lib.tbvh_raycast(self._h, o.ctypes.data_as(_F32P), d.ctypes.data_as(_F32P),
                               o.shape[0], t.ctypes.data_as(_F32P), tri.ctypes.data_as(_I32P),
                               int(n_threads))
        return t, tri

    def face_normals(self) -> np.ndarray:
        """(F, 3) unit face normals in the BVH's triangle order."""
        out = np.empty((self._lib.tbvh_n_tris(self._h), 3), np.float32)
        self._lib.tbvh_face_normals(self._h, out.ctypes.data_as(_F32P))
        return out


@functools.cache
def _raster_lib() -> ctypes.CDLL:
    lib = host_build.load("mesh_raster")
    lib.raster_mesh.restype = None
    lib.raster_mesh.argtypes = [
        _F32P, ctypes.c_int64, _I32P, ctypes.c_int64, _F32P,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, _F32P, _F32P,
    ]
    return lib


def render_mesh_image(verts: np.ndarray, faces: np.ndarray, pose_c2w: np.ndarray,
                      focal, principal, resolution, shaded: bool = False,
                      light_dir: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Rasterize a mesh from a camera with ``native/mesh_raster.cpp``: the
    eval's mesh panel (reference scripts/render_utils.py:418-421 render_mesh,
    scripts/run.py:68 --shaded_mesh).

    ``pose_c2w`` (3, 4) ngp camera-to-world; ``focal`` (fx, fy) in pixels;
    ``principal`` (cx, cy) as fractions of ``resolution`` (W, H).  Returns
    (rgb (H, W, 3) float32: the world normal map 0.5 n + 0.5, or Lambertian
    grey under a headlight (or ``light_dir``) when ``shaded``; depth (H,
    W)); the background is 0.  The world-to-camera matrix is built in
    float32, as the JAX binding builds it."""
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    pose = np.asarray(pose_c2w, np.float32).reshape(3, 4)
    rot, t = pose[:, :3], pose[:, 3]
    w2c = np.ascontiguousarray(np.concatenate([rot.T, (-rot.T @ t)[:, None]], axis=1),
                               np.float32)
    w, h = int(resolution[0]), int(resolution[1])
    rgb = np.zeros((h, w, 3), np.float32)
    depth = np.zeros((h, w), np.float32)
    light = None if light_dir is None else np.ascontiguousarray(light_dir, np.float32)
    _raster_lib().raster_mesh(
        verts.ctypes.data_as(_F32P), verts.shape[0], faces.ctypes.data_as(_I32P),
        faces.shape[0], w2c.ctypes.data_as(_F32P), float(focal[0]), float(focal[1]),
        float(principal[0]) * w, float(principal[1]) * h, w, h, int(bool(shaded)),
        None if light is None else light.ctypes.data_as(_F32P),
        rgb.ctypes.data_as(_F32P), depth.ctypes.data_as(_F32P),
    )
    return rgb, depth
