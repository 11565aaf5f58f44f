"""ctypes bindings to the repo's host C++ in ``native/`` (the port's own
counterpart of ``neus2_tpu/native/__init__.py``: marching cubes and the
threaded PNG/JPEG decoder).

Each source is compiled on first use by ``utils/host_build.py`` into
``neus2_tpu_torch/_build/``.  This is host code, not a GPU kernel: the
mesh's SDF grid is evaluated on the card (``engine/mesh.py``) and copied to
the host once.
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
