"""Build a host C++ source of the repo's ``native/`` into a shared library
and load it with ctypes.

The host C++ compiler (``c++``) compiles the source at first use into
``neus2_tpu_torch/_build/``, keyed by a hash of the source and the flags,
so a fresh checkout builds what it runs and an edited source rebuilds.
Nothing is built at import time, and ``native/build.sh`` (which writes into
the JAX package) is never run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

from neus2_tpu_torch.utils.cuda_build import BUILD_DIR, _PKG

NATIVE = _PKG.parent / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(name: str, libs: tuple[str, ...] = ()) -> str:
    """Compile ``native/<name>.cpp`` unless the keyed library exists."""
    src = NATIVE / f"{name}.cpp"
    flags = (*CXX_FLAGS, *libs)
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}_{key}.so"
    if out.exists():
        return str(out)
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        # Libraries go after the source, so the linker resolves them.
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(src), *libs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"c++ failed for {name}.cpp:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


@functools.cache
def load(name: str, libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    return ctypes.CDLL(build(name, libs))
