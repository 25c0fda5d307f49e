"""Build-at-first-use for the port's host codecs (``native/*.cpp``); a copy
of ``ai4e_tpu/utils/native_build.py``'s ``load_native_function``.

Each source compiles with the host C++ compiler into a shared library under
``build/ai4e_tpu_torch/``, named by a hash of the source and the flags, so
an edited source is rebuilt and a built one reused; the library is written
to a temporary name and renamed into place, so processes that build at once
never load a half-written file. Honours ``CXX`` and ``CXXFLAGS`` as the JAX
package does. Nothing is ever written into the JAX package's ``native/``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shlex
import subprocess
from pathlib import Path

log = logging.getLogger("ai4e_tpu_torch.native_build")

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "ai4e_tpu_torch")
DEFAULT_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def build_native_library(src_name: str, so_name: str) -> str:
    """Compile ``native/{src_name}`` into ``build/ai4e_tpu_torch/`` unless a
    build of the same source and flags is there; returns the library's
    path. ``so_name`` (``lib<x>.so``) names it, with the hash before the
    suffix."""
    src = NATIVE_DIR / src_name
    cxx = os.environ.get("CXX", "g++")
    flags = (shlex.split(os.environ["CXXFLAGS"])
             if os.environ.get("CXXFLAGS") else DEFAULT_FLAGS)
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join([cxx, *flags]).encode())
    stem = so_name[:-3] if so_name.endswith(".so") else so_name
    out = BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, str(src), "-o", str(tmp)]
    log.info("building native codec: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


def load_native_function(src_name: str, so_name: str, fn_name: str,
                         restype, argtypes):
    """Build if needed, load, and bind ONE function; None when the
    toolchain cannot produce it (the caller keeps its numpy version).
    ``ctypes.CDLL`` releases the GIL during the foreign call."""
    try:
        import ctypes

        lib = ctypes.CDLL(build_native_library(src_name, so_name))
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
        return fn
    except Exception:  # noqa: BLE001 — the numpy fallback keeps serving
        log.exception("native %s unavailable; the caller falls back to "
                      "numpy", so_name)
        return None
