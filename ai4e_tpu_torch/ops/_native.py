"""Build-at-first-use for the port's CUDA C++ kernels (``csrc/*.cu``).

Counterpart of ``ai4e_tpu/utils/native_build.py``, for ``nvcc`` and the
H100. Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/ai4e_tpu_torch/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel or header is rebuilt
and a built one is reused. ``nvcc`` is found from
``CUDA_HOME``, then ``PATH``, then the toolkit's default prefix
``/usr/local/cuda``. There is no fallback: a missing compiler, a failed
build or a failed load raises, and the caller's CUDA tensor never reaches
a plain PyTorch version instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ai4e_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("image_preprocess", "seg_postprocess", "flash_attention")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the toolkit's default prefix

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for nvcc in candidates:
        if os.access(nvcc, os.X_OK):
            return nvcc
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    header in ``csrc/`` (``*.cuh``, which a source may include) and the
    flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns wall seconds per
    compiled source (built ones are left out); raises with the compiler's
    output if any build fails. ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept beside each library as
    ``.log``."""
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> dict[str, float]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    seconds: dict[str, float] = {}
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        out = library_path(name)
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for a built library ("" if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build_locked([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
