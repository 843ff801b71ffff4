"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc at first use and
load them with ctypes.

Each source compiles on its own into ``pysolvers_tpu_torch/_build/lib<name>.so``
(a plain C interface; no PyTorch headers, so a build takes seconds).  The
compile goes to a temporary name and is renamed into place atomically, so
concurrent builds never leave a half-written library, and a source newer
than its library triggers a rebuild.  The compiler's output (``-Xptxas -v``:
registers, shared memory, spills) is kept beside the library as
``lib<name>.log``.  Only sources in this package are built; a missing nvcc
or a failed build raises.
"""
from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}

# Launches per (kernel id, dtype name) since the last reset, e.g.
# ("K1", "float32"): every kernel wrapper adds one here where it adds one to
# its own launch count, so a run can tell a path's f32 launches from its f64
# ones (the mixed-precision routes run both).
launches_by_dtype: collections.Counter = collections.Counter()


def count_launch(kernel: str, dtype) -> None:
    launches_by_dtype[kernel, str(dtype).split(".")[-1]] += 1


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "CUDA_HOME); the CUDA kernels cannot be built")
    return nvcc


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; returns
    the library's path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib
