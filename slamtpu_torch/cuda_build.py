"""Build-on-first-use of the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library goes to ``build/slamtpu_torch/`` at the repository
root, named by a content hash of its sources and flags (as
``native_build.py`` does for the host decoders), so a stale library is
never loaded. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "slamtpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

# what the last build of each library printed (ptxas register and spill
# report) and how long it took, for the chip smoke run to show
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build_library(sources: tuple, stem: str) -> str:
    """Compile ``csrc`` sources to ``build/slamtpu_torch/lib<stem>-<hash>.so``
    unless that file exists; return its path."""
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so_path)  # atomic: concurrent builders converge
    BUILD_LOG[stem] = {"seconds": time.perf_counter() - t0, "output": r.stdout + r.stderr}
    return so_path
