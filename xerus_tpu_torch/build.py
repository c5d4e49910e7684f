"""Builds the hand-written CUDA kernels of xerus_tpu_torch on first use.

Each kernel source in ``csrc/`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ctypes.  Libraries go
into ``xerus_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  A missing ``nvcc`` or a failed compile raises: there is no
fallback to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one kernel beside the common ones: df_matvec's error-free
# transformations must never see a multiply and an add contracted into an
# FMA (-fmad=false); the GEMM-only gemm_exact and the TT evaluation
# tt_eval want FFMA contraction
KERNEL_FLAGS = {"df_matvec": ["-fmad=false"], "gemm_exact": [],
                "tt_eval": []}

_loaded = {}
# seconds and compiler output of the builds made by this process
build_log = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of xerus_tpu_torch "
                       "are built from csrc/ on the machine with the card")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with its flags (once per content of the
    source, of the headers in ``csrc/`` and of the flags) and load it."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, name + ".cu")
    flags = NVCC_FLAGS + KERNEL_FLAGS[name]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": proc.stderr.strip()}
    lib = ctypes.CDLL(lib_path)
    _loaded[name] = lib
    return lib
