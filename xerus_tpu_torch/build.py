"""Builds the hand-written CUDA kernels of xerus_tpu_torch on first use,
and the JAX package's host C++ sources the port loads too.

Each kernel source in ``csrc/`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ctypes.  Libraries go
into ``xerus_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  A missing ``nvcc`` or a failed compile raises: there is no
fallback to a plain version.

``native/*.cpp`` (the contraction-path search, the sparse QR) are built
the same way with g++ and the flags of ``native/Makefile``
(``build_host_library``), so the port writes nothing under ``native/``.
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
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
# native/Makefile's CXXFLAGS and its -shared link
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]

# sm_90a keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one kernel beside the common ones: the error-free
# transformations of the df kernels (df_matvec, df_qr, df_chol) must never
# see a multiply and an add contracted into an FMA (-fmad=false); the
# GEMM-only gemm_exact, the TT evaluation tt_eval and the Jacobi eigh / SVD
# (jacobi) want FFMA contraction
KERNEL_FLAGS = {"df_matvec": ["-fmad=false"], "df_qr": ["-fmad=false"],
                "df_chol": ["-fmad=false"], "gemm_exact": [], "tt_eval": [],
                "jacobi": []}

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


def load_kernel_library(name: str, defines: tuple = (),
                        csrc: str = CSRC) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with its flags and the macros
    ``defines`` (once per content of the source, of the headers in
    ``csrc/`` and of the flags) and load it.  ``csrc``: another source
    directory (another version's, for a comparison in one process)."""
    key = (name, *defines, *([csrc] if csrc != CSRC else []))
    if key in _loaded:
        return _loaded[key]
    src = os.path.join(csrc, name + ".cu")
    flags = NVCC_FLAGS + KERNEL_FLAGS[name] + [f"-D{d}" for d in defines]
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
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
        build_log[" ".join(key)] = {"seconds": time.perf_counter() - t0,
                                    "ptxas": proc.stderr.strip()}
    lib = ctypes.CDLL(lib_path)
    _loaded[key] = lib
    return lib


def host_library_path(name: str) -> str:
    """Where the library of ``native/<name>.cpp`` at its current content
    and ``CXX_FLAGS`` lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(NATIVE_DIR, name + ".cpp"), "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_host_library(name: str) -> str:
    """Compile ``native/<name>.cpp`` with g++ into ``_build/`` unless the
    library of its content is there; returns its path.  Raises OSError
    when there is no g++ or the compile fails."""
    path = host_library_path(name)
    if os.path.exists(path):
        return path
    src = os.path.join(NATIVE_DIR, name + ".cpp")
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError(f"no C++ compiler (g++) for {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise OSError(f"g++ failed on {src}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path
