"""The build of the port's plain-C libraries: the host ones (``csrc/*.cpp``)
with g++, the device ones (``csrc/*.cu``) with nvcc for sm_90a.  Each is
compiled at its first use, never at import, into ``build/`` under a name
that carries the hash of its source and flags, so an edited source
rebuilds and concurrent builders each finish their own temporary file
before one atomic rename."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/*.cu at their first CUDA call")


def _build(src: str, name: str, build_dir: str, compiler: str,
           flags: Sequence[str]) -> Tuple[str, str]:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, f"lib{name}_{digest}.so")
    if os.path.exists(lib):
        return lib, ""
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                           f"{src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build_library(src: str, name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` with g++ into ``build_dir`` as ``lib<name>_<hash>.so``
    unless that library is there; returns its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {os.path.basename(src)} is "
                           "built at its first use")
    return _build(src, name, build_dir, gxx, GXX_FLAGS)[0]


def build_cuda_library(src: str, name: str, build_dir: str = BUILD_DIR
                       ) -> Tuple[str, str]:
    """Compile ``src`` with nvcc for sm_90a into ``build_dir`` as
    ``lib<name>_<hash>.so`` unless that library is there.  Returns (library
    path, nvcc's output: ptxas's registers, shared memory and spills of
    each kernel, empty when the library was there)."""
    return _build(src, name, build_dir, find_nvcc(), NVCC_FLAGS)
