"""The g++ build of the port's plain-C host libraries (``csrc/*.cpp``):
each is compiled at its first use, never at import, into ``build/`` under
a name that carries the hash of its source and flags, so an edited source
rebuilds and concurrent builders each finish their own temporary file
before one atomic rename."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_library(src: str, name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` with g++ into ``build_dir`` as ``lib<name>_<hash>.so``
    unless that library is there; returns its path."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, f"lib{name}_{digest}.so")
    if not os.path.exists(lib):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: {os.path.basename(src)} is "
                               "built at its first use")
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *GXX_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib
