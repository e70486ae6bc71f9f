"""Raster entry points: the CUDA kernel on CUDA tensors, the plain version
on CPU tensors.

Counterparts of ``voicepuppet_tpu/ops/raster_pallas.py``:

  rasterize_winner      rasterize_winner_pallas / rasterize_winner_xband_pallas
  render_colors_kernel  render_colors_pallas
  render_colors_xband   render_colors_xband_pallas

All three run one kernel, ``csrc/raster.cu`` (the port of ``_raster_kernel``,
K1/K2), which also does the ``_flat_color_image`` gather.  The TPU layout
knobs ``win``, ``fb`` and ``guard`` are accepted so signatures match, and
ignored: the kernel walks each triangle's whole clipped bbox and never
crops, so its output is always the guard-correct one.

The kernel is built with ``nvcc`` from the source in this package into
``build/`` at the repo root at its first CUDA call (a plain-C shared
library loaded with ``ctypes``), never at import.  On a CPU tensor the
wrappers run the plain version in ``face3d/raster.py``; on a CUDA tensor
they launch the kernel or raise.  Triangle indices are range-checked where
the topology is made (``face3d.morph.device_bfm``), not at each launch; the
kernel skips a triangle with an index outside [0, V) instead of reading out
of bounds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

from voicepuppet_torch.face3d import raster as plain

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "raster.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA raster kernel is built "
                       "from csrc/raster.cu at its first CUDA call")


def build_library(src: str = _SRC, build_dir: str = BUILD_DIR) -> Tuple[str, str]:
    """Compile ``src`` into ``build_dir`` (named by the source hash, so an
    edited source rebuilds).  Returns (library path, nvcc's output)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, f"libvp_raster_{digest}.so")
    if os.path.exists(lib):
        return lib, ""
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class RasterKernel:
    """Lazily built CUDA raster kernel.  ``launches`` counts the wrapper
    calls that launched it (and nothing else)."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library(self):
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_library()
                lib = ctypes.CDLL(path)
                fn = lib.vp_raster_flat
                fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p] * 6)
                fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def __call__(self, vertices: torch.Tensor, triangles: torch.Tensor,
                 h: int, w: int, colors: Optional[torch.Tensor] = None):
        """CUDA tensors only.  Returns (winner, depth) without colors,
        (image, mask) with them."""
        b, v, f = _check(vertices, triangles, h, w)
        dev = vertices.device
        if colors is not None:
            if (colors.device != dev or colors.dtype != torch.float32
                    or colors.dim() != 3 or colors.shape[:2] != (b, v)
                    or not colors.is_contiguous()):
                raise ValueError("colors must be a contiguous float32 "
                                 f"[{b},{v},C] tensor on {dev}, got "
                                 f"{colors.dtype} {tuple(colors.shape)} on "
                                 f"{colors.device}")
        fn = self.library().vp_raster_flat
        zbuf = torch.empty((b, h, w), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if colors is None:
                winner = torch.empty((b, h, w), dtype=torch.int32, device=dev)
                depth = torch.empty((b, h, w), dtype=torch.float32,
                                    device=dev)
                err = fn(vertices.data_ptr(), triangles.data_ptr(), None,
                         b, v, f, 0, h, w, zbuf.data_ptr(),
                         winner.data_ptr(), depth.data_ptr(), None, None,
                         stream)
                out = (winner, depth)
            else:
                c = colors.shape[2]
                image = torch.empty((b, h, w, c), dtype=torch.uint8,
                                    device=dev)
                mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
                err = fn(vertices.data_ptr(), triangles.data_ptr(),
                         colors.data_ptr(), b, v, f, c, h, w,
                         zbuf.data_ptr(), None, None, image.data_ptr(),
                         mask.data_ptr(), stream)
                out = (image, mask)
        if err != 0:
            raise RuntimeError(f"raster kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


def _check(vertices, triangles, h, w):
    if vertices.device.type != "cuda" or triangles.device != vertices.device:
        raise ValueError("the CUDA raster takes vertices and triangles on "
                         f"one CUDA device, got {vertices.device} and "
                         f"{triangles.device}")
    if (vertices.dtype != torch.float32 or vertices.dim() != 3
            or vertices.shape[2] != 3 or not vertices.is_contiguous()):
        raise ValueError("vertices must be a contiguous float32 [B,V,3] "
                         f"tensor, got {vertices.dtype} "
                         f"{tuple(vertices.shape)}")
    if (triangles.dtype != torch.int32 or triangles.dim() != 2
            or triangles.shape[1] != 3 or not triangles.is_contiguous()):
        raise ValueError("triangles must be a contiguous int32 [F,3] "
                         f"tensor, got {triangles.dtype} "
                         f"{tuple(triangles.shape)}")
    b, v, _ = vertices.shape
    f = triangles.shape[0]
    if h <= 0 or w <= 0 or b * h * w >= 2 ** 31 or b * f >= 2 ** 31:
        raise ValueError(f"unsupported raster size B={b} F={f} {h}x{w}")
    return b, v, f


RASTER = RasterKernel()


def rasterize_winner(vertices: torch.Tensor, triangles: torch.Tensor,
                     h: int = 224, w: int = 224, win: int = 16,
                     fb: Optional[int] = None, guard: bool = True):
    """[B,V,3] + [F,3] -> (winner [B,h,w] int32 in [0,F], depth [B,h,w]).
    ``win``/``fb``/``guard``: TPU layout knobs, ignored (module doc)."""
    if vertices.device.type == "cpu":
        return plain.rasterize_winner(vertices, triangles, h, w)
    return RASTER(vertices, triangles, h, w)


def render_colors_kernel(vertices: torch.Tensor, colors: torch.Tensor,
                         triangles: torch.Tensor, h: int = 224,
                         w: int = 224, win: int = 16,
                         fb: Optional[int] = None, guard: bool = True):
    """Flat-shaded render -> (image uint8 [B,h,w,C], mask uint8 [B,h,w]).
    ``win``/``fb``/``guard``: TPU layout knobs, ignored (module doc)."""
    if vertices.device.type == "cpu":
        return plain.render_colors(vertices, colors, triangles, h, w)
    return RASTER(vertices, triangles, h, w, colors=colors)


def render_colors_xband(vertices: torch.Tensor, colors: torch.Tensor,
                        triangles: torch.Tensor, h: int = 224,
                        w: int = 224, win: int = 16,
                        fb: Optional[int] = None, guard: bool = True):
    """The x-banded entry point: 128-lane bands are a TPU device, so on
    Hopper it is the same kernel as :func:`render_colors_kernel`."""
    return render_colors_kernel(vertices, colors, triangles, h, w, win, fb,
                                guard)
