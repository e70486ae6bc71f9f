"""Raster entry points: the CUDA kernels on CUDA tensors, the plain versions
on CPU tensors.

Counterparts of ``voicepuppet_tpu/ops/raster_pallas.py``:

  rasterize_winner            rasterize_winner_pallas /
                              rasterize_winner_xband_pallas       (K1/K2)
  render_colors_kernel        render_colors_pallas                (K1)
  render_colors_xband         render_colors_xband_pallas          (K2)
  rasterize_winner_grouped    rasterize_winner_grouped_pallas     (K4)
  render_colors_grouped       render_colors_grouped_pallas        (K4)
  rasterize_winner_interp     rasterize_winner_interp_pallas      (K3; K5
                                                                   with group)
  rasterize_triangles_kernel  rasterize_triangles_pallas          (K3/K5)
  render_texture_kernel       render_texture_pallas               (K3/K5)

All of them run one source, ``csrc/raster.cu``: a per-triangle pass (K1,
K3) or a per-group pass (K4, K5) of 64-bit atomicMax into a z-buffer, then
a resolve pass that also does the ``_flat_color_image`` gather.  The TPU
layout knobs ``win``, ``fb``, ``guard`` and ``fallback`` are accepted so
signatures match, and ignored: the kernels walk each triangle's whole
clipped bbox and never crop, so their output is always the guard-correct
one.  ``winner_weights`` and ``sample_texture`` after K3/K5 are dense torch
post-passes (``face3d/raster.py``), on the card as on the CPU.

The source is built with ``nvcc`` into ``build/`` at the repo root at the
first CUDA call (a plain-C shared library loaded with ``ctypes``), never at
import.  On a CPU tensor the wrappers run the plain versions in
``face3d/raster.py``; on a CUDA tensor they launch a kernel or raise.
Triangle indices are range-checked where the topology is made
(``face3d.morph.device_bfm``), not at each launch; the kernels skip a
triangle with an index outside [0, V) instead of reading out of bounds.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from voicepuppet_torch.face3d import raster as plain
from voicepuppet_torch.utils import native

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "raster.cu")


class RasterLibrary:
    """The lazily built ``csrc/raster.cu`` library, shared by the kernels:
    ``vp_raster`` (K1-K5) and ``vp_raster_probe`` (the probes X1-X3,
    ``ops/raster_probes.py``)."""

    def __init__(self):
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._lib is None:
                path, self.build_log = native.build_cuda_library(
                    _SRC, "vp_raster")
                lib = ctypes.CDLL(path)
                lib.vp_raster.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 8
                                          + [ctypes.c_void_p] * 6)
                lib.vp_raster.restype = ctypes.c_int
                lib.vp_raster_probe.argtypes = ([ctypes.c_void_p] * 2
                                                + [ctypes.c_int] * 8
                                                + [ctypes.c_void_p] * 4)
                lib.vp_raster_probe.restype = ctypes.c_int
                lib.vp_raster_probe_attrs.argtypes = ([ctypes.c_int] * 5
                                                      + [ctypes.c_void_p])
                lib.vp_raster_probe_attrs.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def function(self):
        return self._load().vp_raster

    def probe_function(self):
        return self._load().vp_raster_probe

    def probe_attrs_function(self):
        return self._load().vp_raster_probe_attrs


LIBRARY = RasterLibrary()


class RasterKernel:
    """One kernel of the library: flat or interpolated depth, per triangle
    or per group.  ``launches`` counts the wrapper calls that launched it
    (and nothing else)."""

    def __init__(self, name: str, interp: bool, grouped: bool):
        self.name = name
        self.interp = interp
        self.grouped = grouped
        self.launches = 0

    def __call__(self, vertices: torch.Tensor, triangles: torch.Tensor,
                 h: int, w: int, colors: Optional[torch.Tensor] = None,
                 group: int = 0):
        """CUDA tensors only.  Returns (winner, depth) without colors,
        (image, mask) with them."""
        b, v, f = _check(vertices, triangles, h, w)
        if self.grouped != (group > 0):
            raise ValueError(f"{self.name} takes "
                             f"{'group >= 1' if self.grouped else 'group 0'}"
                             f", got group={group}")
        dev = vertices.device
        if colors is not None:
            if (colors.device != dev or colors.dtype != torch.float32
                    or colors.dim() != 3 or colors.shape[:2] != (b, v)
                    or not colors.is_contiguous()):
                raise ValueError("colors must be a contiguous float32 "
                                 f"[{b},{v},C] tensor on {dev}, got "
                                 f"{colors.dtype} {tuple(colors.shape)} on "
                                 f"{colors.device}")
        fn = LIBRARY.function()
        zbuf = torch.empty((b, h, w), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            common = (vertices.data_ptr(), triangles.data_ptr())
            if colors is None:
                winner = torch.empty((b, h, w), dtype=torch.int32, device=dev)
                depth = torch.empty((b, h, w), dtype=torch.float32,
                                    device=dev)
                err = fn(*common, None, b, v, f, 0, h, w, int(self.interp),
                         int(group), zbuf.data_ptr(), winner.data_ptr(),
                         depth.data_ptr(), None, None, stream)
                out = (winner, depth)
            else:
                c = colors.shape[2]
                image = torch.empty((b, h, w, c), dtype=torch.uint8,
                                    device=dev)
                mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
                err = fn(*common, colors.data_ptr(), b, v, f, c, h, w,
                         int(self.interp), int(group), zbuf.data_ptr(), None,
                         None, image.data_ptr(), mask.data_ptr(), stream)
                out = (image, mask)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
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
    _check_size(b, f, h, w)
    return b, v, f


def _check_size(b: int, f: int, h: int, w: int):
    """The sizes the kernels index in 32 bits: B x h x w pixels and B x F
    entries below 2^31, and 32 x h x w too, since the per-triangle kernel
    sums the bbox areas of a warp's 32 entries (each at most h x w)."""
    if h <= 0 or w <= 0 or max(b, 32) * h * w >= 2 ** 31 or b * f >= 2 ** 31:
        raise ValueError(f"unsupported raster size B={b} F={f} {h}x{w}")


RASTER = RasterKernel("raster_flat", interp=False, grouped=False)
RASTER_GROUPED = RasterKernel("raster_grouped", interp=False, grouped=True)
RASTER_INTERP = RasterKernel("raster_interp", interp=True, grouped=False)
RASTER_INTERP_GROUPED = RasterKernel("raster_interp_grouped", interp=True,
                                     grouped=True)
KERNELS = (RASTER, RASTER_GROUPED, RASTER_INTERP, RASTER_INTERP_GROUPED)


def _group(group: int) -> int:
    group = int(group)
    if group < 1:
        raise ValueError(f"the grouped raster takes group >= 1, got {group}")
    return group


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


def rasterize_winner_grouped(vertices: torch.Tensor, triangles: torch.Tensor,
                             h: int = 224, w: int = 224, win: int = 32,
                             group: int = 4, fb: Optional[int] = None,
                             fallback: bool = True):
    """K4: the flat winner merged per ``group`` consecutive triangles; the
    output equals :func:`rasterize_winner`'s.  ``win``/``fb``/``fallback``:
    TPU layout knobs, ignored (module doc)."""
    group = _group(group)
    if vertices.device.type == "cpu":
        return plain.rasterize_winner(vertices, triangles, h, w, group=group)
    return RASTER_GROUPED(vertices, triangles, h, w, group=group)


def render_colors_grouped(vertices: torch.Tensor, colors: torch.Tensor,
                          triangles: torch.Tensor, h: int = 224,
                          w: int = 224, win: int = 32, group: int = 4,
                          fb: Optional[int] = None, fallback: bool = True):
    """K4 flat-shaded render -> (image uint8 [B,h,w,C], mask uint8 [B,h,w]),
    equal to :func:`render_colors_kernel`'s."""
    group = _group(group)
    if vertices.device.type == "cpu":
        return plain.render_colors(vertices, colors, triangles, h, w,
                                   group=group)
    return RASTER_GROUPED(vertices, triangles, h, w, colors=colors,
                          group=group)


def rasterize_winner_interp(vertices: torch.Tensor, triangles: torch.Tensor,
                            h: int = 224, w: int = 224, win: int = 16,
                            fb: Optional[int] = None, group: int = 0,
                            guard: bool = True):
    """K3 (``group`` <= 0) or K5: winner [B,h,w] int32 in [0,F] and the
    winner's interpolated depth [B,h,w] under the 2-px border rule
    (mesh_core.cpp:108-166).  K5's output equals K3's.
    ``win``/``fb``/``guard``: TPU layout knobs, ignored (module doc)."""
    group = max(int(group), 0)
    if vertices.device.type == "cpu":
        return plain.rasterize_winner_interp(vertices, triangles, h, w,
                                             group=group)
    kernel = RASTER_INTERP_GROUPED if group else RASTER_INTERP
    return kernel(vertices, triangles, h, w, group=group)


def rasterize_triangles_kernel(vertices: torch.Tensor,
                               triangles: torch.Tensor, h: int = 224,
                               w: int = 224, win: int = 16,
                               fb: Optional[int] = None,
                               group: int = 0) -> plain.RasterOut:
    """K3/K5 winner + the dense barycentric post-pass -> RasterOut
    (``face3d.raster.rasterize_triangles``'s output)."""
    winner, depth = rasterize_winner_interp(vertices, triangles, h, w,
                                            group=group)
    return plain.winner_weights(vertices, triangles, winner, depth, h, w)


def render_texture_kernel(vertices: torch.Tensor, triangles: torch.Tensor,
                          texture: torch.Tensor, tex_coords: torch.Tensor,
                          tex_triangles: torch.Tensor, h: int = 224,
                          w: int = 224, win: int = 16,
                          fb: Optional[int] = None, group: int = 0,
                          bilinear: bool = True):
    """UV-textured render (mesh_core.cpp:234-333) -> (image [B,h,w,C],
    depth [B,h,w]): K3/K5, then ``sample_texture``."""
    out = rasterize_triangles_kernel(vertices, triangles, h, w, group=group)
    return plain.sample_texture(out, texture, tex_coords, tex_triangles,
                                bilinear)
