"""The raster A/B probes: CUDA kernels on CUDA tensors, plain versions on
CPU tensors.

Counterparts of the experiment probes of the JAX package, named after
their entry points there:

  raster_b          X1  ``_kernel_b``        experiments/profile_raster2.py:49
  raster_u          X2  ``_kernel_unroll``   experiments/profile_raster3.py:35
  rasterize_regacc  X3  ``_regacc_kernel``   experiments/profile_raster_regacc.py:49

Each probe is K1 (``ops/raster.py``) changed in the one respect it
measures, and runs in ``csrc/raster.cu`` behind ``vp_raster_probe``:

  X1  degenerate triangles draw nothing, and ``winner=False`` stores only
      depth (a 32-bit atomicMax in place of the 64-bit key);
  X2  each thread takes ``unroll`` consecutive triangles in each of ``fb``
      consecutive frames; the output is K1's at every setting;
  X3  one block per (frame, chunk of ``512 // fb`` triangles) accumulates
      the chunk's ``win``-row band in shared memory and flushes it once;
      fragments outside the band are dropped, so the output equals K1's
      only where every chunk fits its band.

On a CPU tensor the wrappers run the plain versions in
``face3d/raster.py``; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from voicepuppet_torch.face3d import raster as plain
from voicepuppet_torch.ops.raster import LIBRARY, _check

# X2's triangles per thread and frames per thread
UNROLLS = (1, 2, 4, 8)
# the H100's dynamic shared memory per block (227 KB)
MAX_SHARED_BYTES = 232448


def fb_for_batch(b: int, fb: int = 8) -> int:
    """The largest of 8, 4, 2, 1 that divides ``b`` (the JAX package's
    ``_fb_for_batch``)."""
    while b % fb:
        fb //= 2
    return max(fb, 1)


class ProbeKernel:
    """One probe of the library.  ``launches`` counts the wrapper calls that
    launched it (and nothing else)."""

    def __init__(self, name: str, probe: int):
        self.name = name
        self.probe = probe
        self.launches = 0

    def __call__(self, vertices: torch.Tensor, triangles: torch.Tensor,
                 h: int, w: int, a: int, b: int, winner: bool = True):
        """CUDA tensors only.  ``a``/``b``: the probe's settings
        (``vp_raster_probe``).  -> (winner, depth), or depth alone when
        ``winner`` is False."""
        nb, v, f = _check(vertices, triangles, h, w)
        dev = vertices.device
        fn = LIBRARY.probe_function()
        zbuf = torch.empty((nb, h, w), device=dev,
                           dtype=torch.int64 if winner else torch.int32)
        depth = torch.empty((nb, h, w), dtype=torch.float32, device=dev)
        win_buf = (torch.empty((nb, h, w), dtype=torch.int32, device=dev)
                   if winner else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(vertices.data_ptr(), triangles.data_ptr(), nb, v, f, h,
                     w, self.probe, int(a), int(b), zbuf.data_ptr(),
                     None if win_buf is None else win_buf.data_ptr(),
                     depth.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return (win_buf, depth) if winner else depth


PROBE_INSIDE_ONLY = ProbeKernel("probe_inside_only", 0)
PROBE_UNROLL = ProbeKernel("probe_unroll", 1)
PROBE_BAND_REGACC = ProbeKernel("probe_band_regacc", 2)
PROBE_KERNELS = (PROBE_INSIDE_ONLY, PROBE_UNROLL, PROBE_BAND_REGACC)


def raster_b(vertices: torch.Tensor, triangles: torch.Tensor, h: int = 224,
             w: int = 224, winner: bool = True):
    """X1: K1 with degenerate triangles drawing nothing -> (winner, depth),
    or with ``winner=False`` the depth buffer alone (the probe's
    depth-only variant)."""
    if vertices.device.type == "cpu":
        return plain.rasterize_winner_inside_only(vertices, triangles, h, w,
                                                  winner)
    return PROBE_INSIDE_ONLY(vertices, triangles, h, w, int(bool(winner)), 0,
                             winner=bool(winner))


def raster_u(vertices: torch.Tensor, triangles: torch.Tensor, h: int = 224,
             w: int = 224, fb: int = 8, unroll: int = 2):
    """X2: K1 with ``unroll`` triangles in each of ``fb`` frames per thread
    -> (winner, depth), equal to :func:`ops.raster.rasterize_winner`'s."""
    if fb not in UNROLLS or unroll not in UNROLLS:
        raise ValueError(f"fb and unroll must each be one of {UNROLLS}, got "
                         f"fb={fb} unroll={unroll}")
    if vertices.device.type == "cpu":
        return plain.rasterize_winner(vertices, triangles, h, w)
    return PROBE_UNROLL(vertices, triangles, h, w, unroll, fb)


def rasterize_regacc(vertices: torch.Tensor, triangles: torch.Tensor,
                     h: int = 224, w: int = 224, win: int = 16,
                     fb: Optional[int] = None):
    """X3: the band accumulator over chunks of ``512 // fb`` consecutive
    triangles (``fb`` defaults to :func:`fb_for_batch`; it sets only the
    chunk length) -> (winner, depth); ``face3d.raster
    .rasterize_winner_banded`` is its plain version."""
    if fb is None:
        fb = fb_for_batch(vertices.shape[0])
    if not 1 <= fb <= 512:
        raise ValueError(f"fb must lie in [1, 512], got {fb}")
    if not 1 <= win <= h or win * w * 8 > MAX_SHARED_BYTES:
        raise ValueError(f"band of {win} rows x {w} px does not fit: rows in "
                         f"[1, {h}], at most {MAX_SHARED_BYTES} B of keys")
    chunk = 512 // fb
    if vertices.device.type == "cpu":
        return plain.rasterize_winner_banded(vertices, triangles, h, w, win,
                                             chunk)
    return PROBE_BAND_REGACC(vertices, triangles, h, w, win, chunk)
