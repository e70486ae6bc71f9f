"""The raster A/B probes: CUDA kernels on CUDA tensors, plain versions on
CPU tensors.

Counterparts of the experiment probes of the JAX package, named after
their entry points there:

  raster_b          X1  ``_kernel_b``        experiments/profile_raster2.py:49
  raster_u          X2  ``_kernel_unroll``   experiments/profile_raster3.py:35
  rasterize_regacc  X3  ``_regacc_kernel``   experiments/profile_raster_regacc.py:49

Each probe is K1 (``ops/raster.py``) changed in the one respect it
measures, and runs in ``csrc/raster.cu`` behind ``vp_raster_probe``; all
three walk with K1's balanced warp walk, so their times against K1's in
one run measure the change alone:

  X1  K1's kernel, grid and walk (32 entries a warp, their bboxes walked
      as one list), except that degenerate triangles draw nothing, and
      ``winner=False`` stores only depth (a 32-bit atomicMax in place of
      the 64-bit key, into a buffer of half the size);
  X2  lane j of a warp builds ``unroll`` consecutive triangles in each of
      ``fb`` consecutive frames (a triangle's indices loaded once for its
      frames), and the warp walks its 32 x unroll x fb entries in
      unroll x fb rounds of K1's balanced list of 32 slots, one entry a
      lane; at unroll = fb = 1 that is K1's schedule, and the output is
      K1's at every setting;
  X3  one block per (frame, chunk of ``512 // fb`` triangles) builds and
      walks the chunk as K1 does, with each bbox clipped to the chunk's
      ``win``-row band and the atomicMax going into the band in shared
      memory, then flushes only the union rectangle of the clipped bboxes;
      fragments outside the band are dropped, so the output equals K1's
      only where every chunk fits its band.

On a CPU tensor the wrappers run the plain versions in
``face3d/raster.py``; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from voicepuppet_torch.face3d import raster as plain
from voicepuppet_torch.ops.raster import LIBRARY, _check

# X2's triangles per thread and frames per thread
UNROLLS = (1, 2, 4, 8)
# the H100's dynamic shared memory per block (227 KB)
MAX_SHARED_BYTES = 232448
# X3's shared memory per walk slot: a WalkSlot (80 B) and its sum (4 B)
SLOT_BYTES = 84


def fb_for_batch(b: int, fb: int = 8) -> int:
    """The largest of 8, 4, 2, 1 that divides ``b`` (the JAX package's
    ``_fb_for_batch``)."""
    while b % fb:
        fb //= 2
    return max(fb, 1)


def regacc_slots(chunk: int) -> int:
    """The length of X3's walk list for a chunk: the power of two >=
    max(chunk, 32)."""
    return max(32, 1 << (chunk - 1).bit_length())


def regacc_shared_bytes(win: int, w: int, chunk: int) -> int:
    """X3's shared memory per block: the band's win x w uint64 keys
    (rounded up to 16 B) and the chunk's walk list
    (``band_shared_bytes``)."""
    return -(-win * w * 8 // 16) * 16 + regacc_slots(chunk) * SLOT_BYTES


class ProbeKernel:
    """One probe of the library.  ``launches`` counts the wrapper calls that
    launched it (and nothing else)."""

    def __init__(self, name: str, probe: int):
        self.name = name
        self.probe = probe
        self.launches = 0

    def launch_shape(self, a: int, b: int, h: int, w: int) -> Dict[str, int]:
        """X1 (a = 1 winner, 0 depth-only; b unused), X2 (a = unroll,
        b = fb) or X3 (a = win, b = chunk) on an h x w canvas, as the card
        builds it: registers a thread, static and dynamic shared bytes and
        threads a block, and resident blocks an SM
        (``vp_raster_probe_attrs``).  Needs a CUDA device."""
        out = (ctypes.c_int * 5)()
        err = LIBRARY.probe_attrs_function()(self.probe, int(a), int(b),
                                                  int(h), int(w), out)
        if err != 0:
            raise RuntimeError(f"{self.name} attributes: CUDA error {err}")
        return dict(zip(("registers", "static_shared", "dynamic_shared",
                         "threads", "blocks_per_sm"), out))

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
    depth-only variant).  It walks as K1 does, 32 bbox areas a warp, so
    K1's size check (``_check_size``) keeps its sums in 32 bits."""
    if vertices.device.type == "cpu":
        return plain.rasterize_winner_inside_only(vertices, triangles, h, w,
                                                  winner)
    return PROBE_INSIDE_ONLY(vertices, triangles, h, w, int(bool(winner)), 0,
                             winner=bool(winner))


def raster_u(vertices: torch.Tensor, triangles: torch.Tensor, h: int = 224,
             w: int = 224, fb: int = 8, unroll: int = 2):
    """X2: K1's balanced walk over warps of 32 x ``unroll`` x ``fb``
    entries, lane j building ``unroll`` triangles in each of ``fb`` frames
    -> (winner, depth), equal to :func:`ops.raster.rasterize_winner`'s.
    A round sums 32 bbox areas, as K1's warp does, so K1's size check
    (``_check_size``) keeps its sums in 32 bits."""
    if fb not in UNROLLS or unroll not in UNROLLS:
        raise ValueError(f"fb and unroll must each be one of {UNROLLS}, got "
                         f"fb={fb} unroll={unroll}")
    if vertices.device.type == "cpu":
        return plain.rasterize_winner(vertices, triangles, h, w)
    return PROBE_UNROLL(vertices, triangles, h, w, unroll, fb)


def rasterize_regacc(vertices: torch.Tensor, triangles: torch.Tensor,
                     h: int = 224, w: int = 224, win: int = 16,
                     fb: Optional[int] = None):
    """X3: the shared-memory band accumulator over chunks of ``512 // fb``
    consecutive triangles (``fb`` defaults to :func:`fb_for_batch`; it
    sets only the chunk length), walked as K1 walks and flushed over the
    union rectangle of each chunk's band-clipped bboxes -> (winner,
    depth); ``face3d.raster.rasterize_winner_banded`` is its plain
    version."""
    if fb is None:
        fb = fb_for_batch(vertices.shape[0])
    if not 1 <= fb <= 512:
        raise ValueError(f"fb must lie in [1, 512], got {fb}")
    chunk = 512 // fb
    if (not 1 <= win <= h
            or regacc_shared_bytes(win, w, chunk) > MAX_SHARED_BYTES):
        raise ValueError(f"band of {win} rows x {w} px does not fit: rows in "
                         f"[1, {h}], at most {MAX_SHARED_BYTES} B of keys "
                         "and walk slots")
    if vertices.device.type == "cpu":
        return plain.rasterize_winner_banded(vertices, triangles, h, w, win,
                                             chunk)
    return PROBE_BAND_REGACC(vertices, triangles, h, w, win, chunk)
