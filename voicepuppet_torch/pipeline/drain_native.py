"""ctypes binding of the drain's host unpack (``csrc/vp_drain.cpp``).

:func:`unpack_yuv420` turns a packed YUV 4:2:0 chunk into RGB bytes equal
to :func:`voicepuppet_torch.pipeline.synthesize._unpack_yuv420`'s (the
numpy routine, kept as the tests' oracle), in one compiled pass on the
calling thread, with the GIL released for the call (``ctypes.CDLL``), so
the thread dispatching the card's work runs meanwhile.  The library is
built with g++ into ``build/`` at the first call, never at import
(``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from voicepuppet_torch.utils import native

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "vp_drain.cpp")

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build_library(_SRC, "vp_drain"))
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.vp_unpack_yuv420.argtypes = [u8, ctypes.c_int, ctypes.c_int,
                                             u8]
            lib.vp_unpack_yuv420.restype = None
            _lib = lib
        return _lib


def unpack_yuv420(packed: np.ndarray, s: int) -> np.ndarray:
    """[N, S*S*3//2] uint8 planar YUV 4:2:0 (S even) -> a new [N, S, S, 3]
    uint8 RGB array."""
    lib = _load()
    p = np.ascontiguousarray(packed, np.uint8)
    if s % 2 or p.ndim != 2 or p.shape[1] != s * s * 3 // 2:
        raise ValueError(f"packed must be [N, {s * s * 3 // 2}] for an even "
                         f"size, got {packed.shape} at size {s}")
    out = np.empty((p.shape[0], s, s, 3), np.uint8)
    lib.vp_unpack_yuv420(p, p.shape[0], s, out)
    return out
