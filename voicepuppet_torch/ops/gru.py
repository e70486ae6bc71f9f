"""The masked GRU recurrence of the coefficient programs as one hand-written
CUDA kernel.

``gru_recurrence(xg, w_h, h0, seq_len)`` runs the recurrence of one
``models.layers.MaskedGRU`` layer on CUDA tensors, given its input half
already computed for every step (``xg = x W_x^T + b``, one matrix product
over all steps, [B,T,3U]: the r, u and candidate columns), the recurrent
weights ``w_h`` [3U,U] (rows r, u, c; the h columns of ``Dense_0`` and
``Dense_1``), the initial state ``h0`` [B,U] (None: zeros) and ``seq_len``
[B]:

    r, u = sigmoid(xg_g + h W_gh^T),  c = tanh(xg_c + (r * h) W_ch^T),
    h' = u * h + (1 - u) * c

for t < seq_len of each row.  Returns ``(out [B,T,U], h_final [B,U])``:
the outputs zero at t >= seq_len, the state after seq_len steps (``h0``
for an empty row), which is the eager loop's masked output and frozen
carry.  It runs ``csrc/gru.cu`` (one thread-block cluster of U / 32 blocks
a row, W_h in shared memory, all steps in one launch), built with nvcc into
``build/`` at the first call, never at import, and loaded with ``ctypes``.
It takes float32 CUDA tensors with U a multiple of 32 up to 256 and raises
on anything else (:func:`unsupported` says why); ``MaskedGRU.forward``
sends it what it takes when no autograd graph is wanted and the call is not
training.

``gru_recurrence_plain`` is the same function in torch, on any device: the
step loop the kernel runs, in the torch ops' order of sums.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from voicepuppet_torch.utils import native

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "gru.cu")
UNIT_BLOCK = 32        # hidden units a block owns
MAX_UNITS = 256        # 8 blocks a cluster, the portable maximum


def units_problem(units: int) -> Optional[str]:
    """Why the kernel cannot take a layer of ``units`` hidden units, or
    None."""
    if units % UNIT_BLOCK or not 0 < units <= MAX_UNITS:
        return (f"units must be a multiple of {UNIT_BLOCK} up to "
                f"{MAX_UNITS}, got {units}")
    return None


def state_problem(h0: Optional[torch.Tensor], device: torch.device,
                  b: int, units: int) -> Optional[str]:
    """Why the kernel cannot take ``h0`` as a [b, units] initial state on
    ``device`` (None: zeros), or None."""
    if h0 is None:
        return None
    if (h0.device != device or h0.dtype != torch.float32
            or tuple(h0.shape) != (b, units) or not h0.is_contiguous()):
        return (f"h0 must be a contiguous float32 [{b},{units}] tensor on "
                f"{device}, got {h0.dtype} {tuple(h0.shape)} on "
                f"{h0.device}")
    return None


def lengths_problem(seq_len: torch.Tensor, device: torch.device,
                    b: int) -> Optional[str]:
    """Why the kernel cannot take ``seq_len`` as the [b] lengths of rows on
    ``device``, or None."""
    if (not isinstance(seq_len, torch.Tensor) or seq_len.device != device
            or seq_len.dtype not in (torch.int32, torch.int64)
            or tuple(seq_len.shape) != (b,)):
        what = (f"{seq_len.dtype} {tuple(seq_len.shape)} on "
                f"{seq_len.device}" if isinstance(seq_len, torch.Tensor)
                else type(seq_len).__name__)
        return (f"seq_len must be an int32 or int64 [{b}] tensor on "
                f"{device}, got {what}")
    return None


def unsupported(xg: torch.Tensor, w_h: torch.Tensor,
                h0: Optional[torch.Tensor],
                seq_len: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take these inputs, or None when it can."""
    if xg.device.type != "cuda":
        return f"xg must be a CUDA tensor, got {xg.device}"
    return layout_problem(xg, w_h, h0, seq_len)


def layout_problem(xg: torch.Tensor, w_h: torch.Tensor,
                   h0: Optional[torch.Tensor],
                   seq_len: torch.Tensor) -> Optional[str]:
    """What the kernel needs of the inputs besides a CUDA device: why it
    cannot take them, or None."""
    if (xg.dtype != torch.float32 or xg.dim() != 3 or xg.shape[2] % 3
            or not xg.is_contiguous()):
        return (f"xg must be a contiguous float32 [B,T,3U] tensor, got "
                f"{xg.dtype} {tuple(xg.shape)}")
    b, t, units = xg.shape[0], xg.shape[1], xg.shape[2] // 3
    if b == 0 or t == 0:
        return f"xg {tuple(xg.shape)} is empty"
    why = units_problem(units)
    if why is not None:
        return why
    if (w_h.device != xg.device or w_h.dtype != torch.float32
            or tuple(w_h.shape) != (3 * units, units) or w_h.stride(1) != 1
            or w_h.stride(0) < units):
        return (f"w_h must be a float32 [{3 * units},{units}] tensor with "
                f"unit column stride on {xg.device}, got {w_h.dtype} "
                f"{tuple(w_h.shape)} strides {w_h.stride()} on "
                f"{w_h.device}")
    return (state_problem(h0, xg.device, b, units)
            or lengths_problem(seq_len, xg.device, b))


class GruLibrary:
    """The lazily built ``csrc/gru.cu`` library (``vp_gru``).
    ``launches`` counts the wrapper calls that launched the kernel."""

    def __init__(self):
        self.build_log = ""
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def function(self):
        with self._lock:
            if self._lib is None:
                path, self.build_log = native.build_cuda_library(_SRC,
                                                                 "vp_gru")
                lib = ctypes.CDLL(path)
                lib.vp_gru.argtypes = ([ctypes.c_void_p] * 2
                                       + [ctypes.c_longlong]
                                       + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
                lib.vp_gru.restype = ctypes.c_int
                self._lib = lib
            return self._lib.vp_gru


LIBRARY = GruLibrary()


def gru_recurrence(xg: torch.Tensor, w_h: torch.Tensor,
                   h0: Optional[torch.Tensor], seq_len: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's recurrence on CUDA tensors (module docstring); raises on
    any input the kernel does not take."""
    why = unsupported(xg, w_h, h0, seq_len)
    if why is not None:
        raise ValueError(f"gru_recurrence: {why}")
    b, t, units = xg.shape[0], xg.shape[1], xg.shape[2] // 3
    lengths = seq_len.to(torch.int64).contiguous()
    out = torch.empty((b, t, units), dtype=torch.float32, device=xg.device)
    h_final = torch.empty((b, units), dtype=torch.float32, device=xg.device)
    fn = LIBRARY.function()
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w_h.data_ptr(), w_h.stride(0),
                 None if h0 is None else h0.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), h_final.data_ptr(), b, units, t, stream)
    if err != 0:
        raise RuntimeError(f"gru_recurrence launch failed: CUDA error {err}")
    LIBRARY.launches += 1
    return out, h_final


def gru_recurrence_plain(xg: torch.Tensor, w_h: torch.Tensor,
                         h0: Optional[torch.Tensor], seq_len: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_recurrence` in torch on any device and dtype: each step's
    gates from ``xg`` and the state, a row's state frozen and its output
    zero from its ``seq_len`` on."""
    b, t, three_u = xg.shape
    units = three_u // 3
    w_g, w_c = w_h[:2 * units], w_h[2 * units:]
    h = xg.new_zeros((b, units)) if h0 is None else h0
    outs = []
    for i in range(t):
        x = xg[:, i]
        r, u = torch.sigmoid(x[:, :2 * units] + h @ w_g.t()).chunk(2, -1)
        c = torch.tanh(x[:, 2 * units:] + (r * h) @ w_c.t())
        new = u * h + (1 - u) * c
        live = (i < seq_len)[:, None]
        outs.append(torch.where(live, new, torch.zeros_like(new)))
        h = torch.where(live, new, h)
    return torch.stack(outs, dim=1), h
