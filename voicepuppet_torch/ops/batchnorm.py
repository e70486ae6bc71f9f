"""The served generators' batch norm as hand-written CUDA kernels.

``stateless_bn(x, weight, bias, eps, per_frame)`` is
``models.pixrefer.StatelessBatchNorm``'s forward on a CUDA tensor: the
moments of each channel (``per_frame``: of each frame's channel, moment
axes (2, 3); else over the whole batch, (0, 2, 3)) in float32, then
``((x - mean) * inv) * weight + bias`` cast back to ``x``'s dtype.  It runs
``csrc/norm.cu`` (a moments pass, a short pass that combines them and a
normalise pass: x read twice and y written once), built with nvcc into
``build/`` at the first call, never at import, and loaded with ``ctypes``.
It takes a bf16 or float32 channels_last CUDA tensor (the served
generators' layout: their NHWC inputs are permuted views, and cuDNN keeps
that layout through the convs), with float32 [C] parameters on its device,
and raises on anything else (:func:`unsupported` says why);
``StatelessBatchNorm.forward`` sends it what it takes when no autograd
graph is wanted, and everything else to its eager formula.

``moments_plain`` restates the kernels' order of float32 operations in
torch (the plain version, on any device): the card's moments equal it bit
for bit, and the CPU tests hold it against float64.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from voicepuppet_torch.utils import native

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "norm.cu")
THREADS = 256          # a block, in every pass
MAX_GROUP = 2 ** 30    # rows of one moment group (32-bit indexing)
MAX_SLICES = 1024      # slices of a row group
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How the kernels cut a channels_last [N,C,H,W] tensor, in memory
    [N*H*W rows, C]: ``groups`` row groups (N per frame, 1 per chunk) of
    ``rows`` pixel rows, each cut into ``slices`` slices of ``slice`` rows;
    a block is ``lanes`` column lanes by 256 / lanes row lanes over a slice
    and one of ``tiles`` tiles of columns.  Each thread loads ``vec``
    channels at a time; the moments pass writes ``partials`` float2
    sums."""
    groups: int
    rows: int
    slice: int
    slices: int
    lanes: int
    tiles: int
    vec: int
    partials: int


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def plan(shape, per_frame: bool, itemsize: int, aligned: bool) -> Plan:
    """The cut of a tensor of ``shape``.  A block takes 2,048-16,384
    elements, more as the tensor grows (about 4,096 blocks' worth at most
    sizes, so the grid fills the 132 SMs many times), and a group at most
    ``MAX_SLICES`` slices, so their partials combine in one short pass.
    16-byte loads where the pointer is 16-byte aligned and the channels a
    whole number of them."""
    n, c, h, w = shape
    p = h * w
    wide = 16 // itemsize
    size = min(16384, max(2048, _pow2_floor(n * c * p // 4096)))
    vec = wide if aligned and c % wide == 0 else 1
    cvecs = c // vec
    lanes = min(THREADS, _pow2_ceil(cvecs))
    row_lanes = THREADS // lanes
    groups, rows = (n, p) if per_frame else (1, n * p)
    rows_a_slice = max(-(-size // (lanes * vec)), -(-rows // MAX_SLICES))
    rows_a_slice = -(-rows_a_slice // row_lanes) * row_lanes
    slices = -(-rows // rows_a_slice)
    return Plan(groups, rows, rows_a_slice, slices, lanes,
                -(-cvecs // lanes), vec, groups * slices * c)


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0


def unsupported(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot take these inputs, or None when they can."""
    if x.device.type != "cuda":
        return f"x must be a CUDA tensor, got {x.device}"
    return layout_problem(x, weight, bias)


def layout_problem(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> Optional[str]:
    """What the kernels need of the inputs besides a CUDA device: why they
    cannot take them, or None."""
    if x.dtype not in _DTYPES:
        return f"x must be bfloat16 or float32, got {x.dtype}"
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        return (f"x must be a channels_last 4-D tensor, got shape "
                f"{tuple(x.shape)} strides {x.stride()}")
    if x.shape[0] * x.shape[2] * x.shape[3] >= MAX_GROUP:
        return f"x {tuple(x.shape)} has a moment group of 2^30 or more"
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous()):
            return (f"{name} must be a contiguous float32 [{x.shape[1]}] "
                    f"tensor on {x.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return None


class NormLibrary:
    """The lazily built ``csrc/norm.cu`` library (``vp_bn``).
    ``launches`` counts the wrapper calls that launched its passes."""

    def __init__(self):
        self.build_log = ""
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def function(self):
        with self._lock:
            if self._lib is None:
                path, self.build_log = native.build_cuda_library(_SRC,
                                                                 "vp_norm")
                lib = ctypes.CDLL(path)
                lib.vp_bn.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 2
                                      + [ctypes.c_longlong] * 3
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_float, ctypes.c_void_p])
                lib.vp_bn.restype = ctypes.c_int
                self._lib = lib
            return self._lib.vp_bn


LIBRARY = NormLibrary()


def stateless_bn_moments(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float, per_frame: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`stateless_bn`, also returning the moments it normalised
    with: (y, mean, mean2), the moments float32 [N,C,1,1] per frame,
    [1,C,1,1] per chunk."""
    why = unsupported(x, weight, bias)
    if why is not None:
        raise ValueError(f"stateless_bn: {why}")
    n, c, h, w = x.shape
    pl = plan(x.shape, per_frame, x.element_size(), _aligned(x))
    shape = (n, c, 1, 1) if per_frame else (1, c, 1, 1)
    y = torch.empty_like(x)
    moments = torch.empty(shape + (2,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, moments[..., 0], moments[..., 1]
    part = torch.empty((pl.partials, 2), dtype=torch.float32,
                       device=x.device)
    fn = LIBRARY.function()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), part.data_ptr(), moments.data_ptr(),
                 _DTYPES[x.dtype], pl.vec, n, c, h * w, int(per_frame),
                 pl.slice, pl.lanes, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"stateless_bn launch failed: CUDA error {err}")
    LIBRARY.launches += 1
    return y, moments[..., 0], moments[..., 1]


def stateless_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float, per_frame: bool) -> torch.Tensor:
    """The batch norm of a bf16 or float32 channels_last CUDA tensor
    (module docstring); raises on any other input."""
    return stateless_bn_moments(x, weight, bias, eps, per_frame)[0]


def _in_order(v: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim``, first to last."""
    parts = v.unbind(dim)
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total


def _row_sums(xf: torch.Tensor, pl: Plan):
    """Each thread's running sums over its rows (r, r + row lanes, ...),
    the row lanes in order, then per channel the slices' partials (q lane
    j from slices j, j + q lanes, ...), the q lanes in order."""
    c = xf.shape[1]
    row_lanes = THREADS // pl.lanes
    g = xf.permute(0, 2, 3, 1).reshape(pl.groups, pl.rows, c)
    g = torch.nn.functional.pad(g, (0, 0, 0, pl.slices * pl.slice - pl.rows))
    g = g.reshape(pl.groups, pl.slices, pl.slice // row_lanes, row_lanes, c)
    s = torch.zeros(pl.groups, pl.slices, row_lanes, c, device=xf.device)
    s2 = torch.zeros_like(s)
    for k in range(g.shape[2]):
        v = g[:, :, k]
        s = s + v
        s2 = s2 + v * v
    q_lanes = THREADS // min(32, _pow2_ceil(c))
    rounds = -(-pl.slices // q_lanes)
    sums = []
    for t in (s, s2):
        p = torch.nn.functional.pad(_in_order(t, 2),
                                    (0, 0, 0, rounds * q_lanes - pl.slices))
        p = p.reshape(pl.groups, rounds, q_lanes, c)
        acc = torch.zeros(pl.groups, q_lanes, c, device=xf.device)
        for k in range(rounds):
            acc = acc + p[:, k]
        sums.append(_in_order(acc, 1))
    return sums


def moments_plain(x: torch.Tensor, per_frame: bool,
                  aligned: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' moments (mean, mean2), float32 [N,C,1,1] per frame or
    [1,C,1,1] per chunk, in their order of float32 operations (the sums
    over the row count), on ``x``'s device, in any layout.  ``aligned``:
    whether the kernels would take 16-byte loads (default: ``x``'s own
    pointer)."""
    n, c = x.shape[:2]
    pl = plan(x.shape, per_frame, x.element_size(),
              _aligned(x) if aligned is None else aligned)
    sums = _row_sums(x.float(), pl)
    count = torch.full_like(sums[0], float(pl.rows))
    shape = (n, c, 1, 1) if per_frame else (1, c, 1, 1)
    return tuple((t / count).reshape(shape) for t in sums)
