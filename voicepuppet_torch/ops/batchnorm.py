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

The float32 batch norm of a training step, forward and backward, is
:class:`TrainBatchNorm` (``train_bn(x, weight, bias, eps)``), batch
moments over a contiguous NCHW or channels_last CUDA tensor
(:func:`train_unsupported` says what it needs): ``csrc/norm.cu``'s
training passes, 8 float32 passes an element where eager makes ~45
(channels_last's forward is the passes above).  ``bn_train_plain``
restates their order in torch.  ``StatelessBatchNorm`` sends training
calls to the Function while ``TRAINING_PASSES`` is true.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from voicepuppet_torch.utils import native

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "norm.cu")
THREADS = 256          # a block, in every pass
MAX_GROUP = 2 ** 30    # rows of one moment group (32-bit indexing)
MAX_SLICES = 1024      # slices of a row group
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Whether ``StatelessBatchNorm`` sends the calls :class:`TrainBatchNorm`
# takes to it; false, they take the eager formula (counted as eager).
TRAINING_PASSES = True


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
    return _param_problem(x, weight, bias)


def _param_problem(x, weight, bias) -> Optional[str]:
    """Why ``weight`` and ``bias`` are not contiguous float32 [C] tensors
    on x's device, or None."""
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous()):
            return (f"{name} must be a contiguous float32 [{x.shape[1]}] "
                    f"tensor on {x.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return None


class NormLibrary:
    """The lazily built ``csrc/norm.cu`` library: ``function()`` is the
    served ``vp_bn``, ``function(name)`` the training passes'
    ``vp_bn_train_forward`` / ``vp_bn_train_backward``.  ``launches``
    counts the wrapper calls that launched passes."""

    _ARGS = {
        "vp_bn": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                  + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_void_p]),
        "vp_bn_train_forward": ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                                + [ctypes.c_longlong] * 3
                                + [ctypes.c_int, ctypes.c_float,
                                   ctypes.c_void_p]),
        "vp_bn_train_backward": ([ctypes.c_int] + [ctypes.c_void_p] * 9
                                 + [ctypes.c_int] + [ctypes.c_longlong] * 5
                                 + [ctypes.c_int] * 2
                                 + [ctypes.c_float, ctypes.c_void_p]),
    }

    def __init__(self):
        self.build_log = ""
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def function(self, name: str = "vp_bn"):
        with self._lock:
            if self._lib is None:
                path, self.build_log = native.build_cuda_library(_SRC,
                                                                 "vp_norm")
                lib = ctypes.CDLL(path)
                for fn_name, args in self._ARGS.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                self._lib = lib
            return getattr(self._lib, name)


LIBRARY = NormLibrary()


def stateless_bn_moments(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float, per_frame: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`stateless_bn`, also returning the moments it normalised
    with: (y, mean, mean2), the moments float32 [N,C,1,1] per frame,
    [1,C,1,1] per chunk."""
    y, moments = _served(x, weight, bias, eps, per_frame)
    return y, moments[..., 0], moments[..., 1]


def _served(x, weight, bias, eps, per_frame):
    """(y, moments float32 [N or 1, C, 1, 1, 2] of (mean, mean2)) from the
    served passes."""
    why = unsupported(x, weight, bias)
    if why is not None:
        raise ValueError(f"stateless_bn: {why}")
    n, c, h, w = x.shape
    pl = plan(x.shape, per_frame, x.element_size(), _aligned(x))
    shape = (n, c, 1, 1) if per_frame else (1, c, 1, 1)
    y = torch.empty_like(x)
    moments = torch.empty(shape + (2,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, moments
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
    return y, moments


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


def _combine(part: torch.Tensor) -> torch.Tensor:
    """Per (row group, channel) the sum of the slices' partials [groups,
    slices, C] in ``bn_finalize_rows``' order: q lane j over slices j,
    j + q lanes, ..., then the q lanes in order."""
    groups, slices, c = part.shape
    q_lanes = THREADS // min(32, _pow2_ceil(c))
    rounds = -(-slices // q_lanes)
    p = torch.nn.functional.pad(part, (0, 0, 0, rounds * q_lanes - slices))
    p = p.reshape(groups, rounds, q_lanes, c)
    acc = torch.zeros_like(p[:, 0])
    for k in range(rounds):
        acc = acc + p[:, k]
    return _in_order(acc, 1)


def _row_partials(u: torch.Tensor, v: torch.Tensor, pl: Plan):
    """The sums of ``u`` and of ``v`` (NCHW, any layout) a (row group,
    slice, channel) in ``bn_moments_rows``' order: each thread's running
    sums over its rows (r, r + row lanes, ...), the row lanes in order."""
    c = u.shape[1]
    row_lanes = THREADS // pl.lanes
    out = []
    for t in (u, v):
        g = t.permute(0, 2, 3, 1).reshape(pl.groups, pl.rows, c)
        g = torch.nn.functional.pad(g,
                                    (0, 0, 0, pl.slices * pl.slice - pl.rows))
        g = g.reshape(pl.groups, pl.slices, pl.slice // row_lanes,
                      row_lanes, c)
        s = torch.zeros_like(g[:, :, 0])
        for k in range(g.shape[2]):
            s = s + g[:, :, k]
        out.append(_in_order(s, 2))
    return out


def _row_sums(xf: torch.Tensor, pl: Plan):
    """The kernels' sums of x and x² a (row group, channel)."""
    return [_combine(p) for p in _row_partials(xf, xf * xf, pl)]


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


# ---- the float32 batch norm of a training step ----------------------------


class PlanesPlan(NamedTuple):
    """How the training passes cut a contiguous NCHW [N,C,H,W] tensor:
    each channel's N planes of ``pv`` vectors of ``vec`` floats (``total``
    vectors) in ``slices`` slices of ``slice`` vectors, one block each."""
    vec: int
    pv: int
    total: int
    slice: int
    slices: int


def planes_plan(shape, vec: int) -> PlanesPlan:
    """The cut of an NCHW tensor of ``shape`` in vectors of ``vec``: a
    block takes the served passes' 2,048-16,384 elements, in whole rounds
    of 256 vectors, and a channel at most ``MAX_SLICES`` blocks."""
    n, c, h, w = shape
    size = min(16384, max(2048, _pow2_floor(n * c * h * w // 4096)))
    total = n * h * w // vec
    per = max(-(-size // vec), -(-total // MAX_SLICES))
    per = -(-per // THREADS) * THREADS
    return PlanesPlan(vec, h * w // vec, total, per, -(-total // per))


def train_layout(x: torch.Tensor) -> Optional[str]:
    """``nchw`` or ``channels_last`` for a 4-D tensor contiguous in that
    layout, else None (an NCHW tensor of 1x1 planes is taken as NCHW)."""
    if x.dim() != 4:
        return None
    if x.is_contiguous():
        return "nchw"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return None


def train_unsupported(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> Optional[str]:
    """Why the training passes cannot take these inputs (batch moments
    assumed), or None when they can: a float32 CUDA tensor, contiguous
    NCHW or channels_last, fewer than 2^30 elements a channel, with
    float32 [C] parameters on its device."""
    if x.device.type != "cuda":
        return f"x must be a CUDA tensor, got {x.device}"
    return train_layout_problem(x, weight, bias)


def train_layout_problem(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> Optional[str]:
    """What the training passes need of the inputs besides a CUDA device:
    why they cannot take them, or None."""
    if x.dtype != torch.float32:
        return f"x must be float32, got {x.dtype}"
    if x.numel() == 0:
        return "x has no elements"
    if train_layout(x) is None:
        return (f"x must be a contiguous NCHW or channels_last 4-D tensor, "
                f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape[0] * x.shape[2] * x.shape[3] >= MAX_GROUP:
        return f"x {tuple(x.shape)} has 2^30 or more elements a channel"
    return _param_problem(x, weight, bias)


def _dy_strides(x: torch.Tensor, dy: torch.Tensor) -> Optional[tuple]:
    """The strides the backward reads ``dy`` at, in elements, or None when
    it cannot: for an NCHW ``x`` the frame and channel strides of a dy
    whose planes are contiguous (a channel slice of an NCHW ``cat``); for
    a channels_last ``x`` the row stride (and 0) of a dy whose pixels'
    channels are contiguous at one stride of C or more (a channel slice of
    a channels_last ``cat``).  A stride of a dimension of size 1 reads 0."""
    n, c, h, w = dy.shape
    s0, s1, s2, s3 = dy.stride()
    if train_layout(x) == "nchw":
        if not (dy.is_contiguous() or (s3 == 1 and s2 == w)):
            return None
        return (s0 if n > 1 else 0, s1 if c > 1 else 0)
    if dy.is_contiguous(memory_format=torch.channels_last):
        return (c, 0)
    if s1 == 1 and s3 >= c and s2 == w * s3 and s0 == h * s2:
        return (s3, 0)
    return None


def _train_vec(x: torch.Tensor, dy: Optional[torch.Tensor],
               strides=(0, 0)) -> int:
    """4 where the planes (NCHW) or the channels (channels_last), every
    stride and every pointer allow 16-byte loads, else 1."""
    n, c, h, w = x.shape
    width = h * w if train_layout(x) == "nchw" else c
    ok = width % 4 == 0 and _aligned(x) and all(s % 4 == 0 for s in strides)
    return 4 if ok and (dy is None or _aligned(dy)) else 1


def _readable(x: torch.Tensor, dy: torch.Tensor):
    """(dy as the backward reads it, its strides, the vector width): dy
    itself where :func:`_dy_strides` finds its form, else a copy in x's
    layout."""
    strides = _dy_strides(x, dy)
    if strides is None:
        dy = dy.contiguous(memory_format=torch.channels_last
                           if train_layout(x) == "channels_last"
                           else torch.contiguous_format)
        strides = _dy_strides(x, dy)
    return dy, strides, _train_vec(x, dy, strides)


def train_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward on the card: (y in x's layout, moments float32
    [C, 2] of (mean, mean2)).  channels_last takes the served passes, NCHW
    the planes passes."""
    why = train_unsupported(x, weight, bias)
    if why is not None:
        raise ValueError(f"train_forward: {why}")
    n, c, h, w = x.shape
    if train_layout(x) == "channels_last":
        y, moments = _served(x, weight, bias, eps, False)
        return y, moments.reshape(c, 2)
    pp = planes_plan(x.shape, _train_vec(x, None))
    y = torch.empty_like(x)
    moments = torch.empty((c, 2), dtype=torch.float32, device=x.device)
    part = torch.empty((c * pp.slices, 2), dtype=torch.float32,
                       device=x.device)
    fn = LIBRARY.function("vp_bn_train_forward")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), part.data_ptr(), moments.data_ptr(),
                 pp.vec, n, c, h * w, pp.slice, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"train_forward launch failed: CUDA error {err}")
    LIBRARY.launches += 1
    return y, moments


def train_backward(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                   moments: torch.Tensor, eps: float, need_dx: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                              torch.Tensor]:
    """The training backward on the card from the forward's ``moments``
    ([C, 2]): (dx in x's layout, or None without ``need_dx``; dw; db).  A
    dy the passes cannot read where it lies (:func:`_dy_strides`) is
    first copied into x's layout."""
    n, c, h, w = x.shape
    dy, strides, vec = _readable(x, dy)
    if train_layout(x) == "nchw":
        pp = planes_plan(x.shape, vec)
        layout, slice_, lanes, slices = 0, pp.slice, 0, pp.slices
    else:
        pl = plan(x.shape, False, 4, vec == 4)
        layout, slice_, lanes, slices = 1, pl.slice, pl.lanes, pl.slices
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    dw, db = torch.empty(c, **f32), torch.empty(c, **f32)
    coef = torch.empty((c, 4), **f32)
    part = torch.empty((c * slices, 2), **f32)
    fn = LIBRARY.function("vp_bn_train_backward")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(layout, x.data_ptr(), dy.data_ptr(),
                 dx.data_ptr() if need_dx else None, weight.data_ptr(),
                 moments.data_ptr(), part.data_ptr(), coef.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), vec, n, c, h * w, strides[0],
                 strides[1], slice_, lanes, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"train_backward launch failed: CUDA error {err}")
    LIBRARY.launches += 1
    return dx, dw, db


class TrainBatchNorm(torch.autograd.Function):
    """The batch norm of a training step with batch moments (0, 2, 3) on
    the card: ``apply(x, weight, bias, eps)``, the passes above
    (:func:`train_forward`, :func:`train_backward`: 8 float32 passes an
    element where eager makes ~45); raises on what they do not take
    (:func:`train_unsupported`).  Saves x, the parameters and the [C, 2]
    moments; no loss here takes a second derivative."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, moments = train_forward(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, moments)
        ctx.eps = eps
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, moments = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, db = train_backward(x, dy, weight, moments, ctx.eps, need[0])
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None)


def train_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The batch norm of a training step (:class:`TrainBatchNorm`)."""
    return TrainBatchNorm.apply(x, weight, bias, eps)


def _plane_partials(u: torch.Tensor, v: torch.Tensor, pp: PlanesPlan):
    """The sums of ``u`` and of ``v`` (NCHW, any layout) a (slice,
    channel), [1, slices, C], in ``bn_stats_planes``' order: each thread's
    running sums over its vectors (j, j + 256, ...), a lane of the vector
    apart, then the lanes in order; a warp's threads as a tree (lane i
    takes lane i + d, d = 16, 8, 4, 2, 1); the warps in order."""
    c = u.shape[1]
    out = []
    for t in (u, v):
        seq = t.transpose(0, 1).reshape(c, pp.total, pp.vec)
        seq = torch.nn.functional.pad(
            seq, (0, 0, 0, pp.slices * pp.slice - pp.total))
        seq = seq.reshape(c, pp.slices, pp.slice // THREADS, THREADS,
                          pp.vec)
        acc = torch.zeros_like(seq[:, :, 0])
        for k in range(seq.shape[2]):
            acc = acc + seq[:, :, k]
        lanes = _in_order(acc, 3).reshape(c, pp.slices, THREADS // 32, 32)
        for d in (16, 8, 4, 2, 1):
            lanes = lanes[..., :d] + lanes[..., d:2 * d]
        out.append(_in_order(lanes[..., 0], 2).t().unsqueeze(0))
    return out


def _train_sums(u, v, layout: str, vec: int):
    """Per channel the kernels' sums of ``u`` and ``v`` over a batch."""
    if layout == "channels_last":
        parts = _row_partials(u, v, plan(u.shape, False, 4, vec == 4))
    else:
        parts = _plane_partials(u, v, planes_plan(u.shape, vec))
    return [_combine(p)[0] for p in parts]


def bn_train_plain(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   dy: Optional[torch.Tensor] = None) -> dict:
    """The training passes' order of operations restated in torch, on
    ``x``'s device, in float32 (float64 for a float64 ``x``): ``y``,
    ``mean``, ``mean2`` ([C]); with ``dy``, also ``dx``, ``dw``, ``db``.
    The cut and the vector widths are the ones the passes take for these
    tensors (an x in neither layout is cut as its NCHW copy)."""
    if train_layout(x) is None:
        x = x.contiguous()
    layout = train_layout(x)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.detach().to(dt)
    n, c, h, w = x.shape
    per = lambda t: t.detach().to(dt).reshape(1, c, 1, 1)  # noqa: E731
    s, s2 = _train_sums(xf, xf * xf, layout, _train_vec(x, None))
    count = torch.full_like(s, float(n * h * w))
    mean, mean2 = s / count, s2 / count
    inv = torch.rsqrt((mean2 - mean * mean) + eps)
    xm = xf - per(mean)
    y = (xm * per(inv)) * per(weight) + per(bias)
    out = {"y": y, "mean": mean, "mean2": mean2}
    if dy is None:
        return out
    g = dy.detach().to(dt)
    sd, sdx = _train_sums(g, g * xm, layout, _readable(x, dy)[2])
    c1 = sd / count
    c2 = (inv * inv) * (sdx / count)
    a = weight.detach().to(dt) * inv
    out.update(dx=per(a) * ((g - per(c1)) - xm * per(c2)), dw=inv * sdx,
               db=sd)
    return out
