"""Building blocks with TF1-reference semantics, for inference and training.

Port of ``voicepuppet_tpu/models/layers.py``.
Submodules keep the flax scope names (``Conv_0``, ``TFBatchNorm_1``,
``InvertedResidual_3`` ...) so a state_dict key reads like the JAX
parameter path (``weights.py`` maps one onto the other).

Tensors are NCHW inside; TF ``'SAME'`` padding is applied explicitly with
``F.pad``, because it is asymmetric (more at the end) when the pad total
is odd — e.g. the stride-2 stem over 80 mel bins pads (1, 2) — and torch's
symmetric ``padding=`` cannot express that.  Max pools pad with ``-inf``,
as ``lax.reduce_window`` does.

Training mode is an explicit ``train`` argument, as in the JAX modules:
``TFBatchNorm`` then normalizes with the batch moments and updates its
running moments, and :func:`dropout` draws its mask from the caller's
``torch.Generator``.

Sync-BN: every batch-moment norm of the package (``TFBatchNorm`` here,
``StatelessBatchNorm`` in ``pixrefer.py``, ``StatelessCenterBN`` in
``vgnet.py``) is a :class:`SyncBN` with a ``group`` attribute, the JAX
modules' ``axis_name``.  Inside :func:`sync_bn` the moments combine over
the group's ranks, so a data-parallel step normalizes as one device on
the global batch does; outside it, or with a group of one rank, each
takes its own batch's moments by the code it always ran.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.ops import gru as gru_kernel
from voicepuppet_torch.parallel.mesh import AllReduceSum, spans_ranks
from voicepuppet_torch.utils import tracing


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA 'SAME' (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    ph = same_pads(x.shape[-2], kernel[0], stride[0])
    pw = same_pads(x.shape[-1], kernel[1], stride[1])
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SameConv2d(nn.Conv2d):
    """``nn.Conv(padding="SAME")``: explicit TF padding, then a valid
    conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), groups: int = 1,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        # the weight (float32) is cast to the input's dtype: a bfloat16
        # trunk computes in bfloat16 from float32 parameters
        return self._conv_forward(pad_same(x, self.kernel_size, self.stride),
                                  self.weight.to(x.dtype), None
                                  if self.bias is None
                                  else self.bias.to(x.dtype))


def conv_transpose_same_pads(kernel: int, stride: int) -> Tuple[int, int]:
    """``lax.conv_transpose(padding="SAME")``'s (before, after) padding of
    the stride-dilated input (flax ``ConvTranspose``): (2, 2) at k=4 s=2,
    (4, 3) at k=7 s=2, (2, 1) at k=3 s=2."""
    pad_len = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return before, pad_len - before


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(padding="SAME")``: output ``stride * n``.
    torch pads the dilated input by ``k - 1 - padding`` on both sides (and
    ``output_padding`` more after), so an uneven split such as k=7's (4, 3)
    has no ``padding``/``output_padding`` of its own: ``padding = k - 1 -
    before`` pads ``before`` on both sides and the extra ``before -
    after`` trailing rows and columns are cropped.  (``padding=3,
    output_padding=1`` has the right size at k=7 but pads (3, 4), one
    pixel off.)  The weight is the flipped flax kernel (``weights.py``);
    it and the bias are cast to the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 bias: bool = True):
        before, after = conv_transpose_same_pads(kernel, stride)
        if before < after:
            raise ValueError(f"k={kernel} s={stride}: 'SAME' pads "
                             f"({before}, {after}), not supported")
        super().__init__(in_ch, out_ch, kernel, stride,
                         padding=kernel - 1 - before, bias=bias)
        self.crop = before - after

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype),
                               None if self.bias is None
                               else self.bias.to(x.dtype), self.stride,
                               self.padding)
        if self.crop:
            y = y[..., :y.shape[-2] - self.crop, :y.shape[-1] - self.crop]
        return y


def max_pool_same(x: torch.Tensor, window: Tuple[int, int],
                  stride: Tuple[int, int]) -> torch.Tensor:
    """``tf.layers.max_pooling2d(padding='same')`` (-inf padding)."""
    x = pad_same(x, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def leaky_relu(x):
    """tf.nn.leaky_relu default alpha=0.2."""
    return F.leaky_relu(x, negative_slope=0.2)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.  The mask
    is drawn from ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def batch_moments(xf: torch.Tensor, group=None):
    """Per-channel (axis 1) mean and biased variance of a float32 tensor:
    flax's ``mean(x²) - mean²`` to rounding, taken by ``torch.var_mean``
    in one pass.  Its backward, ``2(x - mean)/N``, is well conditioned;
    the float32 backward of ``mean(x²) - mean²`` cancels two large terms,
    which left BFMNet's head gradients 7.8e-4 of a leaf's max |g| off
    JAX's, against 7.7e-6 this way (tests/test_torch_train_bfmnet.py).

    Over a ``group`` of several ranks the moments are those of all the
    ranks' rows together, kept free of that cancellation: the global mean
    first (an :class:`AllReduceSum` of the sums and the counts), then an
    all-reduce of ``Σ (x - mean)²``.  The partial sums accumulate in
    float64: float32 sums are less exact than ``var_mean``, and the head
    gradients behind BFMNet's 57 train-mode BNs moved by 7.8e-4 of a
    leaf's max with them, against 2.5e-6 this way (one process, measured on
    the CPU).  Four collectives per call, two in the forward and two in the
    backward, so every rank must call it in the same order."""
    red = (0,) + tuple(range(2, xf.dim()))
    if not spans_ranks(group):
        var, mean = torch.var_mean(xf, dim=red, correction=0)
        return mean, var
    f64 = torch.float64
    count = torch.full((1,), float(xf.numel() // xf.shape[1]), dtype=f64,
                       device=xf.device)
    sums = AllReduceSum.apply(torch.cat([xf.sum(dim=red, dtype=f64),
                                         count]), group)
    n = sums[-1].detach()
    mean = (sums[:-1] / n).float()
    d = xf - mean.view((1, -1) + (1,) * (xf.dim() - 2))
    var = AllReduceSum.apply(torch.sum(d * d, dim=red, dtype=f64),
                             group) / n
    return mean, var.float()


class SyncBN(nn.Module):
    """A batch-moment norm whose moments combine over ``group``'s ranks
    (None: this process's batch alone); see :func:`sync_bn`."""
    group = None


@contextlib.contextmanager
def sync_bn(group, *modules: nn.Module):
    """Within the block every :class:`SyncBN` under ``modules`` takes its
    moments over ``group`` (the data-parallel step's forwards); after it,
    each takes its own batch's again (evaluation and inference, as the
    JAX trainers' ``axis_name=None`` twins).  With ``group`` None it
    changes nothing."""
    bns = [m for mod in modules for m in mod.modules()
           if isinstance(m, SyncBN)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


class TFBatchNorm(SyncBN):
    """tf.contrib.layers.batch_norm: eps 1e-3, offset only (no scale),
    normalizing in float32 over the channel axis 1.

    At inference it uses the running moments.  With ``train`` it uses the
    batch moments of :func:`batch_moments` and moves the running moments
    by ``ra <- 0.999 ra + 0.001 batch`` (flax's momentum; ``F.batch_norm``
    would store the unbiased variance, with one minus this momentum)."""

    # the flax module nests its variables one scope deeper
    # (``weights.state_key_for`` folds it)
    flax_scope = "BatchNorm_0"

    def __init__(self, ch: int, epsilon: float = 1e-3,
                 momentum: float = 0.999):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if train:
            mean, var = batch_moments(xf, self.group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((xf - mean.view(shape)) * torch.rsqrt(var.view(shape)
                                                   + self.epsilon)
             + self.bias.view(shape))
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """conv -> BN -> activation (ref: tinynet.py:12-27)."""

    def __init__(self, in_ch: int, features: int, kernel, stride,
                 activation: Callable = F.relu):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, kernel, stride)
        self.TFBatchNorm_0 = TFBatchNorm(features)
        self.activation = activation

    def forward(self, x, train: bool = False):
        return self.activation(self.TFBatchNorm_0(self.Conv_0(x), train))


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual (ref: tinynet.py:120-142): 1x1
    expansion -> depthwise [7,3] -> 1x1 projection, with a 1x1+BN
    shortcut when the channel count changes (stride is always 1 here)."""

    def __init__(self, in_ch: int, features: int, expansion: int = 6,
                 dw_kernel: Tuple[int, int] = (7, 3),
                 activation: Callable = F.relu6):
        super().__init__()
        ch = in_ch * expansion
        self.activation = activation
        self.Conv_0 = SameConv2d(in_ch, ch, (1, 1))
        self.TFBatchNorm_0 = TFBatchNorm(ch)
        self.Conv_1 = SameConv2d(ch, ch, dw_kernel, groups=ch)
        self.TFBatchNorm_1 = TFBatchNorm(ch)
        self.Conv_2 = SameConv2d(ch, features, (1, 1))
        self.TFBatchNorm_2 = TFBatchNorm(features)
        if features != in_ch:
            self.Conv_3 = SameConv2d(in_ch, features, (1, 1))
            self.TFBatchNorm_3 = TFBatchNorm(features)

    def forward(self, x, time_mask: Optional[torch.Tensor] = None,
                train: bool = False):
        inputs = x
        act = self.activation
        x = act(self.TFBatchNorm_0(self.Conv_0(x), train))
        if time_mask is not None:
            # re-zero the padded time rows before the depthwise conv, whose
            # temporal extent would otherwise read them (layers.py:112-116)
            x = torch.where(time_mask, x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        x = act(self.TFBatchNorm_1(self.Conv_1(x), train))
        x = self.TFBatchNorm_2(self.Conv_2(x), train)
        if hasattr(self, "Conv_3"):
            inputs = self.TFBatchNorm_3(self.Conv_3(inputs), train)
        return x + inputs


class MfccNet(nn.Module):
    """Audio backbone over mel images (ref: tinynet.py:154-215).

    Input ``[B, 1, T*5, 80]`` (NCHW); frequency is downsampled x64, time is
    kept.  ``valid_rows`` [B] re-zeroes activations past each row's length
    after every stage (and pools see ``-inf`` there), so a time-padded run
    equals the exact-length run on the valid rows.  ``dtype`` is the
    compute dtype of the whole stack (JAX ``MfccNet.dtype``): parameters
    and BN moments stay float32, the output is float32.

    ``activation`` is the blocks' activation: relu6 for BFMNet, elu with
    :data:`MOBILENET_WIDTHS` for ATNet.  The stem and head conv use plain
    relu when it is relu6 (bfmnet/tinynet.py:26) and the activation itself
    otherwise (atvgnet/tinynet.py:26; JAX ``layers.py:192-196``)."""

    # (widths index, expansion) of blocks block1_0 .. block7_0, and the
    # blocks a [2,2]/[1,2] max pool follows (layers.py:207-227)
    _BLOCKS = ((1, 1), (2, 6), (2, 6), (3, 6), (3, 6), (3, 6), (4, 6),
               (4, 6), (4, 6), (4, 6), (5, 6), (5, 6), (5, 6), (6, 6),
               (6, 6), (6, 6), (7, 6))
    _POOL_AFTER = (1, 3, 6, 13)

    def __init__(self, output_channels: int = 256, width_mult: float = 1.0,
                 widths: Tuple[int, ...] = (32, 64, 64, 128, 192, 256, 256,
                                            256),
                 dtype: torch.dtype = torch.float32,
                 activation: Callable = F.relu6):
        super().__init__()
        self.dtype = dtype
        stem_act = F.relu if activation is F.relu6 else activation
        w = lambda f: max(8, int(f * width_mult))
        ch = w(widths[0])
        self.ConvBN_0 = ConvBN(1, ch, (9, 5), (1, 2), stem_act)
        for i, (wi, e) in enumerate(self._BLOCKS):
            out = w(widths[wi])
            self.add_module(f"InvertedResidual_{i}",
                            InvertedResidual(ch, out, e,
                                             activation=activation))
            ch = out
        self.ConvBN_1 = ConvBN(ch, output_channels, (1, 1), (1, 1),
                               stem_act)

    def forward(self, x, valid_rows: Optional[torch.Tensor] = None,
                train: bool = False):
        x = x.to(self.dtype)
        if valid_rows is None:
            tmask = None
            m0 = lambda v: v
            neg = lambda v: v
        else:
            rows = torch.arange(x.shape[2], device=x.device)
            tmask = (rows[None, :] < valid_rows[:, None])[:, None, :, None]
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            ninf = torch.full((), -math.inf, dtype=x.dtype, device=x.device)
            m0 = lambda v: torch.where(tmask, v, zero)
            neg = lambda v: torch.where(tmask, v, ninf)
        x = m0(x)
        x = m0(self.ConvBN_0(x, train))
        for i in range(len(self._BLOCKS)):
            x = m0(getattr(self, f"InvertedResidual_{i}")(x, tmask, train))
            if i in self._POOL_AFTER:
                x = m0(max_pool_same(neg(x), (2, 2), (1, 2)))
        return m0(self.ConvBN_1(x, train)).float()


# the atvgnet width schedule (true MobileNetV2; atvgnet/tinynet.py:172-204)
MOBILENET_WIDTHS = (32, 16, 24, 32, 64, 96, 160, 320)


class ThinNet(nn.Module):
    """Image backbone with MobileNetV2 widths (ref: atvgnet/tinynet.py:
    218-275; JAX ``layers.py:238-273``): a 3x3 stem at ``stem_stride``
    (VGNet passes (1, 1)), 17 inverted residuals, a 1x1 head conv; the
    stem and head use plain relu only when ``activation`` is relu6."""

    # (widths index, expansion) of the 17 blocks (layers.py:264-269)
    _BLOCKS = ((1, 1),) + tuple((wi, 6) for wi, reps in (
        (2, 2), (3, 3), (4, 4), (5, 3), (6, 3)) for _ in range(reps)) + (
            (7, 6),)

    def __init__(self, in_ch: int, output_channels: int = 256,
                 activation: Callable = F.elu, width_mult: float = 1.0,
                 stem_stride: Tuple[int, int] = (2, 2),
                 widths: Tuple[int, ...] = MOBILENET_WIDTHS):
        super().__init__()
        stem_act = F.relu if activation is F.relu6 else activation
        w = lambda f: max(8, int(f * width_mult))
        ch = w(widths[0])
        self.ConvBN_0 = ConvBN(in_ch, ch, (3, 3), stem_stride, stem_act)
        for i, (wi, e) in enumerate(self._BLOCKS):
            out = w(widths[wi])
            self.add_module(f"InvertedResidual_{i}",
                            InvertedResidual(ch, out, e,
                                             activation=activation))
            ch = out
        self.ConvBN_1 = ConvBN(ch, output_channels, (1, 1), (1, 1),
                               stem_act)

    def forward(self, x, train: bool = False):
        x = self.ConvBN_0(x, train)
        for i in range(len(self._BLOCKS)):
            x = getattr(self, f"InvertedResidual_{i}")(x, None, train)
        return self.ConvBN_1(x, train)


class TFGRUCell(nn.Module):
    """tf.contrib.rnn.GRUCell math (ref: bfmnet.py:53):
    ``r, u = sigmoid([x, h] W_g + b_g)``, ``c = tanh([x, r*h] W_c + b_c)``,
    ``h' = u*h + (1-u)*c``."""

    def __init__(self, in_dim: int, num_units: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim + num_units, 2 * num_units)
        self.Dense_1 = nn.Linear(in_dim + num_units, num_units)

    def forward(self, h, x):
        gates = torch.sigmoid(self.Dense_0(torch.cat([x, h], dim=-1)))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(self.Dense_1(torch.cat([x, r * h], dim=-1)))
        return u * h + (1 - u) * c


class MaskedGRU(nn.Module):
    """``tf.nn.dynamic_rnn(sequence_length=...)`` output semantics over a
    TFGRUCell stack (ref: bfmnet.py:44-69): run over time, zero the
    outputs past each row's length (JAX ``masked_gru`` at inference).

    ``initial_state`` (one [B, units] tensor per layer) and
    ``return_state`` carry the recurrence across chunks, exactly: the
    returned finals are dynamic_rnn's frozen carry, the pre-mask output at
    t = seq_len-1 (the GRU output is its state), or the initial state for
    an empty row (JAX ``layers.py:305-355``).  With ``train`` each layer's
    masked outputs go through dropout at ``drop_rate``
    (tf.contrib.rnn.DropoutWrapper(output_keep_prob=1-drop_rate)).

    A CUDA call that is not training and wants no autograd graph (the
    serving paths' inference mode), in float32 with units a multiple of 32
    up to 256, runs each layer as one matrix product of the input half of
    its gates over all steps and ``ops/gru.py``'s kernel for the
    recurrence, which stops at each row's ``seq_len`` (counted as
    ``vp.gru.fused``, the steps it ran); every other call runs the step
    loop below, a CUDA one counted as ``vp.gru.eager`` (B x T steps a
    layer)."""

    def __init__(self, in_dim: int, num_units: int, num_layers: int = 1,
                 drop_rate: float = 0.0):
        super().__init__()
        self.num_units = num_units
        self.num_layers = num_layers
        self.drop_rate = drop_rate
        for layer in range(num_layers):
            self.add_module(f"ScanTFGRUCell_{layer}", TFGRUCell(
                in_dim if layer == 0 else num_units, num_units))

    def forward(self, inputs, seq_len, initial_state=None,
                return_state: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, t, _ = inputs.shape
        if inputs.is_cuda:
            if self._fused(inputs, seq_len, initial_state, train):
                return self._fused_forward(inputs, seq_len, initial_state,
                                           return_state)
            tracing.count("vp.gru.eager", b * t * self.num_layers)
        x = inputs
        mask = (torch.arange(t, device=x.device)[None, :]
                < seq_len[:, None])[..., None]
        finals = []
        for layer in range(self.num_layers):
            cell = getattr(self, f"ScanTFGRUCell_{layer}")
            h0 = (x.new_zeros((b, self.num_units)) if initial_state is None
                  else initial_state[layer])
            h = h0
            outs = []
            for i in range(t):
                h = cell(h, x[:, i])
                outs.append(h)
            out = torch.stack(outs, dim=1)
            if return_state:
                at_len = torch.clamp(seq_len.long() - 1, 0, t - 1)
                last = out[torch.arange(b, device=x.device), at_len]
                finals.append(torch.where((seq_len > 0)[:, None], last, h0))
            x = out * mask
            if train:
                x = dropout(x, self.drop_rate, generator)
        if return_state:
            return x, finals
        return x

    def _fused(self, inputs, seq_len, initial_state, train: bool) -> bool:
        """Whether ``ops/gru.py``'s kernel takes this call: not training,
        no autograd graph wanted, float32 inputs and parameters on one
        device, and units, lengths and initial states it takes."""
        if (train or torch.is_grad_enabled()
                or inputs.dtype != torch.float32 or 0 in inputs.shape):
            return False
        dev, b = inputs.device, inputs.shape[0]
        states = (initial_state if initial_state is not None
                  else [None] * self.num_layers)
        return (all(p.dtype == torch.float32 and p.device == dev
                    for p in self.parameters())
                and gru_kernel.units_problem(self.num_units) is None
                and gru_kernel.lengths_problem(seq_len, dev, b) is None
                and all(gru_kernel.state_problem(h, dev, b, self.num_units)
                        is None for h in states))

    def _fused_forward(self, inputs, seq_len, initial_state,
                       return_state: bool,
                       recurrence: Optional[Callable] = None):
        """Each layer: ``xg = x W_x^T + b`` over all steps in one matrix
        product, then the kernel's recurrence (``Dense_0``'s and
        ``Dense_1``'s weights stacked: rows r, u, c; columns x, then h).
        ``recurrence``: the kernel (None), or ``ops/gru.py``'s
        ``gru_recurrence_plain``, its torch version."""
        recurrence = recurrence or gru_kernel.gru_recurrence
        b, t, _ = inputs.shape
        if tracing.counting():
            tracing.count("vp.gru.fused", torch.clamp(seq_len, 0, t).sum()
                          * self.num_layers)
        x = inputs
        finals = []
        for layer in range(self.num_layers):
            cell = getattr(self, f"ScanTFGRUCell_{layer}")
            w = torch.cat([cell.Dense_0.weight, cell.Dense_1.weight])
            bias = torch.cat([cell.Dense_0.bias, cell.Dense_1.bias])
            d = x.shape[-1]
            xg = torch.addmm(bias, x.reshape(b * t, d), w[:, :d].t())
            x, h = recurrence(
                xg.view(b, t, -1), w[:, d:],
                None if initial_state is None else initial_state[layer],
                seq_len)
            finals.append(h)
        if return_state:
            return x, finals
        return x


def l2_regularization(module: nn.Module, scale: float = 1e-4
                      ) -> torch.Tensor:
    """``tf.contrib.layers.l2_regularizer``: ``scale * sum(w**2) / 2`` over
    the conv and depthwise kernels only (ref: tinynet.py:10; JAX
    ``layers.py:363-383``): the 4-D weights.  Dense and GRU kernels carry
    no regularizer."""
    leaves = [p for name, p in module.named_parameters()
              if name.endswith("weight") and p.dim() == 4]
    if not leaves:
        return torch.zeros((), device=next(module.parameters()).device)
    return scale * 0.5 * sum(torch.sum(torch.square(w)) for w in leaves)


@contextlib.contextmanager
def one_cpu_thread():
    """Within the block torch's CPU ops use one thread (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def orthogonal_(w: torch.Tensor, generator: torch.Generator):
    """flax ``orthogonal()`` on a kernel flattened to [fan_in, out], stored
    ``[out, ...]`` as torch keeps it.  The QR runs on one CPU thread: the
    blocked LAPACK QR rounds differently with the thread count, which gave
    processes with other thread counts (a spawned rank, a test worker)
    other weights from one seed."""
    cols = w.shape[0]
    rows = w[0].numel()
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    with one_cpu_thread():
        q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    w.copy_(q.T.reshape(w.shape))


def init_flax_like_(model: nn.Module, generator: torch.Generator,
                    orthogonal: Callable[[str], bool] = lambda name: False
                    ) -> nn.Module:
    """Fresh weights drawn as a flax init draws them (its distributions,
    not its bits): conv and dense kernels xavier-uniform, or orthogonal
    where ``orthogonal(name)`` holds; GRU cells orthogonal with gate bias
    1.0; other biases and BN offsets zero; BN moments (0, 1)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            gru = "ScanTFGRUCell_" in name
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                if gru or orthogonal(name):
                    orthogonal_(w, generator)
                else:
                    fan_out = w.shape[0] * w[0, 0].numel()
                    fan_in = w[0].numel()
                    a = math.sqrt(6.0 / (fan_in + fan_out))
                    w.uniform_(-a, a, generator=generator)
                if mod.bias is not None:
                    mod.bias.fill_(1.0 if gru and name.endswith("Dense_0")
                                   else 0.0)
            elif isinstance(mod, TFBatchNorm):
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model
