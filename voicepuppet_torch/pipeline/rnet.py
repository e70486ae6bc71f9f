"""The Deep3DFace R-Net identity path: face photo -> 257 coefficients.

Port of ``voicepuppet_tpu/pipeline/rnet.py``.  :class:`RNet` is slim
``resnet_v1_50`` (conv1 7x7/2 + a 3x3/2 max pool + bottleneck stages
[3, 4, 6, 3], the stride on each stage's last unit, BN with moving
statistics) with a 257-wide 1x1 head after global pooling: the network
the reference's ``FaceReconModel.pb`` freezes.  Its weights load from a
slim-named npz dump or straight from the frozen GraphDef
(``tools/tf_bundle.read_graphdef_consts``), through the name rows of
:func:`_rnet_name_rows` and ``weights.state_key_for``.

Layout: the input is [B, 224, 224, 3] float32 BGR in 0..255 (what the
reference feeds the frozen graph), permuted once to NCHW.  Stride-2 convs
pad k-1 in total, origin-biased, then run VALID (slim ``conv2d_same``);
stride-1 convs pad TF 'SAME'.  The max pool is TF 'SAME', which at
112 -> 56 pads 0 before and 1 after with -inf (``nn.MaxPool2d(padding=1)``
would pad both sides and change the first row and column).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.models.layers import max_pool_same, pad_same
from voicepuppet_torch.tools import tf_checkpoint as tfc


class SlimBatchNorm(nn.Module):
    """slim batch_norm at inference: moving statistics, scale and centre,
    eps 1e-5 (resnet_arg_scope)."""

    def __init__(self, ch: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        view = lambda t: t.view(1, -1, 1, 1)
        inv = torch.rsqrt(view(self.running_var) + self.epsilon)
        return ((x - view(self.running_mean)) * inv * view(self.weight)
                + view(self.bias))


class ConvBN(nn.Module):
    """slim conv2d under resnet_arg_scope: no bias, BN, optional relu."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = kernel, stride, relu
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, bias=False)
        self.bn = SlimBatchNorm(features)

    def forward(self, x):
        k, s = self.kernel, self.stride
        if s > 1:
            beg = (k - 1) // 2
            x = F.pad(x, (beg, k - 1 - beg, beg, k - 1 - beg))
        else:
            x = pad_same(x, (k, k), (1, 1))
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class BottleneckV1(nn.Module):
    """slim bottleneck_v1: 1x1 -> 3x3 (stride) -> 1x1, plus a shortcut: a
    1x1 projection where the depth changes, else the input subsampled by
    the stride."""

    def __init__(self, in_ch: int, depth: int, depth_bottleneck: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        if in_ch != depth:
            self.shortcut = ConvBN(in_ch, depth, 1, stride, relu=False)
        self.conv1 = ConvBN(in_ch, depth_bottleneck, 1)
        self.conv2 = ConvBN(depth_bottleneck, depth_bottleneck, 3, stride)
        self.conv3 = ConvBN(depth_bottleneck, depth, 1, relu=False)

    def forward(self, x):
        if hasattr(self, "shortcut"):
            shortcut = self.shortcut(x)
        elif self.stride > 1:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = x
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + shortcut)


# resnet_v1_50: (depth, depth_bottleneck, units, stride of the last unit)
_BLOCKS = ((256, 64, 3, 2), (512, 128, 4, 2), (1024, 256, 6, 2),
           (2048, 512, 3, 1))


class RNet(nn.Module):
    """resnet_v1_50 trunk + 257-wide head.  [B, 224, 224, 3] float32 BGR
    0..255 (NHWC) -> [B, 257]."""

    def __init__(self, num_coeff: int = 257):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, 2)
        ch = 64
        for b, (depth, bott, units, last_stride) in enumerate(_BLOCKS,
                                                              start=1):
            for u in range(1, units + 1):
                stride = last_stride if u == units else 1
                self.add_module(f"block{b}_unit_{u}",
                                BottleneckV1(ch, depth, bott, stride))
                ch = depth
        self.logits = nn.Conv2d(ch, num_coeff, 1)

    def forward(self, x):
        x = self.conv1(x.permute(0, 3, 1, 2))
        x = max_pool_same(x, (3, 3), (2, 2))
        for b, (_, _, units, _) in enumerate(_BLOCKS, start=1):
            for u in range(1, units + 1):
                x = getattr(self, f"block{b}_unit_{u}")(x)
        x = x.mean(dim=(2, 3), keepdim=True)
        return self.logits(x)[:, :, 0, 0]


def _rnet_name_rows() -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(tf_name, collection, flax_path) rows of the slim checkpoint."""
    rows: List = []

    def convbn(tf_scope: str, flax: Tuple[str, ...]):
        rows.append((f"{tf_scope}/weights", "params",
                     flax + ("conv", "kernel")))
        bn = f"{tf_scope}/BatchNorm"
        rows.append((f"{bn}/gamma", "params", flax + ("bn", "scale")))
        rows.append((f"{bn}/beta", "params", flax + ("bn", "bias")))
        rows.append((f"{bn}/moving_mean", "batch_stats",
                     flax + ("bn", "mean")))
        rows.append((f"{bn}/moving_variance", "batch_stats",
                     flax + ("bn", "var")))

    r = "resnet_v1_50"
    convbn(f"{r}/conv1", ("conv1",))
    for b, (_depth, _bott, units, _ls) in enumerate(_BLOCKS, start=1):
        for u in range(1, units + 1):
            tf_u = f"{r}/block{b}/unit_{u}/bottleneck_v1"
            fx = (f"block{b}_unit_{u}",)
            if u == 1:      # the projection shortcut of each first unit
                convbn(f"{tf_u}/shortcut", fx + ("shortcut",))
            for c in ("conv1", "conv2", "conv3"):
                convbn(f"{tf_u}/{c}", fx + (c,))
    rows.append((f"{r}/logits/weights", "params", ("logits", "kernel")))
    rows.append((f"{r}/logits/biases", "params", ("logits", "bias")))
    return rows


def _rows() -> List[tfc.Row]:
    return [row + (None,) for row in _rnet_name_rows()]


def load_rnet_arrays(available: Mapping[str, np.ndarray], target):
    """Slim-named arrays -> ``(state, loaded, missing)`` for ``target`` (an
    RNet or its state_dict)."""
    return tfc.load_arrays(available, target, _rows())


def load_rnet_npz(path: str, target):
    return load_rnet_arrays(tfc.read_npz(path), target)


def read_rnet_graphdef(path: str) -> Dict[str, np.ndarray]:
    """The ``resnet_v1_50`` Const tensors of a frozen GraphDef."""
    from voicepuppet_torch.tools.tf_bundle import read_graphdef_consts
    return read_graphdef_consts(path, name_filter=r"resnet_v1_50")


def load_rnet_graphdef(path: str, target):
    """``FaceReconModel.pb`` -> ``(state, loaded, missing)``, read with no
    TensorFlow."""
    return load_rnet_arrays(read_rnet_graphdef(path), target)


def export_rnet_arrays(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """An RNet state_dict -> its slim-named arrays (TF layouts)."""
    return tfc.export_arrays(state, _rows())


def init_rnet_(model: RNet, generator: torch.Generator,
               calibration: Optional[torch.Tensor] = None,
               head_gain: float = 0.1) -> RNet:
    """Seeded weights: He-normal convs, BN scale 1 and offset 0, and the
    head drawn ``head_gain / sqrt(fan_in)`` wide with a zero bias.  With a
    ``calibration`` batch each BN's moving statistics are set to the
    moments of its own input on that batch, layer by layer, so that
    activations stay O(1) and the coefficients O(head_gain), as a trained
    network's would."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = (head_gain if name == "logits" else math.sqrt(2.0)) \
                    / math.sqrt(fan_in)
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
        if calibration is None:
            return model

        def moments(mod, args):
            x = args[0]
            mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
            mod.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

        hooks = [m.register_forward_pre_hook(moments)
                 for m in model.modules() if isinstance(m, SlimBatchNorm)]
        try:
            model(calibration)
        finally:
            for h in hooks:
                h.remove()
    return model


class RNetIdentityProvider:
    """image + 68 landmarks -> Identity via the R-Net on ``device`` (the
    reference's alignto_bfm_coeff, infer_bfmvid.py:29-74)."""

    def __init__(self, state: Mapping[str, torch.Tensor], lm3d: np.ndarray,
                 device="cuda"):
        full_fp32_matmuls()
        self.device = torch.device(device)
        self.lm3d = lm3d              # [5, 3] (standard_lm3d)
        self.model = RNet()
        self.model.load_state_dict(state)
        self.model.to(self.device).eval()

    @classmethod
    def _strict(cls, arrays, what: str, lm3d, device):
        with torch.device("meta"):
            own = RNet().state_dict()
        return cls(tfc.strict_state(arrays, own, _rows(), what), lm3d,
                   device)

    @classmethod
    def from_npz(cls, weights_path: str, lm3d: np.ndarray, device="cuda"):
        return cls._strict(tfc.read_npz(weights_path),
                           f"rnet npz {weights_path}", lm3d, device)

    @classmethod
    def from_pb(cls, pb_path: str, lm3d: np.ndarray, device="cuda"):
        """The reference's ``FaceReconModel.pb`` itself, read with no TF."""
        return cls._strict(read_rnet_graphdef(pb_path), f"rnet pb {pb_path}",
                           lm3d, device)

    @torch.inference_mode()
    def coefficients(self, aligned: np.ndarray) -> np.ndarray:
        """[B, 224, 224, 3] BGR 0..255 -> [B, 257] float32."""
        x = torch.as_tensor(np.asarray(aligned, np.float32),
                            device=self.device)
        return self.model(x).float().cpu().numpy()

    def __call__(self, image: np.ndarray, landmarks68: np.ndarray,
                 center_x: int, center_y: int, ratio: float):
        from voicepuppet_torch.pipeline.align import (align_for_identity,
                                                      landmarks68_to_5)
        from voicepuppet_torch.pipeline.synthesize import Identity
        lmk5 = landmarks68_to_5(np.asarray(landmarks68).reshape(-1))
        aligned, trans_params = align_for_identity(image, lmk5, self.lm3d)
        return Identity(bfmcoeff=self.coefficients(aligned),
                        transform_params=trans_params, center_x=center_x,
                        center_y=center_y, ratio=ratio, colors_bgr=True)
