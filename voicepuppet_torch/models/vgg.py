"""VGG-16 perceptual trunk (port of ``voicepuppet_tpu/models/vgg.py``:28-122).

The slim VGG-16 of PixRefer's perceptual loss
(voicepuppet/pixrefer/vgg_simple.py:96-163): conv stacks (2, 2, 3, 3) of
3x3 'SAME' convs with 2x2 max pools, endpoints conv1_2 / conv2_2 /
conv3_3 / conv4_3.  Submodules keep the flax names (``conv1_1`` ...), so
``weights.state_dict_from_flax`` loads a JAX trunk directly.  Weights come
from a converted npz (:func:`load_weights`), the released ``vgg_16.ckpt``
(``tools/tf_bundle.load_vgg16_checkpoint``) or, when neither is present,
a seeded random draw (:func:`init_vgg_`), as the JAX trainer falls back
to its seeded init.

The trunk is frozen: its parameters never require gradients (the
reference keeps the vgg variables out of both optimizers' var_lists,
pixrefer.py:397-406).  The loss reads conv3_3 only, so the perceptual path
stops there: XLA drops the unused conv4 stack from the JAX program, while
eager torch would run it for nothing.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (convs per stack, stack name)
STACKS = ((2, "conv1"), (2, "conv2"), (3, "conv3"), (3, "conv4"))


class VGG16Features(nn.Module):
    """NHWC images -> the endpoint feature maps (NCHW) of the first
    ``stacks`` conv stacks.  ``dtype``: the conv compute dtype (the
    parameters stay float32)."""

    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = 3
        for (reps, name), width in zip(STACKS, widths):
            for j in range(reps):
                self.add_module(f"{name}_{j + 1}",
                                nn.Conv2d(ch, width, 3, padding=1))
                ch = width
        self.requires_grad_(False)

    def forward(self, x, stacks: int = 4) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        ends = []
        for s, (reps, name) in enumerate(STACKS[:stacks]):
            if s:
                x = F.max_pool2d(x, 2, 2)
            for j in range(reps):
                conv = getattr(self, f"{name}_{j + 1}")
                x = F.relu(F.conv2d(x, conv.weight.to(x.dtype),
                                    conv.bias.to(x.dtype), padding=1))
            ends.append(x)
        return ends


def init_vgg_(model: VGG16Features, generator: torch.Generator
              ) -> VGG16Features:
    """flax's default conv init: lecun-normal kernels (a normal truncated
    at 2 sigma, std sqrt(1/fan_in) / .87962566), zero biases."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
    return model


def load_weights(npz_path: str, model: VGG16Features) -> VGG16Features:
    """Load converted slim weights (``conv{i}_{j}_kernel`` HWIO /
    ``conv{i}_{j}_bias`` arrays), strictly: an absent or mis-shaped array
    raises instead of leaving random weights in the loss."""
    from voicepuppet_torch import weights
    blob = np.load(npz_path)
    own = model.state_dict()
    state, missing = {}, []
    for key in own:
        layer, part = key.split(".")
        name = f"{layer}_{'kernel' if part == 'weight' else 'bias'}"
        if name not in blob:
            missing.append(name)
            continue
        val = weights.convert_leaf((layer, name.rsplit("_", 1)[1]),
                                   blob[name])
        if val.shape != tuple(own[key].shape):
            missing.append(name)
            continue
        state[key] = torch.from_numpy(np.ascontiguousarray(val, np.float32))
    if missing:
        raise ValueError(f"{npz_path}: {len(missing)} trunk arrays absent "
                         f"or mis-shaped, e.g. {missing[:3]}")
    model.load_state_dict(state)
    return model


def perceptual_loss(vgg: VGG16Features, real_fg: torch.Tensor,
                    fake_fg: torch.Tensor) -> torch.Tensor:
    """conv3_3 L2 content loss (ref: pixrefer.py:318-328):
    ``l2_loss(gen_f - img_f) / size(gen_f)`` = ``sum(diff²) / (2 size)``,
    reduced in float32 whatever the trunk's dtype.  The real branch runs
    under ``no_grad``; the two passes equal the reference's one pass over
    ``concat([real, fake])`` because every op of the trunk is per
    sample."""
    with torch.no_grad():
        real_f = vgg(real_fg, stacks=3)[-1]
    fake_f = vgg(fake_fg, stacks=3)[-1]
    diff = (fake_f - real_f).float()
    return torch.sum(torch.square(diff)) / (2.0 * diff.numel())
