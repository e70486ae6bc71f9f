"""PixFlowNet — a skip-free GAN driven by rendered-face feature
differences (port of ``voicepuppet_tpu/models/pixflow.py``; ref:
voicepuppet/pixflow/pixflow.py).

Generator (:222-255): ``encoder_net`` embeds the reference foreground (a
7x7 stride-2 TF-'SAME' stem ``stem7``, then three 4x4 stride-2 conv + BN
levels to ngf*8); ``diffnet``, one set of weights applied to both
rendered faces, embeds them and their difference carries the motion; two
resnet stacks process the encoding and the difference, their sum feeds
the decoder (two more resnet blocks, three 4x4 deconvs and the 7x7
stride-2 deconv ``final7``), then tanh RGB + alpha.  The composite is
on a black background: ``rgb*α + α - 1``.

The discriminator is PixRefer's PatchGAN (``pixrefer.Discriminator``)
with ndf 48; the losses (:293-312) have a single real term in D's and
take G's L1 target from the current foreground ``fg_inputs[..., 3:]``.
BatchNorm is PixRefer's batch-moment ``StatelessBatchNorm``, at inference
too.  ``ResBlock`` drops out at ``drop_rate`` 0.5 in training, drawing
from the caller's ``torch.Generator``.

Serving (``pipeline/synthesize.py``) runs G as the published driver
does, one frame at a time, over a batch: ``PixFlowNet.per_frame_moments``
gives each frame its own BN moments, so a frame does not depend on the
others of its batch.  The encoding of the reference foreground, the
reference render's ``diffnet`` features and ``pre_resnet`` are then the
same for every frame of a call: ``PixFlowGenerator.call_state`` computes
them once (at batch 1) and ``frame_forward`` the rest for a batch of
current renders; together they are ``forward`` exactly.

Modules keep the flax scope names; images enter and leave NHWC, the convs
run NCHW in the compute dtype ``PixFlowGenerator.dtype`` (float32 by
default; the trainer's ``train_dtype``) with float32 parameters, while BN
moments, the tanh and the composite stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.models.layers import (SameConv2d,
                                             SameConvTranspose2d, dropout)
from voicepuppet_torch.models.pixrefer import (GenConv, GenDeconv,
                                               PixReferNet,
                                               StatelessBatchNorm, lrelu)


class ResBlock(nn.Module):
    """ref: pixflow.py:95-109: 3x3 conv + BN + lrelu (+ dropout in
    training) + 3x3 conv + BN, added to the input."""

    def __init__(self, features: int, drop_rate: float = 0.5):
        super().__init__()
        self.drop_rate = drop_rate
        self.Conv_0 = SameConv2d(features, features, (3, 3), bias=True)
        self.StatelessBatchNorm_0 = StatelessBatchNorm(features)
        self.Conv_1 = SameConv2d(features, features, (3, 3), bias=True)
        self.StatelessBatchNorm_1 = StatelessBatchNorm(features)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        y = lrelu(self.StatelessBatchNorm_0(self.Conv_0(x)))
        if train:
            y = dropout(y, self.drop_rate, generator)
        return x + self.StatelessBatchNorm_1(self.Conv_1(y))


class EncoderNet(nn.Module):
    """ref: pixflow.py:111-131: ``stem7`` then three GenConv + BN."""

    def __init__(self, ngf: int):
        super().__init__()
        self.stem7 = SameConv2d(3, ngf, (7, 7), (2, 2), bias=True)
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 4, ngf * 8)):
            self.add_module(f"enc_{i + 1}", GenConv(ch, out))
            self.add_module(f"StatelessBatchNorm_{i}",
                            StatelessBatchNorm(out))
            ch = out

    def forward(self, x):
        x = self.stem7(x)
        for i in range(3):
            x = getattr(self, f"StatelessBatchNorm_{i}")(
                getattr(self, f"enc_{i + 1}")(lrelu(x)))
        return x


class PixFlowGenerator(nn.Module):
    """ref: pixflow.py:222-255.  inputs [B,S,S,6] (render ref⊕cur),
    fg_inputs [B,S,S,6] (fg ref⊕cur; only the first three channels reach
    G), NHWC in [-1,1] -> the raw tanh output [B,S,S,4] float32."""

    def __init__(self, ngf: int = 64, out_channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder_net = EncoderNet(ngf)
        self.diffnet = EncoderNet(ngf)
        for name in ("pre_resnet", "diff_resnet", "post_resnet"):
            for i in range(2):
                self.add_module(f"{name}_{i + 1}", ResBlock(ngf * 8))
        ch = ngf * 8
        for i, out in enumerate((ngf * 8, ngf * 4, ngf * 2)):
            self.add_module(f"decoder_{i}", GenDeconv(ch, out))
            self.add_module(f"StatelessBatchNorm_{i}",
                            StatelessBatchNorm(out))
            ch = out
        self.final7 = SameConvTranspose2d(ch, out_channels, 7, 2)

    def forward(self, inputs, fg_inputs, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = inputs.permute(0, 3, 1, 2).to(self.dtype)
        fg = fg_inputs.permute(0, 3, 1, 2).to(self.dtype)
        encode_feat = self.encoder_net(fg[:, :3])
        diff_feat = self.diffnet(x[:, 3:]) - self.diffnet(x[:, :3])
        res = lambda name, v: getattr(self, name)(v, train, generator)
        h = res("pre_resnet_2", res("pre_resnet_1", encode_feat))
        return self._tail(h, diff_feat, res)

    def _tail(self, h, diff_feat, res):
        """diff_resnet, post_resnet on their sum, the decoder, tanh."""
        d = res("diff_resnet_2", res("diff_resnet_1", diff_feat))
        h = res("post_resnet_2", res("post_resnet_1", h + d))
        for i in range(3):
            h = getattr(self, f"StatelessBatchNorm_{i}")(
                getattr(self, f"decoder_{i}")(F.relu(h)))
        h = self.final7(F.relu(h))
        return torch.tanh(h.float()).permute(0, 2, 3, 1)

    def call_state(self, render_ref, fg_ref):
        """The part of an inference forward that one call's frames share
        under per-frame moments: render_ref, fg_ref [1,S,S,3] NHWC in
        [-1,1] -> (``pre_resnet``'s output, the reference render's
        ``diffnet`` features), NCHW in the compute dtype."""
        fg = fg_ref.permute(0, 3, 1, 2).to(self.dtype)
        ref = render_ref.permute(0, 3, 1, 2).to(self.dtype)
        h = self.pre_resnet_2(self.pre_resnet_1(self.encoder_net(fg)))
        return h, self.diffnet(ref)

    def frame_forward(self, state, render_cur):
        """The rest of an inference forward: ``call_state``'s output and
        the current renders [B,S,S,3] NHWC in [-1,1] -> the raw tanh
        output [B,S,S,4] float32."""
        h, ref_feat = state
        x = render_cur.permute(0, 3, 1, 2).to(self.dtype)
        res = lambda name, v: getattr(self, name)(v)
        return self._tail(h, self.diffnet(x) - ref_feat, res)


class PixFlowNet(nn.Module):
    """The generator and the black-background composite (ref:
    pixflow.py:258-267) -> (outputs [B,S,S,3], alphas [B,S,S,3])."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.generator = PixFlowGenerator(cfg.ngf, 4, dtype)

    def forward(self, inputs, fg_inputs, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return composite_black(self.generator(inputs, fg_inputs, train,
                                              generator))

    set_conv_dtype = PixReferNet.set_conv_dtype

    def per_frame_moments(self) -> "PixFlowNet":
        """Every BN takes each frame's own moments (over H and W): a
        batch then serves what batches of one frame serve."""
        for m in self.modules():
            if isinstance(m, StatelessBatchNorm):
                m.moment_dims = (2, 3)
        return self


def composite_black(out):
    """G's raw [B,S,S,4] -> (``rgb*α + α - 1`` [B,S,S,3], α [B,S,S,3])."""
    alpha = ((out[..., 3:] + 1.0) / 2.0).expand(-1, -1, -1, 3)
    return out[..., :3] * alpha + alpha - 1.0, alpha


def pixflow_discriminator_loss(predict_real, predict_fake,
                               eps: float = 1e-12):
    """ref: pixflow.py:295-300 (a single real term, unlike PixRefer)."""
    return torch.mean(-(torch.log(predict_real + eps)
                        + torch.log(1.0 - predict_fake + eps)))


def pixflow_generator_loss(predict_fake, fg_cur, outputs, alphas, masks,
                           gan_weight: float, l1_weight: float,
                           eps: float = 1e-12):
    """ref: pixflow.py:302-312 -> (total, gan term, l1 term);
    ``fg_cur`` is ``fg_inputs[..., 3:]``."""
    gan = torch.mean(-torch.log(predict_fake + eps))
    l1 = (torch.mean(torch.abs(fg_cur - outputs))
          + torch.mean(torch.abs(masks - alphas)))
    return gan * gan_weight + l1 * l1_weight, gan, l1
