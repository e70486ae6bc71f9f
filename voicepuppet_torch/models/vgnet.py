"""VGNet — landmark sequence + example image -> video GAN, the legacy
ATVGNet subsystem (port of ``voicepuppet_tpu/models/vgnet.py``; ref:
voicepuppet/atvgnet/vgnet.py).

Generator (:451-627): image encoders to 1/4 (128 ch) and 1/16 (512 ch) of
the example image; a landmark path (dense to an (S/16)² map, conv 256,
conv 512) shared by the example landmark and every frame; a per-frame
attention map at 1/4 (two 3x3 deconvs, a conv, BN, sigmoid); a
bottleneck conv over the image feature and the landmark feature's
difference; the convolutional GRU ``conv_gru`` (3x3 gate and candidate
convs, batch-normalized, 512 filters) run over time with its outputs
masked past ``seq_len``; the video head (ThinNet-128 + two deconvs fused
with the 1/4 image encoding through the attention, two more deconvs to
full size), and the colour (tanh) and attention (sigmoid) composite
against the example image.

Discriminator (:630-808): a per-frame conv encoder with no norm or
activation between its convs, a dense landmark encoder, a GRU(256) with
dropout 0.25 in training, a per-step score (masked mean, sigmoid) and a
landmark head added to the example landmark.

The losses (:848-934): D's BCE terms plus the landmark MSE of both
passes; G's BCE, landmark MSE and a pixel MSE weighted by (mask + 0.5) *
(attention + 0.5), the attention taken as a constant there.

Images enter and leave NHWC (``[B,T,S,S,C]`` for sequences); the convs run
NCHW.  ``StatelessCenterBN`` takes the biased batch moments through
``layers.batch_moments`` (the JAX module's ``mean(x²) - mean²``, whose
float32 backward cancels two large terms).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.models.layers import (MOBILENET_WIDTHS, MaskedGRU,
                                             SameConv2d,
                                             SameConvTranspose2d, SyncBN,
                                             TFBatchNorm, ThinNet,
                                             batch_moments, init_flax_like_)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ConvBNElu(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, (kernel, kernel),
                                 (stride, stride))
        self.TFBatchNorm_0 = TFBatchNorm(features)

    def forward(self, x, train: bool = False):
        return F.elu(self.TFBatchNorm_0(self.Conv_0(x), train))


class DeconvBNElu(nn.Module):
    """A 3x3 stride-2 'SAME' transposed conv (pads the dilated input
    (2, 1)), BN, elu."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = SameConvTranspose2d(in_ch, features, 3, 2,
                                                   bias=False)
        self.TFBatchNorm_0 = TFBatchNorm(features)

    def forward(self, x, train: bool = False):
        return F.elu(self.TFBatchNorm_0(self.ConvTranspose_0(x), train))


class StatelessCenterBN(SyncBN):
    """Batch-moment normalization with a learned offset only (eps 1e-3)
    and no running moments, inside the conv-GRU cell (JAX
    ``vgnet.py:94-104``), at inference too.  Under :func:`layers.sync_bn`
    its moments are the group's (``batch_moments``)."""

    def __init__(self, ch: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        mean, var = batch_moments(x, self.group)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape)
                                                     + self.epsilon)
                + self.bias.view(shape))


class Conv2dGRUCell(nn.Module):
    """ref: vgnet.py:350-424: ``r, u = sigmoid(BN(conv([x, h])))``, ``c =
    BN(conv([x, r*h]))``, ``h' = u*h + (1-u)*tanh(c)``."""

    def __init__(self, in_ch: int, filters: int = 512):
        super().__init__()
        self.filters = filters
        self.gates = SameConv2d(in_ch + filters, 2 * filters, (3, 3))
        self.bn_r = StatelessCenterBN(filters)
        self.bn_u = StatelessCenterBN(filters)
        self.candidate = SameConv2d(in_ch + filters, filters, (3, 3))
        self.bn_c = StatelessCenterBN(filters)

    def forward(self, h, x):
        y = self.gates(torch.cat([x, h], dim=1))
        r = torch.sigmoid(self.bn_r(y[:, :self.filters]))
        u = torch.sigmoid(self.bn_u(y[:, self.filters:]))
        c = self.bn_c(self.candidate(torch.cat([x, r * h], dim=1)))
        return u * h + (1 - u) * torch.tanh(c)


class Conv2dGRU(nn.Module):
    """The cell run over [B,T,C,H,W] as a Python loop over T, the outputs
    zeroed past each row's ``seq_len`` (``tf.nn.dynamic_rnn`` masking, as
    the JAX scan does), then BN over (B, T, H, W) and elu (ref:
    vgnet.py:427-448).  The cell keeps the scan's flax scope,
    ``ScanConv2dGRUCell_0``."""

    def __init__(self, in_ch: int, filters: int = 512):
        super().__init__()
        self.filters = filters
        self.ScanConv2dGRUCell_0 = Conv2dGRUCell(in_ch, filters)
        self.TFBatchNorm_0 = TFBatchNorm(filters)

    def forward(self, inputs, seq_len, train: bool = False):
        b, t, _, hh, ww = inputs.shape
        cell = self.ScanConv2dGRUCell_0
        h = inputs.new_zeros((b, self.filters, hh, ww))
        outs = []
        for i in range(t):
            h = cell(h, inputs[:, i])
            outs.append(h)
        out = torch.stack(outs, dim=1)
        mask = (torch.arange(t, device=out.device)[None, :]
                < seq_len[:, None]).to(out.dtype)
        out = out * mask[:, :, None, None, None]
        out = self.TFBatchNorm_0(out.reshape(b * t, self.filters, hh, ww),
                                 train)
        return F.elu(out).reshape(b, t, self.filters, hh, ww)


class VGNetGenerator(nn.Module):
    """ref: vgnet.py:451-627.  example_img [B,S,S,3], landmark_seq
    [B,T,136], example_landmark [B,136], seq_len [B] -> (video
    [B,T,S,S,3], attention [B,T,S,S,1], color [B,T,S,S,3])."""

    def __init__(self, cfg):
        super().__init__()
        s16 = cfg.img_size // 16
        self.s16 = s16
        for i, (cin, cout, k, st) in enumerate((
                (3, 64, 7, 1), (64, 64, 3, 2), (64, 128, 3, 2),
                (128, 256, 3, 2), (256, 512, 3, 2))):
            self.add_module(f"ConvBNElu_{i}", ConvBNElu(cin, cout, k, st))
        self.landmark_encoder1 = nn.Linear(cfg.landmark_size, s16 * s16)
        self.landmark_encoder2 = ConvBNElu(1, 256)
        self.landmark_feature = ConvBNElu(256, 512)
        self.att_deconv1 = DeconvBNElu(512, 256)
        self.att_deconv2 = DeconvBNElu(256, 128)
        self.att_out = SameConv2d(128, 1, (3, 3))
        self.att_bn = TFBatchNorm(1)
        self.bottleneck = ConvBNElu(1024, 128)
        self.conv_gru = Conv2dGRU(128, 512)
        self.genbase_thinnet = ThinNet(512, 128, F.elu,
                                       stem_stride=(1, 1),
                                       widths=MOBILENET_WIDTHS)
        self.genbase_deconv1 = DeconvBNElu(128, 256)
        self.genbase_deconv2 = DeconvBNElu(256, 128)
        self.basenet_deconv1 = DeconvBNElu(128, 64)
        self.basenet_deconv2 = DeconvBNElu(64, 32)
        self.gen_color = SameConv2d(32, 3, (7, 7))
        self.gen_attention = SameConv2d(32, 1, (7, 7))

    def forward(self, example_img, landmark_seq, example_landmark, seq_len,
                train: bool = False):
        b, t, _ = landmark_seq.shape
        s, s16 = example_img.shape[1], self.s16
        tile = lambda v: v[:, None].expand(-1, t, *v.shape[1:]).reshape(
            b * t, *v.shape[1:])

        ex = _nchw(example_img)
        x = self.ConvBNElu_0(ex, train)
        x = self.ConvBNElu_1(x, train)
        img_encoding1 = self.ConvBNElu_2(x, train)          # [B,128,S/4,.]
        x = self.ConvBNElu_3(img_encoding1, train)
        img_feature = self.ConvBNElu_4(x, train)            # [B,512,S/16,.]

        def encode_lmk(lmk_flat):
            e1 = F.elu(self.landmark_encoder1(lmk_flat)).reshape(
                -1, 1, s16, s16)
            e2 = self.landmark_encoder2(e1, train)
            return e2, self.landmark_feature(e2, train)

        ex_enc2, ex_feat = encode_lmk(example_landmark)
        seq_enc2, seq_feat = encode_lmk(landmark_seq.reshape(b * t, -1))

        y = torch.cat([seq_enc2, tile(ex_enc2)], dim=1)
        y = self.att_deconv2(self.att_deconv1(y, train), train)
        lmk_atts = torch.sigmoid(self.att_bn(self.att_out(y), train))

        bott = self.bottleneck(torch.cat([tile(img_feature),
                                          seq_feat - tile(ex_feat)], dim=1),
                               train)
        gru = self.conv_gru(bott.reshape(b, t, 128, s16, s16), seq_len,
                            train).reshape(b * t, 512, s16, s16)

        vt = self.genbase_thinnet(gru, train)
        vt = self.genbase_deconv2(self.genbase_deconv1(vt, train), train)
        vt = tile(img_encoding1) * (1 - lmk_atts) + vt * lmk_atts
        base = self.basenet_deconv2(self.basenet_deconv1(vt, train), train)
        color = torch.tanh(self.gen_color(base))
        attention = torch.sigmoid(self.gen_attention(base))
        video = attention * color + (1 - attention) * tile(ex)
        seq = lambda v: _nhwc(v).reshape(b, t, s, s, v.shape[1])
        return seq(video), seq(attention), seq(color)


class VGNetDiscriminator(nn.Module):
    """ref: vgnet.py:630-808.  (img_seq [B,T,S,S,3], example_landmark
    [B,136], seq_len [B]) -> (score [B], landmarks [B,T,136])."""

    def __init__(self, cfg, drop_rate: float = 0.25):
        super().__init__()
        self.dis_lmk_1 = nn.Linear(cfg.landmark_size, 256, bias=False)
        self.dis_lmk_2 = nn.Linear(256, 512, bias=False)
        ch = 3
        for i, out in enumerate((64, 128, 128, 256)):
            self.add_module(f"dis_conv_{i + 1}",
                            SameConv2d(ch, out, (3, 3), (2, 2)))
            ch = out
        self.dis_img_fc = nn.Linear((cfg.img_size // 16) ** 2 * 256, 512,
                                    bias=False)
        # keep_prob .75 (vgnet.py:693), in training only
        self.dis_rnn = MaskedGRU(1024, 256, 1, drop_rate)
        self.decision = nn.Linear(256, 1, bias=False)
        self.rnn_dense = nn.Linear(256, cfg.landmark_size, bias=False)

    def forward(self, img_seq, example_landmark, seq_len,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, t, s = img_seq.shape[:3]
        le = F.elu(self.dis_lmk_2(F.elu(self.dis_lmk_1(example_landmark))))
        x = _nchw(img_seq.reshape(b * t, s, s, 3))
        for i in range(4):
            x = getattr(self, f"dis_conv_{i + 1}")(x)
        # flattened in the JAX module's NHWC order
        x = F.elu(self.dis_img_fc(_nhwc(x).reshape(b * t, -1)))
        feat = torch.cat([x.reshape(b, t, 512),
                          le[:, None].expand(-1, t, -1)], dim=-1)
        rnn = self.dis_rnn(feat, seq_len, train=train, generator=generator)
        score = self.decision(rnn)[..., 0]
        mask = (torch.arange(t, device=score.device)[None, :]
                < seq_len[:, None]).float()
        score = torch.sigmoid(torch.sum(score * mask, dim=-1)
                              / seq_len.float())
        lmk = torch.tanh(self.rnn_dense(rnn)) + example_landmark[:, None]
        return score, lmk


def init_vgnet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights with the JAX init's distributions: VGNet's own convs,
    deconvs and dense kernels orthogonal, ThinNet's xavier-uniform, GRU
    cells orthogonal with gate bias 1.0.  Serves G and D."""
    return init_flax_like_(model, generator, orthogonal=lambda name:
                           not name.startswith("genbase_thinnet"))


def _mask(seq_len, t):
    return (torch.arange(t, device=seq_len.device)[None, :]
            < seq_len[:, None]).float()


def vgnet_discriminator_loss(real_score, real_lmk, fake_score, fake_lmk,
                             real_landmark_seq, seq_len, eps: float = 1e-12):
    """ref: vgnet.py:848-892."""
    mask = _mask(seq_len, real_lmk.shape[1])
    bce1 = torch.mean(-torch.log(real_score + eps))
    bce2 = torch.mean(-torch.log(1 - fake_score + eps))
    mse_r = torch.mean(torch.square(real_lmk - real_landmark_seq), dim=-1)
    mse_f = torch.mean(torch.square(fake_lmk - real_landmark_seq), dim=-1)
    lmk1 = torch.mean(torch.sum(mse_r * mask, dim=-1))
    lmk2 = torch.mean(torch.sum(mse_f * mask, dim=-1))
    return bce1 + lmk1 + bce2 + lmk2


def vgnet_generator_loss(fake_score, fake_lmk, fake_img_seq, attention,
                         real_landmark_seq, real_mask_seq, real_img_seq,
                         seq_len, eps: float = 1e-12):
    """ref: vgnet.py:894-934 -> (total, bce, landmark, pixel); the
    attention is a constant in the pixel weight (vgnet.py:906)."""
    mask = _mask(seq_len, fake_lmk.shape[1])
    bce = torch.mean(-torch.log(fake_score + eps))
    mse = torch.mean(torch.square(fake_lmk - real_landmark_seq), dim=-1)
    lmk = torch.mean(torch.sum(mse * mask, dim=-1))
    diff = (torch.square(real_img_seq - fake_img_seq)
            * (real_mask_seq + 0.5) * (attention.detach() + 0.5))
    pix = torch.mean(torch.sum(torch.sum(diff, dim=(2, 3, 4)) * mask,
                               dim=-1))
    return bce + lmk + pix, bce, lmk, pix
