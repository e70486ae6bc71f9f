"""PixRefer GAN — reference-conditioned pix2pix with alpha compositing.

Port of ``voicepuppet_tpu/models/pixrefer.py``.  The generator
(:128-188, 258-272): two 4-level strided-conv encoders (rendered face, 6 ch;
foreground reference, 3 ch) merged at 1/16 scale, 4 more encoder levels,
7 deconv levels with U-Net skips, a tanh RGBA head, then ``composite``.

BatchNorm is the reference's always-``training=True`` batch norm: the
moments of the chunk being rendered, even at inference, accumulated in
float32 (``StatelessBatchNorm``).  ``Generator`` takes and returns NHWC
like the JAX module; inside it runs NCHW.  Its convs run in the compute
dtype held on the module (``Generator.dtype``, float32 by default), each
conv casting its weights to it, while BN moments, the tanh and the
compositing stay float32.  Training sets it with the constructor's
``dtype`` and keeps float32 parameters, as the JAX modules' ``dtype``
does; ``set_conv_dtype`` sets it together with the weights' dtype, as
``Synthesizer`` does for the JAX serving path's ``gan_dtype=bfloat16``.

The discriminator (:113-126, 191-256) is the 70x70 PatchGAN: pad 1 and a
VALID 4x4 conv per layer, strides 2, 2, 2, 1, 1, ``StatelessBatchNorm`` on
the middle three, a sigmoid over float32 logits.  The trainer applies it
three times per step (two real pairs, the fake), each call with its own
batch moments.  ``discriminator_loss`` / ``generator_loss`` are the
reference's losses (pixrefer.py:334-354).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.models.layers import (SameConv2d,
                                             SameConvTranspose2d, SyncBN,
                                             same_pads)
from voicepuppet_torch.parallel.mesh import AllReduceSum, spans_ranks


def lrelu(x, a: float = 0.2):
    return F.leaky_relu(x, negative_slope=a)


class StatelessBatchNorm(SyncBN):
    """Batch-moment normalization with learned scale/offset, eps 1e-5,
    moments in float32 (ref: pixrefer.py:58-86).  Over a group of several
    ranks (:func:`layers.sync_bn`) ``mean`` and ``mean²`` are averaged
    across them, as the JAX module pmeans them (pixrefer.py:81-83).
    ``moment_dims``: the NCHW axes the moments are taken over; (2, 3)
    gives each frame its own moments, as a batch of one would
    (``PixFlowNet.per_frame_moments``)."""

    moment_dims = (0, 2, 3)

    def __init__(self, ch: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=self.moment_dims, keepdim=True)
        mean2 = torch.square(xf).mean(dim=self.moment_dims, keepdim=True)
        if spans_ranks(self.group):
            both = AllReduceSum.apply(torch.cat([mean, mean2]), self.group)
            both = both / dist.get_world_size(self.group)
            mean, mean2 = both[:1], both[1:]
        return self.normalize(xf, mean, mean2).to(x.dtype)

    def normalize(self, xf, mean, mean2):
        """float32 ``xf`` normalized with given moments ([1,C,1,1] mean
        and mean of squares, float32), scaled and offset: the path of a
        caller that takes the moments itself, over any element count
        (``parallel/spatial.py``: a tensor split by rows over ranks)."""
        var = mean2 - torch.square(mean)
        inv = torch.rsqrt(var + self.epsilon)
        return ((xf - mean) * inv * self.weight.view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


class GenConv(nn.Module):
    """4x4 stride-2 'SAME' conv (ref: pixrefer.py:66-74)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, (4, 4), (2, 2), bias=True)

    def forward(self, x):
        return self.Conv_0(x)

    def forward_halo(self, x):
        """The conv of rows ``x`` that carry one halo row above and one
        below (a neighbour's row, or zeros at the tensor's edge) in place
        of SAME's height padding: output row i reads input rows 2i-1 ..
        2i+2, so an even count of rows plus the two halo rows gives
        exactly this block's output rows.  The width is padded as SAME
        pads it."""
        c = self.Conv_0
        pw = same_pads(x.shape[-1], c.kernel_size[1], c.stride[1])
        return c._conv_forward(F.pad(x, (pw[0], pw[1], 0, 0)),
                               c.weight.to(x.dtype), c.bias.to(x.dtype))


class GenDeconv(nn.Module):
    """4x4 stride-2 'SAME' transposed conv (ref: pixrefer.py:76-86):
    ``lax.conv_transpose`` pads the dilated input (2, 2), torch's
    ``padding=1`` (``layers.SameConvTranspose2d``); its kernel is the
    spatially flipped flax kernel (weights.py)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = SameConvTranspose2d(in_ch, features, 4, 2)

    def forward(self, x):
        return self.ConvTranspose_0(x)

    def forward_halo(self, x):
        """The transposed conv of rows ``x`` [a-1, b] (one halo row each
        side, zeros at the tensor's edge) -> output rows [2a, 2b): the
        halo rows widen the output by ``stride`` rows at each end, and a
        height padding ``stride`` larger crops them."""
        c = self.ConvTranspose_0
        return F.conv_transpose2d(x, c.weight.to(x.dtype),
                                  c.bias.to(x.dtype), c.stride,
                                  (c.padding[0] + c.stride[0],
                                   c.padding[1]))


class WholeOps:
    """The generator's ops on whole NCHW tensors, as its plain forward
    runs them.  ``parallel.spatial.RowSplit`` supplies the same six ops
    on tensors whose rows are split over ranks."""

    @staticmethod
    def enter(x):
        return x

    @staticmethod
    def leave(y):
        return y

    @staticmethod
    def act(fn, x):
        return fn(x)

    @staticmethod
    def conv(module, x):
        return module(x)

    @staticmethod
    def bn(module, x):
        return module(x)

    @staticmethod
    def cat(a, b):
        return torch.cat([a, b], dim=1)


WHOLE = WholeOps()


class Generator(nn.Module):
    """ref: pixrefer.py:128-188.  inputs [B,S,S,6], fg_ref [B,S,S,3]
    (NHWC, in [-1,1]) -> raw tanh output [B,S,S,4] float32.  ``dtype``:
    the conv compute dtype."""

    def __init__(self, ngf: int = 64, out_channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ngf = ngf
        self.dtype = dtype
        bn = iter(range(17))

        def add_bn(ch):
            self.add_module(f"StatelessBatchNorm_{next(bn)}",
                            StatelessBatchNorm(ch))

        self.encoder_1 = GenConv(6, ngf)
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 2, ngf * 4)):
            self.add_module(f"encoder_{i + 2}", GenConv(ch, out))
            add_bn(out)
            ch = out
        self.encoder_fg_1 = GenConv(3, ngf)
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 2, ngf * 4)):
            self.add_module(f"encoder_fg_{i + 2}", GenConv(ch, out))
            add_bn(out)
            ch = out
        enc = [ngf * 8]                   # merged trunk input channels
        for i, out in enumerate((ngf * 4, ngf * 8, ngf * 8, ngf * 8)):
            self.add_module(f"merged_encoder_{i + 2}", GenConv(enc[-1], out))
            add_bn(out)
            enc.append(out)
        ch = enc[-1]
        for dl, out in enumerate((ngf * 8, ngf * 8, ngf * 4, ngf * 4)):
            skip = len(enc) - dl - 1
            in_ch = ch if dl == 0 else ch + enc[skip]
            self.add_module(f"merged_decoder_{skip + 1}",
                            GenDeconv(in_ch, out))
            add_bn(out)
            ch = out
        face = [ngf, ngf * 2, ngf * 2, ngf * 4]
        for dl, out in enumerate((ngf * 2, ngf * 2, ngf)):
            skip = len(face) - dl - 1
            self.add_module(f"merged2_decoder_{skip + 1}",
                            GenDeconv(ch + face[skip], out))
            add_bn(out)
            ch = out
        self.decoder_1 = GenDeconv(ch + ngf, out_channels)

    def forward(self, inputs, fg_ref, ops=WHOLE):
        """``ops``: how each op of the U-Net runs (:data:`WHOLE`: the
        plain forward; ``parallel.spatial.RowSplit``: the height split
        over ranks)."""
        x = ops.enter(inputs.permute(0, 3, 1, 2).to(self.dtype))
        fg = ops.enter(fg_ref.permute(0, 3, 1, 2).to(self.dtype))
        bn = iter(getattr(self, f"StatelessBatchNorm_{i}") for i in range(17))

        def down(name, y):
            return ops.bn(next(bn), ops.conv(getattr(self, name),
                                             ops.act(lrelu, y)))

        def up(name, y):
            return ops.bn(next(bn), ops.conv(getattr(self, name),
                                             ops.act(F.relu, y)))

        layers = [ops.conv(self.encoder_1, x)]
        for i in range(3):
            layers.append(down(f"encoder_{i + 2}", layers[-1]))
        fg_layers = [ops.conv(self.encoder_fg_1, fg)]
        for i in range(3):
            fg_layers.append(down(f"encoder_fg_{i + 2}", fg_layers[-1]))
        merged = [ops.cat(layers[-1], fg_layers[-1])]
        for i in range(4):
            merged.append(down(f"merged_encoder_{i + 2}", merged[-1]))
        num_enc = len(merged)
        for dl in range(4):
            skip = num_enc - dl - 1
            x = merged[-1] if dl == 0 else ops.cat(merged[-1], merged[skip])
            merged.append(up(f"merged_decoder_{skip + 1}", x))
        num_enc2 = len(layers)
        for dl in range(3):
            skip = num_enc2 - dl - 1
            merged.append(up(f"merged2_decoder_{skip + 1}",
                             ops.cat(merged[-1], layers[skip])))
        x = ops.conv(self.decoder_1,
                     ops.act(F.relu, ops.cat(merged[-1], layers[0])))
        return torch.tanh(ops.leave(x).float()).permute(0, 2, 3, 1)


def composite(gen_out, targets):
    """RGB+alpha compositing (ref: pixrefer.py:219-228) ->
    (outputs, alphas, outputs_fg), all NHWC."""
    rgb = gen_out[..., :3]
    alpha = ((gen_out[..., 3:] + 1.0) / 2.0).expand(-1, -1, -1, 3)
    outputs = rgb * alpha + targets * (1.0 - alpha)
    outputs_fg = rgb * alpha + alpha - 1.0
    return outputs, alpha, outputs_fg


def preprocess(image):
    """[0,1] -> [-1,1]."""
    return image * 2.0 - 1.0


def deprocess(image):
    """[-1,1] -> [0,1]."""
    return (image + 1.0) / 2.0


class PixReferNet(nn.Module):
    """Generator side (ref: pixrefer.py:258-272): inputs [B,S,S,6],
    fg_inputs [B,S,S,6] (only the first 3 channels reach G), targets
    [B,S,S,3], all in [-1,1] -> composite(G(...), targets)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.generator = Generator(cfg.ngf, 4, dtype)

    def forward(self, inputs, fg_inputs, targets):
        return composite(self.generator(inputs, fg_inputs[..., :3]),
                         targets)

    def set_conv_dtype(self, dtype: torch.dtype) -> "PixReferNet":
        """Cast the conv weights (not the BN affine) to ``dtype`` and
        compute the convs in it."""
        self.generator.dtype = dtype
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        return self


class DiscrimConv(nn.Module):
    """Pad 1, then a 4x4 VALID conv (ref: pixrefer.py:61-64)."""

    def __init__(self, in_ch: int, features: int, stride: int):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_ch, features, 4, stride, padding=0)

    def forward(self, x):
        c = self.Conv_0
        return F.conv2d(F.pad(x, (1, 1, 1, 1)), c.weight.to(x.dtype),
                        c.bias.to(x.dtype), stride=self.stride)


class Discriminator(nn.Module):
    """PatchGAN (ref: pixrefer.py:103-134): d_inputs, d_targets [B,S,S,3]
    NHWC in [-1,1] -> sigmoid scores [B,S/8-2,S/8-2,1] float32.  ``dtype``
    is the conv compute dtype (parameters stay float32); the sigmoid runs
    on float32 logits, so its saturation near 0 and 1, which the -log(D)
    losses read, does not change with it."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.dtype = dtype
        self.layer_1 = DiscrimConv(6, ndf, 2)
        ch = ndf
        for i in range(n_layers):
            out = ndf * min(2 ** (i + 1), 8)
            self.add_module(f"layer_{i + 2}", DiscrimConv(
                ch, out, 1 if i == n_layers - 1 else 2))
            self.add_module(f"StatelessBatchNorm_{i}", StatelessBatchNorm(out))
            ch = out
        self.add_module(f"layer_{n_layers + 2}", DiscrimConv(ch, 1, 1))

    def forward(self, d_inputs, d_targets):
        x = torch.cat([d_inputs, d_targets], dim=-1).permute(0, 3, 1, 2)
        x = lrelu(self.layer_1(x.to(self.dtype)))
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i + 2}")(x)
            x = lrelu(getattr(self, f"StatelessBatchNorm_{i}")(x))
        x = getattr(self, f"layer_{self.n_layers + 2}")(x)
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1)


def discriminator_loss(predict_real, predict_fake, eps: float = 1e-12):
    """ref: pixrefer.py:334-340 (the real term doubled)."""
    return torch.mean(-(torch.log(predict_real + eps) * 2.0
                        + torch.log(1.0 - predict_fake + eps)))


def generator_loss(predict_fake, targets, outputs, alphas, masks,
                   perceptual, gan_weight: float, l1_weight: float,
                   eps: float = 1e-12):
    """ref: pixrefer.py:342-354 -> (total, gan term, l1 term)."""
    gan = torch.mean(-torch.log(predict_fake + eps))
    l1 = (torch.mean(torch.abs(targets - outputs))
          + torch.mean(torch.abs(masks - alphas)) + torch.mean(perceptual))
    return gan * gan_weight + l1 * l1_weight, gan, l1


def init_pixrefer_(model: nn.Module, generator: torch.Generator
                   ) -> nn.Module:
    """Fresh weights with the JAX init's distributions: conv kernels
    N(0, 0.02), zero conv biases, BN scale 1 + N(0, 0.02), BN bias 0.
    Serves the generator (``PixReferNet``) and the ``Discriminator``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, StatelessBatchNorm):
                m.weight.normal_(0.0, 1.0, generator=generator)
                m.weight.mul_(0.02).add_(1.0)
                m.bias.zero_()
    return model
