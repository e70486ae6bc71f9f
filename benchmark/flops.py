"""Operation counts of the reference networks at a cell's shapes, by
``torch.utils.flop_counter.FlopCounterMode`` over the reference's modules
on the meta device (no memory, no device), and the analytic count of the
generator's convs that they are tested against."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def generator_flops(ngf: int, batch: int, size: int) -> int:
    """One forward of the PixRefer generator at ``batch`` frames of
    ``size``²."""
    with torch.device("meta"):
        g = nets.Generator(ngf)
        x = torch.zeros(batch, size, size, 6)
        fg = torch.zeros(batch, size, size, 3)
        return _count(lambda: g(x, fg))


def bfmnet_flops(bfm: dict, frames: int, frame_mel: int = 5,
                 bins: int = 80) -> int:
    """One forward of BFMNet over a clip of ``frames`` frames (its mel
    frontend's two matmuls excluded)."""
    with torch.device("meta"):
        net = nets.BFMNet(bfm)
        mel = torch.zeros(1, frames * frame_mel, bins)
        ears = torch.zeros(1, frames, 1)
        seq = torch.full((1,), frames, dtype=torch.int64)
        return _count(lambda: net(ears, mel, seq))


def train_step_flops(ngf: int, ndf: int, batch: int, size: int) -> int:
    """One PixRefer D-then-G step at ``batch`` rows of ``size``²: G's
    forward, D three times and its backward, D on the fake again, the VGG
    trunk twice to conv3_3 and G's backward through them."""
    with torch.device("meta"):
        gen, disc = nets.PixReferNet(ngf), nets.Discriminator(ndf)
        vgg = nets.VGG16Features()
        x6 = torch.zeros(batch, size, size, 6)
        x3 = torch.zeros(batch, size, size, 3)

        def step():
            outputs, alphas, fg = gen(x6, x6, x3)
            real = (disc(x6[..., 3:], x6[..., 3:])
                    + disc(x6[..., :3], x6[..., :3])) / 2.0
            d_loss = nets.discriminator_loss(real, disc(x6[..., 3:],
                                                        fg.detach()))
            d_loss.backward(inputs=list(disc.parameters()))
            perc = nets.perceptual_loss(vgg, x6[..., 3:], fg)
            g_loss = nets.generator_loss(disc(x6[..., 3:], fg), x3, outputs,
                                         alphas, x3, perc, 1.0, 500.0)
            g_loss.backward(inputs=list(gen.parameters()))

        return _count(step)


def layer_flops(kind: str, b: int, h_in: int, c_in: int, c_out: int) -> float:
    """2 x MACs of a 4x4 stride-2 (transposed) conv at batch ``b``: 16
    c_in c_out per pixel of the small side."""
    small = h_in // 2 if kind == "conv" else h_in
    return 2.0 * b * small * small * 16 * c_in * c_out


def gen_spec(ngf: int, s: int):
    """(kind, h_in, c_in, c_out) of every conv of the generator."""
    spec = [("conv", s, 6, ngf)]
    enc = ((ngf, ngf * 2), (ngf * 2, ngf * 2), (ngf * 2, ngf * 4))
    h = s // 2
    for ci, co in enc:
        spec.append(("conv", h, ci, co))
        h //= 2
    spec.append(("conv", s, 3, ngf))
    h = s // 2
    for ci, co in enc:
        spec.append(("conv", h, ci, co))
        h //= 2
    h = s // 16
    for ci, co in ((ngf * 8, ngf * 4), (ngf * 4, ngf * 8),
                   (ngf * 8, ngf * 8), (ngf * 8, ngf * 8)):
        spec.append(("conv", h, ci, co))
        h //= 2
    h = s // 256
    for ci, co in ((ngf * 8, ngf * 8), (ngf * 16, ngf * 8),
                   (ngf * 16, ngf * 4), (ngf * 8, ngf * 4),
                   (ngf * 8, ngf * 2), (ngf * 4, ngf * 2), (ngf * 4, ngf)):
        spec.append(("deconv", h, ci, co))
        h *= 2
    spec.append(("deconv", h, ngf * 2, 4))
    return spec


def generator_layer_flops(ngf: int, batch: int, size: int) -> float:
    return sum(layer_flops(k, batch, h, ci, co)
               for k, h, ci, co in gen_spec(ngf, size))
