"""Operation counts of the reference PixFlow generator at a cell's shapes,
by ``FlopCounterMode`` on the meta device (``flops._count``), split as
serving computes it: the part every frame of a call shares under
per-frame moments (the foreground encoder, ``diffnet`` on the reference
render and ``pre_resnet``) and the part each frame runs (``diffnet`` on
its render, ``diff_resnet``, ``post_resnet`` and the decoder).  The
whole generator on one frame is their sum."""

from __future__ import annotations

import torch

from benchmark.flops import _count
from benchmark.reference import pixflow


def per_call_flops(ngf: int, size: int) -> int:
    """The shared part, once (batch 1)."""
    with torch.device("meta"):
        g = pixflow.Generator(ngf)
        x = torch.zeros(1, 3, size, size)

        def part():
            g.pre_resnet_2(g.pre_resnet_1(g.encoder_net(x)))
            g.diffnet(x)

        return _count(part)


def per_frame_flops(ngf: int, batch: int, size: int) -> int:
    """The per-frame part at ``batch`` frames."""
    with torch.device("meta"):
        g = pixflow.Generator(ngf)
        x = torch.zeros(batch, 3, size, size)

        def part():
            d = g.diffnet(x)
            d = g.diff_resnet_2(g.diff_resnet_1(d))
            h = g.post_resnet_2(g.post_resnet_1(d))
            for i in range(3):
                h = getattr(g, f"StatelessBatchNorm_{i}")(
                    getattr(g, f"decoder_{i}")(h))
            g.final7(h)

        return _count(part)


def generator_flops(ngf: int, batch: int, size: int) -> int:
    """The whole generator's forward at ``batch`` frames."""
    with torch.device("meta"):
        g = pixflow.Generator(ngf)
        x = torch.zeros(batch, size, size, 6)
        fg = torch.zeros(batch, size, size, 3)
        return _count(lambda: g(x, fg))
