"""Operation counts of the reference PixFlow training step at a cell's
shapes, by ``FlopCounterMode`` on the meta device: G three times over
(D's constant without a graph, G's loss forward, its backward), D twice
forward and backward for its own loss and once forward and back to its
input for G's loss.  The counter attributes each operation, backward
included, to the module that ran it, which gives the G and D parts."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets, pixflow_train


def step_flops_by_part(ngf: int, ndf: int, batch: int,
                       size: int) -> Dict[str, int]:
    """{"step", "gen", "disc"}: one D-then-G step at ``batch`` rows of
    ``size``², the whole and its G and D parts."""
    p = {"gan_weight": 1.0, "l1_weight": 500.0}
    with torch.device("meta"):
        gen = pixflow_train.PixFlowTrainNet(ngf)
        disc = nets.Discriminator(ndf)
        x6 = torch.zeros(batch, size, size, 6)
        x3 = torch.zeros(batch, size, size, 3)
        counter = FlopCounterMode(display=False)
        with counter:
            pixflow_train.step_losses(gen, disc, (x6, x6, x3), None, p)
    counts = {k: sum(v.values()) for k, v in
              counter.get_flop_counts().items()}
    return {"step": int(counter.get_total_flops()),
            "gen": int(counts.get(type(gen).__name__, 0)),
            "disc": int(counts.get(type(disc).__name__, 0))}


def step_flops(ngf: int, ndf: int, batch: int, size: int) -> int:
    return step_flops_by_part(ngf, ndf, batch, size)["step"]
