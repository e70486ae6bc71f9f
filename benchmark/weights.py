"""Weights made from a run's seed, on the device, in one large draw: the
benchmark makes them and hands the same tensors to the system and to the
reference.  Keys and shapes come from the reference's modules built on
the meta device (the system's modules carry the same names)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn


def _rule_pix2pix(name: str, shape) -> tuple:
    """Conv kernels N(0, 0.02), biases 0, BN scales 1 + N(0, 0.02)."""
    if len(shape) >= 2:
        return "normal", 0.02, 0.0
    if name.endswith("weight"):            # a BN scale
        return "normal", 0.02, 1.0
    return "const", 0.0, 0.0


def _rule_glorot(name: str, shape) -> tuple:
    """Kernels N(0, 2 / (fan_in + fan_out)); the GRU's gate bias 1; other
    biases and BN offsets 0; running moments (0, 1)."""
    if name.endswith("running_var"):
        return "const", 0.0, 1.0
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        fan_out = shape[0] * math.prod(shape[2:])
        return "normal", math.sqrt(2.0 / (fan_in + fan_out)), 0.0
    if "ScanTFGRUCell" in name and name.endswith("Dense_0.bias"):
        return "const", 0.0, 1.0
    return "const", 0.0, 0.0


def _rule_lecun(name: str, shape) -> tuple:
    if len(shape) >= 2:
        return "normal", math.sqrt(1.0 / math.prod(shape[1:])), 0.0
    return "const", 0.0, 0.0


RULES: Dict[str, Callable] = {"pix2pix": _rule_pix2pix,
                              "glorot": _rule_glorot, "lecun": _rule_lecun}


def seeded_state(make: Callable[[], nn.Module], rule: str, seed: int,
                 stream: int, device) -> Dict[str, torch.Tensor]:
    """The state_dict of ``make()`` filled from ``(seed, stream)`` by
    ``rule``: one normal draw on ``device`` sliced over the leaves."""
    with torch.device("meta"):
        layout = {k: tuple(v.shape) for k, v in make().state_dict().items()}
    plan = {k: RULES[rule](k, shape) for k, shape in layout.items()}
    total = sum(math.prod(s) for k, s in layout.items()
                if plan[k][0] == "normal")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    draw = torch.randn(total, generator=gen, device=dev)
    out, at = {}, 0
    for k, shape in layout.items():
        kind, std, mean = plan[k]
        n = math.prod(shape)
        if kind == "normal":
            out[k] = draw[at:at + n].view(shape) * std + mean
            at += n
        else:
            out[k] = torch.full(shape, mean, device=dev)
    return out
