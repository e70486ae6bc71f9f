"""Train states (port of ``voicepuppet_tpu/train/state.py``).

The reference keeps its training state implicit in the TF1 graph
(global_step, optimizer slots, batch-norm moving moments; bfmnet.py:307,
train_bfmnet.py:94-96).  Here it is one plain object per model: the
step, the module(s) — their parameters and BN buffers — and the
optimizer(s).  ``state_dict`` / ``load_state_dict`` are what
``train/checkpoint.py`` saves and restores.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


class TrainState:
    """Single-optimizer state (BFMNet): ``step`` counts optimizer
    updates."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.step = step
        self.model = model
        self.optimizer = optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, blob: Dict[str, Any]):
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.step = int(blob["step"])


class GANTrainState:
    """Two-optimizer GAN state (PixRefer).  The reference steps D then G
    each iteration and both optimizers increment one shared global_step
    (pixrefer.py:396-407), so ``step`` advances by 2 per iteration.  The
    updates themselves live in the trainer's step (D first, then G through
    the updated D); a combined helper here would get the order wrong."""

    def __init__(self, gen: torch.nn.Module, disc: torch.nn.Module,
                 g_optimizer: torch.optim.Optimizer,
                 d_optimizer: torch.optim.Optimizer, step: int = 0):
        self.step = step
        self.gen = gen
        self.disc = disc
        self.g_optimizer = g_optimizer
        self.d_optimizer = d_optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "gen": self.gen.state_dict(),
                "disc": self.disc.state_dict(),
                "g_optimizer": self.g_optimizer.state_dict(),
                "d_optimizer": self.d_optimizer.state_dict()}

    def load_state_dict(self, blob: Dict[str, Any]):
        self.gen.load_state_dict(blob["gen"])
        self.disc.load_state_dict(blob["disc"])
        self.g_optimizer.load_state_dict(blob["g_optimizer"])
        self.d_optimizer.load_state_dict(blob["d_optimizer"])
        self.step = int(blob["step"])
