"""The reference training loop shared by the trainers whose ``fit`` is
one ``train_step`` per batch (PixFlow, ATNet, VGNet)."""

from __future__ import annotations

from typing import Iterator

import torch


class StepLoop:
    """Mixin: ``fit`` over ``self.train_step(state, batch, generator)``
    and ``self.device``."""

    def fit(self, state, batches: Iterator, num_steps: int, logger=None,
            ckpt=None, profiler=None):
        """One step per batch, one metrics row per step, a checkpoint at
        exact multiples of ``save_interval``; the dropout masks come from
        one generator seeded with 0 on the trainer's device."""
        generator = torch.Generator(self.device).manual_seed(0)
        for _ in range(num_steps):
            if profiler is not None:
                profiler.step(state.step)
            state, metrics = self.train_step(state, next(batches), generator)
            if logger is not None:
                logger.log(state.step, **metrics)
            if ckpt is not None and state.step % ckpt.save_interval == 0:
                ckpt.save(state.step, state)
        if profiler is not None:
            profiler.close()
        return state
