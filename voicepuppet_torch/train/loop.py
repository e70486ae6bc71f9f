"""The reference training loop shared by the trainers whose ``fit`` is
one ``train_step`` per batch (PixFlow, ATNet, VGNet)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

from voicepuppet_torch.parallel.mesh import rank_generator
from voicepuppet_torch.weights import flax_paths


def flax_gradients(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{JAX path joined by "/": gradient}`` of ``module``'s parameters
    that hold one (the tags of the JAX fits' gradient histograms); the
    gradients stay where they are."""
    params = dict(module.named_parameters())
    return {"/".join(path): params[key].grad
            for key, path in flax_paths(module).items()
            if params[key].grad is not None}


class StepLoop:
    """Mixin: ``fit`` over ``self.train_step(state, batch, generator)``,
    ``self.device`` and ``self.mesh`` (a ``parallel.mesh.DataGroup``;
    None: one process).  ``step_stride``: the global steps one
    ``train_step`` advances (its own ``state.step`` increment reads it).
    A trainer with gradient histograms defines ``gradient_groups(state)
    -> (groups, exclude)`` for ``MetricsLogger.log_histograms`` and sets
    ``log_gradients`` (None: ask the logger's ``wants_histograms``)."""

    mesh = None
    step_stride = 1
    log_gradients: Optional[bool] = None
    gradient_groups = None

    def fit(self, state, batches: Iterator, num_steps: int, logger=None,
            ckpt=None, profiler=None):
        """One step per batch, one metrics row per step, a checkpoint at
        exact multiples of ``save_interval``; the dropout masks come from
        one generator seeded with 0 on the trainer's device
        (``rank_generator``: each rank its own).  Under a mesh rank 0
        alone logs, the gradient histograms from the gradients the step
        left in ``.grad`` (averaged over the ranks).  The profiler is
        closed however the loop ends."""
        rank = 0 if self.mesh is None else self.mesh.rank
        generator = rank_generator(0, rank, self.device)
        log = logger is not None and rank == 0
        histograms = log and self.gradient_groups is not None and (
            self.log_gradients if self.log_gradients is not None
            else getattr(logger, "wants_histograms", False))
        try:
            for _ in range(num_steps):
                if profiler is not None:
                    profiler.step(state.step, self.step_stride)
                state, metrics = self.train_step(state, next(batches),
                                                 generator)
                if log:
                    logger.log(state.step, **metrics)
                if histograms and logger.histogram_due(state.step):
                    logger.log_histograms(state.step,
                                          *self.gradient_groups(state))
                if ckpt is not None and state.step % ckpt.save_interval == 0:
                    ckpt.save(state.step, state)
        finally:
            if profiler is not None:
                profiler.close()
        return state
