"""Optimizers matching the reference trainers (port of
``voicepuppet_tpu/train/optim.py``).

BFMNet (bfmnet.py:307-318): Adam on a staircase exponential-decay
schedule, the gradients first clipped by their global norm 50.
PixRefer (pixrefer.py:396-407): two Adams with beta1 0.5 on a shared
decay schedule, no clipping.

:class:`ReferenceAdam` computes what optax's
``chain(clip_by_global_norm(max), adam(schedule, b1))`` computes, in
optax's order of operations:

  * clip: ``g`` below the threshold, else ``(g / ||g||) * max`` — the
    function ``g * max / max(||g||, max)`` with optax's rounding (not
    ``clip_grad_norm_``'s ``max / (||g|| + 1e-6)``);
  * ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g² + b2 nu``, ``n += 1``;
  * ``u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)``;
  * ``p += -lr(n - 1) * u`` — the schedule is read at the optimizer's own
    update count before the increment, as ``scale_by_schedule`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def exponential_decay_schedule(learning_rate: float, decay_steps: int,
                               decay_rate: float) -> Callable[[int], float]:
    """``tf.train.exponential_decay(staircase=True)`` (ref:
    bfmnet.py:308-309): ``lr * rate ** floor(n / decay_steps)``."""
    if decay_rate == 1.0:
        return lambda n: learning_rate
    return lambda n: learning_rate * decay_rate ** math.floor(
        n / decay_steps)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum_i ||t_i||²)`` over a list of tensors, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


class ReferenceAdam(torch.optim.Optimizer):
    """Clip-by-global-norm (``max_grad_norm`` > 0) then Adam, b2 0.999,
    eps 1e-8, on ``schedule(count)``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: float = 0.0):
        super().__init__(params, dict(beta1=beta1, beta2=beta2, eps=eps,
                                      max_grad_norm=max_grad_norm,
                                      count=0))
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            max_norm = group["max_grad_norm"]
            if max_norm and max_norm > 0:
                # optax's where(norm < max, g, (g / norm) * max), as a
                # divide and a multiply by device scalars that are 1
                # below the threshold (no host sync)
                norm = global_norm(grads)
                below = norm < max_norm
                one = torch.ones_like(norm)
                grads = torch._foreach_div(grads, torch.where(below, one,
                                                              norm))
                torch._foreach_mul_(grads, torch.where(below, one,
                                                       one * max_norm))
            b1, b2, eps = group["beta1"], group["beta2"], group["eps"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            lr = self.schedule(group["count"])
            group["count"] += 1
            n = group["count"]
            # b * m + (1 - b) * g, each product rounded, as optax's
            # update_moment
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            # the bias corrections in float32, as optax computes them
            bc1 = float(1.0 - torch.tensor(b1) ** n)
            bc2 = float(1.0 - torch.tensor(b2) ** n)
            mu_hat = torch._foreach_div(mus, bc1)
            nu_hat = torch._foreach_div(nus, bc2)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
        return None


def reference_adam(learning_rate: float, decay_steps: int = 1000,
                   decay_rate: float = 1.0, beta1: float = 0.9,
                   max_grad_norm: float = 0.0
                   ) -> Callable[[Iterable[torch.Tensor]], ReferenceAdam]:
    """A factory: parameters -> :class:`ReferenceAdam` on the staircase
    schedule."""
    sched = exponential_decay_schedule(learning_rate, decay_steps,
                                       decay_rate)
    return lambda params: ReferenceAdam(params, sched, beta1=beta1,
                                        max_grad_norm=max_grad_norm)


def bfmnet_optimizer(training_cfg):
    """ref: bfmnet.py:307-318, defaults from bfmnet.py:153-155."""
    return reference_adam(training_cfg.learning_rate,
                          training_cfg.decay_steps, training_cfg.decay_rate,
                          beta1=training_cfg.beta1,
                          max_grad_norm=training_cfg.max_grad_norm)


def gan_optimizer(training_cfg):
    """ref: pixrefer.py:396-407 (Adam, beta1 .5, exp decay, no clip).

    The reference's D and G optimizers share one global_step that both
    increment, so it advances 2 per iteration while each optimizer here
    counts 1: halving ``decay_steps`` gives the reference's staircase
    exactly (D reads floor(2N/1000) == floor(N/500), and G
    floor((2N+1)/1000) == floor(N/500))."""
    return reference_adam(training_cfg.learning_rate,
                          max(1, training_cfg.decay_steps // 2),
                          training_cfg.decay_rate, beta1=training_cfg.beta1,
                          max_grad_norm=0.0)
