"""Two-process dryrun of the multi-host data path and of the checkpoint
roundtrip across a restart (port of ``experiments/dryrun_multihost.py``).

Two gloo ranks on the CPU each feed ONLY their local rows of an 8-row
least-squares batch through ``local_batch_rows`` and
``shard_batch_local``, back-propagate their own mean loss and average the
gradients with ``all_reduce_grads_`` — the trainers' idiom.  Every step's
weights must equal the analytic full-batch gradient-descent trajectory
(``_analytic_weights``), so a dropped or doubled reduction (gradients off
by 2x) fails.  Then rank 0 saves through ``train.checkpoint.
CheckpointManager``; a fresh group restores into a zeroed state, must
hold the same trajectory's weights, and one more step must land on the
next point of it.

Run: ``python -m voicepuppet_torch.experiments.dryrun_multihost``; it
prints ``MULTIHOST DRYRUN OK`` and ``MULTIHOST CKPT ROUNDTRIP OK`` and
exits 0 when every check passes.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

N_PROC = 2
TRAIN_STEPS = 3
LR = 0.1
ATOL, RTOL = 1e-6, 1e-5


def _analytic_weights(x: np.ndarray, y: np.ndarray, steps: int
                      ) -> np.ndarray:
    """Single-process full-batch GD on ``mean((x w - y)²)`` from w = 0."""
    w = np.zeros((x.shape[1], 1), np.float64)
    for _ in range(steps):
        w = w - LR * (2.0 / x.shape[0] * x.T @ (x @ w - y))
    return w


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randn(8, 1).astype(np.float32))


class _State:
    """The smallest train state ``CheckpointManager`` takes."""

    def __init__(self, w: torch.Tensor, step: int = 0):
        self.w, self.step = w, step

    def state_dict(self):
        return {"w": self.w.detach().clone(), "step": self.step}

    def load_state_dict(self, blob):
        with torch.no_grad():
            self.w.copy_(blob["w"])
        self.step = int(blob["step"])


def _step(state: _State, batch, mesh):
    from voicepuppet_torch.parallel.mesh import (all_reduce_grads_,
                                                 pmean_metric)
    bx, by = batch
    state.w.grad = None
    err = bx @ state.w - by
    loss = (err * err).mean()
    loss.backward()
    all_reduce_grads_([state.w], mesh.group)
    with torch.no_grad():
        state.w -= LR * state.w.grad
    state.step += 1
    return float(pmean_metric(loss.detach(), mesh))


def _local_batch(mesh):
    from voicepuppet_torch.parallel.mesh import (local_batch_rows,
                                                 shard_batch_local)
    x, y = _data()
    rows = local_batch_rows(x.shape[0], mesh)
    lo = mesh.rank * rows
    return shard_batch_local((x[lo:lo + rows], y[lo:lo + rows]), mesh), x, y


def _check(w: torch.Tensor, x, y, steps: int, what: str):
    np.testing.assert_allclose(w.detach().numpy(),
                               _analytic_weights(x, y, steps), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def rank_save(mesh, ckpt_dir: str) -> str:
    """Train ``TRAIN_STEPS`` steps on the local rows, checking each
    against the analytic trajectory; rank 0 saves."""
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    batch, x, y = _local_batch(mesh)
    state = _State(torch.zeros(16, 1, requires_grad=True))
    for k in range(TRAIN_STEPS):
        loss = _step(state, batch, mesh)
        _check(state.w, x, y, k + 1, f"rank {mesh.rank} step {k + 1}")
    CheckpointManager(ckpt_dir, save_interval=1, mesh=mesh).save(
        TRAIN_STEPS, state)
    return f"rank {mesh.rank}: loss {loss:.6f}, saved step {TRAIN_STEPS}"


def rank_restore(mesh, ckpt_dir: str) -> str:
    """Restore into a zeroed state, check it, and take one more step."""
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    batch, x, y = _local_batch(mesh)
    mgr = CheckpointManager(ckpt_dir, save_interval=1, mesh=mesh)
    if mgr.latest_step() != TRAIN_STEPS:
        raise AssertionError(f"latest step {mgr.latest_step()}")
    state = mgr.restore(_State(torch.zeros(16, 1, requires_grad=True)))
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"restored step {state.step}")
    _check(state.w, x, y, TRAIN_STEPS, f"rank {mesh.rank} restored")
    _step(state, batch, mesh)
    _check(state.w, x, y, TRAIN_STEPS + 1, f"rank {mesh.rank} step after")
    return f"rank {mesh.rank}: restore OK (step {TRAIN_STEPS})"


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Both groups in turn; 0 when every check passed."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a group may take")
    args = p.parse_args(argv)
    from voicepuppet_torch.parallel.spawn import run_ranks
    ok = ok2 = False
    with tempfile.TemporaryDirectory() as ckpt_dir:
        try:
            for line in run_ranks(rank_save, N_PROC, ckpt_dir,
                                  timeout=args.timeout):
                print(line, flush=True)
            ok = True
        except RuntimeError as exc:
            print(exc, flush=True)
        print("MULTIHOST DRYRUN OK" if ok else "MULTIHOST DRYRUN FAILED",
              flush=True)
        if ok:
            try:
                for line in run_ranks(rank_restore, N_PROC, ckpt_dir,
                                      timeout=args.timeout):
                    print(line, flush=True)
                ok2 = True
            except RuntimeError as exc:
                print(exc, flush=True)
        print("MULTIHOST CKPT ROUNDTRIP OK" if ok2
              else "MULTIHOST CKPT ROUNDTRIP FAILED", flush=True)
    return 0 if ok and ok2 else 1


if __name__ == "__main__":
    sys.exit(main())
