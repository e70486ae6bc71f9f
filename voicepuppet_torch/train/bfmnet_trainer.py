"""BFMNet trainer, data-parallel over a ``parallel.mesh.DataGroup`` (port
of ``voicepuppet_tpu/train/bfmnet_trainer.py``:37-293; ref:
voicepuppet/bfmnet/train_bfmnet.py:112-145).

The step: a train-mode forward (batch-moment BN updating its running
moments; dropout from the caller's ``torch.Generator``), the vertex-space
loss plus the backbone L2 regularizer, the backward, then the optimizer
(clip by global norm 50, then Adam).  ``fit`` keeps the reference loop:
one metrics row per step, eval with the rendered coefficient grid every
``eval_interval`` steps, a checkpoint every ``save_interval`` steps, both
firing on interval *crossings* so ``steps_per_call`` K > 1 never steps
over a boundary.  ``train_multi_step`` runs K steps whose metrics stay
on the device and are fetched once per call — the counterpart of the JAX
trainer's ``lax.scan`` dispatch.

Data parallelism (``mesh``, the JAX trainer's ``mesh=``): the global
batch is ``mesh_global_batch`` of the configured one, and each rank's
step takes its rows of it (``parallel.mesh.shard_batch``, or
``prefetch_to_device(mesh=)`` and ``shard_batch_local`` as a per-rank
feed).  Each rank runs the forward with sync-BN (``layers.sync_bn``),
back-propagates its own mean loss, averages the gradients once
(``all_reduce_grads_``) and only then clips and steps, so every rank's
update is the same.  Dropout draws from ``rank_generator``.  Rank 0
alone logs, runs the eval grid (running moments, no collective) and
writes checkpoints; the others wait at a barrier.  With no mesh, or a group of one rank, the step is
the single-device step, bit for bit.

Float32 training turns TF32 off (``full_fp32_matmuls``), as the JAX
trainer trains in full float32.

CLI: ``python -m voicepuppet_torch.train.bfmnet_trainer --config_path
<yml> [--steps N] [--steps_per_call K] [--device cuda|cpu]``, on N cards
``torchrun --nproc_per_node N -m voicepuppet_torch.train.bfmnet_trainer
...`` (each rank on ``cuda:LOCAL_RANK``, NCCL; gloo with ``--device
cpu``).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.config import Config
from voicepuppet_torch.models.bfmnet import (BFMNet, BFMNetLoss,
                                             init_bfmnet_, make_mouth_mask,
                                             total_loss)
from voicepuppet_torch.models.layers import sync_bn
from voicepuppet_torch.parallel.mesh import (DataGroup, all_reduce_grads_,
                                             group_of, mesh_global_batch,
                                             pmean_metric, rank_generator,
                                             replicate)
from voicepuppet_torch.train.optim import bfmnet_optimizer, global_norm
from voicepuppet_torch.train.state import TrainState


def batch_to_device(batch, device: torch.device):
    """A batch of numpy arrays or tensors -> tensors on ``device``."""
    return tuple(torch.as_tensor(b).to(device) for b in batch)


class BFMNetTrainer:
    """``tx``: a factory, parameters -> optimizer (default: the reference
    Adam of ``train/optim.py``); the parity tests pass SGD.  ``mesh``: the
    data group (None: this process alone, on ``device``); with one, the
    rank's device is ``mesh.device``."""

    def __init__(self, cfg: Config, face_model,
                 mouth_idx: Optional[np.ndarray] = None, tx=None,
                 device="cuda", mesh: Optional[DataGroup] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        mouth_mask = make_mouth_mask(face_model.num_vertices, mouth_idx,
                                     cfg.bfmnet.mouth_weight)
        self.loss_fn = BFMNetLoss(face_model.exBase, mouth_mask, self.device)
        # the reference's batch (train_bfmnet.py:43) rounded up to the group
        self.global_batch = mesh_global_batch(cfg.bfmnet.batch_size, mesh)
        self.tx = tx if tx is not None else bfmnet_optimizer(
            cfg.bfmnet.training)

    # ---- state ----
    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights drawn from ``torch.Generator().manual_seed(seed)``
        on the CPU, then moved to the device (and broadcast from rank 0)."""
        model = init_bfmnet_(BFMNet(self.cfg.bfmnet),
                             torch.Generator().manual_seed(seed))
        model.to(self.device)
        replicate([model], self.mesh)
        return TrainState(model, self.tx(model.parameters()))

    # ---- the step ----
    def loss(self, state: TrainState, batch,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The train-mode loss of ``batch``, this rank's rows (updates the
        BN running moments as a side effect, as the step does)."""
        coeff, ears, mfccs, seq_len = batch_to_device(batch, self.device)
        with sync_bn(group_of(self.mesh), state.model):
            out = state.model(ears, mfccs, seq_len, train=True,
                              generator=generator)
        return total_loss(state.model, self.loss_fn, out, coeff, seq_len)

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step on ``batch``, this rank's rows of the global
        batch (``parallel.mesh.shard_batch``); returns (state, {"loss",
        "grad_norm"}) with device scalars: the loss averaged over the
        ranks, the norm of the averaged gradient (the same on every rank)
        before clipping."""
        loss = self.loss(state, batch, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = list(state.model.parameters())
        all_reduce_grads_(params, group_of(self.mesh))
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": pmean_metric(loss.detach(), self.mesh),
                       "grad_norm": grad_norm}

    def train_multi_step(self, state: TrainState, batches,
                         generator: Optional[torch.Generator] = None):
        """K sequential steps with no host sync; every metric gains a
        leading [K] axis (still on the device)."""
        rows = [self.train_step(state, b, generator)[1] for b in batches]
        return state, {k: torch.stack([r[k] for r in rows])
                       for k in rows[0]}

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch):
        """(loss, coefficients) with the running BN moments, no dropout and
        no regularizer."""
        coeff, ears, mfccs, seq_len = batch_to_device(batch, self.device)
        out = state.model(ears, mfccs, seq_len, train=False)
        return self.loss_fn(out, coeff, seq_len), out

    # ---- loop (ref: train_bfmnet.py:112-145) ----
    def fit(self, state: TrainState, batches: Iterator, num_steps: int,
            eval_batches: Optional[Iterator] = None, logger=None,
            ckpt=None, eval_hook: Optional[Callable] = None, seed: int = 0,
            steps_per_call: int = 1, profiler=None) -> TrainState:
        """``steps_per_call`` K packs K steps into each call of
        ``train_multi_step``; eval and checkpoint fire when a call crosses
        an interval, at most once per call (K larger than an interval
        coarsens that cadence, with a warning).  K = 1 is the reference
        loop exactly.  Under a mesh each ``batches`` item is this rank's
        rows of a global batch (``prefetch_to_device(mesh=...)``); rank 0
        alone logs and evaluates."""
        main = self.mesh is None or self.mesh.is_main
        generator = rank_generator(
            seed, 0 if self.mesh is None else self.mesh.rank, self.device)
        tcfg = self.cfg.bfmnet.training
        k = max(1, int(steps_per_call))
        if k > 1:
            for label, iv in (("eval_interval", tcfg.eval_interval
                               if eval_batches is not None else None),
                              ("save_interval",
                               ckpt.save_interval if ckpt else None)):
                if iv and k > iv:
                    warnings.warn(f"steps_per_call={k} exceeds {label}={iv}:"
                                  " that cadence coarsens to once per call")
        done = 0
        while done < num_steps:
            if profiler is not None:
                profiler.step(state.step)
            kk = min(k, num_steps - done)
            state, stacked = self.train_multi_step(
                state, [next(batches) for _ in range(kk)], generator)
            done += kk
            step = state.step
            if logger is not None and main:
                keys = list(stacked)
                vals = torch.stack([stacked[n].float() for n in keys],
                                   1).cpu().numpy()
                for i, row in enumerate(vals):
                    logger.log(step - kk + i + 1,
                               **dict(zip(keys, map(float, row))))
            if eval_batches is not None and (
                    step // tcfg.eval_interval
                    > (step - kk) // tcfg.eval_interval):
                if main:
                    eval_batch = next(eval_batches)
                    eval_loss, eval_out = self.eval_loss(state, eval_batch)
                    if logger is not None:
                        logger.log(step, eval_loss=eval_loss)
                    if eval_hook is not None:
                        eval_hook(step, state, eval_batch, eval_out)
                if self.mesh is not None:
                    self.mesh.barrier()
            if ckpt is not None and step > 0 and (
                    step // ckpt.save_interval
                    > (step - kk) // ckpt.save_interval):
                ckpt.save(step, state)
        if profiler is not None:
            profiler.close()
        return state


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.data.generators import (BFMNetBatcher,
                                                   FileSource,
                                                   prefetch_to_device)
    from voicepuppet_torch.face3d import morph
    from voicepuppet_torch.face3d.bfm import load_bfm, synthetic_bfm
    from voicepuppet_torch.parallel.mesh import make_mesh
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import (MetricsLogger,
                                                 add_profiler_args,
                                                 profiler_from_args)
    from voicepuppet_torch.utils.viz import plot_bfm_coeff_seq

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--ckpt_dir", default="ckpt_bfmnet")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="run K steps per call with their metrics kept on "
                        "the device and fetched once; the same math per "
                        "step and the same dropout stream")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    add_profiler_args(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = make_mesh(args.device)
    device = mesh.device
    face_model = (load_bfm(cfg.model_dir)
                  if os.path.exists(os.path.join(cfg.model_dir,
                                                 "BFM_model_front.mat"))
                  else synthetic_bfm())
    mouth_path = os.path.join(cfg.model_dir, "mouth_idx.npy")
    mouth_idx = np.load(mouth_path) if os.path.exists(mouth_path) else None

    trainer = BFMNetTrainer(cfg, face_model, mouth_idx, mesh=mesh)
    tcfg = cfg.bfmnet.training
    ckpt = CheckpointManager(args.ckpt_dir, tcfg.max_to_keep,
                             tcfg.save_interval, mesh=mesh)
    state = ckpt.restore(trainer.init_state())
    logger = MetricsLogger(args.log_dir, "bfmnet") if mesh.is_main else None
    batcher = BFMNetBatcher(
        cfg, FileSource(cfg.dataset.train_dataset_path, cfg),
        batch_size=trainer.global_batch, device=device)
    eval_batcher = BFMNetBatcher(
        cfg, FileSource(cfg.dataset.eval_dataset_path, cfg), shuffle=False,
        device=device)

    # the rendered eval grid at eval cadence (train_bfmnet.py:130-138)
    eval_dir = os.path.join(args.log_dir, "eval_bfmnet")
    fm = morph.device_bfm(face_model, device)

    def eval_hook(step, _state, batch, eval_out):
        plot_bfm_coeff_seq(eval_dir, step, np.asarray(batch[0][0]),
                           eval_out[0].cpu().numpy(), fm)

    steps = args.steps if args.steps is not None else tcfg.epochs
    trainer.fit(state, prefetch_to_device(iter(batcher), device, mesh=mesh),
                steps, iter(eval_batcher), logger, ckpt, eval_hook=eval_hook,
                steps_per_call=args.steps_per_call,
                profiler=profiler_from_args(args) if mesh.is_main else None)
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
