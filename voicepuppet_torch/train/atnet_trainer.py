"""ATNet trainer, data-parallel over a ``parallel.mesh.DataGroup`` (port of
``voicepuppet_tpu/train/atnet_trainer.py``:27-195; ref:
voicepuppet/atvgnet/atnet.py:281-312, train_atnet.py:106-141).

The BFMNet trainer's single-optimizer step on the landmark task: a
train-mode forward (batch-moment BN moving its running moments, the GRU's
dropout from the caller's ``torch.Generator``), the masked frame loss
plus the temporal loss plus the backbone's L2 regularizer, the backward,
then the reference Adam (clip by global norm, then Adam on the staircase
schedule).  The batch is ``data.generators.ATNetBatcher``'s: (landmark
[B,T,136], ears [B,T,1], poses [B,T,3], mfccs [B,T*5,80], example
landmark [B,136], seq_len [B]).

Gradient histograms (``log_gradients``; None asks the logger): ``fit``
writes the gradients as ``atnet/<flax path>/gradients`` at the logger's
cadence, the batch norms' left out (train_atnet.py:96-101).

Data parallelism (``mesh``): as the BFMNet trainer's (sync-BN forward on
this rank's rows, one gradient average before clip and Adam, the loss
averaged over the ranks, rank 0 alone logging and saving).

CLI: ``python -m voicepuppet_torch.train.atnet_trainer --config_path
<yml> [--steps N] [--device cuda|cpu]`` (on N cards under ``torchrun
--nproc_per_node N``).  The landmark PCA assets load
from ``<model_dir>/lmk_mean.npy`` and ``lmk_components.npy`` when present
(the reference names them through hparams its config never defines);
otherwise a zero mean and ``models.atnet.synthetic_pca_component``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.config import Config
from voicepuppet_torch.models.atnet import (ATNet, atnet_loss,
                                            synthetic_pca_component)
from voicepuppet_torch.models.layers import (init_flax_like_,
                                             l2_regularization, sync_bn)
from voicepuppet_torch.parallel.mesh import (DataGroup, all_reduce_grads_,
                                             group_of, mesh_global_batch,
                                             pmean_metric, replicate)
from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
from voicepuppet_torch.train.loop import StepLoop, flax_gradients
from voicepuppet_torch.train.optim import reference_adam
from voicepuppet_torch.train.state import TrainState


def load_pca_assets(model_dir: str, landmark_size: int = 136,
                    components: int = 6):
    """(mean [136], component [K, 136]) from ``model_dir``, or a zero mean
    and the synthetic basis."""
    mean_path = os.path.join(model_dir, "lmk_mean.npy")
    comp_path = os.path.join(model_dir, "lmk_components.npy")
    mean = (np.load(mean_path) if os.path.exists(mean_path)
            else np.zeros((landmark_size,), np.float32))
    comp = (np.load(comp_path) if os.path.exists(comp_path)
            else synthetic_pca_component(components, landmark_size))
    return mean, comp


class ATNetTrainer(StepLoop):
    """``tx``: a factory, parameters -> optimizer (default: the reference
    Adam with the config's schedule and clip); the parity tests pass
    SGD.  ``mesh``: the data group (None: this process alone, on
    ``device``).  ``log_gradients``: True or False turns ``fit``'s
    gradient histograms on or off; None asks the logger."""

    def __init__(self, cfg: Config, pca_component: np.ndarray,
                 width_mult: float = 1.0, tx=None, device="cuda",
                 mesh: Optional[DataGroup] = None,
                 log_gradients: Optional[bool] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.log_gradients = log_gradients
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        self.pca_component = pca_component
        self.width_mult = width_mult
        # the reference's batch 16 (train_atnet.py:41) rounded up
        self.global_batch = mesh_global_batch(cfg.atnet.batch_size, mesh)
        t = cfg.atnet.training
        self.tx = tx if tx is not None else reference_adam(
            t.learning_rate, t.decay_steps, t.decay_rate,
            max_grad_norm=t.max_grad_norm)

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights with the JAX init's distributions (xavier-uniform
        kernels, orthogonal GRU kernels with gate bias 1.0) from
        ``torch.Generator().manual_seed(seed)`` on the CPU, moved to the
        device."""
        model = init_flax_like_(ATNet(self.cfg.atnet, self.pca_component,
                                      self.width_mult),
                                torch.Generator().manual_seed(seed))
        model.to(self.device)
        replicate([model], self.mesh)
        return TrainState(model, self.tx(model.parameters()))

    def loss(self, state: TrainState, batch,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The train-mode loss of ``batch``, this rank's rows (moves the
        BN running moments, as the step does)."""
        landmark, ears, poses, mfccs, example, seq_len = batch_to_device(
            batch, self.device)
        with sync_bn(group_of(self.mesh), state.model):
            out = state.model(ears, poses, mfccs, example, seq_len,
                              train=True, generator=generator)
        return (atnet_loss(out, landmark, seq_len)
                + l2_regularization(state.model))

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        """One optimizer step on ``batch``, this rank's rows of the global
        batch (``parallel.mesh.shard_batch``); returns (state, {"loss"}),
        the loss averaged over the ranks, as a device scalar."""
        loss = self.loss(state, batch, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(state.model.parameters(), group_of(self.mesh))
        state.optimizer.step()
        state.step += self.step_stride
        return state, pmean_metric({"loss": loss.detach()}, self.mesh)

    def gradient_groups(self, state: TrainState):
        """The last step's gradients for the histograms, the batch norms'
        excluded as the reference does."""
        return {"atnet": flax_gradients(state.model)}, ("BatchNorm", "bn")

    @torch.no_grad()
    def infer(self, state: TrainState, ears, poses, mfccs, example_lmk,
              seq_len) -> torch.Tensor:
        """Landmarks [B,T,136] with the running BN moments, no dropout."""
        args = batch_to_device((ears, poses, mfccs, example_lmk, seq_len),
                               self.device)
        return state.model(*args, train=False)


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.data.generators import (ATNetBatcher, FileSource,
                                                   prefetch_to_device)
    from voicepuppet_torch.parallel.mesh import make_mesh
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import (MetricsLogger,
                                                 add_profiler_args,
                                                 profiler_from_args)

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--ckpt_dir", default="ckpt_atnet")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    add_profiler_args(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = make_mesh(args.device)
    device = mesh.device
    pca_mean, pca_component = load_pca_assets(
        cfg.model_dir, cfg.atnet.landmark_size, cfg.atnet.pca_components)
    trainer = ATNetTrainer(cfg, pca_component, mesh=mesh)
    tcfg = cfg.atnet.training
    ckpt = CheckpointManager(args.ckpt_dir, tcfg.max_to_keep,
                             tcfg.save_interval, mesh=mesh)
    state = ckpt.restore(trainer.init_state())
    logger = MetricsLogger(args.log_dir, "atnet") if mesh.is_main else None
    # the streams take the [136, K] transpose; the model keeps [K, 136]
    batcher = ATNetBatcher(cfg, FileSource(cfg.dataset.train_dataset_path,
                                           cfg),
                           pca_mean, pca_component.T,
                           batch_size=trainer.global_batch, device=device)
    steps = args.steps if args.steps is not None else tcfg.epochs
    try:
        trainer.fit(state, prefetch_to_device(iter(batcher), device,
                                              mesh=mesh),
                    steps, logger, ckpt,
                    profiler=profiler_from_args(args) if mesh.is_main
                    else None)
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
