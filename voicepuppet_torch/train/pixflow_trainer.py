"""PixFlow GAN trainer, data-parallel over a ``parallel.mesh.DataGroup``
(port of
``voicepuppet_tpu/train/pixflow_trainer.py``:30-251; ref:
voicepuppet/pixflow/pixflow.py:314-384, train_pixflow.py).

The step of the PixRefer trainer with PixFlow's loss wiring: D updates
first on a generator output taken as a constant, then G's loss — the GAN
term through the *updated* D and the foreground and alpha L1s, no
perceptual term — updates G; ``step`` advances by 2.  G's ``ResBlock``s
drop out at 0.5 in training, so, as in the JAX step, the two G forwards
(D's constant input, then G's own loss) draw two dropout masks, here in
turn from the step's ``torch.Generator``.  D's loss has a single real
term and G's L1 target is the current foreground ``fg_inputs[..., 3:]``.
The batch is (inputs [B,S,S,6] render ref⊕cur, fg_inputs [B,S,S,6] fg
ref⊕cur, masks [B,S,S,3]) in [0, 1] (``data.generators.PixFlowBatcher``).

``train_dtype=torch.bfloat16`` runs the G and D convs in bfloat16 while
parameters, optimizer states, BN moments, losses and the tanh / sigmoid
heads stay float32.  Float32 convs and matmuls run in full float32 (TF32
off).  The optimizers are PixRefer's (``gan_optimizer``: Adam beta1 0.5,
lr 3e-4 decaying 0.999 every 1000 global steps).

Data parallelism (``mesh``): as the PixRefer trainer's.  Both G forwards
of a step (D's constant under ``no_grad``, then G's loss) normalize with
the group's moments, as both are sync-BN in the JAX step
(``pixflow_trainer.py:89-123``); the dropout masks come from each rank's
own generator.  ``infer`` takes local moments.

CLI: ``python -m voicepuppet_torch.train.pixflow_trainer --config_path
<yml> [--steps N] [--dtype float32|bfloat16] [--device cuda|cpu]``; on
N cards under ``torchrun --nproc_per_node N``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.config import Config
from voicepuppet_torch.models import pixflow as pf
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.models.layers import sync_bn
from voicepuppet_torch.parallel.mesh import (DataGroup, all_reduce_grads_,
                                             group_of, mesh_global_batch,
                                             pmean_metric, replicate,
                                             shard_batch_local)
from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
from voicepuppet_torch.train.loop import StepLoop
from voicepuppet_torch.train.optim import gan_optimizer
from voicepuppet_torch.train.pixrefer_trainer import DTYPES, _mark
from voicepuppet_torch.train.state import GANTrainState


class PixFlowTrainer(StepLoop):
    """``g_tx`` / ``d_tx``: factories, parameters -> optimizer (default:
    ``gan_optimizer``); the parity tests pass SGD.  ``mesh``: the data
    group (None: this process alone, on ``device``)."""

    def __init__(self, cfg: Config, train_dtype: torch.dtype = torch.float32,
                 g_tx=None, d_tx=None, device="cuda",
                 mesh: Optional[DataGroup] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        self.train_dtype = train_dtype
        # the reference's batch 3 (train_pixflow.py:36) rounded up
        self.global_batch = mesh_global_batch(cfg.pixflow.batch_size, mesh)
        self.g_tx = g_tx if g_tx is not None else gan_optimizer(
            cfg.pixflow.training)
        self.d_tx = d_tx if d_tx is not None else gan_optimizer(
            cfg.pixflow.training)

    def init_state(self, seed: int = 0) -> GANTrainState:
        """Fresh G then D weights from ``torch.Generator().manual_seed(seed)``
        on the CPU, moved to the device."""
        g = torch.Generator().manual_seed(seed)
        gen = px.init_pixrefer_(pf.PixFlowNet(self.cfg.pixflow,
                                              self.train_dtype), g)
        disc = px.init_pixrefer_(px.Discriminator(self.cfg.pixflow.ndf,
                                                  dtype=self.train_dtype), g)
        gen.to(self.device)
        disc.to(self.device)
        replicate([gen, disc], self.mesh)
        return GANTrainState(gen, disc, self.g_tx(gen.parameters()),
                             self.d_tx(disc.parameters()))

    def train_step(self, state: GANTrainState, batch,
                   generator: Optional[torch.Generator] = None,
                   marks: Optional[List] = None):
        """One D update then one G update on ``batch``, this rank's rows
        of the global batch (``parallel.mesh.shard_batch``); returns
        (state, metrics of device scalars, averaged over the ranks).
        ``generator`` draws the dropout masks; ``marks``, a list (on the
        card), receives CUDA events at the start, after D and after G."""
        with sync_bn(group_of(self.mesh), state.gen, state.disc):
            return self._step(state, batch, generator, marks)

    def _step(self, state: GANTrainState, batch, generator, marks):
        cfg = self.cfg.pixflow
        group = group_of(self.mesh)
        inputs, fg_inputs, masks = batch_to_device(batch, self.device)
        _mark(marks)
        inputs_p = px.preprocess(inputs)
        fg_p = px.preprocess(fg_inputs)
        gen, disc = state.gen, state.disc
        with torch.no_grad():
            out0, _ = gen(inputs_p, fg_p, train=True, generator=generator)
        d_loss = pf.pixflow_discriminator_loss(
            disc(inputs_p[..., 3:], fg_p[..., 3:]),
            disc(inputs_p[..., 3:], out0))
        state.d_optimizer.zero_grad(set_to_none=True)
        d_loss.backward(inputs=list(disc.parameters()))
        all_reduce_grads_(disc.parameters(), group)
        state.d_optimizer.step()
        _mark(marks)

        # G through the updated D (reference ordering), its own dropout
        outputs, alphas = gen(inputs_p, fg_p, train=True,
                              generator=generator)
        g_loss, gan_t, l1_t = pf.pixflow_generator_loss(
            disc(inputs_p[..., 3:], outputs), fg_p[..., 3:], outputs,
            alphas, masks, cfg.gan_weight, cfg.l1_weight)
        state.g_optimizer.zero_grad(set_to_none=True)
        g_loss.backward(inputs=list(gen.parameters()))
        all_reduce_grads_(gen.parameters(), group)
        state.g_optimizer.step()
        _mark(marks)
        state.step += 2
        metrics = {"discrim_loss": d_loss, "gen_loss": g_loss,
                   "gen_loss_GAN": gan_t, "gen_loss_L1": l1_t}
        return state, pmean_metric({k: v.detach()
                                    for k, v in metrics.items()}, self.mesh)

    @torch.no_grad()
    def infer(self, state: GANTrainState, inputs, fg_inputs):
        """[0,1] NHWC images -> (outputs in [0,1], alphas), inference mode
        (no dropout), float32 convs whatever the training dtype (ref:
        pixflow.py:364-384)."""
        inputs, fg_inputs = batch_to_device((inputs, fg_inputs),
                                            self.device)
        gen = state.gen.generator
        train_dtype, gen.dtype = gen.dtype, torch.float32
        try:
            outputs, alphas = state.gen(px.preprocess(inputs),
                                        px.preprocess(fg_inputs))
        finally:
            gen.dtype = train_dtype
        return px.deprocess(outputs), alphas


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixFlowBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.parallel.mesh import (local_batch_rows,
                                                 make_mesh)
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import (MetricsLogger,
                                                 add_profiler_args,
                                                 profiler_from_args)

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--ckpt_dir", default="ckpt_pixflow")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32",
                   help="bfloat16: G and D convs in bfloat16; parameters, "
                        "optimizer states, BN moments and losses stay "
                        "float32")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    add_profiler_args(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = make_mesh(args.device)
    trainer = PixFlowTrainer(cfg, train_dtype=DTYPES[args.dtype], mesh=mesh)
    tcfg = cfg.pixflow.training
    ckpt = CheckpointManager(args.ckpt_dir, tcfg.max_to_keep,
                             tcfg.save_interval, mesh=mesh)
    state = ckpt.restore(trainer.init_state())
    logger = (MetricsLogger(args.log_dir, "pixflow") if mesh.is_main
              else None)
    src = FileSource(cfg.dataset.train_dataset_path, cfg, load_images=True)
    steps = args.steps if args.steps is not None else tcfg.epochs
    # JPEG decode + crop augmentation in worker threads (ref: tf.data
    # num_parallel_calls=4); each rank decodes its own rows
    rows = local_batch_rows(trainer.global_batch, mesh)
    bg = BackgroundBatches(
        lambda i: iter(PixFlowBatcher(cfg, src, seed=4 * mesh.rank + i,
                                      batch_size=rows)),
        num_workers=4)
    try:
        trainer.fit(state, (shard_batch_local(b, mesh) for b in
                            prefetch_to_device(bg, mesh.device)),
                    steps, logger, ckpt,
                    profiler=profiler_from_args(args) if mesh.is_main
                    else None)
    finally:
        bg.close()
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
