"""VGNet trainer, data-parallel over a ``parallel.mesh.DataGroup`` (port of
``voicepuppet_tpu/train/vgnet_trainer.py``:29-223; ref:
voicepuppet/atvgnet/train_vgnet.py:131-193).

The reference alternates D-only and G-only phases every ``alternative``
(1000) steps (train_vgnet.py:132-165); ``step`` counts both.  A D step runs
G as a constant in training mode (its BNs normalize with batch moments
and move their running moments, as the JAX step keeps G's updated
``batch_stats``), then D on the real and the fake sequence, and updates D
alone.  A G step runs G, scores it with D (training mode: D's GRU drops
out), and updates G alone.  Each phase leaves the other network's
parameters and Adam state untouched.  Both optimizers are the reference
Adam with the config's schedule and clip.  The batch is
``data.generators.VGNetBatcher``'s: (landmark_seq [B,T,136], mask_seq
[B,T,S,S,1], img_seq [B,T,S,S,3], example_landmark [B,136], example_img
[B,S,S,3], seq_len [B]).

Data parallelism (``mesh``): both phases run every forward with sync-BN
(the D step's G under ``no_grad`` too, as in the JAX step,
``vgnet_trainer.py:102-122``), so every rank issues the same
collectives in the same order; each phase averages the gradients of the
network it updates alone.  ``generate`` takes the running moments.

CLI: ``python -m voicepuppet_torch.train.vgnet_trainer --config_path
<yml> [--steps N] [--alternative K] [--device cuda|cpu]``; the landmark
PCA assets resolve as the ATNet trainer's; on N cards under ``torchrun
--nproc_per_node N``.
"""

from __future__ import annotations

from typing import Optional

import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.config import Config
from voicepuppet_torch.models import vgnet as vg
from voicepuppet_torch.models.layers import sync_bn
from voicepuppet_torch.parallel.mesh import (DataGroup, all_reduce_grads_,
                                             group_of, mesh_global_batch,
                                             pmean_metric, replicate)
from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
from voicepuppet_torch.train.loop import StepLoop
from voicepuppet_torch.train.optim import reference_adam
from voicepuppet_torch.train.state import GANTrainState


class VGNetTrainer(StepLoop):
    """``g_tx`` / ``d_tx``: factories, parameters -> optimizer (default:
    the reference Adam); the parity tests pass SGD.  ``mesh``: the data
    group (None: this process alone, on ``device``)."""

    def __init__(self, cfg: Config, alternative: int = 1000, g_tx=None,
                 d_tx=None, device="cuda", mesh: Optional[DataGroup] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        self.alternative = alternative
        # the reference's batch 4 (train_vgnet.py:41) rounded up
        self.global_batch = mesh_global_batch(cfg.vgnet.batch_size, mesh)
        t = cfg.vgnet.training
        adam = lambda: reference_adam(t.learning_rate, t.decay_steps,
                                      t.decay_rate,
                                      max_grad_norm=t.max_grad_norm)
        self.g_tx = g_tx if g_tx is not None else adam()
        self.d_tx = d_tx if d_tx is not None else adam()

    def init_state(self, seed: int = 0) -> GANTrainState:
        """Fresh G then D weights from ``torch.Generator().manual_seed(seed)``
        on the CPU, moved to the device."""
        g = torch.Generator().manual_seed(seed)
        gen = vg.init_vgnet_(vg.VGNetGenerator(self.cfg.vgnet), g)
        disc = vg.init_vgnet_(vg.VGNetDiscriminator(self.cfg.vgnet), g)
        gen.to(self.device)
        disc.to(self.device)
        replicate([gen, disc], self.mesh)
        return GANTrainState(gen, disc, self.g_tx(gen.parameters()),
                             self.d_tx(disc.parameters()))

    def is_d_phase(self, step: int) -> bool:
        """D-only phases first, alternating every ``alternative`` steps
        (train_vgnet.py:133)."""
        return (step // self.alternative) % 2 == 0

    def d_step(self, state: GANTrainState, batch,
               generator: Optional[torch.Generator] = None):
        lmk_seq, _mask_seq, img_seq, ex_lmk, ex_img, seq_len = \
            batch_to_device(batch, self.device)
        with torch.no_grad():
            fake = state.gen(ex_img, lmk_seq, ex_lmk, seq_len, train=True)[0]
        rs, rl = state.disc(img_seq, ex_lmk, seq_len, train=True,
                            generator=generator)
        fs, fl = state.disc(fake, ex_lmk, seq_len, train=True,
                            generator=generator)
        loss = vg.vgnet_discriminator_loss(rs, rl, fs, fl, lmk_seq, seq_len)
        state.d_optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=list(state.disc.parameters()))
        all_reduce_grads_(state.disc.parameters(), group_of(self.mesh))
        state.d_optimizer.step()
        state.step += self.step_stride
        return state, pmean_metric({"discriminator_loss": loss.detach()},
                                   self.mesh)

    def g_step(self, state: GANTrainState, batch,
               generator: Optional[torch.Generator] = None):
        lmk_seq, mask_seq, img_seq, ex_lmk, ex_img, seq_len = \
            batch_to_device(batch, self.device)
        fake, att, _ = state.gen(ex_img, lmk_seq, ex_lmk, seq_len,
                                 train=True)
        fs, fl = state.disc(fake, ex_lmk, seq_len, train=True,
                            generator=generator)
        loss, bce, _lmk, pix = vg.vgnet_generator_loss(
            fs, fl, fake, att, lmk_seq, mask_seq, img_seq, seq_len)
        state.g_optimizer.zero_grad(set_to_none=True)
        loss.backward(inputs=list(state.gen.parameters()))
        all_reduce_grads_(state.gen.parameters(), group_of(self.mesh))
        state.g_optimizer.step()
        state.step += self.step_stride
        return state, pmean_metric(
            {"generator_loss": loss.detach(), "bce_loss": bce.detach(),
             "pix_loss": pix.detach()}, self.mesh)

    def train_step(self, state: GANTrainState, batch,
                   generator: Optional[torch.Generator] = None):
        """The step of the phase ``state.step`` falls in, on ``batch``,
        this rank's rows of the global batch (``parallel.mesh.
        shard_batch``), with sync-BN."""
        step = self.d_step if self.is_d_phase(state.step) else self.g_step
        with sync_bn(group_of(self.mesh), state.gen, state.disc):
            return step(state, batch, generator)

    @torch.no_grad()
    def generate(self, state: GANTrainState, example_img, landmark_seq,
                 example_landmark, seq_len):
        """The generator in inference mode (running BN moments):
        (video, attention, color)."""
        args = batch_to_device((example_img, landmark_seq, example_landmark,
                                seq_len), self.device)
        return state.gen(*args, train=False)


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.data.generators import (FileSource, VGNetBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.train.atnet_trainer import load_pca_assets
    from voicepuppet_torch.parallel.mesh import make_mesh
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import (MetricsLogger,
                                                 add_profiler_args,
                                                 profiler_from_args)

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--ckpt_dir", default="ckpt_vgnet")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--alternative", type=int, default=1000,
                   help="D/G phase length (train_vgnet.py:133)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    add_profiler_args(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = make_mesh(args.device)
    pca_mean, pca_component = load_pca_assets(cfg.model_dir,
                                              cfg.vgnet.landmark_size)
    trainer = VGNetTrainer(cfg, alternative=args.alternative, mesh=mesh)
    tcfg = cfg.vgnet.training
    ckpt = CheckpointManager(args.ckpt_dir, tcfg.max_to_keep,
                             tcfg.save_interval, mesh=mesh)
    state = ckpt.restore(trainer.init_state())
    logger = MetricsLogger(args.log_dir, "vgnet") if mesh.is_main else None
    # the streams take the [136, K] transpose of the component
    batcher = VGNetBatcher(cfg, FileSource(cfg.dataset.train_dataset_path,
                                           cfg, load_images=True),
                           pca_mean, pca_component.T,
                           batch_size=trainer.global_batch)
    steps = args.steps if args.steps is not None else tcfg.epochs
    try:
        trainer.fit(state, prefetch_to_device(iter(batcher), mesh.device,
                                              mesh=mesh),
                    steps, logger, ckpt,
                    profiler=profiler_from_args(args) if mesh.is_main
                    else None)
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
