"""PixRefer GAN trainer, data-parallel over a ``parallel.mesh.DataGroup``
(port of ``voicepuppet_tpu/train/pixrefer_trainer.py``:50-407; ref:
voicepuppet/pixrefer/pixrefer.py:356-412, train_pixrefer.py:112-153).

One step: the generator runs once; D updates first on that output taken
as a constant; then G's loss — the GAN term through the *updated* D, the
image and alpha L1s and the VGG conv3_3 perceptual term — updates G (the
reference nests G's backward under ``control_dependencies([discrim_train])``).
G's parameters do not change during the D update, so the JAX program's
two G forwards give one value and one is enough here.  D runs three
times, on the current real pair, the reference real pair and the fake,
each call normalizing with its own batch moments (one concatenated call
would change every moment).  ``step`` advances by 2 per iteration (both
reference optimizers increment one global_step).  Adam beta1 0.5, lr 3e-4
decaying 0.999 every 1000 global steps, no clipping.

``train_dtype=torch.bfloat16`` runs the G and D convs in bfloat16 while
parameters, optimizer states, BN moments, losses and the tanh / sigmoid
heads stay float32; ``perceptual_dtype`` sets the frozen VGG trunk's conv
dtype alone (default: ``train_dtype``).  Float32 convs and matmuls run in
full float32 (TF32 off).

Data parallelism (``mesh``): as the BFMNet trainer's.  Each rank runs G
and D on its rows with sync-BN (every G and D call is a collective, in
the same order on every rank), back-propagates its mean D loss, then
averages D's gradients alone before D's step; likewise G's after G's
backward.  ``infer`` (the image summary, on rank 0 alone) takes local
moments, as the JAX ``gen_eval`` with ``axis_name=None``.

CLI: ``python -m voicepuppet_torch.train.pixrefer_trainer --config_path
<yml> [--steps N] [--dtype float32|bfloat16] [--perceptual_dtype ...]
[--steps_per_call K] [--device cuda|cpu]``; on N cards under
``torchrun --nproc_per_node N``.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, List, Optional

import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.config import Config
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.models import vgg as vgg_mod
from voicepuppet_torch.models.layers import sync_bn
from voicepuppet_torch.parallel.mesh import (DataGroup, all_reduce_grads_,
                                             group_of, mesh_global_batch,
                                             pmean_metric, replicate,
                                             shard_batch_local)
from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
from voicepuppet_torch.train.optim import gan_optimizer
from voicepuppet_torch.train.state import GANTrainState
from voicepuppet_torch.utils import tracing

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _hit_interval(step: int, stride: int, kk: int, interval: int) -> bool:
    """True iff one of this call's ``kk`` step values ``{step -
    stride*(kk-1), ..., step}`` is an exact multiple of ``interval`` —
    the reference's ``global_step % interval == 0`` (train_pixrefer.py:
    144-153, global_step striding by 2) for K steps per call."""
    return any((step - stride * j) % interval == 0 for j in range(kk))


def _mark(marks: Optional[List]):
    """Append to ``marks``, when given, a CUDA event recorded on the
    current stream."""
    if marks is not None:
        marks.append(tracing.cuda_event())


class PixReferTrainer:
    """``g_tx`` / ``d_tx``: factories, parameters -> optimizer (default:
    ``gan_optimizer``); the parity tests pass SGD.  ``vgg_weights_path``:
    a converted ``.npz`` or the released slim checkpoint; without one the
    trunk is drawn from ``torch.Generator().manual_seed(vgg_seed)``.
    ``mesh``: the data group (None: this process alone, on ``device``).
    ``step_stride``: the global steps one D+G ``train_step`` advances."""

    step_stride = 2

    def __init__(self, cfg: Config, vgg_weights_path: Optional[str] = None,
                 train_dtype: torch.dtype = torch.float32,
                 perceptual_dtype: Optional[torch.dtype] = None,
                 g_tx=None, d_tx=None, device="cuda", vgg_seed: int = 17,
                 mesh: Optional[DataGroup] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        self.train_dtype = train_dtype
        self.perceptual_dtype = perceptual_dtype or train_dtype
        # the reference's batch 2 (train_pixrefer.py:36) rounded up
        self.global_batch = mesh_global_batch(cfg.pixrefer.batch_size, mesh)
        self.g_tx = g_tx if g_tx is not None else gan_optimizer(
            cfg.pixrefer.training)
        self.d_tx = d_tx if d_tx is not None else gan_optimizer(
            cfg.pixrefer.training)
        vgg = vgg_mod.init_vgg_(vgg_mod.VGG16Features(),
                                torch.Generator().manual_seed(vgg_seed))
        if vgg_weights_path is not None:
            if vgg_weights_path.endswith(".npz"):
                vgg_mod.load_weights(vgg_weights_path, vgg)
            else:
                from voicepuppet_torch.tools.tf_bundle import \
                    load_vgg16_checkpoint
                state, _, missing = load_vgg16_checkpoint(vgg_weights_path,
                                                          vgg)
                if missing:
                    raise ValueError(
                        f"vgg ckpt {vgg_weights_path}: {len(missing)} trunk "
                        f"variables missing or mis-shaped, e.g. "
                        f"{missing[:3]}")
                vgg.load_state_dict(state)
        vgg.dtype = self.perceptual_dtype
        self.vgg = vgg.to(self.device)

    def init_state(self, seed: int = 0) -> GANTrainState:
        """Fresh G then D weights from ``torch.Generator().manual_seed(seed)``
        on the CPU, moved to the device."""
        g = torch.Generator().manual_seed(seed)
        gen = px.init_pixrefer_(px.PixReferNet(self.cfg.pixrefer,
                                               self.train_dtype), g)
        disc = px.init_pixrefer_(px.Discriminator(self.cfg.pixrefer.ndf,
                                                  dtype=self.train_dtype), g)
        gen.to(self.device)
        disc.to(self.device)
        replicate([gen, disc], self.mesh)
        return GANTrainState(gen, disc, self.g_tx(gen.parameters()),
                             self.d_tx(disc.parameters()))

    # ---- the D-then-G step ----
    def train_step(self, state: GANTrainState, batch,
                   marks: Optional[List] = None):
        """One D update then one G update on ``batch``, this rank's rows
        of the global batch (``parallel.mesh.shard_batch``); returns
        (state, metrics of device scalars, averaged over the ranks).
        ``marks``, a list (on the card), receives CUDA events at the
        start, after D and after G."""
        with sync_bn(group_of(self.mesh), state.gen, state.disc):
            return self._step(state, batch, marks)

    def _step(self, state: GANTrainState, batch, marks):
        cfg = self.cfg.pixrefer
        group = group_of(self.mesh)
        inputs, fg_inputs, targets, masks = batch_to_device(batch,
                                                            self.device)
        _mark(marks)
        with tracing.span("vp.train.d_half", request=state.step,
                          device=self.device):
            inputs_p = px.preprocess(inputs)
            fg_p = px.preprocess(fg_inputs)
            targets_p = px.preprocess(targets)
            gen, disc = state.gen, state.disc
            outputs, alphas, outputs_fg = gen(inputs_p, fg_p, targets_p)

            fake = outputs_fg.detach()
            predict_real = (disc(inputs_p[..., 3:], fg_p[..., 3:])
                            + disc(inputs_p[..., :3], fg_p[..., :3])) / 2.0
            d_loss = px.discriminator_loss(predict_real,
                                           disc(inputs_p[..., 3:], fake))
            state.d_optimizer.zero_grad(set_to_none=True)
            d_loss.backward(inputs=list(disc.parameters()))
            all_reduce_grads_(disc.parameters(), group)
            state.d_optimizer.step()
        _mark(marks)

        # G through the updated D (reference ordering)
        with tracing.span("vp.train.g_half", request=state.step,
                          device=self.device):
            perc = vgg_mod.perceptual_loss(self.vgg, fg_p[..., 3:],
                                           outputs_fg)
            g_loss, gan_t, l1_t = px.generator_loss(
                disc(inputs_p[..., 3:], outputs_fg), targets_p, outputs,
                alphas, masks, perc, cfg.gan_weight, cfg.l1_weight)
            state.g_optimizer.zero_grad(set_to_none=True)
            g_loss.backward(inputs=list(gen.parameters()))
            all_reduce_grads_(gen.parameters(), group)
            state.g_optimizer.step()
        _mark(marks)
        state.step += self.step_stride
        metrics = {"discrim_loss": d_loss, "gen_loss": g_loss,
                   "gen_loss_GAN": gan_t, "gen_loss_L1": l1_t,
                   "perceptual": perc}
        return state, pmean_metric({k: v.detach()
                                    for k, v in metrics.items()}, self.mesh)

    def train_multi_step(self, state: GANTrainState, batches):
        """K sequential D+G steps with no host sync; every metric gains a
        leading [K] axis; ``state.step`` advances by 2K."""
        rows = [self.train_step(state, b)[1] for b in batches]
        return state, {k: torch.stack([r[k] for r in rows])
                       for k in rows[0]}

    # ---- inference (ref: pixrefer.py:414-438) ----
    @torch.no_grad()
    def infer(self, state: GANTrainState, inputs, fg_inputs, targets):
        """[0,1] NHWC images -> (outputs, outputs_fg + alpha - 1) in [0,1],
        with float32 convs whatever the training dtype."""
        inputs, fg_inputs, targets = batch_to_device(
            (inputs, fg_inputs, targets), self.device)
        gen = state.gen.generator
        train_dtype, gen.dtype = gen.dtype, torch.float32
        try:
            outputs, alphas, outputs_fg = state.gen(
                px.preprocess(inputs), px.preprocess(fg_inputs),
                px.preprocess(targets))
        finally:
            gen.dtype = train_dtype
        return (px.deprocess(outputs),
                px.deprocess(outputs_fg + alphas - 1.0))

    # ---- loop (ref: train_pixrefer.py:134-153) ----
    def fit(self, state: GANTrainState, batches: Iterator, num_steps: int,
            logger=None, ckpt=None, steps_per_call: int = 1,
            profiler=None) -> GANTrainState:
        """``steps_per_call`` K runs K D+G steps per call; the image
        summary and the checkpoint fire when one of the call's step values
        (stride 2) is an exact multiple of their interval, at most once
        per call.  K = 1 is the reference loop exactly.  Under a mesh,
        rank 0 alone logs and renders the summary."""
        main = self.mesh is None or self.mesh.is_main
        tcfg = self.cfg.pixrefer.training
        k = max(1, int(steps_per_call))
        stride = self.step_stride
        if k > 1:
            for label, iv in (("summary_interval", tcfg.summary_interval),
                              ("save_interval",
                               ckpt.save_interval if ckpt else None)):
                if iv and stride * k > iv:
                    warnings.warn(f"steps_per_call={k} (stride "
                                  f"{stride * k}) "
                                  f"exceeds {label}={iv}: that cadence "
                                  "coarsens to once per call")
        done = 0
        try:
            while done < num_steps:
                kk = min(k, num_steps - done)
                if profiler is not None:
                    profiler.step(state.step, stride * kk)
                got = [next(batches) for _ in range(kk)]
                state, stacked = self.train_multi_step(state, got)
                done += kk
                step = state.step
                if logger is not None and main:
                    keys = list(stacked)
                    vals = torch.stack([stacked[n].float() for n in keys],
                                       1).cpu().numpy()
                    for i, row in enumerate(vals):
                        logger.log(step - stride * (kk - i - 1),
                                   **dict(zip(keys, map(float, row))))
                    if _hit_interval(step, stride, kk,
                                     tcfg.summary_interval):
                        # current render | target | output (ref:
                        # train_pixrefer.py:101-131)
                        inputs, fg_inputs, targets, _ = batch_to_device(
                            got[-1], self.device)
                        outputs, _ = self.infer(state, inputs[:1],
                                                fg_inputs[:1], targets[:1])
                        logger.log_image(step, "pixrefer", torch.cat(
                            [inputs[0, ..., 3:6], targets[0],
                             outputs[0].clamp(0, 1)], dim=1).cpu().numpy())
                if ckpt is not None and step > 0 and _hit_interval(
                        step, stride, kk, ckpt.save_interval):
                    ckpt.save(step, state)
        finally:
            if profiler is not None:
                profiler.close()
        return state


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixReferBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.parallel.mesh import (local_batch_rows,
                                                 make_mesh)
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import (MetricsLogger,
                                                 add_profiler_args,
                                                 profiler_from_args)

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--ckpt_dir", default="ckpt_pixrefer")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32",
                   help="bfloat16: G and D convs in bfloat16; parameters, "
                        "optimizer states, BN moments and losses stay "
                        "float32")
    p.add_argument("--perceptual_dtype", choices=tuple(DTYPES),
                   default=None,
                   help="conv dtype of the frozen VGG trunk alone "
                        "(default: follow --dtype)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="run K D+G steps per call with their metrics kept "
                        "on the device and fetched once")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    add_profiler_args(p)
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = make_mesh(args.device)
    vgg_path = os.path.join(cfg.model_dir, "vgg16_weights.npz")
    trainer = PixReferTrainer(
        cfg, vgg_weights_path=vgg_path if os.path.exists(vgg_path) else None,
        train_dtype=DTYPES[args.dtype],
        perceptual_dtype=DTYPES.get(args.perceptual_dtype), mesh=mesh)
    tcfg = cfg.pixrefer.training
    ckpt = CheckpointManager(args.ckpt_dir, tcfg.max_to_keep,
                             tcfg.save_interval, mesh=mesh)
    state = ckpt.restore(trainer.init_state())
    logger = (MetricsLogger(args.log_dir, "pixrefer") if mesh.is_main
              else None)
    src = FileSource(cfg.dataset.train_dataset_path, cfg, load_images=True)
    steps = args.steps if args.steps is not None else tcfg.epochs
    # JPEG decode + crop augmentation in worker threads, overlapping the
    # device step (ref: tf.data num_parallel_calls=4, generator.py:502);
    # each rank decodes its own rows, from seeds of its own
    rows = local_batch_rows(trainer.global_batch, mesh)
    bg = BackgroundBatches(
        lambda i: iter(PixReferBatcher(cfg, src, seed=4 * mesh.rank + i,
                                       batch_size=rows)),
        num_workers=4)
    try:
        trainer.fit(state, (shard_batch_local(b, mesh) for b in
                            prefetch_to_device(bg, mesh.device)),
                    steps, logger, ckpt, steps_per_call=args.steps_per_call,
                    profiler=profiler_from_args(args) if mesh.is_main
                    else None)
    finally:
        bg.close()
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    main()
