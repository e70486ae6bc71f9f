"""The reference's PixFlow training step (taylorlu/voicepuppet
``train_pixflow.py`` with ``pixflow.py`` ``create_generator`` :222-255,
``add_cost_function`` :293-312 and ``build_train_op`` :314-362).

One step: G in training mode gives D its fake as a constant; D is updated
on a single real term (the current render with the current foreground)
and the fake; then G's loss through the updated D, the GAN term plus 500
times the L1 of the composite against the current foreground and of the
alpha against the mask, updates G.  Every batch norm takes its own batch
moments; each ``ResBlock`` drops out at 0.5 after its first BN and leaky
ReLU.  Two Adams (beta1 0.5, learning rate 3e-4, constant while fewer
than 500 steps have run).  Plain torch in float32 with TF32 off; the
generator keeps the system's submodule names (those of
``reference/pixflow.py``), so one state_dict loads into both.

Departures from the source:

* the dropout masks come from a given ``torch.Generator``: per
  ``ResBlock`` one ``torch.rand`` of the activation's NCHW shape, kept
  where below ``1 - rate``, the kept elements scaled by ``1 / (1 -
  rate)``, drawn in the system's order (the six blocks ``pre_resnet_1``,
  ``pre_resnet_2``, ``diff_resnet_1``, ``diff_resnet_2``,
  ``post_resnet_1``, ``post_resnet_2`` of D's constant forward, then the
  six of G's loss forward), so that both sides drop the same elements;
  the source draws them from TensorFlow's generator;
* G runs twice a step, once without a graph for D's input and once for
  its own loss through the updated D, each with its own masks, as the
  system's step orders the two updates;
* NHWC images in and out, NCHW inside; TF 'SAME' convs padded explicitly
  (``reference/pixflow.py``, ``nets.py``);
* the batch moments as ``mean(x²) - mean²`` in float32 (``nets.
  StatelessBatchNorm``);
* the learning rate's decay (0.999 every 1000 global steps) never starts
  in the steps compared, so it is left out.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets, pixflow
from benchmark.reference.train import leaf_norms

EPS = 1e-12


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def res_block(block: pixflow.ResBlock, x, rate: float, generator):
    y = nets.lrelu(block.StatelessBatchNorm_0(block.Conv_0(x)))
    y = dropout(y, rate, generator)
    return x + block.StatelessBatchNorm_1(block.Conv_1(y))


class PixFlowTrainNet(nn.Module):
    """PixFlowNet's generator in training mode and the black composite.
    forward(inputs [B,S,S,6] render ref | cur, fg_inputs [B,S,S,6] fg
    ref | cur, NHWC in [-1,1], a generator) -> (outputs [B,S,S,3],
    alphas [B,S,S,3])."""

    def __init__(self, ngf: int, drop_rate: float = 0.5):
        super().__init__()
        self.generator = pixflow.Generator(ngf)
        self.drop_rate = drop_rate

    def forward(self, inputs, fg_inputs, generator=None):
        g = self.generator
        res = lambda name, v: res_block(  # noqa: E731
            getattr(g, name), v, self.drop_rate, generator)
        x = inputs.permute(0, 3, 1, 2)
        fg = fg_inputs[..., :3].permute(0, 3, 1, 2)
        encode_feat = g.encoder_net(fg)
        diff_feat = g.diffnet(x[:, 3:]) - g.diffnet(x[:, :3])
        h = res("pre_resnet_2", res("pre_resnet_1", encode_feat))
        d = res("diff_resnet_2", res("diff_resnet_1", diff_feat))
        h = res("post_resnet_2", res("post_resnet_1", h + d))
        for i in range(3):
            h = getattr(g, f"StatelessBatchNorm_{i}")(
                getattr(g, f"decoder_{i}")(F.relu(h)))
        out = torch.tanh(g.final7(F.relu(h))).permute(0, 2, 3, 1)
        alpha = ((out[..., 3:] + 1.0) / 2.0).expand(-1, -1, -1, 3)
        return out[..., :3] * alpha + alpha - 1.0, alpha


def discriminator_loss(predict_real, predict_fake):
    """pixflow.py:295-300: a single real term."""
    return torch.mean(-(torch.log(predict_real + EPS)
                        + torch.log(1.0 - predict_fake + EPS)))


def generator_loss(predict_fake, fg_cur, outputs, alphas, masks,
                   gan_weight: float, l1_weight: float):
    """pixflow.py:302-312."""
    gan = torch.mean(-torch.log(predict_fake + EPS))
    l1 = (torch.mean(torch.abs(fg_cur - outputs))
          + torch.mean(torch.abs(masks - alphas)))
    return gan * gan_weight + l1 * l1_weight


def step_losses(gen, disc, batch, generator, p: dict, d_update=None,
                g_update=None):
    """One D-then-G step of ``gen`` and ``disc`` on a batch of tensors in
    [0,1] (inputs, fg_inputs, masks) -> (d_loss, g_loss) tensors.
    ``d_update`` / ``g_update``: called after each loss's backward (the
    optimizer's step and the readings); None leaves the parameters as
    they are (the FLOP count)."""
    inputs, fg_inputs, masks = batch
    x = nets.preprocess(inputs)
    fg = nets.preprocess(fg_inputs)
    with torch.no_grad():
        fake, _ = gen(x, fg, generator)
    d_loss = discriminator_loss(disc(x[..., 3:], fg[..., 3:]),
                                disc(x[..., 3:], fake))
    d_loss.backward(inputs=list(disc.parameters()))
    if d_update is not None:
        d_update()
    outputs, alphas = gen(x, fg, generator)
    g_loss = generator_loss(disc(x[..., 3:], outputs), fg[..., 3:], outputs,
                            alphas, masks, p["gan_weight"], p["l1_weight"])
    g_loss.backward(inputs=list(gen.parameters()))
    if g_update is not None:
        g_update()
    return d_loss, g_loss


class Trainer:
    """``config``: the configuration file's dict; G's and D's states; the
    dropout generator's seed (a ``torch.Generator`` on ``device``)."""

    def __init__(self, config: dict, g_state, d_state, device,
                 dropout_seed: int):
        p = config["pixflow"]
        self.p = p
        dev = torch.device(device)
        self.gen = PixFlowTrainNet(p["ngf"], p["drop_rate"]).to(dev)
        self.gen.load_state_dict(g_state)
        self.disc = nets.Discriminator(p["ndf"]).to(dev)
        self.disc.load_state_dict(d_state)
        tr = p["training"]
        self.g_opt = nets.ReferenceAdam(self.gen.parameters(),
                                        tr["learning_rate"], tr["beta1"])
        self.d_opt = nets.ReferenceAdam(self.disc.parameters(),
                                        tr["learning_rate"], tr["beta1"])
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(int(dropout_seed))
        self.device = dev

    def step(self, batch, grads: Dict[str, list] = None):
        """One step on a batch of [0,1] arrays -> (d_loss, g_loss) as
        floats.  ``grads``: filled with each leaf's gradient norm of this
        step, per model."""
        def update(name, model, opt):
            def run():
                if grads is not None:
                    grads[name] = leaf_norms([t.grad for t in
                                              model.parameters()])
                opt.step()
                opt.zero_grad()
            return run

        batch = tuple(torch.as_tensor(b, device=self.device) for b in batch)
        self.d_opt.zero_grad()
        self.g_opt.zero_grad()
        d_loss, g_loss = step_losses(
            self.gen, self.disc, batch, self.generator, self.p,
            update("disc", self.disc, self.d_opt),
            update("gen", self.gen, self.g_opt))
        return float(d_loss.detach()), float(g_loss.detach())
