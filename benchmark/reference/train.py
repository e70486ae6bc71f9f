"""The reference's PixRefer training step and the readings compared.

One step (``train_pixrefer.py``): G once; D updated first on that output
taken as a constant (D three times, each call with its own batch
moments); then G's loss through the updated D (GAN term, image and alpha
L1 and the VGG conv3_3 perceptual term) updates G.  Two Adams (beta1
0.5, constant learning rate while fewer than 500 steps have run)."""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark.reference import nets


class Trainer:
    def __init__(self, config: dict, g_state, d_state, vgg_state, device):
        p = config["pixrefer"]
        self.p = p
        dev = torch.device(device)
        self.gen = nets.PixReferNet(p["ngf"]).to(dev)
        self.gen.load_state_dict(g_state)
        self.disc = nets.Discriminator(p["ndf"]).to(dev)
        self.disc.load_state_dict(d_state)
        self.vgg = nets.VGG16Features(tuple(config["vgg"]["widths"])).to(dev)
        self.vgg.load_state_dict(vgg_state)
        tr = p["training"]
        self.g_opt = nets.ReferenceAdam(self.gen.parameters(),
                                        tr["learning_rate"], tr["beta1"])
        self.d_opt = nets.ReferenceAdam(self.disc.parameters(),
                                        tr["learning_rate"], tr["beta1"])
        self.device = dev

    def step(self, batch, grads: Dict[str, list] = None):
        """One D-then-G step on a batch of [0,1] arrays -> (d_loss, g_loss)
        as floats.  ``grads``: filled with each leaf's gradient norm of this
        step, per model."""
        inputs, fg_inputs, targets, masks = (
            torch.as_tensor(b, device=self.device) for b in batch)
        x = nets.preprocess(inputs)
        fg = nets.preprocess(fg_inputs)
        t = nets.preprocess(targets)
        gen, disc = self.gen, self.disc
        outputs, alphas, outputs_fg = gen(x, fg, t)
        fake = outputs_fg.detach()
        real = (disc(x[..., 3:], fg[..., 3:]) + disc(x[..., :3], fg[..., :3])
                ) / 2.0
        d_loss = nets.discriminator_loss(real, disc(x[..., 3:], fake))
        self.d_opt.zero_grad()
        d_loss.backward(inputs=list(disc.parameters()))
        if grads is not None:
            grads["disc"] = leaf_norms([p.grad for p in disc.parameters()])
        self.d_opt.step()
        perc = nets.perceptual_loss(self.vgg, fg[..., 3:], outputs_fg)
        g_loss = nets.generator_loss(disc(x[..., 3:], outputs_fg), t,
                                     outputs, alphas, masks, perc,
                                     self.p["gan_weight"],
                                     self.p["l1_weight"])
        self.g_opt.zero_grad()
        g_loss.backward(inputs=list(gen.parameters()))
        if grads is not None:
            grads["gen"] = leaf_norms([p.grad for p in gen.parameters()])
        self.g_opt.step()
        return float(d_loss.detach()), float(g_loss.detach())


def leaf_norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) if t is not None
            else 0.0 for t in tensors]


def norm_gap(got: List[float], want: List[float],
             keep: List[bool] = None) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over the larger of its reference
    norm and the median leaf's reference norm."""
    med = statistics.median(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if keep is not None and not keep[i]:
            continue
        worst = max(worst, abs(g - w) / max(w, med, 1e-30))
    return worst


def moving(grad_norms: List[float], share: float = 1e-3) -> List[bool]:
    """The leaves whose reference gradient is more than ``share`` of the
    median leaf's: the others (a conv bias under batch norm) move under
    Adam by round-off alone."""
    med = statistics.median(grad_norms)
    return [g > share * med for g in grad_norms]


def loss_gap(got: List[float], want: List[float]) -> float:
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
