"""The PixRefer D+G train step split into its parts, timed on the card.

Port of experiments/profile_pixrefer_step.py (batch 2, 512², float32,
the full VGG-16 trunk from seed 17, the trainer's modules and Adam):
G forward; G forward and backward on the L1 terms alone; one D forward;
the D loss's gradient over three D forwards (the fake made outside);
the same with the G forward; VGG's perceptual forward; its backward to
the image; the full G-loss gradient (G, D and VGG); one Adam update of
each net; and the whole step as the trainer runs it.  Each part K times
back to back with a carried dependence on the input, interleaved
rounds, per-variant minima (``_timing``, CUDA events).

    python -m voicepuppet_torch.experiments.profile_pixrefer_step [--k 8 --rounds 6]
"""

import sys

import numpy as np
import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.models import vgg as vgg_mod
from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer


def step_parts(trainer, state, fg, targets, masks):
    """{name: f(x)} of the JAX script; ``x`` is the [-1, 1] inputs
    [B,S,S,6]; ``fg``, ``targets`` in [-1, 1], ``masks`` in {0, 1}."""
    cfg = trainer.cfg.pixrefer
    gen, disc, vgg = state.gen, state.disc, trainer.vgg
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())

    def g_forward(x):
        with torch.no_grad():
            return gen(x, fg, targets)[0]

    def g_l1_grad(x):
        outputs, alphas, _ = gen(x, fg, targets)
        loss = (torch.mean(torch.abs(targets - outputs))
                + torch.mean(torch.abs(masks - alphas)))
        return torch.autograd.grad(loss, g_params)

    def d_forward(x):
        with torch.no_grad():
            return disc(x[..., 3:], targets)

    def d_loss(x, fake):
        pr = (disc(x[..., 3:], fg[..., 3:]) + disc(x[..., :3], fg[..., :3]))
        return px.discriminator_loss(pr / 2.0, disc(x[..., 3:], fake))

    def d_grad_only(x):
        return torch.autograd.grad(d_loss(x, targets), d_params)

    def d_step_grad(x):
        with torch.no_grad():
            fake = gen(x, fg, targets)[2]
        return torch.autograd.grad(d_loss(x, fake), d_params)

    def vgg_forward(x):
        with torch.no_grad():
            return vgg_mod.perceptual_loss(vgg, fg[..., 3:], x[..., :3])

    def vgg_bwd(x):
        im = x[..., :3].detach().requires_grad_(True)
        return torch.autograd.grad(
            vgg_mod.perceptual_loss(vgg, fg[..., 3:], im), im)[0]

    def g_full_grad(x):
        outputs, alphas, outputs_fg = gen(x, fg, targets)
        perc = vgg_mod.perceptual_loss(vgg, fg[..., 3:], outputs_fg)
        total, _, _ = px.generator_loss(
            disc(x[..., 3:], outputs_fg), targets, outputs, alphas, masks,
            perc, cfg.gan_weight, cfg.l1_weight)
        return torch.autograd.grad(total, g_params)

    def adam(params, opt):
        def update(x):
            scale = x[0, 0, 0, 0]
            for q in params:
                q.grad = q.detach() * scale
            opt.step()
            return params[0]
        return update

    batch01 = (fg * 0.5 + 0.5, targets * 0.5 + 0.5, masks)

    def full_step(x):
        return trainer.train_step(state, (x * 0.5 + 0.5,) + batch01)[1]

    return {
        "g_forward": g_forward,
        "g_l1_grad (G fwd+bwd, no D/VGG)": g_l1_grad,
        "d_forward (one D call)": d_forward,
        "d_grad_only (3 D fwd + bwd)": d_grad_only,
        "d_step_grad (+ G fwd)": d_step_grad,
        "vgg_forward": vgg_forward,
        "vgg_bwd (to image)": vgg_bwd,
        "g_full_grad (G+D+VGG bwd)": g_full_grad,
        "adam_update (G)": adam(g_params, state.g_optimizer),
        "adam_update (D)": adam(d_params, state.d_optimizer),
        "full_step (D+G, 2x adam)": full_step,
    }


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    cfg = _common.config_for(args.scale)
    s, b = cfg.pixrefer.img_size, args.batch
    trainer = _common.fit_vgg_(PixReferTrainer(cfg, device=dev), args.scale)
    state = trainer.init_state()
    r = np.random.RandomState(0)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    inputs = t(r.rand(b, s, s, 6) * 2 - 1)
    fg = t(r.rand(b, s, s, 6) * 2 - 1)
    targets = t(r.rand(b, s, s, 3) * 2 - 1)
    masks = t(r.rand(b, s, s, 3) > 0.5)
    parts = step_parts(trainer, state, fg, targets, masks)
    per, mins1, minsk = _common.timed({n: (f, inputs)
                                       for n, f in parts.items()},
                                      args.k, args.rounds, dev)
    print(f"\nFINAL per-iteration compute (ms, batch={b}, {s}², float32, "
          f"K={args.k}) on {_common.device_line(dev)}:")
    for name, sec in per.items():
        print(f"  {name:34s} {sec * 1e3:9.3f}   (t1={mins1[name] * 1e3:.2f} "
              f"tK={minsk[name] * 1e3:.2f})", flush=True)
    return {name: sec * 1e3 for name, sec in per.items()}


if __name__ == "__main__":
    main(sys.argv[1:])
