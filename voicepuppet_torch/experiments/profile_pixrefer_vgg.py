"""The PixRefer step at float32 against the step with only the perceptual
term in bfloat16 (the trainer's ``perceptual_dtype``), and the step on a
batch already on the card.

Port of experiments/profile_pixrefer_vgg.py (batch 2, 512²): the VGG
trunk has no batch norm, so a bf16 trunk costs no casts around moments.
Variants: the whole trainer step with the perceptual term in float32
and in bf16, and VGG's backward to the image in each dtype, K times
back to back with a carried dependence, interleaved rounds, per-variant
minima (``_timing``, CUDA events).  Then the trainer's steps on a batch
moved once to the card by ``parallel.mesh.shard_batch`` over a world-1
``make_mesh`` group (the batch is not re-sent per step, as
``prefetch_to_device`` overlaps it in ``fit``).

    python -m voicepuppet_torch.experiments.profile_pixrefer_vgg [--k 8 --rounds 6]
"""

import sys

import numpy as np
import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.models import vgg as vgg_mod
from voicepuppet_torch.parallel.mesh import make_mesh, shard_batch
from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    cfg = _common.config_for(args.scale)
    s, b = cfg.pixrefer.img_size, args.batch
    r = np.random.RandomState(0)
    host = (r.rand(b, s, s, 6).astype(np.float32),
            r.rand(b, s, s, 6).astype(np.float32),
            r.rand(b, s, s, 3).astype(np.float32),
            (r.rand(b, s, s, 3) > 0.5).astype(np.float32))
    mesh = make_mesh(dev)
    batch = shard_batch(host, mesh)
    fg_p = batch[1] * 2 - 1
    cases = {}
    vggs = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tr = _common.fit_vgg_(PixReferTrainer(cfg, perceptual_dtype=dt,
                                              device=dev), args.scale)
        st = tr.init_state()
        cases[f"full_step {name} perceptual"] = (
            lambda x, tr=tr, st=st: tr.train_step(st, (x,) + batch[1:]),
            batch[0])
        vggs[name] = tr.vgg

    def vgg_bwd(vgg):
        def f(x):
            im = (x[..., :3] * 2 - 1).detach().requires_grad_(True)
            return torch.autograd.grad(
                vgg_mod.perceptual_loss(vgg, fg_p[..., 3:], im), im)[0]
        return f

    for name, vgg in vggs.items():
        cases[f"vgg_bwd {name} (to image)"] = (vgg_bwd(vgg), batch[0])
    per, mins1, minsk = _common.timed(cases, args.k, args.rounds, dev)
    card = _common.device_line(dev)
    print(f"\nFINAL per-iteration compute (ms, batch={b}, {s}², "
          f"K={args.k}) on {card}:")
    for name, sec in per.items():
        print(f"  {name:30s} {sec * 1e3:9.3f}   (t1={mins1[name] * 1e3:.2f} "
              f"tK={minsk[name] * 1e3:.2f})", flush=True)

    trainer = _common.fit_vgg_(PixReferTrainer(cfg, device=dev, mesh=mesh),
                               args.scale)
    state = trainer.init_state()
    dev_batch = shard_batch(host, mesh)
    if not all(t.device.type == dev.type for t in dev_batch):
        raise AssertionError("shard_batch left the batch off the device")
    res, _, _ = _common.timed(
        {"resident": (lambda x: trainer.train_step(state, x), dev_batch)},
        args.k, args.rounds, dev, carry=False)
    sec = res["resident"]
    print(f"\ndevice-resident trainer steps (batch sharded once): pixrefer "
          f"batch={b}: {sec * 1e3:.3f} ms/step ({1.0 / sec:.2f} steps/s) on "
          f"{card}", flush=True)
    out = {name: sec * 1e3 for name, sec in per.items()}
    out["resident"] = res["resident"] * 1e3
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
