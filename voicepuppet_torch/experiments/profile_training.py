"""Training throughput on the card: ms per step of the trainers' steps.

Port of experiments/profile_training.py:

  * bfmnet: the BFMNet step at full scale (T = 24, width 1.0, the loss
    through the full 189² basis), global batch 4 and 8;
  * pixrefer: the PixRefer D-then-G step at 512², ngf and ndf 64, batch
    2 and 8;
  * ab / ab8: PixRefer float32 against ``dtype`` bfloat16, interleaved;
  * multi / multi32: BFMNet single steps against ``train_multi_step`` of
    ``--multi_k`` (8; 32) batches, interleaved;
  * pxmulti / pxmulti8: PixRefer on batches already on the card through
    ``parallel.mesh.shard_batch`` (a world-1 ``make_mesh`` group), single
    steps against ``train_multi_step`` of ``--multi_k`` (4).

``all`` runs bfmnet, pixrefer, ab and pxmulti.  Every step updates the
trainer's state in place, so back-to-back steps carry their dependence
through it; K steps are timed against one with CUDA events,
``(t_K - t_1) / (K - 1)``, the variants of a comparison in interleaved
rounds, the minimum of each (``_timing``).

    python -m voicepuppet_torch.experiments.profile_training [--which all]
"""

import dataclasses
import sys

import numpy as np
import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.parallel.mesh import make_mesh, shard_batch
from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer

T = 24


def bfm_batch(rng, b, t=T):
    return (rng.randn(b, t, 257).astype(np.float32) * 0.1,
            rng.rand(b, t, 1).astype(np.float32) * 0.1,
            rng.randn(b, t * 5, 80).astype(np.float32),
            np.full((b,), t, np.int64))


def px_batch(rng, b, s):
    return (rng.rand(b, s, s, 6).astype(np.float32),
            rng.rand(b, s, s, 6).astype(np.float32),
            rng.rand(b, s, s, 3).astype(np.float32),
            (rng.rand(b, s, s, 3) > 0.5).astype(np.float32))


def _report(label, per, b, extra=""):
    print(f"{label}: {per * 1e3:9.3f} ms/step  {1.0 / per:7.2f} steps/s  "
          f"{b / per:8.2f} samples/s{extra}", flush=True)


def _time(cases, args, dev):
    per, _, _ = _common.timed(cases, args.k, args.rounds, dev, carry=False)
    return per


def bfm_trainer(args, cfg, batch_size, mesh=None):
    face = _common.face_model_for(args.scale, seed=0)
    c = dataclasses.replace(cfg, bfmnet=dataclasses.replace(
        cfg.bfmnet, batch_size=batch_size))
    tr = BFMNetTrainer(c, face, device=args.device, mesh=mesh)
    return tr, tr.init_state()


def px_trainer(args, cfg, batch_size, dtype=torch.float32, mesh=None):
    c = dataclasses.replace(cfg, pixrefer=dataclasses.replace(
        cfg.pixrefer, batch_size=batch_size))
    tr = _common.fit_vgg_(PixReferTrainer(c, train_dtype=dtype,
                                          device=args.device, mesh=mesh),
                          args.scale)
    return tr, tr.init_state()


def bench_bfmnet(args, cfg, dev, batch_size):
    tr, st = bfm_trainer(args, cfg, batch_size)
    b = tr.global_batch
    batch = shard_batch(bfm_batch(np.random.RandomState(0), b),
                        make_mesh(dev))
    per = _time({"step": (lambda x: tr.train_step(st, x), batch)}, args, dev)
    loss = float(tr.train_step(st, batch)[1]["loss"])
    _report(f"bfmnet  batch={b:2d}", per["step"], b, f"  (loss={loss:.4f})")
    return per["step"] * 1e3


def bench_pixrefer(args, cfg, dev, batch_size):
    tr, st = px_trainer(args, cfg, batch_size)
    b = tr.global_batch
    batch = shard_batch(px_batch(np.random.RandomState(0), b,
                                 cfg.pixrefer.img_size), make_mesh(dev))
    per = _time({"step": (lambda x: tr.train_step(st, x), batch)}, args, dev)
    loss = float(tr.train_step(st, batch)[1]["gen_loss"])
    _report(f"pixrefer batch={b:2d} (D+G, {cfg.pixrefer.img_size}², "
            f"float32)", per["step"], b, f"  (loss={loss:.4f})")
    return per["step"] * 1e3


def bench_pixrefer_ab(args, cfg, dev, batch_size):
    rng = np.random.RandomState(0)
    cases = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tr, st = px_trainer(args, cfg, batch_size, dt)
        batch = shard_batch(px_batch(rng, tr.global_batch,
                                     cfg.pixrefer.img_size), make_mesh(dev))
        cases[name] = (lambda x, tr=tr, st=st: tr.train_step(st, x), batch)
    per = _time(cases, args, dev)
    for name, sec in per.items():
        _report(f"pixrefer batch={batch_size:2d} {name:4s}", sec, batch_size)
    return {name: sec * 1e3 for name, sec in per.items()}


def bench_bfmnet_multi(args, cfg, dev, batch_size, k):
    rng = np.random.RandomState(0)
    mesh = make_mesh(dev)
    tr1, s1 = bfm_trainer(args, cfg, batch_size)
    trk, sk = bfm_trainer(args, cfg, batch_size)
    b = tr1.global_batch
    batch = shard_batch(bfm_batch(rng, b), mesh)
    batches = [shard_batch(bfm_batch(rng, b), mesh) for _ in range(k)]
    per = _time({"K=1": (lambda x: tr1.train_step(s1, x), batch),
                 f"K={k}": (lambda xs: trk.train_multi_step(sk, xs),
                            batches)}, args, dev)
    per[f"K={k}"] /= k
    for name, sec in per.items():
        _report(f"bfmnet  batch={b:2d} {name:4s}", sec, b)
    return {name: sec * 1e3 for name, sec in per.items()}


def bench_pixrefer_multi(args, cfg, dev, batch_size, k):
    """Batches on the card through shard_batch over a world-1 group."""
    rng = np.random.RandomState(0)
    mesh = make_mesh(dev)
    tr1, s1 = px_trainer(args, cfg, batch_size, mesh=mesh)
    trk, sk = px_trainer(args, cfg, batch_size, mesh=mesh)
    b = tr1.global_batch
    s = cfg.pixrefer.img_size
    batch = shard_batch(px_batch(rng, b, s), mesh)
    if not all(t.device.type == torch.device(dev).type for t in batch):
        raise AssertionError("shard_batch left the batch off the device")
    batches = [shard_batch(px_batch(rng, b, s), mesh) for _ in range(k)]
    per = _time({"K=1": (lambda x: tr1.train_step(s1, x), batch),
                 f"K={k}": (lambda xs: trk.train_multi_step(sk, xs),
                            batches)}, args, dev)
    per[f"K={k}"] /= k
    for name, sec in per.items():
        _report(f"pixrefer batch={b:2d} {name:4s} (device-resident)", sec, b)
    return {name: sec * 1e3 for name, sec in per.items()}


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--which", default="all",
                   choices=("all", "bfmnet", "pixrefer", "ab", "ab8",
                            "multi", "multi32", "pxmulti", "pxmulti8"))
    p.add_argument("--bfm_batches", type=int, nargs="+", default=[4, 8])
    p.add_argument("--px_batches", type=int, nargs="+", default=[2, 8])
    p.add_argument("--k", type=int, default=4,
                   help="steps per timed window")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--multi_k", type=int, default=None,
                   help="batches per train_multi_step (default: 8 for "
                        "multi, 32 for multi32, 4 for pxmulti)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    cfg = _common.config_for(args.scale)
    w = args.which
    out = {}
    if w in ("all", "bfmnet"):
        out["bfmnet"] = {b: bench_bfmnet(args, cfg, dev, b)
                         for b in args.bfm_batches}
    if w in ("all", "pixrefer"):
        out["pixrefer"] = {b: bench_pixrefer(args, cfg, dev, b)
                           for b in args.px_batches}
    if w in ("all", "ab"):
        out["ab"] = bench_pixrefer_ab(args, cfg, dev, args.px_batches[0])
    if w == "ab8":
        out["ab"] = bench_pixrefer_ab(args, cfg, dev, 8)
    mk = args.multi_k
    if w == "multi":
        out["multi"] = {b: bench_bfmnet_multi(args, cfg, dev, b, mk or 8)
                        for b in args.bfm_batches}
    if w == "multi32":
        out["multi"] = {8: bench_bfmnet_multi(args, cfg, dev, 8, mk or 32)}
    if w in ("all", "pxmulti"):
        out["pxmulti"] = bench_pixrefer_multi(args, cfg, dev,
                                              args.px_batches[0], mk or 4)
    if w == "pxmulti8":
        out["pxmulti"] = bench_pixrefer_multi(args, cfg, dev, 8, mk or 4)
    print(f"FINAL profile_training ({w}) on {_common.device_line(dev)}",
          flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
