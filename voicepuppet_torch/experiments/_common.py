"""What the profile entry points share: the raster probes' command line,
probe mesh and report; the serving and training experiments' device and
scale options, configurations and timing."""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from voicepuppet_torch.config import Config
from voicepuppet_torch.experiments import _timing
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.face3d import morph

H = W = 224
# the serving and training experiments' sizes: "full" is Config() on the
# 189² synthetic BFM (the JAX scripts' scale); "tiny" the CPU tests'
# widths (ngf 8 at 256², BFMNet width-mult 0.25, 64 wide) on a 16² mesh
SCALES = ("full", "tiny")
MESH_GRID = {"full": 189, "tiny": 16}


def parse_args(doc: str, argv: Optional[Sequence[str]], mesh: int
               ) -> argparse.Namespace:
    """The entry points' options: the device (the card unless ``cpu`` is
    asked for), the batch, K, the rounds, and the mesh's grid size (the
    JAX script's by default)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--batch", type=int, default=16, help="frames")
    p.add_argument("--k", type=int, default=8,
                   help="back-to-back calls per timed window")
    p.add_argument("--rounds", type=int, default=6,
                   help="interleaved timing rounds")
    p.add_argument("--mesh", type=int, default=mesh,
                   help="synthetic_bfm grid (num_theta = num_phi)")
    return p.parse_args(argv)


def probe_mesh(args: argparse.Namespace, seed: int, coeff_seed: int,
               colors: bool = False):
    """``synthetic_bfm(mesh, mesh, seed)`` decoded with
    ``demo_coeff(batch, coeff_seed)`` through ``morph.reconstruct``, as
    the JAX scripts build it -> (vertices [B,V,3], triangles [F,3] int32)
    on ``args.device``, plus the floored colours [B,V,3] with
    ``colors``."""
    dev = torch.device(args.device)
    model = bfm_mod.synthetic_bfm(num_theta=args.mesh, num_phi=args.mesh,
                                  seed=seed)
    fm = morph.device_bfm(model, dev)
    coeff = torch.as_tensor(bfm_mod.demo_coeff(model, batch=args.batch,
                                               seed=coeff_seed), device=dev)
    with torch.inference_mode():
        rec = morph.reconstruct(coeff, fm)
        verts = torch.cat([rec.face_projection, rec.z_buffer],
                          -1).contiguous()
        if not colors:
            return verts, fm.tri
        return verts, fm.tri, torch.floor(torch.clamp(
            rec.face_color, 0.0, 255.0)).contiguous()


def device_line(device) -> str:
    """The device the times were taken on: the card's name and what
    ``nvidia-smi`` says of its name and power limit, or ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return f"{torch.cuda.get_device_name(dev)} ({smi})"


def time_variants(cases: Mapping[str, Callable], x, args: argparse.Namespace,
                  title: str, entries: int) -> Dict[str, float]:
    """Build, time in turns and report ``{name: f}`` on input ``x`` ->
    per-iteration seconds."""
    progs = _timing.build_progs({n: (f, x) for n, f in cases.items()},
                                args.k, args.device)
    mins1, minsk = _timing.interleaved_minima(progs, args.rounds)
    per = _timing.per_iter(mins1, minsk, args.k)
    # per variant: ms per iteration, ns per (triangle, frame) entry, and
    # the minima t_1 and t_K
    print(f"\n{title} on {device_line(args.device)}", flush=True)
    for name, sec in per.items():
        print(f"  {name:22s} {sec * 1e3:9.4f} ms  "
              f"({sec / entries * 1e9:7.3f} ns/tri-frame)  "
              f"(t1={mins1[name] * 1e3:.4f} tK={minsk[name] * 1e3:.4f})",
              flush=True)
    return per


def experiment_parser(doc: str) -> argparse.ArgumentParser:
    """``--device`` (the card unless ``cpu`` is asked for) and ``--scale``
    (module comment above); the entry point adds its own knobs."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    p.add_argument("--scale", choices=SCALES, default="full",
                   help="full: Config() and the 189² mesh; tiny: the CPU "
                        "tests' widths")
    return p


def config_for(scale: str) -> Config:
    cfg = Config()
    if scale == "full":
        return cfg
    return dataclasses.replace(
        cfg,
        bfmnet=dataclasses.replace(cfg.bfmnet, backbone_width_mult=0.25,
                                   thinresnet_output_channels=64,
                                   encode_embedding_size=64,
                                   rnn_hidden_size=64),
        pixrefer=dataclasses.replace(cfg.pixrefer, ngf=8, ndf=8,
                                     img_size=256))


def face_model_for(scale: str, seed: int = 0):
    g = MESH_GRID[scale]
    return bfm_mod.synthetic_bfm(num_theta=g, num_phi=g, seed=seed)


def timed(cases: Mapping[str, Tuple[Callable, object]], k: int,
          rounds: int, device, carry: bool = True
          ) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float]]:
    """``{name: (f, x)}`` built, timed in turns for ``rounds`` rounds with
    a carried dependence (``_timing``) -> (seconds per call, minima of
    t_1, minima of t_K)."""
    progs = _timing.build_progs(cases, k, device, carry=carry)
    mins1, minsk = _timing.interleaved_minima(progs, rounds)
    return _timing.per_iter(mins1, minsk, k), mins1, minsk


TINY_VGG_WIDTHS = (8, 16, 32, 32)


def fit_vgg_(trainer, scale: str):
    """At the tiny scale, give a PixRefer trainer a narrow VGG trunk
    (``TINY_VGG_WIDTHS``, seed 17, the trainer's perceptual dtype): the
    full trunk dominates a CPU step.  At full scale nothing changes."""
    if scale == "full":
        return trainer
    from voicepuppet_torch.models import vgg as vgg_mod
    vgg = vgg_mod.init_vgg_(vgg_mod.VGG16Features(TINY_VGG_WIDTHS),
                            torch.Generator().manual_seed(17))
    vgg.dtype = trainer.perceptual_dtype
    trainer.vgg = vgg.to(trainer.device)
    return trainer
