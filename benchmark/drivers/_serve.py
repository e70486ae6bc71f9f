"""What the serving cells share: the scene and weights from the seed, the
system's synthesizer built on them, and the check of served frames
against the reference."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import numpy as np
import torch

from benchmark import devicetime, flops, system, weights
from benchmark.reference import nets
from benchmark.reference.face import face_model_on
from benchmark.reference.serve import Pipeline, frame_mad, generator_inputs
from benchmark.traffic import scene

BFM_STREAM, G_STREAM = 1, 2


@dataclasses.dataclass
class Scene:
    face_arrays: dict
    ident: dict
    panel: np.ndarray
    background: np.ndarray


def make_scene(config: dict, seed: int) -> Scene:
    s = config["pixrefer"]["img_size"]
    return Scene(scene.face_model_arrays(config["face_model"]["grid"], seed),
                 scene.identity(seed, s), scene.panel(seed, s),
                 scene.background(seed, s))


def make_weights(config: dict, seed: int, device):
    """(BFMNet state, PixRefer G state) from the seed, on ``device``."""
    bfm = weights.seeded_state(lambda: nets.BFMNet(config["bfmnet"]),
                               "glorot", seed, BFM_STREAM, device)
    gen = weights.seeded_state(
        lambda: nets.PixReferNet(config["pixrefer"]["ngf"]), "pix2pix", seed,
        G_STREAM, device)
    return bfm, gen


def build(config: dict, sc: Scene, seed: int, chunk: int, raster_group: int,
          device):
    """The system's Synthesizer on the seed's weights; refuses TF32."""
    bfm, gen = make_weights(config, seed, device)
    synth = system.synthesizer(config, sc.face_arrays, bfm, gen, chunk,
                               raster_group, device)
    del bfm, gen
    if any(system.tf32_flags()):
        raise SystemExit(f"the system left TF32 on {system.tf32_flags()}: "
                         f"the float32 peak and the reference assume it off")
    return synth


class CoeffTap:
    """The expression coefficients the served path computes, read by a
    forward hook on the system's coefficient head (each call's output,
    [1, T, 64]), kept under ``key`` while it is not None."""

    def __init__(self, synth):
        self.key = None
        self.kept: Dict[object, list] = {}
        self._handle = synth.bfmnet.bfm_coeff_decoder.register_forward_hook(
            self._hook)

    def _hook(self, module, args, out):
        if self.key is not None:
            self.kept.setdefault(self.key, []).append(out.detach())

    def close(self):
        self._handle.remove()


def release(synth):
    """Free the system's state before the reference runs."""
    synth.close()
    del synth
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference(config: dict, sc: Scene, seed: int, device,
              mode: str = "reference") -> Pipeline:
    """The reference pipeline on the seed's weights, made again."""
    bfm, gen = make_weights(config, seed, device)
    return Pipeline(config, bfm, gen, sc.face_arrays, device, mode)


def coeff_gap(served, want, notes: List[str]) -> float:
    """The worst coefficient's |served - reference| over the largest
    |reference| coefficient, over every compared item."""
    worst = 0.0
    for key, got in served.items():
        ref = want[key].float()
        gap = float((got.float().to(ref.device) - ref).abs().max()
                    / ref.abs().max().clamp(min=1e-12))
        worst = max(worst, gap)
        notes.append(f"coefficients {key}: {tuple(ref.shape)}, max |diff| "
                     f"over max |ref| {gap:.3g}")
    return worst


def compare(served: Dict[object, np.ndarray], want: Dict[object, np.ndarray],
            limit: float, notes: List[str]) -> dict:
    """The worst frame's mean |served - reference| in 8-bit codes over
    every compared frame."""
    worst = 0.0
    for key, frames in served.items():
        mad = frame_mad(frames, want[key])
        worst = max(worst, float(mad.max()))
        notes.append(f"compared {key}: {frames.shape[0]} frames, mean |diff|"
                     f" {float(mad.mean()):.4f} codes, worst frame "
                     f"{float(mad.max()):.4f}")
    return {"frame_mad_max": {"value": worst, "limit": limit}}


def chunk_inputs(sc: Scene, chunk: int, device):
    """(background pool, background ids, render ref, foreground ref) of a
    chunk, on the device."""
    s = sc.panel.shape[0]
    panel = torch.as_tensor(sc.panel, device=device)
    return (torch.as_tensor(sc.background[None], device=device),
            torch.zeros((chunk,), dtype=torch.int64, device=device),
            panel[:, s:2 * s], panel[:, :s] * panel[:, 2 * s:])


@torch.inference_mode()
def chunk_layer(synth, sid, sc: Scene, rows, config: dict, device) -> dict:
    """One chunk of coefficient rows through the frame program and G alone,
    by CUDA events with a carried dependence, and the raster kernel alone,
    by CUDA events behind a spin that holds the stream; G's FLOPs and the
    raster's least time from the reference's count of the same inputs."""
    from benchmark.reference import face
    chunk = rows.shape[0]
    s, rs = synth.img_size, config["raster"]["size"]
    ang = torch.as_tensor(face.head_sway(chunk)[0], device=device)
    bg_pool, idx, ref3d, fg = chunk_inputs(sc, chunk, device)
    prog = synth.frame_program_for(sid)
    out = {"frame_program_ms": devicetime.carried_ms(
        lambda c: c + 1e-30 * prog(c, ang, bg_pool, idx, ref3d, fg
                                   ).reshape(-1)[0].float(), rows)}
    fm = face_model_on(sc.face_arrays, device)
    inputs, fg_inputs, (verts, colors, winner) = generator_inputs(
        fm, s, rs, rows, ang, sc.ident, ref3d, fg)
    bgp = bg_pool.expand(chunk, -1, -1, -1) * 2.0 - 1.0
    out["gen_ms"] = devicetime.carried_ms(
        lambda x: x + 1e-30 * synth.gen(x, fg_inputs, bgp)[0].reshape(-1)[0],
        inputs)
    out["gen_flops"] = flops.generator_flops(config["pixrefer"]["ngf"],
                                             chunk, s)
    tri = fm.tri.to(torch.int32).contiguous()
    out["raster_ms"] = devicetime.held_ms(
        lambda: system.render_colors(verts, colors, tri, rs, rs,
                                     synth.raster_group), 20)
    out["raster_bound_ms"] = devicetime.raster_bound_ms(
        verts, colors, tri, winner, rs, rs)[0]
    return out
