"""The frame program's tail and the 3DMM decode's pieces at the serving
shapes (chunk 16, 224² raster, 512² frames, bf16 G), timed on the card.

Port of experiments/profile_frame_tail.py.  Variants: the whole frame
program (``Synthesizer.frame_program``, K1 included), the decode
(``reconstruct_rotation``) and its pieces: the corner gathers
``face_shape[:, tri[:, k]]``, the corner-basis form (the PCA rows and
mean gathered per triangle corner once, so the corners come out of one
einsum with no per-frame gather; it must equal the gather form to 1e-5
of the corners' scale before it is timed), the face normals of each
form, the one-ring gather and ``compute_norm``; then the tail stages
alone: the linear resize (identity at the demo identity's 224 and a
real one to 320), the paste, the channel assembly, the YUV 4:2:0 pack,
and the tail as a whole.  Each variant K times back to back with a
carried dependence, interleaved rounds, per-variant minima
(``_timing``).

    python -m voicepuppet_torch.experiments.profile_frame_tail [--chunk 16 --k 8]
"""

import sys

import numpy as np
import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.face3d import morph
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.pipeline import synthesize as syn

RS = 224
CORNER_REL_BAND = 1e-5


def corner_basis_tables(model, device):
    """The id|ex PCA rows [F, 3 corners, 3 xyz, 144] and the recentred
    mean [F, 3, 3] gathered per triangle corner (static, made once)."""
    idb = np.asarray(model.idBase, np.float32).reshape(-1, 3, 80)
    exb = np.asarray(model.exBase, np.float32).reshape(-1, 3, 64)
    mean = np.asarray(model.meanshape, np.float32).reshape(-1, 3)
    mean = mean - mean.mean(axis=0, keepdims=True)
    tri = np.asarray(model.tri, np.int64) - 1
    basis = np.concatenate([idb, exb], axis=-1)[tri]
    return (torch.as_tensor(basis, device=device),
            torch.as_tensor(mean[tri], device=device))


def corner_verts_basis(id_ex, basis, mean):
    """[B, 144] id|ex coefficients -> corners [B, F, 3c, 3xyz]."""
    return torch.einsum("tcxk,bk->btcx", basis, id_ex) + mean[None]


def corner_verts_gather(face_shape, tri):
    return (face_shape[:, tri[:, 0]], face_shape[:, tri[:, 1]],
            face_shape[:, tri[:, 2]])


def corner_basis_error(fm, basis, mean, coeff):
    """(max |basis corner - gathered corner|, the corners' max |value|)."""
    fs = morph.shape_formation(coeff[:, :80], coeff[:, 80:144], fm)
    gathered = corner_verts_gather(fs, fm.tri.long())
    vb = corner_verts_basis(coeff[:, :144], basis, mean)
    err = max(float((vb[:, :, k] - v).abs().max())
              for k, v in enumerate(gathered))
    return err, float(gathered[0].abs().max())


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    c = args.chunk
    cfg = _common.config_for(args.scale)
    s = cfg.pixrefer.img_size
    model = _common.face_model_for(args.scale, seed=0)
    synth, identity = syn.SynthesisAssets.demo(cfg, face_model=model,
                                               chunk=c, device=dev)
    fm = synth.fm
    tri = fm.tri.long()
    coeff = torch.as_tensor(bfm_mod.demo_coeff(model, batch=c, seed=1),
                            device=dev)
    angles = torch.zeros((c, 3), device=dev)
    basis, mean = corner_basis_tables(model, dev)
    rng = np.random.RandomState(0)
    face224 = torch.as_tensor(rng.rand(c, RS, RS, 3).astype(np.float32),
                              device=dev)
    frames = torch.as_tensor(np.random.RandomState(1).rand(
        c, s, s, 3).astype(np.float32), device=dev)
    bg_pool = torch.zeros((1, s, s, 3), device=dev)
    bg_idx = torch.zeros((c,), dtype=torch.int64, device=dev)
    ref3 = torch.zeros((s, s, 3), device=dev)
    prog = synth.frame_program_for(identity)
    (ty0, ty1, tx0, tx1), (sy0, sy1, sx0, sx1) = syn._paste_geometry(
        RS, s // 2, s // 2, 0, 0, s)

    def shape_of(co):
        return morph.shape_formation(co[:, :80], co[:, 80:144], fm)

    def face_norm_gather(fs):
        v1, v2, v3 = corner_verts_gather(fs, tri)
        return torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)

    def face_norm_basis(id_ex):
        v = corner_verts_basis(id_ex, basis, mean)
        return torch.linalg.cross(v[:, :, 0] - v[:, :, 1],
                                  v[:, :, 1] - v[:, :, 2], dim=-1)

    def one_ring(face_norm):
        fn = torch.cat([face_norm, face_norm.new_zeros((c, 1, 3))], 1)
        v = fn[:, fm.point_buf].sum(dim=2)
        return v / torch.linalg.norm(v, dim=2, keepdim=True)

    def stage_paste(x):
        canvas = torch.zeros((c, s, s, 3), device=dev)
        canvas[:, ty0:ty1, tx0:tx1] = x[:, sy0:sy1, sx0:sx1]
        return canvas

    def stage_assembly(canvas):
        ref = ref3[None].expand(c, -1, -1, -1)
        inputs = torch.cat([ref, canvas], dim=-1)
        fg_inputs = torch.cat([ref, torch.zeros_like(ref)], dim=-1)
        return px.preprocess(inputs), px.preprocess(fg_inputs)

    def tail_whole(x):
        a, b = stage_assembly(stage_paste(syn.resize_linear(x, RS)))
        return a[:, 0, 0, 0] + b[:, 0, 0, 0]

    with torch.inference_mode():
        err, scale = corner_basis_error(fm, basis, mean, coeff)
        print(f"corner-basis max |diff| = {err:.3e} (scale {scale:.3e})",
              flush=True)
        if not err <= CORNER_REL_BAND * scale:
            raise AssertionError(f"corner-basis corners off the gathered "
                                 f"ones by {err} (scale {scale})")
        fs = shape_of(coeff)
        cases = {
            "frame_program_whole": (
                lambda co: prog(co, angles, bg_pool, bg_idx, ref3, ref3),
                coeff),
            "decode_whole": (
                lambda co: morph.reconstruct_rotation(
                    co, fm, angles, image_size=float(RS)).face_color, coeff),
            "shape_formation": (shape_of, coeff),
            "corner_gather": (lambda f: corner_verts_gather(f, tri), fs),
            "corner_basis": (lambda ie: corner_verts_basis(ie, basis, mean),
                             coeff[:, :144].contiguous()),
            "face_norm_gather": (face_norm_gather, fs),
            "face_norm_basis": (face_norm_basis,
                                coeff[:, :144].contiguous()),
            "one_ring_gather": (one_ring, face_norm_gather(fs)),
            "compute_norm_whole": (lambda f: morph.compute_norm(f, fm), fs),
            "tail_resize_identity": (lambda x: syn.resize_linear(x, RS),
                                     face224),
            "tail_resize_320": (lambda x: syn.resize_linear(x, 320),
                                face224),
            "tail_paste": (stage_paste, face224),
            "tail_assembly": (stage_assembly, stage_paste(face224)),
            "tail_pack_yuv420": (syn._pack_yuv420, frames),
            "tail_whole": (tail_whole, face224),
        }
        per, mins1, minsk = _common.timed(cases, args.k, args.rounds, dev)
    synth.close()
    print(f"\nFINAL ms per iteration (K={args.k}, chunk C={c}, {s}², G "
          f"{synth.gen.generator.dtype}) on {_common.device_line(dev)}:")
    for name, sec in per.items():
        print(f"  {name:24s} {sec * 1e3:9.4f} ms   (t1="
              f"{mins1[name] * 1e3:.3f} tK={minsk[name] * 1e3:.3f})",
              flush=True)
    out = {name: sec * 1e3 for name, sec in per.items()}
    out["corner_basis_err"] = err
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
