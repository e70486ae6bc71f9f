"""The 3DMM decode and its pieces, timed on the card.

Port of experiments/profile_decode.py: B = 16 frames of
``demo_coeff(seed=1)`` on the 189² synthetic BFM (seed 0), each variant
K times back to back with a carried dependence, interleaved rounds,
per-variant minima (``_timing``, CUDA events).  The JAX script's
"default precision" variant (the TPU's bf16 matmul passes) is the card's
TF32 matmuls here.  The one-ring gather reads the per-triangle normals
padded with the sentinel row ([B, F+1, 3]); the JAX script feeds it the
per-vertex normals, whose out-of-range indices XLA's gather clamps.

    python -m voicepuppet_torch.experiments.profile_decode [--batch 16 --k 16 --rounds 8]
"""

import contextlib
import sys

import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.face3d import morph


@contextlib.contextmanager
def tf32_matmuls():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def decode_cases(fm, coeff, angles):
    """{name: (f, x)} of the JAX script, on the port's decode."""
    b = coeff.shape[0]
    id_c, ex_c, tex_c, _, gamma, translation = morph.split_coeff(coeff)
    face_shape = morph.shape_formation(id_c, ex_c, fm)
    face_tex = morph.texture_formation(tex_c, fm)
    rot = morph.rotation_matrix(angles)
    face_norm = morph.compute_norm(face_shape, fm)
    tri = fm.tri.long()

    def shape_tf32(c):
        with tf32_matmuls():
            return morph.shape_formation(c[:, :80], c[:, 80:144], fm)

    def face_norm_only(fs):
        v1, v2, v3 = fs[:, tri[:, 0]], fs[:, tri[:, 1]], fs[:, tri[:, 2]]
        return torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)

    tri_norm = face_norm_only(face_shape)
    fn_pad = torch.cat([tri_norm, tri_norm.new_zeros((b, 1, 3))], 1)

    return {
        "full_reconstruct_rotation":
            (lambda c: morph.reconstruct_rotation(c, fm, angles).face_color,
             coeff),
        "shape_formation_fp32":
            (lambda c: morph.shape_formation(c[:, :80], c[:, 80:144], fm),
             coeff),
        "shape_formation_tf32": (shape_tf32, coeff),
        "texture_formation":
            (lambda c: morph.texture_formation(c[:, 144:224], fm), coeff),
        "compute_norm_full": (lambda fs: morph.compute_norm(fs, fm),
                              face_shape),
        "corner_gathers_cross": (face_norm_only, face_shape),
        "point_buf_ring_gather":
            (lambda fn: fn[:, fm.point_buf].sum(dim=2), fn_pad),
        "illumination":
            (lambda ft: morph.illumination_layer(ft, face_norm, gamma)[0],
             face_tex),
        "projection":
            (lambda fs: morph.projection_layer(fs, rot, translation)[0],
             face_shape),
    }


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--rounds", type=int, default=8)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    model = _common.face_model_for(args.scale, seed=0)
    fm = morph.device_bfm(model, dev)
    coeff = torch.as_tensor(bfm_mod.demo_coeff(model, batch=args.batch,
                                               seed=1), device=dev)
    angles = torch.zeros((args.batch, 3), device=dev)
    with torch.inference_mode():
        per, mins1, minsk = _common.timed(decode_cases(fm, coeff, angles),
                                          args.k, args.rounds, dev)
    print(f"\nFINAL per-iteration compute (ms, B={args.batch} frames, "
          f"K={args.k}, {model.num_vertices} vertices) on "
          f"{_common.device_line(dev)}:")
    for name, sec in per.items():
        print(f"  {name:32s} {sec * 1e3:9.4f}   (t1={mins1[name] * 1e3:.3f} "
              f"tK={minsk[name] * 1e3:.3f})", flush=True)
    return {name: sec * 1e3 for name, sec in per.items()}


if __name__ == "__main__":
    main(sys.argv[1:])
