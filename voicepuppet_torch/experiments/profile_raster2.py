"""Second raster profile: X1, K1 without the degenerate quirk, timed A/B.

Port of experiments/profile_raster2.py.  Variants:
  A  K1 (baseline)
  B  X1 (``raster_b``): degenerate triangles draw nothing; the bbox walk
     bounds the pixels and the inside test alone decides
  D  X1 depth-only: a 32-bit depth store in place of the 64-bit key, the
     lower-bound signal for the store's cost
X1 runs K1's kernel design (one warp walks the bboxes of 32 consecutive
entries as one balanced list), so B and D against A, printed as X1/K1,
read what the probe changes and nothing else.
Mesh: synthetic_bfm(189, 189, seed=0), 16 frames of demo_coeff(seed=1).

    python -m voicepuppet_torch.experiments.profile_raster2 [--device cpu]
"""

import sys

from voicepuppet_torch import ops
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.face3d import raster as plain
from voicepuppet_torch.ops import raster_probes as probes

MESH, SEED, COEFF_SEED = 189, 0, 1


def main(argv=None):
    args = _common.parse_args(__doc__, argv, MESH)
    verts, tri = _common.probe_mesh(args, SEED, COEFF_SEED)
    f = tri.shape[0]
    h, w = _common.H, _common.W
    cases = {
        "A_production": lambda v: ops.rasterize_winner(v, tri, h, w),
        "B_no_inbox": lambda v: probes.raster_b(v, tri, h, w),
        "D_depth_only": lambda v: probes.raster_b(v, tri, h, w,
                                                  winner=False),
    }
    wa, _ = ops.rasterize_winner(verts, tri, h, w)
    wb, _ = probes.raster_b(verts, tri, h, w)
    deg_won = int(plain.degenerate(verts, tri).sum())
    print(f"winner mismatch fraction A vs B: "
          f"{float((wa != wb).float().mean()):.6f} (expected >0 only from "
          f"degenerate-quirk pixels; {deg_won} degenerate triangle-frames)",
          flush=True)
    per = _common.time_variants(
        cases, verts, args, f"FINAL per-iteration (ms, {args.batch} "
        f"frames, {f} tris, K={args.k})", args.batch * f)
    for name in ("B_no_inbox", "D_depth_only"):
        print(f"  X1/K1 {name}: {per[name] / per['A_production']:.3f}",
              flush=True)
    return per


if __name__ == "__main__":
    main(sys.argv[1:])
