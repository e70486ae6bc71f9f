"""Grouped raster K4 against the per-triangle K1, timed A/B.

Port of experiments/profile_raster_grouped.py.  K4 merges G consecutive
triangles per warp before one atomicMax per pixel; its output is K1's at
every group size.  The port walks whole bboxes, so the TPU's window
sizes, fits preflight and fallback have no counterpart: the variants are
K1 and K4 at groups 4, 8, 16 and 32.  Mesh: synthetic_bfm(189, 189,
seed=0), 16 frames of demo_coeff(seed=1).

    python -m voicepuppet_torch.experiments.profile_raster_grouped [--device cpu]
"""

import sys

import torch

from voicepuppet_torch import ops
from voicepuppet_torch.experiments import _common

MESH, SEED, COEFF_SEED = 189, 0, 1
GROUPS = (4, 8, 16, 32)


def main(argv=None):
    args = _common.parse_args(__doc__, argv, MESH)
    verts, tri = _common.probe_mesh(args, SEED, COEFF_SEED)
    f = tri.shape[0]
    h, w = _common.H, _common.W
    cases = {"pertri": lambda v: ops.rasterize_winner(v, tri, h, w)}
    for g in GROUPS:
        cases[f"g{g}"] = lambda v, g=g: ops.rasterize_winner_grouped(
            v, tri, h, w, group=g)
    wa, da = ops.rasterize_winner(verts, tri, h, w)
    for name, fn in cases.items():
        if name == "pertri":
            continue
        wg, dg = fn(verts)
        print(f"parity {name}: winner {torch.equal(wa, wg)} depth "
              f"{torch.equal(da, dg)}", flush=True)
    return _common.time_variants(
        cases, verts, args, f"FINAL per-iteration (ms, {args.batch} "
        f"frames, {f} tris, K={args.k})", args.batch * f)


if __name__ == "__main__":
    main(sys.argv[1:])
