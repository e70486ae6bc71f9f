"""Phase A of the tile-binned raster question: X3, the shared-memory band
accumulator, against K1, before any binning machinery is built.

Port of experiments/profile_raster_regacc.py.  X3 (``rasterize_regacc``)
runs one block per (frame, chunk of 512 // fb consecutive triangles); the
chunk's win-row band, which starts at its first triangle's aligned window,
is accumulated in shared memory.  The block builds and walks its entries
as K1 does (each bbox clipped to the band, the atomicMax into the band),
then flushes only the union rectangle of the clipped bboxes, so X3
against K1 reads the band accumulator itself, not another walk.  The band
assignment is synthetic, so the output is wrong for an unsorted triangle
order (only a table sorted into bands makes it exact), but the work per
(triangle, frame) entry is a banded kernel's, so its time is the decision
number.

Decision rule (the JAX script's): unless X3 beats K1 by at least 1.3x per
entry, tile binning cannot win, since sorting and binning only add cost.
An 8-row band duplicates each triangle that crosses a band edge, so the
win-8 time is charged that duplication before it is compared.  Mesh:
synthetic_bfm(192, 192, seed=7), 16 frames of demo_coeff(seed=11).

    python -m voicepuppet_torch.experiments.profile_raster_regacc [--device cpu]
"""

import sys

import torch

from voicepuppet_torch import ops
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.ops import raster_probes as probes

MESH, SEED, COEFF_SEED = 192, 7, 11
DECISION_RATIO = 1.3


def band_duplication(verts: torch.Tensor, tri: torch.Tensor, h: int,
                     band: int) -> float:
    """Mean number of ``band``-row aligned bands that a drawing triangle's
    clipped bbox rows touch: the entries a binned kernel would make per
    original entry."""
    ys = verts[:, tri.long(), 1]                          # [B, F, 3]
    y0 = torch.clamp(torch.ceil(ys.amin(-1)), min=0.0)
    y1 = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1.0)
    live = y1 >= y0
    n = torch.floor(y1 / band) - torch.floor(y0 / band) + 1
    return float(n[live].mean())


def main(argv=None):
    args = _common.parse_args(__doc__, argv, MESH)
    verts, tri = _common.probe_mesh(args, SEED, COEFF_SEED)
    f = tri.shape[0]
    h, w = _common.H, _common.W
    print(f"mesh: {f} triangles x {args.batch} frames", flush=True)
    cases = {
        "production win16": lambda v: ops.rasterize_winner(v, tri, h, w),
        "regacc win16 fb8": lambda v: probes.rasterize_regacc(
            v, tri, h, w, win=16, fb=8),
        "regacc win16 fb4": lambda v: probes.rasterize_regacc(
            v, tri, h, w, win=16, fb=4),
        "regacc win8 fb8": lambda v: probes.rasterize_regacc(
            v, tri, h, w, win=8, fb=8),
    }
    per = _common.time_variants(
        cases, verts, args, f"REGACC A/B ({f} tris x {args.batch} frames, "
        f"K={args.k})", args.batch * f)
    dup8 = band_duplication(verts, tri, h, 8)
    k1 = per["production win16"]
    r16 = k1 / per["regacc win16 fb8"]
    r8 = k1 / (per["regacc win8 fb8"] * dup8)
    print(f"decision: K1 / regacc win16 fb8 = {r16:.3f}; K1 / (regacc win8 "
          f"fb8 x 8-row band duplication {dup8:.3f}) = {r8:.3f}; tile "
          f"binning worth building only at >= {DECISION_RATIO}: "
          f"{max(r16, r8) >= DECISION_RATIO}", flush=True)
    return per


if __name__ == "__main__":
    main(sys.argv[1:])
