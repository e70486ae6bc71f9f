"""Third raster profile: X2, is the per-triangle floor loop overhead?

Port of experiments/profile_raster3.py.  Variants: K1, and X2
(``raster_u``) at the JAX script's four (unroll, fb) settings.  X2 is K1's
design with more work a thread: lane j of a warp builds ``unroll``
consecutive triangles in each of ``fb`` frames (their indices loaded once
for the frames), and the warp walks its 32 x unroll x fb entries as K1's
balanced list, in rounds of 32 slots; at unroll = fb = 1 it is K1's
schedule.  So X2 against K1 reads what the longer list and the
shared index loads change, and nothing else.  Mesh: synthetic_bfm(189,
189, seed=0), 16 frames of demo_coeff(seed=1).

    python -m voicepuppet_torch.experiments.profile_raster3 [--device cpu]
"""

import sys

import torch

from voicepuppet_torch import ops
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.ops import raster_probes as probes

MESH, SEED, COEFF_SEED = 189, 0, 1
# (fb, unroll) of U2_fb8, U4_fb8, U4_fb2, U8_fb4
SETTINGS = ((8, 2), (8, 4), (2, 4), (4, 8))


def main(argv=None):
    args = _common.parse_args(__doc__, argv, MESH)
    verts, tri = _common.probe_mesh(args, SEED, COEFF_SEED)
    f = tri.shape[0]
    h, w = _common.H, _common.W
    cases = {"A_production": lambda v: ops.rasterize_winner(v, tri, h, w)}
    for fb, unroll in SETTINGS:
        cases[f"U{unroll}_fb{fb}"] = (
            lambda v, fb=fb, unroll=unroll: probes.raster_u(
                v, tri, h, w, fb=fb, unroll=unroll))
    wa, da = ops.rasterize_winner(verts, tri, h, w)
    wu, du = probes.raster_u(verts, tri, h, w, fb=8, unroll=4)
    print("U4 winner exact:", torch.equal(wa, wu), "depth exact:",
          torch.equal(da, du), flush=True)
    return _common.time_variants(
        cases, verts, args, f"FINAL per-iteration (ms, {args.batch} "
        f"frames, {f} tris, K={args.k})", args.batch * f)


if __name__ == "__main__":
    main(sys.argv[1:])
