"""K1 profile: the flat raster at 224², on canvases 128 and 256 wide, and
the render_colors_xband entry, timed A/B.

Port of experiments/profile_raster.py.  That script's fb and win
variants are TPU layout knobs that the port ignores (ops/raster.py), so
they collapse into K1.  Mesh: synthetic_bfm(189, 189, seed=0), 16 frames
of demo_coeff(seed=1).

    python -m voicepuppet_torch.experiments.profile_raster [--device cpu]
"""

import sys

from voicepuppet_torch import ops
from voicepuppet_torch.experiments import _common

MESH, SEED, COEFF_SEED = 189, 0, 1


def main(argv=None):
    args = _common.parse_args(__doc__, argv, MESH)
    verts, tri, colors = _common.probe_mesh(args, SEED, COEFF_SEED,
                                            colors=True)
    f = tri.shape[0]
    h, w = _common.H, _common.W
    print(f"tris: {f} verts: {tuple(verts.shape)}", flush=True)
    cases = {
        "k1_224": lambda v: ops.rasterize_winner(v, tri, h, w),
        "k1_w128": lambda v: ops.rasterize_winner(v, tri, h, 128),
        "k1_w256": lambda v: ops.rasterize_winner(v, tri, h, 256),
        "k1_xband_render": lambda v: ops.render_colors_xband(v, colors, tri,
                                                             h, w),
    }
    return _common.time_variants(
        cases, verts, args, f"FINAL per-iteration (ms, B={args.batch} "
        f"frames, {f} tris, K={args.k})", args.batch * f)


if __name__ == "__main__":
    main(sys.argv[1:])
