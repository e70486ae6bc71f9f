"""On-card parity gate for the CUDA raster kernels.

Counterpart of ``voicepuppet_tpu/ops/raster_selftest.py``.  The quirk
meshes below are own numpy copies of that module's cases and of the
x-band and grouped cases in ``tests/test_raster.py``: depth ties, a
degenerate triangle, colour truncation, occlusion order, seam ties, the
low-bit-y mesh, an edge through pixel centres, a narrow canvas, random
soups, triangles taller or wider than 128 px, a triangle order with no
screen locality and an in-group depth tie; and, of the port's own, a
three-frame case that puts every kind of K4/K5 tile into one warp
(``grouped_mixed_tiles``) and one, at 96² and 224², that lays out the
warps of K1/K3's balanced walk (``walk_balance``: large, degenerate,
one-pixel, empty, NaN-cornered and tied entries in one warp, warps across
frames, a warp with nothing to draw, a ragged last warp).

``run_selftest(device)`` builds each case on ``device`` and holds every
CUDA kernel, through every entry point of ``ops/raster.py``, against its
plain version (``face3d/raster.py``) on the same tensors: the flat kernel
K1, the grouped K4 at several group sizes, the interpolated-depth K3 and
its grouped form K5.  Both sides evaluate the inside test and the
interpolated depth in the same unfused float32 order, so the contract is
bit for bit on every case, soups included: winner ids, depths, image and
mask; and K4 must equal K1, K5 equal K3.  (Against the sequential spec
``raster_ref``, whose barycentrics are float64, the soups and the
low-bit-y mesh may differ at pixels whose centre lies within ~1e-5 of an
edge, and interpolated depths at exact ties; tests/test_torch_raster*.py
hold the plain versions to that spec on the CPU.)

``run_probe_selftest(device)`` does the same for the raster A/B probes
(``ops/raster_probes.py``) on every case above and on a band-fitting
case: X1 in both modes, X2 at every (fb, unroll), X3 at each of
``REGACC_SETTINGS`` and ``REGACC_LISTS``, each bit for bit against its
plain version, X2 and X1 (off degenerate winners) against K1, and X3
against K1 where every chunk fits its band.

``walk_entries``, ``walk_schedule`` and ``bbox_position`` are a CPU model
of the balanced warp walk (``walk_list`` in ``csrc/raster.cu``) for the
tests: which bbox pixels each list's lanes visit, in how many steps.
K1/K3's lists are warps of 32 entries in flat order, and so are X1's
(``inside_only_walk_kernel``), whose entries ``inside_only_entries``
gives (degenerate triangles with area 0); ``unroll_order``
gives X2's (``unroll_walk_kernel``: each lane building ``unroll``
triangles in ``fb`` frames, walked in rounds of 32 slots, one entry a
lane, or in lists of any power of two for the tests), and ``band_boxes`` X3's
(``band_walk_kernel``: one list a block, the bboxes clipped to each
chunk's band, and each block's union rectangle).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

H = W = 96
WIDE_W = 224
N_SOUP = 256

Case = Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]


def soup(seed: int = 0, n: int = N_SOUP, w: int = W, x0: float = 4.0,
         max_span: float = 8.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic triangle soup: spans <= ``max_span``, corners on a
    quarter-pixel grid nudged off pixel centres, distinct depths."""
    rng = np.random.default_rng(seed)
    anchor = rng.uniform([x0, 4.0], [w - max_span - 6.0,
                                     H - max_span - 6.0], (n, 2))
    offs = rng.uniform(1.0, max_span - 1.0, (n, 2, 2))
    pts = np.concatenate([anchor[:, None], anchor[:, None] + offs], 1)
    pts = np.floor(pts * 4.0) / 4.0 + 0.3
    depth = np.repeat(rng.uniform(1.0, 50.0, (n, 1)), 3, 1)[..., None]
    verts = np.concatenate([pts, depth], -1).reshape(-1, 3)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    colors = np.repeat(rng.integers(0, 256, (n, 1, 3)), 3, 1)
    return (verts.astype(np.float32), tris,
            colors.reshape(-1, 3).astype(np.float32))


def low_bit_y_mesh() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triangles whose y carries 2^-17-grade low bits, with exact depth
    ties, so winner identity hangs on bit-exact inside tests."""
    rng = np.random.default_rng(7)
    n = 96
    anchor = rng.uniform([100.0, 8.0], [200.0, 200.0], (n, 2))
    offs = rng.uniform(2.0, 14.0, (n, 2, 2))
    offs[..., 1] = np.clip(offs[..., 1], 2.0, 8.0)
    pts = np.concatenate([anchor[:, None], anchor[:, None] + offs], 1)
    pts = np.float32(np.floor(pts * 4) / 4)
    pts[..., 1] += np.float32(2.0 ** -17) * rng.integers(
        0, 8, (n, 3)).astype(np.float32)
    verts = np.concatenate(
        [pts.reshape(-1, 2), np.full((3 * n, 1), 5.0, np.float32)],
        axis=1).astype(np.float32)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    colors = np.repeat(rng.uniform(0, 255, (n, 1, 3)), 3, axis=1
                       ).reshape(-1, 3).astype(np.float32)
    return verts, tris, colors


def _soup_case(seed: int, w: int = W) -> Case:
    v, t, c = soup(seed=seed, w=w)
    return v, t, c, H, w


def _tall_guard() -> Case:
    v, t, c = soup(seed=1)
    v = v.copy()
    v[t[0], :2] = [[W * 0.5, 2.3], [W * 0.25, H - 3.3], [W * 0.75, H - 5.3]]
    v[t[0], 2] = 0.5
    return v, t, c, H, W


def _wide_triangle() -> Case:
    v, t, c = soup(seed=2, w=WIDE_W)
    v = v.copy()
    v[t[0], :2] = [[60.3, H * 0.4], [180.3, H * 0.3], [120.3, H * 0.6]]
    v[t[0], 2] = 0.5
    return v, t, c, H, WIDE_W


def _huge_triangle() -> Case:
    """A triangle taller and wider than 128 px over a soup at 224²."""
    v, t, c = soup(seed=4, w=WIDE_W)
    v = v.copy()
    v[:, 1] = v[:, 1] * 2.2
    v[t[0], :2] = [[5.3, 3.7], [219.6, 40.2], [60.1, 220.9]]
    v[t[0], 2] = 30.0
    return v, t, c, 224, WIDE_W


def _degenerate_truncation_tie() -> Case:
    v = np.array([
        [10.0, 10.0, 1.0], [14.0, 10.0, 1.0], [12.0, 10.0, 1.0],  # degen
        [2.0, 14.0, 1.0], [20.0, 14.0, 1.0], [2.0, 30.0, 1.0],    # A
        [2.0, 14.0, 1.0], [20.0, 14.0, 1.0], [2.0, 30.0, 1.0],    # B = tie
    ], np.float32)
    t = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    c = np.array([[90.0]] * 3 + [[9.0], [9.0], [10.0]] + [[200.0]] * 3,
                 np.float32)
    return v, t, c, 32, 32


def _occlusion_far_first() -> Case:
    v = np.array([[2.0, 2.0, 5.0], [28.0, 2.0, 5.0], [2.0, 28.0, 5.0],
                  [2.0, 2.0, 1.0], [28.0, 2.0, 1.0], [2.0, 28.0, 1.0]],
                 np.float32)
    c = np.array([[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[3, 4, 5], [0, 1, 2]], np.int32), c, 32, 32


def _seam(za: float, zb: float) -> Case:
    tri_a = [[90.0, 10.0], [120.0, 10.0], [105.0, 40.0]]
    tri_b = [[100.0, 5.0], [126.0, 20.0], [96.5, 35.0]]
    v = np.array([p + [za] for p in tri_a] + [p + [zb] for p in tri_b],
                 np.float32)
    c = np.array([[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32), c, 48, WIDE_W


def _edge_through_pixel_centers() -> Case:
    eps = np.float32(2.0 ** -17)
    v = np.array([[104.0, 40.0 - eps, 5.0], [120.0, 52.0 - eps, 5.0],
                  [118.0, 42.0, 5.0]], np.float32)
    return (v, np.array([[0, 1, 2]], np.int32),
            np.full((3, 3), 90.0, np.float32), 224, 224)


def _narrow_canvas() -> Case:
    v = np.array([[2.0, 2.0, 1.0], [28.0, 2.0, 1.0], [2.0, 28.0, 1.0]],
                 np.float32)
    return (v, np.array([[0, 1, 2]], np.int32),
            np.full((3, 3), 90.0, np.float32), 32, 96)


def _low_bit_y() -> Case:
    v, t, c = low_bit_y_mesh()
    return v, t, c, 224, 224


WALK_FRAMES, WALK_TRIS = 3, 37
# triangle_kernel's warps at F = 37 over 3 frames (entry b * 37 + f):
#   0: frame 0, 0-31          the mix below
#   1: frame 0, 32-36 + frame 1, 0-26   straddles frames
#   2: frame 1, 27-36 + frame 2, 0-21   no live triangle
#   3: frame 2, 22-36         ragged: 15 entries
# The drawing triangles of a 96² canvas (doubled at 224²): corners and
# flat depth; each frame moves each one by its own quarter pixels.
_WALK_DRAWING = {
    0: ([[6.3, 8.3], [70.3, 20.3], [30.3, 66.3]], 4.0),     # bbox 65 x 58
    # degenerate: p2 - p0 = 2 (p1 - p0) exactly, so deno == 0 and the whole
    # 16 x 8 bbox draws
    1: ([[10.25, 20.25], [18.25, 24.25], [26.25, 28.25]], 7.0),
    # an exact depth tie across two slots over an overlap
    2: ([[40.3, 10.3], [56.3, 14.3], [44.3, 26.3]], 6.0),
    3: ([[40.55, 10.3], [56.55, 14.3], [44.55, 26.3]], 6.0),
    # one pixel centre in its bbox at either size; it does not move
    4: ([[40.9, 40.9], [41.3, 41.0], [41.0, 41.3]], 9.0),
    # behind the depth init: dead in K1, walked in K3, drawing in neither
    11: ([[20.3, 60.3], [34.3, 62.3], [24.3, 74.3]], -2e5),
}
# the slots of warps 0 and 1 that take the eight empty kinds below
_WALK_EMPTY_SLOTS = (5, 6, 7, 8, 9, 10, 12, 13)


def _walk_empty(kind: int, size: int) -> list:
    """Eight triangles that never draw, in K1 or K3, on a size² canvas."""
    s = float(size)
    return [
        [[-30.0, 40.0], [-20.0, 40.0], [-25.0, 48.0]],          # left of it
        [[s + 5.0, 40.0], [s + 15.0, 40.0], [s + 9.0, 48.0]],   # right
        [[40.0, -20.0], [50.0, -20.0], [45.0, -12.0]],          # above
        [[40.0, s + 4.0], [50.0, s + 4.0], [45.0, s + 12.0]],   # below
        [[np.nan, 40.0], [50.0, 40.0], [45.0, 48.0]],           # NaN x
        [[70.0, 40.0], [80.0, np.nan], [75.0, 48.0]],           # NaN y
        [[60.2, 30.2], [60.7, 30.4], [60.4, 30.8]],   # no pixel centre
        [[30.0, 50.5], [40.0, 50.5], [35.0, 50.5]],   # degenerate, no row
    ][kind % 8]


def walk_balance(size: int = W) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Three frames of 37 triangles for a size² canvas (96 or 224) ->
    (vertices [3,111,3], triangles [37,3], colours [3,111,3]), laid out for
    triangle_kernel's balanced walk (the table above).  Warp 0 mixes a
    triangle whose bbox is 65 x 58 px (130 x 116 at 224²), a degenerate
    one covering its whole bbox, a one-pixel one, an exact depth tie
    across two slots, a bbox-empty sliver, triangles off each side of the
    canvas, NaN-cornered ones and one behind the depth init, among a soup
    of 2-14 px triangles; warp 1 holds the same mix moved; warp 2 holds no
    live triangle; warp 3 is ragged."""
    rng = np.random.default_rng(17)
    scale = 1.0 if size < 2 * W else 2.0
    verts = np.zeros((WALK_FRAMES, WALK_TRIS, 3, 3), np.float32)
    anchor = rng.uniform(4.0, 78.0, (WALK_TRIS, 2))
    span = rng.uniform(1.0, 13.0, (WALK_TRIS, 2, 2))
    soup_z = rng.permutation(WALK_TRIS) * 0.25 + 1.0
    for b in range(WALK_FRAMES):
        shift = 0.25 * rng.integers(-2, 3, (WALK_TRIS, 2))
        shift[3] = shift[2]                      # the tie moves as one
        shift[4] = 0.0
        for f in range(WALK_TRIS):
            if (b == 1 and f >= 27) or (b == 2 and f <= 21):   # warp 2
                verts[b, f, :, :2] = _walk_empty(f, size)
                verts[b, f, :, 2] = 1.0
            elif f in _WALK_EMPTY_SLOTS:
                verts[b, f, :, :2] = _walk_empty(
                    _WALK_EMPTY_SLOTS.index(f), size)
                verts[b, f, :, 2] = 1.0
            else:
                if f in _WALK_DRAWING:
                    pts, z = _WALK_DRAWING[f]
                    off = 0.0
                else:
                    pts = np.concatenate([anchor[f, None],
                                          anchor[f, None] + span[f]])
                    pts, z, off = np.floor(pts * 4.0) / 4.0, soup_z[f], 0.3
                # quarter-pixel corners, the soup's nudged off pixel centres
                verts[b, f, :, :2] = (np.array(pts) + shift[f]) * scale + off
                verts[b, f, :, 2] = z
    colors = rng.integers(0, 256, (WALK_FRAMES, WALK_TRIS * 3, 3))
    return (verts.reshape(WALK_FRAMES, WALK_TRIS * 3, 3),
            np.arange(3 * WALK_TRIS, dtype=np.int32).reshape(WALK_TRIS, 3),
            colors.astype(np.float32))


CASES: Dict[str, Callable[[], Case]] = {
    "soup": lambda: _soup_case(0),
    "tall_guard": _tall_guard,
    "xband_soup": lambda: _soup_case(2, WIDE_W),
    "xband_wide_triangle": _wide_triangle,
    "huge_triangle": _huge_triangle,
    "degenerate_truncation_tie": _degenerate_truncation_tie,
    "occlusion_far_first": _occlusion_far_first,
    "seam_near_a": lambda: _seam(5.0, 1.0),
    "seam_near_b": lambda: _seam(1.0, 5.0),
    "seam_tie": lambda: _seam(3.0, 3.0),
    "edge_through_pixel_centers": _edge_through_pixel_centers,
    "narrow_canvas": _narrow_canvas,
    "low_bit_y": _low_bit_y,
    "walk_balance": lambda: walk_balance(W) + (W, W),
    "walk_balance_wide": lambda: walk_balance(WIDE_W) + (WIDE_W, WIDE_W),
}


def _scattered_order() -> Case:
    """Two triangles of one group 60 rows apart (tests/test_raster.py:242):
    the TPU falls back per triangle; here K4 walks each member's bbox."""
    v = np.array([[4.0, 2.0, 1.0], [28.0, 2.0, 1.0], [4.0, 10.0, 1.0],
                  [4.0, 62.0, 2.0], [28.0, 62.0, 2.0], [4.0, 70.0, 2.0]],
                 np.float32)
    c = np.array([[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32), c, 96, 96


def _in_group_tie() -> Case:
    """Six overlapping same-depth triangles over two groups of four
    (tests/test_raster.py:267): the lowest id owns the overlap."""
    base = np.array([[4.0, 4.0, 1.0], [28.0, 4.0, 1.0], [4.0, 28.0, 1.0]],
                    np.float32)
    v = np.concatenate([base + np.array([i * 0.25, 0.0, 0.0], np.float32)
                        for i in range(6)], axis=0)
    c = np.concatenate([np.full((3, 1), 40.0 + 10 * i, np.float32)
                        for i in range(6)], axis=0)
    return v, np.arange(18, dtype=np.int32).reshape(6, 3), c, 64, 64


def _degenerate_occlusion() -> Case:
    """A zero-area triangle, then a near and a far one
    (tests/test_raster.py:301)."""
    v = np.array([
        [10.0, 10.0, 1.0], [14.0, 10.0, 1.0], [12.0, 10.0, 1.0],  # degen
        [2.0, 2.0, 5.0], [28.0, 2.0, 5.0], [2.0, 28.0, 5.0],      # near
        [2.0, 2.0, 1.0], [28.0, 2.0, 1.0], [2.0, 28.0, 1.0],      # far
    ], np.float32)
    c = np.array([[90.0]] * 3 + [[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32), c, 32, 32


_MIXED_FRAMES = 3
# the corners of the triangles that draw: (x, y) anchor, width, height and
# flat depth; the quarter-pixel jitter of each frame moves them
_MIXED_DRAWING = {
    # 0-7 compact: overlapping, the depth ties 0 = 1 and 4 = 5 in one group
    # at G = 3, 4 and 8
    0: (10, 20, 12, 11, 5.0), 1: (12, 22, 11, 12, 5.0),
    2: (16, 19, 10, 10, 3.0), 3: (9, 26, 12, 10, 7.0),
    4: (14, 25, 12, 11, 6.0), 5: (17, 27, 10, 12, 6.0),
    6: (11, 30, 12, 9, 2.0), 7: (20, 23, 10, 11, 4.0),
    # 8-15 scattered: rows 3-11 on the left, rows 76-84 on the right
    **{8 + i: ((6 + 4 * i, 3) if i % 2 == 0 else (58 + 3 * i, 76))
       + (8, 8, 10.0 + i) for i in range(8)},
    # 24-31 compact over the first cluster: 26 lies behind the depth init
    # (never draws), 28 ties triangles 0 and 1 from another group
    24: (22, 28, 11, 10, 4.5), 25: (26, 32, 10, 12, 8.0),
    26: (20, 30, 12, 12, -2e5), 27: (30, 36, 11, 11, 3.5),
    28: (14, 21, 10, 10, 5.0), 29: (32, 28, 10, 10, 9.0),
    30: (24, 40, 12, 10, 1.0), 31: (34, 42, 10, 11, 6.5),
    # 32-37 the ragged last group, one over the second cluster
    32: (40, 50, 12, 11, 2.5), 33: (44, 54, 11, 12, 7.5),
    34: (48, 52, 10, 10, 5.5), 35: (36, 44, 12, 10, 8.5),
    36: (52, 60, 10, 12, 4.0), 37: (46, 62, 12, 11, 3.0),
}
# 16-23: the all-empty group, the same in every frame
_MIXED_EMPTY = {
    16: [[-30.0, 40.0], [-20.0, 40.0], [-25.0, 48.0]],   # left of the canvas
    17: [[30.0, 50.5], [40.0, 50.5], [35.0, 50.5]],      # degenerate, no row
    18: [[np.nan, 40.0], [50.0, 40.0], [45.0, 48.0]],    # NaN corner
    19: [[40.0, 100.0], [50.0, 100.0], [45.0, 108.0]],   # below it
    20: [[60.2, 30.2], [60.7, 30.4], [60.4, 30.8]],      # no pixel centre
    21: [[101.0, 40.0], [110.0, 40.0], [105.0, 48.0]],   # right of it
    22: [[70.0, 40.0], [80.0, np.nan], [75.0, 48.0]],    # NaN corner
    23: [[40.0, -20.0], [50.0, -20.0], [45.0, -12.0]],   # above it
}


def grouped_mixed_tiles() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Three frames of 38 triangles for a 96² canvas -> (vertices [3,114,3],
    triangles [38,3], colours [3,114,3]).  At G = 3, 4 and 8 the first
    warp's tiles of each frame (triangles 0-23) hold compact groups, in-group
    depth ties, scattered groups (members >= 60 rows apart) and an all-empty
    group (off the canvas, a degenerate triangle between rows, NaN corners,
    a sliver between pixel centres).  38 is no multiple of 3, 4 or 8, so the
    last group is ragged, tiles straddle frames and the last warp holds
    tiles past the end.  Each frame moves the drawing corners by its own
    quarter pixels (off pixel centres by 0.3); no triangle is 25 rows tall,
    so the TPU grouped path does not crop."""
    rng = np.random.default_rng(13)
    n = len(_MIXED_DRAWING) + len(_MIXED_EMPTY)
    verts = np.zeros((_MIXED_FRAMES, n, 3, 3), np.float32)
    for f, pts in _MIXED_EMPTY.items():
        verts[:, f, :, :2] = pts
        verts[:, f, :, 2] = 1.0
    for b in range(_MIXED_FRAMES):
        for f, (x, y, sx, sy, z) in _MIXED_DRAWING.items():
            pts = np.array([[x, y], [x + sx, y + 0.5 * sy],
                            [x + 0.25 * sx, y + sy]])
            verts[b, f, :, :2] = pts + 0.3 + 0.25 * rng.integers(-2, 3, (3, 2))
            verts[b, f, :, 2] = z
    colors = rng.integers(0, 256, (_MIXED_FRAMES, n * 3, 3))
    return (verts.reshape(_MIXED_FRAMES, n * 3, 3),
            np.arange(3 * n, dtype=np.int32).reshape(n, 3),
            colors.astype(np.float32))


GROUPED_CASES: Dict[str, Callable[[], Case]] = {
    "grouped_scattered_order": _scattered_order,
    "grouped_in_group_tie": _in_group_tie,
    "grouped_degenerate_occlusion": _degenerate_occlusion,
    "grouped_mixed_tiles": lambda: grouped_mixed_tiles() + (96, 96),
}

# the interp-depth soup of voicepuppet_tpu/ops/raster_selftest.py:325
INTERP_CASES: Dict[str, Callable[[], Case]] = {
    "interp_soup": lambda: _soup_case(3),
}

# group sizes run through K4/K5 on every case: one member, a group narrower
# than its 4-lane tile, the serving size, 8-lane tiles, a full-warp tile,
# and more members than a warp's lanes (two batches per group)
GROUP_SIZES = (1, 3, 4, 8, 32, 33)

# X3's (win, fb) settings: profile_raster_regacc.py's three variants
REGACC_SETTINGS = ((16, 8), (16, 4), (8, 8))
# and those the on-card gate adds: walk lists of 512, 256 and 32 slots
# (chunks of 512, 256 and 32), the first two past 48 KB of shared memory
REGACC_LISTS = ((8, 1), (16, 2), (32, 16))


def band_fitting_mesh() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A soup for a 64² canvas: 8 runs of 64 consecutive triangles, run k
    drawn only in rows 8k+1 .. 8k+6 (corners on a quarter-pixel grid,
    distinct depths).  Every chunk of 64 or 128 consecutive triangles then
    lies inside the 8- or 16-row band that starts at its first triangle's
    aligned origin, so X3 at each of REGACC_SETTINGS equals K1 on it."""
    rng = np.random.default_rng(5)
    per_band, w = 64, 64
    pts = []
    for k in range(8):
        anchor = rng.uniform([2.0, 8.0 * k], [w - 10.0, 8.0 * k + 0.5],
                             (per_band, 2))
        offs = np.stack([rng.uniform(1.0, 7.0, (per_band, 2)),
                         rng.uniform(1.0, 6.0, (per_band, 2))], -1)
        pts.append(np.concatenate([anchor[:, None], anchor[:, None] + offs],
                                  1))
    pts = np.floor(np.concatenate(pts) * 4.0) / 4.0 + 0.3
    n = pts.shape[0]
    depth = np.repeat(rng.permutation(n)[:, None] + 1.0, 3, 1)[..., None]
    verts = np.concatenate([pts, depth], -1).reshape(-1, 3)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    colors = np.repeat(rng.integers(0, 256, (n, 1, 3)), 3, 1)
    return (verts.astype(np.float32), tris,
            colors.reshape(-1, 3).astype(np.float32))


PROBE_CASES: Dict[str, Callable[[], Case]] = {
    "band_fitting": lambda: band_fitting_mesh() + (64, 64),
}


def sphere_uv(num_theta: int, num_phi: int, tex_h: int, tex_w: int
              ) -> np.ndarray:
    """Texture coordinates [V, 2] (x, y in texels) for ``synthetic_bfm``'s
    sphere patch: vertex i*num_phi + j sits at its (phi, theta) grid
    position, so its triangles double as the texture triangles."""
    i, j = np.meshgrid(np.arange(num_theta), np.arange(num_phi),
                       indexing="ij")
    u = j.reshape(-1) * ((tex_w - 1.0) / (num_phi - 1))
    v = i.reshape(-1) * ((tex_h - 1.0) / (num_theta - 1))
    return np.stack([u, v], -1).astype(np.float32)


def expect_equal(got: torch.Tensor, want: torch.Tensor, label: str):
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    bad = got != want
    if bool(bad.any()):
        first = tuple(int(i) for i in bad.nonzero()[0])
        raise AssertionError(f"{label}: {int(bad.sum())}/{bad.numel()} "
                             f"elements differ (first at {first})")


def _expect_pair(got, want, label: str):
    for g, w_, part in zip(got, want, ("winner", "depth")):
        expect_equal(g, w_, f"{label} {part}")


def check_against_plain(vertices: torch.Tensor, colors: torch.Tensor,
                        triangles: torch.Tensor, h: int, w: int,
                        label: str, groups=GROUP_SIZES) -> int:
    """Hold every kernel entry point against its plain version on the same
    CUDA tensors, bit for bit: K1 (flat), K4 at each of ``groups`` (equal
    to K1), K3 (interpolated depth) and K5 at each of ``groups`` (equal to
    K3).  Returns the flat raster's covered pixel count."""
    if vertices.device.type != "cuda":
        raise ValueError("the selftest compares the CUDA kernel: pass "
                         "tensors on a CUDA device")
    return _check_entry_points(vertices, colors, triangles, h, w, label,
                               groups)


def _check_entry_points(vertices: torch.Tensor, colors: torch.Tensor,
                        triangles: torch.Tensor, h: int, w: int,
                        label: str, groups=GROUP_SIZES) -> int:
    """:func:`check_against_plain` on any device: on CPU tensors the entry
    points dispatch to the plain versions, so what is held there is the
    dispatch and the plain grouped and interpolated forms against the
    flat and per-triangle ones."""
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.ops import raster as kern
    flat = plain.rasterize_winner(vertices, triangles, h, w)
    want_img, want_mask = plain.flat_color_image(flat[0], colors, triangles)
    _expect_pair(kern.rasterize_winner(vertices, triangles, h, w), flat,
                 f"{label} K1")
    entries = [("K1 kernel", kern.render_colors_kernel, {}),
               ("K1 xband", kern.render_colors_xband, {})]
    for g in groups:
        grouped = plain.rasterize_winner(vertices, triangles, h, w, group=g)
        _expect_pair(grouped, flat, f"{label} plain group {g} vs flat")
        _expect_pair(kern.rasterize_winner_grouped(vertices, triangles, h, w,
                                                   group=g), grouped,
                     f"{label} K4 group {g}")
        entries.append((f"K4 group {g}", kern.render_colors_grouped,
                        {"group": g}))
    for name, entry, kw in entries:
        img, mask = entry(vertices, colors, triangles, h=h, w=w, **kw)
        expect_equal(mask, want_mask, f"{label} {name} mask")
        expect_equal(img, want_img, f"{label} {name} image")

    interp = plain.rasterize_winner_interp(vertices, triangles, h, w)
    _expect_pair(kern.rasterize_winner_interp(vertices, triangles, h, w),
                 interp, f"{label} K3")
    for g in groups:
        grouped = plain.rasterize_winner_interp(vertices, triangles, h, w,
                                                group=g)
        _expect_pair(grouped, interp, f"{label} plain interp group {g} vs "
                     "per-triangle")
        _expect_pair(kern.rasterize_winner_interp(vertices, triangles, h, w,
                                                  group=g), grouped,
                     f"{label} K5 group {g}")
    return int((want_mask > 0).sum())


def expect_inside_only_matches_k1(x1_winner: torch.Tensor,
                                  k1_winner: torch.Tensor,
                                  vertices: torch.Tensor,
                                  triangles: torch.Tensor, label: str) -> int:
    """X1's winner equals K1's at every pixel whose K1 winner is not a
    degenerate triangle (X1 drops only those).  Returns the count of pixels
    that K1 gives to a degenerate triangle."""
    from voicepuppet_torch.face3d import raster as plain
    f = triangles.shape[0]
    deg = plain.degenerate(vertices, triangles)                 # [B, F]
    deg = torch.cat([deg, deg.new_zeros((deg.shape[0], 1))], 1)
    deg_won = torch.gather(deg, 1, k1_winner.reshape(deg.shape[0], -1).long()
                           .clamp(max=f)).reshape(k1_winner.shape)
    expect_equal(torch.where(deg_won, k1_winner, x1_winner), k1_winner,
                 f"{label} X1 == K1 off degenerate winners")
    return int(deg_won.sum())


def check_probes_against_plain(vertices: torch.Tensor,
                               triangles: torch.Tensor, h: int, w: int,
                               label: str, band_fits: bool = False) -> int:
    """Hold every probe against its plain version on the same CUDA tensors,
    bit for bit: X1 with winner and depth-only (whose depth must equal the
    winner mode's), X1 against K1 off degenerate winners, X2 at every
    (fb, unroll) against K1, X3 at each of REGACC_SETTINGS and
    REGACC_LISTS (where the band fits the canvas), and with ``band_fits``
    X3 at REGACC_SETTINGS against K1.  Returns the count of pixels K1
    gives a degenerate triangle."""
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.ops import raster_probes as probes
    if vertices.device.type != "cuda":
        raise ValueError("the selftest compares the CUDA kernel: pass "
                         "tensors on a CUDA device")
    flat = plain.rasterize_winner(vertices, triangles, h, w)
    x1 = plain.rasterize_winner_inside_only(vertices, triangles, h, w)
    _expect_pair(probes.raster_b(vertices, triangles, h, w), x1,
                 f"{label} X1")
    depth_only = probes.raster_b(vertices, triangles, h, w, winner=False)
    expect_equal(depth_only, x1[1], f"{label} X1 depth-only")
    deg_won = expect_inside_only_matches_k1(x1[0], flat[0], vertices,
                                            triangles, label)
    for fb in probes.UNROLLS:
        for unroll in probes.UNROLLS:
            _expect_pair(probes.raster_u(vertices, triangles, h, w, fb=fb,
                                         unroll=unroll), flat,
                         f"{label} X2 fb {fb} unroll {unroll}")
    for win, fb in REGACC_SETTINGS + REGACC_LISTS:
        if win > h:
            continue
        want = plain.rasterize_winner_banded(vertices, triangles, h, w, win,
                                             512 // fb)
        _expect_pair(probes.rasterize_regacc(vertices, triangles, h, w,
                                             win=win, fb=fb), want,
                     f"{label} X3 win {win} fb {fb}")
        if band_fits and (win, fb) in REGACC_SETTINGS:
            _expect_pair(want, flat, f"{label} X3 win {win} fb {fb} == K1")
    return deg_won


def _case_tensors(make, device):
    """A case's arrays on ``device``; vertices and colours [V, 3] are one
    frame, [B, V, 3] are B."""
    v, t, c, h, w = make()
    vt = torch.as_tensor(v if v.ndim == 3 else v[None],
                         device=device).contiguous()
    ct = torch.as_tensor(c if c.ndim == 3 else c[None],
                         device=device).contiguous()
    tt = torch.as_tensor(t, dtype=torch.int32, device=device)
    return vt, ct, tt, h, w


def run_selftest(device="cuda") -> Dict[str, int]:
    """Every quirk case on ``device``: {case: covered pixels}.  On a CUDA
    device every kernel against its plain version
    (:func:`check_against_plain`); on the CPU, where the entry points run
    the plain versions, the same checks of their dispatch and of the
    plain forms against one another.  Raises AssertionError on the first
    difference."""
    cuda = torch.device(device).type == "cuda"
    check = check_against_plain if cuda else _check_entry_points
    report = {}
    for name, make in {**CASES, **GROUPED_CASES, **INTERP_CASES}.items():
        vt, ct, tt, h, w = _case_tensors(make, device)
        covered = check(vt, ct, tt, h, w, name)
        if covered == 0:
            raise AssertionError(f"{name}: the case draws nothing")
        report[name] = covered
    return report


def run_probe_selftest(device="cuda") -> Dict[str, int]:
    """Every quirk, grouped and interp case, and the band-fitting case, on
    ``device`` through the probes (:func:`check_probes_against_plain`):
    {case: pixels whose K1 winner is a degenerate triangle}.  Raises
    AssertionError on the first difference."""
    report = {}
    for name, make in {**CASES, **GROUPED_CASES, **INTERP_CASES,
                       **PROBE_CASES}.items():
        vt, _, tt, h, w = _case_tensors(make, device)
        report[name] = check_probes_against_plain(
            vt, tt, h, w, name, band_fits=name in PROBE_CASES)
    return report


# ---- a CPU model of triangle_kernel's balanced walk (used by the tests) ----

WARP = 32


def walk_entries(vertices: np.ndarray, triangles: np.ndarray, h: int, w: int,
                 interp: bool = False) -> Tuple[np.ndarray, ...]:
    """tri_setup's verdict on every (frame, triangle) entry, in the kernel's
    flat order b * F + f: (x0, y0, width, height) of the clipped bbox,
    width = height = 0 for an entry that cannot draw (an index outside the
    mesh, a NaN or infinite corner, an empty bbox and, for the flat depth,
    a depth at or below the init).  Float32 throughout, as the kernel."""
    v = np.asarray(vertices, np.float32)
    v = v if v.ndim == 3 else v[None]
    t = np.asarray(triangles).astype(np.int64)
    ok = ((t >= 0) & (t < v.shape[1])).all(1)
    c = v[:, np.where(ok[:, None], t, 0)]                  # [B, F, 3, 3]
    xs, ys, zs = c[..., 0], c[..., 1], c[..., 2]
    with np.errstate(invalid="ignore"):
        x0 = np.maximum(np.ceil(xs.min(-1)), np.float32(0))
        x1 = np.minimum(np.floor(xs.max(-1)), np.float32(w - 1))
        y0 = np.maximum(np.ceil(ys.min(-1)), np.float32(0))
        y1 = np.minimum(np.floor(ys.max(-1)), np.float32(h - 1))
        live = (ok & np.isfinite(xs).all(-1) & np.isfinite(ys).all(-1)
                & (x1 >= x0) & (y1 >= y0))
        if not interp:
            depth = (zs[..., 0] + zs[..., 1] + zs[..., 2]) * np.float32(1 / 3)
            live &= depth > np.float32(-99999.0)
    x0, y0 = np.where(live, x0, 0), np.where(live, y0, 0)
    bw = np.where(live, x1 - x0 + 1, 0)
    bh = np.where(live, y1 - y0 + 1, 0)
    return tuple(a.reshape(-1).astype(np.int64) for a in (x0, y0, bw, bh))


def inside_only_entries(vertices: np.ndarray, triangles: np.ndarray,
                        h: int, w: int) -> Tuple[np.ndarray, ...]:
    """X1's entries (``inside_only_walk_kernel``), walked in K1's warps:
    :func:`walk_entries` of the flat depth, with every degenerate entry
    (``face3d.raster.degenerate``, inv_deno == 0) given width and height 0
    and origin (0, 0), as the kernel gives it area 0 and no slot."""
    from voicepuppet_torch.face3d import raster as plain
    v = np.asarray(vertices, np.float32)
    v = v if v.ndim == 3 else v[None]
    t = np.asarray(triangles, np.int32)
    x0, y0, bw, bh = walk_entries(v, t, h, w)
    deg = plain.degenerate(torch.from_numpy(v),
                           torch.from_numpy(t)).numpy().reshape(-1)
    return tuple(np.where(deg, 0, a) for a in (x0, y0, bw, bh))


def warp_areas(bw: np.ndarray, bh: np.ndarray) -> np.ndarray:
    """The bbox areas of the flat entries laid out as K1's warps:
    [ceil(n / 32), 32], 0 past the last entry.  A warp's balanced walk
    takes ceil(its row's sum / 32) steps; the one-thread walk it replaced
    took its row's max."""
    area = np.zeros(-(-bw.size // WARP) * WARP, np.int64)
    area[:bw.size] = bw * bh
    return area.reshape(-1, WARP)


def bbox_position(q: np.ndarray, width: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's row-major position q -> (dy, dx) in a bbox ``width``
    pixels wide, for 0 <= q < 2^31: the magic number
    m = floor((2^32 - 1) / w) + 1 (0 at w = 1, where dy = q), dy the high
    32 bits of q * m, then one correction where dx < 0."""
    q = np.asarray(q, np.uint64)
    wu = np.asarray(width, np.uint64)
    m = (np.uint64(0xFFFFFFFF) // wu + np.uint64(1)) & np.uint64(0xFFFFFFFF)
    dy = np.where(m != 0, (q * m) >> np.uint64(32), q).astype(np.int64)
    dx = q.astype(np.int64) - dy * wu.astype(np.int64)
    under = dx < 0
    return dy - under, dx + under * wu.astype(np.int64)


def walk_schedule(x0: np.ndarray, y0: np.ndarray, bw: np.ndarray,
                  bh: np.ndarray, slots: int = WARP,
                  order: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, ...]:
    """The balanced walk (``walk_list`` in csrc/raster.cu) over the entries
    of :func:`walk_entries`, taken as lists of ``slots`` (a power of two
    >= 32): ``order`` gives each list's entries in slot order, -1 for a
    slot with none (by default K1's, triangle_kernel's: the flat order in
    warps of 32).  Each list scans its areas, then lane j takes pixel
    r = base + j of the list for base = 0, 32, ... below its total, finds
    its owner slot by the log2(slots)-step binary search over the list's
    sums, and its pixel by :func:`bbox_position`.  Returns (entry, x, y)
    of every pixel visited, and each list's step count."""
    n = bw.shape[0]
    if order is None:
        order = np.full(-(-n // WARP) * WARP, -1, np.int64)
        order[:n] = np.arange(n)
    order = np.asarray(order, np.int64).reshape(-1, slots)
    area = np.where(order >= 0, (bw * bh)[np.maximum(order, 0)], 0)
    ends = np.cumsum(area, 1)                           # each list's scan
    total = ends[:, -1]
    lst = np.repeat(np.arange(order.shape[0]), total)
    r = np.arange(lst.shape[0]) - np.repeat(np.cumsum(total) - total, total)
    o = np.zeros_like(r)
    start = np.zeros_like(r)
    s = slots // 2
    while s:
        e = ends[lst, o + s - 1]
        take = e <= r
        o = np.where(take, o + s, o)
        start = np.where(take, e, start)
        s //= 2
    entry = order[lst, o]
    dy, dx = bbox_position(r - start, bw[entry])
    steps = np.zeros(order.shape[0], np.int64)
    np.maximum.at(steps, lst, r // WARP + 1)
    return entry, x0[entry] + dx, y0[entry] + dy, steps


def unroll_order(b: int, f: int, unroll: int, fb: int,
                 round_slots: int = WARP) -> np.ndarray:
    """X2's slot order at TPT = ``unroll``, FPT = ``fb``: the entry
    b * F + f of each slot of each walk list, -1 where a slot holds none,
    as [lists, slots] in launch order.  Thread g = fg x ceil(F / unroll)
    + tg (lane g % 32 of warp g // 32) takes triangles tg x unroll + k // fb
    in frames fg x fb + k % fb for its entries k = 0 .. unroll x fb - 1; a
    warp's lists are its rounds of kr = min(unroll x fb, round_slots / 32)
    entries a lane, each list in lane-major slot order lane x kr +
    (k mod kr).  unroll_walk_kernel's rounds are the default, 32 slots
    (kr = 1, lane j in slot j); longer lists model the same entries walked
    as one list of up to 32 x unroll x fb slots."""
    ntg = -(-f // unroll)
    n = ntg * -(-b // fb)
    k_all = unroll * fb
    kr = min(k_all, round_slots // WARP)
    g = np.arange(-(-n // WARP) * WARP).reshape(-1, 1, WARP, 1)
    k = (np.arange(k_all // kr) * kr).reshape(1, -1, 1, 1) + np.arange(kr)
    tri = (g % ntg) * unroll + k // fb
    frame = (g // ntg) * fb + k % fb
    ok = (g < n) & (tri < f) & (frame < b)
    return np.where(ok, frame * f + tri, -1).reshape(-1, WARP * kr)


def band_boxes(vertices: np.ndarray, triangles: np.ndarray, h: int, w: int,
               win: int, chunk: int) -> Tuple[np.ndarray, ...]:
    """band_walk_kernel's entries: one block per (frame, chunk of
    ``chunk`` triangles), block b x nc + c, whose thread i takes triangle
    chunk x c + i into slot i of the block's list of NS slots (the power
    of two >= max(chunk, 32)), which the whole block walks.  Each entry's
    :func:`walk_entries` bbox is clipped to its chunk's band rows
    [y0, y0 + win) (``face3d.raster.band_origins``); an entry with no row
    left has area 0.  Returns (x0, y0, width, height) of the clipped
    bboxes in the flat order b * F + f, the blocks' lists [B x nc, NS]
    (-1 past the chunk), and each block's union rectangle
    [B x nc, 4] as (x0, x1, y0, y1) of the clipped bboxes that draw,
    (2^31 - 1, -1, 2^31 - 1, -1) for a block with none."""
    from voicepuppet_torch.face3d import raster as plain
    v = np.asarray(vertices, np.float32)
    v = v if v.ndim == 3 else v[None]
    t = np.asarray(triangles, np.int32)
    nb, f = v.shape[0], t.shape[0]
    nc = -(-f // chunk)
    x0, y0, bw, bh = walk_entries(v, t, h, w)
    band = plain.band_origins(torch.from_numpy(v), torch.from_numpy(t), h,
                              win, chunk).numpy()               # [B, nc]
    tri = np.tile(np.arange(f), nb)
    lo = band[np.repeat(np.arange(nb), f), tri // chunk]
    ya = np.maximum(y0, lo)
    yb = np.minimum(y0 + bh - 1, lo + win - 1)
    live = (bw > 0) & (bh > 0) & (yb >= ya)
    cx0, cy0 = np.where(live, x0, 0), np.where(live, ya, 0)
    cbw, cbh = np.where(live, bw, 0), np.where(live, yb - ya + 1, 0)
    i = np.arange(max(WARP, 1 << (chunk - 1).bit_length()))
    blk = np.arange(nb * nc)[:, None]
    ftri = (blk % nc) * chunk + i
    order = np.where((i < chunk) & (ftri < f), (blk // nc) * f + ftri, -1)
    big = np.int64(2 ** 31 - 1)
    union = np.empty((nb * nc, 4), np.int64)
    block_of = (np.repeat(np.arange(nb), f) * nc + tri // chunk)[live]
    for col, (vals, fill, red) in enumerate((
            (cx0, big, np.minimum), (cx0 + cbw - 1, -1, np.maximum),
            (cy0, big, np.minimum), (cy0 + cbh - 1, -1, np.maximum))):
        union[:, col] = fill
        red.at(union[:, col], block_of, vals[live])
    return cx0, cy0, cbw, cbh, order, union
