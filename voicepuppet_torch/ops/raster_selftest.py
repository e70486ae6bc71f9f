"""On-card parity gate for the CUDA raster kernels.

Counterpart of ``voicepuppet_tpu/ops/raster_selftest.py``.  The quirk
meshes below are own numpy copies of that module's cases and of the
x-band and grouped cases in ``tests/test_raster.py``: depth ties, a
degenerate triangle, colour truncation, occlusion order, seam ties, the
low-bit-y mesh, an edge through pixel centres, a narrow canvas, random
soups, triangles taller or wider than 128 px, a triangle order with no
screen locality and an in-group depth tie.

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
``REGACC_SETTINGS``, each bit for bit against its plain version, X2 and
X1 (off degenerate winners) against K1, and X3 against K1 where every
chunk fits its band.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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


GROUPED_CASES: Dict[str, Callable[[], Case]] = {
    "grouped_scattered_order": _scattered_order,
    "grouped_in_group_tie": _in_group_tie,
    "grouped_degenerate_occlusion": _degenerate_occlusion,
}

# the interp-depth soup of voicepuppet_tpu/ops/raster_selftest.py:325
INTERP_CASES: Dict[str, Callable[[], Case]] = {
    "interp_soup": lambda: _soup_case(3),
}

# group sizes run through K4/K5 on every case: one member, the serving
# size, and more members than a warp's lanes (two batches per group)
GROUP_SIZES = (1, 4, 33)

# X3's (win, fb) settings: profile_raster_regacc.py's three variants
REGACC_SETTINGS = ((16, 8), (16, 4), (8, 8))


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
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.ops import raster as kern
    if vertices.device.type != "cuda":
        raise ValueError("the selftest compares the CUDA kernel: pass "
                         "tensors on a CUDA device")
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
    (fb, unroll) against K1, X3 at each of REGACC_SETTINGS, and with
    ``band_fits`` X3 against K1.  Returns the count of pixels K1 gives a
    degenerate triangle."""
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
    for win, fb in REGACC_SETTINGS:
        want = plain.rasterize_winner_banded(vertices, triangles, h, w, win,
                                             512 // fb)
        _expect_pair(probes.rasterize_regacc(vertices, triangles, h, w,
                                             win=win, fb=fb), want,
                     f"{label} X3 win {win} fb {fb}")
        if band_fits:
            _expect_pair(want, flat, f"{label} X3 win {win} fb {fb} == K1")
    return deg_won


def _case_tensors(make, device):
    v, t, c, h, w = make()
    vt = torch.as_tensor(v[None], device=device).contiguous()
    ct = torch.as_tensor(c[None], device=device).contiguous()
    tt = torch.as_tensor(t, dtype=torch.int32, device=device)
    return vt, ct, tt, h, w


def run_selftest(device="cuda") -> Dict[str, int]:
    """Every quirk case on ``device``: {case: covered pixels}.  Raises
    AssertionError on the first difference."""
    report = {}
    for name, make in {**CASES, **GROUPED_CASES, **INTERP_CASES}.items():
        vt, ct, tt, h, w = _case_tensors(make, device)
        covered = check_against_plain(vt, ct, tt, h, w, name)
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
