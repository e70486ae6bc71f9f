"""The port's interpolated-depth raster (K3; K5 with ``group``) and the
texture post-passes on CPU tensors (the plain versions of the CUDA
kernels) against the JAX interp Mosaic kernels in interpret mode, the XLA
formulation and the sequential spec ``raster_ref.rasterize_triangles_ref``.

The port's float order is the normative one: the unfused float32 order of
the kernels' source (``raster_pallas.py:181-190`` and ``:750``).  The spec
(float32 dot products, float64 barycentrics and a float64 depth compared
against a float32 buffer) and XLA's CPU kernels (which contract ``a*b +
c*d`` into an FMA) may each decide two kinds of pixel differently, and
every such pixel is proven in float64 here, never counted blindly:

  * edge: the pixel centre lies within 3e-5 (barycentric units) of an edge
    of some triangle (``ops/raster_selftest.py:_borderline_pixels``), or
    within 1e-4 against the JAX kernels, whose fused products move u and v
    by up to ~3e-5 on the low-bit-y mesh (measured; the flat raster's test
    holds the same 1e-4, tests/test_torch_raster.py);
  * tie: both winners cover the pixel and their interpolated depths there
    agree to 1e-5 relative in float64 (adjacent triangles meet at equal
    depth on their shared edge; equal-depth meshes tie everywhere).

Bands: winners exact on the engineered meshes; depth within 1e-5 of JAX
and 1e-4 of the spec where winners agree (2e-3 on the ~90-px-tall
triangle, JAX's own band for its float32 cancellation); barycentric
weights within 1e-3 of the spec (JAX's own test) and 1e-5 of JAX; textures
bilinear within 1e-5, nearest exact.
"""

import numpy as np
import pytest
import torch

from voicepuppet_tpu.face3d import raster as jraster
from voicepuppet_tpu.face3d import raster_ref as jref
from voicepuppet_tpu.ops import raster_pallas as jpallas
from voicepuppet_tpu.ops import raster_selftest as jself

from voicepuppet_torch import ops as tops
from voicepuppet_torch.face3d import raster as traster
from voicepuppet_torch.ops import raster_selftest as tself

from test_torch_raster import SPEC_CASES, case_soup_xband, spec_frame

torch.set_num_threads(1)

TIE_RTOL = 1e-5

ENGINEERED = ("mesh", "degenerate_truncation_tie", "occlusion_far_first",
              "seam_near_a", "seam_near_b", "edge_through_pixel_centers",
              "narrow_canvas", "tall_triangle")
BORDERLINE = {
    "interp_soup": tself.INTERP_CASES["interp_soup"],
    "soup": tself.CASES["soup"],
    "xband_soup": case_soup_xband,
    "low_bit_y": tself.CASES["low_bit_y"],
    "seam_tie": SPEC_CASES["seam_tie"],
    "in_group_tie": tself.GROUPED_CASES["grouped_in_group_tie"],
    # three frames each, an exact depth tie and NaN corners among them
    "walk_balance": tself.CASES["walk_balance"],
    "walk_balance_wide": tself.CASES["walk_balance_wide"],
}
SOUPS = ("interp_soup", "soup", "xband_soup")


def _tensors(v, t):
    """Vertices [V, 3] are one frame, [B, V, 3] are B."""
    return (torch.from_numpy(np.ascontiguousarray(v if v.ndim == 3
                                                  else v[None])),
            torch.from_numpy(np.array(t, dtype=np.int32)))


def _port_interp(v, t, h, w, group=0):
    """(triangle buffer [h,w] with -1 uncovered, depth [h,w])."""
    vt, tt = _tensors(v, t)
    winner, depth = tops.rasterize_winner_interp(vt, tt, h=h, w=w,
                                                 group=group)
    winner = winner[0].numpy()
    return np.where(winner == t.shape[0], -1, winner), depth[0].numpy()


def _jax_interp(v, t, h, w, group=0):
    """The JAX interp kernels; the grouped one with a full-canvas window,
    since at a smaller one its fallback crops tall triangles (test
    below)."""
    win = h if group > 0 else 16
    winner, depth = jpallas.rasterize_winner_interp_pallas(
        v[None], t, h=h, w=w, win=win, group=group, interpret=True)
    winner = np.asarray(winner[0])
    return (np.where(winner == t.shape[0], -1, winner),
            np.asarray(depth[0]))


def _depth64(v, t, tri, y, x):
    """Float64 interpolated depth of triangle ``tri`` at pixel (y, x)."""
    p = v[t[tri]].astype(np.float64)
    v0, v1 = p[2, :2] - p[0, :2], p[1, :2] - p[0, :2]
    v2 = np.array([x, y], np.float64) - p[0, :2]
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d02, d12 = v0 @ v2, v1 @ v2
    deno = d00 * d11 - d01 * d01
    inv = 0.0 if deno == 0 else 1.0 / deno
    u = (d11 * d02 - d01 * d12) * inv
    vv = (d00 * d12 - d01 * d02) * inv
    return (1.0 - u - vv) * p[0, 2] + vv * p[1, 2] + u * p[2, 2]


def _prove_borderline(v, t, h, w, got, want, label, eps):
    """Every pixel where the triangle buffers differ is an edge (within
    ``eps``) or a tie (module doc).  Returns (edge count, tie count)."""
    bad = np.argwhere(got != want)
    edge = jself._borderline_pixels(v, t, h, w, eps) if len(bad) else set()
    n_edge = n_tie = 0
    for y, x in bad:
        a, b = int(got[y, x]), int(want[y, x])
        if (int(y), int(x)) in edge:
            n_edge += 1
            continue
        assert a >= 0 and b >= 0, (label, "coverage differs off an edge",
                                   y, x, a, b)
        da, db = _depth64(v, t, a, y, x), _depth64(v, t, b, y, x)
        assert abs(da - db) <= TIE_RTOL * max(1.0, abs(da)), (
            label, "not a tie", y, x, a, b, da, db)
        n_tie += 1
    return n_edge, n_tie


def _spec(v, t, h, w):
    return jref.rasterize_triangles_ref(v, t, h, w)


@pytest.mark.parametrize("name", ENGINEERED)
def test_interp_winners_exact_on_engineered_meshes(name):
    """K3 and K5 plain versions against the spec and the JAX interp
    kernels (group 0, and group 4 where the TPU grouped path does not crop):
    winners bit for bit, depth within the bands."""
    v, t, _, h, w = SPEC_CASES[name]()
    want_d, want_t, _ = _spec(v, t, h, w)
    assert (want_t >= 0).sum() > 0
    got_t, got_d = _port_interp(v, t, h, w)
    for g in tself.GROUP_SIZES:
        gt, gd = _port_interp(v, t, h, w, group=g)
        np.testing.assert_array_equal(gt, got_t)
        np.testing.assert_array_equal(gd, got_d)
    np.testing.assert_array_equal(got_t, want_t)
    cov = want_t >= 0
    tol_jax, tol_spec = (2e-3, 2e-3) if name == "tall_triangle" else \
        (1e-5, 1e-4)
    np.testing.assert_allclose(got_d[cov], want_d[cov], atol=tol_spec)
    np.testing.assert_array_equal(got_d[~cov], want_d[~cov])
    for g in (0, 4):
        jt, jd = _jax_interp(v, t, h, w, group=g)
        np.testing.assert_array_equal(got_t, jt)
        np.testing.assert_allclose(got_d, jd, atol=tol_jax)


@pytest.mark.parametrize("name", sorted(BORDERLINE))
def test_interp_borderline_pixels_proven_in_float64(name):
    """Soups and equal-depth meshes: where the port's winners differ from
    the spec's or the JAX kernels', each pixel is an edge or a tie proven
    in float64; soups hold the selftest's budget of 16 such pixels (the
    equal-depth meshes tie over whole overlaps, so their count is only
    reported).  Depth where winners agree: 1e-5 of JAX, 1e-4 of the
    spec.  A case of several frames is taken frame by frame; the spec and
    the proofs get NaN-cornered triangles off the canvas (spec_frame)."""
    v, t, _, h, w = BORDERLINE[name]()
    for vb in (v if v.ndim == 3 else v[None]):
        sb = spec_frame(vb, t)
        want_d, want_t, _ = _spec(sb, t, h, w)
        got_t, got_d = _port_interp(vb, t, h, w)
        gt4, gd4 = _port_interp(vb, t, h, w, group=4)
        np.testing.assert_array_equal(gt4, got_t)
        np.testing.assert_array_equal(gd4, got_d)
        refs = [("spec", want_t, want_d, 1e-4, jself.BORDERLINE_EPS)]
        for g in (0, 4):
            jt, jd = _jax_interp(vb, t, h, w, group=g)
            refs.append((f"jax group {g}", jt, jd, 1e-5, 1e-4))
        for label, ref_t, ref_d, tol, eps in refs:
            n_edge, n_tie = _prove_borderline(sb, t, h, w, got_t, ref_t,
                                              f"{name} vs {label}", eps)
            if name in SOUPS:
                assert n_edge + n_tie <= jself.MAX_BORDERLINE, (n_edge,
                                                                n_tie)
            agree = (got_t == ref_t) & (ref_t >= 0)
            np.testing.assert_allclose(got_d[agree], ref_d[agree], atol=tol)


def test_tpu_grouped_interp_crops_tall_triangles_port_does_not():
    """A hazard of the TPU path, not of the port: when a group does not fit
    its window the TPU grouped interp path falls back to the per-triangle
    kernel at the same ``win`` with no guard, which crops a triangle taller
    than win-7 rows.  The port's K5 gives the uncropped spec answer."""
    v, t, _, h, w = SPEC_CASES["tall_triangle"]()
    _, want_t, _ = _spec(v, t, h, w)
    winner, _ = jpallas.rasterize_winner_interp_pallas(
        v[None], t, h=h, w=w, win=16, group=4, interpret=True)
    jt = np.asarray(winner[0])
    got_t, _ = _port_interp(v, t, h, w, group=4)
    np.testing.assert_array_equal(got_t, want_t)
    assert ((want_t == 0).sum() > 500
            and (jt == 0).sum() < (want_t == 0).sum())


def test_degenerate_triangle_depth_is_z0():
    """inv_deno = 0 gives u = v = 0 over the whole bbox: the interpolated
    depth is z0 there, on the port and the spec alike."""
    v = np.array([[10.0, 10.0, 2.0], [14.0, 10.0, 7.0], [12.0, 10.0, 9.0]],
                 np.float32)
    t = np.array([[0, 1, 2]], np.int32)
    want_d, want_t, _ = _spec(v, t, 32, 32)
    for g in (0, 4):
        got_t, got_d = _port_interp(v, t, 32, 32, group=g)
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_array_equal(got_d, want_d)
    assert (got_t == 0).sum() == 5 and (got_d[got_t == 0] == 2.0).all()


def test_border_override_extrapolated_depth_wins():
    """Upstream's quirk: inside the 2-px canvas border a fragment passes
    the inside test unconditionally, with its extrapolated depth, and can
    beat an in-triangle fragment there."""
    v = np.array([[0.5, 0.5, 10.0], [63.0, 0.5, 10.0], [0.5, 63.0, 10.0],
                  [1.2, 1.2, 0.0], [30.0, 1.2, 40.0], [1.2, 30.0, 40.0]],
                 np.float32)
    t = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    want_d, want_t, _ = _spec(v, t, 32, 32)
    for g in (0, 4):
        got_t, got_d = _port_interp(v, t, 32, 32, group=g)
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_allclose(got_d, want_d, atol=1e-4)
    # (30, 30) and (20, 20) lie outside triangle 1 (x + y > 31.2) and
    # inside triangle 0: on the border row triangle 1's extrapolated depth
    # (~80) beats triangle 0's 10, off the border it does not draw
    assert want_t[30, 30] == 1 and got_d[30, 30] > 70
    assert want_t[20, 20] == 0 and got_d[20, 20] == 10.0


@pytest.mark.parametrize("group", [0, 4])
def test_rasterize_triangles_matches_jax_pallas(group):
    """The RasterOut of ``rasterize_triangles_kernel`` (CPU: the plain
    version) against ``rasterize_triangles_pallas`` and the spec."""
    v, t, _, h, w = SPEC_CASES["mesh"]()
    vt, tt = _tensors(v, t)
    got = tops.rasterize_triangles_kernel(vt, tt, h=h, w=w, group=group)
    plain = traster.rasterize_triangles(vt, tt, h, w, group)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    want = jpallas.rasterize_triangles_pallas(v[None], t, h=h, w=w,
                                              group=group, interpret=True)
    np.testing.assert_array_equal(got.triangle_buffer.numpy(),
                                  np.asarray(want.triangle_buffer))
    np.testing.assert_allclose(got.depth_buffer.numpy(),
                               np.asarray(want.depth_buffer), atol=1e-5)
    np.testing.assert_allclose(got.barycentric_weight.numpy(),
                               np.asarray(want.barycentric_weight),
                               atol=1e-5)
    _, want_t, want_w = _spec(v, t, h, w)
    cov = want_t >= 0
    np.testing.assert_allclose(got.barycentric_weight[0].numpy()[cov],
                               want_w[cov], atol=1e-3)
    assert (got.barycentric_weight[0].numpy()[~cov] == 0).all()


def _textured_mesh():
    """The fixture mesh with texture coordinates from the sphere's (theta,
    phi) grid over a 16² random texture."""
    v, t, _, h, w = SPEC_CASES["mesh"]()
    uv = tself.sphere_uv(14, 14, 16, 16)
    tex = np.random.RandomState(5).rand(16, 16, 3).astype(np.float32)
    return v, t, tex, uv, h, w


@pytest.mark.parametrize("bilinear", [True, False],
                         ids=["bilinear", "nearest"])
def test_render_texture_matches_jax(bilinear):
    """``render_texture_kernel`` (group 0 and 4) against
    ``render_texture_pallas`` and the XLA ``render_texture``, on the mesh
    and on tests/test_raster.py's single textured triangle."""
    single = (np.array([[2.0, 2.0, 1.0], [28.0, 2.0, 1.0],
                        [2.0, 28.0, 1.0]], np.float32),
              np.array([[0, 1, 2]], np.int32),
              np.where(np.arange(16)[None, :, None] < 8, 1.0, 0.0) *
              np.ones((16, 16, 3), np.float32),
              np.array([[0.0, 0.0], [15.0, 0.0], [0.0, 15.0]], np.float32),
              32, 32)
    for v, t, tex, uv, h, w in (_textured_mesh(), single):
        tex = tex.astype(np.float32)
        want_p, want_pd = jpallas.render_texture_pallas(
            v[None], t, tex, uv, t, h=h, w=w, win=32, bilinear=bilinear,
            interpret=True)
        want_x, _ = jraster.render_texture(v[None], t, tex, uv, t, h=h,
                                           w=w, bb=32, bilinear=bilinear)
        vt, tt = _tensors(v, t)
        for g in (0, 4):
            img, depth = tops.render_texture_kernel(
                vt, tt, torch.from_numpy(tex), torch.from_numpy(uv), tt,
                h=h, w=w, group=g, bilinear=bilinear)
            assert img.shape == (1, h, w, 3)
            np.testing.assert_allclose(depth.numpy(), np.asarray(want_pd),
                                       atol=1e-5)
            for want in (want_p, want_x):
                if bilinear:
                    np.testing.assert_allclose(img.numpy(),
                                               np.asarray(want), atol=1e-5)
                else:
                    np.testing.assert_array_equal(img.numpy(),
                                                  np.asarray(want))
        assert img.numpy().std() > 0


@pytest.mark.parametrize("name", sorted({**tself.CASES, **tself.GROUPED_CASES,
                                         **tself.INTERP_CASES}))
def test_selftest_cases_interp_grouped_plain_equals_per_triangle(name):
    """Every case of the on-card gate through the grouped interp plain
    version (K5's reference on the card) at each of its group sizes: bit
    for bit the per-triangle one (K3's)."""
    cases = {**tself.CASES, **tself.GROUPED_CASES, **tself.INTERP_CASES}
    v, t, _, h, w = cases[name]()
    vt, tt = _tensors(v, t)
    want = traster.rasterize_winner_interp(vt, tt, h, w)
    assert (want[0] < t.shape[0]).any()
    for g in tself.GROUP_SIZES:
        got = traster.rasterize_winner_interp(vt, tt, h, w, group=g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sphere_uv_indexes_the_patch_grid():
    uv = tself.sphere_uv(3, 4, 9, 7)
    assert uv.shape == (12, 2)
    np.testing.assert_array_equal(uv[0], [0.0, 0.0])
    np.testing.assert_array_equal(uv[3], [6.0, 0.0])       # (i 0, j 3)
    np.testing.assert_array_equal(uv[4], [0.0, 4.0])       # (i 1, j 0)
    np.testing.assert_array_equal(uv[11], [6.0, 8.0])
