"""The port's raster on CPU tensors (the plain version of the CUDA kernel)
against the sequential spec ``raster_ref.render_colors_ref`` and the JAX
Mosaic kernel in interpret mode — bit for bit, on the quirk meshes of
tests/test_raster.py and ops/raster_selftest.py.

No float tolerance anywhere in this file: winner ids, masks and colors are
integers and must be equal.
"""

import numpy as np
import pytest
import torch

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import morph as jmorph
from voicepuppet_tpu.face3d import raster_ref as jref
from voicepuppet_tpu.ops import raster_pallas as jpallas
from voicepuppet_tpu.ops import raster_selftest as jself

from voicepuppet_torch import ops as tops
from voicepuppet_torch.face3d import raster as traster
from voicepuppet_torch.face3d import raster_ref as tref
from voicepuppet_torch.ops import raster_selftest as tself

torch.set_num_threads(1)

H = W = 96


def _project_synthetic(seed=0, n=14, scale=40.0):
    """tests/test_raster.py's small sphere-patch mesh in screen space."""
    model = jbfm.synthetic_bfm(num_theta=n, num_phi=n, seed=seed)
    fm = jmorph.device_bfm(model)
    coeff = jbfm.demo_coeff(model, batch=1, seed=seed + 1)
    rec = jmorph.reconstruct(coeff, fm, image_size=float(H))
    proj = np.asarray(rec.face_projection[0])
    proj = (proj - proj.mean(0)) * (scale / np.abs(
        proj - proj.mean(0)).max()) + np.array([W / 2, H / 2])
    z = np.asarray(rec.z_buffer[0])
    verts = np.concatenate([proj, z], axis=1).astype(np.float32)
    colors = np.clip(np.asarray(rec.face_color[0]), 0, 255).astype(
        np.int32).astype(np.float32)
    return verts, np.asarray(fm.tri), colors


_MESH = []


def mesh():
    if not _MESH:
        _MESH.append(_project_synthetic())
    verts, tris, colors = _MESH[0]
    return verts.copy(), tris, colors


def _frames(a):
    """Vertices or colours [V, 3] are one frame, [B, V, 3] are B."""
    return a if a.ndim == 3 else a[None]


def _port(verts, tris, colors, h, w, entry="auto"):
    """(image, mask) of one frame [V, 3], or of B frames [B, V, 3]."""
    v = torch.from_numpy(np.ascontiguousarray(_frames(verts)))
    c = torch.from_numpy(np.ascontiguousarray(_frames(colors)))
    t = torch.from_numpy(np.array(tris, dtype=np.int32))
    if entry == "auto":
        img, mask = tops.render_colors_auto(v, c, t, h=h, w=w)
    elif entry == "kernel":
        img, mask = tops.render_colors_kernel(v, c, t, h=h, w=w)
    else:
        img, mask = tops.render_colors_xband(v, c, t, h=h, w=w, guard=False)
    if verts.ndim == 2:
        return img[0].numpy(), mask[0].numpy()
    return img.numpy(), mask.numpy()


def spec_frame(verts, tris):
    """One frame's vertices as the spec can take them: its integer bbox
    cannot take a NaN corner, so each NaN-cornered triangle moves off the
    canvas, where it draws nothing, as it draws nothing in the port.  (The
    cases that carry NaN corners give every triangle its own vertices.)"""
    v = verts.copy()
    nan_tri = ~np.isfinite(v[tris]).all((1, 2))
    v[tris[nan_tri].reshape(-1), :2] = -50.0
    return v


def _equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# ---- the cases: (verts, tris, colors, h, w) --------------------------------

def case_mesh():
    v, t, c = mesh()
    return v, t, c, H, W


def case_degenerate_truncation_tie():
    v = np.array([
        [10.0, 10.0, 1.0], [14.0, 10.0, 1.0], [12.0, 10.0, 1.0],  # degen
        [2.0, 14.0, 1.0], [20.0, 14.0, 1.0], [2.0, 30.0, 1.0],    # A
        [2.0, 14.0, 1.0], [20.0, 14.0, 1.0], [2.0, 30.0, 1.0],    # B = tie
    ], np.float32)
    t = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    c = np.array([[90.0]] * 3 + [[9.0], [9.0], [10.0]] + [[200.0]] * 3,
                 np.float32)
    return v, t, c, 32, 32


def case_occlusion_far_first():
    v = np.array([[2.0, 2.0, 5.0], [28.0, 2.0, 5.0], [2.0, 28.0, 5.0],
                  [2.0, 2.0, 1.0], [28.0, 2.0, 1.0], [2.0, 28.0, 1.0]],
                 np.float32)
    c = np.array([[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[3, 4, 5], [0, 1, 2]], np.int32), c, 32, 32


def case_tall_triangle():
    v, t, c = mesh()
    t0 = t[0]
    v[t0[0], :2] = [W * 0.5, 2.3]
    v[t0[1], :2] = [W * 0.25, H - 3.3]
    v[t0[2], :2] = [W * 0.75, H - 5.3]
    v[t0, 2] = 50.0
    return v, t, c, H, W


def case_xband_wide_mesh():
    v, t, c = mesh()
    v[:, 0] = (v[:, 0] - v[:, 0].mean()) * 2.2 + 224 / 2
    return v, t, c, H, 224


def case_xband_wide_triangle():
    v, t, c = mesh()
    v[:, 0] += (224 - W) / 2
    t0 = t[0]
    v[t0[0], :2] = [60.3, H * 0.4]
    v[t0[1], :2] = [180.3, H * 0.3]
    v[t0[2], :2] = [120.3, H * 0.6]
    v[t0, 2] = 50.0
    return v, t, c, H, 224


def _seam(za, zb):
    tri_a = [[90.0, 10.0], [120.0, 10.0], [105.0, 40.0]]
    tri_b = [[100.0, 5.0], [126.0, 20.0], [96.5, 35.0]]
    v = np.array([p + [za] for p in tri_a] + [p + [zb] for p in tri_b],
                 np.float32)
    c = np.array([[200.0]] * 3 + [[50.0]] * 3, np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32), c, 48, 224


def case_edge_through_pixel_centers():
    eps = np.float32(2.0 ** -17)
    v = np.array([[104.0, 40.0 - eps, 5.0], [120.0, 52.0 - eps, 5.0],
                  [118.0, 42.0, 5.0]], np.float32)
    return (v, np.array([[0, 1, 2]], np.int32),
            np.full((3, 3), 90.0, np.float32), 224, 224)


def case_narrow_canvas():
    v = np.array([[2.0, 2.0, 1.0], [28.0, 2.0, 1.0], [2.0, 28.0, 1.0]],
                 np.float32)
    return (v, np.array([[0, 1, 2]], np.int32),
            np.full((3, 3), 90.0, np.float32), 32, 96)


def case_soup():
    v, t, c = jself._soup(seed=0)
    return v, t, c, H, W


def case_soup_xband():
    v, t, c = jself._soup(seed=2, w=224)
    return v, t, c, H, 224


SPEC_CASES = {
    "mesh": case_mesh,
    "degenerate_truncation_tie": case_degenerate_truncation_tie,
    "occlusion_far_first": case_occlusion_far_first,
    "tall_triangle": case_tall_triangle,
    "xband_wide_mesh": case_xband_wide_mesh,
    "xband_wide_triangle": case_xband_wide_triangle,
    "seam_near_a": lambda: _seam(5.0, 1.0),
    "seam_near_b": lambda: _seam(1.0, 5.0),
    "seam_tie": lambda: _seam(3.0, 3.0),
    "edge_through_pixel_centers": case_edge_through_pixel_centers,
    "narrow_canvas": case_narrow_canvas,
    # three frames: triangle_kernel's balanced-walk layout (its 224² form
    # has edges through pixel centres: _BORDERLINE_CASES)
    "walk_balance": tself.CASES["walk_balance"],
}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_port_raster_matches_sequential_spec(name):
    v, t, c, h, w = SPEC_CASES[name]()
    got_img, got_mask = _port(_frames(v), t, _frames(c), h, w)
    for b, (vb, cb) in enumerate(zip(_frames(v), _frames(c))):
        vb = spec_frame(vb, t)
        want = jref.render_colors_ref(vb, t, cb, h, w)
        assert want[1].sum() > 0
        _equal((got_img[b], got_mask[b]), want)
        # the port's own copy of the spec is the same spec
        _equal(tref.render_colors_ref(vb, t, cb, h, w), want)


@pytest.mark.parametrize("name", ["mesh", "degenerate_truncation_tie",
                                  "xband_wide_mesh", "xband_wide_triangle",
                                  "seam_near_a", "seam_tie",
                                  "edge_through_pixel_centers",
                                  "narrow_canvas"])
def test_port_raster_matches_jax_xband_interpret(name):
    v, t, c, h, w = SPEC_CASES[name]()
    win = 48 if name.startswith("seam") else 16
    img, mask = jpallas.render_colors_xband_pallas(
        _frames(v), _frames(c), t, h=h, w=w, win=win, interpret=True)
    want = (np.asarray(img), np.asarray(mask))
    for entry in ("auto", "kernel", "xband"):
        _equal(_port(_frames(v), t, _frames(c), h, w, entry), want)


@pytest.mark.parametrize("case", [case_soup, case_soup_xband],
                         ids=["soup", "soup_xband"])
def test_port_raster_on_random_soups(case):
    """Random triangle soups (ops/raster_selftest.py) carry pixel centers
    within an ulp of an edge.  There raster_ref (float64 barycentrics) and
    the JAX interpret kernel (XLA's CPU float32) may each round the inside
    test differently from the plain float32 order the port and the CUDA
    kernel share, so the selftest's own contract applies: equal except at
    a bounded handful of pixels proven borderline by a float64
    recomputation."""
    v, t, c, h, w = case()
    got = _port(v, t, c, h, w)
    want = jref.render_colors_ref(v, t, c, h, w)
    jself._expect_match(got[0], got[1], want[0], want[1], v, t, h, w,
                        "port vs spec")
    img, mask = jpallas.render_colors_xband_pallas(
        v[None], c[None], t, h=h, w=w, interpret=True)
    jself._expect_match(got[0], got[1], np.asarray(img[0]),
                        np.asarray(mask[0]), v, t, h, w, "port vs jax")


def test_low_bit_y_mesh_against_spec_and_jax():
    """The round-4 regression mesh: exact depth ties, y coordinates with
    2^-17 low bits, quarter-pixel x — winners hang on inside tests whose
    pixel centers sit on or within ~1e-5 of an edge.  There the three
    float orders part: raster_ref's float64 barycentrics, XLA's CPU
    float32, which contracts ``a*b + c*d`` into ``fma(a, b, c*d)`` (the
    JAX interpret kernels), and the unfused float32 order the port and the
    CUDA kernel share.  Measured: 6 of 50,176 pixels differ from the spec
    and 6 from the JAX kernels, which themselves differ from the spec at
    4, so no float order equals both.  So: the selftest's contract against the
    spec (a bounded handful of pixels, f64-verified within 3e-5 of an
    edge), and against the JAX kernels every differing pixel must lie
    within 1e-4 of an edge — the JAX pair itself must agree exactly."""
    v, t, c = jself._low_bit_y_mesh()
    p_img, p_mask = jpallas.render_colors_pallas(
        v[None], c[None], t, h=224, w=224, interpret=True)
    x_img, x_mask = jpallas.render_colors_xband_pallas(
        v[None], c[None], t, h=224, w=224, guard=False, interpret=True)
    np.testing.assert_array_equal(np.asarray(x_mask), np.asarray(p_mask))
    got = _port(v, t, c, 224, 224)
    want = jref.render_colors_ref(v, t, c, 224, 224)
    jself._expect_match(got[0], got[1], want[0], want[1], v, t, 224, 224,
                        "port vs spec")
    bad = np.argwhere((got[1] != np.asarray(p_mask[0]))
                      | (got[0] != np.asarray(p_img[0])).any(-1))
    assert 0 < len(got[1].nonzero()[0]) and len(bad) <= jself.MAX_BORDERLINE
    near = jself._borderline_pixels(v, t, 224, 224, eps=1e-4)
    assert all((int(y), int(x)) in near for y, x in bad), bad


@pytest.mark.parametrize("name", ["walk_balance", "walk_balance_wide"])
def test_walk_balance_against_jax_kernels(name):
    """The balanced-walk case, three frames with NaN corners, through the
    JAX per-triangle and x-band kernels in interpret mode: equal to the
    port except at a bounded handful of pixels per frame, each within 1e-4
    of an edge in float64 (XLA's CPU FMA; test_low_bit_y_mesh_against_spec
    _and_jax)."""
    v, t, c, h, w = tself.CASES[name]()
    got_img, got_mask = _port(v, t, c, h, w)
    for fn in (jpallas.render_colors_pallas,
               jpallas.render_colors_xband_pallas):
        img, mask = fn(v, c, t, h=h, w=w, interpret=True)
        img, mask = np.asarray(img), np.asarray(mask)
        for b in range(v.shape[0]):
            bad = np.argwhere((got_mask[b] != mask[b])
                              | (got_img[b] != img[b]).any(-1))
            assert len(bad) <= jself.MAX_BORDERLINE, (fn.__name__, b, bad)
            near = jself._borderline_pixels(spec_frame(v[b], t), t, h, w,
                                            eps=1e-4)
            assert all((int(y), int(x)) in near for y, x in bad), bad


def test_winner_and_depth_match_jax_winner_kernel():
    """rasterize_winner: ids in [0, F] (F = uncovered) and the winner's
    flat depth, equal to the JAX winner kernel's buffers."""
    v, t, _ = mesh()
    v2 = np.stack([v, v + np.array([5.0, 0.0, 0.0], np.float32)])
    jw, jd = jpallas.rasterize_winner_pallas(v2, t, h=H, w=W,
                                             interpret=True)
    tw, td = tops.rasterize_winner(torch.from_numpy(v2),
                                   torch.from_numpy(t.astype(np.int32)),
                                   h=H, w=W)
    assert tw.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tw.numpy() == t.shape[0]).any() and (tw.numpy() < t.shape[0]).any()


def test_batched_render_is_per_frame():
    v, t, c = mesh()
    v2 = torch.from_numpy(np.stack([v, v + np.array([5.0, 0.0, 0.0],
                                                    np.float32)]))
    c2 = torch.from_numpy(np.stack([c, c]))
    img, mask = traster.render_colors(v2, c2, torch.from_numpy(t), H, W)
    want = jref.render_colors_ref(v, t, c, H, W)
    np.testing.assert_array_equal(img[0].numpy(), want[0])
    np.testing.assert_array_equal(mask[0].numpy(), want[1])
    assert not torch.equal(mask[0], mask[1])


def test_depth_filter_and_empty_inputs():
    """Triangles at or below the -99999 init depth never draw (strict >),
    off-canvas triangles are empty, and a mesh that draws nothing yields
    winner == F everywhere."""
    v = np.array([[2.0, 2.0, -99999.0], [28.0, 2.0, -99999.0],
                  [2.0, 28.0, -99999.0],
                  [-50.0, -50.0, 1.0], [-40.0, -50.0, 1.0],
                  [-50.0, -40.0, 1.0]], np.float32)
    t = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    w_, d_ = traster.rasterize_winner(torch.from_numpy(v[None]),
                                      torch.from_numpy(t), 32, 32)
    assert (w_ == 2).all() and (d_ == -99999.0).all()


def test_selftest_generators_copy_the_jax_ones():
    """The on-card gate's own numpy copies of the soup and low-bit-y
    generators produce the JAX selftest's arrays exactly."""
    for seed, w in ((0, 96), (1, 96), (2, 224)):
        for got, want in zip(tself.soup(seed=seed, w=w),
                             jself._soup(seed=seed, w=w)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tself.low_bit_y_mesh(), jself._low_bit_y_mesh()):
        np.testing.assert_array_equal(got, want)


# cases whose corners sit on a quarter-pixel grid or carry 2^-17 low bits:
# the spec's float64 barycentrics may part from float32 at pixels within
# ~1e-5 of an edge (test_port_raster_on_random_soups)
_BORDERLINE_CASES = ("soup", "tall_guard", "xband_soup",
                     "xband_wide_triangle", "huge_triangle", "low_bit_y",
                     "walk_balance_wide")


@pytest.mark.parametrize("name", sorted(tself.CASES))
def test_selftest_cases_plain_version_against_spec(name):
    """Every quirk case of the on-card gate, rendered by the plain version
    (the kernel's reference on the card), against the sequential spec:
    bit for bit on the engineered cases, the selftest's f64-verified
    borderline contract on the soups."""
    v, t, c, h, w = tself.CASES[name]()
    got_img, got_mask = _port(_frames(v), t, _frames(c), h, w)
    for b, (vb, cb) in enumerate(zip(_frames(v), _frames(c))):
        vb = spec_frame(vb, t)
        want = jref.render_colors_ref(vb, t, cb, h, w)
        assert want[1].sum() > 0
        status = jself._expect_match(got_img[b], got_mask[b], want[0],
                                     want[1], vb, t, h, w, f"{name} {b}")
        if name not in _BORDERLINE_CASES:
            assert status == "exact", status


def test_selftest_needs_cuda_tensors():
    v, t, c, h, w = tself.CASES["narrow_canvas"]()
    with pytest.raises(ValueError, match="CUDA"):
        tself.check_against_plain(torch.from_numpy(v[None]),
                                  torch.from_numpy(c[None]),
                                  torch.from_numpy(t), h, w, "cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; the CPU path is the
    entry points' dispatch, never a fallback inside the wrapper."""
    v = torch.zeros((1, 3, 3))
    t = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tops.RASTER(v, t, 8, 8)
    assert tops.RASTER.launches == 0


def test_cuda_wrapper_size_limits():
    """The kernels index pixels and entries in 32 bits, and the
    per-triangle kernel sums 32 bbox areas of up to h x w each: so
    max(B, 32) x h x w and B x F stay below 2^31."""
    from voicepuppet_torch.ops.raster import _check_size
    _check_size(1, 70688, 8191, 8191)
    _check_size(32, 70688, 8191, 8191)
    _check_size(32768, 65535, 8, 8)
    for b, f, h, w in ((1, 3, 8192, 8192), (33, 3, 8191, 8191),
                       (1, 2 ** 31, 8, 8), (1, 3, 0, 8)):
        with pytest.raises(ValueError, match="unsupported raster size"):
            _check_size(b, f, h, w)


def test_device_bfm_refuses_triangle_indices_outside_the_mesh():
    """The kernel trusts the topology: its index range is checked once,
    where device_bfm makes it."""
    from voicepuppet_torch.face3d import bfm as tbfm
    from voicepuppet_torch.face3d import morph as tmorph
    model = tbfm.synthetic_bfm(num_theta=6, num_phi=6)
    fm = tmorph.device_bfm(model, "cpu")
    assert int(fm.tri.min()) == 0
    assert int(fm.tri.max()) == model.num_vertices - 1
    model.tri = model.tri.copy()
    model.tri[3, 1] = model.num_vertices + 1          # 1-based: one past
    with pytest.raises(ValueError, match="outside"):
        tmorph.device_bfm(model, "cpu")


# ---- K4: the grouped raster --------------------------------------------------

def _port_grouped(verts, tris, colors, h, w, group=4, batch=1):
    v = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(verts[None], (batch,) + verts.shape)))
    c = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(colors[None], (batch,) + colors.shape)))
    t = torch.from_numpy(np.array(tris, dtype=np.int32))
    img, mask = tops.render_colors_grouped(v, c, t, h=h, w=w, group=group)
    auto = tops.render_colors_auto(v, c, t, h=h, w=w, group=group)
    np.testing.assert_array_equal(auto[0].numpy(), img.numpy())
    np.testing.assert_array_equal(auto[1].numpy(), mask.numpy())
    return img.numpy(), mask.numpy()


def _jax_grouped(verts, tris, colors, h, w, batch=1, **kw):
    vb = np.broadcast_to(verts[None], (batch,) + verts.shape)
    cb = np.broadcast_to(colors[None], (batch,) + colors.shape)
    img, mask = jpallas.render_colors_grouped_pallas(vb, cb, tris, h=h, w=w,
                                                     interpret=True, **kw)
    return np.asarray(img), np.asarray(mask)


def test_grouped_matches_jax_grouped_kernel_on_the_fixture_mesh():
    """The tests/test_raster.py fixture mesh, which takes the TPU's grouped
    path (fits): the grouped kernel alone (fallback=False), and batch 16
    through its lax.cond, equal the port's grouped plain version and the
    sequential spec bit for bit."""
    v, t, c, h, w = case_mesh()
    spec = jref.render_colors_ref(v, t, c, h, w)
    got = _port_grouped(v, t, c, h, w)
    _equal((got[0][0], got[1][0]), spec)
    want = _jax_grouped(v, t, c, h, w, fallback=False)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    got16 = _port_grouped(v, t, c, h, w, batch=16)
    want16 = _jax_grouped(v, t, c, h, w, batch=16)
    np.testing.assert_array_equal(got16[1], want16[1])
    np.testing.assert_array_equal(got16[0], want16[0])


def test_grouped_scattered_order_matches_jax_fallback():
    """A group whose members lie 60 rows apart: the TPU takes its
    per-triangle fallback, the port's grouped merge needs none."""
    v, t, c, h, w = tself.GROUPED_CASES["grouped_scattered_order"]()
    _, fits = jpallas._grouped_table(v[None], t, h, w, 32, 4, pad_to=64)
    assert not bool(fits)
    got = _port_grouped(v, t, c, h, w)
    _equal((got[0][0], got[1][0]), jref.render_colors_ref(v, t, c, h, w))
    want = _jax_grouped(v, t, c, h, w)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_grouped_in_group_depth_tie_first_wins():
    """Six same-depth overlapping triangles over two groups: the lowest id
    owns the overlap, and the JAX grouped kernel agrees bit for bit."""
    v, t, c, h, w = tself.GROUPED_CASES["grouped_in_group_tie"]()
    got = _port_grouped(v, t, c, h, w)
    want = _jax_grouped(v, t, c, h, w, fallback=False)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0, 10, 10, 0] == 40
    flat = _port(v, t, c, h, w, "kernel")
    _equal((got[0][0], got[1][0]), flat)


def test_grouped_degenerate_and_occlusion():
    v, t, c, h, w = tself.GROUPED_CASES["grouped_degenerate_occlusion"]()
    got = _port_grouped(v, t, c, h, w)
    spec = jref.render_colors_ref(v, t, c, h, w)
    _equal((got[0][0], got[1][0]), spec)
    want = _jax_grouped(v, t, c, h, w, fallback=False)
    np.testing.assert_array_equal(got[0], want[0])
    assert spec[1][10, 12] > 0 and got[0][0, 10, 10, 0] == 200


@pytest.mark.parametrize("group", [1, 3, 4, 33])
def test_grouped_winner_equals_flat_winner(group):
    """Any group size gives the flat kernel's winner and depth, on the
    mesh and with an oversized triangle among its neighbours."""
    for case in (case_mesh, case_tall_triangle):
        v, t, _, h, w = case()
        vt = torch.from_numpy(v[None])
        tt = torch.from_numpy(t.astype(np.int32))
        gw, gd = tops.rasterize_winner_grouped(vt, tt, h=h, w=w, group=group)
        fw, fd = tops.rasterize_winner(vt, tt, h=h, w=w)
        assert torch.equal(gw, fw) and torch.equal(gd, fd)


@pytest.mark.parametrize("name", sorted({**tself.CASES,
                                         **tself.GROUPED_CASES}))
def test_selftest_cases_grouped_plain_equals_flat(name):
    """Every quirk and grouped case of the on-card gate, through the
    grouped plain version (K4's reference on the card) at each of its group
    sizes: bit for bit the flat plain version's winner and depth."""
    v, t, _, h, w = {**tself.CASES, **tself.GROUPED_CASES}[name]()
    vt = torch.from_numpy(v if v.ndim == 3 else v[None])
    tt = torch.from_numpy(t.astype(np.int32))
    want = traster.rasterize_winner(vt, tt, h, w)
    for g in tself.GROUP_SIZES:
        got = traster.rasterize_winner(vt, tt, h, w, group=g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_grouped_mixed_tiles_matches_jax_grouped_kernel_and_spec():
    """The tile-geometry case (three frames, each jittered its own way) at
    group 4 and B = 3: the port's grouped plain version (K4's reference on
    the card) equals the JAX grouped path and, frame by frame, the
    sequential spec, bit for bit.  Its scattered groups send the JAX path
    to its per-triangle fallback, which crops nothing here (no triangle is
    25 rows tall).  The spec's integer bbox cannot take a NaN corner, so it
    gets those triangles off the canvas, where they draw nothing too."""
    v, t, c = tself.grouped_mixed_tiles()
    h = w = 96
    img, mask = tops.render_colors_grouped(
        torch.from_numpy(v), torch.from_numpy(c), torch.from_numpy(t), h=h,
        w=w, group=4)
    img, mask = img.numpy(), mask.numpy()
    assert (mask > 0).sum((1, 2)).min() > 0
    assert not (mask[0] == mask[1]).all() and not (mask[1] == mask[2]).all()
    j_img, j_mask = jpallas.render_colors_grouped_pallas(
        v, c, t, h=h, w=w, group=4, interpret=True)
    np.testing.assert_array_equal(mask, np.asarray(j_mask))
    np.testing.assert_array_equal(img, np.asarray(j_img))
    for b in range(v.shape[0]):
        vb = v[b].copy()
        nan_tri = ~np.isfinite(vb[t]).all((1, 2))
        assert nan_tri.sum() == 2
        vb[t[nan_tri].reshape(-1), :2] = -50.0
        _equal((img[b], mask[b]), jref.render_colors_ref(vb, t, c[b], h, w))


@pytest.mark.parametrize("group", [3, 4, 8])
def test_grouped_mixed_tiles_holds_every_tile_kind(group):
    """The tile-geometry case as group_kernel (csrc/raster.cu) sees it at
    ``group``: in every frame the first 32/T groups (T the tile width, the
    smallest power of two >= group; one warp's tiles) hold a compact group
    of two or more live members on the union walk, a scattered group on
    the per-member walk, an all-empty group and a depth tie between two
    overlapping members; the last group is ragged, the warps' tiles
    straddle frames and the last warp holds tiles past the end."""
    v, t, _ = tself.grouped_mixed_tiles()
    b, f = v.shape[0], t.shape[0]
    h = w = 96
    tiles = 32 // (1 << (group - 1).bit_length())
    ngroups = -(-f // group)
    assert f % group and ngroups % tiles and (b * ngroups) % tiles
    corners = v[:, t]                                    # [B, F, 3, 3]
    with np.errstate(invalid="ignore"):
        x0 = np.maximum(np.ceil(corners[..., 0].min(-1)), 0.0)
        x1 = np.minimum(np.floor(corners[..., 0].max(-1)), w - 1.0)
        y0 = np.maximum(np.ceil(corners[..., 1].min(-1)), 0.0)
        y1 = np.minimum(np.floor(corners[..., 1].max(-1)), h - 1.0)
        depth = corners[..., 2].mean(-1)
        live = (np.isfinite(corners[..., :2]).all((-1, -2)) & (x1 >= x0)
                & (y1 >= y0) & (depth > -99999.0))
    area = (x1 - x0 + 1) * (y1 - y0 + 1)
    for frame in range(b):
        kinds = set()
        for g in range(tiles):
            m = np.arange(g * group, (g + 1) * group)
            m = m[live[frame, m]]
            if m.size == 0:
                kinds.add("empty")
                continue
            bx0, bx1 = x0[frame, m], x1[frame, m]
            by0, by1 = y0[frame, m], y1[frame, m]
            uarea = (bx1.max() - bx0.min() + 1) * (by1.max() - by0.min() + 1)
            if uarea > 2 * area[frame, m].sum() + 64:
                kinds.add("scattered")
            elif m.size >= 2:
                kinds.add("compact")
            for i in range(m.size):
                for j in range(i + 1, m.size):
                    if (depth[frame, m[i]] == depth[frame, m[j]]
                            and bx0[i] <= bx1[j] and bx0[j] <= bx1[i]
                            and by0[i] <= by1[j] and by0[j] <= by1[i]):
                        kinds.add("tie")
        assert kinds == {"compact", "scattered", "empty", "tie"}, (frame,
                                                                   kinds)


def test_grouped_entry_points_refuse_group_zero():
    v = torch.zeros((1, 3, 3))
    t = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="group"):
        tops.rasterize_winner_grouped(v, t, h=8, w=8, group=0)
    for kernel in tops.KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            kernel(v, t, 8, 8, group=4 if kernel.grouped else 0)
        assert kernel.launches == 0


# ---- K1/K3: triangle_kernel's balanced walk (the CPU model) -----------------

_WALK_MESH = []


def _mesh189_b2():
    """The main path's 189² mesh at B = 2, decoded at 224² by the port's
    own reconstruct_rotation with the head sway."""
    if not _WALK_MESH:
        from voicepuppet_torch.face3d import bfm as tbfm
        from voicepuppet_torch.face3d import morph as tmorph
        from voicepuppet_torch.pipeline.align import head_sway_angles
        model = tbfm.synthetic_bfm(num_theta=189, num_phi=189)
        fm = tmorph.device_bfm(model, "cpu")
        coeff = torch.as_tensor(tbfm.demo_coeff(model, batch=2, seed=1))
        angles = torch.as_tensor(head_sway_angles(2))
        rec = tmorph.reconstruct_rotation(coeff, fm, angles, image_size=224.0)
        verts = torch.cat([rec.face_projection, rec.z_buffer], -1)
        _WALK_MESH.append((verts.numpy(), fm.tri.numpy()))
    v, t = _WALK_MESH[0]
    return v, t, 224, 224


def _without_colors(make):
    def case():
        v, t, _, h, w = make()
        return v, t, h, w
    return case


_WALK_CASES = {
    "walk_balance": _without_colors(tself.CASES["walk_balance"]),
    "walk_balance_wide": _without_colors(tself.CASES["walk_balance_wide"]),
    "grouped_mixed_tiles": _without_colors(
        tself.GROUPED_CASES["grouped_mixed_tiles"]),
    "mesh189_b2": _mesh189_b2,
}


def _bboxes64(v, t, h, w, interp):
    """Each entry's clipped bbox area in float64, apart from the model:
    0 where the triangle cannot draw."""
    c = v[:, t].astype(np.float64)                       # [B, F, 3, 3]
    with np.errstate(invalid="ignore"):
        x0 = np.maximum(np.ceil(c[..., 0].min(-1)), 0.0)
        x1 = np.minimum(np.floor(c[..., 0].max(-1)), w - 1.0)
        y0 = np.maximum(np.ceil(c[..., 1].min(-1)), 0.0)
        y1 = np.minimum(np.floor(c[..., 1].max(-1)), h - 1.0)
        live = (np.isfinite(c[..., :2]).all((-1, -2)) & (x1 >= x0)
                & (y1 >= y0))
        if not interp:
            live &= traster._triangle_setup(
                torch.from_numpy(v), torch.from_numpy(t)
            )["depth"].numpy() > traster.DEPTH_INIT
    area = np.where(live, (x1 - x0 + 1) * (y1 - y0 + 1), 0.0)
    return area.reshape(-1).astype(np.int64)


@pytest.mark.parametrize("interp", [False, True], ids=["flat", "interp"])
@pytest.mark.parametrize("name", sorted(_WALK_CASES))
def test_walk_schedule_visits_every_bbox_pixel_once(name, interp):
    """The CPU model of triangle_kernel's walk (its scan, owner search and
    q -> (x, y) mapping): every pixel of every live entry's clipped bbox is
    visited exactly once, every fragment the plain version draws is among
    the visits, and each warp takes ceil(sum of its 32 areas / 32) steps,
    never more than the one-thread walk's largest bbox."""
    v, t, h, w = _WALK_CASES[name]()
    v = np.ascontiguousarray(v if v.ndim == 3 else v[None], np.float32)
    t = np.asarray(t, np.int32)
    x0, y0, bw, bh = tself.walk_entries(v, t, h, w, interp)
    area = _bboxes64(v, t, h, w, interp)
    np.testing.assert_array_equal(bw * bh, area)
    entry, x, y, steps = tself.walk_schedule(x0, y0, bw, bh)
    assert ((x >= x0[entry]) & (x < x0[entry] + bw[entry])
            & (y >= y0[entry]) & (y < y0[entry] + bh[entry])).all()
    # each (entry, bbox pixel) once: their row-major codes are 0 .. N-1
    start = np.cumsum(area) - area
    code = start[entry] + (y - y0[entry]) * bw[entry] + (x - x0[entry])
    np.testing.assert_array_equal(np.sort(code), np.arange(area.sum()))
    # every drawing fragment is visited
    f = t.shape[0]
    tri, pix, _ = traster._fragments(torch.from_numpy(v),
                                     torch.from_numpy(t), h, w, interp)
    frame = pix.numpy() // (h * w)
    drawn = (frame * f + tri.numpy()) * (h * w) + pix.numpy() % (h * w)
    visited = entry * (h * w) + y * w + x
    assert np.isin(drawn, visited).all()
    padded = np.zeros(steps.shape[0] * tself.WARP, np.int64)
    padded[:area.shape[0]] = area
    per_warp = padded.reshape(-1, tself.WARP)
    np.testing.assert_array_equal(steps, -(-per_warp.sum(1) // tself.WARP))
    assert (steps <= per_warp.max(1)).all()


def test_bbox_position_is_exact():
    """The kernel's division-free q -> (dy, dx): exact for every bbox width
    1 ... 224 and every q < 224 w, and at widths and positions up to the
    wrapper's limit (q < 2^31)."""
    for width in range(1, 225):
        q = np.arange(width * 224)
        dy, dx = tself.bbox_position(q, np.full(q.shape, width))
        np.testing.assert_array_equal(dy, q // width)
        np.testing.assert_array_equal(dx, q % width)
    rng = np.random.default_rng(0)
    widths = np.concatenate([[1, 2, 3, 224, 225, 4096, 46341, 65535, 65536,
                              2 ** 31 - 1], rng.integers(1, 2 ** 31, 2000)])
    for width in widths:
        q = np.concatenate([[0, 2 ** 31 - 1, 2 ** 31 - 2],
                            rng.integers(0, 2 ** 31, 500)])
        q = np.concatenate([q, q - q % width, q - q % width - 1])
        q = q[q >= 0]
        dy, dx = tself.bbox_position(q, np.full(q.shape, width))
        np.testing.assert_array_equal(dy, q // width)
        np.testing.assert_array_equal(dx, q % width)


@pytest.mark.parametrize("name", ["walk_balance", "walk_balance_wide"])
def test_walk_balance_holds_every_entry_kind(name):
    """The balanced-walk case as triangle_kernel sees it, flat and
    interpolated: warp 0 holds a bbox over 128 px, a degenerate triangle
    that draws its whole bbox, a one-pixel bbox, empty entries (off each
    side of the canvas, NaN corners, no pixel centre), and an exact depth
    tie between two overlapping slots; warp 1 straddles two frames with
    live entries in both; warp 2 has no live entry; the last warp is
    ragged."""
    v, t, _, h, w = tself.CASES[name]()
    f = t.shape[0]
    n = v.shape[0] * f
    assert n % tself.WARP and -(-n // tself.WARP) == 4
    setup = traster._triangle_setup(torch.from_numpy(v), torch.from_numpy(t))
    depth = setup["depth"].numpy().reshape(-1)
    degenerate = (setup["inv_deno"] == 0).numpy().reshape(-1)
    tri, pix, _ = traster._fragments(torch.from_numpy(v),
                                     torch.from_numpy(t), h, w, False)
    drawn = np.bincount(pix.numpy() // (h * w) * f + tri.numpy(),
                        minlength=n)
    nan = ~np.isfinite(v[:, t]).all((-1, -2)).reshape(-1)
    for interp in (False, True):
        x0, y0, bw, bh = tself.walk_entries(v, t, h, w, interp)
        area = bw * bh
        lanes = np.arange(tself.WARP)
        w0 = lanes
        assert area[w0].max() > 128 and (area[w0] == 1).any()
        deg = w0[degenerate[w0] & (area[w0] > 1)]
        assert deg.size and (drawn[deg] == area[deg]).all()
        assert (area[w0] == 0).sum() >= 8 and nan[w0].sum() >= 2
        ties = [(i, j) for i in w0 for j in w0 if i < j and area[i]
                and area[j] and depth[i] == depth[j]
                and x0[i] <= x0[j] + bw[j] - 1 and x0[j] <= x0[i] + bw[i] - 1
                and y0[i] <= y0[j] + bh[j] - 1 and y0[j] <= y0[i] + bh[i] - 1]
        assert ties
        w1 = 32 + lanes
        assert len(set(w1 // f)) == 2
        assert all(area[w1[w1 // f == b]].any() for b in set(w1 // f))
        assert area[64 + lanes].sum() == 0
