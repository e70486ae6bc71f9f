"""The raster A/B probes of the port (``ops/raster_probes.py``, plain
versions in ``face3d/raster.py``) against the JAX probe kernels of
``experiments/``, run in Pallas interpret mode on the CPU.

The probe kernels are loaded from the experiment scripts without running
them: the scripts do all their work at import, so only their imports and
undecorated functions are executed (``_load_script``), and the kernels
are launched through ``raster_pallas._winner_pallas_call``.

Contract: winners and depths equal, except at pixels that the test proves
borderline in float64 (the pixel centre within 1e-4 of an edge of the
port's or JAX's winner in barycentric units: XLA's CPU contracts
``a*b + c*d`` into an FMA where the port rounds twice, ROADMAP Queue 3).
X1 in JAX also tests the full-width window with no bbox, so a pixel just
outside a bbox may pass its inside test by rounding: such pixels are
borderline by the same proof.  The departing pixel counts are printed.
"""

import argparse
import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import morph as jmorph
from voicepuppet_tpu.ops import raster_pallas as jpallas

from voicepuppet_torch import ops as tops
from voicepuppet_torch.experiments import _common, _timing
from voicepuppet_torch.face3d import raster as traster
from voicepuppet_torch.ops import raster_probes as tprobes
from voicepuppet_torch.ops import raster_selftest as tself
from voicepuppet_torch.ops.raster import _check_size

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
BATCH = 8          # a multiple of every fb below: the JAX grid is B // fb
N_VERTS = 3 * 512  # the band-fitting mesh's vertices
EDGE_EPS = 1e-4    # against XLA's FMA (ROADMAP Queue 3)


@functools.lru_cache(maxsize=None)
def _load_script(name):
    """The imports and undecorated functions of ``experiments/<name>``,
    executed without the script's module-level work."""
    path = os.path.join(REPO, "experiments", name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef) and not n.decorator_list)]
    ns = {"__name__": f"_probe_{name[:-3]}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _jax_probe(kind, b, h, w, f, win, fb, unroll=0, winner=True):
    """The JAX probe ``kind`` (x1 ``_kernel_b`` on ``_trim_table``, 12
    slots; x2 ``_kernel_unroll`` and x3 ``_regacc_kernel`` on
    ``_triangle_table``, 16 slots), jitted once per setting and shape:
    compiling the interpreted kernel is most of its cost here."""
    chunk = 512 // fb
    if kind == "x1":
        ns = _load_script("profile_raster2.py")
        make_table = functools.partial(ns["_trim_table"], h=h, w=w, win=win,
                                       pad_to=chunk)
        kernel = functools.partial(ns["_kernel_b"], winner=winner)
        slots = 12
    else:
        make_table = functools.partial(jpallas._triangle_table, h=h, w=w,
                                       win=win, pad_to=chunk)
        if kind == "x2":
            kernel = functools.partial(
                _load_script("profile_raster3.py")["_kernel_unroll"],
                unroll=unroll)
        else:
            kernel = functools.partial(
                _load_script("profile_raster_regacc.py")["_regacc_kernel"],
                unroll=jpallas._unroll_for(chunk))
        slots = 16
    kernel = functools.partial(kernel, h=h, w=w, num_tri=f, win=win, fb=fb,
                               chunk=chunk)

    @jax.jit
    def run(v, t):
        table = make_table(v, t)
        depth, win_buf = jpallas._winner_pallas_call(
            kernel, table, b=b, h=h, w=w, fb=fb,
            nc=table.shape[1] // chunk, slots=slots, interpret=True)
        return win_buf, depth
    return run


def _jax(kind, v, t, h, w, win=16, fb=8, **kw):
    out = _jax_probe(kind, v.shape[0], h, w, len(t), win, fb, **kw)(
        jnp.asarray(v), jnp.asarray(t))
    return tuple(np.asarray(o) for o in out)


def _port(fn, v, t, *args, **kw):
    out = fn(torch.from_numpy(np.ascontiguousarray(v)),
             torch.from_numpy(np.array(t, np.int32)), *args, **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _near_edge(v, tri, b, y, x, eps=EDGE_EPS):
    """True if pixel (x, y) of frame b lies within ``eps`` of an edge of
    triangle ``tri``, in float64 barycentrics."""
    p0, p1, p2 = (v[b, i, :2].astype(np.float64) for i in tri)
    v0, v1, v2 = p2 - p0, p1 - p0, np.array([x, y], np.float64) - p0
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d02, d12 = v0 @ v2, v1 @ v2
    deno = d00 * d11 - d01 * d01
    if deno == 0:
        return False
    u = (d11 * d02 - d01 * d12) / deno
    uv = (d00 * d12 - d01 * d02) / deno
    return min(abs(u), abs(uv), abs(u + uv - 1.0)) < eps


def expect_borderline(got, want, v, t, label):
    """(winner, depth) of the port against JAX's: equal, except at pixels
    proven borderline for the port's or JAX's winner.  Returns the count
    of departing pixels."""
    f = len(t)
    gw, gd = got
    ww, wd = want
    assert gw.shape == ww.shape and gd.shape == wd.shape, label
    bad = np.argwhere((gw != ww) | (gd != wd))
    assert len(bad) <= tself_budget(v), (label, len(bad))
    for b, y, x in bad:
        cands = {int(gw[b, y, x]), int(ww[b, y, x])} - {f}
        assert any(_near_edge(v, t[c], b, y, x) for c in cands), (
            label, (b, y, x), cands)
    print(f"{label}: {len(bad)} borderline pixels of {gw.size}")
    return len(bad)


def tself_budget(v):
    """The JAX selftest's borderline budget (16 per frame)."""
    return 16 * v.shape[0]


# ---- the meshes: (verts [B,V,3], tris [F,3], h, w) -------------------------

def _frames(v, shift_y=True, n_verts=0):
    """``BATCH`` frames of one mesh, each moved by a distinct sub-pixel
    shift, with unused vertices appended up to ``n_verts``: meshes of one
    shape share the JAX probes' compiled programs."""
    i = np.arange(BATCH, dtype=np.float32)[:, None]
    shift = np.concatenate([0.37 * i - 1.3, (0.23 * i - 0.8) * shift_y,
                            0.0 * i], 1)
    v = np.concatenate([v, np.zeros((max(n_verts - len(v), 0), 3))])
    return (v[None] + shift[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fixture():
    """tests/test_raster.py's sphere-patch mesh at 64², 17 x 17 vertices:
    512 triangles, as many as the band-fitting mesh, so the two share the
    JAX probes' compiled programs."""
    model = jbfm.synthetic_bfm(num_theta=17, num_phi=17, seed=0)
    fm = jmorph.device_bfm(model)
    rec = jmorph.reconstruct(jbfm.demo_coeff(model, batch=1, seed=1), fm,
                             image_size=float(H))
    proj = np.asarray(rec.face_projection[0])
    proj = (proj - proj.mean(0)) * (26.0 / np.abs(proj - proj.mean(0)).max()
                                    ) + np.array([W / 2, H / 2])
    verts = np.concatenate([proj, np.asarray(rec.z_buffer[0])], 1)
    return verts.astype(np.float32), np.asarray(fm.tri, np.int32)


def mesh_fixture():
    v, t = _fixture()
    return _frames(v, n_verts=N_VERTS), t, H, W


def mesh_degenerate():
    """The fixture mesh with its last 13 triangles made zero-area and put
    in front of it, the same in every frame (a shift would round their
    corners off the line): collinear corners on a diagonal and on a row,
    and one with two equal corners.  K1 lets each cover its bbox; X1 drops
    them."""
    v, t = _fixture()
    z = float(v[:, 2].max()) + 1.0
    extra = []
    for k in range(6):
        x0, y0 = 18.0 + 5.0 * k, 20.0 + 3.0 * k
        extra += [[x0, y0], [x0 + 2.0, y0 + 2.0], [x0 + 4.0, y0 + 4.0]]
        extra += [[x0, y0 + 9.0], [x0 + 3.0, y0 + 9.0], [x0 + 6.0, y0 + 9.0]]
    extra += [[30.0, 30.0], [30.0, 30.0], [36.5, 40.5]]
    extra = np.concatenate([np.asarray(extra, np.float32),
                            np.full((len(extra), 1), z, np.float32)], 1)
    tris = np.concatenate([t[:len(t) - len(extra) // 3],
                           N_VERTS - len(extra) + np.arange(
                               len(extra), dtype=np.int32).reshape(-1, 3)])
    verts = np.concatenate([_frames(v, n_verts=N_VERTS - len(extra)),
                            np.broadcast_to(extra, (BATCH,) + extra.shape)],
                           1)
    return np.ascontiguousarray(verts), tris, H, W


def mesh_soup():
    v, t, _ = tself.soup(seed=0)
    return _frames(v), t, tself.H, tself.W


def mesh_unsorted():
    """The fixture mesh in a random triangle order: chunks lose their
    screen locality, so X3's bands drop fragments."""
    v, t = _fixture()
    perm = np.random.default_rng(3).permutation(len(t))
    return _frames(v, n_verts=N_VERTS), t[perm], H, W


def mesh_band_fitting():
    v, t, _ = tself.band_fitting_mesh()
    return _frames(v, shift_y=False), t, 64, 64


X1_MESHES = {"fixture": mesh_fixture, "degenerate": mesh_degenerate,
             "soup": mesh_soup}
X3_MESHES = {"unsorted": mesh_unsorted, "band_fitting": mesh_band_fitting}


# ---- X1 ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(X1_MESHES))
def test_x1_matches_jax_kernel_b(name):
    """X1 in both modes against ``_kernel_b``; the winner mode's depth is
    the depth-only mode's, and X1 equals K1 off degenerate winners."""
    v, t, h, w = X1_MESHES[name]()
    got = _port(tprobes.raster_b, v, t, h, w)
    want = _jax("x1", v, t, h, w)
    expect_borderline(got, want, v, t, f"X1 {name}")
    depth_only = _port(tprobes.raster_b, v, t, h, w, winner=False)
    np.testing.assert_array_equal(depth_only, got[1])
    _, want_d = _jax("x1", v, t, h, w, winner=False)
    np.testing.assert_array_equal(want_d, want[1])
    k1 = _port(traster.rasterize_winner, v, t, h, w)
    deg_won = tself.expect_inside_only_matches_k1(
        torch.from_numpy(got[0]), torch.from_numpy(k1[0]),
        torch.from_numpy(v), torch.from_numpy(t), name)
    assert (deg_won > 0) == (name != "fixture")


@pytest.mark.parametrize("name", sorted(X1_MESHES))
def test_x1_degenerate_classification_matches_jax(name):
    """Whether a triangle is degenerate hangs on ``deno == 0``: the port's
    unfused order and XLA's CPU order (which may contract it into an FMA)
    classify every triangle alike on these meshes."""
    v, t, h, w = X1_MESHES[name]()
    trim = jax.jit(functools.partial(
        _load_script("profile_raster2.py")["_trim_table"], h=h, w=w, win=16,
        pad_to=64))
    jdeg = np.asarray(trim(jnp.asarray(v), jnp.asarray(t))[:, :len(t), 10]
                      == -1e10)
    tdeg = traster.degenerate(torch.from_numpy(v), torch.from_numpy(t))
    differ = np.argwhere(jdeg != tdeg.numpy())
    assert len(differ) == 0, f"classified differently: {differ.tolist()}"
    assert jdeg.any() == (name != "fixture")


def test_x1_jax_crops_a_tall_triangle_port_does_not():
    """``_kernel_b`` tests only a win-row window at the triangle's aligned
    origin, so a triangle taller than win - 7 rows is cropped; the port
    walks the bbox and draws all of it, as K1 does."""
    v = np.array([[[20.3, 4.3, 2.0], [50.3, 30.6, 2.0], [12.6, 57.4, 2.0]]],
                 np.float32)
    t = np.array([[0, 1, 2]], np.int32)
    got = _port(tprobes.raster_b, v, t, H, W)
    k1 = _port(traster.rasterize_winner, v, t, H, W)
    np.testing.assert_array_equal(got[0], k1[0])
    jw, _ = _jax("x1", v, t, H, W, fb=1)
    rows_port = set(np.nonzero((got[0][0] == 0).any(1))[0].tolist())
    rows_jax = set(np.nonzero((jw[0] == 0).any(1))[0].tolist())
    # the window: rows 0..15 from the aligned origin floor(5 / 8) * 8 = 0
    assert rows_jax == {r for r in rows_port if r < 16}
    assert max(rows_port) >= 56
    np.testing.assert_array_equal(jw[0][:16], got[0][0][:16])


# ---- X2 ----------------------------------------------------------------------

@pytest.mark.parametrize("fb,unroll", [(8, 2), (8, 4), (2, 4), (4, 8)])
def test_x2_kernel_unroll_is_k1(fb, unroll):
    """``_kernel_unroll`` at the JAX script's four settings against the
    port's K1 plain version, which is X2's (``raster_u`` on CPU tensors)."""
    v, t, h, w = mesh_fixture()
    got = _port(tprobes.raster_u, v, t, h, w, fb=fb, unroll=unroll)
    k1 = _port(traster.rasterize_winner, v, t, h, w)
    np.testing.assert_array_equal(got[0], k1[0])
    np.testing.assert_array_equal(got[1], k1[1])
    expect_borderline(got, _jax("x2", v, t, h, w, fb=fb, unroll=unroll), v, t,
                      f"X2 fb {fb} unroll {unroll}")


# ---- X3 ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(X3_MESHES))
@pytest.mark.parametrize("win,fb", tself.REGACC_SETTINGS)
def test_x3_matches_jax_regacc_kernel(name, win, fb):
    """X3 against ``_regacc_kernel``: on an unsorted order it drops
    fragments outside each chunk's band and so differs from K1; on the
    band-fitting mesh it equals K1."""
    v, t, h, w = X3_MESHES[name]()
    got = _port(tprobes.rasterize_regacc, v, t, h, w, win=win, fb=fb)
    expect_borderline(got, _jax("x3", v, t, h, w, win, fb), v, t,
                      f"X3 {name} win {win} fb {fb}")
    k1 = _port(traster.rasterize_winner, v, t, h, w)
    fits = bool((got[0] == k1[0]).all() and (got[1] == k1[1]).all())
    assert fits == (name == "band_fitting")


def test_x3_band_origin_comes_from_the_chunk_first_triangle():
    """The band of each chunk starts at its first triangle's aligned window
    even when that triangle draws nothing: above the canvas (row 0), NaN
    (row 0, XLA's NaN to int32), below it (clipped to h - win) or an empty
    sliver between pixel centres (its own band)."""
    v, t, h, w = mesh_band_fitting()
    v = v.copy()
    v[:, t[0]] = [[20.3, -40.0, 9.0], [24.3, -35.0, 9.0], [22.3, -30.0, 9.0]]
    v[:, t[64], 1] = np.nan
    v[:, t[128]] = [[20.3, 200.0, 9.0], [24.3, 205.0, 9.0], [22.3, 210.0,
                                                              9.0]]
    v[:, t[192]] = [[10.2, 25.3, 9.0], [10.8, 25.3, 9.0], [10.5, 27.4, 9.0]]
    origins = traster.band_origins(torch.from_numpy(v), torch.from_numpy(t),
                                   h, 16, 64)
    assert origins[0].tolist() == [0, 0, h - 16, 24, 32, 40, 48, 48]
    got = _port(tprobes.rasterize_regacc, v, t, h, w, win=16, fb=8)
    expect_borderline(got, _jax("x3", v, t, h, w, 16, 8), v, t,
                      "X3 band origins")


# ---- the wrappers and the entry points ---------------------------------------

def test_probe_wrappers_refuse_cpu_tensors_and_bad_settings():
    v = torch.zeros((1, 3, 3))
    t = torch.zeros((1, 3), dtype=torch.int32)
    for kernel in tprobes.PROBE_KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            kernel(v, t, 32, 32, 1, 1)
        assert kernel.launches == 0
    with pytest.raises(ValueError, match="unroll"):
        tprobes.raster_u(v, t, 32, 32, fb=3)
    with pytest.raises(ValueError, match="band"):
        tprobes.rasterize_regacc(v, t, 8, 32, win=16)
    with pytest.raises(ValueError, match="band"):
        tprobes.rasterize_regacc(v, t, 224, 4096, win=16)
    assert [tprobes.fb_for_batch(b) for b in (16, 12, 6, 5)] == [8, 4, 2, 1]


def test_band_fitting_case_equals_k1_under_x3_plain():
    """The on-card gate's band-fitting case: every X3 setting gives K1's
    output, so the gate can hold the kernel to K1 there."""
    v, t, _, h, w = tself.PROBE_CASES["band_fitting"]()
    vt, tt = torch.from_numpy(v[None]), torch.from_numpy(t)
    k1 = traster.rasterize_winner(vt, tt, h, w)
    assert int((k1[0] < len(t)).sum()) > 1000
    for win, fb in tself.REGACC_SETTINGS:
        got = traster.rasterize_winner_banded(vt, tt, h, w, win, 512 // fb)
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])


def test_build_progs_raises_on_a_failing_variant():
    """No variant is skipped in silence: a failure stops the A/B."""
    def broken(x):
        raise RuntimeError("launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        _timing.build_progs({"ok": (lambda x: x, 1), "bad": (broken, 1)}, 2,
                            device="cpu", log=None)
    progs = _timing.build_progs({"ok": (lambda x: x, 1)}, 2, device="cpu",
                                log=None)
    mins1, minsk = _timing.interleaved_minima(progs, rounds=2, log=None)
    per = _timing.per_iter(mins1, minsk, 2)
    assert set(per) == {"ok"} and np.isfinite(per["ok"])


PROFILES = ("profile_raster", "profile_raster2", "profile_raster3",
            "profile_raster_regacc", "profile_raster_grouped")


@pytest.mark.parametrize("name", PROFILES)
def test_profile_entry_point_runs_on_cpu(name, capsys):
    """Importing the module does nothing; its main runs at a tiny size on
    the CPU (K = 2, one round) and prints its parity and FINAL lines."""
    import importlib
    mod = importlib.import_module(f"voicepuppet_torch.experiments.{name}")
    assert capsys.readouterr().out == ""
    per = mod.main(["--device", "cpu", "--batch", "2", "--k", "2",
                    "--rounds", "1", "--mesh", "8"])
    out = capsys.readouterr().out
    assert per and all(np.isfinite(s) for s in per.values())
    assert "ns/tri-frame" in out and "on cpu" in out
    if name == "profile_raster3":
        assert "U4 winner exact: True depth exact: True" in out
    if name == "profile_raster_grouped":
        assert out.count("winner True depth True") == 4
    if name == "profile_raster_regacc":
        assert "decision:" in out


# ---- CPU models of X1's, X2's and X3's walks (ops/raster_selftest.py) -------

# one (unroll, fb) setting whose warp holds L = 32 x unroll x fb entries
SETTING_FOR_L = {32: (1, 1), 64: (2, 1), 256: (4, 2), 2048: (8, 8)}
MODEL_CASES = {**tself.CASES, **tself.GROUPED_CASES, **tself.PROBE_CASES}


def _model_case(name):
    v, t, _, h, w = MODEL_CASES[name]()
    return (np.ascontiguousarray(v if v.ndim == 3 else v[None], np.float32),
            np.asarray(t, np.int32), h, w)


def _expect_walk_covers(v, t, h, w, boxes, visits, label):
    """Every pixel of every box (x0, y0, width, height) [B*F] is visited
    exactly once, and nothing else: their row-major codes are 0 .. N-1."""
    x0, y0, bw, bh = boxes
    entry, x, y = visits
    assert ((x >= x0[entry]) & (x < x0[entry] + bw[entry])
            & (y >= y0[entry]) & (y < y0[entry] + bh[entry])).all(), label
    area = bw * bh
    start = np.cumsum(area) - area
    code = start[entry] + (y - y0[entry]) * bw[entry] + (x - x0[entry])
    np.testing.assert_array_equal(np.sort(code), np.arange(area.sum()),
                                  err_msg=label)


def _drawn(v, t, h, w, drop_degenerate=False):
    """(flat entry b * F + f, frame, pixel within the frame) of every
    fragment K1's plain version draws (X1's with ``drop_degenerate``)."""
    tri, pix, _ = traster._fragments(torch.from_numpy(v), torch.from_numpy(t),
                                     h, w, False,
                                     drop_degenerate=drop_degenerate)
    frame = pix.numpy() // (h * w)
    return frame * t.shape[0] + tri.numpy(), frame, pix.numpy() % (h * w)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
@pytest.mark.parametrize("slots", sorted(SETTING_FOR_L))
def test_unroll_walk_model_visits_every_bbox_pixel_once(slots, name):
    """X2's schedule as one list of L = 32 x unroll x fb slots a warp
    (``unroll_order`` with rounds of L): every entry sits in one slot,
    the log2(L)-step owner search visits every bbox pixel of every entry
    exactly once and every fragment K1 draws, each list takes
    ceil(its area / 32) steps, and at L = 32 the schedule is K1's."""
    v, t, h, w = _model_case(name)
    b, f = v.shape[0], t.shape[0]
    unroll, fb = SETTING_FOR_L[slots]
    order = tself.unroll_order(b, f, unroll, fb, round_slots=slots)
    assert order.shape[1] == slots
    np.testing.assert_array_equal(np.sort(order[order >= 0]),
                                  np.arange(b * f))
    boxes = tself.walk_entries(v, t, h, w)
    entry, x, y, steps = tself.walk_schedule(*boxes, slots=slots,
                                             order=order)
    _expect_walk_covers(v, t, h, w, boxes, (entry, x, y), name)
    drawn, frame, pix = _drawn(v, t, h, w)
    assert np.isin(drawn * (h * w) + pix, entry * (h * w) + y * w + x).all()
    area = np.where(order >= 0, (boxes[2] * boxes[3])[order], 0)
    np.testing.assert_array_equal(steps, -(-area.sum(1) // tself.WARP))
    if slots == 32:
        for got, want in zip((entry, x, y, steps),
                             tself.walk_schedule(*boxes)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounds", [tself.WARP, 256])
@pytest.mark.parametrize("fb", tprobes.UNROLLS)
@pytest.mark.parametrize("unroll", tprobes.UNROLLS)
def test_unroll_walk_model_in_rounds(unroll, fb, rounds):
    """Rounds of at most ``rounds`` slots (the kernel's 32, one entry a
    lane, and 256, the same entries in longer lists) at every setting, on 8 frames of the soup: each warp's lanes build
    ``unroll`` consecutive triangles in ``fb`` consecutive frames, split
    into lists of min(32 x unroll x fb, rounds) slots, and the walk still
    visits every bbox pixel once."""
    v, t, h, w = mesh_soup()
    b, f = v.shape[0], t.shape[0]
    order = tself.unroll_order(b, f, unroll, fb, round_slots=rounds)
    kr = min(unroll * fb, rounds // tself.WARP)
    assert order.shape[1] == tself.WARP * kr
    np.testing.assert_array_equal(np.sort(order[order >= 0]),
                                  np.arange(b * f))
    # a warp's rounds, lane by lane: unroll consecutive triangles x fb
    # consecutive frames per lane
    lanes = order.reshape(-1, unroll * fb // kr, tself.WARP, kr)
    per_lane = lanes.transpose(0, 2, 1, 3).reshape(-1, unroll * fb)
    full = per_lane[(per_lane >= 0).all(1)]
    tri, frame = full % f, full // f
    np.testing.assert_array_equal(tri.reshape(-1, unroll, fb)
                                  - tri[:, :1, None], np.broadcast_to(
                                      np.arange(unroll)[:, None],
                                      (len(full), unroll, fb)))
    np.testing.assert_array_equal(frame.reshape(-1, unroll, fb)
                                  - frame[:, :1, None], np.broadcast_to(
                                      np.arange(fb), (len(full), unroll, fb)))
    boxes = tself.walk_entries(v, t, h, w)
    entry, x, y, _ = tself.walk_schedule(*boxes, slots=order.shape[1],
                                         order=order)
    _expect_walk_covers(v, t, h, w, boxes, (entry, x, y), "soup")


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_inside_only_walk_model_visits_every_bbox_pixel_once(name):
    """X1's schedule (``inside_only_entries`` walked in K1's warps of 32):
    every bbox pixel of every non-degenerate entry that draws is visited
    exactly once and no pixel of a degenerate entry, every fragment X1's
    plain version draws is visited, each warp takes ceil(its area / 32)
    steps, and on a case with no degenerate entry that has a pixel the
    schedule is K1's."""
    v, t, h, w = _model_case(name)
    boxes = tself.inside_only_entries(v, t, h, w)
    entry, x, y, steps = tself.walk_schedule(*boxes)
    _expect_walk_covers(v, t, h, w, boxes, (entry, x, y), name)
    deg = traster.degenerate(torch.from_numpy(v),
                             torch.from_numpy(t)).numpy().reshape(-1)
    assert not deg[entry].any()
    k1 = tself.walk_entries(v, t, h, w)
    for got, want in zip(boxes, k1):        # only degenerate entries differ
        np.testing.assert_array_equal(got[~deg], want[~deg])
    drawn, _, pix = _drawn(v, t, h, w, drop_degenerate=True)
    assert np.isin(drawn * (h * w) + pix, entry * (h * w) + y * w + x).all()
    np.testing.assert_array_equal(
        steps, -(-tself.warp_areas(boxes[2], boxes[3]).sum(1) // tself.WARP))
    if not (deg & (k1[2] * k1[3] > 0)).any():
        for got, want in zip((entry, x, y, steps), tself.walk_schedule(*k1)):
            np.testing.assert_array_equal(got, want)


def test_inside_only_walk_steps_on_the_probe_mesh():
    """On the probe mesh (``_common.probe_mesh``: the 189² synthetic BFM,
    seeds 0 and 1) at B = 2, 224²: X1's warp steps are K1's less only the
    degenerate entries' share, warp by warp, and equal K1's in every warp
    without a degenerate pixel.  F = 70,688 = 32 x 2,209, so no warp
    straddles frames here (the 192² mesh's do, on the card)."""
    vt, tt = _common.probe_mesh(argparse.Namespace(device="cpu", batch=2,
                                                   mesh=189), 0, 1)
    v, t = vt.numpy(), tt.numpy()
    assert t.shape[0] == 32 * 2209
    k1 = tself.walk_entries(v, t, 224, 224)
    x1 = tself.inside_only_entries(v, t, 224, 224)
    deg = traster.degenerate(vt, tt).numpy().reshape(-1)
    k1_area = tself.warp_areas(k1[2], k1[3]).sum(1)
    deg_area = tself.warp_areas(np.where(deg, k1[2], 0), k1[3]).sum(1)
    assert deg_area.sum() > 0
    _, _, _, k1_steps = tself.walk_schedule(*k1)
    _, _, _, x1_steps = tself.walk_schedule(*x1)
    np.testing.assert_array_equal(k1_steps, -(-k1_area // tself.WARP))
    np.testing.assert_array_equal(
        x1_steps, -(-(k1_area - deg_area) // tself.WARP))
    np.testing.assert_array_equal(x1_steps[deg_area == 0],
                                  k1_steps[deg_area == 0])
    print(f"probe mesh B=2: K1 {k1_steps.sum()} warp steps, X1 "
          f"{x1_steps.sum()}, {deg.sum()} degenerate entries, "
          f"{deg_area.sum()} of {k1_area.sum()} bbox px")


def _band_case(name):
    if name in X3_MESHES:
        return X3_MESHES[name]()
    return _model_case(name)


@pytest.mark.parametrize("name", sorted({**tself.CASES, **tself.PROBE_CASES,
                                         **X3_MESHES}))
@pytest.mark.parametrize("win,fb",
                         tself.REGACC_SETTINGS + tself.REGACC_LISTS)
def test_band_walk_model_stays_in_the_union_rectangle(win, fb, name):
    """X3's schedule (``band_boxes``): each bbox clipped to its chunk's
    band is visited pixel by pixel exactly once by the warps' walks, every
    in-band fragment of ``rasterize_winner_banded`` is visited, no visit
    lies outside the band or the block's union rectangle, and the union
    lies inside the band and the canvas (empty exactly where no clipped
    bbox draws)."""
    v, t, h, w = _band_case(name)
    b, f = v.shape[0], t.shape[0]
    chunk = 512 // fb
    nc = -(-f // chunk)
    x0, y0, bw, bh, order, union = tself.band_boxes(v, t, h, w, win, chunk)
    assert order.shape == (b * nc, tprobes.regacc_slots(chunk))
    entry, x, y, _ = tself.walk_schedule(x0, y0, bw, bh,
                                         slots=order.shape[1], order=order)
    _expect_walk_covers(v, t, h, w, (x0, y0, bw, bh), (entry, x, y), name)
    start = traster.band_origins(torch.from_numpy(v), torch.from_numpy(t), h,
                                 win, chunk).numpy()
    # every in-band fragment of the plain version is visited
    drawn, frame, pix = _drawn(v, t, h, w)
    lo = start[frame, (drawn % f) // chunk]
    keep = (pix // w >= lo) & (pix // w < lo + win)
    assert np.isin(drawn[keep] * (h * w) + pix[keep],
                   entry * (h * w) + y * w + x).all()
    # nothing outside the band, nothing outside the union rectangle
    block = (entry // f) * nc + (entry % f) // chunk
    lo_v = start.reshape(-1)[block]
    assert ((y >= lo_v) & (y < lo_v + win)).all()
    u = union[block]
    assert ((x >= u[:, 0]) & (x <= u[:, 1]) & (y >= u[:, 2])
            & (y <= u[:, 3])).all()
    live = np.zeros(b * nc, bool)
    live[(np.arange(b * f) // f * nc + np.arange(b * f) % f // chunk)[
        bw * bh > 0]] = True
    empty = union[:, 0] > union[:, 1]
    np.testing.assert_array_equal(empty, ~live)
    assert (union[empty] == [2 ** 31 - 1, -1, 2 ** 31 - 1, -1]).all()
    ok = union[~empty]
    band = start.reshape(-1)[~empty]
    assert ((ok[:, 0] >= 0) & (ok[:, 1] < w) & (ok[:, 2] >= band)
            & (ok[:, 3] < band + win) & (ok[:, 2] <= ok[:, 3])).all()


def test_band_walk_model_empty_chunks():
    """A chunk whose triangles all lie off the canvas, and one whose band
    (from a first triangle far below) holds none of its rows: both have an
    empty union, so the kernel touches no memory for them, and the plain
    version gives them no pixel."""
    v, t, h, w = mesh_band_fitting()
    v = v.copy()
    v[:, t[128:192].reshape(-1), 0] -= 200.0          # chunk 2: off canvas
    v[:, t[192]] = [[20.3, 200.0, 9.0], [24.3, 205.0, 9.0],
                    [22.3, 210.0, 9.0]]                # chunk 3: band 48-63
    _, _, bw, bh, order, union = tself.band_boxes(v, t, h, w, 16, 64)
    nc = union.shape[0] // v.shape[0]
    empty = (union[:, 0] > union[:, 1]).reshape(-1, nc)
    assert empty[:, 2:4].all() and not empty[:, [0, 1, 4, 5, 6, 7]].any()
    winner, _ = traster.rasterize_winner_banded(torch.from_numpy(v),
                                                torch.from_numpy(t), h, w,
                                                16, 64)
    won = winner.numpy()
    assert not ((won >= 128) & (won < 256)).any()
    assert ((won >= 256) & (won < len(t))).any()


def test_regacc_shared_bytes():
    """X3's shared memory a block: the band's keys and the chunk's walk
    list, 84 B a slot, the list the power of two >= max(chunk, 32)."""
    assert [tprobes.regacc_slots(c) for c in (1, 32, 33, 64, 100, 512)] == [
        32, 32, 64, 64, 128, 512]
    assert tprobes.regacc_shared_bytes(16, 224, 64) == 28672 + 64 * 84
    assert tprobes.regacc_shared_bytes(16, 224, 128) == 28672 + 128 * 84
    assert tprobes.regacc_shared_bytes(8, 224, 64) == 14336 + 64 * 84
    assert tprobes.regacc_shared_bytes(1, 3, 1) == 32 + 32 * 84


@pytest.mark.parametrize("slots", sorted(SETTING_FOR_L))
def test_unroll_wrapper_refuses_32bit_sums(slots):
    """X2 walks a warp's L = 32 x unroll x fb entries in rounds of 32
    slots, so a round sums at most 32 x h x w, as K1's warp does.  The
    size check that every CUDA call of the wrapper makes before it builds
    or launches anything (``_check``, K1's ``_check_size``) refuses
    32 x h x w >= 2^31, which keeps a round's sums and pixel indices below
    2^32 at every L; a canvas whose whole list L x h x w reaches 2^32 while
    its rounds stay below is admitted."""
    unroll, fb = SETTING_FOR_L[slots]
    # one warp's entries: unroll x fb rounds of 32 slots
    order = tself.unroll_order(fb, tself.WARP * unroll, unroll, fb)
    assert order.shape == (unroll * fb, tself.WARP)
    h = 1024
    w = 2 ** 31 // (tself.WARP * h)
    with pytest.raises(ValueError, match="unsupported raster size"):
        _check_size(1, 64, h, w)
    _check_size(1, 64, h, w - 1)
    assert tself.WARP * h * (w - 1) + tself.WARP < 2 ** 32
    hw = -(-2 ** 32 // slots)      # the least h x w with L x h x w >= 2^32
    if tself.WARP * hw < 2 ** 31:
        _check_size(1, 64, 1, hw)
