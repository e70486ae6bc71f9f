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
from voicepuppet_torch.experiments import _timing
from voicepuppet_torch.face3d import raster as traster
from voicepuppet_torch.ops import raster_probes as tprobes
from voicepuppet_torch.ops import raster_selftest as tself

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
