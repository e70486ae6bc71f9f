"""The data-prep toolchain of the PyTorch port (voicepuppet_torch/tools/
makelist.py, bfm_tools.py, convert_assets.py, models_torch.py,
prepare_dataset.py and face3d/raster_native.py) against the JAX
package's functions on the same inputs, on the CPU.

Equalities are to the bit (files byte for byte, arrays exactly, the same
errors with the same messages), except the rendered faces of steps 5 and
6.  The JAX raster off the TPU fills only a ``bb x bb`` window of each
triangle's bbox, and ``_render_faces`` fixes ``bb = round(6 · size /
224)`` (7 at 256²) while the port walks whole bboxes (ROADMAP Queue 3);
so the clip renders ``synthetic_bfm(110, 110)`` (written to the
config's model dir as ``BFM_model_front.mat``), whose largest triangle
bbox is asserted to fit the window at 96² (stretched silhouette
triangles reach 13 px at 256², 11-13 px at any grid); the render is held
there, and steps 5 and 6 at 256² are held with the JAX Schedule drawing
the port's faces.  A pixel that still differs must lie within 1e-4 of
an edge in float64 or in the bbox of a sliver (test_torch_infer_drivers.
py), or, one code apart, in the bbox of a triangle with a vertex colour
within 1e-3 of an integer (the flat colour floors each vertex colour,
and the two 3DMM decodes' float orders may floor it apart).  Measured:
3 pixels of 46,080, all colour floors (6 of 181,500 vertex colour
components floor apart).
"""

import dataclasses
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import raster_native as jrn
from voicepuppet_tpu.tools import bfm_tools as jbt
from voicepuppet_tpu.tools import convert_assets as jca
from voicepuppet_tpu.tools import makelist as jml
from voicepuppet_tpu.tools import models_torch as jmt
from voicepuppet_tpu.tools import prepare_dataset as jpd

from voicepuppet_torch.face3d import raster_native as trn
from voicepuppet_torch.tools import bfm_tools as tbt
from voicepuppet_torch.tools import convert_assets as tca
from voicepuppet_torch.tools import makelist as tml
from voicepuppet_torch.tools import models_torch as tmt
from voicepuppet_torch.tools import prepare_dataset as tpd
from voicepuppet_torch.utils import native

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

T = 5           # frames of the prep clip (one padded render chunk)
GRID = 110      # the clip's synthetic_bfm grid
SRC_SIZE = 224  # the clip's frames
RENDER_SIZE = 96  # the window 6 holds every triangle bbox there


# ---- makelist, save_obj, BFM09 -------------------------------------------

def _clip_tree(root):
    """Six clips: BFM-style (landmark, bfmcoeff, audio; one with a row
    count mismatch, one without audio) and PixRefer-style ({i}.jpg)."""
    rng = np.random.RandomState(0)
    for i in range(6):
        d = os.path.join(root, f"spk{i % 2}", f"clip{i}")
        os.makedirs(d)
        n = 3 + i
        np.savetxt(os.path.join(d, "landmark.txt"), rng.rand(n, 136),
                   delimiter=",")
        np.savetxt(os.path.join(d, "bfmcoeff.txt"),
                   rng.rand(n + (i == 4), 257), delimiter=",")
        if i != 2:
            open(os.path.join(d, "audio.wav"), "wb").write(b"RIFF")
        for k in range(i):
            open(os.path.join(d, f"{k}.jpg"), "wb").write(b"\xff\xd8")


@pytest.mark.parametrize("mode", ["bfm", "pixrefer"])
def test_makelist_matches_jax(tmp_path, mode):
    root = str(tmp_path / "data")
    _clip_tree(root)
    out = {}
    for name, mod in (("jax", jml), ("port", tml)):
        paths = (str(tmp_path / name / "train.txt"),
                 str(tmp_path / name / "eval.txt"))
        counts = mod.write_dataset(root, *paths, mode=mode, train_by_eval=2)
        out[name] = (counts, [open(p).read() for p in paths],
                     mod.collect_clips(root, mode, "landmark.txt"))
    assert out["port"] == out["jax"]
    assert sum(out["jax"][0]) > 2


def test_makelist_cli_matches_jax(tmp_path):
    root = str(tmp_path / "data")
    _clip_tree(root)
    for name, mod in (("jax", jml), ("port", tml)):
        cfg = tmp_path / f"{name}.yml"
        cfg.write_text(f"default:\n  train_dataset_path: {tmp_path}/{name}"
                       f"/train.txt\n  eval_dataset_path: {tmp_path}/"
                       f"{name}/eval.txt\n  root_path: {root}\n")
        mod.main(["--config_path", str(cfg)])
    for f in ("train.txt", "eval.txt"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_save_obj_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    v, c = rng.randn(40, 3), rng.rand(40, 3) * 255
    f = rng.randint(1, 41, (70, 3))
    jbt.save_obj(str(tmp_path / "j.obj"), v, f, c)
    tbt.save_obj(str(tmp_path / "t.obj"), v, f, c)
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()


def _bfm09(path):
    from test_bfm09_ingest import _write_fixture
    os.makedirs(path, exist_ok=True)
    return _write_fixture(path, np.random.RandomState(42))


def test_convert_bfm09_matches_jax(tmp_path):
    from scipy.io import loadmat
    src = str(tmp_path / "src")
    _bfm09(src)
    want = jbt.convert_bfm09(src, out_dir=str(tmp_path))
    got = tbt.convert_bfm09(src, out_name="port.mat",
                            out_dir=str(tmp_path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a = loadmat(str(tmp_path / "BFM_model_front.mat"))
    b = loadmat(str(tmp_path / "port.mat"))
    for k in want:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for x, y in zip(tbt.load_exp_basis(src), jbt.load_exp_basis(src)):
        np.testing.assert_array_equal(x, y)


def _truncate(d):
    path = os.path.join(d, "Exp_Pca.bin")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-8])


def _std_count(d):
    np.savetxt(os.path.join(d, "std_exp.txt"), np.ones(67))


def _front_idx(d):
    from scipy.io import loadmat, savemat
    idx = loadmat(os.path.join(d, "BFM_front_idx.mat"))["idx"]
    idx[-1] = 10_000
    savemat(os.path.join(d, "BFM_front_idx.mat"), {"idx": idx})


def _exp_idx(d):
    from scipy.io import loadmat, savemat
    t = loadmat(os.path.join(d, "BFM_exp_idx.mat"))["trimIndex"]
    savemat(os.path.join(d, "BFM_exp_idx.mat"), {"trimIndex": t[:-1]})


@pytest.mark.parametrize("breakage", [_truncate, _std_count, _front_idx,
                                      _exp_idx])
def test_bfm09_failures_match_jax(tmp_path, breakage):
    """The loud failures of test_bfm09_ingest.py, with JAX's messages."""
    src = str(tmp_path / "src")
    _bfm09(src)
    breakage(src)
    with pytest.raises(ValueError) as want:
        jbt.convert_bfm09(src, out_dir=str(tmp_path))
    with pytest.raises(ValueError) as got:
        tbt.convert_bfm09(src, out_dir=str(tmp_path))
    assert str(got.value) == str(want.value)


# ---- the native host raster ---------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    rng = np.random.RandomState(3)
    n = 60
    v = np.concatenate([rng.uniform(2, 46, (n, 2)),
                        rng.uniform(-5, 5, (n, 1))], 1).astype(np.float32)
    t = rng.randint(0, n, (90, 3)).astype(np.int32)
    return v, t, rng


def test_raster_native_matches_jax_bindings(mesh):
    v, t, rng = mesh
    c = (rng.rand(len(v), 3) * 255).astype(np.float32)
    for got, want in zip(trn.render_colors_native(v, t, c, 48, 52),
                         jrn.render_colors_native(v, t, c, 48, 52)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(trn.rasterize_triangles_native(v, t, 48, 52),
                         jrn.rasterize_triangles_native(v, t, 48, 52)):
        np.testing.assert_array_equal(got, want)
    tn = rng.randn(len(t), 3).astype(np.float32)
    np.testing.assert_array_equal(trn.vertex_normals_native(tn, t, len(v)),
                                  jrn.vertex_normals_native(tn, t, len(v)))
    tex = rng.rand(16, 20, 3).astype(np.float32)
    uv = rng.rand(len(v), 2).astype(np.float32)
    for bilinear in (True, False):
        for got, want in zip(
                trn.render_texture_native(v, t, tex, uv, t, 48, 52,
                                          bilinear),
                jrn.render_texture_native(v, t, tex, uv, t, 48, 52,
                                          bilinear)):
            np.testing.assert_array_equal(got, want)


def test_raster_native_builds_its_own_copy(mesh):
    """The library is the port's source built into build/, not
    native/libvp_raster.so; bad triangles fail before the C code."""
    path = native.build_library(trn._SRC, "vp_raster_host")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert "libvp_raster_host_" in os.path.basename(path)
    assert trn._SRC.endswith(os.path.join("voicepuppet_torch", "csrc",
                                          "vp_raster.cpp"))
    v, t, _ = mesh
    with pytest.raises(ValueError, match="out of"):
        trn.render_colors_native(v, t + len(v), np.ones_like(v), 8, 8)


# ---- the prep models -----------------------------------------------------

@pytest.mark.parametrize("name", ["UnetMobilenetV2", "DIMMatting",
                                  "UnetResNet"])
def test_models_torch_keys_and_forwards_match_jax(name):
    """The same state_dict keys and shapes (the checkpoints' wire format),
    and on shared weights the same outputs."""
    torch.manual_seed(0)
    want = getattr(jmt, name)().eval()
    got = getattr(tmt, name)().eval()
    ws, gs = want.state_dict(), got.state_dict()
    assert list(gs) == list(ws)
    assert all(gs[k].shape == ws[k].shape for k in ws)
    if name == "UnetResNet":
        return
    got.load_state_dict(ws)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        if name == "DIMMatting":
            tm = torch.rand(1, 1, 64, 64)
            np.testing.assert_array_equal(got(x, tm).numpy(),
                                          want(x, tm).numpy())
        else:
            np.testing.assert_array_equal(got(x).numpy(), want(x).numpy())
    img = np.random.RandomState(2).rand(70, 90, 3).astype(np.float32)
    if name == "UnetMobilenetV2":
        np.testing.assert_array_equal(tmt.predict_mask(got, img),
                                      jmt.predict_mask(want, img))


def test_models_torch_checkpoint_loads_match_jax(tmp_path):
    """The released layouts (state_dict blob; a pickled DataParallel
    module) load into the port's modules as into the JAX package's, and
    a scrambled one fails loudly."""
    torch.manual_seed(1)
    seg = jmt.UnetMobilenetV2()
    torch.save({"state_dict": seg.state_dict()}, str(tmp_path / "seg.pth"))
    torch.save({"model": torch.nn.DataParallel(jmt.DIMMatting())},
               str(tmp_path / "dim.tar"))
    for cls, path in (("UnetMobilenetV2", "seg.pth"),
                      ("DIMMatting", "dim.tar")):
        got, want = getattr(tmt, cls)(), getattr(jmt, cls)()
        assert got.load_state(str(tmp_path / path)) == \
            want.load_state(str(tmp_path / path))
        for k, v in want.state_dict().items():
            np.testing.assert_array_equal(got.state_dict()[k].numpy(),
                                          v.numpy())
    torch.save({"state_dict": {"x": torch.zeros(1)}},
               str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="matched only"):
        tmt.UnetMobilenetV2().load_state(str(tmp_path / "bad.pth"))


# ---- the Schedule --------------------------------------------------------

def _save_bfm(model, model_dir):
    """``model`` as the ``BFM_model_front.mat`` both loaders read."""
    from scipy.io import savemat
    os.makedirs(model_dir, exist_ok=True)
    savemat(os.path.join(model_dir, "BFM_model_front.mat"), {
        "meanshape": model.meanshape, "idBase": model.idBase,
        "exBase": model.exBase, "meantex": model.meantex,
        "texBase": model.texBase, "point_buf": model.point_buf,
        "tri": model.tri, "keypoints": model.keypoints[None] + 1})


@pytest.fixture(scope="module")
def prep(tmp_path_factory):
    """A model dir holding the clip's BFM, and a source tree with one
    clip: T JPEG frames (``raw_{i}.jpg`` and ``{i}.jpg``), its
    coefficients and the 68 landmarks they project to (224 frame)."""
    import jax.numpy as jnp
    from PIL import Image
    from voicepuppet_tpu.face3d import morph as jmorph
    root = tmp_path_factory.mktemp("prep")
    model = jbfm.synthetic_bfm(num_theta=GRID, num_phi=GRID, seed=0)
    _save_bfm(model, str(root / "models"))
    coeff = jbfm.demo_coeff(model, batch=T, seed=3)
    coeff[:, 80:144] += np.random.RandomState(4).randn(T, 64).astype(
        np.float32) * 0.3
    rec = jmorph.reconstruct(jnp.asarray(coeff), jmorph.device_bfm(model))
    lmk = np.asarray(rec.landmarks_2d).reshape(T, -1)
    clip = root / "src" / "spk0" / "clip0"
    clip.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i in range(T):
        img = (rng.rand(SRC_SIZE, SRC_SIZE, 3) * 255).astype(np.uint8)
        for name in (f"raw_{i}.jpg", f"{i}.jpg"):
            Image.fromarray(img).save(str(clip / name))
    np.savetxt(str(clip / "landmark.txt"), lmk, fmt="%.3f", delimiter=",")
    np.savetxt(str(clip / "bfmcoeff.txt"), coeff, fmt="%.6f", delimiter=",")
    jcfg = dataclasses.replace(jax_cfg(), model_dir=str(root / "models"))
    return dict(root=root, jcfg=jcfg, cfg=port_cfg(jcfg), model=model,
                coeff=coeff)


def _copy_src(prep, tmp_path, name):
    src = tmp_path / name / "src"
    shutil.copytree(str(prep["root"] / "src"), str(src))
    return str(src), str(tmp_path / name / "dst")


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _run(prep, tmp_path, step, **kw):
    """Step ``step`` of the JAX Schedule and of the port's (on the CPU)
    over copies of the source tree -> their (count, files) each.  The
    JAX Schedule draws the port's faces (module docstring)."""
    out = {}
    for name, mod, cfg, extra in (("jax", jpd, prep["jcfg"], {}),
                                  ("port", tpd, prep["cfg"],
                                   {"device": "cpu"})):
        src, dst = _copy_src(prep, tmp_path, name)
        sched = mod.Schedule(cfg, **kw, **extra)
        if mod is jpd:
            sched._render_faces = tpd.Schedule(
                prep["cfg"], device="cpu")._render_faces
        n = sched.run(step, src, dst)
        out[name] = (n, _files(src), _files(dst))
    return out


def test_schedule_step1_ear_matches_jax(prep, tmp_path):
    out = _run(prep, tmp_path, 1)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == 1 and any("ear.txt" in k for k in out["jax"][1])


def test_schedule_step2_builds_the_jax_ffmpeg_command(prep, tmp_path,
                                                      monkeypatch):
    """ffmpeg need not be installed: step 2's command is held, not run."""
    videos = tmp_path / "videos" / "spk0"
    videos.mkdir(parents=True)
    for n in ("b.mp4", "a.mpg", "c.txt"):
        (videos / n).write_bytes(b"")
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)
    calls = {"jax": [], "port": []}
    for name, mod, cfg, extra in (("jax", jpd, prep["jcfg"], {}),
                                  ("port", tpd, prep["cfg"],
                                   {"device": "cpu"})):
        monkeypatch.setattr(subprocess, "run",
                            lambda cmd, check=False, c=calls[name]:
                            c.append((cmd, check)))
        dst = str(tmp_path / name)
        n = mod.Schedule(cfg, **extra).run(2, str(tmp_path / "videos"), dst)
        assert n == 2
    strip = lambda cs, name: [([a.replace(str(tmp_path / name), "DST")
                                for a in cmd], check) for cmd, check in cs]
    assert strip(calls["port"], "port") == strip(calls["jax"], "jax")
    assert calls["jax"][0][0][:3] == ["/usr/bin/ffmpeg", "-v", "error"]


def _landmarks(img):
    """A stand-in landmark provider: 68 points from the image's mean and a
    2x-downsampled crop."""
    m = float(np.asarray(img).mean())
    pts = np.linspace(10.0, 100.0, 136, dtype=np.float32) + m
    return pts, np.asarray(img)[::2, ::2]


def _identity(img, lmk):
    """A stand-in identity provider: 257 numbers of the image and its
    landmarks."""
    return (np.arange(257, dtype=np.float32) * float(np.asarray(img).std())
            + float(np.asarray(lmk).sum()) * 1e-3)


def test_schedule_steps_3_4_with_providers_match_jax(prep, tmp_path):
    def drop(src):
        for name in ("landmark.txt", "bfmcoeff.txt"):
            os.remove(os.path.join(src, "spk0", "clip0", name))
    out = {}
    for name, mod, cfg, extra in (("jax", jpd, prep["jcfg"], {}),
                                  ("port", tpd, prep["cfg"],
                                   {"device": "cpu"})):
        src, dst = _copy_src(prep, tmp_path, name)
        drop(src)
        sched = mod.Schedule(cfg, landmark_fn=_landmarks,
                             identity_fn=_identity, **extra)
        out[name] = (sched.run(3, src, dst), sched.run(4, src, dst),
                     _files(src))
    assert out["port"] == out["jax"]
    assert out["jax"][:2] == (1, 1)
    for mod in (jpd, tpd):
        with pytest.raises(RuntimeError, match="provider"):
            mod.Schedule(prep["cfg"] if mod is tpd else prep["jcfg"]).run(
                3, str(tmp_path), str(tmp_path))


def test_render_faces_matches_jax_through_k1(prep, monkeypatch):
    """The port's render goes through ``ops.render_colors_auto`` once per
    16 padded frames and equals JAX's but for float-order edge pixels."""
    from test_torch_infer_drivers import _sliver_bbox_pixels
    from voicepuppet_tpu.ops import raster_selftest as jself
    from voicepuppet_torch import ops
    from voicepuppet_torch.face3d import morph as tmorph
    size = RENDER_SIZE
    want = jpd.Schedule(prep["jcfg"])._render_faces(prep["coeff"], size)
    calls = []
    real = ops.render_colors_auto
    monkeypatch.setattr(ops, "render_colors_auto",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    sched = tpd.Schedule(prep["cfg"], device="cpu")
    got = sched._render_faces(prep["coeff"], size)
    assert calls == [(tpd.CHUNK, prep["model"].num_vertices, 3)]
    assert got.dtype == np.uint8 and (got.sum(-1) > 0).mean() > 0.05
    fm = sched.face_model()
    rec = tmorph.reconstruct(torch.as_tensor(prep["coeff"]), fm)
    verts = torch.cat([rec.face_projection * (size / 224.0),
                       rec.z_buffer], -1).numpy()
    tri = fm.tri.numpy()
    corners = verts[:, tri, :2]
    extent = (np.floor(corners.max(2)) - np.ceil(corners.min(2)) + 1).max()
    assert extent <= max(6, int(round(6 * size / 224))), extent
    colors = rec.face_color.numpy()
    for b in range(T):
        bad = np.argwhere((got[b] != want[b]).any(-1))
        if len(bad):
            near = (jself._borderline_pixels(verts[b], tri, size, size,
                                             eps=1e-4)
                    | _sliver_bbox_pixels(verts[b], tri))
            floors = _colour_floor_pixels(verts[b], colors[b], tri)
            for y, x in bad:
                assert (int(y), int(x)) in near | floors, (b, y, x)
                if (int(y), int(x)) not in near:
                    assert np.abs(got[b, y, x].astype(int)
                                  - want[b, y, x]).max() <= 1


def _colour_floor_pixels(verts, colors, tri, eps=1e-3):
    """Pixels of the bboxes of triangles with a vertex colour within
    ``eps`` of an integer: the flat colour floors each vertex's, and the
    two decodes' float orders may floor it one code apart."""
    near = (np.abs(colors - np.round(colors)) < eps).any(-1)
    out = set()
    for f in np.flatnonzero(near[tri].any(-1)):
        p = verts[tri[f], :2]
        x0, y0 = np.ceil(p.min(0)).astype(int)
        x1, y1 = np.floor(p.max(0)).astype(int)
        out |= {(y, x) for y in range(y0, y1 + 1)
                for x in range(x0, x1 + 1)}
    return out


def test_schedule_step5_panels_match_jax(prep, tmp_path):
    out = _run(prep, tmp_path, 5)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == 1 and len(out["jax"][2]) == T


def _prep_models(tmp_path):
    """The segmentation and matting nets at a seeded random init, saved in
    their released layouts."""
    torch.manual_seed(0)
    seg, dim = str(tmp_path / "seg.pth"), str(tmp_path / "dim.tar")
    torch.save({"state_dict": tmt.UnetMobilenetV2().state_dict()}, seg)
    torch.save({"state_dict": tmt.DIMMatting().state_dict()}, dim)
    return seg, dim


@pytest.mark.parametrize("nets", [False, True])
def test_schedule_step6_panels_match_jax(prep, tmp_path, nets):
    """512x1536-layout panels (here at the config's 256²): the image, the
    rendered face and the alpha — the segmentation and matting nets' when
    their weights are given, else ``face_region_mask``."""
    kw = {}
    if nets:
        kw = dict(zip(("seg_model_path", "matting_model_path"),
                      _prep_models(tmp_path)))
    out = _run(prep, tmp_path, 6, **kw)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == 1 and len(out["jax"][2]) == T


# ---- convert_assets ------------------------------------------------------

def _release(root):
    """An ``allmodels/``-shaped release: the BFM09 raw binaries, the 3-D
    landmarks, BFMNet and PixRefer TensorBundles at test_convert_assets.
    py's tiny widths (seeded numpy on ``jax.eval_shape``), the TF-written
    VGG fixture, the prep nets' checkpoints, and an unparseable
    ``FaceReconModel.pb``."""
    from scipy.io import savemat
    from test_convert_assets import FIX, _rows_to_arrays, _tiny_cfg
    from voicepuppet_tpu.models import pixrefer as jpx
    from voicepuppet_tpu.models.bfmnet import BFMNet
    from voicepuppet_tpu.tools import tf_bundle as jtb
    from voicepuppet_tpu.tools import tf_checkpoint as jtfc
    from _torch_port_cases import numpy_tree
    cfg = _tiny_cfg()
    os.makedirs(root)
    _bfm09(root)
    rng = np.random.RandomState(0)
    savemat(os.path.join(root, "similarity_Lm3D_all.mat"),
            {"lm": rng.rand(68, 3) * 2 - 1})
    t = 4
    z = lambda *s: np.zeros(s, np.float32)
    bv = numpy_tree(BFMNet(cfg.bfmnet), z(1, t, 1), z(1, t * 5, 80),
                    np.full((1,), t, np.int32), train=False, seed=1)
    arrays = _rows_to_arrays(jtfc.bfmnet_name_map()
                             + jtfc._shortcut_rows(bv), bv)
    arrays["global_step"] = np.asarray(65000, np.int64)
    jtb.write_bundle(arrays, os.path.join(root, "ckpt_bfmnet",
                                          "bfmnet-65000"))
    s = cfg.pixrefer.img_size
    gv = numpy_tree(jpx.PixReferNet(cfg.pixrefer), z(1, s, s, 6),
                    z(1, s, s, 6), z(1, s, s, 3), seed=2)
    dv = numpy_tree(jpx.Discriminator(cfg.pixrefer.ndf), z(1, s, s, 3),
                    z(1, s, s, 3), seed=3)
    jtb.write_bundle(
        {**_rows_to_arrays(jtfc.pixrefer_generator_name_map(), gv),
         **_rows_to_arrays(jtfc.pixrefer_discriminator_name_map(), dv)},
        os.path.join(root, "ckpt_pixrefer", "pixrefernet-20000"))
    os.makedirs(os.path.join(root, "vgg"))
    shutil.copyfile(os.path.join(FIX, "vgg_slim", "vgg_16.ckpt"),
                    os.path.join(root, "vgg", "vgg_16.ckpt"))
    torch.manual_seed(0)
    torch.save({"state_dict": tmt.UnetMobilenetV2().state_dict()},
               os.path.join(root, "mobilenetV2_model_checkpoint_metric.pth"))
    torch.save({"model": torch.nn.DataParallel(tmt.DIMMatting())},
               os.path.join(root, "BEST_checkpoint.tar"))
    open(os.path.join(root, "FaceReconModel.pb"), "wb").write(
        b"\x01\x02not a graphdef")
    return cfg


def _same_outputs(a, b):
    from scipy.io import loadmat
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".npz"):
            x, y = np.load(pa), np.load(pb)
            assert sorted(x.files) == sorted(y.files), n
            for k in x.files:
                np.testing.assert_array_equal(y[k], x[k], err_msg=(n, k))
        elif n.endswith(".mat"):
            x, y = loadmat(pa), loadmat(pb)
            for k in x:
                if not k.startswith("__"):
                    np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        elif n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pb), np.load(pa))
        else:
            assert open(pb, "rb").read() == open(pa, "rb").read(), n


def test_convert_all_matches_jax(tmp_path):
    """The same files and the same manifest as the JAX sweep; every
    converted checkpoint loads strictly into the port's modules."""
    assets = str(tmp_path / "allmodels")
    cfg = _release(assets)
    want = jca.convert_all(assets, str(tmp_path / "jax"), cfg=cfg)
    got = tca.convert_all(assets, str(tmp_path / "port"), cfg=port_cfg(cfg))
    assert got == want
    assert {k: v["status"] for k, v in got.items()} == {
        "bfm": "converted", "lm3d": "converted", "bfmnet_ckpt": "converted",
        "pixrefer_ckpt": "converted", "vgg16_ckpt": "converted",
        "rnet_pb": "failed", "seg_checkpoint": "validated",
        "matting_checkpoint": "validated"}
    _same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
    from voicepuppet_torch.models.bfmnet import BFMNet
    from voicepuppet_torch.tools import tf_checkpoint as tfc
    pcfg = port_cfg(cfg)
    _, _, missing = tfc.load_bfmnet_npz(str(tmp_path / "port" /
                                             tca.BFMNET_NPZ),
                                        BFMNet(pcfg.bfmnet))
    assert not missing


@pytest.mark.parametrize("broken", [False, True])
def test_convert_assets_main_matches_jax(tmp_path, broken):
    """The CLI over an empty release (every asset missing, exit 0) and
    over a broken one (failed, exit 1): the same exit code and
    manifest.json."""
    assets = tmp_path / "allmodels"
    assets.mkdir()
    if broken:
        (assets / "FaceReconModel.pb").write_bytes(b"\x01\x02nope")
    rcs, manifests = [], []
    for name, mod in (("jax", jca), ("port", tca)):
        out = tmp_path / name
        rcs.append(mod.main(["--assets_dir", str(assets),
                             "--out_dir", str(out)]))
        manifests.append(json.loads((out / "manifest.json").read_text()))
    assert rcs[0] == rcs[1] == int(broken)
    assert manifests[0] == manifests[1]


def test_device_bfm_of_a_loaded_mat_has_contiguous_triangles(prep):
    """``load_bfm`` returns loadmat's Fortran-ordered arrays; the raster
    kernels refuse non-contiguous triangles, so ``device_bfm`` stores
    them in C order (the prep path on the card failed on this)."""
    from voicepuppet_torch.face3d import bfm as tbfm
    from voicepuppet_torch.face3d import morph as tmorph
    model = tbfm.load_bfm(prep["cfg"].model_dir)
    assert not model.tri.flags["C_CONTIGUOUS"]
    fm = tmorph.device_bfm(model, "cpu")
    assert fm.tri.is_contiguous() and fm.tri.dtype == torch.int32
    np.testing.assert_array_equal(fm.tri.numpy(),
                                  np.asarray(prep["model"].tri) - 1)


def test_steps_3_4_from_the_ports_detector_and_rnet(prep, tmp_path):
    """``landmark_fn_from`` (a ``pipeline.detect`` provider) and
    ``identity_fn_from`` (an ``RNetIdentityProvider`` at a seeded random
    init) drive steps 3 and 4: landmark.txt holds the provider's points
    and bfmcoeff.txt the R-Net's coefficients of each aligned frame."""
    from voicepuppet_torch.data.loaders import load_image, load_text_array
    from voicepuppet_torch.pipeline import rnet as trnet
    from voicepuppet_torch.pipeline.align import (align_for_identity,
                                                  landmarks68_to_5)
    from voicepuppet_torch.pipeline.detect import CenteredFaceProvider
    src, dst = _copy_src(prep, tmp_path, "adapters")
    clip = os.path.join(src, "spk0", "clip0")
    for name in ("landmark.txt", "bfmcoeff.txt"):
        os.remove(os.path.join(clip, name))
    net = trnet.init_rnet_(trnet.RNet(), torch.Generator().manual_seed(0))
    lm3d = np.random.RandomState(2).randn(5, 3) * 0.3
    rnet = trnet.RNetIdentityProvider(net.state_dict(), lm3d, device="cpu")
    faces = CenteredFaceProvider()
    sched = tpd.Schedule(prep["cfg"], device="cpu",
                         landmark_fn=tpd.landmark_fn_from(faces),
                         identity_fn=tpd.identity_fn_from(rnet))
    assert sched.run(3, src, dst) == 1 and sched.run(4, src, dst) == 1
    lmks = load_text_array(os.path.join(clip, "landmark.txt"))
    coeffs = load_text_array(os.path.join(clip, "bfmcoeff.txt"))
    assert lmks.shape == (T, 136) and coeffs.shape == (T, 257)
    img = load_image(os.path.join(clip, "0.jpg"))
    np.testing.assert_allclose(lmks[0], faces(img).reshape(-1), atol=1e-3)
    aligned, _ = align_for_identity(img, landmarks68_to_5(lmks[0]), lm3d)
    np.testing.assert_allclose(coeffs[0], rnet.coefficients(aligned)[0],
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="no face"):
        tpd.landmark_fn_from(lambda img: None)(img)
