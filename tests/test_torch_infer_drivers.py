"""The BFMNet mesh-video entry point of the port
(voicepuppet_torch/pipeline/infer_drivers.py) against the JAX package's
(voicepuppet_tpu/pipeline/infer_drivers.py), on the CPU.

The JAX raster off the TPU fills only a ``bb x bb`` window of each
triangle's bbox (``bb = max(6, ceil(7 * size / 224))``, 6 at 96²), while
the port walks whole bboxes (ROADMAP Queue 3), so the mesh here is sized
for its largest triangle bbox to fit that window: synthetic_bfm(40, 40)
at a 96² canvas, largest bbox 6 x 5 px over the clip (asserted).  The
frames then agree except where the float order decides (ROADMAP Queue 3:
the unfused float32 order of the kernels' source is normative): pixels
within 1e-4 of an edge in float64, and pixels in the bbox of a sliver
whose Gram determinant the normative order rounds to 0, which the spec's
degenerate rule lets cover its whole bbox, while XLA's CPU FMA keeps it
nonzero.  Measured: 3 pixels of 110,592, all in the bbox of one sliver
of frame 4 (float64 determinant 8.2e-7).
"""

import numpy as np
import torch

import jax.numpy as jnp

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.ops import raster_selftest as jself
from voicepuppet_tpu.pipeline import infer_drivers as jdrv

from voicepuppet_torch.face3d import morph as tmorph
from voicepuppet_torch.pipeline import infer_drivers as tdrv

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

SIZE = 96
T = 12


def _clip():
    model = jbfm.synthetic_bfm(num_theta=40, num_phi=40, seed=1)
    coeff = jbfm.demo_coeff(model, batch=T, seed=2)
    coeff[:, 80:144] += np.random.RandomState(0).randn(T, 64).astype(
        np.float32) * 0.3
    return model, coeff


def _screen_vertices(model, coeff, size):
    """The mesh video's screen-space vertices per frame, from the port."""
    fm = tmorph.device_bfm(model, "cpu")
    ang = torch.zeros((coeff.shape[0], 3))
    ang[:, 1] = torch.as_tensor(tdrv.sweep_yaw(coeff.shape[0]))
    shape = tmorph.reconstruct_rotation(torch.as_tensor(coeff), fm,
                                        ang).face_shape
    scale = size / 224.0
    xy = (112.0 - shape[..., :2] * 112.0) * scale
    return torch.cat([xy, shape[..., 2:3] * scale], -1).numpy(), \
        fm.tri.numpy()


def _sliver_bbox_pixels(verts, tri, bound=1e-5):
    """Pixels of the bboxes of triangles the port's float32 order calls
    degenerate (``inv_deno == 0``) whose float64 Gram determinant is below
    ``bound``: near-degenerate slivers whose class hangs on rounding."""
    from voicepuppet_torch.face3d import raster as traster
    deg = traster.degenerate(torch.as_tensor(verts[None]),
                             torch.as_tensor(tri))[0].numpy()
    out = set()
    for f in np.flatnonzero(deg):
        p = verts[tri[f], :2].astype(np.float64)
        e1, e2 = p[1] - p[0], p[2] - p[0]
        if abs((e1 @ e1) * (e2 @ e2) - (e1 @ e2) ** 2) >= bound:
            continue
        x0, y0 = np.ceil(p.min(0)).astype(int)
        x1, y1 = np.floor(p.max(0)).astype(int)
        out |= {(y, x) for y in range(y0, y1 + 1)
                for x in range(x0, x1 + 1)}
    return out


def test_sweep_yaw_and_blink_match_jax():
    np.testing.assert_array_equal(tdrv._blink_ears(11), jdrv._blink_ears(11))
    yaw = np.zeros((60,), np.float32)
    a, s = 0.0, 0.04
    for i in range(60):          # the loop of jdrv.render_coeff_video_frames
        a += s
        if a > 0.8 or a < -0.8:
            s = -s
        yaw[i] = a
    np.testing.assert_array_equal(tdrv.sweep_yaw(60), yaw)


def test_mesh_video_frames_match_jax():
    model, coeff = _clip()
    want = jdrv.render_coeff_video_frames(coeff, model, img_size=SIZE)
    got = tdrv.render_coeff_video_frames(coeff, model, img_size=SIZE,
                                         device="cpu")
    assert got.shape == want.shape == (T, SIZE, SIZE, 3)
    assert got.dtype == np.uint8 and (got.sum(-1) > 0).mean() > 0.3
    verts, tri = _screen_vertices(model, coeff, SIZE)
    corners = verts[:, tri, :2]
    extent = (np.floor(corners.max(2)) - np.ceil(corners.min(2)) + 1).max(
        axis=(0, 1))
    bb = max(6, int(np.ceil(7 * SIZE / 224)))
    assert (extent <= bb).all(), (extent, bb)
    for b in range(T):
        bad = np.argwhere((got[b] != want[b]).any(-1))
        assert len(bad) <= jself.MAX_BORDERLINE, (b, bad)
        if len(bad):
            near = (jself._borderline_pixels(verts[b], tri, SIZE, SIZE,
                                             eps=1e-4)
                    | _sliver_bbox_pixels(verts[b], tri))
            assert all((int(y), int(x)) in near for y, x in bad), (b, bad)
    # a DeviceBFM with the corner cache renders the same frames
    np.testing.assert_array_equal(
        tdrv.render_coeff_video_frames(
            coeff, tmorph.device_bfm(model, "cpu", corner_cache=True),
            img_size=SIZE), got)


def test_infer_bfmnet_end_to_end(tmp_path):
    """audio -> BFMNet (blink ears, the clip's own length) -> mesh frames
    (160² here, 672² by default) -> the video, the PNG fallback when
    ffmpeg is absent.  The
    coefficients are held against the JAX BFMNet on the same weights
    (bridged back with weights.flax_leaf), within the 5e-5 band of
    tests/test_torch_synthesize.py."""
    from voicepuppet_tpu.audio.frontend import MelFrontend as JMel
    from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
    from voicepuppet_torch import weights
    from voicepuppet_torch.pipeline import synthesize as tsyn
    from voicepuppet_torch.tools import tf_checkpoint as tfc

    cfg = port_cfg()
    model = jbfm.synthetic_bfm(num_theta=24, num_phi=24, seed=1)
    synth, ident = tsyn.SynthesisAssets.demo(cfg, seed=3, face_model=model,
                                             gan_dtype=torch.float32,
                                             device="cpu")
    n = 5000
    pcm = (0.3 * np.sin(2 * np.pi * 200 * np.arange(n) / 16000)
           + 0.05 * np.random.RandomState(1).randn(n)).astype(np.float32)
    frames = tdrv.infer_bfmnet(cfg, synth, ident, pcm, out_dir=str(tmp_path),
                               img_size=160)
    t = int(1 + n / cfg.frame_wav_scale)
    assert frames.shape == (t, 160, 160, 3) and frames.dtype == np.uint8
    assert frames.std(axis=0).max() > 0
    import shutil
    if shutil.which("ffmpeg") is None:
        assert len(list((tmp_path / "bfmnet_frames").glob("*.png"))) == t
    else:
        assert (tmp_path / "bfmnet.mp4").exists()

    got = tdrv.predict_blink_expressions(cfg, synth, pcm).numpy()
    state = synth.bfmnet.state_dict()
    tree = {"params": {}, "batch_stats": {}}
    for _tf, coll, path, _tr in tfc.bfmnet_rows(state):
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = weights.flax_leaf(
            path, state[weights.state_key_for(path)].numpy())
    jcfg = jax_cfg()
    pcm_len = jcfg.pcm_length_for_frames(t)
    pcm_p = np.pad(pcm, (0, max(0, pcm_len - n)))[None, :pcm_len]
    mel = JMel(jcfg.mel)(jnp.asarray(pcm_p))
    want = np.asarray(JBFMNet(jcfg.bfmnet).apply(
        tree, jnp.asarray(jdrv._blink_ears(t)), mel,
        jnp.asarray([t], jnp.int32), train=False, mask_time=True))
    assert got.shape == want.shape == (1, t, 64)
    np.testing.assert_allclose(got, want, atol=5e-5)


# ---- PixFlow and ATVGNet drivers ----------------------------------------------

def _panels(tmp_path, rng, n, s):
    from PIL import Image
    paths = []
    for i in range(n):
        img = (rng.rand(s, 3 * s, 3) * 255).astype(np.uint8)
        img[:, 2 * s:] = 0
        img[s // 8:-s // 8, 2 * s + s // 4:3 * s - s // 4] = 255
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


def _pixflow_pair(jcfg, seed=4):
    """The JAX trainer's ``infer`` on a params tree, and the port's
    trainer with the same parameters."""
    import types
    from voicepuppet_tpu.models import pixflow as jpf
    from voicepuppet_tpu.train.pixflow_trainer import PixFlowTrainer as JPF
    from voicepuppet_torch import weights
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    from _torch_port_cases import numpy_tree
    s = jcfg.pixflow.img_size
    x6 = np.zeros((1, s, s, 6), np.float32)
    g = numpy_tree(jpf.PixFlowNet(jcfg.pixflow), x6, x6, train=False,
                   seed=seed)["params"]
    jt = types.SimpleNamespace(gen_eval=jpf.PixFlowNet(jcfg.pixflow),
                               _infer_step=None)
    jt.infer = types.MethodType(JPF.infer, jt)
    tr = PixFlowTrainer(port_cfg(jcfg), device="cpu")
    state = tr.init_state()
    weights.load_flax_(state.gen, g)
    return (jt, types.SimpleNamespace(g_params=g)), (tr, state)


def test_infer_pixflow_matches_jax(tmp_path):
    """``infer_pixflow`` on a 3-frame panel folder (64², ngf 8), the same
    G parameters on both sides: frames within 1e-4 (float32 sums in other
    orders through 13 batch-moment BNs; measured 2.7e-5 on 2% of values,
    the rest within 1e-5)."""
    jcfg = jax_cfg()
    s = jcfg.pixflow.img_size
    paths = _panels(tmp_path, np.random.RandomState(5), 3, s)
    (jt, jstate), (tr, state) = _pixflow_pair(jcfg)
    want = jdrv.infer_pixflow(jcfg, jt, jstate, paths, str(tmp_path / "j"))
    got = tdrv.infer_pixflow(port_cfg(jcfg), tr, state, paths,
                             str(tmp_path / "t"))
    assert got.shape == want.shape == (3, s, s, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "0.jpg", "1.jpg", "2.jpg"]


def test_infer_bfm_pixflow_matches_jax(tmp_path):
    """audio -> coefficients -> faces rendered at PixFlow's size with no
    yaw (K1's plain version here, ``ceil(T/8)`` chunks) -> PixFlowNet per
    frame.  Both drivers get the port synthesizer's expressions (BFMNet's
    parity is held in test_infer_bfmnet_end_to_end and
    tests/test_torch_synthesize.py), so this holds the splice, the render
    and the generator loop: the rendered faces equal the JAX raster's (the
    64² canvas keeps every triangle inside the JAX CPU raster's 6 px
    window, asserted), the frames within 1e-4 (as infer_pixflow's)."""
    import types
    import jax.numpy as jnp
    from voicepuppet_torch.pipeline import synthesize as tsyn
    jcfg = jax_cfg()
    cfg = port_cfg(jcfg)
    s = cfg.pixflow.img_size
    model = jbfm.synthetic_bfm(num_theta=24, num_phi=24, seed=1)
    synth, ident = tsyn.SynthesisAssets.demo(cfg, seed=3, face_model=model,
                                             gan_dtype=torch.float32,
                                             device="cpu")
    n = 9000
    pcm = (0.3 * np.sin(2 * np.pi * 200 * np.arange(n) / 16000)
           + 0.05 * np.random.RandomState(2).randn(n)).astype(np.float32)
    exp = synth.predict_expressions(pcm)
    jsynth = types.SimpleNamespace(
        predict_expressions=lambda _pcm: jnp.asarray(exp.numpy()),
        face_model=model)
    panel = np.random.RandomState(6).rand(s, 3 * s, 3).astype(np.float32)
    (jt, jstate), (tr, state) = _pixflow_pair(jcfg, seed=7)
    want = jdrv.infer_bfm_pixflow(jcfg, jsynth, jt, jstate, ident, panel,
                                  pcm, str(tmp_path / "j"))
    got = tdrv.infer_bfm_pixflow(cfg, synth, tr, state, ident, panel, pcm,
                                 str(tmp_path / "t"))
    t = exp.shape[1]
    assert got.shape == want.shape == (t, s, s, 3) and t > 8
    coeff = tsyn.splice_coeff_sequence(ident.bfmcoeff, exp).numpy()
    verts, tri = _screen_vertices(model, coeff, s)
    corners = verts[:, tri, :2]
    extent = (np.floor(corners.max(2)) - np.ceil(corners.min(2)) + 1).max()
    assert extent <= max(6, int(np.ceil(7 * s / 224)))
    np.testing.assert_array_equal(
        tdrv.render_coeff_video_frames(coeff, model, s, yaw_shift=0.0,
                                       device="cpu"),
        jdrv.render_coeff_video_frames(coeff, model, img_size=s,
                                       yaw_shift=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(list((tmp_path / "t").iterdir())) == t


def test_infer_atvgnet_matches_jax(tmp_path):
    """audio -> the log-mel -> ATNet landmarks -> the VGNet generator in
    inference mode -> uint8 frames and the video (a PNG sequence without
    ffmpeg).  ATNet 64-wide at width-mult 0.25, VGNet at 32²; the same
    parameters on both sides.  Each side computes the mel on its own
    frontend (float32, ~1e-5 apart), so the frames agree within one code
    (float -> uint8 truncation) on under 1% of values (measured: 1 code
    on 0.014%)."""
    import types
    from voicepuppet_tpu.models import atnet as jat
    from voicepuppet_tpu.models import vgnet as jvg
    from voicepuppet_tpu.train.atnet_trainer import ATNetTrainer as JAT
    from voicepuppet_torch import weights
    from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
    from voicepuppet_torch.train.vgnet_trainer import VGNetTrainer
    from _torch_port_cases import numpy_tree
    jcfg = jax_cfg()
    cfg = port_cfg(jcfg)
    s, width = cfg.vgnet.img_size, 0.25
    comp = jat.synthetic_pca_component(6)
    rng = np.random.RandomState(8)
    t0 = 6
    a_tree = numpy_tree(jat.ATNet(jcfg.atnet, comp, width_mult=width),
                        np.zeros((1, t0, 1)), np.zeros((1, t0, 3)),
                        np.zeros((1, t0 * 5, 80)), np.zeros((1, 136)),
                        np.full((1,), t0, np.int32), train=False, seed=9)
    g_tree = numpy_tree(jvg.VGNetGenerator(jcfg.vgnet),
                        np.zeros((1, s, s, 3)), np.zeros((1, t0, 136)),
                        np.zeros((1, 136)), np.full((1,), t0, np.int32),
                        train=False, seed=10)
    jat_tr = types.SimpleNamespace(eval_model=jat.ATNet(
        jcfg.atnet, comp, width_mult=width))
    jat_tr.infer = types.MethodType(JAT.infer, jat_tr)
    jvg_tr = types.SimpleNamespace(gen_eval=jvg.VGNetGenerator(jcfg.vgnet))
    img = rng.rand(s, s, 3).astype(np.float32)
    lmk = rng.rand(136).astype(np.float32) * s * 0.6 + s * 0.2
    mean = np.zeros((136,), np.float32)
    n = 4000
    pcm = (0.3 * np.sin(2 * np.pi * 180 * np.arange(n) / 16000)).astype(
        np.float32)
    want = jdrv.infer_atvgnet(
        jcfg, jat_tr, types.SimpleNamespace(
            params=a_tree["params"], batch_stats=a_tree["batch_stats"]),
        jvg_tr, types.SimpleNamespace(
            g_params=g_tree["params"],
            batch_stats={"g": g_tree["batch_stats"]}),
        img, lmk, pcm, mean, comp.T, out_dir=str(tmp_path / "j"))
    at = ATNetTrainer(cfg, comp, width_mult=width, device="cpu")
    a_state = at.init_state()
    weights.load_flax_(a_state.model, a_tree)
    vt = VGNetTrainer(cfg, device="cpu")
    v_state = vt.init_state()
    weights.load_flax_(v_state.gen, g_tree)
    got = tdrv.infer_atvgnet(cfg, at, a_state, vt, v_state, img, lmk, pcm,
                             mean, comp.T, out_dir=str(tmp_path / "t"))
    t = int(1 + n / cfg.frame_wav_scale)
    assert got.shape == want.shape == (t, s, s, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (
        diff.max(), (diff > 0).mean())
    assert got.std(axis=0).max() > 0
    import shutil
    if shutil.which("ffmpeg") is None:
        assert len(list((tmp_path / "t" / "atvg_frames").glob("*.png"))) == t
    else:
        assert (tmp_path / "t" / "atvg.mp4").exists()
