"""Module-by-module parity of the PyTorch port (voicepuppet_torch) against
the JAX reference (voicepuppet_tpu), both on the CPU, fed the same numpy
inputs and the same parameters (JAX inits bridged by
voicepuppet_torch/weights.py).

Tolerances: both sides are float32, but they sum in different orders
(XLA's CPU dots and convolutions vs torch's), and XLA's CPU backend
contracts ``a*b + c*d`` into an FMA where torch rounds twice.  Each test
states the band it allows and why; integer outputs (YUV bytes, the
geometry helpers) must be equal.
"""

import ast
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicepuppet_tpu.audio.frontend import MelFrontend as JMel
from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import morph as jmorph
from voicepuppet_tpu.models import layers as jlayers
from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
from voicepuppet_tpu.pipeline import align as jalign
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import config as tconfig
from voicepuppet_torch import weights
from voicepuppet_torch.audio.frontend import MelFrontend as TMel
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.face3d import morph as tmorph
from voicepuppet_torch.models import layers as tlayers
from voicepuppet_torch.models import pixrefer as tpx
from voicepuppet_torch.models.bfmnet import BFMNet as TBFMNet
from voicepuppet_torch.pipeline import align as talign
from voicepuppet_torch.pipeline import drain_native
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import jax_cfg, jax_trees, port_cfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# ---- package boundary --------------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, "voicepuppet_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax, flax, optax, orbax
    or the JAX package, at any depth of any function."""
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "voicepuppet_tpu")
    sources = list(_port_sources())
    assert len(sources) > 15 and all(os.path.exists(p) for p in sources)
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(
                      node.func, "id", "")) in ("import_module",
                                                "__import__")):
                names = [a.value for a in node.args
                         if isinstance(a, ast.Constant)]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def _generator_name_tests(tree):
    """Line numbers of the comparisons of a generator's name (``generator``,
    ``cfg.generator``, ``synth.generator``, ...) with a string, or with a
    tuple, list or set of strings, in ``tree``."""
    def named(x):
        return getattr(x, "attr", getattr(x, "id", None)) == "generator"

    def literal(x):
        if isinstance(x, (ast.Tuple, ast.List, ast.Set)):
            return any(literal(e) for e in x.elts)
        return isinstance(x, ast.Constant) and isinstance(x.value, str)
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Compare)
            and any(named(x) for x in [node.left, *node.comparators])
            and any(literal(x) for x in [node.left, *node.comparators])]


@pytest.mark.parametrize("snippet", [
    'if cfg.generator == "pixflow": pass',
    'if synth.generator != "pixrefer": pass',
    'pixflow = generator == "pixflow"',
    'ok = self.cfg.generator in ("pixrefer", "pixflow")'])
def test_the_generator_seam_check_sees_a_name_branch(snippet):
    assert _generator_name_tests(ast.parse(snippet)) == [1]


def test_pipeline_compares_no_generator_name():
    """No module under ``voicepuppet_torch/pipeline/`` branches on the
    served generator's name: its decisions live in its frame program,
    which ``Synthesizer`` picks once from ``synthesize.FRAME_PROGRAMS``
    (a table, not a comparison)."""
    pipeline = os.path.join(REPO, "voicepuppet_torch", "pipeline")
    found = []
    for f in sorted(os.listdir(pipeline)):
        if f.endswith(".py"):
            with open(os.path.join(pipeline, f)) as fh:
                tree = ast.parse(fh.read(), f)
            found += [(f, n) for n in _generator_name_tests(tree)]
    assert not found, found
    assert set(tsyn.FRAME_PROGRAMS) == {"pixrefer", "pixflow"}
    assert tconfig.Config().generator in tsyn.FRAME_PROGRAMS


def test_config_copy_matches_reference():
    from voicepuppet_tpu.config import Config as JConfig
    j, t = JConfig(), tconfig.Config()
    assert dataclasses.asdict(j.mel) == dataclasses.asdict(t.mel)
    assert dataclasses.asdict(j.bfmnet) == dataclasses.asdict(t.bfmnet)
    for f in dataclasses.fields(t.pixrefer):
        want = getattr(j.pixrefer, f.name)
        got = getattr(t.pixrefer, f.name)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name
    assert dataclasses.asdict(j.dataset) == dataclasses.asdict(t.dataset)
    assert dataclasses.asdict(j.training) == dataclasses.asdict(t.training)
    for n in (1, 16, 55):
        assert j.pcm_length_for_frames(n) == t.pcm_length_for_frames(n)
    assert (j.frame_wav_scale, j.frame_mfcc_scale) == (t.frame_wav_scale,
                                                       t.frame_mfcc_scale)


def test_load_config_yaml(tmp_path):
    p = tmp_path / "p.yml"
    p.write_text("default:\n  frame_rate: 25\n  mel:\n    hop_step: 160\n"
                 "  pixrefer:\n    ngf: 8\n  training: {epochs: 3}\n")
    cfg = tconfig.load_config(str(p))
    assert cfg.mel.hop_step == 160 and cfg.pixrefer.ngf == 8
    assert tconfig.load_config(None) == tconfig.Config()


@pytest.mark.parametrize("name", ["pixflow", "atnet", "vgnet", "mesh"])
def test_new_config_copies_match_reference(name):
    from voicepuppet_tpu.config import Config as JConfig
    assert (dataclasses.asdict(getattr(tconfig.Config(), name))
            == dataclasses.asdict(getattr(JConfig(), name)))


def test_yaml_flattening_covers_the_five_models(tmp_path):
    """The reference schema's shared ``training`` block reaches each of
    the five models except the fields that model pins (PixFlow: lr,
    beta1, decay_rate, max_to_keep; ATNet: lr, decay_steps, decay_rate;
    VGNet: lr), a per-model block wins, and every model section loads as
    the JAX loader loads it."""
    from voicepuppet_tpu.config import load_config as jload
    p = tmp_path / "params.yml"
    p.write_text("""
default:
  training: {epochs: 9, learning_rate: 0.5, beta1: 0.3, decay_rate: 0.5,
             decay_steps: 77, max_to_keep: 4, drop_rate: 0.2}
  pixflow: {ngf: 16, training: {save_interval: 6}}
  atnet: {rnn_hidden_size: 32}
  vgnet: {img_size: 64, training: {decay_steps: 5}}
  mesh: {data_parallel: 2}
""")
    j, t = jload(str(p)), tconfig.load_config(str(p))
    for name in tconfig._MODEL_KEYS + ("training", "mesh"):
        got = dataclasses.asdict(getattr(t, name))
        want = dataclasses.asdict(getattr(j, name))
        # the port's PixRefer has no ``separable_conv`` (no model reads it)
        assert got == {k: want[k] for k in got}, name
    assert tconfig._MODEL_KEYS == ("bfmnet", "pixrefer", "pixflow", "atnet",
                                   "vgnet")
    pf, at, vg = t.pixflow.training, t.atnet.training, t.vgnet.training
    assert (pf.learning_rate, pf.beta1, pf.decay_rate, pf.max_to_keep) == (
        3e-4, 0.5, 0.999, 2)
    assert (pf.epochs, pf.decay_steps, pf.save_interval) == (9, 77, 6)
    assert (at.learning_rate, at.decay_steps, at.decay_rate) == (
        1e-4, 10000, 1.0)
    assert (at.beta1, at.max_to_keep, at.drop_rate) == (0.3, 4, 0.2)
    assert (vg.learning_rate, vg.decay_rate, vg.decay_steps) == (
        1e-4, 0.5, 5)
    assert t.pixflow.ngf == 16 and t.vgnet.img_size == 64
    assert t.mesh.data_parallel == 2


def _public_names(path):
    import ast
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", [
    "config.py", "data/generators.py", "pipeline/infer_drivers.py",
    "utils/viz.py", "models/pixflow.py", "models/atnet.py",
    "models/vgnet.py", "models/backbone.py", "train/pixflow_trainer.py",
    "train/atnet_trainer.py", "train/vgnet_trainer.py"])
def test_port_module_defines_every_public_name_of_jax(module):
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = _public_names(os.path.join(root, "voicepuppet_tpu", module))
    got = _public_names(os.path.join(root, "voicepuppet_torch", module))
    assert want - got == set(), sorted(want - got)


def test_bfm_copy_matches_reference():
    a = jbfm.synthetic_bfm(num_theta=9, num_phi=7, seed=3)
    b = tbfm.synthetic_bfm(num_theta=9, num_phi=7, seed=3)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    np.testing.assert_array_equal(jbfm.demo_coeff(a, 3, seed=2),
                                  tbfm.demo_coeff(b, 3, seed=2))


# ---- parameter bridge and layer semantics -----------------------------------

def test_weights_bridge_loads_jax_trees_strictly():
    bfm, g = jax_trees()
    cfg = port_cfg()
    net = weights.load_flax_(TBFMNet(cfg.bfmnet), bfm)
    gen = weights.load_flax_(tpx.PixReferNet(cfg.pixrefer), g)
    p = bfm["params"]["mfcc_encoder"]["MfccNet_0"]
    dw = p["InvertedResidual_1"]["Conv_1"]["kernel"]            # [7,3,1,C]
    np.testing.assert_array_equal(
        net.mfcc_encoder.MfccNet_0.InvertedResidual_1.Conv_1.weight.detach()
        .numpy(),
        np.transpose(dw, (3, 2, 0, 1)))
    stats = bfm["batch_stats"]["mfcc_encoder"]["MfccNet_0"]["ConvBN_0"]
    np.testing.assert_array_equal(
        net.mfcc_encoder.MfccNet_0.ConvBN_0.TFBatchNorm_0.running_var
        .numpy(),
        stats["TFBatchNorm_0"]["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(
        net.rnn_in.weight.detach().numpy(),
        bfm["params"]["rnn_in"]["kernel"].T)
    k = g["generator"]["decoder_1"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(
        gen.generator.decoder_1.ConvTranspose_0.weight.detach().numpy(),
        np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
    with pytest.raises(RuntimeError):
        weights.load_flax_(TBFMNet(dataclasses.replace(
            cfg.bfmnet, rnn_layers=2)), bfm)


def test_same_padding_is_asymmetric_for_odd_totals():
    # stride-2 over 80 bins with a 5-wide kernel: total 3 -> (1, 2)
    assert tlayers.same_pads(80, 5, 2) == (1, 2)
    assert tlayers.same_pads(75, 9, 1) == (4, 4)
    assert tlayers.same_pads(5, 2, 2) == (0, 1)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 15, 80, 3).astype(np.float32)
    conv = fnn.Conv(4, (9, 5), strides=(1, 2), padding="SAME",
                    use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(params, x))
    tconv = tlayers.SameConv2d(3, 4, (9, 5), (1, 2))
    tconv.load_state_dict(weights.state_dict_from_flax(params))
    got = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # fp32 sums of 135 products in different orders: ~1e-6 relative
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_max_pool_same_matches_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 13, 5, 4).astype(np.float32)
    for window, stride in (((2, 2), (1, 2)), ((5, 3), (5, 3))):
        want = np.asarray(jlayers.max_pool_same(jnp.asarray(x), window,
                                                stride))
        got = tlayers.max_pool_same(_t(x).permute(0, 3, 1, 2), window,
                                    stride).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)   # max is exact


def test_conv_transpose_same_padding_pinned():
    """flax ConvTranspose(4x4, stride 2, 'SAME') == torch ConvTranspose2d
    (padding=1) on the flipped kernel: lax.conv_transpose pads the dilated
    input by (2, 2) = k-1-p for p = 1; output exactly 2x."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    deconv = fnn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME")
    params = deconv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(deconv.apply(params, x))
    assert want.shape == (2, 10, 14, 6)
    tdec = tpx.GenDeconv(3, 6)
    tdec.load_state_dict(weights.state_dict_from_flax(
        {"ConvTranspose_0": params["params"]}))
    got = tdec(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # fp32, 48-term sums in different orders
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # padding 0 or 2 would shift or shrink the map: the pin is meaningful
    tdec.ConvTranspose_0.padding = (0, 0)
    assert tdec(_t(x).permute(0, 3, 1, 2)).shape[-2:] != (10, 14)


# ---- modules of the serving path --------------------------------------------

def test_mel_frontend_matches_jax():
    cfg = jax_cfg()
    pcm = (np.random.RandomState(11).randn(1, 16000) * 0.1).astype(
        np.float32)
    want = np.asarray(JMel(cfg.mel)(jnp.asarray(pcm)))
    got = TMel(port_cfg().mel, device="cpu")(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape == (1, 122, 80)
    # log-mel of bins with real energy (the _model_cases mask): fp32 DFT
    # matmuls summed in different orders differ by ~1e-6 absolute in the
    # magnitudes, ~1e-5 in the log
    sel = want > -6.0
    assert sel.mean() > 0.9
    np.testing.assert_allclose(got[sel], want[sel], atol=5e-5)


def test_bfmnet_coeffs_match_jax_with_mask_time():
    """A bucket-padded clip (13 frames in a 16 bucket, mask_time) through
    both BFMNets on the same weights."""
    bfm, _ = jax_trees()
    jcfg = jax_cfg()
    t, tb = 13, 16
    rng = np.random.RandomState(7)
    mfcc = rng.randn(1, tb * 5, 80).astype(np.float32)
    ear = np.zeros((1, tb, 1), np.float32)
    ear[:, :t] = rng.rand(1, t, 1) / 100.0
    seq = np.array([t], np.int32)
    want = np.asarray(JBFMNet(jcfg.bfmnet).apply(
        bfm, jnp.asarray(ear), jnp.asarray(mfcc), jnp.asarray(seq),
        train=False, mask_time=True))
    net = weights.load_flax_(TBFMNet(port_cfg().bfmnet), bfm).eval()
    with torch.no_grad():
        got = net(_t(ear), _t(mfcc), torch.from_numpy(seq),
                  mask_time=True).numpy()
        exact = net(_t(ear[:, :t]), _t(mfcc[:, :t * 5]),
                    torch.from_numpy(seq)).numpy()
    assert got.shape == want.shape == (1, tb, 64)
    # 18 conv stages + GRU in fp32, different sum orders: measured max
    # |diff| ~1e-6 on O(0.1) coefficients
    np.testing.assert_allclose(got[:, :t], want[:, :t], atol=2e-5)
    # mask_time makes the padded run equal the exact-length run
    np.testing.assert_allclose(got[:, :t], exact, atol=2e-6)
    assert np.all(got[:, t:, :16] == got[:, t:, :16])   # finite tail


def test_reconstruct_rotation_matches_jax():
    model = jbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    coeff = jbfm.demo_coeff(model, batch=4, seed=5)
    angles = (np.random.RandomState(3).randn(4, 3) * 0.05).astype(
        np.float32)
    want = jmorph.reconstruct_rotation(jnp.asarray(coeff),
                                       jmorph.device_bfm(model),
                                       jnp.asarray(angles), 224.0)
    got = tmorph.reconstruct_rotation(
        _t(coeff), tmorph.device_bfm(model, "cpu"), _t(angles), 224.0)
    # fp32 PCA matmuls (80/64-term sums) + normalisation; positions are
    # O(100) px and colors O(200), so 1e-4 / 2e-3 absolute is ~1e-6
    # relative
    for name, atol in (("face_shape", 1e-5), ("face_projection", 1e-4),
                       ("z_buffer", 1e-5), ("face_color", 2e-3),
                       ("landmarks_2d", 1e-4), ("face_texture", 2e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=atol, err_msg=name)


def test_reconstruct_matches_jax():
    """The decode with the coefficients' own pose (the raster probes'
    meshes) on synthetic_bfm(12, 12), within the bands of
    test_reconstruct_rotation_matches_jax."""
    model = jbfm.synthetic_bfm(num_theta=12, num_phi=12, seed=2)
    coeff = jbfm.demo_coeff(model, batch=3, seed=4)
    want = jmorph.reconstruct(jnp.asarray(coeff), jmorph.device_bfm(model),
                              224.0)
    got = tmorph.reconstruct(_t(coeff), tmorph.device_bfm(model, "cpu"),
                             224.0)
    for name, atol in (("face_shape", 1e-5), ("face_projection", 1e-4),
                       ("z_buffer", 1e-5), ("face_color", 2e-3),
                       ("landmarks_2d", 1e-4), ("face_texture", 2e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=atol, err_msg=name)
    # the shape itself stays unrotated: only reconstruct_rotation turns it
    np.testing.assert_allclose(
        got.face_shape.numpy(),
        tmorph.shape_formation(_t(coeff[:, :80]), _t(coeff[:, 80:144]),
                               tmorph.device_bfm(model, "cpu")).numpy())


def test_generator_and_composite_match_jax():
    _, g = jax_trees()
    jcfg = jax_cfg()
    s = jcfg.pixrefer.img_size
    rng = np.random.RandomState(7)
    x = (rng.rand(2, s, s, 6) * 2 - 1).astype(np.float32)
    xfg = (rng.rand(2, s, s, 6) * 2 - 1).astype(np.float32)
    bg = (rng.rand(2, s, s, 3) * 2 - 1).astype(np.float32)
    want = jpx.PixReferNet(jcfg.pixrefer).apply({"params": g}, x, xfg, bg)
    net = weights.load_flax_(tpx.PixReferNet(port_cfg().pixrefer), g)
    with torch.no_grad():
        got = net(_t(x), _t(xfg), _t(bg))
    # 16 conv levels with per-batch BN renormalising every level: fp32
    # sum-order noise grows to ~1e-5 at the tanh output (measured)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, s, s, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_pack_yuv420_bytes_equal_jax():
    rng = np.random.RandomState(5)
    frames = rng.rand(3, 64, 64, 3).astype(np.float32) * 1.2 - 0.1
    want = np.asarray(jax.jit(jsyn._pack_yuv420)(jnp.asarray(frames)))
    got = tsyn._pack_yuv420(_t(frames)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 64 * 64 * 3 // 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsyn._unpack_yuv420(got, 64),
                                  jsyn._unpack_yuv420(want, 64))
    # the drain's served unpack
    np.testing.assert_array_equal(drain_native.unpack_yuv420(got, 64),
                                  jsyn._unpack_yuv420(want, 64))


@pytest.mark.parametrize("out_hw", [150, 224, 301])
def test_resize_matches_jax_image_resize(out_hw):
    """jax.image.resize 'linear' antialiases when downscaling; torch's
    bilinear with antialias=True matches it on both sides of ratio 1."""
    img = np.random.RandomState(out_hw).rand(2, 224, 224, 3).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img),
                                       (2, out_hw, out_hw, 3), "linear"))
    got = tsyn.resize_linear(_t(img), out_hw).numpy()
    # triangle-filter weights computed and normalised in fp32 by each
    # side in its own order: measured max |diff| 7e-6 on [0, 1] pixels
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sequence_helpers_match_jax():
    np.testing.assert_array_equal(talign.head_sway_angles(100),
                                  jalign.head_sway_angles(100))
    a, st = talign.head_sway_angles(7, state=(np.zeros(3), 0.005))
    b, sj = jalign.head_sway_angles(7, state=(np.zeros(3), 0.005))
    np.testing.assert_array_equal(a, b)
    assert st[1] == sj[1]
    idc = np.arange(257, dtype=np.float32)[None]
    exp = np.random.RandomState(0).rand(1, 5, 64).astype(np.float32)
    np.testing.assert_array_equal(
        tsyn.splice_coeff_sequence(idc, _t(exp)).numpy(),
        np.asarray(jsyn.splice_coeff_sequence(idc, exp)))
    for args in ((100, 10, 10, 0, 0, 256), (224, 256, 256, -3, 5, 512),
                 (260, 300, 20, 4, -7, 512)):
        assert tsyn._paste_geometry(*args) == jsyn._paste_geometry(*args)
    for t in (1, 15, 16, 17, 100):
        assert tsyn.Synthesizer._bucket(t) == jsyn.Synthesizer._bucket(t)


@pytest.mark.parametrize("chunk", [16, 32])
def test_tail_bucket_rule(chunk):
    """Last-chunk sizes equal the JAX render_frames loop (floor 8,
    powers of two, capped at the chunk)."""
    for n in range(1, chunk):
        cc = 8
        while cc < n:
            cc *= 2
        assert tsyn.tail_bucket(n, chunk) == min(cc, chunk)
    assert tsyn.tail_bucket(23, 32) == 32 and tsyn.tail_bucket(5, 16) == 8


# ---- the corner cache ---------------------------------------------------------

def _corner_case():
    model = jbfm.synthetic_bfm(num_theta=14, num_phi=14, seed=3)
    coeff = jbfm.demo_coeff(model, batch=3, seed=6)
    coeff[:, 80:144] += np.random.RandomState(8).randn(3, 64).astype(
        np.float32) * 0.5
    angles = (np.random.RandomState(9).randn(3, 3) * 0.1).astype(np.float32)
    return model, coeff, angles


def test_corner_cache_layout_matches_jax():
    model, _, _ = _corner_case()
    want = jmorph.device_bfm(model, corner_cache=True)
    got = tmorph.device_bfm(model, "cpu", corner_cache=True)
    for name in ("corner_id_base", "corner_ex_base", "corner_mean"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert tmorph.device_bfm(model, "cpu").corner_id_base is None


def test_compute_norm_from_coeff_matches_jax_and_gather():
    """The corner-cache normals against the JAX corner-cache normals and
    against the port's gather path: the same function, float32 round-off
    apart (unit vectors; measured max |diff| ~1e-7)."""
    model, coeff, _ = _corner_case()
    fm = tmorph.device_bfm(model, "cpu", corner_cache=True)
    jfm = jmorph.device_bfm(model, corner_cache=True)
    id_c, ex_c = coeff[:, :80], coeff[:, 80:144]
    got = tmorph.compute_norm_from_coeff(_t(id_c), _t(ex_c), fm).numpy()
    want = np.asarray(jmorph.compute_norm_from_coeff(
        jnp.asarray(id_c), jnp.asarray(ex_c), jfm))
    gather = tmorph.compute_norm(
        tmorph.shape_formation(_t(id_c), _t(ex_c), fm), fm).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5)


@pytest.mark.parametrize("which", ["reconstruct", "reconstruct_rotation"])
def test_cached_decode_matches_jax_and_gather(which):
    """reconstruct / reconstruct_rotation dispatch to the corner cache when
    the DeviceBFM holds one: every output within 1e-5 of the port's gather
    path (normals enter only the colours, O(100)) and within the bands of
    test_reconstruct_rotation_matches_jax of the JAX cached decode."""
    model, coeff, angles = _corner_case()
    fm = tmorph.device_bfm(model, "cpu", corner_cache=True)
    plain_fm = tmorph.device_bfm(model, "cpu")
    jfm = jmorph.device_bfm(model, corner_cache=True)
    if which == "reconstruct":
        got = tmorph.reconstruct(_t(coeff), fm)
        gather = tmorph.reconstruct(_t(coeff), plain_fm)
        want = jmorph.reconstruct(jnp.asarray(coeff), jfm)
    else:
        got = tmorph.reconstruct_rotation(_t(coeff), fm, _t(angles))
        gather = tmorph.reconstruct_rotation(_t(coeff), plain_fm,
                                             _t(angles))
        want = jmorph.reconstruct_rotation(jnp.asarray(coeff), jfm,
                                           jnp.asarray(angles))
    for name, atol in (("face_shape", 1e-5), ("face_projection", 1e-4),
                       ("z_buffer", 1e-5), ("face_color", 2e-3),
                       ("landmarks_2d", 1e-4), ("face_texture", 2e-3)):
        a = getattr(got, name).numpy()
        np.testing.assert_allclose(a, np.asarray(getattr(want, name)),
                                   atol=atol, err_msg=name)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, getattr(gather, name).numpy(),
                                   atol=1e-5 * scale, err_msg=name)


# ---- the identity path's host math ------------------------------------------

def _face_image(seed=0, h=300, w=260):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 0.7 + yy * 0.2) % 255, (yy * 0.9) % 255,
                    (xx * yy * 0.01) % 255], -1) + rng.rand(h, w, 3) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def test_alignment_math_matches_jax():
    from voicepuppet_tpu.pipeline import detect as jdetect
    rng = np.random.RandomState(1)
    xp, x = rng.randn(2, 5) * 50 + 100, rng.randn(3, 5)
    (tt, ts), (jt, js) = talign.pos_similarity(xp, x), \
        jalign.pos_similarity(xp, x)
    np.testing.assert_array_equal(tt, jt)
    assert ts == js
    lmk68 = jdetect.CenteredFaceProvider()(np.zeros((300, 260, 3)))
    np.testing.assert_array_equal(talign.landmarks68_to_5(lmk68.reshape(-1)),
                                  jalign.landmarks68_to_5(lmk68.reshape(-1)))
    lm68_3d = rng.randn(68, 3)
    np.testing.assert_array_equal(talign.standard_lm3d(lm68_3d),
                                  jalign.standard_lm3d(lm68_3d))
    lm3d = jalign.standard_lm3d(lm68_3d * 0.4)
    lmk5 = jalign.landmarks68_to_5(lmk68.reshape(-1))
    for img in (_face_image(), _face_image(1).astype(np.float32) / 255.0):
        got = talign.align_for_identity(img, lmk5, lm3d)
        want = jalign.align_for_identity(img, lmk5, lm3d)
        assert got[0].shape == (1, 224, 224, 3) and got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_sat_alignment_and_providers_match_jax(tmp_path):
    from voicepuppet_tpu.pipeline import detect as jdetect
    from voicepuppet_torch.pipeline import detect as tdetect
    img = _face_image(2)
    np.testing.assert_array_equal(tdetect.CenteredFaceProvider()(img),
                                  jdetect.CenteredFaceProvider()(img))
    for provider in ("centered", "shifted"):
        fn = (tdetect.CenteredFaceProvider() if provider == "centered" else
              tdetect.CallableLandmarkProvider(
                  lambda im: jdetect.CenteredFaceProvider()(im) + 31.5))
        jfn = (jdetect.CenteredFaceProvider() if provider == "centered" else
               jdetect.CallableLandmarkProvider(
                   lambda im: jdetect.CenteredFaceProvider()(im) + 31.5))
        got = tdetect.sat_alignment(img, fn)
        want = jdetect.sat_alignment(img, jfn)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rows = np.random.RandomState(3).rand(2, 136).astype(np.float32) * 200
    np.savetxt(tmp_path / "landmark.txt", rows, delimiter=",", fmt="%.4f")
    tp = tdetect.FileLandmarkProvider.from_file(str(tmp_path /
                                                    "landmark.txt"))
    jp = jdetect.FileLandmarkProvider.from_file(str(tmp_path /
                                                    "landmark.txt"))
    for _ in range(2):
        np.testing.assert_array_equal(tp(img), jp(img))
    assert tp(img) is None and jp(img) is None
    assert tdetect.sat_alignment(img, tp) is None


@pytest.mark.parametrize("out", ["coords", "heatmaps"])
def test_torchscript_landmarks_match_jax(out, tmp_path):
    """A scripted detector (coordinates, or 68 heatmaps at 64² that both
    sides resize to 128² before the argmax) on the port's device, here the
    CPU, against the JAX package's provider on the same file."""
    from voicepuppet_tpu.pipeline import detect as jdetect
    from voicepuppet_torch.pipeline import detect as tdetect

    class Coords(torch.nn.Module):
        def forward(self, x):
            s = x.mean(dim=(1, 2, 3))
            grid = torch.arange(136, dtype=torch.float32).reshape(1, 68, 2)
            return grid * 2.0 + s[:, None, None]

    class Heatmaps(torch.nn.Module):
        def forward(self, x):
            g = torch.arange(64 * 64, dtype=torch.float32).reshape(1, 1, 64,
                                                                   64)
            k = torch.arange(68, dtype=torch.float32).reshape(1, 68, 1, 1)
            return torch.sin(g * 0.01 * (k + 1)) + x.mean()

    path = str(tmp_path / "m.pt")
    torch.jit.script(Coords() if out == "coords" else Heatmaps()).save(path)
    img = _face_image(4, 200, 180)
    got = tdetect.TorchScriptLandmarkProvider(path, device="cpu")(img)
    want = jdetect.TorchScriptLandmarkProvider(path)(img)
    assert got.shape == (68, 2)
    np.testing.assert_array_equal(got, want)


def test_loaders_and_lm3d_match_jax(tmp_path):
    from scipy.io import savemat
    from voicepuppet_tpu.data import loaders as jload
    from voicepuppet_tpu.tools import bfm_tools as jtools
    from voicepuppet_torch.data import loaders as tload
    from voicepuppet_torch.tools import bfm_tools as ttools
    rows = np.random.RandomState(5).rand(3, 136) * 128
    np.savetxt(tmp_path / "t.txt", rows, delimiter=",", fmt="%.5f")
    for fn in ("load_text_array", "load_landmarks"):
        np.testing.assert_array_equal(
            getattr(tload, fn)(str(tmp_path / "t.txt")),
            getattr(jload, fn)(str(tmp_path / "t.txt")))
    np.save(tmp_path / "b.npy", rows)
    np.testing.assert_array_equal(tload.load_bin_array(str(tmp_path /
                                                           "b.npy")), rows)
    with pytest.raises(ValueError):
        tload.load_bin_array(str(tmp_path / "t.txt"))
    img = np.random.RandomState(6).rand(10, 12, 3).astype(np.float32)
    tload.save_image(str(tmp_path / "t.png"), img)
    jload.save_image(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(tload.load_image(str(tmp_path / "t.png")),
                                  jload.load_image(str(tmp_path / "j.png")))
    lm = np.random.RandomState(7).randn(68, 3)
    savemat(str(tmp_path / "similarity_Lm3D_all.mat"), {"lm": lm})
    np.testing.assert_array_equal(ttools.resolve_lm3d(str(tmp_path)),
                                  jtools.resolve_lm3d(str(tmp_path)))
    np.save(tmp_path / "lm3d.npy", lm[:5])
    np.testing.assert_array_equal(ttools.resolve_lm3d(str(tmp_path)),
                                  lm[:5])
    np.save(tmp_path / "lm3d.npy", lm[:4])
    with pytest.raises(ValueError):
        ttools.resolve_lm3d(str(tmp_path))
