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
    """Neither the port nor chip_smoke.py imports jax, flax or the JAX
    package, at any depth of any function."""
    banned = ("jax", "jaxlib", "flax", "voicepuppet_tpu")
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


def test_config_copy_matches_reference():
    from voicepuppet_tpu.config import Config as JConfig
    j, t = JConfig(), tconfig.Config()
    assert dataclasses.asdict(j.mel) == dataclasses.asdict(t.mel)
    for f in dataclasses.fields(t.bfmnet):
        assert getattr(j.bfmnet, f.name) == getattr(t.bfmnet, f.name)
    assert (j.pixrefer.ngf, j.pixrefer.img_size) == (t.pixrefer.ngf,
                                                     t.pixrefer.img_size)
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
