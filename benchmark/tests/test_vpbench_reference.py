"""The plain reference against the system at small sizes on the CPU: each
part on the same inputs and weights, then whole cells at test size, whose
compared numbers a sound run keeps near zero."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import face, nets
from benchmark.run import run_cell
from benchmark.traffic import scene

BFM = dict(thinresnet_output_channels=256, encode_embedding_size=256,
           rnn_hidden_size=256, rnn_layers=1, bfm_coeff_size=64,
           backbone_width_mult=0.25)
MEL = dict(sample_rate=16000, num_mel_bins=80, win_length=512,
           fft_length=512, hop_step=128, lower_edge_hertz=80.0,
           upper_edge_hertz=7600.0, log_offset=1e-6)


def test_mel_matches_the_system():
    from voicepuppet_torch.audio.frontend import MelFrontend
    from voicepuppet_torch.config import MelConfig
    pcm = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.3, 0.3, (2, 6000)).astype(np.float32))
    want = MelFrontend(MelConfig(**MEL), "cpu")(pcm)
    torch.testing.assert_close(face.Mel(MEL, "cpu")(pcm), want, rtol=0,
                               atol=0)


def test_bfmnet_matches_the_system():
    from voicepuppet_torch.config import BFMNetConfig
    from voicepuppet_torch.models.bfmnet import BFMNet
    state = weights.seeded_state(lambda: nets.BFMNet(BFM), "glorot", 3, 1,
                                 "cpu")
    ref = nets.BFMNet(BFM)
    ref.load_state_dict(state)
    sys_net = BFMNet(BFMNetConfig(backbone_width_mult=0.25))
    sys_net.load_state_dict(state)
    g = torch.Generator().manual_seed(0)
    mel = torch.randn(1, 80, 80, generator=g)
    ears = torch.rand(1, 16, 1, generator=g) / 100
    seq = torch.tensor([13])
    with torch.no_grad():
        torch.testing.assert_close(
            ref(ears, mel, seq, mask_time=True),
            sys_net.eval()(ears, mel, seq, mask_time=True), rtol=0, atol=0)


def test_decode_and_raster_match_the_system():
    from voicepuppet_torch.face3d import morph
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.face3d.bfm import BFMModel
    arrays = scene.face_model_arrays(32, 4)
    coeff = torch.from_numpy(np.repeat(scene.identity(4, 256)["bfmcoeff"],
                                       3, 0))
    coeff[:, 80:144] = torch.randn(3, 64, generator=torch.Generator()
                                   .manual_seed(2)) * 0.5
    angles = torch.from_numpy(face.head_sway(3)[0])
    fm_sys = morph.device_bfm(BFMModel(**arrays), "cpu")
    rec = morph.reconstruct_rotation(coeff, fm_sys, angles, 224.0)
    verts = torch.cat([rec.face_projection, rec.z_buffer], -1)
    colors = torch.floor(torch.clamp(rec.face_color, 0, 255))
    want, _ = plain.render_colors(verts, colors, fm_sys.tri, 224, 224)
    fm = face.face_model_on(arrays, "cpu")
    v, c = face.decode(coeff, fm, angles, 224.0)
    torch.testing.assert_close(v, verts, rtol=0, atol=0)
    got = face.flat_colors(face.rasterize_winner(v, fm.tri, 224, 224), c,
                           fm.tri)
    assert torch.equal(got, want)
    assert (got > 0).any()


def test_generator_and_yuv_match_the_system():
    from voicepuppet_torch.config import PixReferConfig
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.pipeline import synthesize as syn
    state = weights.seeded_state(lambda: nets.PixReferNet(8), "pix2pix", 5,
                                 2, "cpu")
    ref = nets.PixReferNet(8)
    ref.load_state_dict(state)
    sys_g = px.PixReferNet(PixReferConfig(ngf=8, img_size=256))
    sys_g.load_state_dict(state)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 256, 256, 6, generator=g) * 2 - 1
    fg = torch.rand(2, 256, 256, 6, generator=g) * 2 - 1
    bg = torch.rand(2, 256, 256, 3, generator=g) * 2 - 1
    with torch.no_grad():
        got, want = ref(x, fg, bg)[0], sys_g(x, fg, bg)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    frames = nets.deprocess(got)
    packed = face.pack_yuv420(frames)
    assert torch.equal(packed, syn.pack_frames(frames, "yuv420"))
    assert np.array_equal(face.unpack_yuv420(packed.numpy(), 256),
                          syn._unpack_yuv420(packed.numpy(), 256))


def test_fp8_control_rounds_the_generator():
    x = torch.linspace(-1, 1, 1000)
    w = torch.linspace(-0.05, 0.05, 64)
    qx, qw = nets.fp8_operands(x, w)
    assert 0 < float((qx - x).abs().max()) < 0.07
    assert 0 < float((qw - w).abs().max()) < 0.004


def _run(tiny, name, seconds=1.0):
    return run_cell(harness.Run(tiny(name), 2 ** 31 + 21, seconds, False,
                                "cpu", time.perf_counter()))


@pytest.mark.parametrize("name", ["serve-batch-clips", "serve-stream-live",
                                  "train-pixrefer512-b2"])
def test_sound_run_at_test_size_is_correct(tiny, name):
    out = _run(tiny, name, 3.5 if "stream" in name else 1.0)
    assert out.failed == 0 and out.attempted > 0
    assert harness.judged(out.checks), out.checks
    if name.startswith("train"):
        # the system's batches, worked out again from the files, exactly
        assert out.readings["batch_gap"] == 0.0
