"""The port's serving path end to end against the JAX Synthesizer, both on
the CPU with the same weights (JAX demo inits bridged by
voicepuppet_torch/weights.py): coefficient program and chunked frame
program, with a tail chunk that the tail bucket pads to 8.

Frames are uint8 after the YUV 4:2:0 round trip.  Both sides are float32
(the generator in fp32 here — the card serves it in bf16), but XLA's CPU
backend sums in other orders and fuses multiply-adds, so generator outputs
differ by ~1e-5 and a uint8 code can flip by one where a value sits on a
rounding edge; decoded vertices differ by ~1e-5 px, which may move a
borderline raster pixel.  The bands below are measured and stated with
each assertion.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import weights
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

S = 256
CHUNK = 16
T = 21          # one full chunk + a 5-frame tail, bucketed to 8
MEAN_BAND = 0.01        # mean |uint8 diff| per chunk
OVER_ONE_BAND = 1e-3    # share of values that differ by more than 1 code


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_cfg()
    model = jbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    # The JAX CPU raster fills only a bb x bb window of each triangle's
    # bbox; this coarse mesh has triangles up to ~20 px across at 224², so
    # bb=24 lets the reference fill them whole, as the port's raster does.
    jsynth, ident = jsyn.SynthesisAssets.demo(jcfg, face_model=model,
                                              chunk=CHUNK, raster_bb=24,
                                              gan_dtype=jnp.float32)
    tsynth = tsyn.Synthesizer(
        port_cfg(jcfg), model,
        weights.state_dict_from_flax(jsynth.bfm_vars),
        weights.state_dict_from_flax(jsynth.g_params), chunk=CHUNK,
        gan_dtype=torch.float32, device="cpu")
    tident = tsyn.Identity(**ident.__dict__)
    return jsynth, tsynth, ident, tident


def _inputs():
    rng = np.random.RandomState(0)
    coeff = jbfm.demo_coeff(jbfm.synthetic_bfm(num_theta=16, num_phi=16,
                                               seed=1), batch=1, seed=3)
    coeff = np.repeat(coeff, T, 0)
    coeff[:, 80:144] += rng.randn(T, 64).astype(np.float32) * 0.3
    face3d_ref = rng.rand(S, S, 3).astype(np.float32)
    fg_ref = rng.rand(S, S, 3).astype(np.float32)
    bgs = rng.rand(2, S, S, 3).astype(np.float32)
    return coeff, face3d_ref, fg_ref, bgs


def test_render_frames_matches_jax_with_tail_chunk(pair):
    jsynth, tsynth, ident, tident = pair
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    want = jsynth.render_frames(coeff, ident, face3d_ref, fg_ref, bgs)
    got = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    assert got.shape == want.shape == (T, S, S, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # fp32 sum-order / FMA noise: one-code flips, plus the rare raster
    # pixel whose winner flips on a ~4-ulp vertex difference (one pixel in
    # 16 frames here), which the U-Net spreads as 2-3 code changes around
    # it.  Measured: mean 1.6e-3, share > 1 code 2.0e-4, max 3.  The tail
    # frames are held as tightly as the full chunk; a wrong tail bucket
    # (16 instead of 8 padded frames in the batch-stat BN) moves them by
    # mean 0.52 with 8.5% of values > 1 code (test below).
    for sl in (slice(0, CHUNK), slice(CHUNK, T)):
        assert diff[sl].mean() < MEAN_BAND, diff[sl].mean()
        assert (diff[sl] > 1).mean() < OVER_ONE_BAND, (diff[sl] > 1).mean()
    assert got.std(axis=0).max() > 0


def test_render_frames_tail_bucket_matters(pair):
    """Rendering the tail in a full 16-frame batch changes the tail frames
    beyond the parity band above: the band does detect a wrong bucket."""
    _, tsynth, _, tident = pair
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    got = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    padded = np.concatenate([coeff, np.zeros((2 * CHUNK - T, 257),
                                              np.float32)])
    full = tsynth.render_frames(padded, tident, face3d_ref, fg_ref, bgs)
    np.testing.assert_array_equal(full[:CHUNK], got[:CHUNK])
    tail = np.abs(full[CHUNK:T].astype(np.int16)
                  - got[CHUNK:].astype(np.int16))
    assert tail.mean() > MEAN_BAND and (tail > 1).mean() > OVER_ONE_BAND


def test_predict_expressions_matches_jax(pair):
    jsynth, tsynth, _, _ = pair
    pcm = (0.3 * np.sin(2 * np.pi * 220 * np.arange(14000) / 16000)
           + 0.05 * np.random.RandomState(1).randn(14000)).astype(np.float32)
    want = np.asarray(jsynth.predict_expressions(pcm))
    got = tsynth.predict_expressions(pcm).numpy()
    t = int(1 + 14000 / 640)
    assert got.shape == want.shape == (1, t, 64)
    # mel (fp32 DFT) + 18 conv stages + GRU, different sum orders: the
    # measured max |diff| is ~1e-5 on O(0.1) coefficients
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_synthesize_contract_on_cpu(pair):
    _, tsynth, _, tident = pair
    rng = np.random.RandomState(0)
    panel = rng.rand(S, 3 * S, 3).astype(np.float32)
    pcm = (0.3 * np.sin(2 * np.pi * 440 * np.arange(6000) / 16000)
           ).astype(np.float32)
    frames = tsynth.synthesize(panel, pcm, tident)
    assert frames.shape == (int(1 + 6000 / 640), S, S, 3)
    assert frames.dtype == np.uint8 and frames.std(axis=0).max() > 0


def test_cpu_only_paths_refuse_what_is_not_ported():
    cfg = port_cfg()
    model = jbfm.synthetic_bfm(num_theta=6, num_phi=6)
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg)
    with pytest.raises(NotImplementedError):
        tsyn.Synthesizer(cfg, model, bfm_state, g_state, mesh=object(),
                         device="cpu")


def test_raster_group_renders_the_same_frames(pair):
    """``raster_group=4`` (the grouped raster K4, here its plain version)
    renders exactly the frames of the flat raster, tail chunk included."""
    _, tsynth, _, tident = pair
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    flat = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    tsynth.raster_group = 4
    try:
        grouped = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref,
                                       bgs)
    finally:
        tsynth.raster_group = 0
    np.testing.assert_array_equal(grouped, flat)


@pytest.mark.parametrize("fmt", ["rgb8", "yuv444"])
def test_only_the_yuv420_drain_is_ported(fmt):
    """The reference's default drain, YUV 4:2:0, is the only one served;
    any other transfer format raises instead of taking an untested path."""
    cfg = port_cfg()
    model = jbfm.synthetic_bfm(num_theta=6, num_phi=6)
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg)
    with pytest.raises(NotImplementedError, match="yuv420"):
        tsyn.Synthesizer(cfg, model, bfm_state, g_state, device="cpu",
                         transfer_format=fmt)
