"""The port's streaming path (voicepuppet_torch/pipeline/streaming.py)
against the JAX StreamingCoeffPredictor / StreamingSynthesizer on the same
pcm feeds, seed and parameters, both on the CPU, and the GRU carry that
makes it exact.

Bands: coefficients within the BFMNet band of the batch tests (5e-5: mel
and conv stages sum in other orders, ~1e-5 measured); frames within the
frame bands of tests/test_torch_synthesize.py (mean 0.01 uint8, a 1e-3
share off by more than one code).  The JAX side renders with
``raster_bb=24``: its CPU raster fills only a bb x bb window per triangle
(ROADMAP Queue 3), while the port's grouped raster never crops.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.pipeline import streaming as jstream
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import weights
from voicepuppet_torch.pipeline import streaming as tstream
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

S = 256
CHUNK = 16
COEFF_BAND = 5e-5
MEAN_BAND = 0.01
OVER_ONE_BAND = 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_cfg()
    model = jbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    jsynth, ident = jsyn.SynthesisAssets.demo(
        jcfg, face_model=model, chunk=CHUNK, raster_bb=24, raster_group=4,
        gan_dtype=jnp.float32)
    tsynth = tsyn.Synthesizer(
        port_cfg(jcfg), model,
        weights.state_dict_from_flax(jsynth.bfm_vars),
        weights.state_dict_from_flax(jsynth.g_params), chunk=CHUNK,
        raster_group=4, gan_dtype=torch.float32, device="cpu")
    return jsynth, tsynth, ident, tsyn.Identity(**ident.__dict__)


def _pcm(frames, seed=3):
    n = frames * 640
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _stream(obj, pcm, step):
    blocks = []
    for i in range(0, pcm.shape[0], step):
        blocks.extend(obj.feed(pcm[i:i + step]))
    return blocks + obj.flush()


def test_chunked_decode_with_carried_state_is_exact(pair):
    """The port's decode run in chunks of 8 with the carried GRU state
    equals its whole-sequence decode bit for bit, and forward is still
    encode + decode."""
    _, tsynth, _, _ = pair
    net = tsynth.bfmnet
    rng = np.random.RandomState(0)
    t = 32
    enc = torch.from_numpy(rng.randn(1, t, 64).astype(np.float32))
    ears = torch.from_numpy(rng.rand(1, t, 1).astype(np.float32) / 100)
    with torch.inference_mode():
        whole = net.decode(enc, ears, torch.tensor([t]))
        state, outs = None, []
        for s in range(0, t, 8):
            out, state = net.decode(enc[:, s:s + 8], ears[:, s:s + 8],
                                    torch.tensor([8]), rnn_state=state,
                                    return_rnn_state=True)
            outs.append(out)
        assert torch.equal(torch.cat(outs, 1), whole)
        mel = torch.from_numpy(rng.randn(1, 40, 80).astype(np.float32))
        seq = torch.tensor([8])
        assert torch.equal(net(ears[:, :8], mel, seq),
                           net.decode(net.encode(mel), ears[:, :8], seq))


def test_decode_state_matches_jax_past_seq_len(pair):
    """With seq_len < T the carried state freezes at t = seq_len-1
    (dynamic_rnn), and an empty row keeps its initial state: port and JAX
    decode agree on outputs and finals."""
    jsynth, tsynth, _, _ = pair
    rng = np.random.RandomState(1)
    enc = rng.randn(2, 8, 64).astype(np.float32)
    ears = rng.rand(2, 8, 1).astype(np.float32) / 100
    h0 = rng.randn(1, 2, 64).astype(np.float32) * 0.5
    seq = np.array([5, 0], np.int32)

    def dec(m, x, e, sl, st):
        return m.decode(x, e, sl, train=False, rnn_state=st,
                        return_rnn_state=True)

    want, want_state = jsynth.bfmnet.apply(
        jsynth.bfm_vars, jnp.asarray(enc), jnp.asarray(ears),
        jnp.asarray(seq), [jnp.asarray(h0[0])], method=dec)
    with torch.inference_mode():
        got, got_state = tsynth.bfmnet.decode(
            torch.from_numpy(enc), torch.from_numpy(ears),
            torch.from_numpy(seq.astype(np.int64)),
            rnn_state=[torch.from_numpy(h0[0])], return_rnn_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=COEFF_BAND)
    np.testing.assert_allclose(got_state[0].numpy(),
                               np.asarray(want_state[0]), atol=COEFF_BAND)
    np.testing.assert_array_equal(got_state[0][1].numpy(), h0[0][1])


def test_streaming_coeffs_match_jax(pair):
    """Same feeds, same ear-noise seed: every block of the port's
    StreamingCoeffPredictor matches JAX's, the partial last one too."""
    jsynth, tsynth, _, _ = pair
    pcm = _pcm(53)
    want = _stream(jstream.StreamingCoeffPredictor(jsynth, chunk=CHUNK),
                   pcm, 2000)
    got = _stream(tstream.StreamingCoeffPredictor(tsynth, chunk=CHUNK),
                  pcm, 2000)
    assert [b.shape[0] for b in got] == [b.shape[0] for b in want] \
        == [16, 16, 16, 5]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=COEFF_BAND)


def test_streaming_coeffs_match_batch_on_interior_frames(pair):
    """Against the port's own whole-clip predict_expressions (the same
    ear noise: both draw it frame by frame from RandomState(0)): interior
    frames agree within the JAX streaming test's band (2e-2,
    tests/test_streaming.py); the first chunk carries the start-of-stream
    approximation."""
    _, tsynth, _, _ = pair
    frames = 64
    pcm = _pcm(frames)
    batch = tsynth.predict_expressions(pcm[:(frames - 1) * 640 + 1])[0]
    got = torch.cat(_stream(tstream.StreamingCoeffPredictor(
        tsynth, chunk=CHUNK), pcm, 2000))
    assert got.shape == (frames, 64) and batch.shape == (frames, 64)
    err = float((got[32:48] - batch[32:48]).abs().max())
    assert err < 2e-2, err


def test_streaming_buffer_is_trimmed_and_feed_after_flush_raises(pair):
    _, tsynth, _, _ = pair
    sp = tstream.StreamingCoeffPredictor(tsynth, chunk=CHUNK)
    for _ in range(6):
        sp.feed(_pcm(16))
    max_samples = (sp.ctx_left + sp.chunk + sp.ctx_right + 2) * 640
    assert 0 < sp._buffer.shape[0] <= max_samples
    assert sp._buffer_start > 0 and sp.frames_buffered == 96 - 80
    sp.flush()
    with pytest.raises(RuntimeError):
        sp.feed(_pcm(4))


def test_streaming_synthesizer_matches_jax(pair):
    """pcm -> frame blocks through the grouped raster (K4's plain version)
    against JAX's StreamingSynthesizer on the same feeds: a full block,
    then a 5-frame tail padded to the chunk, over a two-image background
    pool that must cycle per frame across blocks."""
    jsynth, tsynth, jident, tident = pair
    frames = 21
    pcm = _pcm(frames)
    rng = np.random.RandomState(0)
    ref = rng.rand(S, S, 3).astype(np.float32)
    fg = rng.rand(S, S, 3).astype(np.float32)
    pool = np.stack([np.zeros((S, S, 3), np.float32),
                     np.ones((S, S, 3), np.float32)])
    want = _stream(jstream.StreamingSynthesizer(jsynth, jident, ref, fg,
                                                background=pool), pcm, 4000)
    got = _stream(tstream.StreamingSynthesizer(tsynth, tident, ref, fg,
                                               background=pool), pcm, 4000)
    assert [b.shape for b in got] == [b.shape for b in want] \
        == [(16, S, S, 3), (5, S, S, 3)]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert diff.mean() < MEAN_BAND, diff.mean()
        assert (diff > 1).mean() < OVER_ONE_BAND, (diff > 1).mean()
    frames_out = np.concatenate(got).astype(np.int32)
    assert frames_out.std(axis=0).max() > 0
    # even frames ride background 0, odd frames background 1, across the
    # block boundary too
    for a, b in ((14, 15), (15, 16), (16, 17)):
        adjacent = np.abs(frames_out[a] - frames_out[b]).mean()
        same_bg = np.abs(frames_out[a] - frames_out[a + 2]).mean()
        assert adjacent > 10 * max(same_bg, 1e-3), (a, adjacent, same_bg)
