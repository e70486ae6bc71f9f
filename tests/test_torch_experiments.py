"""The serving experiment entry points of the port
(voicepuppet_torch/experiments/: profile_serving, profile_tail_bucket,
profile_decode, profile_frame_tail, profile_pack, profile_pack_inprogram,
streaming_quality) run with ``--device cpu`` at the tiny scale (the CPU
tests' widths, a 16² mesh) and one round, their exactness checks
passing; and their variants that compute a production function held
against the JAX side on the same inputs.

Bands: the chained and planar packs byte for byte against the JAX
``_pack_yuv420`` (as tests/test_torch_port_units.py holds the served
pack); the einsum pack within one code of the JAX script's
``pack_matmul``, no value off by more (that script's own check: a
matmul's summation order is its library's); the corner-basis corners
within 1e-5 of the JAX decode's gathered corners (the face-shape band
of test_reconstruct_rotation_matches_jax); the streamed-vs-batch
coefficient MAE of each streaming preset within 1e-4 relative of the
JAX script's numbers on the same weights, and the interior MAE too
where truncation shows (above 1e-5); where it is float noise (the
batch-faithful presets, ~3e-7 on O(0.04) coefficients) both sides stay
under 1e-6.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicepuppet_tpu.config import Config as JConfig
from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import morph as jmorph
from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
from voicepuppet_tpu.pipeline import streaming as jstream
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import weights
from voicepuppet_torch.experiments import (profile_decode,
                                           profile_frame_tail, profile_pack,
                                           profile_pack_inprogram,
                                           profile_serving,
                                           profile_tail_bucket,
                                           streaming_quality)
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.face3d import morph as tmorph
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import numpy_tree

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
TINY = CPU + ["--scale", "tiny"]
CORNER_BAND = 1e-5
SQ_REL = 1e-4
SQ_NOISE = 1e-6


def test_profile_serving_runs():
    out = profile_serving.main(TINY + ["--chunks", "4", "--blocks", "2",
                                       "--frames", "16", "--k", "2",
                                       "--rounds", "1"])
    assert set(out["bfmnet_ms"]) == {"f32", "bf16"}
    assert len(out["stream_ms"][4]) == 2


def test_profile_tail_bucket_runs_with_full_chunks_equal():
    """21 frames at chunk 16: a 5-frame tail bucketed to 8 or padded to
    16; the full chunk is byte-identical across the variants (checked
    inside ``main``) and the switch is restored."""
    out = profile_tail_bucket.main(TINY + ["--pairs", "1", "--seconds",
                                           "0.8", "--chunk", "16"])
    assert set(out["best"]) == {"bucket", "pad_full"}


def test_profile_decode_runs():
    out = profile_decode.main(TINY + ["--batch", "2", "--k", "2",
                                      "--rounds", "1"])
    assert "point_buf_ring_gather" in out and "shape_formation_tf32" in out


def test_profile_frame_tail_runs():
    out = profile_frame_tail.main(TINY + ["--chunk", "2", "--k", "2",
                                          "--rounds", "1"])
    assert "frame_program_whole" in out and "tail_whole" in out


def test_corner_basis_matches_the_jax_decode_corners():
    """The corner-basis corners against the corners the JAX decode gathers
    from its shape (``morph.shape_formation``)."""
    model = jbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    coeff = jbfm.demo_coeff(model, batch=4, seed=5)
    jfm = jmorph.device_bfm(model)
    fs = np.asarray(jmorph.shape_formation(jnp.asarray(coeff[:, :80]),
                                           jnp.asarray(coeff[:, 80:144]),
                                           jfm))
    tri = np.asarray(jfm.tri)
    basis, mean = profile_frame_tail.corner_basis_tables(model, "cpu")
    got = profile_frame_tail.corner_verts_basis(
        torch.as_tensor(coeff[:, :144]), basis, mean).numpy()
    for k in range(3):
        np.testing.assert_allclose(got[:, :, k], fs[:, tri[:, k]],
                                   atol=CORNER_BAND)
    err, scale = profile_frame_tail.corner_basis_error(
        tmorph.device_bfm(model, "cpu"), basis, mean, torch.as_tensor(coeff))
    assert err <= CORNER_BAND * scale


def test_profile_pack_runs():
    out = profile_pack.main(CPU + ["--chunk", "2", "--size", "64", "--k",
                                   "2", "--rounds", "1"])
    assert set(out) == {"v0_chained", "v1_planar", "v2_matmul"}


@pytest.mark.parametrize("variant", ["v0_chained", "v1_planar", "v2_matmul"])
def test_packs_match_jax(variant):
    from experiments import profile_pack as jpack
    rng = np.random.RandomState(5)
    frames = rng.rand(3, 64, 64, 3).astype(np.float32) * 1.2 - 0.1
    f = {"v0_chained": tsyn._pack_yuv420,
         "v1_planar": profile_pack.pack_planar,
         "v2_matmul": profile_pack.pack_matmul}[variant]
    got = f(torch.as_tensor(frames)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 64 * 64 * 3 // 2)
    if variant == "v2_matmul":
        want = np.asarray(jax.jit(jpack.pack_matmul)(jnp.asarray(frames)))
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1
    else:
        want = np.asarray(jax.jit(jsyn._pack_yuv420)(jnp.asarray(frames)))
        np.testing.assert_array_equal(got, want)


def test_profile_pack_inprogram_runs_and_restores_the_pack():
    served = tsyn._pack_yuv420
    out = profile_pack_inprogram.main(TINY + ["--chunk", "2", "--k", "2",
                                              "--rounds", "1"])
    assert set(out) == {"chained", "einsum"}
    assert tsyn._pack_yuv420 is served


def test_streaming_quality_runs():
    out = streaming_quality.main(CPU)
    assert [r["preset"] for r in out["rows"]] == [
        p[0] for p in streaming_quality.PRESETS]
    # fully causal loses the most
    assert out["rows"][-1]["mae"] == max(r["mae"] for r in out["rows"])


def _jax_script_numbers(synth, pcm):
    """streaming_quality's loop as the JAX script runs it, on the JAX
    package's StreamingCoeffPredictor and whole-clip BFMNet."""
    frames = streaming_quality.FRAMES
    cfg = synth.cfg
    n = cfg.pcm_length_for_frames(frames)
    pcm_pad = np.pad(pcm, (0, max(0, n - pcm.shape[0])))[:n]
    ref = np.asarray(synth.bfmnet.apply(
        synth.bfm_vars, np.zeros((1, frames, 1), np.float32),
        synth.frontend(pcm_pad[None]), np.full((1,), frames, np.int32),
        train=False))[0]
    rows = []
    for _, chunk, ctx_right in streaming_quality.PRESETS:
        sp = jstream.StreamingCoeffPredictor(synth, chunk=chunk,
                                             ctx_right=ctx_right)
        sp._rng = streaming_quality.ZeroRng()
        blocks = []
        step = cfg.mel.sample_rate // 4
        for off in range(0, pcm.shape[0], step):
            blocks += sp.feed(pcm[off:off + step])
        blocks += sp.flush()
        got = np.concatenate([np.asarray(b) for b in blocks], 0)
        inner = streaming_quality.INTERIOR
        rows.append((float(np.abs(got - ref).mean()),
                     float(np.abs(got[inner] - ref[inner]).mean())))
    return rows


def test_streaming_quality_matches_the_jax_script():
    base = JConfig()
    jcfg = dataclasses.replace(
        base,
        bfmnet=dataclasses.replace(base.bfmnet, backbone_width_mult=0.25,
                                   thinresnet_output_channels=64,
                                   encode_embedding_size=64,
                                   rnn_hidden_size=64),
        pixrefer=dataclasses.replace(base.pixrefer, ngf=8, ndf=8,
                                     img_size=256))
    t = 8
    bfm_vars = numpy_tree(JBFMNet(jcfg.bfmnet), jnp.zeros((1, t, 1)),
                          jnp.zeros((1, t * 5, 80)),
                          jnp.full((1,), t, jnp.int32), train=False, seed=1)
    x = jnp.zeros((1, 256, 256, 6))
    g = numpy_tree(jpx.PixReferNet(jcfg.pixrefer), x, x, x[..., :3],
                   seed=2)["params"]
    model = jbfm.synthetic_bfm(num_theta=12, num_phi=12, seed=3)
    cfg = streaming_quality.script_config()
    pcm = streaming_quality.clip(cfg)
    want = _jax_script_numbers(jsyn.Synthesizer(jcfg, model, bfm_vars, g),
                               pcm)
    tsynth = tsyn.Synthesizer(cfg, model,
                              weights.state_dict_from_flax(bfm_vars),
                              weights.state_dict_from_flax(g),
                              device="cpu")
    got, _ = streaming_quality.preset_errors(tsynth, pcm)
    for row, (mae, inner) in zip(got, want):
        assert abs(row["mae"] - mae) <= SQ_REL * mae, (row, mae)
        if inner > 1e-5:
            assert abs(row["interior_mae"] - inner) <= SQ_REL * inner, (
                row, inner)
        else:
            assert row["interior_mae"] < SQ_NOISE and inner < SQ_NOISE


def test_decode_ring_gather_reads_triangle_normals():
    """point_buf indexes triangles (up to the sentinel F), more rows than
    the per-vertex normals the JAX script pads (N + 1; XLA clamps the
    rest): the port's case gathers from the F + 1 triangle normals."""
    model = tbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=0)
    fm = tmorph.device_bfm(model, "cpu")
    coeff = torch.as_tensor(tbfm.demo_coeff(model, batch=2, seed=1))
    f, n = fm.tri.shape[0], model.num_vertices
    assert int(fm.point_buf.max()) == f > n + 1
    fn, x = profile_decode.decode_cases(fm, coeff, torch.zeros((2, 3)))[
        "point_buf_ring_gather"]
    assert x.shape == (2, f + 1, 3)
    want = tmorph.compute_norm(tmorph.shape_formation(
        coeff[:, :80], coeff[:, 80:144], fm), fm)
    got = fn(x)
    np.testing.assert_allclose(
        (got / torch.linalg.norm(got, dim=2, keepdim=True)).numpy(),
        want.numpy(), atol=1e-6)


def test_carried_timing_takes_the_carry_off(monkeypatch):
    """With ``carry`` each call gets the previous call's nudged input,
    and the nudges' own time, taken in a window of their own, is not in
    the result: a 20 ms nudge around an instant call times as ~0."""
    from voicepuppet_torch.experiments import _timing
    real = _timing.nudge
    seen = []

    def slow_nudge(x, out):
        time.sleep(0.02)
        return real(x, out)

    def f(x):
        seen.append(float(x[0]))
        return torch.ones(1)

    monkeypatch.setattr(_timing, "nudge", slow_nudge)
    x = torch.zeros(1)
    carried = _timing.repeat(f, 3, "cpu", carry=True)(x)
    # each call fed the last output (float32 values of 1e-30, 2e-30)
    assert seen[1:] == pytest.approx([1e-30, 2e-30], rel=1e-6)
    assert abs(carried) < 0.01
    plain = _timing.repeat(f, 3, "cpu")(x)
    assert abs(plain) < 0.01 and seen[3:] == [0.0] * 3
