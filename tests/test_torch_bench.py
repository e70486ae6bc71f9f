"""The port's benchmark (``voicepuppet_torch/bench.py``) on the
CPU: its emitted line against the JAX ``bench._emit`` contract, a tiny
``main`` run, and ``measure``'s coefficients and frames against the JAX
Synthesizer's on the bench's own workload.

``vs_baseline`` is the real-time factor ``value / frame_rate`` (the JAX
bench divides by a TPU share, which is no H100 figure).

``measure``'s frames, served as the bench times them (the generator in
bfloat16), are held to the JAX frame program fed the same coefficients
with ``raster_bb=24`` and its generator in bfloat16 too, the weights the
port's seed-0 ones carried into JAX trees, within the served path's
band: mean |uint8 diff| under ``chip_smoke.GEN_BF16_MEAN_CODES`` (0.185
codes, bf16 against float32 on the card).  The two bf16 generators round
apart: 0.111 codes here, each 0.10 from its own float32 frames (which
agree within ``tests/test_torch_synthesize.py``'s 0.01); against the
port's own bf16 ``render_frames`` of the same coefficients they are
equal byte for byte.  The bench's
audio is a pure sine: 62% of its log-mel bins lie below -10, near the
log floor (-13.8), where float32 rounding of a power ~1e-6 moves a bin
by up to 1.5 between the two frontends (bins above -6 agree within
3.7e-4), so the whole clip's coefficients are held to COEFF_ATOL
(measured 4.0e-3 on values up to 0.49); with the noise of
``test_torch_synthesize.py``'s audio they agree within 5e-5 there.
``BENCH_CHUNK=8`` keeps the frame-rate probe's 36 frame programs short
here.
"""

import json

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import bench, weights
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import jax_cfg, port_cfg
from chip_smoke import GEN_BF16_MEAN_CODES

torch.set_num_threads(1)

COEFF_ATOL = 1e-2
KEYS = {"metric", "value", "unit", "vs_baseline", "runs", "watchdog",
        "compute_fps", "fps_runs", "d2h_MBps", "raster_parity"}
SMALL_YML = """
default:
  bfmnet:
    backbone_width_mult: 0.25
    thinresnet_output_channels: 64
    encode_embedding_size: 64
    rnn_hidden_size: 64
  pixrefer:
    ngf: 8
    ndf: 8
    img_size: 256
"""


def _one_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_emit_json_contract(capsys):
    bench._best.update(bench._fresh_record())
    bench._best["runs"] = 7
    bench._best["compute_fps"] = 245.3
    bench._best["fps_runs"] = [80.25, 70.0]
    bench._emit(80.25)
    rec = _one_line(capsys)
    assert set(rec) == KEYS
    assert rec["metric"] == "e2e_synthesis_frames_per_sec_per_chip_512px"
    assert rec["value"] == 80.25 and rec["unit"] == "frames/s"
    assert rec["vs_baseline"] == round(80.25 / 25, 4)
    assert rec["runs"] == 7 and rec["watchdog"] is False
    assert rec["compute_fps"] == 245.3
    assert rec["fps_runs"] == [80.2, 70.0]
    assert rec["raster_parity"] == "not run"


def test_emit_handles_unmeasured_compute(capsys):
    bench._best.update(bench._fresh_record())
    bench._best["runs"] = 1
    bench._emit(25.0, watchdog=True)
    rec = _one_line(capsys)
    assert rec["watchdog"] is True and rec["compute_fps"] is None
    assert rec["vs_baseline"] == 1.0


def test_emit_keys_are_the_jax_bench_keys(capsys):
    """The root ``bench._emit`` (the JAX package's) prints the same keys,
    no more."""
    import bench as jbench
    jbench._emit(10.0)
    want = json.loads(capsys.readouterr().out.strip())
    bench._emit(10.0)
    assert set(_one_line(capsys)) == set(want) == KEYS


def test_workload_is_the_jax_bench_workload():
    """``bench.py:116-122``: an 8 s 220 Hz sine at 0.3, a RandomState(0)
    panel (s, 3s, 3)."""
    cfg = port_cfg()
    pcm, panel = bench.workload(cfg, 8.0)
    sr = cfg.mel.sample_rate
    want = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(int(8.0 * sr))
                         / sr)).astype(np.float32)
    np.testing.assert_array_equal(pcm, want)
    s = cfg.pixrefer.img_size
    np.testing.assert_array_equal(
        panel, np.random.RandomState(0).rand(s, 3 * s, 3).astype(np.float32))


def test_main_tiny_cpu_run(tmp_path, monkeypatch, capsys):
    """``main`` with ``--device cpu`` on a small YAML profile: exit 0, one
    JSON line, the selftest (after run 2) through the plain raster, no
    d2h probe on the CPU."""
    monkeypatch.setenv("BENCH_CHUNK", "8")
    yml = tmp_path / "small.yml"
    yml.write_text(SMALL_YML)
    rc = bench.main(["--device", "cpu", "--config_path", str(yml),
                     "--seconds", "0.5", "--budget_s", "0",
                     "--min_runs", "2"])
    rec = _one_line(capsys)
    assert rc == 0
    assert set(rec) == KEYS
    assert rec["raster_parity"] == "ok"
    assert rec["runs"] == 2 and len(rec["fps_runs"]) == 2
    assert rec["value"] > 0 and rec["value"] == round(
        max(bench._best["fps_runs"]), 2)
    assert rec["vs_baseline"] == round(bench._best["fps"] / 25, 4)
    assert rec["d2h_MBps"] == []
    assert rec["compute_fps"] is None or rec["compute_fps"] > 0
    assert bench._best["frames"].shape == (13, 256, 256, 3)


def test_main_reports_a_parity_failure(tmp_path, monkeypatch, capsys):
    """A selftest that finds a difference: its message is the line's
    ``raster_parity`` and ``main`` returns 1."""
    from voicepuppet_torch.ops import raster_selftest

    def differs(device):
        raise AssertionError("soup K1 winner: 1/4096 elements differ")
    monkeypatch.setattr(raster_selftest, "run_selftest", differs)
    monkeypatch.setattr(bench, "MESH_GRID", 16)
    monkeypatch.setenv("BENCH_CHUNK", "8")
    yml = tmp_path / "small.yml"
    yml.write_text(SMALL_YML)
    rc = bench.main(["--device", "cpu", "--config_path", str(yml),
                     "--seconds", "0.3", "--budget_s", "0",
                     "--min_runs", "2"])
    rec = _one_line(capsys)
    assert rc == 1
    assert rec["raster_parity"] == ("AssertionError: soup K1 winner: "
                                    "1/4096 elements differ")


def test_main_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        bench.main(["--budget_s", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_measure_frames_match_jax(monkeypatch):
    """``measure``'s last run (panel, pcm, black background, the demo
    identity; chunk 8 on a 16² mesh: 13 frames, one chunk and a tail
    bucket of 8) against the JAX Synthesizer with the same weights, both
    generators in bfloat16: the coefficients within COEFF_ATOL, the
    frames equal to the port's own ``render_frames`` of those
    coefficients byte for byte, and against the JAX ``render_frames``
    within the served band."""
    monkeypatch.setenv("BENCH_CHUNK", "8")
    monkeypatch.setenv("BENCH_RASTER_PARITY", "0")
    jcfg = jax_cfg()
    cfg = port_cfg(jcfg)
    model = jbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=0)
    tmodel = tbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=0)
    rec = bench.measure(cfg, tmodel, device="cpu", seconds=0.5, budget_s=0,
                        min_runs=1)
    got = rec["frames"]
    assert rec["raster_parity"] == "not run" and rec["runs"] == 1

    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg, 0)
    bfm_t, g_t = jax.eval_shape(
        lambda: jsyn.SynthesisAssets.init_trees(jcfg))
    jsynth = jsyn.Synthesizer(
        jcfg, model, weights.flax_from_state_dict(bfm_state, bfm_t),
        weights.flax_from_state_dict(g_state, g_t)["params"], chunk=8,
        raster_bb=24, gan_dtype=jnp.bfloat16)
    ident = jsyn.synthetic_identity(model, 0, jcfg.pixrefer.img_size)
    tident = tsyn.synthetic_identity(tmodel, 0, cfg.pixrefer.img_size)
    for k, v in ident.__dict__.items():
        np.testing.assert_array_equal(np.asarray(getattr(tident, k)),
                                      np.asarray(v))
    pcm, panel = bench.workload(cfg, 0.5)
    # the coefficients measure served: the same weights on the CPU
    tsynth = tsyn.Synthesizer(cfg, tmodel, bfm_state, g_state, chunk=8,
                              device="cpu")
    texp = tsynth.predict_expressions(pcm).numpy()
    jexp = np.asarray(jsynth.predict_expressions(pcm))
    assert np.abs(texp - jexp).max() < COEFF_ATOL, np.abs(texp - jexp).max()

    s = jcfg.pixrefer.img_size
    coeff = tsyn.splice_coeff_sequence(tident.bfmcoeff,
                                       torch.from_numpy(texp)).numpy()
    refs = (panel[:, s:2 * s], panel[:, :s] * panel[:, 2 * s:],
            np.zeros((1, s, s, 3), np.float32))
    # the port's own bf16 Synthesizer on those coefficients: byte for byte
    mine = tsynth.render_frames(coeff, tident, *refs)
    tsynth.close()
    np.testing.assert_array_equal(got, mine)
    want = jsynth.render_frames(coeff, ident, *refs)
    assert got.shape == want.shape == (13, s, s, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.mean() < GEN_BF16_MEAN_CODES, diff.mean()
    assert got.std(axis=0).max() > 0
