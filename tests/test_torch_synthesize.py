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


@pytest.mark.parametrize("fmt", ["yuv444"])
def test_only_the_yuv420_drain_is_ported(fmt):
    """The reference's two drains, YUV 4:2:0 and rgb8, are the ones served
    (rgb8 is held against JAX in test_rgb8_drain_matches_jax_rgb8); any
    other transfer format raises instead of taking an untested path."""
    cfg = port_cfg()
    model = jbfm.synthetic_bfm(num_theta=6, num_phi=6)
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg)
    with pytest.raises(NotImplementedError, match="yuv420"):
        tsyn.Synthesizer(cfg, model, bfm_state, g_state, device="cpu",
                         transfer_format=fmt)


# ---- weights from the reference's files ------------------------------------

def _jax_weight_files(jsynth, tmp_path):
    """jsynth's trees written by the JAX package under the TF names: a V2
    bundle per model and an npz per model."""
    from voicepuppet_tpu.tools import tf_bundle as jtb
    from voicepuppet_tpu.tools import tf_checkpoint as jtfc
    g_vars = {"params": jsynth.g_params}
    out = {}
    for name, rows, variables in (
            ("bfmnet", jtfc.bfmnet_name_map()
             + jtfc._shortcut_rows(jsynth.bfm_vars), jsynth.bfm_vars),
            ("pixrefer", jtfc.pixrefer_generator_name_map(), g_vars)):
        arrays = {}
        for tf_name, coll, p, transform in rows:
            val = np.asarray(jtfc._get(variables[coll], p))
            arrays[tf_name] = transform(val) if transform else val
        prefix = str(tmp_path / f"ckpt_{name}" / f"{name}-1")
        jtb.write_bundle(arrays, prefix)
        npz = str(tmp_path / f"{name}.npz")
        jtfc.export_npz(variables, rows, npz)
        out[name] = (prefix, npz)
    return out


@pytest.fixture(scope="module")
def loaded(pair, tmp_path_factory):
    """The JAX Synthesizer of ``from_tf_checkpoints`` (its overlay targets
    zeroed, so every weight comes from the files) and its frames, and the
    weight files."""
    import jax
    jsynth, _, ident, _ = pair
    files = _jax_weight_files(jsynth, tmp_path_factory.mktemp("weights"))
    zeros = lambda t: jax.tree_util.tree_map(lambda a: np.zeros_like(a), t)
    trees = (zeros(jsynth.bfm_vars), zeros({"params": jsynth.g_params}))
    init_trees = jsyn.SynthesisAssets.init_trees
    jsyn.SynthesisAssets.init_trees = staticmethod(lambda cfg: trees)
    try:
        jloaded = jsyn.SynthesisAssets.from_tf_checkpoints(
            jax_cfg(), files["bfmnet"][0], files["pixrefer"][0],
            face_model=jsynth.face_model, chunk=CHUNK, raster_bb=24,
            gan_dtype=jnp.float32)
    finally:
        jsyn.SynthesisAssets.init_trees = init_trees
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    want = jloaded.render_frames(coeff, ident, face3d_ref, fg_ref, bgs)
    return jloaded, want, files


@pytest.mark.parametrize("source", ["tf", "npz"])
def test_loaded_weights_match_jax_from_tf_checkpoints(pair, loaded, source):
    """``from_tf_checkpoints`` and ``from_npz`` of JAX-written files give
    state_dicts equal, bit for bit, to state_dict_from_flax of the trees
    the JAX ``from_tf_checkpoints`` loads, and frames within this file's
    bands of that JAX Synthesizer's."""
    jsynth, _, _, tident = pair
    jloaded, want, files = loaded
    (bfm_prefix, bfm_npz), (g_prefix, g_npz) = files["bfmnet"], \
        files["pixrefer"]
    kw = dict(face_model=jsynth.face_model, chunk=CHUNK,
              gan_dtype=torch.float32, device="cpu")
    synth = (tsyn.SynthesisAssets.from_tf_checkpoints(
        port_cfg(), bfm_prefix, g_prefix, **kw) if source == "tf" else
        tsyn.SynthesisAssets.from_npz(port_cfg(), bfm_npz, g_npz, **kw))
    for module, tree in ((synth.bfmnet, jloaded.bfm_vars),
                         (synth.gen, jloaded.g_params)):
        want_state = weights.state_dict_from_flax(tree)
        got_state = module.float().state_dict()
        assert set(got_state) == set(want_state)
        for k, v in want_state.items():
            assert torch.equal(got_state[k], v), k
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    got = synth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    for sl in (slice(0, CHUNK), slice(CHUNK, T)):
        assert diff[sl].mean() < MEAN_BAND, diff[sl].mean()
        assert (diff[sl] > 1).mean() < OVER_ONE_BAND, (diff[sl] > 1).mean()


def test_rgb8_drain_matches_jax_rgb8(pair):
    """``transfer_format="rgb8"`` (clip(frames * 255) as uint8, no chroma
    subsampling) against the JAX rgb8 drain, within the yuv420 bands."""
    jsynth, tsynth, ident, tident = pair
    jrgb = jsyn.Synthesizer(jax_cfg(), jsynth.face_model, jsynth.bfm_vars,
                            jsynth.g_params, chunk=CHUNK, raster_bb=24,
                            gan_dtype=jnp.float32, transfer_format="rgb8")
    trgb = tsyn.Synthesizer(port_cfg(), jsynth.face_model,
                            tsynth.bfmnet.state_dict(),
                            tsynth.gen.state_dict(), chunk=CHUNK,
                            gan_dtype=torch.float32, transfer_format="rgb8",
                            device="cpu")
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    want = jrgb.render_frames(coeff, ident, face3d_ref, fg_ref, bgs)
    got = trgb.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    assert got.shape == want.shape == (T, S, S, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.mean() < MEAN_BAND, diff.mean()
    assert (diff > 1).mean() < OVER_ONE_BAND, (diff > 1).mean()
    # rgb8 and yuv420 differ only by the chroma round trip: luma agrees
    yuv = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    luma = lambda f: f.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    assert np.abs(luma(got) - luma(yuv)).mean() < 1.5


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_drain_workers_give_identical_frames(pair, workers):
    """Each drain task writes its own frame slice, so the frames do not
    depend on the worker count; the pool persists across calls and is
    released by close()."""
    _, tsynth, _, tident = pair
    coeff, face3d_ref, fg_ref, bgs = _inputs()
    want = tsynth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
    with tsyn.Synthesizer(port_cfg(), tsynth.face_model,
                          tsynth.bfmnet.state_dict(),
                          tsynth.gen.state_dict(), chunk=CHUNK,
                          gan_dtype=torch.float32, drain_workers=workers,
                          device="cpu") as synth:
        got = synth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
        pool = synth._drain_pool
        assert pool is not None and pool._max_workers == workers
        again = synth.render_frames(coeff, tident, face3d_ref, fg_ref, bgs)
        assert synth._drain_pool is pool
    assert synth._drain_pool is None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)


def test_estimate_chunk_compute_is_a_positive_time(pair):
    _, tsynth, _, tident = pair
    sec = tsynth.estimate_chunk_compute(tident, k=3, repeats=1)
    assert np.isfinite(sec) and sec > 0, sec


def test_bfmnet_bfloat16_trunk_inside_the_jax_band():
    """``bfmnet_dtype=bfloat16`` against float32 on the same weights,
    inside the band of tests/test_bfmnet.py:191-220 (max |diff| < 0.05 x
    scale + 1e-3), and not equal (the cast is live); float32 output."""
    from voicepuppet_torch.models.bfmnet import BFMNet
    cfg = port_cfg()
    state, _ = tsyn.SynthesisAssets.init_trees(cfg, seed=0)
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        nets[dtype] = BFMNet(cfg.bfmnet, dtype=dtype)
        nets[dtype].load_state_dict(state)
        nets[dtype].eval()
    rs = np.random.RandomState(0)
    t = 8
    ears = torch.as_tensor(rs.rand(2, t, 1) / 100.0, dtype=torch.float32)
    mfcc = torch.as_tensor(rs.randn(2, t * 5, 80), dtype=torch.float32)
    seq = torch.full((2,), t)
    with torch.no_grad():
        o32 = nets[torch.float32](ears, mfcc, seq, mask_time=True)
        o16 = nets[torch.bfloat16](ears, mfcc, seq, mask_time=True)
    assert o16.dtype == torch.float32
    assert next(nets[torch.bfloat16].parameters()).dtype == torch.float32
    d = float((o32 - o16).abs().max())
    scale = float(o32.abs().max())
    assert 0.0 < d < 0.05 * scale + 1e-3, (d, scale)


# ---- the command line ---------------------------------------------------------

def _cli_files(tmp_path):
    """A small config, a panel image, a wav, weights in both forms, an
    identity npz, a TorchScript landmark model and an R-Net npz."""
    import scipy.io.wavfile
    from PIL import Image
    from voicepuppet_torch.pipeline import detect, rnet
    from voicepuppet_torch.tools import tf_bundle as tb
    from voicepuppet_torch.tools import tf_checkpoint as tfc
    cfg = port_cfg()
    (tmp_path / "models").mkdir()
    np.save(tmp_path / "models" / "lm3d.npy",
            np.random.RandomState(2).randn(5, 3) * 0.3)
    (tmp_path / "cfg.yml").write_text(
        f"model_dir: {tmp_path / 'models'}\n"
        "bfmnet: {backbone_width_mult: 0.25, thinresnet_output_channels: 64,"
        " encode_embedding_size: 64, rnn_hidden_size: 64}\n"
        "pixrefer: {ngf: 8, img_size: 256}\n")
    rng = np.random.RandomState(0)
    Image.fromarray((rng.rand(S, 3 * S, 3) * 255).astype(np.uint8)).save(
        tmp_path / "panel.png")
    scipy.io.wavfile.write(str(tmp_path / "a.wav"), 16000, (0.3 * np.sin(
        2 * np.pi * 440 * np.arange(6000) / 16000)).astype(np.float32))
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg, seed=1)
    b = tfc.export_arrays(bfm_state, tfc.bfmnet_rows(bfm_state))
    g = tfc.export_arrays(g_state, tfc.pixrefer_generator_name_map())
    tb.write_bundle(b, str(tmp_path / "ckpt_bfmnet" / "bfmnet-65000"))
    tb.write_bundle(g, str(tmp_path / "ckpt_pixrefer" / "pixrefernet-20000"))
    for name, arrays in (("bfmnet", b), ("pixrefer_g", g)):
        np.savez(tmp_path / f"{name}.npz",
                 **{k.replace("/", "|"): v for k, v in arrays.items()})
    np.savez(tmp_path / "identity.npz", bfmcoeff=tbfm_demo_coeff(),
             transform_params=np.array([S, S, 1.0, 0.0, 0.0]),
             center_x=S // 2, center_y=S // 2, ratio=1.0, colors_bgr=False)

    class Landmarks(torch.nn.Module):
        def __init__(self, lmk):
            super().__init__()
            self.register_buffer("lmk", torch.as_tensor(lmk)[None])

        def forward(self, x):
            return self.lmk + 0.0 * x.sum()

    lmk = detect.CenteredFaceProvider()(np.zeros((S, S, 3)))
    torch.jit.script(Landmarks(lmk)).save(str(tmp_path / "lmk.pt"))
    net = rnet.init_rnet_(rnet.RNet(), torch.Generator().manual_seed(0))
    np.savez(tmp_path / "rnet.npz", **{
        k.replace("/", "|"): v
        for k, v in rnet.export_rnet_arrays(net.state_dict()).items()})
    return tmp_path


def tbfm_demo_coeff():
    from voicepuppet_torch.face3d import bfm as tbfm
    return tbfm.demo_coeff(tbfm.synthetic_bfm(num_theta=48, num_phi=48),
                           batch=1, seed=4)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    return _cli_files(tmp_path_factory.mktemp("cli"))


CLI_FLAGS = {
    "tf": ["--bfmnet_tf_ckpt", "ckpt_bfmnet/bfmnet-65000",
           "--pixrefer_tf_ckpt", "ckpt_pixrefer/pixrefernet-20000"],
    "npz": ["--bfmnet_npz", "bfmnet.npz", "--pixrefer_npz",
            "pixrefer_g.npz", "--identity_npz", "identity.npz"],
    "photo": ["--bfmnet_npz", "bfmnet.npz", "--pixrefer_npz",
              "pixrefer_g.npz", "--landmark_model", "lmk.pt",
              "--rnet_npz", "rnet.npz"],
}


@pytest.mark.parametrize("flags", sorted(CLI_FLAGS))
def test_cli_serves_each_weight_source_on_cpu(cli_dir, flags, capsys):
    out = cli_dir / f"out_{flags}"
    args = [a if a.startswith("--") else str(cli_dir / a)
            for a in CLI_FLAGS[flags]]
    tsyn.main(["--config_path", str(cli_dir / "cfg.yml"), "--out_dir",
               str(out), "--background_dir", str(cli_dir / "none"),
               "--device", "cpu"] + args
              + [str(cli_dir / "panel.png"), str(cli_dir / "a.wav")])
    n = int(1 + 6000 / 640)
    assert f"wrote {n} frames" in capsys.readouterr().out
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == n


@pytest.mark.parametrize("flags", [
    ["--bfmnet_tf_ckpt", "a"], ["--pixrefer_tf_ckpt", "a"],
    ["--bfmnet_npz", "a"], ["--pixrefer_npz", "a"],
    ["--bfmnet_tf_ckpt", "a", "--pixrefer_tf_ckpt", "b", "--bfmnet_npz",
     "c", "--pixrefer_npz", "d"],
    ["--landmark_model", "a"], ["--rnet_npz", "a"], ["--rnet_pb", "a"],
    ["--landmark_model", "a", "--rnet_npz", "b", "--rnet_pb", "c"],
    ["--bfmnet_ckpt", "a"], ["--pixrefer_ckpt", "a"],
    ["--bfmnet_ckpt", "a", "--pixrefer_ckpt", "b", "--bfmnet_npz", "c",
     "--pixrefer_npz", "d"]])
def test_cli_pairing_errors(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tsyn.main(flags + ["--device", "cpu", "image.png", "audio.wav"])
    assert exc.value.code == 2
    assert "error: --" in capsys.readouterr().err
