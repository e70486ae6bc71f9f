"""PixFlowNet served through the port's ``Synthesizer``
(``Config.generator = "pixflow"``), on the CPU in float32: ngf 8 at 128²,
a 24² face mesh, BFMNet at width 0.25, seeded weights, one thread.

* the served frames against the benchmark's plain reference
  (``benchmark/reference/pixflow.py``: G on one frame at a time, whole,
  as the published driver runs it), through the YUV 4:2:0 drain: each
  frame within 0.02 codes on average and 2 codes at any byte;
* chunk independence: a frame's bytes do not change when another frame
  of its chunk is made extreme, and a tail-bucket frame equals the same
  frame served inside a full chunk; under per-chunk moments (PixRefer's)
  the first of these fails;
* the shared part computed once a call (``call_state``) and the
  per-frame part (``frame_forward``) at batch 4 equal the whole G run on
  one frame at a time, and the JAX package's ``PixFlowNet`` run one frame
  at a time (as ``tests/test_torch_pixflow.py`` holds it at batch 1);
* the rgb8 transfer against ``infer_bfm_pixflow``'s frames within one
  code (the pack truncates, the driver's frames are rounded here);
* ``FlopCounterMode``'s counts of the two parts at ngf 64 and 512² on the
  meta device: 99.0 GFLOP a frame and 47.6 once a call;
* the ``vp.render.gen`` and ``vp.render.ref`` spans of one call, and the
  refusals of the streaming driver and of a mesh of several ranks.
"""

import copy
import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import face as ref_face
from benchmark.reference import nets as ref_nets
from benchmark.reference import pixflow as ref_pixflow
from benchmark.traffic import scene
from voicepuppet_torch.config import BFMNetConfig, Config, PixFlowConfig
from voicepuppet_torch.face3d.bfm import BFMModel
from voicepuppet_torch.models import pixflow as tpf
from voicepuppet_torch.pipeline import synthesize as tsyn
from voicepuppet_torch.utils import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
S, NGF, GRID, CHUNK = 128, 8, 24, 16
SEED = 5
MEAN_CODES, MAX_CODES = 0.02, 2


def _config():
    """The benchmark's configuration file at test size (the reference
    reads it; the port's ``Config`` is made from the same numbers)."""
    cfg = json.loads((ROOT / "benchmark/configs/serve-pixflow512.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg["pixflow"].update(ngf=NGF, img_size=S)
    cfg["bfmnet"]["backbone_width_mult"] = 0.25
    return cfg


def _port_cfg(generator="pixflow"):
    return Config(generator=generator,
                  pixflow=PixFlowConfig(ngf=NGF, img_size=S),
                  bfmnet=dataclasses.replace(BFMNetConfig(),
                                             backbone_width_mult=0.25))


@pytest.fixture(scope="module")
def case():
    cfg = _port_cfg()
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg, SEED)
    arrays = scene.face_model_arrays(GRID, SEED)
    ident = scene.identity(SEED, S)
    panel = scene.panel(SEED, S)
    n = 640 * 40
    pcm = (0.3 * np.sin(2 * np.pi * 180 * np.arange(n) / 16000)
           + 0.05 * np.random.RandomState(SEED).randn(n)).astype(np.float32)
    return types.SimpleNamespace(cfg=cfg, bfm_state=bfm_state,
                                 g_state=g_state, arrays=arrays, ident=ident,
                                 panel=panel, pcm=pcm)


def _synth(case, transfer_format="yuv420", chunk=CHUNK):
    return tsyn.Synthesizer(case.cfg, BFMModel(**case.arrays),
                            case.bfm_state, case.g_state, chunk=chunk,
                            gan_dtype=torch.float32,
                            transfer_format=transfer_format, device="cpu")


def _identity(ident):
    return tsyn.Identity(bfmcoeff=np.asarray(ident["bfmcoeff"], np.float32),
                         transform_params=np.asarray(
                             ident["transform_params"]),
                         center_x=ident["center_x"],
                         center_y=ident["center_y"], ratio=ident["ratio"])


def _refs(panel):
    return panel[:, S:2 * S], panel[:, :S] * panel[:, 2 * S:]


def _codes(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return d.reshape(d.shape[0], -1).mean(1), int(d.max())


def test_synthesize_matches_the_reference(case):
    with _synth(case) as synth:
        got = synth.synthesize(case.panel, case.pcm, _identity(case.ident))
    ref = ref_pixflow.Pipeline(_config(), case.bfm_state, case.g_state,
                               case.arrays, "cpu")
    with ref:
        want = ref.clip_frames(case.pcm, case.ident, case.panel)
    assert got.shape == want.shape == (41, S, S, 3)
    mean, worst = _codes(got, want)
    assert mean.max() <= MEAN_CODES and worst <= MAX_CODES, (mean.max(),
                                                            worst)
    # the frames are not blank: the face moves the generator's output
    assert got.std() > 5


def _rows(case, t):
    rng = np.random.RandomState(SEED + 1)
    rows = np.repeat(np.asarray(case.ident["bfmcoeff"], np.float32), t, 0)
    rows[:, 80:144] = rng.randn(t, 64).astype(np.float32)
    return rows


def test_a_frame_does_not_depend_on_its_chunk(case):
    ident = _identity(case.ident)
    rows = _rows(case, 20)
    extreme = rows.copy()
    extreme[3, 80:144] *= 40.0           # a face far off its usual shape
    extreme[3, 144:224] += 30.0          # and its colours
    with _synth(case) as synth:
        a = synth.render_frames(rows, ident, *_refs(case.panel), None)
        b = synth.render_frames(extreme, ident, *_refs(case.panel), None)
        # the tail bucket (4 frames padded to 8) against the same frames
        # served inside a full chunk of 16
        c = synth.render_frames(rows[4:20], ident, *_refs(case.panel), None)
        keep = np.arange(20) != 3
        assert np.abs(a[3].astype(int) - b[3].astype(int)).mean() > 1
        np.testing.assert_array_equal(a[keep], b[keep])
        mean, worst = _codes(a[16:20], c[12:16])
        assert mean.max() <= 0.01 and worst <= 1, (mean.max(), worst)
        # under per-chunk moments the extreme frame moves the others
        for m in synth.gen.modules():
            if isinstance(m, tpf.StatelessBatchNorm):
                m.moment_dims = (0, 2, 3)
        a2 = synth.render_frames(rows, ident, *_refs(case.panel), None)
        b2 = synth.render_frames(extreme, ident, *_refs(case.panel), None)
    assert np.abs(a2[keep].astype(int) - b2[keep].astype(int)).mean() > 0.5


def _images(b, s=S, seed=SEED):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(b, s, s, 3).astype(np.float32)) * 2
            - 1)


def test_call_state_reuse_equals_the_whole_g_per_frame(case):
    net = tpf.PixFlowNet(case.cfg.pixflow)
    net.load_state_dict(case.g_state)
    net.per_frame_moments().eval()
    g = net.generator
    ref, fg, cur = _images(1, seed=1), _images(1, seed=2), _images(4)
    with torch.no_grad():
        got = g.frame_forward(g.call_state(ref, fg), cur)
        want = torch.cat([
            g(torch.cat([ref, cur[i:i + 1]], -1),
              torch.cat([fg, torch.zeros_like(fg)], -1))
            for i in range(4)])
        # and the reference's whole G, one frame at a time
        rnet = ref_pixflow.PixFlowNet(NGF)
        rnet.load_state_dict(case.g_state)
        rwant = torch.cat([rnet.generator(torch.cat([ref, cur[i:i + 1]], -1),
                                          fg) for i in range(4)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), rwant.numpy(), rtol=0,
                               atol=1e-5)


def test_served_form_matches_jax_one_frame_at_a_time():
    from voicepuppet_tpu.models import pixflow as jpf
    from voicepuppet_torch import weights
    from _torch_port_cases import jax_cfg, numpy_tree, port_cfg
    jcfg = jax_cfg()
    s = jcfg.pixflow.img_size
    x6 = np.zeros((1, s, s, 6), np.float32)
    tree = numpy_tree(jpf.PixFlowNet(jcfg.pixflow), x6, x6, train=False,
                      seed=1)["params"]
    net = weights.load_flax_(tpf.PixFlowNet(port_cfg(jcfg).pixflow), tree)
    net.per_frame_moments().eval()
    rng = np.random.RandomState(4)
    ref = rng.rand(1, s, s, 3).astype(np.float32) * 2 - 1
    fg = rng.rand(1, s, s, 3).astype(np.float32) * 2 - 1
    cur = rng.rand(3, s, s, 3).astype(np.float32) * 2 - 1
    with torch.no_grad():
        raw = net.generator.frame_forward(
            net.generator.call_state(torch.from_numpy(ref),
                                     torch.from_numpy(fg)),
            torch.from_numpy(cur))
        got, _ = tpf.composite_black(raw)
    jnet = jpf.PixFlowNet(jcfg.pixflow)
    fg6 = np.concatenate([fg, np.zeros_like(fg)], -1)
    want = np.concatenate([
        np.asarray(jnet.apply({"params": tree},
                              np.concatenate([ref, cur[i:i + 1]], -1), fg6,
                              train=False)[0]) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_rgb8_matches_infer_bfm_pixflow(case, tmp_path):
    from voicepuppet_torch.pipeline import infer_drivers
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    trainer = PixFlowTrainer(case.cfg, device="cpu")
    state = trainer.init_state(seed=SEED)
    state.gen.load_state_dict(case.g_state)
    ident = _identity(case.ident)
    pcm = case.pcm[:640 * 12]
    with _synth(case, "rgb8") as synth:
        got = synth.synthesize(case.panel, pcm, ident)
        want = infer_drivers.infer_bfm_pixflow(
            case.cfg, synth, trainer, state, ident, case.panel, pcm,
            str(tmp_path))
    want = np.clip(np.round(want * 255.0), 0, 255).astype(np.uint8)
    assert got.shape == want.shape == (13, S, S, 3)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_flop_counts_of_the_two_parts():
    cfg = PixFlowConfig(ngf=64, img_size=512)
    with torch.device("meta"):
        g = tpf.PixFlowNet(cfg).per_frame_moments().generator
        one = torch.zeros(1, 512, 512, 3)
        batch = torch.zeros(4, 512, 512, 3)
        counter = FlopCounterMode(display=False)
        with counter:
            state = g.call_state(one, one)
        call = counter.get_total_flops()
        counter = FlopCounterMode(display=False)
        with counter:
            g.frame_forward(state, batch)
        frame = counter.get_total_flops() / 4
    assert round(call / 1e9, 1) == 47.6
    assert round(frame / 1e9, 1) == 99.0


def test_spans_of_one_call(case):
    with _synth(case) as synth:
        with tracing.recording() as rec:
            synth.synthesize(case.panel, case.pcm, _identity(case.ident))
    spans = rec.summary()["spans"]
    named = lambda n: [s for s in spans if s["name"] == n]  # noqa: E731
    chunks, gens = named("vp.render.chunk"), named("vp.render.gen")
    (ref,) = named("vp.render.ref")
    call = named("vp.synthesize")[0]
    # 41 frames: chunks of 16, 16 and a tail of 9 in a bucket of 16
    assert [s["size"] for s in chunks] == [16, 16, 9]
    assert [s["size"] for s in gens] == [16, 16, 16]
    assert all(g["parent"] == c["id"] for g, c in zip(gens, chunks))
    assert ref["request"] == call["request"] and ref["end_ns"] <= min(
        c["start_ns"] for c in chunks)


def test_pixrefer_has_the_generator_span():
    s = 256                     # the U-Net's eight levels need 256²
    cfg = dataclasses.replace(
        _port_cfg("pixrefer"),
        pixrefer=dataclasses.replace(_port_cfg().pixrefer, ngf=8,
                                     img_size=s))
    face = scene.face_model_arrays(GRID, SEED)
    bfm, gen = tsyn.SynthesisAssets.init_trees(cfg, SEED)
    ident = scene.identity(SEED, s)
    with tsyn.Synthesizer(cfg, BFMModel(**face), bfm, gen, chunk=8,
                          gan_dtype=torch.float32, device="cpu") as synth:
        rows = np.repeat(np.asarray(ident["bfmcoeff"], np.float32), 10, 0)
        panel = scene.panel(SEED, s)
        with tracing.recording() as rec:
            synth.render_frames(rows, _identity(ident), panel[:, s:2 * s],
                                panel[:, :s], scene.background(SEED, s))
    names = [s["name"] for s in rec.summary()["spans"]]
    assert names.count("vp.render.gen") == 2
    assert "vp.render.ref" not in names


def test_streaming_refuses_pixflow(case):
    from voicepuppet_torch.pipeline.streaming import StreamingSynthesizer
    with _synth(case) as synth:
        with pytest.raises(NotImplementedError, match="pixflow"):
            StreamingSynthesizer(synth, _identity(case.ident),
                                 *_refs(case.panel))


def test_a_mesh_of_several_ranks_refuses_pixflow(case):
    mesh = types.SimpleNamespace(world=2, group=None, device="cpu",
                                 is_main=True)
    with pytest.raises(NotImplementedError, match="mesh of 2 ranks"):
        tsyn.Synthesizer(case.cfg, BFMModel(**case.arrays), case.bfm_state,
                         case.g_state, mesh=mesh, device="cpu")


def test_tf_named_weights_refuse_pixflow(case):
    with pytest.raises(NotImplementedError, match="pixflow"):
        tsyn.SynthesisAssets.states_from_arrays(case.cfg, {}, {}, "a", "b")


def test_the_reference_decode_is_the_drivers(case):
    """The reference's canvas mesh equals the port's decode with the
    published driver's mapping (``render_coeff_video_frames``)."""
    from voicepuppet_torch.face3d import morph
    rows = torch.from_numpy(_rows(case, 4))
    fm = morph.device_bfm(BFMModel(**case.arrays), "cpu")
    want, want_colors = tsyn.canvas_mesh(rows, fm, torch.zeros(4, 3), S)
    verts, colors = ref_pixflow.canvas_mesh(
        rows, ref_face.face_model_on(case.arrays, "cpu"), S)
    np.testing.assert_allclose(verts.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(colors.numpy(), want_colors.numpy(), atol=1)
    assert ref_nets.set_tf32 is not None


@pytest.mark.parametrize("group", [0, 4])
def test_render_canvas_is_the_drivers_and_the_programs_raster(case, group):
    """``render_canvas`` gives the bytes of the mesh-video driver at no yaw
    (``render_coeff_video_frames``) and of the raster inside PixFlow's
    frame program on the same rows (K1, or K4 at ``raster_group`` 4)."""
    from voicepuppet_torch.pipeline import infer_drivers
    rows = torch.from_numpy(_rows(case, 8))
    zeros = torch.zeros(8, 3)
    rasters = []
    real = tsyn.render_colors_auto

    def keep(*a, **k):
        out = real(*a, **k)
        rasters.append(out[0])
        return out
    with _synth(case) as synth:
        synth.raster_group = group
        got, mask = tsyn.render_canvas(rows, synth.fm, zeros, S, group)
        driver = infer_drivers.render_coeff_video_frames(
            rows, synth.fm, S, yaw_shift=0.0, chunk=8)
        tsyn.render_colors_auto = keep
        try:
            with torch.inference_mode():
                synth.frame_program(None, rows, zeros, None, None,
                                    *(torch.as_tensor(r) for r in
                                      _refs(case.panel)))
        finally:
            tsyn.render_colors_auto = real
    assert got.dtype == torch.uint8 and got.shape == (8, S, S, 3)
    assert 0 < float((mask > 0).float().mean()) < 1   # a face in the canvas
    np.testing.assert_array_equal(got.numpy(), driver)
    (program,) = rasters
    np.testing.assert_array_equal(got.numpy(), program.numpy())
