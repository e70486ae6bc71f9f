"""The port's trainer CLIs end to end on the CPU (``--device cpu``) on a
tiny on-disk dataset, serving from what they wrote, and
``infer_pixrefer`` against the JAX driver.

Tolerances: frames served by ``from_checkpoints`` equal to the byte the
frames of the same state_dicts served directly (the same CPU ops);
``infer_pixrefer``'s frames within 1e-5 of the JAX driver's (float32 on
both sides, the generator's sums in different orders).
"""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import wavfile

from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.pipeline import infer_drivers as jdrivers
from voicepuppet_tpu.train.pixrefer_trainer import PixReferTrainer as JTrainer

from voicepuppet_torch import config as tconfig
from voicepuppet_torch import weights
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.pipeline import infer_drivers as tdrivers
from voicepuppet_torch.pipeline import synthesize as tsyn
from voicepuppet_torch.train import bfmnet_trainer, pixrefer_trainer
from voicepuppet_torch.train.checkpoint import CheckpointManager
from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer

from _torch_port_cases import jax_cfg, numpy_tree, port_cfg

torch.set_num_threads(1)

PR_S = 256      # PixRefer panel size (its 8-level U-Net needs >= 256)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Coefficient/landmark/wav clips (BFMNet) and 3-panel JPEG clips
    (PixRefer), listed as "folder|frame_count" files."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(0)

    def write_clip(d, frames, panel):
        d.mkdir()
        np.savetxt(d / "bfmcoeff.txt", rng.randn(frames, 257) * 0.1,
                   fmt="%.5f", delimiter=",")
        np.savetxt(d / "landmark.txt", rng.rand(frames, 136) * 140 + 40,
                   fmt="%.3f", delimiter=",")
        pcm = 0.3 * np.sin(2 * np.pi * 220 * np.arange(frames * 640)
                           / 16000.0)
        wavfile.write(d / "audio.wav", 16000, (pcm * 32767).astype(np.int16))
        for i in range(frames if panel else 0):
            Image.fromarray((rng.rand(PR_S, 3 * PR_S, 3) * 255).astype(
                np.uint8)).save(d / f"{i}.jpg")
        return f"{d}|{frames}"

    for name, frames, panel in (("seq", 60, False), ("panel", 4, True)):
        (root / name).mkdir()
        lines = [write_clip(root / name / f"clip{k}", frames, panel)
                 for k in range(2)]
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return root


def _yaml(tmp_path, dataset, list_name):
    p = tmp_path / f"params_{list_name}.yml"
    p.write_text(f"""
default:
  model_dir: {tmp_path}/allmodels
  train_dataset_path: {dataset}/{list_name}
  eval_dataset_path: {dataset}/{list_name}
  bfmnet:
    batch_size: 4
    backbone_width_mult: 0.25
    thinresnet_output_channels: 32
    encode_embedding_size: 32
    rnn_hidden_size: 32
    training: {{save_interval: 1, eval_interval: 2}}
  pixrefer:
    batch_size: 2
    ngf: 4
    ndf: 4
    img_size: {PR_S}
    training: {{save_interval: 2, summary_interval: 2}}
""")
    return str(p)


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """Both CLIs, 2 steps each on the CPU, each with a profiler window."""
    tmp = tmp_path_factory.mktemp("run")
    cfg_b = _yaml(tmp, dataset, "seq.txt")
    cfg_p = _yaml(tmp, dataset, "panel.txt")
    bfmnet_trainer.main(["--config_path", cfg_b, "--steps", "2",
                         "--device", "cpu", "--ckpt_dir", str(tmp / "cb"),
                         "--log_dir", str(tmp / "lb"), "--profile_steps",
                         "1", "--profile_start", "1"])
    pixrefer_trainer.main(["--config_path", cfg_p, "--steps", "2",
                           "--device", "cpu", "--ckpt_dir", str(tmp / "cp"),
                           "--log_dir", str(tmp / "lp"), "--profile_steps",
                           "1", "--profile_start", "2"])
    return tmp, cfg_p


def test_bfmnet_cli_writes_metrics_checkpoints_grid_and_trace(trained):
    tmp, _ = trained
    rows = [json.loads(x) for x in open(tmp / "lb" / "bfmnet_metrics.jsonl")]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
    assert [r["step"] for r in rows if "eval_loss" in r] == [2]
    assert all(np.isfinite(r.get("loss", 0.0)) for r in rows)
    assert CheckpointManager(str(tmp / "cb")).steps() == [1, 2]
    grid = np.asarray(Image.open(tmp / "lb" / "eval_bfmnet" /
                                 "bfmnet_2.jpg"))
    # 2 x 24 faces, 10 to a row of 224² cells: 6 rows
    assert grid.shape == (6 * 224, 10 * 224, 3) and grid.max() > 0
    assert glob.glob(str(tmp / "lb" / "profile" / "trace_1.json"))
    assert glob.glob(str(tmp / "lb" / "tb" / "bfmnet" / "events.*"))


def test_pixrefer_cli_writes_metrics_checkpoints_and_summary(trained):
    tmp, _ = trained
    rows = [json.loads(x) for x in open(tmp / "lp" /
                                        "pixrefer_metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 4]
    assert set(rows[0]) >= {"discrim_loss", "gen_loss", "gen_loss_GAN",
                            "gen_loss_L1", "perceptual"}
    assert CheckpointManager(str(tmp / "cp")).steps() == [2, 4]
    strip = np.asarray(Image.open(tmp / "lp" / "images" /
                                  "pixrefer_2.jpg"))
    assert strip.shape == (PR_S, 3 * PR_S, 3)


def test_pixrefer_cli_trace_names_the_step_halves(trained):
    """The trace of ``--profile_steps`` holds the trainer's spans."""
    tmp, _ = trained
    with open(tmp / "lp" / "profile" / "trace_2.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vp.train.d_half", "vp.train.g_half"} <= names


def test_from_checkpoints_serves_what_was_trained(trained):
    """``from_checkpoints`` on the two directories serves the frames of
    the same state_dicts given to ``Synthesizer`` directly; the synthesize
    CLI's ``--bfmnet_ckpt/--pixrefer_ckpt`` serves them too."""
    tmp, cfg_path = trained
    cfg = tconfig.load_config(cfg_path)
    fm = tbfm.synthetic_bfm(num_theta=20, num_phi=20, seed=1)
    rng = np.random.RandomState(3)
    panel = rng.rand(PR_S, 3 * PR_S, 3).astype(np.float32)
    pcm = (0.3 * np.sin(np.arange(8000) * 0.09)).astype(np.float32)
    ident = tsyn.synthetic_identity(fm, img_size=PR_S)
    kw = dict(face_model=fm, device="cpu", gan_dtype=torch.float32,
              chunk=8)
    got = tsyn.SynthesisAssets.from_checkpoints(
        cfg, str(tmp / "cb"), str(tmp / "cp"), **kw).synthesize(
            panel, pcm, ident)
    bfm_state = CheckpointManager(str(tmp / "cb")).load()["model"]
    g_state = CheckpointManager(str(tmp / "cp")).load()["gen"]
    want = tsyn.Synthesizer(cfg, fm, bfm_state, g_state, device="cpu",
                            gan_dtype=torch.float32, chunk=8).synthesize(
                                panel, pcm, ident)
    assert got.shape == want.shape and got.shape[0] > 8
    assert np.array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tsyn.SynthesisAssets.load_checkpoint_weights(cfg, str(tmp / "none"),
                                                     str(tmp / "cp"))
    Image.fromarray((panel * 255).astype(np.uint8)).save(tmp / "panel.png")
    wavfile.write(tmp / "in.wav", 16000, (pcm * 32767).astype(np.int16))
    tsyn.main(["--config_path", cfg_path, "--bfmnet_ckpt", str(tmp / "cb"),
               "--pixrefer_ckpt", str(tmp / "cp"), "--device", "cpu",
               "--out_dir", str(tmp / "out"), str(tmp / "panel.png"),
               str(tmp / "in.wav")])
    assert len(glob.glob(str(tmp / "out" / "*.png"))) == got.shape[0]


def test_infer_pixrefer_matches_jax_driver(tmp_path):
    """``infer_pixrefer`` on a 3-frame panel folder, the same G params on
    both sides (the JAX side through its own ``PixReferTrainer.infer``)."""
    jcfg = jax_cfg()
    x6 = np.zeros((1, PR_S, PR_S, 6), np.float32)
    g = numpy_tree(jpx.PixReferNet(jcfg.pixrefer), x6, x6, x6[..., :3],
                   seed=4)["params"]
    rng = np.random.RandomState(5)
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray((rng.rand(PR_S, 3 * PR_S, 3) * 255).astype(
            np.uint8)).save(p)
        paths.append(str(p))
    jtrainer = types.SimpleNamespace(gen_eval=jpx.PixReferNet(jcfg.pixrefer),
                                     _infer_step=None)
    jtrainer.infer = types.MethodType(JTrainer.infer, jtrainer)
    want = jdrivers.infer_pixrefer(jcfg, jtrainer,
                                   types.SimpleNamespace(g_params=g), paths,
                                   str(tmp_path / "j"))
    tr = PixReferTrainer(port_cfg(jcfg), device="cpu")
    state = tr.init_state()
    weights.load_flax_(state.gen, g)
    got = tdrivers.infer_pixrefer(port_cfg(jcfg), tr, state, paths,
                                  str(tmp_path / "t"))
    assert got.shape == want.shape == (3, PR_S, PR_S, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "t")) == ["0.jpg", "1.jpg", "2.jpg"]


# ---- the PixFlow, ATNet and VGNet CLIs -------------------------------------------

ZOO_S = 32      # VGNet's image size here; PixFlow's panels are 64²


@pytest.fixture(scope="module")
def zoo_trained(dataset, tmp_path_factory):
    """The three CLIs, 2 steps each on the CPU: PixFlow in bfloat16 on
    64² panels, ATNet on the coefficient/landmark/wav clips, VGNet on
    15-frame JPEG clips with landmarks."""
    from voicepuppet_torch.train import (atnet_trainer, pixflow_trainer,
                                         vgnet_trainer)
    tmp = tmp_path_factory.mktemp("zoo")
    rng = np.random.RandomState(9)
    lines = {"pf": [], "vg": []}
    for k in range(2):
        d = tmp / f"pf{k}"
        d.mkdir()
        for i in range(3):
            img = (rng.rand(64, 192, 3) * 255).astype(np.uint8)
            img[:, 128:] = 0
            img[8:-8, 144:176] = 255
            Image.fromarray(img).save(d / f"{i}.jpg")
        lines["pf"].append(f"{d}|3")
        d = tmp / f"vg{k}"
        d.mkdir()
        ang = np.linspace(0, 2 * np.pi, 68, endpoint=False)
        ring = np.stack([112 + 70 * np.cos(ang), 112 + 85 * np.sin(ang)], -1)
        np.savetxt(d / "landmark.txt", (ring[None] + rng.randn(15, 68, 2))
                   .reshape(15, 136), fmt="%.3f", delimiter=",")
        for i in range(15):
            Image.fromarray((rng.rand(ZOO_S, ZOO_S, 3) * 255).astype(
                np.uint8)).save(d / f"{i}.jpg")
        lines["vg"].append(f"{d}|15")
    for name, ls in lines.items():
        (tmp / f"{name}.txt").write_text("\n".join(ls) + "\n")
    cfg = tmp / "zoo.yml"
    cfg.write_text(f"""
default:
  model_dir: {tmp}/allmodels
  pixflow:
    batch_size: 2
    ngf: 4
    ndf: 4
    img_size: 64
    training: {{save_interval: 2}}
  atnet:
    batch_size: 2
    thinresnet_output_channels: 32
    encode_embedding_size: 32
    rnn_hidden_size: 32
    training: {{save_interval: 1}}
  vgnet:
    batch_size: 2
    img_size: {ZOO_S}
    training: {{save_interval: 1}}
""")
    import yaml
    doc = yaml.safe_load(cfg.read_text())
    for name, lst in (("pixflow", tmp / "pf.txt"),
                      ("atnet", dataset / "seq.txt"),
                      ("vgnet", tmp / "vg.txt")):
        doc["default"]["train_dataset_path"] = str(lst)
        path = tmp / f"{name}.yml"
        path.write_text(yaml.safe_dump(doc))
    pixflow_trainer.main(["--config_path", str(tmp / "pixflow.yml"),
                          "--steps", "2", "--dtype", "bfloat16", "--device",
                          "cpu", "--ckpt_dir", str(tmp / "cf"), "--log_dir",
                          str(tmp / "lf")])
    atnet_trainer.main(["--config_path", str(tmp / "atnet.yml"), "--steps",
                        "2", "--device", "cpu", "--ckpt_dir",
                        str(tmp / "ca"), "--log_dir", str(tmp / "la")])
    vgnet_trainer.main(["--config_path", str(tmp / "vgnet.yml"), "--steps",
                        "2", "--alternative", "1", "--device", "cpu",
                        "--ckpt_dir", str(tmp / "cv"), "--log_dir",
                        str(tmp / "lv")])
    return tmp


def _rows(path):
    return [json.loads(x) for x in open(path)]


def test_pixflow_cli_bf16_writes_metrics_and_checkpoints(zoo_trained):
    """``--dtype bfloat16`` trains with float32 parameters; the
    checkpoint restores into a fresh trainer's state equal."""
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    tmp = zoo_trained
    rows = _rows(tmp / "lf" / "pixflow_metrics.jsonl")
    assert [r["step"] for r in rows] == [2, 4]
    assert set(rows[0]) >= {"discrim_loss", "gen_loss", "gen_loss_GAN",
                            "gen_loss_L1"}
    assert all(np.isfinite(r["gen_loss"]) for r in rows)
    ckpt = CheckpointManager(str(tmp / "cf"))
    assert ckpt.steps() == [2, 4]
    cfg = tconfig.load_config(str(tmp / "pixflow.yml"))
    tr = PixFlowTrainer(cfg, train_dtype=torch.bfloat16, device="cpu")
    state = ckpt.restore(tr.init_state(seed=5))
    assert state.step == 4
    blob = ckpt.load()
    assert all(torch.equal(v, blob["gen"][k])
               for k, v in state.gen.state_dict().items())
    assert all(v.dtype == torch.float32 for v in blob["gen"].values())


def test_atnet_cli_writes_metrics_and_checkpoints(zoo_trained):
    tmp = zoo_trained
    rows = _rows(tmp / "la" / "atnet_metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert CheckpointManager(str(tmp / "ca")).steps() == [1, 2]


def test_vgnet_cli_alternates_phases(zoo_trained):
    """``--alternative 1``: a D step, then a G step."""
    tmp = zoo_trained
    rows = _rows(tmp / "lv" / "vgnet_metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2]
    assert "discriminator_loss" in rows[0] and "pix_loss" in rows[1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert CheckpointManager(str(tmp / "cv")).steps() == [1, 2]
