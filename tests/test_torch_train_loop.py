"""The training plumbing of the PyTorch port (voicepuppet_torch) against
the JAX package (voicepuppet_tpu), on the CPU: the optimizer against
optax, the data batchers against the JAX generators, event files against
the JAX reader, and the loop and checkpoint semantics of the trainers.

Tolerances: the optimizer within rel 1e-6 of optax (float32 on both
sides, the same order of operations); batches of coefficients, ears,
images and masks equal; the log-mel within the frontend's band of
tests/test_torch_port_units.py (5e-5 on bins above -6); event records
equal.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voicepuppet_tpu.config import TrainingConfig as JTrainingConfig
from voicepuppet_tpu.data import generators as jgen
from voicepuppet_tpu.train import optim as joptim
from voicepuppet_tpu.train.pixrefer_trainer import _hit_interval as j_hit
from voicepuppet_tpu.utils import tb_writer as jtb

from voicepuppet_torch import config as tconfig
from voicepuppet_torch import weights
from voicepuppet_torch.data import generators as tgen
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.train import optim as toptim
from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
from voicepuppet_torch.train.checkpoint import CheckpointManager
from voicepuppet_torch.train.loop import StepLoop
from voicepuppet_torch.train.metrics import MetricsLogger, ProfilerHook
from voicepuppet_torch.train.pixrefer_trainer import _hit_interval
from voicepuppet_torch.utils import tb_writer as ttb

from _torch_port_cases import jax_cfg, port_cfg
from test_data import make_clip, make_panel_clip

torch.set_num_threads(1)

OPT_REL = 1e-6


# ---- config --------------------------------------------------------------------

def test_reference_yaml_loads_like_jax(tmp_path):
    """The reference params.yml schema (top-level dataset keys, a
    ``sample_file`` block, a shared ``training`` block distributed to the
    models except where a model pins the field, per-model overrides)
    loads into the same values as the JAX loader's."""
    from voicepuppet_tpu.config import load_config as jload
    p = tmp_path / "params.yml"
    p.write_text("""
default:
  train_dataset_path: a/train.txt
  root_path: /data
  sample_file: {wav_name: voice.wav, max_sequence_len: 40}
  training: {epochs: 7, learning_rate: 0.5, drop_rate: 0.1,
             max_grad_norm: 20.0, save_interval: 11}
  bfmnet: {batch_size: 6, training: {eval_interval: 3}}
  pixrefer: {ndf: 32, training: {beta1: 0.7}}
""")
    j, t = jload(str(p)), tconfig.load_config(str(p))
    for name in ("dataset", "training", "bfmnet", "pixrefer"):
        got = dataclasses.asdict(getattr(t, name))
        want = dataclasses.asdict(getattr(j, name))
        assert got == {k: want[k] for k in got}, name
    # pinned: BFMNet's lr (1e-4) and PixRefer's beta1 default stay theirs
    assert t.bfmnet.training.learning_rate == 1e-4
    assert t.bfmnet.training.drop_rate == 0.1
    assert t.pixrefer.training.beta1 == 0.7


# ---- optimizer ----------------------------------------------------------------

def _grad_stream(shapes, steps, seed):
    """Seeded gradients whose global norm crosses 1.0 (the clip threshold
    used below) both ways."""
    rng = np.random.RandomState(seed)
    for i in range(steps):
        scale = 0.02 if i % 3 else 0.6
        yield {k: (rng.randn(*s) * scale).astype(np.float32)
               for k, s in shapes.items()}


@pytest.mark.parametrize("which", ["reference_adam", "gan_optimizer"])
def test_optimizer_matches_optax(which):
    """30 steps on seeded gradients crossing staircase boundaries (every
    8 updates; the GAN optimizer halves decay_steps 16 to 8) and, for the
    clipped Adam, the clip threshold: every parameter and both moments
    within rel 1e-6 of optax."""
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    if which == "reference_adam":
        jtx = joptim.reference_adam(1e-2, 8, 0.5, beta1=0.9,
                                    max_grad_norm=1.0)
        make = toptim.reference_adam(1e-2, 8, 0.5, beta1=0.9,
                                     max_grad_norm=1.0)
    else:
        tcfg = JTrainingConfig(learning_rate=3e-2, decay_steps=16,
                               decay_rate=0.5, beta1=0.5)
        jtx = joptim.gan_optimizer(tcfg)
        make = toptim.gan_optimizer(tconfig.TrainingConfig(
            **dataclasses.asdict(tcfg)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make(list(tp.values()))
    clipped = 0
    for g in _grad_stream(shapes, 30, 1):
        clipped += np.sqrt(sum(np.sum(x ** 2) for x in g.values())) > 1.0
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=OPT_REL,
                                       atol=1e-7)
    assert clipped >= 5
    adam = weights._find_adam(jstate)
    assert int(adam.count) == opt.param_groups[0]["count"] == 30
    for m in ("mu", "nu"):
        for k, p in tp.items():
            np.testing.assert_allclose(opt.state[p][m].numpy(),
                                       np.asarray(getattr(adam, m)[k]),
                                       rtol=OPT_REL, atol=1e-12)


def test_gan_schedule_matches_reference_global_step():
    """The reference's shared global_step advances 2 per GAN iteration;
    with decay_steps halved, update N reads lr0 * rate^floor(2N/1000)
    (optim.py:50-63), read at the optimizer's own count."""
    tcfg = tconfig.TrainingConfig(learning_rate=3e-4, decay_steps=1000,
                                  decay_rate=0.999, beta1=0.5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.gan_optimizer(tcfg)([p])
    for n in range(520):
        before = p.detach().clone()
        p.grad = torch.ones(3)
        opt.step()
        if n in (498, 499, 500, 510):
            # steady-state Adam on constant gradients: |update| == lr
            got = float(before[0] - p[0])
            want = 3e-4 * 0.999 ** ((2 * n) // 1000)
            assert got == pytest.approx(want, rel=1e-4), (n, got, want)


def test_adam_state_bridge_round_trip():
    """An optax Adam state carried into the port's ReferenceAdam and back;
    the next step from it equals optax's."""
    net = torch.nn.Sequential()
    net.add_module("Dense_0", torch.nn.Linear(4, 3))
    tree = {"Dense_0": {"kernel": np.random.RandomState(0).randn(4, 3)
                        .astype(np.float32),
                        "bias": np.zeros(3, np.float32)}}
    weights.load_flax_(net, tree)
    jtx = joptim.reference_adam(1e-2, 5, 0.9, max_grad_norm=2.0)
    jstate = jtx.init(tree)
    rng = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        for _ in range(4)]
    jp = tree
    for g in grads[:3]:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    weights.load_flax_(net, jax.tree_util.tree_map(np.asarray, jp))
    opt = toptim.reference_adam(1e-2, 5, 0.9, max_grad_norm=2.0)(
        net.parameters())
    weights.load_adam_state_(opt, net, weights.adam_state_from_optax(jstate))
    back = weights.adam_state_to_flax(opt, net, tree)
    assert back["count"] == 3
    for m in ("mu", "nu"):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
            back[m], getattr(weights._find_adam(jstate), m))
    upd, jstate = jtx.update(grads[3], jstate, jp)
    jp = optax.apply_updates(jp, upd)
    for name, p in net.named_parameters():
        path = tuple(name.replace("weight", "kernel").split("."))
        p.grad = torch.from_numpy(np.ascontiguousarray(weights.convert_leaf(
            path, grads[3][path[0]][path[1]])))
    opt.step()
    got = weights.flax_from_state_dict(net.state_dict(), tree)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                rtol=OPT_REL, atol=1e-7),
        got, jp)


# ---- data ---------------------------------------------------------------------

def test_feature_math_matches_jax():
    rng = np.random.RandomState(0)
    clip = make_clip(rng, frames=40, silence_frames=7)
    np.testing.assert_array_equal(tgen.ear_compute(clip["landmark"]),
                                  jgen.ear_compute(clip["landmark"]))
    np.testing.assert_array_equal(tgen.split_silence(clip["pcm"]),
                                  jgen.split_silence(clip["pcm"]))
    assert tgen.split_silence(np.zeros(100, np.float32)).shape == (0, 2)


def _bfm_clips(seed=2):
    """make_clip's clips with the tone after the leading silence replaced
    by white noise of 0.1 rms, the input the frontend's band was measured
    on (a pure tone leaves most bins near the log floor)."""
    rng = np.random.RandomState(seed)
    clips = []
    for k in range(3):
        clip = make_clip(rng, frames=80 + 13 * k, silence_frames=2 + k)
        loud = clip["pcm"] != 0
        clip["pcm"][loud] = (0.1 * rng.randn(int(loud.sum()))).astype(
            np.float32)
        clips.append(clip)
    return clips


@pytest.mark.parametrize("shuffle", [True, False])
def test_bfmnet_batcher_matches_jax(shuffle):
    """Four batches of 4 from the same seed and clips."""
    jcfg = jax_cfg()
    jcfg = dataclasses.replace(jcfg, dataset=dataclasses.replace(
        jcfg.dataset, shuffle_bufsize=5))
    clips = _bfm_clips()
    jb = iter(jgen.BFMNetBatcher(jcfg, jgen.ArraySource(clips), seed=3,
                                 batch_size=4, shuffle=shuffle))
    tb = iter(tgen.BFMNetBatcher(port_cfg(jcfg), tgen.ArraySource(clips),
                                 seed=3, batch_size=4, shuffle=shuffle,
                                 device="cpu"))
    for _ in range(4):
        want, got = next(jb), next(tb)
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i], want[i])
        mel, want_mel = got[2].numpy(), np.asarray(want[2])
        assert mel.shape == want_mel.shape == (4, 120, 80)
        sel = want_mel > -6.0
        assert sel.mean() > 0.5
        np.testing.assert_allclose(mel[sel], want_mel[sel], atol=5e-5)


def test_pixrefer_batcher_matches_jax():
    """Three batches of 2 from two in-memory panel clips at 64², crop
    augmentation on."""
    jcfg = jax_cfg()
    jcfg = dataclasses.replace(jcfg, pixrefer=dataclasses.replace(
        jcfg.pixrefer, img_size=64))
    rng = np.random.RandomState(4)
    clips = [make_panel_clip(rng, frames=3, size=64) for _ in range(2)]
    jb = iter(jgen.PixReferBatcher(jcfg, jgen.ArraySource(clips), seed=5))
    tb = iter(tgen.PixReferBatcher(port_cfg(jcfg), tgen.ArraySource(clips),
                                   seed=5))
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert len(got) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_file_source_matches_jax(tmp_path):
    """FileSource over a "folder|frame_count" list: the same clip arrays
    (coefficients, landmarks, 16 kHz pcm, image paths)."""
    from PIL import Image
    from scipy.io import wavfile
    rng = np.random.RandomState(6)
    lines = []
    for k in range(2):
        d = tmp_path / f"clip{k}"
        d.mkdir()
        np.savetxt(d / "bfmcoeff.txt", rng.randn(30, 257) * 0.1,
                   fmt="%.5f", delimiter=",")
        np.savetxt(d / "landmark.txt", rng.rand(30, 136) * 140 + 40,
                   fmt="%.3f", delimiter=",")
        wavfile.write(d / "audio.wav", 16000,
                      (rng.randn(30 * 640) * 3000).astype(np.int16))
        Image.fromarray((rng.rand(8, 24, 3) * 255).astype(np.uint8)).save(
            d / "0.jpg")
        lines.append(f"{d}|30")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    jcfg = jax_cfg()
    want = list(jgen.FileSource(str(lst), jcfg, load_images=True))
    got = list(tgen.FileSource(str(lst), port_cfg(jcfg), load_images=True))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]
    import random
    order = [c["frame_count"] for c in tgen._shuffled_pass(
        tgen.FileSource(str(lst), port_cfg(jcfg)), random.Random(1))]
    assert order == [c["frame_count"] for c in jgen._shuffled_pass(
        jgen.FileSource(str(lst), jcfg), random.Random(1))]


def test_background_batches_union_and_termination():
    bg = tgen.BackgroundBatches(lambda i: iter([(i, j) for j in range(5)]),
                                num_workers=3, prefetch=4)
    got = list(bg)
    assert sorted(got) == [(i, j) for i in range(3) for j in range(5)]
    bg.close()


def test_prefetch_to_device_cpu_keeps_order():
    batches = [(np.full((2,), i, np.float32), np.arange(3) + i)
               for i in range(5)]
    out = list(tgen.prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), batches[i][0])
        np.testing.assert_array_equal(b.numpy(), batches[i][1])


# ---- logs ---------------------------------------------------------------------

def _write_events(mod, log_dir):
    w = mod.TBEventWriter(str(log_dir))
    rng = np.random.RandomState(7)
    w.scalar("loss", 1.25, 3)
    w.image("grid", rng.rand(6, 10, 3).astype(np.float32), 4)
    w.histogram("g/gradients", rng.randn(500), 5)
    w.histogram("const", np.full(7, 2.0), 6)
    w.close()
    return w.path


def test_event_file_parses_with_jax_reader(tmp_path):
    """An event file the port writes parses with the JAX reader into the
    same scalar, image (PNG bytes) and histogram records as the JAX
    writer's; the port's reader reads the JAX file the same way."""
    got = jtb.read_events(_write_events(ttb, tmp_path / "t"))
    jpath = _write_events(jtb, tmp_path / "j")
    want = jtb.read_events(jpath)
    assert got == want
    assert ttb.read_events(jpath) == want
    assert [s for s, _ in got] == [0, 3, 4, 5, 6]


def test_event_reader_rejects_corrupt_record(tmp_path):
    path = _write_events(ttb, tmp_path)
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        ttb.read_events(path)


def test_metrics_logger_jsonl_events_images_histograms(tmp_path):
    log = MetricsLogger(str(tmp_path), "t", print_every=0)
    log.log(1, loss=torch.tensor(2.5), grad_norm=np.float32(3.0))
    log.log_image(2, "strip", np.zeros((4, 8, 3), np.float32))
    log.log_histograms(2, {"g": {"w": torch.ones(3),
                                 "bn.bias": torch.ones(2)}},
                       exclude=("bn",))
    log.close()
    rows = [json.loads(x) for x in open(log.path)]
    assert rows[0]["step"] == 1 and rows[0]["loss"] == 2.5
    assert os.path.exists(tmp_path / "images" / "strip_2.jpg")
    ev = glob.glob(str(tmp_path / "tb" / "t" / "events.out.tfevents.*"))
    recs = jtb.read_events(ev[0])
    tags = [t for _, v in recs for t in v]
    assert tags == ["loss", "grad_norm", "strip", "g/w/gradients"]


def test_profiler_hook_writes_a_trace(tmp_path):
    hook = ProfilerHook(str(tmp_path), start_step=1, num_steps=1)
    for step in range(3):
        hook.step(step)
        torch.ones(64).sum()
    hook.close()
    assert hook.path and os.path.getsize(hook.path) > 0


# ---- loop and checkpoint semantics ------------------------------------------

@pytest.fixture(scope="module")
def small():
    jcfg = jax_cfg()
    b = jcfg.bfmnet
    jcfg = dataclasses.replace(jcfg, bfmnet=dataclasses.replace(
        b, batch_size=4, training=dataclasses.replace(
            b.training, drop_rate=0.0, eval_interval=3)))
    return port_cfg(jcfg), tbfm.synthetic_bfm(num_theta=10, num_phi=10,
                                              seed=0)


def _stream(seed, t=8, b=4):
    rng = np.random.RandomState(seed)
    while True:
        yield (rng.randn(b, t, 257).astype(np.float32) * 0.1,
               rng.rand(b, t, 1).astype(np.float32) * 0.1,
               rng.randn(b, t * 5, 80).astype(np.float32),
               np.full((b,), t, np.int32))


def test_checkpoint_roundtrip(small, tmp_path):
    cfg, fm = small
    tr = BFMNetTrainer(cfg, fm, device="cpu")
    state = tr.init_state()
    state, _ = tr.train_step(state, next(_stream(0)))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                             save_interval=1)
    ckpt.save(5, state)
    assert ckpt.latest_step() == 5
    other = ckpt.restore(tr.init_state(seed=99))
    assert other.step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(sa["state"][i][m], sb["state"][i][m])


def test_checkpoint_restore_without_any_is_noop(small, tmp_path):
    cfg, fm = small
    state = BFMNetTrainer(cfg, fm, device="cpu").init_state()
    restored = CheckpointManager(str(tmp_path / "empty"), 2, 1).restore(state)
    assert restored is state


def test_checkpoint_cadence_and_max_to_keep(small, tmp_path):
    """fit saves at the exact multiples of the interval and the manager
    keeps the newest ``max_to_keep``."""
    cfg, fm = small
    tr = BFMNetTrainer(cfg, fm, device="cpu")
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval=3)
    saved, save = [], ckpt.save
    ckpt.save = lambda step, state: (saved.append(step), save(step, state))
    state = tr.fit(tr.init_state(), _stream(0), 13, ckpt=ckpt)
    assert state.step == 13
    assert saved == [3, 6, 9, 12]
    assert ckpt.steps() == [9, 12]


@pytest.mark.parametrize("stride", [1, 2])
def test_step_loop_rows_cadence_and_dropout_stream(stride):
    """``StepLoop.fit`` (the PixFlow, ATNet and VGNet loop): one metrics
    row per step at the step reached, a save at each exact multiple of the
    interval (the D+G trainers stride by 2), the profiler stepped before
    each step and closed, and one dropout generator seeded with 0 carried
    across the steps."""

    class Trainer(StepLoop):
        device = torch.device("cpu")

        def train_step(self, state, batch, generator):
            state.draws.append(float(torch.rand(1, generator=generator)))
            state.step += stride
            return state, {"loss": torch.tensor(float(batch))}

    class State:
        step, draws = 0, []

    class Ckpt:
        save_interval, saved = 4, []

        def save(self, step, state):
            self.saved.append(step)

    class Rows:
        def __init__(self):
            self.rows = []

        def log(self, step, **kw):
            self.rows.append((step, float(kw["loss"])))

    class Profiler:
        seen, closed = [], False

        def step(self, step, k=1):
            self.seen.append(step)

        def close(self):
            self.closed = True

    state, rows, ckpt, prof = State(), Rows(), Ckpt(), Profiler()
    state.draws = []
    out = Trainer().fit(state, iter(range(10, 16)), 6, rows, ckpt, prof)
    assert out.step == 6 * stride
    assert rows.rows == [(stride * (i + 1), 10.0 + i) for i in range(6)]
    assert ckpt.saved == [s for s in range(stride, 6 * stride + 1, stride)
                          if s % 4 == 0]
    assert prof.seen == [stride * i for i in range(6)] and prof.closed
    g = torch.Generator().manual_seed(0)
    assert state.draws == [float(torch.rand(1, generator=g))
                           for _ in range(6)]


@pytest.mark.parametrize("stride,kk,interval", [
    (2, 1, 4), (2, 3, 4), (2, 2, 25), (2, 4, 6), (1, 3, 5), (2, 1, 1)])
def test_hit_interval_matches_jax(stride, kk, interval):
    for step in range(0, 60, stride):
        assert _hit_interval(step, stride, kk, interval) == j_hit(
            step, stride, kk, interval)


def test_multi_step_matches_sequential(small):
    """K steps in one train_multi_step call equal K train_step calls: the
    same ops in the same order, so equal to the bit on the CPU."""
    cfg, fm = small
    sgd = lambda p: torch.optim.SGD(p, lr=1e-3)
    tr = BFMNetTrainer(cfg, fm, device="cpu", tx=sgd)
    batches = [b for b, _ in zip(_stream(1), range(3))]
    s_seq, s_multi = tr.init_state(), tr.init_state()
    losses = [float(tr.train_step(s_seq, b)[1]["loss"]) for b in batches]
    s_multi, stacked = tr.train_multi_step(s_multi, batches)
    assert s_multi.step == s_seq.step == 3
    assert stacked["loss"].shape == (3,)
    assert stacked["loss"].tolist() == losses
    for a, b in zip(s_seq.model.state_dict().values(),
                    s_multi.model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 2])
def test_fit_steps_per_call_logs_every_step(small, tmp_path, k):
    """fit logs one row per step for any K, with a tail call shorter than
    K; eval (interval 3) and checkpoints (interval 2) fire on interval
    crossings, at most once per call."""
    cfg, fm = small
    tr = BFMNetTrainer(cfg, fm, device="cpu")
    rows, evals = [], []

    class Log:
        def log(self, step, **kw):
            rows.append((step, {n: float(v) for n, v in kw.items()}))

    ckpt = CheckpointManager(str(tmp_path / "c"), 10, save_interval=2)
    state = tr.fit(tr.init_state(), _stream(2), 5, eval_batches=_stream(3),
                   logger=Log(), ckpt=ckpt, steps_per_call=k,
                   eval_hook=lambda step, *a: evals.append(step))
    assert state.step == 5
    train_rows = [r for r in rows if "loss" in r[1]]
    assert [r[0] for r in train_rows] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(list(r[1].values())).all() for r in rows)
    want_eval = [3] if k == 1 else [4]
    assert evals == want_eval
    assert [r[0] for r in rows if "eval_loss" in r[1]] == want_eval
    assert ckpt.steps() == [2, 4]


# ---- the profiler window and the gradient histograms ---------------------------

@pytest.mark.parametrize("calls,k", [((0, 4, 8), 4), ((0, 1, 2, 3), 1),
                                     ((0, 2, 4), 2)])
def test_profiler_hook_window_inside_a_dispatch(tmp_path, calls, k):
    """A window [2, 3) that lies inside one dispatch of K = 4 steps
    (step() at 0, 4, 8) is traced: the trace opens at the dispatch that
    overlaps it and closes at the first one past it.  (The JAX hook
    writes nothing here: it compares the dispatch's first step only.)"""
    hook = ProfilerHook(str(tmp_path), start_step=2, num_steps=1)
    for step in calls:
        hook.step(step, k)
        torch.ones(64).sum()
    assert hook.path == str(tmp_path / "trace_2.json")
    assert os.path.getsize(hook.path) > 0


@pytest.mark.parametrize("loop", ["step_loop", "bfmnet"])
def test_profiler_trace_written_when_fit_raises(small, tmp_path, loop):
    """A fit that raises still closes its profiler and writes the
    trace."""

    def failing(batches):
        yield next(batches)
        raise RuntimeError("data source failed")

    hook = ProfilerHook(str(tmp_path), start_step=0, num_steps=10)
    if loop == "bfmnet":
        cfg, fm = small
        tr = BFMNetTrainer(cfg, fm, device="cpu")
        with pytest.raises(RuntimeError, match="data source"):
            tr.fit(tr.init_state(), failing(_stream(0)), 3, profiler=hook)
    else:
        class Trainer(StepLoop):
            device = torch.device("cpu")

            def train_step(self, state, batch, generator):
                state.step += 1
                return state, {"loss": torch.tensor(float(batch))}

        class State:
            step = 0

        with pytest.raises(RuntimeError, match="data source"):
            Trainer().fit(State(), failing(iter(range(5))), 3,
                          profiler=hook)
    assert hook.path == str(tmp_path / "trace_0.json")
    assert os.path.getsize(hook.path) > 0


def _jax_tags(group, tree, exclude=()):
    """{tag: leaf size} of the JAX fits' gradient histograms over a params
    tree (``voicepuppet_tpu/train/metrics.py`` log_histograms)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        parts = [str(getattr(p, "key", getattr(p, "name", p)))
                 for p in path]
        tag = "/".join([group] + parts)
        if not any(e in tag for e in exclude):
            out[tag + "/gradients"] = int(np.prod(leaf.shape))
    return out


def _histograms(log_dir, name):
    """{step: {tag: element count}} of the histograms in ``log_dir``'s
    event files."""
    out = {}
    for path in glob.glob(os.path.join(str(log_dir), "tb", name,
                                       "events.out.tfevents.*")):
        for step, values in ttb.read_events(path):
            for tag, v in values.items():
                if tag.endswith("/gradients"):
                    out.setdefault(step, {})[tag] = int(v["num"])
    return out


def _atnet_case():
    from voicepuppet_tpu.models import atnet as jat
    from _torch_port_cases import DP_WIDTH
    jcfg = jax_cfg()
    comp = jat.synthetic_pca_component(6)
    b, t = 2, 4
    rng = np.random.RandomState(3)
    batch = (rng.randn(b, t, 136).astype(np.float32) * 0.1,
             rng.rand(b, t, 1).astype(np.float32),
             rng.randn(b, t, 3).astype(np.float32) * 0.1,
             rng.randn(b, t * 5, 80).astype(np.float32),
             rng.randn(b, 136).astype(np.float32) * 0.1,
             np.array([t, 3], np.int32))
    shapes = jax.eval_shape(lambda: jat.ATNet(
        jcfg.atnet, comp, width_mult=DP_WIDTH).init(
            jax.random.PRNGKey(0), *(jnp.asarray(x) for x in batch[1:]),
            train=False))
    return jcfg, comp, batch, _jax_tags("atnet", shapes["params"],
                                        ("BatchNorm", "bn"))


def _pixflow_case():
    from voicepuppet_tpu.models import pixflow as jpf
    from voicepuppet_tpu.models import pixrefer as jpx
    jcfg = jax_cfg()
    s, b = jcfg.pixflow.img_size, jcfg.pixflow.batch_size
    rng = np.random.RandomState(4)
    batch = (rng.rand(b, s, s, 6).astype(np.float32),
             rng.rand(b, s, s, 6).astype(np.float32),
             (rng.rand(b, s, s, 3) > 0.5).astype(np.float32))
    key = jax.random.PRNGKey(0)
    g = jax.eval_shape(lambda: jpf.PixFlowNet(jcfg.pixflow, axis_name=None)
                       .init({"params": key, "dropout": key},
                             jnp.zeros((1, s, s, 6)),
                             jnp.zeros((1, s, s, 6)), train=False))
    d = jax.eval_shape(lambda: jpx.Discriminator(jcfg.pixflow.ndf).init(
        key, jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3))))
    return jcfg, batch, {**_jax_tags("discriminator", d["params"]),
                         **_jax_tags("generator", g["params"])}


def _fit_with_histograms(name, log_dir, interval, steps=1):
    """A tiny ``name`` fit of ``steps`` steps on the CPU with a logger at
    ``interval``; returns (its histograms, the JAX fit's {tag: size})."""
    logger = MetricsLogger(str(log_dir), name, print_every=0,
                           histogram_interval=interval)
    if name == "atnet":
        from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
        from _torch_port_cases import DP_WIDTH
        jcfg, comp, batch, want = _atnet_case()
        tr = ATNetTrainer(port_cfg(jcfg), comp, width_mult=DP_WIDTH,
                          device="cpu")
    else:
        from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
        jcfg, batch, want = _pixflow_case()
        tr = PixFlowTrainer(port_cfg(jcfg), device="cpu")
    tr.fit(tr.init_state(), iter([batch] * steps), steps, logger)
    logger.close()
    return _histograms(log_dir, name), want, tr.step_stride


@pytest.mark.parametrize("name", ["pixflow", "atnet"])
def test_fit_gradient_histograms_match_the_jax_tags(tmp_path, name):
    """At interval 1 a PixFlow fit (D and G trees) and an ATNet fit (its
    batch norms left out) write one histogram per gradient leaf of the
    JAX fit's trees: the same tags, taken from the JAX parameter trees by
    ``jax.eval_shape`` with no compile, and each histogram's element
    count the JAX leaf's size."""
    got, want, stride = _fit_with_histograms(name, tmp_path, 1)
    assert list(got) == [stride]
    assert got[stride] == want
    if name == "atnet":
        assert not any("bn" in t or "BatchNorm" in t for t in got[stride])


@pytest.mark.parametrize("name", ["pixflow", "atnet"])
def test_fit_gradient_histograms_off_cadence(tmp_path, name, monkeypatch):
    """Interval 3 and one step: no step on the cadence, no histogram, and
    the gradients are not gathered at all."""
    from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    gathered = []
    for cls in (ATNetTrainer, PixFlowTrainer):
        monkeypatch.setattr(
            cls, "gradient_groups",
            lambda self, state, _f=cls.gradient_groups: (
                gathered.append(state.step), _f(self, state))[1])
    got, _, _ = _fit_with_histograms(name, tmp_path, 3)
    assert got == {} and gathered == []
    # the scalars are still written
    assert glob.glob(str(tmp_path / "tb" / name / "events.out.tfevents.*"))


def test_fit_gradient_histograms_rank_zero_alone(tmp_path):
    """Two gloo ranks of an ATNet fit, each with a logger: rank 0 writes
    the averaged gradients' histograms with the JAX tags, rank 1 nothing;
    both ranks hold the same averaged gradients."""
    from voicepuppet_torch.parallel.spawn import run_ranks
    from _torch_port_cases import histogram_rank
    jcfg, comp, batch, want = _atnet_case()
    ranks = run_ranks(histogram_rank, 2, port_cfg(jcfg), comp, batch,
                      str(tmp_path))
    assert np.array_equal(ranks[0], ranks[1])
    assert _histograms(tmp_path / "rank0", "atnet") == {1: want}
    assert _histograms(tmp_path / "rank1", "atnet") == {}
