"""The legacy ATVGNet subsystem and ThinResnet in the PyTorch port
(voicepuppet_torch/models/atnet.py, vgnet.py, backbone.py, layers.ThinNet,
train/atnet_trainer.py, vgnet_trainer.py, the ATVGNet, Pix2Pix and
Audio2Exp streams of data/generators.py, the ATVGNet plots of
utils/viz.py) against the JAX package, both on the CPU, with the same
parameters (``weights.state_dict_from_flax``) and numpy-seeded inputs.

Sizes: ATNet 64-wide with its trunk at width-mult 0.25, B 2, T 4; VGNet
at 32², B 2, T 4 (its GRU is 512 filters and its encoders reach 512
channels at any size).  Dropout masks cannot match across frameworks:
ATNet runs with ``drop_rate`` 0 on both sides; for VGNet's D (0.25 in
training) the JAX D of the step runs with ``train=False`` (it holds no BN,
so only the dropout goes) and the port's at rate 0.

Tolerances: forwards within 1e-5 (measured <= 5.3e-6, ThinNet); losses
within rel 1e-5; one SGD step's parameter updates within 1e-3 of each
leaf's largest (measured <= 1.6e-4 for ATNet and VGNet's G, 6.2e-5 for
VGNet's D); leaves whose JAX update is below 1e-4 of the learning rate
have a true gradient of zero (a bias or BN offset whose channel shift a
later batch-moment BN removes) and both sides' |g| is held under 1e-4
there; running BN moments within 1e-6 (float32 storage of values near
1); the numpy helpers, streams and plots equal to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from voicepuppet_tpu.data import generators as jgen
from voicepuppet_tpu.models import atnet as jat
from voicepuppet_tpu.models import backbone as jbb
from voicepuppet_tpu.models import layers as jl
from voicepuppet_tpu.models import vgnet as jvg
from voicepuppet_tpu.parallel.mesh import make_mesh
from voicepuppet_tpu.train.atnet_trainer import ATNetTrainer as JATrainer
from voicepuppet_tpu.train.state import GANTrainState as JGState
from voicepuppet_tpu.train.state import TrainState as JState
from voicepuppet_tpu.train.vgnet_trainer import VGNetTrainer as JVGTrainer
from voicepuppet_tpu.utils import viz as jviz

from voicepuppet_torch import weights
from voicepuppet_torch.data import generators as tgen
from voicepuppet_torch.models import atnet as tat
from voicepuppet_torch.models import backbone as tbb
from voicepuppet_torch.models import layers as tl
from voicepuppet_torch.models import vgnet as tvg
from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
from voicepuppet_torch.train.vgnet_trainer import VGNetTrainer
from voicepuppet_torch.utils import viz as tviz

from _torch_port_cases import jax_cfg, numpy_tree, port_cfg

torch.set_num_threads(1)

B, T, S = 2, 4, 32
WIDTH = 0.25
LR = 0.1
FWD_ATOL = 1e-5
LOSS_REL = 1e-5
UPDATE_BAND = 1e-3
NULL_GRAD = 1e-4
MOMENT_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().numpy()


def _no_dropout(cfg):
    a = cfg.atnet
    return dataclasses.replace(cfg, atnet=dataclasses.replace(
        a, training=dataclasses.replace(a.training, drop_rate=0.0)))


@pytest.fixture(scope="module")
def cfgs():
    jcfg = _no_dropout(jax_cfg())
    return jcfg, port_cfg(jcfg)


@pytest.fixture(scope="module")
def component():
    return jat.synthetic_pca_component(6)


def _atnet_batch(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 136).astype(np.float32) * 0.1,
            rng.rand(B, T, 1).astype(np.float32),
            rng.randn(B, T, 3).astype(np.float32) * 0.1,
            rng.randn(B, T * 5, 80).astype(np.float32),
            rng.randn(B, 136).astype(np.float32) * 0.1,
            np.array([T, 3], np.int32))


def _vgnet_batch(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 136).astype(np.float32) * 0.1,
            rng.rand(B, T, S, S, 1).astype(np.float32),
            rng.rand(B, T, S, S, 3).astype(np.float32),
            rng.randn(B, 136).astype(np.float32) * 0.1,
            rng.rand(B, S, S, 3).astype(np.float32),
            np.array([T, 3], np.int32))


@pytest.fixture(scope="module")
def atnet_tree(cfgs, component):
    jcfg, _ = cfgs
    b = _atnet_batch()
    return numpy_tree(jat.ATNet(jcfg.atnet, component, width_mult=WIDTH),
                      *b[1:], train=False, seed=1)


@pytest.mark.parametrize("train", [False, True])
def test_atnet_forward_matches_jax(cfgs, component, atnet_tree, train):
    """Inference (running moments) and training (batch moments) mode."""
    jcfg, pcfg = cfgs
    b = _atnet_batch(5)
    model = jat.ATNet(jcfg.atnet, component, width_mult=WIDTH)
    if train:
        want, _ = model.apply(atnet_tree, *b[1:], train=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
    else:
        want = model.apply(atnet_tree, *b[1:], train=False)
    net = weights.load_flax_(tat.ATNet(pcfg.atnet, component, WIDTH),
                             atnet_tree)
    got = net(*map(_t, b[1:]), train=train)
    assert got.shape == want.shape == (B, T, 136)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


def test_atnet_loss_matches_jax():
    rng = np.random.RandomState(6)
    pred, target = (rng.randn(B, T, 136).astype(np.float32)
                    for _ in range(2))
    seq_len = np.array([T, 2], np.int32)
    want = float(jat.atnet_loss(pred, target, seq_len))
    got = float(tat.atnet_loss(_t(pred), _t(target), _t(seq_len)))
    assert abs(got / want - 1) < LOSS_REL
    np.testing.assert_array_equal(tat.synthetic_pca_component(6),
                                  jat.synthetic_pca_component(6))


def test_thinresnet_matches_jax():
    x = np.random.RandomState(7).randn(2, 32, 16, 1).astype(np.float32)
    tree = numpy_tree(jbb.ThinResnet(64), x, train=False, seed=2)
    want = jbb.ThinResnet(64).apply(tree, x, train=False)
    got = weights.load_flax_(tbb.ThinResnet(1, 64), tree)(_t(x))
    assert got.shape == want.shape == (2, 4, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("stem_stride", [(1, 1), (2, 2)])
def test_thinnet_matches_jax(stem_stride):
    x = np.random.RandomState(8).randn(2, 8, 8, 16).astype(np.float32)
    m = jl.ThinNet(32, activation=jax.nn.elu, width_mult=WIDTH,
                   stem_stride=stem_stride)
    tree = numpy_tree(m, x, train=False, seed=3)
    want = m.apply(tree, x, train=False)
    net = weights.load_flax_(tl.ThinNet(16, 32, F.elu, WIDTH, stem_stride),
                             tree)
    got = net(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


@pytest.fixture(scope="module")
def vgnet_trees(cfgs):
    jcfg, _ = cfgs
    b = _vgnet_batch()
    g = numpy_tree(jvg.VGNetGenerator(jcfg.vgnet), b[4], b[0], b[3], b[5],
                   train=False, seed=4)
    d = numpy_tree(jvg.VGNetDiscriminator(jcfg.vgnet), b[2], b[3], b[5],
                   train=False, seed=5)
    return g, d


def test_vgnet_generator_matches_jax(cfgs, vgnet_trees):
    jcfg, pcfg = cfgs
    b = _vgnet_batch(9)
    args = (b[4], b[0], b[3], b[5])
    want = jvg.VGNetGenerator(jcfg.vgnet).apply(vgnet_trees[0], *args,
                                                train=False)
    gen = weights.load_flax_(tvg.VGNetGenerator(pcfg.vgnet), vgnet_trees[0])
    got = gen(*map(_t, args))
    for a, w, c in zip(got, want, (3, 1, 3)):
        assert a.shape == w.shape == (B, T, S, S, c)
        np.testing.assert_allclose(_np(a), np.asarray(w), rtol=0,
                                   atol=FWD_ATOL)


def test_vgnet_discriminator_matches_jax(cfgs, vgnet_trees):
    jcfg, pcfg = cfgs
    b = _vgnet_batch(10)
    args = (b[2], b[3], b[5])
    want = jvg.VGNetDiscriminator(jcfg.vgnet).apply(vgnet_trees[1], *args,
                                                    train=False)
    disc = weights.load_flax_(tvg.VGNetDiscriminator(pcfg.vgnet),
                              vgnet_trees[1])
    got = disc(*map(_t, args))
    assert got[0].shape == (B,) and got[1].shape == (B, T, 136)
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), rtol=0,
                                   atol=FWD_ATOL)


def test_conv_gru_masks_past_seq_len_and_reads_the_scan_scope():
    """``Conv2dGRU`` against the JAX scan: the cell's parameters sit under
    the scan's own scope (read off the JAX tree, not guessed), outputs
    past each row's ``seq_len`` are zero before the BN, and the port's
    Python loop gives the scan's values."""
    rng = np.random.RandomState(11)
    x = rng.randn(B, T, 4, 4, 8).astype(np.float32)
    seq_len = np.array([T, 2], np.int32)
    m = jvg.Conv2dGRU(16)
    tree = numpy_tree(m, x, seq_len, False, seed=6)
    cell_scope = [k for k in tree["params"] if k != "TFBatchNorm_0"]
    assert cell_scope == ["ScanConv2dGRUCell_0"]
    assert set(tree["params"][cell_scope[0]]) == {
        "gates", "candidate", "bn_r", "bn_u", "bn_c"}
    assert set(tree["params"][cell_scope[0]]["bn_r"]) == {"bias"}
    want = m.apply(tree, x, seq_len, False)
    net = weights.load_flax_(tvg.Conv2dGRU(8, 16), tree)
    got = net(_t(x).permute(0, 1, 4, 2, 3), _t(seq_len)).permute(
        0, 1, 3, 4, 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    # zero rows before the BN: after it, each masked frame is the constant
    # elu(BN(0)) of its channel
    bn = net.TFBatchNorm_0
    zero = F.elu((0 - bn.running_mean) * torch.rsqrt(bn.running_var + 1e-3)
                 + bn.bias)
    np.testing.assert_allclose(_np(got[1, 2:]),
                               np.broadcast_to(_np(zero), (2, 4, 4, 16)),
                               atol=1e-6)


def test_stateless_center_bn_takes_biased_moments():
    x = np.random.RandomState(12).randn(3, 5, 6, 7).astype(np.float32) * 3
    m = jvg.StatelessCenterBN()
    tree = {"params": {"bias": np.linspace(-1, 1, 7).astype(np.float32)}}
    want = m.apply(tree, x)
    bn = tvg.StatelessCenterBN(7)
    bn.load_state_dict({"bias": _t(tree["params"]["bias"])})
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


def test_vgnet_losses_match_jax():
    rng = np.random.RandomState(13)
    rs, fs = (rng.uniform(0.05, 0.95, (B,)).astype(np.float32)
              for _ in range(2))
    rl, fl, lmk = (rng.randn(B, T, 136).astype(np.float32) * 0.1
                   for _ in range(3))
    fake, real = (rng.rand(B, T, 8, 8, 3).astype(np.float32)
                  for _ in range(2))
    mask = rng.rand(B, T, 8, 8, 1).astype(np.float32)
    att = rng.rand(B, T, 8, 8, 1).astype(np.float32)
    seq_len = np.array([T, 3], np.int32)
    want = float(jvg.vgnet_discriminator_loss(rs, rl, fs, fl, lmk, seq_len))
    got = float(tvg.vgnet_discriminator_loss(*map(_t, (rs, rl, fs, fl, lmk,
                                                       seq_len))))
    assert abs(got / want - 1) < LOSS_REL
    jw = jvg.vgnet_generator_loss(fs, fl, fake, att, lmk, mask, real,
                                  seq_len)
    att_t = _t(att).requires_grad_(True)
    tw = tvg.vgnet_generator_loss(_t(fs), _t(fl), _t(fake), att_t, _t(lmk),
                                  _t(mask), _t(real), _t(seq_len))
    for a, b in zip(tw, jw):
        assert abs(float(a) / float(b) - 1) < LOSS_REL
    # the attention is a constant in the pixel weight
    assert not tw[0].requires_grad


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _check_updates(module, before_tree, after_tree):
    before = weights.state_dict_from_flax(before_tree)
    after = weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, after_tree))
    own = module.state_dict()
    assert set(own) == set(after)
    bad, nulls = [], 0
    for k in own:
        if k.endswith(("running_mean", "running_var")):
            err = float((own[k] - after[k]).abs().max())
            if not err < MOMENT_ATOL:
                bad.append((k, "moment", err))
            continue
        want = (after[k] - before[k]).numpy()
        got = (own[k] - before[k]).numpy()
        scale = np.abs(want).max()
        if scale / LR < NULL_GRAD:
            nulls += 1
            if not np.abs(got).max() / LR < NULL_GRAD:
                bad.append((k, "null", np.abs(got).max() / LR))
        elif not np.abs(got - want).max() / scale < UPDATE_BAND:
            bad.append((k, np.abs(got - want).max() / scale))
    assert not bad, bad[:5]
    return nulls


def test_atnet_step_matches_jax(cfgs, component, atnet_tree):
    jcfg, pcfg = cfgs
    batch = _atnet_batch(14)
    jt = JATrainer(jcfg, component, mesh=make_mesh(jax.devices()[:1]),
                   width_mult=WIDTH)
    s1, metrics = jt.train_step(
        JState.create(atnet_tree["params"], atnet_tree["batch_stats"],
                      optax.sgd(LR)), batch, jax.random.PRNGKey(0),
        log_gradients=False)
    tr = ATNetTrainer(pcfg, component, width_mult=WIDTH, tx=_sgd,
                      device="cpu")
    state = tr.init_state()
    weights.load_flax_(state.model, atnet_tree)
    state, got = tr.train_step(state, batch)
    assert abs(float(got["loss"]) / float(metrics["loss"]) - 1) < LOSS_REL
    assert state.step == int(s1.step) == 1
    _check_updates(state.model, atnet_tree,
                   {"params": s1.params, "batch_stats": s1.batch_stats})


class _NoDropout:
    """The JAX VGNet D of the step with ``train=False`` (no BN: only its
    GRU's dropout goes)."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, train=True, rngs=None, **kw):
        return self.module.apply(variables, *args, train=False, **kw)


@pytest.fixture(scope="module")
def vgnet_steps(cfgs, vgnet_trees):
    """A D step then a G step (``alternative`` 1) on both sides."""
    jcfg, pcfg = cfgs
    g, d = vgnet_trees
    batch = _vgnet_batch(15)
    jt = JVGTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]), alternative=1)
    jt.disc = _NoDropout(jt.disc)
    s0 = JGState.create(g["params"], d["params"],
                        batch_stats={"g": g["batch_stats"], "d": {}},
                        g_tx=optax.sgd(LR), d_tx=optax.sgd(LR))
    s1, m1 = jt.train_step(s0, batch, jax.random.PRNGKey(0))
    s2, m2 = jt.train_step(s1, batch, jax.random.PRNGKey(1))
    tr = VGNetTrainer(pcfg, alternative=1, g_tx=_sgd, d_tx=_sgd,
                      device="cpu")
    state = tr.init_state()
    weights.load_flax_(state.gen, g)
    weights.load_flax_(state.disc, d)
    state.disc.dis_rnn.drop_rate = 0.0
    assert tr.is_d_phase(0) and not tr.is_d_phase(1)
    state, n1 = tr.train_step(state, batch)
    state, n2 = tr.train_step(state, batch)
    return dict(state=state, want={**m1, **m2}, got={**n1, **n2}, s2=s2,
                g=g, d=d)


@pytest.mark.parametrize("term", ["discriminator_loss", "generator_loss",
                                  "bce_loss", "pix_loss"])
def test_vgnet_step_losses_match_jax(vgnet_steps, term):
    got, want = vgnet_steps["got"][term], vgnet_steps["want"][term]
    assert abs(float(got) / float(want) - 1) < LOSS_REL


def test_vgnet_d_and_g_steps_match_jax(vgnet_steps):
    st = vgnet_steps
    assert st["state"].step == int(st["s2"].step) == 2
    nulls = _check_updates(st["state"].disc, st["d"],
                           {"params": st["s2"].d_params})
    nulls += _check_updates(st["state"].gen, st["g"],
                            {"params": st["s2"].g_params,
                             "batch_stats": st["s2"].batch_stats["g"]})
    assert nulls > 0


def test_vgnet_phases_leave_the_other_network_alone(cfgs):
    """With the reference Adams and ``alternative`` 2: the D steps leave
    G's parameters and Adam state untouched (G's BN running moments move:
    G runs in training mode), the G steps D's."""
    _, pcfg = cfgs
    tr = VGNetTrainer(pcfg, alternative=2, device="cpu")
    state = tr.init_state(seed=3)
    batch = _vgnet_batch(16)
    moments = ("running_mean", "running_var")

    def snap():
        return ({k: v.clone() for k, v in state.gen.state_dict().items()},
                {k: v.clone() for k, v in state.disc.state_dict().items()},
                {id(p): {n: t.clone() for n, t in s.items()}
                 for p, s in state.g_optimizer.state.items()},
                {id(p): {n: t.clone() for n, t in s.items()}
                 for p, s in state.d_optimizer.state.items()})

    def same(a, b, skip=()):
        return set(a) == set(b) and all(
            torch.equal(v, b[k]) if isinstance(v, torch.Tensor)
            else same(v, b[k]) for k, v in a.items()
            if not (isinstance(k, str) and k.endswith(skip)))

    g0, d0, go0, do0 = snap()
    for _ in range(2):
        state, m = tr.train_step(state, batch)
        assert set(m) == {"discriminator_loss"}
    g1, d1, go1, do1 = snap()
    assert same(g0, g1, moments) and not same(g0, g1) and go1 == go0 == {}
    assert not same(d0, d1) and len(do1) == len(list(
        state.disc.parameters()))
    for _ in range(2):
        state, m = tr.train_step(state, batch)
        assert set(m) == {"generator_loss", "bce_loss", "pix_loss"}
    g2, d2, go2, do2 = snap()
    assert same(d1, d2) and same(do1, do2)
    assert not same(g1, g2, moments) and len(go2) == len(list(
        state.gen.parameters()))
    assert state.step == 4 and tr.is_d_phase(4)


# ---- numpy helpers, streams and plots ---------------------------------------

def _landmarks(rng, n, size=224):
    """68-point landmarks on a face-shaped ring in pixels."""
    ang = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    base = np.stack([size / 2 + size / 3 * np.cos(ang),
                     size / 2 + size / 2.5 * np.sin(ang)], -1)
    return (base[None] + rng.randn(n, 68, 2) * 3).reshape(n, 136).astype(
        np.float32)


def test_pca_hull_and_face_mask_equal_jax(component):
    rng = np.random.RandomState(16)
    lmk = rng.randn(10, 136)
    mean = lmk.mean(0)
    np.testing.assert_array_equal(tgen.pca_renorm(lmk, mean, component.T),
                                  jgen.pca_renorm(lmk, mean, component.T))
    pts = rng.rand(40, 2) * 50
    np.testing.assert_array_equal(tgen.convex_hull(pts),
                                  jgen.convex_hull(pts))
    for lm, size in ((_landmarks(rng, 1)[0], 224),
                     (_landmarks(rng, 1, 1.0)[0], 64)):
        got = tgen.face_region_mask(lm, size)
        want = jgen.face_region_mask(lm, size)
        assert got.dtype == want.dtype and got.max() > 0
        assert got.tobytes() == want.tobytes()


def _clips(rng, n_clips=2, frames=30, img=S):
    out = []
    for k in range(n_clips):
        n = frames + 5 * k
        out.append({"bfmcoeff": rng.randn(n, 257).astype(np.float32) * 0.1,
                    "landmark": _landmarks(rng, n),
                    "pcm": rng.randn(n * 640).astype(np.float32) * 0.1,
                    "images": rng.rand(n, img, 3 * img, 3).astype(
                        np.float32)})
    return out


def _same_batches(a, b, n):
    count = 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u = u.numpy() if isinstance(u, torch.Tensor) else u
            v = np.asarray(v)
            assert u.shape == v.shape
            yield u, v
        count += 1
        if count == n:
            break
    assert count == n


def test_atnet_stream_matches_jax(cfgs, component):
    """The same batches from a seed; the log-mel (float32 on each side's
    own frontend) within 1e-4, all else equal."""
    jcfg, pcfg = cfgs
    rng = np.random.RandomState(17)
    clips = _clips(rng)
    mean = _landmarks(rng, 1)[0] / 224.0
    want = jgen.ATNetBatcher(jcfg, jgen.ArraySource(clips), mean,
                             component.T, seed=2, batch_size=2)
    got = tgen.ATNetBatcher(pcfg, tgen.ArraySource(clips), mean,
                            component.T, seed=2, batch_size=2, device="cpu")
    k = 0
    for u, v in _same_batches(got, want, 2):
        if k % 6 == 3:
            np.testing.assert_allclose(u, v, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(u, v)
        k += 1


def test_vgnet_stream_matches_jax(cfgs, component):
    jcfg, pcfg = cfgs
    rng = np.random.RandomState(18)
    clips = _clips(rng)
    mean = np.zeros((136,), np.float32)
    want = jgen.VGNetBatcher(jcfg, jgen.ArraySource(
        [dict(c, images=c["images"][:, :, :S]) for c in clips]), mean,
        component.T, seed=1, batch_size=2)
    got = tgen.VGNetBatcher(pcfg, tgen.ArraySource(
        [dict(c, images=c["images"][:, :, :S]) for c in clips]), mean,
        component.T, seed=1, batch_size=2)
    for u, v in _same_batches(got, want, 2):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def test_pix2pix_stream_matches_jax(cfgs):
    jcfg, pcfg = cfgs
    rng = np.random.RandomState(19)
    s = 16
    cfg_j = dataclasses.replace(jcfg, pixrefer=dataclasses.replace(
        jcfg.pixrefer, img_size=s))
    cfg_t = dataclasses.replace(pcfg, pixrefer=dataclasses.replace(
        pcfg.pixrefer, img_size=s))
    clips = [{"images": rng.rand(20, s, 3 * s, 3).astype(np.float32)}
             for _ in range(2)]
    want = jgen.Pix2PixBatcher(cfg_j, jgen.ArraySource(clips), seed=4)
    got = tgen.Pix2PixBatcher(cfg_t, tgen.ArraySource(clips), seed=4)
    for u, v in _same_batches(got, want, 3):
        np.testing.assert_array_equal(u, v)


def test_audio2exp_stream_and_feature_helpers_match_jax(cfgs):
    jcfg, pcfg = cfgs
    rng = np.random.RandomState(20)
    clips = _clips(rng, frames=50)
    speech = lambda pcm, sr: np.abs(np.fft.rfft(
        pcm[:(len(pcm) // 320) * 320].reshape(-1, 320), axis=-1))[:, :29]
    want = iter(jgen.Audio2ExpSampleStream(jcfg, jgen.ArraySource(clips),
                                           speech, seed=5))
    got = iter(tgen.Audio2ExpSampleStream(pcfg, tgen.ArraySource(clips),
                                          speech, seed=5))
    for _ in range(3):
        for u, v in zip(next(got), next(want)):
            np.testing.assert_array_equal(u, v)
    feats = rng.randn(37, 5)
    for args in ((50.0, 25.0), (50.0, 25.0, 20), (30.0, 25.0)):
        np.testing.assert_array_equal(tgen.interpolate_features(feats, *args),
                                      jgen.interpolate_features(feats, *args))
    np.testing.assert_array_equal(tgen.context_windows(feats),
                                  jgen.context_windows(feats))
    np.testing.assert_array_equal(tgen.context_windows(feats, 2, 1),
                                  jgen.context_windows(feats, 2, 1))


def test_atvgnet_plots_equal_jax(tmp_path, component):
    rng = np.random.RandomState(21)
    real = (_landmarks(rng, 12)[None] / 224.0 - 0.5) * 2
    pred = real + rng.randn(*real.shape).astype(np.float32) * 0.02
    a = tviz.plot_lmk_seq(str(tmp_path / "t"), 3, None, component,
                          np.array([12]), real, pred, img_size=64)
    b = jviz.plot_lmk_seq(str(tmp_path / "j"), 3, None, component,
                          np.array([12]), real, pred, img_size=64)
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(a)),
                          np.asarray(Image.open(b)))
    imgs = rng.rand(1, 4, 16, 16, 3).astype(np.float32)
    att = rng.rand(1, 4, 16, 16, 1).astype(np.float32)
    a = tviz.plot_image_seq(str(tmp_path / "t"), 5, imgs, imgs[:, ::-1], att)
    b = jviz.plot_image_seq(str(tmp_path / "j"), 5, imgs, imgs[:, ::-1], att)
    assert np.array_equal(np.asarray(Image.open(a)),
                          np.asarray(Image.open(b)))
    canvas = np.zeros((64, 64, 3), np.uint8)
    np.testing.assert_array_equal(
        tviz.draw_landmarks(canvas, real[0, 0] * 20 + 32),
        jviz.draw_landmarks(canvas, real[0, 0] * 20 + 32))
    assert tviz.LANDMARK_STROKES == jviz.LANDMARK_STROKES
