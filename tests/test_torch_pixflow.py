"""PixFlow in the PyTorch port (voicepuppet_torch/models/pixflow.py,
train/pixflow_trainer.py, the PixFlow stream of data/generators.py)
against the JAX package, both on the CPU, with the same parameters
(through ``weights.state_dict_from_flax``) and the same numpy-seeded
inputs: ngf and ndf 8 at 64², batch 2 (``_torch_port_cases.jax_cfg``).

Dropout: ``ResBlock``'s rate is a field (0.5), not config, and its masks
cannot match across frameworks, so the step comparisons run G without
dropout on both sides: the JAX G with ``train=False`` (its BNs use batch
moments either way) and the port's ``ResBlock``s at rate 0.

Tolerances: forward outputs and alphas within 1e-5 (measured <= 2e-6);
the k=7 'SAME' transposed conv within 1e-5 at every pixel (float32 sums
of 7·7·C products), while the one-pixel-shifted ``padding=3,
output_padding=1`` form is off by O(1); losses within rel 1e-5; one SGD
step's updates within 1e-3 of each leaf's largest (PixRefer's band); the
biases of convs that feed a batch-moment BN have a true gradient of zero
(the BN removes any per-channel shift), as has diffnet's last BN offset
(it cancels in the feature difference), so there both sides' |g| is float
noise and is held under 1e-4 instead (measured: JAX <= 1.1e-5 at
``decoder_2``, the port <= 1.7e-6, against 0.03-105 on the other biases);
the stream's batches equal to the bit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from voicepuppet_tpu.data import generators as jgen
from voicepuppet_tpu.models import pixflow as jpf
from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.parallel.mesh import make_mesh
from voicepuppet_tpu.train.pixflow_trainer import PixFlowTrainer as JTrainer
from voicepuppet_tpu.train.state import GANTrainState as JState

from voicepuppet_torch import weights
from voicepuppet_torch.data import generators as tgen
from voicepuppet_torch.models import layers as tlayers
from voicepuppet_torch.models import pixflow as tpf
from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer

from _torch_port_cases import jax_cfg, numpy_tree, port_cfg

torch.set_num_threads(1)

S = 64
LR = 0.1
FWD_ATOL = 1e-5
LOSS_REL = 1e-5
UPDATE_BAND = 1e-3
NULL_GRAD = 1e-4
# biases with a true gradient of zero: those of the convs whose output goes
# straight into a StatelessBatchNorm, and diffnet's last BN offset, which
# cancels in feat_cur - feat_ref
FEEDS_BN = re.compile(r"(enc_\d\.Conv_0|decoder_\d\.ConvTranspose_0|"
                      r"resnet_\d\.Conv_[01]|layer_[234]\.Conv_0|"
                      r"diffnet\.StatelessBatchNorm_2)\.bias$")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, S, S, 6).astype(np.float32),
            rng.rand(b, S, S, 6).astype(np.float32),
            (rng.rand(b, S, S, 3) > 0.5).astype(np.float32))


@pytest.fixture(scope="module")
def trees():
    jcfg = jax_cfg()
    x6 = np.zeros((1, S, S, 6), np.float32)
    g = numpy_tree(jpf.PixFlowNet(jcfg.pixflow), x6, x6, train=False,
                   seed=1)["params"]
    d = numpy_tree(jpx.Discriminator(jcfg.pixflow.ndf), x6[..., :3],
                   x6[..., :3], seed=2)["params"]
    return jcfg, g, d


def test_forward_and_composite_match_jax(trees):
    jcfg, g, _ = trees
    inputs, fg, _ = _batch(3)
    x, f = inputs * 2 - 1, fg * 2 - 1
    want = jpf.PixFlowNet(jcfg.pixflow).apply({"params": g}, x, f,
                                              train=False)
    net = weights.load_flax_(tpf.PixFlowNet(port_cfg(jcfg).pixflow), g)
    got = net(_t(x), _t(f))
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, S, S, 3)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=FWD_ATOL)
    out, alpha = (a.detach().numpy() for a in got)
    # black background: rgb * a + a - 1 is -1 where a is 0
    raw = net.generator(_t(x), _t(f)).detach().numpy()
    np.testing.assert_allclose(out, raw[..., :3] * alpha + alpha - 1,
                               atol=1e-6)
    assert 0.0 <= alpha.min() and alpha.max() <= 1.0


class _Final7(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(4, (7, 7), strides=(2, 2), padding="SAME",
                                 name="final7")(x)


@pytest.mark.parametrize("size", [5, 8])
def test_final7_transpose_conv_alignment(size):
    """``final7``: flax ``ConvTranspose(7, stride 2, 'SAME')`` pads the
    dilated input 4 before and 3 after; ``SameConvTranspose2d`` with the
    bridged (flipped) kernel matches it at every pixel, borders included,
    and the same-size ``padding=3, output_padding=1`` form is one pixel
    off."""
    assert tlayers.conv_transpose_same_pads(7, 2) == (4, 3)
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 6).astype(np.float32)
    params = {"params": {"final7": {
        "kernel": rng.randn(7, 7, 6, 4).astype(np.float32) / 10,
        "bias": rng.randn(4).astype(np.float32)}}}
    want = np.asarray(_Final7().apply(params, x))
    assert want.shape == (2, 2 * size, 2 * size, 4)
    # the scope name is the parent's, so the bridge knows the transposed
    # conv by the target module's type
    holder = torch.nn.Module()
    holder.final7 = tlayers.SameConvTranspose2d(6, 4, 7, 2)
    weights.load_flax_(holder, params)
    ours = holder.final7
    np.testing.assert_array_equal(
        ours.weight.detach().numpy(),
        np.transpose(params["params"]["final7"]["kernel"][::-1, ::-1],
                     (2, 3, 0, 1)))
    back = weights.flax_from_state_dict(holder.state_dict(), params, holder)
    np.testing.assert_array_equal(back["params"]["final7"]["kernel"],
                                  params["params"]["final7"]["kernel"])
    xt = _t(x).permute(0, 3, 1, 2)
    got = ours(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    shifted = torch.nn.functional.conv_transpose2d(
        xt, ours.weight, ours.bias, 2, padding=3,
        output_padding=1).permute(0, 2, 3, 1).detach().numpy()
    assert shifted.shape == want.shape
    assert np.abs(shifted - want).max() > 0.1


def test_losses_match_jax():
    rng = np.random.RandomState(4)
    pr, pfk = (rng.uniform(0.05, 0.95, (2, 6, 6, 1)).astype(np.float32)
               for _ in range(2))
    fg, out, alpha, mask = (rng.rand(2, S, S, 3).astype(np.float32)
                            for _ in range(4))
    want = float(jpf.pixflow_discriminator_loss(pr, pfk))
    got = float(tpf.pixflow_discriminator_loss(_t(pr), _t(pfk)))
    assert abs(got / want - 1) < LOSS_REL
    np.testing.assert_allclose(
        got, np.mean(-(np.log(pr + 1e-12) + np.log(1 - pfk + 1e-12))),
        rtol=1e-5)
    jw = jpf.pixflow_generator_loss(pfk, fg, out, alpha, mask, 1.0, 500.0)
    tw = tpf.pixflow_generator_loss(_t(pfk), _t(fg), _t(out), _t(alpha),
                                    _t(mask), 1.0, 500.0)
    for a, b in zip(tw, jw):
        assert abs(float(a) / float(b) - 1) < LOSS_REL


class _NoDropout:
    """The JAX G of the step with ``train=False``: no dropout, the same
    batch-moment BNs."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, train=True, rngs=None, **kw):
        return self.module.apply(variables, *args, train=False, **kw)


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


@pytest.fixture(scope="module")
def stepped(trees):
    jcfg, g, d = trees
    batch = _batch(5)
    jt = JTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]))
    jt.gen = _NoDropout(jt.gen)
    s1, metrics = jt.train_step(
        JState.create(g, d, {}, optax.sgd(LR), optax.sgd(LR)), batch,
        jax.random.PRNGKey(0), log_gradients=False)
    tr = PixFlowTrainer(port_cfg(jcfg), device="cpu", g_tx=_sgd, d_tx=_sgd)
    state = tr.init_state()
    host = lambda t, module: weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, t), module)
    weights.load_flax_(state.gen, g)
    weights.load_flax_(state.disc, d)
    for m in state.gen.modules():
        if isinstance(m, tpf.ResBlock):
            m.drop_rate = 0.0
    state, got = tr.train_step(state, batch)
    return dict(g=g, d=d, want={k: float(v) for k, v in metrics.items()},
                got={k: float(v) for k, v in got.items()}, state=state,
                step=int(s1.step), g1=host(s1.g_params, state.gen),
                d1=host(s1.d_params, state.disc))


def _check_updates(module, before_tree, after):
    before = weights.state_dict_from_flax(before_tree, module)
    own = module.state_dict()
    assert set(own) == set(after)
    bad = []
    nulls = 0
    for k in own:
        want = (after[k] - before[k]).numpy()
        got = (own[k] - before[k]).numpy()
        scale = np.abs(want).max()
        if FEEDS_BN.search(k):
            nulls += 1
            if not max(np.abs(got).max(), scale) / LR < NULL_GRAD:
                bad.append((k, "null", np.abs(got).max() / LR, scale / LR))
        elif not np.abs(got - want).max() / scale < UPDATE_BAND:
            bad.append((k, np.abs(got - want).max() / scale))
    assert not bad, bad[:5]
    assert nulls > 0


@pytest.mark.parametrize("term", ["discrim_loss", "gen_loss",
                                  "gen_loss_GAN", "gen_loss_L1"])
def test_step_losses_match_jax(stepped, term):
    assert abs(stepped["got"][term] / stepped["want"][term] - 1) < LOSS_REL


@pytest.mark.parametrize("part", ["disc", "gen"])
def test_step_updates_match_jax(stepped, part):
    """D's update, then G's through the updated D."""
    _check_updates(getattr(stepped["state"], part),
                   stepped["d" if part == "disc" else "g"],
                   stepped["d1" if part == "disc" else "g1"])
    assert stepped["state"].step == stepped["step"] == 2


def test_resblock_dropout_draws_from_the_generator(trees):
    """In training the port's ResBlocks drop out at 0.5 from the step's
    ``torch.Generator``: the same seed gives the same output, another seed
    another, and ``train=False`` none."""
    jcfg, g, _ = trees
    net = weights.load_flax_(tpf.PixFlowNet(port_cfg(jcfg).pixflow), g)
    inputs, fg, _ = _batch(6)
    x, f = _t(inputs * 2 - 1), _t(fg * 2 - 1)
    run = lambda seed: net(x, f, train=True, generator=torch.Generator(
    ).manual_seed(seed))[0].detach()
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), net(x, f)[0].detach())
    block = net.generator.pre_resnet_1
    y = torch.ones(4, 8, 16, 16)
    kept = tlayers.dropout(y, block.drop_rate, torch.Generator().manual_seed(
        3))
    assert set(kept.unique().tolist()) <= {0.0, 2.0}
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.05


def _panel_clip(rng, frames, size):
    alpha = np.zeros((frames, size, size, 3), np.float32)
    alpha[:, size // 8:-size // 8, size // 4:-size // 4] = 1.0
    return {"images": np.concatenate(
        [rng.rand(frames, size, size, 3), rng.rand(frames, size, size, 3),
         alpha], axis=2).astype(np.float32)}


def test_stream_batches_match_jax():
    jcfg = jax_cfg()
    rng = np.random.RandomState(7)
    clips = [_panel_clip(rng, 3, S) for _ in range(2)]
    want = jgen.PixFlowBatcher(jcfg, jgen.ArraySource(clips), seed=3)
    got = tgen.PixFlowBatcher(port_cfg(jcfg), tgen.ArraySource(clips),
                              seed=3)
    n = 0
    for a, b in zip(got, want):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        n += 1
        if n == 4:
            break
    assert n == 4
    assert a[0].shape == (2, S, S, 6) and a[2].shape == (2, S, S, 3)


def test_bf16_step_learns(trees):
    """``train_dtype=bfloat16``: G and D convs in bfloat16, parameters and
    losses float32; over 12 D+G steps on one batch (Adam, lr 1e-3) the L1
    term falls by more than 10%."""
    jcfg, _, _ = trees
    cfg = port_cfg(jcfg)
    cfg = dataclasses.replace(cfg, pixflow=dataclasses.replace(
        cfg.pixflow, training=dataclasses.replace(
            cfg.pixflow.training, learning_rate=1e-3)))
    tr = PixFlowTrainer(cfg, train_dtype=torch.bfloat16, device="cpu")
    state = tr.init_state(seed=1)
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    batch = _batch(8)
    gen = torch.Generator().manual_seed(0)
    l1 = []
    for _ in range(12):
        state, m = tr.train_step(state, batch, gen)
        l1.append(float(m["gen_loss_L1"]))
    assert np.isfinite(l1).all()
    assert min(l1[-3:]) < 0.9 * l1[0], l1
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
