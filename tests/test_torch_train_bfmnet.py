"""BFMNet training of the PyTorch port (voicepuppet_torch/train) against
the JAX trainer (voicepuppet_tpu/train/bfmnet_trainer.py), both on the
CPU, from the same parameters and batch, at the widths of
``_torch_port_cases.jax_cfg()`` and ``drop_rate = 0`` (dropout masks cannot
match JAX's RNG; dropout has its own test below).

Tolerances.  The forward is float32 on both sides and agrees to float
noise: the loss within rel 1e-5, the updated BN moments within 1e-6.
Gradients are held two ways, because the backward through the 20 stacked
train-mode batch norms of the conv trunk (MfccNet) is ill-conditioned in
float32: against a float64 run of the port, JAX's own float32 trunk
gradients are off by 0.5-2.5% of each leaf's max |g| and the port's by
0.5-1.7%, and merely permuting the batch rows moves the port's by as
much (measured on this configuration).  So:

  * with the running BN moments (``train=False``), where the backward is
    well conditioned, every leaf within 1e-4 of its max |g|;
  * in train mode, the leaves after the trunk (dense, GRU, head) within
    1e-4 of their max |g| (measured 7.7e-6), the trunk leaves within 0.15
    of theirs (measured 0.077) and their concatenation within 2e-2 in
    relative L2 (measured 5.8e-3); a trunk leaf whose
    true gradient is zero (the projection BN biases, whose shift the next
    BN removes; |g| < 1e-4 on both sides, float noise) is held by
    magnitude only.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
from voicepuppet_tpu.models.bfmnet import BFMNetLoss as JLoss
from voicepuppet_tpu.models.bfmnet import make_mouth_mask as jmouth
from voicepuppet_tpu.models.layers import l2_regularization as jl2
from voicepuppet_tpu.parallel.mesh import make_mesh
from voicepuppet_tpu.train.bfmnet_trainer import BFMNetTrainer as JTrainer
from voicepuppet_tpu.train.state import TrainState as JState

from voicepuppet_torch import weights
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.models import layers as tlayers
from voicepuppet_torch.models.bfmnet import BFMNet as TBFMNet
from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer

from _torch_port_cases import jax_cfg, numpy_tree, port_cfg

torch.set_num_threads(1)

LOSS_REL = 1e-5
STATS_ATOL = 1e-6
LEAF_BAND = 1e-4        # of the leaf's max |g|, well-conditioned leaves
TRUNK_BAND = 0.15       # of the leaf's max |g|, train-mode conv trunk
TRUNK_L2 = 2e-2         # relative L2 over the train-mode trunk
NULL_GRAD = 1e-4        # |g| of a leaf whose true gradient is zero
LR = 0.1
MOUTH = np.arange(0, 100, 3)
TRUNK = "mfcc_encoder.MfccNet_0."


def _tree(jcfg):
    t = 8
    return numpy_tree(JBFMNet(jcfg.bfmnet), np.zeros((1, t, 1), np.float32),
                      np.zeros((1, t * 5, 80), np.float32),
                      np.full((1,), t, np.int32), train=False, seed=2)


def _no_dropout(cfg):
    b = cfg.bfmnet
    return dataclasses.replace(cfg, bfmnet=dataclasses.replace(
        b, training=dataclasses.replace(b.training, drop_rate=0.0)))


@pytest.fixture(scope="module")
def case():
    jcfg = _no_dropout(jax_cfg())
    tree = _tree(jcfg)
    rng = np.random.RandomState(5)
    b, t = 4, 8
    # rows 2 and 4 are padded: their padded frames enter train-mode BN
    batch = (rng.randn(b, t, 257).astype(np.float32) * 0.1,
             rng.rand(b, t, 1).astype(np.float32) * 0.1,
             rng.randn(b, t * 5, 80).astype(np.float32),
             np.array([8, 6, 8, 5], np.int32))
    jfm = jbfm.synthetic_bfm(num_theta=10, num_phi=10, seed=0)
    model = JBFMNet(jcfg.bfmnet, bn_axis=None)
    loss_fn = JLoss(jfm.exBase, jmouth(jfm.num_vertices, MOUTH, 10.0))

    def loss_of(params, stats, batch, train):
        coeff, ears, mfccs, seq_len = batch
        if not train:
            out = model.apply({"params": params, "batch_stats": stats},
                              ears, mfccs, seq_len, train=False)
            return loss_fn(out, coeff, seq_len) + jl2(params), stats
        out, mut = model.apply(
            {"params": params, "batch_stats": stats}, ears, mfccs, seq_len,
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return loss_fn(out, coeff, seq_len) + jl2(params), mut["batch_stats"]

    @jax.jit
    def both(params, stats, batch):
        vg = jax.value_and_grad(loss_of, has_aux=True)
        return (vg(params, stats, batch, True),
                vg(params, stats, batch, False))

    host = lambda x: jax.tree_util.tree_map(np.asarray, x)
    (tl, tstats), tg = host(both(tree["params"], tree["batch_stats"],
                                 batch)[0])
    (el, _), eg = host(both(tree["params"], tree["batch_stats"], batch)[1])
    jt = JTrainer(jcfg, jfm, MOUTH, mesh=make_mesh(jax.devices()[:1]),
                  tx=optax.sgd(LR))
    s0 = JState.create(tree["params"], tree["batch_stats"], jt.tx)
    eval_loss, eval_out = jt.eval_loss(s0, batch)
    s1, metrics = jt.train_step(s0, batch, jax.random.PRNGKey(0))
    return dict(
        jcfg=jcfg, cfg=port_cfg(jcfg), tree=tree, batch=batch,
        train=(float(tl), weights.state_dict_from_flax(tg),
               weights.state_dict_from_flax({"batch_stats": tstats})),
        eval=(float(el), weights.state_dict_from_flax(eg)),
        step=(weights.state_dict_from_flax(host(
            {"params": s1.params, "batch_stats": s1.batch_stats})),
            {k: float(v) for k, v in metrics.items()}),
        eval_loss=(float(eval_loss), np.asarray(eval_out)),
        face=tbfm.synthetic_bfm(num_theta=10, num_phi=10, seed=0))


def _trainer(case, tx=None):
    tr = BFMNetTrainer(case["cfg"], case["face"], MOUTH, device="cpu",
                       tx=tx or (lambda p: torch.optim.SGD(p, lr=LR)))
    state = tr.init_state()
    weights.load_flax_(state.model, case["tree"])
    return tr, state


def _grad_bands(got, want, train_mode):
    """(leaf, |diff| / max|want|, band) rows over every leaf, and the
    relative L2 of the trunk leaves."""
    rows, dt, wt = [], [], []
    for name, g in got.items():
        w = want[name].numpy()
        g = g.detach().numpy()
        scale = np.abs(w).max()
        if train_mode and name.startswith(TRUNK) and scale < NULL_GRAD:
            rows.append((name, np.abs(g).max(), NULL_GRAD))
            continue
        band = TRUNK_BAND if train_mode and name.startswith(TRUNK) \
            else LEAF_BAND
        rows.append((name, np.abs(g - w).max() / scale, band))
        if name.startswith(TRUNK):
            dt.append((g - w).ravel())
            wt.append(w.ravel())
    l2 = (np.linalg.norm(np.concatenate(dt))
          / np.linalg.norm(np.concatenate(wt)))
    return rows, l2


def test_train_loss_and_batch_stats_match_jax(case):
    tr, state = _trainer(case)
    with torch.no_grad():
        loss = tr.loss(state, case["batch"])
    want_loss, _, want_stats = case["train"]
    assert abs(float(loss) / want_loss - 1) < LOSS_REL
    own = state.model.state_dict()
    for k, v in want_stats.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_grads_match_jax(case, mode):
    tr, state = _trainer(case)
    train = mode == "train"
    if train:
        loss = tr.loss(state, case["batch"])
    else:
        coeff, ears, mfccs, seq_len = [torch.as_tensor(a)
                                       for a in case["batch"]]
        loss = (tr.loss_fn(state.model(ears, mfccs, seq_len), coeff,
                           seq_len) + tlayers.l2_regularization(state.model))
        assert abs(float(loss.detach()) / case["eval"][0] - 1) < LOSS_REL
    loss.backward()
    want = case["train" if train else "eval"][1]
    got = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(got) == set(want)
    rows, l2 = _grad_bands(got, want, train)
    bad = [r for r in rows if not r[1] < r[2]]
    assert not bad, bad[:5]
    assert l2 < (TRUNK_L2 if train else LEAF_BAND), l2


def test_sgd_step_matches_jax_trainer(case):
    """One full step (loss, grad_norm, the SGD update, the running BN
    moments) against ``BFMNetTrainer.train_step`` on a 1-device mesh.  An
    update is LR times a gradient, so it is held to the gradient bands,
    relative to the leaf's largest update."""
    tr, state = _trainer(case)
    state, metrics = tr.train_step(state, case["batch"])
    assert state.step == 1
    want, jm = case["step"]
    assert abs(float(metrics["loss"]) / jm["loss"] - 1) < LOSS_REL
    # the norm is dominated by the trunk's gradients (see the docstring)
    assert abs(float(metrics["grad_norm"]) / jm["grad_norm"] - 1) < 1e-3
    before = weights.state_dict_from_flax(case["tree"])
    own = state.model.state_dict()
    params = dict(state.model.named_parameters())
    got = {k: (own[k] - before[k]) / LR for k in params}
    ref = {k: (want[k] - before[k]) / LR for k in params}
    rows, l2 = _grad_bands(got, ref, True)
    bad = [r for r in rows if not r[1] < r[2]]
    assert not bad, bad[:5]
    assert l2 < TRUNK_L2
    for k in own:
        if k.endswith("running_mean") or k.endswith("running_var"):
            np.testing.assert_allclose(own[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=STATS_ATOL, err_msg=k)


def test_eval_loss_matches_jax(case):
    """``eval_loss``: running moments, no dropout, no regularizer; the
    coefficients within 1e-5 of their largest."""
    tr, state = _trainer(case)
    loss, out = tr.eval_loss(state, case["batch"])
    want_loss, want_out = case["eval_loss"]
    assert abs(float(loss) / want_loss - 1) < LOSS_REL
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0,
                               atol=1e-5 * np.abs(want_out).max())


def test_l2_regularization_matches_jax(case):
    tree = case["tree"]
    net = weights.load_flax_(TBFMNet(case["cfg"].bfmnet), tree)
    got = float(tlayers.l2_regularization(net))
    want = float(jl2(tree["params"]))
    assert abs(got / want - 1) < 1e-6
    # only the 4-D conv kernels: scaling a dense or GRU kernel changes
    # nothing
    with torch.no_grad():
        net.rnn_in.weight.mul_(3.0)
        net.rnn_module.ScanTFGRUCell_0.Dense_0.weight.mul_(3.0)
    assert float(tlayers.l2_regularization(net)) == got


def test_dropout_keep_scaling_eval_and_seed():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    y = tlayers.dropout(x, 0.25, g)
    kept = y != 0
    # kept elements scaled by 1 / (1 - rate), the kept share ~ 0.75
    assert torch.all(y[kept] == 1.0 / 0.75)
    assert abs(float(kept.float().mean()) - 0.75) < 5e-3
    # the same seed repeats the mask, another seed does not
    assert torch.equal(tlayers.dropout(x, 0.25,
                                       torch.Generator().manual_seed(3)), y)
    assert not torch.equal(
        tlayers.dropout(x, 0.25, torch.Generator().manual_seed(4)), y)
    assert tlayers.dropout(x, 0.0, g) is x


def test_bfmnet_dropout_train_only():
    """The network's dropouts act in train mode only, and repeat from the
    same generator seed."""
    cfg = port_cfg()
    torch.manual_seed(0)
    net = TBFMNet(cfg.bfmnet)
    assert cfg.bfmnet.training.drop_rate == 0.25
    rng = np.random.RandomState(1)
    ears = torch.as_tensor(rng.rand(2, 8, 1).astype(np.float32))
    mfcc = torch.as_tensor(rng.randn(2, 40, 80).astype(np.float32))
    seq = torch.tensor([8, 8])
    stats = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        a = net(ears, mfcc, seq, train=True,
                generator=torch.Generator().manual_seed(7))
        net.load_state_dict(stats)
        b = net(ears, mfcc, seq, train=True,
                generator=torch.Generator().manual_seed(7))
        net.load_state_dict(stats)
        c = net(ears, mfcc, seq, train=True,
                generator=torch.Generator().manual_seed(8))
        e1 = net(ears, mfcc, seq)
        e2 = net(ears, mfcc, seq)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2)


def test_batch_moments_match_float64():
    """Train-mode BN moments on activations with a large mean, where
    float32 ``mean(x²) - mean²`` loses the variance (9.3e-4 of it here):
    the mean and the biased variance within 1e-6 of a float64 run, and
    the gradient of a weighted variance within 1e-5 of its largest
    (measured 3.2e-8, 5.2e-8 and 1.6e-6)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 40, 8, generator=g) * 0.5 + 30.0
    w = torch.randn(16, generator=g)

    def run(xs, moments):
        xs = xs.clone().requires_grad_(True)
        mean, var = moments(xs)
        (w.to(xs.dtype) * var).sum().backward()
        return mean.detach().double(), var.detach().double(), xs.grad

    def float64(xd):
        mean = xd.mean(dim=(0, 2, 3))
        return mean, torch.square(xd).mean(dim=(0, 2, 3)) - mean ** 2

    got = run(x, tlayers.batch_moments)
    want = run(x.double(), float64)
    for a, b, band in zip(got, want, (1e-6, 1e-6, 1e-5)):
        assert float((a.double() - b).abs().max() / b.abs().max()) < band
