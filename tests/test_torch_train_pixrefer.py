"""PixRefer GAN training of the PyTorch port (voicepuppet_torch/train)
against the JAX trainer (voicepuppet_tpu/train/pixrefer_trainer.py), both
on the CPU, from the same G, D and VGG parameters and batch: 256², ngf and
ndf 8, batch 2, the full-width VGG-16 trunk (the JAX perceptual loss has
no width knob).  Both sides take one SGD step (lr 0.1) so that a
parameter's update is lr times its gradient: D's gradients of the D loss,
and G's gradients through the *updated* D.

Tolerances: the five losses within rel 1e-5 (measured <= 4.4e-6, the
perceptual term); every update within 1e-3 of its leaf's largest
(measured <= 4.3e-4: the float32 backward through 17 batch-stat BNs);
conv biases that feed a batch-stat BN have a true gradient of zero (the
BN removes any per-channel shift), so both sides' |g| there is float noise
and is held below 1e-5 instead.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.models import vgg as jvgg
from voicepuppet_tpu.parallel.mesh import make_mesh
from voicepuppet_tpu.tools import tf_bundle as jtb
from voicepuppet_tpu.tools import tf_checkpoint as jtfc
from voicepuppet_tpu.train.pixrefer_trainer import PixReferTrainer as JTrainer
from voicepuppet_tpu.train.state import GANTrainState as JState

from voicepuppet_torch import weights
from voicepuppet_torch.models import pixrefer as tpx
from voicepuppet_torch.models import vgg as tvgg
from voicepuppet_torch.tools import tf_bundle as ttb
from voicepuppet_torch.tools import tf_checkpoint as tfc
from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer

from _torch_port_cases import jax_cfg, numpy_tree, port_cfg

torch.set_num_threads(1)

LR = 0.1
LOSS_REL = 1e-5
UPDATE_BAND = 1e-3
NULL_GRAD = 1e-5
S = 256


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


@pytest.fixture(scope="module")
def case():
    jcfg = jax_cfg()
    x6 = np.zeros((1, S, S, 6), np.float32)
    x3 = np.zeros((1, S, S, 3), np.float32)
    g = numpy_tree(jpx.PixReferNet(jcfg.pixrefer), x6, x6, x3,
                   seed=1)["params"]
    d = numpy_tree(jpx.Discriminator(jcfg.pixrefer.ndf), x3, x3,
                   seed=2)["params"]
    v = numpy_tree(jvgg.VGG16Features(), np.zeros((1, 32, 32, 3),
                                                   np.float32),
                   seed=3)["params"]
    rng = np.random.RandomState(0)
    batch = tuple(rng.rand(2, S, S, c).astype(np.float32)
                  for c in (6, 6, 3, 3))
    jt = JTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]),
                  g_tx=optax.sgd(LR), d_tx=optax.sgd(LR))
    jt.vgg_params = jax.tree_util.tree_map(jnp.asarray, v)
    s1, metrics = jt.train_step(JState.create(g, d, {}, jt.g_tx, jt.d_tx),
                                batch, jax.random.PRNGKey(0))
    host = lambda t: weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, t))
    return dict(cfg=port_cfg(jcfg), g=g, d=d, vgg=v, batch=batch,
                step=int(s1.step), metrics={k: float(x)
                                            for k, x in metrics.items()},
                g1=host(s1.g_params), d1=host(s1.d_params))


def _port(case, dtype=torch.float32, perceptual_dtype=None):
    tr = PixReferTrainer(case["cfg"], device="cpu", g_tx=_sgd, d_tx=_sgd,
                         train_dtype=dtype,
                         perceptual_dtype=perceptual_dtype)
    weights.load_flax_(tr.vgg, case["vgg"])
    state = tr.init_state()
    weights.load_flax_(state.gen, case["g"])
    weights.load_flax_(state.disc, case["d"])
    return tr, state


@pytest.fixture(scope="module")
def stepped(case):
    tr, state = _port(case)
    state, metrics = tr.train_step(state, case["batch"])
    return state, {k: float(v) for k, v in metrics.items()}


def _check_updates(module, before_tree, after):
    """Each leaf's update against the JAX one, as module docstring says."""
    before = weights.state_dict_from_flax(before_tree)
    own = module.state_dict()
    assert set(own) == set(after)
    bad = []
    for k in own:
        want = (after[k] - before[k]).numpy()
        got = (own[k] - before[k]).numpy()
        scale = np.abs(want).max()
        if scale / LR < NULL_GRAD:
            if not np.abs(got).max() / LR < NULL_GRAD:
                bad.append((k, "null", np.abs(got).max() / LR))
        elif not np.abs(got - want).max() / scale < UPDATE_BAND:
            bad.append((k, np.abs(got - want).max() / scale))
    assert not bad, bad[:5]


def test_d_loss_and_grads_match_jax(case, stepped):
    _, metrics = stepped
    want = case["metrics"]["discrim_loss"]
    assert abs(metrics["discrim_loss"] / want - 1) < LOSS_REL
    _check_updates(stepped[0].disc, case["d"], case["d1"])


@pytest.mark.parametrize("term", ["gen_loss", "gen_loss_GAN", "gen_loss_L1",
                                  "perceptual"])
def test_g_loss_terms_match_jax(case, stepped, term):
    """G's terms, the GAN one through the updated D."""
    assert abs(stepped[1][term] / case["metrics"][term] - 1) < LOSS_REL


def test_g_grads_through_updated_d_match_jax(case, stepped):
    _check_updates(stepped[0].gen, case["g"], case["g1"])


def test_step_advances_by_two(case, stepped):
    assert stepped[0].step == case["step"] == 2


def test_g_grads_differ_through_the_old_d(case, stepped):
    """G's update depends on D having been updated first: a step whose G
    loss goes through the old D moves G differently (so the test above
    sees the ordering)."""
    tr, state = _port(case)
    d_old = {k: v.clone() for k, v in state.disc.state_dict().items()}
    state.d_optimizer = torch.optim.SGD(state.disc.parameters(), lr=0.0)
    state, _ = tr.train_step(state, case["batch"])
    assert all(torch.equal(v, state.disc.state_dict()[k])
               for k, v in d_old.items())
    delta = max(float((a - b).abs().max()) for a, b in zip(
        state.gen.state_dict().values(),
        stepped[0].gen.state_dict().values()))
    assert delta > 1e-6


def test_perceptual_loss_detaches_the_real_branch(case):
    vgg = tvgg.VGG16Features()
    weights.load_flax_(vgg, case["vgg"])
    rng = np.random.RandomState(3)
    real = torch.tensor(rng.rand(1, 64, 64, 3).astype(np.float32) * 2 - 1,
                        requires_grad=True)
    fake = torch.tensor(rng.rand(1, 64, 64, 3).astype(np.float32) * 2 - 1,
                        requires_grad=True)
    loss = tvgg.perceptual_loss(vgg, real, fake)
    loss.backward()
    assert real.grad is None
    assert fake.grad is not None and float(fake.grad.abs().max()) > 0
    assert all(p.grad is None and not p.requires_grad
               for p in vgg.parameters())
    # conv3_3 only: the value equals the JAX loss of the same trunk
    want = float(jvgg.perceptual_loss(
        jax.tree_util.tree_map(jnp.asarray, case["vgg"]),
        jnp.asarray(real.detach().numpy()),
        jnp.asarray(fake.detach().numpy())))
    assert abs(float(loss) / want - 1) < LOSS_REL


def test_discriminator_forward_matches_jax(case):
    rng = np.random.RandomState(4)
    a, b = (rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
            for _ in range(2))
    want = np.asarray(jpx.Discriminator(8).apply({"params": case["d"]},
                                                 a, b))
    disc = weights.load_flax_(tpx.Discriminator(8), case["d"])
    got = disc(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    assert got.shape == want.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["perceptual_bf16", "bf16"])
def test_bfloat16_step_stays_near_float32(case, stepped, mode):
    """``--perceptual_dtype bfloat16`` and ``--dtype bfloat16`` against the
    float32 step from the same start; parameters, optimizer states and
    losses stay float32.  The VGG trunk alone in bf16 barely moves the
    step: losses within rel 5e-3 (measured 4.8e-4, the perceptual term)
    and every leaf's update at cosine > 0.999 to float32's (measured >
    0.99999).  The whole step in bf16 (G and D convs) keeps the losses
    within rel 1e-2 (measured 3.3e-3, the GAN term) and G's and D's
    concatenated updates at cosine > 0.98 (measured 0.995 for G); single
    small leaves, BN scales above all, can turn (cosine down to -0.5
    measured), so they are not held one by one."""
    if mode == "bf16":
        tr, state = _port(case, torch.bfloat16)
    else:
        tr, state = _port(case, perceptual_dtype=torch.bfloat16)
    state, metrics = tr.train_step(state, case["batch"])
    for k, v in metrics.items():
        assert v.dtype == torch.float32
        band = 1e-2 if mode == "bf16" else 5e-3
        assert abs(float(v) / stepped[1][k] - 1) < band, (k, float(v))
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))
    for mod, ref, tree in ((state.gen, stepped[0].gen, case["g"]),
                           (state.disc, stepped[0].disc, case["d"])):
        before = weights.state_dict_from_flax(tree)
        got, want = [], []
        for (k, p), q in zip(mod.state_dict().items(),
                             ref.state_dict().values()):
            assert p.dtype == torch.float32
            a, b = (p - before[k]).ravel(), (q - before[k]).ravel()
            if float(b.abs().max()) / LR < NULL_GRAD:
                continue
            if mode != "bf16":
                assert cos(a, b) > 0.999, k
            got.append(a)
            want.append(b)
        assert cos(torch.cat(got), torch.cat(want)) > 0.98


def test_discriminator_loads_from_tf_bundle(case, tmp_path):
    """A V2 bundle under the reference's discriminator names loads through
    ``load_pixrefer_ckpt(prefix, g, d_target=Discriminator)``, strictly,
    into exactly the JAX tree's state."""
    arrays = {}
    for tf_name, coll, path, transform in \
            jtfc.pixrefer_discriminator_name_map():
        val = np.asarray(jtfc._get({"params": case["d"]}[coll], path))
        arrays[tf_name] = transform(val) if transform else val
    prefix = str(tmp_path / "ckpt_pixrefer" / "pixrefernet-20000")
    jtb.write_bundle(arrays, prefix)
    disc = tpx.Discriminator(8)
    g_own = tpx.PixReferNet(case["cfg"].pixrefer).state_dict()
    (_, _, g_missing), (d_state, loaded, d_missing) = tfc.load_pixrefer_ckpt(
        prefix, g_own, d_target=disc)
    assert g_missing and not d_missing
    assert len(loaded) == len(tfc.pixrefer_discriminator_name_map())
    disc.load_state_dict(d_state, strict=True)
    want = weights.state_dict_from_flax(case["d"])
    for k, v in disc.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_vgg_loads_slim_checkpoint_and_npz(tmp_path):
    """The released slim VGG-16 (conv1-4 plus excluded fc/conv5 variables)
    as a V2 bundle, and its converted npz, load into the trunk equal to
    the JAX loaders' trees (narrow widths: names are width-independent)."""
    widths = (4, 8, 8, 16)
    tree = numpy_tree(jvgg.VGG16Features(widths=widths),
                      np.zeros((1, 16, 16, 3), np.float32), seed=5)["params"]
    arrays = {}
    for slim, npz_key in jtb.vgg16_slim_name_map():
        layer, part = npz_key.rsplit("_", 1)
        arrays[slim] = tree[layer][part]
    arrays["vgg_16/fc8/biases"] = np.zeros(3, np.float32)
    prefix = str(tmp_path / "vgg_16.ckpt")
    jtb.write_bundle(arrays, prefix)
    zero = jax.tree_util.tree_map(lambda a: a * 0, tree)
    jparams, _, jmissing = jtb.load_vgg16_checkpoint(prefix, zero)
    vgg = tvgg.VGG16Features(widths=widths)
    state, loaded, missing = ttb.load_vgg16_checkpoint(prefix, vgg)
    assert not missing and not jmissing and len(loaded) == 20
    vgg.load_state_dict(state, strict=True)
    want = weights.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, want[k]), k
    npz = str(tmp_path / "vgg16_weights.npz")
    np.savez(npz, **{k: arrays[s] for s, k in jtb.vgg16_slim_name_map()})
    other = tvgg.load_weights(npz, tvgg.VGG16Features(widths=widths))
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
    arrays["vgg_16/conv9/weights"] = np.zeros(3, np.float32)
    jtb.write_bundle(arrays, prefix)
    with pytest.raises(ValueError, match="conv9"):
        ttb.load_vgg16_checkpoint(prefix, vgg)
    np.savez(npz, conv1_1_kernel=arrays["vgg_16/conv1/conv1_1/weights"])
    with pytest.raises(ValueError, match="absent or mis-shaped"):
        tvgg.load_weights(npz, tvgg.VGG16Features(widths=widths))
