"""The port's TF weight readers and name maps (voicepuppet_torch/tools/)
against TensorFlow's own readback and against the JAX package.

The fixtures under tests/fixtures/tf_binary/ were written by TensorFlow,
and expected.npz is TensorFlow's readback of every tensor; the BFMNet
checkpoint under tests/fixtures/tf_oracle/ was written by TensorFlow
together with the coefficients its graph computed.  Readers and exports
must be exact; the BFMNet forward is held to TensorFlow's coefficients
within the bands of tests/test_tf_oracle.py (mean 1e-4, max 1e-3).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.tools import tf_bundle as jtb
from voicepuppet_tpu.tools import tf_checkpoint as jtfc

from voicepuppet_torch import weights
from voicepuppet_torch.config import BFMNetConfig
from voicepuppet_torch.models.bfmnet import BFMNet
from voicepuppet_torch.models import pixrefer as tpx
from voicepuppet_torch.tools import tf_bundle as tb
from voicepuppet_torch.tools import tf_checkpoint as tfc

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures", "tf_binary")
ORACLE = os.path.join(HERE, "fixtures", "tf_oracle")


def _expected(tag):
    blob = np.load(os.path.join(FIX, "expected.npz"))
    return {k.split("|", 1)[1].replace("&", "/"): blob[k]
            for k in blob.files if k.split("|", 1)[0] == tag}


def _assert_arrays_equal(got, want):
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5],
                                   sorted(set(got) - set(want))[:5])
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == tuple(np.shape(want[name])), name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("tag", ["bundle_v2", "v1", "graph"])
def test_readers_match_tf_readback(tag):
    read = {
        "bundle_v2": lambda: tb.read_bundle(
            os.path.join(FIX, "bundle_v2", "model"), verify_crc=True),
        "v1": lambda: tb.read_v1_checkpoint(os.path.join(FIX, "v1",
                                                         "model.ckpt")),
        "graph": lambda: tb.read_graphdef_consts(
            os.path.join(FIX, "frozen_graph.pb")),
    }[tag]
    _assert_arrays_equal(read(), _expected(tag))


def test_read_checkpoint_dispatches_both_formats():
    _assert_arrays_equal(tb.read_checkpoint(os.path.join(FIX, "bundle_v2",
                                                         "model")),
                         _expected("bundle_v2"))
    _assert_arrays_equal(tb.read_checkpoint(os.path.join(FIX, "v1",
                                                         "model.ckpt")),
                         _expected("v1"))
    with pytest.raises(FileNotFoundError):
        tb.read_checkpoint(os.path.join(FIX, "no_such_prefix"))


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, 9000, 70001])
def test_crc32c_matches_the_byte_loop(n):
    """The parallel-stream crc32c equals the reference's byte loop at every
    length around the switch-over and the stream count."""
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    for crc in (0, 0x9E3779B9):
        assert tb.crc32c(data, crc) == jtb.crc32c(data, crc)
    assert tb.masked_crc32c(data) == jtb.masked_crc32c(data)


def test_write_bundle_round_trip_and_bytes_equal_jax(tmp_path):
    """write_bundle -> read_bundle returns every tensor exactly, and the
    files equal, byte for byte, what the JAX package's writer makes (whose
    output TensorFlow reads back exactly)."""
    rng = np.random.RandomState(0)
    arrays = {
        "a/kernel": rng.randn(3, 5, 7, 2).astype(np.float32),
        "a/bias": rng.randn(2).astype(np.float32),
        "big": rng.randn(300, 40).astype(np.float32),     # > 4096 B
        "steps": np.array(7, np.int64),
        "mask": rng.rand(4, 4) > 0.5,
        "half": rng.randn(5).astype(np.float16),
    }
    arrays.update({f"many/{i:03d}": rng.randn(i % 7 + 1).astype(np.float64)
                   for i in range(200)})         # several index blocks
    tb.write_bundle(arrays, str(tmp_path / "port" / "model"))
    jtb.write_bundle(arrays, str(tmp_path / "jax" / "model"))
    _assert_arrays_equal(tb.read_bundle(str(tmp_path / "port" / "model"),
                                        verify_crc=True), arrays)
    for suffix in (".index", ".data-00000-of-00001"):
        assert ((tmp_path / "port" / f"model{suffix}").read_bytes()
                == (tmp_path / "jax" / f"model{suffix}").read_bytes())


def test_bfloat16_tensors_widen_exactly():
    bits = np.array([0x3F80, 0xC040, 0x0001, 0x7F80], np.uint16)
    want = np.array([1.0, -3.0, 9.183549615799121e-41, np.inf], np.float32)
    got = tb._widen_bfloat16(bits)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_tf_oracle_checkpoint_loads_and_matches_tensorflow():
    """The TF-written BFMNet V2 checkpoint: 242 of 242 variables into the
    port's BFMNet, whose forward meets TensorFlow's coefficients."""
    z = np.load(os.path.join(ORACLE, "bfmnet.npz"))
    net = BFMNet(BFMNetConfig(thinresnet_output_channels=32,
                              encode_embedding_size=32, rnn_hidden_size=32,
                              backbone_width_mult=0.25))
    prefix = os.path.join(ORACLE, "bfmnet_ckpt", "model-65000")
    state, loaded, missing = tfc.load_bfmnet_ckpt(prefix, net)
    assert missing == [] and len(loaded) == 242
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    net.eval()
    with torch.no_grad():
        out = net(torch.as_tensor(z["ears"]), torch.as_tensor(z["mfccs"]),
                  torch.as_tensor(z["seq_len"])).numpy()
    d = np.abs(out - z["coeff"])
    assert d.mean() < 1e-4        # measured 2.3e-7
    assert d.max() < 1e-3         # measured 2.5e-6


def _same_state(got, want):
    assert set(got) == set(want), (sorted(set(want) - set(got))[:3],
                                   sorted(set(got) - set(want))[:3])
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def _seeded_tree(init, seed, *args):
    """The variable tree ``init`` makes, its shapes traced with
    ``jax.eval_shape`` (nothing compiled) and filled from a seed."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), dict(shapes))


@pytest.fixture(scope="module")
def pixrefer_jax():
    """A PixRefer G+D at ngf 4, 256² in the JAX package's tree layout, with
    the rows of each written out under the TF names."""
    cfg = dataclasses.replace(jax_cfg().pixrefer, ngf=4, ndf=4)
    x = jnp.zeros((1, 256, 256, 6))
    gv = _seeded_tree(jpx.PixReferNet(cfg).init, 0, x, x, x[..., :3])
    dv = _seeded_tree(jpx.Discriminator(4).init, 1, x[..., :3], x[..., :3])
    arrays = {}
    for rows, variables in ((jtfc.pixrefer_generator_name_map(), gv),
                            (jtfc.pixrefer_discriminator_name_map(), dv)):
        for tf_name, coll, p, transform in rows:
            val = np.asarray(jtfc._get(variables[coll], p))
            arrays[tf_name] = transform(val) if transform else val
    return cfg, gv, dv, arrays


@pytest.mark.parametrize("form", ["bundle", "npz"])
def test_pixrefer_g_and_d_load_to_state_dict_from_flax(pixrefer_jax, form,
                                                       tmp_path):
    """A G+D checkpoint (as the release ships) loads in the port to exactly
    ``state_dict_from_flax`` of the trees the JAX loaders make of it."""
    cfg, gv, dv, arrays = pixrefer_jax
    zero = lambda v: jax.tree_util.tree_map(lambda a: a * 0.0, v)
    g_own = weights.state_dict_from_flax(gv["params"])
    d_own = weights.state_dict_from_flax(dv["params"])
    if form == "bundle":
        prefix = str(tmp_path / "ckpt_pixrefer" / "pixrefernet-20000")
        jtb.write_bundle(arrays, prefix)
        (jg, _, jgm), (jd, _, jdm) = jtfc.load_pixrefer_ckpt(
            prefix, zero(gv), zero(dv))
        (g, _, gm), (d, _, dm) = tfc.load_pixrefer_ckpt(prefix, g_own, d_own)
    else:
        path = str(tmp_path / "pixrefer.npz")
        np.savez(path, **{k.replace("/", "|"): v for k, v in arrays.items()})
        jg, _, jgm = jtfc.load_npz(path, zero(gv),
                                   jtfc.pixrefer_generator_name_map())
        jd, _, jdm = jtfc.load_npz(path, zero(dv),
                                   jtfc.pixrefer_discriminator_name_map())
        g, _, gm = tfc.load_npz(path, g_own,
                                tfc.pixrefer_generator_name_map())
        d, _, dm = tfc.load_npz(path, d_own,
                                tfc.pixrefer_discriminator_name_map())
    assert not (jgm or jdm or gm or dm)
    _same_state(g, weights.state_dict_from_flax(jg["params"]))
    _same_state(d, weights.state_dict_from_flax(jd["params"]))
    # and the generator state loads strictly into the port's module
    net = tpx.PixReferNet(dataclasses.replace(port_cfg().pixrefer, ngf=4))
    net.load_state_dict(g)


def test_bfmnet_npz_export_and_load_match_jax(tmp_path):
    """The exports are the inverse of the loaders, and agree with the JAX
    package both ways: its npz loads in the port to state_dict_from_flax of
    its tree, and the port's npz equals its npz array for array."""
    bfm = _bfmnet_tree()
    jax_npz = str(tmp_path / "jax.npz")
    jtfc.export_bfmnet_npz(bfm, jax_npz)
    net = BFMNet(port_cfg().bfmnet)
    state, loaded, missing = tfc.load_bfmnet_npz(jax_npz, net)
    assert missing == [] and len(loaded) == len(tfc.bfmnet_rows(net))
    want = weights.state_dict_from_flax(bfm)
    _same_state(state, want)
    port_npz = str(tmp_path / "port.npz")
    tfc.export_bfmnet_npz(want, port_npz)
    a, b = np.load(jax_npz), np.load(port_npz)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_layout_inverse_round_trips():
    """weights.flax_leaf undoes convert_leaf for every kind of kernel."""
    rng = np.random.RandomState(0)
    for path, shape in ((("Dense_0", "kernel"), (5, 3)),
                        (("Conv_0", "kernel"), (3, 2, 4, 6)),
                        (("ConvTranspose_0", "kernel"), (4, 4, 3, 5)),
                        (("TFBatchNorm_0", "BatchNorm_0", "bias"), (7,))):
        x = rng.randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(
            weights.flax_leaf(path, weights.convert_leaf(path, x)), x)


def _bfmnet_tree():
    """The small JAX BFMNet's variable tree, seeded (``_seeded_tree``)."""
    from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
    t = 8
    return _seeded_tree(
        lambda rng, *a: JBFMNet(jax_cfg().bfmnet).init(rng, *a, train=False),
        2, jnp.zeros((1, t, 1)), jnp.zeros((1, t * 5, 80)),
        jnp.full((1,), t, jnp.int32))


def test_name_rows_equal_jax():
    bfm = _bfmnet_tree()
    net = BFMNet(port_cfg().bfmnet)
    strip = lambda rows: [r[:3] for r in rows]
    assert strip(tfc.bfmnet_rows(net)) == strip(
        jtfc.bfmnet_name_map() + jtfc._shortcut_rows(bfm))
    assert strip(tfc.pixrefer_generator_name_map()) == strip(
        jtfc.pixrefer_generator_name_map())
    assert strip(tfc.pixrefer_discriminator_name_map()) == strip(
        jtfc.pixrefer_discriminator_name_map())


@pytest.mark.parametrize("fault", ["renamed", "missing", "misshaped"])
def test_a_faulty_checkpoint_raises_naming_the_variable(fault, tmp_path):
    """A renamed, missing or mis-shaped variable raises a ValueError that
    names it, from the npz and from the TF-bundle entry point alike."""
    from voicepuppet_torch.pipeline.synthesize import SynthesisAssets
    cfg = port_cfg()
    bfm_state, g_state = SynthesisAssets.init_trees(cfg)
    b = tfc.export_arrays(bfm_state, tfc.bfmnet_rows(bfm_state))
    g = tfc.export_arrays(g_state, tfc.pixrefer_generator_name_map())
    name = "rnn_module/dense/kernel"
    if fault == "renamed":
        b["rnn_module/dense_renamed/kernel"] = b.pop(name)
    elif fault == "missing":
        del b[name]
    else:
        b[name] = b[name][:-1]
    tb.write_bundle(b, str(tmp_path / "b" / "m"))
    tb.write_bundle(g, str(tmp_path / "g" / "m"))
    with pytest.raises(ValueError, match="rnn_module/dense/kernel"
                       if fault != "misshaped" else "rnn_in.weight"):
        SynthesisAssets.load_tf_weights(cfg, str(tmp_path / "b" / "m"),
                                        str(tmp_path / "g" / "m"))
    np.savez(tmp_path / "b.npz", **{k.replace("/", "|"): v
                                    for k, v in b.items()})
    np.savez(tmp_path / "g.npz", **{k.replace("/", "|"): v
                                    for k, v in g.items()})
    with pytest.raises(ValueError, match="bfmnet npz"):
        SynthesisAssets.load_npz_weights(cfg, str(tmp_path / "b.npz"),
                                         str(tmp_path / "g.npz"))


def test_write_graphdef_consts_equals_the_test_encoder(tmp_path):
    """The port's frozen-graph writer makes the bytes of the independent
    encoder of tests/test_tf_bundle.py, and both readers read it back."""
    from test_tf_bundle import _encode_graphdef_consts
    rng = np.random.RandomState(4)
    arrays = {"resnet_v1_50/conv1/weights": rng.randn(7, 7, 3, 4).astype(
        np.float32), "resnet_v1_50/logits/biases": rng.randn(5).astype(
        np.float32), "other/steps": np.array([3, 4], np.int64)}
    path = str(tmp_path / "g.pb")
    tb.write_graphdef_consts(arrays, path)
    with open(path, "rb") as f:
        assert f.read() == _encode_graphdef_consts(arrays)
    _assert_arrays_equal(tb.read_graphdef_consts(path), arrays)
    _assert_arrays_equal(jtb.read_graphdef_consts(path), arrays)
    only = tb.read_graphdef_consts(path, name_filter=r"resnet_v1_50")
    assert set(only) == {k for k in arrays if k.startswith("resnet")}
