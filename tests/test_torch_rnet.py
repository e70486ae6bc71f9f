"""The port's R-Net identity path (voicepuppet_torch/pipeline/rnet.py)
against the JAX package's, on the CPU with the same weights (JAX
``init_rnet(0)`` with perturbed BN statistics, bridged by
voicepuppet_torch/weights.py).

Both sides are float32 through 53 conv layers with BN, summing in their
own orders; the coefficients are O(300) on random input, and the measured
max |diff| is ~5e-4 (~2e-6 relative), so the band is 1e-5 of the output's
scale.
"""

import json
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from voicepuppet_tpu.pipeline import rnet as jrnet

from voicepuppet_torch import weights
from voicepuppet_torch.models.layers import max_pool_same
from voicepuppet_torch.pipeline import rnet as trnet

torch.set_num_threads(1)

REL_BAND = 1e-5


@pytest.fixture(scope="module")
def jax_rnet():
    """JAX ``init_rnet(0)`` once per module, BN moments perturbed so the
    bridge of the moving statistics is exercised."""
    model, v = jrnet.init_rnet(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, {"params": v["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def port_rnet(jax_rnet):
    net = trnet.RNet()
    net.load_state_dict(weights.state_dict_from_flax(jax_rnet[1]))
    return net.eval()


def _image(seed=0):
    return (np.random.RandomState(seed).rand(1, 224, 224, 3) * 255).astype(
        np.float32)


def _close(got, want):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= REL_BAND * scale, (
        np.abs(got - want).max(), scale)


def test_rnet_matches_jax_on_one_image(jax_rnet, port_rnet):
    model, variables = jax_rnet
    x = _image()
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_rnet(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (1, 257)
    _close(got, want)


@pytest.mark.parametrize("size", [8, 112])
def test_max_pool_pads_after_only(size):
    """TF 'SAME' 3x3/2 over an even size pads 0 before and 1 after.  On a
    ramp whose maximum lies in the last row and column every window's
    maximum is its last element, so a pool padded on both sides
    (``nn.MaxPool2d(3, 2, padding=1)``) is off everywhere."""
    ramp = np.add.outer(np.arange(size), np.arange(size)).astype(np.float32)
    x = np.broadcast_to(ramp, (1, 2, size, size)).copy()
    want = np.asarray(fnn.max_pool(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.as_tensor(x), (3, 3), (2, 2)).numpy()
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))
    symmetric = torch.nn.MaxPool2d(3, 2, padding=1)(torch.as_tensor(x))
    assert symmetric.shape == got.shape
    assert (symmetric.numpy() != got).mean() > 0.9


def test_name_rows_equal_jax_and_the_fixture(port_rnet):
    rows = trnet._rnet_name_rows()
    assert rows == jrnet._rnet_name_rows()
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "rnet_names.json")) as f:
        fixture = json.load(f)
    assert {r[0] for r in rows} == set(fixture)
    own = port_rnet.state_dict()
    assert {weights.state_key_for(r[2]) for r in rows} == set(own)
    arrays = trnet.export_rnet_arrays(own)
    for name, shape in fixture.items():
        assert list(arrays[name].shape) == shape, name


def test_from_pb_loads_a_graphdef(jax_rnet, port_rnet, tmp_path):
    """``from_pb`` on a frozen GraphDef written by the encoder of
    tests/test_tf_bundle.py (one node per variable, concatenated), and
    ``from_npz`` on the same arrays: both give the bridged weights exactly,
    and a GraphDef without one variable raises naming it."""
    from test_tf_bundle import _encode_graphdef_consts
    arrays = trnet.export_rnet_arrays(port_rnet.state_dict())
    pb = tmp_path / "FaceReconModel.pb"
    with open(pb, "wb") as f:
        for name, arr in arrays.items():
            f.write(_encode_graphdef_consts({name: arr}))
    np.savez(tmp_path / "rnet.npz",
             **{k.replace("/", "|"): v for k, v in arrays.items()})
    want = port_rnet.state_dict()
    lm3d = np.zeros((5, 3))
    for provider in (
            trnet.RNetIdentityProvider.from_pb(str(pb), lm3d, device="cpu"),
            trnet.RNetIdentityProvider.from_npz(str(tmp_path / "rnet.npz"),
                                                lm3d, device="cpu")):
        got = provider.model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    drop = "resnet_v1_50/block2/unit_3/bottleneck_v1/conv2/weights"
    with open(pb, "wb") as f:
        for name, arr in arrays.items():
            if name != drop:
                f.write(_encode_graphdef_consts({name: arr}))
    with pytest.raises(ValueError, match=drop):
        trnet.RNetIdentityProvider.from_pb(str(pb), lm3d, device="cpu")


def test_identity_provider_matches_jax(jax_rnet, port_rnet):
    """Image + 68 landmarks -> Identity through the whole provider (68 -> 5
    points, POS alignment, BGR crop, R-Net) on both sides."""
    from voicepuppet_tpu.pipeline import detect as jdetect
    from voicepuppet_torch.pipeline import detect as tdetect
    model, variables = jax_rnet
    img = (np.random.RandomState(1).rand(300, 260, 3) * 255).astype(
        np.uint8)
    lm3d = np.random.RandomState(2).randn(5, 3) * 0.3
    jal = jdetect.sat_alignment(img, jdetect.CenteredFaceProvider())
    tal = tdetect.sat_alignment(img, tdetect.CenteredFaceProvider())
    want = jrnet.RNetIdentityProvider(variables=variables, lm3d=lm3d)(
        *jal[2:])
    provider = trnet.RNetIdentityProvider(port_rnet.state_dict(), lm3d,
                                          device="cpu")
    got = provider(*tal[2:])
    np.testing.assert_array_equal(got.transform_params,
                                  want.transform_params)
    assert (got.center_x, got.center_y, got.ratio, got.colors_bgr) == (
        want.center_x, want.center_y, want.ratio, want.colors_bgr)
    assert got.bfmcoeff.shape == (1, 257)
    _close(got.bfmcoeff, np.asarray(want.bfmcoeff))


def test_seeded_init_calibrates_the_moments():
    """init_rnet_ with a calibration batch keeps the coefficients
    O(head_gain): finite, nonzero, |c| < 1 on other input."""
    gen = torch.Generator().manual_seed(0)
    calib = torch.rand((2, 224, 224, 3), generator=gen) * 255
    net = trnet.init_rnet_(trnet.RNet(), gen, calib).eval()
    with torch.no_grad():
        out = net(torch.as_tensor(_image(3)))
    assert torch.isfinite(out).all()
    assert 0 < float(out.abs().max()) < 1.0
