"""The training experiment entry points of the port
(voicepuppet_torch/experiments/: profile_training, profile_pixrefer_step,
profile_pixrefer_vgg, profile_pixrefer_layers, profile_pixrefer_levers)
run with ``--device cpu`` at the tiny scale (PixRefer ngf 8 at 256² with
a narrow VGG trunk, BFMNet at width-mult 0.25), K = 2 and one round,
their exactness checks passing; and the levers held against the
production layers.

Bands: at float32 the im2col stem and the parity-decomposed transposed
conv within 1e-5 of the output's scale of the production ``GenConv`` /
``GenDeconv`` (the same products summed in another order, measured
~3e-7), the space-to-depth stem alike; at bfloat16 the JAX script's 2e-2
of the scale.
"""

import numpy as np
import pytest
import torch

from voicepuppet_torch.experiments import (profile_pixrefer_layers,
                                           profile_pixrefer_levers,
                                           profile_pixrefer_step,
                                           profile_pixrefer_vgg,
                                           profile_training)

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--scale", "tiny", "--k", "2", "--rounds", "1"]
LEVER_BAND = 1e-5


@pytest.mark.parametrize("which", ["bfmnet", "pixrefer", "ab", "multi",
                                   "pxmulti"])
def test_profile_training_runs(which):
    out = profile_training.main(TINY + ["--which", which, "--bfm_batches",
                                        "2", "--px_batches", "2",
                                        "--multi_k", "2"])
    key = {"bfmnet": "bfmnet", "pixrefer": "pixrefer", "ab": "ab",
           "multi": "multi", "pxmulti": "pxmulti"}[which]
    assert out[key]


def test_profile_pixrefer_step_runs():
    out = profile_pixrefer_step.main(TINY)
    assert len(out) == 11 and "full_step (D+G, 2x adam)" in out


def test_profile_pixrefer_vgg_runs():
    out = profile_pixrefer_vgg.main(TINY)
    assert "full_step bf16 perceptual" in out and "resident" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_pixrefer_layers_runs(dtype):
    rows = profile_pixrefer_layers.main(TINY + ["--batch", "2", "--dtype",
                                                dtype])
    spec = profile_pixrefer_layers.gen_spec(8, 256)
    assert {n for _, n, *_ in spec} < set(rows)
    assert len(spec) == 20          # the generator's 20 convs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_pixrefer_levers_runs(dtype):
    out = profile_pixrefer_levers.main(TINY + ["--batch", "2", "--dtype",
                                               dtype])
    assert set(out["parity"]) == {"encoder_1", "encoder_fg_1", "decoder_1",
                                  "merged2_decoder_2"}


@pytest.mark.parametrize("layer", ["encoder_1", "encoder_fg_1", "decoder_1",
                                   "merged2_decoder_2"])
def test_levers_equal_the_production_layers(layer):
    """The im2col stem and the parity deconv at float32 against the
    production conv at 1e-5 of its output's scale."""
    rng = np.random.RandomState(3)
    levers = profile_pixrefer_levers.lever_cases(8, 64, 2, torch.float32,
                                                 rng, "cpu")
    base, fast, x = levers[layer]
    with torch.no_grad():
        want = base(x)
        got = fast(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=LEVER_BAND * float(want.abs().max()))


@pytest.mark.parametrize("ci", [6, 3])
def test_s2d_stem_equals_the_stem_conv(ci):
    rng = np.random.RandomState(4)
    s2d, conv = profile_pixrefer_layers.s2d_stem(ci, 8, torch.float32, rng,
                                                 "cpu")
    x = torch.as_tensor(rng.rand(2, ci, 32, 32).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        want = conv(x)
        got = s2d(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=LEVER_BAND * float(want.abs().max()))
