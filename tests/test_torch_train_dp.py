"""Data-parallel training of the PyTorch port (voicepuppet_torch/parallel,
the sync-BN of models/layers.py, the trainers' ``mesh=``): BFMNet, ATNet
and VGNet on two gloo ranks of one spawned group, against the port's
single-process step on the whole global batch and against the JAX
trainers' ``data_parallel_step`` on 2 virtual CPU devices, from the same
parameters and batch (``_torch_port_cases.dp_payload``: the small
widths, dropout off).  The GAN trainers are in test_torch_train_dp_gan.py
(one group per module, so ``--dist loadfile`` spreads them).

Each trainer takes one SGD step at lr 1 (VGNet two: its D phase, then
its G phase), whose averaged gradients are compared, and three steps
with the reference Adams, after which the ranks must hold the same
parameters and buffers to the bit.

Tolerances (``grad_bands``): losses within rel 1e-4; a leaf after the
batch-norm trunk within 1e-4 of its max |g|; a leaf in a trunk of stacked
train-mode batch norms (BFMNet's and ATNet's MfccNet, VGNet's ThinNet)
within 0.15 of its max |g| and the trunk's gradients within 2e-2 in
relative L2 (the single-process trainers' bands: float32 backward
through 20 train-mode BNs is ill-conditioned, see
test_torch_train_bfmnet.py); leaves whose true
gradient is zero (|g| < 1e-4 on the reference) held by magnitude;
running BN moments within 1e-6.  Measured on the CPU: BFMNet's trunk
0.066 of a leaf's max against the single-process step and 0.035 against
JAX; ATNet's and VGNet's trunks <= 3.6e-5 and every other leaf <= 5.7e-5
(VGNet's ``landmark_encoder1``); losses <= 7.3e-7 (BFMNet's
``grad_norm``, a norm over the trunk's gradients too, is held by the
gradient bands, not as a loss).  The controls: twice or half the
averaged gradient, or a rank's own gradient without the average, break
the bands.
"""

import os

import numpy as np
import pytest
import torch

from voicepuppet_torch.parallel.spawn import run_ranks

from _torch_port_cases import (check_dp_grads, check_dp_losses,
                               check_ranks_identical, check_wrong_reduction,
                               dp_payload, dp_rank, dp_rank_runs, dp_run,
                               jax_dp_steps)

torch.set_num_threads(1)

NAMES = ("bfmnet", "atnet", "vgnet")
STEPS = {"bfmnet": 1, "atnet": 1, "vgnet": 2}
LOSS_REL = 1e-4
MOMENT_ATOL = 1e-6
TRUNK = {"bfmnet": r"^model\.mfcc_encoder\.MfccNet_0\.",
         "atnet": r"^model\.mfcc_net\.",
         "vgnet": r"^gen\.genbase_thinnet\."}


@pytest.fixture(scope="module")
def payloads():
    return {name: dp_payload(name) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(payloads, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_fit"))
    child = {n: {k: v for k, v in p.items() if k != "jcfg"}
             for n, p in payloads.items()}
    return run_ranks(dp_rank_runs, 2, child, STEPS, tmp), tmp


@pytest.fixture(scope="module")
def single(payloads):
    return {n: dp_run(n, payloads[n], None, steps=STEPS[n]) for n in NAMES}


@pytest.fixture(scope="module")
def jax2(payloads):
    return {n: jax_dp_steps(n, payloads[n], STEPS[n]) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_dp_losses_match_single_and_jax(ranks, single, jax2, name):
    check_dp_losses(ranks[0], single, jax2, name, LOSS_REL)


@pytest.mark.parametrize("ref", ["single", "jax"])
@pytest.mark.parametrize("name", NAMES)
def test_dp_grads_match(ranks, single, jax2, name, ref):
    check_dp_grads(ranks[0], single, jax2, name, ref, TRUNK[name])


@pytest.mark.parametrize("name", NAMES)
def test_dp_moments_match_single_and_jax(ranks, single, jax2, name):
    got = dp_rank(ranks[0], name)["state"]
    flat = {f"{m}.{k}": v for m, sd in got.items() for k, v in sd.items()}
    one = single[name]["state"]
    flat_one = {f"{m}.{k}": v for m, sd in one.items()
                for k, v in sd.items()}
    want = jax2[name][-1]["moments"]
    assert want
    for k, w in want.items():
        np.testing.assert_allclose(flat[k], w, rtol=0, atol=MOMENT_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(flat[k], flat_one[k], rtol=0,
                                   atol=MOMENT_ATOL, err_msg=k)


@pytest.mark.parametrize("control", ["twice", "half", "no_average"])
@pytest.mark.parametrize("name", NAMES)
def test_wrong_reduction_breaks_the_bands(ranks, single, name, control):
    """A doubled or missing reduction falls outside the bands that the
    true one sits in (test_dp_grads_match)."""
    check_wrong_reduction(ranks[0], single, name, control, TRUNK[name])


@pytest.mark.parametrize("name", NAMES)
def test_ranks_stay_bit_identical(ranks, name):
    """Three steps with the reference Adams (clip by global norm after the
    average), and the SGD steps' gradients: the same on both ranks."""
    check_ranks_identical(ranks[0], name)


def test_fit_rank0_writes_and_every_rank_restores(ranks):
    """``fit`` for 4 steps (eval and save every 2) on both ranks: one
    checkpoint stream and one metrics stream, rank 0's; the eval grid's
    hook on rank 0 alone; every rank restores rank 0's final state."""
    res, tmp = ranks
    assert sorted(os.listdir(os.path.join(tmp, "ckpt"))) == [
        "ckpt_2.pt", "ckpt_4.pt"]
    rows = open(os.path.join(tmp, "log0", "bfmnet_metrics.jsonl")).read()
    assert len(rows.splitlines()) == 4 + 2       # 4 steps, 2 evals
    assert open(os.path.join(tmp, "log1",
                             "bfmnet_metrics.jsonl")).read() == ""
    assert res[0]["fit"]["evals"] == [2, 4] and res[1]["fit"]["evals"] == []
    for r in (0, 1):
        fit = res[r]["fit"]
        assert fit["restored_step"] == 4
        for k, v in res[0]["fit"]["state"]["model"].items():
            assert np.array_equal(fit["restored"]["model"][k], v), k


def test_dryrun_multihost_main():
    from voicepuppet_torch.experiments import dryrun_multihost
    assert dryrun_multihost.main([]) == 0
