"""Data-parallel training of the port's GAN trainers, PixRefer (256², ngf
and ndf 8, the full VGG-16 trunk) and PixFlow (64², ngf and ndf 8), on
two gloo ranks of one spawned group (one row each), against the port's
single-process step on the global batch and the JAX trainers' 2-device
step; the rest of the trainers and the bands' reasons are in
test_torch_train_dp.py.

Each phase averages only the gradients of the network it updates: D's
after D's backward, G's (through the updated D) after G's.  Every G and
D call is a sync-BN collective; PixFlow's two G forwards a step both are.

Tolerances: losses within rel 1e-4; PixFlow's every leaf, and PixRefer's
D, within 1e-4 of the leaf's max |g|; PixRefer's generator is a U-Net of
17 train-mode batch norms whose innermost ones normalize 2 values (one a
rank) and is held as a BN-deep trunk, 0.15 per leaf and 2e-2 in relative
L2.  Measured on the CPU: PixRefer's G <= 2.7e-3 against the
single-process step and <= 1.5e-3 against JAX; PixFlow <= 4.0e-6.
"""

import pytest
import torch

from voicepuppet_torch.parallel.spawn import run_ranks

from _torch_port_cases import (check_dp_grads, check_dp_losses,
                               check_ranks_identical, check_wrong_reduction,
                               dp_payload, dp_rank, dp_rank_runs, dp_run,
                               jax_dp_steps)

torch.set_num_threads(1)

NAMES = ("pixrefer", "pixflow")
STEPS = {"pixrefer": 1, "pixflow": 1}
LOSS_REL = 1e-4
TRUNK = {"pixrefer": r"^gen\.", "pixflow": None}


@pytest.fixture(scope="module")
def payloads():
    return {name: dp_payload(name) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(payloads):
    child = {n: {k: v for k, v in p.items() if k != "jcfg"}
             for n, p in payloads.items()}
    return run_ranks(dp_rank_runs, 2, child, STEPS, None)


@pytest.fixture(scope="module")
def single(payloads):
    return {n: dp_run(n, payloads[n], None, steps=STEPS[n]) for n in NAMES}


@pytest.fixture(scope="module")
def jax2(payloads):
    return {n: jax_dp_steps(n, payloads[n], STEPS[n]) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_dp_losses_match_single_and_jax(ranks, single, jax2, name):
    check_dp_losses(ranks, single, jax2, name, LOSS_REL)


@pytest.mark.parametrize("ref", ["single", "jax"])
@pytest.mark.parametrize("name", NAMES)
def test_dp_grads_match(ranks, single, jax2, name, ref):
    check_dp_grads(ranks, single, jax2, name, ref, TRUNK[name])


@pytest.mark.parametrize("control", ["twice", "half", "no_average"])
@pytest.mark.parametrize("name", NAMES)
def test_wrong_reduction_breaks_the_bands(ranks, single, name, control):
    check_wrong_reduction(ranks, single, name, control, TRUNK[name])


@pytest.mark.parametrize("name", NAMES)
def test_ranks_stay_bit_identical(ranks, name):
    check_ranks_identical(ranks, name)


@pytest.mark.parametrize("name", NAMES)
def test_each_phase_averages_its_own_network(ranks, name):
    """The D phase averages D's gradients and the G phase G's: every
    parameter's gradient was averaged exactly once in the step."""
    row = dp_rank(ranks, name)["steps"][0]
    assert set(row["averaged"]) == set(row["grads"])
    assert set(row["averaged"].values()) == {1}
    assert {k.split(".")[0] for k in row["averaged"]} == {"gen", "disc"}
