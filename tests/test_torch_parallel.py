"""The data-parallel layer of the PyTorch port (voicepuppet_torch/parallel/
mesh.py, spawn.py and the sync-BN of models/layers.py, pixrefer.py,
vgnet.py) against the JAX package's ``parallel/mesh.py`` and against one
process on the whole batch.  One spawned group of two gloo ranks on the
CPU (``run_ranks``: a ``file://`` store in a temporary directory, one
thread a rank) computes everything that needs ranks; the batch is numpy,
seeded.

Tolerances: sync moments within 1e-6 of ``batch_moments`` on the
concatenated batch and each BN form's outputs within 1e-6 of the
single-process forward (float32 of values near 1); input and parameter
gradients within 1e-5 (float32 sums of a few hundred products); a group
of one rank, the integer batch arithmetic and the collectives of exact
values to the bit.
"""

import jax
import numpy as np
import pytest
import torch

from voicepuppet_tpu.parallel import mesh as jmesh

from voicepuppet_torch.models.layers import batch_moments
from voicepuppet_torch.parallel import mesh as pm
from voicepuppet_torch.parallel.spawn import run_ranks

from _torch_port_cases import BN_FORMS, bn_case, parallel_rank_checks

torch.set_num_threads(1)

B, C, H, W = 4, 3, 5, 6
MOMENT_ATOL = 1e-6
GRAD_ATOL = 1e-5


def _group(world, rank=0):
    """A data group of ``world`` ranks seen from ``rank``, with no process
    group (the batch arithmetic needs none)."""
    return pm.DataGroup(rank, world, torch.device("cpu"), None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    x = (rng.randn(B, C, H, W) * 2 + 0.5).astype(np.float32)
    r = rng.randn(B, C, H, W).astype(np.float32)
    return x, r


@pytest.fixture(scope="module")
def ranks(data):
    return run_ranks(parallel_rank_checks, 2, *data)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("requested", [1, 2, 3, 4, 5, 8, 16])
def test_mesh_global_batch_equals_jax(requested, n):
    want = jmesh.mesh_global_batch(requested,
                                   jmesh.make_mesh(jax.devices()[:n]))
    assert pm.mesh_global_batch(requested, _group(n)) == want


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("global_batch", [2, 4, 6, 8, 12, 16])
def test_local_batch_rows_and_errors_equal_jax(monkeypatch, global_batch,
                                               n):
    """One process is one rank here, so the JAX function is asked with as
    many processes as devices."""
    monkeypatch.setattr(jax, "process_count", lambda: n)
    jm = jmesh.make_mesh(jax.devices()[:n])
    try:
        want = jmesh.local_batch_rows(global_batch, jm)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pm.local_batch_rows(global_batch, _group(n))
        assert str(got.value) == str(exc)
    else:
        assert pm.local_batch_rows(global_batch, _group(n)) == want


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_batch_rows_equal_jax_shards(data, n):
    x, r = data
    sharded = jmesh.shard_batch((x, r), jmesh.make_mesh(jax.devices()[:n]))
    for rank in range(n):
        got = pm.shard_batch((x, r), _group(n, rank))
        assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu"
                   for g in got)
        for g, arr in zip(got, sharded):
            shard = [s for s in arr.addressable_shards
                     if s.device == jax.devices()[rank]][0]
            np.testing.assert_array_equal(g.numpy(), np.asarray(shard.data))


def test_shard_batch_errors_equal_jax(data):
    x, _ = data
    with pytest.raises(ValueError) as want:
        jmesh.shard_batch((x[:3],), jmesh.make_mesh(jax.devices()[:2]))
    with pytest.raises(ValueError) as got:
        pm.shard_batch((x[:3],), _group(2))
    assert str(got.value) == str(want.value)


def test_no_group_is_the_identity(monkeypatch, data):
    """Outside torchrun the process trains alone: world 1, no group, and
    the batch, gradients and metrics pass untouched."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pm.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu") and mesh.is_main
    batch = data
    assert pm.shard_batch(batch, None) is batch
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.arange(3.0)
    pm.all_reduce_grads_([p], None)
    assert p.grad.tolist() == [0.0, 1.0, 2.0]
    m = {"loss": torch.tensor(2.0)}
    assert pm.pmean_metric(m, mesh) is m
    assert pm.rank_seed(5, 0) == 5


def test_group_layout_and_feed(ranks, data):
    x, _ = data
    for r, out in enumerate(ranks):
        assert (out["rank"], out["world"], out["rows"]) == (r, 2, B // 2)
        assert out["device"] == "cpu"
        assert out["local_is_rows"]
        assert out["metric"] == 0.5
        np.testing.assert_array_equal(out["replicated"], 0.0)


def test_sync_moments_equal_the_whole_batch(ranks, data):
    x, _ = data
    mean, var = batch_moments(torch.as_tensor(x))
    for out in ranks:
        np.testing.assert_allclose(out["moments"][0], mean.numpy(),
                                   rtol=0, atol=MOMENT_ATOL)
        np.testing.assert_allclose(out["moments"][1], var.numpy(),
                                   rtol=0, atol=MOMENT_ATOL)


@pytest.mark.parametrize("form", BN_FORMS)
def test_sync_bn_forward_and_grads_equal_the_whole_batch(ranks, data, form):
    """Each rank's rows of the output and of the input gradient are the
    single process's rows; the parameter gradients, averaged over the
    ranks as the trainers average them, are the single process's
    divided by the world (its loss is the sum of the ranks' losses);
    running moments equal on every rank and to the single process's."""
    x, r = data
    y, dx, grads, bufs = bn_case(form, x, r)
    n = B // 2
    for k, out in enumerate(ranks):
        yk, dxk, _, bufk = out["bn"][form]
        np.testing.assert_allclose(yk, y[k * n:(k + 1) * n], rtol=0,
                                   atol=MOMENT_ATOL)
        np.testing.assert_allclose(dxk, dx[k * n:(k + 1) * n], rtol=0,
                                   atol=GRAD_ATOL)
        for name, g in grads.items():
            np.testing.assert_allclose(out["averaged"][form][name] * 2, g,
                                       rtol=0, atol=GRAD_ATOL)
        for name, b in bufs.items():
            np.testing.assert_allclose(bufk[name], b, rtol=0,
                                       atol=MOMENT_ATOL)
            np.testing.assert_array_equal(bufk[name],
                                          ranks[0]["bn"][form][3][name])


@pytest.mark.parametrize("form", BN_FORMS)
def test_local_moments_differ_from_the_whole_batch(ranks, data, form):
    """The control: a rank's rows normalized by their own moments are
    far from the whole batch's normalization."""
    x, r = data
    y = bn_case(form, x, r)[0]
    own = bn_case(form, x[:B // 2], r[:B // 2])[0]
    assert np.abs(own - y[:B // 2]).max() > 100 * MOMENT_ATOL


def test_all_reduce_sum_backward_sums_the_cotangents(ranks):
    """y = Σ_ranks c_r x; loss_r = Σ y v_r, so dx_r = c_r (v_0 + v_1)."""
    v = [1.0, 4.0]
    c = [out["allreduce"][2] for out in ranks]
    for k, out in enumerate(ranks):
        y, dx, ck = out["allreduce"]
        np.testing.assert_array_equal(y, np.arange(4.0) * sum(c))
        np.testing.assert_array_equal(dx, np.full(4, ck * sum(v)))


def test_dropout_masks_differ_per_rank(ranks):
    m0, m1 = ranks[0]["mask"], ranks[1]["mask"]
    assert not np.array_equal(m0, m1)
    want = torch.ones(64)
    keep = torch.rand(64, generator=torch.Generator().manual_seed(0)) < 0.5
    np.testing.assert_array_equal(m0, torch.where(keep, want / 0.5,
                                                  0.0).numpy())


@pytest.mark.parametrize("form", BN_FORMS)
def test_group_of_one_rank_is_bit_equal_to_none(ranks, form):
    for out in ranks:
        solo, none = out["solo"][form]
        for a, b in zip(solo[:2], none[:2]):
            np.testing.assert_array_equal(a, b)
        for part in (2, 3):
            for k in solo[part]:
                np.testing.assert_array_equal(solo[part][k], none[part][k])
        got, want = out["solo_grads"]
        np.testing.assert_array_equal(got, want)


def _chip_smoke():
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_frozen_kinks_replays_the_recorded_pieces():
    """chip_smoke.py's ``frozen_kinks`` (phase 22): a run replaying a
    recorded run's leaky ReLU and |.| signs, as rank 1 of two, keeps the
    recorded slopes on its rows where an input has crossed a kink, and
    otherwise computes what the functions compute, to the bit."""
    import torch.nn.functional as F
    fk = _chip_smoke().frozen_kinks
    x = torch.tensor([[1.0, -2.0, 3e-7], [-4e-7, 2.0, -3.0],
                      [5e-7, -1.0, 0.5], [1.5, 2e-7, -0.25]])
    c = torch.tensor([0.5, -0.3, 0.1])

    def grad(v, kinks):
        v = v.clone().requires_grad_(True)
        with kinks:
            loss = torch.abs(F.leaky_relu(v, negative_slope=0.2) - c).sum()
        loss.backward()
        return loss.detach(), v.grad

    rec = fk()
    _, want = grad(x, rec)
    assert len(rec.masks) == 2
    plain_loss, plain = grad(x, fk(rec.masks))
    assert torch.equal(plain, want)
    nudged = x[2:] * torch.tensor([[-1.0, 1.0, 1.0], [1.0, -1.0, 1.0]])
    _, got = grad(nudged, fk(rec.masks, rank=1))
    assert torch.equal(got, want[2:])
    free = fk(rank=1)
    _, moved = grad(nudged, free)
    assert not torch.equal(moved, want[2:])
    assert free.flips(rec.masks) == 2   # the two leaky ReLU inputs
    with pytest.raises(AssertionError, match="recorded"):
        grad(x[:1, :2], fk(rec.masks))
