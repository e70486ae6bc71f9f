"""The data-parallel layer over ``torch.distributed`` (port of
``voicepuppet_tpu/parallel/mesh.py``).

The JAX package runs every trainer's step as one ``shard_map`` program
over a ``data`` mesh axis: the batch sharded on its rows, the state
replicated, the loss ``pmean``-ed so that autodiff inserts the gradient
psum, and the batch norms' moments ``pmean``-ed across the axis (sync-BN).
Here a process is one rank of a :class:`DataGroup` (torchrun's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), holding one device:

  * each rank runs the forward on its rows of the global batch, the
    batch norms combining their moments across ranks through
    :class:`AllReduceSum` (whose backward sums the moment cotangents, as
    the psum's transpose does);
  * each rank back-propagates its own mean loss, then
    :func:`all_reduce_grads_` averages the gradients once, in one flat
    bucket, before the optimizer clips and steps, so every rank applies
    the same update (the L2 term, in every rank's loss, counts once);
  * :func:`rank_generator` gives each rank its own dropout stream
    (``fold_in(axis_index)``).

With no process group (no torchrun environment) the group is world 1
with ``group`` None and every function here is the identity, so the
single-device path is exactly what it was.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits in a collective for the others before failing
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: its ``rank`` of
    ``world``, its ``device``, and the ``torch.distributed`` process group
    (None when the process trains alone)."""
    rank: int
    world: int
    device: torch.device
    group: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the checkpoints, metrics and images."""
        return self.rank == 0

    def barrier(self):
        """Wait for every rank (nothing to wait for at world 1)."""
        if self.group is not None and self.world > 1:
            dist.barrier(group=self.group)


def _rank_device(device, local_rank: int) -> torch.device:
    """``cuda`` (or None) means ``cuda:LOCAL_RANK``; an explicit index or
    the CPU stays as given."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def make_mesh(device=None) -> DataGroup:
    """The data group of this process.

    An initialized default process group is taken as it is (a caller that
    wants another backend starts its own group first).  Otherwise, under
    torchrun (``WORLD_SIZE`` set) the group is initialized from torchrun's
    environment: NCCL when the rank's device is a card
    (``cuda:LOCAL_RANK``), gloo on the CPU.  With neither, the process
    trains alone: world 1, no group, ``device`` (default the card)."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "WORLD_SIZE" in os.environ:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ["WORLD_SIZE"])
    else:
        return DataGroup(0, 1, _rank_device(device, 0), None)
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", rank=rank, world_size=world,
            timeout=DEFAULT_TIMEOUT)
    return DataGroup(rank, world, dev, dist.group.WORLD)


def world_of(mesh: Optional[DataGroup]) -> int:
    return 1 if mesh is None else mesh.world


def group_of(mesh: Optional[DataGroup]):
    return None if mesh is None else mesh.group


def spans_ranks(group) -> bool:
    """True iff ``group`` is a process group of more than one rank: the
    batch norms combine their moments only then."""
    return group is not None and dist.get_world_size(group) > 1


def mesh_global_batch(requested: int, mesh: Optional[DataGroup],
                      name: str = "batch_size") -> int:
    """Round a global batch size up to a multiple of the world size, with
    a warning (PixRefer's batch 2 becomes 8 on 8 ranks).  A larger batch
    at the same schedule is a training-dynamics divergence from the
    reference's one-GPU batches; padding and masking the extra rows was
    rejected for the reasons the JAX function gives (mesh.py:47-80)."""
    n = world_of(mesh)
    if requested % n == 0:
        return requested
    rounded = -(-requested // n) * n
    logging.getLogger(__name__).warning(
        "%s=%d is not divisible by the %d-device '%s' mesh axis; "
        "rounding up to %d", name, requested, n, "data", rounded)
    return rounded


def _lead(batch: Sequence) -> int:
    leads = {int(np.shape(b)[0]) for b in batch}
    if len(leads) != 1:
        raise ValueError(f"batch fields disagree on their rows: {leads}")
    return leads.pop()


def rank_rows(batch: Sequence, mesh: DataGroup) -> tuple:
    """This rank's rows of the global batch ``batch`` (a tuple of arrays
    or tensors sharing their leading axis), where they lie.  The rows
    must divide over the ranks: size global batches with
    :func:`mesh_global_batch`."""
    lead = _lead(batch)
    n = mesh.world
    if lead % n != 0:
        raise ValueError(
            f"global batch {lead} is not divisible by the {n}-device "
            f"'data' mesh axis; round it up with mesh_global_batch()")
    rows = lead // n
    lo = mesh.rank * rows
    return tuple(b[lo:lo + rows] for b in batch)


def _on(batch: Sequence, device: torch.device) -> tuple:
    return tuple(torch.as_tensor(b).to(device) for b in batch)


def shard_batch(batch: Sequence, mesh: Optional[DataGroup]):
    """This rank's rows of the global host batch (:func:`rank_rows`),
    moved to the rank's device: what the trainers' steps take.  With no
    group the batch is returned as it is."""
    if mesh is None:
        return batch
    return _on(rank_rows(batch, mesh), mesh.device)


def local_batch_rows(global_batch: int, mesh: Optional[DataGroup]) -> int:
    """Rows of the global batch this rank produces for
    :func:`shard_batch_local` (one process is one rank here, so the
    JAX function's device and process counts are both the world)."""
    n = world_of(mesh)
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} must divide both the "
            f"{n}-device 'data' axis and {n} processes")
    return global_batch // n


def shard_batch_local(local_batch: Sequence, mesh: Optional[DataGroup]):
    """The per-rank feed: ``local_batch`` holds only this rank's
    :func:`local_batch_rows` rows; they move to the rank's device and no
    batch data crosses ranks."""
    if mesh is None:
        return local_batch
    _lead(local_batch)
    return _on(local_batch, mesh.device)


def replicate(modules: Iterable[torch.nn.Module],
              mesh: Optional[DataGroup]):
    """Broadcast every parameter and buffer of ``modules`` from rank 0,
    in place, so the ranks start from one state."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return
    with torch.no_grad():
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank), in rank order, on
    every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def gather_to_main(x: torch.Tensor,
                   mesh: DataGroup) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` (one shape on every rank), in rank order, on
    rank 0; None on the other ranks, which receive nothing."""
    x = x.contiguous()
    parts = ([torch.empty_like(x) for _ in range(mesh.world)]
             if mesh.is_main else None)
    dist.gather(x, parts, dst=0, group=mesh.group)
    return parts


class AllReduceSum(torch.autograd.Function):
    """``y = Σ_ranks x``; the backward is the all-reduce sum of the
    cotangents, because every rank's loss depends on every rank's ``x``
    through ``y`` (the transpose of the psum in the JAX sync-BN)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_grads_(params: Iterable[torch.Tensor], group) -> None:
    """Average the ``.grad`` of ``params`` over the ranks of ``group``, in
    place: one flat bucket, one all-reduce, one division by the world
    size.  The counterpart of the gradient psum that autodiff inserts
    after the JAX step's loss ``pmean``; call it after the backward and
    before the optimizer (which clips the averaged gradient).  With
    ``group`` None it does nothing."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(piece.view_as(g))


def pmean_metric(metrics, mesh: Optional[DataGroup]):
    """The mean over the ranks of a scalar tensor, or of each scalar of a
    dict in one all-reduce (for values that do not pass through the
    gradient average, such as the losses).  Identity at world 1."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return metrics
    if isinstance(metrics, dict):
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        return dict(zip(keys, flat.unbind()))
    out = metrics.detach().float().clone()
    dist.all_reduce(out, group=mesh.group)
    return out.div_(mesh.world)


_GOLDEN = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """``seed`` at rank 0 (so one process draws what it always drew) and
    a distinct seed at every other rank (``fold_in(axis_index)``)."""
    return (seed ^ (rank * _GOLDEN)) % (1 << 63)


def rank_generator(seed: int, rank: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for this rank."""
    return torch.Generator(device).manual_seed(rank_seed(seed, rank))
