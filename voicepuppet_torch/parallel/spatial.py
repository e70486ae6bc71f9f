"""The PixRefer generator's forward split by height over a data group.

The JAX ``Synthesizer(mesh_partition="spatial")`` shards the generator's
height over the mesh and lets GSPMD insert the conv halo exchanges
(``voicepuppet_tpu/pipeline/synthesize.py:328-338``).  Here each rank
holds a band of rows of every activation and the exchanges are written
out:

  * Every conv of the U-Net is a 4x4 stride-2 SAME conv: at an even
    height SAME pads one row each side, so output row i reads input rows
    2i-1 .. 2i+2.  Every up-conv is a 4x4 stride-2 transposed conv with
    padding 1: output rows [2a, 2b) read input rows a-1 .. b.  So each
    conv needs one halo row from each neighbour, and zeros at the
    tensor's top and bottom, which is SAME's own padding
    (``GenConv.forward_halo``, ``GenDeconv.forward_halo``).
  * The halo exchange is one ``all_gather`` of every rank's first and
    last row; each rank keeps its neighbours'.  (Point-to-point sends
    are not used: gloo's on CUDA tensors are not assured.)
  * A level stays split while each rank holds an even number of rows,
    at least 2 (:func:`split_level`).  Below that, as at the deep merged
    levels of a 512² generator, the rows are all-gathered and the level
    runs whole on every rank; the decoder takes its rank's rows again at
    the first split level it reaches.  Skip connections concatenate
    tensors of one level, so both halves are split alike.
  * Batch-norm moments at a split level are the float64 sums over
    (batch, rows, width), all-reduced with the element count and divided
    by the global count; at a whole level each rank takes its own
    moments, which are the whole tensor's (no all-reduce: averaging n
    equal float32 values is not always exact).

The wiring is ``Generator.forward``'s own: :class:`RowSplit` supplies
the ops that it runs (``pixrefer.WholeOps``'s six) on split tensors.
Every rank must call :func:`generator_rows` with the same inputs, in the
same order as its other collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from voicepuppet_torch.parallel.mesh import all_gather


def split_level(height: int, world: int) -> bool:
    """True iff a level of ``height`` rows stays split over ``world``
    ranks: each rank's share is even and at least 2."""
    rows, rem = divmod(height, world)
    return rem == 0 and rows >= 2 and rows % 2 == 0


class Part(NamedTuple):
    """An NCHW activation: this rank's rows of it (``split``) or all of
    them."""
    t: torch.Tensor
    split: bool


class RowSplit:
    """The height split of one data group: ``rank`` of ``world``.  Its
    ``enter``, ``leave``, ``act``, ``conv``, ``bn`` and ``cat`` are the
    generator's ops (``pixrefer.WholeOps``) on :class:`Part` tensors."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def take(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's rows (axis ``dim``) of a whole tensor."""
        rows = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * rows, rows)

    def enter(self, x: torch.Tensor) -> Part:
        """A whole input -> this rank's rows of it."""
        return Part(self.take(x), True)

    @staticmethod
    def leave(y: Part) -> torch.Tensor:
        """The output level's rows, which must be split."""
        if not y.split:
            raise AssertionError("the generator's output level is not "
                                 "split")
        return y.t

    @staticmethod
    def act(fn, x: Part) -> Part:
        return Part(fn(x.t), x.split)

    @staticmethod
    def cat(a: Part, b: Part) -> Part:
        if a.split != b.split:
            raise AssertionError("a skip joins a split and a whole level")
        return Part(torch.cat([a.t, b.t], dim=1), a.split)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order: the whole tensor, on every
        rank."""
        return torch.cat(all_gather(x, self.group), 2)

    def with_halo(self, x: torch.Tensor) -> torch.Tensor:
        """Rows ``x`` with the row above (the previous rank's last) and
        the row below (the next rank's first) attached; zero rows at the
        tensor's top and bottom."""
        edges = all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2),
                           self.group)
        zero = torch.zeros_like(x[:, :, :1])
        top = edges[self.rank - 1][:, :, 1:] if self.rank > 0 else zero
        bottom = (edges[self.rank + 1][:, :, :1]
                  if self.rank < self.world - 1 else zero)
        return torch.cat([top, x, bottom], 2)

    def conv(self, module, x: Part) -> Part:
        """A ``GenConv`` or ``GenDeconv`` of ``x``, its output split or
        whole as its level requires."""
        if x.split:
            y = module.forward_halo(self.with_halo(x.t))
            height = y.shape[2] * self.world
        else:
            y = module(x.t)
            height = y.shape[2]
        split = split_level(height, self.world)
        if x.split and not split:
            y = self.gather(y)
        elif split and not x.split:
            y = self.take(y)
        return Part(y, split)

    def bn(self, module, x: Part) -> Part:
        """A ``StatelessBatchNorm`` of ``x``: the moments of the whole
        tensor, all-reduced over the ranks' rows where ``x`` is split."""
        if not x.split:
            return Part(module(x.t), False)
        xf = x.t.float()
        c = xf.shape[1]
        moments = self.moments(xf).float().view(2, 1, c, 1, 1)
        y = module.normalize(xf, moments[0], moments[1])
        return Part(y.to(x.t.dtype), True)

    def moments(self, xf: torch.Tensor) -> torch.Tensor:
        """[2, C] float64 mean and mean of squares over (batch, rows,
        width) of the whole tensor whose rows the ranks hold: the float64
        sums and the element count, all-reduced, then divided."""
        f64 = torch.float64
        count = torch.full((1,), float(xf.numel() // xf.shape[1]),
                           dtype=f64, device=xf.device)
        sums = torch.cat([xf.sum(dim=(0, 2, 3), dtype=f64),
                          torch.square(xf).sum(dim=(0, 2, 3), dtype=f64),
                          count])
        dist.all_reduce(sums, group=self.group)
        return (sums[:-1] / sums[-1]).view(2, -1)


def generator_rows(gen, inputs: torch.Tensor, fg_ref: torch.Tensor,
                   group) -> torch.Tensor:
    """``Generator.forward`` with the height split over ``group``:
    ``inputs`` [B,S,S,6] and ``fg_ref`` [B,S,S,3] (NHWC, in [-1,1]) whole
    on every rank -> this rank's rows [B, S/n, S, 4] of the raw tanh
    output, float32.  ``S`` must split (:func:`split_level`); a group of
    one rank takes the plain forward's rows."""
    if group is None or dist.get_world_size(group) == 1:
        return gen(inputs, fg_ref)
    sp = RowSplit(group)
    s = inputs.shape[1]
    if not split_level(s, sp.world):
        raise ValueError(f"a {s}-row generator does not split over "
                         f"{sp.world} ranks (each needs an even share of "
                         f"at least 2 rows)")
    return gen(inputs, fg_ref, ops=sp)
