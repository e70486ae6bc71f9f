"""Checks of the training batch norm (``ops/batchnorm.py``
``TrainBatchNorm``, ``csrc/norm.cu``'s training passes), shared by
``tests/test_torch_bn_train.py`` and ``chip_smoke.py`` (``phase_bn``):

* ``training_shapes``: every BN input of both trainers' steps at the
  training cells' sizes (forward hooks on a meta-device forward, so it
  runs anywhere);
* ``training_bn_split``: one training step with every batch norm watched:
  its elements by grad mode and by x's and dy's layouts, its calls by
  shape, the ``vp.bn.*`` counters and the library's launch count;
* ``check_train_shape`` (card): the passes on one shape and layout against
  ``bn_train_plain`` run on the card (y and the moments bit for bit; dx,
  dw, db bit for bit) and against float64 autograd of the eager formula
  (within ``TRAIN_REL``), and run to run;
* ``step_against_eager`` (card): one training step with the kernels and
  one on the eager formula from the same weights and batch: losses and
  gradient norms;
* ``time_train_shape`` (card): forward and backward ms of the passes, the
  bytes bound, the plain version's and the library's (``F.batch_norm``
  in training mode, a yardstick the port never calls).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from voicepuppet_torch.models import pixflow as pf
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.ops import batchnorm as bn
from voicepuppet_torch.ops.batchnorm_selftest import (EPS, H100_BYTES_PER_S,
                                                      _bn_inputs, _held_ms,
                                                      eager_only)
from voicepuppet_torch.utils import tracing

# The passes against float64 autograd of the eager formula: the largest
# |Δ| of y, dx, dw and db over the largest |float64 value| of each.  Every
# sum runs in float32 over up to 2^18 terms (a few rounding steps of
# 6e-8 each, grown by the sums' depth) and dx cancels three terms of the
# size of dy, so a few 1e-7 is the expected gap: the CPU restatement reads
# 3e-8 to 4e-7 on the trainers' shapes; 2e-6 leaves room for the other
# orders of the card's cut without passing a moment or a gradient summed
# in a lower precision (bf16 sums read ~1e-3).
TRAIN_REL = 2e-6
# A step with the kernels against one on the eager formula (from the same
# weights, batch and dropout): only the order of float32 sums and dx's
# form differ, so the losses and the gradient norms agree to round-off.
# The training cells' limits are ``loss_gap`` 1e-3 and ``grad_gap``
# 1.5e-3 against a plain reference on the eager formula.
STEP_LOSS = 1e-4
STEP_GRAD = 1e-3
# dy forms the backward reads in place (``_dy_strides``) and one it copies.
DY_FORMS = ("same", "slice", "other")


def training_shapes(cfg=None) -> List[Tuple[str, Tuple[int, ...]]]:
    """(label, shape) of every distinct BN input of a training step of
    PixFlow (G at batch 3 with dropout, D at ndf 48) and PixRefer (G at
    batch 2, D at ndf 64), at ``cfg``'s sizes (default ``Config()``)."""
    from types import SimpleNamespace

    from voicepuppet_torch.config import Config
    cfg = cfg or Config()
    out, seen = [], set()

    def add(label, shapes):
        for s in shapes:
            if s not in seen:
                seen.add(s)
                out.append((label, s))

    with torch.device("meta"), torch.no_grad():
        for name, c in (("pixflow", cfg.pixflow), ("pixrefer", cfg.pixrefer)):
            b, s = c.batch_size, c.img_size
            if name == "pixflow":
                g = pf.PixFlowNet(SimpleNamespace(ngf=c.ngf)).generator
                run = lambda: g(torch.zeros(b, s, s, 6),
                                torch.zeros(b, s, s, 6), train=True)
            else:
                g = px.PixReferNet(SimpleNamespace(ngf=c.ngf)).generator
                run = lambda: g(torch.zeros(b, s, s, 6),
                                torch.zeros(b, s, s, 3))
            add(f"{name} G", _bn_inputs(g, run))
            d = px.Discriminator(c.ndf)
            add(f"{name} D", _bn_inputs(d, lambda: d(
                torch.zeros(b, s, s, 3), torch.zeros(b, s, s, 3))))
    return out


TRAINERS = ("pixflow", "pixrefer")


def trainer_step(which: str, device, cfg=None, seed: int = 0):
    """(trainer, state, batch, step keywords) of one training step of
    ``which`` (``TRAINERS``) at ``cfg``'s sizes (default: ``Config()``,
    the training cells' widths, PixFlow batch 3 and PixRefer batch 2),
    float32, fresh weights and a batch uniform in [0, 1] from ``seed``."""
    import numpy as np

    from voicepuppet_torch.config import Config
    cfg = cfg or Config()
    rng = np.random.RandomState(seed)
    if which == "pixflow":
        from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
        tr, c = PixFlowTrainer(cfg, device=device), cfg.pixflow
        chans = (6, 6, 3)
        kw = {"generator": torch.Generator(device=device).manual_seed(seed)}
    else:
        from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
        tr, c = PixReferTrainer(cfg, device=device), cfg.pixrefer
        chans, kw = (6, 6, 3, 3), {}
    s, b = c.img_size, c.batch_size
    batch = tuple(rng.rand(b, s, s, ch).astype(np.float32) for ch in chans)
    return tr, tr.init_state(seed), batch, kw


def layout_of(t: torch.Tensor) -> str:
    """The layout of a 4-D tensor as the training passes tell them apart:
    ``nchw`` (contiguous), ``channels_last``, ``nchw_strided`` (each plane
    contiguous, frames and channels at any stride: a channel slice of an
    NCHW ``cat``), ``rows_strided`` (each pixel's channels contiguous,
    pixels at one row stride: a channel slice of a channels_last ``cat``)
    or ``other``."""
    n, c, h, w = t.shape
    s = t.stride()
    if t.is_contiguous():
        return "nchw"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    if s[3] == 1 and s[2] == w:
        return "nchw_strided"
    if s[1] == 1 and s[2] == w * s[3] and s[0] == h * s[2]:
        return "rows_strided"
    return "other"


def training_bn_split(which: str, device, cfg=None) -> dict:
    """One training step of ``which``: the BN elements by (grad mode, x's
    layout, dy's layout; ``-`` for a call that builds no graph) in
    ``split``, the BN calls by (grad mode, x's layout, shape) in
    ``calls``, the step's ``vp.bn.fused`` and ``vp.bn.eager``, and
    ``launches``, the wrapper calls of ``csrc/norm.cu`` it made
    (``batchnorm.LIBRARY.launches``: three kernel launches each)."""
    tr, state, batch, kw = trainer_step(which, device, cfg)
    split, calls = {}, {}

    def add(table, key, n):
        table[key] = table.get(key, 0) + n

    def watch(m, args, out):
        x = args[0]
        mode = "grad" if out.requires_grad else "no_grad"
        add(calls, (mode, layout_of(x), tuple(x.shape)), 1)
        if mode == "no_grad":
            add(split, ("no_grad", layout_of(x), "-"), x.numel())
            return
        out.register_hook(lambda dy, lx=layout_of(x): add(
            split, ("grad", lx, layout_of(dy)), dy.numel()))

    hooks = [m.register_forward_hook(watch)
             for mod in (state.gen, state.disc) for m in mod.modules()
             if isinstance(m, px.StatelessBatchNorm)]
    try:
        bn.LIBRARY.launches = 0
        with tracing.recording() as rec:
            tr.train_step(state, batch, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        launches = bn.LIBRARY.launches
    finally:
        for h in hooks:
            h.remove()
    return {"split": split, "calls": calls, "launches": launches,
            "fused": rec.counts.get("vp.bn.fused", 0),
            "eager": rec.counts.get("vp.bn.eager", 0)}


def train_inputs(shape, layout: str, device, seed: int = 0,
                 dy_form: str = "same"):
    """x (in ``layout``), weight, bias and dy of one case from ``seed``.
    ``dy_form``: ``same`` (dy in x's layout), ``slice`` (a channel slice of
    a tensor twice as wide in x's layout, as a ``cat``'s backward hands
    it) or ``other`` (the other layout: copied before the passes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    x = (torch.randn(shape, generator=gen, device=device) * 1.7
         + 0.3).contiguous(memory_format=fmt)
    wt = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
    b = 0.1 * torch.randn(c, generator=gen, device=device)
    if dy_form == "slice":
        dy = torch.randn((n, 2 * c, h, w), generator=gen, device=device
                         ).contiguous(memory_format=fmt)[:, c:]
    else:
        other = (torch.contiguous_format if layout == "channels_last"
                 else torch.channels_last)
        dy = torch.randn(shape, generator=gen, device=device).contiguous(
            memory_format=fmt if dy_form == "same" else other)
    return x, wt, b, dy


def eager64(x, weight, bias, dy) -> dict:
    """Float64 autograd of ``StatelessBatchNorm``'s eager formula (batch
    moments): y, dx, dw, db."""
    xd = x.detach().double().requires_grad_(True)
    wd = weight.detach().double().requires_grad_(True)
    bd = bias.detach().double().requires_grad_(True)
    mean = xd.mean((0, 2, 3), keepdim=True)
    mean2 = torch.square(xd).mean((0, 2, 3), keepdim=True)
    inv = torch.rsqrt(mean2 - torch.square(mean) + EPS)
    y = (xd - mean) * inv * wd.view(1, -1, 1, 1) + bd.view(1, -1, 1, 1)
    y.backward(dy.double())
    return {"y": y.detach(), "dx": xd.grad, "dw": wd.grad, "db": bd.grad}


def rel_gaps(got: dict, want: dict) -> dict:
    """Per output, the largest |Δ| over the largest |want|."""
    return {k: float((got[k].double() - want[k]).abs().max()
                     / want[k].abs().max()) for k in ("y", "dx", "dw", "db")}


def check_train_shape(shape, layout: str, device, dy_form: str = "same",
                      seed: int = 0) -> dict:
    """Raise AssertionError unless the passes, on one shape, layout and dy
    form, equal ``bn_train_plain`` run on the same device bit for bit (y,
    mean, mean2, dx, dw, db), come within ``TRAIN_REL`` of float64 eager
    autograd, keep x's layout in y and dx, and repeat run to run.  Returns
    the float64 gaps."""
    x, w, b, dy = train_inputs(shape, layout, device, seed, dy_form)
    y, moments = bn.train_forward(x, w, b, EPS)
    dx, dw, db = bn.train_backward(x, dy, w, moments, EPS)
    y2, m2 = bn.train_forward(x, w, b, EPS)
    dx2, dw2, db2 = bn.train_backward(x, dy, w, moments, EPS)
    plain = bn.bn_train_plain(x, w, b, EPS, dy)
    got = {"y": y, "mean": moments[:, 0], "mean2": moments[:, 1], "dx": dx,
           "dw": dw, "db": db}
    what = f"{tuple(shape)} {layout} dy {dy_form}"
    for k, v in got.items():
        assert torch.equal(v, plain[k].reshape(v.shape)), (
            f"{what}: {k} differs from bn_train_plain by up to "
            f"{float((v - plain[k].reshape(v.shape)).abs().max())}")
    assert (torch.equal(y, y2) and torch.equal(moments, m2)
            and torch.equal(dx, dx2) and torch.equal(dw, dw2)
            and torch.equal(db, db2)), f"{what}: differs run to run"
    assert y.stride() == x.stride() and dx.stride() == x.stride(), what
    gaps = rel_gaps(got, eager64(x, w, b, dy))
    assert max(gaps.values()) < TRAIN_REL, f"{what}: {gaps}"
    return gaps


def _grad_norms(state) -> dict:
    return {f"{name}.{k}": float(p.grad.norm())
            for name, mod in (("G", state.gen), ("D", state.disc))
            for k, p in mod.named_parameters() if p.grad is not None}


def step_against_eager(which: str, device, seed: int = 0) -> dict:
    """One training step of ``which`` with the kernels and one on the
    eager formula, from the same weights, batch and dropout seed: each
    side's losses, its gradient norms (G's and D's leaves after the
    step) and its ``vp.bn.*`` counts; ``loss_gap``, the worst relative
    gap of the losses, and ``grad_gap``, the worst leaf's gap of gradient
    norms over the larger of its and the median leaf's eager norm (the
    benchmark's ``grad_gap``: the conv biases under a BN have a gradient
    of zero in real arithmetic, so their norms are round-off alone).
    TF32 stays off, as the trainers set it."""
    out = {}
    for name, ctx in (("kernels", None), ("eager", eager_only())):
        tr, st, batch, kw = trainer_step(which, device, seed=seed)
        with tracing.recording() as rec:
            if ctx is None:
                _, metrics = tr.train_step(st, batch, **kw)
            else:
                with ctx:
                    _, metrics = tr.train_step(st, batch, **kw)
            torch.cuda.synchronize(device)
        out[name] = {"losses": {k: float(v) for k, v in metrics.items()},
                     "grads": _grad_norms(st),
                     "fused": rec.counts.get("vp.bn.fused", 0),
                     "eager": rec.counts.get("vp.bn.eager", 0)}
    ka, ea = out["kernels"]["grads"], out["eager"]["grads"]
    median = sorted(ea.values())[len(ea) // 2]
    gaps = {k: abs(ka[k] - ea[k]) / max(ea[k], median) for k in ea}
    out["worst_leaf"] = max(gaps, key=gaps.get)
    out["grad_gap"] = gaps[out["worst_leaf"]]
    out["median"] = median
    out["worst_leaves"] = sorted(gaps, key=gaps.get, reverse=True)[:4]
    out["leaf_gaps"] = gaps
    out["loss_gap"] = max(
        abs(out["kernels"]["losses"][k] - v) / max(abs(v), 1e-30)
        for k, v in out["eager"]["losses"].items())
    return out


def time_train_shape(shape, layout: str, device, iters: int = 20) -> dict:
    """On one shape and layout (dy in x's layout): the passes' forward and
    backward ms, the bytes bound of each (forward 3 and backward 5 float32
    passes at 3.35 TB/s), the plain version's ms forward and backward, and
    the library's (``F.batch_norm`` in training mode, no running
    statistics, forward and its backward).  Repeated calls find a tensor
    under 50 MB in L2."""
    x, w, b, dy = train_inputs(shape, layout, device)
    y, moments = bn.train_forward(x, w, b, EPS)
    fwd = _held_ms(lambda: bn.train_forward(x, w, b, EPS), iters)
    bwd = _held_ms(lambda: bn.train_backward(x, dy, w, moments, EPS), iters)
    plain_f = _held_ms(lambda: bn.bn_train_plain(x, w, b, EPS), 2)
    plain_fb = _held_ms(lambda: bn.bn_train_plain(x, w, b, EPS, dy), 2)
    xl = x.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    bl = b.detach().requires_grad_(True)

    def lib_fwd():
        return torch.nn.functional.batch_norm(xl, None, None, wl, bl,
                                              training=True, eps=EPS)

    yl = lib_fwd()
    lib_f = _held_ms(lib_fwd, iters)
    lib_b = _held_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                                 retain_graph=True), iters)
    m = px.StatelessBatchNorm(shape[1]).to(device)
    xe = x.detach().requires_grad_(True)
    with eager_only():
        ye = m(xe)
        eager_f = _held_ms(lambda: m(xe), iters)
    eager_b = _held_ms(lambda: torch.autograd.grad(
        ye, (xe, m.weight, m.bias), dy, retain_graph=True), iters)
    per = 4 * x.numel() / H100_BYTES_PER_S * 1e3
    return {"fwd_ms": fwd, "bwd_ms": bwd, "fwd_bound_ms": 3 * per,
            "bwd_bound_ms": 5 * per, "fwd_ratio": fwd / (3 * per),
            "bwd_ratio": bwd / (5 * per), "plain_fwd_ms": plain_f,
            "plain_bwd_ms": plain_fb - plain_f, "library_fwd_ms": lib_f,
            "library_bwd_ms": lib_b, "eager_fwd_ms": eager_f,
            "eager_bwd_ms": eager_b}
