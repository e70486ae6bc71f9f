"""The training batch norm (``ops/batchnorm.py`` ``TrainBatchNorm``,
``csrc/norm.cu``'s training passes) and its dispatch in
``StatelessBatchNorm.forward``.

CPU: ``bn_train_plain``, the passes' order of float32 operations restated
in torch, forward and backward, against float64 autograd of the eager
formula on every training BN shape of both trainers in both layouts
(within ``TRAIN_REL``: the reason is beside it in
``ops/batchnorm_train_selftest.py``); ``gradcheck`` in float64 on the
passes' order as a test-local Function (the Function itself refuses a
CPU tensor); y, dx, dw and db against ``jax.vjp`` of the JAX package's
``StatelessBatchNorm`` on every training shape in both layouts (within
``JAX_TRAIN_REL``); which calls the dispatch sends to the Function, to
the eager formula counted, and uncounted (a CPU tensor that reports
``is_cuda``, ``_CudaLooking``, with the device check lifted and the
Function replaced by a recorder); the cut of every training shape; the
dy forms the backward reads in place.

Card (marked ``card``; skipped without CUDA): the passes bit-equal to
``bn_train_plain`` on the card and within ``TRAIN_REL`` of float64 on
every training shape and layout, and within ``JAX_TRAIN_REL`` of the JAX
module run on the host; both trainers' steps sending at least
95% of their BN elements through the kernels; a step of each with the
kernels against one on the eager formula.  On the card: ``python -m
pytest tests/test_torch_bn_train.py -m card -q``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.autograd.function import once_differentiable

from test_torch_bn_fused import _jax_bn_call
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.ops import batchnorm as bn
from voicepuppet_torch.ops import batchnorm_train_selftest as ts
from voicepuppet_torch.utils import tracing

EPS = ts.EPS
CPU = torch.device("cpu")

# Every distinct BN input of a training step (``ts.training_shapes``):
# PixFlow at batch 3 (G with dropout, D at ndf 48), PixRefer at batch 2
# (G, D at ndf 64), 512².
TRAIN_SHAPES = [
    (3, 128, 128, 128), (3, 256, 64, 64), (3, 512, 32, 32),
    (3, 512, 64, 64), (3, 256, 128, 128), (3, 128, 256, 256),
    (3, 96, 128, 128), (3, 192, 64, 64), (3, 384, 63, 63),
    (2, 128, 128, 128), (2, 128, 64, 64), (2, 256, 32, 32),
    (2, 256, 16, 16), (2, 512, 8, 8), (2, 512, 4, 4), (2, 512, 2, 2),
    (2, 64, 256, 256), (2, 256, 64, 64), (2, 512, 63, 63)]
LAYOUTS = ("nchw", "channels_last")
# The passes against ``jax.vjp`` of the JAX module (float32 both): the
# largest |Δ| of y, dx, dw and db over the largest |JAX value| of each.
# XLA's CPU reductions sum in another order, so the JAX side is what
# moves: on the training shapes below it reads 1.9e-7 to 2.0e-6 from
# float64 (dw, db the farthest; the passes read below 4e-7), and the
# passes 2.4e-7 to 2.0e-6 from it; 1e-5 leaves 5x room, while a backward
# fed dy rounded to bf16 reads ~1e-3.
JAX_TRAIN_REL = 1e-5


def test_training_shapes():
    """The list above is what the trainers' modules give (meta device)."""
    assert [s for _, s in ts.training_shapes()] == TRAIN_SHAPES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_plain_vs_float64(shape, layout):
    """``bn_train_plain`` in float32 (the kernels' order) against float64
    autograd of the eager formula: y, dx, dw and db within ``TRAIN_REL``
    of the largest float64 value of each."""
    x, w, b, dy = ts.train_inputs(shape, layout, CPU, seed=shape[1])
    got = bn.bn_train_plain(x, w, b, EPS, dy)
    assert got["y"].dtype == torch.float32
    gaps = ts.rel_gaps(got, ts.eager64(x, w, b, dy))
    assert max(gaps.values()) < ts.TRAIN_REL, gaps


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tolerance_fails_bf16_sums(layout):
    """The yardstick: the same passes fed dy rounded to bf16 (a backward
    summed in a lower precision) read far outside ``TRAIN_REL``."""
    x, w, b, dy = ts.train_inputs((3, 96, 32, 32), layout, CPU)
    got = bn.bn_train_plain(x, w, b, EPS, dy.bfloat16().float())
    gaps = ts.rel_gaps(got, ts.eager64(x, w, b, dy))
    assert min(gaps["dx"], gaps["dw"], gaps["db"]) > 100 * ts.TRAIN_REL, gaps


class _PlainFunction(torch.autograd.Function):
    """``bn_train_plain`` as an autograd Function: the passes' forward and
    backward in torch (float64 for a float64 x), for ``gradcheck``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return bn.bn_train_plain(x, weight, bias, eps)["y"]

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        r = bn.bn_train_plain(x, weight, bias, ctx.eps, dy)
        return r["dx"], r["dw"], r["db"], None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (3, 4, 2, 2), (1, 2, 3, 1)],
                         ids=str)
def test_gradcheck(shape, layout):
    """The passes' order of operations in float64 (``_PlainFunction``):
    their backward is the derivative of their forward
    (``torch.autograd.gradcheck``)."""
    gen = torch.Generator().manual_seed(0)
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).contiguous(
        memory_format=fmt).requires_grad_(True)
    w = (1 + 0.1 * torch.randn(shape[1], generator=gen,
                               dtype=torch.float64)).requires_grad_(True)
    b = (0.1 * torch.randn(shape[1], generator=gen,
                           dtype=torch.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w, b: _PlainFunction.apply(x, w, b, EPS), (x, w, b))


def test_function_cpu_route_matches_plain():
    """On the CPU ``TrainBatchNorm`` refuses (the dispatch never sends it
    a CPU tensor), and the test-local ``_PlainFunction`` gives
    ``bn_train_plain``'s outputs forward and backward, in x's layout."""
    x, w, b, dy = ts.train_inputs((3, 8, 6, 6), "channels_last", CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn.train_bn(x, w, b, EPS)
    want = bn.bn_train_plain(x, w, b, EPS, dy)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = _PlainFunction.apply(xg, wg, b, EPS)
    y.backward(dy)
    assert torch.equal(y.detach(), want["y"])
    assert torch.equal(xg.grad, want["dx"]) and torch.equal(wg.grad,
                                                            want["dw"])
    assert y.stride() == x.stride()


@functools.lru_cache(maxsize=None)
def _jax_vjp():
    """``jax.vjp`` of the JAX package's ``StatelessBatchNorm`` (its source,
    as ``test_torch_bn_fused`` loads it), jitted on JAX's CPU backend:
    ``f(x, scale, bias, dy)`` on NHWC arrays gives (y, dx, dscale,
    dbias)."""
    import jax
    run = _jax_bn_call()

    def fwd_bwd(x, scale, bias, dy):
        y, pull = jax.vjp(run, x, scale, bias)
        return (y,) + pull(dy)

    return jax.jit(fwd_bwd)


def _jax_train(x, w, b, dy) -> dict:
    """The JAX module's y, dx, dw and db on the host for NCHW torch
    inputs (any device, any layout), as float64 NCHW torch tensors."""
    import jax.numpy as jnp

    def nhwc(t):
        return jnp.asarray(t.detach().cpu().permute(0, 2, 3, 1)
                           .contiguous().numpy())

    y, dx, dw, db = _jax_vjp()(nhwc(x), jnp.asarray(w.detach().cpu().numpy()),
                               jnp.asarray(b.detach().cpu().numpy()),
                               nhwc(dy))
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a)).double().permute(0, 3, 1, 2)
    return {"y": back(y), "dx": back(dx),
            "dw": torch.from_numpy(np.array(dw)).double(),
            "db": torch.from_numpy(np.array(db)).double()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_plain_against_jax(shape, layout):
    """``bn_train_plain`` (the kernels' order, which the card's passes
    equal bit for bit) against ``jax.vjp`` of the JAX module on the same
    x, scale, bias and dy: y, dx, dw and db within ``JAX_TRAIN_REL`` of
    the largest JAX value of each."""
    x, w, b, dy = ts.train_inputs(shape, layout, CPU, seed=shape[1])
    gaps = ts.rel_gaps(bn.bn_train_plain(x, w, b, EPS, dy),
                       _jax_train(x, w, b, dy))
    assert max(gaps.values()) < JAX_TRAIN_REL, gaps


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_tolerance_fails_bf16_sums(layout):
    """The yardstick: the passes fed dy rounded to bf16 read far outside
    ``JAX_TRAIN_REL`` of the JAX module in dx, dw and db."""
    x, w, b, dy = ts.train_inputs((3, 96, 32, 32), layout, CPU)
    got = bn.bn_train_plain(x, w, b, EPS, dy.bfloat16().float())
    gaps = ts.rel_gaps(got, _jax_train(x, w, b, dy))
    assert min(gaps["dx"], gaps["dw"], gaps["db"]) > 10 * JAX_TRAIN_REL, gaps


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_plans(shape, layout):
    """The cut of every training shape: NCHW slices of whole rounds of
    256 vectors, at most ``MAX_SLICES`` a channel, 16-byte loads but on
    D's 63x63 plane; channels_last the served cut of a batch."""
    n, c, h, w = shape
    if layout == "nchw":
        pp = bn.planes_plan(shape, 4 if h * w % 4 == 0 else 1)
        assert pp.vec == (1 if h == 63 else 4)
        assert pp.slice % bn.THREADS == 0 and pp.slices <= bn.MAX_SLICES
        assert pp.slices * pp.slice >= pp.total == n * h * w // pp.vec
        assert (pp.slices - 1) * pp.slice < pp.total
    else:
        pl = bn.plan(shape, False, 4, True)
        assert pl.vec == 4 and pl.groups == 1 and pl.rows == n * h * w
        assert pl.slice % (bn.THREADS // pl.lanes) == 0
        assert pl.slices <= bn.MAX_SLICES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", ts.DY_FORMS)
def test_dy_forms(layout, form):
    """The backward reads dy in x's layout and a channel slice of a
    ``cat`` in place, at their strides; dy in the other layout is copied
    into x's first.  The plain backward's outputs do not depend on dy's
    form."""
    shape = (2, 8, 4, 6)
    x, w, b, dy = ts.train_inputs(shape, layout, CPU, dy_form=form)
    assert ts.layout_of(dy) == {
        ("same", "nchw"): "nchw", ("same", "channels_last"): "channels_last",
        ("slice", "nchw"): "nchw_strided",
        ("slice", "channels_last"): "rows_strided",
        ("other", "nchw"): "channels_last",
        ("other", "channels_last"): "nchw"}[(form, layout)]
    strides = bn._dy_strides(x, dy)
    read, at, vec = bn._readable(x, dy)
    if form == "other":
        assert strides is None and read is not dy
        assert bn.train_layout(read) == layout
    elif layout == "nchw":
        assert strides == dy.stride()[:2] and read is dy
    else:
        assert strides == (dy.stride()[3], 0) and read is dy
    assert vec == 4
    got = bn.bn_train_plain(x, w, b, EPS, dy)
    want = bn.bn_train_plain(x, w, b, EPS, dy.contiguous(
        memory_format=torch.channels_last if layout == "channels_last"
        else torch.contiguous_format))
    for k in ("dx", "dw", "db"):
        assert torch.equal(got[k], want[k]), k


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the dispatch's first test."""

    @property
    def is_cuda(self):
        return True


def _oracle(x, w, b, dims):
    """The eager formula (one process, no ranks), in float32."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    mean2 = torch.square(xf).mean(dim=dims, keepdim=True)
    inv = torch.rsqrt(mean2 - torch.square(mean) + EPS)
    return ((xf - mean) * inv * w.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1)).to(x.dtype)


@pytest.fixture
def lifted(monkeypatch):
    """The dispatch with both device checks lifted, the served wrapper and
    the Function replaced by recorders that return the oracle's output."""
    calls = []

    def served(x, weight, bias, eps, per_frame):
        calls.append("served")
        return _oracle(x.as_subclass(torch.Tensor), weight.detach(),
                       bias.detach(), (2, 3) if per_frame else (0, 2, 3))

    def train(x, weight, bias, eps):
        calls.append("train")
        return _oracle(x.as_subclass(torch.Tensor), weight, bias,
                       (0, 2, 3))

    monkeypatch.setattr(bn, "unsupported", bn.layout_problem)
    monkeypatch.setattr(bn, "stateless_bn", served)
    monkeypatch.setattr(bn, "train_unsupported", bn.train_layout_problem)
    monkeypatch.setattr(bn, "train_bn", train)
    return calls


def _case(name, monkeypatch):
    """(module, input, grad mode) of one dispatch case: a float32 batch
    of 3 frames of 5 channels, changed in one respect."""
    gen = torch.Generator().manual_seed(1)
    m = px.StatelessBatchNorm(5)
    x = torch.randn((3, 5, 8, 8), generator=gen) * 1.7 + 0.3
    layout, grad = "channels_last", True
    if name == "nchw":
        layout = "nchw"
    elif name == "nchw_no_grad":
        layout, grad = "nchw", False
    elif name == "channels_last_no_grad":
        grad = False
    elif name == "spans_ranks":
        monkeypatch.setattr(px, "spans_ranks", lambda group: True)
        monkeypatch.setattr(px.AllReduceSum, "apply", lambda t, g: t)
        monkeypatch.setattr(px.dist, "get_world_size", lambda g: 1)
    elif name == "per_frame":
        m.moment_dims = (2, 3)
    elif name == "passes_off":
        monkeypatch.setattr(bn, "TRAINING_PASSES", False)
    elif name in ("bfloat16", "float16", "float64"):
        x = x.to(getattr(torch, name))
    elif name == "non_contiguous":
        x = torch.randn((3, 5, 8, 16), generator=gen)[..., ::2]
    if name != "non_contiguous":
        x = x.contiguous(memory_format=torch.channels_last
                         if layout == "channels_last"
                         else torch.contiguous_format)
    return m, x, grad


# (case, the route a CUDA-looking call takes: "train" the Function,
# "served" the served no-grad kernels, "eager" the eager formula counted)
DISPATCH = [("channels_last", "train"), ("nchw", "train"),
            ("nchw_no_grad", "train"), ("channels_last_no_grad", "served"),
            ("spans_ranks", "eager"), ("per_frame", "eager"),
            ("bfloat16", "eager"), ("float16", "eager"),
            ("float64", "eager"), ("non_contiguous", "eager"),
            ("passes_off", "eager")]


@pytest.mark.parametrize("name,route", DISPATCH)
def test_dispatch(lifted, monkeypatch, name, route):
    """Grad-enabled float32 batch moments on one rank in a layout the
    kernels take go to the Function (and a no-grad NCHW call to its
    forward), counted as ``vp.bn.fused``; a no-grad channels_last call
    keeps the served kernels; sync-BN over ranks, per-frame moments with
    grad, other dtypes, other layouts and any call while
    ``TRAINING_PASSES`` is false take the eager formula, counted as
    ``vp.bn.eager``.  Every route gives the oracle's output."""
    m, x, grad = _case(name, monkeypatch)
    with tracing.recording() as rec, torch.set_grad_enabled(grad):
        y = m(x.as_subclass(_CudaLooking))
    assert lifted == ([] if route == "eager" else [route])
    key = "vp.bn.eager" if route == "eager" else "vp.bn.fused"
    assert rec.counts == {key: x.numel()}
    want = _oracle(x, m.weight.detach(), m.bias.detach(), m.moment_dims)
    assert torch.equal(y.detach().as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("name,route", DISPATCH)
def test_cpu_calls_uncounted(monkeypatch, name, route):
    """A CPU call takes the eager formula whatever else holds, counts
    nothing, and its gradient flows as before."""
    m, x, grad = _case(name, monkeypatch)
    x = x.detach().requires_grad_(grad and x.dtype.is_floating_point)
    with tracing.recording() as rec, torch.set_grad_enabled(grad):
        y = m(x)
    assert rec.counts == {}
    want = _oracle(x.detach(), m.weight.detach(), m.bias.detach(),
                   m.moment_dims)
    assert torch.equal(y.detach(), want)
    if grad:
        y.float().sum().backward()
        assert m.weight.grad is not None


def test_layout_of():
    x = torch.zeros(2, 3, 4, 5)
    assert ts.layout_of(x) == "nchw"
    assert ts.layout_of(x.contiguous(memory_format=torch.channels_last)
                        ) == "channels_last"
    assert ts.layout_of(torch.zeros(2, 6, 4, 5)[:, 3:]) == "nchw_strided"
    assert ts.layout_of(torch.zeros(2, 6, 4, 5).contiguous(
        memory_format=torch.channels_last)[:, 3:]) == "rows_strided"
    assert ts.layout_of(x.transpose(2, 3)) == "other"


def test_training_split_on_cpu():
    """One PixFlow step at a toy size on the CPU: every BN call watched,
    the elements by grad mode and layouts (the dropout's NCHW output
    shows in both G forwards), nothing counted."""
    import dataclasses as dc

    from voicepuppet_torch.config import Config
    cfg = Config()
    cfg = dc.replace(cfg, pixflow=dc.replace(cfg.pixflow, img_size=64, ngf=4,
                                             ndf=4, batch_size=2))
    r = ts.training_bn_split("pixflow", CPU, cfg)
    assert r["fused"] == 0 and r["eager"] == 0
    split = r["split"]
    assert {k[0] for k in split} == {"grad", "no_grad"}
    assert split[("no_grad", "nchw", "-")] == split[
        ("grad", "nchw", "channels_last")] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_card_training_shapes(card, layout):
    """Every training shape: the passes bit-equal to ``bn_train_plain``
    on the card, within ``TRAIN_REL`` of float64, run to run; every dy
    form on the shapes of 96 and 512 channels."""
    for shape in TRAIN_SHAPES:
        forms = ts.DY_FORMS if shape[1] in (96, 512) else ("same",)
        for form in forms:
            ts.check_train_shape(shape, layout, card, form)


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_card_against_jax(card, layout):
    """Every training shape: the passes' y, dx, dw and db on the card
    against ``jax.vjp`` of the JAX module run on the host on the same x,
    scale, bias and dy, within ``JAX_TRAIN_REL``."""
    worst = {}
    for shape in TRAIN_SHAPES:
        x, w, b, dy = ts.train_inputs(shape, layout, card, seed=shape[1])
        y, moments = bn.train_forward(x, w, b, EPS)
        dx, dw, db = bn.train_backward(x, dy, w, moments, EPS)
        got = {"y": y.cpu(), "dx": dx.cpu(), "dw": dw.cpu(), "db": db.cpu()}
        gaps = ts.rel_gaps(got, _jax_train(x, w, b, dy))
        assert max(gaps.values()) < JAX_TRAIN_REL, (shape, gaps)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
        del x, dy, y, dx
    print(f"training passes against JAX, {layout}: worst gaps "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


@pytest.mark.card
@pytest.mark.parametrize("which", ts.TRAINERS)
def test_card_training_step_takes_kernels(card, which):
    """A training step of each trainer at the cells' sizes sends at least
    95% of its BN elements through the kernels (``vp.bn.fused``)."""
    r = ts.training_bn_split(which, card)
    share = r["fused"] / (r["fused"] + r["eager"])
    assert share >= 0.95, r


@pytest.mark.card
@pytest.mark.parametrize("which", ts.TRAINERS)
def test_card_step_against_eager(card, which):
    """A step with the kernels against one on the eager formula, from the
    same weights, batch and dropout: the losses within ``STEP_LOSS``, the
    gradient norms within ``STEP_GRAD`` (over the larger of the leaf's
    and the median leaf's, as the benchmark's ``grad_gap``)."""
    r = ts.step_against_eager(which, card)
    assert r["loss_gap"] < ts.STEP_LOSS and r["grad_gap"] < ts.STEP_GRAD, r
