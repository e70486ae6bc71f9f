"""Card checks of the batch norm kernels (``ops/batchnorm.py``,
``csrc/norm.cu``), shared by ``tests/test_torch_bn_fused.py`` (its tests
marked ``card``) and ``chip_smoke.py`` (``phase_bn``):

* ``check_shape``: the kernels on one shape, dtype and moment mode, on a
  channels_last input, against float64 moments (within ``MOMENT_REL`` of
  ``mean2``), against the plain restatement of their order (moments bit
  for bit, and the output of eager ``normalize`` of those moments, byte
  for byte), against eager ``normalize(...).to(dtype)`` of their own
  moments (byte for byte), and against themselves (run to run);
* ``check_generators``: PixRefer's G and PixFlow's ``frame_forward`` at
  512², ngf 64, B 32, bf16 convs: the kernels' output no further from the
  float32 G than eager's, and the counters of one forward; the library's
  one-call batch norm (``library_bn``) measured beside them;
* ``time_shape``: the kernels', the plain version's, eager's and the
  library's milliseconds of one shape, and the bandwidth bound.

``served_shapes`` lists every BN input of both served generators (forward
hooks on a meta-device forward, so it runs anywhere).
"""

from __future__ import annotations

import contextlib
import copy
from types import SimpleNamespace
from typing import List, Tuple

import torch

from voicepuppet_torch.models import pixflow as pf
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.ops import batchnorm as bn
from voicepuppet_torch.utils import tracing

EPS = 1e-5
MOMENT_REL = 1e-5
GEN_DRIFT = 1.1       # the kernels' G distance from float32 over eager's
H100_BYTES_PER_S = 3.35e12
SIZE, NGF = 512, 64


def _bn_inputs(module: torch.nn.Module, fn) -> List[Tuple[int, ...]]:
    """The input shapes of every StatelessBatchNorm under ``module``, in
    call order, while ``fn()`` runs."""
    got = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: got.append(tuple(a[0].shape)))
        for m in module.modules() if isinstance(m, px.StatelessBatchNorm)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return got


def _pixrefer(ngf: int) -> torch.nn.Module:
    return px.PixReferNet(SimpleNamespace(ngf=ngf)).generator


def _pixflow(ngf: int) -> torch.nn.Module:
    return pf.PixFlowNet(SimpleNamespace(ngf=ngf)).per_frame_moments(
        ).generator


def served_shapes(size: int = SIZE, ngf: int = NGF
                  ) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(label, shape, per_frame) of every distinct BN input of PixRefer's
    G at B 32, 16 and 1 (per-chunk moments) and PixFlow's ``frame_forward``
    at B 32 and ``call_state`` at B 1 (per-frame moments)."""
    out, seen = [], set()

    def add(label, shapes, per_frame):
        for s in shapes:
            if (s, per_frame) not in seen:
                seen.add((s, per_frame))
                out.append((label, s, per_frame))

    with torch.device("meta"), torch.no_grad():
        g = _pixrefer(ngf)
        for b in (32, 16, 1):
            add(f"pixrefer B{b}", _bn_inputs(g, lambda: g(
                torch.zeros(b, size, size, 6),
                torch.zeros(b, size, size, 3))), False)
        f = _pixflow(ngf)
        ref = torch.zeros(1, size, size, 3)
        state = []
        add("pixflow call_state B1", _bn_inputs(f, lambda: state.append(
            f.call_state(ref, ref))), True)
        add("pixflow frame_forward B32", _bn_inputs(
            f, lambda: f.frame_forward(state[0],
                                       torch.zeros(32, size, size, 3))),
            True)
    return out


def _inputs(shape, dtype, device, seed):
    """x (channels_last), weight and bias of one case, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=device) * 1.7
         + 0.3).to(dtype).contiguous(memory_format=torch.channels_last)
    w = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
    b = 0.1 * torch.randn(c, generator=gen, device=device)
    return x, w, b


def _eager(w, b) -> px.StatelessBatchNorm:
    m = px.StatelessBatchNorm(w.shape[0]).to(w.device)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    return m


def check_shape(shape, dtype, per_frame: bool, device, seed: int = 0
                ) -> dict:
    """Raise AssertionError unless the kernels meet the checks of the
    module docstring on this channels_last input; returns the moments'
    worst relative gap from float64 (``moment_rel``), the output's largest
    |Δ| from the plain version (``max_abs_err``, 0 when byte-equal) and
    from the eager module with its own moments (``eager_abs_err``)."""
    x, w, b = _inputs(shape, dtype, device, seed)
    eager = _eager(w, b).requires_grad_(False)
    eager.moment_dims = (2, 3) if per_frame else (0, 2, 3)
    with torch.inference_mode():
        y, mean, mean2 = bn.stateless_bn_moments(x, w, b, EPS, per_frame)
        xd = x.double()
        m64 = xd.mean(eager.moment_dims, keepdim=True)
        m2_64 = (xd * xd).mean(eager.moment_dims, keepdim=True)
        rel = max(float(((mean.double() - m64).abs() / m2_64).max()),
                  float(((mean2.double() - m2_64).abs() / m2_64).max()))
        pm, pm2 = bn.moments_plain(x, per_frame)
        plain = eager.normalize(x.float(), pm, pm2).to(dtype)
        want = eager.normalize(x.float(), mean, mean2).to(dtype)
        again = bn.stateless_bn(x, w, b, EPS, per_frame)
    with torch.enable_grad(), eager_only():
        own = eager(x)
    err = float((y.float() - plain.float()).abs().max())
    what = f"{tuple(shape)} {dtype} per_frame={per_frame}"
    assert rel < MOMENT_REL, f"{what}: moments {rel:.3e} from float64"
    assert torch.equal(mean, pm) and torch.equal(mean2, pm2), (
        f"{what}: moments differ from moments_plain")
    assert torch.equal(y, plain), (
        f"{what}: output differs from the plain version by up to {err}")
    assert torch.equal(y, want), (
        f"{what}: output differs from eager normalize of its moments at "
        f"{int((y != want).sum())} elements")
    assert torch.equal(y, again), f"{what}: output differs run to run"
    return {"moment_rel": rel, "max_abs_err": err,
            "eager_abs_err": float((y.float() - own.float()).abs().max())}


def library_bn(x, weight, bias, eps: float, per_frame: bool):
    """The batch norm as one library call: ``F.instance_norm`` for
    per-frame moments, ``F.batch_norm`` in training mode with no running
    statistics for per-chunk moments (both take bf16 input with float32
    parameters, and form the variance their own way)."""
    if per_frame:
        return torch.nn.functional.instance_norm(x, weight=weight,
                                                 bias=bias, eps=eps)
    return torch.nn.functional.batch_norm(x, None, None, weight, bias,
                                          training=True, eps=eps)


def _frozen(module: torch.nn.Module, dtype) -> torch.nn.Module:
    module = copy.deepcopy(module)
    module.requires_grad_(False)
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.to(dtype)
    module.dtype = dtype
    return module


@contextlib.contextmanager
def eager_only():
    """Every batch norm of a training step on the eager formula: the
    dispatch to ``batchnorm.TrainBatchNorm`` turned off (the served
    kernels' no-grad dispatch stays), by ``bn.TRAINING_PASSES``."""
    before, bn.TRAINING_PASSES = bn.TRAINING_PASSES, False
    try:
        yield
    finally:
        bn.TRAINING_PASSES = before


@contextlib.contextmanager
def _eager_reordered():
    """Eager BN with its moments summed over the width reversed: the same
    values in another float32 order, the yardstick of how far a bf16
    generator moves when nothing but the order of its sums changes."""
    forward = px.StatelessBatchNorm.forward

    def reordered(self, x):
        xf = x.float()
        xr = xf.flip(-1)
        mean = xr.mean(dim=self.moment_dims, keepdim=True)
        mean2 = torch.square(xr).mean(dim=self.moment_dims, keepdim=True)
        return self.normalize(xf, mean, mean2).to(x.dtype)

    px.StatelessBatchNorm.forward = reordered
    try:
        yield
    finally:
        px.StatelessBatchNorm.forward = forward


@contextlib.contextmanager
def _library_forward():
    """Every batch norm as ``library_bn``."""
    forward = px.StatelessBatchNorm.forward

    def library(self, x):
        return library_bn(x, self.weight, self.bias, self.epsilon,
                          tuple(self.moment_dims) == (2, 3))

    px.StatelessBatchNorm.forward = library
    try:
        yield
    finally:
        px.StatelessBatchNorm.forward = forward


def _gen_distances(run_g, g) -> dict:
    """``run_g(g)`` with the kernels (inference mode), eager (grad mode,
    nothing requiring grad), eager with its moments' sums reordered and
    the library's one-call batch norm, in bf16 convs, and eager in float32
    convs with TF32 off; mean |Δ| of the pairs, the counters of the
    kernels' forward, and G's device ms with the kernels and with the
    library's batch norm (inference mode)."""
    gb, g32 = _frozen(g, torch.bfloat16), _frozen(g, torch.float32)
    with torch.inference_mode(), tracing.recording() as rec:
        fused = run_g(gb)
    counts = dict(rec.counts)
    with torch.inference_mode():
        shapes = _bn_inputs(gb, lambda: run_g(gb))
        kernel_ms = _held_ms(lambda: run_g(gb), 3)
        with _library_forward():
            library_ms = _held_ms(lambda: run_g(gb), 3)
    with torch.enable_grad():
        eager = run_g(gb)
        with _eager_reordered():
            reordered = run_g(gb)
        with _library_forward():
            library = run_g(gb)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with eager_only():
                full = run_g(g32)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    def dist(a, b):
        return float((a - b).abs().mean())

    return {"kernel_vs_eager": dist(fused, eager),
            "reordered_vs_eager": dist(reordered, eager),
            "kernel_vs_float32": dist(fused, full),
            "eager_vs_float32": dist(eager, full),
            "library_vs_float32": dist(library, full),
            "kernel_g_ms": kernel_ms, "library_g_ms": library_ms,
            "bn_elements": sum(torch.Size(t).numel() for t in shapes),
            "fused": counts.get("vp.bn.fused", 0),
            "eager": counts.get("vp.bn.eager", 0)}


def check_generators(device, batch: int = 32, seed: int = 0) -> dict:
    """Both served generators at 512², ngf 64, fresh weights from ``seed``,
    inputs uniform in [-1, 1]: raise AssertionError unless the kernels' G
    is as close to the float32 G as eager's (within ``GEN_DRIFT``) and the
    counters show every BN element on the kernels and none on eager.
    Returns each generator's distances and counts.  The kernels' distance
    from eager itself is reported beside eager's from eager reordered:
    both are bf16 roundings flipped by the order of float32 sums and
    carried through the layers."""
    gen = torch.Generator().manual_seed(seed)
    dgen = torch.Generator(device=device).manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=dgen, device=device) * 2 - 1

    out = {}
    g = px.init_pixrefer_(_pixrefer(NGF), gen).to(device)
    inp, fg = uniform(batch, SIZE, SIZE, 6), uniform(batch, SIZE, SIZE, 3)
    out["pixrefer"] = _gen_distances(lambda m: m(inp, fg), g)
    f = px.init_pixrefer_(_pixflow(NGF), gen).to(device)
    ref, fgr = uniform(1, SIZE, SIZE, 3), uniform(1, SIZE, SIZE, 3)
    cur = uniform(batch, SIZE, SIZE, 3)
    out["pixflow"] = _gen_distances(
        lambda m: m.frame_forward(m.call_state(ref, fgr), cur), f)
    for name, r in out.items():
        assert r["kernel_vs_float32"] < GEN_DRIFT * r["eager_vs_float32"], (
            f"{name}: {r}")
        assert r["fused"] == r["bn_elements"] and r["eager"] == 0, (
            f"{name}: counters {r}")
    return out


def _held_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls queued behind a spin
    that holds the stream, so the host's enqueue is not what is timed."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(shape, dtype, per_frame: bool, device, iters: int = 20
               ) -> dict:
    """On one channels_last input (the served layout): the kernels' ms
    (every pass), the bandwidth bound (x read twice, y written once at
    3.35 TB/s), the plain version's ms (``moments_plain`` and eager
    ``normalize``), eager's (the module's formula) and the library's
    (``library_bn``, one call).  Repeated calls find a tensor under 50 MB
    in L2."""
    x, w, b = _inputs(shape, dtype, device, 0)
    m = _eager(w, b).requires_grad_(False)
    m.moment_dims = (2, 3) if per_frame else (0, 2, 3)

    def plain():
        mean, mean2 = bn.moments_plain(x, per_frame)
        return m.normalize(x.float(), mean, mean2).to(dtype)

    with torch.inference_mode():
        kernel = _held_ms(lambda: bn.stateless_bn(x, w, b, EPS, per_frame),
                          iters)
        plain_ms = _held_ms(plain, max(iters // 4, 2))
        library = _held_ms(lambda: library_bn(x, w, b, EPS, per_frame),
                           iters)
    with torch.enable_grad(), eager_only():
        eager = _held_ms(lambda: m(x), iters)
    bound = 3 * x.numel() * x.element_size() / H100_BYTES_PER_S * 1e3
    return {"kernel_ms": kernel, "bound_ms": bound,
            "ratio": kernel / bound, "plain_ms": plain_ms,
            "eager_ms": eager, "library_ms": library}
