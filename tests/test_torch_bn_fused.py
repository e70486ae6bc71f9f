"""The served generators' batch norm kernels (``ops/batchnorm.py``,
``csrc/norm.cu``) and the dispatch in ``StatelessBatchNorm.forward``.

CPU: every input the kernels do not take goes to the eager formula, whose
output stays byte for byte today's (``_oracle``, a copy of it); the
wrapper raises on those inputs; the counters; the modules import without
nvcc or CUDA; the plain restatement of the kernels' order of float32
operations against float64 and against the JAX package's
``StatelessBatchNorm``; the cut of every served BN shape.  A CPU tensor
cannot reach the kernels, so the dispatch's other conditions are tested on
a CPU tensor that reports ``is_cuda`` (``_CudaLooking``), with the device
check lifted (``layout_problem`` for ``unsupported``) and the wrapper
replaced by a recorder.

The JAX module runs from its own source (``_jax_bn``: its ``__call__``
loaded with ``ast``, flax's parameter lookup stood in for), so that it
runs where flax is not installed, always on JAX's CPU backend.

Card (marked ``card``; skipped without CUDA): ``ops/batchnorm_selftest.py``
on every BN shape of both served generators, the whole generators, and
the kernels' output on every served shape against the JAX module on the
host.  A training step's batch norm and its counters are
``tests/test_torch_bn_train.py``'s.  On the card: ``python -m
pytest tests/test_torch_bn_fused.py -m card -q`` (``tests/conftest.py``
puts JAX on its CPU backend).
"""

import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.ops import batchnorm as bn
from voicepuppet_torch.ops import batchnorm_selftest as selftest
from voicepuppet_torch.utils import native, tracing

EPS = 1e-5
PLAIN_REL = 1e-6
# Against the JAX module, both outputs rounded to bf16: at most this share
# of the elements differ (a float32 order of sums flips a rounding here and
# there; moments rounded to bf16 flip ~21% of them), and none by more than
# one bf16 step.
JAX_SHARE = 0.01
_JAX_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "voicepuppet_tpu", "models", "pixrefer.py")


def _oracle(x, w, b, dims):
    """``StatelessBatchNorm.forward``'s eager formula as it stood before
    the kernels (one process, no ranks)."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    mean2 = torch.square(xf).mean(dim=dims, keepdim=True)
    var = mean2 - torch.square(mean)
    inv = torch.rsqrt(var + EPS)
    return ((xf - mean) * inv * w.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1)).to(x.dtype)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the dispatch's first test."""

    @property
    def is_cuda(self):
        return True


def _module(c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    m = px.StatelessBatchNorm(c)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
        m.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return m


def _x(shape=(3, 5, 8, 8), dtype=torch.bfloat16, seed=1):
    """A channels_last input."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 1.7 + 0.3).to(dtype
        ).contiguous(memory_format=torch.channels_last)


@pytest.fixture
def lifted(monkeypatch):
    """The dispatch with the device check lifted and the wrapper replaced
    by a recorder that returns the oracle's output."""
    calls = []

    def wrapper(x, weight, bias, eps, per_frame):
        calls.append(per_frame)
        dims = (2, 3) if per_frame else (0, 2, 3)
        return _oracle(x.as_subclass(torch.Tensor), weight.detach(),
                       bias.detach(), dims)

    monkeypatch.setattr(bn, "unsupported", bn.layout_problem)
    monkeypatch.setattr(bn, "stateless_bn", wrapper)
    return calls


def _run(m, x, grad=False):
    with tracing.recording() as rec:
        with torch.set_grad_enabled(grad):
            y = m(x)
    return y.detach().as_subclass(torch.Tensor), rec.counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", [(0, 2, 3), (2, 3)])
def test_dispatch_takes_kernel(lifted, dims, dtype):
    """The control: with no grad, one rank, a bf16 or float32
    channels_last tensor and a moment mode the kernels have, the call goes
    to the wrapper."""
    m, x = _module(5), _x(dtype=dtype)
    m.moment_dims = dims
    y, counts = _run(m, x.as_subclass(_CudaLooking))
    assert lifted == [dims == (2, 3)]
    assert torch.equal(y, _oracle(x, m.weight.detach(), m.bias.detach(),
                                  dims))
    assert counts == {"vp.bn.fused": x.numel()}


def _case(name, monkeypatch):
    """(module, input, grad) of one input the dispatch sends to eager."""
    m, x, grad = _module(5), _x(), False
    if name == "grad":          # training: grad on, parameters need it
        grad = True
    elif name == "spans_ranks":
        monkeypatch.setattr(px, "spans_ranks", lambda group: True)
        monkeypatch.setattr(px.AllReduceSum, "apply", lambda t, g: t)
        monkeypatch.setattr(px.dist, "get_world_size", lambda g: 1)
    elif name == "float16":
        x = x.to(torch.float16)
    elif name == "nchw":               # contiguous NCHW
        x = x.contiguous()
    elif name == "non_contiguous":     # in neither layout
        x = _x((3, 5, 8, 16))[..., ::2]
    elif name.startswith("moment_dims"):
        m.moment_dims = (2,) if name == "moment_dims_2" else (0,)
    return m, x, grad


EAGER_CASES = ["grad", "spans_ranks", "float16", "nchw", "non_contiguous",
               "moment_dims_2", "moment_dims_0"]


@pytest.mark.parametrize("name", EAGER_CASES)
def test_dispatch_takes_eager(lifted, monkeypatch, name):
    """Each condition alone sends a CUDA-looking input to eager, whose
    output is byte for byte the oracle's, counted as ``vp.bn.eager``."""
    m, x, grad = _case(name, monkeypatch)
    y, counts = _run(m, x.as_subclass(_CudaLooking), grad)
    assert lifted == []
    assert torch.equal(y, _oracle(x, m.weight.detach(), m.bias.detach(),
                                  m.moment_dims))
    assert counts == {"vp.bn.eager": x.numel()}


@pytest.mark.parametrize("name", ["cpu"] + EAGER_CASES)
def test_cpu_tensors_take_eager_uncounted(monkeypatch, name):
    """A CPU tensor takes the eager formula, byte for byte the oracle's,
    and counts nothing: ``vp.bn.fused`` and ``vp.bn.eager`` stay 0."""
    m, x, grad = _case(name, monkeypatch)
    y, counts = _run(m, x, grad)
    assert torch.equal(y, _oracle(x, m.weight.detach(), m.bias.detach(),
                                  m.moment_dims))
    assert counts == {}


def _bad(name):
    """(x, weight, bias, what layout_problem names) of an input the
    wrapper does not take (besides a CPU device)."""
    x, w, b = _x((2, 4, 8, 8), torch.float32), torch.ones(4), torch.zeros(4)
    return {
        "float16": (x.half(), w, b, "bfloat16 or float32"),
        "float64": (x.double(), w, b, "bfloat16 or float32"),
        "three_dims": (x[0], w, b, "channels_last"),
        "nchw": (x.contiguous(), w, b, "channels_last"),
        "non_contiguous": (x.transpose(2, 3), w, b, "channels_last"),
        "weight_float64": (x, w.double(), b, "weight must be"),
        "weight_shape": (x, torch.ones(3), b, "weight must be"),
        "bias_strided": (x, w, torch.zeros(8)[::2], "bias must be"),
    }[name]


@pytest.mark.parametrize("name", ["float16", "float64", "three_dims",
                                  "nchw", "non_contiguous",
                                  "weight_float64", "weight_shape",
                                  "bias_strided"])
def test_wrapper_raises(name):
    x, w, b, what = _bad(name)
    assert what in bn.layout_problem(x, w, b)
    with pytest.raises(ValueError, match="stateless_bn"):
        bn.stateless_bn(x, w, b, EPS, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_raises_on_cpu(dtype):
    x = _x(dtype=dtype)
    assert bn.layout_problem(x, torch.ones(5), torch.zeros(5)) is None
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn.stateless_bn(x, torch.ones(5), torch.zeros(5), EPS, True)


def test_generator_on_cpu_counts_nothing():
    """A whole G served on the CPU (inference mode): no BN counted."""
    g = selftest._pixrefer(4)
    with tracing.recording() as rec, torch.inference_mode():
        g(torch.zeros(2, 256, 256, 6), torch.zeros(2, 256, 256, 3))
    assert rec.counts == {}


def test_imports_build_nothing(monkeypatch, tmp_path):
    """The wrapper and the models import in a fresh process with no
    library built or loaded; building without nvcc raises."""
    code = ("import voicepuppet_torch.models.pixflow\n"
            "from voicepuppet_torch.ops import batchnorm\n"
            "assert batchnorm.LIBRARY._lib is None, 'built at import'\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bn.NormLibrary().function()


PLANES = (256, 128, 64, 32, 16, 8, 4, 2)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_frame", [False, True])
def test_moments_plain_vs_float64(per_frame, dtype, aligned, layout):
    """The kernels' order of float32 sums on the served planes 256² down
    to 2², at a reduced batch and 16 channels: within 1e-6 of float64,
    relative to the mean of squares, and the same bits whatever the
    layout of the tensor it is handed."""
    dims = (2, 3) if per_frame else (0, 2, 3)
    for s in PLANES:
        x = _x((4, 16, s, s), dtype, seed=s)
        if layout == "nchw":
            x = x.contiguous()
        mean, mean2 = bn.moments_plain(x, per_frame, aligned)
        want = bn.moments_plain(x.contiguous(
            memory_format=torch.channels_last), per_frame, aligned)
        assert torch.equal(mean, want[0]) and torch.equal(mean2, want[1])
        xd = x.double()
        m64 = xd.mean(dims, keepdim=True)
        m2_64 = (xd * xd).mean(dims, keepdim=True)
        assert mean.shape == m64.shape and mean.dtype == torch.float32
        rel = max(float(((mean.double() - m64).abs() / m2_64).max()),
                  float(((mean2.double() - m2_64).abs() / m2_64).max()))
        assert rel < PLAIN_REL, (s, rel)


def test_served_shapes():
    """Every distinct BN input of both served generators at 512², ngf 64,
    and the kernels' cut of each in both dtypes and modes: 16-byte loads,
    one tile of columns, slices of whole row-lane rounds, at most
    ``MAX_SLICES`` of them a group."""
    shapes = selftest.served_shapes()
    assert {label for label, _, _ in shapes} == {
        "pixrefer B32", "pixrefer B16", "pixrefer B1",
        "pixflow call_state B1", "pixflow frame_forward B32"}
    assert (32, 64, 256, 256) in [s for _, s, _ in shapes]
    assert (32, 128, 256, 256) in [s for _, s, _ in shapes]
    for _, shape, _ in shapes:
        for itemsize in (2, 4):
            for mode in (False, True):
                pl = bn.plan(shape, mode, itemsize, True)
                assert pl.vec == 16 // itemsize and pl.tiles == 1
                assert pl.groups * pl.rows * shape[1] == (
                    torch.Size(shape).numel())
                assert pl.slice % (bn.THREADS // pl.lanes) == 0
                assert pl.slices <= bn.MAX_SLICES
                assert pl.slices * pl.slice >= pl.rows
                assert pl.partials == pl.groups * pl.slices * shape[1]
    assert bn.plan((32, 128, 256, 256), True, 2, True) == bn.Plan(
        32, 65536, 128, 512, 16, 1, 8, 32 * 512 * 128)
    assert bn.plan((32, 64, 256, 256), False, 2, True) == bn.Plan(
        1, 2097152, 2048, 1024, 8, 1, 8, 1024 * 64)
    assert bn.plan((32, 64, 256, 256), False, 2, False) == bn.Plan(
        1, 2097152, 2048, 1024, 64, 1, 1, 1024 * 64)


def test_served_elements_per_frame():
    """The BN elements a frame of each generator, from the module shapes
    (the traffic the kernels save: PixRefer 13.06 M, PixFlow's per-frame
    part 22.54 M)."""
    from voicepuppet_torch.ops.batchnorm_selftest import (_bn_inputs,
                                                          _pixflow,
                                                          _pixrefer)
    with torch.device("meta"), torch.no_grad():
        g = _pixrefer(64)
        got = _bn_inputs(g, lambda: g(torch.zeros(1, 512, 512, 6),
                                      torch.zeros(1, 512, 512, 3)))
        f = _pixflow(64)
        state = f.call_state(torch.zeros(1, 512, 512, 3),
                             torch.zeros(1, 512, 512, 3))
        flow = _bn_inputs(f, lambda: f.frame_forward(
            state, torch.zeros(1, 512, 512, 3)))
    assert sum(torch.Size(s).numel() for s in got) == 13_060_096
    assert sum(torch.Size(s).numel() for s in flow) == 22_544_384


def _jax_bn_call():
    """The JAX package's ``StatelessBatchNorm.__call__`` from its source,
    as ``f(x, scale, bias)`` on an NHWC array (not jitted), on JAX's CPU
    backend.  The class's fields are its own defaults; ``self.param``
    returns the given scale and bias."""
    import jax
    import jax.numpy as jnp
    assert jax.default_backend() == "cpu", jax.default_backend()
    with open(_JAX_SRC) as f:
        tree = ast.parse(f.read(), _JAX_SRC)
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "StatelessBatchNorm")
    call = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
                and n.name == "__call__")
    call.decorator_list = []
    fields = {n.target.id: ast.literal_eval(n.value) for n in cls.body
              if isinstance(n, ast.AnnAssign) and n.value is not None}
    ns = {"jax": jax, "jnp": jnp,
          "nn": SimpleNamespace(initializers=SimpleNamespace(zeros=None))}
    exec(compile(ast.Module(body=[call], type_ignores=[]), _JAX_SRC,
                 "exec"), ns)

    def run(x, scale, bias):
        params = {"scale": scale, "bias": bias}
        me = SimpleNamespace(param=lambda name, init, shape: params[name],
                             **fields)
        return ns["__call__"](me, x)

    return run


def _jax_bn():
    """``_jax_bn_call`` under ``jax.jit``: ``f(x, scale, bias,
    per_frame)`` on an NHWC array, per frame by ``vmap`` over frames of
    one (the moments of a batch of one, as the JAX PixFlowNet takes
    them)."""
    import jax
    run = _jax_bn_call()
    chunk = jax.jit(run)
    frames = jax.jit(jax.vmap(lambda x, s, b: run(x[None], s, b)[0],
                              in_axes=(0, None, None)))
    return lambda x, s, b, per_frame: (frames if per_frame else chunk)(
        x, s, b)


def _to_jax(t: torch.Tensor):
    """An NCHW torch tensor as an NHWC JAX array of the same dtype and
    values, on JAX's CPU backend."""
    import jax.numpy as jnp
    dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.detach().float().permute(0, 2, 3, 1).cpu()
                       .numpy(), dtype=dtype)


def _gap_from_jax(y: torch.Tensor, want) -> tuple:
    """(share of elements whose bf16 roundings differ, worst gap in bf16
    steps at the larger of the two magnitudes, those below 2^-9 taken as
    2^-9) between the NCHW ``y`` and the JAX module's NHWC ``want``."""
    a = y.detach().permute(0, 2, 3, 1).float().cpu().bfloat16().double()
    b = torch.from_numpy(np.array(want, dtype=np.float32)).bfloat16(
        ).double()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()),
                        torch.tensor(2.0 ** -9, dtype=torch.float64))
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (float((a != b).double().mean()),
            float(((a - b).abs() / step).max()))


def test_jax_loader_is_the_module():
    """``_jax_bn`` gives the flax module's bytes: the JAX package's
    ``StatelessBatchNorm`` applied with the same scale and bias, over the
    whole batch and on each frame alone."""
    import jax.numpy as jnp
    from voicepuppet_tpu.models.pixrefer import StatelessBatchNorm
    m, x = _module(16, seed=3), _x((3, 16, 8, 8), seed=4)
    xj, s, b = (_to_jax(x), jnp.asarray(m.weight.detach().numpy()),
                jnp.asarray(m.bias.detach().numpy()))
    fn, ref = _jax_bn(), StatelessBatchNorm()
    params = {"params": {"scale": s, "bias": b}}
    np.testing.assert_array_equal(np.asarray(fn(xj, s, b, False)),
                                  np.asarray(ref.apply(params, xj)))
    per = np.asarray(fn(xj, s, b, True))
    for i in range(x.shape[0]):
        np.testing.assert_array_equal(
            per[i], np.asarray(ref.apply(params, xj[i:i + 1]))[0])


JAX_CPU_SHAPES = ((32, 512, 2, 2), (8, 256, 16, 16), (4, 64, 64, 64),
                  (1, 128, 128, 128))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_frame", [False, True])
def test_plain_against_jax(per_frame, dtype):
    """The kernels' moments in their order (``moments_plain``, which the
    card's equal bit for bit) and eager ``normalize`` against the JAX
    module on served channel widths and planes: within ``JAX_SHARE`` and
    one bf16 step.  The yardstick fails moments rounded to bf16."""
    import jax.numpy as jnp
    fn = _jax_bn()
    for shape in JAX_CPU_SHAPES:
        m, x = _module(shape[1], seed=shape[2]), _x(shape, dtype,
                                                    seed=shape[3])
        want = fn(_to_jax(x), jnp.asarray(m.weight.detach().numpy()),
                  jnp.asarray(m.bias.detach().numpy()), per_frame)
        mean, mean2 = bn.moments_plain(x, per_frame)
        with torch.no_grad():
            y = m.normalize(x.float(), mean, mean2).to(dtype)
            rounded = m.normalize(x.float(), mean.bfloat16().float(),
                                  mean2.bfloat16().float()).to(dtype)
        share, steps = _gap_from_jax(y, want)
        assert share <= JAX_SHARE and steps <= 1.0, (shape, share, steps)
        assert _gap_from_jax(rounded, want)[0] > JAX_SHARE, shape


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_card_served_shapes(card):
    """Every BN shape of both generators, bf16 and float32, in its own
    moment mode and the other, channels_last (the served layout): the
    checks of ``check_shape``."""
    for _, shape, own in selftest.served_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            for per_frame in (own, not own):
                r = selftest.check_shape(shape, dtype, per_frame, card)
                assert r["max_abs_err"] == 0.0, (shape, dtype, r)


@pytest.mark.card
def test_card_generators(card):
    selftest.check_generators(card)


@pytest.mark.card
def test_card_against_jax(card):
    """The kernels on every BN shape of both served generators, bf16 and
    float32, both moment modes, channels_last: their output against the
    JAX module run on the host on the same x, weight and bias, within
    ``JAX_SHARE`` and one bf16 step."""
    import jax.numpy as jnp
    fn = _jax_bn()
    worst = (0.0, 0.0)
    for _, shape, own in selftest.served_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = selftest._inputs(shape, dtype, card, 0)
            sj, bj = jnp.asarray(w.cpu().numpy()), jnp.asarray(
                b.cpu().numpy())
            xj = _to_jax(x)
            for per_frame in (own, not own):
                with torch.inference_mode():
                    y = bn.stateless_bn(x, w, b, EPS, per_frame)
                share, steps = _gap_from_jax(y, fn(xj, sj, bj, per_frame))
                assert share <= JAX_SHARE and steps <= 1.0, (
                    shape, dtype, per_frame, share, steps)
                worst = (max(worst[0], share), max(worst[1], steps))
            del x, xj, y
    print(f"against JAX: worst share of differing bf16 roundings "
          f"{worst[0]:.3e}, worst gap {worst[1]:.3f} bf16 steps")
