"""The GRU recurrence kernel (``ops/gru.py``, ``csrc/gru.cu``) and the
dispatch in ``MaskedGRU.forward``.

CPU: every input the kernel does not take goes to the eager step loop,
whose output stays byte for byte today's (``_oracle``, a copy of it); the
wrapper raises on those inputs; the counters; the modules import without
nvcc or CUDA; the torch version of the kernel's path (the input half of
the gates in one matrix product over all steps, the recurrence stopping at
each row's length, the zero fill, the finals: ``gru_selftest.fused_plain``)
against the eager ``MaskedGRU`` and against the JAX package's
``masked_gru``.  A CPU tensor cannot reach the kernel, so the dispatch is
tested on a CPU tensor that reports ``is_cuda`` (``_CudaLooking``), with
the kernel replaced by a recorder that runs its torch version.

Card (marked ``card``; skipped without CUDA): the kernel against the eager
loop and the torch version on every case of ``gru_selftest.CASES`` (T up
to 2048, the 60 s bucket), the state carried over two calls against one
call, and the counters of a served call, a live block and a BFMNet
training step.  On the card: ``python -m pytest
tests/test_torch_gru_fused.py -m card -q``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from voicepuppet_torch.models import layers
from voicepuppet_torch.ops import gru
from voicepuppet_torch.ops import gru_selftest as selftest
from voicepuppet_torch.utils import native, tracing

# The kernel's path against the eager loop, float32 on the CPU: the input
# half of the gates is summed apart from the recurrent half, so each step
# rounds differently; states lie in (-1, 1).
PLAIN_ABS = 1e-5
# Against the JAX module (XLA's CPU sums, another order again).
JAX_ABS = 1e-5


def _oracle(m, inputs, seq_len, initial_state=None, return_state=False,
            train=False, generator=None):
    """``MaskedGRU.forward``'s step loop as it stood before the kernel."""
    b, t, _ = inputs.shape
    x = inputs
    mask = (torch.arange(t, device=x.device)[None, :]
            < seq_len[:, None])[..., None]
    finals = []
    for layer in range(m.num_layers):
        cell = getattr(m, f"ScanTFGRUCell_{layer}")
        h0 = (x.new_zeros((b, m.num_units)) if initial_state is None
              else initial_state[layer])
        h = h0
        outs = []
        for i in range(t):
            h = cell(h, x[:, i])
            outs.append(h)
        out = torch.stack(outs, dim=1)
        if return_state:
            at_len = torch.clamp(seq_len.long() - 1, 0, t - 1)
            last = out[torch.arange(b, device=x.device), at_len]
            finals.append(torch.where((seq_len > 0)[:, None], last, h0))
        x = out * mask
        if train:
            x = layers.dropout(x, m.drop_rate, generator)
    if return_state:
        return x, finals
    return x


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the dispatch's first test."""

    @property
    def is_cuda(self):
        return True


def _plain(t):
    return t.detach().as_subclass(torch.Tensor)


@pytest.fixture
def lifted(monkeypatch):
    """The kernel replaced by a recorder that runs its torch version."""
    calls = []

    def recorder(xg, w_h, h0, seq_len):
        calls.append(tuple(xg.shape))
        assert gru.layout_problem(xg, w_h, h0, seq_len) is None
        return gru.gru_recurrence_plain(xg, w_h, h0, seq_len)

    monkeypatch.setattr(gru, "gru_recurrence", recorder)
    return calls


def _run(m, x, seq_len, state=None, grad=False, train=False, gen=None):
    """(outputs, finals, counts) of one call under a recording."""
    with tracing.recording() as rec:
        with torch.set_grad_enabled(grad):
            out, fin = m(x, seq_len, state, return_state=True, train=train,
                         generator=gen)
    return _plain(out), [_plain(f) for f in fin], rec.counts


@pytest.mark.parametrize("units,layers_", [(256, 1), (128, 1), (32, 2)])
@pytest.mark.parametrize("state", [False, True])
def test_dispatch_takes_kernel(lifted, units, layers_, state):
    """The control: float32, no grad, not training, units a multiple of 32
    up to 256: one kernel call a layer, the output the torch version's,
    counted as ``vp.gru.fused``, the steps run (the lengths clamped to T)
    over rows and layers."""
    m = selftest.masked_gru(units, 24, layers_)
    x, seq_len, h0 = selftest.inputs(3, 10, units, 24, (10, 0, 17), state,
                                     layers_)
    out, fin, counts = _run(m, x.as_subclass(_CudaLooking), seq_len, h0)
    assert lifted == [(3, 10, 3 * units)] * layers_
    want, wfin = selftest.fused_plain(m, x, seq_len, h0)
    assert torch.equal(out, want)
    assert all(torch.equal(f, w) for f, w in zip(fin, wfin))
    assert counts == {"vp.gru.fused": (10 + 0 + 10) * layers_}
    with torch.no_grad():           # without return_state: the outputs
        alone = m(x.as_subclass(_CudaLooking), seq_len, h0)
    assert torch.equal(_plain(alone), want)


EAGER_CASES = ["grad", "train", "float64", "bfloat16", "units_48",
               "units_512", "lengths_float"]


def _case(name):
    """(module, x, seq_len, state, grad, train) of one call the dispatch
    sends to the eager loop."""
    units = {"units_48": 48, "units_512": 512}.get(name, 64)
    m = selftest.masked_gru(units, 24, 1)
    m.drop_rate = 0.25
    x, seq_len, h0 = selftest.inputs(2, 6, units, 24, (6, 4), True)
    grad = name == "grad"
    train = name == "train"
    if name in ("float64", "bfloat16"):
        dtype = getattr(torch, name)
        m, x, h0 = m.to(dtype), x.to(dtype), [h.to(dtype) for h in h0]
    elif name == "lengths_float":
        seq_len = seq_len.float()
    return m, x, seq_len, h0, grad, train


def _want(m, x, seq_len, h0, grad, train):
    with torch.set_grad_enabled(grad):
        out, fin = _oracle(m, x, seq_len, h0, True, train,
                           torch.Generator().manual_seed(7))
    return _plain(out), [_plain(f) for f in fin]


@pytest.mark.parametrize("name", EAGER_CASES)
def test_dispatch_takes_eager(lifted, name):
    """Each condition alone sends a CUDA-looking input to the eager loop,
    whose output is byte for byte the oracle's, counted as
    ``vp.gru.eager`` (B x T steps a layer)."""
    m, x, seq_len, h0, grad, train = _case(name)
    out, fin, counts = _run(m, x.as_subclass(_CudaLooking), seq_len, h0,
                            grad, train, torch.Generator().manual_seed(7))
    assert lifted == []
    want, wfin = _want(m, x, seq_len, h0, grad, train)
    assert torch.equal(out, want)
    assert all(torch.equal(f, w) for f, w in zip(fin, wfin))
    assert counts == {"vp.gru.eager": 2 * 6}


@pytest.mark.parametrize("name", ["control"] + EAGER_CASES[:6])
def test_cpu_tensors_take_eager_uncounted(lifted, name):
    """A CPU tensor takes the eager loop, byte for byte the oracle's, and
    counts nothing."""
    if name == "control":
        m = selftest.masked_gru(64, 24, 1)
        x, seq_len, h0 = selftest.inputs(2, 6, 64, 24, (6, 4), True)
        grad = train = False
    else:
        m, x, seq_len, h0, grad, train = _case(name)
    out, fin, counts = _run(m, x, seq_len, h0, grad, train,
                            torch.Generator().manual_seed(7))
    assert lifted == []
    want, wfin = _want(m, x, seq_len, h0, grad, train)
    assert torch.equal(out, want)
    assert all(torch.equal(f, w) for f, w in zip(fin, wfin))
    assert counts == {}


def _kernel_args(units=64, b=2, t=5):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(b, t, 3 * units, generator=gen),
            torch.randn(3 * units, units, generator=gen),
            torch.zeros(b, units), torch.full((b,), t, dtype=torch.int64))


def _bad(name):
    """(xg, w_h, h0, seq_len, what layout_problem names) of an input the
    wrapper does not take (besides a CPU device)."""
    xg, w, h0, n = _kernel_args()
    return {
        "float64": (xg.double(), w, h0, n, "float32"),
        "bfloat16": (xg.bfloat16(), w, h0, n, "float32"),
        "not_three_u": (xg[..., 1:].contiguous(), w, h0, n, "[B,T,3U]"),
        "non_contiguous": (xg.transpose(0, 1), w, h0, n, "contiguous"),
        "empty": (xg[:, :0], w, h0, n, "empty"),
        "units_48": _kernel_args(48)[:4] + ("multiple of 32",),
        "units_512": _kernel_args(512, 1, 2)[:4] + ("multiple of 32",),
        "w_shape": (xg, w[:-1], h0, n, "w_h must be"),
        "w_columns": (xg, w.t().contiguous().t(), h0, n, "w_h must be"),
        "h0_shape": (xg, w, h0[:1], n, "h0 must be"),
        "h0_float64": (xg, w, h0.double(), n, "h0 must be"),
        "lengths_float": (xg, w, h0, n.float(), "seq_len must be"),
        "lengths_shape": (xg, w, h0, n[:1], "seq_len must be"),
    }[name]


BAD = ["float64", "bfloat16", "not_three_u", "non_contiguous", "empty",
       "units_48", "units_512", "w_shape", "w_columns", "h0_shape",
       "h0_float64", "lengths_float", "lengths_shape"]


@pytest.mark.parametrize("name", BAD)
def test_wrapper_raises(name):
    xg, w, h0, n, what = _bad(name)
    assert what in gru.layout_problem(xg, w, h0, n)
    with pytest.raises(ValueError, match="gru_recurrence"):
        gru.gru_recurrence(xg, w, h0, n)


def test_wrapper_raises_on_cpu():
    xg, w, h0, n = _kernel_args()
    assert gru.layout_problem(xg, w, h0, n) is None
    assert gru.layout_problem(xg, w[:, :64], None, n) is None
    with pytest.raises(ValueError, match="CUDA tensor"):
        gru.gru_recurrence(xg, w, h0, n)


def test_imports_build_nothing(monkeypatch, tmp_path):
    """The wrapper and the models import in a fresh process with no library
    built or loaded; building without nvcc raises."""
    code = ("import voicepuppet_torch.models\n"
            "import voicepuppet_torch.pipeline.streaming\n"
            "from voicepuppet_torch.ops import gru\n"
            "assert gru.LIBRARY._lib is None, 'built at import'\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gru.GruLibrary().function()


def test_counts_held_on_a_device_are_read_late():
    """A count given as a tensor is kept as it is and read when the counts
    are; ``counting`` says whether a recording is open."""
    assert not tracing.counting()
    with tracing.recording() as rec:
        assert tracing.counting()
        tracing.count("vp.n", torch.tensor(3))
        tracing.count("vp.n", 2)
        tracing.count("vp.m", torch.tensor([4]))
        assert rec.pending
    assert not tracing.counting()
    assert rec.summary()["counts"] == {"vp.n": 5, "vp.m": 4}
    assert rec.counts == {"vp.n": 5, "vp.m": 4} and not rec.pending


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("units", [256, 128])
@pytest.mark.parametrize("t", [16, 64, 512])
@pytest.mark.parametrize("b,lens", [(1, "full"), (3, "mixed")])
def test_plain_against_eager(b, lens, t, units, state):
    """The kernel's path in torch against the eager ``MaskedGRU`` on the
    CPU: outputs and finals within ``PLAIN_ABS``; zeros past each length."""
    lengths = (t,) if lens == "full" else (t, 0, max(1, t // 3))
    m = selftest.masked_gru(units, units, 1, seed=t)
    x, seq_len, h0 = selftest.inputs(b, t, units, units, lengths, state,
                                     seed=units)
    got, gfin = selftest.fused_plain(m, x, seq_len, h0)
    with torch.no_grad():
        want, wfin = _oracle(m, x, seq_len, h0, True)
    gap = max([float((got - want).abs().max())]
              + [float((g - w).abs().max()) for g, w in zip(gfin, wfin)])
    assert gap <= PLAIN_ABS, gap
    past = torch.arange(t)[None, :] >= seq_len[:, None]
    assert (got[past] == 0).all()
    if state and lens == "mixed":          # the empty row keeps its state
        assert torch.equal(gfin[0][1], h0[0][1])


def test_plain_two_layers_against_eager():
    m = selftest.masked_gru(64, 40, 2, seed=5)
    x, seq_len, h0 = selftest.inputs(3, 20, 64, 40, (20, 7, 0), True, 2)
    got, gfin = selftest.fused_plain(m, x, seq_len, h0)
    with torch.no_grad():
        want, wfin = _oracle(m, x, seq_len, h0, True)
    assert float((got - want).abs().max()) <= PLAIN_ABS
    assert all(float((g - w).abs().max()) <= PLAIN_ABS
               for g, w in zip(gfin, wfin))


def test_plain_carries_state_exactly():
    """The torch version over xg in two calls, the state carried, equals
    one call over the whole, byte for byte (per-row lengths past the
    split keep running; a row that ended stays frozen)."""
    xg, w, _, _ = _kernel_args(64, 3, 30)
    h0 = torch.tanh(torch.randn(3, 64, generator=torch.Generator()
                                .manual_seed(1)))
    lens = torch.tensor([30, 12, 0])
    whole, hw = gru.gru_recurrence_plain(xg, w, h0, lens)
    first, h1 = gru.gru_recurrence_plain(xg[:, :16], w, h0, lens)
    rest, h2 = gru.gru_recurrence_plain(xg[:, 16:], w, h1,
                                        torch.clamp(lens - 16, min=0))
    assert torch.equal(torch.cat([first, rest], 1), whole)
    assert torch.equal(h2, hw)


def _jax_masked_gru(m, x, seq_len, h0):
    """The JAX package's ``masked_gru`` with ``m``'s weights (inference:
    ``train=False``), on JAX's CPU backend: (outputs, finals) as numpy."""
    import jax
    import jax.numpy as jnp
    from voicepuppet_tpu.models.layers import masked_gru
    assert jax.default_backend() == "cpu", jax.default_backend()
    params = {}
    for layer in range(m.num_layers):
        cell = getattr(m, f"ScanTFGRUCell_{layer}")
        params[f"ScanTFGRUCell_{layer}"] = {
            name: {"kernel": jnp.asarray(d.weight.detach().t().numpy()),
                   "bias": jnp.asarray(d.bias.detach().numpy())}
            for name, d in (("Dense_0", cell.Dense_0),
                            ("Dense_1", cell.Dense_1))}
    mod = masked_gru(num_units=m.num_units, num_layers=m.num_layers,
                     drop_rate=0.0)
    state = (None if h0 is None
             else [jnp.asarray(h.numpy()) for h in h0])
    out, fin = mod.apply({"params": params}, jnp.asarray(x.numpy()),
                         jnp.asarray(seq_len.numpy().astype(np.int32)),
                         train=False, initial_state=state, return_state=True)
    return np.asarray(out), [np.asarray(f) for f in fin]


@pytest.mark.parametrize("b,t,units,lengths,state", [
    (3, 64, 256, (64, 0, 37), False),
    (3, 64, 256, (64, 0, 37), True),
    (3, 16, 128, (16, 5, 0), True),
    (1, 512, 256, (367,), True),
    (1, 512, 128, (512,), False),
])
def test_plain_against_jax(b, t, units, lengths, state):
    """The kernel's path in torch against the JAX package's ``masked_gru``
    on the same weights and inputs: outputs and finals within
    ``JAX_ABS``."""
    m = selftest.masked_gru(units, units, 1, seed=b + t)
    x, seq_len, h0 = selftest.inputs(b, t, units, units, lengths, state,
                                     seed=units)
    got, gfin = selftest.fused_plain(m, x, seq_len, h0)
    want, wfin = _jax_masked_gru(m, x, seq_len, h0)
    assert np.abs(got.numpy() - want).max() <= JAX_ABS
    for g, w in zip(gfin, wfin):
        assert np.abs(g.numpy() - w).max() <= JAX_ABS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_card_against_eager(card):
    """Every case of ``gru_selftest.CASES`` (B 1 and 3 with mixed lengths
    including 0, T 16 to 2048, units 256 and 128, with and without an
    initial state): the kernel within ``KERNEL_ABS`` of the eager loop, of
    the torch version and of the eager loop in float64, the same run to
    run, zeros past each length, one launch a layer."""
    for case in selftest.CASES:
        r = selftest.check_case(card, *case)
        assert r["eager_abs"] <= selftest.KERNEL_ABS, (case, r)
        assert r["plain_abs"] <= selftest.KERNEL_ABS, (case, r)
        assert r["kernel_f64"] <= selftest.KERNEL_ABS, (case, r)
        assert r["run_to_run"] and r["zero_past"], (case, r)
        assert r["launches"] == 2, (case, r)


@pytest.mark.card
def test_card_two_layers(card):
    r = selftest.check_case(card, 3, 64, 128, 40, (64, 9, 0), True, 2)
    assert r["eager_abs"] <= selftest.KERNEL_ABS, r
    assert r["launches"] == 4, r


@pytest.mark.card
def test_card_carries_state_exactly(card):
    assert selftest.check_carry(card)


@pytest.mark.card
def test_card_served_calls_take_the_kernel(card):
    r = selftest.served_counts(card)
    assert r["batch"]["eager"] == 0 and r["batch"]["fused"] == r["frames"]
    assert r["live"]["eager"] == 0
    assert r["live"]["fused"] == 16 * r["blocks"]


@pytest.mark.card
def test_card_training_step_takes_eager(card):
    r = selftest.training_step_counts(card)
    assert r["train"] == {"fused": 0, "eager": r["steps"]}
    assert r["eval"]["eager"] == 0 and r["eval"]["fused"] > 0
