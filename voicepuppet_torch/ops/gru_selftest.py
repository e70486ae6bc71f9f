"""Card checks of the GRU recurrence kernel (``ops/gru.py``,
``csrc/gru.cu``), shared by ``tests/test_torch_gru_fused.py`` (its tests
marked ``card``) and ``chip_smoke.py`` (``phase_gru``):

* ``check_case``: a ``MaskedGRU`` through the kernel against its eager step
  loop (the same module, autograd on), against the torch version of the
  kernel's path (``gru_recurrence_plain``) and against itself, run to run;
* ``check_carry``: the kernel over a sequence in two calls, the state
  carried, against one call over the whole: byte for byte;
* ``served_counts`` / ``training_step_counts``: the ``vp.gru.*`` counters of
  a served ``synthesize`` and a live block, and of a BFMNet training step;
* ``time_case``: the kernel's microseconds a step at B 1, beside the eager
  loop's (``library_ms`` in ``chip_smoke.py``'s table: the path the kernel
  replaces).

Weights are drawn as the flax init draws a GRU's (orthogonal kernels, gate
bias 1.0), inputs from a seeded generator.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from voicepuppet_torch.models import layers
from voicepuppet_torch.ops import gru
from voicepuppet_torch.utils import tracing

KERNEL_ABS = 1e-5      # max |kernel - eager| (float32 sums in other orders)
# (B, T, units, in_dim, lengths, initial state) of the card checks
CASES = tuple((b, t, u, d, lens, state)
              for u, d in ((256, 256), (128, 128))
              for b, t, lens in ((1, 16, (16,)), (1, 64, (64,)),
                                 (3, 64, (64, 0, 37)), (1, 512, (367,)),
                                 (3, 512, (512, 5, 0)), (1, 2048, (1501,)))
              for state in (False, True))


def masked_gru(units: int, in_dim: int, layers_: int = 1, seed: int = 0,
               device=None) -> layers.MaskedGRU:
    """A ``MaskedGRU`` with the flax init's weights from ``seed``."""
    m = layers.init_flax_like_(layers.MaskedGRU(in_dim, units, layers_),
                               torch.Generator().manual_seed(seed))
    return m.to(device)


def inputs(b: int, t: int, units: int, in_dim: int, lens: Sequence[int],
           state: bool, layers_: int = 1, seed: int = 1, device=None):
    """(x [B,T,in], seq_len [B] int64, initial state or None) from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, in_dim, generator=gen)
    h0 = ([torch.tanh(torch.randn(b, units, generator=gen)).to(device)
           for _ in range(layers_)] if state else None)
    return (x.to(device), torch.tensor(lens, dtype=torch.int64,
                                       device=device), h0)


def fused_plain(m: layers.MaskedGRU, x, seq_len, h0):
    """The kernel's path with its torch version in the kernel's place."""
    with torch.no_grad():
        return m._fused_forward(x, seq_len, h0, True,
                                recurrence=gru.gru_recurrence_plain)


def _gap(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_case(dev, b, t, units, in_dim, lens, state,
               layers_: int = 1) -> dict:
    """One shape: the kernel's outputs and finals against eager's and the
    plain version's (max |Δ|), run to run (equal), the zero fill past each
    length, and the launches (one a layer); the kernel's and eager's
    distances from the eager loop in float64 (``*_f64``)."""
    m = masked_gru(units, in_dim, layers_, 0, dev)
    x, seq_len, h0 = inputs(b, t, units, in_dim, lens, state, layers_, 1,
                            dev)
    before = gru.LIBRARY.launches
    with torch.inference_mode():
        out, fin = m(x, seq_len, h0, return_state=True)
        again, fin2 = m(x, seq_len, h0, return_state=True)
    launches = gru.LIBRARY.launches - before
    with torch.enable_grad():
        want, wfin = m(x, seq_len, h0, return_state=True)
    plain, pfin = fused_plain(m, x, seq_len, h0)
    want, wfin = want.detach(), [f.detach() for f in wfin]
    with torch.no_grad():
        exact, efin = m.double()(x.double(), seq_len, None if h0 is None else
                                 [h.double() for h in h0], return_state=True)
    torch.cuda.synchronize(dev)
    past = (torch.arange(t, device=dev)[None, :] >= seq_len[:, None])
    return {
        "eager_abs": max([_gap(out, want)]
                         + [_gap(f, w) for f, w in zip(fin, wfin)]),
        "plain_abs": max([_gap(out, plain)]
                         + [_gap(f, p) for f, p in zip(fin, pfin)]),
        "run_to_run": bool(torch.equal(out, again) and all(
            torch.equal(f, g) for f, g in zip(fin, fin2))),
        "zero_past": bool((out[past] == 0).all()),
        "launches": launches,
        "kernel_f64": max([_gap(out.double(), exact)] + [
            _gap(f.double(), e) for f, e in zip(fin, efin)]),
        "eager_f64": max([_gap(want.double(), exact)] + [
            _gap(w.double(), e) for w, e in zip(wfin, efin)]),
    }


def check_carry(dev) -> bool:
    """The kernel over xg in two calls, 16 steps then 496 from the first
    call's final state, against one call over the 512 (B 2, units 256):
    outputs and finals byte for byte."""
    t, split, units = 512, 16, 256
    gen = torch.Generator().manual_seed(3)
    m = masked_gru(units, units, 1, 3)
    w_h = torch.cat([m.ScanTFGRUCell_0.Dense_0.weight,
                     m.ScanTFGRUCell_0.Dense_1.weight])[:, units:]
    w_h = w_h.detach().contiguous().to(dev)
    xg = torch.randn(2, t, 3 * units, generator=gen).to(dev)
    h0 = torch.tanh(torch.randn(2, units, generator=gen)).to(dev)
    full = lambda n: torch.full((2,), n, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        whole, hw = gru.gru_recurrence(xg, w_h, h0, full(t))
        first, h1 = gru.gru_recurrence(xg[:, :split].contiguous(), w_h, h0,
                                       full(split))
        rest, h2 = gru.gru_recurrence(xg[:, split:].contiguous(), w_h, h1,
                                      full(t - split))
    return bool(torch.equal(torch.cat([first, rest], 1), whole)
                and torch.equal(h2, hw))


def _counts(rec) -> dict:
    counts = rec.counts
    return {"fused": counts.get("vp.gru.fused", 0),
            "eager": counts.get("vp.gru.eager", 0)}


def served_counts(dev) -> dict:
    """The counters of one served ``synthesize`` (``Config()`` widths, a
    16² synthetic BFM, a 55-frame clip) and of the live blocks the same
    clip fed at once makes: {"batch": {...}, "live": {...}, "frames",
    "blocks"}."""
    frames = 55
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.pipeline import streaming
    from voicepuppet_torch.pipeline import synthesize as syn
    cfg = tcfg.Config()
    face = bfm.synthetic_bfm(num_theta=16, num_phi=16)
    synth = syn.Synthesizer(cfg, face, *syn.SynthesisAssets.init_trees(
        cfg, 0), chunk=32, device=dev)
    ident = syn.synthetic_identity(face, 0, cfg.pixrefer.img_size)
    s = cfg.pixrefer.img_size
    rng = np.random.RandomState(0)
    pcm = (0.1 * rng.randn((frames - 1) * cfg.frame_wav_scale)
           ).astype(np.float32)
    panel = rng.rand(s, 3 * s, 3).astype(np.float32)
    with tracing.recording() as rec:
        synth.synthesize(panel, pcm, ident)
    batch = _counts(rec)
    pred = streaming.StreamingCoeffPredictor(synth)
    with tracing.recording() as rec:
        blocks = pred.feed(pcm)
    if not blocks:
        raise AssertionError("the live predictor emitted no block")
    return {"batch": batch, "live": _counts(rec), "frames": frames,
            "blocks": len(blocks)}


def training_step_counts(dev) -> dict:
    """The counters of one BFMNet training step (``Config()`` widths, batch
    2, T 24) and of the trainer's eval loss on the same batch."""
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
    cfg = tcfg.Config()
    trainer = BFMNetTrainer(cfg, bfm.synthetic_bfm(num_theta=16, num_phi=16),
                            device=dev)
    state = trainer.init_state(seed=0)
    rng = np.random.RandomState(0)
    b, t = 2, 24
    batch = (rng.randn(b, t, 257).astype(np.float32) * 0.1,
             rng.rand(b, t, 1).astype(np.float32) * 0.1,
             rng.randn(b, t * 5, 80).astype(np.float32),
             np.array([t, 17], np.int64))
    with tracing.recording() as rec:
        trainer.train_step(state, batch, torch.Generator(dev).manual_seed(0))
    train = _counts(rec)
    with tracing.recording() as rec:
        trainer.eval_loss(state, batch)
    return {"train": train, "eval": _counts(rec), "steps": b * t}


def _events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / iters


def time_case(dev, t: int, units: int) -> dict:
    """At B 1, lengths t: the kernel alone (``gru_recurrence`` on a ready
    xg) in µs a step and ms a call, the whole fused layer (the matrix
    product, the stacking and the kernel), the torch version on the same
    xg and the eager loop with no graph recorded, in ms (CUDA events over
    20 calls, 2 of the torch version and of eager)."""
    in_dim = units
    m = masked_gru(units, in_dim, 1, 0, dev)
    x, seq_len, _ = inputs(1, t, units, in_dim, (t,), False, 1, 1, dev)
    cell = m.ScanTFGRUCell_0
    with torch.inference_mode():
        w = torch.cat([cell.Dense_0.weight, cell.Dense_1.weight])
        bias = torch.cat([cell.Dense_0.bias, cell.Dense_1.bias])
        xg = torch.addmm(bias, x.reshape(t, in_dim), w[:, :in_dim].t()
                         ).view(1, t, -1)
        w_h = w[:, in_dim:]
        kernel = _events_ms(lambda: gru.gru_recurrence(xg, w_h, None,
                                                       seq_len), 20)
        layer = _events_ms(lambda: m(x, seq_len), 20)
        plain = _events_ms(lambda: gru.gru_recurrence_plain(xg, w_h, None,
                                                            seq_len),
                           2)
    # autograd on but nothing requiring grad: the dispatch takes the eager
    # loop and no graph is recorded, as the serving path ran it before
    m.requires_grad_(False)
    with torch.enable_grad():
        eager = _events_ms(lambda: m(x, seq_len), 2)
    return {"t": t, "units": units, "kernel_ms": kernel,
            "us_a_step": 1000.0 * kernel / t, "layer_ms": layer,
            "plain_ms": plain, "eager_ms": eager}
