"""A/B micro-timing harness for the raster profile entry points.

The port's counterpart of ``experiments/_timing.py``, with its API
(``build_progs``, ``interleaved_minima``, ``per_iter``).  On the card a
program is one call of a variant, or ``k`` calls back to back on the
current stream with no host sync between them, timed with CUDA events;
the per-call time is ``(t_k - t_1) / (k - 1)``, which cancels the fixed
cost of one timed window.  A spin kernel holds the stream while the host
queues the calls, so a call whose host-side enqueue is slower than its
device work is still timed at the device's pace.  Variants are timed in
turns, round after round, and each keeps its minimum: the host is noisy.

With ``carry`` each call's input depends on the previous call's output,
as the JAX harness's ``fori_loop`` carry does: every floating tensor of
the input is nudged by ``1e-30`` times an element of the output (a
no-op on the values, a data dependence on the stream).  Eager launches
cannot be hoisted, so the carry only orders them.  Its cost, a few
elementwise launches over the input per call, is timed apart (``k``
nudges alone in a window of their own) and taken off each timing.

``build_progs`` raises when a variant fails to build or launch: a variant
skipped in silence would hide a kernel that does not work.  On
``device="cpu"`` (the tests) programs are timed with ``perf_counter``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

HOLD_CYCLES = 20_000_000     # ~10 ms of spin at the H100's ~2 GHz

Prog = Tuple[Callable[[Any], float], Callable[[Any], float], Any]


def _first_float(out) -> Optional[torch.Tensor]:
    """A 0-d float32 view of the first element of ``out``'s first
    floating (or any) tensor, in tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        return out.reshape(-1)[0].float() if out.numel() else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for o in items:
        got = _first_float(o)
        if got is not None:
            return got
    return None


def nudge(x, out):
    """``x`` with every floating tensor moved by ``1e-30 *`` an element
    of ``out`` (tuples, lists and dicts kept)."""
    s = _first_float(out)
    if s is None:
        return x

    def go(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a + (1e-30 * s).to(a.dtype)
        if isinstance(a, tuple):
            return tuple(go(b) for b in a)
        if isinstance(a, list):
            return [go(b) for b in a]
        if isinstance(a, dict):
            return {key: go(b) for key, b in a.items()}
        return a
    return go(x)


def repeat(f: Callable[[Any], Any], k: int, device,
           carry: bool = False) -> Callable[[Any], float]:
    """``x -> seconds`` that ``k`` back-to-back calls of ``f(x)`` take.
    With ``carry`` each call is fed the previous call's nudged input, and
    ``k`` nudges alone, timed in a window of their own right after, are
    taken off: the result is the calls' time without the carry's."""
    def calls(x):
        out = None
        for _ in range(k):
            out = f(x)
            if carry:
                x = nudge(x, out)
        return out

    def nudges(x, out):
        for _ in range(k):
            x = nudge(x, out)

    if torch.device(device).type != "cuda":
        def host_window(fn, *args):
            t0 = time.perf_counter()
            got = fn(*args)
            return got, time.perf_counter() - t0

        def run_host(x):
            out, t = host_window(calls, x)
            return t - host_window(nudges, x, out)[1] if carry else t
        return run_host

    def window(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        got = fn(*args)
        end.record()
        return got, (start, end)

    def run(x):
        out, span = window(calls, x)
        spans = [span] + ([window(nudges, x, out)[1]] if carry else [])
        spans[-1][1].synchronize()
        t = [a.elapsed_time(b) / 1e3 for a, b in spans]
        return t[0] - sum(t[1:])
    return run


def build_progs(cases: Mapping[str, Tuple[Callable, Any]], k: int,
                device="cuda", log: Optional[Callable] = print,
                carry: bool = False) -> Dict[str, Prog]:
    """``{name: (f, x)}`` -> ``{name: (run1, runK, x)}``, each program run
    once as a warm-up (the first CUDA call builds the kernels).  Raises
    the variant's own error when one fails."""
    if k < 2:
        raise ValueError(f"k must be at least 2, got {k}")
    progs = {}
    for name, (f, x) in cases.items():
        p1 = repeat(f, 1, device, carry)
        pk = repeat(f, k, device, carry)
        p1(x)
        pk(x)
        progs[name] = (p1, pk, x)
        if log:
            log(f"built {name}")
    return progs


def interleaved_minima(progs: Mapping[str, Prog], rounds: int = 6,
                       log: Optional[Callable] = print
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Variants in turns for ``rounds`` rounds -> per-variant minima of
    (t_1, t_K) in seconds."""
    mins1 = {name: float("inf") for name in progs}
    minsk = {name: float("inf") for name in progs}
    for r in range(rounds):
        for name, (f1, fk, x) in progs.items():
            mins1[name] = min(mins1[name], f1(x))
            minsk[name] = min(minsk[name], fk(x))
        if log:
            log(f"round {r} done")
    return mins1, minsk


def per_iter(mins1: Mapping[str, float], minsk: Mapping[str, float],
             k: int) -> Dict[str, float]:
    """Seconds per call: ``(t_K - t_1) / (K - 1)``."""
    if k < 2:
        raise ValueError(f"k must be at least 2, got {k}")
    return {name: (minsk[name] - mins1[name]) / (k - 1) for name in mins1}
