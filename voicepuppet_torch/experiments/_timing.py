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


def repeat(f: Callable[[Any], Any], k: int, device) -> Callable[[Any], float]:
    """``x -> seconds`` that ``k`` back-to-back calls of ``f(x)`` take."""
    if torch.device(device).type != "cuda":
        def run_host(x):
            t0 = time.perf_counter()
            for _ in range(k):
                f(x)
            return time.perf_counter() - t0
        return run_host

    def run(x):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(k):
            f(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return run


def build_progs(cases: Mapping[str, Tuple[Callable, Any]], k: int,
                device="cuda", log: Optional[Callable] = print
                ) -> Dict[str, Prog]:
    """``{name: (f, x)}`` -> ``{name: (run1, runK, x)}``, each program run
    once as a warm-up (the first CUDA call builds the kernels).  Raises
    the variant's own error when one fails."""
    if k < 2:
        raise ValueError(f"k must be at least 2, got {k}")
    progs = {}
    for name, (f, x) in cases.items():
        p1, pk = repeat(f, 1, device), repeat(f, k, device)
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
