"""The live sessions' schedule: ``sessions`` sessions, each feeding
``feed_samples`` of pcm every ``feed_s`` seconds in real time from its
start offset.  The offsets are the same set for every seed,
``(k + 0.5) / K`` of ``spread_s``, given to the sessions in an order
drawn from the seed."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def offsets(k: int, spread_s: float, seed: int) -> List[float]:
    base = [(i + 0.5) / k * spread_s for i in range(k)]
    order = np.random.default_rng([seed, 30]).permutation(k)
    return [base[i] for i in order]


def due_times(k: int, spread_s: float, feed_s: float, seconds: float,
              seed: int) -> List[Tuple[float, int, int]]:
    """Every feed due before ``seconds``: (due time, session, feed index),
    in order of due time, ties by session."""
    out = []
    for s, off in enumerate(offsets(k, spread_s, seed)):
        j = 0
        while off + j * feed_s < seconds:
            out.append((off + j * feed_s, s, j))
            j += 1
    return sorted(out)
