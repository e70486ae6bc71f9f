"""The reference's PixFlow batches, worked out again from the files.

The system's PixFlow input pipeline draws as its PixRefer one does
(``generator.py:837-902``): for each current frame of a shuffled pass
over the clips a random reference frame, then a random square crop of
each (``random.Random(seed)``), a shuffle buffer of 100 samples (its own
``random.Random(seed)``), batches of three; each worker with a seed of
its own.  PixFlow keeps the render pair, the foreground pair and the
current alpha, and drops the current target.  So the draws and the crops
are ``reference/data.py``'s, and only the fields differ: nothing of the
system imported."""

from __future__ import annotations

from benchmark.reference import data


def batch(list_path: str, s: int, crop_ratio: float, seed: int, index: int,
          batch_size: int):
    """Batch ``index`` of the worker seeded ``seed``: (inputs [B,S,S,6]
    render ref | cur, fg_inputs [B,S,S,6] foreground ref | cur, masks
    [B,S,S,3] the current alpha), float32 in [0, 1]."""
    inputs, fg_inputs, _targets, masks = data.batch(
        list_path, s, crop_ratio, seed, index, batch_size)
    return inputs, fg_inputs, masks
