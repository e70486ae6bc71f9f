"""The batch clip cycle: ``count`` clip lengths spread log-uniformly over
[min_frames, max_frames] (the same set for every seed, one length in
each of ``count`` equal steps of log length), in an order drawn from the
seed, each with its own speech-like audio."""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.traffic.speech import speech


def cycle_frames(spec: dict, seed: int) -> List[int]:
    count, lo, hi = spec["count"], spec["min_frames"], spec["max_frames"]
    frames = [int(round(lo * (hi / lo) ** ((i + 0.5) / count)))
              for i in range(count)]
    order = np.random.default_rng([seed, 1]).permutation(count)
    return [frames[i] for i in order]


def samples_for_frames(frames: int, frame_samples: int = 640) -> int:
    """pcm samples that the synthesizer maps to ``frames`` frames
    (``int(1 + samples / frame_samples)``)."""
    return (frames - 1) * frame_samples


def cycle(spec: dict, seed: int, sample_rate: int = 16000,
          frame_samples: int = 640) -> List[np.ndarray]:
    """The cycle's pcm clips, float32 [samples] each."""
    out = []
    for i, frames in enumerate(cycle_frames(spec, seed)):
        rng = np.random.default_rng([seed, 2, i])
        out.append(speech(samples_for_frames(frames, frame_samples), rng,
                          sample_rate, spec.get("audio")))
    return out
