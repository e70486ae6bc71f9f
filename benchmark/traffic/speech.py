"""A seeded speech-like signal: a voiced source of harmonics over a pitch
that wanders between 90 and 250 Hz, a syllable envelope at 3 to 6 Hz, and
bursts of noise as fricatives, at 16 kHz in [-1, 1]."""

from __future__ import annotations

import numpy as np


def speech(num_samples: int, rng: np.random.Generator,
           sample_rate: int = 16000, params: dict = None) -> np.ndarray:
    p = dict(f0_lo=90.0, f0_hi=250.0, syl_lo=3.0, syl_hi=6.0,
             harmonics=12, burst_rate=1.5, burst_s=0.06, level=0.3)
    p.update(params or {})
    n = int(num_samples)
    t = np.arange(n) / sample_rate
    # pitch: a slow random walk between the bounds, in log frequency
    knots = max(2, int(n / sample_rate * 4) + 2)
    lo, hi = np.log(p["f0_lo"]), np.log(p["f0_hi"])
    walk = rng.uniform(lo, hi, knots)
    f0 = np.exp(np.interp(t, np.linspace(0, t[-1] if n else 1, knots), walk))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    k = np.arange(1, p["harmonics"] + 1)[:, None]
    voiced = (np.sin(k * phase[None]) / k).sum(0)
    # syllables: a raised cosine at a rate drawn per clip
    rate = rng.uniform(p["syl_lo"], p["syl_hi"])
    env = 0.5 - 0.5 * np.cos(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
    sig = voiced * env
    # fricative bursts of white noise
    bursts = rng.poisson(p["burst_rate"] * n / sample_rate)
    width = int(p["burst_s"] * sample_rate)
    for start in rng.integers(0, max(1, n - width), bursts):
        sig[start:start + width] += rng.normal(0.0, 0.5, min(width, n - start))
    peak = np.abs(sig).max() if n else 1.0
    return (sig / max(peak, 1e-9) * p["level"]).astype(np.float32)
