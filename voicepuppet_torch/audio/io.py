"""Host-side audio decode.

Replaces the reference's librosa/scipy+resampy loaders
(generator/loader.py:92-119) without those dependencies: WAV via
``scipy.io.wavfile``; any other container (e.g. the sample .aac,
infer_bfmvid.py:159) is decoded by shelling out to ffmpeg.  Output is mono
float32 in [-1, 1] at the requested sample rate, matching
``librosa.load(path, sr=16000)`` semantics.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
from scipy.io import wavfile
from scipy import signal as _signal


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    # rescale BEFORE the channel mean: mean() promotes integer PCM to
    # float64 and would skip the dtype branches for multi-channel input
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data.astype(np.float32)


def resample(pcm: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), standing in for resampy
    (generator/loader.py:118)."""
    if orig_sr == target_sr:
        return pcm
    g = np.gcd(int(orig_sr), int(target_sr))
    return _signal.resample_poly(pcm, target_sr // g, orig_sr // g).astype(
        np.float32)


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """WavLoader equivalent (generator/loader.py:92-102)."""
    rate, data = wavfile.read(path)
    return resample(_to_float_mono(data), rate, sr)


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """Decode any audio container to mono float32 at ``sr``.  Non-wav input
    goes through ffmpeg (the reference assumes librosa+audioread for its
    .aac sample; infer_bfmvid.py:158-159)."""
    if path.lower().endswith(".wav"):
        return load_wav(path, sr)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not found; cannot decode " + path)
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.wav")
        subprocess.run(
            [ffmpeg, "-v", "error", "-i", path, "-ac", "1", "-ar", str(sr),
             "-f", "wav", "-y", out],
            check=True)
        return load_wav(out, sr)
