"""Log-mel audio frontend as two fp32 matmuls.

Port of ``voicepuppet_tpu/audio/frontend.py``: ``tf.signal.stft``
(periodic Hann, no centering) -> magnitude -> HTK mel weights (bin 0
zeroed) -> ``log(mel + log_offset)``.  The windowed DFT is a matmul
against precomputed cos/-sin bases with the window folded in; frames come
from a hop-reshaped view, as in the reference.  Both matmuls run in full
float32 (TF32 off), matching the reference's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (``tf.signal.hann_window``)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def _hertz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


def linear_to_mel_weight_matrix(num_mel_bins: int,
                                num_spectrogram_bins: int,
                                sample_rate: float,
                                lower_edge_hertz: float,
                                upper_edge_hertz: float) -> np.ndarray:
    """``tf.signal.linear_to_mel_weight_matrix``: triangular filters on the
    HTK mel scale with the DC bin zeroed."""
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
    spectrogram_bins_mel = _hertz_to_mel(linear_freqs)[:, None]
    band_edges_mel = np.linspace(_hertz_to_mel(lower_edge_hertz),
                                 _hertz_to_mel(upper_edge_hertz),
                                 num_mel_bins + 2)
    lower_edge_mel = band_edges_mel[None, :-2]
    center_mel = band_edges_mel[None, 1:-1]
    upper_edge_mel = band_edges_mel[None, 2:]
    lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
        center_mel - lower_edge_mel)
    upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
        upper_edge_mel - center_mel)
    mel_weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    mel_weights = np.pad(mel_weights, [[1, 0], [0, 0]])
    return mel_weights.astype(np.float32)


def _dft_bases(win_length: int, fft_length: int) -> np.ndarray:
    """[win_length, 2 * (fft_length//2 + 1)]: Hann-windowed cos bases then
    -sin bases (rows past win_length are the stft zero padding, dropped)."""
    bins = fft_length // 2 + 1
    n = np.arange(fft_length, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / fft_length
    window = hann_window(win_length).astype(np.float64)[:, None]
    basis = np.concatenate([np.cos(angle), -np.sin(angle)],
                           axis=1)[:win_length] * window
    return basis.astype(np.float32)


def full_fp32_matmuls():
    """Turn TF32 off for cuBLAS and cuDNN: the frontend, the 3DMM decode
    and BFMNet are held to the reference's full-float32 numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class MelFrontend:
    """pcm ``[B, N]`` in [-1, 1] -> log-mel ``[B, F, num_mel_bins]``,
    ``F = 1 + (N - win) // hop``."""

    def __init__(self, mel_cfg, device="cuda"):
        self.cfg = mel_cfg
        self.win_length = mel_cfg.win_length
        self.hop_step = mel_cfg.hop_step
        self.num_bins = mel_cfg.fft_length // 2 + 1
        self.log_offset = mel_cfg.log_offset
        self.device = torch.device(device)
        self._basis = torch.from_numpy(_dft_bases(
            self.win_length, mel_cfg.fft_length)).to(self.device)
        self._mel = torch.from_numpy(linear_to_mel_weight_matrix(
            mel_cfg.num_mel_bins, self.num_bins, mel_cfg.sample_rate,
            mel_cfg.lower_edge_hertz, mel_cfg.upper_edge_hertz)).to(
                self.device)

    def num_frames(self, num_samples: int) -> int:
        return 1 + (num_samples - self.win_length) // self.hop_step

    def frame(self, pcm: torch.Tensor) -> torch.Tensor:
        """[..., N] -> [..., F, win_length] strided frames."""
        nf = self.num_frames(pcm.shape[-1])
        if self.win_length % self.hop_step == 0:
            k = self.win_length // self.hop_step
            rows_needed = nf - 1 + k
            usable = rows_needed * self.hop_step
            if pcm.shape[-1] < usable:
                pcm = torch.nn.functional.pad(
                    pcm, (0, usable - pcm.shape[-1]))
            rows = pcm[..., :usable].reshape(pcm.shape[:-1]
                                            + (rows_needed, self.hop_step))
            return torch.cat([rows[..., i:i + nf, :] for i in range(k)],
                             dim=-1)
        return pcm.unfold(-1, self.win_length, self.hop_step)

    def __call__(self, pcm: torch.Tensor) -> torch.Tensor:
        full_fp32_matmuls()
        frames = self.frame(torch.as_tensor(pcm, dtype=torch.float32,
                                            device=self.device))
        proj = frames @ self._basis
        re, im = proj.chunk(2, dim=-1)
        spec = torch.sqrt(re * re + im * im)
        return torch.log(spec @ self._mel + self.log_offset)
