"""The log-mel frontend and audio file readers (``voicepuppet_tpu.audio``
counterpart)."""

from voicepuppet_torch.audio.frontend import (MelFrontend, hann_window,
                                              linear_to_mel_weight_matrix)
from voicepuppet_torch.audio.io import load_audio, load_wav

__all__ = ["MelFrontend", "hann_window", "linear_to_mel_weight_matrix",
           "load_audio", "load_wav"]
