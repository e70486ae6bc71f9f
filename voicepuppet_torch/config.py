"""Configuration for the serving path.

Own copy of the serving subset of ``voicepuppet_tpu/config.py``: the mel
frontend, BFMNet and PixRefer hyper-parameters and the top-level fields
the synthesis pipeline reads.  The YAML loader accepts the reference
``config/params.yml`` schema and the nested native schema; keys this
subset does not know are ignored, as the reference loader ignores extras.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MelConfig:
    """Audio frontend parameters (ref: config/params.yml:16-21)."""

    sample_rate: int = 16000
    num_mel_bins: int = 80
    win_length: int = 512
    fft_length: int = 512
    hop_step: int = 128
    lower_edge_hertz: float = 80.0
    upper_edge_hertz: float = 7600.0
    log_offset: float = 1e-6


@dataclass(frozen=True)
class BFMNetConfig:
    """BFMNet inference hyper-parameters (ref: bfmnet.py:143-157)."""

    thinresnet_scale: Tuple[int, int] = (1, 32)
    thinresnet_output_channels: int = 256
    encode_embedding_size: int = 256
    rnn_hidden_size: int = 256
    rnn_layers: int = 1
    bfm_coeff_size: int = 64
    backbone_width_mult: float = 1.0


@dataclass(frozen=True)
class PixReferConfig:
    """PixRefer generator hyper-parameters (ref: pixrefer.py:24-37)."""

    ngf: int = 64
    img_size: int = 512


@dataclass(frozen=True)
class Config:
    model_dir: str = "./allmodels"
    frame_rate: int = 25
    mel: MelConfig = field(default_factory=MelConfig)
    bfmnet: BFMNetConfig = field(default_factory=BFMNetConfig)
    pixrefer: PixReferConfig = field(default_factory=PixReferConfig)

    def __post_init__(self):
        if self.frame_wav_scale * self.frame_rate != self.mel.sample_rate:
            raise ValueError(
                "sample_rate must be divisible by frame_rate: "
                f"{self.mel.sample_rate} / {self.frame_rate}")
        scale = self.mel.sample_rate / self.mel.hop_step / self.frame_rate
        if scale != int(scale):
            raise ValueError(
                "sample_rate/hop_step must be divisible by frame_rate "
                f"(got {self.mel.sample_rate}/{self.mel.hop_step}/"
                f"{self.frame_rate})")

    @property
    def frame_wav_scale(self) -> int:
        """PCM samples per video frame (640 at 16 kHz / 25 fps)."""
        return self.mel.sample_rate // self.frame_rate

    @property
    def frame_mfcc_scale(self) -> int:
        """Mel frames per video frame (5 at hop 128)."""
        return self.frame_wav_scale // self.mel.hop_step

    def pcm_length_for_frames(self, num_frames: int) -> int:
        """The pcm window producing exactly ``num_frames *
        frame_mfcc_scale`` STFT frames (ref: generator/generator.py:478)."""
        return (self.mel.hop_step * (num_frames * self.frame_mfcc_scale - 1)
                + self.mel.win_length)


def _update_dataclass(obj, overrides: Dict[str, Any]):
    """Recursively apply a nested dict onto a frozen dataclass tree."""
    kwargs = {}
    names = {f.name for f in dataclasses.fields(obj)}
    for key, value in overrides.items():
        if key not in names:
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return dataclasses.replace(obj, **kwargs)


def load_config(config_path: Optional[str] = None,
                profile: str = "default") -> Config:
    """Load a YAML profile on top of the defaults;
    ``load_config(None)`` returns the defaults."""
    cfg = Config()
    if config_path is None:
        return cfg
    if not os.path.exists(config_path):
        raise FileNotFoundError(config_path)
    import yaml     # only the YAML path needs it
    with open(config_path) as f:
        docs = yaml.safe_load(f)
    raw = docs.get(profile, docs) if isinstance(docs, dict) else {}
    flat = {k: raw[k] for k in ("model_dir", "frame_rate", "mel",
                                "bfmnet", "pixrefer") if k in raw}
    return _update_dataclass(cfg, flat)
