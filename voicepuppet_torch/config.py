"""Configuration for serving and training.

Own copy of ``voicepuppet_tpu/config.py``: the mel frontend, the dataset
lists, the hyper-parameters of the five models (BFMNet, PixRefer,
PixFlow, ATNet, VGNet) with their training knobs, the device-mesh layout
and the top-level fields the pipelines read.  The YAML loader accepts the
reference ``config/params.yml`` schema and the nested native schema; keys
this subset does not know are ignored, as the reference loader ignores
extras.
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
class TrainingConfig:
    """Per-trainer optimization knobs (ref: config/params.yml:25-31)."""

    epochs: int = 100000
    drop_rate: float = 0.25
    learning_rate: float = 1e-3
    max_grad_norm: float = 50.0
    decay_steps: int = 1000
    decay_rate: float = 0.95
    beta1: float = 0.9
    save_interval: int = 5000    # ref: train_bfmnet.py:78
    eval_interval: int = 1000    # ref: train_bfmnet.py:80
    summary_interval: int = 100  # ref: train_pixrefer.py:144
    max_to_keep: int = 10        # ref: train_bfmnet.py:74


@dataclass(frozen=True)
class BFMNetConfig:
    """BFMNet hyper-parameters (ref: bfmnet.py:143-157)."""

    thinresnet_scale: Tuple[int, int] = (1, 32)
    thinresnet_output_channels: int = 256
    encode_embedding_size: int = 256
    rnn_hidden_size: int = 256
    rnn_layers: int = 1
    bfm_coeff_size: int = 64
    batch_size: int = 8          # ref: generator/generator.py:395
    mouth_weight: float = 10.0   # ref: bfmnet.py:137
    backbone_width_mult: float = 1.0
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        learning_rate=1e-4, decay_steps=10000, decay_rate=1.0))


@dataclass(frozen=True)
class PixReferConfig:
    """PixRefer GAN hyper-parameters (ref: pixrefer.py:24-37)."""

    ngf: int = 64
    ndf: int = 64
    l1_weight: float = 500.0
    gan_weight: float = 1.0
    img_size: int = 512
    batch_size: int = 2          # ref: generator/generator.py:938
    crop_ratio: float = 0.9      # ref: generator/generator.py:940
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        learning_rate=3e-4, beta1=0.5, decay_rate=0.999, max_to_keep=2))


@dataclass(frozen=True)
class PixFlowConfig:
    """PixFlowNet hyper-parameters (ref: pixflow.py:24-40)."""

    ngf: int = 64
    ndf: int = 48
    l1_weight: float = 500.0
    gan_weight: float = 1.0
    img_size: int = 512
    batch_size: int = 3          # ref: generator/generator.py:819
    crop_ratio: float = 0.9
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        learning_rate=3e-4, beta1=0.5, decay_rate=0.999, max_to_keep=2))


@dataclass(frozen=True)
class ATNetConfig:
    """ATNet (legacy) hyper-parameters (ref: atvgnet/atnet.py:150-190)."""

    thinresnet_output_channels: int = 256
    encode_embedding_size: int = 128
    rnn_hidden_size: int = 128
    landmark_size: int = 136
    pca_components: int = 6
    batch_size: int = 16         # ref: train_atnet.py:41
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        learning_rate=1e-4, decay_steps=10000, decay_rate=1.0))


@dataclass(frozen=True)
class VGNetConfig:
    """VGNet (legacy) hyper-parameters (ref: atvgnet/vgnet.py)."""

    img_size: int = 128
    landmark_size: int = 136
    batch_size: int = 4          # ref: train_vgnet.py:41
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        learning_rate=1e-4))


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset list / sample-file naming (ref: config/params.yml:1-14)."""

    train_dataset_path: str = "config/train.txt"
    eval_dataset_path: str = "config/eval.txt"
    root_path: str = ""
    train_by_eval: int = 9
    landmark_name: str = "landmark.txt"
    wav_name: str = "audio.wav"
    bfmcoeff_name: str = "bfmcoeff.txt"
    max_sequence_len: int = 30   # ref: generator/generator.py:392
    min_sequence_len: int = 20
    fixed_sequence_len: int = 24  # ref: generator/generator.py:460
    shuffle_bufsize: int = 1000
    silence_top_db: float = 20.0  # ref: generator/generator.py:461


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the reference's multi-device training.  The
    port's data group comes from torchrun's environment
    (``parallel.mesh.make_mesh``: every rank on the data axis, no model
    axis); the fields are kept so that a profile naming them loads
    unchanged."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 0   # 0 = all devices on the data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    model_dir: str = "./allmodels"
    frame_rate: int = 25
    # the generator the Synthesizer serves: "pixrefer" (infer_bfmvid.py)
    # or "pixflow" (infer_bfm_pixflow.py)
    generator: str = "pixrefer"
    mel: MelConfig = field(default_factory=MelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    bfmnet: BFMNetConfig = field(default_factory=BFMNetConfig)
    pixrefer: PixReferConfig = field(default_factory=PixReferConfig)
    pixflow: PixFlowConfig = field(default_factory=PixFlowConfig)
    atnet: ATNetConfig = field(default_factory=ATNetConfig)
    vgnet: VGNetConfig = field(default_factory=VGNetConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

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


_MODEL_KEYS = ("bfmnet", "pixrefer", "pixflow", "atnet", "vgnet")


def _distribute_training(out: Dict[str, Any], training: Dict[str, Any]):
    """Propagate the reference YAML's shared ``training:`` block into each
    model's training config.  A key reaches a model only if that model's
    default training config does not pin the field (pinned = differs from
    the base ``TrainingConfig`` default): the reference hard-codes those
    after its YAML load (bfmnet.py:153-157), so the YAML value is dead
    there too.  A per-model ``<model>: training:`` block always wins."""
    base = TrainingConfig()
    defaults = Config()
    for model_key in _MODEL_KEYS:
        model_default = getattr(defaults, model_key).training
        pinned = {f.name for f in dataclasses.fields(TrainingConfig)
                  if getattr(model_default, f.name) != getattr(base, f.name)}
        merged = {k: v for k, v in training.items()
                  if k not in pinned and not isinstance(v, dict)}
        merged.update(out.get(model_key, {}).get("training", {}))
        if merged:
            out.setdefault(model_key, {})["training"] = merged


def _flatten_reference_yaml(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Map the reference params.yml schema onto the Config tree."""
    out: Dict[str, Any] = {k: raw[k] for k in ("model_dir", "frame_rate",
                                               "generator", "mel",
                                               "training")
                           if k in raw}
    dataset: Dict[str, Any] = {k: raw[k] for k in (
        "train_dataset_path", "eval_dataset_path", "root_path",
        "train_by_eval") if k in raw}
    if "sample_file" in raw:
        dataset.update(raw["sample_file"])
    if dataset:
        out["dataset"] = dataset
    for key in ("dataset",) + _MODEL_KEYS + ("mesh",):
        if key in raw:
            out.setdefault(key, {}).update(raw[key])
    if isinstance(raw.get("training"), dict):
        _distribute_training(out, raw["training"])
    return out


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
    return _update_dataclass(cfg, _flatten_reference_yaml(raw))
