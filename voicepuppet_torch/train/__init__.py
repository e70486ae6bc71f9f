"""Training: the BFMNet, PixRefer, PixFlow, ATNet and VGNet trainers, on
one device or data-parallel over a ``parallel.mesh.DataGroup``, their
optimizer, loop, train states, checkpoints and logs (port of
``voicepuppet_tpu/train``)."""

from voicepuppet_torch.train.state import TrainState, GANTrainState
from voicepuppet_torch.train.optim import (reference_adam,
                                           exponential_decay_schedule)
from voicepuppet_torch.train.checkpoint import CheckpointManager

__all__ = ["TrainState", "GANTrainState", "reference_adam",
           "exponential_decay_schedule", "CheckpointManager"]
