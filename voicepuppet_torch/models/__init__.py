"""BFMNet, its loss and its layers (``voicepuppet_tpu.models``
counterpart; the JAX ``masked_gru`` function is the module
``MaskedGRU`` here).  PixRefer, PixFlow, ATNet, VGNet and the VGG trunk
are the submodules of the same names."""

from voicepuppet_torch.models.bfmnet import BFMNet, BFMNetLoss
from voicepuppet_torch.models.layers import (MfccNet, ThinNet, TFGRUCell,
                                             MaskedGRU)

__all__ = ["BFMNet", "BFMNetLoss", "MfccNet", "ThinNet", "TFGRUCell",
           "MaskedGRU"]
