"""BFMNet inference — audio -> per-frame BFM expression coefficients.

Port of the inference path of ``voicepuppet_tpu/models/bfmnet.py``
(:43-166): MfccNet over the mel image + a [5, 3] 'same' max pool to one
vector per video frame, dense + leaky_relu, a dense into the GRU, the
masked GRU, and the coefficient head with the ear injection
``ears * [-2,-2,-2,-4]`` into coefficient dims [16, 20).  ``dtype`` is the
compute dtype of the conv trunk (JAX ``BFMNet.dtype``): bfloat16 runs the
MfccNet in bfloat16 from float32 parameters and BN moments, while the
pooled dense, the GRU and the coefficient head stay float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.config import BFMNetConfig
from voicepuppet_torch.models.layers import (MaskedGRU, MfccNet, TFBatchNorm,
                                             leaky_relu, max_pool_same)


class MfccEncoder(nn.Module):
    """ref: bfmnet.py:20-41 + the dense at bfmnet.py:198-200."""

    def __init__(self, output_channels: int = 256, embedding_size: int = 256,
                 pooling=(5, 3), width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_channels = output_channels
        self.pooling = tuple(pooling)
        self.MfccNet_0 = MfccNet(output_channels, width_mult=width_mult,
                                 dtype=dtype)
        self.Dense_0 = nn.Linear(output_channels, embedding_size)

    def forward(self, mfccs, valid_rows: Optional[torch.Tensor] = None):
        x = self.MfccNet_0(mfccs[:, None], valid_rows=valid_rows)
        x = max_pool_same(x, self.pooling, self.pooling)   # [B, C, T, 1]
        x = x.flatten(2).transpose(1, 2)                   # [B, T, C]
        return leaky_relu(self.Dense_0(x))


class BFMCoeffDecoder(nn.Module):
    """ref: bfmnet.py:112-118."""

    def __init__(self, in_dim: int, bfm_coeff_size: int = 64):
        super().__init__()
        self.bfm_coeff_size = bfm_coeff_size
        self.Dense_0 = nn.Linear(in_dim, 128)
        self.Dense_1 = nn.Linear(128, 64)
        self.Dense_2 = nn.Linear(64, bfm_coeff_size)

    def forward(self, x, ears):
        x = leaky_relu(self.Dense_0(x))
        x = leaky_relu(self.Dense_1(x))
        x = self.Dense_2(x)
        return x + F.pad(ears, (16, self.bfm_coeff_size - 16 - ears.shape[-1]))


class BFMNet(nn.Module):
    """ears [B,T,1], mfccs [B,T*5,80], seq_len [B] -> coeffs [B,T,64]."""

    def __init__(self, cfg: BFMNetConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.mfcc_encoder = MfccEncoder(c.thinresnet_output_channels,
                                        c.encode_embedding_size,
                                        width_mult=c.backbone_width_mult,
                                        dtype=dtype)
        self.rnn_in = nn.Linear(c.encode_embedding_size,
                                c.encode_embedding_size)
        self.rnn_module = MaskedGRU(c.encode_embedding_size,
                                    c.rnn_hidden_size, c.rnn_layers)
        self.bfm_coeff_decoder = BFMCoeffDecoder(c.rnn_hidden_size,
                                                 c.bfm_coeff_size)
        self.register_buffer("ear_scale",
                             torch.tensor([-2.0, -2.0, -2.0, -4.0]),
                             persistent=False)

    def encode(self, mfccs, valid_rows: Optional[torch.Tensor] = None):
        """mfccs [B,T*5,80] -> pre-GRU embeddings [B,T,emb] (the
        convolutional trunk).  ``valid_rows`` [B] re-zeroes activations
        past those mel rows at every stage (``mask_time``)."""
        return leaky_relu(self.rnn_in(self.mfcc_encoder(mfccs, valid_rows)))

    def decode(self, x, ears, seq_len, rnn_state=None,
               return_rnn_state: bool = False):
        """GRU + coefficient head.  ``rnn_state``/``return_rnn_state``
        carry the hidden state across chunks; the recurrence is exactly
        streamable (pipeline/streaming.py)."""
        x = self.rnn_module(x, seq_len, initial_state=rnn_state,
                            return_state=return_rnn_state)
        if return_rnn_state:
            x, new_state = x
        out = self.bfm_coeff_decoder(x, ears * self.ear_scale)
        if return_rnn_state:
            return out, new_state
        return out

    def forward(self, ears, mfccs, seq_len, mask_time: bool = False):
        """``mask_time=True`` re-zeroes CNN activations past seq_len*5 at
        every stage, so a bucket-padded run equals the exact-length run
        for frames < seq_len (the serving path)."""
        valid = seq_len * self.mfcc_encoder.pooling[0] if mask_time else None
        return self.decode(self.encode(mfccs, valid), ears, seq_len)


def init_bfmnet_(model: BFMNet, generator: torch.Generator) -> BFMNet:
    """Fresh weights drawn as the JAX init draws them (its distributions,
    not its bits): xavier-uniform conv and dense kernels, orthogonal GRU
    kernels with gate bias 1.0, zero biases, BN moments (0, 1)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                if ".ScanTFGRUCell_" in name:
                    _orthogonal_(w, generator)
                else:
                    fan_out = w.shape[0] * w[0, 0].numel()
                    fan_in = w[0].numel()
                    a = math.sqrt(6.0 / (fan_in + fan_out))
                    w.uniform_(-a, a, generator=generator)
                if mod.bias is not None:
                    gate = name.endswith("Dense_0") and ".ScanTFGRUCell_" in name
                    mod.bias.fill_(1.0 if gate else 0.0)
            elif isinstance(mod, TFBatchNorm):
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model


def _orthogonal_(w: torch.Tensor, generator: torch.Generator):
    """flax ``orthogonal()`` on the [in, out] kernel, stored [out, in]."""
    rows, cols = w.shape[1], w.shape[0]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    w.copy_(q.T)
