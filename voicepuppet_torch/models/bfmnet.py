"""BFMNet — audio -> per-frame BFM expression coefficients, and its loss.

Port of ``voicepuppet_tpu/models/bfmnet.py``: MfccNet over the mel image
+ a [5, 3] 'same' max pool to one
vector per video frame, dense + leaky_relu, a dense into the GRU, the
masked GRU, and the coefficient head with the ear injection
``ears * [-2,-2,-2,-4]`` into coefficient dims [16, 20).  ``dtype`` is the
compute dtype of the conv trunk (JAX ``BFMNet.dtype``): bfloat16 runs the
MfccNet in bfloat16 from float32 parameters and BN moments, while the
pooled dense, the GRU and the coefficient head stay float32.

Training (``train=True``) uses batch-moment BN with running updates and
the reference's dropouts at ``cfg.training.drop_rate``: after the encoder
dense (JAX :66), on the GRU outputs, and after each hidden decoder dense
(:80, :83), with masks drawn from the caller's ``torch.Generator``.
Padded rows enter the train-mode BN moments, as in the reference
(``mask_time`` is off in training).  :class:`BFMNetLoss` is the
vertex-space sequence loss (:169-211), folded through the mouth-weighted
``exBase`` so the [B, T, 3N] vertex tensors never materialize.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.config import BFMNetConfig
from voicepuppet_torch.models.layers import (MaskedGRU, MfccNet,
                                             dropout, init_flax_like_,
                                             l2_regularization, leaky_relu,
                                             max_pool_same)


class MfccEncoder(nn.Module):
    """ref: bfmnet.py:20-41 + the dense at bfmnet.py:198-200."""

    def __init__(self, output_channels: int = 256, embedding_size: int = 256,
                 pooling=(5, 3), width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0):
        super().__init__()
        self.output_channels = output_channels
        self.pooling = tuple(pooling)
        self.drop_rate = drop_rate
        self.MfccNet_0 = MfccNet(output_channels, width_mult=width_mult,
                                 dtype=dtype)
        self.Dense_0 = nn.Linear(output_channels, embedding_size)

    def forward(self, mfccs, valid_rows: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.MfccNet_0(mfccs[:, None], valid_rows=valid_rows,
                           train=train)
        x = max_pool_same(x, self.pooling, self.pooling)   # [B, C, T, 1]
        x = x.flatten(2).transpose(1, 2)                   # [B, T, C]
        x = leaky_relu(self.Dense_0(x))
        return dropout(x, self.drop_rate, generator) if train else x


class BFMCoeffDecoder(nn.Module):
    """ref: bfmnet.py:112-118."""

    def __init__(self, in_dim: int, bfm_coeff_size: int = 64,
                 drop_rate: float = 0.0):
        super().__init__()
        self.bfm_coeff_size = bfm_coeff_size
        self.drop_rate = drop_rate
        self.Dense_0 = nn.Linear(in_dim, 128)
        self.Dense_1 = nn.Linear(128, 64)
        self.Dense_2 = nn.Linear(64, bfm_coeff_size)

    def forward(self, x, ears, train: bool = False,
                generator: Optional[torch.Generator] = None):
        drop = ((lambda v: dropout(v, self.drop_rate, generator)) if train
                else (lambda v: v))
        x = drop(leaky_relu(self.Dense_0(x)))
        x = drop(leaky_relu(self.Dense_1(x)))
        x = self.Dense_2(x)
        return x + F.pad(ears, (16, self.bfm_coeff_size - 16 - ears.shape[-1]))


class BFMNet(nn.Module):
    """ears [B,T,1], mfccs [B,T*5,80], seq_len [B] -> coeffs [B,T,64]."""

    def __init__(self, cfg: BFMNetConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        drop = c.training.drop_rate
        self.mfcc_encoder = MfccEncoder(c.thinresnet_output_channels,
                                        c.encode_embedding_size,
                                        width_mult=c.backbone_width_mult,
                                        dtype=dtype, drop_rate=drop)
        self.rnn_in = nn.Linear(c.encode_embedding_size,
                                c.encode_embedding_size)
        self.rnn_module = MaskedGRU(c.encode_embedding_size,
                                    c.rnn_hidden_size, c.rnn_layers, drop)
        self.bfm_coeff_decoder = BFMCoeffDecoder(c.rnn_hidden_size,
                                                 c.bfm_coeff_size, drop)
        self.register_buffer("ear_scale",
                             torch.tensor([-2.0, -2.0, -2.0, -4.0]),
                             persistent=False)

    def encode(self, mfccs, valid_rows: Optional[torch.Tensor] = None,
               train: bool = False,
               generator: Optional[torch.Generator] = None):
        """mfccs [B,T*5,80] -> pre-GRU embeddings [B,T,emb] (the
        convolutional trunk).  ``valid_rows`` [B] re-zeroes activations
        past those mel rows at every stage (``mask_time``)."""
        return leaky_relu(self.rnn_in(self.mfcc_encoder(
            mfccs, valid_rows, train, generator)))

    def decode(self, x, ears, seq_len, rnn_state=None,
               return_rnn_state: bool = False, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """GRU + coefficient head.  ``rnn_state``/``return_rnn_state``
        carry the hidden state across chunks; the recurrence is exactly
        streamable (pipeline/streaming.py)."""
        x = self.rnn_module(x, seq_len, initial_state=rnn_state,
                            return_state=return_rnn_state, train=train,
                            generator=generator)
        if return_rnn_state:
            x, new_state = x
        out = self.bfm_coeff_decoder(x, ears * self.ear_scale, train,
                                     generator)
        if return_rnn_state:
            return out, new_state
        return out

    def forward(self, ears, mfccs, seq_len, mask_time: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``mask_time=True`` re-zeroes CNN activations past seq_len*5 at
        every stage, so a bucket-padded run equals the exact-length run
        for frames < seq_len (the serving path).  ``train`` selects
        batch-moment BN (updating the running moments) and the dropouts,
        drawn from ``generator``."""
        valid = seq_len * self.mfcc_encoder.pooling[0] if mask_time else None
        return self.decode(self.encode(mfccs, valid, train, generator), ears,
                           seq_len, train=train, generator=generator)


def init_bfmnet_(model: BFMNet, generator: torch.Generator) -> BFMNet:
    """Fresh weights drawn as the JAX init draws them (its distributions,
    not its bits): xavier-uniform conv and dense kernels, orthogonal GRU
    kernels with gate bias 1.0, zero biases, BN moments (0, 1)."""
    return init_flax_like_(model, generator)


class BFMNetLoss:
    """Vertex-space sequence loss (ref: bfmnet.py:215-271; JAX
    ``bfmnet.py:169-211``): both branches compare ``exBase @ (pred_exp -
    true_exp)`` — the id / meanshape terms cancel — so the x10 mouth
    weights fold into one weighted basis ``[3N, 64]``.  The frame L1 and
    the temporal-difference L1 are summed over vertex dims, masked by
    ``seq_len`` and averaged over the batch."""

    def __init__(self, ex_base: np.ndarray, mouth_mask: np.ndarray,
                 device="cuda"):
        self.weighted_ex_base = torch.as_tensor(
            np.asarray(ex_base, np.float32)
            * np.asarray(mouth_mask, np.float32).reshape(-1, 1),
            device=device)

    def __call__(self, pred_exp: torch.Tensor, true_coeff: torch.Tensor,
                 seq_len: torch.Tensor) -> torch.Tensor:
        """pred_exp [B,T,64]; true_coeff [B,T,257]; seq_len [B]."""
        b, t, _ = pred_exp.shape
        w = self.weighted_ex_base
        delta = pred_exp - true_coeff[:, :, 80:144]
        frame_l1 = torch.abs(delta.reshape(b * t, -1) @ w.T).sum(-1)
        steps = torch.arange(t, device=pred_exp.device)
        mask = (steps[None, :] < seq_len[:, None]).float()
        loss = torch.mean(torch.sum(frame_l1.reshape(b, t) * mask, dim=-1))
        vid = (delta[:, 1:] - delta[:, :-1]).reshape(b * (t - 1), -1)
        vid_l1 = torch.abs(vid @ w.T).sum(-1).reshape(b, t - 1)
        vid_mask = (steps[None, :-1] < (seq_len - 1)[:, None]).float()
        return loss + torch.mean(torch.sum(vid_l1 * vid_mask, dim=-1))


def make_mouth_mask(num_vertices: int, mouth_idx: Optional[np.ndarray],
                    weight: float = 10.0) -> np.ndarray:
    """ref: bfmnet.py:134-137 — ones with ``weight`` at mouth vertices."""
    mask = np.ones([num_vertices, 3], np.float32)
    if mouth_idx is not None:
        mask[np.asarray(mouth_idx, np.int64)] = weight
    return mask


def total_loss(model: nn.Module, loss_fn: BFMNetLoss, pred_exp, true_coeff,
               seq_len, reg_scale: float = 1e-4) -> torch.Tensor:
    """Sequence loss + the backbone L2 regularizer (ref:
    bfmnet.py:269-270)."""
    return (loss_fn(pred_exp, true_coeff, seq_len)
            + l2_regularization(model, reg_scale))
