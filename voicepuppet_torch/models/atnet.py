"""ATNet — audio to 68-point facial landmarks, the legacy ATVGNet
subsystem (port of ``voicepuppet_tpu/models/atnet.py``; ref:
voicepuppet/atvgnet/atnet.py).

  * mfcc encoder (atnet.py:17-35, 214-222): the elu / MobileNetV2-width
    ``MfccNet``, a [5,3] max pool to one vector per video frame, then
    dense + BN + elu (``mfcc_proj``);
  * landmark encoder (atnet.py:61-82, 210): the example landmark
    projected on the PCA basis, tiled over time, dense + BN + elu;
  * pose encoder (atnet.py:38-58): dense + BN + elu over [B,T,3] poses;
  * the three embeddings summed into a GRU(128) (``rnn_module``,
    atnet.py:232-235) with the config's dropout in training;
  * landmark decoder (atnet.py:113-143): dense 64 + BN + elu -> a tanh
    PCA code x0.9 -> with the ears, tanh eye offsets x0.1 -> ``code @
    component`` plus the eye offsets padded into landmark dims [72, 96).

The PCA ``component`` [K, 136] is an input (the reference loads a
``components_file`` its config never defines):
:func:`synthetic_pca_component` stands in for it.  Training mode is the
``train`` argument: TFBatchNorm then uses batch moments and moves its
running moments, and the GRU drops out from the caller's generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voicepuppet_torch.models.layers import (MOBILENET_WIDTHS, MaskedGRU,
                                             MfccNet, TFBatchNorm,
                                             max_pool_same)


class DenseBNElu(nn.Module):
    """Dense, then TFBatchNorm over the last axis, then elu."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, features)
        self.TFBatchNorm_0 = TFBatchNorm(features)

    def forward(self, x, train: bool = False):
        y = self.Dense_0(x)
        shape = y.shape
        y = self.TFBatchNorm_0(y.reshape(-1, shape[-1]), train)
        return F.elu(y.reshape(shape))


class ATNet(nn.Module):
    """ears [B,T,1], poses [B,T,3], mfccs [B,T*5,80], example_landmark
    [B,136], seq_len [B] -> landmarks [B,T,136]."""

    def __init__(self, cfg, component: np.ndarray, width_mult: float = 1.0):
        super().__init__()
        self.cfg = cfg
        comp = torch.as_tensor(np.asarray(component, np.float32))
        self.register_buffer("component", comp, persistent=False)
        k = comp.shape[0]
        emb = cfg.encode_embedding_size
        self.mfcc_net = MfccNet(cfg.thinresnet_output_channels, width_mult,
                                MOBILENET_WIDTHS, activation=F.elu)
        self.mfcc_proj = DenseBNElu(cfg.thinresnet_output_channels, emb)
        self.landmark_encoder = DenseBNElu(k, emb)
        self.pose_encoder = DenseBNElu(3, emb)
        self.rnn_module = MaskedGRU(emb, cfg.rnn_hidden_size, 1,
                                    cfg.training.drop_rate)
        self.dec_dense = DenseBNElu(cfg.rnn_hidden_size, 64)
        self.dec_code = nn.Linear(64, k)
        self.dec_eye = nn.Linear(k + 1, 24)

    def forward(self, ears, poses, mfccs, example_landmark, seq_len,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        c = self.cfg
        b, t = poses.shape[:2]
        comp = self.component
        x = self.mfcc_net(mfccs[:, None], train=train)   # [B, C, T*5, F]
        x = max_pool_same(x, (5, 3), (5, 3))
        x = x.permute(0, 2, 3, 1).reshape(b, -1,
                                          c.thinresnet_output_channels)
        mfcc_f = self.mfcc_proj(x, train)
        code = example_landmark @ comp.T                  # [B, K]
        lmk_f = self.landmark_encoder(
            code[:, None, :].expand(-1, t, -1), train)
        pose_f = self.pose_encoder(poses, train)
        h = self.rnn_module(mfcc_f + lmk_f + pose_f, seq_len, train=train,
                            generator=generator)
        d = self.dec_dense(h, train)
        code = torch.tanh(self.dec_code(d)) * 0.9
        eye = torch.tanh(self.dec_eye(torch.cat([code, ears], -1))) * 0.1
        eye = F.pad(eye, (72, c.landmark_size - 72 - 24))
        return code @ comp + eye


def atnet_loss(pred, landmarks, seq_len):
    """Masked per-frame squared error plus the temporal-difference term
    (ref: atnet.py:248-262)."""
    b, t, _ = pred.shape
    steps = torch.arange(t, device=pred.device)
    mask = (steps[None, :] < seq_len[:, None]).float()
    frame = torch.sum(torch.square(landmarks - pred), dim=-1)
    loss = torch.mean(torch.sum(frame * mask, dim=-1))
    vmask = (steps[None, :-1] < (seq_len - 1)[:, None]).float()
    vid = ((pred[:, 1:] - pred[:, :-1])
           - (landmarks[:, 1:] - landmarks[:, :-1]))
    return loss + torch.mean(torch.sum(
        torch.sum(torch.square(vid), -1) * vmask, -1))


def synthetic_pca_component(k: int = 6, landmark_size: int = 136,
                            seed: int = 0) -> np.ndarray:
    """A random orthonormal [K, 136] basis standing in for the reference's
    absent ``components_file`` (the same numbers as the JAX package's)."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(landmark_size, k))
    return q.T.astype(np.float32)
