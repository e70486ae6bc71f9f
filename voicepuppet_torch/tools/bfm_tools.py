"""The 5-point standard landmarks of the R-Net alignment.

Own copies of ``load_lm3d`` and ``resolve_lm3d`` from
``voicepuppet_tpu/tools/bfm_tools.py`` (:118-140); the BFM09 conversion
and mesh export there are preparation tools, not yet ported.
"""

from __future__ import annotations

import os

import numpy as np

from voicepuppet_torch.pipeline.align import standard_lm3d


def load_lm3d(model_dir: str) -> np.ndarray:
    """``similarity_Lm3D_all.mat`` -> [5, 3] (eyeL, eyeR, nose, mouthL,
    mouthR) (ref: utils/bfm_load_data.py:118-129)."""
    from scipy.io import loadmat
    lm = loadmat(os.path.join(model_dir, "similarity_Lm3D_all.mat"))["lm"]
    return standard_lm3d(lm)


def resolve_lm3d(model_dir: str) -> np.ndarray:
    """The 5-point landmarks of ``model_dir``: its ``lm3d.npy`` (a
    converted release dir) when present, else the raw
    ``similarity_Lm3D_all.mat``."""
    path = os.path.join(model_dir, "lm3d.npy")
    if os.path.exists(path):
        lm = np.load(path)
        if lm.shape != (5, 3):
            raise ValueError(f"{path}: shape {lm.shape}, expected (5, 3)")
        return lm
    return load_lm3d(model_dir)
