"""The BFMNet eval grid (port of ``render_coeff_grid`` and
``plot_bfm_coeff_seq`` of ``voicepuppet_tpu/utils/viz.py``:38-80; ref:
utils/bfm_visual.py:88-154).

Rows of rendered faces: the ground-truth coefficient sequence on the top
rows, the same identity with the predicted expressions below, written as
one ``bfmnet_<step>.jpg``.  All faces of a sequence render as one batch
through ``ops.render_colors_auto``: the flat raster kernel K1 for CUDA
tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

import os

import numpy as np
import torch


@torch.no_grad()
def render_coeff_grid(coeff_seq, face_model, cols: int = 10,
                      size: int = 224, device="cuda") -> np.ndarray:
    """[T, 257] coefficients -> a grid image [rows*size, cols*size, 3]
    uint8.  ``face_model`` is a ``BFMModel`` (moved to ``device``) or a
    ``morph.DeviceBFM``, whose device then runs the decode and raster."""
    from voicepuppet_torch.face3d import morph
    from voicepuppet_torch.ops import render_colors_auto

    fm = (face_model if isinstance(face_model, morph.DeviceBFM)
          else morph.device_bfm(face_model, device))
    coeff = torch.as_tensor(np.asarray(coeff_seq, np.float32),
                            device=fm.tri.device)
    t = coeff.shape[0]
    rec = morph.reconstruct(coeff, fm, image_size=float(size))
    verts = torch.cat([rec.face_projection, rec.z_buffer], -1).contiguous()
    colors = torch.floor(torch.clamp(rec.face_color, 0.0,
                                     255.0)).contiguous()
    imgs, _ = render_colors_auto(verts, colors, fm.tri, h=size, w=size)
    imgs = imgs.cpu().numpy()
    rows = -(-t // cols)
    grid = np.zeros((rows * size, cols * size, 3), np.uint8)
    for i in range(t):
        r, c = divmod(i, cols)
        grid[r * size:(r + 1) * size, c * size:(c + 1) * size] = imgs[i]
    return grid


def coeff_grid(real_coeff, pred_exp, face_model, cols: int = 10,
               size: int = 224, max_frames: int = 30,
               device="cuda") -> np.ndarray:
    """The eval sheet as an array: the ground truth's grid over the grid
    of the same coefficients with the predicted expressions spliced into
    dims [80, 144) — two renders of ``min(T, max_frames)`` faces."""
    t = min(real_coeff.shape[0], pred_exp.shape[0], max_frames)
    real = np.asarray(real_coeff[:t], np.float32)
    pred = real.copy()
    pred[:, 80:144] = np.asarray(pred_exp[:t], np.float32)
    return np.concatenate(
        [render_coeff_grid(real, face_model, cols, size, device),
         render_coeff_grid(pred, face_model, cols, size, device)], axis=0)


def plot_bfm_coeff_seq(out_dir: str, step: int, real_coeff, pred_exp,
                       face_model, cols: int = 10, size: int = 224,
                       max_frames: int = 30, device="cuda") -> str:
    """Write :func:`coeff_grid` as ``<out_dir>/bfmnet_<step>.jpg`` and
    return its path."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"bfmnet_{step}.jpg")
    Image.fromarray(coeff_grid(real_coeff, pred_exp, face_model, cols, size,
                               max_frames, device)).save(path)
    return path
