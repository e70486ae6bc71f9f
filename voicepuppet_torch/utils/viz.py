"""Evaluation images (port of ``voicepuppet_tpu/utils/viz.py``).

  * The BFMNet eval grid (:func:`plot_bfm_coeff_seq`; ref:
    utils/bfm_visual.py:88-154): rows of rendered faces, the ground-truth
    coefficient sequence on the top rows, the same identity with the
    predicted expressions below, written as one ``bfmnet_<step>.jpg``.
    All faces of a sequence render as one batch through
    ``ops.render_colors_auto``: the flat raster kernel K1 for CUDA
    tensors, its plain version for CPU tensors.
  * The ATVGNet sheets (:func:`plot_lmk_seq`, :func:`plot_image_seq`;
    ref: voicepuppet/atvgnet/plot.py:41-127): landmark strokes drawn with
    PIL, and real / fake / attention image rows.
"""

from __future__ import annotations

import os

from typing import Optional

import numpy as np
import torch

# the 68-landmark strokes (plot.py:9-38): jaw, brows, nose bridge and base,
# eyes, outer and inner lips
LANDMARK_STROKES = (
    list(range(0, 17)),
    list(range(17, 22)),
    list(range(22, 27)),
    list(range(27, 31)),
    list(range(31, 36)),
    list(range(36, 42)) + [36],
    list(range(42, 48)) + [42],
    list(range(48, 60)) + [48],
    list(range(60, 68)) + [60],
)


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


def draw_landmarks(canvas: np.ndarray, lmk: np.ndarray,
                   color=(0, 255, 0)) -> np.ndarray:
    """68 landmarks drawn as strokes on an image with PIL (ref:
    plot.py:41-81, cv2 there)."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(canvas if canvas.dtype == np.uint8 else
                          np.clip(canvas * 255, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    pts = lmk.reshape(-1, 2)
    for stroke in LANDMARK_STROKES:
        draw.line([(float(pts[i, 0]), float(pts[i, 1])) for i in stroke],
                  fill=tuple(color), width=1)
    return np.asarray(img)


def plot_lmk_seq(out_dir: str, step: int, mean: np.ndarray,
                 component: np.ndarray, seq_len: np.ndarray,
                 real_lmk_seq: np.ndarray, pred_lmk_seq: np.ndarray,
                 img_size: int = 224, cols: int = 10,
                 max_frames: int = 30) -> str:
    """The ATNet eval sheet ``atnet_<step>.jpg`` (ref: plot.py:41-81):
    the real (green) and predicted (red) landmark strokes of the first
    sequence on white cells, taken back from [-1, 1] to pixels."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    t = min(int(seq_len[0]), max_frames, real_lmk_seq.shape[1])
    denorm = lambda lmk: (lmk / 2.0 + 0.5) * img_size
    size = img_size
    rows = 2 * (-(-t // cols))
    grid = np.full((rows * size, cols * size, 3), 255, np.uint8)
    for i in range(t):
        r, c = divmod(i, cols)
        for row, seq, color in ((r, real_lmk_seq, (0, 200, 0)),
                                (r + rows // 2, pred_lmk_seq, (220, 0, 0))):
            cell = np.full((size, size, 3), 255, np.uint8)
            grid[row * size:(row + 1) * size, c * size:(c + 1) * size] = \
                draw_landmarks(cell, denorm(seq[0, i]).reshape(-1, 2),
                               color)
    path = os.path.join(out_dir, f"atnet_{step}.jpg")
    Image.fromarray(grid).save(path)
    return path


def plot_image_seq(out_dir: str, step: int, real_img_seq: np.ndarray,
                   fake_img_seq: np.ndarray,
                   attention: Optional[np.ndarray] = None,
                   cols: int = 10, max_frames: int = 10) -> str:
    """The VGNet eval sheet ``vgnet_<step>.jpg`` (ref: plot.py:84-127):
    a real row, a fake row and, when given, an attention row."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    t = min(real_img_seq.shape[1], fake_img_seq.shape[1], max_frames, cols)
    s = real_img_seq.shape[2]

    def to_u8(x):
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = np.clip(x * 255.0 if x.max() <= 1.5 else x, 0,
                        255).astype(np.uint8)
        return x

    rows = 3 if attention is not None else 2
    grid = np.zeros((rows * s, t * s, 3), np.uint8)
    for i in range(t):
        grid[:s, i * s:(i + 1) * s] = to_u8(real_img_seq[0, i])
        grid[s:2 * s, i * s:(i + 1) * s] = to_u8(fake_img_seq[0, i])
        if attention is not None:
            grid[2 * s:3 * s, i * s:(i + 1) * s] = to_u8(
                np.repeat(attention[0, i], 3, axis=-1))
    path = os.path.join(out_dir, f"vgnet_{step}.jpg")
    Image.fromarray(grid).save(path)
    return path
