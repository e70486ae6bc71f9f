"""Face landmark providers and the SAT crop geometry.

Port of ``voicepuppet_tpu/pipeline/detect.py``.  The reference's
``get_mxnet_sat_alignment`` (utils/utils.py:36-147) chains a dlib detector
and the mxnet SAT heatmap model around crop-expansion math; here the
detector is a pluggable provider and the geometry is reproduced exactly:

  * :class:`FileLandmarkProvider` — successive rows of a ``landmark.txt``
  * :class:`CallableLandmarkProvider` — any detector callable
  * :class:`TorchScriptLandmarkProvider` — a detector exported as
    TorchScript, run on the port's device
  * :class:`CenteredFaceProvider` — deterministic synthetic landmarks
  * :func:`sat_alignment` — the crop/expand/centre math around a provider
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol

import numpy as np
import torch
import torch.nn.functional as F


class LandmarkProvider(Protocol):
    def __call__(self, image: np.ndarray) -> Optional[np.ndarray]:
        """RGB image -> 68x2 landmarks in image pixel coords, or None."""


@dataclasses.dataclass
class FileLandmarkProvider:
    """Serves successive rows of a landmark.txt file (flattened 136-dim
    rows; generator/loader.py:58-66)."""
    rows: np.ndarray
    index: int = 0

    @classmethod
    def from_file(cls, path: str, norm_size: float = 1.0):
        from voicepuppet_torch.data.loaders import load_landmarks
        return cls(rows=load_landmarks(path, norm_size))

    def __call__(self, image: np.ndarray) -> Optional[np.ndarray]:
        if self.index >= self.rows.shape[0]:
            return None
        lmk = self.rows[self.index].reshape(68, 2)
        self.index += 1
        return lmk


@dataclasses.dataclass
class CallableLandmarkProvider:
    fn: Callable[[np.ndarray], Optional[np.ndarray]]

    def __call__(self, image: np.ndarray) -> Optional[np.ndarray]:
        return self.fn(image)


class TorchScriptLandmarkProvider:
    """A landmark detector exported as TorchScript (architecture and
    weights in one file), run on ``device``.  Contract: a float32 RGB
    [1, 3, H, W] tensor in [0, 1] -> [1, 68, 2] pixel coordinates or a
    [1, 68, h, w] heatmap stack; heatmaps are resized to 128² before the
    argmax, as the reference's SAT decode does (utils/utils.py:109-140),
    and scaled back to image pixels."""

    def __init__(self, model_path: str, device="cuda"):
        self.device = torch.device(device)
        self._model = torch.jit.load(model_path, map_location=self.device)
        self._model.eval()

    def __call__(self, image: np.ndarray) -> Optional[np.ndarray]:
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape[:2]
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(
                img.transpose(2, 0, 1)[None])).to(self.device)
            out = self._model(t)
            if isinstance(out, (tuple, list)):
                out = out[-1]
            if out.ndim == 4 and out.shape[1] == 68 and tuple(
                    out.shape[2:]) != (128, 128):
                out = F.interpolate(out, size=(128, 128), mode="bilinear",
                                    align_corners=False)
        out = out.cpu().numpy()
        if out.ndim == 3 and out.shape[1:] == (68, 2):
            return out[0].astype(np.float32)
        if out.ndim == 4 and out.shape[1] == 68:
            hm = out[0]
            hh, hw = hm.shape[1:]
            flat = hm.reshape(68, -1).argmax(axis=1)
            ys, xs = np.divmod(flat, hw)
            return np.stack([xs * (w / hw), ys * (h / hh)],
                            axis=1).astype(np.float32)
        raise ValueError(
            f"landmark torchscript returned shape {out.shape}; expected "
            "[1,68,2] coords or [1,68,h,w] heatmaps")


class CenteredFaceProvider:
    """Synthetic landmark layout centred in the frame (a stand-in for the
    detector so demos run without external assets)."""

    def __call__(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        cx, cy = w / 2.0, h / 2.0
        s = min(h, w) * 0.25
        t = np.linspace(0, np.pi, 17)
        jaw = np.stack([cx + s * np.cos(np.pi - t),
                        cy + s * 0.2 + s * np.sin(t) * 0.9], 1)
        brow_r = np.stack([cx - s * 0.7 + np.linspace(0, s * 0.5, 5),
                           np.full(5, cy - s * 0.5)], 1)
        brow_l = np.stack([cx + s * 0.2 + np.linspace(0, s * 0.5, 5),
                           np.full(5, cy - s * 0.5)], 1)
        nose = np.stack([np.full(4, cx),
                         cy - s * 0.3 + np.linspace(0, s * 0.5, 4)], 1)
        nose_base = np.stack([cx + np.linspace(-s * .15, s * .15, 5),
                              np.full(5, cy + s * 0.25)], 1)
        ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        eye_r = np.stack([cx - s * 0.45 + 0.15 * s * np.cos(ang),
                          cy - s * 0.25 + 0.08 * s * np.sin(ang)], 1)
        eye_l = np.stack([cx + s * 0.45 + 0.15 * s * np.cos(ang),
                          cy - s * 0.25 + 0.08 * s * np.sin(ang)], 1)
        ang2 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        lip_o = np.stack([cx + 0.3 * s * np.cos(ang2),
                          cy + s * 0.55 + 0.15 * s * np.sin(ang2)], 1)
        ang3 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        lip_i = np.stack([cx + 0.18 * s * np.cos(ang3),
                          cy + s * 0.55 + 0.08 * s * np.sin(ang3)], 1)
        return np.concatenate([jaw, brow_r, brow_l, nose, nose_base,
                               eye_r, eye_l, lip_o, lip_i]).astype(
                                   np.float32)


def _expand_box(x0, y0, x1, y1, factor, w, h):
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    half = max(x1 - x0, y1 - y0) * factor / 2.0
    return (max(int(cx - half), 0), max(int(cy - half), 0),
            min(int(cx + half), w), min(int(cy + half), h))


def sat_alignment(image: np.ndarray, provider: LandmarkProvider,
                  out_size: int = 224, box_expand: float = 1.5,
                  crop_expand: float = 1.3):
    """The get_mxnet_sat_alignment contract (utils/utils.py:36-147):
    (image, img_landmarks [68,2], img_cropped [224,224,3], lmk_cropped
    [136], center_x, center_y, ratio), or None when no face is found.
    ``ratio`` maps the 224² analysis frame back to source pixels."""
    from PIL import Image
    h, w = image.shape[:2]
    lmk = provider(image)
    if lmk is None:
        return None
    lmk = np.asarray(lmk, np.float64)
    # the landmark bbox expanded like the detector box, then the analysis
    # crop expands that box again
    x0, y0 = lmk.min(0)
    x1, y1 = lmk.max(0)
    x0, y0, x1, y1 = _expand_box(x0, y0, x1, y1, box_expand, w, h)
    bx0, by0, bx1, by1 = _expand_box(x0, y0, x1, y1, crop_expand, w, h)
    # degenerate boxes (coincident landmarks, truncation collapse)
    bx1 = min(max(bx1, bx0 + 1), w) if bx1 > bx0 else min(bx0 + 1, w)
    by1 = min(max(by1, by0 + 1), h) if by1 > by0 else min(by0 + 1, h)
    bx0 = min(bx0, bx1 - 1)
    by0 = min(by0, by1 - 1)
    center_x = (bx0 + bx1) // 2
    center_y = (by0 + by1) // 2
    ratio = out_size / float(bx1 - bx0)
    img_u8 = (np.clip(image * 255.0, 0, 255).astype(np.uint8)
              if image.dtype != np.uint8 else image)
    pil = Image.fromarray(img_u8).crop((bx0, by0, bx1, by1)).resize(
        (out_size, out_size), Image.BILINEAR)
    img_cropped = np.asarray(pil)
    lmk_cropped = ((lmk - np.array([bx0, by0])) *
                   np.array([out_size / (bx1 - bx0),
                             out_size / (by1 - by0)]))
    return (image, lmk.astype(np.float32), img_cropped,
            lmk_cropped.reshape(-1).astype(np.float32),
            int(center_x), int(center_y), float(ratio))
