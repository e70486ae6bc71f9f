"""Host-side file loaders: own copies of ``voicepuppet_tpu/data/loaders.py``
(:20-62).  Comma-separated text arrays, npy/npz blobs, landmark rows and
images as RGB float32 in [0, 1] (the reference reads BGR with cv2 and
converts at use sites; here images are RGB from the start)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_text_array(path: str) -> np.ndarray:
    """Comma-separated floats per line -> [rows, cols] float32
    (ref: generator/loader.py:17-30)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if parts and parts[0]:
                rows.append(np.asarray([np.float32(x) for x in parts]))
    return np.asarray(rows)


def load_bin_array(path: str) -> np.ndarray:
    """npy/npz blob (ref: generator/loader.py:35-41)."""
    if path.endswith(".npy") or path.endswith(".npz"):
        return np.load(path)
    raise ValueError(f"unsupported binary format: {path}")


def load_landmarks(path: str, norm_size: float = 128.0) -> np.ndarray:
    """Landmark rows divided by ``norm_size``
    (ref: generator/loader.py:58-66)."""
    return load_text_array(path).astype(np.float32) / norm_size


def load_image(path: str, resize: Optional[Tuple[int, int]] = None
               ) -> np.ndarray:
    """RGB float32 in [0,1] (ref: generator/loader.py:76-89)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if resize is not None:
        img = img.resize((resize[0], resize[1]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def save_image(path: str, img: np.ndarray):
    """uint8 as is; floats in [0, 1] (or 0..255 when their max is above
    1.5) clipped to uint8."""
    from PIL import Image
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.5 else arr,
                      0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
