"""Host-side image loader (own copy of ``load_image`` from
``voicepuppet_tpu/data/loaders.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_image(path: str, resize: Optional[Tuple[int, int]] = None
               ) -> np.ndarray:
    """RGB float32 in [0,1] (ref: generator/loader.py:76-89)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if resize is not None:
        img = img.resize((resize[0], resize[1]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0
