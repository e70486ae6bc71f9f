"""The PixRefer training set of a run, from its seed: ``clips`` clips of
``frames`` 3-panel JPEGs ([s, 3s]: target | render | alpha) and the
reference's "folder|frame_count" list file, written under ``root``."""

from __future__ import annotations

import os

import numpy as np

from benchmark.traffic.scene import face_mask, smooth_image


def write_panel_dataset(root: str, seed: int, clips: int, frames: int,
                        s: int, quality: int = 90) -> str:
    from PIL import Image
    alpha = (face_mask(s, s) * 255).astype(np.uint8)
    lines = []
    for k in range(clips):
        d = os.path.join(root, f"panels{k}")
        os.makedirs(d)
        rng = np.random.default_rng([seed, 20, k])
        for i in range(frames):
            img = np.concatenate([
                (smooth_image(rng, s, s) * 255).astype(np.uint8),
                (smooth_image(rng, s, s) * 255).astype(np.uint8), alpha], 1)
            Image.fromarray(img).save(os.path.join(d, f"{i}.jpg"),
                                      quality=quality)
        lines.append(f"{d}|{frames}")
    path = os.path.join(root, "panel_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
