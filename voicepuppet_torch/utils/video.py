"""Video writing (port of ``voicepuppet_tpu/utils/video.py``; ref:
voicepuppet/atvgnet/plot.py:130-173): ffmpeg encodes and muxes."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np


def _write_pngs(frames: np.ndarray, frame_dir: str):
    from PIL import Image
    os.makedirs(frame_dir, exist_ok=True)
    for i in range(frames.shape[0]):
        Image.fromarray(np.asarray(frames[i], np.uint8)).save(
            os.path.join(frame_dir, f"{i}.png"))


def save_image_seq_video(frames: np.ndarray, out_path: str,
                         frame_rate: int = 25,
                         audio_path: Optional[str] = None) -> bool:
    """[T, H, W, 3] uint8 -> H.264 mp4 (+ an optional audio track); True
    when the mp4 exists.  Without ffmpeg on PATH the frames go to a PNG
    sequence in ``<out_path minus extension>_frames/`` and False is
    returned."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        _write_pngs(frames, os.path.splitext(out_path)[0] + "_frames")
        return False
    with tempfile.TemporaryDirectory() as td:
        _write_pngs(frames, td)
        cmd = [ffmpeg, "-v", "error", "-framerate", str(frame_rate),
               "-i", os.path.join(td, "%d.png")]
        if audio_path:
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", "-y", out_path]
        subprocess.run(cmd, check=False)
    return os.path.exists(out_path)
