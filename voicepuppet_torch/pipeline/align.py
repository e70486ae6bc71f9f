"""Head-sway pose sequence for the serving path.

Own copy of ``head_sway_angles`` from ``voicepuppet_tpu/pipeline/align.py``
(:103-125); the R-Net alignment math there belongs to the identity path,
which is not ported yet.
"""

from __future__ import annotations

import numpy as np


def head_sway_angles(num_frames: int, shift: float = 0.005,
                     bound: float = 0.03, state=None):
    """The idle head-sway pose sequence: all three euler angles advance by
    ``shift`` per frame, direction flipping when the yaw passes ±bound
    (ref: infer_bfmvid.py:76-89).  Returns [T, 3] float32 — or
    ``(angles, new_state)`` when ``state`` = (angles [3] float64, step) is
    given, so chunked callers continue the walk exactly."""
    out = np.zeros((num_frames, 3), np.float32)
    if state is None:
        angles, step = np.zeros(3, np.float64), shift
    else:
        angles, step = np.array(state[0], np.float64), state[1]
    for i in range(num_frames):
        angles += step
        if angles[1] > bound or angles[1] < -bound:
            step = -step
        out[i] = angles
    if state is not None:
        return out, (angles, step)
    return out
