"""Face alignment math (host side) and the head-sway pose sequence.

Own copies of ``voicepuppet_tpu/pipeline/align.py``: the POS
least-squares similarity between 5 image landmarks and the standard 3D
landmarks, the 68 -> 5 landmark reduction and the affine crop to the 224²
frame the R-Net reads (ref: utils/bfm_load_data.py:118-212,
infer_bfmvid.py:55-68), and the idle head sway (infer_bfmvid.py:76-89).
"""

from __future__ import annotations

import numpy as np


def pos_similarity(xp: np.ndarray, x: np.ndarray):
    """Least-squares 2D similarity transform from 3D standard landmarks to
    image landmarks (ref: utils/bfm_load_data.py:148-170).

    xp: [2, N] image points; x: [3, N] standard points.
    Returns (t [2,1], s scalar)."""
    npts = xp.shape[1]
    a = np.zeros([2 * npts, 8])
    a[0:2 * npts - 1:2, 0:3] = x.T
    a[0:2 * npts - 1:2, 3] = 1
    a[1:2 * npts:2, 4:7] = x.T
    a[1:2 * npts:2, 7] = 1
    b = xp.T.reshape(2 * npts, 1)
    k, _, _, _ = np.linalg.lstsq(a, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, float(s)


def landmarks68_to_5(ps: np.ndarray) -> np.ndarray:
    """Flattened 68-point landmarks [136] -> the 5-point set (eye centres,
    nose tip, mouth corners; ref: infer_bfmvid.py:55-68)."""
    ps = np.asarray(ps, np.float64)
    lx = np.mean([ps[72], ps[74], ps[76], ps[78], ps[80], ps[82]])
    ly = np.mean([ps[73], ps[75], ps[77], ps[79], ps[81], ps[83]])
    rx = np.mean([ps[84], ps[86], ps[88], ps[90], ps[92], ps[94]])
    ry = np.mean([ps[85], ps[87], ps[89], ps[91], ps[93], ps[95]])
    return np.round(np.array([
        [lx, ly], [rx, ry], [ps[60], ps[61]], [ps[96], ps[97]],
        [ps[108], ps[109]]])).astype(np.int64)


def standard_lm3d(lm3d_all: np.ndarray) -> np.ndarray:
    """[68, 3] standard landmarks -> 5 points in the order (eyeL, eyeR,
    nose, mouthL, mouthR) (ref: utils/bfm_load_data.py:118-129)."""
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    pts = np.stack([lm3d_all[idx[0]],
                    np.mean(lm3d_all[idx[[1, 2]]], 0),
                    np.mean(lm3d_all[idx[[3, 4]]], 0),
                    lm3d_all[idx[5]], lm3d_all[idx[6]]], axis=0)
    return pts[[1, 2, 0, 3, 4], :]


def align_for_identity(img: np.ndarray, lmk5: np.ndarray,
                       lm3d: np.ndarray):
    """An RGB [H,W,3] image (uint8, or float in [0, 1] or 0..255) -> the
    224² identity-regression crop (ref: utils/bfm_load_data.py:173-212).

    Returns (aligned [1,224,224,3] float32 BGR 0..255, trans_params
    [w0, h0, 102/s, t0, t1])."""
    from PIL import Image
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 if img.max() <= 1.5 else img, 0,
                      255).astype(np.uint8)
    pil = Image.fromarray(img)
    w0, h0 = pil.size
    lm = np.stack([lmk5[:, 0], h0 - 1 - lmk5[:, 1]], axis=1).astype(
        np.float64)
    t, s = pos_similarity(lm.T, lm3d.T)
    t0, t1 = float(t[0, 0]), float(t[1, 0])
    pil = pil.transform(pil.size, Image.AFFINE,
                        (1, 0, t0 - w0 / 2, 0, 1, h0 / 2 - t1))
    w = int(w0 / s * 102)
    h = int(h0 / s * 102)
    pil = pil.resize((w, h), resample=Image.BILINEAR)
    left = int(w / 2 - 112)
    up = int(h / 2 - 112)
    pil = pil.crop((left, up, left + 224, up + 224))
    # the pretrained R-Net reads BGR crops (bfm_load_data.py:189)
    aligned = np.asarray(pil)[None, ..., ::-1].astype(np.float32)
    trans_params = np.array([w0, h0, 102.0 / s,
                             t0 - w0 / 2, h0 / 2 - t1])
    return aligned, trans_params


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
