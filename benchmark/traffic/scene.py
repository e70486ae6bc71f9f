"""The face scene of a serving run, from its seed: the synthetic face
model (a triangulated sphere patch of ``grid``² vertices at the real
BFM's scale, random PCA bases), the identity's coefficient row and crop
geometry, the 3-panel face image and the background."""

from __future__ import annotations

import numpy as np


def face_model_arrays(grid: int, seed: int) -> dict:
    """The BFM file's arrays: meanshape [1,3N], idBase [3N,80], exBase
    [3N,64], meantex [1,3N], texBase [3N,80], tri [F,3] and point_buf
    [N,8] 1-based (point_buf padded with F+1), keypoints [68]."""
    rng = np.random.default_rng([seed, 10])
    th = np.linspace(0.35 * np.pi, 0.65 * np.pi, grid)
    ph = np.linspace(-0.3 * np.pi, 0.3 * np.pi, grid)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(tt) * np.sin(pp), np.cos(tt),
                      np.sin(tt) * np.cos(pp)], -1).reshape(-1, 3)
    n = verts.shape[0]
    a = (np.arange(grid - 1)[:, None] * grid + np.arange(grid - 1)[None])
    a = a.reshape(-1)
    b, c = a + 1, a + grid
    tri = np.stack([np.stack([a, b, c], 1), np.stack([b, c + 1, c], 1)],
                   1).reshape(-1, 3)
    f = tri.shape[0]
    # each vertex's first 8 adjacent triangles in id order, then F+1
    tid = np.repeat(np.arange(f), 3)
    order = np.argsort(tri.reshape(-1), kind="stable")
    vid, tid = tri.reshape(-1)[order], tid[order]
    first = np.searchsorted(vid, np.arange(n))
    slot = np.arange(vid.shape[0]) - first[vid]
    keep = slot < 8
    point_buf = np.full((n, 8), f + 1, np.float64)
    point_buf[vid[keep], slot[keep]] = tid[keep] + 1
    f32 = np.float32
    return dict(
        meanshape=verts.reshape(1, -1).astype(f32),
        idBase=(rng.standard_normal((3 * n, 80), f32) * f32(2e-3)),
        exBase=(rng.standard_normal((3 * n, 64), f32) * f32(2e-3)),
        texBase=(rng.standard_normal((3 * n, 80), f32) * f32(2.0)),
        meantex=rng.uniform(80.0, 180.0, (1, 3 * n)).astype(f32),
        point_buf=point_buf, tri=(tri + 1).astype(np.float64),
        keypoints=rng.choice(n, 68, replace=False).astype(np.int32))


def identity(seed: int, img_size: int) -> dict:
    """The identity's [1,257] coefficients (expression left zero; the
    served clip supplies it) and a centred crop at unit ratio."""
    rng = np.random.default_rng([seed, 11])
    coeff = np.zeros((1, 257), np.float32)
    coeff[:, :80] = rng.standard_normal((1, 80)) * 0.5
    coeff[:, 144:224] = rng.standard_normal((1, 80)) * 0.5
    coeff[:, 224:227] = rng.standard_normal((1, 3)) * 0.05
    coeff[:, 227:254] = rng.standard_normal((1, 27)) * 0.1
    return dict(bfmcoeff=coeff,
                transform_params=np.array([img_size, img_size, 1.0, 0.0,
                                           0.0]),
                center_x=img_size // 2, center_y=img_size // 2, ratio=1.0)


def smooth_image(rng: np.random.Generator, h: int, w: int,
                 cells: int = 16) -> np.ndarray:
    """[h, w, 3] float32 in [0, 1]: a coarse random field upsampled
    bilinearly, plus fine grain."""
    gh, gw = cells, max(1, cells * w // h)
    grid = rng.random((gh + 1, gw + 1, 3), np.float32)
    ys = np.linspace(0, gh, h, dtype=np.float32)
    xs = np.linspace(0, gw, w, dtype=np.float32)
    y0 = np.minimum(ys.astype(int), gh - 1)
    x0 = np.minimum(xs.astype(int), gw - 1)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    img = top * (1 - fy) + bot * fy
    img += rng.normal(0.0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def face_mask(h: int, w: int) -> np.ndarray:
    """[h, w, 3] float32: 1 inside a centred ellipse, 0 outside."""
    y, x = np.mgrid[0:h, 0:w]
    inside = (((y - h / 2) / (0.42 * h)) ** 2
              + ((x - w / 2) / (0.32 * w)) ** 2) <= 1.0
    return np.repeat(inside[..., None], 3, -1).astype(np.float32)


def panel(seed: int, s: int) -> np.ndarray:
    """[s, 3s, 3] float32: image | render | alpha."""
    rng = np.random.default_rng([seed, 12])
    return np.concatenate([smooth_image(rng, s, s), smooth_image(rng, s, s),
                           face_mask(s, s)], axis=1)


def background(seed: int, s: int) -> np.ndarray:
    return smooth_image(np.random.default_rng([seed, 13]), s, s)
