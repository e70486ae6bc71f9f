"""Basel Face Model asset container.

Mirrors the reference BFM loader (utils/bfm_load_data.py:9-21): the
``BFM_model_front.mat`` asset holds the 35709-vertex front-cropped BFM09 with
80 identity / 64 expression / 80 texture PCA bases, triangle topology,
one-ring adjacency (``point_buf``) and the 68-landmark keypoint indices.

Because the pretrained .mat assets are external (reference README.md:32-35)
and may be absent, :func:`synthetic_bfm` builds a structurally-identical
random model (with a valid closed triangulation over a deformed sphere patch)
so every downstream component — morph math, rasterizer, losses, trainers —
is testable without the proprietary asset.

Own copy of ``voicepuppet_tpu/face3d/bfm.py``.  All fields are numpy on
the host; ``face3d.morph.device_bfm`` uploads them once as tensors.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

NUM_VERTICES = 35709
ID_DIMS, EX_DIMS, TEX_DIMS = 80, 64, 80
COEFF_DIMS = 257  # 80 id + 64 exp + 80 tex + 3 angles + 27 gamma + 3 trans


@dataclass
class BFMModel:
    meanshape: np.ndarray   # [1, 3N]
    idBase: np.ndarray      # [3N, 80]
    exBase: np.ndarray      # [3N, 64]
    meantex: np.ndarray     # [1, 3N]
    texBase: np.ndarray     # [3N, 80]
    point_buf: np.ndarray   # [N, 8] adjacent triangle ids, 1-based
    tri: np.ndarray         # [F, 3] vertex ids, 1-based
    keypoints: np.ndarray   # [68] vertex ids, 0-based

    @property
    def num_vertices(self) -> int:
        return self.meanshape.size // 3

    @property
    def num_triangles(self) -> int:
        return self.tri.shape[0]

    def recenter(self) -> np.ndarray:
        """Mean of meanshape vertices, the recentering constant used by
        Shape_formation (utils/reconstruct_mesh.py:27)."""
        return self.meanshape.reshape(1, -1, 3).mean(axis=1, keepdims=True)


def load_bfm(model_dir: str) -> BFMModel:
    """Load ``BFM_model_front.mat`` (ref: utils/bfm_load_data.py:9-21).

    Fails loudly on a missing field or an internally-inconsistent layout
    (wrong basis row count, out-of-range triangle/adjacency indices)
    rather than letting a misread asset produce silently-wrong renders.
    """
    from scipy.io import loadmat
    path = os.path.join(model_dir, "BFM_model_front.mat")
    model = loadmat(path)
    required = ("meanshape", "idBase", "exBase", "meantex", "texBase",
                "point_buf", "tri", "keypoints")
    missing = [k for k in required if k not in model]
    if missing:
        raise ValueError(f"{path}: missing fields {missing}")
    n3 = model["meanshape"].size
    if n3 % 3:
        raise ValueError(f"{path}: meanshape size {n3} not divisible by 3")
    n = n3 // 3
    for name, cols in (("idBase", ID_DIMS), ("exBase", EX_DIMS),
                       ("texBase", TEX_DIMS)):
        shape = model[name].shape
        if shape != (n3, cols):
            raise ValueError(
                f"{path}: {name} has shape {shape}, expected ({n3}, {cols})")
    if model["meantex"].size != n3:
        raise ValueError(f"{path}: meantex size {model['meantex'].size} "
                         f"!= meanshape size {n3}")
    tri = model["tri"]
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"{path}: tri has shape {tri.shape}")
    if tri.min() < 1 or tri.max() > n:
        raise ValueError(f"{path}: 1-based tri indices out of [1, {n}]")
    pbuf = model["point_buf"]
    if pbuf.shape[0] != n:
        raise ValueError(f"{path}: point_buf rows {pbuf.shape[0]} != {n} "
                         "vertices")
    ntri = tri.shape[0]
    if pbuf.min() < 1 or pbuf.max() > ntri + 1:  # ntri+1 = zero-normal pad
        raise ValueError(
            f"{path}: 1-based point_buf indices out of [1, {ntri + 1}]")
    keypoints = np.squeeze(model["keypoints"]).astype(np.int32) - 1
    if keypoints.min() < 0 or keypoints.max() >= n:
        raise ValueError(f"{path}: keypoint indices out of range")
    return BFMModel(
        meanshape=model["meanshape"].astype(np.float32),
        idBase=model["idBase"].astype(np.float32),
        exBase=model["exBase"].astype(np.float32),
        meantex=model["meantex"].astype(np.float32),
        texBase=model["texBase"].astype(np.float32),
        point_buf=pbuf,
        tri=tri,
        keypoints=keypoints,
    )


def _sphere_patch(n_theta: int, n_phi: int):
    """Regular triangulated patch of a unit sphere cap: returns vertices
    [N, 3] and 0-based triangles [F, 3]."""
    thetas = np.linspace(0.35 * np.pi, 0.65 * np.pi, n_theta)
    phis = np.linspace(-0.3 * np.pi, 0.3 * np.pi, n_phi)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = np.sin(tt) * np.sin(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.cos(pp)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    tris = []
    for i in range(n_theta - 1):
        for j in range(n_phi - 1):
            a = i * n_phi + j
            b = a + 1
            c = a + n_phi
            d = c + 1
            tris.append([a, b, c])
            tris.append([b, d, c])
    return verts.astype(np.float64), np.asarray(tris, dtype=np.int64)


def synthetic_bfm(num_theta: int = 40, num_phi: int = 40,
                  seed: int = 0) -> BFMModel:
    """Random-but-valid BFM stand-in with the reference's dtypes/layout.

    Geometry: a sphere cap scaled to the real model's ~decimeter scale
    (utils/bfm_load_data.py:59 unifies BFM09 to decimeters; meanshape
    vertices are O(0.1)).  PCA bases are small random perturbations so coeff
    O(1) produces plausible deformations.  ``point_buf`` is padded with the
    (ntri+1) sentinel exactly like the real asset (Compute_norm concatenates
    a zero normal at index ntri; utils/reconstruct_mesh.py:47-49).
    """
    rng = np.random.RandomState(seed)
    verts, tris0 = _sphere_patch(num_theta, num_phi)
    n = verts.shape[0]
    f = tris0.shape[0]
    meanshape = (verts * 1.0).reshape(1, -1)

    id_base = rng.randn(3 * n, ID_DIMS) * 2e-3
    ex_base = rng.randn(3 * n, EX_DIMS) * 2e-3
    tex_base = rng.randn(3 * n, TEX_DIMS) * 2.0
    meantex = rng.uniform(80.0, 180.0, size=(1, 3 * n))

    # point_buf: up to 8 adjacent triangles per vertex, 1-based, padded with
    # the sentinel f+1 which maps to the zero normal row.
    point_buf = np.full((n, 8), f + 1, dtype=np.float64)
    counts = np.zeros(n, dtype=np.int64)
    for t in range(f):
        for v in tris0[t]:
            if counts[v] < 8:
                point_buf[v, counts[v]] = t + 1
                counts[v] += 1

    keypoints = rng.choice(n, size=68, replace=n < 68).astype(np.int32)

    return BFMModel(
        meanshape=meanshape.astype(np.float32),
        idBase=id_base.astype(np.float32),
        exBase=ex_base.astype(np.float32),
        meantex=meantex.astype(np.float32),
        texBase=tex_base.astype(np.float32),
        point_buf=point_buf,
        tri=(tris0 + 1).astype(np.float64),
        keypoints=keypoints,
    )


def demo_coeff(model: BFMModel, batch: int = 1, seed: int = 0,
               translation_z: float = 0.0) -> np.ndarray:
    """Random [B, 257] coefficient rows scaled to produce an on-screen face
    when projected with the reference camera (focal 1015, center 112,
    camera z 10; utils/reconstruct_mesh.py:100-103)."""
    rng = np.random.RandomState(seed)
    coeff = np.zeros((batch, COEFF_DIMS), dtype=np.float32)
    coeff[:, :ID_DIMS] = rng.randn(batch, ID_DIMS) * 0.5
    coeff[:, 80:144] = rng.randn(batch, EX_DIMS) * 0.5
    coeff[:, 144:224] = rng.randn(batch, TEX_DIMS) * 0.5
    coeff[:, 224:227] = rng.randn(batch, 3) * 0.05
    coeff[:, 227:254] = rng.randn(batch, 27) * 0.1
    coeff[:, 254:257] = np.array([0.0, 0.0, translation_z], dtype=np.float32)
    return coeff
