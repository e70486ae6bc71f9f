"""BFM asset tooling (port of ``voicepuppet_tpu/tools/bfm_tools.py``).

Host-side utilities around the Basel Face Model assets:

  * :func:`convert_bfm09` — the one-time BFM09 -> ``BFM_model_front.mat``
    converter (ref: utils/bfm_load_data.py:45-114): rescale the shape and
    expression bases to decimeters, truncate to 80/64/80 components, and
    crop to the 35709-vertex front region through the published index
    maps;
  * :func:`load_exp_basis` — the ``Exp_Pca.bin`` reader
    (utils/bfm_load_data.py:25-41);
  * :func:`load_lm3d` / :func:`resolve_lm3d` — the 5-point standard
    alignment landmarks of the R-Net path (utils/bfm_load_data.py:
    118-129);
  * :func:`save_obj` — colored-mesh .obj export (utils/bfm_load_data.py:
    133-144).
"""

from __future__ import annotations

import os
from array import array

import numpy as np

from voicepuppet_torch.pipeline.align import standard_lm3d


def load_exp_basis(model_dir: str):
    """Read Exp_Pca.bin: (expPC [3*n_vertex, K], expEV [K]).

    Layout (utils/bfm_load_data.py:25-41): one little-endian int32 K, then
    3*n_vertex float32 mean values, then K*3*n_vertex float32 principal
    components stored [K, 3*n_vertex] row-major.  The reference hardcodes
    n_vertex=53215; here it is derived from the file size (which equals
    4*(1 + 3*n_vertex*(K+1))) and must divide exactly — a truncated or
    differently-laid-out file fails loudly instead of misparsing."""
    path = os.path.join(model_dir, "Exp_Pca.bin")
    file_words = os.path.getsize(path) // 4
    with open(path, "rb") as f:
        dim = array("i")
        dim.fromfile(f, 1)
        k = dim[0]
        if k <= 0 or (file_words - 1) % (3 * (k + 1)) != 0:
            raise ValueError(
                f"{path}: {file_words * 4} bytes inconsistent with "
                f"exp_dim={k} (expect 4*(1 + 3*n_vertex*(K+1)))")
        n_vertex = (file_words - 1) // (3 * (k + 1))
        mu = array("f")
        mu.fromfile(f, 3 * n_vertex)
        pc = array("f")
        pc.fromfile(f, 3 * k * n_vertex)
    exp_pc = np.asarray(pc).reshape(k, -1).T
    exp_ev = np.loadtxt(os.path.join(model_dir, "std_exp.txt"))
    if np.ndim(exp_ev) == 0:
        exp_ev = exp_ev.reshape(1)
    if exp_ev.shape[0] != k:
        raise ValueError(
            f"std_exp.txt has {exp_ev.shape[0]} eigenvalues, "
            f"Exp_Pca.bin has {k} components")
    return exp_pc, exp_ev


def convert_bfm09(model_dir: str, out_name: str = "BFM_model_front.mat",
                  out_dir: str = None):
    """BFM09 + JuYong expression basis -> the front-cropped working model.

    Requires the external research assets (01_MorphableModel.mat,
    Exp_Pca.bin, BFM_front_idx.mat, BFM_exp_idx.mat, facemodel_info.mat)
    in ``model_dir`` — the reference converter's contract.  The result is
    written to ``out_dir`` (default ``model_dir``, which may be read-only
    when a release is converted in place — see tools/convert_assets.py).
    A 1-based index out of range fails loudly."""
    from scipy.io import loadmat, savemat

    raw = loadmat(os.path.join(model_dir, "01_MorphableModel.mat"))
    id_base = (raw["shapePC"] * raw["shapeEV"].reshape(1, -1))[:, :80] / 1e5
    tex_base = (raw["texPC"] * raw["texEV"].reshape(1, -1))[:, :80]
    exp_pc, exp_ev = load_exp_basis(model_dir)
    ex_base = (exp_pc * exp_ev.reshape(1, -1))[:, :64] / 1e5

    idx_exp = loadmat(os.path.join(model_dir, "BFM_front_idx.mat"))[
        "idx"].astype(np.int64) - 1
    idx_shape = loadmat(os.path.join(model_dir, "BFM_exp_idx.mat"))[
        "trimIndex"].astype(np.int64) - 1
    n_exp = ex_base.shape[0] // 3
    n_shape = id_base.shape[0] // 3
    if idx_exp.min() < 0 or idx_exp.max() >= n_exp:
        raise ValueError(
            f"BFM_front_idx.mat: 1-based idx out of [1, {n_exp}] "
            "(expression-basis vertex count)")
    if idx_shape.min() < 0 or idx_shape.max() >= n_shape \
            or idx_shape.shape[0] != n_exp:
        raise ValueError(
            f"BFM_exp_idx.mat: trimIndex must be [{n_exp}, 1] 1-based "
            f"into [1, {n_shape}] (BFM09 vertex count)")
    idx_shape = idx_shape[idx_exp]

    def crop(base, idx, k):
        return base.reshape(-1, 3, k)[idx.reshape(-1)].reshape(-1, k)

    id_base = crop(id_base, idx_shape, 80)
    tex_base = crop(tex_base, idx_shape, 80)
    ex_base = crop(ex_base, idx_exp, 64)
    meanshape = (raw["shapeMU"].reshape(-1, 3) / 1e5)[
        idx_shape.reshape(-1)].reshape(1, -1)
    meantex = raw["texMU"].reshape(-1, 3)[idx_shape.reshape(-1)].reshape(
        1, -1)

    info = loadmat(os.path.join(model_dir, "facemodel_info.mat"))
    out = {"meanshape": meanshape, "meantex": meantex, "idBase": id_base,
           "exBase": ex_base, "texBase": tex_base, "tri": info["tri"],
           "point_buf": info["point_buf"], "tri_mask2": info["tri_mask2"],
           "keypoints": info["keypoints"],
           "frontmask2_idx": info["frontmask2_idx"],
           "skinmask": info["skinmask"]}
    savemat(os.path.join(out_dir or model_dir, out_name), out)
    return out


def load_lm3d(model_dir: str) -> np.ndarray:
    """``similarity_Lm3D_all.mat`` -> [5, 3] (eyeL, eyeR, nose, mouthL,
    mouthR) (ref: utils/bfm_load_data.py:118-129)."""
    from scipy.io import loadmat
    lm = loadmat(os.path.join(model_dir, "similarity_Lm3D_all.mat"))["lm"]
    return standard_lm3d(lm)


def resolve_lm3d(model_dir: str) -> np.ndarray:
    """The 5-point landmarks of ``model_dir``: its ``lm3d.npy`` (a
    converted release dir) when present, else the raw
    ``similarity_Lm3D_all.mat``."""
    path = os.path.join(model_dir, "lm3d.npy")
    if os.path.exists(path):
        lm = np.load(path)
        if lm.shape != (5, 3):
            raise ValueError(f"{path}: shape {lm.shape}, expected (5, 3)")
        return lm
    return load_lm3d(model_dir)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             colors: np.ndarray):
    """Colored mesh export: 'v x y z r g b' rows + 1-based 'f' rows."""
    with open(path, "w") as f:
        for v, c in zip(vertices, colors):
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f} "
                    f"{c[0]:f} {c[1]:f} {c[2]:f}\n")
        f.write("\n")
        for face in faces:
            f.write(f"f {int(face[0])} {int(face[1])} {int(face[2])}\n")
