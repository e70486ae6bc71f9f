"""3DMM forward math, batched over frames.

Port of ``voicepuppet_tpu/face3d/morph.py``: ``split_coeff`` -> shape /
texture PCA decode -> one-ring vertex normals through ``point_buf`` ->
rotation -> perspective projection -> 9-term SH lighting.  Matmuls run in
full float32 (TF32 off), matching ``Precision.HIGHEST``.

The normals take one of two forms of the same function: the gather path
(:func:`compute_norm`, the triangle corners gathered from the decoded
shape) or, with ``device_bfm(corner_cache=True)``, the corner cache
(:func:`compute_norm_from_coeff`, the PCA rows pre-gathered per corner so
the corners come out of two matmuls).  The cache costs
``F * 9 * 145 * 4`` bytes (366 MB at BFM scale), so it is opt-in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from voicepuppet_torch.audio.frontend import full_fp32_matmuls
from voicepuppet_torch.face3d.bfm import BFMModel


class DeviceBFM(NamedTuple):
    """BFM constants on the device (0-based int topology)."""
    meanshape: torch.Tensor   # [N, 3]
    recenter: torch.Tensor    # [1, 3]
    id_base: torch.Tensor     # [3N, 80]
    ex_base: torch.Tensor     # [3N, 64]
    meantex: torch.Tensor     # [N, 3]
    tex_base: torch.Tensor    # [3N, 80]
    tri: torch.Tensor         # [F, 3] int32
    point_buf: torch.Tensor   # [N, 8] int64 (sentinel = F)
    keypoints: torch.Tensor   # [68] int64
    corner_id_base: Optional[torch.Tensor] = None  # [F, 3c, 3xyz, 80]
    corner_ex_base: Optional[torch.Tensor] = None  # [F, 3c, 3xyz, 64]
    corner_mean: Optional[torch.Tensor] = None     # [F, 3c, 3xyz] (raw)


def device_bfm(model: BFMModel, device="cuda",
               corner_cache: bool = False) -> DeviceBFM:
    """The model's constants on ``device``.  Raises if a triangle index
    lies outside the model's vertices: the raster kernel trusts the
    topology made here.  ``corner_cache`` adds the per-corner PCA rows of
    :func:`compute_norm_from_coeff` (JAX ``morph.py:56-83``)."""
    n = model.num_vertices
    tri = np.asarray(model.tri, np.int64) - 1
    if tri.size and (tri.min() < 0 or tri.max() >= n):
        raise ValueError(f"triangle indices outside [1, {n}]")
    meanshape = model.meanshape.reshape(n, 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=device)
    corner = {}
    if corner_cache:
        idb = np.asarray(model.idBase, np.float32).reshape(n, 3, 80)
        exb = np.asarray(model.exBase, np.float32).reshape(n, 3, 64)
        corner = dict(corner_id_base=f32(idb[tri]),
                      corner_ex_base=f32(exb[tri]),
                      corner_mean=f32(meanshape.astype(np.float32)[tri]))
    return DeviceBFM(
        meanshape=f32(meanshape),
        recenter=f32(meanshape.mean(axis=0, keepdims=True)),
        id_base=f32(model.idBase),
        ex_base=f32(model.exBase),
        meantex=f32(model.meantex.reshape(n, 3)),
        tex_base=f32(model.texBase),
        tri=torch.as_tensor(tri, device=device).to(torch.int32),
        point_buf=torch.as_tensor(np.asarray(model.point_buf, np.int64) - 1,
                                  device=device),
        keypoints=torch.as_tensor(np.asarray(model.keypoints, np.int64),
                                  device=device),
        **corner,
    )


def split_coeff(coeff: torch.Tensor):
    """[B, 257] -> (id 80, exp 64, tex 80, angles 3, gamma 27, trans 3)."""
    return (coeff[:, :80], coeff[:, 80:144], coeff[:, 144:224],
            coeff[:, 224:227], coeff[:, 227:254], coeff[:, 254:257])


def shape_formation(id_coeff, ex_coeff, fm: DeviceBFM) -> torch.Tensor:
    """[B,80],[B,64] -> recentered shape [B,N,3]."""
    flat = (id_coeff @ fm.id_base.T + ex_coeff @ fm.ex_base.T
            + fm.meanshape.reshape(1, -1))
    return flat.reshape(flat.shape[0], -1, 3) - fm.recenter[None]


def texture_formation(tex_coeff, fm: DeviceBFM) -> torch.Tensor:
    """[B,80] -> albedo [B,N,3] (0-255)."""
    flat = tex_coeff @ fm.tex_base.T + fm.meantex.reshape(1, -1)
    return flat.reshape(flat.shape[0], -1, 3)


def _one_ring_normals(face_norm, fm: DeviceBFM) -> torch.Tensor:
    """Face normals [B,F,3] -> unit one-ring vertex normals [B,N,3], summed
    through ``point_buf``, whose sentinel row indexes a zero normal."""
    face_norm = torch.cat([face_norm, face_norm.new_zeros(
        (face_norm.shape[0], 1, 3))], dim=1)
    v_norm = face_norm[:, fm.point_buf].sum(dim=2)
    return v_norm / torch.linalg.norm(v_norm, dim=2, keepdim=True)


def compute_norm(face_shape, fm: DeviceBFM) -> torch.Tensor:
    """One-ring unit vertex normals [B,N,3] (ref: reconstruct_mesh.py:35-52)
    from the triangle corners gathered out of the decoded shape."""
    tri = fm.tri.long()
    v1 = face_shape[:, tri[:, 0]]
    v2 = face_shape[:, tri[:, 1]]
    v3 = face_shape[:, tri[:, 2]]
    return _one_ring_normals(torch.linalg.cross(v1 - v2, v2 - v3, dim=-1),
                             fm)


def compute_norm_from_coeff(id_coeff, ex_coeff,
                            fm: DeviceBFM) -> torch.Tensor:
    """:func:`compute_norm` with no gather: [B,80],[B,64] -> [B,N,3].  The
    corners come from the corner cache as two matmuls, in the gather
    path's add order (id + ex + mean, then recenter), so the values agree
    with it to float32 round-off (JAX ``morph.py:139-160``)."""
    f = fm.corner_mean.shape[0]
    v = ((id_coeff @ fm.corner_id_base.reshape(f * 9, 80).T)
         + (ex_coeff @ fm.corner_ex_base.reshape(f * 9, 64).T)
         + fm.corner_mean.reshape(1, f * 9)).reshape(-1, f, 3, 3)
    v = v - fm.recenter[None, None]
    return _one_ring_normals(torch.linalg.cross(
        v[:, :, 0] - v[:, :, 1], v[:, :, 1] - v[:, :, 2], dim=-1), fm)


def _normals(id_c, ex_c, face_shape, fm: DeviceBFM) -> torch.Tensor:
    """The corner cache when ``fm`` holds one, else the gather path."""
    if fm.corner_id_base is not None:
        return compute_norm_from_coeff(id_c, ex_c, fm)
    return compute_norm(face_shape, fm)


def rotation_matrix(angles) -> torch.Tensor:
    """XYZ euler angles [B,3] -> row-vector rotations [B,3,3]
    (applied as ``shape @ R``)."""
    ax, ay, az = angles[:, 0], angles[:, 1], angles[:, 2]
    zeros = torch.zeros_like(ax)
    ones = torch.ones_like(ax)
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rot_x = torch.stack([ones, zeros, zeros, zeros, cx, -sx,
                         zeros, sx, cx], dim=-1).reshape(-1, 3, 3)
    rot_y = torch.stack([cy, zeros, sy, zeros, ones, zeros,
                         -sy, zeros, cy], dim=-1).reshape(-1, 3, 3)
    rot_z = torch.stack([cz, -sz, zeros, sz, cz, zeros,
                         zeros, zeros, ones], dim=-1).reshape(-1, 3, 3)
    return (rot_z @ rot_y @ rot_x).transpose(1, 2)


def projection_layer(face_shape, rotation, translation,
                     focal: float = 1015.0, center: float = 112.0):
    """Perspective projection onto the 224² image plane
    (ref: reconstruct_mesh.py:100-120) -> ([B,N,2], [B,N,1])."""
    dev = face_shape.device
    camera_pos = torch.tensor([0.0, 0.0, 10.0], device=dev).reshape(1, 1, 3)
    reverse_z = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]],
                             device=dev).reshape(1, 3, 3)
    p_matrix = torch.tensor([[focal, 0.0, center], [0.0, focal, center],
                             [0.0, 0.0, 1.0]], device=dev).reshape(1, 3, 3)
    face_shape_t = face_shape @ rotation + translation[:, None, :]
    face_shape_t = face_shape_t @ reverse_z + camera_pos
    aug = face_shape_t @ p_matrix.transpose(1, 2)
    return aug[:, :, 0:2] / aug[:, :, 2:3], -aug[:, :, 2:3]


def illumination_layer(face_texture, norm, gamma):
    """9-term SH lighting per channel (ref: reconstruct_mesh.py:129-168)
    -> (face_color [B,N,3], lighting [B,N,3])."""
    init_lit = torch.tensor([0.8, 0, 0, 0, 0, 0, 0, 0, 0],
                            device=gamma.device)
    gamma = gamma.reshape(-1, 3, 9) + init_lit.reshape(1, 1, 9)
    a0 = np.pi
    a1 = 2 * np.pi / np.sqrt(3.0)
    a2 = 2 * np.pi / np.sqrt(8.0)
    c0 = 1 / np.sqrt(4 * np.pi)
    c1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
    c2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
    nx, ny, nz = norm[..., 0], norm[..., 1], norm[..., 2]
    y = torch.stack([
        torch.full_like(nx, float(a0 * c0)),
        float(-a1 * c1) * ny,
        float(a1 * c1) * nz,
        float(-a1 * c1) * nx,
        float(a2 * c2) * nx * ny,
        float(-a2 * c2) * ny * nz,
        float(a2 * c2 * 0.5 / np.sqrt(3.0)) * (3 * torch.square(nz) - 1),
        float(-a2 * c2) * nx * nz,
        float(a2 * c2 * 0.5) * (torch.square(nx) - torch.square(ny)),
    ], dim=-1)                                        # [B, N, 9]
    lit = y @ gamma.transpose(1, 2)                   # [B, N, 3]
    return lit * face_texture, lit * 128.0


class Reconstruction(NamedTuple):
    face_shape: torch.Tensor
    face_texture: torch.Tensor
    face_color: torch.Tensor
    face_projection: torch.Tensor   # [B, N, 2] (y flipped to image rows)
    z_buffer: torch.Tensor          # [B, N, 1]
    landmarks_2d: torch.Tensor      # [B, 68, 2]


def reconstruct(coeff, fm: DeviceBFM,
                image_size: float = 224.0) -> Reconstruction:
    """Full coefficients -> screen-space mesh with the coefficients' own
    pose (ref: reconstruct_mesh.py:172-194): the shape stays unrotated, the
    normals and the projection are rotated, y is flipped to image rows."""
    full_fp32_matmuls()
    id_c, ex_c, tex_c, angles, gamma, translation = split_coeff(coeff)
    face_shape = shape_formation(id_c, ex_c, fm)
    face_texture = texture_formation(tex_c, fm)
    face_norm = _normals(id_c, ex_c, face_shape, fm)
    rotation = rotation_matrix(angles)
    face_norm_r = face_norm @ rotation
    face_projection, z_buffer = projection_layer(face_shape, rotation,
                                                 translation)
    face_projection = torch.stack(
        [face_projection[..., 0], image_size - face_projection[..., 1]],
        dim=-1)
    landmarks_2d = face_projection[:, fm.keypoints, :]
    face_color, _ = illumination_layer(face_texture, face_norm_r, gamma)
    return Reconstruction(face_shape, face_texture, face_color,
                          face_projection, z_buffer, landmarks_2d)


def reconstruct_rotation(coeff, fm: DeviceBFM, angles,
                         image_size: float = 224.0) -> Reconstruction:
    """Decode with an external rotation applied to the shape itself (the
    idle head sway; ref: reconstruct_mesh.py:198-223).  ``angles`` [B,3]
    overrides the coefficients' own pose."""
    full_fp32_matmuls()
    id_c, ex_c, tex_c, _, gamma, translation = split_coeff(coeff)
    face_shape = shape_formation(id_c, ex_c, fm)
    face_texture = texture_formation(tex_c, fm)
    face_norm = _normals(id_c, ex_c, face_shape, fm)
    rotation = rotation_matrix(angles)
    face_norm_r = face_norm @ rotation
    face_shape = face_shape @ rotation
    face_projection, z_buffer = projection_layer(face_shape, rotation,
                                                 translation)
    face_projection = torch.stack(
        [face_projection[..., 0], image_size - face_projection[..., 1]],
        dim=-1)
    landmarks_2d = face_projection[:, fm.keypoints, :]
    face_color, _ = illumination_layer(face_texture, face_norm_r, gamma)
    return Reconstruction(face_shape, face_texture, face_color,
                          face_projection, z_buffer, landmarks_2d)
