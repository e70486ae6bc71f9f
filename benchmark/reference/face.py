"""The serving path of the plain reference, outside the networks: the
log-mel frontend, the 3DMM decode, the flat z-buffer raster, resize and
paste, the idle head sway and the YUV 4:2:0 round trip.

Frozen copies of the system's plain code (its frontend, ``face3d/morph``,
the order-free plain raster of ``face3d/raster.py``, the synthesizer's
pack and unpack), nothing of it imported.  Every matmul runs in the
precision the caller leaves set: float32 with TF32 off for the reference,
TF32 for the control.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

DEPTH_INIT = -99999.0


# ---- log-mel frontend ---------------------------------------------------------

def _hertz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


def mel_matrix(num_mel_bins, num_spectrogram_bins, sample_rate, lower, upper):
    """``tf.signal.linear_to_mel_weight_matrix`` (DC bin zeroed)."""
    linear = np.linspace(0.0, sample_rate / 2.0, num_spectrogram_bins)[1:]
    spec_mel = _hertz_to_mel(linear)[:, None]
    edges = np.linspace(_hertz_to_mel(lower), _hertz_to_mel(upper),
                        num_mel_bins + 2)
    lo, ce, up = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((spec_mel - lo) / (ce - lo),
                                   (up - spec_mel) / (up - ce)))
    return np.pad(w, [[1, 0], [0, 0]]).astype(np.float32)


def dft_bases(win_length, fft_length):
    bins = fft_length // 2 + 1
    n = np.arange(fft_length, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / fft_length
    hann = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length)
                               / win_length)).astype(np.float32)
    basis = np.concatenate([np.cos(angle), -np.sin(angle)],
                           axis=1)[:win_length] * hann.astype(
                               np.float64)[:, None]
    return basis.astype(np.float32)


class Mel:
    """pcm [B, N] -> log-mel [B, F, bins]: framing by hop rows, the
    windowed DFT and the mel weights as two matmuls."""

    def __init__(self, mel: dict, device):
        self.win, self.hop = mel["win_length"], mel["hop_step"]
        self.log_offset = mel["log_offset"]
        self.basis = torch.from_numpy(dft_bases(
            self.win, mel["fft_length"])).to(device)
        self.mel = torch.from_numpy(mel_matrix(
            mel["num_mel_bins"], mel["fft_length"] // 2 + 1,
            mel["sample_rate"], mel["lower_edge_hertz"],
            mel["upper_edge_hertz"])).to(device)

    def __call__(self, pcm: torch.Tensor) -> torch.Tensor:
        nf = 1 + (pcm.shape[-1] - self.win) // self.hop
        k = self.win // self.hop
        rows_needed = nf - 1 + k
        usable = rows_needed * self.hop
        if pcm.shape[-1] < usable:
            pcm = F.pad(pcm, (0, usable - pcm.shape[-1]))
        rows = pcm[..., :usable].reshape(pcm.shape[:-1]
                                         + (rows_needed, self.hop))
        frames = torch.cat([rows[..., i:i + nf, :] for i in range(k)],
                           dim=-1)
        re, im = (frames @ self.basis).chunk(2, dim=-1)
        return torch.log(torch.sqrt(re * re + im * im) @ self.mel
                         + self.log_offset)


def pcm_length_for_frames(num_frames: int, mel: dict, scale: int) -> int:
    return mel["hop_step"] * (num_frames * scale - 1) + mel["win_length"]


# ---- 3DMM decode -----------------------------------------------------------

class FaceModel(NamedTuple):
    """The BFM's arrays on the device (0-based topology)."""
    meanshape: torch.Tensor   # [N, 3]
    recenter: torch.Tensor    # [1, 3]
    id_base: torch.Tensor     # [3N, 80]
    ex_base: torch.Tensor     # [3N, 64]
    meantex: torch.Tensor     # [N, 3]
    tex_base: torch.Tensor    # [3N, 80]
    tri: torch.Tensor         # [F, 3] int64
    point_buf: torch.Tensor   # [N, 8] int64, sentinel F


def face_model_on(arrays: dict, device) -> FaceModel:
    """``arrays``: meanshape [1,3N], idBase, exBase, meantex, texBase,
    tri [F,3] and point_buf [N,8] 1-based (the BFM file's layout)."""
    n = arrays["meanshape"].size // 3
    meanshape = np.asarray(arrays["meanshape"], np.float32).reshape(n, 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return FaceModel(
        meanshape=f32(meanshape),
        recenter=f32(meanshape.mean(axis=0, keepdims=True)),
        id_base=f32(arrays["idBase"]), ex_base=f32(arrays["exBase"]),
        meantex=f32(np.asarray(arrays["meantex"]).reshape(n, 3)),
        tex_base=f32(arrays["texBase"]),
        tri=torch.as_tensor(np.asarray(arrays["tri"], np.int64) - 1,
                            device=device),
        point_buf=torch.as_tensor(np.asarray(arrays["point_buf"], np.int64)
                                  - 1, device=device))


def rotation_matrix(angles):
    ax, ay, az = angles[:, 0], angles[:, 1], angles[:, 2]
    z, o = torch.zeros_like(ax), torch.ones_like(ax)
    cx, sx, cy, sy = torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(-1, 3, 3)
    return (rz @ ry @ rx).transpose(1, 2)


def _illumination(tex, norm, gamma):
    init_lit = torch.tensor([0.8, 0, 0, 0, 0, 0, 0, 0, 0],
                            device=gamma.device)
    gamma = gamma.reshape(-1, 3, 9) + init_lit.reshape(1, 1, 9)
    a0, a1, a2 = np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0)
    c0 = 1 / np.sqrt(4 * np.pi)
    c1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
    c2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
    nx, ny, nz = norm[..., 0], norm[..., 1], norm[..., 2]
    y = torch.stack([
        torch.full_like(nx, float(a0 * c0)), float(-a1 * c1) * ny,
        float(a1 * c1) * nz, float(-a1 * c1) * nx,
        float(a2 * c2) * nx * ny, float(-a2 * c2) * ny * nz,
        float(a2 * c2 * 0.5 / np.sqrt(3.0)) * (3 * torch.square(nz) - 1),
        float(-a2 * c2) * nx * nz,
        float(a2 * c2 * 0.5) * (torch.square(nx) - torch.square(ny))], -1)
    return (y @ gamma.transpose(1, 2)) * tex


def decode(coeff, fm: FaceModel, angles, image_size: float = 224.0):
    """coeff [B,257] with the head sway ``angles`` [B,3] applied to the
    shape -> (vertices [B,N,3] as x, y in image rows, z; colours [B,N,3]
    floored to 0..255)."""
    id_c, ex_c, tex_c = coeff[:, :80], coeff[:, 80:144], coeff[:, 144:224]
    gamma, trans = coeff[:, 227:254], coeff[:, 254:257]
    flat = id_c @ fm.id_base.T + ex_c @ fm.ex_base.T + fm.meanshape.reshape(
        1, -1)
    shape = flat.reshape(flat.shape[0], -1, 3) - fm.recenter[None]
    tex = (tex_c @ fm.tex_base.T + fm.meantex.reshape(1, -1)).reshape(
        shape.shape)
    tri = fm.tri
    v1, v2, v3 = shape[:, tri[:, 0]], shape[:, tri[:, 1]], shape[:, tri[:, 2]]
    fnorm = torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)
    fnorm = torch.cat([fnorm, fnorm.new_zeros((fnorm.shape[0], 1, 3))], 1)
    vnorm = fnorm[:, fm.point_buf].sum(dim=2)
    vnorm = vnorm / torch.linalg.norm(vnorm, dim=2, keepdim=True)
    rot = rotation_matrix(angles)
    vnorm = vnorm @ rot
    shape = shape @ rot
    dev = coeff.device
    cam = torch.tensor([0.0, 0.0, 10.0], device=dev).reshape(1, 1, 3)
    rev = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]],
                       device=dev).reshape(1, 3, 3)
    pm = torch.tensor([[1015.0, 0.0, 112.0], [0.0, 1015.0, 112.0],
                       [0.0, 0.0, 1.0]], device=dev).reshape(1, 3, 3)
    st = (shape @ rot + trans[:, None, :]) @ rev + cam
    aug = st @ pm.transpose(1, 2)
    proj = aug[:, :, 0:2] / aug[:, :, 2:3]
    verts = torch.cat([proj[..., :1], image_size - proj[..., 1:2],
                       -aug[:, :, 2:3]], -1)
    colors = torch.floor(torch.clamp(_illumination(tex, vnorm, gamma),
                                     0.0, 255.0))
    return verts.contiguous(), colors


# ---- the flat z-buffer raster (order-free form) --------------------------------

def _div(a, b):
    return torch.div(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def rasterize_winner(vertices, triangles, h: int, w: int):
    """Each pixel takes the fragment of largest depth, and among equal
    depths the smallest triangle id (the sequential z-test with strict >,
    in index order) -> winner [B,h,w] int32 in [0, F], F where empty."""
    b, f = vertices.shape[0], triangles.shape[0]
    dev = vertices.device
    tri = triangles.long()
    v = vertices.float()
    p0, p1, p2 = v[:, tri[:, 0]], v[:, tri[:, 1]], v[:, tri[:, 2]]
    v0x, v0y = p2[..., 0] - p0[..., 0], p2[..., 1] - p0[..., 1]
    v1x, v1y = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    deno = dot00 * dot11 - dot01 * dot01
    inv = torch.where(deno == 0, torch.zeros_like(deno),
                      _div(torch.ones_like(deno),
                           torch.where(deno == 0, torch.ones_like(deno),
                                       deno)))
    depth = torch.mul(p0[..., 2] + p1[..., 2] + p2[..., 2],
                      torch.tensor(1.0 / 3.0, device=dev))
    xs = torch.stack([p0[..., 0], p1[..., 0], p2[..., 0]], -1)
    ys = torch.stack([p0[..., 1], p1[..., 1], p2[..., 1]], -1)
    x0 = torch.clamp(torch.ceil(xs.amin(-1)), min=0.0)
    x1 = torch.clamp(torch.floor(xs.amax(-1)), max=w - 1.0)
    y0 = torch.clamp(torch.ceil(ys.amin(-1)), min=0.0)
    y1 = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1.0)
    live = ((x1 >= x0) & (y1 >= y0) & torch.isfinite(xs).all(-1)
            & torch.isfinite(ys).all(-1) & (depth > DEPTH_INIT))
    zero = torch.zeros((), device=dev)
    bw = torch.where(live, x1 - x0 + 1.0, zero).long()
    bh = torch.where(live, y1 - y0 + 1.0, zero).long()
    area = (bw * bh).reshape(-1)
    bf = torch.repeat_interleave(torch.arange(b * f, device=dev), area)
    local = torch.arange(bf.shape[0], device=dev) - (torch.cumsum(area, 0)
                                                     - area)[bf]
    bwf = bw.reshape(-1)[bf]
    fx = x0.reshape(-1)[bf].long() + local % bwf
    fy = y0.reshape(-1)[bf].long() + local // bwf
    g = lambda t: t.reshape(-1)[bf]
    px, py = fx.float() - g(p0[..., 0]), fy.float() - g(p0[..., 1])
    dot02 = g(v0x) * px + g(v0y) * py
    dot12 = g(v1x) * px + g(v1y) * py
    u = (g(dot11) * dot02 - g(dot01) * dot12) * g(inv)
    vv = (g(dot00) * dot12 - g(dot01) * dot02) * g(inv)
    keep = (u >= 0) & (vv >= 0) & (u + vv < 1)
    d = g(depth)[keep]
    d = torch.where(d == 0, torch.zeros_like(d), d)
    pix = (bf[keep] // f) * (h * w) + fy[keep] * w + fx[keep]
    tid = bf[keep] % f
    n = b * h * w
    depth_buf = torch.full((n,), DEPTH_INIT, device=dev)
    depth_buf.scatter_reduce_(0, pix, d, reduce="amax")
    won = d == depth_buf[pix]
    winner = torch.full((n,), f, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, pix[won], tid[won].to(torch.int32),
                           reduce="amin")
    return winner.reshape(b, h, w)


def flat_colors(winner, colors, triangles):
    """winner [B,h,w] -> uint8 image [B,h,w,3]: the triangle's floored
    corner colours summed and floor-divided by 3; black where empty."""
    b, h, w = winner.shape
    f = triangles.shape[0]
    tc = torch.floor(colors.float()[:, triangles.long()])
    flat = torch.floor(_div(tc[:, :, 0] + tc[:, :, 1] + tc[:, :, 2], 3.0))
    flat = torch.cat([flat, flat.new_zeros((b, 1, flat.shape[-1]))], 1)
    img = torch.gather(flat, 1, winner.reshape(b, -1, 1).long().expand(
        -1, -1, flat.shape[-1])).reshape(b, h, w, -1)
    img = torch.where((winner < f)[..., None], img, torch.zeros_like(img))
    return img.to(torch.uint8)


# ---- resize, paste, sway, pack -------------------------------------------------

def resize_linear(face, out_hw: int):
    if face.shape[1] == out_hw and face.shape[2] == out_hw:
        return face
    x = F.interpolate(face.permute(0, 3, 1, 2), size=(out_hw, out_hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def paste_geometry(identity: dict, raster_size: int, img_size: int):
    """(out_hw, (ty0, ty1, tx0, tx1), (sy0, sy1, sx0, sx1)) of an identity
    (``transform_params``, ``center_x``, ``center_y``, ``ratio``)."""
    tp = identity["transform_params"]
    ratio = identity["ratio"] * float(tp[2])
    tx, ty = -int(tp[3] / ratio), -int(tp[4] / ratio)
    out_hw = int(round(raster_size / ratio))
    cf = out_hw // 2
    y0 = identity["center_y"] - cf - ty
    x0 = identity["center_x"] - cf - tx
    ty0, tx0 = max(y0, 0), max(x0, 0)
    ty1, tx1 = min(y0 + out_hw, img_size), min(x0 + out_hw, img_size)
    sy0, sx0 = ty0 - y0, tx0 - x0
    return out_hw, (ty0, ty1, tx0, tx1), (sy0, sy0 + ty1 - ty0, sx0,
                                          sx0 + tx1 - tx0)


def head_sway(num_frames: int, state=None, shift: float = 0.005,
              bound: float = 0.03):
    """Euler angles advancing by ``shift`` a frame, turning where the yaw
    passes ±bound -> ([T,3] float32, state)."""
    out = np.zeros((num_frames, 3), np.float32)
    angles, step = ((np.zeros(3, np.float64), shift) if state is None
                    else (np.array(state[0], np.float64), state[1]))
    for i in range(num_frames):
        angles += step
        if angles[1] > bound or angles[1] < -bound:
            step = -step
        out[i] = angles
    return out, (angles, step)


def _fma(a, b: float, c):
    return (a.double() * float(np.float32(b)) + c.double()).float()


def pack_yuv420(frames):
    """[C,H,W,3] in [0,1] -> [C, H*W*3/2] uint8 (BT.601 full range, 2x2
    box chroma), each ``a*b + c`` rounded once."""
    c, h, w = frames.shape[:3]
    f = torch.clamp(frames, 0.0, 1.0) * 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _fma(b, 0.114, _fma(r, 0.299, g * 0.587))
    u = _fma(b - y, 0.564, torch.full_like(y, 128.0))
    v = _fma(r - y, 0.713, torch.full_like(y, 128.0))

    def box(p):
        q = p.reshape(c, h // 2, 2, w // 2, 2)
        return (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
                + q[:, :, 1, :, 1]) * 0.25

    packed = torch.cat([y.reshape(c, -1), box(u).reshape(c, -1),
                        box(v).reshape(c, -1)], dim=1)
    return torch.clamp(torch.round(packed), 0, 255).to(torch.uint8)


def unpack_yuv420(packed: np.ndarray, s: int) -> np.ndarray:
    """[N, S*S*3/2] uint8 -> [N,S,S,3] uint8 RGB (nearest chroma, int16
    1/64 fixed point)."""
    n, ss = packed.shape[0], s * s
    y = packed[:, :ss].reshape(n, s, s).astype(np.int16)
    u = packed[:, ss:ss + ss // 4].reshape(n, s // 2, s // 2).astype(
        np.int16) - 128
    v = packed[:, ss + ss // 4:].reshape(n, s // 2, s // 2).astype(
        np.int16) - 128
    out = np.empty((n, s, s, 3), np.uint8)
    for ch, q in ((0, (90 * v) >> 6), (1, (-22 * u - 46 * v) >> 6),
                  (2, (113 * u) >> 6)):
        up = np.repeat(np.repeat(q, 2, axis=1), 2, axis=2) + y
        out[..., ch] = np.clip(up, 0, 255)
    return out


def tail_bucket(n: int, chunk: int) -> int:
    """A last chunk of ``n`` frames renders the smallest power of two >= n,
    at least 8, at most ``chunk``."""
    cc = 8
    while cc < n:
        cc *= 2
    return min(cc, chunk)


def coeff_bucket(t: int) -> int:
    """The whole-clip coefficient program's padded length: the next power
    of two >= t, at least 16."""
    b = 16
    while b < t:
        b *= 2
    return b
