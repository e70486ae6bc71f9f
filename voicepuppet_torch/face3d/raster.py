"""Flat-shaded z-buffer raster, plain PyTorch version.

Port of the order-free formulation of ``voicepuppet_tpu/face3d/raster.py``
(:57-228).  The sequential C++ loop (``mesh_core.cpp:169-231``: triangles
in index order, depth init -99999, strict ``>``) is equivalent to a rule
that needs no order: each pixel takes the maximum depth over the
triangles that cover it, and among the triangles at that depth the
smallest id.  Here that is two ``scatter_reduce`` passes over fragments:
``amax`` of depth, then ``amin`` of the triangle id among depth winners.

Fragments are generated exactly: every triangle emits one fragment per
pixel of its clipped integer bbox (``repeat_interleave`` over the bbox
areas), so no triangle is ever cropped, whatever its size.  The inside
test uses the reference's dot-product barycentrics in the same operation
order as ``_raster_kernel`` (``ops/raster_pallas.py:181-190``), one float32
op at a time.

This is the plain version of the CUDA kernel in ``csrc/raster.cu``: the
CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on the
card, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

DEPTH_INIT = -99999.0


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE float32 division.  The divisor is made a tensor on ``a``'s
    device: torch's CUDA division by a host scalar multiplies by the
    rounded reciprocal instead, which is not the quotient the kernel and
    the reference compute."""
    return torch.div(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _triangle_setup(vertices: torch.Tensor, triangles: torch.Tensor):
    """[B,V,3] + [F,3] -> dict of [B,F] per-triangle constants."""
    tri = triangles.long()
    v = vertices.float()
    p0 = v[:, tri[:, 0]]
    p1 = v[:, tri[:, 1]]
    p2 = v[:, tri[:, 2]]
    v0x, v0y = p2[..., 0] - p0[..., 0], p2[..., 1] - p0[..., 1]
    v1x, v1y = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    deno = dot00 * dot11 - dot01 * dot01
    inv_deno = torch.where(deno == 0, torch.zeros_like(deno),
                           _div(torch.ones_like(deno),
                                torch.where(deno == 0,
                                            torch.ones_like(deno), deno)))
    # jnp.mean of the three z: XLA sums in order, then multiplies by the
    # float32 reciprocal of 3 (not a division)
    depth = torch.mul(p0[..., 2] + p1[..., 2] + p2[..., 2],
                      torch.tensor(1.0 / 3.0, device=vertices.device))
    xs = torch.stack([p0[..., 0], p1[..., 0], p2[..., 0]], -1)
    ys = torch.stack([p0[..., 1], p1[..., 1], p2[..., 1]], -1)
    return dict(p0x=p0[..., 0], p0y=p0[..., 1], v0x=v0x, v0y=v0y,
                v1x=v1x, v1y=v1y, dot00=dot00, dot01=dot01, dot11=dot11,
                inv_deno=inv_deno, depth=depth, xs=xs, ys=ys)


def rasterize_winner(vertices: torch.Tensor, triangles: torch.Tensor,
                     h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,V,3] (x, y, depth in pixels) + [F,3] int -> (winner [B,h,w]
    int32 in [0,F], F = uncovered; depth [B,h,w] float32, -99999 where
    uncovered)."""
    b = vertices.shape[0]
    f = triangles.shape[0]
    dev = vertices.device
    s = _triangle_setup(vertices, triangles)
    x_min = torch.clamp(torch.ceil(s["xs"].amin(-1)), min=0.0)
    x_max = torch.clamp(torch.floor(s["xs"].amax(-1)), max=w - 1.0)
    y_min = torch.clamp(torch.ceil(s["ys"].amin(-1)), min=0.0)
    y_max = torch.clamp(torch.floor(s["ys"].amax(-1)), max=h - 1.0)
    finite = torch.isfinite(s["xs"]).all(-1) & torch.isfinite(s["ys"]).all(-1)
    live = ((x_max >= x_min) & (y_max >= y_min) & finite
            & (s["depth"] > DEPTH_INIT))
    zero = torch.zeros((), device=dev)
    bw = torch.where(live, x_max - x_min + 1.0, zero).long()
    bh = torch.where(live, y_max - y_min + 1.0, zero).long()
    area = (bw * bh).reshape(-1)                          # [B*F]
    bf = torch.repeat_interleave(torch.arange(b * f, device=dev), area)
    start = torch.cumsum(area, 0) - area
    local = torch.arange(bf.shape[0], device=dev) - start[bf]
    bw_f = bw.reshape(-1)[bf]
    fx = x_min.reshape(-1)[bf].long() + local % bw_f
    fy = y_min.reshape(-1)[bf].long() + local // bw_f

    g = {k: t.reshape(-1)[bf] for k, t in s.items() if k not in ("xs", "ys")}
    px = fx.float() - g["p0x"]
    py = fy.float() - g["p0y"]
    dot02 = g["v0x"] * px + g["v0y"] * py
    dot12 = g["v1x"] * px + g["v1y"] * py
    u = (g["dot11"] * dot02 - g["dot01"] * dot12) * g["inv_deno"]
    v = (g["dot00"] * dot12 - g["dot01"] * dot02) * g["inv_deno"]
    inside = (u >= 0) & (v >= 0) & (u + v < 1)

    frame = bf[inside] // f
    tri_id = (bf[inside] % f).to(torch.int32)
    pix = frame * (h * w) + fy[inside] * w + fx[inside]
    depth = g["depth"][inside]
    depth_buf = torch.full((b * h * w,), DEPTH_INIT, device=dev)
    depth_buf.scatter_reduce_(0, pix, depth, reduce="amax")
    is_winner = depth == depth_buf[pix]
    winner = torch.full((b * h * w,), f, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, pix[is_winner], tri_id[is_winner],
                           reduce="amin")
    return winner.reshape(b, h, w), depth_buf.reshape(b, h, w)


def flat_color_image(winner: torch.Tensor, colors: torch.Tensor,
                     triangles: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner ids [B,h,w] -> (image uint8 [B,h,w,C], mask uint8 [B,h,w])
    with the C++ truncation ``(int)(c0+c1+c2)/3`` on floored corner colors
    (``_flat_color_image``, ops/raster_pallas.py:990-1010)."""
    b, h, w = winner.shape
    f = triangles.shape[0]
    tri_colors = torch.floor(colors.float()[:, triangles.long()])  # [B,F,3,C]
    color_sum = tri_colors[:, :, 0] + tri_colors[:, :, 1] + tri_colors[:, :, 2]
    flat = torch.floor(_div(color_sum, 3.0))
    flat = torch.cat([flat, flat.new_zeros((b, 1, flat.shape[-1]))], dim=1)
    image = torch.gather(flat, 1, winner.reshape(b, -1, 1).long().expand(
        -1, -1, flat.shape[-1])).reshape(b, h, w, -1)
    covered = winner < f
    image = torch.where(covered[..., None], image, torch.zeros_like(image))
    mask = covered.to(torch.uint8) * 255
    return image.to(torch.uint8), mask


def render_colors(vertices: torch.Tensor, colors: torch.Tensor,
                  triangles: torch.Tensor, h: int = 224, w: int = 224
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-shaded z-buffer render (ref: mesh_core.cpp:169-231).
    vertices [B,V,3], colors [B,V,C] (integral 0-255), triangles [F,3]
    -> (image uint8 [B,h,w,C], mask uint8 [B,h,w])."""
    winner, _ = rasterize_winner(vertices, triangles, h, w)
    return flat_color_image(winner, colors, triangles)
