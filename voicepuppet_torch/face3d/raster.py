"""Z-buffer rasterizers, plain PyTorch versions.

Port of the order-free formulation of ``voicepuppet_tpu/face3d/raster.py``
(:57-349).  The sequential C++ loops (``mesh_core.cpp:108-231``: triangles
in index order, depth init -99999, strict ``>``) are equivalent to a rule
that needs no order: each pixel takes the maximum depth over the
fragments that cover it, and among the fragments at that depth the
smallest triangle id.  Here that is two ``scatter_reduce`` passes over
fragments: ``amax`` of depth, then ``amin`` of the triangle id among depth
winners.  With ``group`` > 0 the fragments are first merged within each
group of ``group`` consecutive triangles, by the same rule, and the group
winners then across groups: the order of ``_raster_kernel_grouped`` and
``_raster_kernel_interp_grouped``, whose output equals the per-triangle
one.

Fragments are generated exactly: every triangle emits one fragment per
pixel of its clipped integer bbox (``repeat_interleave`` over the bbox
areas), so no triangle is ever cropped, whatever its size.  The inside
test uses the reference's dot-product barycentrics in the same operation
order as the TPU kernels (``ops/raster_pallas.py:181-190``), one float32
op at a time, and the interpolated depth is ``(1-u-v)*z0 + v*z1 + u*z2``
summed left to right (``:750``).  That unfused float32 order is the
normative one: the spec ``raster_ref`` (float32 dot products, float64
barycentrics) and XLA's CPU kernels (which contract ``a*b + c*d`` into an
FMA) may each decide a pixel whose centre lies within ~1e-5 of an edge
differently, and the tests hold those departures to the float64-verified
borderline contract of ``ops/raster_selftest.py``.

These are the plain versions of the CUDA kernels in ``csrc/raster.cu``,
the raster A/B probes X1 and X3 included (X2's is ``rasterize_winner``):
the CPU tests use them, and ``chip_smoke.py`` holds the kernels against
them on the card, bit for bit.  ``winner_weights`` and ``sample_texture``
are dense post-passes with no kernel of their own.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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
                inv_deno=inv_deno, depth=depth, z0=p0[..., 2],
                z1=p1[..., 2], z2=p2[..., 2], xs=xs, ys=ys)


def _barycentric(g, px, py):
    """u, v at pixel offsets (px, py) from p0, in the kernels' order."""
    dot02 = g["v0x"] * px + g["v0y"] * py
    dot12 = g["v1x"] * px + g["v1y"] * py
    u = (g["dot11"] * dot02 - g["dot01"] * dot12) * g["inv_deno"]
    v = (g["dot00"] * dot12 - g["dot01"] * dot02) * g["inv_deno"]
    return u, v


def _fragments(vertices: torch.Tensor, triangles: torch.Tensor, h: int,
               w: int, interp: bool, drop_degenerate: bool = False):
    """Every fragment that draws: (triangle id [N] int64, pixel [N] int64 as
    frame*h*w + y*w + x, depth [N] float32 > -99999, -0.0 made +0.0).
    ``drop_degenerate``: triangles with ``inv_deno == 0`` draw nothing
    (the X1 probe) instead of covering their whole bbox."""
    b = vertices.shape[0]
    f = triangles.shape[0]
    dev = vertices.device
    s = _triangle_setup(vertices, triangles)
    x_min = torch.clamp(torch.ceil(s["xs"].amin(-1)), min=0.0)
    x_max = torch.clamp(torch.floor(s["xs"].amax(-1)), max=w - 1.0)
    y_min = torch.clamp(torch.ceil(s["ys"].amin(-1)), min=0.0)
    y_max = torch.clamp(torch.floor(s["ys"].amax(-1)), max=h - 1.0)
    finite = torch.isfinite(s["xs"]).all(-1) & torch.isfinite(s["ys"]).all(-1)
    live = (x_max >= x_min) & (y_max >= y_min) & finite
    if not interp:
        live &= s["depth"] > DEPTH_INIT
    if drop_degenerate:
        live &= s["inv_deno"] != 0
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

    keys = ("p0x", "p0y", "v0x", "v0y", "v1x", "v1y", "dot00", "dot01",
            "dot11", "inv_deno") + (("z0", "z1", "z2") if interp
                                    else ("depth",))
    g = {k: s[k].reshape(-1)[bf] for k in keys}
    u, v = _barycentric(g, fx.float() - g["p0x"], fy.float() - g["p0y"])
    inside = (u >= 0) & (v >= 0) & (u + v < 1)
    if interp:
        # the 2-px canvas border passes unconditionally inside the clipped
        # bbox (mesh_core.cpp:148, 292)
        border = (fx < 2) | (fx > w - 3) | (fy < 2) | (fy > h - 3)
        depth = (1.0 - u - v) * g["z0"] + v * g["z1"] + u * g["z2"]
        keep = (inside | border) & (depth > DEPTH_INIT)   # drops NaN too
    else:
        depth = g["depth"]
        keep = inside
    depth = depth[keep]
    depth = torch.where(depth == 0, torch.zeros_like(depth), depth)
    frame = bf[keep] // f
    pix = frame * (h * w) + fy[keep] * w + fx[keep]
    return bf[keep] % f, pix, depth


def _max_depth_min_id(index: torch.Tensor, tri: torch.Tensor,
                      depth: torch.Tensor, n: int, f: int):
    """Order-free z-test: per slot of ``index`` in [0, n), the maximum depth
    and the smallest triangle id at it -> (depth [n], winner [n] int32;
    DEPTH_INIT and f where nothing draws)."""
    depth_buf = torch.full((n,), DEPTH_INIT, device=depth.device)
    depth_buf.scatter_reduce_(0, index, depth, reduce="amax")
    is_winner = depth == depth_buf[index]
    winner = torch.full((n,), f, dtype=torch.int32, device=depth.device)
    winner.scatter_reduce_(0, index[is_winner],
                           tri[is_winner].to(torch.int32), reduce="amin")
    return depth_buf, winner


def _resolve(tri: torch.Tensor, pix: torch.Tensor, depth: torch.Tensor,
             b: int, f: int, h: int, w: int, group: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = b * h * w
    if group > 0:
        # within each group of `group` consecutive triangles first ...
        cell = (tri // group) * n + pix
        cells, slot = torch.unique(cell, return_inverse=True)
        depth, tri = _max_depth_min_id(slot, tri, depth, cells.numel(), f)
        pix = cells % n
    # ... then across groups (or, without groups, across triangles)
    depth_buf, winner = _max_depth_min_id(pix, tri, depth, n, f)
    return winner.reshape(b, h, w), depth_buf.reshape(b, h, w)


def rasterize_winner(vertices: torch.Tensor, triangles: torch.Tensor,
                     h: int, w: int, group: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,V,3] (x, y, depth in pixels) + [F,3] int -> (winner [B,h,w]
    int32 in [0,F], F = uncovered; flat depth [B,h,w] float32, -99999 where
    uncovered).  ``group`` > 0: the grouped merge order (K4)."""
    tri, pix, depth = _fragments(vertices, triangles, h, w, interp=False)
    return _resolve(tri, pix, depth, vertices.shape[0], triangles.shape[0],
                    h, w, group)


def rasterize_winner_interp(vertices: torch.Tensor, triangles: torch.Tensor,
                            h: int, w: int, group: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner and interpolated depth under the 2-px border rule
    (mesh_core.cpp:108-166; K3, and K5 with ``group`` > 0)."""
    tri, pix, depth = _fragments(vertices, triangles, h, w, interp=True)
    return _resolve(tri, pix, depth, vertices.shape[0], triangles.shape[0],
                    h, w, group)


# ---- the raster A/B probes (experiments/profile_raster{2,_regacc}.py) -----

def rasterize_winner_inside_only(vertices: torch.Tensor,
                                 triangles: torch.Tensor, h: int, w: int,
                                 winner: bool = True):
    """X1 (``_kernel_b``): K1 with degenerate triangles (``inv_deno == 0``)
    drawing nothing, the depth -1e10 of ``_trim_table``.  The bbox walk
    bounds the pixels and the inside test alone decides.  -> (winner,
    depth) as :func:`rasterize_winner`, or with ``winner=False`` the depth
    buffer [B,h,w] only (the probe's depth-only variant)."""
    tri, pix, depth = _fragments(vertices, triangles, h, w, interp=False,
                                 drop_degenerate=True)
    winner_buf, depth_buf = _resolve(tri, pix, depth, vertices.shape[0],
                                     triangles.shape[0], h, w, 0)
    return (winner_buf, depth_buf) if winner else depth_buf


def degenerate(vertices: torch.Tensor, triangles: torch.Tensor
               ) -> torch.Tensor:
    """[B, F] bool: the triangles whose ``inv_deno`` is 0, which K1 lets
    cover their whole bbox and X1 drops."""
    return _triangle_setup(vertices, triangles)["inv_deno"] == 0


def band_origins(vertices: torch.Tensor, triangles: torch.Tensor, h: int,
                 win: int, chunk: int) -> torch.Tensor:
    """[B, ceil(F/chunk)] int64: each chunk's band start row, its first
    triangle's aligned window origin ``clip(floor(y_min/8)*8, 0, h-win)``
    with ``y_min = max(ceil(min y), 0)`` (raster_pallas.py:106-111),
    whether or not that triangle draws.  A NaN origin becomes row 0, as
    XLA converts NaN to int32."""
    first = triangles[::chunk].long()
    ys = vertices.float()[:, first, 1]                     # [B, nc, 3]
    y_min = torch.clamp(torch.ceil(ys.amin(-1)), min=0.0)
    y0 = torch.clamp(torch.floor(y_min / 8.0) * 8.0, 0.0, float(h - win))
    return torch.nan_to_num(y0, nan=0.0).long()


def rasterize_winner_banded(vertices: torch.Tensor, triangles: torch.Tensor,
                            h: int, w: int, win: int = 16, chunk: int = 64
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X3 (``_regacc_kernel``): K1's fragments, each counted only inside
    the ``win``-row band of its chunk of ``chunk`` consecutive triangles
    (:func:`band_origins`), then the order-free (max depth, min id) rule:
    the kernel's strict ``>`` in id order within a chunk and its
    (max depth, min id) flush across chunks.  Equals K1 when every
    chunk's triangles lie in their band; on an unsorted table it differs,
    as the probe does."""
    if not 1 <= win <= h:
        raise ValueError(f"band height {win} outside [1, {h}]")
    tri, pix, depth = _fragments(vertices, triangles, h, w, interp=False)
    start = band_origins(vertices, triangles, h, win, chunk)
    row = (pix % (h * w)) // w
    lo = start[pix // (h * w), tri // chunk]
    keep = (row >= lo) & (row < lo + win)
    return _resolve(tri[keep], pix[keep], depth[keep], vertices.shape[0],
                    triangles.shape[0], h, w, 0)


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
                  triangles: torch.Tensor, h: int = 224, w: int = 224,
                  group: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-shaded z-buffer render (ref: mesh_core.cpp:169-231).
    vertices [B,V,3], colors [B,V,C] (integral 0-255), triangles [F,3]
    -> (image uint8 [B,h,w,C], mask uint8 [B,h,w])."""
    winner, _ = rasterize_winner(vertices, triangles, h, w, group)
    return flat_color_image(winner, colors, triangles)


class RasterOut(NamedTuple):
    depth_buffer: torch.Tensor        # [B, h, w]
    triangle_buffer: torch.Tensor     # [B, h, w] int32, -1 where empty
    barycentric_weight: torch.Tensor  # [B, h, w, 3]


def winner_weights(vertices: torch.Tensor, triangles: torch.Tensor,
                   winner: torch.Tensor, depth_buf: torch.Tensor, h: int,
                   w: int) -> RasterOut:
    """Winner ids (F = uncovered) + depth buffer -> RasterOut with the
    barycentrics recomputed at each winning pixel (a gather; JAX
    ``face3d/raster.py:winner_weights``)."""
    b = vertices.shape[0]
    f = triangles.shape[0]
    s = _triangle_setup(vertices, triangles)
    winner = winner.reshape(b, h * w)
    covered = winner < f
    safe = torch.where(covered, winner, torch.zeros_like(winner)).long()
    g = {k: torch.gather(s[k], 1, safe).reshape(b, h, w)
         for k in ("p0x", "p0y", "v0x", "v0y", "v1x", "v1y", "dot00",
                   "dot01", "dot11", "inv_deno")}
    dev = vertices.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    uu, vv = _barycentric(g, xs[None].float() - g["p0x"],
                          ys[None].float() - g["p0y"])
    weights = torch.stack([1.0 - uu - vv, vv, uu], dim=-1)
    covered = covered.reshape(b, h, w)
    weights = torch.where(covered[..., None], weights,
                          torch.zeros_like(weights))
    tri_out = torch.where(covered, winner.reshape(b, h, w),
                          torch.full_like(winner.reshape(b, h, w), -1))
    return RasterOut(depth_buf.reshape(b, h, w), tri_out, weights)


def rasterize_triangles(vertices: torch.Tensor, triangles: torch.Tensor,
                        h: int = 224, w: int = 224,
                        group: int = 0) -> RasterOut:
    """Triangle-id + barycentric rasterization (ref: mesh_core.cpp:108-166).
    vertices [B,V,3]."""
    winner, depth = rasterize_winner_interp(vertices, triangles, h, w, group)
    return winner_weights(vertices, triangles, winner, depth, h, w)


def sample_texture(out: RasterOut, texture: torch.Tensor,
                   tex_coords: torch.Tensor, tex_triangles: torch.Tensor,
                   bilinear: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UV sampling at winning pixels (mesh_core.cpp:262-323; JAX
    ``face3d/raster.py:sample_texture``) -> (image [B,h,w,C], depth).
    texture [th,tw,C], tex_coords [Vt,2+], tex_triangles [F,3]."""
    covered = out.triangle_buffer >= 0
    safe = torch.where(covered, out.triangle_buffer,
                       torch.zeros_like(out.triangle_buffer)).long()
    tex_tri = tex_triangles.long()[safe]                  # [B,h,w,3]
    corners = tex_coords[:, :2].float()[tex_tri]          # [B,h,w,3,2]
    wgt = out.barycentric_weight[..., None]
    tp = (wgt[..., 0, :] * corners[..., 0, :] + wgt[..., 1, :]
          * corners[..., 1, :] + wgt[..., 2, :] * corners[..., 2, :])
    tex_h, tex_w = texture.shape[0], texture.shape[1]
    tx = torch.clamp(tp[..., 0], 0.0, tex_w - 1.0)
    ty = torch.clamp(tp[..., 1], 0.0, tex_h - 1.0)
    if bilinear:
        x0, y0 = torch.floor(tx).long(), torch.floor(ty).long()
        x1, y1 = torch.ceil(tx).long(), torch.ceil(ty).long()
        xd = (tx - x0)[..., None]
        yd = (ty - y0)[..., None]
        sample = (texture[y0, x0] * (1 - xd) * (1 - yd)
                  + texture[y0, x1] * xd * (1 - yd)
                  + texture[y1, x0] * (1 - xd) * yd
                  + texture[y1, x1] * xd * yd)
    else:
        # round half to even, as jnp.round
        sample = texture[torch.round(ty).long(), torch.round(tx).long()]
    image = torch.where(covered[..., None], sample, torch.zeros_like(sample))
    return image, out.depth_buffer


def render_texture(vertices: torch.Tensor, triangles: torch.Tensor,
                   texture: torch.Tensor, tex_coords: torch.Tensor,
                   tex_triangles: torch.Tensor, h: int = 224, w: int = 224,
                   bilinear: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UV-textured rasterization (ref: mesh_core.cpp:234-333)."""
    out = rasterize_triangles(vertices, triangles, h, w)
    return sample_texture(out, texture, tex_coords, tex_triangles, bilinear)


def vertex_normals(tri_normal: torch.Tensor, triangles: torch.Tensor,
                   num_vertices: int) -> torch.Tensor:
    """One-ring scatter-add of per-triangle normals onto vertices (ref:
    mesh_core.cpp:85-105; JAX ``face3d/raster.py:353``): tri_normal
    [..., F, 3], triangles [F, 3] -> [..., num_vertices, 3] in
    ``tri_normal``'s dtype, the triangles' first, second, then third
    corners added in turn."""
    out = tri_normal.new_zeros(tri_normal.shape[:-2] + (num_vertices, 3))
    tri = triangles.to(device=tri_normal.device, dtype=torch.long)
    for k in range(3):
        out.index_add_(-2, tri[:, k], tri_normal)
    return out
