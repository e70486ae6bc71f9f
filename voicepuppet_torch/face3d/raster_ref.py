"""Sequential NumPy z-buffer rasterizer — the behavioral spec.

A direct, loop-for-loop re-statement of the reference C++ kernels
(utils/cython/mesh_core.cpp:85-333) and of the pure-python algorithm spec at
utils/bfm_visual.py:50-85, written fresh in NumPy.  Own copy of
``voicepuppet_tpu/face3d/raster_ref.py``: the plain raster
(face3d/raster.py) and the CUDA kernel (csrc/raster.cu) are held against
its exact sequential semantics (triangle order, strict depth test, integer
color truncation, border rules).

Used only by tests; never on the serving path.
"""

from __future__ import annotations

import numpy as np

DEPTH_INIT = -99999.0


def _point_in_tri(px, py, p0, p1, p2):
    """mesh_core.cpp:23-50 (degenerate triangles return True)."""
    v0 = p2 - p0
    v1 = p1 - p0
    v2 = np.array([px, py], np.float32) - p0
    dot00 = float(v0 @ v0)
    dot01 = float(v0 @ v1)
    dot02 = float(v0 @ v2)
    dot11 = float(v1 @ v1)
    dot12 = float(v1 @ v2)
    deno = dot00 * dot11 - dot01 * dot01
    inv = 0.0 if deno == 0 else 1.0 / deno
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (u >= 0) and (v >= 0) and (u + v < 1)


def _point_weight(px, py, p0, p1, p2):
    """mesh_core.cpp:53-82 -> (w0, w1, w2)."""
    v0 = p2 - p0
    v1 = p1 - p0
    v2 = np.array([px, py], np.float32) - p0
    dot00 = float(v0 @ v0)
    dot01 = float(v0 @ v1)
    dot02 = float(v0 @ v2)
    dot11 = float(v1 @ v1)
    dot12 = float(v1 @ v2)
    deno = dot00 * dot11 - dot01 * dot01
    inv = 0.0 if deno == 0 else 1.0 / deno
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (1.0 - u - v, v, u)


def _bbox(p0, p1, p2, h, w):
    x_min = max(int(np.ceil(min(p0[0], p1[0], p2[0]))), 0)
    x_max = min(int(np.floor(max(p0[0], p1[0], p2[0]))), w - 1)
    y_min = max(int(np.ceil(min(p0[1], p1[1], p2[1]))), 0)
    y_max = min(int(np.floor(max(p0[1], p1[1], p2[1]))), h - 1)
    return x_min, x_max, y_min, y_max


def render_colors_ref(vertices: np.ndarray, triangles: np.ndarray,
                      colors: np.ndarray, h: int, w: int):
    """mesh_core.cpp:169-231.  vertices [V,3], triangles [F,3] 0-based,
    colors [V,C] floats holding integral values.
    Returns (image [h,w,C] uint8, face_mask [h,w] uint8)."""
    c = colors.shape[1]
    image = np.zeros((h, w, c), np.uint8)
    face_mask = np.zeros((h, w), np.uint8)
    depth_buffer = np.full((h, w), DEPTH_INIT, np.float32)

    for i in range(triangles.shape[0]):
        i0, i1, i2 = triangles[i]
        p0 = vertices[i0, :2].astype(np.float32)
        p1 = vertices[i1, :2].astype(np.float32)
        p2 = vertices[i2, :2].astype(np.float32)
        x_min, x_max, y_min, y_max = _bbox(p0, p1, p2, h, w)
        if x_max < x_min or y_max < y_min:
            continue
        p_depth = (float(vertices[i0, 2]) + float(vertices[i1, 2])
                   + float(vertices[i2, 2])) / 3.0
        for y in range(y_min, y_max + 1):
            for x in range(x_min, x_max + 1):
                if p_depth > depth_buffer[y, x] and _point_in_tri(
                        x, y, p0, p1, p2):
                    for k in range(c):
                        s = (colors[i0, k] + colors[i1, k] + colors[i2, k])
                        image[y, x, k] = int(s) // 3
                    face_mask[y, x] = 255
                    depth_buffer[y, x] = p_depth
    return image, face_mask


def rasterize_triangles_ref(vertices: np.ndarray, triangles: np.ndarray,
                            h: int, w: int):
    """mesh_core.cpp:108-166.  Returns (depth [h,w], tri_id [h,w] int32
    (-1 empty -- the C++ leaves caller-initialized memory; tests init -1),
    weights [h,w,3])."""
    depth_buffer = np.full((h, w), DEPTH_INIT, np.float32)
    triangle_buffer = np.full((h, w), -1, np.int32)
    weight_buffer = np.zeros((h, w, 3), np.float32)

    for i in range(triangles.shape[0]):
        i0, i1, i2 = triangles[i]
        p0 = vertices[i0, :2].astype(np.float32)
        p1 = vertices[i1, :2].astype(np.float32)
        p2 = vertices[i2, :2].astype(np.float32)
        d0, d1, d2 = (float(vertices[i0, 2]), float(vertices[i1, 2]),
                      float(vertices[i2, 2]))
        x_min, x_max, y_min, y_max = _bbox(p0, p1, p2, h, w)
        if x_max < x_min or y_max < y_min:
            continue
        for y in range(y_min, y_max + 1):
            for x in range(x_min, x_max + 1):
                border = x < 2 or x > w - 3 or y < 2 or y > h - 3
                if border or _point_in_tri(x, y, p0, p1, p2):
                    w0, w1, w2 = _point_weight(x, y, p0, p1, p2)
                    p_depth = w0 * d0 + w1 * d1 + w2 * d2
                    if p_depth > depth_buffer[y, x]:
                        depth_buffer[y, x] = p_depth
                        triangle_buffer[y, x] = i
                        weight_buffer[y, x] = (w0, w1, w2)
    return depth_buffer, triangle_buffer, weight_buffer


def vertex_normals_ref(tri_normal: np.ndarray, triangles: np.ndarray,
                       num_vertices: int):
    """mesh_core.cpp:85-105."""
    out = np.zeros((num_vertices, 3), tri_normal.dtype)
    for i in range(triangles.shape[0]):
        for v in triangles[i]:
            out[v] += tri_normal[i]
    return out
