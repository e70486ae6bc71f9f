"""ctypes bindings for the port's native host rasterizer
(``csrc/vp_raster.cpp``, its own copy of ``native/vp_raster.cpp``; port
of ``voicepuppet_tpu/face3d/raster_native.py``).

The raster API on the host CPU, a second oracle next to the plain spec
(``face3d/raster_ref.py``); the reference equivalent is the
mesh_core_cython extension (utils/cython/mesh_core_cython.pyx:40-99).
No serving or training path calls it.  The library is built with g++ and
``native/build.py``'s flags into ``build/`` (named by the source's hash)
at the first call, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

DEPTH_INIT = -99999.0

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "vp_raster.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def build_library(src: str = _SRC, build_dir: str = BUILD_DIR) -> str:
    """Compile ``src`` with g++ into ``build_dir`` unless a library of the
    same source and flags is there; returns its path."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, f"libvp_raster_host_{digest}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int
        lib.vp_render_colors.argtypes = [f32, i32, f32, c_int, c_int, c_int,
                                         c_int, u8, u8, f32]
        lib.vp_rasterize_triangles.argtypes = [f32, i32, c_int, c_int,
                                               c_int, f32, i32, f32]
        lib.vp_vertex_normals.argtypes = [f32, i32, c_int, f32]
        lib.vp_render_texture.argtypes = [f32, i32, f32, f32, i32, c_int,
                                          c_int, c_int, c_int, c_int, c_int,
                                          c_int, f32, f32]
        for fn in (lib.vp_render_colors, lib.vp_rasterize_triangles,
                   lib.vp_vertex_normals, lib.vp_render_texture):
            fn.restype = None
        _lib = lib
        return lib


def _tri(triangles: np.ndarray, num_vertices: int) -> np.ndarray:
    """0-based int32 triangles, checked against the vertex count: the C
    code trusts them."""
    t = np.ascontiguousarray(triangles, np.int32)
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"triangles must be [F, 3], got {t.shape}")
    if t.size and (t.min() < 0 or t.max() >= num_vertices):
        raise ValueError(f"triangle indices out of [0, {num_vertices})")
    return t


def render_colors_native(vertices: np.ndarray, triangles: np.ndarray,
                         colors: np.ndarray, h: int, w: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """vertices [V,3], triangles [F,3] 0-based, colors [V,C] ->
    (image [h,w,C] u8, mask [h,w] u8)."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    t = _tri(triangles, v.shape[0])
    col = np.ascontiguousarray(colors, np.float32)
    if col.shape[0] != v.shape[0]:
        raise ValueError("one color row per vertex")
    c = col.shape[1]
    image = np.zeros((h, w, c), np.uint8)
    mask = np.zeros((h, w), np.uint8)
    depth = np.full((h, w), DEPTH_INIT, np.float32)
    lib.vp_render_colors(v.reshape(-1), t.reshape(-1), col.reshape(-1),
                         t.shape[0], h, w, c, image.reshape(-1),
                         mask.reshape(-1), depth.reshape(-1))
    return image, mask


def rasterize_triangles_native(vertices: np.ndarray, triangles: np.ndarray,
                               h: int, w: int):
    """-> (depth [h,w], triangle id [h,w] (-1: none), barycentric weights
    [h,w,3])."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    t = _tri(triangles, v.shape[0])
    depth = np.full((h, w), DEPTH_INIT, np.float32)
    tri_buf = np.full((h, w), -1, np.int32)
    weights = np.zeros((h, w, 3), np.float32)
    lib.vp_rasterize_triangles(v.reshape(-1), t.reshape(-1), t.shape[0],
                               h, w, depth.reshape(-1),
                               tri_buf.reshape(-1), weights.reshape(-1))
    return depth, tri_buf, weights


def vertex_normals_native(tri_normal: np.ndarray, triangles: np.ndarray,
                          num_vertices: int) -> np.ndarray:
    """Per-vertex sums of the adjacent triangles' normals [V, 3]."""
    lib = _load()
    tn = np.ascontiguousarray(tri_normal, np.float32)
    t = _tri(triangles, num_vertices)
    if tn.shape != (t.shape[0], 3):
        raise ValueError("one normal row per triangle")
    out = np.zeros((num_vertices, 3), np.float32)
    lib.vp_vertex_normals(tn.reshape(-1), t.reshape(-1), t.shape[0],
                          out.reshape(-1))
    return out


def render_texture_native(vertices: np.ndarray, triangles: np.ndarray,
                          texture: np.ndarray, tex_coords: np.ndarray,
                          tex_triangles: np.ndarray, h: int, w: int,
                          bilinear: bool = True):
    """UV-textured render -> (image [h,w,C] float32, depth [h,w])."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    t = _tri(triangles, v.shape[0])
    tex = np.ascontiguousarray(texture, np.float32)
    tc = np.ascontiguousarray(tex_coords[:, :2], np.float32)
    tt = _tri(tex_triangles, tc.shape[0])
    if tt.shape != t.shape:
        raise ValueError("one texture triangle per mesh triangle")
    c = tex.shape[2]
    image = np.zeros((h, w, c), np.float32)
    depth = np.full((h, w), DEPTH_INIT, np.float32)
    lib.vp_render_texture(v.reshape(-1), t.reshape(-1), tex.reshape(-1),
                          tc.reshape(-1), tt.reshape(-1), t.shape[0], h, w,
                          c, tex.shape[0], tex.shape[1],
                          1 if bilinear else 0, image.reshape(-1),
                          depth.reshape(-1))
    return image, depth
