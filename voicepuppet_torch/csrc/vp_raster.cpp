// The port's native host rasterizer: its own copy of native/vp_raster.cpp.
//
// Fresh C++ implementation of the z-buffer triangle rasterization the
// reference ships as a Cython extension (utils/cython/mesh_core.cpp).
// Behavioral spec: voicepuppet_torch/face3d/raster_ref.py (flat-shaded
// color/depth as vertex means with integer truncation, strict > depth
// test against a caller-initialized buffer, barycentric inside test that
// accepts degenerate triangles, 2px border override for the
// triangle-id/texture variants).
//
// Host-side only: data-prep tooling and a second oracle for the raster
// kernels.  Exported with C linkage for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, into build/ at the first call
// of voicepuppet_torch/face3d/raster_native.py.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

struct Bary {
  // Barycentric solve via the classic dot-product method
  // (http://blackpawn.com/texts/pointinpoly/), precomputed per triangle.
  float ax, ay;          // anchor vertex
  float e0x, e0y;        // v2 - v0
  float e1x, e1y;        // v1 - v0
  float d00, d01, d11;
  float inv_den;         // 0 for degenerate triangles

  void setup(const float* v0, const float* v1, const float* v2) {
    ax = v0[0]; ay = v0[1];
    e0x = v2[0] - v0[0]; e0y = v2[1] - v0[1];
    e1x = v1[0] - v0[0]; e1y = v1[1] - v0[1];
    d00 = e0x * e0x + e0y * e0y;
    d01 = e0x * e1x + e0y * e1y;
    d11 = e1x * e1x + e1y * e1y;
    const float den = d00 * d11 - d01 * d01;
    inv_den = (den == 0.0f) ? 0.0f : 1.0f / den;
  }

  inline void uv(float px, float py, float* u, float* v) const {
    const float dx = px - ax, dy = py - ay;
    const float d02 = e0x * dx + e0y * dy;
    const float d12 = e1x * dx + e1y * dy;
    *u = (d11 * d02 - d01 * d12) * inv_den;
    *v = (d00 * d12 - d01 * d02) * inv_den;
  }

  inline bool inside(float px, float py) const {
    float u, v;
    uv(px, py, &u, &v);
    return u >= 0.0f && v >= 0.0f && (u + v) < 1.0f;
  }
};

struct BBox {
  int x0, x1, y0, y1;
  bool empty;
  void clip(const float* v0, const float* v1, const float* v2,
            int h, int w) {
    const float xmin = std::min(v0[0], std::min(v1[0], v2[0]));
    const float xmax = std::max(v0[0], std::max(v1[0], v2[0]));
    const float ymin = std::min(v0[1], std::min(v1[1], v2[1]));
    const float ymax = std::max(v0[1], std::max(v1[1], v2[1]));
    x0 = std::max((int)std::ceil(xmin), 0);
    x1 = std::min((int)std::floor(xmax), w - 1);
    y0 = std::max((int)std::ceil(ymin), 0);
    y1 = std::min((int)std::floor(ymax), h - 1);
    empty = (x1 < x0) || (y1 < y0);
  }
};

}  // namespace

extern "C" {

// Flat-shaded color render (spec: raster_ref.render_colors_ref).
// vertices [nver*3] (x,y,depth), triangles [ntri*3] 0-based,
// colors [nver*c] (integral values as floats).
// image [h*w*c] u8, mask [h*w] u8, depth [h*w] caller-initialized.
void vp_render_colors(const float* vertices, const int32_t* triangles,
                      const float* colors, int ntri, int h, int w, int c,
                      uint8_t* image, uint8_t* mask, float* depth) {
  for (int t = 0; t < ntri; ++t) {
    const int32_t ia = triangles[3 * t];
    const int32_t ib = triangles[3 * t + 1];
    const int32_t ic = triangles[3 * t + 2];
    const float* va = vertices + 3 * ia;
    const float* vb = vertices + 3 * ib;
    const float* vc = vertices + 3 * ic;

    BBox box;
    box.clip(va, vb, vc, h, w);
    if (box.empty) continue;

    const float tri_depth = (va[2] + vb[2] + vc[2]) / 3.0f;
    Bary bary;
    bary.setup(va, vb, vc);

    for (int y = box.y0; y <= box.y1; ++y) {
      float* drow = depth + y * w;
      for (int x = box.x0; x <= box.x1; ++x) {
        if (tri_depth > drow[x] && bary.inside((float)x, (float)y)) {
          uint8_t* px = image + (y * w + x) * c;
          for (int k = 0; k < c; ++k) {
            const float sum = colors[c * ia + k] + colors[c * ib + k] +
                              colors[c * ic + k];
            px[k] = (uint8_t)((int)sum / 3);
          }
          mask[y * w + x] = 255;
          drow[x] = tri_depth;
        }
      }
    }
  }
}

// Triangle-id + barycentric raster (spec: rasterize_triangles_ref):
// interpolated depth, 2px border override, weights written per win.
void vp_rasterize_triangles(const float* vertices,
                            const int32_t* triangles, int ntri, int h,
                            int w, float* depth, int32_t* tri_buf,
                            float* weights) {
  for (int t = 0; t < ntri; ++t) {
    const int32_t ia = triangles[3 * t];
    const int32_t ib = triangles[3 * t + 1];
    const int32_t ic = triangles[3 * t + 2];
    const float* va = vertices + 3 * ia;
    const float* vb = vertices + 3 * ib;
    const float* vc = vertices + 3 * ic;

    BBox box;
    box.clip(va, vb, vc, h, w);
    if (box.empty) continue;

    Bary bary;
    bary.setup(va, vb, vc);

    for (int y = box.y0; y <= box.y1; ++y) {
      for (int x = box.x0; x <= box.x1; ++x) {
        const bool border = x < 2 || x > w - 3 || y < 2 || y > h - 3;
        if (!border && !bary.inside((float)x, (float)y)) continue;
        float u, v;
        bary.uv((float)x, (float)y, &u, &v);
        const float w0 = 1.0f - u - v;
        const float d = w0 * va[2] + v * vb[2] + u * vc[2];
        const int idx = y * w + x;
        if (d > depth[idx]) {
          depth[idx] = d;
          tri_buf[idx] = t;
          weights[idx * 3] = w0;
          weights[idx * 3 + 1] = v;
          weights[idx * 3 + 2] = u;
        }
      }
    }
  }
}

// One-ring scatter-add of per-triangle normals onto vertices
// (spec: vertex_normals_ref).
void vp_vertex_normals(const float* tri_normal, const int32_t* triangles,
                       int ntri, float* out) {
  for (int t = 0; t < ntri; ++t) {
    const float nx = tri_normal[3 * t];
    const float ny = tri_normal[3 * t + 1];
    const float nz = tri_normal[3 * t + 2];
    for (int k = 0; k < 3; ++k) {
      const int32_t vi = triangles[3 * t + k];
      out[3 * vi] += nx;
      out[3 * vi + 1] += ny;
      out[3 * vi + 2] += nz;
    }
  }
}

// UV-textured raster: nearest (mapping 0) or bilinear (1) sampling with
// interpolated depth + border override.  Texture coords indexed through
// tex_triangles for BOTH axes (the reference mixes mesh/texture indices
// for the V axis — a bug deliberately not reproduced; see
// voicepuppet_tpu/face3d/raster.py module docstring).
void vp_render_texture(const float* vertices, const int32_t* triangles,
                       const float* texture, const float* tex_coords,
                       const int32_t* tex_triangles, int ntri, int h,
                       int w, int c, int tex_h, int tex_w, int mapping,
                       float* image, float* depth) {
  for (int t = 0; t < ntri; ++t) {
    const int32_t ia = triangles[3 * t];
    const int32_t ib = triangles[3 * t + 1];
    const int32_t ic = triangles[3 * t + 2];
    const float* va = vertices + 3 * ia;
    const float* vb = vertices + 3 * ib;
    const float* vc = vertices + 3 * ic;
    const float* ta = tex_coords + 2 * tex_triangles[3 * t];
    const float* tb = tex_coords + 2 * tex_triangles[3 * t + 1];
    const float* tc = tex_coords + 2 * tex_triangles[3 * t + 2];

    BBox box;
    box.clip(va, vb, vc, h, w);
    if (box.empty) continue;

    Bary bary;
    bary.setup(va, vb, vc);

    for (int y = box.y0; y <= box.y1; ++y) {
      for (int x = box.x0; x <= box.x1; ++x) {
        const bool border = x < 2 || x > w - 3 || y < 2 || y > h - 3;
        if (!border && !bary.inside((float)x, (float)y)) continue;
        float u, v;
        bary.uv((float)x, (float)y, &u, &v);
        const float w0 = 1.0f - u - v;
        const float d = w0 * va[2] + v * vb[2] + u * vc[2];
        const int idx = y * w + x;
        if (d <= depth[idx]) continue;
        depth[idx] = d;

        float tx = w0 * ta[0] + v * tb[0] + u * tc[0];
        float ty = w0 * ta[1] + v * tb[1] + u * tc[1];
        tx = std::max(std::min(tx, (float)(tex_w - 1)), 0.0f);
        ty = std::max(std::min(ty, (float)(tex_h - 1)), 0.0f);

        float* px = image + idx * c;
        if (mapping == 0) {  // nearest
          const int sx = (int)std::lround(tx);
          const int sy = (int)std::lround(ty);
          const float* sp = texture + (sy * tex_w + sx) * c;
          for (int k = 0; k < c; ++k) px[k] = sp[k];
        } else {  // bilinear
          const int x0i = (int)std::floor(tx), x1i = (int)std::ceil(tx);
          const int y0i = (int)std::floor(ty), y1i = (int)std::ceil(ty);
          const float fx = tx - x0i, fy = ty - y0i;
          const float* ul = texture + (y0i * tex_w + x0i) * c;
          const float* ur = texture + (y0i * tex_w + x1i) * c;
          const float* dl = texture + (y1i * tex_w + x0i) * c;
          const float* dr = texture + (y1i * tex_w + x1i) * c;
          for (int k = 0; k < c; ++k) {
            px[k] = ul[k] * (1 - fx) * (1 - fy) + ur[k] * fx * (1 - fy) +
                    dl[k] * (1 - fx) * fy + dr[k] * fx * fy;
          }
        }
      }
    }
  }
}

}  // extern "C"
