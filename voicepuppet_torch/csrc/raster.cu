// Flat-shaded z-buffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernel voicepuppet_tpu/ops/raster_pallas.py:_raster_kernel
// (K1, and its x-band mode K2, which computes the same output).  The TPU
// kernel walks triangles in index order over a VMEM-resident depth window;
// windows, 8-aligned origins, frame interleave and 128-lane x-bands are
// TPU layout devices and none of them carries over.  What it computes is
// the sequential C++ rule (mesh_core.cpp:169-231): depth init -99999, strict
// '>', so the first triangle at a depth wins.  That rule is equivalent to an
// order-free one (face3d/raster.py): per pixel, the maximum depth among the
// covering triangles, then the minimum triangle id at that depth.
//
// Design:
//   pass 1  one thread per (frame, triangle) builds the setup (p0, edge
//           vectors, dot products, inv_deno) in the operation order of
//           face3d/raster_ref.py:_point_in_tri and walks its clipped integer
//           bbox; every covered pixel does one 64-bit atomicMax of
//           (orderable(depth) << 32) | (0xFFFFFFFF - tri) into a [B,h,w]
//           uint64 scratch buffer.  The max of that key is the (max depth,
//           min id) winner, so the result does not depend on the order the
//           atomics land in.  -0.0 is made +0.0 first, because the key
//           orders them while '>' does not.
//   pass 2  one thread per pixel unpacks the key into winner/depth and, when
//           colours are given, gathers the flat colour with the C++
//           truncation floor((floor(c0)+floor(c1)+floor(c2))/3) into a uint8
//           image and a 0/255 mask (raster_pallas.py:_flat_color_image).
// Every float operation of the setup and the inside test is written with
// the _rn intrinsics, so nvcc cannot contract it into an FMA: the inside
// test rounds exactly as the float32 reference does.  (Device FMA flipped
// 1-6 borderline pixels per ~27k on the TPU.)
//
// Bound on an H100 (per chunk of 32 frames at 224², 35,721 vertices,
// 70,688 triangles): the function reads ~13.7 MB of vertices and 0.85 MB of
// triangles, plus, for the image, the colours of the winning triangles'
// corners only (at most 13.7 MB; pass 2 reads no other), and writes 12.8 MB
// of winner/depth or 6.4 MB of image/mask; the 12.8 MB scratch stays in the
// 50 MB L2.  That is under 10 us at 3.35 TB/s (chip_smoke.py computes the
// bound from each run's winners).  The practical limit is L2 atomic
// throughput over 32 x 70,688 x (covered px per triangle) atomics.  A later
// PR may replace the global atomics with a tile-binned shared-memory
// z-buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDepthInit = -99999.0f;

__device__ __forceinline__ uint32_t orderable(float d) {
  uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  uint32_t b = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(b);
}

__global__ void raster_kernel(const float* __restrict__ verts,
                              const int* __restrict__ tris, int B, int V,
                              int F, int H, int W,
                              unsigned long long* __restrict__ zbuf) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx - (long long)b * F);
  const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
  // indices are range-checked where the topology is made (morph.device_bfm);
  // a triangle outside [0, V) is skipped rather than read out of bounds
  if ((unsigned)i0 >= (unsigned)V || (unsigned)i1 >= (unsigned)V ||
      (unsigned)i2 >= (unsigned)V)
    return;
  const float* vb = verts + (size_t)b * V * 3;
  const float p0x = vb[3 * i0], p0y = vb[3 * i0 + 1], z0 = vb[3 * i0 + 2];
  const float p1x = vb[3 * i1], p1y = vb[3 * i1 + 1], z1 = vb[3 * i1 + 2];
  const float p2x = vb[3 * i2], p2y = vb[3 * i2 + 1], z2 = vb[3 * i2 + 2];

  // flat depth = jnp.mean(z): the sum in order times fl(1/3), as XLA
  // evaluates the mean
  float depth = __fmul_rn(__fadd_rn(__fadd_rn(z0, z1), z2), 1.0f / 3.0f);
  if (!(depth > kDepthInit)) return;          // also drops NaN depth
  if (depth == 0.0f) depth = 0.0f;            // -0.0 -> +0.0
  if (!(isfinite(p0x) && isfinite(p0y) && isfinite(p1x) && isfinite(p1y) &&
        isfinite(p2x) && isfinite(p2y)))
    return;

  const float xmn = fmaxf(ceilf(fminf(fminf(p0x, p1x), p2x)), 0.0f);
  const float xmx = fminf(floorf(fmaxf(fmaxf(p0x, p1x), p2x)), W - 1.0f);
  const float ymn = fmaxf(ceilf(fminf(fminf(p0y, p1y), p2y)), 0.0f);
  const float ymx = fminf(floorf(fmaxf(fmaxf(p0y, p1y), p2y)), H - 1.0f);
  if (!(xmx >= xmn) || !(ymx >= ymn)) return;

  const float v0x = __fsub_rn(p2x, p0x), v0y = __fsub_rn(p2y, p0y);
  const float v1x = __fsub_rn(p1x, p0x), v1y = __fsub_rn(p1y, p0y);
  const float dot00 = __fadd_rn(__fmul_rn(v0x, v0x), __fmul_rn(v0y, v0y));
  const float dot01 = __fadd_rn(__fmul_rn(v0x, v1x), __fmul_rn(v0y, v1y));
  const float dot11 = __fadd_rn(__fmul_rn(v1x, v1x), __fmul_rn(v1y, v1y));
  const float deno = __fsub_rn(__fmul_rn(dot00, dot11),
                               __fmul_rn(dot01, dot01));
  // degenerate triangle: inv_deno = 0 -> u = v = 0 over the whole bbox
  const float inv = (deno == 0.0f) ? 0.0f : __fdiv_rn(1.0f, deno);

  const unsigned long long key =
      ((unsigned long long)orderable(depth) << 32) |
      (unsigned long long)(0xFFFFFFFFu - (uint32_t)f);
  unsigned long long* zb = zbuf + (size_t)b * H * W;
  const int x0 = (int)xmn, x1 = (int)xmx, y0 = (int)ymn, y1 = (int)ymx;
  for (int y = y0; y <= y1; ++y) {
    const float py = __fsub_rn((float)y, p0y);
    for (int x = x0; x <= x1; ++x) {
      const float px = __fsub_rn((float)x, p0x);
      const float dot02 = __fadd_rn(__fmul_rn(v0x, px), __fmul_rn(v0y, py));
      const float dot12 = __fadd_rn(__fmul_rn(v1x, px), __fmul_rn(v1y, py));
      const float u = __fmul_rn(__fsub_rn(__fmul_rn(dot11, dot02),
                                          __fmul_rn(dot01, dot12)), inv);
      const float v = __fmul_rn(__fsub_rn(__fmul_rn(dot00, dot12),
                                          __fmul_rn(dot01, dot02)), inv);
      if (u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) < 1.0f)
        atomicMax(zb + (size_t)y * W + x, key);
    }
  }
}

__global__ void resolve_kernel(const unsigned long long* __restrict__ zbuf,
                               const int* __restrict__ tris,
                               const float* __restrict__ colors, int B,
                               int V, int F, int C, int H, int W,
                               int* __restrict__ winner,
                               float* __restrict__ depth,
                               unsigned char* __restrict__ image,
                               unsigned char* __restrict__ mask) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * H * W) return;
  const unsigned long long key = zbuf[idx];
  const bool covered = key != 0ull;
  const int f = covered ? (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull))
                        : F;
  if (winner) winner[idx] = f;
  if (depth) depth[idx] = covered ? from_orderable((uint32_t)(key >> 32))
                                  : kDepthInit;
  if (!image) return;
  mask[idx] = covered ? 255 : 0;
  unsigned char* px = image + idx * C;
  if (!covered) {
    for (int c = 0; c < C; ++c) px[c] = 0;
    return;
  }
  const int b = (int)(idx / ((long long)H * W));
  const float* cb = colors + (size_t)b * V * C;
  const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
  for (int c = 0; c < C; ++c) {
    const float s = __fadd_rn(__fadd_rn(floorf(cb[i0 * C + c]),
                                        floorf(cb[i1 * C + c])),
                              floorf(cb[i2 * C + c]));
    px[c] = (unsigned char)(int)floorf(__fdiv_rn(s, 3.0f));
  }
}

}  // namespace

// vertices [B,V,3] f32, triangles [F,3] i32, colors [B,V,C] f32 or null;
// zbuf [B,H,W] u64 scratch; winner/depth [B,H,W] or null; image [B,H,W,C]
// u8 and mask [B,H,W] u8 or null.  Launches on `stream`, returns
// cudaGetLastError() (0 on success).
extern "C" int vp_raster_flat(const float* vertices, const int* triangles,
                              const float* colors, int B, int V, int F,
                              int C, int H, int W, void* zbuf, int* winner,
                              float* depth, unsigned char* image,
                              unsigned char* mask, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* z = (unsigned long long*)zbuf;
  cudaError_t err = cudaMemsetAsync(z, 0, sizeof(unsigned long long) *
                                              (size_t)B * H * W, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long nt = (long long)B * F;
  if (nt > 0) {
    raster_kernel<<<(unsigned)((nt + threads - 1) / threads), threads, 0, s>>>(
        vertices, triangles, B, V, F, H, W, z);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long np = (long long)B * H * W;
  if (np > 0) {
    resolve_kernel<<<(unsigned)((np + threads - 1) / threads), threads, 0,
                     s>>>(z, triangles, colors, B, V, F, C, H, W, winner,
                          depth, image, mask);
  }
  return (int)cudaGetLastError();
}
