// Z-buffer rasterizers for Hopper (sm_90a).
//
// Replaces the TPU kernels of voicepuppet_tpu/ops/raster_pallas.py:
//   K1 _raster_kernel (and its x-band mode K2, which computes the same
//      output): flat depth, the winner and depth buffers, the flat colour;
//   K4 _raster_kernel_grouped: K1 with G consecutive triangles merged in
//      registers before one read-modify-write;
//   K3 _raster_kernel_interp: winner plus the barycentric-interpolated
//      per-pixel depth (1-u-v)*z0 + v*z1 + u*z2, and a 2-px canvas border
//      that passes the inside test unconditionally inside the clipped bbox
//      (mesh_core.cpp:108-166, 148);
//   K5 _raster_kernel_interp_grouped: K3 merged per group, as K4 is K1;
// and the raster A/B probes of experiments/ (X1 _kernel_b, X2
// _kernel_unroll, X3 _regacc_kernel; near the end, behind vp_raster_probe).
// The TPU kernels walk triangles in index order over a VMEM-resident depth
// window; windows, 8-aligned origins, frame interleave and 128-lane x-bands
// are TPU layout devices and none of them carries over.  What they compute
// is the sequential C++ rule (mesh_core.cpp:108-231): depth init -99999,
// strict '>', so the first triangle at a depth wins.  That rule equals an
// order-free one (face3d/raster.py): per pixel, the maximum depth among the
// covering fragments, then the minimum triangle id at that depth.
//
// Design:
//   pass 1  every fragment that passes makes one 64-bit atomicMax of
//           (orderable(depth) << 32) | (0xFFFFFFFF - tri) into a [B,h,w]
//           uint64 scratch buffer.  The max of that key is the (max depth,
//           min id) winner, so the result does not depend on the order the
//           atomics land in.  -0.0 is made +0.0 first, because the key
//           orders them while '>' does not; NaN and depths <= -99999 never
//           draw.
//             per-triangle (K1, K3): lane j of a warp takes the (frame,
//           triangle) entry first + j of the flat order b * F + f, builds
//           its setup (p0, edge vectors, dot products, inv_deno, in the
//           operation order of face3d/raster_ref.py:_point_in_tri) and stores
//           it, with its bbox's magic number and its frame's offset, into the
//           warp's shared slot j as five 16-byte words.  The warp scans the 32
//           clipped bbox areas (0 for an entry that cannot draw) with
//           shuffles, and then walks all 32 bboxes as one list of sum(area)
//           pixels, 32 adjacent ones a step: lane j takes pixel r = base + j,
//           finds its owner slot by a binary search over the 32 sums (5
//           shared loads), loads the owner's slot (5 128-bit loads), and
//           finds (x, y) from the row-major position q in the owner's bbox by
//           one __umulhi with the magic number and one correction (no
//           division per pixel).  A warp takes ceil(sum(area) / 32) steps.
//             What bounds it: the earlier form gave each entry one thread
//           that walked its bbox alone, so a warp took as long as its
//           largest bbox; on the 189² mesh at 224² (bbox 4.8 px on average,
//           54 at most) lanes did useful work in 31% of its steps, and the
//           balanced walk takes 2.9x fewer.  Each step now pays the owner
//           search, the slot loads and the mapping besides pixel_key, about
//           twice the old step's work, so the walk gains less than 2.9x.
//           The setup (index and vertex loads, the IEEE 1/deno, the magic
//           number's division, the scan) is a fixed cost the walk does not
//           touch, and the atomics cost little: on an H100, a setup-only
//           form of this kernel took a large share of pass 1, and a form
//           with one atomic per thread instead of one per fragment was no
//           faster (one-off A/Bs; PERF.md).  Pass 1 of K1 takes ~0.05
//           ms per chunk of 32 frames at 224² on an H100 80GB HBM3 at 700 W,
//           the whole call (memset, pass 1, resolve) ~0.07-0.08 ms
//           (chip_smoke.py; PERF.md).  The hazards, each marked where it
//           sits: a warp leaves early only when all its entries are past
//           B x F (the scan takes the full mask); a warp's entries may
//           straddle frames, so each slot carries its own frame's offset;
//           the sums are 32-bit, which the wrapper's limit
//           max(B, 32) x H x W < 2^31 keeps from overflowing.
//             grouped (K4, K5): one T-lane tile per (frame, group of G
//           consecutive triangles), T the smallest power of two >=
//           min(G, 32), 32/T tiles per warp.  Lane k of a tile builds member
//           k's setup into the warp's shared slots; the tile reduces its
//           union bbox with log2(T) shuffles and its T lanes walk it, each
//           merging the members at its pixel in id order with a strict '>'
//           of the key before one atomicMax (at T <= 8 the members' bboxes
//           are shuffled into registers first, so the per-pixel bbox tests
//           wait on no shared-memory load).  When the union is far larger
//           than the members' bboxes together (a scattered triangle order),
//           the tile walks each member's bbox instead.  The max of the keys
//           does not depend on that choice, so both walks give K1's (K3's)
//           output bit for bit.  At T = 32 a group of more than 32 triangles
//           is taken 32 members at a time, one atomicMax per pixel per batch.
//             What bounds it: a warp's fixed cost (dependent index and vertex
//           loads, the shuffles, the ballot) against the work it is given.
//           The earlier form gave each group a whole warp: at G = 4 only
//           four lanes loaded and built a setup, and the union bbox of the
//           189² mesh at 224² (11.2 px on average) left ~21 of 32 lanes idle
//           in its walk, so B x F/4 warps took ~67 waves of the card against
//           K1's ~8.4.  The tiles give the warp K1's count (B x F / 32 at
//           every G <= 32), every lane a setup, and a walk that fits the
//           union, while the merge still saves atomics.  What is left is the
//           walk's per-pixel member tests (G bbox tests and ~1.7 inside
//           tests per union pixel at G = 4), so a larger G costs more per
//           pixel; on an H100 at 700 W K4 at G = 4 takes ~1.3x K1
//           (chip_smoke.py; PERF.md).  The hazards, each
//           marked where it sits: a warp leaves early only when all its
//           tiles are past B x ngroups (the shuffles take the full mask);
//           one warp's tiles may straddle frames, so each tile finds its own
//           frame; __ffs over a tile's live mask indexes that tile's slots;
//           the __syncwarp before a next 32-member batch stays where it was.
//   pass 2  one thread per pixel unpacks the key into winner/depth and, when
//           colours are given, gathers the flat colour with the C++
//           truncation floor((floor(c0)+floor(c1)+floor(c2))/3) into a uint8
//           image and a 0/255 mask (raster_pallas.py:_flat_color_image).
// Every float operation of the setup, the inside test and the interpolated
// depth is written with the _rn intrinsics, so nvcc cannot contract it into
// an FMA: each rounds exactly as the unfused float32 order of the kernels'
// source expressions (raster_pallas.py:181-190, 750), which the plain
// version (face3d/raster.py) computes too.  (Device FMA flipped 1-6
// borderline pixels per ~27k on the TPU.)
//
// Bound on an H100 (per chunk of 32 frames at 224², 35,721 vertices,
// 70,688 triangles): the function reads ~13.7 MB of vertices and 0.85 MB of
// triangles, plus, for the image, the colours of the winning triangles'
// corners only, and writes 12.8 MB of winner/depth or 6.4 MB of image/mask;
// the 12.8 MB scratch stays in the 50 MB L2.  That is about 10 us at
// 3.35 TB/s (chip_smoke.py computes the bound from each run's inputs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDepthInit = -99999.0f;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint32_t orderable(float d) {
  uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  uint32_t b = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(b);
}

// Per-triangle constants.  `key` is the whole fragment key for the flat
// kernels (one depth per triangle) and only its id bits for the interpolated
// ones.
struct Tri {
  float p0x, p0y, v0x, v0y, v1x, v1y, dot00, dot01, dot11, inv;
  float z0, z1, z2;
  int x0, x1, y0, y1;
  unsigned long long key;
};

// Builds triangle f of one frame; false if it can never draw.
template <bool INTERP>
__device__ __forceinline__ bool tri_setup(const float* __restrict__ vb,
                                          const int* __restrict__ tris,
                                          int f, int V, int H, int W,
                                          Tri& t) {
  const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
  // indices are range-checked where the topology is made (morph.device_bfm);
  // a triangle outside [0, V) is skipped rather than read out of bounds
  if ((unsigned)i0 >= (unsigned)V || (unsigned)i1 >= (unsigned)V ||
      (unsigned)i2 >= (unsigned)V)
    return false;
  const float p0x = vb[3 * i0], p0y = vb[3 * i0 + 1], z0 = vb[3 * i0 + 2];
  const float p1x = vb[3 * i1], p1y = vb[3 * i1 + 1], z1 = vb[3 * i1 + 2];
  const float p2x = vb[3 * i2], p2y = vb[3 * i2 + 1], z2 = vb[3 * i2 + 2];
  const unsigned long long id_bits =
      (unsigned long long)(0xFFFFFFFFu - (uint32_t)f);
  if (INTERP) {
    t.z0 = z0;
    t.z1 = z1;
    t.z2 = z2;
    t.key = id_bits;
  } else {
    // flat depth = jnp.mean(z): the sum in order times fl(1/3), as XLA
    // evaluates the mean
    float depth = __fmul_rn(__fadd_rn(__fadd_rn(z0, z1), z2), 1.0f / 3.0f);
    if (!(depth > kDepthInit)) return false;  // also drops NaN depth
    if (depth == 0.0f) depth = 0.0f;          // -0.0 -> +0.0
    t.key = ((unsigned long long)orderable(depth) << 32) | id_bits;
  }
  if (!(isfinite(p0x) && isfinite(p0y) && isfinite(p1x) && isfinite(p1y) &&
        isfinite(p2x) && isfinite(p2y)))
    return false;

  const float xmn = fmaxf(ceilf(fminf(fminf(p0x, p1x), p2x)), 0.0f);
  const float xmx = fminf(floorf(fmaxf(fmaxf(p0x, p1x), p2x)), W - 1.0f);
  const float ymn = fmaxf(ceilf(fminf(fminf(p0y, p1y), p2y)), 0.0f);
  const float ymx = fminf(floorf(fmaxf(fmaxf(p0y, p1y), p2y)), H - 1.0f);
  if (!(xmx >= xmn) || !(ymx >= ymn)) return false;
  t.x0 = (int)xmn;
  t.x1 = (int)xmx;
  t.y0 = (int)ymn;
  t.y1 = (int)ymx;

  t.p0x = p0x;
  t.p0y = p0y;
  t.v0x = __fsub_rn(p2x, p0x);
  t.v0y = __fsub_rn(p2y, p0y);
  t.v1x = __fsub_rn(p1x, p0x);
  t.v1y = __fsub_rn(p1y, p0y);
  t.dot00 = __fadd_rn(__fmul_rn(t.v0x, t.v0x), __fmul_rn(t.v0y, t.v0y));
  t.dot01 = __fadd_rn(__fmul_rn(t.v0x, t.v1x), __fmul_rn(t.v0y, t.v1y));
  t.dot11 = __fadd_rn(__fmul_rn(t.v1x, t.v1x), __fmul_rn(t.v1y, t.v1y));
  const float deno = __fsub_rn(__fmul_rn(t.dot00, t.dot11),
                               __fmul_rn(t.dot01, t.dot01));
  // degenerate triangle: inv_deno = 0 -> u = v = 0 over the whole bbox
  t.inv = (deno == 0.0f) ? 0.0f : __fdiv_rn(1.0f, deno);
  return true;
}

// The fragment key of triangle t at pixel (x, y) inside its bbox, 0 if the
// fragment does not draw.
template <bool INTERP>
__device__ __forceinline__ unsigned long long pixel_key(const Tri& t, int x,
                                                        int y, int H,
                                                        int W) {
  const float px = __fsub_rn((float)x, t.p0x);
  const float py = __fsub_rn((float)y, t.p0y);
  const float dot02 = __fadd_rn(__fmul_rn(t.v0x, px), __fmul_rn(t.v0y, py));
  const float dot12 = __fadd_rn(__fmul_rn(t.v1x, px), __fmul_rn(t.v1y, py));
  const float u = __fmul_rn(__fsub_rn(__fmul_rn(t.dot11, dot02),
                                      __fmul_rn(t.dot01, dot12)), t.inv);
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(t.dot00, dot12),
                                      __fmul_rn(t.dot01, dot02)), t.inv);
  const bool inside = u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) < 1.0f;
  if (!INTERP) return inside ? t.key : 0ull;
  const bool border = x < 2 || x > W - 3 || y < 2 || y > H - 3;
  if (!(inside || border)) return 0ull;
  // weight[0] = 1-u-v -> p0, weight[1] = v -> p1, weight[2] = u -> p2,
  // summed left to right (raster_pallas.py:750)
  float pd = __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(__fsub_rn(1.0f, u), v),
                                           t.z0),
                                 __fmul_rn(v, t.z1)),
                       __fmul_rn(u, t.z2));
  if (!(pd > kDepthInit)) return 0ull;        // also drops NaN depth
  if (pd == 0.0f) pd = 0.0f;                  // -0.0 -> +0.0
  return ((unsigned long long)orderable(pd) << 32) | t.key;
}

constexpr int kWalkWarps = 8;   // triangle_kernel's warps per block

// One walk slot in shared memory: what the balanced walk reads of an entry,
// as five 16-byte words, so a lane stores it with five 128-bit stores and
// the walk loads it with five 128-bit loads (a Tri stored field by field at
// its 80-byte stride would take four-way bank-conflicted stores).
struct WalkSlot {
  float4 w0;   // p0x, p0y, v0x, v0y
  float4 w1;   // v1x, v1y, dot00, dot01
  float4 w2;   // dot11, inv, z0, z1
  float4 w3;   // z2, x0, x1, y0 (ints as bits)
  float4 w4;   // magic, frame offset, key low, key high (bits)
};

// magic = floor((2^32 - 1) / w) + 1 for the bbox width w (0 at w = 1);
// `off` = b * H * W, the key-buffer offset of the entry's frame.
__device__ __forceinline__ void store_slot(WalkSlot& s, const Tri& t,
                                           unsigned magic, int off) {
  s.w0 = make_float4(t.p0x, t.p0y, t.v0x, t.v0y);
  s.w1 = make_float4(t.v1x, t.v1y, t.dot00, t.dot01);
  s.w2 = make_float4(t.dot11, t.inv, t.z0, t.z1);
  s.w3 = make_float4(t.z2, __int_as_float(t.x0), __int_as_float(t.x1),
                     __int_as_float(t.y0));
  s.w4 = make_float4(__uint_as_float(magic), __int_as_float(off),
                     __uint_as_float((uint32_t)t.key),
                     __uint_as_float((uint32_t)(t.key >> 32)));
}

// The Tri that pixel_key reads (all but y1) and the slot's magic and
// frame offset.
__device__ __forceinline__ Tri load_slot(const WalkSlot& s, unsigned& magic,
                                         int& off) {
  const float4 w0 = s.w0, w1 = s.w1, w2 = s.w2, w3 = s.w3, w4 = s.w4;
  Tri t;
  t.p0x = w0.x;
  t.p0y = w0.y;
  t.v0x = w0.z;
  t.v0y = w0.w;
  t.v1x = w1.x;
  t.v1y = w1.y;
  t.dot00 = w1.z;
  t.dot01 = w1.w;
  t.dot11 = w2.x;
  t.inv = w2.y;
  t.z0 = w2.z;
  t.z1 = w2.w;
  t.z2 = w3.x;
  t.x0 = __float_as_int(w3.y);
  t.x1 = __float_as_int(w3.z);
  t.y0 = __float_as_int(w3.w);
  t.y1 = t.y0;   // not stored: pixel_key does not read it
  magic = __float_as_uint(w4.x);
  off = __float_as_int(w4.y);
  t.key = ((unsigned long long)__float_as_uint(w4.w) << 32) |
          __float_as_uint(w4.z);
  return t;
}

// K1/K3: one warp per 32 consecutive (frame, triangle) entries, whose bbox
// pixels its 32 lanes walk together, 32 adjacent pixels a step (header
// note).
template <bool INTERP>
__global__ void __launch_bounds__(32 * kWalkWarps)
triangle_kernel(const float* __restrict__ verts,
                const int* __restrict__ tris, int B, int V, int F, int H,
                int W, unsigned long long* __restrict__ zbuf) {
  __shared__ WalkSlot slots[kWalkWarps][32];
  __shared__ unsigned ends[kWalkWarps][32];    // inclusive sums of areas
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)B * F;
  const long long first = ((long long)blockIdx.x * kWalkWarps + warp) * 32;
  // Scan hazard: only a warp whose first entry is past the end leaves; the
  // scan below takes the full mask, so a lane past the end stays in with
  // area 0.
  if (first >= n) return;
  const long long idx = first + lane;
  unsigned area = 0;
  if (idx < n) {
    // Straddle hazard: a warp's entries may lie in two or more frames, so
    // each slot carries its own frame's key-buffer offset.  idx < B * F <
    // 2^31 (the wrapper): 32-bit arithmetic.
    const int i = (int)idx;
    const int b = i / F;
    const int f = i - b * F;
    Tri t;
    if (tri_setup<INTERP>(verts + (size_t)b * V * 3, tris, f, V, H, W,
                          t)) {
      const int w = t.x1 - t.x0 + 1;
      area = (unsigned)(w * (t.y1 - t.y0 + 1));   // <= H * W
      // floor((2^32 - 1) / w) + 1 wraps to 0 at w = 1 only
      store_slot(slots[warp][lane], t, 0xFFFFFFFFu / (unsigned)w + 1u,
                 b * H * W);
    }
  }
  // Inclusive scan of the areas in 32 bits: one degenerate triangle's bbox
  // may be the whole canvas, but the wrapper admits 32 * H * W < 2^31 only,
  // so a warp's total, and every pixel index r + 32 below, stays < 2^32.
  unsigned end = area;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xFFFFFFFFu, end, d);
    if (lane >= d) end += up;
  }
  ends[warp][lane] = end;
  const unsigned total = __shfl_sync(0xFFFFFFFFu, end, 31);
  __syncwarp();   // the slots and sums are read by every lane below
  const unsigned* e = ends[warp];
  // No shuffle from here on: the last step's lanes past `total` leave.
  for (unsigned r = lane; r < total; r += 32) {
    // the owner: the first slot whose sum exceeds r (a slot that drew
    // nothing adds 0 and is never one); `start` is the sum before it
    int o = 0;
    unsigned start = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned v = e[o + s - 1];
      if (v <= r) {
        o += s;
        start = v;
      }
    }
    unsigned m;
    int off;
    const Tri t = load_slot(slots[warp][o], m, off);
    // row-major position q < w * h of the owner's bbox; with
    // m = floor((2^32 - 1) / w) + 1, umulhi(q, m) is floor(q / w) or one
    // more for every q < 2^31, so one correction makes it exact (unsigned:
    // dy * w may pass 2^31 before it)
    const unsigned q = r - start;
    const unsigned w = (unsigned)(t.x1 - t.x0 + 1);
    int dy = (int)(m ? __umulhi(q, m) : q);
    int dx = (int)(q - (unsigned)dy * w);
    if (dx < 0) {
      --dy;
      dx += (int)w;
    }
    const int x = t.x0 + dx, y = t.y0 + dy;
    const unsigned long long key = pixel_key<INTERP>(t, x, y, H, W);
    if (key) atomicMax(zbuf + off + (size_t)y * W + x, key);
  }
}

// Reductions over the T lanes of one tile (T a power of two; at T = 1 the
// value itself).  Every lane of the warp must call them together.
template <int T>
__device__ __forceinline__ int tile_min(int v) {
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o, T));
  return v;
}

template <int T>
__device__ __forceinline__ int tile_max(int v) {
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o, T));
  return v;
}

template <int T>
__device__ __forceinline__ long long tile_sum(long long v) {
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, o, T);
  return v;
}

// Lane k of a T-lane tile calls f(x, y) at pixels k, k + T, k + 2T, ... of
// the box [x0, x1] x [y0, y1] in row order: one division per walk, none per
// pixel.
template <int T, typename Fn>
__device__ __forceinline__ void tile_walk(int x0, int x1, int y0, int y1,
                                          int k, Fn f) {
  const int w = x1 - x0 + 1;
  const int sy = T / w, sx = T - sy * w;   // T = sy rows + sx columns
  int x = x0 + k % w, y = y0 + k / w;
  while (y <= y1) {
    f(x, y);
    x += sx;
    y += sy;
    if (x > x1) {
      x -= w;
      ++y;
    }
  }
}

// The widest tile whose union walk keeps its members' bboxes in registers
// (4 x T of them).
constexpr int kRegBoxes = 8;

// K4/K5: one T-lane tile per (frame, group of G consecutive triangles), 32/T
// tiles per warp (header note).
template <bool INTERP, int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
group_kernel(const float* __restrict__ verts, const int* __restrict__ tris,
             int B, int V, int F, int G, int H, int W,
             unsigned long long* __restrict__ zbuf) {
  constexpr int kTiles = 32 / T;
  __shared__ Tri members[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = lane / T, k = lane % T;
  const long long ngroups = (F + (long long)G - 1) / G;
  const long long ntiles = (long long)B * ngroups;
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + warp) * kTiles;
  // Only a warp whose first tile is past the end leaves: the tile shuffles
  // below take the full mask, so a tile past the end stays in with no
  // members (n <= 0, ok = false) and walks nothing.
  if (first >= ntiles) return;
  const long long gt = first + tile;
  // Each tile finds its own frame: one warp's tiles may straddle frames.
  int b = 0;
  long long g0 = 0, g1 = 0;
  if (gt < ntiles) {
    b = (int)(gt / ngroups);
    g0 = (gt - (long long)b * ngroups) * G;
    g1 = min(g0 + G, (long long)F);
  }
  const float* vb = verts + (size_t)b * V * 3;
  unsigned long long* zb = zbuf + (size_t)b * H * W;
  // the tile's T member slots; __ffs over the tile's live mask indexes here
  Tri* sm = members[warp] + tile * T;

  // At T < 32 a group has at most T members: one pass.  At T = 32 the warp
  // is one tile, and a group of more than 32 goes 32 members at a time.
  long long base = g0;
  do {
    const int n = (int)min((long long)T, g1 - base);
    bool ok = false;
    if (k < n)
      ok = tri_setup<INTERP>(vb, tris, (int)(base + k), V, H, W, sm[k]);
    // the tile's T bits of the warp's ballot (at T = 32, all of it)
    const unsigned live = (__ballot_sync(0xFFFFFFFFu, ok) >> (tile * T)) &
                          (0xFFFFFFFFu >> (32 - T));
    const Tri& mine = sm[k];
    const int ux0 = tile_min<T>(ok ? mine.x0 : 0x7FFFFFFF);
    const int uy0 = tile_min<T>(ok ? mine.y0 : 0x7FFFFFFF);
    const int ux1 = tile_max<T>(ok ? mine.x1 : -1);
    const int uy1 = tile_max<T>(ok ? mine.y1 : -1);
    const long long area = tile_sum<T>(
        ok ? (long long)(mine.x1 - mine.x0 + 1) * (mine.y1 - mine.y0 + 1)
           : 0ll);
    // At T <= kRegBoxes every lane of the tile takes its members' bboxes
    // into registers (an empty box for a slot that is not live), so the
    // union walk tests them without a chain of shared-memory loads.
    constexpr int R = T <= kRegBoxes ? T : 1;
    int bx0[R], bx1[R], by0[R], by1[R];
    if constexpr (T <= kRegBoxes) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int src = tile * T + j;
        bx0[j] = __shfl_sync(0xFFFFFFFFu, ok ? mine.x0 : 0x7FFFFFFF, src);
        bx1[j] = __shfl_sync(0xFFFFFFFFu, ok ? mine.x1 : -1, src);
        by0[j] = __shfl_sync(0xFFFFFFFFu, ok ? mine.y0 : 0x7FFFFFFF, src);
        by1[j] = __shfl_sync(0xFFFFFFFFu, ok ? mine.y1 : -1, src);
      }
    }
    __syncwarp();
    // No shuffle from here to the end of the pass: the tiles diverge.
    if (live) {
      const long long uarea = (long long)(ux1 - ux0 + 1) * (uy1 - uy0 + 1);
      if (uarea <= 2 * area + 64) {
        // the group's union bbox, every member merged per pixel in id order
        tile_walk<T>(ux0, ux1, uy0, uy1, k, [&](int x, int y) {
          unsigned long long best = 0ull;
          if constexpr (T <= kRegBoxes) {
#pragma unroll
            for (int j = 0; j < T; ++j) {
              if (x < bx0[j] || x > bx1[j] || y < by0[j] || y > by1[j])
                continue;
              const unsigned long long key =
                  pixel_key<INTERP>(sm[j], x, y, H, W);
              if (key > best) best = key;
            }
          } else {
            for (unsigned m = live; m; m &= m - 1) {
              const Tri& t = sm[__ffs(m) - 1];
              if (x < t.x0 || x > t.x1 || y < t.y0 || y > t.y1) continue;
              const unsigned long long key =
                  pixel_key<INTERP>(t, x, y, H, W);
              if (key > best) best = key;
            }
          }
          if (best) atomicMax(zb + (size_t)y * W + x, best);
        });
      } else {
        // scattered order: each member's own bbox
        for (unsigned m = live; m; m &= m - 1) {
          const Tri& t = sm[__ffs(m) - 1];
          tile_walk<T>(t.x0, t.x1, t.y0, t.y1, k, [&](int x, int y) {
            const unsigned long long key = pixel_key<INTERP>(t, x, y, H, W);
            if (key) atomicMax(zb + (size_t)y * W + x, key);
          });
        }
      }
    }
    __syncwarp();   // the next batch overwrites this warp's members
    base += T;
  } while (T == 32 && base < g1);
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

// ---- the raster A/B probes (experiments/profile_raster{2,3,_regacc}.py) --
// Each differs from K1 only in what it probes; all share tri_setup,
// pixel_key, orderable and the resolve pass, so their outputs are the plain
// versions' in face3d/raster.py bit for bit.  Bound: the vertices and
// triangles read once and the probe's own outputs written once, bytes-bound
// like K1 (about 4.2 us for B = 16 frames of the 189² mesh at 224²;
// chip_smoke.py computes it from each run's inputs).  They are simple by
// design: a probe measures one change against K1, not a tuned kernel.

// X1 (_kernel_b, profile_raster2.py:49): K1 with degenerate triangles
// (inv_deno == 0) dropped at setup, as _trim_table's depth -1e10 does.
// DEPTH_ONLY stores the key's depth half with a 32-bit atomicMax into a
// [B,H,W] uint32 buffer: the TPU probe's "lower-bound signal for store
// cost" (profile_raster2.py:7) as the 64-bit key's cost against a
// depth-only store.
template <bool DEPTH_ONLY>
__global__ void inside_only_kernel(const float* __restrict__ verts,
                                   const int* __restrict__ tris, int B,
                                   int V, int F, int H, int W,
                                   void* __restrict__ zbuf) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx - (long long)b * F);
  Tri t;
  if (!tri_setup<false>(verts + (size_t)b * V * 3, tris, f, V, H, W, t) ||
      t.inv == 0.0f)
    return;
  const size_t base = (size_t)b * H * W;
  for (int y = t.y0; y <= t.y1; ++y) {
    for (int x = t.x0; x <= t.x1; ++x) {
      const unsigned long long key = pixel_key<false>(t, x, y, H, W);
      if (!key) continue;
      const size_t p = base + (size_t)y * W + x;
      if (DEPTH_ONLY)
        atomicMax((unsigned int*)zbuf + p, (unsigned int)(key >> 32));
      else
        atomicMax((unsigned long long*)zbuf + p, key);
    }
  }
}

__global__ void depth_resolve_kernel(const unsigned int* __restrict__ zbuf,
                                     long long n, float* __restrict__ depth) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const unsigned int o = zbuf[idx];
  depth[idx] = o ? from_orderable(o) : kDepthInit;
}

// X2 (_kernel_unroll, profile_raster3.py:35): K1 with each thread taking
// TPT consecutive triangles in each of FPT consecutive frames, the
// counterparts of the TPU's triangle unroll and frame interleave fb.  The
// atomicMax key makes the output K1's at every setting.
template <int TPT, int FPT>
__global__ void unroll_kernel(const float* __restrict__ verts,
                              const int* __restrict__ tris, int B, int V,
                              int F, int H, int W,
                              unsigned long long* __restrict__ zbuf) {
  const long long ntg = (F + (long long)TPT - 1) / TPT;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ntg * ((B + (long long)FPT - 1) / FPT)) return;
  const long long fg = idx / ntg;
  const long long tg = idx - fg * ntg;
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const long long f = tg * TPT + u;
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      const long long b = fg * FPT + j;
      Tri t;
      if (f >= F || b >= B ||
          !tri_setup<false>(verts + (size_t)b * V * 3, tris, (int)f, V, H,
                            W, t))
        continue;
      unsigned long long* zb = zbuf + (size_t)b * H * W;
      for (int y = t.y0; y <= t.y1; ++y) {
        for (int x = t.x0; x <= t.x1; ++x) {
          const unsigned long long key = pixel_key<false>(t, x, y, H, W);
          if (key) atomicMax(zb + (size_t)y * W + x, key);
        }
      }
    }
  }
}

// X3's band start row: triangle f's aligned window origin
// clip(floor(y_min/8)*8, 0, H-win), y_min = max(ceil(min y), 0)
// (raster_pallas.py:106-111), computed apart from tri_setup because the
// band comes from the chunk's first triangle even when that triangle draws
// nothing.  NaN gives row 0, as XLA's float-to-int32 conversion does.
__device__ __forceinline__ int band_origin(const float* __restrict__ vb,
                                           const int* __restrict__ tris,
                                           int f, int V, int H, int win) {
  const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
  if ((unsigned)i0 >= (unsigned)V || (unsigned)i1 >= (unsigned)V ||
      (unsigned)i2 >= (unsigned)V)
    return 0;
  const float a = vb[3 * i0 + 1], b = vb[3 * i1 + 1], c = vb[3 * i2 + 1];
  if (isnan(a) || isnan(b) || isnan(c)) return 0;
  const float ymn = fmaxf(ceilf(fminf(fminf(a, b), c)), 0.0f);
  const float y0 = __fmul_rn(floorf(__fmul_rn(ymn, 0.125f)), 8.0f);
  return (int)fminf(y0, (float)(H - win));
}

// X3 (_regacc_kernel, profile_raster_regacc.py:49): one block per (frame,
// chunk of `chunk` consecutive triangles).  The chunk's band of win rows
// lives in dynamic shared memory as win x W uint64 keys (28,672 B at win
// 16, W 224), starting at 0; each thread takes triangles of the chunk,
// walks its bbox rows inside the band and makes a shared-memory 64-bit
// atomicMax per fragment; after __syncthreads() the block flushes each
// non-zero key with one global atomicMax.  The max of the keys is the
// TPU's strict '>' in id order within the chunk and its (max depth, min id)
// flush across chunks.  This is the shared-memory z-buffer form that a
// tile-binned raster would take, with the TPU probe's synthetic band
// assignment: fragments outside the band are dropped.
__global__ void band_regacc_kernel(const float* __restrict__ verts,
                                   const int* __restrict__ tris, int B,
                                   int V, int F, int H, int W, int win,
                                   int chunk,
                                   unsigned long long* __restrict__ zbuf) {
  extern __shared__ unsigned long long band[];
  const int nc = (F + chunk - 1) / chunk;
  const int b = blockIdx.x / nc;
  const int c = blockIdx.x - b * nc;
  const float* vb = verts + (size_t)b * V * 3;
  const int n = win * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) band[i] = 0ull;
  const int y0 = band_origin(vb, tris, c * chunk, V, H, win);
  __syncthreads();
  const int f1 = min(F, (c + 1) * chunk);
  for (int f = c * chunk + threadIdx.x; f < f1; f += blockDim.x) {
    Tri t;
    if (!tri_setup<false>(vb, tris, f, V, H, W, t)) continue;
    const int ya = max(t.y0, y0), yb = min(t.y1, y0 + win - 1);
    for (int y = ya; y <= yb; ++y) {
      for (int x = t.x0; x <= t.x1; ++x) {
        const unsigned long long key = pixel_key<false>(t, x, y, H, W);
        if (key) atomicMax(band + (y - y0) * W + x, key);
      }
    }
  }
  __syncthreads();
  unsigned long long* zb = zbuf + (size_t)b * H * W + (size_t)y0 * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long key = band[i];
    if (key) atomicMax(zb + i, key);
  }
}

template <int TPT>
cudaError_t launch_unroll_fpt(int fpt, const float* v, const int* t, int B,
                              int V, int F, int H, int W,
                              unsigned long long* z, cudaStream_t s) {
  const int threads = 256;
  const long long nt = ((F + (long long)TPT - 1) / TPT) *
                       ((B + (long long)fpt - 1) / fpt);
  const unsigned blocks = (unsigned)((nt + threads - 1) / threads);
  switch (fpt) {
    case 1:
      unroll_kernel<TPT, 1><<<blocks, threads, 0, s>>>(v, t, B, V, F, H, W,
                                                       z);
      break;
    case 2:
      unroll_kernel<TPT, 2><<<blocks, threads, 0, s>>>(v, t, B, V, F, H, W,
                                                       z);
      break;
    case 4:
      unroll_kernel<TPT, 4><<<blocks, threads, 0, s>>>(v, t, B, V, F, H, W,
                                                       z);
      break;
    case 8:
      unroll_kernel<TPT, 8><<<blocks, threads, 0, s>>>(v, t, B, V, F, H, W,
                                                       z);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_unroll(int tpt, int fpt, const float* v, const int* t,
                          int B, int V, int F, int H, int W,
                          unsigned long long* z, cudaStream_t s) {
  switch (tpt) {
    case 1: return launch_unroll_fpt<1>(fpt, v, t, B, V, F, H, W, z, s);
    case 2: return launch_unroll_fpt<2>(fpt, v, t, B, V, F, H, W, z, s);
    case 4: return launch_unroll_fpt<4>(fpt, v, t, B, V, F, H, W, z, s);
    case 8: return launch_unroll_fpt<8>(fpt, v, t, B, V, F, H, W, z, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kMaxSharedBytes = 232448;   // 227 KB: an H100 block's most

template <bool INTERP, int T>
cudaError_t launch_group(const float* vertices, const int* triangles, int B,
                         int V, int F, int H, int W, int group,
                         unsigned long long* z, cudaStream_t s) {
  const long long ntiles =
      (long long)B * ((F + (long long)group - 1) / group);
  const long long nw = (ntiles + 32 / T - 1) / (32 / T);
  group_kernel<INTERP, T>
      <<<(unsigned)((nw + kWarpsPerBlock - 1) / kWarpsPerBlock),
         32 * kWarpsPerBlock, 0, s>>>(vertices, triangles, B, V, F, group, H,
                                      W, z);
  return cudaGetLastError();
}

template <bool INTERP>
cudaError_t launch_pass1(const float* vertices, const int* triangles, int B,
                         int V, int F, int H, int W, int group,
                         unsigned long long* z, cudaStream_t s) {
  if (group <= 0) {
    const int threads = 32 * kWalkWarps;
    const long long nt = (long long)B * F;
    triangle_kernel<INTERP>
        <<<(unsigned)((nt + threads - 1) / threads), threads, 0, s>>>(
            vertices, triangles, B, V, F, H, W, z);
    return cudaGetLastError();
  }
  // the tile width: the smallest power of two >= min(group, 32)
  int t = 1;
  while (t < group && t < 32) t <<= 1;
  const float* v = vertices;
  const int* tr = triangles;
  switch (t) {
    case 1: return launch_group<INTERP, 1>(v, tr, B, V, F, H, W, group, z, s);
    case 2: return launch_group<INTERP, 2>(v, tr, B, V, F, H, W, group, z, s);
    case 4: return launch_group<INTERP, 4>(v, tr, B, V, F, H, W, group, z, s);
    case 8: return launch_group<INTERP, 8>(v, tr, B, V, F, H, W, group, z, s);
    case 16:
      return launch_group<INTERP, 16>(v, tr, B, V, F, H, W, group, z, s);
    default:
      return launch_group<INTERP, 32>(v, tr, B, V, F, H, W, group, z, s);
  }
}

}  // namespace

// vertices [B,V,3] f32, triangles [F,3] i32, colors [B,V,C] f32 or null;
// interp != 0 selects the interpolated depth and border rule (K3/K5), else
// the flat depth (K1/K4); group > 0 merges `group` consecutive triangles per
// warp (K4/K5), else one thread per triangle (K1/K3).  zbuf [B,H,W] u64
// scratch; winner/depth [B,H,W] or null; image [B,H,W,C] u8 and mask
// [B,H,W] u8 or null.  Launches on `stream`, returns cudaGetLastError() (0
// on success).
extern "C" int vp_raster(const float* vertices, const int* triangles,
                         const float* colors, int B, int V, int F, int C,
                         int H, int W, int interp, int group, void* zbuf,
                         int* winner, float* depth, unsigned char* image,
                         unsigned char* mask, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* z = (unsigned long long*)zbuf;
  cudaError_t err = cudaMemsetAsync(z, 0, sizeof(unsigned long long) *
                                              (size_t)B * H * W, s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * F > 0) {
    err = interp ? launch_pass1<true>(vertices, triangles, B, V, F, H, W,
                                      group, z, s)
                 : launch_pass1<false>(vertices, triangles, B, V, F, H, W,
                                       group, z, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  const long long np = (long long)B * H * W;
  if (np > 0) {
    resolve_kernel<<<(unsigned)((np + threads - 1) / threads), threads, 0,
                     s>>>(z, triangles, colors, B, V, F, C, H, W, winner,
                          depth, image, mask);
  }
  return (int)cudaGetLastError();
}

// The raster A/B probes; vertices [B,V,3] f32, triangles [F,3] i32.
//   probe 0  X1 inside-only: a = 1 for winner + depth (zbuf [B,H,W] u64),
//            0 for depth only (zbuf [B,H,W] u32, winner null);
//   probe 1  X2 unroll: a = triangles per thread, b = frames per thread,
//            each in {1, 2, 4, 8} (zbuf u64);
//   probe 2  X3 band regacc: a = band rows win in [1, H], b = chunk >= 1,
//            win * W * 8 bytes of shared memory at most 227 KB (zbuf u64).
// winner [B,H,W] i32 or null, depth [B,H,W] f32.  Launches on `stream`,
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// setting outside those ranges, before any launch).
extern "C" int vp_raster_probe(const float* vertices, const int* triangles,
                               int B, int V, int F, int H, int W, int probe,
                               int a, int b, void* zbuf, int* winner,
                               float* depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long np = (long long)B * H * W;
  const int threads = 256;
  const unsigned pblocks = (unsigned)((np + threads - 1) / threads);
  const bool depth_only = probe == 0 && a == 0;
  const size_t smem = probe == 2 ? sizeof(unsigned long long) * (size_t)a * W
                                 : 0;
  if (probe < 0 || probe > 2 ||
      (probe == 1 && !((a == 1 || a == 2 || a == 4 || a == 8) &&
                       (b == 1 || b == 2 || b == 4 || b == 8))) ||
      (probe == 2 && (a < 1 || a > H || b < 1 || smem > kMaxSharedBytes)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      zbuf, 0, (depth_only ? sizeof(unsigned int)
                           : sizeof(unsigned long long)) * (size_t)np, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* z = (unsigned long long*)zbuf;
  const long long nt = (long long)B * F;
  if (nt > 0) {
    const unsigned tblocks = (unsigned)((nt + threads - 1) / threads);
    if (probe == 0) {
      if (depth_only)
        inside_only_kernel<true><<<tblocks, threads, 0, s>>>(
            vertices, triangles, B, V, F, H, W, zbuf);
      else
        inside_only_kernel<false><<<tblocks, threads, 0, s>>>(
            vertices, triangles, B, V, F, H, W, zbuf);
      err = cudaGetLastError();
    } else if (probe == 1) {
      err = launch_unroll(a, b, vertices, triangles, B, V, F, H, W, z, s);
    } else {
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(band_regacc_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      // one thread per triangle of the chunk, in whole warps, at most 512
      const long long nc = (F + (long long)b - 1) / b;
      const int bthreads = ((b < 512 ? b : 512) + 31) / 32 * 32;
      band_regacc_kernel<<<(unsigned)(B * nc), bthreads, smem, s>>>(
          vertices, triangles, B, V, F, H, W, a, b, z);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (np > 0) {
    if (depth_only)
      depth_resolve_kernel<<<pblocks, threads, 0, s>>>(
          (const unsigned int*)zbuf, np, depth);
    else
      resolve_kernel<<<pblocks, threads, 0, s>>>(z, triangles, nullptr, B, V,
                                                 F, 0, H, W, winner, depth,
                                                 nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
