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
// _kernel_unroll, X3 _regacc_kernel; near the end, behind vp_raster_probe),
// all three built on K1's balanced walk (walk_list) and differing from it
// only in what they probe.
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
//             per-triangle (K1, K3; warp_walk, which X1 shares): lane j of a
//           warp takes the (frame, triangle) entry first + j of the flat
//           order b * F + f, builds its setup (p0, edge vectors, dot
//           products, inv_deno, in the operation order of
//           face3d/raster_ref.py:_point_in_tri) and stores it, with its
//           bbox's magic number and its frame's offset, into the warp's
//           shared slot j as five 16-byte words.  The warp scans the 32
//           clipped bbox areas (0 for an entry that cannot draw) with
//           shuffles, and then walks all 32 bboxes as one list of sum(area)
//           pixels, 32 adjacent ones a step: lane j takes pixel r = base +
//           j, finds its owner slot by a binary search over the 32 sums (5
//           shared loads), loads the owner's slot (5 128-bit loads), and
//           finds (x, y) from the row-major position q in the owner's bbox
//           by one __umulhi with the magic number and one correction (no
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

// Builds triangle f of one frame from its corner indices i0, i1, i2; false
// if it can never draw.
template <bool INTERP>
__device__ __forceinline__ bool tri_setup_at(const float* __restrict__ vb,
                                             int i0, int i1, int i2, int f,
                                             int V, int H, int W, Tri& t) {
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

// Builds triangle f of one frame; false if it can never draw.
template <bool INTERP>
__device__ __forceinline__ bool tri_setup(const float* __restrict__ vb,
                                          const int* __restrict__ tris,
                                          int f, int V, int H, int W,
                                          Tri& t) {
  return tri_setup_at<INTERP>(vb, tris[3 * f], tris[3 * f + 1],
                              tris[3 * f + 2], f, V, H, W, t);
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

// Inclusive sum of v over the warp's 32 lanes; every lane calls it.
__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// The balanced walk over a list of NS slots (NS a power of two, at least
// 32) whose inclusive area sums are e[0 .. NS - 1], total = e[NS - 1]: the
// `stride` threads that walk it (a warp's 32 lanes, or X3's block) take
// `stride` adjacent pixels a step, thread `first` pixel r = base + first of
// the list for base = 0, stride, ... below `total`; each finds its owner
// slot by log2(NS) shared loads and its (x, y) by the owner's magic number,
// and calls emit(off, x, y, key) where the fragment draws (off: the slot's
// frame offset).  K1/K3, X2 and X3 all walk with it.
template <bool INTERP, int NS, typename Emit>
__device__ __forceinline__ void walk_list(const WalkSlot* slots,
                                          const unsigned* e, unsigned total,
                                          int first, int stride, int H, int W,
                                          Emit emit) {
  // No shuffle from here on: the last step's threads past `total` leave.
  for (unsigned r = first; r < total; r += stride) {
    // the owner: the first slot whose sum exceeds r (a slot that drew
    // nothing adds 0 and is never one); `start` is the sum before it
    int o = 0;
    unsigned start = 0;
#pragma unroll
    for (int s = NS / 2; s > 0; s >>= 1) {
      const unsigned v = e[o + s - 1];
      if (v <= r) {
        o += s;
        start = v;
      }
    }
    unsigned m;
    int off;
    const Tri t = load_slot(slots[o], m, off);
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
    if (key) emit(off, x, y, key);
  }
}

// The warp body of K1/K3 and X1: lane j of the warp builds the (frame,
// triangle) entry first + j of the flat order b * F + f into the warp's
// slot j, the warp scans the 32 areas and walks them with walk_list, and
// emit(off, x, y, key) stores each fragment that draws (header note).
// With DROP_DEGENERATE (X1) an entry whose inv_deno is 0 gets area 0.
template <bool INTERP, bool DROP_DEGENERATE, typename Emit>
__device__ __forceinline__ void warp_walk(const float* __restrict__ verts,
                                          const int* __restrict__ tris,
                                          int B, int V, int F, int H, int W,
                                          WalkSlot* slots, unsigned* ends,
                                          Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = (long long)B * F;
  const long long first = ((long long)blockIdx.x * kWalkWarps + warp) * 32;
  // Scan hazard: only a warp whose first entry is past the end leaves; the
  // scan below takes the full mask, so a lane past the end, or whose entry
  // cannot draw (or, with DROP_DEGENERATE, is degenerate), stays in with
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
    if (tri_setup<INTERP>(verts + (size_t)b * V * 3, tris, f, V, H, W, t) &&
        !(DROP_DEGENERATE && t.inv == 0.0f)) {
      const int w = t.x1 - t.x0 + 1;
      area = (unsigned)(w * (t.y1 - t.y0 + 1));   // <= H * W
      // floor((2^32 - 1) / w) + 1 wraps to 0 at w = 1 only
      store_slot(slots[lane], t, 0xFFFFFFFFu / (unsigned)w + 1u, b * H * W);
    }
  }
  // Inclusive scan of the areas in 32 bits: one degenerate triangle's bbox
  // may be the whole canvas, but the wrapper admits 32 * H * W < 2^31 only,
  // so a warp's total, and every pixel index r + 32 below, stays < 2^32.
  const unsigned end = warp_inclusive_sum(area, lane);
  ends[lane] = end;
  const unsigned total = __shfl_sync(0xFFFFFFFFu, end, 31);
  __syncwarp();   // the slots and sums are read by every lane below
  walk_list<INTERP, 32>(slots, ends, total, lane, 32, H, W, emit);
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
  const int warp = threadIdx.x >> 5;
  warp_walk<INTERP, false>(
      verts, tris, B, V, F, H, W, slots[warp], ends[warp],
      [&](int off, int x, int y, unsigned long long key) {
        atomicMax(zbuf + off + (size_t)y * W + x, key);
      });
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
// Each is K1 changed in the one respect it probes.  All share tri_setup,
// pixel_key, orderable and the resolve pass, so their outputs are the plain
// versions' in face3d/raster.py bit for bit (and no FMA creeps into any of
// them); all three walk with K1's walk_list, so a probe's time against K1's
// in the same run measures its change, not a different walk.  Bound: the
// vertices and triangles read once and the probe's own outputs written
// once, bytes-bound like K1 (about 4.2 us for B = 16 frames of the 189²
// mesh at 224²; chip_smoke.py computes it from each run's inputs).

// X1 (_kernel_b, profile_raster2.py:49): triangle_kernel<false>, its grid,
// its slots and its walk (warp_walk), with the two things the TPU probe
// measures: degenerate triangles (inv_deno == 0) get area 0 and no slot,
// as _trim_table's depth -1e10 drops them (profile_raster2.py:31-44); and
// DEPTH_ONLY stores the key's depth half with a 32-bit atomicMax into a
// [B,H,W] uint32 buffer, at the same element offset off + y * W + x (the
// slot's frame offset counts elements, so it indexes either buffer): the
// probe's "lower-bound signal for store cost" (profile_raster2.py:7), the
// 64-bit key's atomic, twice the memset and an 8-byte resolve against a
// depth-only store.  Empty-value hazard: 0 in either buffer means empty to
// its resolve pass; a fragment that draws has depth > -99999, not NaN, so
// orderable(depth), the key's high half, is never 0 (and -0.0 was made
// +0.0 in tri_setup_at, so both modes resolve the same canonical depth).
template <bool DEPTH_ONLY>
__global__ void __launch_bounds__(32 * kWalkWarps)
inside_only_walk_kernel(const float* __restrict__ verts,
                        const int* __restrict__ tris, int B, int V, int F,
                        int H, int W, void* __restrict__ zbuf) {
  __shared__ WalkSlot slots[kWalkWarps][32];
  __shared__ unsigned ends[kWalkWarps][32];    // inclusive sums of areas
  const int warp = threadIdx.x >> 5;
  warp_walk<false, true>(
      verts, tris, B, V, F, H, W, slots[warp], ends[warp],
      [&](int off, int x, int y, unsigned long long key) {
        const size_t p = off + (size_t)y * W + x;
        if (DEPTH_ONLY)
          atomicMax((unsigned int*)zbuf + p, (unsigned int)(key >> 32));
        else
          atomicMax((unsigned long long*)zbuf + p, key);
      });
}

__global__ void depth_resolve_kernel(const unsigned int* __restrict__ zbuf,
                                     long long n, float* __restrict__ depth) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const unsigned int o = zbuf[idx];
  depth[idx] = o ? from_orderable(o) : kDepthInit;
}

// X2 (_kernel_unroll, profile_raster3.py:35): K1's balanced walk with more
// entries a lane.  Lane j of a warp is thread g = fg * ceil(F / TPT) + tg
// of the grid and takes TPT consecutive triangles tg * TPT + u in each of
// FPT consecutive frames fg * FPT + i (the TPU's triangle unroll and frame
// interleave fb); it loads a triangle's three indices once for its FPT
// frames (the counterpart of one SMEM table row serving fb frames).  The
// warp walks its 32 x TPT x FPT entries in TPT x FPT rounds of K1's list:
// in round k each lane builds its entry k (triangle k / FPT, frame k % FPT)
// into its slot, the warp scans the 32 areas and walks them with
// walk_list, and the next round overwrites the slots.  At TPT = FPT = 1
// this is triangle_kernel<false> entry for entry: the same grid, 8 warps a
// block, lane j in slot j, one round.
//   Rounds: a slot takes 84 B of shared memory (a WalkSlot and its sum), so
// one list of all 2,048 entries (TPT = FPT = 8) would take 172,032 B, one
// warp an SM.  Rounds of 32 slots keep K1's 21,504 B a block and its
// 5-step owner search, and were the fastest round size at every setting on
// an H100 (PERF.md).
//   What bounds it: K1's costs per entry (index and vertex loads, the
// setup's IEEE 1/deno and the magic number's division) and per pixel (the
// owner search, five 128-bit slot loads, pixel_key, the atomic), a round's
// imbalance across its 32 lanes, and B x F / (32 x TPT x FPT) warps: at
// TPT x FPT = 32, 1,105 warps for B = 16 of the 189² mesh, 8.4 an SM.
template <int TPT, int FPT>
__global__ void __launch_bounds__(32 * kWalkWarps)
unroll_walk_kernel(const float* __restrict__ verts,
                   const int* __restrict__ tris, int B, int V, int F, int H,
                   int W, unsigned long long* __restrict__ zbuf) {
  __shared__ WalkSlot slots[kWalkWarps][32];
  __shared__ unsigned ends[kWalkWarps][32];    // inclusive sums of areas
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ntg = (F + (long long)TPT - 1) / TPT;
  const long long n = ntg * ((B + (long long)FPT - 1) / FPT);
  const long long first = ((long long)blockIdx.x * kWalkWarps + warp) * 32;
  // Exit hazard: only a warp whose every lane is past the end leaves; the
  // scan of every round takes the full mask, so a lane past the end stays
  // in, with area 0, through all the rounds.
  if (first >= n) return;
  const long long g = first + lane;
  const bool in = g < n;
  const long long fg = in ? g / ntg : 0;
  const long long tg = in ? g - fg * ntg : 0;
  // the lane's first triangle and frame: < F + TPT and < B + FPT, 32 bits
  // (B x F < 2^31, the wrapper)
  const int f0 = (int)(tg * TPT), b0 = (int)(fg * FPT);
  // the current triangle's indices, loaded once for its FPT frames
  int i0 = 0, i1 = 0, i2 = 0;
  bool tri_in = false;
#pragma unroll 1
  for (int k = 0; k < TPT * FPT; ++k) {
    const int f = f0 + k / FPT, b = b0 + k % FPT;
    if (k % FPT == 0) {
      tri_in = in && f < F;
      if (tri_in) {
        i0 = tris[3 * f];
        i1 = tris[3 * f + 1];
        i2 = tris[3 * f + 2];
      }
    }
    unsigned area = 0;
    Tri t;
    if (tri_in && b < B &&
        tri_setup_at<false>(verts + (size_t)b * V * 3, i0, i1, i2, f, V, H,
                            W, t)) {
      const int w = t.x1 - t.x0 + 1;
      area = (unsigned)(w * (t.y1 - t.y0 + 1));   // <= H * W
      // Order hazard: the rounds take the warp's entries lane by lane, not
      // in K1's flat order b * F + f, and one lane's entries lie in FPT
      // frames (a round's in several): the keys are order-free, so the
      // output does not change, and each slot carries its own frame's
      // key-buffer offset.
      store_slot(slots[warp][lane], t, 0xFFFFFFFFu / (unsigned)w + 1u,
                 b * H * W);
    }
    // Sum hazard: a round sums 32 areas, as K1's warp does, and the
    // wrapper admits 32 x H x W < 2^31 only, so a round's total, and every
    // pixel index r + 32 of its walk, stays < 2^32.
    const unsigned end = warp_inclusive_sum(area, lane);
    ends[warp][lane] = end;
    const unsigned total = __shfl_sync(0xFFFFFFFFu, end, 31);
    __syncwarp();   // the slots and sums are read by every lane below
    walk_list<false, 32>(slots[warp], ends[warp], total, lane, 32, H, W,
                         [&](int off, int x, int y, unsigned long long key) {
                           atomicMax(zbuf + off + (size_t)y * W + x, key);
                         });
    __syncwarp();   // the next round overwrites this warp's slots and sums
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

// X3 (_regacc_kernel, profile_raster_regacc.py:49): K1's build and walk,
// with the atomicMax going into a shared-memory band.  One block per (frame,
// chunk of `chunk` consecutive triangles), thread i building triangle
// chunk x c + i into slot i of the chunk's list of NS slots (NS the power of
// two >= max(chunk, 32)).  The chunk's band of win rows from its first
// triangle's aligned origin lives in dynamic shared memory as win x W
// uint64 keys (28,672 B at win 16, W 224), the list's slots and sums after
// it.  Each entry's bbox rows are clipped to the band [y0, y0 + win) before
// the scan, so the walk never visits a pixel outside it (the TPU probe's
// synthetic band assignment: fragments outside the band are dropped).  The
// block scans the areas, reduces the clipped bboxes to their union
// rectangle, zeroes only that rectangle, walks the list with walk_list
// into the band, every thread of the block taking a pixel a step, and
// flushes the rectangle row by row, coalesced, with one global atomicMax
// per non-zero key.  Every key outside the rectangle stays zero, so the
// output is what a whole-band flush gives; the TPU kernel handles whole
// win x W windows because its vector unit works on windows.  The max of the
// keys is the TPU's strict '>' in id order within the chunk and its
// (max depth, min id) flush across chunks.
//   Block shape: max(NS, kBandThreads) threads.  The band's shared memory
// caps the resident blocks an SM (6 at win 16 and chunk 64, 34,048 B), so a
// block of one warp per 32 entries (2 at chunk 64) leaves an SM 12 warps to
// hide the walk's latency; 4 warps a block give it 24 and halve the steps
// of each block's walk, zeroing and flush.  128 threads was the fastest
// block at win 16, fb 8 (with 256) and at win 8, fb 8, where 256 would cap
// an SM at 8 blocks by threads (PERF.md).
//   What bounds it: a block's fixed cost (the band origin and the build,
// each a chain of dependent loads, the scan, two reductions, three
// barriers) over few entries (64 at fb 8), and the band's shared memory.
constexpr int kBandThreads = 128;
constexpr int kBandMaxSlots = 512;   // chunk <= 512

// The band's keys rounded up to 16 bytes; the list's slots follow them.
__host__ __device__ __forceinline__ size_t band_keys_bytes(int win, int W) {
  return ((size_t)win * W * sizeof(unsigned long long) + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t band_shared_bytes(int win, int W,
                                                             int slots) {
  return band_keys_bytes(win, W) +
         (size_t)slots * (sizeof(WalkSlot) + sizeof(unsigned));
}

template <int NS>
__global__ void __launch_bounds__(NS > kBandThreads ? NS : kBandThreads)
band_walk_kernel(const float* __restrict__ verts,
                 const int* __restrict__ tris, int B, int V, int F, int H,
                 int W, int win, int chunk,
                 unsigned long long* __restrict__ zbuf) {
  constexpr int kWarps = (NS > kBandThreads ? NS : kBandThreads) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int boxes[kWarps][4];     // each warp's union rectangle
  __shared__ unsigned sums[kWarps];    // each warp's total area
  const int i = threadIdx.x, warp = i >> 5, lane = i & 31;
  unsigned long long* band = (unsigned long long*)smem;
  WalkSlot* slots = (WalkSlot*)(smem + band_keys_bytes(win, W));
  unsigned* ends = (unsigned*)(slots + NS);
  const int nc = (F + chunk - 1) / chunk;
  const int b = blockIdx.x / nc;
  const int c = blockIdx.x - b * nc;
  const float* vb = verts + (size_t)b * V * 3;
  const int y0 = band_origin(vb, tris, c * chunk, V, H, win);
  const int f = c * chunk + i;
  unsigned area = 0;
  // an empty box: min x0 > max x1 until an entry draws inside the band
  int bx0 = 0x7FFFFFFF, bx1 = -1, by0 = 0x7FFFFFFF, by1 = -1;
  Tri t;
  if (i < chunk && f < F && tri_setup<false>(vb, tris, f, V, H, W, t)) {
    t.y0 = max(t.y0, y0);
    t.y1 = min(t.y1, y0 + win - 1);
    if (t.y0 <= t.y1) {
      const int w = t.x1 - t.x0 + 1;
      area = (unsigned)(w * (t.y1 - t.y0 + 1));   // <= win * W
      store_slot(slots[i], t, 0xFFFFFFFFu / (unsigned)w + 1u, 0);
      bx0 = t.x0;
      bx1 = t.x1;
      by0 = t.y0;
      by1 = t.y1;
    }
  }
  // The scans and the reductions take the full mask: a thread past the
  // chunk's end takes part with area 0 and an empty box.  Sum hazard: the
  // band's keys fit 227 KB, so win x W < 29,057 and the list's total,
  // at most NS x win x W, stays below 2^24.
  const unsigned incl = warp_inclusive_sum(area, lane);
  bx0 = __reduce_min_sync(0xFFFFFFFFu, bx0);
  bx1 = __reduce_max_sync(0xFFFFFFFFu, bx1);
  by0 = __reduce_min_sync(0xFFFFFFFFu, by0);
  by1 = __reduce_max_sync(0xFFFFFFFFu, by1);
  if (lane == 31) sums[warp] = incl;
  if (lane == 0) {
    boxes[warp][0] = bx0;
    boxes[warp][1] = bx1;
    boxes[warp][2] = by0;
    boxes[warp][3] = by1;
  }
  __syncthreads();
  unsigned before = 0, total = 0;
  int ux0 = 0x7FFFFFFF, ux1 = -1, uy0 = 0x7FFFFFFF, uy1 = -1;
  for (int j = 0; j < kWarps; ++j) {
    if (j < warp) before += sums[j];
    total += sums[j];
    ux0 = min(ux0, boxes[j][0]);
    ux1 = max(ux1, boxes[j][1]);
    uy0 = min(uy0, boxes[j][2]);
    uy1 = max(uy1, boxes[j][3]);
  }
  // Empty-union hazard: a chunk with no entry that draws inside its band
  // leaves here, every thread alike (the union is the block's), before it
  // zeroes, walks or flushes anything: no global memory is touched, and no
  // width or height is formed from the empty set's sentinels.
  if (ux0 > ux1) return;
  if (i < NS) ends[i] = before + incl;
  for (int y = uy0 + warp; y <= uy1; y += kWarps)
    for (int x = ux0 + lane; x <= ux1; x += 32) band[(y - y0) * W + x] = 0ull;
  __syncthreads();   // the slots, the sums and the zeroed rectangle
  walk_list<false, NS>(slots, ends, total, i, 32 * kWarps, H, W,
                       [&](int, int x, int y, unsigned long long key) {
                         atomicMax(band + (y - y0) * W + x, key);
                       });
  __syncthreads();
  unsigned long long* zb = zbuf + (size_t)b * H * W;
  for (int y = uy0 + warp; y <= uy1; y += kWarps) {
    for (int x = ux0 + lane; x <= ux1; x += 32) {
      const unsigned long long key = band[(y - y0) * W + x];
      if (key) atomicMax(zb + (size_t)y * W + x, key);
    }
  }
}

// Runs op.run<NS>() for X3's list of `slots` slots (32, 64, ..., 512).
template <typename Op>
cudaError_t with_band_slots(int slots, Op& op) {
  switch (slots) {
    case 32: return op.template run<32>();
    case 64: return op.template run<64>();
    case 128: return op.template run<128>();
    case 256: return op.template run<256>();
    case 512: return op.template run<512>();
    default: return cudaErrorInvalidValue;
  }
}

// Runs op.run<TPT, FPT>() for TPT and FPT each in {1, 2, 4, 8}.
template <int TPT, typename Op>
cudaError_t unroll_fpt(int fpt, Op& op) {
  switch (fpt) {
    case 1: return op.template run<TPT, 1>();
    case 2: return op.template run<TPT, 2>();
    case 4: return op.template run<TPT, 4>();
    case 8: return op.template run<TPT, 8>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename Op>
cudaError_t with_unroll(int tpt, int fpt, Op& op) {
  switch (tpt) {
    case 1: return unroll_fpt<1>(fpt, op);
    case 2: return unroll_fpt<2>(fpt, op);
    case 4: return unroll_fpt<4>(fpt, op);
    case 8: return unroll_fpt<8>(fpt, op);
    default: return cudaErrorInvalidValue;
  }
}

struct UnrollLaunch {
  const float* v;
  const int* t;
  int B, V, F, H, W;
  unsigned long long* z;
  cudaStream_t s;
  template <int TPT, int FPT>
  cudaError_t run() {
    const int threads = 32 * kWalkWarps;
    const long long nt = ((F + (long long)TPT - 1) / TPT) *
                         ((B + (long long)FPT - 1) / FPT);
    unroll_walk_kernel<TPT, FPT>
        <<<(unsigned)((nt + threads - 1) / threads), threads, 0, s>>>(
            v, t, B, V, F, H, W, z);
    return cudaGetLastError();
  }
};

// out: registers a thread, static and dynamic shared bytes, threads a
// block, and resident blocks an SM at that launch.
cudaError_t kernel_attrs(const void* fn, int threads, size_t dyn, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      dyn);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)dyn;
  out[3] = threads;
  out[4] = blocks;
  return err;
}

struct UnrollAttrs {
  int* out;
  template <int TPT, int FPT>
  cudaError_t run() {
    return kernel_attrs((const void*)unroll_walk_kernel<TPT, FPT>,
                        32 * kWalkWarps, 0, out);
  }
};

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

// X3's list length (the power of two >= max(chunk, 32)), threads a block
// and dynamic shared bytes; cudaErrorInvalidValue for a setting outside
// the ranges of vp_raster_probe.
cudaError_t band_launch_shape(int win, int chunk, int H, int W, int& slots,
                              int& threads, size_t& smem) {
  if (win < 1 || win > H || chunk < 1 || chunk > kBandMaxSlots)
    return cudaErrorInvalidValue;
  slots = 32;
  while (slots < chunk) slots <<= 1;
  threads = slots > kBandThreads ? slots : kBandThreads;
  smem = band_shared_bytes(win, W, slots);
  return smem > kMaxSharedBytes ? cudaErrorInvalidValue : cudaSuccess;
}

// band_walk_kernel<NS>'s dynamic shared memory, opted in at every size:
// the 48 KB a block gets without the opt-in counts its static arrays too,
// so 48 KB of keys and slots alone already need it.
template <int NS>
cudaError_t allow_band_shared(size_t smem) {
  return cudaFuncSetAttribute(band_walk_kernel<NS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct BandLaunch {
  const float* v;
  const int* t;
  int B, V, F, H, W, win, chunk, threads;
  size_t smem;
  unsigned long long* z;
  cudaStream_t s;
  template <int NS>
  cudaError_t run() {
    const cudaError_t err = allow_band_shared<NS>(smem);
    if (err != cudaSuccess) return err;
    const long long nc = (F + (long long)chunk - 1) / chunk;
    band_walk_kernel<NS><<<(unsigned)(B * nc), threads, smem, s>>>(
        v, t, B, V, F, H, W, win, chunk, z);
    return cudaGetLastError();
  }
};

struct BandAttrs {
  int threads;
  size_t smem;
  int* out;
  template <int NS>
  cudaError_t run() {
    const cudaError_t err = allow_band_shared<NS>(smem);
    if (err != cudaSuccess) return err;
    return kernel_attrs((const void*)band_walk_kernel<NS>, threads, smem,
                        out);
  }
};

bool unroll_ok(int tpt, int fpt) {
  return (tpt == 1 || tpt == 2 || tpt == 4 || tpt == 8) &&
         (fpt == 1 || fpt == 2 || fpt == 4 || fpt == 8);
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
//   probe 2  X3 band regacc: a = band rows win in [1, H], b = chunk in
//            [1, 512], the band's win x W keys and the chunk's walk slots
//            (band_shared_bytes) at most 227 KB of shared memory (zbuf
//            u64).
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
  int band_slots = 0, band_threads = 0;
  size_t smem = 0;
  if (probe < 0 || probe > 2 || (probe == 1 && !unroll_ok(a, b)))
    return (int)cudaErrorInvalidValue;
  if (probe == 2) {
    const cudaError_t err =
        band_launch_shape(a, b, H, W, band_slots, band_threads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaMemsetAsync(
      zbuf, 0, (depth_only ? sizeof(unsigned int)
                           : sizeof(unsigned long long)) * (size_t)np, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* z = (unsigned long long*)zbuf;
  const long long nt = (long long)B * F;
  if (nt > 0) {
    const unsigned tblocks = (unsigned)((nt + threads - 1) / threads);
    if (probe == 0) {
      // X1 on triangle_kernel's grid: blocks of 256 = 32 x kWalkWarps
      // threads, one warp per 32 consecutive entries
      static_assert(32 * kWalkWarps == 256, "X1's grid is K1's");
      if (depth_only)
        inside_only_walk_kernel<true><<<tblocks, threads, 0, s>>>(
            vertices, triangles, B, V, F, H, W, zbuf);
      else
        inside_only_walk_kernel<false><<<tblocks, threads, 0, s>>>(
            vertices, triangles, B, V, F, H, W, zbuf);
      err = cudaGetLastError();
    } else if (probe == 1) {
      UnrollLaunch op{vertices, triangles, B, V, F, H, W, z, s};
      err = with_unroll(a, b, op);
    } else {
      BandLaunch op{vertices, triangles, B, V, F, H, W, a, b, band_threads,
                    smem, z, s};
      err = with_band_slots(band_slots, op);
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

// The launch shape of probe 0 (X1: a = 1 winner, 0 depth-only), probe 1
// (X2: a = TPT, b = FPT) or probe 2 (X3: a = win, b = chunk) on an H x W
// canvas: out[0] registers a thread, out[1] static and out[2] dynamic
// shared bytes a block, out[3] threads a block, out[4] resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a CUDA error
// code (cudaErrorInvalidValue as vp_raster_probe).
extern "C" int vp_raster_probe_attrs(int probe, int a, int b, int H, int W,
                                     int* out) {
  if (probe == 0)
    return (int)kernel_attrs(
        a ? (const void*)inside_only_walk_kernel<false>
          : (const void*)inside_only_walk_kernel<true>,
        32 * kWalkWarps, 0, out);
  if (probe == 1) {
    if (!unroll_ok(a, b)) return (int)cudaErrorInvalidValue;
    UnrollAttrs op{out};
    return (int)with_unroll(a, b, op);
  }
  if (probe != 2) return (int)cudaErrorInvalidValue;
  int slots = 0, threads = 0;
  size_t smem = 0;
  const cudaError_t err =
      band_launch_shape(a, b, H, W, slots, threads, smem);
  if (err != cudaSuccess) return (int)err;
  BandAttrs op{threads, smem, out};
  return (int)with_band_slots(slots, op);
}
