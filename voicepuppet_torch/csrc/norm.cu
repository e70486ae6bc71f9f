// Batch-moment normalisation of the served generators for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves StatelessBatchNorm
// (voicepuppet_tpu/models/pixrefer.py) to XLA, which fuses its float32
// passes.  Eager PyTorch runs them one kernel each (x.float(), two means,
// a square, four elementwise ops, the cast back): about 60 bytes of
// device traffic for each bf16 element, where reading x twice and writing
// y once is 6.  Normalisation sits far below the H100's ridge, so what
// bounds it is bytes: 3 x numel x itemsize at 3.35 TB/s.
//
// y = ((x - mean) * inv) * w[c] + b[c], inv = rsqrt(mean2 - mean^2 + eps),
// over a channels_last [N,C,H,W] tensor (bf16 or float32): the layout of
// the served generators' activations, whose NHWC inputs are permuted to
// NCHW views and which cuDNN keeps through the convs.  In memory it is
// [N*P rows, C] row-major (P = H*W), and a moment group is one column
// over the P rows of a frame (per frame) or all N*P rows (per chunk).  A
// block is `lanes` column lanes (each 16 bytes of channels) by 256 /
// lanes row lanes over `slice` rows of one row group and one tile of
// columns; three passes:
//   bn_moments_rows   each thread sums its channels over its rows (rows
//       r, r + row lanes, ...) in order, with 16-byte loads (8 bf16 or 4
//       float32; scalar loads where the channels or the pointer do not
//       allow them); the row lanes' sums are added in order through
//       shared memory; one (sum, sum of squares) per (slice, channel).
//   bn_finalize_rows  per (row group, channel): q lanes sum the slices'
//       partials (lane j: j, j + q lanes, ...), then the lanes in order;
//       the moments.  A group has at most 1,024 slices (plan), so this
//       pass is short.
//   bn_normalize_rows each thread forms its channels' inv and streams its
//       rows.
//
// No atomics: a chunk's output is the same from run to run.  Every
// arithmetic step is an explicit round-to-nearest intrinsic (no FMA
// contraction), and the moments are formed as the eager formula forms
// them (rsqrtf is the function torch.rsqrt runs on the card), so given
// the same moments the output equals eager normalize(...).to(dtype) byte
// for byte.  The normalise pass runs its blocks in the reverse order of
// the moments pass, so the data read last, still in the 50 MB L2, is read
// again first.  ops/batchnorm.py plans the cut and restates the order of
// operations in torch (moments_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread

// Raw 16-byte vectors (V > 1) or one element (V == 1), and their floats.
template <typename T, int V>
struct Raw {
  uint4 w;
};
template <typename T>
struct Raw<T, 1> {
  T w;
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p, bool stream) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.w = *p;
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    r.w = stream ? __ldcs(q) : *q;
  }
  return r;
}

__device__ __forceinline__ void bf16x2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T, int V>
__device__ __forceinline__ void to_float(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2)
      f[0] = __bfloat162float(r.w);
    else
      f[0] = r.w;
  } else if constexpr (sizeof(T) == 2) {
    bf16x2(r.w.x, f);
    bf16x2(r.w.y, f + 2);
    bf16x2(r.w.z, f + 4);
    bf16x2(r.w.w, f + 6);
  } else {
    f[0] = __uint_as_float(r.w.x);
    f[1] = __uint_as_float(r.w.y);
    f[2] = __uint_as_float(r.w.z);
    f[3] = __uint_as_float(r.w.w);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2)
      *p = __float2bfloat16_rn(f[0]);
    else
      *p = f[0];
  } else if constexpr (sizeof(T) == 2) {
    uint4 w;
    w.x = bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
    w.y = bf16_bits(f[2]) | (bf16_bits(f[3]) << 16);
    w.z = bf16_bits(f[4]) | (bf16_bits(f[5]) << 16);
    w.w = bf16_bits(f[6]) | (bf16_bits(f[7]) << 16);
    *reinterpret_cast<uint4*>(p) = w;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

struct Rows {
  long long groups;  // row groups: N per frame, 1 per chunk
  int rows;          // rows (pixels) of a group: P or N*P
  int channels;      // C
  int cvecs;         // C / V
  int lanes;         // column lanes of a block (a power of two)
  int row_lanes;     // 256 / lanes
  int tiles;         // ceil(cvecs / lanes)
  int slice;         // rows of a slice, a multiple of row_lanes
  int slices;        // ceil(rows / slice)
  int q_lanes;       // bn_finalize_rows: 256 / min(32, pow2 >= C)
};

// Block b of the moments and normalise grids: (row group, slice, tile).
struct RowBlock {
  long long group;
  int slice, tile;
};

__device__ __forceinline__ RowBlock row_block(const Rows& L, long long b) {
  RowBlock r;
  r.tile = (int)(b % L.tiles);
  const long long gq = b / L.tiles;
  r.slice = (int)(gq % L.slices);
  r.group = gq / L.slices;
  return r;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_moments_rows(const T* __restrict__ x, float2* __restrict__ part,
                    Rows L) {
  __shared__ float2 red[kThreads * 8];
  const RowBlock B = row_block(L, blockIdx.x);
  const int lane = threadIdx.x & (L.lanes - 1);
  const int row_lane = threadIdx.x / L.lanes;
  const int cv = B.tile * L.lanes + lane;
  float s[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = s2[i] = 0.f;
  if (cv < L.cvecs) {
    const int r0 = B.slice * L.slice;
    const int r1 = min(r0 + L.slice, L.rows);
    const T* base = x + B.group * L.rows * (long long)L.channels + cv * V;
    for (int r = r0 + row_lane; r < r1; r += kUnroll * L.row_lanes) {
      Raw<T, V> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * L.row_lanes;
        if (rr < r1)
          raw[u] = load<T, V>(base + (long long)rr * L.channels, false);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * L.row_lanes >= r1) break;
        float f[V];
        to_float<T, V>(raw[u], f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] = __fadd_rn(s[i], f[i]);
          s2[i] = __fadd_rn(s2[i], __fmul_rn(f[i], f[i]));
        }
      }
    }
  }
  const int width = L.lanes * V;   // columns of the tile
#pragma unroll
  for (int i = 0; i < V; ++i)
    red[row_lane * width + lane * V + i] = make_float2(s[i], s2[i]);
  __syncthreads();
  const long long out = (B.group * L.slices + B.slice) * L.channels;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int c = B.tile * width + j;
    if (c >= L.channels) continue;
    float2 t = red[j];
    for (int k = 1; k < L.row_lanes; ++k) t = add2(t, red[k * width + j]);
    part[out + c] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    bn_finalize_rows(const float2* __restrict__ part,
                     float2* __restrict__ moments, Rows L) {
  __shared__ float2 red[kThreads];
  const int cc = kThreads / L.q_lanes;
  const int ctiles = (L.channels + cc - 1) / cc;
  const long long g = blockIdx.x / ctiles;
  const int lane = threadIdx.x % cc, q_lane = threadIdx.x / cc;
  const int c = (int)(blockIdx.x % ctiles) * cc + lane;
  float2 s = make_float2(0.f, 0.f);
  if (c < L.channels)
    for (int q = q_lane; q < L.slices; q += L.q_lanes)
      s = add2(s, part[(g * L.slices + q) * L.channels + c]);
  red[threadIdx.x] = s;
  __syncthreads();
  if (q_lane != 0 || c >= L.channels) return;
  float2 t = red[lane];
  for (int k = 1; k < L.q_lanes; ++k) t = add2(t, red[k * cc + lane]);
  const float count = (float)L.rows;
  moments[g * L.channels + c] =
      make_float2(__fdiv_rn(t.x, count), __fdiv_rn(t.y, count));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_normalize_rows(const T* __restrict__ x, T* __restrict__ y,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias,
                      const float2* __restrict__ moments, Rows L,
                      float eps) {
  const RowBlock B = row_block(L, (long long)gridDim.x - 1 - blockIdx.x);
  const int lane = threadIdx.x & (L.lanes - 1);
  const int row_lane = threadIdx.x / L.lanes;
  const int cv = B.tile * L.lanes + lane;
  if (cv >= L.cvecs) return;
  float mean[V], inv[V], wc[V], bc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = cv * V + i;
    const float2 m = moments[B.group * L.channels + c];
    mean[i] = m.x;
    inv[i] = rsqrtf(__fadd_rn(__fsub_rn(m.y, __fmul_rn(m.x, m.x)), eps));
    wc[i] = weight[c];
    bc[i] = bias[c];
  }
  const int r0 = B.slice * L.slice;
  const int r1 = min(r0 + L.slice, L.rows);
  const long long at = B.group * L.rows * (long long)L.channels + cv * V;
  for (int r = r0 + row_lane; r < r1; r += kUnroll * L.row_lanes) {
    Raw<T, V> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * L.row_lanes;
      if (rr < r1)
        raw[u] = load<T, V>(x + at + (long long)rr * L.channels, true);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * L.row_lanes;
      if (rr >= r1) break;
      float f[V];
      to_float<T, V>(raw[u], f);
#pragma unroll
      for (int i = 0; i < V; ++i)
        f[i] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(f[i], mean[i]), inv[i]), wc[i]),
            bc[i]);
      store<T, V>(y + at + (long long)rr * L.channels, f);
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* y, const float* weight,
                   const float* bias, void* part, void* moments, long long N,
                   long long C, long long P, int per_frame, int slice,
                   int lanes, float eps, cudaStream_t s) {
  Rows L;
  L.groups = per_frame ? N : 1;
  L.rows = (int)(per_frame ? P : N * P);
  L.channels = (int)C;
  L.cvecs = (int)(C / V);
  L.lanes = lanes;
  L.row_lanes = kThreads / lanes;
  L.tiles = (L.cvecs + lanes - 1) / lanes;
  L.slice = slice;
  L.slices = (L.rows + slice - 1) / slice;
  int cc = 1;
  while (cc < 32 && cc < C) cc <<= 1;
  L.q_lanes = kThreads / cc;
  if (slice % L.row_lanes != 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(L.groups * L.slices * L.tiles);
  bn_moments_rows<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float2*>(part), L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned fblocks = (unsigned)(L.groups * ((C + cc - 1) / cc));
  bn_finalize_rows<<<fblocks, kThreads, 0, s>>>(
      static_cast<const float2*>(part), static_cast<float2*>(moments), L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_normalize_rows<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), weight, bias,
      static_cast<const float2*>(moments), L, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y [N,C,H,W] channels_last (row-major [N*P, C], P = H*W), dtype 0
// float32 or 1 bf16, 16-byte aligned when vec > 1; weight, bias [C]
// float32; part float2 scratch [row groups * slices * C]; moments float2
// out (mean, mean2), [N*C] per frame (per_frame 1) and [C] per chunk.
// vec is 1 or 16 / itemsize and divides C; slice rows a slice (a multiple
// of 256 / lanes); lanes the column lanes of a block, a power of two in
// [1, 256]; N*P is below 2^30, so the kernels index a group in 32 bits.
// Launches the passes on `stream`; returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for arguments outside those ranges,
// before any launch).
extern "C" int vp_bn(const void* x, void* y, const float* weight,
                     const float* bias, void* part, void* moments, int dtype,
                     int vec, long long N, long long C, long long P,
                     int per_frame, int slice, int lanes, float eps,
                     void* stream) {
  if (N <= 0 || C <= 0 || P <= 0 || N * P >= (1LL << 30) || slice <= 0 ||
      lanes < 1 || lanes > kThreads || (lanes & (lanes - 1)) != 0 ||
      (dtype != 0 && dtype != 1) || (vec != 1 && vec != (dtype ? 8 : 4)) ||
      C % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)(vec == 8
                     ? launch<__nv_bfloat16, 8>(x, y, weight, bias, part,
                                                moments, N, C, P, per_frame,
                                                slice, lanes, eps, s)
                     : launch<__nv_bfloat16, 1>(x, y, weight, bias, part,
                                                moments, N, C, P, per_frame,
                                                slice, lanes, eps, s));
  return (int)(vec == 4 ? launch<float, 4>(x, y, weight, bias, part, moments,
                                           N, C, P, per_frame, slice, lanes,
                                           eps, s)
                        : launch<float, 1>(x, y, weight, bias, part, moments,
                                           N, C, P, per_frame, slice, lanes,
                                           eps, s));
}

// ---------------------------------------------------------------------------
// The float32 batch norm of a training step, forward and backward.
//
// Replaces no TPU kernel either: the JAX StatelessBatchNorm reaches no
// pallas_call.  Eager PyTorch runs a grad-enabled call as ~14 kernels
// forward and ~30 backward, about 45 full-tensor float32 passes an
// element; these kernels make 8 (forward: x read for the moments, then
// read and y written; backward: x and dy read for the two sums, then read
// again and dx written), so bytes bound them: 8 x 4 x numel at 3.35 TB/s.
// Batch moments (0, 2, 3) only, over two layouts:
//
//   NCHW contiguous (planes): each channel is the sequence of its N planes
//       of P elements, in vectors of V floats (V = 4 where P, the strides
//       and the pointers allow 16-byte loads; D's 63x63 plane does not).
//       A block is (channel, slice of `slice` vectors); thread t takes
//       vectors j0 + t, j0 + t + 256, ... and steps its (frame, vector)
//       position by (256 / pv, 256 % pv), so no division in the loop.
//       bn_stats_planes sums each lane of a vector apart, then the lanes
//       in order, then the warp's threads as a tree (shuffle down 16, 8,
//       4, 2, 1), then the 8 warps in order: one partial a (channel,
//       slice).  bn_apply_planes writes y (forward) or dx (backward).
//   channels_last (rows): the forward is the served passes above (float32,
//       batch moments); the backward's sums run in bn_moments_rows' order
//       (bn_grad_rows) and dx streams as bn_normalize_rows does
//       (bn_dx_rows).  dy may have a longer row than C (a channel slice of
//       a channels_last cat), and in NCHW any frame and channel stride
//       with whole planes (a channel slice of an NCHW cat).
//
// bn_train_finalize combines a channel's partials as bn_finalize_rows
// does: forward, the moments (mean, mean2 = E[x^2]); backward, db = Sdy,
// dw = inv * Sdy(x - mean) and dx's coefficients, inv formed from the
// saved moments as the forward formed it.  dx = w inv (dy - Sdy / n -
// (x - mean) inv^2 Sdy(x - mean) / n), the gradient of the eager formula in
// real arithmetic.  As above: no atomics, every step an explicit
// round-to-nearest intrinsic, so ops/batchnorm.py's bn_train_plain
// restates the order of operations in torch and the card's output equals
// it bit for bit.

namespace {

struct Planes {
  int pv;            // vectors a plane: P / V
  int total;         // vectors a channel: N * pv
  int slice;         // vectors a block, a multiple of 256
  int slices;        // ceil(total / slice)
  int dn, dq;        // a thread's step: 256 / pv frames and 256 % pv vectors
  long long xn;      // x's (and the output's) frame stride in vectors
  long long gn, gc;  // dy's frame and channel strides in vectors
};

__device__ __forceinline__ void advance(const Planes& L, int& n, int& q) {
  q += L.dq;
  n += L.dn;
  if (q >= L.pv) {
    q -= L.pv;
    ++n;
  }
}

template <int V, bool GRAD>
__global__ void __launch_bounds__(kThreads)
    bn_stats_planes(const float* __restrict__ x, const float* __restrict__ dy,
                    const float2* __restrict__ moments,
                    float2* __restrict__ part, Planes L) {
  __shared__ float2 red[kThreads / 32];
  const int c = blockIdx.x / L.slices;
  const int s = blockIdx.x % L.slices;
  const int j1 = min((s + 1) * L.slice, L.total);
  const float mean = GRAD ? moments[c].x : 0.f;
  const float* xc = x + (long long)c * L.pv * V;
  const float* gc = GRAD ? dy + L.gc * c * V : x;
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
  int j = s * L.slice + threadIdx.x;
  int n = j / L.pv, q = j % L.pv;
  for (; j < j1; j += kUnroll * kThreads) {
    Raw<float, V> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < j1) {
        rx[u] = load<float, V>(xc + (n * L.xn + q) * V, false);
        if constexpr (GRAD)
          rg[u] = load<float, V>(gc + (n * L.gn + q) * V, false);
      }
      advance(L, n, q);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads >= j1) break;
      float f[V];
      to_float<float, V>(rx[u], f);
      if constexpr (GRAD) {
        float g[V];
        to_float<float, V>(rg[u], g);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] = __fadd_rn(a[i], g[i]);
          b[i] = __fadd_rn(b[i], __fmul_rn(g[i], __fsub_rn(f[i], mean)));
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] = __fadd_rn(a[i], f[i]);
          b[i] = __fadd_rn(b[i], __fmul_rn(f[i], f[i]));
        }
      }
    }
  }
  float sa = a[0], sb = b[0];
#pragma unroll
  for (int i = 1; i < V; ++i) {
    sa = __fadd_rn(sa, a[i]);
    sb = __fadd_rn(sb, b[i]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sa = __fadd_rn(sa, __shfl_down_sync(0xffffffffu, sa, d));
    sb = __fadd_rn(sb, __shfl_down_sync(0xffffffffu, sb, d));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(sa, sb);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = red[0];
    for (int w = 1; w < kThreads / 32; ++w) t = add2(t, red[w]);
    part[(long long)c * L.slices + s] = t;
  }
}

template <int V, bool GRAD>
__global__ void __launch_bounds__(kThreads)
    bn_apply_planes(const float* __restrict__ x, const float* __restrict__ dy,
                    float* __restrict__ out,
                    const float2* __restrict__ moments,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias,
                    const float4* __restrict__ coef, Planes L, float eps) {
  const int blk = gridDim.x - 1 - blockIdx.x;
  const int c = blk / L.slices;
  const int s = blk % L.slices;
  const int j1 = min((s + 1) * L.slice, L.total);
  float k0, k1, k2, k3;
  if constexpr (GRAD) {
    const float4 k = coef[c];
    k0 = k.x;
    k1 = k.y;
    k2 = k.z;
    k3 = k.w;
  } else {
    const float2 m = moments[c];
    k0 = m.x;
    k1 = rsqrtf(__fadd_rn(__fsub_rn(m.y, __fmul_rn(m.x, m.x)), eps));
    k2 = weight[c];
    k3 = bias[c];
  }
  const long long at = (long long)c * L.pv * V;
  const float* gc = GRAD ? dy + L.gc * c * V : x;
  int j = s * L.slice + threadIdx.x;
  int n = j / L.pv, q = j % L.pv;
  for (; j < j1; j += kUnroll * kThreads) {
    Raw<float, V> rx[kUnroll], rg[kUnroll];
    long long o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      o[u] = at + (n * L.xn + q) * V;
      if (j + u * kThreads < j1) {
        rx[u] = load<float, V>(x + o[u], true);
        if constexpr (GRAD)
          rg[u] = load<float, V>(gc + (n * L.gn + q) * V, true);
      }
      advance(L, n, q);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads >= j1) break;
      float f[V];
      to_float<float, V>(rx[u], f);
      if constexpr (GRAD) {
        float g[V];
        to_float<float, V>(rg[u], g);
#pragma unroll
        for (int i = 0; i < V; ++i)
          f[i] = __fmul_rn(k3, __fsub_rn(__fsub_rn(g[i], k1),
                                         __fmul_rn(__fsub_rn(f[i], k0), k2)));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          f[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i], k0), k1), k2),
                           k3);
      }
      store<float, V>(out + o[u], f);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_rows(const float* __restrict__ x, const float* __restrict__ dy,
                 const float2* __restrict__ moments,
                 float2* __restrict__ part, Rows L, long long grow) {
  __shared__ float2 red[kThreads * V];
  const RowBlock B = row_block(L, blockIdx.x);
  const int lane = threadIdx.x & (L.lanes - 1);
  const int row_lane = threadIdx.x / L.lanes;
  const int cv = B.tile * L.lanes + lane;
  float s[V], s2[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = s2[i] = mean[i] = 0.f;
  if (cv < L.cvecs) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      mean[i] = moments[B.group * L.channels + cv * V + i].x;
    const int r0 = B.slice * L.slice;
    const int r1 = min(r0 + L.slice, L.rows);
    const float* xb = x + B.group * L.rows * (long long)L.channels + cv * V;
    const float* gb = dy + B.group * L.rows * grow + cv * V;
    for (int r = r0 + row_lane; r < r1; r += kUnroll * L.row_lanes) {
      Raw<float, V> rx[kUnroll], rg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * L.row_lanes;
        if (rr < r1) {
          rx[u] = load<float, V>(xb + (long long)rr * L.channels, false);
          rg[u] = load<float, V>(gb + rr * grow, false);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * L.row_lanes >= r1) break;
        float f[V], g[V];
        to_float<float, V>(rx[u], f);
        to_float<float, V>(rg[u], g);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] = __fadd_rn(s[i], g[i]);
          s2[i] = __fadd_rn(s2[i], __fmul_rn(g[i], __fsub_rn(f[i], mean[i])));
        }
      }
    }
  }
  const int width = L.lanes * V;
#pragma unroll
  for (int i = 0; i < V; ++i)
    red[row_lane * width + lane * V + i] = make_float2(s[i], s2[i]);
  __syncthreads();
  const long long out = (B.group * L.slices + B.slice) * L.channels;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    const int c = B.tile * width + j;
    if (c >= L.channels) continue;
    float2 t = red[j];
    for (int k = 1; k < L.row_lanes; ++k) t = add2(t, red[k * width + j]);
    part[out + c] = t;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_dx_rows(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ dx, const float4* __restrict__ coef,
               Rows L, long long grow) {
  const RowBlock B = row_block(L, (long long)gridDim.x - 1 - blockIdx.x);
  const int lane = threadIdx.x & (L.lanes - 1);
  const int row_lane = threadIdx.x / L.lanes;
  const int cv = B.tile * L.lanes + lane;
  if (cv >= L.cvecs) return;
  float k0[V], k1[V], k2[V], k3[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float4 k = coef[B.group * L.channels + cv * V + i];
    k0[i] = k.x;
    k1[i] = k.y;
    k2[i] = k.z;
    k3[i] = k.w;
  }
  const int r0 = B.slice * L.slice;
  const int r1 = min(r0 + L.slice, L.rows);
  const long long at = B.group * L.rows * (long long)L.channels + cv * V;
  const float* gb = dy + B.group * L.rows * grow + cv * V;
  for (int r = r0 + row_lane; r < r1; r += kUnroll * L.row_lanes) {
    Raw<float, V> rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * L.row_lanes;
      if (rr < r1) {
        rx[u] = load<float, V>(x + at + (long long)rr * L.channels, true);
        rg[u] = load<float, V>(gb + rr * grow, true);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * L.row_lanes;
      if (rr >= r1) break;
      float f[V], g[V];
      to_float<float, V>(rx[u], f);
      to_float<float, V>(rg[u], g);
#pragma unroll
      for (int i = 0; i < V; ++i)
        f[i] = __fmul_rn(k3[i], __fsub_rn(__fsub_rn(g[i], k1[i]),
                                          __fmul_rn(__fsub_rn(f[i], k0[i]),
                                                    k2[i])));
      store<float, V>(dx + at + (long long)rr * L.channels, f);
    }
  }
}

template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
    bn_train_finalize(const float2* __restrict__ part, long long pc,
                      long long ps, int slices, int channels, int q_lanes,
                      float count, const float2* __restrict__ moments_in,
                      const float* __restrict__ weight, float eps,
                      float2* __restrict__ moments_out,
                      float4* __restrict__ coef, float* __restrict__ dw,
                      float* __restrict__ db) {
  __shared__ float2 red[kThreads];
  const int cc = kThreads / q_lanes;
  const int lane = threadIdx.x % cc, q_lane = threadIdx.x / cc;
  const int c = blockIdx.x * cc + lane;
  float2 s = make_float2(0.f, 0.f);
  if (c < channels)
    for (int q = q_lane; q < slices; q += q_lanes)
      s = add2(s, part[c * pc + q * ps]);
  red[threadIdx.x] = s;
  __syncthreads();
  if (q_lane != 0 || c >= channels) return;
  float2 t = red[lane];
  for (int k = 1; k < q_lanes; ++k) t = add2(t, red[k * cc + lane]);
  if constexpr (!GRAD) {
    moments_out[c] = make_float2(__fdiv_rn(t.x, count), __fdiv_rn(t.y, count));
  } else {
    const float2 m = moments_in[c];
    const float inv =
        rsqrtf(__fadd_rn(__fsub_rn(m.y, __fmul_rn(m.x, m.x)), eps));
    db[c] = t.x;
    dw[c] = __fmul_rn(inv, t.y);
    coef[c] = make_float4(m.x, __fdiv_rn(t.x, count),
                          __fmul_rn(__fmul_rn(inv, inv), __fdiv_rn(t.y, count)),
                          __fmul_rn(weight[c], inv));
  }
}

Planes planes(int vec, long long N, long long C, long long P, int slice,
              long long gn, long long gc) {
  Planes L;
  L.pv = (int)(P / vec);
  L.total = (int)(N * L.pv);
  L.slice = slice;
  L.slices = (L.total + slice - 1) / slice;
  L.dn = kThreads / L.pv;
  L.dq = kThreads % L.pv;
  L.xn = C * L.pv;
  L.gn = gn / vec;
  L.gc = gc / vec;
  return L;
}

int q_lanes_of(long long C) {
  int cc = 1;
  while (cc < 32 && cc < C) cc <<= 1;
  return kThreads / cc;
}

bool planes_ok(int vec, long long N, long long C, long long P, int slice) {
  return N > 0 && C > 0 && P > 0 && N * P < (1LL << 30) &&
         (vec == 1 || vec == 4) && P % vec == 0 && slice > 0 &&
         slice % kThreads == 0;
}

template <int V>
cudaError_t train_forward(const float* x, float* y, const float* weight,
                          const float* bias, float2* part, float2* moments,
                          long long N, long long C, long long P, int slice,
                          float eps, cudaStream_t s) {
  const Planes L = planes(V, N, C, P, slice, 0, 0);
  const unsigned blocks = (unsigned)(C * L.slices);
  bn_stats_planes<V, false><<<blocks, kThreads, 0, s>>>(x, nullptr, nullptr,
                                                         part, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int q = q_lanes_of(C);
  const unsigned fblocks = (unsigned)((C + kThreads / q - 1) / (kThreads / q));
  bn_train_finalize<false><<<fblocks, kThreads, 0, s>>>(
      part, L.slices, 1, L.slices, (int)C, q, (float)(N * P), nullptr,
      nullptr, eps, moments, nullptr, nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_apply_planes<V, false><<<blocks, kThreads, 0, s>>>(
      x, nullptr, y, moments, weight, bias, nullptr, L, eps);
  return cudaGetLastError();
}

template <int V>
cudaError_t train_backward_planes(const float* x, const float* dy, float* dx,
                                  const float* weight, const float2* moments,
                                  float2* part, float4* coef, float* dw,
                                  float* db, long long N, long long C,
                                  long long P, long long gn, long long gc,
                                  int slice, float eps, cudaStream_t s) {
  const Planes L = planes(V, N, C, P, slice, gn, gc);
  const unsigned blocks = (unsigned)(C * L.slices);
  bn_stats_planes<V, true><<<blocks, kThreads, 0, s>>>(x, dy, moments, part,
                                                        L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int q = q_lanes_of(C);
  const unsigned fblocks = (unsigned)((C + kThreads / q - 1) / (kThreads / q));
  bn_train_finalize<true><<<fblocks, kThreads, 0, s>>>(
      part, L.slices, 1, L.slices, (int)C, q, (float)(N * P), moments, weight,
      eps, nullptr, coef, dw, db);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return err;
  bn_apply_planes<V, true><<<blocks, kThreads, 0, s>>>(
      x, dy, dx, nullptr, nullptr, nullptr, coef, L, eps);
  return cudaGetLastError();
}

template <int V>
cudaError_t train_backward_rows(const float* x, const float* dy, float* dx,
                                const float* weight, const float2* moments,
                                float2* part, float4* coef, float* dw,
                                float* db, long long N, long long C,
                                long long P, long long grow, int slice,
                                int lanes, float eps, cudaStream_t s) {
  Rows L;
  L.groups = 1;
  L.rows = (int)(N * P);
  L.channels = (int)C;
  L.cvecs = (int)(C / V);
  L.lanes = lanes;
  L.row_lanes = kThreads / lanes;
  L.tiles = (L.cvecs + lanes - 1) / lanes;
  L.slice = slice;
  L.slices = (L.rows + slice - 1) / slice;
  L.q_lanes = q_lanes_of(C);
  if (slice % L.row_lanes != 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(L.slices * L.tiles);
  bn_grad_rows<V><<<blocks, kThreads, 0, s>>>(x, dy, moments, part, L, grow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cc = kThreads / L.q_lanes;
  const unsigned fblocks = (unsigned)((C + cc - 1) / cc);
  bn_train_finalize<true><<<fblocks, kThreads, 0, s>>>(
      part, 1, C, L.slices, (int)C, L.q_lanes, (float)L.rows, moments,
      weight, eps, nullptr, coef, dw, db);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return err;
  bn_dx_rows<V><<<blocks, kThreads, 0, s>>>(x, dy, dx, coef, L, grow);
  return cudaGetLastError();
}

}  // namespace

// The training forward of a contiguous NCHW float32 x [N,C,H,W] (P = H*W)
// with batch moments: y (NCHW), moments float2 (mean, mean2) [C]; part
// float2 scratch [C * ceil(N*P/vec / slice)]; weight, bias [C].  vec 1 or
// 4 (4: P a multiple of 4 and x, y 16-byte aligned); slice vectors a
// block, a multiple of 256; N*P below 2^30.  Launches three passes on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments outside those ranges, before any launch).
extern "C" int vp_bn_train_forward(const float* x, float* y,
                                   const float* weight, const float* bias,
                                   void* part, void* moments, int vec,
                                   long long N, long long C, long long P,
                                   int slice, float eps, void* stream) {
  if (!planes_ok(vec, N, C, P, slice)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float2* pt = static_cast<float2*>(part);
  float2* m = static_cast<float2*>(moments);
  return (int)(vec == 4 ? train_forward<4>(x, y, weight, bias, pt, m, N, C, P,
                                           slice, eps, s)
                        : train_forward<1>(x, y, weight, bias, pt, m, N, C, P,
                                           slice, eps, s));
}

// The training backward of x [N,C,H,W] float32 with batch moments: from dy
// and the forward's moments (float2 [C]), db = Sdy and dw = inv Sdy(x -
// mean) [C], and dx (x's layout) unless dx is null.  layout 0: x
// contiguous NCHW, dy with whole planes at frame stride g0 and channel
// stride g1 (elements), cut by `slice` vectors as the forward; part
// float2 [C * slices].  layout 1: x channels_last, dy's pixels at row
// stride g0 (elements, C or more), cut as the served passes cut a batch
// (slice rows, lanes column lanes); part float2 [slices * C].  coef
// float4 scratch [C].  vec 1 or 4 (4: the plane or C and the strides
// multiples of 4, every pointer 16-byte aligned).  Returns
// cudaGetLastError() (cudaErrorInvalidValue before any launch for
// arguments outside those ranges).
extern "C" int vp_bn_train_backward(int layout, const float* x,
                                    const float* dy, float* dx,
                                    const float* weight, const void* moments,
                                    void* part, void* coef, float* dw,
                                    float* db, int vec, long long N,
                                    long long C, long long P, long long g0,
                                    long long g1, int slice, int lanes,
                                    float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float2* m = static_cast<const float2*>(moments);
  float2* pt = static_cast<float2*>(part);
  float4* k = static_cast<float4*>(coef);
  if (layout == 0) {
    if (!planes_ok(vec, N, C, P, slice) || g0 % vec != 0 || g1 % vec != 0)
      return (int)cudaErrorInvalidValue;
    return (int)(vec == 4 ? train_backward_planes<4>(x, dy, dx, weight, m, pt,
                                                     k, dw, db, N, C, P, g0,
                                                     g1, slice, eps, s)
                          : train_backward_planes<1>(x, dy, dx, weight, m, pt,
                                                     k, dw, db, N, C, P, g0,
                                                     g1, slice, eps, s));
  }
  if (layout != 1 || N <= 0 || C <= 0 || P <= 0 || N * P >= (1LL << 30) ||
      slice <= 0 || lanes < 1 || lanes > kThreads ||
      (lanes & (lanes - 1)) != 0 || (vec != 1 && vec != 4) || C % vec != 0 ||
      g0 < C || g0 % vec != 0)
    return (int)cudaErrorInvalidValue;
  return (int)(vec == 4 ? train_backward_rows<4>(x, dy, dx, weight, m, pt, k,
                                                 dw, db, N, C, P, g0, slice,
                                                 lanes, eps, s)
                        : train_backward_rows<1>(x, dy, dx, weight, m, pt, k,
                                                 dw, db, N, C, P, g0, slice,
                                                 lanes, eps, s));
}
