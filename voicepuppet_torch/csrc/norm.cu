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
