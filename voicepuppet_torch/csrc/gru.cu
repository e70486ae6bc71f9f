// The masked GRU recurrence of the coefficient programs for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's masked_gru
// (voicepuppet_tpu/models/layers.py) is an nn.scan, which XLA compiles into
// one device loop.  Eager PyTorch ran it as a Python loop of ~11 launches a
// step (two cats, two addmms, a sigmoid, a tanh, five elementwise ops), each
// a 256-wide float32 matrix-vector product or smaller, so the card waited on
// the host for nearly all of a clip's recurrence.
//
// What bounds it: the steps are a chain, each needing the whole state of the
// one before.  A step is 3U x U multiply-adds (196,608 at U = 256) against
// weights that stay the same over the clip, so the work is latency: the
// weights' reads from shared memory, the dot products' reductions and the
// exchange of the state between the blocks that share a row.
//
// The input half of the gates, xg = x W_x^T + b for every step, is one
// matrix product before this kernel (ops/gru.py).  Here:
//
//   r, u = sigmoid(xg_g + W_gh h),  c = tanh(xg_c + W_ch (r * h)),
//   h' = u * h + (1 - u) * c,
//
// for t < seq_len of each row; outputs at t >= seq_len are zeros and the
// final state is h after seq_len steps (h0 for an empty row), which is what
// dynamic_rnn's masked outputs and frozen carry give.
//
// One thread-block cluster per row, U / 32 blocks (8 at U = 256, the
// portable cluster maximum), each owning 32 hidden units and holding its
// rows of W_h (the 32 r rows, 32 u rows and 32 c rows of its units, 96 x U
// floats, 98,304 B at U = 256) in shared memory, loaded once.  Every block
// keeps a copy of the whole state h and of r * h.  A step:
//   (a) each warp takes 8 gate rows: every lane sums 8 rows over its U / 32
//       columns (lane, lane + 32, ...: conflict-free shared loads), then a
//       butterfly that halves the rows each round reduces the warp's 8 sums
//       in 9 shuffles; the r lanes write r * h of their unit into every
//       block of the cluster (distributed shared memory), the u lanes keep u;
//       cluster barrier;
//   (b) each warp takes 4 candidate rows against r * h, likewise; the lane
//       of each unit forms h', stores it to out[t] and writes it into every
//       block's copy of h; cluster barrier.
// The barrier orders a step's reads of h and r * h before the next writes,
// so one copy of each suffices.  xg of the next step is loaded while the
// current one runs.  float32 FMAs on the CUDA cores throughout (no TF32),
// expf and tanhf (no fast-math approximations).  The sums run in a fixed
// order, so a result is the same from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 32;                 // hidden units a block owns
constexpr int kRows = 3 * kUnits;          // its rows of W_h: r, u, c
constexpr int kGateRows = 2 * kUnits / kWarps;   // 8 a warp
constexpr int kCandRows = kUnits / kWarps;       // 4 a warp
constexpr unsigned kFull = 0xffffffffu;

// One round of the butterfly: of the values v[0, 2m) each lane keeps the
// half chosen by its `bit` and adds its partner's copy of that half.
template <int M>
__device__ __forceinline__ void halve(const float (&v)[2 * M], float (&k)[M],
                                      bool upper, int bit) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float give = upper ? v[i] : v[i + M];
    const float keep = upper ? v[i + M] : v[i];
    k[i] = keep + __shfl_xor_sync(kFull, give, bit);
  }
}

// The warp's sums of 8 rows: lane l returns row ((l >> 2) & 7)'s.
__device__ __forceinline__ float reduce8(const float (&v)[8], int lane) {
  float a[4], b[2], c[1];
  halve<4>(v, a, lane & 16, 16);
  halve<2>(a, b, lane & 8, 8);
  halve<1>(b, c, lane & 4, 4);
  float s = c[0];
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// The warp's sums of 4 rows: lane l returns row ((l >> 3) & 3)'s.
__device__ __forceinline__ float reduce4(const float (&v)[4], int lane) {
  float a[2], b[1];
  halve<2>(v, a, lane & 16, 16);
  halve<1>(a, b, lane & 8, 8);
  float s = b[0];
  s += __shfl_xor_sync(kFull, s, 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return s;
}

// Rows `first` .. first + R of this block's W_h slice against the vector
// v (in shared memory, U = 32 N long): each lane's partial sums.
template <int N, int R>
__device__ __forceinline__ void partial_rows(const float* w, const float* v,
                                             int first, int lane,
                                             float (&acc)[R]) {
  constexpr int U = 32 * N;
  float x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = v[lane + 32 * j];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float* row = w + (first + k) * U + lane;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) s = fmaf(row[32 * j], x[j], s);
    acc[k] = s;
  }
}

// xg [B,T,3U], w_h [3U,U] with row stride ldw, h0 [B,U] or null (zeros),
// seq_len [B] int64 -> out [B,T,U], h_final [B,U].  Grid: B clusters of N
// blocks, 256 threads each.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    gru_recurrence_kernel(const float* __restrict__ xg,
                          const float* __restrict__ w_h, long long ldw,
                          const float* __restrict__ h0,
                          const long long* __restrict__ seq_len,
                          float* __restrict__ out,
                          float* __restrict__ h_final, int T) {
  constexpr int U = 32 * N;
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);   // [kRows][U]
  float* h = w + kRows * U;                     // [U] the state
  float* rh = h + U;                            // [U] r * h
  float* ub = rh + U;                           // [kUnits] this block's u

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int own = rank * kUnits;

  for (int i = tid; i < kRows * U; i += kThreads) {
    const int row = i / U, col = i - row * U;
    const int part = row / kUnits, j = row - part * kUnits;
    w[i] = w_h[(long long)(part * U + own + j) * ldw + col];
  }
  for (int i = tid; i < U; i += kThreads) h[i] = h0 ? h0[b * U + i] : 0.f;
  const long long len = seq_len[b];
  const int steps = len <= 0 ? 0 : (len >= T ? T : (int)len);

  // the rows whose sums this lane finishes: gate row ga (r for ga < 32, u
  // after) in (a), candidate row jc in (b)
  const int ga = warp * kGateRows + (lane >> 2);
  const int jc = warp * kCandRows + (lane >> 3);
  const bool a_lead = (lane & 3) == 0, c_lead = (lane & 7) == 0;
  const int gcol = ga < kUnits ? own + ga : U + own + (ga - kUnits);
  const int ccol = 2 * U + own + jc;
  const float* x = xg + b * T * 3 * U;
  float xa = 0.f, xc = 0.f;
  if (steps > 0) {
    if (a_lead) xa = x[gcol];
    if (c_lead) xc = x[ccol];
  }
  cluster.sync();   // every block of the row has started and holds h0

  for (int t = 0; t < steps; ++t) {
    float xa_next = 0.f, xc_next = 0.f;
    if (t + 1 < steps) {
      const float* xn = x + (long long)(t + 1) * 3 * U;
      if (a_lead) xa_next = xn[gcol];
      if (c_lead) xc_next = xn[ccol];
    }
    {
      float acc[kGateRows];
      partial_rows<N, kGateRows>(w, h, warp * kGateRows, lane, acc);
      const float g = reduce8(acc, lane);
      if (a_lead) {
        const float s = 1.f / (1.f + expf(-(xa + g)));
        if (ga < kUnits) {
          const float v = s * h[own + ga];
#pragma unroll
          for (int q = 0; q < N; ++q)
            cluster.map_shared_rank(rh, q)[own + ga] = v;
        } else {
          ub[ga - kUnits] = s;
        }
      }
    }
    cluster.sync();
    {
      float acc[kCandRows];
      partial_rows<N, kCandRows>(w, rh, 2 * kUnits + warp * kCandRows, lane,
                                 acc);
      const float g = reduce4(acc, lane);
      if (c_lead) {
        const float c = tanhf(xc + g);
        const float u = ub[jc];
        const float hn = u * h[own + jc] + (1.f - u) * c;
        out[(b * T + t) * U + own + jc] = hn;
#pragma unroll
        for (int q = 0; q < N; ++q)
          cluster.map_shared_rank(h, q)[own + jc] = hn;
      }
    }
    cluster.sync();
    xa = xa_next;
    xc = xc_next;
  }

  for (int i = tid; i < (T - steps) * kUnits; i += kThreads) {
    const int t = steps + i / kUnits, j = i % kUnits;
    out[(b * T + t) * U + own + j] = 0.f;
  }
  if (tid < kUnits) h_final[b * U + own + tid] = h[own + tid];
}

template <int N>
cudaError_t launch(const float* xg, const float* w_h, long long ldw,
                   const float* h0, const long long* seq_len, float* out,
                   float* h_final, int B, int T, cudaStream_t stream) {
  constexpr int U = 32 * N;
  const size_t smem = (size_t)(kRows * U + 2 * U + kUnits) * sizeof(float);
  auto kernel = gru_recurrence_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xg, w_h, ldw, h0, seq_len, out,
                           h_final, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The recurrence of one GRU layer (see the top of this file); ops/gru.py
// checks the tensors.  Returns a cudaError_t, 0 when launched.
extern "C" int vp_gru(const void* xg, const void* w_h, long long ldw,
                      const void* h0, const void* seq_len, void* out,
                      void* h_final, int B, int U, int T, void* stream) {
  if (B <= 0 || T <= 0 || U < 32 || U > 256 || U % 32 != 0 || ldw < U ||
      (long long)B * (U / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xg;
  const float* w = (const float*)w_h;
  const float* h = (const float*)h0;
  const long long* n = (const long long*)seq_len;
  float* o = (float*)out;
  float* f = (float*)h_final;
  cudaStream_t s = (cudaStream_t)stream;
  switch (U / 32) {
    case 1: return (int)launch<1>(x, w, ldw, h, n, o, f, B, T, s);
    case 2: return (int)launch<2>(x, w, ldw, h, n, o, f, B, T, s);
    case 3: return (int)launch<3>(x, w, ldw, h, n, o, f, B, T, s);
    case 4: return (int)launch<4>(x, w, ldw, h, n, o, f, B, T, s);
    case 5: return (int)launch<5>(x, w, ldw, h, n, o, f, B, T, s);
    case 6: return (int)launch<6>(x, w, ldw, h, n, o, f, B, T, s);
    case 7: return (int)launch<7>(x, w, ldw, h, n, o, f, B, T, s);
    default: return (int)launch<8>(x, w, ldw, h, n, o, f, B, T, s);
  }
}
