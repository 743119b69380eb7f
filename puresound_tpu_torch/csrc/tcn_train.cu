// One whole residual TCN block for training, for Hopper (sm_90a): forward,
// and backward with the forward recomputed.
//
// Replaces the Pallas TPU kernels of puresound_tpu/ops/tcn_train_kernel.py:
//   _run_fwd (pallas_call at :353, body _make_fwd_kernel) and
//   _run_bwd (pallas_call at :383, body _make_bwd_kernel),
// the forward and the custom VJP of tcn_block_train. Per sample b, on
// x [B, C, T] with hidden width Ch, k depthwise taps and a dilation d:
//   h1 = W_in x                      a1 = PReLU1(gLN1(h1))
//   h2 = dwconv(a1) + b_dw           a2 = PReLU2(gGN2(h2))
//   h3 = W_pw a2 + b_pw              a3 = PReLU3(gGN3(h3))
//   y  = W_out a3 + b_out + x
// The taps read a1 at t + j*d - ((k-1)/2)*d, zero outside [0, T). Every norm
// is global per sample over (Ch, T): mean and the single-pass variance
// max(E[h^2] - mean^2, 0), eps 1e-8, over the real count Ch*T. All math is
// float32; each operand of the three 1x1 products (and of their weight
// gradients) is rounded to the dot dtype (bfloat16 for bfloat16 x) and
// summed in float32. x, y, dy and dx are in x's dtype; the parameters come
// in as float32 (bfloat16 values are exact in it) and the gradients go out
// as float32 sums over the batch.
//
// What bounds it on the H100. At the speaker net's training shape (B = 64,
// C = 128, Ch = 256, T = 1,999) the three 1x1 products are 33.5 GFLOP in the
// forward and about 100.6 GFLOP in the backward with its recompute; x is
// 65.5 MB in float32. In float32 without tensor cores (67 TFLOP/s) the block
// is bound by operations: about 0.50 ms forward and 1.50 ms backward. In
// bf16 (989 TFLOP/s) it is bound by bytes. These products run here on CUDA
// cores, tiled through shared memory: tensor cores are later work.
//
// What this design does about it. A sample's hidden activation (2 MB at
// T = 1,999) does not fit one SM, and each global norm needs the whole
// sample's statistics before it can normalise, so the block is MULTI-PASS
// with float32 scratch in device memory (h1, h2, h3; two more for the
// backward), each pass normalising its input on load:
//   forward   GEMM W_in x (+ per-tile sums of h, h^2) -> stats reduce
//             -> depthwise over PReLU1(gLN1(h1)) (+ per-row sums) -> reduce
//             -> GEMM W_pw over PReLU2(gGN2(h2)) (+ sums) -> reduce
//             -> GEMM W_out over PReLU3(gGN3(h3)) + b_out + x
//   backward  the three forward passes above, then per level: a GEMM with
//             the transposed weight for the input gradient, a row pass for
//             the PReLU and norm VJPs (per (b, c) row sums of dy*xhat, dy
//             and the alpha term, in place over the incoming gradient), a
//             fixed-order reduce for the per-sample sums and the norm and
//             alpha gradients, and a tiled weight-gradient product over
//             fixed ranges of the B*T columns whose partials are added in a
//             fixed order. The depthwise VJP is one row pass that also runs
//             PReLU1/gLN1's. No atomics: the result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // GEMM / weight-gradient tile (rows x columns)
constexpr int KS = 16;        // GEMM depth per shared-memory stage
constexpr int RB = 32;        // weight-gradient columns per stage
constexpr int PAD = 68;       // padded row of a staged tile (16-byte aligned)
constexpr int THREADS = 256;  // every kernel
constexpr int MAXK = 8;       // most depthwise taps
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float ldf(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// round a dot operand to the dot dtype T (identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// An operand [B, rows, T] as a pass reads it:
//   RAW    a tensor in x's dtype (x, dy);
//   ACT    PReLU(gamma * (h - mean) * rstd + beta) of a float32 h (a1, a2, a3);
//   DNORM  rstd * (g * dyn - m1 - xhat * m2), the norm's input gradient from
//          dyn (the gradient after the PReLU) and h.
enum { RAW = 0, ACT = 1, DNORM = 2 };

struct Src {
  int mode;
  const void* raw;
  const float* h;
  const float* dyn;
  const float* mean;
  const float* rstd;
  const float* m1;
  const float* m2;
  const float* g;
  const float* beta;
  const float* al;
};

__device__ __forceinline__ float prelu(float y, float al) { return y >= 0.f ? y : al * y; }

template <typename T>
__device__ __forceinline__ float load_src(const Src& s, long idx, int b, int r) {
  if (s.mode == RAW) return ldf(static_cast<const T*>(s.raw), idx);
  const float xhat = (s.h[idx] - s.mean[b]) * s.rstd[b];
  if (s.mode == ACT) return prelu(xhat * s.g[r] + s.beta[r], s.al[0]);
  return s.rstd[b] * (s.dyn[idx] * s.g[r] - s.m1[b] - xhat * s.m2[b]);
}

// sums v[0..N) over the block in a fixed order (every thread gets them)
template <int N, typename F>
__device__ __forceinline__ void block_sum(F* v) {
  __shared__ F red[THREADS / 32][N];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
  if (lane == 0)
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp][n] = v[n];
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    F s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][n];
    v[n] = s;
  }
  __syncthreads();
}

// ------------------------------------------------------------------- GEMM
// out[b, o, t] = sum_k W[o, k] * in[b, k, t] (+ bias[o]) (+ res[b, o, t]);
// with `part`, per-tile sums of the value before `res` (the norm statistics)
struct GemmParams {
  const float* w;     // [O, K]
  Src in;             // [B, K, T]
  const float* bias;  // [O] or null
  const void* res;    // [B, O, T] in x's dtype, or null
  void* out;          // [B, O, T]: float32 scratch, or x's dtype when typed_out
  float* part;        // [B, P, 2] or null, P = the tiles of one sample
  int O, K, T, typed_out;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 4) tcn_gemm_kernel(GemmParams p) {
  __shared__ __align__(16) float w_s[KS][PAD];  // [k][o]
  __shared__ __align__(16) float x_s[KS][PAD];  // [k][t]
  const int t0 = blockIdx.x * TILE, o0 = blockIdx.y * TILE, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int O = p.O, K = p.K, Tn = p.T;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KS) {
#pragma unroll
    for (int q = 0; q < KS * TILE / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int oo = e / KS, kk = e % KS, o = o0 + oo, k = k0 + kk;
      w_s[kk][oo] = (o < O && k < K) ? rnd<T>(p.w[(long)o * K + k]) : 0.f;
      const int kx = e / TILE, tt = e % TILE, kg = k0 + kx, t = t0 + tt;
      x_s[kx][tt] = (kg < K && t < Tn)
                        ? rnd<T>(load_src<T>(p.in, ((long)b * K + kg) * Tn + t, b, kg))
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(&w_s[kk][ty * 4]);
      const float4 x4 = *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
    }
    __syncthreads();
  }

  float sums[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= O) continue;
    const float bo = p.bias != nullptr ? p.bias[o] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx * 4 + j;
      if (t >= Tn) continue;
      const long idx = ((long)b * O + o) * Tn + t;
      float v = acc[i][j] + bo;
      sums[0] += v;
      sums[1] += v * v;
      if (p.typed_out) {
        if (p.res != nullptr) v += ldf(static_cast<const T*>(p.res), idx);
        stf(static_cast<T*>(p.out), idx, v);
      } else {
        static_cast<float*>(p.out)[idx] = v;
      }
    }
  }
  if (p.part != nullptr) {
    block_sum<2>(sums);
    if (tid == 0) {
      const long P = (long)gridDim.x * gridDim.y;
      float* dst = p.part + ((long)b * P + blockIdx.y * gridDim.x + blockIdx.x) * 2;
      dst[0] = sums[0];
      dst[1] = sums[1];
    }
  }
}

// -------------------------------------------------------- weight gradient
// dW[o, k] = sum over the B*T columns of d[b, o, t] * a[b, k, t], per fixed
// range z of columns; dbias[o] = the same sum of the unrounded d
struct WgradParams {
  Src d;          // [B, O, T]
  Src a;          // [B, K, T]
  float* w_part;  // [n_split, O, K]
  float* b_part;  // [n_split, O] or null
  int O, K, T, B, cols_per_split;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) tcn_wgrad_kernel(WgradParams p) {
  __shared__ __align__(16) float d_s[RB][PAD];  // rounded d, [col][o]
  __shared__ __align__(16) float a_s[RB][PAD];  // rounded a, [col][k]
  __shared__ float du_s[RB][TILE];              // unrounded d (dbias)
  const int k0 = blockIdx.x * TILE, o0 = blockIdx.y * TILE, z = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int O = p.O, K = p.K, Tn = p.T;
  const int R = p.B * Tn;  // the wrapper keeps B * T below 2^31
  const int r_begin = z * p.cols_per_split;
  const int r_end = min(R, r_begin + p.cols_per_split);
  const bool do_bias = p.b_part != nullptr && blockIdx.x == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += RB) {
#pragma unroll
    for (int q = 0; q < RB * TILE / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int rr = e % RB, row = e / RB, r = r0 + rr;
      float dv = 0.f, av = 0.f;
      if (r < r_end) {
        const int b = r / Tn, t = r - b * Tn;
        const int o = o0 + row, k = k0 + row;
        if (o < O) dv = load_src<T>(p.d, ((long)b * O + o) * Tn + t, b, o);
        if (k < K) av = load_src<T>(p.a, ((long)b * K + k) * Tn + t, b, k);
      }
      d_s[rr][row] = rnd<T>(dv);
      du_s[rr][row] = dv;
      a_s[rr][row] = rnd<T>(av);
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < RB; ++rr) {
      const float4 d4 = *reinterpret_cast<const float4*>(&d_s[rr][ty * 4]);
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[rr][tx * 4]);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += dv[i] * av[j];
    }
    if (do_bias && tid < TILE)
      for (int rr = 0; rr < RB; ++rr) bacc += du_s[rr][tid];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty * 4 + i, k = k0 + tx * 4 + j;
      if (o < O && k < K) p.w_part[((long)z * O + o) * K + k] = acc[i][j];
    }
  if (do_bias && tid < TILE && o0 + tid < O) p.b_part[(long)z * O + o0 + tid] = bacc;
}

// sums the column-range partials in a fixed order
__global__ void tcn_wgrad_reduce(const float* w_part, const float* b_part, float* dw,
                                 float* db, int O, int K, int n_split) {
  const long OK = (long)O * K;
  const long total = OK + (b_part != nullptr ? O : 0);
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (idx < OK) {
      for (int z = 0; z < n_split; ++z) s += w_part[z * OK + idx];
      dw[idx] = s;
    } else {
      const long o = idx - OK;
      for (int z = 0; z < n_split; ++z) s += b_part[(long)z * O + o];
      db[o] = s;
    }
  }
}

// ------------------------------------------------------------- statistics
// per sample: mean and rstd from the [P, 2] partial sums, in double
__global__ void __launch_bounds__(THREADS) tcn_stats_reduce(const float* part, int P,
                                                            double count, float* mean,
                                                            float* rstd) {
  const int b = blockIdx.x;
  double s[2] = {0.0, 0.0};
  for (int q = threadIdx.x; q < P; q += THREADS) {
    s[0] += part[((long)b * P + q) * 2];
    s[1] += part[((long)b * P + q) * 2 + 1];
  }
  block_sum<2>(s);
  if (threadIdx.x == 0) {
    const double m = s[0] / count;
    const double var = fmax(s[1] / count - m * m, 0.0);
    mean[b] = (float)m;
    rstd[b] = (float)(1.0 / sqrt(var + (double)EPS));
  }
}

// ---------------------------------------------------------- depthwise pass
struct DwParams {
  Src a1;             // ACT of h1
  const float* w_dw;  // [Ch, k]
  const float* b_dw;  // [Ch]
  float* h2;          // [B, Ch, T]
  float* part;        // [B, Ch, 2]
  int Ch, T, kw, dil, pad;
};

// one block per (c, b) row: h2 = sum_j w[j] * a1(t + j*d - pad) + b_dw
__global__ void __launch_bounds__(THREADS) tcn_dw_fwd_kernel(DwParams p) {
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T;
  const long row = ((long)b * p.Ch + c) * Tn;
  float w[MAXK];
  for (int j = 0; j < p.kw; ++j) w[j] = p.w_dw[c * p.kw + j];
  float sums[2] = {0.f, 0.f};
  for (int t = threadIdx.x; t < Tn; t += THREADS) {
    float acc = 0.f;
    for (int j = 0; j < p.kw; ++j) {
      const int ts = t + j * p.dil - p.pad;
      const float a = (ts >= 0 && ts < Tn) ? load_src<float>(p.a1, row + ts, b, c) : 0.f;
      acc = j == 0 ? w[j] * a : acc + w[j] * a;
    }
    const float h = acc + p.b_dw[c];
    p.h2[row + t] = h;
    sums[0] += h;
    sums[1] += h * h;
  }
  block_sum<2>(sums);
  if (threadIdx.x == 0) {
    p.part[((long)b * p.Ch + c) * 2] = sums[0];
    p.part[((long)b * p.Ch + c) * 2 + 1] = sums[1];
  }
}

// ---------------------------------------------------- norm / PReLU VJPs
struct NormRowParams {
  float* g_io;  // [B, Ch, T]: da in, dyn = da * PReLU'(y) out
  Src y;        // h with its stats, gamma, beta (y = gamma * xhat + beta), alpha
  float* rows;  // [B, Ch, 3]: sum dyn*xhat, sum dyn, sum da*min(y, 0)
  int Ch, T;
};

__global__ void __launch_bounds__(THREADS) tcn_norm_rows_kernel(NormRowParams p) {
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T;
  const long row = ((long)b * p.Ch + c) * Tn;
  const float mean = p.y.mean[b], rstd = p.y.rstd[b];
  const float g = p.y.g[c], be = p.y.beta[c], al = p.y.al[0];
  float s[3] = {0.f, 0.f, 0.f};
  for (int t = threadIdx.x; t < Tn; t += THREADS) {
    const float xhat = (p.y.h[row + t] - mean) * rstd;
    const float y = xhat * g + be;
    const float da = p.g_io[row + t];
    const float dyn = da * (y >= 0.f ? 1.f : al);
    p.g_io[row + t] = dyn;
    s[0] += dyn * xhat;
    s[1] += dyn;
    s[2] += da * (y < 0.f ? y : 0.f);
  }
  block_sum<3>(s);
  if (threadIdx.x == 0)
    for (int q = 0; q < 3; ++q) p.rows[((long)b * p.Ch + c) * 3 + q] = s[q];
}

// the depthwise VJP (dW_dw, db_dw, da1) and PReLU1/gLN1's row pass in one:
// one block per (c, b) row
struct DwBwdParams {
  Src dh2;            // DNORM of (dyn2, h2)
  Src a1;             // ACT of h1 (the taps' input)
  const float* w_dw;  // [Ch, k]
  float* dyn1;        // [B, Ch, T] out
  float* rows;        // [B, Ch, 3] as tcn_norm_rows_kernel's, for level 1
  float* dw_rows;     // [B, Ch, 1 + k]: sum dh2, sum dh2 * a1(t + s_j)
  int Ch, T, kw, dil, pad;
};

__global__ void __launch_bounds__(THREADS) tcn_dw_bwd_kernel(DwBwdParams p) {
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T;
  const long row = ((long)b * p.Ch + c) * Tn;
  float w[MAXK];
  for (int j = 0; j < p.kw; ++j) w[j] = p.w_dw[c * p.kw + j];
  const float mean = p.a1.mean[b], rstd = p.a1.rstd[b];
  const float g = p.a1.g[c], be = p.a1.beta[c], al = p.a1.al[0];
  float s[3] = {0.f, 0.f, 0.f};
  float sw[1 + MAXK];
  for (int j = 0; j <= MAXK; ++j) sw[j] = 0.f;
  for (int t = threadIdx.x; t < Tn; t += THREADS) {
    const float d = load_src<float>(p.dh2, row + t, b, c);
    sw[0] += d;
    float da = 0.f;
    for (int j = 0; j < p.kw; ++j) {
      const int s_j = j * p.dil - p.pad;
      const int ta = t + s_j, td = t - s_j;
      if (ta >= 0 && ta < Tn) sw[1 + j] += d * load_src<float>(p.a1, row + ta, b, c);
      const float dd = (td >= 0 && td < Tn) ? load_src<float>(p.dh2, row + td, b, c) : 0.f;
      da = j == 0 ? w[j] * dd : da + w[j] * dd;
    }
    const float xhat = (p.a1.h[row + t] - mean) * rstd;
    const float y = xhat * g + be;
    const float dyn = da * (y >= 0.f ? 1.f : al);
    p.dyn1[row + t] = dyn;
    s[0] += dyn * xhat;
    s[1] += dyn;
    s[2] += da * (y < 0.f ? y : 0.f);
  }
  block_sum<3>(s);
  block_sum<1 + MAXK>(sw);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) p.rows[((long)b * p.Ch + c) * 3 + q] = s[q];
    for (int q = 0; q <= p.kw; ++q) p.dw_rows[((long)b * p.Ch + c) * (1 + p.kw) + q] = sw[q];
  }
}

// blocks 0..B-1: per sample m1 = sum_c g[c] * rows[b, c, 1] / count and
// m2 = sum_c g[c] * rows[b, c, 0] / count; block B: dgamma[c], dbeta[c]
// (sums over b) and dalpha (the sum over b and c)
__global__ void __launch_bounds__(THREADS) tcn_norm_reduce(const float* rows, const float* g,
                                                           int B, int Ch, float count,
                                                           float* m1, float* m2,
                                                           float* dgamma, float* dbeta,
                                                           float* dalpha) {
  if (blockIdx.x < B) {
    const int b = blockIdx.x;
    float s[2] = {0.f, 0.f};
    for (int c = threadIdx.x; c < Ch; c += THREADS) {
      s[0] += g[c] * rows[((long)b * Ch + c) * 3 + 1];
      s[1] += g[c] * rows[((long)b * Ch + c) * 3];
    }
    block_sum<2>(s);
    if (threadIdx.x == 0) {
      m1[b] = s[0] / count;
      m2[b] = s[1] / count;
    }
    return;
  }
  float sa[1] = {0.f};
  for (int c = threadIdx.x; c < Ch; c += THREADS) {
    float sg = 0.f, sb = 0.f, salpha = 0.f;
    for (int b = 0; b < B; ++b) {
      sg += rows[((long)b * Ch + c) * 3];
      sb += rows[((long)b * Ch + c) * 3 + 1];
      salpha += rows[((long)b * Ch + c) * 3 + 2];
    }
    dgamma[c] = sg;
    dbeta[c] = sb;
    sa[0] += salpha;
  }
  block_sum<1>(sa);
  if (threadIdx.x == 0) dalpha[0] = sa[0];
}

// db_dw[c] and dW_dw[c, j]: the depthwise row sums over b
__global__ void tcn_dw_param_reduce(const float* dw_rows, int B, int Ch, int kw, float* db_dw,
                                    float* dw_dw) {
  const int n = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (n >= Ch * (1 + kw)) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += dw_rows[(long)b * Ch * (1 + kw) + n];
  const int c = n / (1 + kw), q = n % (1 + kw);
  if (q == 0)
    db_dw[c] = s;
  else
    dw_dw[c * kw + q - 1] = s;
}

// ------------------------------------------------------ host entry points
// Parameter pointers, in tcn_block_train's order, all float32 contiguous:
enum {
  W_IN, G1, B1, AL1, W_DW, B_DW, G2, B2, AL2, W_PW, B_PW, G3, B3, AL3, W_OUT, B_OUT, N_PARAMS
};

struct Dims {
  int B, C, Ch, T, kw, dil;
};

struct Scratch {  // carved from one float32 buffer, in this order
  float *h1, *h2, *h3, *s, *s2;  // [B, Ch, T] each; s / s2 in the backward only
  float* part;                   // [B, max(P, Ch), 2] statistics partials
  float* stats;                  // mean1, rstd1, mean2, rstd2, mean3, rstd3: [B] each
  float* m;                      // m1/m2 of levels 1, 2, 3: [B] each
  float* rows;                   // [B, Ch, 3]
  float* dw_rows;                // [B, Ch, 1 + k]
  float* w_part;                 // [n_split, max(Ch*Ch, Ch*C)]
  float* b_part;                 // [n_split, max(Ch, C)]
};

long gemm_tiles(int O, int T) { return (long)((T + TILE - 1) / TILE) * ((O + TILE - 1) / TILE); }

long part_floats(const Dims& d) {
  const long P = gemm_tiles(d.Ch, d.T);
  return (long)d.B * (P > d.Ch ? P : d.Ch) * 2;
}

long scratch_floats(const Dims& d, int backward, int n_split) {
  const long N = (long)d.B * d.Ch * d.T;
  long n = (backward ? 5 : 3) * N + part_floats(d) + 6L * d.B;
  if (backward) {
    const long wk = (long)d.Ch * (d.Ch > d.C ? d.Ch : d.C);
    n += 6L * d.B + (long)d.B * d.Ch * 3 + (long)d.B * d.Ch * (1 + d.kw) +
         (long)n_split * wk + (long)n_split * (d.Ch > d.C ? d.Ch : d.C);
  }
  return n;
}

Scratch carve(float* base, const Dims& d, int backward, int n_split) {
  const long N = (long)d.B * d.Ch * d.T;
  Scratch s{};
  float* q = base;
  s.h1 = q; q += N;
  s.h2 = q; q += N;
  s.h3 = q; q += N;
  if (backward) {
    s.s = q; q += N;
    s.s2 = q; q += N;
  }
  s.part = q; q += part_floats(d);
  s.stats = q; q += 6L * d.B;
  if (backward) {
    const long wk = (long)d.Ch * (d.Ch > d.C ? d.Ch : d.C);
    s.m = q; q += 6L * d.B;
    s.rows = q; q += (long)d.B * d.Ch * 3;
    s.dw_rows = q; q += (long)d.B * d.Ch * (1 + d.kw);
    s.w_part = q; q += (long)n_split * wk;
    s.b_part = q;
  }
  return s;
}

Src raw(const void* p) {
  Src s{};
  s.mode = RAW;
  s.raw = p;
  return s;
}

Src act(const float* h, const float* mean, const float* rstd, const float* g, const float* beta,
        const float* al) {
  Src s{};
  s.mode = ACT;
  s.h = h;
  s.mean = mean;
  s.rstd = rstd;
  s.g = g;
  s.beta = beta;
  s.al = al;
  return s;
}

Src dnorm(const float* dyn, const float* h, const float* mean, const float* rstd, const float* m1,
          const float* m2, const float* g) {
  Src s{};
  s.mode = DNORM;
  s.dyn = dyn;
  s.h = h;
  s.mean = mean;
  s.rstd = rstd;
  s.m1 = m1;
  s.m2 = m2;
  s.g = g;
  return s;
}

template <typename T>
cudaError_t gemm(const float* w, Src in, const float* bias, const void* res, void* out,
                 int typed_out, float* part, int O, int K, int B, int Tn, cudaStream_t st) {
  GemmParams p{w, in, bias, res, out, part, O, K, Tn, typed_out};
  const dim3 grid((Tn + TILE - 1) / TILE, (O + TILE - 1) / TILE, B);
  tcn_gemm_kernel<T><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

cudaError_t stats(const float* part, int P, const Dims& d, float* mean, float* rstd,
                  cudaStream_t st) {
  tcn_stats_reduce<<<d.B, THREADS, 0, st>>>(part, P, (double)d.Ch * d.T, mean, rstd);
  return cudaGetLastError();
}

#define TRY(expr)                              \
  do {                                         \
    const cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

// h1, h2, h3 and their statistics into the scratch
template <typename T>
cudaError_t forward_hidden(const void* x, const float* const* P, const Dims& d, Scratch& s,
                           cudaStream_t st) {
  float* mean = s.stats;
  float* rstd = s.stats + d.B;
  const int Pg = (int)gemm_tiles(d.Ch, d.T);
  TRY(gemm<T>(P[W_IN], raw(x), nullptr, nullptr, s.h1, 0, s.part, d.Ch, d.C, d.B, d.T, st));
  TRY(stats(s.part, Pg, d, mean, rstd, st));
  DwParams dw{act(s.h1, mean, rstd, P[G1], P[B1], P[AL1]), P[W_DW], P[B_DW], s.h2, s.part,
              d.Ch, d.T, d.kw, d.dil, ((d.kw - 1) / 2) * d.dil};
  tcn_dw_fwd_kernel<<<dim3(d.Ch, d.B), THREADS, 0, st>>>(dw);
  TRY(cudaGetLastError());
  TRY(stats(s.part, d.Ch, d, mean + 2 * d.B, rstd + 2 * d.B, st));
  TRY(gemm<T>(P[W_PW], act(s.h2, mean + 2 * d.B, rstd + 2 * d.B, P[G2], P[B2], P[AL2]),
              P[B_PW], nullptr, s.h3, 0, s.part, d.Ch, d.Ch, d.B, d.T, st));
  return stats(s.part, Pg, d, mean + 4 * d.B, rstd + 4 * d.B, st);
}

template <typename T>
cudaError_t fwd(const void* x, const float* const* P, void* y, float* scratch, const Dims& d,
                cudaStream_t st) {
  Scratch s = carve(scratch, d, 0, 0);
  TRY(forward_hidden<T>(x, P, d, s, st));
  const float* mean3 = s.stats + 4 * d.B;
  const float* rstd3 = s.stats + 5 * d.B;
  return gemm<T>(P[W_OUT], act(s.h3, mean3, rstd3, P[G3], P[B3], P[AL3]), P[B_OUT], x, y, 1,
                 nullptr, d.C, d.Ch, d.B, d.T, st);
}

template <typename T>
cudaError_t wgrad(Src dsrc, Src asrc, int O, int K, const Dims& d, int n_split,
                  int cols_per_split, Scratch& s, float* dw, float* db, cudaStream_t st) {
  WgradParams p{dsrc, asrc, s.w_part, db != nullptr ? s.b_part : nullptr, O, K, d.T, d.B,
                cols_per_split};
  const dim3 grid((K + TILE - 1) / TILE, (O + TILE - 1) / TILE, n_split);
  tcn_wgrad_kernel<T><<<grid, THREADS, 0, st>>>(p);
  TRY(cudaGetLastError());
  const long total = (long)O * K + O;
  const int blocks = total / THREADS + 1 < 1024 ? (int)(total / THREADS + 1) : 1024;
  tcn_wgrad_reduce<<<blocks, THREADS, 0, st>>>(s.w_part, db != nullptr ? s.b_part : nullptr,
                                               dw, db, O, K, n_split);
  return cudaGetLastError();
}

cudaError_t norm_level(float* g_io, Src y, const Dims& d, Scratch& s, float* m1, float* m2,
                       float* dg, float* db, float* dal, cudaStream_t st) {
  NormRowParams p{g_io, y, s.rows, d.Ch, d.T};
  tcn_norm_rows_kernel<<<dim3(d.Ch, d.B), THREADS, 0, st>>>(p);
  TRY(cudaGetLastError());
  tcn_norm_reduce<<<d.B + 1, THREADS, 0, st>>>(s.rows, y.g, d.B, d.Ch, (float)d.Ch * d.T, m1,
                                               m2, dg, db, dal);
  return cudaGetLastError();
}

// G: the 16 gradient pointers (float32), in the parameters' order;
// WT: W_in^T [C, Ch], W_pw^T [Ch, Ch], W_out^T [Ch, C]
template <typename T>
cudaError_t bwd(const void* x, const void* dy, const float* const* P, const float* const* WT,
                void* dx, float* const* G, float* scratch, const Dims& d, int n_split,
                int cols_per_split, cudaStream_t st) {
  Scratch s = carve(scratch, d, 1, n_split);
  TRY(forward_hidden<T>(x, P, d, s, st));
  const int B = d.B;
  const float *mean1 = s.stats, *rstd1 = s.stats + B, *mean2 = s.stats + 2 * B,
              *rstd2 = s.stats + 3 * B, *mean3 = s.stats + 4 * B, *rstd3 = s.stats + 5 * B;
  float *m1_1 = s.m, *m2_1 = s.m + B, *m1_2 = s.m + 2 * B, *m2_2 = s.m + 3 * B,
        *m1_3 = s.m + 4 * B, *m2_3 = s.m + 5 * B;
  const Src a1 = act(s.h1, mean1, rstd1, P[G1], P[B1], P[AL1]);
  const Src a2 = act(s.h2, mean2, rstd2, P[G2], P[B2], P[AL2]);
  const Src a3 = act(s.h3, mean3, rstd3, P[G3], P[B3], P[AL3]);

  // out 1x1: da3 = W_out^T dy; dW_out, db_out
  TRY(gemm<T>(WT[2], raw(dy), nullptr, nullptr, s.s, 0, nullptr, d.Ch, d.C, B, d.T, st));
  TRY(wgrad<T>(raw(dy), a3, d.C, d.Ch, d, n_split, cols_per_split, s, G[W_OUT], G[B_OUT], st));
  // PReLU3 / gGN3
  TRY(norm_level(s.s, a3, d, s, m1_3, m2_3, G[G3], G[B3], G[AL3], st));
  const Src dh3 = dnorm(s.s, s.h3, mean3, rstd3, m1_3, m2_3, P[G3]);
  // pointwise 1x1: da2 = W_pw^T dh3; dW_pw, db_pw
  TRY(gemm<T>(WT[1], dh3, nullptr, nullptr, s.s2, 0, nullptr, d.Ch, d.Ch, B, d.T, st));
  TRY(wgrad<T>(dh3, a2, d.Ch, d.Ch, d, n_split, cols_per_split, s, G[W_PW], G[B_PW], st));
  // PReLU2 / gGN2
  TRY(norm_level(s.s2, a2, d, s, m1_2, m2_2, G[G2], G[B2], G[AL2], st));
  // depthwise VJP + PReLU1 / gLN1's rows
  DwBwdParams dw{dnorm(s.s2, s.h2, mean2, rstd2, m1_2, m2_2, P[G2]), a1, P[W_DW], s.s, s.rows,
                 s.dw_rows, d.Ch, d.T, d.kw, d.dil, ((d.kw - 1) / 2) * d.dil};
  tcn_dw_bwd_kernel<<<dim3(d.Ch, B), THREADS, 0, st>>>(dw);
  TRY(cudaGetLastError());
  const int n = d.Ch * (1 + d.kw);
  tcn_dw_param_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(s.dw_rows, B, d.Ch, d.kw,
                                                                       G[B_DW], G[W_DW]);
  TRY(cudaGetLastError());
  tcn_norm_reduce<<<B + 1, THREADS, 0, st>>>(s.rows, P[G1], B, d.Ch, (float)d.Ch * d.T, m1_1,
                                             m2_1, G[G1], G[B1], G[AL1]);
  TRY(cudaGetLastError());
  const Src dh1 = dnorm(s.s, s.h1, mean1, rstd1, m1_1, m2_1, P[G1]);
  // in 1x1 (no bias): dx = W_in^T dh1 + dy; dW_in
  TRY(gemm<T>(WT[0], dh1, nullptr, dy, dx, 1, nullptr, d.C, d.Ch, B, d.T, st));
  return wgrad<T>(dh1, raw(x), d.Ch, d.C, d, n_split, cols_per_split, s, G[W_IN], nullptr, st);
}

}  // namespace

extern "C" long tcn_train_scratch_floats(int B, int C, int Ch, int T, int kw, int backward,
                                         int n_split) {
  return scratch_floats(Dims{B, C, Ch, T, kw, 1}, backward, n_split);
}

// ptrs: x, the 16 parameters, y
extern "C" int tcn_train_fwd(void* const* ptrs, void* scratch, int B, int C, int Ch, int T,
                             int kw, int dil, int x_bf16, void* stream) {
  if (kw > MAXK || kw % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* P = reinterpret_cast<const float* const*>(ptrs + 1);
  const Dims d{B, C, Ch, T, kw, dil};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err = x_bf16 ? fwd<__nv_bfloat16>(ptrs[0], P, ptrs[17], sc, d, st)
                                 : fwd<float>(ptrs[0], P, ptrs[17], sc, d, st);
  return static_cast<int>(err);
}

// ptrs: x, dy, the 16 parameters, W_in^T, W_pw^T, W_out^T, dx, the 16 gradients
extern "C" int tcn_train_bwd(void* const* ptrs, void* scratch, int B, int C, int Ch, int T,
                             int kw, int dil, int x_bf16, int n_split, int cols_per_split,
                             void* stream) {
  if (kw > MAXK || kw % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* P = reinterpret_cast<const float* const*>(ptrs + 2);
  const float* const* WT = reinterpret_cast<const float* const*>(ptrs + 18);
  float* const* G = reinterpret_cast<float* const*>(ptrs + 22);
  const Dims d{B, C, Ch, T, kw, dil};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      x_bf16 ? bwd<__nv_bfloat16>(ptrs[0], ptrs[1], P, WT, ptrs[21], G, sc, d, n_split,
                                  cols_per_split, st)
             : bwd<float>(ptrs[0], ptrs[1], P, WT, ptrs[21], G, sc, d, n_split,
                          cols_per_split, st);
  return static_cast<int>(err);
}

extern "C" const char* tcn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
