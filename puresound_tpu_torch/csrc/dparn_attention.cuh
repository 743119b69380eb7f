// DPARN's intra-frequency attention pass, shared by dparn_attention.cu
// (dparn_intra_pass) and masker.cu (the DPARN wide center, where it reads
// and writes the [F, K*B, CH] activation in place and adds its input back:
// `residual`). `run` launches the route of the plan (`make_plan` below, the
// wrapper's `plan` computed again): the model's geometry under bf16 weights
// and dots runs dparn_wgmma.cuh (two rows a CTA on wgmma); every other shape
// and dtype runs the one-row kernel of this file:
//
// A row is F tokens of C channels. The CTA keeps it in shared memory in
// float32, channel-major ([C][F + 4]: the 4 tokens a thread multiplies
// are one float4), with room for Q, K, V, a temporary and the F x F
// logits: about 190 KB at F = 64, C = 128. The products [F x C] . [C x N]
// (q, k, v, the out-projection, the two feed-forward layers, the FC): the
// weights ([C, N], JAX's [in, out] layout) stream through shared memory in
// tiles of KT rows copied with cp.async and double-buffered (lstm_gates.cuh);
// each thread owns 4 tokens x 8 output channels on CUDA cores. Attention per
// head: the F x F logits (/ sqrt(Dh)), a row softmax in float32
// (max-subtracted; 4 threads a row, shuffles), the probabilities times V
// (4 x 4 / 4 x 1 per thread); its output overwrites that head's Q, which
// nothing reads again. LayerNorms are two-pass over C, eps 1e-5, 4 threads a
// row. Every product operand is rounded to the dot dtype (DB: bfloat16)
// where it is written -- q, k, v, the probabilities, the attention output,
// the feed-forward hidden layer -- or copied rounded when it is also a
// residual (x); sums, the softmax and the norms stay float32. Weights are all float32 or all bfloat16.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dparn_wgmma.cuh"
#include "lstm_gates.cuh"

namespace dparn_attn {

using namespace lstm_gates;

constexpr int THREADS = 256;
constexpr int NW = 28;          // weights: 12 per encoder layer, then fc_k, fc_b, nrm_g, nrm_b
constexpr float EPS = 1e-5f;

struct AttnParams {
  const void* x;       // element (r, f, c) at r * sr + f * sf + c
  const void* pe;      // [F, C], added to layer 1's attention input
  const void* w[NW];   // JAX's flat order, products [in, out] (contiguous off the wgmma path)
  long ws[NW][2];      // their strides (in, out) in elements (the wgmma path's pack reads them)
  void* y;             // the same strides as x (may be x)
  void* packed;        // the wgmma path's repacked weights (dparn_wgmma::pack_kernel)
  long sr, sf;
  int R, F, C, FFD, heads, KT;
  int x_bf16, pe_bf16, y_bf16, residual;  // residual: y = x + pass(x)
};

// 8 consecutive weights of a staged tile as float, rounded to the dot dtype
template <typename WT, bool DB>
__device__ __forceinline__ void load8(const WT* p, float (&w)[8]) {
  if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = rnd<DB>(v[i]);
  }
}

// out[n][m] = act(sum_k A[k][m] W[k][n] + bias[n]) for m < M, n < N: A in
// shared memory [K][ld], W [K][N] in global memory. Thread t owns the 4 x 8
// microtiles t and t + blockDim (M / 4 * N / 8 <= 2 * blockDim). Ends with a
// barrier, so `out` is ready for every thread.
template <typename WT, bool DB>
__device__ void block_gemm(const float* A, int ld, int M, int K, const WT* W, int N, WT* w_s,
                           int KT, float* out, const WT* bias, bool relu, bool round_out) {
  const int ng = N / 8, nmt = (M / 4) * ng, ntiles = (K + KT - 1) / KT;
  float acc[2][4][8];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[u][i][j] = 0.f;
  stage_rows(w_s, W, 0, K < KT ? K : KT, N);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KT, rows = K - k0 < KT ? K - k0 : KT;
    if (t + 1 < ntiles) {
      const int k1 = k0 + KT;
      stage_rows(w_s + ((t + 1) & 1) * KT * N, W, k1, K - k1 < KT ? K - k1 : KT, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const WT* ws = w_s + (t & 1) * KT * N;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mt = threadIdx.x + u * blockDim.x;
      if (mt < nmt) {
        const int m0 = (mt / ng) * 4, n0 = (mt % ng) * 8;
        const float* a_p = A + (long)k0 * ld + m0;
#pragma unroll 2
        for (int kk = 0; kk < rows; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(a_p + kk * ld);
          float w[8];
          load8<WT, DB>(ws + kk * N + n0, w);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[u][i][j] += av[i] * w[j];
        }
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int mt = threadIdx.x + u * blockDim.x;
    if (mt < nmt) {
      const int m0 = (mt / ng) * 4, n0 = (mt % ng) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = bias ? ldw(bias, n0 + j) : 0.f;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[u][i][j] + b;
          if (relu) v[i] = fmaxf(v[i], 0.f);
          if (round_out) v[i] = rnd<DB>(v[i]);
        }
        *reinterpret_cast<float4*>(out + (long)(n0 + j) * ld + m0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// dst[c][m] = LN_c(a[c][m] (+ b[c][m])) * g[c] + beta[c], two-pass, 4
// threads a token (every thread runs the same trip count: the shuffles
// need the whole warp). dst may be a.
template <typename WT>
__device__ void layer_norm(float* dst, const float* a, const float* b, int M, int C, int ld,
                           const WT* g, const WT* beta) {
  const int q = threadIdx.x & 3;
  for (int m0 = 0; m0 < M; m0 += blockDim.x / 4) {
    const int m = m0 + threadIdx.x / 4;
    const bool ok = m < M;
    float s = 0.f;
    if (ok)
      for (int c = q; c < C; c += 4) s += a[c * ld + m] + (b ? b[c * ld + m] : 0.f);
    const float mean = quad_sum(s) / C;
    float v = 0.f;
    if (ok)
      for (int c = q; c < C; c += 4) {
        const float d = a[c * ld + m] + (b ? b[c * ld + m] : 0.f) - mean;
        v += d * d;
      }
    const float rstd = rsqrtf(quad_sum(v) / C + EPS);
    if (ok)
      for (int c = q; c < C; c += 4) {
        const float d = a[c * ld + m] + (b ? b[c * ld + m] : 0.f) - mean;
        dst[c * ld + m] = d * rstd * ldw(g, c) + ldw(beta, c);
      }
  }
  __syncthreads();
}

// L[j][i] = the probabilities softmax_j(L[j][i]) of query i, float32,
// max-subtracted, rounded to the dot dtype; 4 threads a query. Ends with a
// barrier.
template <bool DB>
__device__ void softmax_rows(float* L, int F, int ld) {
  const int qd = threadIdx.x & 3;
  for (int i0 = 0; i0 < F; i0 += blockDim.x / 4) {
    const int i = i0 + threadIdx.x / 4;
    const bool ok = i < F;
    float mx = __int_as_float(0xff800000);  // -inf
    if (ok)
      for (int j = qd; j < F; j += 4) mx = fmaxf(mx, L[j * ld + i]);
    mx = quad_max(mx);
    float s = 0.f;
    if (ok)
      for (int j = qd; j < F; j += 4) {
        const float e = expf(L[j * ld + i] - mx);
        L[j * ld + i] = e;
        s += e;
      }
    s = quad_sum(s);
    if (ok)
      for (int j = qd; j < F; j += 4) L[j * ld + i] = rnd<DB>(L[j * ld + i] / s);
  }
  __syncthreads();
}

// per head: o_h = softmax(q_h k_h^T / sqrt(Dh)) v_h, written over q_h
template <bool DB>
__device__ void attention(float* Q, const float* Kb, const float* V, float* L, int F, int C,
                          int heads, int ld) {
  const int Dh = C / heads, fg = F / 4;
  const float scale = sqrtf((float)Dh);
  for (int h = 0; h < heads; ++h) {
    float* q = Q + (long)h * Dh * ld;
    const float* k = Kb + (long)h * Dh * ld;
    const float* v = V + (long)h * Dh * ld;
    for (int mt = threadIdx.x; mt < fg * fg; mt += blockDim.x) {
      const int i0 = (mt % fg) * 4, j0 = (mt / fg) * 4;
      float acc[4][4] = {};
      for (int d = 0; d < Dh; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(q + d * ld + i0);
        const float4 ka = *reinterpret_cast<const float4*>(k + d * ld + j0);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += qv[ii] * kv[jj];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<float4*>(L + (j0 + jj) * ld + i0) =
            make_float4(acc[0][jj] / scale, acc[1][jj] / scale, acc[2][jj] / scale,
                        acc[3][jj] / scale);
    }
    __syncthreads();
    softmax_rows<DB>(L, F, ld);
    for (int it = threadIdx.x; it < fg * Dh; it += blockDim.x) {
      const int i0 = (it % fg) * 4, d = it / fg;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < F; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(L + j * ld + i0);
        const float vv = v[d * ld + j];
        acc.x += p.x * vv;
        acc.y += p.y * vv;
        acc.z += p.z * vv;
        acc.w += p.w * vv;
      }
      *reinterpret_cast<float4*>(q + d * ld + i0) =
          make_float4(rnd<DB>(acc.x), rnd<DB>(acc.y), rnd<DB>(acc.z), rnd<DB>(acc.w));
    }
    __syncthreads();
  }
}

// shared-memory floats of the activation buffers (the weight tiles follow)
inline size_t act_floats(int F, int C, int FFD) {
  const int ld = F + 4, CM = C > FFD ? C : FFD;
  return (size_t)(4 * C + CM + F) * ld;
}

template <typename WT, bool DB>
__global__ void __launch_bounds__(THREADS) dparn_attn_kernel(AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = p.F, C = p.C, FFD = p.FFD, lda = F + 4, CM = C > FFD ? C : FFD;
  float* X = reinterpret_cast<float*>(smem_raw);   // the row, [C][lda]
  float* T = X + C * lda;                            // [CM][lda]
  float* Q = T + CM * lda;
  float* Kb = Q + C * lda;
  float* V = Kb + C * lda;
  float* L = V + C * lda;                            // [F][lda] logits, probabilities
  WT* w_s = reinterpret_cast<WT*>(L + F * lda);
  const long base = (long)blockIdx.x * p.sr;
  auto wt = [&](int i) { return static_cast<const WT*>(p.w[i]); };

  for (int i = threadIdx.x; i < F * C; i += blockDim.x) {
    const int f = i / C, c = i % C;
    X[c * lda + f] = ld(p.x, base + f * p.sf + c, p.x_bf16);
  }
  __syncthreads();
  for (int layer = 0; layer < 2; ++layer) {
    const int w0 = 12 * layer;
    const float* A = X;
    if (layer == 0 || DB) {  // the product operand: rnd(x + pe) (pe on layer 1)
      for (int i = threadIdx.x; i < F * C; i += blockDim.x) {
        const int c = i / F, f = i % F;
        const float pe = layer == 0 ? ld(p.pe, (long)f * C + c, p.pe_bf16) : 0.f;
        T[c * lda + f] = rnd<DB>(X[c * lda + f] + pe);
      }
      __syncthreads();
      A = T;
    }
    block_gemm<WT, DB>(A, lda, F, C, wt(w0), C, w_s, p.KT, Q, nullptr, false, true);
    block_gemm<WT, DB>(A, lda, F, C, wt(w0 + 1), C, w_s, p.KT, Kb, nullptr, false, true);
    block_gemm<WT, DB>(A, lda, F, C, wt(w0 + 2), C, w_s, p.KT, V, nullptr, false, true);
    attention<DB>(Q, Kb, V, L, F, C, p.heads, lda);
    block_gemm<WT, DB>(Q, lda, F, C, wt(w0 + 3), C, w_s, p.KT, T, nullptr, false, false);
    layer_norm<WT>(X, X, T, F, C, lda, wt(w0 + 4), wt(w0 + 5));
    A = X;
    if (DB) {
      for (int i = threadIdx.x; i < F * C; i += blockDim.x) Kb[i / F * lda + i % F] =
          rnd<DB>(X[i / F * lda + i % F]);
      __syncthreads();
      A = Kb;
    }
    block_gemm<WT, DB>(A, lda, F, C, wt(w0 + 6), FFD, w_s, p.KT, T, wt(w0 + 7), true, true);
    block_gemm<WT, DB>(T, lda, F, FFD, wt(w0 + 8), C, w_s, p.KT, Q, wt(w0 + 9), false, false);
    layer_norm<WT>(X, X, Q, F, C, lda, wt(w0 + 10), wt(w0 + 11));
  }
  const float* A = X;
  if (DB) {
    for (int i = threadIdx.x; i < F * C; i += blockDim.x) Kb[i / F * lda + i % F] =
        rnd<DB>(X[i / F * lda + i % F]);
    __syncthreads();
    A = Kb;
  }
  block_gemm<WT, DB>(A, lda, F, C, wt(24), C, w_s, p.KT, Q, wt(25), false, false);
  layer_norm<WT>(Q, Q, nullptr, F, C, lda, wt(26), wt(27));
  for (int i = threadIdx.x; i < F * C; i += blockDim.x) {
    const int f = i / C, c = i % C;
    const long e = base + f * p.sf + c;
    const float v = Q[c * lda + f] + (p.residual ? ld(p.x, e, p.x_bf16) : 0.f);
    st(p.y, e, v, p.y_bf16);
  }
}

// ------------------------------------------------------------------ plans
// The launch plan, computed by ops/dparn_attention_kernel.py `plan` and
// again here: `run` refuses a plan that differs (PLAN_MISMATCH). Path 1
// (wgmma, dparn_wgmma.cuh) takes the model's geometry under bf16 weights and
// dots; every other shape and dtype keeps the kernel above (path 0), one
// row a CTA on CUDA cores.
enum Path { PATH_CUDA_CORES = 0, PATH_WGMMA = 1 };
constexpr int PLAN_FIELDS = 7;   // path, rows a CTA, warpgroups, stages, KT, smem, CTAs
constexpr int PLAN_MISMATCH = 10000;

inline bool wgmma_geometry(const AttnParams& p, bool w_bf16, bool dot_bf16) {
  return w_bf16 && dot_bf16 && p.F == dparn_wgmma::F && p.C == dparn_wgmma::C &&
         p.FFD == dparn_wgmma::C && p.heads == dparn_wgmma::HEADS;
}

inline cudaError_t make_plan(const AttnParams& p, bool w_bf16, bool dot_bf16,
                             int (&plan)[PLAN_FIELDS]) {
  int dev = 0, cap = 227 * 1024, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (wgmma_geometry(p, w_bf16, dot_bf16)) {
    const int v[PLAN_FIELDS] = {PATH_WGMMA, dparn_wgmma::NWG, dparn_wgmma::NWG,
                                dparn_wgmma::STAGES, 0, (int)dparn_wgmma::SMEM,
                                dparn_wgmma::ctas(p.R, sms)};
    for (int i = 0; i < PLAN_FIELDS; ++i) plan[i] = v[i];
    return (size_t)cap >= dparn_wgmma::SMEM ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  const int CM = p.C > p.FFD ? p.C : p.FFD;
  const size_t act = sizeof(float) * act_floats(p.F, p.C, p.FFD), wsz = w_bf16 ? 2 : 4;
  int KT = 64;   // 2 tiles a 128-row product in bf16, 4 in float32 (shared memory)
  while (KT > 1 && act + wsz * 2 * (size_t)KT * CM > (size_t)cap) KT /= 2;
  const size_t smem = act + wsz * 2 * (size_t)KT * CM;
  const int v[PLAN_FIELDS] = {PATH_CUDA_CORES, 1, 0, 2, KT, (int)smem, p.R};
  for (int i = 0; i < PLAN_FIELDS; ++i) plan[i] = v[i];
  return smem <= (size_t)cap ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// launch the planned kernel; `want` is the caller's plan
template <typename WT, bool DB>
cudaError_t run(AttnParams p, const int* want, cudaStream_t stream) {
  constexpr bool WB = std::is_same<WT, __nv_bfloat16>::value;
  int plan[PLAN_FIELDS];
  cudaError_t err = make_plan(p, WB, DB, plan);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < PLAN_FIELDS; ++i)
    if (plan[i] != want[i]) return static_cast<cudaError_t>(PLAN_MISMATCH);
  if constexpr (WB && DB) {
    if (plan[0] == PATH_WGMMA) {
      dparn_wgmma::Params q{};
      q.x = p.x;
      q.pe = p.pe;
      for (int i = 0; i < NW; ++i) {
        q.w[i] = static_cast<const __nv_bfloat16*>(p.w[i]);
        q.ws[i][0] = p.ws[i][0];
        q.ws[i][1] = p.ws[i][1];
      }
      q.packed = static_cast<__nv_bfloat16*>(p.packed);
      q.y = p.y;
      q.sr = p.sr;
      q.sf = p.sf;
      q.R = p.R;
      q.x_bf16 = p.x_bf16;
      q.pe_bf16 = p.pe_bf16;
      q.y_bf16 = p.y_bf16;
      q.residual = p.residual;
      return dparn_wgmma::run(q, plan[6], stream);
    }
  }
  p.KT = plan[4];
  const size_t smem = (size_t)plan[5];
  err = cudaFuncSetAttribute(dparn_attn_kernel<WT, DB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dparn_attn_kernel<WT, DB><<<p.R, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const AttnParams& p, const int* plan, int w_bf16, int dot_bf16,
                            cudaStream_t stream) {
  if (w_bf16)
    return dot_bf16 ? run<__nv_bfloat16, true>(p, plan, stream)
                    : run<__nv_bfloat16, false>(p, plan, stream);
  return dot_bf16 ? run<float, true>(p, plan, stream) : run<float, false>(p, plan, stream);
}

inline const char* error_string(int err) {
  return err == PLAN_MISMATCH ? "the launch plan differs from the source's own"
                              : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace dparn_attn
