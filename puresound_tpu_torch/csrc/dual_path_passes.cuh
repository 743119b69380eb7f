// The passes of DPCRN's dual-path bottleneck, shared by dual_path.cu
// (dual_path_chunk) and masker.cu (the wide-center kernels, whose DPCRN
// bottleneck is this code and whose DPARN bottleneck reuses its inter pass).
// See dual_path.cu for what each pass computes and why it is built so. Two
// routes, chosen by the launch plan (ops/dual_path_kernel.py `_plan`, checked
// again by dp_tc::check_plan): the tensor-core route of dual_path_tc.cuh
// under bf16 weights and dots at the widths it takes, else the CUDA-core
// passes below.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dual_path_tc.cuh"
#include "lstm_gates.cuh"

namespace dual_path_passes {


using namespace lstm_gates;

constexpr int MAX_THREADS = 512;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// per-row mean and 1/sqrt(var + eps) of t_s [BT][CH + 1], one warp per row
__device__ void row_stats(const float* t_s, int BT, int CH, float* mean_s, float* rstd_s) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < BT; r += nw) {
    const float* tr = t_s + r * (CH + 1);
    float s = 0.f;
    for (int c = lane; c < CH; c += 32) s += tr[c];
    const float mean = warp_sum(s) / CH;
    float v = 0.f;
    for (int c = lane; c < CH; c += 32) {
      const float d = tr[c] - mean;
      v += d * d;
    }
    v = warp_sum(v) / CH;
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rsqrtf(v + LN_EPS);
    }
  }
}

// acc[r] += sum_k in_s[k][col + r] * W[k][c] for k < n (8 rows, channel c)
template <typename WT, bool DB>
__device__ __forceinline__ void proj_dot(float (&acc)[RB], const float* in_s, int BTP,
                                         int col, const WT* W, int n, int CH, int c) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float w = rndw<WT, DB>(W[(long)k * CH + c]);
    const float4 lo = *reinterpret_cast<const float4*>(in_s + k * BTP + col);
    const float4 hi = *reinterpret_cast<const float4*>(in_s + k * BTP + col + 4);
    const float v[RB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] += v[r] * w;
  }
}

// ------------------------------------------------------------ A. intra scans
struct IntraParams {
  const void* x;       // [F, R, CH] (x's dtype for the first block, else x_scr)
  const void* w_ih[2]; // [CH, 4H] forward / backward
  const void* w_hh[2]; // [H, 4H], or int8 x4 words [H/4][4H] under int8_hh
  const void* bias[2]; // [4H]
  const float* s_hh[2];// int8_hh: w_hh's scales / 127^2 [4H]; nullptr: float w_hh
  float* y_dir;        // [2, F, R, H]
  int x_bf16, F, R, CH, H, RG, KT;
};

template <typename WT, bool DB>
__global__ void __launch_bounds__(MAX_THREADS) dp_intra_kernel(IntraParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, CH = p.CH, R = p.R, Fn = p.F;
  const int BT = p.RG * RB, BTP = BT + 4;
  const int tid = threadIdx.x, j = tid % H, rg = tid / H, col = rg * RB;
  const bool live = rg < p.RG;
  const int dir = blockIdx.y;
  WT* w_s = reinterpret_cast<WT*>(smem_raw);                       // [2][KT][4H]
  float* x_s = reinterpret_cast<float*>(w_s + 2 * p.KT * 4 * H);   // [CH][BTP]
  float* h_s = x_s + CH * BTP;                                      // [2][H][BTP]
  // int8_hh: h lives only as its quantized words, [2][H/4][BTP] in h_s's bytes
  int* hq_s = reinterpret_cast<int*>(h_s);
  const float* s_hh = p.s_hh[dir];
  const int HQ = H / 4 * BTP;
  const WT* w_ih = static_cast<const WT*>(p.w_ih[dir]);
  const WT* w_hh = static_cast<const WT*>(p.w_hh[dir]);
  const WT* bias = static_cast<const WT*>(p.bias[dir]);
  const long row0 = (long)blockIdx.x * BT;
  float* y = p.y_dir + (long)dir * Fn * R * H;

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) c[r] = 0.f;
  for (int idx = tid; idx < H * BTP; idx += blockDim.x) h_s[idx] = 0.f;

  int cur = 0;
  for (int s = 0; s < Fn; ++s) {
    const int f = dir ? Fn - 1 - s : s;
    for (int idx = tid; idx < BT * CH; idx += blockDim.x) {
      const int r = idx / CH, k = idx % CH;
      const long row = row0 + r;
      x_s[k * BTP + r] = row < R ? rnd<DB>(ld(p.x, ((long)f * R + row) * CH + k, p.x_bf16))
                                 : 0.f;
    }
    float acc[4][RB];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[q][r] = 0.f;
    // x_s's stores are published by gate_dot's first barrier
    gate_dot<WT, DB>(acc, x_s, BTP, col, w_ih, CH, H, j, live, w_s, p.KT);
    if (s_hh)
      gate_dot_q(acc, hq_s + cur * HQ, BTP, col, reinterpret_cast<const int*>(w_hh), H / 4,
                 H, j, live, reinterpret_cast<int*>(w_s), tile_rows_q<WT>(p.KT), s_hh);
    else
      gate_dot<WT, DB>(acc, h_s + cur * H * BTP, BTP, col, w_hh, H, H, j, live, w_s, p.KT);
    if (live) {
      const float b0 = ldw(bias, j), b1 = ldw(bias, H + j);
      const float b2 = ldw(bias, 2 * H + j), b3 = ldw(bias, 3 * H + j);
      float* hn = h_s + (cur ^ 1) * H * BTP + col;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const long row = row0 + col + r;
        const float ig = sigm(acc[0][r] + b0), fg = sigm(acc[1][r] + b1);
        const float gg = tanhf(acc[2][r] + b2), og = sigm(acc[3][r] + b3);
        c[r] = fg * c[r] + ig * gg;
        const float h = og * tanhf(c[r]);
        const float hv = rnd<DB>(h);
        if (s_hh)
          put_q(hq_s + (cur ^ 1) * HQ, BTP, j, col + r, quant_h(h));
        else
          hn[j * BTP + r] = hv;
        if (row < R) y[((long)f * R + row) * H + j] = hv;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// ------------------------------------------------ B. intra projection + LN
struct ProjParams {
  const float* y_dir;  // [2, NR, H]
  const void* res;     // [NR, CH] residual source
  void* out;           // [NR, CH] x_scr (float32, or bfloat16 under xscr_half)
  const void *pw_f, *pw_b, *pb, *g, *b;
  int res_bf16, out_bf16, NR, CH, H, RG;
};

template <typename WT, bool DB>
__global__ void __launch_bounds__(MAX_THREADS) dp_proj_kernel(ProjParams p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, CH = p.CH, NR = p.NR, H2 = 2 * H;
  const int BT = p.RG * RB, BTP = BT + 4;
  const int tid = threadIdx.x, cc = tid % CH, rg = tid / CH, col = rg * RB;
  float* y_s = smem;                   // [2H][BTP]
  float* t_s = y_s + H2 * BTP;         // [BT][CH + 1]
  float* mean_s = t_s + BT * (CH + 1); // [BT]
  float* rstd_s = mean_s + BT;         // [BT]
  const long row0 = (long)blockIdx.x * BT;

  for (int idx = tid; idx < BT * H2; idx += blockDim.x) {
    const int r = idx / H2, k = idx % H2;
    const long row = row0 + r;
    y_s[k * BTP + r] =
        row < NR ? p.y_dir[(k < H ? 0 : (long)NR * H) + row * H + (k < H ? k : k - H)] : 0.f;
  }
  __syncthreads();
  if (rg < p.RG) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    proj_dot<WT, DB>(acc, y_s, BTP, col, static_cast<const WT*>(p.pw_f), H, CH, cc);
    proj_dot<WT, DB>(acc, y_s + H * BTP, BTP, col, static_cast<const WT*>(p.pw_b), H, CH, cc);
    const float bias = ldw(static_cast<const WT*>(p.pb), cc);
#pragma unroll
    for (int r = 0; r < RB; ++r) t_s[(col + r) * (CH + 1) + cc] = acc[r] + bias;
  }
  __syncthreads();
  row_stats(t_s, BT, CH, mean_s, rstd_s);
  __syncthreads();
  const WT* g = static_cast<const WT*>(p.g);
  const WT* b = static_cast<const WT*>(p.b);
  for (int idx = tid; idx < BT * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const long row = row0 + r;
    if (row < NR) {
      const float t = (t_s[r * (CH + 1) + c] - mean_s[r]) * rstd_s[r] * ldw(g, c) + ldw(b, c);
      st(p.out, row * CH + c, ld(p.res, row * CH + c, p.res_bf16) + t, p.out_bf16);
    }
  }
}

// ----------------------------------- C. inter scan + projection + LN + residual
struct InterParams {
  void* x;             // x_scr [F, K, B, CH] (float32, or bfloat16: xs_bf16)
  void* y;             // [F, K, B, CH] output, written by the last block
  const void *h_in, *c_in;
  void *h_out, *c_out; // [F, B, H] (state dtype)
  const void *w_ih, *w_hh, *bias, *pw, *pb, *g, *b;
  const float* s_hh;   // int8_hh: w_hh (int8 x4 words) scales / 127^2; else nullptr
  int last, y_bf16, s_bf16, xs_bf16, F, K, B, CH, H, RG, KT;
};

template <typename WT, bool DB>
__global__ void __launch_bounds__(MAX_THREADS) dp_inter_kernel(InterParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, CH = p.CH, K = p.K, Bn = p.B;
  const long NR = (long)p.F * Bn;
  const int BT = p.RG * RB, BTP = BT + 4;
  const int tid = threadIdx.x, j = tid % H, rg = tid / H, col = rg * RB;
  const bool live = rg < p.RG;
  WT* w_s = reinterpret_cast<WT*>(smem_raw);                       // [2][KT][4H]
  float* x_s = reinterpret_cast<float*>(w_s + 2 * p.KT * 4 * H);   // [CH][BTP]
  float* h_s = x_s + CH * BTP;                                      // [2][H][BTP]
  float* t_s = h_s + 2 * H * BTP;                                   // [BT][CH + 1]
  float* mean_s = t_s + BT * (CH + 1);  // [BT]
  float* rstd_s = mean_s + BT;          // [BT]
  int* hq_s = reinterpret_cast<int*>(rstd_s + BT);  // int8_hh: [2][H/4][BTP] words
  const int HQ = H / 4 * BTP;
  const WT* w_ih = static_cast<const WT*>(p.w_ih);
  const WT* w_hh = static_cast<const WT*>(p.w_hh);
  const WT* bias = static_cast<const WT*>(p.bias);
  const WT* pw = static_cast<const WT*>(p.pw);
  const WT* pb = static_cast<const WT*>(p.pb);
  const WT* lg = static_cast<const WT*>(p.g);
  const WT* lb = static_cast<const WT*>(p.b);
  const long row0 = (long)blockIdx.x * BT;
  // element (row = f*B + b, channel ch) of frame k: ((f*K + k)*B + b)*CH + ch
  auto xi = [&](long row, int k, int ch) {
    return ((row / Bn * K + k) * Bn + row % Bn) * CH + ch;
  };

  float c[RB], h[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    c[r] = h[r] = 0.f;
    if (live) {
      const long row = row0 + col + r;
      if (row < NR) {
        h[r] = ld(p.h_in, row * H + j, p.s_bf16);
        c[r] = ld(p.c_in, row * H + j, p.s_bf16);
      }
      h_s[j * BTP + col + r] = rnd<DB>(h[r]);
      if (p.s_hh) put_q(hq_s, BTP, j, col + r, quant_h(h[r]));
    }
  }

  int cur = 0;
  for (int k = 0; k < K; ++k) {
    for (int idx = tid; idx < BT * CH; idx += blockDim.x) {
      const int r = idx / CH, ch = idx % CH;
      const long row = row0 + r;
      x_s[ch * BTP + r] = row < NR ? rnd<DB>(ld(p.x, xi(row, k, ch), p.xs_bf16)) : 0.f;
    }
    float acc[4][RB];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[q][r] = 0.f;
    // x_s's (and the first h_s's) stores are published by gate_dot's barrier
    gate_dot<WT, DB>(acc, x_s, BTP, col, w_ih, CH, H, j, live, w_s, p.KT);
    if (p.s_hh)
      gate_dot_q(acc, hq_s + cur * HQ, BTP, col, reinterpret_cast<const int*>(w_hh), H / 4,
                 H, j, live, reinterpret_cast<int*>(w_s), tile_rows_q<WT>(p.KT), p.s_hh);
    else
      gate_dot<WT, DB>(acc, h_s + cur * H * BTP, BTP, col, w_hh, H, H, j, live, w_s, p.KT);
    if (live) {
      const float b0 = ldw(bias, j), b1 = ldw(bias, H + j);
      const float b2 = ldw(bias, 2 * H + j), b3 = ldw(bias, 3 * H + j);
      float* hn = h_s + (cur ^ 1) * H * BTP + col;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float ig = sigm(acc[0][r] + b0), fg = sigm(acc[1][r] + b1);
        const float gg = tanhf(acc[2][r] + b2), og = sigm(acc[3][r] + b3);
        c[r] = fg * c[r] + ig * gg;
        h[r] = og * tanhf(c[r]);
        hn[j * BTP + r] = rnd<DB>(h[r]);
        if (p.s_hh) put_q(hq_s + (cur ^ 1) * HQ, BTP, j, col + r, quant_h(h[r]));
      }
    }
    __syncthreads();
    const float* hs = h_s + (cur ^ 1) * H * BTP;
    for (int w = tid; w < p.RG * CH; w += blockDim.x) {
      const int ch = w % CH, pc = (w / CH) * RB;
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      proj_dot<WT, DB>(acc, hs, BTP, pc, pw, H, CH, ch);
      const float bv = ldw(pb, ch);
#pragma unroll
      for (int r = 0; r < RB; ++r) t_s[(pc + r) * (CH + 1) + ch] = acc[r] + bv;
    }
    __syncthreads();
    row_stats(t_s, BT, CH, mean_s, rstd_s);
    __syncthreads();
    for (int idx = tid; idx < BT * CH; idx += blockDim.x) {
      const int r = idx / CH, ch = idx % CH;
      const long row = row0 + r;
      if (row < NR) {
        const long e = xi(row, k, ch);
        float v = ld(p.x, e, p.xs_bf16) + ((t_s[r * (CH + 1) + ch] - mean_s[r]) * rstd_s[r] *
                                               ldw(lg, ch) + ldw(lb, ch));
        if (p.xs_bf16) v = rnd<true>(v);  // xscr_half: the scratch's rounding, y too
        if (p.last)
          st(p.y, e, v, p.y_bf16);
        else
          st(p.x, e, v, p.xs_bf16);
      }
    }
    cur ^= 1;
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long row = row0 + col + r;
      if (row < NR) {
        st(p.h_out, row * H + j, h[r], p.s_bf16);
        st(p.c_out, row * H + j, c[r], p.s_bf16);
      }
    }
  }
}

// ------------------------------------------------------------------- host
inline int warps(int n) { return (n + 31) / 32 * 32; }

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Chunk {
  const void* x;
  const void* const* h_in;
  const void* const* c_in;
  const void* const* w;     // PER_BLOCK per block (each w_hh int8 x4 words under int8_hh)
  const void* const* s_hh;  // int8_hh: 3 per block (intra f, b, inter), scale / 127^2; else nullptr
  void* y;
  void* const* h_out;
  void* const* c_out;
  void* x_scr;              // float32, or bfloat16 under xscr_half (xs_bf16)
  void* y_dir;              // yf / yb [2][F][R][H]: float32, bfloat16 on the tensor cores
  int n, F, K, B, CH, H, x_bf16, s_bf16, y_bf16, xs_bf16;
  const int* plan;          // dp_tc::PLAN_FIELDS
  const void* const* img;   // tensor cores: IMAGES per block (ops/dual_path_kernel.py tc_images)
  __nv_bfloat16* x16;       // tensor cores without xscr_half: the bf16 copy of x_scr
};

constexpr int PER_BLOCK = 18;
constexpr int IMAGES = 8;   // W_ih / W_hh of f, b, i; [PW_f; PW_b]^T; PW_i^T

// xscr_half's first copy of x into the bfloat16 scratch
__global__ void to_half_kernel(const void* src, int src_bf16, __nv_bfloat16* dst, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(ld(src, i, src_bf16));
}

inline cudaError_t to_half(const void* src, int src_bf16, void* dst, long n,
                           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  to_half_kernel<<<blocks, 256, 0, stream>>>(src, src_bf16, static_cast<__nv_bfloat16*>(dst), n);
  return cudaGetLastError();
}

inline const float* scale_of(const Chunk& q, int blk, int i) {
  return q.s_hh ? static_cast<const float*>(q.s_hh[3 * blk + i]) : nullptr;
}

template <typename WT, bool DB>
cudaError_t run_tc(const Chunk& q, const void* x, int x_bf16, cudaStream_t stream);

template <typename WT, bool DB>
cudaError_t run(const Chunk& q, cudaStream_t stream) {
  const int H = q.H, CH = q.CH, R = q.K * q.B;
  const long NR = (long)q.F * R, NI = (long)q.F * q.B;
  constexpr int w_bf16 = std::is_same<WT, __nv_bfloat16>::value;
  cudaError_t err = dp_tc::check_plan(q.plan, q.F, q.K, q.B, CH, H, w_bf16, DB, q.s_hh != nullptr);
  if (err != cudaSuccess) return err;
  const void* x = q.x;
  int x_bf16 = q.x_bf16;
  if (q.xs_bf16) {  // xscr_half: every pass reads the rounded copy
    if ((err = to_half(q.x, q.x_bf16, q.x_scr, NR * CH, stream)) != cudaSuccess) return err;
    x = q.x_scr;
    x_bf16 = 1;
  }
  if (q.plan[0] == 1) return run_tc<WT, DB>(q, x, x_bf16, stream);
  // the CUDA-core passes: the intra pass runs 2 directions; row groups as
  // lstm_gates.cuh picks them, from the plan
  const int rg_a = q.plan[1], rg_b = q.plan[4], rg_c = q.plan[6];
  const int kt = tile_rows<WT>(4 * H);
  const size_t smem_a = q.plan[3], smem_b = q.plan[5], smem_c = q.plan[8];
  float* y_dir = static_cast<float*>(q.y_dir);
  if ((err = allow_smem(dp_intra_kernel<WT, DB>, smem_a)) != cudaSuccess) return err;
  if ((err = allow_smem(dp_proj_kernel<WT, DB>, smem_b)) != cudaSuccess) return err;
  if ((err = allow_smem(dp_inter_kernel<WT, DB>, smem_c)) != cudaSuccess) return err;
  for (int blk = 0; blk < q.n; ++blk) {
    const void* const* w = q.w + blk * PER_BLOCK;
    const bool first = blk == 0, last = blk == q.n - 1;
    IntraParams a{first ? x : q.x_scr, {w[0], w[3]}, {w[1], w[4]}, {w[2], w[5]},
                  {scale_of(q, blk, 0), scale_of(q, blk, 1)}, y_dir,
                  first ? x_bf16 : q.xs_bf16, q.F, R, CH, H, rg_a, kt};
    dp_intra_kernel<WT, DB><<<dim3((R + RB * rg_a - 1) / (RB * rg_a), 2), warps(rg_a * H), smem_a,
                              stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ProjParams b{y_dir, first ? x : q.x_scr, q.x_scr, w[6], w[7], w[8], w[9], w[10],
                 first ? x_bf16 : q.xs_bf16, q.xs_bf16, (int)NR, CH, H, rg_b};
    dp_proj_kernel<WT, DB><<<(unsigned)((NR + RB * rg_b - 1) / (RB * rg_b)), warps(rg_b * CH), smem_b,
                             stream>>>(b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    InterParams c{q.x_scr, q.y, q.h_in[blk], q.c_in[blk], q.h_out[blk], q.c_out[blk],
                  w[11], w[12], w[13], w[14], w[15], w[16], w[17], scale_of(q, blk, 2),
                  last, q.y_bf16, q.s_bf16, q.xs_bf16, q.F, q.K, q.B, CH, H, rg_c, kt};
    dp_inter_kernel<WT, DB><<<(unsigned)((NI + RB * rg_c - 1) / (RB * rg_c)), warps(rg_c * H), smem_c,
                              stream>>>(c);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The tensor-core route of every block (bf16 weights and dots): A and C on
// mma.sync chains in clusters of 2, B on wgmma (dual_path_tc.cuh). Their x
// operand is a bf16 copy: x itself when it is bf16, the scratch under
// xscr_half, else x16, written by to_half for the first block and by the
// epilogues of B (for C) and C (for the next block's A).
template <typename WT, bool DB>
cudaError_t run_tc(const Chunk& q, const void* x, int x_bf16, cudaStream_t stream) {
  if constexpr (std::is_same<WT, __nv_bfloat16>::value && DB) {
    using bf16 = __nv_bfloat16;
    const int R = q.K * q.B;
    const long NR = (long)q.F * R;
    const bool q8 = q.s_hh != nullptr;
    cudaError_t err;
    const bf16* xa = static_cast<const bf16*>(x);
    if (!x_bf16) {
      if ((err = to_half(x, 0, q.x16, NR * q.CH, stream)) != cudaSuccess) return err;
      xa = q.x16;
    }
    const bf16* xs16 = q.xs_bf16 ? static_cast<const bf16*>(q.x_scr) : q.x16;
    bf16* y_dir = static_cast<bf16*>(q.y_dir);
    for (int blk = 0; blk < q.n; ++blk) {
      const void* const* w = q.w + blk * PER_BLOCK;
      const void* const* im = q.img + blk * IMAGES;
      const bool first = blk == 0, last = blk == q.n - 1;
      dp_tc::ChainParams a{};
      a.xa = first ? xa : xs16;
      a.w_ih[0] = static_cast<const bf16*>(im[0]);
      a.w_hh[0] = im[1];
      a.w_ih[1] = static_cast<const bf16*>(im[2]);
      a.w_hh[1] = im[3];
      a.bias[0] = static_cast<const bf16*>(w[2]);
      a.bias[1] = static_cast<const bf16*>(w[5]);
      a.s_hh[0] = scale_of(q, blk, 0);
      a.s_hh[1] = scale_of(q, blk, 1);
      a.y_dir = y_dir;
      a.F = q.F; a.K = q.K; a.B = q.B; a.R = R; a.CH = q.CH; a.H = q.H;
      a.M = q.plan[1];
      a.nbx = q.plan[2];
      if ((err = dp_tc::launch_chain_q(a, false, q8, q.plan[3], stream)) != cudaSuccess) return err;
      dp_tc::ProjParams b{y_dir, first ? x : q.x_scr, q.x_scr, q.xs_bf16 ? nullptr : q.x16,
                          static_cast<const bf16*>(im[6]), static_cast<const bf16*>(w[8]),
                          static_cast<const bf16*>(w[9]), static_cast<const bf16*>(w[10]), NR,
                          first ? x_bf16 : q.xs_bf16, q.xs_bf16, q.H};
      if ((err = dp_tc::launch_proj(b, q.CH, q.plan[5], stream)) != cudaSuccess) return err;
      dp_tc::ChainParams c{};
      c.xa = xs16;
      c.w_ih[0] = static_cast<const bf16*>(im[4]);
      c.w_hh[0] = im[5];
      c.bias[0] = static_cast<const bf16*>(w[13]);
      c.s_hh[0] = scale_of(q, blk, 2);
      c.x = q.x_scr;
      c.y = q.y;
      c.x16_out = last || q.xs_bf16 ? nullptr : q.x16;
      c.h_in = q.h_in[blk];
      c.c_in = q.c_in[blk];
      c.h_out = q.h_out[blk];
      c.c_out = q.c_out[blk];
      c.pw = static_cast<const bf16*>(im[7]);
      c.pb = static_cast<const bf16*>(w[15]);
      c.lg = static_cast<const bf16*>(w[16]);
      c.lb = static_cast<const bf16*>(w[17]);
      c.last = last;
      c.y_bf16 = q.y_bf16;
      c.s_bf16 = q.s_bf16;
      c.xs_bf16 = q.xs_bf16;
      c.F = q.F; c.K = q.K; c.B = q.B; c.R = R; c.CH = q.CH; c.H = q.H;
      c.M = q.plan[6];
      c.nbx = q.plan[7];
      if ((err = dp_tc::launch_chain_q(c, true, q8, q.plan[8], stream)) != cudaSuccess) return err;
    }
    return cudaSuccess;
  } else {
    return cudaErrorInvalidConfiguration;   // the plan gives this route bf16 only
  }
}

// one inter pass (C) alone: the DPARN bottleneck's inter section. `plan`:
// dp_tc::PLAN_FIELDS; tensor cores: `img` its W_ih, W_hh and PW_i^T images,
// `x16` a bf16 scratch for the rounded copy of x (unused under xscr_half)
template <typename WT, bool DB>
cudaError_t run_inter(InterParams c, const int* plan, const void* const* img,
                      __nv_bfloat16* x16, cudaStream_t stream) {
  constexpr int w_bf16 = std::is_same<WT, __nv_bfloat16>::value;
  cudaError_t err = dp_tc::check_plan(plan, c.F, c.K, c.B, c.CH, c.H, w_bf16, DB,
                                      c.s_hh != nullptr);
  if (err != cudaSuccess) return err;
  if (plan[0] == 1) {
    if constexpr (w_bf16 && DB) {
      using bf16 = __nv_bfloat16;
      const long n = (long)c.F * c.K * c.B * c.CH;
      if (!c.xs_bf16 && (err = to_half(c.x, 0, x16, n, stream)) != cudaSuccess) return err;
      dp_tc::ChainParams t{};
      t.xa = c.xs_bf16 ? static_cast<const bf16*>(c.x) : x16;
      t.w_ih[0] = static_cast<const bf16*>(img[0]);
      t.w_hh[0] = img[1];
      t.bias[0] = static_cast<const bf16*>(c.bias);
      t.s_hh[0] = c.s_hh;
      t.x = c.x;
      t.y = c.y;
      t.h_in = c.h_in;
      t.c_in = c.c_in;
      t.h_out = c.h_out;
      t.c_out = c.c_out;
      t.pw = static_cast<const bf16*>(img[2]);
      t.pb = static_cast<const bf16*>(c.pb);
      t.lg = static_cast<const bf16*>(c.g);
      t.lb = static_cast<const bf16*>(c.b);
      t.last = c.last;
      t.y_bf16 = c.y_bf16;
      t.s_bf16 = c.s_bf16;
      t.xs_bf16 = c.xs_bf16;
      t.F = c.F; t.K = c.K; t.B = c.B; t.R = c.K * c.B; t.CH = c.CH; t.H = c.H;
      t.M = plan[6];
      t.nbx = plan[7];
      return dp_tc::launch_chain_q(t, true, c.s_hh != nullptr, plan[8], stream);
    } else {
      return cudaErrorInvalidConfiguration;
    }
  }
  c.RG = plan[6];
  c.KT = tile_rows<WT>(4 * c.H);
  const int bt = c.RG * RB;
  const size_t smem = plan[8];
  err = allow_smem(dp_inter_kernel<WT, DB>, smem);
  if (err != cudaSuccess) return err;
  dp_inter_kernel<WT, DB><<<(unsigned)(((long)c.F * c.B + bt - 1) / bt), warps(c.RG * c.H), smem,
                            stream>>>(c);
  return cudaGetLastError();
}

}  // namespace dual_path_passes
