// The wide-center masker of DPCRN and DPARN for one chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of puresound_tpu/ops/masker_kernel.py
// (_wide_call, pallas_call at :468; entries center_chunk :489 and
// dparn_center_chunk :536). One C call runs, for x [F, K, B, C0] (the d1
// output, F = 64 frequencies at the bottleneck):
//   d2, d3, d4   causal convs, freq kernel 3, time kernel 2, stride 1: output
//                row (fo, k, b) = PReLU(bias + sum over the time slot t (frame
//                k - 1 + t; frame -1 is the carry) and the frequency tap df
//                (fo - 1 + df, zero outside) of in @ W[3t + df]), BatchNorm
//                folded into W and bias on the host;
//   bottleneck   DPCRN: both dual-path blocks (dual_path_passes.cuh, the
//                passes of dual_path_chunk); DPARN: per block the attention
//                pass (dparn_attention.cuh) added to its input in place, then
//                the inter pass of dual_path_chunk;
//   u0, u1, u2   transpose convs: the same with the frequency tap fo + 1 - df
//                (the time taps are flipped in the weights), an h part and a
//                skip part (the d4, d3, d2 outputs), so no channel concat.
// The carries out are each layer input's last frame. Numerics are JAX's:
// product operands are rounded to the dot dtype (DB) as they are loaded;
// the d2, d3, u0 and u1 outputs are stored rounded to it (bfloat16 storage
// under DB); the d4 output and the bottleneck stay float32; y is written in
// x's dtype and the carries in theirs.
//
// What bounds it on the H100. At 2,048 streams (K = 2) the six convs are
// about 106 GFLOP and DPCRN's dual path 464 (DPARN's attention and inter
// blocks about 412): operations bound it, about 8.5 ms at the 67 TFLOP/s of
// float32 without tensor cores.
//
// What this design does about it. A TPU tile keeps the whole [F, K*bt + bt,
// C] stage stack of a stream tile in 100 MB of VMEM; an SM cannot hold a
// stream's. So the call is a sequence of passes with scratch in device
// memory, all launched by this one C call: per conv layer one kernel whose
// CTA owns TM output rows (TM x C_out <= 8,192 outputs) and walks its 6 (or
// 12, with the skip) taps, staging the gathered input rows [C_in][TM] and
// the tap's weights [C_in][C_out] in shared memory, then 4 x 8 outputs per
// thread on CUDA cores or, under bfloat16 dots and weights, mma.sync tiles on
// the tensor cores; a small copy kernel per carry; the bottleneck's passes
// as they are. Keeping the stages on chip across layers, and tensor cores
// in the dual-path passes, are later work.
//
// int8_hh (DPCRN): the dual-path passes' int8 recurrent products (see
// dual_path.cu). xscr_half: the bottleneck activation is a bfloat16 buffer;
// the d4 output is copied into it rounded (the float32 d4 stays the u0 skip),
// every residual write rounds, and u0 reads it, its carry rounded likewise.
#include "dparn_attention.cuh"
#include "dual_path_passes.cuh"

namespace {

using namespace lstm_gates;

constexpr int THREADS = 256;
constexpr int NCONV = 6;

struct ConvParams {
  const void* h;        // h part: frames [F, K, B, Ch]
  const void* hc;       // its carry, the previous frame [F, B, Ch]
  const void* s;        // skip part (nullptr: none) [F, K, B, Cs]
  const void* sc;       // its carry [F, B, Cs]
  const void* wh[NCONV];
  const void* ws[NCONV];
  const void* bias;
  const void* alpha;
  void* out;            // [F, K, B, Co]
  int h_bf16, hc_bf16, s_bf16, sc_bf16, out_bf16, round_out, tconv;
  int hc_round;         // round the h carry to bfloat16 (it enters xscr_half's scratch)
  int F, K, B, Ch, Cs, Co, TM;
  int mma;              // the products on tensor cores (bf16 dots and weights)
};

// 4 consecutive channels of a float32 or bfloat16 tensor (i % 4 == 0)
__device__ __forceinline__ float4 ld4(const void* p, long i, int bf16) {
  if (!bf16) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A[c][r] = the input of tap (t, df) for output row row0 + r, rounded. A
// thread takes 4 channels of one row; consecutive threads take consecutive
// rows, so the transposed stores hit distinct banks. Each thread issues its
// loads in groups of GB before storing any, so they are in flight together.
constexpr int GB = 4;

template <bool DB>
__device__ void gather(float* A, int lda, const void* fr, int fr_bf16, const void* cr,
                       int cr_bf16, int C, int t, int df, long row0, int F, int K, int B,
                       int TM, int tconv, int cr_round = 0) {
  const long NR = (long)F * K * B, KB = (long)K * B;
  const int n = TM * (C / 4);
  for (int base = threadIdx.x; base < n; base += GB * blockDim.x) {
    float4 v[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + u * blockDim.x;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      const long row = row0 + idx % TM;
      if (idx < n && row < NR) {
        const int c = 4 * (idx / TM);
        const int fo = (int)(row / KB), k = (int)(row % KB / B), b = (int)(row % B);
        const int fi = tconv ? fo + 1 - df : fo - 1 + df, kf = k - 1 + t;
        if (fi >= 0 && fi < F) {
          if (kf < 0) {
            v[u] = ld4(cr, ((long)fi * B + b) * C + c, cr_bf16);
            if (cr_round)
              v[u] = make_float4(rnd<true>(v[u].x), rnd<true>(v[u].y), rnd<true>(v[u].z),
                                 rnd<true>(v[u].w));
          } else {
            v[u] = ld4(fr, (((long)fi * K + kf) * B + b) * C + c, fr_bf16);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int r = idx % TM, c = 4 * (idx / TM);
        A[c * lda + r] = rnd<DB>(v[u].x);
        A[(c + 1) * lda + r] = rnd<DB>(v[u].y);
        A[(c + 2) * lda + r] = rnd<DB>(v[u].z);
        A[(c + 3) * lda + r] = rnd<DB>(v[u].w);
      }
    }
  }
}

// W[k][n] = a tap's weights [C][Co] as float, rounded to the dot dtype; 4
// consecutive weights a load, GB loads in flight
template <typename WT, bool DB>
__device__ void stage_tap(float* W, const WT* w, int n) {
  for (int base = 4 * threadIdx.x; base < n; base += 4 * GB * blockDim.x) {
    float4 v[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int i = base + 4 * u * blockDim.x;
      if (i < n) v[u] = ld4(w, i, std::is_same<WT, __nv_bfloat16>::value);
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int i = base + 4 * u * blockDim.x;
      if (i < n)
        *reinterpret_cast<float4*>(W + i) =
            make_float4(rndw<float, DB>(v[u].x), rndw<float, DB>(v[u].y),
                        rndw<float, DB>(v[u].z), rndw<float, DB>(v[u].w));
    }
  }
}

// The conv on tensor cores: the gathered rows and the tap's weights are
// bfloat16 values, so mma.sync m16n8k16 tiles (float32 sums) compute the
// CUDA-core loop's products. Warp w owns m-tile w / wpm and the n-tiles sub,
// sub + wpm, ... as in dparn_attention.cuh; then bias, PReLU, the rounding
// and the store.
__device__ void conv_mma(const ConvParams& p, float* A, int lda, float* W, long row0) {
  using namespace dparn_attn;
  const int TM = p.TM, Co = p.Co, wpm = (blockDim.x / 32) / (TM / 16), w = threadIdx.x / 32;
  const int m0 = (w / wpm) * 16, sub = w % wpm, NT = Co / 8;
  float acc[MAX_TILES][4] = {};
  for (int part = 0; part < (p.s ? 2 : 1); ++part) {
    const int C = part ? p.Cs : p.Ch;
    const __nv_bfloat16* const* ws =
        reinterpret_cast<const __nv_bfloat16* const*>(part ? p.ws : p.wh);
    for (int g = 0; g < NCONV; ++g) {
      gather<true>(A, lda, part ? p.s : p.h, part ? p.s_bf16 : p.h_bf16, part ? p.sc : p.hc,
                   part ? p.sc_bf16 : p.hc_bf16, C, g / 3, g % 3, row0, p.F, p.K, p.B, TM,
                   p.tconv);
      stage_tap<__nv_bfloat16, true>(W, ws[g], C * Co);
      __syncthreads();
      mma_steps<B_F32_KN>(acc, A, lda, m0, 0, C / 16, W, Co, 0, sub, wpm, NT);
      __syncthreads();
    }
  }
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  const float alpha = __bfloat162float(*static_cast<const __nv_bfloat16*>(p.alpha));
  const long NR = (long)p.F * p.K * p.B;
  const int lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MAX_TILES; ++j) {
    if (sub + j * wpm >= NT) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (sub + j * wpm) * 8 + 2 * t + (e & 1);
      const long row = row0 + m0 + gi + 8 * (e >> 1);
      if (row >= NR) continue;
      float v = acc[j][e] + __bfloat162float(bias[n]);
      v = v >= 0.f ? v : alpha * v;
      if (p.round_out) v = rnd<true>(v);
      st(p.out, row * Co + n, v, p.out_bf16);
    }
  }
}

template <typename WT, bool DB>
__global__ void __launch_bounds__(THREADS) conv_kernel(ConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int TM = p.TM, lda = TM + 4, Co = p.Co, ng = Co / 8, nmt = TM / 4 * ng;
  const int Cmax = p.Ch > p.Cs ? p.Ch : p.Cs;
  float* A = smem;                 // [Cmax][lda]
  float* W = A + Cmax * lda;       // [Cmax][Co]
  const long row0 = (long)blockIdx.x * TM;
  if constexpr (DB && std::is_same<WT, __nv_bfloat16>::value) {
    if (p.mma) {
      conv_mma(p, A, lda, W, row0);
      return;
    }
  }
  const int mt = threadIdx.x, m0 = (mt / ng) * 4, n0 = (mt % ng) * 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int part = 0; part < (p.s ? 2 : 1); ++part) {
    const int C = part ? p.Cs : p.Ch;
    for (int g = 0; g < NCONV; ++g) {
      gather<DB>(A, lda, part ? p.s : p.h, part ? p.s_bf16 : p.h_bf16, part ? p.sc : p.hc,
                 part ? p.sc_bf16 : p.hc_bf16, C, g / 3, g % 3, row0, p.F, p.K, p.B, TM,
                 p.tconv, part ? 0 : p.hc_round);
      stage_tap<WT, DB>(W, static_cast<const WT*>(part ? p.ws[g] : p.wh[g]), C * Co);
      __syncthreads();
      if (mt < nmt) {
#pragma unroll 2
        for (int k = 0; k < C; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(A + k * lda + m0);
          const float4 lo = *reinterpret_cast<const float4*>(W + k * Co + n0);
          const float4 hi = *reinterpret_cast<const float4*>(W + k * Co + n0 + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * wv[j];
        }
      }
      __syncthreads();
    }
  }
  if (mt >= nmt) return;
  const WT* bias = static_cast<const WT*>(p.bias);
  const float alpha = ldw(static_cast<const WT*>(p.alpha), 0);
  const long NR = (long)p.F * p.K * p.B;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + m0 + i;
    if (row >= NR) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[i][j] + ldw(bias, n0 + j);
      v = v >= 0.f ? v : alpha * v;
      if (p.round_out) v = rnd<DB>(v);
      st(p.out, row * Co + n0 + j, v, p.out_bf16);
    }
  }
}

// dst [F, B, C] = src [F, K, B, C] at frame K - 1 (rounded to the dot dtype
// when `round`)
template <bool DB>
__global__ void last_frame_kernel(const void* src, int src_bf16, void* dst, int dst_bf16,
                                  int F, int K, int B, int C, int round) {
  const long n = (long)F * B * C, BC = (long)B * C;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long f = i / BC;
    float v = ld(src, (f * K + K - 1) * BC + i % BC, src_bf16);
    st(dst, i, round ? rnd<DB>(v) : v, dst_bf16);
  }
}

struct Center {
  int kind, F, K, B, C0, C2, C3, C4, CH, Cu2, yC, H, FFD, heads;
  int x_bf16, c_bf16, w_bf16, dot_bf16, pe_bf16, xs_bf16;
  const void* x;
  const void* pe;
  const void* const* cin;   // dc0, dc1, dc2, u0h, u0s, u1h, u2h, h1, h2, c1, c2
  void* const* cout;
  const void* const* cw;    // 66 conv weights
  const void* const* bw;    // the bottleneck's weights
  const void* const* s_hh;  // DPCRN int8_hh: 3 scale vectors a block; else nullptr
  void* y;
  void* scr;                // d2, d3, u0, u1 outputs (the dot dtype)
  float* f32;               // d4 output (, yf / yb)
  void* xs;                 // the bottleneck activation (bfloat16 under xscr_half)
};

template <typename WT, bool DB>
cudaError_t conv(const Center& q, const void* h, int h_bf16, const void* hc, const void* s,
                 int s_bf16, const void* sc, const void* const* wh, const void* const* ws,
                 const void* bias, const void* alpha, void* out, int out_bf16, int round_out,
                 int tconv, int Ch, int Cs, int Co, cudaStream_t stream, int hc_round = 0) {
  ConvParams p{};
  p.hc_round = hc_round;
  p.h = h;
  p.hc = hc;
  p.s = s;
  p.sc = sc;
  for (int g = 0; g < NCONV; ++g) {
    p.wh[g] = wh[g];
    p.ws[g] = ws ? ws[g] : nullptr;
  }
  p.bias = bias;
  p.alpha = alpha;
  p.out = out;
  p.h_bf16 = h_bf16;
  p.hc_bf16 = q.c_bf16;
  p.s_bf16 = s_bf16;
  p.sc_bf16 = q.c_bf16;
  p.out_bf16 = out_bf16;
  p.round_out = round_out;
  p.tconv = tconv;
  p.F = q.F;
  p.K = q.K;
  p.B = q.B;
  p.Ch = Ch;
  p.Cs = s ? Cs : 0;
  p.Co = Co;
  // tensor cores under bf16 dots and weights when the channel counts fill
  // k16 / n8 tiles; then TM = 16 * 2^i <= 128 rows, TM * Co <= 8192
  int tm = 128;
  while (tm * Co > 8192) tm /= 2;
  p.mma = DB && std::is_same<WT, __nv_bfloat16>::value && Ch % 16 == 0 && p.Cs % 16 == 0 &&
          tm >= 16;
  // CUDA cores: 4-row microtiles, so TM is a multiple of 4 (float4 rows)
  p.TM = p.mma ? tm : (8192 / Co < 256 ? 8192 / Co : 256) & ~3;
  const int Cmax = Ch > p.Cs ? Ch : p.Cs;
  const size_t smem = sizeof(float) * ((size_t)Cmax * (p.TM + 4) + (size_t)Cmax * Co);
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<WT, DB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long NR = (long)q.F * q.K * q.B;
  conv_kernel<WT, DB><<<(unsigned)((NR + p.TM - 1) / p.TM), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool DB>
cudaError_t last_frame(const Center& q, const void* src, int src_bf16, void* dst, int C,
                       int round, cudaStream_t stream) {
  const long n = (long)q.F * q.B * C;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  last_frame_kernel<DB><<<blocks, 256, 0, stream>>>(src, src_bf16, dst, q.c_bf16, q.F, q.K,
                                                     q.B, C, round);
  return cudaGetLastError();
}

template <typename WT, bool DB>
cudaError_t run(const Center& q, cudaStream_t stream) {
  const long n = (long)q.F * q.K * q.B;
  const int sb = DB ? 1 : 0;              // stage buffers hold the dot dtype
  const size_t se = DB ? 2 : 4;
  char* scr = static_cast<char*>(q.scr);
  void* d2 = scr;
  void* d3 = scr + se * n * q.C2;
  void* u0 = scr + se * n * (q.C2 + q.C3);
  void* u1 = scr + se * n * (q.C2 + q.C3 + q.C4);
  float* d4 = q.f32;
  float* y_dir = d4 + n * q.CH;
  void* xs = q.xs;
  const void* const* cw = q.cw;
  const void* const* cin = q.cin;
  void* const* cout = q.cout;
  cudaError_t err;
#define CHECK(call) \
  if ((err = (call)) != cudaSuccess) return err
  // ------------------------------------------------ down: d2, d3, d4
  CHECK((conv<WT, DB>(q, q.x, q.x_bf16, cin[0], nullptr, 0, nullptr, cw, nullptr, cw[6],
                      cw[7], d2, sb, 1, 0, q.C0, 0, q.C2, stream)));
  CHECK(last_frame<DB>(q, q.x, q.x_bf16, cout[0], q.C0, 1, stream));
  CHECK((conv<WT, DB>(q, d2, sb, cin[1], nullptr, 0, nullptr, cw + 8, nullptr, cw[14],
                      cw[15], d3, sb, 1, 0, q.C2, 0, q.C3, stream)));
  CHECK(last_frame<DB>(q, d2, sb, cout[1], q.C2, 0, stream));
  CHECK((conv<WT, DB>(q, d3, sb, cin[2], nullptr, 0, nullptr, cw + 16, nullptr, cw[22],
                      cw[23], d4, 0, 0, 0, q.C3, 0, q.CH, stream)));
  CHECK(last_frame<DB>(q, d3, sb, cout[2], q.C3, 0, stream));
  CHECK(last_frame<DB>(q, d4, 0, cout[4], q.CH, 1, stream));
  // ------------------------------------------------ the bottleneck
  if (q.kind == 0) {
    dual_path_passes::Chunk c{d4, cin + 7, cin + 9, q.bw, q.s_hh, xs, cout + 7, cout + 9,
                              xs, y_dir, 2, q.F, q.K, q.B, q.CH, q.H, 0, q.c_bf16,
                              q.xs_bf16, q.xs_bf16};
    CHECK((dual_path_passes::run<WT, DB>(c, stream)));
  } else {
    constexpr int PER = dparn_attn::NW + 7;
    // xscr_half: the d4 output's rounded copy is the first block's input
    if (q.xs_bf16) CHECK(dual_path_passes::to_half(d4, 0, xs, n * q.CH, stream));
    const void* src = q.xs_bf16 ? xs : static_cast<const void*>(d4);
    for (int blk = 0; blk < 2; ++blk) {
      const void* const* w = q.bw + PER * blk;
      dparn_attn::AttnParams a{};
      a.x = blk ? xs : src;
      a.x_bf16 = q.xs_bf16;
      a.y_bf16 = q.xs_bf16;
      a.pe = q.pe;
      for (int i = 0; i < dparn_attn::NW; ++i) a.w[i] = w[i];
      a.y = xs;
      a.sr = q.CH;
      a.sf = (long)q.K * q.B * q.CH;
      a.R = q.K * q.B;
      a.F = q.F;
      a.C = q.CH;
      a.FFD = q.FFD;
      a.heads = q.heads;
      a.pe_bf16 = q.pe_bf16;
      a.residual = 1;
      CHECK((dparn_attn::run<WT, DB>(a, stream)));
      const void* const* iw = w + dparn_attn::NW;
      dual_path_passes::InterParams ip{xs, xs, cin[7 + blk], cin[9 + blk], cout[7 + blk],
                                       cout[9 + blk], iw[0], iw[1], iw[2], iw[3], iw[4],
                                       iw[5], iw[6], nullptr, 0, q.xs_bf16, q.c_bf16,
                                       q.xs_bf16, q.F, q.K, q.B, q.CH, q.H, 0, 0};
      CHECK((dual_path_passes::run_inter<WT, DB>(ip, stream)));
    }
  }
  CHECK(last_frame<DB>(q, xs, q.xs_bf16, cout[3], q.CH, 0, stream));
  // ------------------------------------------------ up: u0, u1, u2
  CHECK((conv<WT, DB>(q, xs, q.xs_bf16, cin[3], d4, 0, cin[4], cw + 24, cw + 30, cw[36],
                      cw[37], u0, sb, 1, 1, q.CH, q.CH, q.C4, stream, q.xs_bf16)));
  CHECK(last_frame<DB>(q, u0, sb, cout[5], q.C4, 0, stream));
  CHECK((conv<WT, DB>(q, u0, sb, cin[5], d3, sb, cin[2], cw + 38, cw + 44, cw[50], cw[51], u1,
                      sb, 1, 1, q.C4, q.C3, q.Cu2, stream)));
  CHECK(last_frame<DB>(q, u1, sb, cout[6], q.Cu2, 0, stream));
  CHECK((conv<WT, DB>(q, u1, sb, cin[6], d2, sb, cin[1], cw + 52, cw + 58, cw[64], cw[65],
                      q.y, q.x_bf16, 0, 1, q.Cu2, q.C2, q.yC, stream)));
#undef CHECK
  return cudaSuccess;
}

}  // namespace

// geo: kind (0 DPCRN, 1 DPARN), F, K, B, C0, C2, C3, C4, CH, Cu2, yC, H, FFD,
// heads, x_bf16, carries_bf16, weights_bf16, dot_bf16, pe_bf16, xscr_half
extern "C" int masker_center_chunk(const int* geo, const void* x, const void* pe,
                                   const void* const* carries_in, void* const* carries_out,
                                   const void* const* conv_weights,
                                   const void* const* bneck_weights,
                                   const void* const* s_hh, void* y, void* scr,
                                   void* f32_scr, void* xs, void* stream) {
  Center q{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8], geo[9],
           geo[10], geo[11], geo[12], geo[13], geo[14], geo[15], geo[16], geo[17], geo[18],
           geo[19], x, pe, carries_in, carries_out, conv_weights, bneck_weights, s_hh, y,
           scr, static_cast<float*>(f32_scr), xs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q.w_bf16)
    err = q.dot_bf16 ? run<__nv_bfloat16, true>(q, s) : run<__nv_bfloat16, false>(q, s);
  else
    err = q.dot_bf16 ? run<float, true>(q, s) : run<float, false>(q, s);
  return static_cast<int>(err);
}

extern "C" const char* masker_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
