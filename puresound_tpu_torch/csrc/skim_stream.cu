// Fused SkiM streaming frames for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   puresound_tpu/ops/skim_stream_kernel.py::fused_skim_frames (body _make_kernel),
// FiLM, Gate and unconditioned blocks. Per frame t and block i, for a tile of
// streams:
//   FiLM:  xn = LN(x); x = (xn @ Wsx + se[i]) * xn + (xn @ Wbx + be[i])
//   Gate:  u = x @ Win; left = PReLU(LN'(u @ Wl)); right = sigmoid(PReLU(LN'(u @ Wrx + ge[i])));
//          x += (left * right) @ Wout   (LN' two-pass with eps 1e-8; one PReLU slope each)
//   LSTM:  gates = x @ W_ih + h @ W_hh + b (i, f, g, o); c = f*c + i*g; h = o*tanh(c)
//   out:   x += LN(h @ proj_w + proj_b)
// Loads in the input dtype (float32 or bfloat16), all math in float32; with
// bf16 weights (dot_dtype=bf16) each dot operand is rounded to bf16 and the
// sum runs in float32. h/c stay on chip (float32) for the whole chunk and
// are written back in the state's dtype; y is written in x's dtype.
//
// What bounds it on the H100: the weights (flagship n=4, C=128, H=256: about
// 1.8 M values, 3.7 MB in bf16 / 7.4 MB in f32) fit in the 50 MB L2 but not in
// one SM's 227 KB of shared memory, and the frame loop and the block loop are
// serial (each step needs the previous h): a call is a chain of F x n block
// steps (60 at the flagship's 15 frames), each of which must bring its
// weights into the SMs that use them.
//
// Two routes, chosen by the launch plan (ops/skim_stream_kernel.py `_plan`,
// computed again by skim_stream_tc.cuh `make_plan` at each launch; a plan
// that differs is refused):
//  - tensor cores (bf16 dots at C = 128, Hg = 128, n >= 2; the flagship's
//    serving route, with and without int8_hh / int8_full, FiLM, Gate or
//    unconditioned blocks), skim_stream_tc.cuh: clusters of K CTAs split
//    the hidden units, M = 16 or 32 streams a tile; every product on
//    mma.sync (bf16 m16n8k16, int8 m16n8k32), the weights streamed from L2
//    through a bulk-copy ring in images the wrapper packs once; h exchanged
//    through distributed shared memory, one cluster barrier a block step.
//  - CUDA cores (float32 dots, and widths off the model geometry), below:
//    one CTA per tile of BT=8 streams, one thread per hidden unit (looping
//    when H > blockDim). Thread j computes the four gate pre-activations of
//    unit j for all 8 streams, so each weight is read from L2 once per tile
//    and frame and reused 8 times from a register; reads of a weight row are
//    coalesced across j; the cell update is thread-local and c of unit j
//    never leaves its owner's shared-memory slot. The tile's x and h values
//    are broadcast from shared memory. LayerNorm is one warp per stream. A
//    ragged last tile is masked. At the flagship's shapes in f32 the serial
//    chain of one CTA is the bound up to one wave (B <= 8 x 132) (PERF.md).
//
// int8 (q_mode bit 0: int8_hh, the recurrent product; bit 1: int8_full, also
// the FiLM dots, W_ih and the projection): JAX's dot_hh / dot_dyn. On the
// CUDA cores a warp per stream quantizes the activation rows once per block
// step into shared memory (clip(rint(v * 127)) for h; per-row amax,
// clip(rint(v / amax * 127)) for x and xn), packed 4 a word along k; the
// quantized weights come packed the same way ([K/4][N] words, w_q) with their
// scales already divided (w_s), so thread j sums 4 products per __dp4a into
// int32 (exact) and scales once: acc * s, or acc * (amax / 127) * s. The
// tensor-core route sums the same int8 values exactly on m16n8k32 and scales
// them the same way.
//
// Gate (gate_mask): four more products of width Hg per block step (x @ Win,
// u @ Wl and u @ Wrx together, (left * right) @ Wout), in the dot dtype
// whatever q_mode says (JAX leaves them unquantized). On the CUDA cores
// thread o owns output column o for the tile's 8 streams as in the FiLM
// dots; its two LayerNorms, the PReLUs and the sigmoid run in one pass of
// the warp that owns the stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "skim_stream_tc.cuh"

namespace {

constexpr int BT = 8;         // streams per CTA
constexpr int THREADS = 256;  // 8 warps

struct Params {
  const void* x;     // [B, F, C]
  const void* se;    // [n, B, C]
  const void* be;    // [n, B, C]
  const void* ge;    // [n, B, Hg]
  const void* h_in;  // [n, B, H]
  const void* c_in;  // [n, B, H]
  void* y;           // [B, F, C]
  void* h_out;       // [n, B, H]
  void* c_out;       // [n, B, H]
  const void* w_mat; // per block: wsx[C,C] wbx[C,C] w_ih[C,4H] w_hh[H,4H] proj_w[H,C]
  const float* w_vec;// per block: fg[C] fb[C] b[4H] proj_b[C] ln_g[C] ln_b[C]
  const int* w_q;    // per block, int8 x4 words: wsx[C/4][C] wbx[C/4][C]
                     // w_ih[C/4][4H] w_hh[H/4][4H] proj_w[H/4][C]
  const float* w_s;  // per block: their column scales, divided as dequant_scale
  const void* g_mat; // per block: win[C,Hg] wl[Hg,Hg] wrx[Hg,Hg] wout[Hg,C], or null
  const float* g_vec;// per block: lg[Hg] lb[Hg] rg[Hg] rb[Hg] la ra, or null
  int B, F, C, H, Hg, n_blocks, film_mask, gate_mask, x_bf16, s_bf16, q_mode;
};

__device__ __forceinline__ float ld(const void* p, long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float wload(const float* w, long i) { return w[i]; }
__device__ __forceinline__ float wload(const __nv_bfloat16* w, long i) {
  return __bfloat162float(w[i]);
}

// round a dot operand to the weights' type (identity for float32)
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// clip(round(v), -127, 127) with round half to even, as jnp.round
__device__ __forceinline__ int q8(float v) { return max(-127, min(127, __float2int_rn(v))); }

// One warp quantizes the K-vector v (K % 4 == 0) into dst[K/4] words, 4 int8
// a word (byte e = element 4w + e). dynamic: JAX's dot_dyn, v / amax * 127
// with amax = max|v| clipped at 1e-8, written to *amax; else dot_hh, v * 127.
__device__ void warp_quant(const float* v, int K, int* dst, float* amax, bool dynamic) {
  const int lane = threadIdx.x & 31;
  float m = 1.f;
  if (dynamic) {
    float a = 0.f;
    for (int k = lane; k < K; k += 32) a = fmaxf(a, fabsf(v[k]));
    m = fmaxf(warp_max(a), 1e-8f);
    if (lane == 0) *amax = m;
  }
  for (int w = lane; w < K / 4; w += 32) {
    unsigned packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = v[4 * w + e];
      const int q = q8(dynamic ? x / m * 127.f : x * 127.f);
      packed |= (unsigned)(q & 0xff) << (8 * e);
    }
    dst[w] = (int)packed;
  }
}

// Two-pass LayerNorm of one C-vector by one warp (eps 1e-5):
// out = LN(v) * g + b, or out += that when `accumulate`.
__device__ void warp_ln(const float* v, int C, const float* g, const float* b,
                        float* out, bool accumulate) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < C; k += 32) s += v[k];
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = v[k] - mean;
    q += d * d;
  }
  const float r = rsqrtf(warp_sum(q) / C + 1e-5f);
  for (int k = lane; k < C; k += 32) {
    const float y = (v[k] - mean) * r * g[k] + b[k];
    out[k] = accumulate ? out[k] + y : y;
  }
}

// Two-pass LayerNorm statistics of one K-vector by one warp: (mean, rstd).
__device__ __forceinline__ float2 warp_ln_stats(const float* v, int K, float eps) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += v[k];
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = v[k] - mean;
    q += d * d;
  }
  return make_float2(mean, rsqrtf(warp_sum(q) / K + eps));
}

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.f) + a * fminf(v, 0.f);
}

// A Gate's elementwise middle for one stream, by one warp: left = PReLU(LN(l)),
// right = sigmoid(PReLU(LN(r))), l <- left * right. gv: lg lb rg rb [Hg], la ra.
__device__ void warp_gate_mix(float* l, const float* r, int Hg, const float* gv) {
  const int lane = threadIdx.x & 31;
  const float2 sl = warp_ln_stats(l, Hg, 1e-8f);
  const float2 sr = warp_ln_stats(r, Hg, 1e-8f);
  const float la = gv[4 * Hg], ra = gv[4 * Hg + 1];
  for (int k = lane; k < Hg; k += 32) {
    const float left = prelu((l[k] - sl.x) * sl.y * gv[k] + gv[Hg + k], la);
    const float right =
        sigm(prelu((r[k] - sr.x) * sr.y * gv[2 * Hg + k] + gv[3 * Hg + k], ra));
    l[k] = left * right;
  }
}

template <typename TW>
__global__ void __launch_bounds__(THREADS) skim_frames_kernel(Params p) {
  extern __shared__ float smem[];
  const int C = p.C, H = p.H, n = p.n_blocks, G = 4 * H, B = p.B;
  float* h_s = smem;              // [n][BT][H] carried h
  float* c_s = h_s + n * BT * H;  // [n][BT][H] carried c
  float* x_s = c_s + n * BT * H;  // [BT][C] block stream x
  float* xn_s = x_s + BT * C;     // [BT][C] LN(x) of a FiLM block
  float* t0_s = xn_s + BT * C;    // [BT][C] FiLM scale dot / projection
  float* t1_s = t0_s + BT * C;    // [BT][C] FiLM bias dot
  float* hn_s = t1_s + BT * C;    // [BT][H] new h of the current block
  const int KQ = (C > H ? C : H) / 4;
  int* aq_s = reinterpret_cast<int*>(hn_s + BT * H);  // [BT][KQ] quantized rows
  int* hq_s = aq_s + BT * KQ;                          // [BT][H/4] quantized h
  float* amax_s = reinterpret_cast<float*>(hq_s + BT * H / 4);  // [BT]
  const int Hg = p.Hg;
  float* gu_s = amax_s + BT;      // [BT][Hg] Gate u = x @ Win
  float* gl_s = gu_s + BT * Hg;   // [BT][Hg] Gate left pre-activation, then left * right
  float* gr_s = gl_s + BT * Hg;   // [BT][Hg] Gate right pre-activation
  const bool q_hh = p.q_mode & 1, q_full = p.q_mode & 2;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const long mat_stride = 2L * C * C + (long)C * G + (long)H * G + (long)H * C;
  const int vec_stride = 2 * C + G + 3 * C;
  const long q_stride = mat_stride / 4;  // words
  const int s_stride = 2 * C + 2 * G + C;
  const long g_stride = 2L * C * Hg + 2L * Hg * Hg;

  for (int idx = tid; idx < n * BT * H; idx += nthr) {
    const int i = idx / (BT * H), r = idx % (BT * H), b = r / H, j = r % H;
    float hv = 0.f, cv = 0.f;
    if (b < nb) {
      const long g = ((long)i * B + b0 + b) * H + j;
      hv = ld(p.h_in, g, p.s_bf16);
      cv = ld(p.c_in, g, p.s_bf16);
    }
    h_s[idx] = hv;
    c_s[idx] = cv;
  }

  for (int t = 0; t < p.F; ++t) {
    for (int idx = tid; idx < BT * C; idx += nthr) {
      const int b = idx / C, k = idx % C;
      x_s[idx] = b < nb ? ld(p.x, ((long)(b0 + b) * p.F + t) * C + k, p.x_bf16) : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const TW* wm = static_cast<const TW*>(p.w_mat) + i * mat_stride;
      const float* wv = p.w_vec + (long)i * vec_stride;

      if ((p.film_mask >> i) & 1) {
        const float* fg = wv;
        const float* fb = wv + C;
        for (int b = warp; b < BT; b += nwarps) {
          warp_ln(x_s + b * C, C, fg, fb, xn_s + b * C, false);
          if (q_full) {
            __syncwarp();
            warp_quant(xn_s + b * C, C, aq_s + b * KQ, amax_s + b, true);
          }
        }
        __syncthreads();
        // output o < C: scale column o; o >= C: bias column o - C
        for (int o = tid; o < 2 * C; o += nthr) {
          const int col = o < C ? o : o - C;
          float acc[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = 0.f;
          if (q_full) {
            const int* w = p.w_q + i * q_stride + (o < C ? 0 : (long)C * C / 4);
            const float sc = p.w_s[(long)i * s_stride + o];
            int ia[BT];
#pragma unroll
            for (int b = 0; b < BT; ++b) ia[b] = 0;
#pragma unroll 4
            for (int g = 0; g < C / 4; ++g) {
              const int wk = w[(long)g * C + col];
#pragma unroll
              for (int b = 0; b < BT; ++b) ia[b] = __dp4a(aq_s[b * KQ + g], wk, ia[b]);
            }
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] = (float)ia[b] * (amax_s[b] / 127.f) * sc;
          } else {
            const TW* w = wm + (o < C ? 0 : (long)C * C);
#pragma unroll 4
            for (int k = 0; k < C; ++k) {
              const float wk = wload(w, (long)k * C + col);
#pragma unroll
              for (int b = 0; b < BT; ++b) acc[b] += rnd(xn_s[b * C + k], wm) * wk;
            }
          }
          float* dst = o < C ? t0_s : t1_s;
#pragma unroll
          for (int b = 0; b < BT; ++b) dst[b * C + col] = acc[b];
        }
        __syncthreads();
        for (int idx = tid; idx < BT * C; idx += nthr) {
          const int b = idx / C, k = idx % C;
          float sv = 0.f, bv = 0.f;
          if (b < nb) {
            const long g = ((long)i * B + b0 + b) * C + k;
            sv = ld(p.se, g, p.x_bf16);
            bv = ld(p.be, g, p.x_bf16);
          }
          x_s[idx] = (t0_s[idx] + sv) * xn_s[idx] + (t1_s[idx] + bv);
        }
        __syncthreads();
      }

      if ((p.gate_mask >> i) & 1) {
        const TW* win = static_cast<const TW*>(p.g_mat) + i * g_stride;
        const TW* wl = win + (long)C * Hg;
        const TW* wrx = wl + (long)Hg * Hg;
        const TW* wout = wrx + (long)Hg * Hg;
        const float* gv = p.g_vec + (long)i * (4 * Hg + 2);
        for (int o = tid; o < Hg; o += nthr) {
          float acc[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
          for (int k = 0; k < C; ++k) {
            const float wk = wload(win, (long)k * Hg + o);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] += rnd(x_s[b * C + k], wm) * wk;
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) gu_s[b * Hg + o] = acc[b];
        }
        __syncthreads();
        // output o < Hg: left column o; o >= Hg: right column o - Hg, plus ge
        for (int o = tid; o < 2 * Hg; o += nthr) {
          const bool left = o < Hg;
          const int col = left ? o : o - Hg;
          const TW* w = left ? wl : wrx;
          float acc[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
          for (int k = 0; k < Hg; ++k) {
            const float wk = wload(w, (long)k * Hg + col);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] += rnd(gu_s[b * Hg + k], wm) * wk;
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            if (left) {
              gl_s[b * Hg + col] = acc[b];
            } else {
              const float e =
                  b < nb ? ld(p.ge, ((long)i * B + b0 + b) * Hg + col, p.x_bf16) : 0.f;
              gr_s[b * Hg + col] = acc[b] + e;
            }
          }
        }
        __syncthreads();
        for (int b = warp; b < BT; b += nwarps)
          warp_gate_mix(gl_s + b * Hg, gr_s + b * Hg, Hg, gv);
        __syncthreads();
        for (int o = tid; o < C; o += nthr) {
          float acc[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
          for (int k = 0; k < Hg; ++k) {
            const float wk = wload(wout, (long)k * C + o);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] += rnd(gl_s[b * Hg + k], wm) * wk;
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) x_s[b * C + o] += acc[b];
        }
        __syncthreads();
      }

      // LSTM cell: thread j owns hidden unit j of every stream in the tile
      const TW* w_ih = wm + 2L * C * C;
      const TW* w_hh = w_ih + (long)C * G;
      const TW* pw = w_hh + (long)H * G;
      const float* bias = wv + 2 * C;
      const float* pb = bias + G;
      const float* lg = pb + C;
      const float* lb = lg + C;
      float* hi = h_s + i * BT * H;
      float* ci = c_s + i * BT * H;
      if (q_hh || q_full) {
        for (int b = warp; b < BT; b += nwarps) {
          if (q_hh) warp_quant(hi + b * H, H, hq_s + b * (H / 4), nullptr, false);
          if (q_full) warp_quant(x_s + b * C, C, aq_s + b * KQ, amax_s + b, true);
        }
        __syncthreads();
      }
      const int* wq_ih = p.w_q + i * q_stride + (long)C * C / 2;
      const int* wq_hh = wq_ih + (long)C * G / 4;
      const float* s_ih = p.w_s + (long)i * s_stride + 2 * C;
      const float* s_hh = s_ih + G;
      for (int j = tid; j < H; j += nthr) {
        float a[4][BT];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int b = 0; b < BT; ++b) a[q][b] = 0.f;
        if (q_full) {
          int ia[4][BT];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < BT; ++b) ia[q][b] = 0;
#pragma unroll 2
          for (int g = 0; g < C / 4; ++g) {
            const int* row = wq_ih + (long)g * G + j;
            const int w0 = row[0], w1 = row[H], w2 = row[2 * H], w3 = row[3 * H];
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              const int v = aq_s[b * KQ + g];
              ia[0][b] = __dp4a(v, w0, ia[0][b]);
              ia[1][b] = __dp4a(v, w1, ia[1][b]);
              ia[2][b] = __dp4a(v, w2, ia[2][b]);
              ia[3][b] = __dp4a(v, w3, ia[3][b]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sc = s_ih[q * H + j];
#pragma unroll
            for (int b = 0; b < BT; ++b) a[q][b] = (float)ia[q][b] * (amax_s[b] / 127.f) * sc;
          }
        } else {
#pragma unroll 2
          for (int k = 0; k < C; ++k) {
            const long row = (long)k * G + j;
            const float w0 = wload(w_ih, row), w1 = wload(w_ih, row + H),
                        w2 = wload(w_ih, row + 2 * H), w3 = wload(w_ih, row + 3 * H);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              const float v = rnd(x_s[b * C + k], wm);
              a[0][b] += v * w0;
              a[1][b] += v * w1;
              a[2][b] += v * w2;
              a[3][b] += v * w3;
            }
          }
        }
        if (q_hh) {
          int ia[4][BT];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < BT; ++b) ia[q][b] = 0;
#pragma unroll 2
          for (int g = 0; g < H / 4; ++g) {
            const int* row = wq_hh + (long)g * G + j;
            const int w0 = row[0], w1 = row[H], w2 = row[2 * H], w3 = row[3 * H];
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              const int v = hq_s[b * (H / 4) + g];
              ia[0][b] = __dp4a(v, w0, ia[0][b]);
              ia[1][b] = __dp4a(v, w1, ia[1][b]);
              ia[2][b] = __dp4a(v, w2, ia[2][b]);
              ia[3][b] = __dp4a(v, w3, ia[3][b]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sc = s_hh[q * H + j];
#pragma unroll
            for (int b = 0; b < BT; ++b) a[q][b] += (float)ia[q][b] * sc;
          }
        } else {
#pragma unroll 2
          for (int k = 0; k < H; ++k) {
            const long row = (long)k * G + j;
            const float w0 = wload(w_hh, row), w1 = wload(w_hh, row + H),
                        w2 = wload(w_hh, row + 2 * H), w3 = wload(w_hh, row + 3 * H);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              const float v = rnd(hi[b * H + k], wm);
              a[0][b] += v * w0;
              a[1][b] += v * w1;
              a[2][b] += v * w2;
              a[3][b] += v * w3;
            }
          }
        }
        const float bi = bias[j], bf = bias[H + j], bg = bias[2 * H + j],
                    bo = bias[3 * H + j];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float ig = sigm(a[0][b] + bi), fg = sigm(a[1][b] + bf);
          const float gg = tanhf(a[2][b] + bg), og = sigm(a[3][b] + bo);
          const float cn = fg * ci[b * H + j] + ig * gg;
          ci[b * H + j] = cn;
          hn_s[b * H + j] = og * tanhf(cn);
        }
      }
      __syncthreads();
      for (int idx = tid; idx < BT * H; idx += nthr) hi[idx] = hn_s[idx];
      if (q_full) {
        for (int b = warp; b < BT; b += nwarps)
          warp_quant(hn_s + b * H, H, aq_s + b * KQ, nullptr, false);
        __syncthreads();
      }
      for (int o = tid; o < C; o += nthr) {
        float acc[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = 0.f;
        if (q_full) {
          const int* w = wq_hh + (long)H * G / 4;
          const float sc = s_hh[G + o];
          int ia[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) ia[b] = 0;
#pragma unroll 4
          for (int g = 0; g < H / 4; ++g) {
            const int wk = w[(long)g * C + o];
#pragma unroll
            for (int b = 0; b < BT; ++b) ia[b] = __dp4a(aq_s[b * KQ + g], wk, ia[b]);
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = (float)ia[b] * sc;
        } else {
#pragma unroll 4
          for (int k = 0; k < H; ++k) {
            const float wk = wload(pw, (long)k * C + o);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] += rnd(hn_s[b * H + k], wm) * wk;
          }
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) t0_s[b * C + o] = acc[b] + pb[o];
      }
      __syncthreads();
      for (int b = warp; b < BT; b += nwarps)
        warp_ln(t0_s + b * C, C, lg, lb, x_s + b * C, true);
      __syncthreads();
    }

    // each thread stores the x_s entries it loads next frame: no race
    for (int idx = tid; idx < BT * C; idx += nthr) {
      const int b = idx / C, k = idx % C;
      if (b < nb) st(p.y, ((long)(b0 + b) * p.F + t) * C + k, x_s[idx], p.x_bf16);
    }
  }

  for (int idx = tid; idx < n * BT * H; idx += nthr) {
    const int i = idx / (BT * H), r = idx % (BT * H), b = r / H, j = r % H;
    if (b < nb) {
      const long g = ((long)i * B + b0 + b) * H + j;
      st(p.h_out, g, h_s[idx], p.s_bf16);
      st(p.c_out, g, c_s[idx], p.s_bf16);
    }
  }
}

template <typename TW>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int kq = (p.C > p.H ? p.C : p.H) / 4;
  const size_t smem =
      sizeof(float) * (2L * p.n_blocks * BT * p.H + 4L * BT * p.C + (long)BT * p.H) +
      sizeof(int) * ((size_t)BT * kq + (size_t)BT * p.H / 4) +
      sizeof(float) * (BT + 3L * BT * p.Hg);
  cudaError_t err = cudaFuncSetAttribute(
      skim_frames_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + BT - 1) / BT);
  skim_frames_kernel<TW><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The __dp4a issue rate, the peak of the int8 products above: each thread
// runs 8 independent dp4a chains `iters` times (asm volatile, so none is
// folded away) and writes their sum. 8 dp4a a thread and iteration, each 4
// multiply-adds.
__global__ void dp4a_rate_kernel(int* out, int a, int b, int iters) {
  int acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = threadIdx.x + i;
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("dp4a.s32.s32 %0, %1, %2, %0;" : "+r"(acc[i]) : "r"(a), "r"(b + i));
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: blocks x 256 ints; iters a multiple of 8
extern "C" int skim_dp4a_rate(void* out, int blocks, int iters, void* stream) {
  dp4a_rate_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), 0x01020304, 0x7f7f7f7f, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skim_stream_frames(const void* x, const void* se, const void* be,
                                  const void* ge, const void* h_in, const void* c_in,
                                  void* y, void* h_out, void* c_out, const void* w_mat,
                                  const void* w_vec, const void* w_q, const void* w_s,
                                  const void* g_mat, const void* g_vec, int B, int F,
                                  int C, int H, int Hg, int n_blocks, int film_mask,
                                  int gate_mask, int x_bf16, int s_bf16, int w_bf16,
                                  int q_mode, const int* plan, const void* img,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = skim_tc::check_plan(plan, B, C, H, Hg, n_blocks, film_mask, gate_mask,
                                        w_bf16, q_mode & 1, (q_mode >> 1) & 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan[0] == 1) {
    const int M = plan[2];
    const skim_tc::TcParams tp{x, se, be, ge, h_in, c_in, y, h_out, c_out,
                               static_cast<const unsigned char*>(img),
                               static_cast<const float*>(w_vec), static_cast<const float*>(w_s),
                               static_cast<const float*>(g_vec), B, F, C, H, Hg, n_blocks,
                               film_mask, gate_mask, x_bf16, s_bf16, plan[1], M, plan[3],
                               plan[5], (B + M - 1) / M};
    err = skim_tc::launch(tp, q_mode, plan[4], s);
    return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
  }
  Params p{x, se, be, ge, h_in, c_in, y, h_out, c_out, w_mat,
           static_cast<const float*>(w_vec), static_cast<const int*>(w_q),
           static_cast<const float*>(w_s), g_mat, static_cast<const float*>(g_vec),
           B, F, C, H, Hg, n_blocks, film_mask, gate_mask, x_bf16, s_bf16, q_mode};
  err = w_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
  return static_cast<int>(err);
}

// clusters of K CTAs of the tensor-core kernel in flight on the card
// (cudaOccupancyMaxActiveClusters at one CTA an SM); 0 where none fits
extern "C" int skim_tc_clusters(int K) { return skim_tc::sm_clusters(K); }

extern "C" const char* skim_stream_error_string(int err) {
  if (err == skim_tc::PLAN_MISMATCH)
    return "the launch plan differs from skim_stream_tc.cuh make_plan's";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
