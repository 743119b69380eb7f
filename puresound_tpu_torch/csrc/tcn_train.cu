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
// in float32 or bfloat16 (all one dtype) and the gradients go out in it, as
// float32 sums over the batch.
//
// What bounds it on the H100. At the speaker net's training shape (B = 64,
// C = 128, Ch = 256, T = 1,999) the three 1x1 products are 33.5 GFLOP in the
// forward and about 100.6 GFLOP in the backward with its recompute. In
// float32 without tensor cores (67 TFLOP/s) operations bound the block:
// about 0.50 ms forward, 1.50 ms backward. In bf16 on wgmma (989 TFLOP/s)
// the products take 0.03 / 0.10 ms, and what is left is bytes: a sample's
// hidden activation (2 MB at T = 1,999) does not fit one SM and each global
// norm needs the whole sample's statistics before it can normalise, so the
// block is MULTI-PASS with float32 scratch (h1, h2, h3; two more for the
// backward, rows padded to Tp = T rounded up to 8), about 0.9 GB of traffic
// forward and 3.4 GB backward at that shape (0.27 / 1.0 ms at 3.35 TB/s).
//
// The passes, which both routes share:
//   forward   product W_in x (+ per-tile sums of h, h^2) -> stats reduce
//             -> depthwise over PReLU1(gLN1(h1)) (+ per-row sums) -> reduce
//             -> product W_pw over PReLU2(gGN2(h2)) (+ sums) -> reduce
//             -> product W_out over PReLU3(gGN3(h3)) + b_out + x
//   backward  the forward's first five passes, then per level the product
//             with the transposed weight for the input gradient, the PReLU
//             and norm VJPs' per-(b, c) row sums (sum dyn*xhat, dyn and the
//             alpha term), fixed-order reduces for the per-sample sums and
//             the norm and alpha gradients, and the weight-gradient product
//             over fixed ranges of the B*T columns whose partials are added
//             in a fixed order. The depthwise VJP is one row pass that also
//             runs PReLU1/gLN1's. No atomics: two calls are bit-equal.
//
// The routes (ops/tcn_train_kernel.py `_plan` picks one by shape and dtype;
// `make_plan` below computes the same and a plan that differs is refused):
//   wgmma      bf16 x with C and Ch in {64, 128, 256}. Each 1x1 product is
//              a persistent CTA (tcn_wg_gemm) that keeps its whole weight
//              (W or W^T, O x K) resident in shared memory, brought in once
//              a call by the bulk copy engine on an mbarrier from an image
//              that tcn_prep_kernel packs per call in wgmma's swizzled
//              K-major layout. The CTA walks column tiles of NC columns of
//              one sample (64 where O = 256, else 128): its 256 threads read
//              the operand's rows with 32-byte loads (NC / 8 threads a row:
//              coalesced), normalise them in registers (ACT = PReLU(gLN(h)),
//              DNORM = the norm VJP from h and the incoming gradient), round
//              them to bf16 and store each column tile ONCE, 16 bytes a
//              store, into an MN-major [K][NC] tile: the activation is
//              T-contiguous, so the B operand is read transposed (trans-b,
//              `hopper::desc_mn`) and nothing is transposed in registers.
//              Two tile buffers; the next tile's first group of loads is
//              issued before this tile's products are waited for and stays
//              in flight through the epilogue. The epilogue goes through a
//              per-warp staging tile in shared memory so that its global
//              traffic is coalesced (16-byte accesses, 8 lanes a 128-byte
//              row segment); it adds the bias (and the residual), stores
//              the typed output, writes the tile's norm sums (s, s^2) and,
//              in the backward, folds the next level's PReLU VJP: it reads h
//              at its own outputs, stores dyn = da * PReLU'(y) and writes
//              the tile's row sums, so no pass reads da back. The weight
//              gradients (tcn_wg_wgrad) are dW = D A^T over the columns:
//              both operands are column-contiguous, so both tiles are
//              K-major with 16-byte stores; a CTA owns a fixed range of
//              64-column chunks and an [O-block x K] float32 accumulator (128
//              rows where K = 256, else 256: dW_pw's A operand is
//              normalised once per O-block, twice), and the bias gradient is
//              summed from the unrounded D in the same pass.
//              What bounds it: bytes, and how many of them are in flight.
//              A CTA per SM alternates loading a tile and storing the
//              previous tile's output, and every SM does so at about the
//              same time, so the passes run at about a third to a half of
//              the card's 3.35 TB/s (`PERF.md` holds the device time by
//              kernel); the products themselves take a few per cent.
//   CUDA cores every float32 call (no TF32: it would round the operands)
//              and bf16 shapes off that geometry: 64 x 64 output tiles, 4 x 4
//              outputs a thread, operands normalised on load per output
//              tile (tcn_gemm_kernel, tcn_wgrad_kernel), the PReLU VJP in
//              its own row pass (tcn_norm_rows_kernel). Operations bound it.
// The memory-bound passes run on CUDA cores for both routes: the depthwise
// forward and VJP stage a row segment with its halo, normalised once, in
// shared memory and write 4 columns a thread with 16-byte stores; the
// statistics reduces are fixed-order trees.
#include <mutex>
#include <utility>
#include <vector>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;      // CUDA-core GEMM / weight-gradient tile (rows x columns)
constexpr int KS = 16;        // CUDA-core GEMM depth per shared-memory stage
constexpr int RB = 32;        // CUDA-core weight-gradient columns per stage
constexpr int PAD = 68;       // padded row of a staged tile (16-byte aligned)
constexpr int THREADS = 256;  // every kernel
constexpr int MAXK = 8;       // most depthwise taps
constexpr float EPS = 1e-8f;
// the plan's constants; ops/tcn_train_kernel.py holds the same numbers
constexpr int H100_SMS = 132;      // persistent CTAs of a wgmma pass
constexpr int SMEM_MAX = 232448;   // shared memory a block may use
constexpr int WG_COLS = 64;        // columns a weight-gradient chunk (wgmma)
constexpr int DW_SEG = 2048;       // columns a depthwise segment
constexpr int ALIGN_F = 64;        // floats: every scratch region starts on 256 bytes
constexpr int SPLIT_COLS = 4096;   // CUDA-core weight gradient: columns a split, at least
constexpr int MAX_SPLIT = 32;      // and at most this many splits
constexpr int PLAN_MISMATCH = 1000;
constexpr int EC = 32;        // wgmma product epilogue: columns a staged chunk
constexpr int ELD = EC + 8;   // floats a staged row (conflict-free float2 stores)
constexpr int STAGE_BYTES = THREADS / 32 * 16 * ELD * 4;   // the eight warps' staging tiles

__device__ __forceinline__ float ldf(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}
// a gradient in the parameters' dtype
__device__ __forceinline__ void put(void* p, long i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
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

// An operand [B, rows, ld] as a pass reads it:
//   RAW    a tensor in x's dtype (x, dy; ld = T);
//   ACT    PReLU(gamma * (h - mean) * rstd + beta) of a float32 h (a1, a2, a3);
//   DNORM  rstd * (g * dyn - m1 - xhat * m2), the norm's input gradient from
//          dyn (the gradient after the PReLU) and h.
enum { RAW = 0, ACT = 1, DNORM = 2 };

struct Src {
  int mode;
  int rows, ld;   // rows a sample, elements a row
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
__device__ __forceinline__ float load_src(const Src& s, int b, int r, int t) {
  const long idx = ((long)b * s.rows + r) * s.ld + t;
  if (s.mode == RAW) return ldf(static_cast<const T*>(s.raw), idx);
  const float xhat = (s.h[idx] - s.mean[b]) * s.rstd[b];
  if (s.mode == ACT) return prelu(xhat * s.g[r] + s.beta[r], s.al[0]);
  return s.rstd[b] * (s.dyn[idx] * s.g[r] - s.m1[b] - xhat * s.m2[b]);
}

// a sample's scalars of a transform
struct Lvl {
  float mean, rstd, m1, m2, al;
};

__device__ __forceinline__ Lvl lvl_of(const Src& s, int b) {
  Lvl L{0.f, 0.f, 0.f, 0.f, 0.f};
  if (s.mode == RAW) return L;
  L.mean = s.mean[b];
  L.rstd = s.rstd[b];
  if (s.mode == ACT) {
    L.al = s.al[0];
  } else {
    L.m1 = s.m1[b];
    L.m2 = s.m2[b];
  }
  return L;
}

// 8 columns [t, t + 8) of row r of sample b (t % 8 == 0), in two steps so
// that a group's loads are all in flight before any of them is used:
// raw8 only loads (h, and dyn under DNORM; RAW: the bf16 bits, kept in
// float registers), xform8 normalises them, zero at t + e >= T. Float32
// scratch rows are 32-byte aligned (ld % 8 == 0); RAW bf16 rows of a length
// that is not a multiple of 8 are read one element at a time.
// DN: the operand is DNORM (h and dyn), else RAW or ACT (h, or the bits)
template <bool DN>
struct Raw8 {
  float h[8], d[DN ? 8 : 1];
};

template <bool DN>
__device__ __forceinline__ void raw8(const Src& s, int b, int r, int t, int T, Raw8<DN>& w) {
  if (t >= T) return;   // xform8 zeroes the columns
  const long idx = ((long)b * s.rows + r) * s.ld + t;
  if (!DN && s.mode == RAW) {
    const unsigned short* x = static_cast<const unsigned short*>(s.raw) + idx;
    if ((s.ld & 7) == 0) {
      const uint4 u = *reinterpret_cast<const uint4*>(x);
      w.h[0] = __uint_as_float(u.x);
      w.h[1] = __uint_as_float(u.y);
      w.h[2] = __uint_as_float(u.z);
      w.h[3] = __uint_as_float(u.w);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) w.h[e] = t + e < T ? __uint_as_float(x[e]) : 0.f;
    }
    return;
  }
  const float4 h0 = *reinterpret_cast<const float4*>(s.h + idx);
  const float4 h1 = *reinterpret_cast<const float4*>(s.h + idx + 4);
  w.h[0] = h0.x, w.h[1] = h0.y, w.h[2] = h0.z, w.h[3] = h0.w;
  w.h[4] = h1.x, w.h[5] = h1.y, w.h[6] = h1.z, w.h[7] = h1.w;
  if constexpr (DN) {
    const float4 d0 = *reinterpret_cast<const float4*>(s.dyn + idx);
    const float4 d1 = *reinterpret_cast<const float4*>(s.dyn + idx + 4);
    w.d[0] = d0.x, w.d[1] = d0.y, w.d[2] = d0.z, w.d[3] = d0.w;
    w.d[4] = d1.x, w.d[5] = d1.y, w.d[6] = d1.z, w.d[7] = d1.w;
  }
}

// gr / br: the row's gamma / beta
template <bool DN>
__device__ __forceinline__ void xform8(const Src& s, const Lvl& L, int t, int T, float gr,
                                       float br, const Raw8<DN>& w, float (&v)[8]) {
  if (!DN && s.mode == RAW) {
    if ((s.ld & 7) == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned u = __float_as_uint(w.h[q]);
        v[2 * q] = __uint_as_float(u << 16);
        v[2 * q + 1] = __uint_as_float(u & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(__float_as_uint(w.h[e]) << 16);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (w.h[e] - L.mean) * L.rstd;
      if constexpr (DN)
        v[e] = L.rstd * (w.d[e] * gr - L.m1 - xhat * L.m2);
      else
        v[e] = prelu(xhat * gr + br, L.al);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = t + e < T ? v[e] : 0.f;
}

__device__ __forceinline__ void sts_bf16x8(uint32_t a, const float (&v)[8]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(hopper::bf16x2(v[0], v[1])), "r"(hopper::bf16x2(v[2], v[3])),
               "r"(hopper::bf16x2(v[4], v[5])), "r"(hopper::bf16x2(v[6], v[7]))
               : "memory");
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

// ------------------------------------------------------ parameter prep
// Per call, in one launch: the parameters as float32 where they come in
// bfloat16, the transposed float32 weights of the CUDA-core backward, and
// the wgmma route's bf16 weight images (W or W^T [O][K], `hopper::swz`).
struct PrepJob {
  const void* src;
  void* dst;
  long begin;     // the job's first element in the launch's range
  int O, K;       // dst [O][K]
  int so, sk;     // src element (o, k) at o * so + k * sk
  int img;        // 1: a swizzled bf16 image, 0: float32 row-major
};
constexpr int MAX_JOBS = 28;

struct PrepParams {
  PrepJob job[MAX_JOBS];
  int n, src_bf16;
  long total;
};

__global__ void __launch_bounds__(THREADS) tcn_prep_kernel(PrepParams p) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < p.total;
       i += (long)gridDim.x * blockDim.x) {
    int j = 0;
    while (j + 1 < p.n && i >= p.job[j + 1].begin) ++j;
    const PrepJob& q = p.job[j];
    const long e = i - q.begin;
    const int o = (int)(e / q.K), k = (int)(e % q.K);
    const long s = (long)o * q.so + (long)k * q.sk;
    const float v = p.src_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q.src)[s])
                               : static_cast<const float*>(q.src)[s];
    if (q.img)
      static_cast<__nv_bfloat16*>(q.dst)[hopper::swz(o, k, q.O, q.K) / 2] = __float2bfloat16(v);
    else
      static_cast<float*>(q.dst)[e] = v;
  }
}

// ------------------------------------------------------- CUDA-core GEMM
// out[b, o, t] = sum_k W[o, k] * in[b, k, t] (+ bias[o]) (+ res[b, o, t]);
// with `part`, per-tile sums of the value before `res` (the norm statistics)
struct GemmParams {
  const float* w;     // [O, K]
  Src in;             // [B, K, T]
  const float* bias;  // [O] or null
  const void* res;    // [B, O, T] in x's dtype, or null
  void* out;          // [B, O, Tp] float32 scratch, or [B, O, T] in x's dtype when typed_out
  float* part;        // [B, P, 2] or null, P = the tiles of one sample
  int O, K, T, Tp, typed_out;
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
      x_s[kx][tt] = (kg < K && t < Tn) ? rnd<T>(load_src<T>(p.in, b, kg, t)) : 0.f;
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
      float v = acc[i][j] + bo;
      sums[0] += v;
      sums[1] += v * v;
      if (p.typed_out) {
        const long idx = ((long)b * O + o) * Tn + t;
        if (p.res != nullptr) v += ldf(static_cast<const T*>(p.res), idx);
        stf(static_cast<T*>(p.out), idx, v);
      } else {
        static_cast<float*>(p.out)[((long)b * O + o) * p.Tp + t] = v;
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

// --------------------------------------------- CUDA-core weight gradient
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
  const int R = p.B * Tn;  // the plan keeps B * T below 2^31
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
        if (o < O) dv = load_src<T>(p.d, b, o, t);
        if (k < K) av = load_src<T>(p.a, b, k, t);
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

// --------------------------------------------------- wgmma 1x1 product
// out[b, o, t] = sum_k W[o, k] * in[b, k, t] over bf16 operands, W resident
enum { STORE_H = 0, TYPED = 1, PVJP = 2 };

struct WgGemmParams {
  const __nv_bfloat16* img;  // W [O][K], tcn_prep_kernel's image
  Src in;                    // [B, K, T]: RAW (bf16), ACT or DNORM
  const float* bias;         // [O] or null
  const __nv_bfloat16* res;  // TYPED: [B, O, T] residual or null
  void* out;                 // STORE_H, PVJP: float32 [B, O, Tp]; TYPED: bf16 [B, O, T]
  float* part;               // STORE_H: [B, P, 2] (s, s^2); PVJP: [B, P, O, 3] row sums
  Src lvl;                   // PVJP: h of the outputs' level with its stats, gamma, beta, alpha
  int mode, O, T, Tp, B, P;  // P = column tiles a sample
};

// The column tile (b, t0) of `in`, normalised and rounded, goes into the
// MN-major [K][NC] tile (`hopper::swz(k, n, K, NC)`, the layout of
// `hopper::desc_mn`) in U units a thread, G at a time: unit (row k, 8
// columns), loaded as 32-byte vectors (NC / 8 threads cover a row's tile:
// coalesced), stored as one 16-byte vector (8 threads fill one 128-byte row
// of a swizzle atom: no bank conflicts). gemm_load issues a group's loads,
// gemm_store normalises and stores them.
template <int NC, int K>
struct GemmStage {
  static constexpr int CG = NC / 8, U = K * CG / THREADS;
  __device__ static int row(int unit) { return threadIdx.x / CG + unit * (THREADS / CG); }
};

template <int NC, int K, int G, bool DN>
__device__ __forceinline__ void gemm_load(const WgGemmParams& p, int b, int t0, int group,
                                          Raw8<DN> (&w)[G]) {
  using S = GemmStage<NC, K>;
  const int t = t0 + 8 * (threadIdx.x % S::CG);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) raw8(p.in, b, S::row(group * G + gi), t, p.T, w[gi]);
}

template <int NC, int K, int G, bool DN>
__device__ __forceinline__ void gemm_store(const WgGemmParams& p, int b, int t0, int group,
                                           const Raw8<DN> (&w)[G], uint32_t tile) {
  using S = GemmStage<NC, K>;
  const Src& s = p.in;
  const Lvl L = lvl_of(s, b);
  const int cg = threadIdx.x % S::CG, t = t0 + 8 * cg;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int k = S::row(group * G + gi);
    const float gk = s.mode != RAW ? s.g[k] : 0.f, bk = s.mode == ACT ? s.beta[k] : 0.f;
    float v[8];
    xform8(s, L, t, p.T, gk, bk, w[gi], v);
    sts_bf16x8(tile + hopper::swz(k, 8 * cg, K, NC), v);
  }
}

// MBW: m-blocks (64 output rows) a warpgroup, 2 where O = 256; DN: the
// operand is DNORM (h and dyn: load groups of 2 units, else 8)
template <int NC, int K, int MBW, bool DN>
__device__ __forceinline__ void wg_gemm_body(const WgGemmParams& p, unsigned char* wg_smem) {
  constexpr int U = GemmStage<NC, K>::U, GM = DN ? 2 : 8, G = U < GM ? U : GM;
  constexpr int NG = U / G;   // load groups a tile
  __shared__ __align__(8) unsigned long long bar;
  const uint32_t raw = hopper::smem_addr(wg_smem);
  const uint32_t Wt = raw + ((1024 - (raw & 1023)) & 1023);   // swizzled tiles: 1,024-aligned
  const int O = p.O;
  const uint32_t wbytes = (uint32_t)O * K * 2, tbytes = NC * K * 2;
  const uint32_t Bt0 = Wt + wbytes;
  const int tid = threadIdx.x, wg = tid / 128, w = tid % 128 / 32, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = p.B * p.P, ctas = gridDim.x, cta = blockIdx.x;
  const int mine = cta < ntiles ? (ntiles - 1 - cta) / ctas + 1 : 0;
  const uint32_t bar_a = hopper::smem_addr(&bar);
  if (tid == 0) {
    hopper::mbar_init(bar_a, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && mine > 0) {   // the weights once: the bulk copy engine
    hopper::mbar_expect_tx(bar_a, wbytes);
    for (uint32_t off = 0; off < wbytes; off += 32768)
      hopper::bulk_load(Wt + off, reinterpret_cast<const char*>(p.img) + off,
                        wbytes - off < 32768 ? wbytes - off : 32768, bar_a);
  }
  if (mine > 0)
#pragma unroll 1
    for (int q = 0; q < NG; ++q) {
      Raw8<DN> ld[G];
      gemm_load<NC, K>(p, cta / p.P, (cta % p.P) * NC, q, ld);
      gemm_store<NC, K>(p, cta / p.P, (cta % p.P) * NC, q, ld, Bt0);
    }
  float acc[MBW][NC / 2];
  const Lvl L3 = {0.f, 0.f, 0.f, 0.f, p.mode == PVJP ? p.lvl.al[0] : 0.f};
  // this warp's epilogue staging tile [16][ELD] after the two column tiles
  float* stg = reinterpret_cast<float*>(wg_smem + (Bt0 + 2 * tbytes - raw)) + (tid / 32) * 16 * ELD;
  for (int i = 0; i < mine; ++i) {
    const int tile = cta + i * ctas, b = tile / p.P, tt = tile % p.P, t0 = tt * NC;
    hopper::fence_async_smem();   // this tile's stores visible to wgmma
    __syncthreads();              // ... and every warpgroup done with the other buffer
    if (i == 0) hopper::mbar_wait(bar_a, 0);
    const uint32_t Bt = Bt0 + (i & 1) * tbytes;
#pragma unroll
    for (int mb = 0; mb < MBW; ++mb) hopper::pin(acc[mb]);
    hopper::wg_fence();
#pragma unroll
    for (int mb = 0; mb < MBW; ++mb)
      if (64 * (wg + 2 * mb) < O) {
#pragma unroll
        for (int ks = 0; ks < K / 16; ++ks)
          hopper::wgmma_tb<NC>(acc[mb], hopper::desc_tile(Wt, 64 * (wg + 2 * mb), ks, O, K),
                               hopper::desc_mn(Bt, 0, ks, K), ks > 0);
      }
    hopper::wg_commit();
    // the next tile's first load group is in flight under this tile's
    // products and epilogue; it and the other groups are normalised after
    const bool more = i + 1 < mine;
    const int nt = tile + ctas, nb = nt / p.P, nt0 = (nt % p.P) * NC;
    const uint32_t nbuf = Bt0 + ((i + 1) & 1) * tbytes;
    Raw8<DN> ld0[G];
    if (more) gemm_load<NC, K>(p, nb, nt0, 0, ld0);
    hopper::wg_wait0();
#pragma unroll
    for (int mb = 0; mb < MBW; ++mb) hopper::pin(acc[mb]);

    // ---- epilogue. A warp's accumulator rows (16 w + g, + 8; columns 8 j +
    // 2 tq, + 1) go through its staging tile, 32 columns at a time, so that
    // each lane then takes 4 consecutive columns of a row: 8 lanes a row's
    // 128 bytes, 16-byte loads and stores (h, dyn, the float32 outputs).
    float sums[2] = {0.f, 0.f};
    const float mean = p.mode == PVJP ? p.lvl.mean[b] : 0.f;
    const float rstd = p.mode == PVJP ? p.lvl.rstd[b] : 0.f;
    const int cq = 4 * (lane % 8);   // this lane's columns in a chunk
#pragma unroll
    for (int mb = 0; mb < MBW; ++mb) {
      if (64 * (wg + 2 * mb) >= O) continue;
      const int R = 64 * (wg + 2 * mb) + 16 * w;   // the warp's first row
      float rs[4][3];
      float bo[4], gy[4], by[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = R + lane / 8 + 4 * q;
        rs[q][0] = rs[q][1] = rs[q][2] = 0.f;
        bo[q] = p.bias != nullptr ? p.bias[o] : 0.f;
        gy[q] = p.mode == PVJP ? p.lvl.g[o] : 0.f;
        by[q] = p.mode == PVJP ? p.lvl.beta[o] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NC / EC; ++c) {
#pragma unroll
        for (int jj = 0; jj < EC / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(stg + (g + 8 * h) * ELD + 8 * jj + 2 * tq) =
                make_float2(acc[mb][4 * (c * EC / 8 + jj) + 2 * h],
                            acc[mb][4 * (c * EC / 8 + jj) + 2 * h + 1]);
        __syncwarp();
        const int t = t0 + c * EC + cq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = lane / 8 + 4 * q, o = R + r;
          const float4 a4 = *reinterpret_cast<const float4*>(stg + r * ELD + cq);
          float v[4] = {a4.x + bo[q], a4.y + bo[q], a4.z + bo[q], a4.w + bo[q]};
          if (t >= p.T) continue;
          const long rowp = ((long)b * O + o) * p.Tp, rowt = ((long)b * O + o) * p.T;
          if (p.mode == STORE_H) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (t + e < p.T) {
                sums[0] += v[e];
                sums[1] += v[e] * v[e];
              }
            *reinterpret_cast<float4*>(static_cast<float*>(p.out) + rowp + t) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else if (p.mode == TYPED) {
            __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.out) + rowt + t;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (t + e < p.T)
                y[e] = __float2bfloat16(
                    p.res != nullptr ? v[e] + __bfloat162float(p.res[rowt + t + e]) : v[e]);
          } else {   // PVJP: da = v -> dyn, the row sums of the norm VJP
            const float4 h4 = *reinterpret_cast<const float4*>(p.lvl.h + rowp + t);
            const float hs[4] = {h4.x, h4.y, h4.z, h4.w};
            float dyn[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float xhat = (hs[e] - mean) * rstd;
              const float y = xhat * gy[q] + by[q];
              dyn[e] = v[e] * (y >= 0.f ? 1.f : L3.al);
              if (t + e < p.T) {
                rs[q][0] += dyn[e] * xhat;
                rs[q][1] += dyn[e];
                rs[q][2] += v[e] * (y < 0.f ? y : 0.f);
              }
            }
            *reinterpret_cast<float4*>(static_cast<float*>(p.out) + rowp + t) =
                make_float4(dyn[0], dyn[1], dyn[2], dyn[3]);
          }
        }
        __syncwarp();
      }
      if (p.mode == PVJP) {   // the 8 lanes of a row, in a fixed order
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int k3 = 0; k3 < 3; ++k3) {
            rs[q][k3] += __shfl_xor_sync(0xffffffffu, rs[q][k3], 1);
            rs[q][k3] += __shfl_xor_sync(0xffffffffu, rs[q][k3], 2);
            rs[q][k3] += __shfl_xor_sync(0xffffffffu, rs[q][k3], 4);
          }
          if (lane % 8 == 0) {
            float* dst = p.part + (((long)b * p.P + tt) * O + R + lane / 8 + 4 * q) * 3;
            dst[0] = rs[q][0];
            dst[1] = rs[q][1];
            dst[2] = rs[q][2];
          }
        }
      }
    }
    if (p.mode == STORE_H) {
      block_sum<2>(sums);
      if (tid == 0) {
        p.part[((long)b * p.P + tt) * 2] = sums[0];
        p.part[((long)b * p.P + tt) * 2 + 1] = sums[1];
      }
    }
    if (more) {
      gemm_store<NC, K>(p, nb, nt0, 0, ld0, nbuf);
#pragma unroll 1
      for (int q = 1; q < NG; ++q) {
        Raw8<DN> ld[G];
        gemm_load<NC, K>(p, nb, nt0, q, ld);
        gemm_store<NC, K>(p, nb, nt0, q, ld, nbuf);
      }
    }
  }
}

template <int NC, int K, int MBW>
__global__ void __launch_bounds__(THREADS, 1) tcn_wg_gemm(WgGemmParams p) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  if (p.in.mode == DNORM)
    wg_gemm_body<NC, K, MBW, true>(p, wg_smem);
  else
    wg_gemm_body<NC, K, MBW, false>(p, wg_smem);
}

// ------------------------------------------ wgmma weight gradient
// dW[o, k] = sum over the columns of d[b, o, t] * a[b, k, t], per fixed range
// z of 64-column chunks (chunk c: sample c / TC, columns 64 (c % TC) + [0, 64)),
// O-block ob of OB rows; dbias[o] = the same sum of the unrounded d
struct WgWgradParams {
  Src d;          // [B, O, T]: RAW (bf16) or DNORM
  Src a;          // [B, K, T]: RAW (bf16) or ACT
  float* w_part;  // [n_split, O, K]
  float* b_part;  // [n_split, O] or null
  int O, T, TC, NCH, cps, n_ob;
};

template <int K>
struct WgShape {
  static constexpr int NB = K / 64, MB = NB >= 4 ? 1 : 2, OB = 128 * MB;
  static constexpr uint32_t DBYTES = OB * 128, BUF = DBYTES + K * 128;
};

// rows [0, OB) of d from o0 and [0, K) of a, chunk (b, t0), into the two
// K-major [rows][64] tiles of `buf`: a thread takes 8 columns of a row (a
// 32-byte load, a 16-byte store), 8 threads a row; 4 rows' loads in flight
// together (2 where d is DNORM: DN, h and dyn); bsum gathers the thread's d
// rows' unrounded sums
template <int K, bool DN>
__device__ __forceinline__ void wg_wgrad_stage(const WgWgradParams& p, int o0, int b, int t0,
                                               uint32_t buf, float (&bsum)[WgShape<K>::OB / 32]) {
  using S = WgShape<K>;
  constexpr int ND = S::OB / 32, NA = K / 32, GD = DN ? 2 : 4, GA = NA < 4 ? NA : 4;
  const int cg = threadIdx.x % 8, t = t0 + 8 * cg;
  const Lvl Ld = lvl_of(p.d, b), La = lvl_of(p.a, b);
#pragma unroll
  for (int i0 = 0; i0 < ND; i0 += GD) {
    Raw8<DN> ld[GD];
#pragma unroll
    for (int gi = 0; gi < GD; ++gi) {
      const int o = o0 + threadIdx.x / 8 + 32 * (i0 + gi);
      raw8(p.d, b, o, t, o < p.O ? p.T : 0, ld[gi]);
    }
#pragma unroll
    for (int gi = 0; gi < GD; ++gi) {
      const int r = threadIdx.x / 8 + 32 * (i0 + gi);
      float v[8];
      const float gd = DN && o0 + r < p.O ? p.d.g[o0 + r] : 0.f;
      xform8(p.d, Ld, t, o0 + r < p.O ? p.T : 0, gd, 0.f, ld[gi], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) bsum[i0 + gi] += v[e];
      sts_bf16x8(buf + hopper::swz(r, 8 * cg, S::OB, 64), v);
    }
  }
  const uint32_t at = buf + S::DBYTES;
#pragma unroll
  for (int i0 = 0; i0 < NA; i0 += GA) {
    Raw8<false> ld[GA];
#pragma unroll
    for (int gi = 0; gi < GA; ++gi) raw8(p.a, b, threadIdx.x / 8 + 32 * (i0 + gi), t, p.T, ld[gi]);
#pragma unroll
    for (int gi = 0; gi < GA; ++gi) {
      const int r = threadIdx.x / 8 + 32 * (i0 + gi);
      float v[8];
      const bool act = p.a.mode == ACT;
      xform8(p.a, La, t, p.T, act ? p.a.g[r] : 0.f, act ? p.a.beta[r] : 0.f, ld[gi], v);
      sts_bf16x8(at + hopper::swz(r, 8 * cg, K, 64), v);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1) tcn_wg_wgrad(WgWgradParams p) {
  using S = WgShape<K>;
  constexpr int MB = S::MB, NB = S::NB, OB = S::OB, ND = OB / 32;
  extern __shared__ __align__(16) unsigned char wr_smem[];
  const uint32_t raw = hopper::smem_addr(wr_smem);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, w = tid % 128 / 32, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int z = blockIdx.x / p.n_ob, ob = blockIdx.x % p.n_ob, o0 = ob * OB;
  const int c0 = z * p.cps, n = min(p.NCH, c0 + p.cps) - c0;
  float bsum[ND];   // this thread's d rows' unrounded sums (the bias gradient)
#pragma unroll
  for (int i = 0; i < ND; ++i) bsum[i] = 0.f;
  float acc[MB][NB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mb][nb][e] = 0.f;
  auto stage = [&](int c, uint32_t buf) {
    if (p.d.mode == DNORM)
      wg_wgrad_stage<K, true>(p, o0, c / p.TC, (c % p.TC) * WG_COLS, buf, bsum);
    else
      wg_wgrad_stage<K, false>(p, o0, c / p.TC, (c % p.TC) * WG_COLS, buf, bsum);
  };
  if (n > 0) stage(c0, base);
  for (int i = 0; i < n; ++i) {
    const uint32_t buf = base + (i & 1) * S::BUF;
    hopper::fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::pin(acc[mb][nb]);
    hopper::wg_fence();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int r0 = 64 * (wg * MB + mb);
      if (o0 + r0 >= p.O) continue;
#pragma unroll
      for (int ks = 0; ks < WG_COLS / 16; ++ks)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::wgmma_m64n64(acc[mb][nb], hopper::desc_tile(buf, r0, ks, OB, 64),
                               hopper::desc_tile(buf + S::DBYTES, 64 * nb, ks, K, 64), 1);
    }
    hopper::wg_commit();
    if (i + 1 < n) stage(c0 + i + 1, base + ((i + 1) & 1) * S::BUF);
    hopper::wg_wait0();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::pin(acc[mb][nb]);
  }
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int r0 = 64 * (wg * MB + mb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + r0 + 16 * w + g + 8 * h;
      if (o >= p.O) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(p.w_part + ((long)z * p.O + o) * K + 64 * nb + 8 * j +
                                     2 * tq) =
              make_float2(acc[mb][nb][4 * j + 2 * h], acc[mb][nb][4 * j + 2 * h + 1]);
    }
  }
  if (p.b_part != nullptr) {   // the 8 threads of a row, in a fixed order
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      float s = bsum[i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      const int o = o0 + tid / 8 + 32 * i;
      if (tid % 8 == 0 && o < p.O) p.b_part[(long)z * p.O + o] = s;
    }
  }
}

// sums the column-range partials in a fixed order, into the gradient's dtype
__global__ void tcn_wgrad_reduce(const float* w_part, const float* b_part, void* dw, void* db,
                                 int O, int K, int n_split, int g_bf16) {
  const long OK = (long)O * K;
  const long total = OK + (b_part != nullptr ? O : 0);
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (idx < OK) {
      for (int z = 0; z < n_split; ++z) s += w_part[z * OK + idx];
      put(dw, idx, s, g_bf16);
    } else {
      const long o = idx - OK;
      for (int z = 0; z < n_split; ++z) s += b_part[(long)z * O + o];
      put(db, o, s, g_bf16);
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
  float* h2;          // [B, Ch, Tp]
  float* part;        // [B, Ch, 2]
  int Ch, T, Tp, kw, dil, pad;
};

// one block per (c, b) row: h2 = sum_j w[j] * a1(t + j*d - pad) + b_dw, the
// row in segments of DW_SEG columns, each staged with its halo, normalised
// once, in shared memory; 4 columns a thread, 16-byte stores
__global__ void __launch_bounds__(THREADS) tcn_dw_fwd_kernel(DwParams p) {
  extern __shared__ float st[];   // DW_SEG + 2 pad
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T;
  const long row = ((long)b * p.Ch + c) * p.Tp;
  float w[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) w[j] = j < p.kw ? p.w_dw[c * p.kw + j] : 0.f;
  const float bdw = p.b_dw[c];
  const float mean = p.a1.mean[b], rstd = p.a1.rstd[b];
  const float g = p.a1.g[c], be = p.a1.beta[c], al = p.a1.al[0];
  float sums[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < Tn; t0 += DW_SEG) {
    const int len = min(DW_SEG, Tn - t0), n = len + 2 * p.pad;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int ts = t0 - p.pad + i;
      st[i] = (ts >= 0 && ts < Tn) ? prelu((p.a1.h[row + ts] - mean) * rstd * g + be, al) : 0.f;
    }
    __syncthreads();
    for (int q = 4 * threadIdx.x; q < len; q += 4 * THREADS) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.f;
        if (q + e >= len) continue;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < MAXK; ++j)
          if (j < p.kw) {
            const float a = st[q + e + j * p.dil];
            acc = j == 0 ? w[j] * a : acc + w[j] * a;
          }
        v[e] = acc + bdw;
        sums[0] += v[e];
        sums[1] += v[e] * v[e];
      }
      *reinterpret_cast<float4*>(p.h2 + row + t0 + q) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  }
  block_sum<2>(sums);
  if (threadIdx.x == 0) {
    p.part[((long)b * p.Ch + c) * 2] = sums[0];
    p.part[((long)b * p.Ch + c) * 2 + 1] = sums[1];
  }
}

// ---------------------------------------------------- norm / PReLU VJPs
// the CUDA-core route's row pass (the wgmma route folds it into the product)
struct NormRowParams {
  float* g_io;  // [B, Ch, Tp]: da in, dyn = da * PReLU'(y) out
  Src y;        // h with its stats, gamma, beta (y = gamma * xhat + beta), alpha
  float* rows;  // [B, Ch, 3]: sum dyn*xhat, sum dyn, sum da*min(y, 0)
  int Ch, T, Tp;
};

__global__ void __launch_bounds__(THREADS) tcn_norm_rows_kernel(NormRowParams p) {
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T;
  const long row = ((long)b * p.Ch + c) * p.Tp;
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
// one block per (c, b) row, segments staged as in the forward (dh2 and a1
// with their halos, xhat1 at the segment's own columns)
struct DwBwdParams {
  Src dh2;            // DNORM of (dyn2, h2)
  Src a1;             // ACT of h1 (the taps' input)
  const float* w_dw;  // [Ch, k]
  float* dyn1;        // [B, Ch, Tp] out
  float* rows;        // [B, Ch, 3] as tcn_norm_rows_kernel's, for level 1
  float* dw_rows;     // [B, Ch, 1 + k]: sum dh2, sum dh2 * a1(t + s_j)
  int Ch, T, Tp, kw, dil, pad;
};

__global__ void __launch_bounds__(THREADS) tcn_dw_bwd_kernel(DwBwdParams p) {
  extern __shared__ float sb[];   // ds, as: DW_SEG + 2 pad each; xs: DW_SEG
  const int c = blockIdx.x, b = blockIdx.y, Tn = p.T, pad = p.pad;
  const int span = DW_SEG + 2 * pad;
  float* ds = sb;
  float* as = sb + span;
  float* xs = sb + 2 * span;
  const long row = ((long)b * p.Ch + c) * p.Tp;
  float w[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) w[j] = j < p.kw ? p.w_dw[c * p.kw + j] : 0.f;
  const float mean = p.a1.mean[b], rstd = p.a1.rstd[b];
  const float g = p.a1.g[c], be = p.a1.beta[c], al = p.a1.al[0];
  const float mean2 = p.dh2.mean[b], rstd2 = p.dh2.rstd[b], g2 = p.dh2.g[c];
  const float m1 = p.dh2.m1[b], m2 = p.dh2.m2[b];
  float s[3] = {0.f, 0.f, 0.f};
  float sw[1 + MAXK];
#pragma unroll
  for (int j = 0; j <= MAXK; ++j) sw[j] = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += DW_SEG) {
    const int len = min(DW_SEG, Tn - t0), n = len + 2 * pad;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int ts = t0 - pad + i;
      float d = 0.f, a = 0.f;
      if (ts >= 0 && ts < Tn) {
        const float xh2 = (p.dh2.h[row + ts] - mean2) * rstd2;
        d = rstd2 * (p.dh2.dyn[row + ts] * g2 - m1 - xh2 * m2);
        const float xh = (p.a1.h[row + ts] - mean) * rstd;
        a = prelu(xh * g + be, al);
        if (i >= pad && i < pad + len) xs[i - pad] = xh;
      }
      ds[i] = d;
      as[i] = a;
    }
    __syncthreads();
    for (int q = 4 * threadIdx.x; q < len; q += 4 * THREADS) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[e] = 0.f;
        if (q + e >= len) continue;
        const float d = ds[pad + q + e];
        sw[0] += d;
        float da = 0.f;
#pragma unroll
        for (int j = 0; j < MAXK; ++j)
          if (j < p.kw) {
            const int s_j = j * p.dil - pad;
            sw[1 + j] += d * as[pad + q + e + s_j];
            const float dd = ds[pad + q + e - s_j];
            da = j == 0 ? w[j] * dd : da + w[j] * dd;
          }
        const float xhat = xs[q + e];
        const float y = xhat * g + be;
        const float dyn = da * (y >= 0.f ? 1.f : al);
        out[e] = dyn;
        s[0] += dyn * xhat;
        s[1] += dyn;
        s[2] += da * (y < 0.f ? y : 0.f);
      }
      *reinterpret_cast<float4*>(p.dyn1 + row + t0 + q) = make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();
  }
  block_sum<3>(s);
  block_sum<1 + MAXK>(sw);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 3; ++q) p.rows[((long)b * p.Ch + c) * 3 + q] = s[q];
#pragma unroll
    for (int q = 0; q <= MAXK; ++q)
      if (q <= p.kw) p.dw_rows[((long)b * p.Ch + c) * (1 + p.kw) + q] = sw[q];
  }
}

// rows[b, c, q] = sum over the P column tiles of part[b, p, c, q] (the wgmma
// route's per-tile row sums), in tile order
__global__ void tcn_rows_sum(const float* part, int B, int P, int Ch, float* rows) {
  const long n = (long)B * Ch * 3;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long b = i / (Ch * 3), cq = i % (Ch * 3);
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += part[((long)b * P + q) * Ch * 3 + cq];
    rows[i] = s;
  }
}

// blocks 0..B-1: per sample m1 = sum_c g[c] * rows[b, c, 1] / count and
// m2 = sum_c g[c] * rows[b, c, 0] / count; block B: dgamma[c], dbeta[c]
// (sums over b) and dalpha (the sum over b and c), in the gradients' dtype
__global__ void __launch_bounds__(THREADS) tcn_norm_reduce(const float* rows, const float* g,
                                                           int B, int Ch, float count,
                                                           float* m1, float* m2, void* dgamma,
                                                           void* dbeta, void* dalpha,
                                                           int g_bf16) {
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
    put(dgamma, c, sg, g_bf16);
    put(dbeta, c, sb, g_bf16);
    sa[0] += salpha;
  }
  block_sum<1>(sa);
  if (threadIdx.x == 0) put(dalpha, 0, sa[0], g_bf16);
}

// db_dw[c] and dW_dw[c, j]: the depthwise row sums over b
__global__ void tcn_dw_param_reduce(const float* dw_rows, int B, int Ch, int kw, void* db_dw,
                                    void* dw_dw, int g_bf16) {
  const int n = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (n >= Ch * (1 + kw)) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += dw_rows[(long)b * Ch * (1 + kw) + n];
  const int c = n / (1 + kw), q = n % (1 + kw);
  if (q == 0)
    put(db_dw, c, s, g_bf16);
  else
    put(dw_dw, c * kw + q - 1, s, g_bf16);
}

// ------------------------------------------------------------------ plan
// Parameter pointers, in tcn_block_train's order:
enum {
  W_IN, G1, B1, AL1, W_DW, B_DW, G2, B2, AL2, W_PW, B_PW, G3, B3, AL3, W_OUT, B_OUT, N_PARAMS
};
// the six 1x1 products (forward: in, pw, out; backward: out^T, pw^T, in^T)
// and the three weight gradients (out, pw, in)
enum { G_IN, G_PW, G_OUT, G_OUT_T, G_PW_T, G_IN_T, N_GEMMS };
enum { D_OUT, D_PW, D_IN, N_WGRADS };

struct Dims {
  int B, C, Ch, T, kw, dil, Tp;
};

// The plan's fields, in the order of ops/tcn_train_kernel.py `TcnPlan.ints`:
//   route (0 CUDA cores, 1 wgmma), Tp, the six products' (columns a tile,
//   shared bytes), the three weight gradients' (splits, chunks or columns a
//   split, O-blocks, shared bytes), the depthwise passes' shared bytes
//   (forward, backward)
enum {
  PL_ROUTE, PL_TP, PL_GEMM, PL_WGRAD = PL_GEMM + 2 * N_GEMMS, PL_DW = PL_WGRAD + 4 * N_WGRADS,
  PLAN_FIELDS = PL_DW + 2
};

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }
inline long al(long n) { return (n + ALIGN_F - 1) / ALIGN_F * ALIGN_F; }
inline bool tile_width(int c) { return c == 64 || c == 128 || c == 256; }

inline void gemm_ok(const Dims& d, int i, int& O, int& K) {
  const int OK[N_GEMMS][2] = {{d.Ch, d.C}, {d.Ch, d.Ch}, {d.C, d.Ch},
                              {d.Ch, d.C}, {d.Ch, d.Ch}, {d.C, d.Ch}};
  O = OK[i][0];
  K = OK[i][1];
}
inline void wgrad_ok(const Dims& d, int i, int& O, int& K) {
  const int OK[N_WGRADS][2] = {{d.C, d.Ch}, {d.Ch, d.Ch}, {d.Ch, d.C}};
  O = OK[i][0];
  K = OK[i][1];
}

// false where no route takes the shape
bool make_plan(const Dims& d, int bf16, int (&pl)[PLAN_FIELDS]) {
  if (d.kw > MAXK || d.kw % 2 == 0 || d.B <= 0 || d.C <= 0 || d.Ch <= 0 || d.T <= 0 ||
      d.dil <= 0 || (long)d.B * d.T >= (1L << 31))
    return false;
  const int wg = bf16 && tile_width(d.C) && tile_width(d.Ch);
  pl[PL_ROUTE] = wg;
  pl[PL_TP] = cdiv(d.T, 8) * 8;
  for (int i = 0; i < N_GEMMS; ++i) {
    int O, K;
    gemm_ok(d, i, O, K);
    int nc = TILE, smem = 0;
    if (wg) {
      for (nc = O > 128 ? 64 : 128; nc >= 64; nc /= 2) {
        smem = 1024 + 2 * O * K + 2 * 2 * nc * K + STAGE_BYTES;
        if (smem <= SMEM_MAX) break;
      }
      if (smem > SMEM_MAX) return false;
    }
    pl[PL_GEMM + 2 * i] = nc;
    pl[PL_GEMM + 2 * i + 1] = smem;
  }
  for (int i = 0; i < N_WGRADS; ++i) {
    int O, K;
    wgrad_ok(d, i, O, K);
    int n, per, nob = 1, smem = 0;
    if (wg) {
      const int MB = K / 64 >= 4 ? 1 : 2, OB = 128 * MB;
      nob = cdiv(O, OB);
      const long nch = (long)d.B * cdiv(d.T, WG_COLS);
      n = (int)(H100_SMS / nob < nch ? H100_SMS / nob : nch);
      if (n < 1) n = 1;
      per = cdiv(nch, n);
      n = cdiv(nch, per);
      smem = 1024 + 2 * (OB + K) * 128;
    } else {
      const long R = (long)d.B * d.T;
      n = cdiv(R, SPLIT_COLS);
      n = n < 1 ? 1 : n > MAX_SPLIT ? MAX_SPLIT : n;
      per = cdiv(cdiv(R, n), RB) * RB;
      n = cdiv(R, per);
    }
    pl[PL_WGRAD + 4 * i] = n;
    pl[PL_WGRAD + 4 * i + 1] = per;
    pl[PL_WGRAD + 4 * i + 2] = nob;
    pl[PL_WGRAD + 4 * i + 3] = smem;
  }
  const long pad = (long)((d.kw - 1) / 2) * d.dil;
  const long fsm = 4 * (DW_SEG + 2 * pad), bsm = 4 * (2 * (DW_SEG + 2 * pad) + DW_SEG);
  if (bsm > SMEM_MAX) return false;
  pl[PL_DW] = (int)fsm;
  pl[PL_DW + 1] = (int)bsm;
  return true;
}

// ---------------------------------------------------------------- scratch
// float32 regions, each al()-aligned, in this order (ops/tcn_train_kernel.py
// `_scratch_floats` computes the same sum)
struct Scratch {
  float *h1, *h2, *h3, *s, *s2;  // [B, Ch, Tp] each; s / s2 in the backward only
  float* part;                   // [B, Pst, 2] statistics partials
  float* stats;                  // mean1, rstd1, mean2, rstd2, mean3, rstd3: [B] each
  float* m;                      // m1/m2 of levels 1, 2, 3: [B] each
  float* rows;                   // [B, Ch, 3]
  float* rows_part;              // wgmma: [B, Pr, Ch, 3]
  float* dw_rows;                // [B, Ch, 1 + k]
  float* w_part;                 // [splits, O * K], the largest of the three
  float* b_part;                 // [splits, O]
  float* p32[N_PARAMS];          // float32 copies of bf16 parameters
  float* wt32[3];                // CUDA-core backward: W_in^T, W_pw^T, W_out^T
  __nv_bfloat16* img[N_GEMMS];   // wgmma: the products' weight images
};

long param_size(const Dims& d, int i) {
  switch (i) {
    case W_IN: return (long)d.Ch * d.C;
    case W_DW: return (long)d.Ch * d.kw;
    case W_PW: return (long)d.Ch * d.Ch;
    case W_OUT: return (long)d.C * d.Ch;
    case B_OUT: return d.C;
    case AL1: case AL2: case AL3: return 1;
    default: return d.Ch;
  }
}

// carves `base` (nullptr: only counts) and returns the floats used
long carve(float* base, const Dims& d, const int (&pl)[PLAN_FIELDS], int backward, Scratch& s) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base != nullptr ? base + off : nullptr;
    off += al(n);
    return p;
  };
  const int wg = pl[PL_ROUTE];
  const long N = (long)d.B * d.Ch * d.Tp;
  s = Scratch{};
  s.h1 = take(N);
  s.h2 = take(N);
  s.h3 = take(N);
  if (backward) {
    s.s = take(N);
    s.s2 = take(N);
  }
  long pst = d.Ch;
  if (wg) {
    pst = pst > cdiv(d.T, pl[PL_GEMM + 2 * G_IN]) ? pst : cdiv(d.T, pl[PL_GEMM + 2 * G_IN]);
    pst = pst > cdiv(d.T, pl[PL_GEMM + 2 * G_PW]) ? pst : cdiv(d.T, pl[PL_GEMM + 2 * G_PW]);
  } else {
    const long pg = (long)cdiv(d.T, TILE) * cdiv(d.Ch, TILE);
    pst = pst > pg ? pst : pg;
  }
  s.part = take((long)d.B * pst * 2);
  s.stats = take(6L * d.B);
  for (int i = 0; i < N_PARAMS; ++i) s.p32[i] = take(param_size(d, i));
  if (backward) {
    s.m = take(6L * d.B);
    s.rows = take((long)d.B * d.Ch * 3);
    if (wg) {
      const int p1 = cdiv(d.T, pl[PL_GEMM + 2 * G_OUT_T]), p2 = cdiv(d.T, pl[PL_GEMM + 2 * G_PW_T]);
      s.rows_part = take((long)d.B * (p1 > p2 ? p1 : p2) * d.Ch * 3);
    }
    s.dw_rows = take((long)d.B * d.Ch * (1 + d.kw));
    long wk = 0, bo = 0;
    for (int i = 0; i < N_WGRADS; ++i) {
      int O, K;
      wgrad_ok(d, i, O, K);
      const long n = pl[PL_WGRAD + 4 * i];
      wk = wk > n * O * K ? wk : n * O * K;
      bo = bo > n * O ? bo : n * O;
    }
    s.w_part = take(wk);
    s.b_part = take(bo);
    if (!wg) {
      s.wt32[0] = take((long)d.C * d.Ch);
      s.wt32[1] = take((long)d.Ch * d.Ch);
      s.wt32[2] = take((long)d.Ch * d.C);
    }
  }
  if (wg)
    for (int i = 0; i < (backward ? N_GEMMS : 3); ++i) {
      int O, K;
      gemm_ok(d, i, O, K);
      s.img[i] = reinterpret_cast<__nv_bfloat16*>(take((long)O * K / 2));
    }
  return off;
}

#define TRY(expr)                              \
  do {                                         \
    const cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

Src raw(const void* p, int rows, int ld) {
  Src s{};
  s.mode = RAW;
  s.rows = rows;
  s.ld = ld;
  s.raw = p;
  return s;
}

Src act(const float* h, int rows, int ld, const float* mean, const float* rstd, const float* g,
        const float* beta, const float* al) {
  Src s{};
  s.mode = ACT;
  s.rows = rows;
  s.ld = ld;
  s.h = h;
  s.mean = mean;
  s.rstd = rstd;
  s.g = g;
  s.beta = beta;
  s.al = al;
  return s;
}

Src dnorm(const float* dyn, const float* h, int rows, int ld, const float* mean,
          const float* rstd, const float* m1, const float* m2, const float* g) {
  Src s{};
  s.mode = DNORM;
  s.rows = rows;
  s.ld = ld;
  s.dyn = dyn;
  s.h = h;
  s.mean = mean;
  s.rstd = rstd;
  s.m1 = m1;
  s.m2 = m2;
  s.g = g;
  return s;
}

// One call's state: the dims, the plan, the scratch, the parameters as
// float32 (P) and the stream
struct Call {
  Dims d;
  int pl[PLAN_FIELDS];
  Scratch s;
  const float* P[N_PARAMS];
  int g_bf16;
  cudaStream_t st;
};

// the parameters as float32 (copies where they come in bf16), the CUDA-core
// backward's transposed weights, the wgmma route's images: one launch
cudaError_t prep(Call& c, const void* const* params, int p_bf16, int backward) {
  const Dims& d = c.d;
  PrepParams q{};
  long total = 0;
  auto job = [&](const void* src, void* dst, int O, int K, int so, int sk, int img) {
    PrepJob& j = q.job[q.n++];
    j = PrepJob{src, dst, total, O, K, so, sk, img};
    total += (long)O * K;
  };
  for (int i = 0; i < N_PARAMS; ++i) {
    if (p_bf16) {
      job(params[i], c.s.p32[i], (int)param_size(d, i), 1, 1, 0, 0);
      c.P[i] = c.s.p32[i];
    } else {
      c.P[i] = static_cast<const float*>(params[i]);
    }
  }
  if (c.pl[PL_ROUTE]) {
    // W [O][K] from the weight's own layout: W_in [Ch][C], W_pw [Ch][Ch], W_out [C][Ch]
    const void* src[N_GEMMS] = {params[W_IN], params[W_PW], params[W_OUT],
                                params[W_OUT], params[W_PW], params[W_IN]};
    for (int i = 0; i < (backward ? N_GEMMS : 3); ++i) {
      int O, K;
      gemm_ok(d, i, O, K);
      if (i < 3)
        job(src[i], c.s.img[i], O, K, K, 1, 1);
      else   // W^T: element (o, k) of W^T is W[k][o]
        job(src[i], c.s.img[i], O, K, 1, O, 1);
    }
  } else if (backward) {
    job(params[W_IN], c.s.wt32[0], d.C, d.Ch, 1, d.C, 0);
    job(params[W_PW], c.s.wt32[1], d.Ch, d.Ch, 1, d.Ch, 0);
    job(params[W_OUT], c.s.wt32[2], d.Ch, d.C, 1, d.Ch, 0);
  }
  if (q.n == 0) return cudaSuccess;
  q.total = total;
  q.src_bf16 = p_bf16;
  const long blocks = (total + THREADS - 1) / THREADS;
  tcn_prep_kernel<<<(int)(blocks < 1024 ? blocks : 1024), THREADS, 0, c.st>>>(q);
  return cudaGetLastError();
}

// lets a kernel take up to SMEM_MAX bytes of shared memory (its static
// arrays included): once a kernel and device
cudaError_t allow_smem(const void* kernel) {
  static std::mutex mu;
  static std::vector<std::pair<int, const void*>> done;
  int dev = 0;
  TRY(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : done)
    if (e.first == dev && e.second == kernel) return cudaSuccess;
  cudaFuncAttributes fa;
  TRY(cudaFuncGetAttributes(&fa, kernel));
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX - (int)fa.sharedSizeBytes));
  done.emplace_back(dev, kernel);
  return cudaSuccess;
}

// one 1x1 product on the call's route: W (the product's image, or the
// float32 weight) times `in`; mode STORE_H / TYPED / PVJP as tcn_wg_gemm's
template <typename T>
cudaError_t gemm(Call& c, int which, const float* w32, Src in, const float* bias,
                 const void* res, void* out, int mode, float* part, Src lvl) {
  const Dims& d = c.d;
  int O, K;
  gemm_ok(d, which, O, K);
  if (!c.pl[PL_ROUTE]) {
    GemmParams p{w32, in, bias, res, out, part, O, K, d.T, d.Tp, mode == TYPED};
    const dim3 grid((d.T + TILE - 1) / TILE, (O + TILE - 1) / TILE, d.B);
    tcn_gemm_kernel<T><<<grid, THREADS, 0, c.st>>>(p);
    return cudaGetLastError();
  }
  const int nc = c.pl[PL_GEMM + 2 * which], smem = c.pl[PL_GEMM + 2 * which + 1];
  const int P = cdiv(d.T, nc);
  WgGemmParams p{c.s.img[which], in, bias, static_cast<const __nv_bfloat16*>(res), out, part,
                 lvl, mode, O, d.T, d.Tp, d.B, P};
  const int ctas = d.B * P < H100_SMS ? d.B * P : H100_SMS;
#define LAUNCH(NC_, K_, MBW_)                                                   \
  if (nc == NC_ && K == K_ && (O > 128) + 1 == MBW_) {                          \
    TRY(allow_smem(reinterpret_cast<const void*>(tcn_wg_gemm<NC_, K_, MBW_>))); \
    tcn_wg_gemm<NC_, K_, MBW_><<<ctas, THREADS, smem, c.st>>>(p);               \
    return cudaGetLastError();                                                  \
  }
  LAUNCH(128, 64, 1) LAUNCH(128, 128, 1) LAUNCH(128, 256, 1)
  LAUNCH(64, 64, 1) LAUNCH(64, 128, 1) LAUNCH(64, 256, 1)
  LAUNCH(128, 64, 2) LAUNCH(128, 128, 2) LAUNCH(128, 256, 2)
  LAUNCH(64, 64, 2) LAUNCH(64, 128, 2) LAUNCH(64, 256, 2)
#undef LAUNCH
  return static_cast<cudaError_t>(PLAN_MISMATCH);
}

cudaError_t stats(Call& c, const float* part, int P, float* mean, float* rstd) {
  tcn_stats_reduce<<<c.d.B, THREADS, 0, c.st>>>(part, P, (double)c.d.Ch * c.d.T, mean, rstd);
  return cudaGetLastError();
}

// h1, h2, h3 and their statistics into the scratch
template <typename T>
cudaError_t forward_hidden(Call& c, const void* x) {
  const Dims& d = c.d;
  Scratch& s = c.s;
  const float* const* P = c.P;
  float* mean = s.stats;
  float* rstd = s.stats + d.B;
  const int wg = c.pl[PL_ROUTE];
  const int p_in = wg ? cdiv(d.T, c.pl[PL_GEMM + 2 * G_IN]) : cdiv(d.T, TILE) * cdiv(d.Ch, TILE);
  const int p_pw = wg ? cdiv(d.T, c.pl[PL_GEMM + 2 * G_PW]) : cdiv(d.T, TILE) * cdiv(d.Ch, TILE);
  TRY(gemm<T>(c, G_IN, P[W_IN], raw(x, d.C, d.T), nullptr, nullptr, s.h1, STORE_H, s.part,
              Src{}));
  TRY(stats(c, s.part, p_in, mean, rstd));
  DwParams dw{act(s.h1, d.Ch, d.Tp, mean, rstd, P[G1], P[B1], P[AL1]), P[W_DW], P[B_DW], s.h2,
              s.part, d.Ch, d.T, d.Tp, d.kw, d.dil, ((d.kw - 1) / 2) * d.dil};
  TRY(allow_smem(reinterpret_cast<const void*>(tcn_dw_fwd_kernel)));
  tcn_dw_fwd_kernel<<<dim3(d.Ch, d.B), THREADS, c.pl[PL_DW], c.st>>>(dw);
  TRY(cudaGetLastError());
  TRY(stats(c, s.part, d.Ch, mean + 2 * d.B, rstd + 2 * d.B));
  TRY(gemm<T>(c, G_PW, P[W_PW],
              act(s.h2, d.Ch, d.Tp, mean + 2 * d.B, rstd + 2 * d.B, P[G2], P[B2], P[AL2]),
              P[B_PW], nullptr, s.h3, STORE_H, s.part, Src{}));
  return stats(c, s.part, p_pw, mean + 4 * d.B, rstd + 4 * d.B);
}

template <typename T>
cudaError_t fwd(Call& c, const void* x, const void* const* params, int p_bf16, void* y) {
  const Dims& d = c.d;
  TRY(prep(c, params, p_bf16, 0));
  TRY(forward_hidden<T>(c, x));
  const float* mean3 = c.s.stats + 4 * d.B;
  const float* rstd3 = c.s.stats + 5 * d.B;
  return gemm<T>(c, G_OUT, c.P[W_OUT],
                 act(c.s.h3, d.Ch, d.Tp, mean3, rstd3, c.P[G3], c.P[B3], c.P[AL3]), c.P[B_OUT],
                 x, y, TYPED, nullptr, Src{});
}

template <typename T>
cudaError_t wgrad(Call& c, int which, Src dsrc, Src asrc, void* dw, void* db) {
  const Dims& d = c.d;
  Scratch& s = c.s;
  int O, K;
  wgrad_ok(d, which, O, K);
  const int* q = c.pl + PL_WGRAD + 4 * which;
  float* bp = db != nullptr ? s.b_part : nullptr;
  if (!c.pl[PL_ROUTE]) {
    WgradParams p{dsrc, asrc, s.w_part, bp, O, K, d.T, d.B, q[1]};
    const dim3 grid((K + TILE - 1) / TILE, (O + TILE - 1) / TILE, q[0]);
    tcn_wgrad_kernel<T><<<grid, THREADS, 0, c.st>>>(p);
  } else {
    const int TC = cdiv(d.T, WG_COLS);
    WgWgradParams p{dsrc, asrc, s.w_part, bp, O, d.T, TC, d.B * TC, q[1], q[2]};
    const int ctas = q[0] * q[2];
    if (K == 64) {
      TRY(allow_smem(reinterpret_cast<const void*>(tcn_wg_wgrad<64>)));
      tcn_wg_wgrad<64><<<ctas, THREADS, q[3], c.st>>>(p);
    } else if (K == 128) {
      TRY(allow_smem(reinterpret_cast<const void*>(tcn_wg_wgrad<128>)));
      tcn_wg_wgrad<128><<<ctas, THREADS, q[3], c.st>>>(p);
    } else if (K == 256) {
      TRY(allow_smem(reinterpret_cast<const void*>(tcn_wg_wgrad<256>)));
      tcn_wg_wgrad<256><<<ctas, THREADS, q[3], c.st>>>(p);
    } else {
      return static_cast<cudaError_t>(PLAN_MISMATCH);
    }
  }
  TRY(cudaGetLastError());
  const long total = (long)O * K + O;
  const int blocks = total / THREADS + 1 < 1024 ? (int)(total / THREADS + 1) : 1024;
  tcn_wgrad_reduce<<<blocks, THREADS, 0, c.st>>>(s.w_part, bp, dw, db, O, K, q[0], c.g_bf16);
  return cudaGetLastError();
}

// the rows of a level's PReLU / norm VJP into s.rows, then its reduce: m1,
// m2 and the gamma, beta and alpha gradients. CUDA cores: the row pass over
// g_io (da -> dyn in place); wgmma: the product's epilogue did that, and
// its per-tile row sums (P tiles a sample) are added here.
cudaError_t norm_level(Call& c, float* g_io, Src y, int P, float* m1, float* m2, void* dg,
                       void* db, void* dal) {
  const Dims& d = c.d;
  if (!c.pl[PL_ROUTE]) {
    NormRowParams p{g_io, y, c.s.rows, d.Ch, d.T, d.Tp};
    tcn_norm_rows_kernel<<<dim3(d.Ch, d.B), THREADS, 0, c.st>>>(p);
  } else {
    const long n = (long)d.B * d.Ch * 3;
    tcn_rows_sum<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0, c.st>>>(c.s.rows_part, d.B,
                                                                           P, d.Ch, c.s.rows);
  }
  TRY(cudaGetLastError());
  tcn_norm_reduce<<<d.B + 1, THREADS, 0, c.st>>>(c.s.rows, y.g, d.B, d.Ch, (float)d.Ch * d.T, m1,
                                                 m2, dg, db, dal, c.g_bf16);
  return cudaGetLastError();
}

// G: the 16 gradient pointers, in the parameters' order and dtype
template <typename T>
cudaError_t bwd(Call& c, const void* x, const void* dy, const void* const* params, int p_bf16,
                void* dx, void* const* G) {
  const Dims& d = c.d;
  Scratch& s = c.s;
  TRY(prep(c, params, p_bf16, 1));
  TRY(forward_hidden<T>(c, x));
  const float* const* P = c.P;
  const int B = d.B, wg = c.pl[PL_ROUTE];
  const float *mean1 = s.stats, *rstd1 = s.stats + B, *mean2 = s.stats + 2 * B,
              *rstd2 = s.stats + 3 * B, *mean3 = s.stats + 4 * B, *rstd3 = s.stats + 5 * B;
  float *m1_1 = s.m, *m2_1 = s.m + B, *m1_2 = s.m + 2 * B, *m2_2 = s.m + 3 * B,
        *m1_3 = s.m + 4 * B, *m2_3 = s.m + 5 * B;
  const Src a1 = act(s.h1, d.Ch, d.Tp, mean1, rstd1, P[G1], P[B1], P[AL1]);
  const Src a2 = act(s.h2, d.Ch, d.Tp, mean2, rstd2, P[G2], P[B2], P[AL2]);
  const Src a3 = act(s.h3, d.Ch, d.Tp, mean3, rstd3, P[G3], P[B3], P[AL3]);
  const int mode = wg ? PVJP : STORE_H;
  float* rp = wg ? s.rows_part : nullptr;
  const int p3 = wg ? cdiv(d.T, c.pl[PL_GEMM + 2 * G_OUT_T]) : 1;
  const int p2 = wg ? cdiv(d.T, c.pl[PL_GEMM + 2 * G_PW_T]) : 1;

  // out 1x1: da3 = W_out^T dy (wgmma: dyn3 and its rows); dW_out, db_out
  TRY(gemm<T>(c, G_OUT_T, s.wt32[2], raw(dy, d.C, d.T), nullptr, nullptr, s.s, mode, rp, a3));
  TRY(wgrad<T>(c, D_OUT, raw(dy, d.C, d.T), a3, G[W_OUT], G[B_OUT]));
  // PReLU3 / gGN3
  TRY(norm_level(c, s.s, a3, p3, m1_3, m2_3, G[G3], G[B3], G[AL3]));
  const Src dh3 = dnorm(s.s, s.h3, d.Ch, d.Tp, mean3, rstd3, m1_3, m2_3, P[G3]);
  // pointwise 1x1: da2 = W_pw^T dh3 (wgmma: dyn2 and its rows); dW_pw, db_pw
  TRY(gemm<T>(c, G_PW_T, s.wt32[1], dh3, nullptr, nullptr, s.s2, mode, rp, a2));
  TRY(wgrad<T>(c, D_PW, dh3, a2, G[W_PW], G[B_PW]));
  // PReLU2 / gGN2
  TRY(norm_level(c, s.s2, a2, p2, m1_2, m2_2, G[G2], G[B2], G[AL2]));
  // depthwise VJP + PReLU1 / gLN1's rows
  DwBwdParams dw{dnorm(s.s2, s.h2, d.Ch, d.Tp, mean2, rstd2, m1_2, m2_2, P[G2]), a1, P[W_DW],
                 s.s, s.rows, s.dw_rows, d.Ch, d.T, d.Tp, d.kw, d.dil, ((d.kw - 1) / 2) * d.dil};
  TRY(allow_smem(reinterpret_cast<const void*>(tcn_dw_bwd_kernel)));
  tcn_dw_bwd_kernel<<<dim3(d.Ch, B), THREADS, c.pl[PL_DW + 1], c.st>>>(dw);
  TRY(cudaGetLastError());
  const int n = d.Ch * (1 + d.kw);
  tcn_dw_param_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, c.st>>>(
      s.dw_rows, B, d.Ch, d.kw, G[B_DW], G[W_DW], c.g_bf16);
  TRY(cudaGetLastError());
  tcn_norm_reduce<<<B + 1, THREADS, 0, c.st>>>(s.rows, P[G1], B, d.Ch, (float)d.Ch * d.T, m1_1,
                                               m2_1, G[G1], G[B1], G[AL1], c.g_bf16);
  TRY(cudaGetLastError());
  const Src dh1 = dnorm(s.s, s.h1, d.Ch, d.Tp, mean1, rstd1, m1_1, m2_1, P[G1]);
  // in 1x1 (no bias): dx = W_in^T dh1 + dy; dW_in
  TRY(gemm<T>(c, G_IN_T, s.wt32[0], dh1, nullptr, dy, dx, TYPED, nullptr, Src{}));
  return wgrad<T>(c, D_IN, dh1, raw(x, d.C, d.T), G[W_IN], nullptr);
}

// checks the caller's plan against make_plan's and carves the scratch
cudaError_t setup(Call& c, const int* plan, void* scratch, long scratch_floats, int backward,
                  int B, int C, int Ch, int T, int kw, int dil, int x_bf16, void* stream) {
  c.d = Dims{B, C, Ch, T, kw, dil, 0};
  if (!make_plan(c.d, x_bf16, c.pl)) return cudaErrorInvalidValue;
  for (int i = 0; i < PLAN_FIELDS; ++i)
    if (c.pl[i] != plan[i]) return static_cast<cudaError_t>(PLAN_MISMATCH);
  c.d.Tp = c.pl[PL_TP];
  if (carve(nullptr, c.d, c.pl, backward, c.s) != scratch_floats)
    return static_cast<cudaError_t>(PLAN_MISMATCH);
  carve(static_cast<float*>(scratch), c.d, c.pl, backward, c.s);
  c.st = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace


extern "C" int tcn_train_plan_fields() { return PLAN_FIELDS; }

// the plan make_plan gives (0 where no route takes the shape) and the
// scratch floats of the forward and the backward
extern "C" int tcn_train_plan(int B, int C, int Ch, int T, int kw, int dil, int x_bf16, int* plan,
                              long* scratch) {
  Dims d{B, C, Ch, T, kw, dil, 0};
  int pl[PLAN_FIELDS];
  if (!make_plan(d, x_bf16, pl)) return 0;
  for (int i = 0; i < PLAN_FIELDS; ++i) plan[i] = pl[i];
  d.Tp = pl[PL_TP];
  Scratch s;
  scratch[0] = carve(nullptr, d, pl, 0, s);
  scratch[1] = carve(nullptr, d, pl, 1, s);
  return 1;
}

// ptrs: x, the 16 parameters, y
extern "C" int tcn_train_fwd(void* const* ptrs, const int* plan, void* scratch,
                             long scratch_floats, int B, int C, int Ch, int T, int kw, int dil,
                             int x_bf16, int p_bf16, void* stream) {
  Call c;
  cudaError_t err = setup(c, plan, scratch, scratch_floats, 0, B, C, Ch, T, kw, dil, x_bf16,
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  c.g_bf16 = p_bf16;
  err = x_bf16 ? fwd<__nv_bfloat16>(c, ptrs[0], ptrs + 1, p_bf16, ptrs[17])
               : fwd<float>(c, ptrs[0], ptrs + 1, p_bf16, ptrs[17]);
  return static_cast<int>(err);
}

// ptrs: x, dy, the 16 parameters, dx, the 16 gradients (in the parameters' dtype)
extern "C" int tcn_train_bwd(void* const* ptrs, const int* plan, void* scratch,
                             long scratch_floats, int B, int C, int Ch, int T, int kw, int dil,
                             int x_bf16, int p_bf16, void* stream) {
  Call c;
  cudaError_t err = setup(c, plan, scratch, scratch_floats, 1, B, C, Ch, T, kw, dil, x_bf16,
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  c.g_bf16 = p_bf16;
  err = x_bf16 ? bwd<__nv_bfloat16>(c, ptrs[0], ptrs[1], ptrs + 2, p_bf16, ptrs[18], ptrs + 19)
               : bwd<float>(c, ptrs[0], ptrs[1], ptrs + 2, p_bf16, ptrs[18], ptrs + 19);
  return static_cast<int>(err);
}

extern "C" const char* tcn_train_error_string(int err) {
  if (err == PLAN_MISMATCH) return "the launch plan differs from the source's";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
