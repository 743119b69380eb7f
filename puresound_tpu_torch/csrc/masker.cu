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
// float32 without tensor cores, 0.58 ms at the 989 TFLOP/s of bf16.
//
// What this design does about it. A TPU tile keeps the whole [F, K*bt + bt,
// C] stage stack of a stream tile in 100 MB of VMEM; an SM cannot hold a
// stream's. So the call is a sequence of passes with scratch in device
// memory, all launched by this one C call. Under bfloat16 dots and weights
// (serving) each conv is an implicit GEMM on wgmma in persistent CTAs that
// keep the layer's weights resident in shared memory and gather each tap's
// input rows with cp.async a ring of buffers ahead (conv_tc_kernel below);
// the DPARN bottleneck's attention passes run dparn_attention.cuh's wgmma
// route. Under float32 dots (or weights) a CTA owns TM output rows (TM x
// C_out <= 8,192) and walks its 6 (or 12, with the skip) taps, staging the
// input rows [C_in][TM] and the tap's weights [C_in][C_out] in shared memory,
// 4 x 8 outputs a thread on CUDA cores. A small copy kernel per carry. The
// bottleneck's dual-path passes (DPCRN's three a block, DPARN's inter pass)
// take dual_path_passes.cuh's route from their own plan: under bf16 dots and
// weights the tensor-core passes of dual_path_tc.cuh (the intra and inter
// chains on mma.sync in clusters of 2 CTAs, the intra projection on wgmma),
// else the CUDA-core passes. What bounds the center now: the chains' step
// latency and their shared-memory operand traffic (PERF.md has the device
// ms by pass). The routes come from the plans of ops/masker_kernel.py
// (`conv_plan`), ops/dparn_attention_kernel.py (`plan`) and
// ops/dual_path_kernel.py (`_plan`), checked again here before any launch.
//
// int8_hh (DPCRN): the dual-path passes' int8 recurrent products (see
// dual_path.cu). xscr_half: the bottleneck activation is a bfloat16 buffer;
// the d4 output is copied into it rounded (the float32 d4 stays the u0 skip),
// every residual write rounds, and u0 reads it, its carry rounded likewise.
#include "dparn_attention.cuh"
#include "dual_path_passes.cuh"
#include "hopper.cuh"

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
  const __nv_bfloat16* wpack;   // resident path: conv_pack_kernel's image of the layer
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

template <typename WT, bool DB>
__global__ void __launch_bounds__(THREADS) conv_kernel(ConvParams p) {
  extern __shared__ __align__(16) float smem[];
  const int TM = p.TM, lda = TM + 4, Co = p.Co, ng = Co / 8, nmt = TM / 4 * ng;
  const int Cmax = p.Ch > p.Cs ? p.Ch : p.Cs;
  float* A = smem;                 // [Cmax][lda]
  float* W = A + Cmax * lda;       // [Cmax][Co]
  const long row0 = (long)blockIdx.x * TM;
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


// ---------------------------------------------- the convs on tensor cores
// Under bf16 dots and weights a conv is an implicit GEMM [rows x (taps C_in)]
// . [(taps C_in) x C_out] on wgmma (float32 sums). A persistent CTA of two
// warpgroups stages its share of the layer's weights once: N = C_out /
// co_split output channels of every tap, K-major and swizzled (hopper.cuh
// `swz`), copied with cp.async from the image `conv_pack_kernel` makes per
// call from the weights' own strides. It then walks row tiles of TM rows:
// per tap (and part) it gathers the tile's input rows as bf16 into a ring of
// NS (3, or 2) swizzled [TM][C_in] buffers with cp.async (float32 inputs are
// loaded, rounded and stored), NS - 1 taps ahead of the products, starting
// the next gather while this tap's wgmma runs; each warpgroup multiplies 64 rows by
// the tap's [C_in x N] weights (m64nNk16 over C_in / 16 slices, both operands
// from shared memory), or with 64-row tiles the tile by half the columns.
// Where the weights do not fit beside a ring of 128-row tiles, the tiles
// shrink to 64 rows, then co_split CTAs share a row tile. The epilogue runs
// in registers: bias, PReLU, the rounding (round_out), the store (bf16 or
// float32 pairs).
constexpr int TC_TM = 128;   // rows a tile, halved where the weights leave no room

// an output row's position (fo, k, b), found once per tile
struct RowPos {
  int fo, k, b, ok;
};

__device__ __forceinline__ RowPos row_pos(const ConvParams& p, int row) {
  const int KB = p.K * p.B;   // rows < 2^31 (the wrapper checks)
  const int fo = row / KB, kb = row - fo * KB, k = kb / p.B;
  return {fo, k, kb - k * p.B, row < p.F * KB};
}

// where the input of tap (t, df) for output row `rp` lives: its tensor
// (null: a zero row outside [0, F)), bf16 flag and element offset
struct TapSrc {
  const void* src;
  int bf;
  long off;
};

__device__ __forceinline__ TapSrc tap_src(const ConvParams& p, int part, int t, int df,
                                          const RowPos& rp) {
  const int C = part ? p.Cs : p.Ch;
  const int fi = p.tconv ? rp.fo + 1 - df : rp.fo - 1 + df, kf = rp.k - 1 + t;
  if (!rp.ok || fi < 0 || fi >= p.F) return {nullptr, 0, 0};
  if (kf < 0)
    return {part ? p.sc : p.hc, part ? p.sc_bf16 : p.hc_bf16, ((long)fi * p.B + rp.b) * C};
  return {part ? p.s : p.h, part ? p.s_bf16 : p.h_bf16,
          (((long)fi * p.K + kf) * p.B + rp.b) * C};
}

// channels 8 c8 .. 8 c8 + 7 of a gathered row into shared memory: cp.async
// from bf16, a rounded copy from float32, zeros for a zero row
__device__ __forceinline__ void gather_chunk(uint32_t d, const TapSrc& s, long off, int c8) {
  if (s.src == nullptr) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(d), "r"(0) : "memory");
  } else if (s.bf) {
    hopper::cp_async16(d, static_cast<const __nv_bfloat16*>(s.src) + off + 8 * c8);
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(s.src) + off +
                                                      8 * c8);
    const float4 lo = q[0], hi = q[1];
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                 "r"(hopper::bf16x2(lo.x, lo.y)), "r"(hopper::bf16x2(lo.z, lo.w)),
                 "r"(hopper::bf16x2(hi.x, hi.y)), "r"(hopper::bf16x2(hi.z, hi.w))
                 : "memory");
  }
}

// the input of tap (t, df) of one part for a tile of TM rows into the
// swizzled buffer dst. `rp`: the tile's first row when B is a multiple of TM
// (the tile lies in one (fo, k) frame, so the tap's rows are one contiguous
// block, or the carry's, or zeros, and consecutive threads copy consecutive
// 16-byte chunks); else this thread's row (each thread gathers one row's
// chunks). C is a power of two (tile_width), so the chunk walk shifts.
template <int TM>
__device__ __forceinline__ void tc_gather(uint32_t dst, const ConvParams& p, int part, int t,
                                          int df, const RowPos& rp) {
  const int C = part ? p.Cs : p.Ch, lg = __ffs(C / 8) - 1;   // log2 of the chunks a row
  const TapSrc s = tap_src(p, part, t, df, rp);
  if (p.B % TM == 0) {
    // thread tid copies chunk tid % (C / 8) of rows tid / (C / 8) + j R: R =
    // THREADS / (C / 8) rows on (a multiple of 8, so the swizzle's row phase
    // and the atom column stay, and each step adds a constant)
    const int c8 = threadIdx.x & ((1 << lg) - 1), r = threadIdx.x >> lg, R = THREADS >> lg;
    const uint32_t step = R * (C >= 64 ? 128 : 64);
    uint32_t d = dst + hopper::swz(r, 8 * c8, TM, C);
    long off = s.off + (long)r * C;
    for (int j = 0; j < TM / R; ++j, d += step, off += (long)R * C) gather_chunk(d, s, off, c8);
  } else {
    const int r = threadIdx.x % TM;
    for (int c8 = threadIdx.x / TM; c8 < C / 8; c8 += THREADS / TM)
      gather_chunk(dst + hopper::swz(r, 8 * c8, TM, C), s, s.off, c8);
  }
}

struct PackParams {
  const __nv_bfloat16* w[2 * NCONV];   // the h taps, then the skip taps
  long ws[2 * NCONV][2];               // their strides (in, out) in elements
  int Ch, Cs, Co, N;                   // N = Co / co_split
  __nv_bfloat16* dst;
};

// dst[part][Co / N blocks][tap] = the block's W_tap^T [N][C] swizzled (swz)
__global__ void conv_pack_kernel(PackParams p) {
  const int nh = NCONV * p.Co * p.Ch, n_all = nh + NCONV * p.Co * p.Cs;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_all; i += gridDim.x * blockDim.x) {
    const int part = i >= nh, j = part ? i - nh : i, C = part ? p.Cs : p.Ch;
    const int g = j / (p.Co * C), n = j / C % p.Co, k = j % C, t = part * NCONV + g;
    const long block = ((long)(n / p.N) * NCONV + g) * p.N * C;
    p.dst[(part ? nh : 0) + block + hopper::swz(n % p.N, k, p.N, C) / 2] =
        p.w[t][k * p.ws[t][0] + n * p.ws[t][1]];
  }
}

inline long pack_elems(int Ch, int Cs, int Co) { return (long)NCONV * Co * (Ch + Cs); }

// channel counts the swizzled tiles take: 32, 64, 128, 256
__host__ __device__ inline bool tile_width(int c) { return c >= 32 && c <= 256 && !(c & (c - 1)); }

// N: this CTA's output channels; TM = 128: each warpgroup 64 rows x N; TM =
// 64: each warpgroup the tile's 64 rows x N / 2

template <int N, int TM>
__global__ void __launch_bounds__(THREADS, 2) conv_tc_kernel(ConvParams p, int co_split, int NS) {
  constexpr int NW = TM == 128 ? N : N / 2;   // a warpgroup's columns
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t raw = hopper::smem_addr(tc_smem);
  const uint32_t Wh = raw + ((1024 - (raw & 1023)) & 1023);   // swizzled tiles: 1,024-aligned
  const int Co = p.Co, Cmax = p.Ch > p.Cs ? p.Ch : p.Cs;
  const int nparts = p.s ? 2 : 1, nst = NCONV * nparts;
  const int col = blockIdx.x % co_split, n_base = col * N;
  const int ctas = gridDim.x / co_split, cta = blockIdx.x / co_split;
  const long NR = (long)p.F * p.K * p.B;
  const int ntiles = (int)((NR + TM - 1) / TM);
  const int mine = cta < ntiles ? (ntiles - 1 - cta) / ctas + 1 : 0;
  const uint32_t Ws = Wh + NCONV * N * p.Ch * 2;
  const uint32_t ring = Ws + NCONV * N * p.Cs * 2;
  const uint32_t buf_bytes = TM * Cmax * 2;
  // the layer's weights once: this CTA's block of the packed image, 16-byte
  // cp.async (the first ring wait covers them)
  for (int part = 0; part < nparts; ++part) {
    const int C = part ? p.Cs : p.Ch, chunks = NCONV * N * C / 8;
    const __nv_bfloat16* src = p.wpack + (part ? NCONV * Co * p.Ch : 0) + (long)col * chunks * 8;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
      hopper::cp_async16((part ? Ws : Wh) + 16 * i, src + 8 * i);
  }
  lstm_gates::cp_async_commit();
  const int tid = threadIdx.x, wg = tid / 128, w = tid % 128 / 32, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // the gathers walk the stages (tile, part, tap) NS - 1 ahead of the
  // products, with counters of their own; a tile's row position is found
  // once (this thread's row where B is not a multiple of TM)
  int g_tile = 0, g_in = 0, g_slot = 0;
  RowPos rp{};
  auto gather_next = [&]() {
    if (g_in == 0)
      rp = row_pos(p, (cta + g_tile * ctas) * TM + (p.B % TM == 0 ? 0 : tid % TM));
    const int part = g_in >= NCONV, tap = g_in - part * NCONV, t = tap >= 3;
    tc_gather<TM>(ring + g_slot * buf_bytes, p, part, t, tap - 3 * t, rp);
    if (++g_in == nst) {
      g_in = 0;
      ++g_tile;
    }
    if (++g_slot == NS) g_slot = 0;
  };
  const int r_wg = TM == 128 ? 64 * wg : 0, n_wg = TM == 128 ? 0 : NW * wg;
  float acc[NW / 2];
  const int S = mine * nst;
  for (int q = 0; q < NS - 1; ++q) {
    if (q < S) gather_next();
    lstm_gates::cp_async_commit();
  }
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  const float alpha = __bfloat162float(*static_cast<const __nv_bfloat16*>(p.alpha));
  int tile = 0, in = 0, slot = 0;
  for (int q = 0; q < S; ++q) {
    if (NS == 3)   // the stage's gathers landed (the ring's later ones may fly)
      lstm_gates::cp_async_wait<1>();
    else
      lstm_gates::cp_async_wait<0>();
    hopper::fence_async_smem();   // the gathered rows (and weights) visible to wgmma
    __syncthreads();              // ... and every warpgroup's products of stage q - 1 done
    const int part = in >= NCONV, tap = in - part * NCONV;
    const int C = part ? p.Cs : p.Ch;
    const uint32_t a_s = ring + slot * buf_bytes;
    const uint32_t w_s = (part ? Ws : Wh) + tap * N * C * 2;
    hopper::pin(acc);
    hopper::wg_fence();
#pragma unroll 4
    for (int ks = 0; ks < C / 16; ++ks)
      hopper::wgmma_ss<NW>(acc, hopper::desc_tile(a_s, r_wg, ks, TM, C),
                           hopper::desc_tile(w_s, n_wg, ks, N, C), in > 0 || ks > 0);
    hopper::wg_commit();
    // the next gather (into the buffer stage q - 1 read) overlaps the products
    if (q + NS - 1 < S) gather_next();
    lstm_gates::cp_async_commit();
    hopper::wg_wait0();
    hopper::pin(acc);
    if (in == nst - 1) {   // the tile's epilogue
      const long row0 = (long)(cta + tile * ctas) * TM + r_wg + 16 * w + g;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long row = row0 + 8 * h;
          const int n = n_base + n_wg + 8 * j + 2 * tq;
          if (row >= NR) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = acc[4 * j + 2 * h + e] + __bfloat162float(bias[n + e]);
            v[e] = v[e] >= 0.f ? v[e] : alpha * v[e];
            if (p.round_out) v[e] = rnd<true>(v[e]);
          }
          if (p.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + row * Co + n) =
                __floats2bfloat162_rn(v[0], v[1]);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + row * Co + n) =
                make_float2(v[0], v[1]);
        }
    }
    if (++in == nst) {
      in = 0;
      ++tile;
    }
    if (++slot == NS) slot = 0;
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

struct Limits {
  int cap, sms;   // shared memory a block may opt into, SMs
};
inline Limits limits() {
  Limits l{227 * 1024, 132};
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&l.cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return l;
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
  const int* plan;          // the attention plan (7), then the six convs' (6 each)
  void* packed;             // the wgmma attention's repacked weights, a block each
  const long* cws;          // the conv weights' strides (in, out), 2 each
  const long* bws;          // the DPARN bottleneck weights' strides (2 each), or null
  void* conv_pack;          // the resident convs' weight images, in layer order
  const void* const* dp_img;  // the bottleneck's tensor-core images (DPCRN 8, DPARN 3 a
                              // block; ops/dual_path_kernel.py), or null
  void* dp16;               // tensor cores: bf16 yf / yb (DPCRN) then x_scr's bf16 copy
  Limits lim;
};

// ------------------------------------------------------------------ plans
// Each conv's plan comes from ops/masker_kernel.py `conv_plan` and is
// computed again here (conv_plan below); a plan that differs is refused.
// the fields: weights (1 resident, 0 streamed), co_split, TM, stages, smem, CTAs
constexpr int CONV_PLAN_FIELDS = 6;
constexpr int SMEM_PER_SM = 233472, BLOCK_RESERVE = 1024;

// resident weights on tensor cores (bf16 dots and weights, input channels
// 32 to 256, N = C_out / co_split of 32, 64 or 128): the fewest co_split CTAs
// a row tile, then tiles of 128 rows before 64 (N >= 64), then 3 ring
// buffers before 2, that fit; else the CUDA-core loop with each tap's
// weights staged per tile ("streamed")
inline bool conv_plan(bool tc, int Ch, int Cs, int Co, long NR, const Limits& l,
                      int (&pl)[CONV_PLAN_FIELDS]) {
  const int Cmax = Ch > Cs ? Ch : Cs;
  if (tc && tile_width(Ch) && (Cs == 0 || tile_width(Cs))) {
    for (int cs = 1; cs <= 4; cs *= 2) {
      const int N = Co % cs ? 0 : Co / cs;
      if (N != 32 && N != 64 && N != 128) continue;
      for (int tm = TC_TM; tm >= TC_TM / 2 && (tm == TC_TM || N >= 64); tm /= 2)
        for (int ns = 3; ns >= 2; --ns) {
          const long smem = 1024 + 2L * NCONV * N * (Ch + Cs) + 2L * ns * tm * Cmax;
          if (smem > l.cap) continue;
          const long per_sm = SMEM_PER_SM / (smem + BLOCK_RESERVE) < 2
                                  ? SMEM_PER_SM / (smem + BLOCK_RESERVE) : 2;
          const long tiles = (NR + tm - 1) / tm * cs;
          long ctas = tiles < l.sms * per_sm ? tiles : l.sms * per_sm;
          ctas -= ctas % cs;
          const int v[CONV_PLAN_FIELDS] = {1, cs, tm, ns, (int)smem, (int)ctas};
          for (int i = 0; i < CONV_PLAN_FIELDS; ++i) pl[i] = v[i];
          return true;
        }
    }
  }
  // CUDA cores: 4-row microtiles, so TM is a multiple of 4 (float4 rows)
  const int TM = (8192 / Co < 256 ? 8192 / Co : 256) & ~3;
  const long smem = 4L * ((long)Cmax * (TM + 4) + (long)Cmax * Co);
  const int v[CONV_PLAN_FIELDS] = {0, 1, TM, 1, (int)smem, (int)((NR + TM - 1) / TM)};
  for (int i = 0; i < CONV_PLAN_FIELDS; ++i) pl[i] = v[i];
  return smem <= l.cap;
}

template <int N, int TM>
cudaError_t launch_tc(const ConvParams& p, const int* pl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_tc_kernel<N, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl[4]);
  if (err != cudaSuccess) return err;
  conv_tc_kernel<N, TM><<<pl[5], THREADS, pl[4], stream>>>(p, pl[1], pl[3]);
  return cudaGetLastError();
}

// `w` indexes the layer's first weight in the flat list (h taps, skip taps
// when `s`, then bias and alpha); `wp` walks the resident images
template <typename WT, bool DB>
cudaError_t conv(const Center& q, const int* want, __nv_bfloat16*& wp, int w, const void* h,
                 int h_bf16, const void* hc, const void* s, int s_bf16, const void* sc,
                 void* out, int out_bf16, int round_out, int tconv, int Ch, int Cs, int Co,
                 cudaStream_t stream, int hc_round = 0) {
  const void* const* wh = q.cw + w;
  const void* const* ws = s ? q.cw + w + NCONV : nullptr;
  const void* bias = q.cw[w + (s ? 2 : 1) * NCONV];
  const void* alpha = q.cw[w + (s ? 2 : 1) * NCONV + 1];
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
  const long NR = (long)q.F * q.K * q.B;
  int pl[CONV_PLAN_FIELDS];
  if (!conv_plan(DB && std::is_same<WT, __nv_bfloat16>::value, Ch, p.Cs, Co, NR, q.lim, pl))
    return cudaErrorInvalidConfiguration;
  for (int i = 0; i < CONV_PLAN_FIELDS; ++i)
    if (pl[i] != want[i]) return static_cast<cudaError_t>(dparn_attn::PLAN_MISMATCH);
  if (pl[0] == 1) {
    PackParams pk{};
    for (int g = 0; g < (s ? 2 : 1) * NCONV; ++g) {
      pk.w[g] = static_cast<const __nv_bfloat16*>(q.cw[w + g]);
      pk.ws[g][0] = q.cws[2 * (w + g)];
      pk.ws[g][1] = q.cws[2 * (w + g) + 1];
    }
    pk.Ch = Ch;
    pk.Cs = p.Cs;
    pk.Co = Co;
    pk.N = Co / pl[1];
    pk.dst = wp;
    conv_pack_kernel<<<64, 256, 0, stream>>>(pk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    p.wpack = wp;
    wp += pack_elems(Ch, p.Cs, Co);
    const int N = Co / pl[1];
    if (pl[2] == 64)
      return N == 128 ? launch_tc<128, 64>(p, pl, stream) : launch_tc<64, 64>(p, pl, stream);
    if (N == 128) return launch_tc<128, 128>(p, pl, stream);
    return N == 64 ? launch_tc<64, 128>(p, pl, stream) : launch_tc<32, 128>(p, pl, stream);
  }
  p.TM = pl[2];
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<WT, DB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl[4]);
  if (err != cudaSuccess) return err;
  conv_kernel<WT, DB><<<pl[5], THREADS, pl[4], stream>>>(p);
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
  // the dual-path passes' plan (dp_tc::PLAN_FIELDS) after the convs'; on the
  // tensor cores yf / yb and x_scr's bf16 copy live in dp16
  const int* dp_plan = q.plan + dparn_attn::PLAN_FIELDS + NCONV * CONV_PLAN_FIELDS;
  const bool dp_tc_route = dp_plan[0] == 1;
  __nv_bfloat16* dp16 = static_cast<__nv_bfloat16*>(q.dp16);
  void* y_dir = dp_tc_route ? static_cast<void*>(dp16) : static_cast<void*>(d4 + n * q.CH);
  __nv_bfloat16* x16 =
      dp_tc_route && !q.xs_bf16 ? dp16 + (q.kind == 0 ? 2 * n * q.H : 0) : nullptr;
  void* xs = q.xs;
  const void* const* cin = q.cin;
  void* const* cout = q.cout;
  cudaError_t err;
#define CHECK(call) \
  if ((err = (call)) != cudaSuccess) return err
  // ------------------------------------------------ down: d2, d3, d4
  const int* cp = q.plan + dparn_attn::PLAN_FIELDS;   // the six convs' plans
  __nv_bfloat16* wp = static_cast<__nv_bfloat16*>(q.conv_pack);
  CHECK((conv<WT, DB>(q, cp, wp, 0, q.x, q.x_bf16, cin[0], nullptr, 0, nullptr, d2, sb, 1, 0,
                      q.C0, 0, q.C2, stream)));
  CHECK(last_frame<DB>(q, q.x, q.x_bf16, cout[0], q.C0, 1, stream));
  CHECK((conv<WT, DB>(q, cp + 6, wp, 8, d2, sb, cin[1], nullptr, 0, nullptr, d3, sb, 1, 0,
                      q.C2, 0, q.C3, stream)));
  CHECK(last_frame<DB>(q, d2, sb, cout[1], q.C2, 0, stream));
  CHECK((conv<WT, DB>(q, cp + 12, wp, 16, d3, sb, cin[2], nullptr, 0, nullptr, d4, 0, 0, 0,
                      q.C3, 0, q.CH, stream)));
  CHECK(last_frame<DB>(q, d3, sb, cout[2], q.C3, 0, stream));
  CHECK(last_frame<DB>(q, d4, 0, cout[4], q.CH, 1, stream));
  // ------------------------------------------------ the bottleneck
  if (q.kind == 0) {
    dual_path_passes::Chunk c{d4, cin + 7, cin + 9, q.bw, q.s_hh, xs, cout + 7, cout + 9,
                              xs, y_dir, 2, q.F, q.K, q.B, q.CH, q.H, 0, q.c_bf16,
                              q.xs_bf16, q.xs_bf16, dp_plan, q.dp_img, x16};
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
      for (int i = 0; i < dparn_attn::NW; ++i) {
        a.w[i] = w[i];
        a.ws[i][0] = q.bws[2 * (PER * blk + i)];
        a.ws[i][1] = q.bws[2 * (PER * blk + i) + 1];
      }
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
      a.packed = static_cast<__nv_bfloat16*>(q.packed) +
                 (size_t)blk * dparn_wgmma::NPROD * dparn_wgmma::C * dparn_wgmma::C;
      CHECK((dparn_attn::run<WT, DB>(a, q.plan, stream)));
      const void* const* iw = w + dparn_attn::NW;
      dual_path_passes::InterParams ip{xs, xs, cin[7 + blk], cin[9 + blk], cout[7 + blk],
                                       cout[9 + blk], iw[0], iw[1], iw[2], iw[3], iw[4],
                                       iw[5], iw[6], nullptr, 0, q.xs_bf16, q.c_bf16,
                                       q.xs_bf16, q.F, q.K, q.B, q.CH, q.H, 0, 0};
      CHECK((dual_path_passes::run_inter<WT, DB>(
          ip, dp_plan, q.dp_img ? q.dp_img + 3 * blk : nullptr, x16, stream)));
    }
  }
  CHECK(last_frame<DB>(q, xs, q.xs_bf16, cout[3], q.CH, 0, stream));
  // ------------------------------------------------ up: u0, u1, u2
  // resident u0 weights: its float32 inputs (the bottleneck's x_scr, the d4
  // skip) enter as bf16 copies (scratch after u1's), gathered by cp.async
  const void* u0h = xs;
  const void* u0s = d4;
  int u0h_bf16 = q.xs_bf16, u0s_bf16 = 0;
  if (cp[18] == 1) {
    char* half = static_cast<char*>(q.scr) + se * n * (q.C2 + q.C3 + q.C4 + q.Cu2);
    if (!q.xs_bf16) {
      CHECK(dual_path_passes::to_half(xs, 0, half, n * q.CH, stream));
      u0h = half;
      u0h_bf16 = 1;
    }
    CHECK(dual_path_passes::to_half(d4, 0, half + 2 * n * q.CH, n * q.CH, stream));
    u0s = half + 2 * n * q.CH;
    u0s_bf16 = 1;
  }
  CHECK((conv<WT, DB>(q, cp + 18, wp, 24, u0h, u0h_bf16, cin[3], u0s, u0s_bf16, cin[4], u0,
                      sb, 1, 1, q.CH, q.CH, q.C4, stream, q.xs_bf16)));
  CHECK(last_frame<DB>(q, u0, sb, cout[5], q.C4, 0, stream));
  CHECK((conv<WT, DB>(q, cp + 24, wp, 38, u0, sb, cin[5], d3, sb, cin[2], u1, sb, 1, 1, q.C4,
                      q.C3, q.Cu2, stream)));
  CHECK(last_frame<DB>(q, u1, sb, cout[6], q.Cu2, 0, stream));
  CHECK((conv<WT, DB>(q, cp + 30, wp, 52, u1, sb, cin[6], d2, sb, cin[1], q.y, q.x_bf16, 0, 1,
                      q.Cu2, q.C2, q.yC, stream)));
#undef CHECK
  return cudaSuccess;
}

}  // namespace

// geo: kind (0 DPCRN, 1 DPARN), F, K, B, C0, C2, C3, C4, CH, Cu2, yC, H, FFD,
// heads, x_bf16, carries_bf16, weights_bf16, dot_bf16, pe_bf16, xscr_half;
// plan: the attention passes' (dparn_attn::PLAN_FIELDS, zeros for DPCRN),
// then d2, d3, d4, u0, u1, u2's (CONV_PLAN_FIELDS each), then the dual-path
// passes' (dp_tc::PLAN_FIELDS); dp_img / dp16: the dual-path passes' tensor-
// core images and bf16 scratch (dual_path_chunk's img / y_dir + x16); packed: the wgmma
// attention's repacked weights (2 x 13 x 128 x 128 bf16) or null;
// conv_strides / bneck_strides: each weight's (in, out) strides in elements
// (the bottleneck's for DPARN only); conv_pack: the resident convs' weight
// images (pack_elems each, in layer order) or null
extern "C" int masker_center_chunk(const int* geo, const void* x, const void* pe,
                                   const void* const* carries_in, void* const* carries_out,
                                   const void* const* conv_weights,
                                   const void* const* bneck_weights,
                                   const void* const* s_hh, void* y, void* scr,
                                   void* f32_scr, void* xs, const int* plan, void* packed,
                                   const long* conv_strides, const long* bneck_strides,
                                   void* conv_pack, const void* const* dp_img, void* dp16,
                                   void* stream) {
  Center q{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8], geo[9],
           geo[10], geo[11], geo[12], geo[13], geo[14], geo[15], geo[16], geo[17], geo[18],
           geo[19], x, pe, carries_in, carries_out, conv_weights, bneck_weights, s_hh, y,
           scr, static_cast<float*>(f32_scr), xs, plan, packed, conv_strides,
           bneck_strides, conv_pack, dp_img, dp16, limits()};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q.w_bf16)
    err = q.dot_bf16 ? run<__nv_bfloat16, true>(q, s) : run<__nv_bfloat16, false>(q, s);
  else
    err = q.dot_bf16 ? run<float, true>(q, s) : run<float, false>(q, s);
  return static_cast<int>(err);
}

extern "C" const char* masker_error_string(int err) {
  if (err == dp_tc::PLAN_MISMATCH) return "the dual-path plan differs from dual_path_tc.cuh's";
  return dparn_attn::error_string(err);
}
