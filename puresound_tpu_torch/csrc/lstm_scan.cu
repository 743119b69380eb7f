// LSTM recurrence over pre-projected inputs, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of puresound_tpu/ops/lstm_scan_kernel.py
// (lstm_scan, pallas_call at :109): per step t (T-1 .. 0 under `reverse`,
// y stays input-aligned), for every row independently,
//   gates = xp[row, t] + h @ W_hh   (i, f, g, o);  c = f*c + i*g;  h = o*tanh(c)
// h and c are carried in float32; the dot's operands are rounded to the dot
// dtype (float32 or bfloat16) and summed in float32. y is stored in xp's
// dtype (float32 or bfloat16), hT / cT in the state's dtype.
//
// What bounds it on the H100. At DPCRN's serving shapes with 2048 streams
// (H = 128), the intra scan is 4,096 rows x 64 steps and the inter scan
// 131,072 rows x 2 steps: 34.4 GFLOP either way, 0.51 ms at the 67 TFLOP/s
// of float32 without tensor cores, against a 0.34 GB bf16 xp / y stream
// (0.10 ms at 3.35 TB/s). Within a row tile the steps are a serial chain.
//
// The launch plan (ops/lstm_scan_kernel.py `_plan`, computed again by
// make_plan below; a plan that differs is refused) picks one of two routes.
//
// Tensor cores (bfloat16 xp and W_hh, H = 16, 32, 64 or 128: a power of
// two, so that the row swizzle keeps each chunk in its row; every serving
// call of the NS models' fused routes): lstm_scan_tc_kernel. A float32 dot
// of a bfloat16 weight is exact on bfloat16 tensor cores once h is split
// into pieces: hi = bf16(h), mid = bf16(h - hi), lo = h - hi - mid are
// exact (each residual has at most 16, then 8 significant bits), so hi +
// mid + lo == h, and every piece x weight product (8-bit x 8-bit
// significands) is exact in float32. mma.sync m16n8k16 over the three
// pieces with float32 sums thus computes the f32 dot with the same operands
// and cast points; only the order of the float32 sums differs. A bfloat16
// dot takes the hi piece alone, which is its rounding of h. W_hh (4H x H
// bf16, 128 KB at H = 128) stays resident in shared memory for the whole
// call: the wrapper packs it once per weight version into an image whose
// row n is gate column (n / 32) * 8 + n % 8 of gate (n / 8) % 4 (one warp's
// four 8-column n-tiles hold i, f, g, o of the same 8 units, so a (row,
// unit)'s four gate sums land in one thread's accumulators and the cell runs
// there, c in registers), each row's 16-byte chunks XOR-swizzled by the row
// (hopper::swz2), and the bulk copy engine brings it in on an mbarrier. A
// persistent CTA (grid = min(tiles / 2, SMs)) holds two groups of warps;
// each walks its own row tiles of 16 rows through all T steps: per step
// warp w of a group (H / 16 warps) takes 2 unit groups, loads h's pieces
// from the group's double-buffered [pieces][16][H] tile and the weights by
// ldmatrix.x4, runs pieces x 2 x 4 mma.sync a k-step, adds xp[t], runs the
// cell, stores y and writes the new h's pieces
// into the other tile; one named barrier a step and group. xp[row, t, :]
// comes into a padded stage by one bulk copy a row, issued after the barrier
// and awaited on the group's mbarrier before the cells, so it lands under
// the products and the cells read it free of bank conflicts. The next
// tile's carries load under the last cells; its h0 pieces go into the tile
// the next step reads. At the intra shape the 4,096 rows are 128 CTAs, one
// wave; the inter shape's 8,192 tiles are 31-32 a group. A float32 xp's
// stage would not fit beside W_hh: it takes the CUDA cores.
//
// What bounds it (clock marks in a test build of 8 warps, PERF.md): a step of
// the two groups is about 2 x 2,800 clocks of products (the tensor pipes'
// mma.sync rate: about 7 clocks an m16n8k16 a scheduler) and 2 x 2,450 of
// cells (ten transcendental instructions a (row, unit) on the 16-a-clock
// MUFU); the two do not overlap (a group run half a step behind the other
// slowed both).
//
// CUDA cores (float32 W_hh, or other widths): lstm_scan_kernel. A CTA owns
// BT = RG x 8 rows for all T steps (RG up to 512 / H, halved while the CTAs
// would not cover the SMs once). Thread (rg, j) owns hidden unit j of 8
// rows: it computes all four gate columns of unit j for its 8 rows
// (lstm_gates.cuh), so the cell update runs in registers, and c stays in its
// registers for the whole scan. h lives in shared memory, double-buffered
// ([2][H][BT + 4]). W_hh (256 KB in float32, widened by the wrapper) streams
// through shared memory in tiles of 32 rows, copied with cp.async while the
// previous tile is in use. float32 weights stay here: their exact split
// would take nine bf16 products (PERF.md §7).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "lstm_gates.cuh"

namespace {

using namespace lstm_gates;
using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 512;
constexpr int SMEM_MAX = 232448;    // shared memory a block may use on the H100
constexpr int PLAN_FIELDS = 5;      // ops/lstm_scan_kernel.py LstmScanPlan.ints()
constexpr int TC_ROWS = 16;         // the tensor-core route's rows a tile (one m-tile)
constexpr int TC_GROUPS = 2;        // its independent groups of warps a CTA
constexpr int TC_H_MAX = 128;       // its widest H: W_hh's image and the h tiles fit an SM
constexpr int PLAN_MISMATCH = 10001;

// ---------------------------------------------------------------- the plan
// Fields: route (1 tensor cores, 0 CUDA cores), pieces of h a product (3
// under float32 dots, 1 under bfloat16 dots; 0 on the CUDA cores), rows a
// CTA, grid, shared bytes a CTA.

// the tensor-core route: W_hh's image, each group's two h tiles of `pieces`
// pieces and its xp stage (rows of 4H bf16, padded by 16 bytes)
inline long tc_smem(int H, int pieces) {
  return 8L * H * H + TC_GROUPS * (4L * pieces * TC_ROWS * H + TC_ROWS * (8L * H + 16));
}

inline bool make_plan(int B, int H, int x_bf16, int w_bf16, int dot_bf16, int sms,
                      int (&pl)[PLAN_FIELDS]) {
  // H a power of two from 16 up: H / 8 chunks a row, so that swz2's XOR
  // keeps every chunk in its row
  if (x_bf16 && w_bf16 && H >= 16 && H <= TC_H_MAX && (H & (H - 1)) == 0) {
    const int pieces = dot_bf16 ? 1 : 3;
    const int ctas = ((B + TC_ROWS - 1) / TC_ROWS + TC_GROUPS - 1) / TC_GROUPS;
    const int v[PLAN_FIELDS] = {1, pieces, TC_ROWS, ctas < sms ? ctas : sms,
                                (int)tc_smem(H, pieces)};
    for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = v[i];
    return true;
  }
  const int bt = RB * row_groups(B, H, 1, sms);
  const long smem = 4L * (2L * tile_rows<float>(4 * H) * 4 * H + 2L * H * (bt + 4));
  const int v[PLAN_FIELDS] = {0, 0, bt, (B + bt - 1) / bt, (int)smem};
  for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = v[i];
  return smem <= SMEM_MAX;
}

// ------------------------------------------------------------ CUDA cores
__device__ __forceinline__ float ldf(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void stf(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, long i, float v) { p[i] = __float2bfloat16(v); }

struct ScanParams {
  const void* xp;      // [B, T, 4H] (XT)
  const void* h0;      // [B, H]     (state dtype)
  const void* c0;      // [B, H]
  const float* w_hh;   // [H, 4H]
  void* y;             // [B, T, H]  (XT)
  void* hT;            // [B, H]     (state dtype)
  void* cT;            // [B, H]
  int B, T, H, reverse, s_bf16, RG, KT;
};

template <typename XT, bool DOT_BF16>
__global__ void __launch_bounds__(MAX_THREADS) lstm_scan_kernel(ScanParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, G = 4 * H, Tn = p.T, B = p.B;
  const int BT = p.RG * RB, BTP = BT + 4;
  const int tid = threadIdx.x, j = tid % H, rg = tid / H;
  const bool live = rg < p.RG;
  float* w_s = reinterpret_cast<float*>(smem);  // [2][KT][4H]
  float* h_s = w_s + 2 * p.KT * G;              // [2][H][BTP]
  const XT* xp = static_cast<const XT*>(p.xp);
  XT* y = static_cast<XT*>(p.y);
  const long r0 = (long)blockIdx.x * BT + rg * RB;  // this thread's first row
  const int col = rg * RB;

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    c[r] = 0.f;
    if (live) {
      float hv = 0.f;
      if (r0 + r < B) {
        hv = ld(p.h0, (r0 + r) * H + j, p.s_bf16);
        c[r] = ld(p.c0, (r0 + r) * H + j, p.s_bf16);
      }
      h_s[j * BTP + col + r] = rnd<DOT_BF16>(hv);
    }
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < Tn; ++s) {
    const int t = p.reverse ? Tn - 1 - s : s;
    float acc[4][RB];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[q][r] = 0.f;
    gate_dot<float, DOT_BF16>(acc, h_s + cur * H * BTP, BTP, col, p.w_hh, H, H, j, live,
                              w_s, p.KT);
    if (live) {
      float* hn = h_s + (cur ^ 1) * H * BTP + col;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const long row = r0 + r;
        float hv = 0.f;
        if (row < B) {
          const long g = (row * Tn + t) * G + j;
          const float ig = sigm(ldf(xp, g) + acc[0][r]);
          const float fg = sigm(ldf(xp, g + H) + acc[1][r]);
          const float gg = tanhf(ldf(xp, g + 2 * H) + acc[2][r]);
          const float og = sigm(ldf(xp, g + 3 * H) + acc[3][r]);
          c[r] = fg * c[r] + ig * gg;
          hv = og * tanhf(c[r]);
          stf(y, (row * Tn + t) * H + j, hv);
          if (s == Tn - 1) {
            st(p.hT, row * H + j, hv, p.s_bf16);
            st(p.cT, row * H + j, c[r], p.s_bf16);
          }
        }
        hn[j * BTP + r] = rnd<DOT_BF16>(hv);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename XT, bool DOT_BF16>
cudaError_t launch(ScanParams p, const int (&pl)[PLAN_FIELDS], cudaStream_t stream) {
  p.RG = pl[2] / RB;
  p.KT = tile_rows<float>(4 * p.H);
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_kernel<XT, DOT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl[4]);
  if (err != cudaSuccess) return err;
  const int threads = (p.RG * p.H + 31) / 32 * 32;
  lstm_scan_kernel<XT, DOT_BF16><<<pl[3], threads, pl[4], stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------- tensor cores
// 8-unit groups a warp (a group of H / 16 warps covers all H units): with 2,
// the 16 warps at H = 128 ran 3-7 % faster than 8 warps of 4 (test builds)
constexpr int UGW = 2;
constexpr int TC_THREADS_MAX = TC_GROUPS * 32 * TC_H_MAX / (8 * UGW);

struct TcParams {
  const bf16* xp;      // [B, T, 4H]
  const void *h0, *c0; // [B, H]     (state dtype)
  const bf16* img;     // W_hh's image [4H][H], gate-column order, rows swizzled
  bf16* y;             // [B, T, H]
  void *hT, *cT;       // [B, H]     (state dtype)
  int B, T, H, reverse, s_bf16, tiles;
};

// Two groups of warps walk their own tiles of M = 16 rows (group r of CTA b:
// tiles 2b + r, then on by 2 x grid), each with its own double-buffered h
// tiles, xp stage, mbarrier and named barrier: two warps a scheduler hide
// each other's latencies (1.6x one group on the H100). Warp w of a group
// takes UGW unit groups (n-tiles of W_hh's image from w * UGW * 32 on) for
// the tile's 16 rows.
template <int P>
__global__ void __launch_bounds__(TC_THREADS_MAX, 1) lstm_scan_tc_kernel(TcParams p) {
  constexpr int M = TC_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[1 + TC_GROUPS];   // W_hh, each group's xp
  const int H = p.H, T = p.T, G = 4 * H, LH = 2 * H;   // LH: bytes of an H-wide bf16 row
  const int XL = 2 * G + 16;                           // bytes of a staged xp row (padded)
  const int gw = H / (8 * UGW);                        // warps a group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int grp = warp / gw, ug0 = (warp - grp * gw) * UGW;   // group, first unit group
  const bool leader = tid == grp * 32 * gw;                     // the group's first thread
  const uint32_t W_s = hopper::smem_addr(smem), wbytes = (uint32_t)G * LH;
  // this group's h tiles [2][P][M][H] (rows swizzled), then its xp stage [M][XL]
  unsigned char* gs = smem + wbytes + (size_t)grp * (2 * P * M * LH + M * XL);
  bf16* Ah = reinterpret_cast<bf16*>(gs);
  unsigned char* xs = gs + 2 * P * M * LH;
  const uint32_t Ah_s = hopper::smem_addr(Ah), xs_s = hopper::smem_addr(xs);
  const uint32_t wbar = hopper::smem_addr(&bars[0]), xbar = hopper::smem_addr(&bars[1 + grp]);
  if (tid < 1 + TC_GROUPS) {
    hopper::mbar_init(hopper::smem_addr(&bars[tid]), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {   // W_hh's image once: the bulk copy engine
    hopper::mbar_expect_tx(wbar, wbytes);
    for (uint32_t off = 0; off < wbytes; off += 32768)
      hopper::bulk_load(W_s + off, reinterpret_cast<const char*>(p.img) + off,
                        wbytes - off < 32768 ? wbytes - off : 32768, wbar);
  }
  // xp[row, t, :] of a tile's rows into the stage, by the group's leader:
  // one bulk copy a row, completion on the group's mbarrier
  auto stage_xp = [&](int tile, int t) {
    const int rows = min(M, p.B - tile * M);
    hopper::mbar_expect_tx(xbar, rows * 2 * G);
    for (int r = 0; r < rows; ++r)
      hopper::bulk_load(xs_s + r * XL, p.xp + ((long)(tile * M + r) * T + t) * G, 2 * G, xbar);
  };

  // ldmatrix.x4 lanes: A (16 rows x one 32-byte k-step) lane l gives row
  // (l % 8) + 8 ((l / 8) % 2), chunk 2 ks + l / 16 (a0 .. a3); B (two 8-row
  // n-tiles) row (l % 8) + 8 (l / 16), chunk 2 ks + (l / 8) % 2 (b0, b1 of
  // each n-tile). Every swizzled row's chunk is XORed by (row % 8).
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_hi = lane >> 4;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_hi = (lane >> 3) & 1;
  const int lx = lane & 7, mh = min(LH >> 4, 8) - 1;

  // cell (u, hf), element j: row g + 8 hf of the tile, unit (ug0 + u) * 8 +
  // 2 tq + j; accumulator element e = 2 hf + j
  float c[UGW][4];
  float2 hn[UGW][2], cn[UGW][2];   // the next tile's carries
  auto load_carries = [&](int tile) {
#pragma unroll
    for (int u = 0; u < UGW; ++u)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = tile * M + g + 8 * hf;
        const long i = (long)row * H + (ug0 + u) * 8 + 2 * tq;
        const bool in = row < p.B;
        hn[u][hf] = in ? hopper::ld2(p.h0, i, p.s_bf16) : make_float2(0.f, 0.f);
        cn[u][hf] = in ? hopper::ld2(p.c0, i, p.s_bf16) : make_float2(0.f, 0.f);
      }
  };
  // h's pieces of a (row, unit pair) into buffer `buf`: hi = bf16(h), then
  // the bf16 rounding of each exact residual
  auto put_h = [&](int buf, int u, int hf, float a, float b) {
    const int off = hopper::swz2(g + 8 * hf, (ug0 + u) * 8 + 2 * tq, H);
    bf16* dst = Ah + (size_t)buf * P * M * H + off;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
      *reinterpret_cast<__nv_bfloat162*>(dst + q * M * H) = v;
      const float2 f = __bfloat1622float2(v);
      a -= f.x;
      b -= f.y;
    }
  };
  auto take_carries = [&](int buf) {
#pragma unroll
    for (int u = 0; u < UGW; ++u)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        put_h(buf, u, hf, hn[u][hf].x, hn[u][hf].y);
        c[u][2 * hf] = cn[u][hf].x;
        c[u][2 * hf + 1] = cn[u][hf].y;
      }
  };

  const int t0 = p.reverse ? T - 1 : 0, stride = TC_GROUPS * gridDim.x;
  const int tile0 = TC_GROUPS * blockIdx.x + grp;
  if (tile0 < p.tiles) {
    if (leader) stage_xp(tile0, t0);
    load_carries(tile0);
    take_carries(0);
  }
  __syncthreads();
  hopper::mbar_wait(wbar, 0);
  int buf = 0;
  uint32_t phase = 0;   // of the group's xp mbarrier
  for (int tile = tile0; tile < p.tiles; tile += stride) {
    const int ntile = tile + stride;
    for (int s = 0; s < T; ++s) {
      const int t = p.reverse ? T - 1 - s : s;
      const bool last = s == T - 1;
      const uint32_t ab = Ah_s + buf * P * M * LH;
      // the products: acc[u][n] = h @ W_hh over unit group u, gate n
      float acc[UGW][4][4];
#pragma unroll
      for (int u = 0; u < UGW; ++u)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][n][e] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < H / 16; ++ks) {
        unsigned b01[UGW][4], b23[UGW][4];
#pragma unroll
        for (int u = 0; u < UGW; ++u) {
          const uint32_t b0 = W_s + ((ug0 + u) * 32 + b_r) * LH +
                              (((2 * ks + b_hi) ^ lx & mh) << 4);
          hopper::ldsm_x4(b01[u], b0);
          hopper::ldsm_x4(b23[u], b0 + 16 * LH);
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          unsigned a[4];
          hopper::ldsm_x4(a, ab + (q * M + a_r) * LH + (((2 * ks + a_hi) ^ lx & mh) << 4));
#pragma unroll
          for (int u = 0; u < UGW; ++u) {
            hopper::mma_bf16(acc[u][0], a, b01[u][0], b01[u][1]);
            hopper::mma_bf16(acc[u][1], a, b01[u][2], b01[u][3]);
            hopper::mma_bf16(acc[u][2], a, b23[u][0], b23[u][1]);
            hopper::mma_bf16(acc[u][3], a, b23[u][2], b23[u][3]);
          }
        }
      }
      hopper::mbar_wait(xbar, phase);   // xp[t] staged
      // the next tile's carries, in flight under the cells
      if (last && ntile < p.tiles) load_carries(ntile);
      // the cell: gates = xp[t] + h @ W_hh, c in registers
#pragma unroll
      for (int u = 0; u < UGW; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const unsigned char* xr = xs + (g + 8 * hf) * XL + ((ug0 + u) * 8 + 2 * tq) * 2;
          float2 xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[q] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + q * LH));
          float hv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * hf + j;
            const float ig = hopper::sigm_f((j ? xv[0].y : xv[0].x) + acc[u][0][e]);
            const float fg = hopper::sigm_f((j ? xv[1].y : xv[1].x) + acc[u][1][e]);
            const float gg = hopper::tanh_f((j ? xv[2].y : xv[2].x) + acc[u][2][e]);
            const float og = hopper::sigm_f((j ? xv[3].y : xv[3].x) + acc[u][3][e]);
            c[u][e] = fg * c[u][e] + ig * gg;
            hv[j] = og * hopper::tanh_f(c[u][e]);
          }
          const int row = tile * M + g + 8 * hf;
          const int unit = (ug0 + u) * 8 + 2 * tq;
          if (row < p.B) {
            *reinterpret_cast<unsigned*>(p.y + ((long)row * T + t) * H + unit) =
                hopper::bf16x2(hv[0], hv[1]);
            if (last) {
              hopper::st2(p.hT, (long)row * H + unit, hv[0], hv[1], p.s_bf16);
              hopper::st2(p.cT, (long)row * H + unit, c[u][2 * hf], c[u][2 * hf + 1],
                          p.s_bf16);
            }
          }
          if (!last) put_h(buf ^ 1, u, hf, hv[0], hv[1]);
        }
      if (last && ntile < p.tiles) take_carries(buf ^ 1);
      // the next h tile is written, this one and the xp stage read by every
      // warp of the group
      hopper::bar_sync(1 + grp, 32 * gw);
      phase ^= 1;
      buf ^= 1;
      if (leader) {   // the next step's xp into the stage, under its products
        if (!last)
          stage_xp(tile, p.reverse ? t - 1 : t + 1);
        else if (ntile < p.tiles)
          stage_xp(ntile, t0);
      }
    }
  }
}

template <int P>
cudaError_t launch_tc(const TcParams& p, const int (&pl)[PLAN_FIELDS], cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_tc_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl[4]);
  if (err != cudaSuccess) return err;
  lstm_scan_tc_kernel<P><<<pl[3], TC_GROUPS * 32 * (p.H / (8 * UGW)), pl[4], stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// w_hh: W_hh's tensor-core image (bf16 [4H][H]) on that route, else W_hh
// [H, 4H] widened to float32; plan: PLAN_FIELDS ints from `_plan`
extern "C" int lstm_scan(const void* xp, const void* h0, const void* c0, const void* w_hh,
                         void* y, void* hT, void* cT, int B, int T, int H, int reverse,
                         int x_bf16, int s_bf16, int w_bf16, int dot_bf16, const int* plan,
                         void* stream) {
  int pl[PLAN_FIELDS];
  if (!make_plan(B, H, x_bf16, w_bf16, dot_bf16, sm_count(), pl))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  for (int i = 0; i < PLAN_FIELDS; ++i)
    if (pl[i] != plan[i]) return PLAN_MISMATCH;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pl[0]) {
    const TcParams p{static_cast<const bf16*>(xp), h0, c0, static_cast<const bf16*>(w_hh),
                     static_cast<bf16*>(y), hT, cT, B, T, H, reverse, s_bf16,
                     (B + TC_ROWS - 1) / TC_ROWS};
    return static_cast<int>(dot_bf16 ? launch_tc<1>(p, pl, s) : launch_tc<3>(p, pl, s));
  }
  ScanParams p{xp, h0, c0, static_cast<const float*>(w_hh), y, hT, cT, B, T, H,
               reverse, s_bf16, 0, 0};
  if (x_bf16)
    err = dot_bf16 ? launch<bf16, true>(p, pl, s) : launch<bf16, false>(p, pl, s);
  else
    err = dot_bf16 ? launch<float, true>(p, pl, s) : launch<float, false>(p, pl, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_scan_error_string(int err) {
  if (err == PLAN_MISMATCH) return "the launch plan differs from lstm_scan.cu's";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
