// The tensor-core route of the dual-path passes (bf16 weights and dots), for
// Hopper (sm_90a). dual_path_passes.cuh dispatches to it when the launch plan
// says so; see dual_path.cu for what each pass computes and why it is built
// so. Three kernels:
//   dp_chain_kernel<false, Q8>  pass A, the intra scans: clusters of 2 CTAs,
//                               each CTA H/2 hidden units of one direction;
//   dp_proj_tc_kernel<CH>       pass B, the intra projection + LN + residual
//                               on wgmma with the projection weight resident;
//   dp_chain_kernel<true, Q8>   pass C, the inter scan with its projection,
//                               LN and residual after each step.
// Q8 (int8_hh): the recurrent product runs as mma.sync m16n8k32 s8 x s8 ->
// s32 on h quantized as JAX's dot_hh quantizes it, scaled once per column.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "lstm_gates.cuh"

namespace dp_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using lstm_gates::quant_h;
using lstm_gates::rnd;
using lstm_gates::row_groups;
using lstm_gates::sm_count;
using lstm_gates::tile_rows;

constexpr int THREADS = 256;        // pass B: two warpgroups
constexpr int CHAIN_THREADS = 512;  // the chains: 16 warps, 4 of them a scheduler
constexpr int ITEMS = 4;            // (m-tile, unit group) pairs a warp at most (M <= 128, H <= 128)
constexpr int SMEM_MAX = 232448;    // shared memory a block may use on the H100
constexpr int PLAN_FIELDS = 9;      // ops/dual_path_kernel.py DualPathPlan.ints()
constexpr int B_ROWS = 128;         // pass B: rows a tile, two warpgroups of 64
constexpr int RED_BYTES = 1024;     // pass C: the LayerNorm's partial row sums
constexpr int PLAN_MISMATCH = 10001;
constexpr float LN_EPS = 1e-5f;

// ------------------------------------------------------------ small parts
using hopper::cl_arrive;
using hopper::cl_sync;
using hopper::cl_wait;
using hopper::ldsm_x2;
using hopper::ldsm_x4;
using hopper::mma_bf16;
using hopper::mma_s8;
using hopper::sigm_f;
using hopper::tanh_f;

// Element offsets in swizzled [rows][L] tiles: hopper::swz2 (bfloat16) and
// its int8 form (chunk j of row r at j ^ (r % 8), fewer bits where a row has
// fewer than 8 chunks).
using hopper::ld2;
using hopper::st2;
using hopper::swz2;
__device__ __forceinline__ int swz1(int row, int k, int L) {   // int8
  const int nch = L >> 4, m = (nch < 8 ? nch : 8) - 1;
  return row * L + ((((k >> 4) ^ (row & m))) << 4) + (k & 15);
}

// --------------------------------------------------------------- the plan
// The route and layout of a call, computed by ops/dual_path_kernel.py `_plan`
// and again here; a plan that differs is refused. Fields: route (1 tensor
// cores, 0 CUDA cores), then per pass: A rows a tile (row groups of 8 on the
// CUDA cores), A's x buffers, A's shared bytes, B rows a tile (row groups),
// B's shared bytes, C rows a tile (row groups), C's x buffers, C's bytes.

// shared bytes of a chain CTA (pass A, or C with `inter`), in the layout order
__host__ __device__ inline long chain_smem(int CH, int H, int M, int nbx, int q8, int inter) {
  const long NC = 2L * H;
  long b = NC * CH * 2 + NC * H * (q8 ? 1 : 2);    // W_ih, W_hh slices
  b += (long)nbx * M * CH * 2;                      // x tiles
  if (!q8 || inter) b += 2L * M * H * 2;            // bf16 h tiles
  if (q8) b += 2L * M * H;                          // int8 h tiles
  b += NC * 4 * (q8 ? 2 : 1);                       // bias (, int8 scales)
  if (inter) b += (long)CH * H * 2 + RED_BYTES + 6L * CH;   // PW_i^T, LN sums, pb / gamma / beta
  return b;
}
// pass B: the alignment slack, PW^T [CH][2H], two A tiles [128][2H]
inline long proj_smem(int CH, int H) { return 1024 + 4L * CH * H + 2L * B_ROWS * 2 * H * 2; }

inline bool tc_shape(int CH, int H) {
  return (CH == 64 || CH == 128) && (H == 32 || H == 64 || H == 128);
}

// the smallest row tile in [lo, hi] (powers of two) whose tiles, `copies`
// CTAs each, fit the SMs once; hi where none does
inline int pick_rows(long rows, int copies, int lo, int hi, int sms) {
  for (int m = lo; m < hi; m *= 2)
    if ((rows + m - 1) / m * copies <= sms) return m;
  return hi;
}

inline bool make_plan(int F, int K, int B, int CH, int H, int w_bf16, int dot_bf16, int q8,
                      int sms, int (&pl)[PLAN_FIELDS]) {
  const long R = (long)K * B, NR = (long)F * R, NI = (long)F * B;
  if (w_bf16 && dot_bf16 && tc_shape(CH, H)) {
    int ma = pick_rows(R, 4, 16, 128, sms);
    while (ma > 16 && chain_smem(CH, H, ma, 1, q8, 0) > SMEM_MAX) ma /= 2;
    int mc = pick_rows(NI, 2, 32, 64, sms);
    while (mc > 32 && chain_smem(CH, H, mc, 1, q8, 1) > SMEM_MAX) mc /= 2;
    if (chain_smem(CH, H, ma, 1, q8, 0) <= SMEM_MAX &&
        chain_smem(CH, H, mc, 1, q8, 1) <= SMEM_MAX && proj_smem(CH, H) <= SMEM_MAX) {
      const int xa = chain_smem(CH, H, ma, 2, q8, 0) <= SMEM_MAX ? 2 : 1;
      const int xc = chain_smem(CH, H, mc, 2, q8, 1) <= SMEM_MAX ? 2 : 1;
      const int v[PLAN_FIELDS] = {1, ma, xa, (int)chain_smem(CH, H, ma, xa, q8, 0), B_ROWS,
                                  (int)proj_smem(CH, H), mc, xc,
                                  (int)chain_smem(CH, H, mc, xc, q8, 1)};
      for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = v[i];
      return true;
    }
  }
  // the CUDA-core passes (dual_path_passes.cuh run): weights staged in tiles
  const int es = w_bf16 ? 2 : 4;
  const int kt = w_bf16 ? tile_rows<bf16>(4 * H) : tile_rows<float>(4 * H);
  const long w_bytes = (long)es * 2 * kt * 4 * H;
  const int rg_a = row_groups(R, H, 2, sms), rg_b = row_groups(NR, CH, 1, sms);
  const int rg_c = row_groups(NI, H, 1, sms);
  const long bt_a = 8L * rg_a, bt_b = 8L * rg_b, bt_c = 8L * rg_c;
  const long sa = w_bytes + 4L * (CH + 2 * H) * (bt_a + 4);
  const long sb = 4L * (2L * H * (bt_b + 4) + bt_b * (CH + 1) + 2 * bt_b);
  const long sc = w_bytes + 4L * ((CH + 2L * H) * (bt_c + 4) + bt_c * (CH + 1) + 2 * bt_c) +
                  (q8 ? 4L * 2 * (H / 4) * (bt_c + 4) : 0);
  const int v[PLAN_FIELDS] = {0, rg_a, 0, (int)sa, rg_b, (int)sb, rg_c, 0, (int)sc};
  for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = v[i];
  return sa <= SMEM_MAX && sb <= SMEM_MAX && sc <= SMEM_MAX;
}

// the plan the caller passed, checked against this source's
inline cudaError_t check_plan(const int* want, int F, int K, int B, int CH, int H, int w_bf16,
                              int dot_bf16, int q8) {
  int pl[PLAN_FIELDS];
  if (!make_plan(F, K, B, CH, H, w_bf16, dot_bf16, q8, sm_count(), pl))
    return cudaErrorInvalidConfiguration;
  for (int i = 0; i < PLAN_FIELDS; ++i)
    if (pl[i] != want[i]) return static_cast<cudaError_t>(PLAN_MISMATCH);
  return cudaSuccess;
}

// ------------------------------------------------------- A / C: the chains
struct ChainParams {
  const bf16* xa;        // the gate product's x rows, bf16: A [F][R][CH]; C [F][K][B][CH]
  const bf16* w_ih[2];   // images [2 ranks][2H][CH] (A: forward, backward; C: [0])
  const void* w_hh[2];   // images [2 ranks][2H][H], bf16 or int8 (Q8)
  const bf16* bias[2];   // [4H], torch's gate order i, f, g, o
  const float* s_hh[2];  // Q8: w_hh's column scales / 127^2 [4H]
  bf16* y_dir;           // A: yf / yb [2][F][R][H]
  void* x;               // C: x_scr [F][K][B][CH] (residual in; out unless last)
  void* y;               // C: the last block's output
  bf16* x16_out;         // C: the next pass A's bf16 copy of what it writes, or null
  const void *h_in, *c_in;
  void *h_out, *c_out;   // C: [F][B][H] (state dtype)
  const bf16* pw;        // C: PW_i^T [CH][H]
  const bf16 *pb, *lg, *lb;
  int last, y_bf16, s_bf16, xs_bf16;
  int F, K, B, R, CH, H, M, nbx;
};

// One cluster of 2 CTAs walks row tiles of M rows of one direction (pass A:
// blockIdx.y) through all their steps. CTA `rank` owns hidden units
// [rank * H/2, (rank + 1) * H/2): its gate columns (n = unit group * 32 +
// gate * 8 + unit in group, the image's order) of W_ih and W_hh stay resident
// in shared memory. A step: warp w of 16 takes (16-row m-tile, 8-unit group)
// pairs w, w + 16, ... two at a time (the pair's A fragment feeds both); for
// each, the four gate n-tiles of [x_t | h] @ W run as mma.sync on fragments
// loaded by ldmatrix from the swizzled tiles, so i, f, g, o of a (row, unit)
// land in one thread's accumulators; the cell update runs there, c stays in
// registers, and h goes straight into the next h tile of both CTAs
// (distributed shared memory). One cluster barrier a step: h tiles are
// double-buffered, x_t tiles come in by cp.async a step ahead (or, with one
// buffer, right after the products). On the H100 a step is bounded by the
// issue of the fragment loads and mma.sync (16 warps, 4 a scheduler) and by
// the barrier's round trip (about 1,400 clocks): see PERF.md.
template <bool INTER, bool Q8>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(CHAIN_THREADS, 1)
    dp_chain_kernel(ChainParams p) {
  constexpr int THREADS = CHAIN_THREADS, NWARP = CHAIN_THREADS / 32;
  // pairs a warp: pass A's tiles reach 128 rows, pass C's 64
  constexpr int NIT = INTER ? ITEMS / 2 : ITEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CH = p.CH, H = p.H, M = p.M, U = H / 2, NC = 2 * H, MT = M / 16;
  const int npairs = MT * (U / 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  unsigned char* sp = smem;
  bf16* Wx = reinterpret_cast<bf16*>(sp);
  sp += (size_t)NC * CH * 2;
  unsigned char* Wh = sp;
  sp += (size_t)NC * H * (Q8 ? 1 : 2);
  bf16* Ax = reinterpret_cast<bf16*>(sp);
  sp += (size_t)p.nbx * M * CH * 2;
  bf16* Ah = reinterpret_cast<bf16*>(sp);
  if (INTER || !Q8) sp += (size_t)2 * M * H * 2;
  signed char* Aq = reinterpret_cast<signed char*>(sp);
  if (Q8) sp += (size_t)2 * M * H;
  float* bias_s = reinterpret_cast<float*>(sp);
  sp += (size_t)NC * 4;
  float* scale_s = reinterpret_cast<float*>(sp);
  if (Q8) sp += (size_t)NC * 4;
  bf16* PW = reinterpret_cast<bf16*>(sp);
  if (INTER) sp += (size_t)CH * H * 2;
  float* red = reinterpret_cast<float*>(sp);
  bf16* vec_s = reinterpret_cast<bf16*>(sp + RED_BYTES);   // pass C: pb, gamma, beta [3][CH]

  const int dir = INTER ? 0 : blockIdx.y;
  const int dir_rows = INTER ? p.F * p.B : p.R;
  const int tiles = (dir_rows + M - 1) / M;
  const int steps = INTER ? p.K : p.F;
  const int n_clusters = gridDim.x / 2;

  // the resident weights: 16-byte cp.async chunks into swizzled rows
  {
    const bf16* src = p.w_ih[dir] + (size_t)rank * NC * CH;
    for (int c = tid; c < NC * (CH / 8); c += THREADS) {
      const int n = c / (CH / 8), k = (c - n * (CH / 8)) * 8;
      hopper::cp_async16(hopper::smem_addr(Wx + swz2(n, k, CH)), src + (size_t)n * CH + k);
    }
    if (Q8) {
      const signed char* s8 = static_cast<const signed char*>(p.w_hh[dir]) + (size_t)rank * NC * H;
      signed char* d8 = reinterpret_cast<signed char*>(Wh);
      for (int c = tid; c < NC * (H / 16); c += THREADS) {
        const int n = c / (H / 16), k = (c - n * (H / 16)) * 16;
        hopper::cp_async16(hopper::smem_addr(d8 + swz1(n, k, H)), s8 + (size_t)n * H + k);
      }
    } else {
      const bf16* sh = static_cast<const bf16*>(p.w_hh[dir]) + (size_t)rank * NC * H;
      bf16* dh = reinterpret_cast<bf16*>(Wh);
      for (int c = tid; c < NC * (H / 8); c += THREADS) {
        const int n = c / (H / 8), k = (c - n * (H / 8)) * 8;
        hopper::cp_async16(hopper::smem_addr(dh + swz2(n, k, H)), sh + (size_t)n * H + k);
      }
    }
    if (INTER)
      for (int c = tid; c < CH * (H / 8); c += THREADS) {
        const int n = c / (H / 8), k = (c - n * (H / 8)) * 8;
        hopper::cp_async16(hopper::smem_addr(PW + swz2(n, k, H)), p.pw + (size_t)n * H + k);
      }
    for (int n = tid; n < NC; n += THREADS) {
      const int unit = rank * U + (n >> 5) * 8 + (n & 7), q = (n >> 3) & 3;
      bias_s[n] = __bfloat162float(p.bias[dir][q * H + unit]);
      if (Q8) scale_s[n] = p.s_hh[dir][q * H + unit];
    }
    if (INTER)
      for (int n = tid; n < CH; n += THREADS) {
        vec_s[n] = p.pb[n];
        vec_s[CH + n] = p.lg[n];
        vec_s[2 * CH + n] = p.lb[n];
      }
    lstm_gates::cp_async_commit();   // the first x tile's wait covers them
  }

  // x rows of (tile, step) into a swizzled [M][CH] tile; rows past the
  // direction's end are zeros
  auto load_x = [&](int tile, int s, bf16* dst) {
    for (int c = tid; c < M * (CH / 8); c += THREADS) {
      const int m = c / (CH / 8), k = (c - m * (CH / 8)) * 8;
      const int i = tile * M + m;
      bf16* d = dst + swz2(m, k, CH);
      if (i >= dir_rows) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
        continue;
      }
      size_t row;
      if (INTER) {
        const int f = i / p.B, b = i - f * p.B;
        row = ((size_t)f * p.K + s) * p.B + b;
      } else {
        row = (size_t)(dir ? p.F - 1 - s : s) * p.R + i;
      }
      hopper::cp_async16(hopper::smem_addr(d), p.xa + row * CH + k);
    }
    lstm_gates::cp_async_commit();
  };

  // ldmatrix.x4 lanes: A (16 rows x one 32-byte k-step) lane l gives row
  // (l % 8) + 8 ((l / 8) % 2), chunk 2 ks + l / 16 (a0 .. a3); B (two 8-row
  // n-tiles) row (l % 8) + 8 (l / 16), chunk 2 ks + (l / 8) % 2 (b0, b1 of
  // each n-tile). Every swizzled row's chunk is XORed by (row % 8).
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_hi = lane >> 4;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_hi = (lane >> 3) & 1;
  const int lx = lane & 7;
  const int LX = CH * 2, LH = H * (Q8 ? 1 : 2);   // row bytes of the x / h operands
  const int mx = min(LX >> 4, 8) - 1, mh = min(LH >> 4, 8) - 1;
  const uint32_t Wx_s = hopper::smem_addr(Wx), Wh_s = hopper::smem_addr(Wh);
  const uint32_t Ax_s = hopper::smem_addr(Ax);
  const uint32_t Ah_s = hopper::smem_addr(Q8 ? static_cast<void*>(Aq) : static_cast<void*>(Ah));

  // pass C's projection runs on warps 0-7: warp (mtl, wpt) takes m-tile mtl
  // of this CTA's half of the rows and ntw 8-column n-tiles
  const int half = M / 2, MP = INTER ? half / 16 : 1, nwp = 8 / MP, ntw = CH / 8 / nwp;
  const int mtl = warp % MP, wpt = warp / MP, rl0 = rank * half + mtl * 16;
  auto vec = [&](int which, int n) { return __bfloat162float(vec_s[which * CH + n]); };

  // pass C: the carries of tile t, h0 (every unit) and c0 (own cells), into
  // registers, every load of a thread issued before the first use
  constexpr int HP = INTER ? 64 * 64 / CHAIN_THREADS : 1;   // unit pairs a thread
  float2 hp[HP];
  float c[NIT][4];
  auto load_carries = [&](int t) {
    const int nbt = min(M, dir_rows - t * M);
#pragma unroll
    for (int u = 0; u < HP; ++u) {
      const int idx = tid + u * THREADS, m = idx / U, j = 2 * (idx - m * U);
      hp[u] = make_float2(0.f, 0.f);
      if (idx < M * U && m < nbt) hp[u] = ld2(p.h_in, (long)(t * M + m) * H + j, p.s_bf16);
    }
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int pi = warp + NWARP * it;
      const int m0 = (pi % MT) * 16, unit = rank * U + (pi / MT) * 8 + 2 * tq;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = m0 + g + 8 * h2;
        const float2 v = pi < npairs && m < nbt
                             ? ld2(p.c_in, (long)(t * M + m) * H + unit, p.s_bf16)
                             : make_float2(0.f, 0.f);
        c[it][2 * h2] = v.x;
        c[it][2 * h2 + 1] = v.y;
      }
    }
  };

  // The h tiles alternate with the steps across the tiles too (step gs of
  // this cluster reads tile gs % 2 and writes the other): a tile's h0 goes
  // into the tile its last step's projection read (this CTA's own reads,
  // ordered by __syncthreads), and the peer's first exchange of the next tile
  // goes into the one that step's products read, before its barrier. So no
  // barrier is needed between tiles, only this one: the peer has started.
  int xb = 0;
  if ((int)(blockIdx.x / 2) < tiles) load_x(blockIdx.x / 2, 0, Ax);
  cl_sync();
  for (int tile = blockIdx.x / 2; tile < tiles; tile += n_clusters) {
    const int nb = min(M, dir_rows - tile * M);
    const int gs0 = (tile - (int)(blockIdx.x / 2)) / n_clusters * steps;   // the cluster's steps so far
    const int h0b = gs0 & 1;   // the h tile of the tile's first step
    if (INTER) {
      load_carries(tile);
    } else {
#pragma unroll
      for (int it = 0; it < NIT; ++it)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[it][e] = 0.f;
    }
    if (INTER) {
      // h0 rounded (and quantized) into the first step's h tile
#pragma unroll
      for (int u = 0; u < HP; ++u) {
        const int idx = tid + u * THREADS, m = idx / U, j = 2 * (idx - m * U);
        if (idx >= M * U) break;
        *reinterpret_cast<unsigned*>(Ah + h0b * M * H + swz2(m, j, H)) =
            hopper::bf16x2(hp[u].x, hp[u].y);
        if (Q8) {
          signed char* q = Aq + h0b * M * H + swz1(m, j, H);
          q[0] = quant_h(hp[u].x);
          q[1] = quant_h(hp[u].y);
        }
      }
    } else {
      unsigned char* h0t = (Q8 ? reinterpret_cast<unsigned char*>(Aq)
                               : reinterpret_cast<unsigned char*>(Ah)) + h0b * M * LH;
      for (int idx = tid; idx < M * LH / 16; idx += THREADS)
        reinterpret_cast<uint4*>(h0t)[idx] = make_uint4(0, 0, 0, 0);
    }
    lstm_gates::cp_async_wait<0>();
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      const int gs = gs0 + s;
      const int cur = gs & 1, nxt = cur ^ 1;
      int ntile = tile, ns = s + 1;
      if (ns == steps) {
        ntile = tile + n_clusters;
        ns = 0;
      }
      const bool more_x = ntile < tiles;
      const uint32_t axc = Ax_s + xb * M * LX, ahc = Ah_s + cur * M * LH;
      if (p.nbx == 2 && more_x) load_x(ntile, ns, Ax + (xb ^ 1) * M * CH);
      const int f = dir ? p.F - 1 - s : s;
      // two pairs at once: pairs w and w + 16 of a warp share their m-tile
      // (MT divides 16), so each k-step's A fragment feeds 8 products
#pragma unroll
      for (int it = 0; it < NIT; it += 2) {
        const int pa = warp + NWARP * it;
        if (pa >= npairs) break;
        const bool two = pa + NWARP < npairs;   // warp-uniform
        const int m0 = (pa % MT) * 16;
        int ug[2], n0[2];
        ug[0] = pa / MT;
        ug[1] = (pa + NWARP) / MT;
        float acc[2][4][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          n0[u] = ug[u] * 32;
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[u][q][e] = u == 0 || two ? bias_s[n0[u] + q * 8 + 2 * tq + (e & 1)] : 0.f;
        }
        // x_t @ W_ih
        {
          const uint32_t a0 = axc + (m0 + a_r) * LX;
#pragma unroll 4
          for (int ks = 0; ks < CH / 16; ++ks) {
            unsigned a[4];
            ldsm_x4(a, a0 + (((2 * ks + a_hi) ^ lx & mx) << 4));
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u == 1 && !two) break;
              const uint32_t b0 = Wx_s + (n0[u] + b_r) * LX + (((2 * ks + b_hi) ^ lx & mx) << 4);
              unsigned b01[4], b23[4];
              ldsm_x4(b01, b0);
              ldsm_x4(b23, b0 + 16 * LX);
              mma_bf16(acc[u][0], a, b01[0], b01[1]);
              mma_bf16(acc[u][1], a, b01[2], b01[3]);
              mma_bf16(acc[u][2], a, b23[0], b23[1]);
              mma_bf16(acc[u][3], a, b23[2], b23[3]);
            }
          }
        }
        // h @ W_hh: bf16, or int8 summed exactly and scaled once
        {
          const uint32_t a0 = ahc + (m0 + a_r) * LH;
          if (Q8) {   // one pair at a time: 16 integer accumulators
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u == 1 && !two) break;
              int isum[4][4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) isum[q][e] = 0;
#pragma unroll 2
              for (int ks = 0; ks < H / 32; ++ks) {
                unsigned a[4], b01[4], b23[4];
                ldsm_x4(a, a0 + (((2 * ks + a_hi) ^ lx & mh) << 4));
                const uint32_t b0 = Wh_s + (n0[u] + b_r) * LH + (((2 * ks + b_hi) ^ lx & mh) << 4);
                ldsm_x4(b01, b0);
                ldsm_x4(b23, b0 + 16 * LH);
                mma_s8(isum[0], a, b01[0], b01[1]);
                mma_s8(isum[1], a, b01[2], b01[3]);
                mma_s8(isum[2], a, b23[0], b23[1]);
                mma_s8(isum[3], a, b23[2], b23[3]);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[u][q][e] += (float)isum[q][e] * scale_s[n0[u] + q * 8 + 2 * tq + (e & 1)];
            }
          } else {
#pragma unroll 4
            for (int ks = 0; ks < H / 16; ++ks) {
              unsigned a[4];
              ldsm_x4(a, a0 + (((2 * ks + a_hi) ^ lx & mh) << 4));
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                if (u == 1 && !two) break;
                const uint32_t b0 = Wh_s + (n0[u] + b_r) * LH + (((2 * ks + b_hi) ^ lx & mh) << 4);
                unsigned b01[4], b23[4];
                ldsm_x4(b01, b0);
                ldsm_x4(b23, b0 + 16 * LH);
                mma_bf16(acc[u][0], a, b01[0], b01[1]);
                mma_bf16(acc[u][1], a, b01[2], b01[3]);
                mma_bf16(acc[u][2], a, b23[0], b23[1]);
                mma_bf16(acc[u][3], a, b23[2], b23[3]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const int ci = it + u;   // this pair's cells in c
          // the cell update: element e is row m0 + g + 8 (e / 2), unit col + e % 2
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ig = sigm_f(acc[u][0][e]), fg = sigm_f(acc[u][1][e]);
            const float gg = tanh_f(acc[u][2][e]), og = sigm_f(acc[u][3][e]);
            c[ci][e] = fg * c[ci][e] + ig * gg;
            hv[e] = og * tanh_f(c[ci][e]);
          }
          const int col = rank * U + ug[u] * 8 + 2 * tq;
          // h into the next h tile of both CTAs
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (INTER || !Q8) {
              bf16* dst = cluster.map_shared_rank(Ah + nxt * M * H, r);
              *reinterpret_cast<unsigned*>(dst + swz2(m0 + g, col, H)) =
                  hopper::bf16x2(hv[0], hv[1]);
              *reinterpret_cast<unsigned*>(dst + swz2(m0 + g + 8, col, H)) =
                  hopper::bf16x2(hv[2], hv[3]);
            }
            if (Q8) {
              signed char* dq = cluster.map_shared_rank(Aq + nxt * M * H, r);
              const unsigned short lo =
                  (unsigned char)quant_h(hv[0]) | ((unsigned)(unsigned char)quant_h(hv[1]) << 8);
              const unsigned short hi =
                  (unsigned char)quant_h(hv[2]) | ((unsigned)(unsigned char)quant_h(hv[3]) << 8);
              *reinterpret_cast<unsigned short*>(dq + swz1(m0 + g, col, H)) = lo;
              *reinterpret_cast<unsigned short*>(dq + swz1(m0 + g + 8, col, H)) = hi;
            }
          }
          if (!INTER) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int m = m0 + g + 8 * h2;
              if (m < nb)
                *reinterpret_cast<unsigned*>(
                    p.y_dir + (((size_t)dir * p.F + f) * p.R + tile * M + m) * H + col) =
                    hopper::bf16x2(hv[2 * h2], hv[2 * h2 + 1]);
            }
          } else if (s == steps - 1) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int m = m0 + g + 8 * h2;
              if (m < nb) {
                const long i = (long)(tile * M + m) * H + col;
                st2(p.h_out, i, hv[2 * h2], hv[2 * h2 + 1], p.s_bf16);
                st2(p.c_out, i, c[ci][2 * h2], c[ci][2 * h2 + 1], p.s_bf16);
              }
            }
          }
        }
      }
      if (p.nbx == 1 && more_x) {
        __syncthreads();   // every warp is done with the one x tile
        load_x(ntile, ns, Ax);
      }
      lstm_gates::cp_async_wait<0>();
      cl_arrive();   // this step's h is in both CTAs' next h tile
      // pass C: the residual rows of this warp's projection outputs, read
      // while the barrier completes
      float2 xr[4][2];
      long ei[2];
      if (INTER && warp < 8) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int m = rl0 + g + 8 * h2, i = tile * M + m, fr = i / p.B;
          ei[h2] = (((long)fr * p.K + s) * p.B + i - fr * p.B) * CH + wpt * ntw * 8 + 2 * tq;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xr[j][h2] = j < ntw && m < nb ? ld2(p.x, ei[h2] + 8 * j, p.xs_bf16)
                                          : make_float2(0.f, 0.f);
        }
      }
      cl_wait();
      if (p.nbx == 2) xb ^= 1;
      if constexpr (INTER) {
        // per frame k: x += LN(h @ PW_i + pb) on this CTA's half of the rows
        float acc[4][4];
        if (warp < 8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = (wpt * ntw + j) * 8 + 2 * tq;
            acc[j][0] = acc[j][2] = j < ntw ? vec(0, n) : 0.f;
            acc[j][1] = acc[j][3] = j < ntw ? vec(0, n + 1) : 0.f;
          }
          const int LP = H * 2, mp = min(LP >> 4, 8) - 1;
          const uint32_t a0 = hopper::smem_addr(Ah) + nxt * M * LP + (rl0 + a_r) * LP;
          const uint32_t b0 = hopper::smem_addr(PW) + (wpt * ntw * 8 + b_r) * LP;
#pragma unroll 4
          for (int ks = 0; ks < H / 16; ++ks) {
            unsigned a[4];
            ldsm_x4(a, a0 + (((2 * ks + a_hi) ^ lx & mp) << 4));
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
              if (j >= ntw) break;
              unsigned b[4];
              if (j + 1 < ntw) {
                ldsm_x4(b, b0 + j * 8 * LP + (((2 * ks + b_hi) ^ lx & mp) << 4));
                mma_bf16(acc[j + 1], a, b[2], b[3]);
              } else {   // one n-tile left: lanes 0-15 give its two matrices
                ldsm_x2(b, b0 + j * 8 * LP + (((2 * ks + b_hi) ^ lx & mp) << 4));
              }
              mma_bf16(acc[j], a, b[0], b[1]);
            }
          }
        }
        // two-pass LayerNorm over CH: quad sums, then the nwp warps of a row
        // in a fixed order through shared memory
        float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
        for (int pass = 0; pass < 2; ++pass) {
          float* rp = red + pass * (RED_BYTES / 8);
          if (warp < 8) {
            float sv[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= ntw) break;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v = pass ? acc[j][e] - mean[e >> 1] : acc[j][e];
                sv[e >> 1] += pass ? v * v : v;
              }
            }
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              sv[h2] += __shfl_xor_sync(0xffffffffu, sv[h2], 1);
              sv[h2] += __shfl_xor_sync(0xffffffffu, sv[h2], 2);
            }
            if (tq == 0) {
              rp[wpt * half + mtl * 16 + g] = sv[0];
              rp[wpt * half + mtl * 16 + g + 8] = sv[1];
            }
          }
          __syncthreads();
          if (warp < 8) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              float t = 0.f;
              for (int w = 0; w < nwp; ++w) t += rp[w * half + mtl * 16 + g + 8 * h2];
              if (pass)
                rstd[h2] = rsqrtf(t / CH + LN_EPS);
              else
                mean[h2] = t / CH;
            }
          }
        }
        if (warp < 8) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            if (rl0 + g + 8 * h2 >= nb) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= ntw) break;
              const int n = (wpt * ntw + j) * 8 + 2 * tq;
              float v0 = xr[j][h2].x +
                         ((acc[j][2 * h2] - mean[h2]) * rstd[h2] * vec(1, n) + vec(2, n));
              float v1 = xr[j][h2].y + ((acc[j][2 * h2 + 1] - mean[h2]) * rstd[h2] *
                                            vec(1, n + 1) + vec(2, n + 1));
              if (p.xs_bf16) {   // xscr_half: the scratch's rounding, y too
                v0 = rnd<true>(v0);
                v1 = rnd<true>(v1);
              }
              const long e = ei[h2] + 8 * j;
              if (p.last)
                st2(p.y, e, v0, v1, p.y_bf16);
              else
                st2(p.x, e, v0, v1, p.xs_bf16);
              if (p.x16_out != nullptr)
                *reinterpret_cast<unsigned*>(p.x16_out + e) = hopper::bf16x2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------- B: projection + LN + residual
struct ProjParams {
  const bf16* y_dir;     // yf / yb [2][NR][H]
  const void* res;       // [NR][CH] residual source
  void* out;             // [NR][CH] x_scr
  bf16* x16;             // its bf16 copy for pass C, or null
  const bf16* pw;        // [CH][2H] image: [PW_f; PW_b]^T
  const bf16 *pb, *g, *b;
  long NR;
  int res_bf16, out_bf16, H;
};

// Persistent CTAs of two warpgroups walk tiles of 128 rows: [yf | yb] rows
// gathered by cp.async into a swizzled K-major tile (two buffers: the next
// tile's gather overlaps this one's products), then 64 rows x CH a
// warpgroup on wgmma against the resident PW^T; a row's CH sums lie in one
// quad, so the two-pass LayerNorm is quad shuffles in registers.
template <int N>
__global__ void __launch_bounds__(THREADS, 1) dp_proj_tc_kernel(ProjParams p) {
  extern __shared__ __align__(16) unsigned char pj_smem[];
  const uint32_t raw = hopper::smem_addr(pj_smem);
  const uint32_t Ws = raw + ((1024 - (raw & 1023)) & 1023);   // swizzled tiles: 1,024-aligned
  const int H = p.H, K = 2 * H;
  const uint32_t ring = Ws + N * K * 2;
  const uint32_t buf_bytes = B_ROWS * K * 2;
  const int tid = threadIdx.x, wg = tid / 128, w = tid % 128 / 32, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long tiles = (p.NR + B_ROWS - 1) / B_ROWS;
  for (int c = tid; c < N * K / 8; c += THREADS) {
    const int n = c / (K / 8), k = (c - n * (K / 8)) * 8;
    hopper::cp_async16(Ws + hopper::swz(n, k, N, K), p.pw + (size_t)n * K + k);
  }
  auto gather = [&](long t, uint32_t dst) {
    for (int c = tid; c < B_ROWS * K / 8; c += THREADS) {
      const int r = c / (K / 8), k = (c - r * (K / 8)) * 8;
      const long row = t * B_ROWS + r;
      const uint32_t d = dst + hopper::swz(r, k, B_ROWS, K);
      if (row >= p.NR) {
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(d), "r"(0) : "memory");
        continue;
      }
      const bf16* src = k < H ? p.y_dir + row * H + k : p.y_dir + (p.NR + row) * H + k - H;
      hopper::cp_async16(d, src);
    }
  };
  if (blockIdx.x < tiles) gather(blockIdx.x, ring);
  lstm_gates::cp_async_commit();
  float acc[N / 2];
  int i = 0;
  for (long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    lstm_gates::cp_async_wait<0>();
    hopper::fence_async_smem();   // the gathered rows (and weights) visible to wgmma
    __syncthreads();              // ... and both warpgroups' last products done
    const uint32_t a_s = ring + (i & 1) * buf_bytes;
    hopper::pin(acc);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks)
      hopper::wgmma_ss<N>(acc, hopper::desc_tile(a_s, 64 * wg, ks, B_ROWS, K),
                          hopper::desc_tile(Ws, 0, ks, N, K), ks > 0);
    hopper::wg_commit();
    if (t + gridDim.x < tiles) gather(t + gridDim.x, ring + ((i + 1) & 1) * buf_bytes);
    lstm_gates::cp_async_commit();
    hopper::wg_wait0();
    hopper::pin(acc);
    // element 4j + 2h + e: row 64 wg + 16 w + g + 8h, column 8j + 2tq + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = t * B_ROWS + 64 * wg + 16 * w + g + 8 * h;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[4 * j + 2 * h + e] += __bfloat162float(p.pb[8 * j + 2 * tq + e]);
          s += acc[4 * j + 2 * h + e];
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mean = s / N;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[4 * j + 2 * h + e] - mean;
          v += d * d;
        }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const float rstd = rsqrtf(v / N + LN_EPS);
      if (row >= p.NR) continue;
      float2 xv[N / 8];   // the row's residual, every load before the first store
#pragma unroll
      for (int j = 0; j < N / 8; ++j) xv[j] = ld2(p.res, row * N + 8 * j + 2 * tq, p.res_bf16);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * tq;
        const long ei = row * N + n;
        const float v0 = xv[j].x + ((acc[4 * j + 2 * h] - mean) * rstd *
                                        __bfloat162float(p.g[n]) + __bfloat162float(p.b[n]));
        const float v1 = xv[j].y + ((acc[4 * j + 2 * h + 1] - mean) * rstd *
                                        __bfloat162float(p.g[n + 1]) +
                                    __bfloat162float(p.b[n + 1]));
        st2(p.out, ei, v0, v1, p.out_bf16);
        if (p.x16 != nullptr)
          *reinterpret_cast<unsigned*>(p.x16 + ei) = hopper::bf16x2(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------------- host
template <typename Kern>
cudaError_t allow(Kern kern, long bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// pass A (`inter` 0, both directions) or C over its row tiles
template <bool Q8>
cudaError_t launch_chain(const ChainParams& c, bool inter, long smem, cudaStream_t stream) {
  const int sms = sm_count();
  const long rows = inter ? (long)c.F * c.B : c.R;
  const long tiles = (rows + c.M - 1) / c.M;
  const int dirs = inter ? 1 : 2;
  const long fit = sms / 2 / dirs;   // clusters of 2 per direction, one CTA an SM
  const unsigned clusters = (unsigned)(tiles < fit ? tiles : (fit < 1 ? 1 : fit));
  cudaError_t err;
  if (inter) {
    if ((err = allow(dp_chain_kernel<true, Q8>, smem)) != cudaSuccess) return err;
    dp_chain_kernel<true, Q8><<<dim3(2 * clusters, 1), CHAIN_THREADS, smem, stream>>>(c);
  } else {
    if ((err = allow(dp_chain_kernel<false, Q8>, smem)) != cudaSuccess) return err;
    dp_chain_kernel<false, Q8><<<dim3(2 * clusters, 2), CHAIN_THREADS, smem, stream>>>(c);
  }
  return cudaGetLastError();
}

inline cudaError_t launch_chain_q(const ChainParams& c, bool inter, bool q8, long smem,
                                  cudaStream_t stream) {
  return q8 ? launch_chain<true>(c, inter, smem, stream)
            : launch_chain<false>(c, inter, smem, stream);
}

inline cudaError_t launch_proj(const ProjParams& b, int CH, long smem, cudaStream_t stream) {
  const int sms = sm_count();
  const long tiles = (b.NR + B_ROWS - 1) / B_ROWS;
  const unsigned ctas = (unsigned)(tiles < sms ? tiles : sms);
  cudaError_t err;
  if (CH == 128) {
    if ((err = allow(dp_proj_tc_kernel<128>, smem)) != cudaSuccess) return err;
    dp_proj_tc_kernel<128><<<ctas, THREADS, smem, stream>>>(b);
  } else {
    if ((err = allow(dp_proj_tc_kernel<64>, smem)) != cudaSuccess) return err;
    dp_proj_tc_kernel<64><<<ctas, THREADS, smem, stream>>>(b);
  }
  return cudaGetLastError();
}

}  // namespace dp_tc
