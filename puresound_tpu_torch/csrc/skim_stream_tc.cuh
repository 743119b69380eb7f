// The tensor-core route of fused_skim_frames (bf16 dots), for Hopper
// (sm_90a); skim_stream.cu says what the kernel computes and dispatches here
// when the launch plan says so (make_plan below, computed first by
// ops/skim_stream_kernel.py `_plan`).
//
// A cluster of K CTAs walks tiles of M streams (M = 16 or 32 rows) through
// every frame and block. CTA `rank` owns the hidden units [rank * U, (rank +
// 1) * U), U = H / K, and so the 4U gate columns of those units (in two
// passes of 2U where 4U is 512, at M = 16): every
// (row, unit)'s i, f, g, o sums land in one thread's mma.sync accumulators
// (the image orders a unit quad's columns i, f | g, o over two 8-column
// n-tiles), and its c stays in shared memory. Everything else a block step
// needs runs in every CTA of the cluster on the same values: the LayerNorms,
// FiLM's two C x C dots or the Gate's four products, the projection and its
// LayerNorm and residual. So the only exchange is h: each CTA keeps its
// slice of every block's h, and a product that needs the full h of block i
// (W_hh at the next frame, the projection now) gathers the K slices through
// distributed shared memory into a local swizzled tile. One cluster barrier
// a block step (after the cell writes its slice, before the projection's
// gather); the next block's h @ W_hh runs between its arrive and its wait.
//
// The weights do not fit: a flagship block holds 896 KB in bf16 (3.5 MB for
// four), so every weight a CTA needs streams from L2 at every block step
// through a ring of D stages of 16 KB (256 rows of 64 bytes), brought in by
// the bulk copy engine on full / empty mbarriers; thread 0 refills a slot
// once every warp has released its stage, at the next round of stages or
// the end of the product.
// A CTA's stages come from its own image, packed once per weight version by
// the wrapper in exactly the order the kernel consumes them (`source`): per
// block, W_hh's slice, the previous block's projection, the fusion's
// products, W_ih's slice. A stage holds 256 / N k-slices of a product of N
// columns (32 k of bf16, or 64 k of int8, a 64-byte row per column), chunks
// XOR-swizzled by (row / 2) % 4, so the ldmatrix.x4 loads of the B fragments
// are free of bank conflicts; the A tiles swizzle their 16-byte chunks by
// row % 8 (as dual_path_tc.cuh's). Warp w of 8 takes the columns w * N / 8
// .. of a product for all M rows. On the H100 the serial chain of block
// steps, each a latency-bound run of stages, gathers and row passes, sets
// the time, not the tensor cores or the feed (PERF.md §6).
//
// int8 (Q bit 0 int8_hh, bit 1 int8_full): the quantized products run on
// mma.sync m16n8k32 s8 x s8 -> s32, exact, each sum scaled once per column
// (and per row by amax / 127 for the dynamic activations): bit for bit the
// __dp4a route's sums. h takes its int8 form (clip(rint(h * 127))) from the
// float h at the cell, x and LN(x) theirs from the row's float values.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "lstm_gates.cuh"

namespace skim_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;        // 8 warps
constexpr int NWARP = 8;
constexpr int STAGE_ROWS = 256;     // a ring stage: 256 rows of 64 bytes
constexpr int STAGE_BYTES = 16384;
constexpr int MAX_DEPTH = 8;        // ring stages at most
constexpr int SCR_LD = 264;         // floats a row of the product scratch (256 + 8 of padding)
constexpr int TC_C = 128;           // the row passes: 32 lanes x 4 features
constexpr int SMEM_MAX = 232448;    // shared memory a block may use on the H100
constexpr int PLAN_FIELDS = 6;      // ops/skim_stream_kernel.py SkimPlan.ints()
constexpr int PLAN_MISMATCH = 10001;
constexpr float LN_EPS = 1e-5f;
constexpr float GATE_EPS = 1e-8f;

// ----------------------------------------------------------------- plan
// Fields: route (1 tensor cores, 0 CUDA cores), K (CTAs a cluster), M (rows
// a tile), D (ring stages), the shared bytes a block, Sb (stages of a frame's
// image); on the CUDA cores only the bytes (the rest 0).

// stages of a product with `kin` input rows and N columns
__host__ __device__ inline int stages_of(int kin, int N, int int8) {
  return kin / ((int8 ? 64 : 32) * (STAGE_ROWS / N));
}
// a product's k-slices tile its stages exactly
inline bool tiles_stages(int kin, int N, int int8) {
  return N > 0 && STAGE_ROWS % N == 0 && kin % ((int8 ? 64 : 32) * (STAGE_ROWS / N)) == 0;
}

// shared bytes of a CTA, in the kernel's layout order
inline long tc_smem(int M, int K, int C, int H, int n, int q_hh, int q_full, int D) {
  const long U = H / K;
  long b = 1024 + (long)D * STAGE_BYTES;                     // alignment, ring
  b += 2L * M * C * 4 + (long)M * SCR_LD * 4 + (long)M * 128 * 2;   // x, xn, scratch, A tile
  if (q_full) b += (long)M * 128 + (long)M * 4;              // int8 A tile, row amax
  if (!q_full) b += (long)M * H * 2 + (long)n * M * U * 2;   // bf16 h tile, own h slices
  if (q_hh) b += (long)M * H + (long)n * M * U;              // int8 h tile, own slices
  return b + (long)n * M * U * 4 + 2L * D * 8;               // c, mbarriers
}

// the gate products of a CTA (4U columns) run in passes of at most 256
__host__ __device__ inline int gate_passes(int U) { return 4 * U > 256 ? 2 : 1; }

// stages of one frame's image: per block W_hh, a projection, the fusion, W_ih
inline int body_stages(int C, int H, int Hg, int n, int K, int film_mask, int gate_mask,
                       int q_hh, int q_full) {
  const int P = gate_passes(H / K), N = 4 * (H / K) / P;
  int s = 0;
  for (int i = 0; i < n; ++i) {
    s += P * stages_of(H, N, q_hh) + stages_of(H, C, q_full) + P * stages_of(C, N, q_full);
    if ((film_mask >> i) & 1) s += stages_of(C, 2 * C, q_full);
    if ((gate_mask >> i) & 1)
      s += stages_of(C, Hg, 0) + stages_of(Hg, 2 * Hg, 0) + stages_of(Hg, C, 0);
  }
  return s;
}

// the CUDA-core kernel's shared bytes (skim_stream.cu `launch`)
inline long cuda_smem(int C, int H, int Hg, int n) {
  const long BT = 8, kq = (C > H ? C : H) / 4;
  return 4 * (2 * n * BT * H + 4 * BT * C + BT * H) + 4 * (BT * kq + BT * H / 4) +
         4 * (BT + 3 * BT * Hg);
}

// The plan: tensor cores for bf16 dots at C = 128 (and Hg = 128 under a
// Gate), n >= 2 blocks, U = H / K of 32, 64 or 128 (two passes of the gate
// products, and 16 rows a tile only) for a cluster of 2-8; among (K, M) in
// the order (H/32, 16), (H/64, 16), (H/32, 32), (H/64, 32), (H/128, 16) the
// first with the fewest stages a CTA streams in all: its waves of
// `clusters[K]` (the clusters of K in flight, cudaOccupancyMaxActiveClusters)
// times the stages of a frame (a stage costs about the same at M = 16 and
// 32); D as many stages as fit (at most 8). Else the CUDA-core kernel, when
// its bytes fit.
inline bool make_plan(int B, int C, int H, int Hg, int n, int film_mask, int gate_mask,
                      int dot_bf16, int q_hh, int q_full, const int* clusters,
                      int (&pl)[PLAN_FIELDS]) {
  for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = 0;
  const bool gate = gate_mask != 0;
  if (dot_bf16 && C == TC_C && (!gate || Hg == 128) && n >= 2) {
    const int cand[5][2] = {{H / 32, 16}, {H / 64, 16}, {H / 32, 32}, {H / 64, 32},
                            {H / 128, 16}};
    long best = -1;
    for (auto& km : cand) {
      const int K = km[0], M = km[1];
      if (K < 2 || K > 8 || H != K * (H / K)) continue;
      const int U = H / K, N = 4 * U / gate_passes(U);
      if ((U != 32 && U != 64 && (U != 128 || M != 16)) || !tiles_stages(H, N, q_hh) ||
          !tiles_stages(C, N, q_full) ||
          !tiles_stages(H, C, q_full) || !tiles_stages(C, 2 * C, q_full))
        continue;
      if (gate && !(tiles_stages(C, Hg, 0) && tiles_stages(Hg, 2 * Hg, 0) &&
                    tiles_stages(Hg, C, 0)))
        continue;
      long D = (SMEM_MAX - tc_smem(M, K, C, H, n, q_hh, q_full, 0)) / (STAGE_BYTES + 16);
      if (D > MAX_DEPTH) D = MAX_DEPTH;
      if (D < 2 || clusters[K] < 1) continue;
      const long tiles = (B + M - 1) / M, waves = (tiles + clusters[K] - 1) / clusters[K];
      const int Sb = body_stages(C, H, Hg, n, K, film_mask, gate_mask, q_hh, q_full);
      if (best < 0 || waves * Sb < best) {
        best = waves * Sb;
        const int v[PLAN_FIELDS] = {1, K, M, (int)D,
                                    (int)tc_smem(M, K, C, H, n, q_hh, q_full, (int)D), Sb};
        for (int i = 0; i < PLAN_FIELDS; ++i) pl[i] = v[i];
      }
    }
    if (best >= 0) return true;
  }
  pl[4] = (int)cuda_smem(C, H, Hg, n);
  return pl[4] <= SMEM_MAX;
}

// ---------------------------------------------------------------- kernel
struct TcParams {
  const void *x, *se, *be, *ge, *h_in, *c_in;
  void *y, *h_out, *c_out;
  const unsigned char* img;  // [K ranks][Sb stages][STAGE_BYTES]
  const float* w_vec;        // per block: fg fb [C] b [4H] proj_b ln_g ln_b [C]
  const float* w_s;          // per block: the scales of wsx wbx [C] w_ih w_hh [4H] proj_w [C]
  const float* g_vec;        // per block: lg lb rg rb [Hg] la ra
  int B, F, C, H, Hg, n, film_mask, gate_mask, x_bf16, s_bf16;
  int K, M, D, Sb, tiles;
};

// an mbarrier phase wait that traps (the launch then fails) instead of
// spinning for ever if the ring's bookkeeping ever went wrong. try_wait with
// a suspend-time hint of 20 ns: without one, a thread suspended in try_wait
// was measured to resume hundreds of cycles after the phase completed.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(20)
        : "memory");
    if (done) return;
    if (spins > (1 << 26)) __trap();
  }
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.f) + a * fminf(v, 0.f);
}
// clip(round(v), -127, 127), round half to even, as jnp.round
__device__ __forceinline__ int q8(float v) { return max(-127, min(127, __float2int_rn(v))); }

// four consecutive values of a float32 / bfloat16 tensor (16- / 8-byte aligned)
__device__ __forceinline__ void ld4(float (&v)[4], const void* p, long i, int bf) {
  if (bf) {
    const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p) + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
}
__device__ __forceinline__ void st4(void* p, long i, const float (&v)[4], int bf) {
  if (bf)
    *reinterpret_cast<uint2*>(static_cast<bf16*>(p) + i) =
        make_uint2(hopper::bf16x2(v[0], v[1]), hopper::bf16x2(v[2], v[3]));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int Q>
__global__ void __launch_bounds__(THREADS, 1) skim_tc_kernel(TcParams p) {
  constexpr bool QH = (Q & 1) != 0, QF = (Q & 2) != 0;   // int8_full implies int8_hh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = p.C, H = p.H, Hg = p.Hg, n = p.n, M = p.M, K = p.K, D = p.D, B = p.B, F = p.F;
  const int U = H / K, MT = M / 16, G = 4 * H;
  // the gate products: P passes (2 only where M = 16) of NP columns, UP units each
  const int P = gate_passes(U), NP = 4 * U / P, UP = U / P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int vec_stride = 2 * C + G + 3 * C, s_stride = 2 * C + 2 * G + C;

  // ---- shared memory, in tc_smem's order
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* sp = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* ring = sp;
  sp += (size_t)D * STAGE_BYTES;
  float* xs = reinterpret_cast<float*>(sp);        // [M][C] the block input x
  sp += (size_t)M * C * 4;
  float* xn = reinterpret_cast<float*>(sp);        // [M][C] LN(x) of a FiLM block
  sp += (size_t)M * C * 4;
  float* scr = reinterpret_cast<float*>(sp);       // [M][SCR_LD] a product's output
  sp += (size_t)M * SCR_LD * 4;
  bf16* a16 = reinterpret_cast<bf16*>(sp);         // [M][128] swizzled bf16 A tile
  sp += (size_t)M * 128 * 2;
  signed char* a8 = reinterpret_cast<signed char*>(sp);   // [M][128] int8 A tile
  float* amax = nullptr;                                   // [M] its rows' amax
  if (QF) {
    sp += (size_t)M * 128;
    amax = reinterpret_cast<float*>(sp);
    sp += (size_t)M * 4;
  }
  bf16* h16 = reinterpret_cast<bf16*>(sp);         // [M][H] gathered h, bf16
  if (!QF) sp += (size_t)M * H * 2;
  signed char* h8 = reinterpret_cast<signed char*>(sp);   // [M][H] gathered h, int8
  if (QH) sp += (size_t)M * H;
  bf16* s16 = reinterpret_cast<bf16*>(sp);         // [n][M][U] this CTA's h slices
  if (!QF) sp += (size_t)n * M * U * 2;
  signed char* s8 = reinterpret_cast<signed char*>(sp);   // [n][M][U] their int8 form
  if (QH) sp += (size_t)n * M * U;
  float* cs = reinterpret_cast<float*>(sp);        // [n][M][U] c of this CTA's units
  sp += (size_t)n * M * U * 4;
  const uint32_t ring_s = hopper::smem_addr(ring), bar_s = hopper::smem_addr(sp);
  const uint32_t a16_s = hopper::smem_addr(a16), a8_s = hopper::smem_addr(a8);
  const uint32_t h16_s = hopper::smem_addr(h16), h8_s = hopper::smem_addr(h8);
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (D + s); };

  // ---- the ring. A tile consumes F * Sb stages: frame 0's image without
  // block 0's projection slot (there is no projection before the first
  // step), frames 1 .. F-1 whole, then that slot (the last projection);
  // `source` maps the j-th stage a CTA consumes to its stage of the image.
  // Each warp releases a stage with one arrive on the slot's empty barrier;
  // thread 0, before each round of stages, refills the slots of the stages
  // consumed before it, once every warp has released them.
  const int n_clusters = gridDim.x / K, cid = blockIdx.x / K;
  const int per_tile = F * p.Sb;
  const int total = (cid < p.tiles ? (p.tiles - cid + n_clusters - 1) / n_clusters : 0) * per_tile;
  const int st_hh = stages_of(H, NP, QH), st_p = stages_of(H, C, QF);   // a pass of W_hh
  const int st_ih = stages_of(C, NP, QF), st_film = stages_of(C, 2 * C, QF);
  const int gate_on = p.gate_mask != 0;
  const int st_win = gate_on ? stages_of(C, Hg, 0) : 0;
  const int st_lr = gate_on ? stages_of(Hg, 2 * Hg, 0) : 0;
  const int st_wout = gate_on ? stages_of(Hg, C, 0) : 0;
  const unsigned char* img = p.img + (size_t)rank * p.Sb * STAGE_BYTES;
  const int st_hh0 = P * st_hh;   // stages before the projection slot of block 0
  auto source = [&](int j) {
    int q = j % per_tile;
    if (q >= st_hh0) q += st_p;
    return q < per_tile ? q % p.Sb : st_hh0 + (q - per_tile);
  };
  auto issue = [&](int j, int slot) {   // thread 0: stage j into its slot
    hopper::mbar_expect_tx(full(slot), STAGE_BYTES);
    hopper::bulk_load(ring_s + slot * STAGE_BYTES, img + (size_t)source(j) * STAGE_BYTES,
                      STAGE_BYTES, full(slot));
  };
  if (tid == 0) {
    for (int s = 0; s < D; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), NWARP);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < D && j < total; ++j) issue(j, j);
  int cslot = 0, consumed = 0;   // the next stage to consume, its slot
  uint32_t cphase = 0;           // and the parity of its slot's use
  int rslot = 0, refilled = 0;   // thread 0: the oldest stage whose slot is not refilled
  uint32_t rphase = 0;
  // thread 0, before a round of stages: refill the slots of the stages
  // consumed before it (every warp has released them, or is about to)
  auto refill = [&]() {
    if (tid != 0) return;
    for (; refilled < consumed; ++refilled) {
      wait_phase(empty(rslot), rphase);
      if (refilled + D < total) issue(refilled + D, rslot);
      if (++rslot == D) rslot = 0, rphase ^= 1;
    }
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(cslot));
    if (++cslot == D) cslot = 0, cphase ^= 1;
    ++consumed;
  };

  // ldmatrix.x4 lanes (as dual_path_tc.cuh's): A rows a_r of an m-tile, 16-byte
  // chunk + a_hi; B rows b_r of an n-tile pair, chunk + b_hi
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_hi = lane >> 4;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_hi = (lane >> 3) & 1;

  // acc[mt][j] (+)= A . W over the next `nst` stages: a product of N columns,
  // this warp's N / 8 of them (n-tiles j); A the swizzled tile at a_s, rows of
  // LA bytes. Float accumulators: bf16 m16n8k16; int: int8 m16n8k32. Two
  // stages a round: one wait for both.
  auto product = [&](auto& acc, uint32_t a_s, int LA, int N, int nst) {
    constexpr bool I8 = std::is_same<std::remove_reference_t<decltype(acc[0][0][0])>, int>::value;
    constexpr int MTX = std::extent<std::remove_reference_t<decltype(acc)>>::value;
    const int sps = STAGE_ROWS / N, col0 = warp * (N / 8), pairs = N / 128;
    for (int st = 0; st < nst; st += 2) {
      const int ng = nst - st < 2 ? 1 : 2;   // stages this round
      refill();
      const int slot2 = cslot + 1 == D ? 0 : cslot + 1;
      wait_phase(full(cslot), cphase);
      if (ng == 2) wait_phase(full(slot2), cslot + 1 == D ? cphase ^ 1 : cphase);
      for (int gi = 0; gi < ng; ++gi) {
        const uint32_t b_s = ring_s + (gi ? slot2 : cslot) * STAGE_BYTES;
        for (int sl = 0; sl < sps; ++sl) {
          const int kc = ((st + gi) * sps + sl) * 4;   // the slice's first 16-byte chunk of an A row
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            unsigned a[2][4];
#pragma unroll
            for (int mt = 0; mt < MTX; ++mt)
              if (mt < MT)
                hopper::ldsm_x4(a[mt], a_s + (mt * 16 + a_r) * LA +
                                           (((kc + 2 * ks + a_hi) ^ (lane & 7)) << 4));
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              if (pp >= pairs) break;
              const int row = sl * N + col0 + 16 * pp + b_r;
              unsigned b[4];
              hopper::ldsm_x4(b, b_s + row * 64 + (((2 * ks + b_hi) ^ ((row >> 1) & 3)) << 4));
#pragma unroll
              for (int mt = 0; mt < MTX; ++mt) {
                if (mt >= MT) break;
                if constexpr (I8) {
                  hopper::mma_s8(acc[mt][2 * pp], a[mt], b[0], b[1]);
                  hopper::mma_s8(acc[mt][2 * pp + 1], a[mt], b[2], b[3]);
                } else {
                  hopper::mma_bf16(acc[mt][2 * pp], a[mt], b[0], b[1]);
                  hopper::mma_bf16(acc[mt][2 * pp + 1], a[mt], b[2], b[3]);
                }
              }
            }
          }
        }
      }
      for (int gi = 0; gi < ng; ++gi) release();
    }
    refill();   // the last round's slots, before the row passes leave the ring idle
  };
  auto zero = [](auto& a) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mt][j][e] = 0;
  };
  // element e of n-tile j of m-tile mt: row mt*16 + g + 8 (e / 2), column
  // col0 + 8 j + 2 tq + e % 2 of the product; `val(row, col, acc)` into the
  // scratch (float2 stores)
  auto to_scr = [&](auto& acc, int N, auto val) {
    const int col0 = warp * (N / 8), nt = N / 64;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= MT) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = mt * 16 + g + 8 * h2, col = col0 + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(scr + row * SCR_LD + col) =
              make_float2(val(row, col, acc[mt][j][2 * h2]), val(row, col + 1, acc[mt][j][2 * h2 + 1]));
        }
      }
    }
  };
  // The gate accumulators ga[x] hold m-tile x (one pass), or pass x of
  // m-tile 0 (two passes). The gate column (q * H + unit) of element e of
  // n-tile j of a pass:
  auto gate_col = [&](int j, int e, int pass) {
    return ((j & 1) * 2 + (e & 1)) * H + rank * U + pass * UP + warp * (UP / 8) +
           4 * (j >> 1) + tq;
  };
  // a gate product into the gate accumulators, pass by pass
  auto gate_product = [&](auto& acc, uint32_t a_s, int LA, int nst) {
    if (P == 1) {
      product(acc, a_s, LA, NP, nst);
      return;
    }
    using Tile = std::remove_reference_t<decltype(acc[0])>;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
      product(*reinterpret_cast<Tile(*)[1]>(&acc[pass]), a_s, LA, NP, nst);
  };
  // int8 sums into the gate accumulators: ga += isum * (row scale) * column scale
  auto add_i8 = [&](float (&ga)[2][4][4], int (&ia)[2][4][4], const float* sc, bool dyn) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x >= (P == 1 ? MT : 2)) break;
      const int mt = P == 1 ? x : 0, pass = P == 1 ? 0 : x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= NP / 64) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[gate_col(j, e, pass)];
          ga[x][j][e] += dyn ? (float)ia[x][j][e] * (amax[mt * 16 + g + 8 * (e >> 1)] / 127.f) * s
                             : (float)ia[x][j][e] * s;
        }
      }
    }
  };

  // full h of block i from every rank's slice (bf16, or its int8 form) into
  // the swizzled h tile; the loads of a thread are issued before its stores
  auto gather = [&](int i, bool i8) {
    const int eb = i8 ? 1 : 2, cpr = U * eb / 16, LB = H * eb;
    const int chunks = K * M * cpr;
    unsigned char* loc = i8 ? reinterpret_cast<unsigned char*>(s8 + (size_t)i * M * U)
                            : reinterpret_cast<unsigned char*>(s16 + (size_t)i * M * U);
    unsigned char* dst = i8 ? reinterpret_cast<unsigned char*>(h8)
                            : reinterpret_cast<unsigned char*>(h16);
    for (int c0 = 0; c0 < chunks; c0 += 4 * THREADS) {
      uint4 v[4];
      int off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * THREADS + tid;
        off[u] = -1;
        if (c < chunks) {
          const int q = c / (M * cpr), rem = c - q * M * cpr, m = rem / cpr, cc = rem - m * cpr;
          v[u] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(loc, q))[m * cpr + cc];
          off[u] = m * LB + (((q * cpr + cc) ^ (m & 7)) << 4);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (off[u] >= 0) *reinterpret_cast<uint4*>(dst + off[u]) = v[u];
    }
  };

  // ---- the row passes: warp w takes rows w, w + 8, .. (RW of them, their
  // work interleaved); lane l features 4l .. 4l + 3 of a row
  const int RW = M / NWARP;
  using Rows = float[4][4];
  auto wsum_rows = [&](float (&v)[4]) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (rr < RW) v[rr] += __shfl_xor_sync(0xffffffffu, v[rr], o);
  };
  // two-pass LayerNorm of each row: out = (v - mean) * rstd * gam + bet
  // (gam / bet: this lane's four values; out may be v)
  auto ln_rows = [&](const Rows& v, const float (&gam)[4], const float (&bet)[4], float eps,
                     Rows& out) {
    float mean[4], q[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) mean[rr] = v[rr][0] + v[rr][1] + v[rr][2] + v[rr][3];
    wsum_rows(mean);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      mean[rr] /= TC_C;
      q[rr] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) q[rr] += (v[rr][e] - mean[rr]) * (v[rr][e] - mean[rr]);
    }
    wsum_rows(q);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float r = rsqrtf(q[rr] / TC_C + eps);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[rr][e] = (v[rr][e] - mean[rr]) * r * gam[e] + bet[e];
    }
  };
  // this lane's four values of a float32 row (shared or global memory)
  auto load_row = [&](float (&v)[4], const float* base) {
    const float4 a = *reinterpret_cast<const float4*>(base + 4 * lane);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  };
  auto load_rows = [&](Rows& v, const float* base, int ld) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      if (rr < RW) load_row(v[rr], base + (warp + NWARP * rr) * ld);
  };
  auto store_rows = [&](float* base, int ld, const Rows& v) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      if (rr < RW)
        *reinterpret_cast<float4*>(base + (warp + NWARP * rr) * ld + 4 * lane) =
            make_float4(v[rr][0], v[rr][1], v[rr][2], v[rr][3]);
  };
  auto put_a16 = [&](const Rows& v) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (rr >= RW) break;
      const int r = warp + NWARP * rr;
      *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(a16) + r * 256 +
                                (((lane >> 1) ^ (r & 7)) << 4) + (lane & 1) * 8) =
          make_uint2(hopper::bf16x2(v[rr][0], v[rr][1]), hopper::bf16x2(v[rr][2], v[rr][3]));
    }
  };
  // int8_full's dynamic activation (dot_dyn): amax of the row, v / amax * 127
  auto put_a8 = [&](const Rows& v) {
    float m[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      m[rr] = fmaxf(fmaxf(fabsf(v[rr][0]), fabsf(v[rr][1])), fmaxf(fabsf(v[rr][2]), fabsf(v[rr][3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (rr < RW) m[rr] = fmaxf(m[rr], __shfl_xor_sync(0xffffffffu, m[rr], o));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (rr >= RW) break;
      const int r = warp + NWARP * rr;
      const float mx = fmaxf(m[rr], 1e-8f);
      if (lane == 0) amax[r] = mx;
      unsigned w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) w |= (unsigned)(q8(v[rr][e] / mx * 127.f) & 0xff) << (8 * e);
      *reinterpret_cast<unsigned*>(a8 + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4) = w;
    }
  };
  // W_ih's operand from the block's x
  auto put_x = [&](const Rows& v) {
    if (QF)
      put_a8(v);
    else
      put_a16(v);
  };
  // a block's first row pass on x: FiLM's LN(x) and its operand, the Gate's
  // bf16 x, or W_ih's operand; fg / fb: FiLM's LayerNorm (this lane's of block i)
  auto prep = [&](int i, const Rows& v, const float (&fg)[4], const float (&fb)[4]) {
    if ((p.film_mask >> i) & 1) {
      Rows o;
      ln_rows(v, fg, fb, LN_EPS, o);
      store_rows(xn, C, o);
      put_x(o);
    } else if ((p.gate_mask >> i) & 1) {
      put_a16(v);
    } else {
      put_x(v);
    }
  };
  // a [n, B, width] tensor's rows of block i for this warp (zeros past the batch)
  auto load_term = [&](Rows& v, const void* t, int i, int width, int b0, int nb) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (rr >= RW) break;
      const int r = warp + NWARP * rr;
      if (r < nb)
        ld4(v[rr], t, ((long)i * B + b0 + r) * width + 4 * lane, p.x_bf16);
      else
        v[rr][0] = v[rr][1] = v[rr][2] = v[rr][3] = 0.f;
    }
  };
  // x of frame f for this warp's rows (zeros past the batch)
  auto load_x = [&](Rows& v, int f, int b0, int nb) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (rr >= RW) break;
      const int r = warp + NWARP * rr;
      if (r < nb)
        ld4(v[rr], p.x, ((long)(b0 + r) * F + f) * C + 4 * lane, p.x_bf16);
      else
        v[rr][0] = v[rr][1] = v[rr][2] = v[rr][3] = 0.f;
    }
  };

  // ---- the LSTM cell of block i at frame t: this thread's (row, unit) cells
  auto cell = [&](int i, int t, float (&ga)[2][4][4], int b0, int nb) {
    const float* bias = p.w_vec + (size_t)i * vec_stride + 2 * C;
    float* ci = cs + (size_t)i * M * U;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x >= (P == 1 ? MT : 2)) break;
      const int mt = P == 1 ? x : 0, pass = P == 1 ? 0 : x;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        if (pp >= NP / 128) break;
        const int ul = pass * UP + warp * (UP / 8) + 4 * pp + tq, unit = rank * U + ul;
        const float bi = bias[unit], bf = bias[H + unit], bg = bias[2 * H + unit],
                    bo = bias[3 * H + unit];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int m = mt * 16 + g + 8 * h2;
          const float ig = hopper::sigm_f(ga[x][2 * pp][2 * h2] + bi);
          const float fg = hopper::sigm_f(ga[x][2 * pp][2 * h2 + 1] + bf);
          const float gg = hopper::tanh_f(ga[x][2 * pp + 1][2 * h2] + bg);
          const float og = hopper::sigm_f(ga[x][2 * pp + 1][2 * h2 + 1] + bo);
          const float cn = fg * ci[m * U + ul] + ig * gg;
          const float hn = og * hopper::tanh_f(cn);
          ci[m * U + ul] = cn;
          if (!QF) s16[((size_t)i * M + m) * U + ul] = __float2bfloat16(hn);
          if (QH) s8[((size_t)i * M + m) * U + ul] = lstm_gates::quant_h(hn);
          if (t == F - 1 && m < nb) {
            const long gi = ((long)i * B + b0 + m) * H + unit;
            lstm_gates::st(p.h_out, gi, hn, p.s_bf16);
            lstm_gates::st(p.c_out, gi, cn, p.s_bf16);
          }
        }
      }
    }
  };

  // ---- block i's projection of h (gathered) into the scratch, then per row
  // x += LN(. + pb); `y_frame` >= 0: store x as y of that frame (each CTA
  // its rows r % K == rank), `x_frame` >= 0: load that frame's x; then
  // prep(next) on the new x
  auto project = [&](int ip, int y_frame, int x_frame, int next, int b0, int nb) {
    if (QF) {
      int ia[2][4][4];
      zero(ia);
      product(ia, h8_s, H, C, st_p);
      const float* sc = p.w_s + (size_t)ip * s_stride + 2 * C + 2 * G;
      to_scr(ia, C, [&](int, int col, int a) { return (float)a * sc[col]; });
    } else {
      float fa[2][4][4];
      zero(fa);
      product(fa, h16_s, 2 * H, C, st_p);
      to_scr(fa, C, [&](int, int, float a) { return a; });
    }
    __syncthreads();
    const float* wv = p.w_vec + (size_t)ip * vec_stride;
    float pb[4], lg[4], lb[4], fg[4], fb[4];
    load_row(pb, wv + 2 * C + G);
    load_row(lg, wv + 3 * C + G);
    load_row(lb, wv + 4 * C + G);
    const float* nv = p.w_vec + (size_t)(next < 0 ? 0 : next) * vec_stride;
    load_row(fg, nv);
    load_row(fb, nv + C);
    Rows t, v;
    load_rows(t, scr, SCR_LD);
    load_rows(v, xs, C);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[rr][e] += pb[e];
    ln_rows(t, lg, lb, LN_EPS, t);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (rr >= RW) break;
      const int r = warp + NWARP * rr;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[rr][e] += t[rr][e];
      if (y_frame >= 0 && r < nb && r % K == rank)
        st4(p.y, ((long)(b0 + r) * F + y_frame) * C + 4 * lane, v[rr], p.x_bf16);
    }
    if (x_frame >= 0) load_x(v, x_frame, b0, nb);
    store_rows(xs, C, v);
    if (next >= 0) prep(next, v, fg, fb);
    __syncthreads();
  };

  // ---- the fusion of block i on x (FiLM or Gate), ending with W_ih's operand
  auto fuse = [&](int i, int b0, int nb) {
    if ((p.film_mask >> i) & 1) {
      if (QF) {
        int ia[2][4][4];
        zero(ia);
        product(ia, a8_s, 128, 2 * C, st_film);
        const float* sc = p.w_s + (size_t)i * s_stride;   // wsx | wbx scales, [2C]
        to_scr(ia, 2 * C, [&](int row, int col, int a) {
          return (float)a * (amax[row] / 127.f) * sc[col];
        });
      } else {
        float fa[2][4][4];
        zero(fa);
        product(fa, a16_s, 256, 2 * C, st_film);
        to_scr(fa, 2 * C, [&](int, int, float a) { return a; });
      }
      __syncthreads();
      Rows v, sv, bv, t;
      load_term(sv, p.se, i, C, b0, nb);
      load_term(bv, p.be, i, C, b0, nb);
      load_rows(v, scr, SCR_LD);        // scale
      load_rows(t, scr + C, SCR_LD);    // bias
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[rr][e] += v[rr][e];
          bv[rr][e] += t[rr][e];
        }
      load_rows(t, xn, C);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[rr][e] = sv[rr][e] * t[rr][e] + bv[rr][e];
      store_rows(xs, C, v);
      put_x(v);
      __syncthreads();
    } else if ((p.gate_mask >> i) & 1) {
      const float* gv = p.g_vec + (size_t)i * (4 * Hg + 2);
      float fa[2][4][4];
      // u = x @ Win
      zero(fa);
      product(fa, a16_s, 256, Hg, st_win);
      to_scr(fa, Hg, [&](int, int, float a) { return a; });
      __syncthreads();
      {
        Rows u;
        load_rows(u, scr, SCR_LD);
        put_a16(u);
      }
      __syncthreads();
      // [left | right] = u @ [Wl | Wrx]; right += ge; left * right
      zero(fa);
      product(fa, a16_s, 256, 2 * Hg, st_lr);
      to_scr(fa, 2 * Hg, [&](int, int, float a) { return a; });
      __syncthreads();
      const float la = gv[4 * Hg], ra = gv[4 * Hg + 1];
      float lgv[4], lbv[4], rgv[4], rbv[4];   // scalar loads: a Gate block's vectors are 4 Hg + 2 apart
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lgv[e] = gv[4 * lane + e];
        lbv[e] = gv[Hg + 4 * lane + e];
        rgv[e] = gv[2 * Hg + 4 * lane + e];
        rbv[e] = gv[3 * Hg + 4 * lane + e];
      }
      {
        Rows l, r, e4;
        load_term(e4, p.ge, i, Hg, b0, nb);
        load_rows(l, scr, SCR_LD);
        load_rows(r, scr + Hg, SCR_LD);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[rr][e] += e4[rr][e];
        ln_rows(l, lgv, lbv, GATE_EPS, l);
        ln_rows(r, rgv, rbv, GATE_EPS, r);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[rr][e] = prelu(l[rr][e], la) * sigm(prelu(r[rr][e], ra));
        put_a16(l);
      }
      __syncthreads();
      // x += (left * right) @ Wout
      zero(fa);
      product(fa, a16_s, 256, C, st_wout);
      to_scr(fa, C, [&](int, int, float a) { return a; });
      __syncthreads();
      {
        Rows o, v;
        load_rows(o, scr, SCR_LD);
        load_rows(v, xs, C);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[rr][e] += o[rr][e];
        store_rows(xs, C, v);
        put_x(v);
      }
      __syncthreads();
    }
  };

  const int S = F * n;
  for (int tile = cid; tile < p.tiles; tile += n_clusters) {
    const int b0 = tile * M, nb = min(M, B - b0);
    // c and this CTA's h slices from the carries, x of frame 0
    for (int idx = tid; idx < n * M * U; idx += THREADS) {
      const int i = idx / (M * U), m = idx / U % M, ul = idx % U;
      float hv = 0.f, cv = 0.f;
      if (m < nb) {
        const long gi = ((long)i * B + b0 + m) * H + rank * U + ul;
        hv = lstm_gates::ld(p.h_in, gi, p.s_bf16);
        cv = lstm_gates::ld(p.c_in, gi, p.s_bf16);
      }
      cs[idx] = cv;
      if (!QF) s16[idx] = __float2bfloat16(hv);
      if (QH) s8[idx] = lstm_gates::quant_h(hv);
    }
    float fg[4], fb[4];
    load_row(fg, p.w_vec);
    load_row(fb, p.w_vec + C);
    {
      Rows v;
      load_x(v, 0, b0, nb);
      store_rows(xs, C, v);
      prep(0, v, fg, fb);
    }
    hopper::cl_sync();   // every slice written (and this CTA's rows) before any gather

    for (int s = 0; s < S; ++s) {
      const int t = s / n, i = s - t * n;
      // h_i(t-1) for W_hh, then this step's arrive: the slices of block i
      // were written n >= 2 steps ago, and no CTA rewrites its slice (at
      // the cell below) before every CTA has arrived, at every step
      gather(i, QH);
      __syncthreads();
      hopper::cl_arrive();
      float ga[2][4][4];
      zero(ga);
      if (QH) {
        int ia[2][4][4];
        zero(ia);
        gate_product(ia, h8_s, H, st_hh);
        add_i8(ga, ia, p.w_s + (size_t)i * s_stride + 2 * C + G, false);
      } else {
        gate_product(ga, h16_s, 2 * H, st_hh);
      }
      hopper::cl_wait();   // every slice of step s - 1 written, every gather of block i done
      if (s > 0) {
        __syncthreads();    // every warp is done with the h tile
        const int ip = (i + n - 1) % n;
        gather(ip, QF);
        __syncthreads();
        project(ip, i == 0 ? t - 1 : -1, i == 0 ? t : -1, i, b0, nb);
      }
      fuse(i, b0, nb);
      if (QF) {
        int ia[2][4][4];
        zero(ia);
        gate_product(ia, a8_s, 128, st_ih);
        add_i8(ga, ia, p.w_s + (size_t)i * s_stride + 2 * C, true);
      } else {
        gate_product(ga, a16_s, 256, st_ih);
      }
      cell(i, t, ga, b0, nb);
      __syncthreads();   // this CTA's slices before its own gathers
    }
    hopper::cl_arrive();
    hopper::cl_wait();
    gather(n - 1, QF);
    __syncthreads();
    project(n - 1, F - 1, -1, -1, b0, nb);
    hopper::cl_sync();   // every gather done before the next tile rewrites the slices
  }
}

// ------------------------------------------------------------------ host
// clusters of K CTAs in flight on the current device, asked once per device
inline int sm_clusters(int K) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES][9] = {};
  int dev = 0;
  if (K < 1 || K > 8 || cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (cached[dev][K]) return cached[dev][K];
  cudaError_t err = cudaFuncSetAttribute(skim_tc_kernel<0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, skim_tc_kernel<0>, &cfg) != cudaSuccess)
    return 0;
  return cached[dev][K] = clusters;
}

// the plan the caller passed, checked against this source's
inline cudaError_t check_plan(const int* want, int B, int C, int H, int Hg, int n, int film_mask,
                              int gate_mask, int dot_bf16, int q_hh, int q_full) {
  int clusters[9];
  for (int k = 0; k < 9; ++k) clusters[k] = (k == 2 || k == 4 || k == 8) ? sm_clusters(k) : 0;
  int pl[PLAN_FIELDS];
  if (!make_plan(B, C, H, Hg, n, film_mask, gate_mask, dot_bf16, q_hh, q_full, clusters, pl))
    return cudaErrorInvalidConfiguration;
  for (int i = 0; i < PLAN_FIELDS; ++i)
    if (pl[i] != want[i]) return static_cast<cudaError_t>(PLAN_MISMATCH);
  return cudaSuccess;
}

template <int Q>
cudaError_t launch_q(const TcParams& p, int smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(skim_tc_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  const int clusters = sm_clusters(p.K);
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.K * (p.tiles < clusters ? p.tiles : clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, skim_tc_kernel<Q>, p);
}

inline cudaError_t launch(const TcParams& p, int q_mode, int smem, cudaStream_t stream) {
  if (q_mode & 2) return launch_q<3>(p, smem, stream);
  if (q_mode & 1) return launch_q<1>(p, smem, stream);
  return launch_q<0>(p, smem, stream);
}

}  // namespace skim_tc
