// LSTM scans for training, for Hopper (sm_90a): a forward cluster kernel, and
// a backward made of a cluster kernel for the recurrence and a tiled product
// kernel for the work off the serial chain, with the input projection inside
// the kernel (proj = 1) or hoisted out of it (proj = 0), on batch-major or
// time-major sequences (x_tm).
//
// Replaces the Pallas TPU kernels of puresound_tpu/ops/lstm_train_kernel.py:
//   _fwd_call_fp (pallas_call at :533, body _fwd_kernel_fp) and
//   _bwd_call_fp (pallas_call at :590, body _bwd_kernel_fp),
// the forward and the custom VJP of lstm_scan_train_fp and, time-major (x_t
// [T, B, C] in, y_t out; dy_t in, dx_t out), of lstm_scan_train_fp_tm; and
//   _fwd_call (pallas_call at :177, body _fwd_kernel) and
//   _bwd_call (pallas_call at :224, body _bwd_kernel),
// those of lstm_scan_train_tm / lstm_scan_train, which read the hoisted
// projection xp_t [T, B, 4H] in place of x_t @ W_ih + bias, write the dgates
// as dxp_t (in xp's dtype) in place of dx, compute no dbias, and give dW_hh
// alone: the weight-gradient product has H rows in place of H + C. At the
// boundary step the hoisted backward reads c0 rounded to xp's dtype, as JAX
// concatenates it onto cseq (:329-341); no concatenated copy is built.
// Per step t (t walks
// T-1 .. 0 under `reverse`), for a tile of rows:
//   forward:  gates = x_t @ W_ih + bias + h @ W_hh (i, f, g, o);
//             c = f*c + i*g;  h = o*tanh(c)
//             stores y_t, the ACTIVATED gates and c_t (the backward's residuals)
//   backward: dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c)^2)
//             dgates (i, f, g, o);  dx_t = dgates @ W_ih^T
//             dh_carry = dgates @ W_hh^T;  dc_carry = dc*f
//             dW_hh = sum h_prev^T dgates, dW_ih = sum x^T dgates, dbias = sum dgates
// Loads are in x's dtype (float32 or bfloat16, which is also the dot dtype),
// all math and the h/c and dh/dc carries are float32, each dot operand is
// rounded to the dot dtype and summed in float32. y, gates and c are stored
// in x's dtype and the backward reads them as stored; hT/cT in the state's
// dtype. h_prev/c_prev of a step are the neighbouring y/cseq entries, and
// h0/c0 at the forward's first step (t = 0, or t = T-1 under reverse).
//
// What bounds it on the H100. At the flagship's training shapes (SegLSTM:
// 896 rows, T = 150, C = 128, H = 256) one forward call does 105.7 GFLOP and
// moves about 449 MB in bf16 (275 MB of them the activated gates); the
// backward does about 211 GFLOP. Against the published peaks (989 TFLOP/s
// bf16, 67 TFLOP/s float32 without tensor cores, 3.35 TB/s) the forward is
// bounded at 0.134 ms (bf16, bytes) / 1.58 ms (f32, operations) and the
// backward at 0.214 / 3.15 ms. But each call is also a chain of T dependent
// steps: per step a tile of rows needs the whole h (or dgates) of the step
// before, so the time is T times one step's latency unless a step's product
// is spread over many SMs, its weights sit close to them, and the chain
// carries nothing that a later step does not need.
//
// What this design does about it.
//  - The chains run on thread-block clusters of CL CTAs (8 from H = 33). CTA r
//    of a cluster owns U = Hp / CL hidden units and their 4U gate columns,
//    keeps its weight slice resident in shared memory for the whole call, and
//    exchanges through distributed shared memory: the forward all-gathers h
//    (each CTA writes its h slice into every peer's next h tile), the
//    backward reduce-scatters dh (each CTA computes the partial dh of every
//    unit from its own dgates and sends each owner its part; the owner sums
//    the CL parts in rank order). One cluster barrier a step with double
//    buffers, two with one buffer where two do not fit; the global stores of
//    a step (y, gates, c_t; dgates) go out between the barrier's arrive and
//    its wait, and the backward reads a step's residuals one step ahead.
//  - Under bf16 the step products run on tensor cores (mma.sync m16n8k16,
//    bf16 x bf16 -> f32). Warp w owns pairs of (16-row m-tile, 8-unit
//    group): the four gate n-tiles of a pair leave i, f, g, o of the same
//    (row, unit) in one thread's accumulators, so the cell update and the
//    c / dh / dc carries stay in registers. Under float32 each thread owns
//    4 rows x 2 units and runs the same products on CUDA cores from k-major
//    tiles (one 16-byte read of 4 rows feeds 32 FMAs).
//  - The float32 slices of W_ih and W_hh do not fit beside a tile of rows at
//    SegLSTM's width (192 KB at H = 256, C = 128): there the forward first
//    makes x @ W_ih + bias for every step in float32 with the tiled product
//    kernel (a [T, B, 4H] scratch; no rounding, so the fused route's
//    arithmetic is kept) and runs the chain in the hoisted layout.
//  - The backward chain computes only dgates and the H-wide dh product;
//    dx = dgates @ W_ih^T and [dW_hh; dW_ih] = [h_prev | x]^T @ dgates run
//    after it in a tiled product kernel (128 x 128 tiles, tensor cores under
//    bf16) over the T*B rows, reading h_prev straight from y shifted by one
//    step (h0 at the boundary, no concatenated copy). The weight gradient
//    runs over fixed row ranges whose partials a last kernel sums in a fixed
//    order, with dbias from per-row sums of the unrounded dgates. No
//    atomics: the result is deterministic.
//  - Clusters are independent row tiles of M rows (a multiple of 16 under
//    bf16); the wrapper sizes the grid from cudaOccupancyMaxActiveClusters
//    (lstm_train_clusters: 15 clusters of 8 on an H100 SXM) and picks M so
//    that the tiles fit in one wave; a cluster walks its tiles, so no
//    grid-wide barrier is needed. C, H and the row tile are padded with
//    zeros in shared memory.
// The layout (CL, U, M, the buffers, the x projection) comes from _plan in
// ops/lstm_train_kernel.py; the launches recompute its shared-memory bytes
// and refuse a plan that does not match. The hoisted variant is the same
// kernels with C = 0: xp_t read straight from device memory in place of the
// projection, and no dx / dW_ih / dbias work. The layout flag only changes
// the x / y / dy / dx index arithmetic, so the time-major and batch-major
// entries compute the same sums in the same order, bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // threads of every kernel here
constexpr int XCH = 8;         // 16-byte chunks of x a thread stages a step
constexpr int SMEM_MAX = 232448;
constexpr int BM = 128, BN = 128, BK = 32;  // the off-chain product's tiles

__device__ __forceinline__ float ldf(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// the state (h0, c0, hT, cT) dtype is chosen at run time
__device__ __forceinline__ float lds(const void* p, long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void sts(void* p, long i, float v, int bf16) {
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

// the cell's nonlinearities on the fast exponential (tanh as 1 - 2 / (1 + e^2v)):
// within about 1e-7 of expf-based ones in absolute terms
__device__ __forceinline__ float sigm(float v) { return __fdividef(1.0f, 1.0f + __expf(-v)); }
__device__ __forceinline__ float tnh(float v) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * v));
}

// elements i and i + 1 of a row (i + 1 only when `two`; both at once when
// `pair`: i even in an array of even rows)
__device__ __forceinline__ void st2(float* p, long i, float a, float b, bool two, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
  } else {
    p[i] = a;
    if (two) p[i + 1] = b;
  }
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, long i, float a, float b, bool two,
                                    bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
  } else {
    p[i] = __float2bfloat16(a);
    if (two) p[i + 1] = __float2bfloat16(b);
  }
}
__device__ __forceinline__ float2 ld2(const float* p, long i, bool two, bool pair) {
  if (pair) return *reinterpret_cast<const float2*>(p + i);
  return make_float2(p[i], two ? p[i + 1] : 0.f);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p, long i, bool two, bool pair) {
  if (pair) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
  return make_float2(__bfloat162float(p[i]), two ? __bfloat162float(p[i + 1]) : 0.f);
}

// row of step t and sequence `row` in a [B, T, *] (tm = 0) or [T, B, *] array
__device__ __forceinline__ long seq_row(int tm, int t, long row, int B, int T) {
  return tm ? (long)t * B + row : row * T + t;
}

// ------------------------------------------------- clusters, tensor cores
__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_sync() {
  cl_arrive();
  cl_wait();
}

template <typename P>
__device__ __forceinline__ P* peer(P* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d += a . b on the tensor cores: m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed, from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15 of a row-major
// bf16 tile with leading dimension ld (lane = 4 g + t)
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const __nv_bfloat16* A, int ld,
                                       int m0, int k0, int g, int t) {
  const __nv_bfloat16* p = A + (long)(m0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// ---------------------------------------------------------- the chain tiles
// The cells (row, unit) of a CTA's tile that one thread owns. bf16: MT = 2
// pairs (16-row m-tile, 8-unit group) of the thread's warp, its cells the
// accumulator elements e of the mma (rows g, g + 8; units 2t, 2t + 1). f32:
// one tile of 4 rows x 2 units, cell e = (row e / 2, unit e % 2). The
// mapping is the same for every row tile, so it is computed once.
template <bool BF>
struct Cells {
  static constexpr int CE = BF ? 4 : 8;  // cells a tile
  static constexpr int MT = BF ? 2 : 1;  // tiles a thread
  bool on[MT];
  int r0[MT], u0[MT];  // the tile's first row and unit
  int rc[MT], uc[MT];  // the thread's first cell in it
  __device__ Cells(int M, int U) {
    const int lane = threadIdx.x & 31;
    const int n = BF ? (M / 16) * (U / 8) : (M / 4) * (U / 2);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int i = BF ? (threadIdx.x >> 5) + (THREADS / 32) * j : threadIdx.x;
      on[j] = i < n;
      r0[j] = BF ? (i % (M / 16)) * 16 : (i % (M / 4)) * 4;
      u0[j] = BF ? (i / (M / 16)) * 8 : (i / (M / 4)) * 2;
      rc[j] = r0[j] + (BF ? lane / 4 : 0);
      uc[j] = u0[j] + (BF ? 2 * (lane & 3) : 0);
    }
  }
  __device__ int row(int j, int e) const { return rc[j] + (BF ? 8 * (e >> 1) : e / 2); }
  __device__ int unit(int j, int e) const { return uc[j] + (BF ? (e & 1) : e % 2); }
};

// x_t of a tile staged through registers: chunks of 16 bytes (8 bf16 or 4
// float32 values of one row), loaded early in a step and stored into shared
// memory late in it. Rows past nb and channels past C are zeros.
template <typename T>
struct XStage {
  static constexpr int V = 16 / sizeof(T);
  uint4 r[XCH];
  __device__ void load(const T* x, int tm, int t, long b0, int nb, int B, int T_, int C,
                       int M) {
    const int cpr = (C + V - 1) / V;
    const bool vec = C % V == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = threadIdx.x + THREADS * i;
      r[i] = make_uint4(0, 0, 0, 0);
      if (ch >= M * cpr) continue;
      const int m = ch / cpr, k0 = (ch % cpr) * V;
      if (m >= nb) continue;
      const T* src = x + seq_row(tm, t, b0 + m, B, T_) * C + k0;
      if (vec) {
        r[i] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        T v[V];
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = k0 + q < C ? src[q] : T(0.f);
        r[i] = *reinterpret_cast<uint4*>(v);
      }
    }
  }
  // into the x columns [0, C) of a [M][ld] bf16 tile or a [k][M] float32 tile
  __device__ void store(T* A, int ld, int C, int M) const {
    const int cpr = (C + V - 1) / V;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = threadIdx.x + THREADS * i;
      if (ch >= M * cpr) continue;
      const int m = ch / cpr, k0 = (ch % cpr) * V;
      if (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(A + (long)m * ld + k0) = r[i];
      } else {
        const float* v = reinterpret_cast<const float*>(&r[i]);
#pragma unroll
        for (int q = 0; q < V; ++q)
          if (k0 + q < C) reinterpret_cast<float*>(A)[(long)(k0 + q) * M + m] = v[q];
      }
    }
  }
};

// float32: acc[q][e] += sum over k in [k0, k1) of A[k][r0 + e / 2] * W(k, q, u0 + e % 2),
// W(k, q, u) = w[k * ldk + q * ldq + u] (shared memory or device memory)
__device__ __forceinline__ void fma_panel(float (&acc)[4][8], const float* A, int M, int r0,
                                          int k0, int k1, const float* w, long ldk, int ldq,
                                          int u0) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + (long)k * M + r0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float* wk = w + (long)(k - k0) * ldk + u0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 wv = *reinterpret_cast<const float2*>(wk + q * ldq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[q][2 * i] += av[i] * wv.x;
        acc[q][2 * i + 1] += av[i] * wv.y;
      }
    }
  }
}

// ------------------------------------------------------------------ forward
struct FwdParams {
  const void* x;      // [B, T, C] or [T, B, C] (dot dtype T); proj = 0: xp [T, B, 4H]
  const void* h0;     // [B, H]     (state dtype)
  const void* c0;     // [B, H]
  const void* w_ih;   // [C, 4H]    (T), null when proj = 0
  const float* bias;  // [4H], null when proj = 0
  const void* w_hh;   // [H, 4H]    (T)
  void* y;            // [B, T, H] or [T, B, H]  (T)
  void* hT;           // [B, H]     (state dtype)
  void* cT;           // [B, H]
  void* gates;        // [T, B, 4H] (T) activated gates, or null
  void* cseq;         // [T, B, H]  (T) cell states, or null
  int B, T, C, H, reverse, s_bf16, proj, x_tm;  // proj = 0: C = 0
  int CL, U, M, Cp, nbuf;                       // the plan
};

// shared memory of the forward (bytes), in the order of the layout below
__host__ __device__ inline long fwd_smem_bytes(int bf, int CL, int U, int M, int Cp, int nbuf) {
  const long Hp = (long)CL * U, Kp = Cp + Hp, NC = 4L * U;
  if (bf) return NC * (Kp + 8) * 2 + (long)nbuf * M * (Kp + 8) * 2 + NC * 4;
  return Kp * NC * 4 + (long)nbuf * Kp * M * 4 + NC * 4;
}

// A step: the products from the h | x tile, then the cell update in
// registers; h goes to every peer's next tile and x_{t+1} into this CTA's
// before the cluster barrier's arrive, the stores of y, the gates and c_t
// after it, so that they overlap the barrier. With one tile (nbuf = 1) a
// second barrier first lets every CTA finish reading it.
template <typename T, bool PROJ>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_cluster(FwdParams p) {
  constexpr bool BF = sizeof(T) == 2;
  using Cl = Cells<BF>;
  constexpr int CE = Cl::CE, MT = Cl::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, Tn = p.T, C = p.C, H = p.H, G = 4 * H;
  const int CL = p.CL, U = p.U, M = p.M, Cp = p.Cp, Hp = CL * U, Kp = Cp + Hp, NC = 4 * U;
  const int rank = (int)cg::this_cluster().block_rank();
  const int uoff = rank * U;  // the CTA's first unit
  const Cl cells(M, U);
  // layout: W_s, then the h | x tiles, then the bias slice
  const int ldw = BF ? Kp + 8 : NC;                       // bf16 [NC][ldw]; f32 [k][NC]
  const int lda = BF ? Kp + 8 : M;                        // bf16 [M][lda]; f32 [Kp][M]
  const int a_elems = BF ? M * lda : Kp * M;
  T* W_s = reinterpret_cast<T*>(smem);
  T* A_s = W_s + Kp * NC + (BF ? 8 * NC : 0);
  float* bias_s = reinterpret_cast<float*>(A_s + p.nbuf * a_elems);
  const T* x = static_cast<const T*>(p.x);
  const T* w_ih = static_cast<const T*>(p.w_ih);
  const T* w_hh = static_cast<const T*>(p.w_hh);
  T* y = static_cast<T*>(p.y);
  T* gates = static_cast<T*>(p.gates);
  T* cseq = static_cast<T*>(p.cseq);
  const int tid = threadIdx.x, g = (tid & 31) >> 2, tq = tid & 3;

  // the weight slice, resident for the whole call: column q * U + u of the
  // CTA is gate q of unit uoff + u; rows k < Cp are W_ih, then W_hh
  for (int idx = tid; idx < Kp * NC; idx += THREADS) {
    const int k = idx / NC, n = idx - k * NC, q = n / U, unit = uoff + n - q * U;
    const int kh = k - Cp;
    float v = 0.f;
    if (unit < H) {
      if (kh >= 0 && kh < H)
        v = ldf(w_hh, (long)kh * G + q * H + unit);
      else if (kh < 0 && k < C)
        v = ldf(w_ih, (long)k * G + q * H + unit);
    }
    if (BF)
      W_s[n * ldw + k] = T(v);
    else
      W_s[k * NC + n] = T(v);
  }
  for (int n = tid; n < NC; n += THREADS) {
    const int q = n / U, unit = uoff + n - q * U;
    bias_s[n] = PROJ && unit < H ? p.bias[q * H + unit] : 0.f;
  }

  const int n_tiles = (B + M - 1) / M;
  const int n_clusters = gridDim.x / CL;
  for (int tile = blockIdx.x / CL; tile < n_tiles; tile += n_clusters) {
    const long b0 = (long)tile * M;
    const int nb = min(M, (int)(B - b0));
    // zero the tiles, then h0 (every unit, rounded) and x of the first step
    for (int idx = tid; idx < p.nbuf * a_elems; idx += THREADS) A_s[idx] = T(0.f);
    __syncthreads();
    for (int idx = tid; idx < nb * H; idx += THREADS) {
      const int m = idx / H, j = idx - m * H;
      const float hv = rnd<T>(lds(p.h0, (b0 + m) * H + j, p.s_bf16));
      if (BF)
        A_s[m * lda + Cp + j] = T(hv);
      else
        A_s[(Cp + j) * M + m] = T(hv);
    }
    float c[MT][CE];
    // the hoisted xp_t of the next step, read a step ahead (it does not depend on h)
    float xp[MT][4][PROJ ? 1 : CE];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
        const bool live = cells.on[j] && m < nb && unit < H;
        c[j][e] = live ? lds(p.c0, (b0 + m) * H + unit, p.s_bf16) : 0.f;
        if constexpr (!PROJ) {
          const int t0 = p.reverse ? Tn - 1 : 0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xp[j][q][e] = live ? ldf(x, ((long)t0 * B + b0 + m) * G + q * H + unit) : 0.f;
        }
      }
    const bool even = H % 2 == 0;  // pairs of units move as one 4- or 8-byte access
    XStage<T> xs;
    if (PROJ) {
      xs.load(x, p.x_tm, p.reverse ? Tn - 1 : 0, b0, nb, B, Tn, C, M);
      xs.store(A_s, lda, C, M);
    }
    __syncthreads();
    cl_sync();  // every CTA of the cluster is in this tile

    for (int s = 0; s < Tn; ++s) {
      const int t = p.reverse ? Tn - 1 - s : s;
      const int b = p.nbuf == 2 ? s & 1 : 0, bn = p.nbuf == 2 ? b ^ 1 : 0;
      const T* A = A_s + b * a_elems;
      const bool more = s + 1 < Tn;
      const int tn = p.reverse ? t - 1 : t + 1;
      if (PROJ && more && p.nbuf == 2) xs.load(x, p.x_tm, tn, b0, nb, B, Tn, C, M);
      float acc[MT][4][CE];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < CE; ++e)
            acc[j][q][e] = PROJ && cells.on[j] ? bias_s[q * U + cells.unit(j, e)] : 0.f;
      // the products: [x_t | h] @ W for the CTA's 4U columns
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (!cells.on[j]) continue;
        if constexpr (BF) {
          const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(A);
          const __nv_bfloat16* Wb =
              reinterpret_cast<const __nv_bfloat16*>(W_s) + (cells.u0[j] + g) * ldw + 2 * tq;
#pragma unroll 2
          for (int k0 = 0; k0 < Kp; k0 += 16) {
            unsigned a[4];
            frag_a(a, Ab, lda, cells.r0[j], k0, g, tq);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat16* wp = Wb + q * U * ldw + k0;
              mma_bf16(acc[j][q], a, ld32(wp), ld32(wp + 8));
            }
          }
        } else {
          const float* Af = reinterpret_cast<const float*>(A);
          const float* Wf = reinterpret_cast<const float*>(W_s);
          const int r0 = cells.r0[j], u0 = cells.u0[j];
          fma_panel(acc[j], Af, M, r0, 0, Kp, Wf, NC, U, u0);
        }
      }
      if (p.nbuf == 1) {
        cl_sync();  // every CTA has read the one h | x tile
        if (PROJ && more) xs.load(x, p.x_tm, tn, b0, nb, B, Tn, C, M);
      }
      // the cell update in registers: acc becomes the activated gates
      float hv[MT][CE];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          float pre[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (PROJ)
              pre[q] = acc[j][q][e];
            else
              pre[q] = xp[j][q][e] + acc[j][q][e];
          }
          acc[j][0][e] = sigm(pre[0]);
          acc[j][1][e] = sigm(pre[1]);
          acc[j][2][e] = tnh(pre[2]);
          acc[j][3][e] = sigm(pre[3]);
          const float cn = acc[j][1][e] * c[j][e] + acc[j][0][e] * acc[j][2][e];
          const float h = acc[j][3][e] * tnh(cn);
          c[j][e] = cn;
          hv[j][e] = rnd<T>(h);
          const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
          if (!more && cells.on[j] && m < nb && unit < H) {
            sts(p.hT, (b0 + m) * H + unit, h, p.s_bf16);
            sts(p.cT, (b0 + m) * H + unit, cn, p.s_bf16);
          }
        }
      if (more) {
        T* An = A_s + bn * a_elems;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (!cells.on[j]) continue;
          const int k_h = Cp + uoff + cells.u0[j];
          for (int r = 0; r < CL; ++r) {
            T* dst = peer(An, r);
            if constexpr (BF) {
              const int m0 = cells.rc[j], kk = k_h + 2 * tq;
              *reinterpret_cast<unsigned*>(dst + m0 * lda + kk) =
                  pack_bf16(hv[j][0], hv[j][1]);
              *reinterpret_cast<unsigned*>(dst + (m0 + 8) * lda + kk) =
                  pack_bf16(hv[j][2], hv[j][3]);
            } else {
              float* df = reinterpret_cast<float*>(dst);
              const int r0 = cells.r0[j];
#pragma unroll
              for (int v = 0; v < 2; ++v)
                *reinterpret_cast<float4*>(df + (k_h + v) * M + r0) =
                    make_float4(hv[j][v], hv[j][2 + v], hv[j][4 + v], hv[j][6 + v]);
            }
          }
        }
        if (PROJ) xs.store(An, lda, C, M);
      }
      cl_arrive();  // h of the next step is on its way to every CTA's tile
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < CE; e += 2) {  // cells e, e + 1: one row, units u, u + 1
          const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
          if (!cells.on[j] || m >= nb || unit >= H) continue;
          const long row = b0 + m;
          const bool two = unit + 1 < H, pair = two && even;
          st2(y, seq_row(p.x_tm, t, row, B, Tn) * H + unit, hv[j][e], hv[j][e + 1], two, pair);
          if (gates != nullptr) {
            const long gi = ((long)t * B + row) * G + unit;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              st2(gates, gi + q * H, acc[j][q][e], acc[j][q][e + 1], two, pair);
          }
          if (cseq != nullptr)
            st2(cseq, ((long)t * B + row) * H + unit, c[j][e], c[j][e + 1], two, pair);
          if constexpr (!PROJ) {
            if (more)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 v = ld2(x, ((long)tn * B + row) * G + q * H + unit, two, pair);
                xp[j][q][e] = v.x;
                xp[j][q][e + 1] = v.y;
              }
          }
        }
      cl_wait();
    }
  }
}

// -------------------------------------------------- backward (a): recurrence
struct BwdParams {
  const void* h0;      // [B, H]     (state dtype)
  const void* c0;      // [B, H]
  const void* w_hh;    // [H, 4H]    (T)
  const void* gates;   // [T, B, 4H] (T)
  const void* cseq;    // [T, B, H]  (T)
  const void* dy;      // y's layout (T)
  const float* dhT;    // [B, H]
  const float* dcT;    // [B, H]
  float* dh0;          // [B, H]
  float* dc0;          // [B, H]
  void* dg;            // [T, B, 4H] (T) dgates rounded to the dot dtype: scratch,
                       // or the output dxp_t when proj = 0
  float* db_part;      // [B, 4H] each row's dbias summed over T, or null
  int B, T, H, reverse, s_bf16, proj, x_tm;
  int CL, U, M, nbuf;  // the plan
};

__host__ __device__ inline long bwd_smem_bytes(int bf, int CL, int U, int M, int nbuf) {
  const long Hp = (long)CL * U, NC = 4L * U;
  const long part = (long)nbuf * CL * M * U * 4;
  if (bf) return Hp * (NC + 8) * 2 + (long)M * (NC + 8) * 2 + part;
  return NC * Hp * 4 + NC * M * 4 + part;
}

// The residuals one cell's dgates need at step t: the activated gates, c_t,
// c_{t-1} (c0 at the forward's first step) and dy_t.
struct Resid {
  float ig, fg, gg, og, cn, cp, dy;
};

// A step: dgates of the CTA's cells from registers (the residuals were read
// a step ahead), the partial dh of every unit from this CTA's dgates to each
// owner's buffer, the cluster barrier's arrive, the dgates' stores while it
// completes, then each owner sums the CL partials in rank order.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_cluster(BwdParams p) {
  constexpr bool BF = sizeof(T) == 2;
  using Cl = Cells<BF>;
  constexpr int CE = Cl::CE, MT = Cl::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.B, Tn = p.T, H = p.H, G = 4 * H;
  const int CL = p.CL, U = p.U, M = p.M, Hp = CL * U, NC = 4 * U;
  const int rank = (int)cg::this_cluster().block_rank();
  const int uoff = rank * U;
  const Cl cells(M, U);
  // layout: W_s (bf16 [Hp][NC + 8]: W_hh[j][the CTA's columns]; f32 [NC][Hp]),
  // dg_s (bf16 [M][NC + 8]; f32 [NC][M]), then part [nbuf][CL][M][U] (bf16)
  // or [nbuf][CL][U][M] (f32): the partial dh each rank sends this CTA
  const int ldw = BF ? NC + 8 : Hp, ldg = BF ? NC + 8 : M;
  T* W_s = reinterpret_cast<T*>(smem);
  T* dg_s = W_s + (BF ? Hp * ldw : NC * Hp);
  float* part = reinterpret_cast<float*>(dg_s + (BF ? M * ldg : NC * M));
  const int part_buf = CL * M * U;
  const T* w_hh = static_cast<const T*>(p.w_hh);
  const T* gates = static_cast<const T*>(p.gates);
  const T* cseq = static_cast<const T*>(p.cseq);
  const T* dy = static_cast<const T*>(p.dy);
  T* dg = static_cast<T*>(p.dg);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;

  for (int idx = tid; idx < Hp * NC; idx += THREADS) {
    const int jr = idx / NC, n = idx - jr * NC, q = n / U, unit = uoff + n - q * U;
    const float v = jr < H && unit < H ? ldf(w_hh, (long)jr * G + q * H + unit) : 0.f;
    if (BF)
      W_s[jr * ldw + n] = T(v);
    else
      W_s[n * Hp + jr] = T(v);
  }

  const int n_tiles = (B + M - 1) / M;
  const int n_clusters = gridDim.x / CL;
  for (int tile = blockIdx.x / CL; tile < n_tiles; tile += n_clusters) {
    const long b0 = (long)tile * M;
    const int nb = min(M, (int)(B - b0));
    for (int idx = tid; idx < (BF ? M * ldg : NC * M); idx += THREADS) dg_s[idx] = T(0.f);
    float dh[MT][CE], dc[MT][CE], db[MT][4][CE];
    Resid rs[MT][CE];
    // the residuals of the step s (t = time of s), zeros outside the tile
    auto load_resid = [&](int s) {
      const int t = p.reverse ? Tn - 1 - s : s;
      const int tp = p.reverse ? t + 1 : t - 1;
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
          Resid& r = rs[j][e];
          r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (!cells.on[j] || m >= nb || unit >= H) continue;
          const long row = b0 + m;
          const long gb = ((long)t * B + row) * G + unit;
          r.ig = ldf(gates, gb);
          r.fg = ldf(gates, gb + H);
          r.gg = ldf(gates, gb + 2 * H);
          r.og = ldf(gates, gb + 3 * H);
          r.cn = ldf(cseq, ((long)t * B + row) * H + unit);
          if (s == 0) {
            const float c0 = lds(p.c0, row * H + unit, p.s_bf16);
            r.cp = p.proj ? c0 : rnd<T>(c0);
          } else {
            r.cp = ldf(cseq, ((long)tp * B + row) * H + unit);
          }
          r.dy = ldf(dy, seq_row(p.x_tm, t, row, B, Tn) * H + unit);
        }
    };
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
        const bool live = cells.on[j] && m < nb && unit < H;
        dh[j][e] = live ? p.dhT[(b0 + m) * H + unit] : 0.f;
        dc[j][e] = live ? p.dcT[(b0 + m) * H + unit] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) db[j][q][e] = 0.f;
      }
    load_resid(Tn - 1);
    __syncthreads();
    cl_sync();  // every CTA of the cluster is in this tile

    // s walks the forward's steps backwards; s == 0 is its first step
    for (int s = Tn - 1; s >= 0; --s) {
      const int t = p.reverse ? Tn - 1 - s : s;
      const int b = p.nbuf == 2 ? s & 1 : 0;
      // (1) dgates of the CTA's cells, elementwise
      float d[MT][4][CE];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          const Resid& r = rs[j][e];
          const float tc = tnh(r.cn);
          const float dhv = dh[j][e] + r.dy;
          const float dcv = dc[j][e] + dhv * r.og * (1.f - tc * tc);
          d[j][0][e] = dcv * r.gg * r.ig * (1.f - r.ig);
          d[j][1][e] = dcv * r.cp * r.fg * (1.f - r.fg);
          d[j][2][e] = dcv * r.ig * (1.f - r.gg * r.gg);
          d[j][3][e] = dhv * tc * r.og * (1.f - r.og);
          dc[j][e] = dcv * r.fg;
          if (!cells.on[j]) continue;
          const int m = cells.row(j, e), u = cells.unit(j, e);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            db[j][q][e] += d[j][q][e];
            if (BF)
              dg_s[m * ldg + q * U + u] = T(d[j][q][e]);
            else
              dg_s[(q * U + u) * M + m] = T(d[j][q][e]);
          }
        }
      if (s > 0) load_resid(s - 1);
      __syncthreads();
      // (2) partial dh of every unit from the CTA's dgates, each owner's part
      // to its buffer
      if (p.nbuf == 1 && s != Tn - 1) cl_sync();  // every owner has read the parts
      float* pb = part + b * part_buf + rank * M * U;
      if constexpr (BF) {
        const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(dg_s);
        const __nv_bfloat16* Wb = reinterpret_cast<const __nv_bfloat16*>(W_s);
        const int mt = M / 16, n_out = mt * (Hp / 8);
        for (int ot = warp; ot < n_out; ot += THREADS / 32) {
          const int m0 = (ot % mt) * 16, j0 = (ot / mt) * 8;
          float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int k0 = 0; k0 < NC; k0 += 16) {
            unsigned a[4];
            frag_a(a, Ab, ldg, m0, k0, g, tq);
            const __nv_bfloat16* wp = Wb + (j0 + g) * ldw + k0 + 2 * tq;
            mma_bf16(o, a, ld32(wp), ld32(wp + 8));
          }
          const int jj = j0 + 2 * tq, owner = jj / U, u = jj - owner * U;
          float* dst = peer(pb, owner);
          *reinterpret_cast<float2*>(dst + (m0 + g) * U + u) = make_float2(o[0], o[1]);
          *reinterpret_cast<float2*>(dst + (m0 + g + 8) * U + u) = make_float2(o[2], o[3]);
        }
      } else {
        const float* Af = reinterpret_cast<const float*>(dg_s);
        const float* Wf = reinterpret_cast<const float*>(W_s);
        const int rt = M / 4, n_out = rt * (Hp / 8);
        for (int ot = tid; ot < n_out; ot += THREADS) {
          const int r0 = (ot % rt) * 4, j0 = (ot / rt) * 8;
          float o[4][8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int v = 0; v < 8; ++v) o[i][v] = 0.f;
#pragma unroll 4
          for (int k = 0; k < NC; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(Af + k * M + r0);
            const float4 w0 = *reinterpret_cast<const float4*>(Wf + k * Hp + j0);
            const float4 w1 = *reinterpret_cast<const float4*>(Wf + k * Hp + j0 + 4);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int v = 0; v < 8; ++v) o[i][v] += av[i] * wv[v];
          }
          const int owner = j0 / U, u = j0 - owner * U;
          float* dst = peer(pb, owner);
#pragma unroll
          for (int v = 0; v < 8; ++v)
            *reinterpret_cast<float4*>(dst + (u + v) * M + r0) =
                make_float4(o[0][v], o[1][v], o[2][v], o[3][v]);
        }
      }
      cl_arrive();
      // the dgates, rounded to the dot dtype, while the parts arrive
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < CE; e += 2) {
          const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
          if (!cells.on[j] || m >= nb || unit >= H) continue;
          const long gb = ((long)t * B + b0 + m) * G + unit;
          const bool two = unit + 1 < H, pair = two && H % 2 == 0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st2(dg, gb + q * H, d[j][q][e], d[j][q][e + 1], two, pair);
        }
      cl_wait();  // (3) every part of this step has arrived: the owners sum them
      const float* pin = part + b * part_buf;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (!cells.on[j]) continue;
        if constexpr (BF) {  // cells (e, e + 1): one row, neighbouring units
#pragma unroll
          for (int e = 0; e < CE; e += 2) {
            const int m = cells.row(j, e), u = cells.unit(j, e);
            float2 v = make_float2(0.f, 0.f);
            for (int r = 0; r < CL; ++r) {
              const float2 w = *reinterpret_cast<const float2*>(pin + (r * M + m) * U + u);
              v.x += w.x;
              v.y += w.y;
            }
            dh[j][e] = v.x;
            dh[j][e + 1] = v.y;
          }
        } else {  // cells (v, v + 2, v + 4, v + 6): four rows of unit u0 + v
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int r = 0; r < CL; ++r) {
              const float4 w = *reinterpret_cast<const float4*>(
                  pin + (r * U + cells.u0[j] + v) * M + cells.r0[j]);
              a.x += w.x;
              a.y += w.y;
              a.z += w.z;
              a.w += w.w;
            }
            dh[j][v] = a.x;
            dh[j][2 + v] = a.y;
            dh[j][4 + v] = a.z;
            dh[j][6 + v] = a.w;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        const int m = cells.row(j, e), unit = uoff + cells.unit(j, e);
        if (!cells.on[j] || m >= nb || unit >= H) continue;
        const long row = b0 + m;
        p.dh0[row * H + unit] = dh[j][e];
        p.dc0[row * H + unit] = dc[j][e];
        if (p.proj)
#pragma unroll
          for (int q = 0; q < 4; ++q) p.db_part[row * G + q * H + unit] = db[j][q][e];
      }
    __syncthreads();
  }
}

// ------------------------------- backward (b): the products off the chain
struct ProdParams {
  const void* x;     // [B, T, C] or [T, B, C] (T); null when C = 0
  const void* h0;    // [B, H]     (state dtype)
  const void* y;     // x's layout, H wide (T)
  const void* dg;    // [T, B, 4H] (T)
  const void* w_ih;  // [C, 4H]    (T), or null
  float* w_part;     // [n_split, H + C, 4H] partial [dW_hh; dW_ih]
  void* dx;          // x's layout (T), or null
  const float* bias; // [4H] (XPROJ)
  float* xp;         // [T, B, 4H] x @ W_ih + bias in float32 (XPROJ)
  int B, T, C, H, reverse, s_bf16, rows_per_split, x_tm;
};

enum ProdMode { WGRAD, DX, XPROJ };

// One BM x BN tile of out = A @ B over k, staged BK deep through shared
// memory; data row r = t * B + b (the [T, B, *] order of the scratch).
//   WGRAD: out = [h_prev | x]^T @ dgates: A(m, r) the feature m of row r,
//          B(r, n) = dgates[r][n], k over the rows of split blockIdx.y, out
//          to w_part[blockIdx.y];
//   DX:    out = dgates @ W_ih^T: A(r, k) = dgates[r][k], B(k, n) = W_ih[n][k],
//          k over 4H, out to dx in x's layout;
//   XPROJ: out = x @ W_ih + bias: A(r, k) = x of row r, B(k, n) = W_ih[k][n],
//          k over C, out to xp [T, B, 4H] (float32 only: the forward's x
//          projection where W_ih does not fit beside the tile).
// Each thread moves 16-byte chunks along the operand's contiguous axis, the
// next block's while this one is computed. bf16: mma.sync, warp w owns rows
// 64 (w % 2) .. + 64 and columns 32 (w / 2) .. + 32 (4 x 4 mma tiles); the
// weight gradient keeps both operands k-major as they arrive ([k][m], [k][n])
// and reads its fragments with ldmatrix.trans; f32: 8 x 8 outputs a thread
// on the CUDA cores.
template <typename T, int MODE>
__device__ __forceinline__ void prod_tile(const ProdParams& p) {
  constexpr bool WGRAD = MODE == ProdMode::WGRAD;
  constexpr bool A_K = MODE != ProdMode::WGRAD;  // A runs along k (else along m)
  constexpr bool B_K = MODE == ProdMode::DX;     // B runs along k (else along n)
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LD = BK + 8;                 // bf16 [m or n][LD]
  constexpr int LDT = BM + 8;                // bf16 weight gradient [k][LDT]
  constexpr int V = 16 / sizeof(T);          // elements a chunk
  constexpr int NCH = BM * BK / V / THREADS;  // chunks a thread, per operand
  __shared__ __align__(16) T As[BF ? BM * LD : BK * BM];
  __shared__ __align__(16) T Bs[BF ? BN * LD : BK * BN];
  const int B = p.B, Tn = p.T, C = p.C, H = p.H, G = 4 * H, K = H + C;
  const int R = B * Tn;  // the wrapper keeps B * T below 2^31
  const T* x = static_cast<const T*>(p.x);
  const T* y = static_cast<const T*>(p.y);
  const T* dg = static_cast<const T*>(p.dg);
  const T* w_ih = static_cast<const T*>(p.w_ih);
  const int Mdim = WGRAD ? K : R, Ndim = MODE == ProdMode::DX ? C : G;
  const int tiles_n = (Ndim + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int k_begin = WGRAD ? blockIdx.y * p.rows_per_split : 0;
  const int k_end = WGRAD ? min(R, k_begin + p.rows_per_split)
                          : (MODE == ProdMode::DX ? G : C);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  // chunks need whole 16-byte runs inside one source row
  const bool vec = (WGRAD ? H % V == 0 && C % V == 0
                          : G % V == 0 && (MODE == ProdMode::DX || C % V == 0)) &&
                   ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y) |
                     reinterpret_cast<size_t>(dg) | reinterpret_cast<size_t>(w_ih)) & 15) == 0;

  // A(m, k) and B(k, n) element by element (k global), 0 outside
  auto a_at = [&](int m, int k) -> float {
    if (m >= Mdim || k >= k_end) return 0.f;
    if (MODE == ProdMode::DX) return ldf(dg, (long)m * G + k);
    if (MODE == ProdMode::XPROJ) {
      const int t = m / B, b = m - t * B;
      return ldf(x, seq_row(p.x_tm, t, b, B, Tn) * C + k);
    }
    const int t = k / B, b = k - t * B;
    if (m >= H) return ldf(x, seq_row(p.x_tm, t, b, B, Tn) * C + (m - H));
    const bool first = p.reverse ? t == Tn - 1 : t == 0;
    const int tp = p.reverse ? t + 1 : t - 1;
    return first ? rnd<T>(lds(p.h0, (long)b * H + m, p.s_bf16))
                 : ldf(y, seq_row(p.x_tm, tp, b, B, Tn) * H + m);
  };
  auto b_at = [&](int k, int n) -> float {
    if (n >= Ndim || k >= k_end) return 0.f;
    return B_K ? ldf(w_ih, (long)n * G + k) : MODE == ProdMode::XPROJ
                                                  ? ldf(w_ih, (long)k * G + n)
                                                  : ldf(dg, (long)k * G + n);
  };
  // chunk c of an operand: (m or n, k) of its first element, running along k
  // (along_k) or along m / n
  auto pos = [&](bool along_k, int c, int& mm, int& kk) {
    if (along_k) { mm = c / (BK / V); kk = (c % (BK / V)) * V; }
    else { kk = c / (BM / V); mm = (c % (BM / V)) * V; }
  };
  uint4 ra[NCH], rb[NCH];
  auto load = [&](int kc) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = tid + THREADS * i;
      int mm, kk;
      pos(A_K, c, mm, kk);
      int m = m0 + mm, k = kc + kk;
      T va[V], vb[V];
      const T* src = nullptr;
      if (vec && k < k_end && (A_K ? m < Mdim && k + V <= k_end : m + V <= Mdim)) {
        if (WGRAD) {
          const int t = k / B, b = k - t * B;
          const bool first = p.reverse ? t == Tn - 1 : t == 0;
          if (m >= H) src = x + seq_row(p.x_tm, t, b, B, Tn) * C + (m - H);
          else if (!first) src = y + seq_row(p.x_tm, p.reverse ? t + 1 : t - 1, b, B, Tn) * H + m;
        } else if (MODE == ProdMode::DX) {
          src = dg + (long)m * G + k;
        } else {
          const int t = m / B, b = m - t * B;
          src = x + seq_row(p.x_tm, t, b, B, Tn) * C + k;
        }
      }
      if (src != nullptr) {
        ra[i] = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) va[v] = T(A_K ? a_at(m, k + v) : a_at(m + v, k));
        ra[i] = *reinterpret_cast<uint4*>(va);
      }
      pos(B_K, c, mm, kk);  // B: (k, n .. n + V) or (k .. k + V, n)
      const int n = n0 + mm;
      k = kc + kk;
      const T* bsrc = nullptr;
      if (vec && k < k_end && (B_K ? n < Ndim && k + V <= k_end : n + V <= Ndim))
        bsrc = B_K ? w_ih + (long)n * G + k
                   : (MODE == ProdMode::XPROJ ? w_ih : dg) + (long)k * G + n;
      if (bsrc != nullptr) {
        rb[i] = *reinterpret_cast<const uint4*>(bsrc);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) vb[v] = T(B_K ? b_at(k + v, n) : b_at(k, n + v));
        rb[i] = *reinterpret_cast<uint4*>(vb);
      }
    }
  };
  // into the tiles: bf16 As[m][k], Bs[n][k]; f32 As[k][m], Bs[k][n]
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = tid + THREADS * i;
      int mm, kk;
      pos(A_K, c, mm, kk);
      const T* va = reinterpret_cast<const T*>(&ra[i]);
      if (BF && WGRAD)  // k-major tiles [k][LDT]
        *reinterpret_cast<uint4*>(As + kk * LDT + mm) = ra[i];
      else if (BF == A_K)  // the chunk runs along the tile's contiguous axis
        *reinterpret_cast<uint4*>(BF ? As + mm * LD + kk : As + kk * BM + mm) = ra[i];
      else
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (BF)
            As[(mm + v) * LD + kk] = va[v];
          else
            As[(kk + v) * BM + mm] = va[v];
        }
      pos(B_K, c, mm, kk);
      const T* vb = reinterpret_cast<const T*>(&rb[i]);
      if (BF && WGRAD)
        *reinterpret_cast<uint4*>(Bs + kk * LDT + mm) = rb[i];
      else if (BF == B_K)
        *reinterpret_cast<uint4*>(BF ? Bs + mm * LD + kk : Bs + kk * BN + mm) = rb[i];
      else
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (BF)
            Bs[(mm + v) * LD + kk] = vb[v];
          else
            Bs[(kk + v) * BN + mm] = vb[v];
        }
    }
  };

  // bf16: acc[mt * 4 + nt][e]; f32: acc[row][col]
  float acc[BF ? 16 : 8][BF ? 4 : 8];
#pragma unroll
  for (int i = 0; i < (BF ? 16 : 8); ++i)
#pragma unroll
    for (int j = 0; j < (BF ? 4 : 8); ++j) acc[i][j] = 0.f;
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;  // bf16: the warp's block
  const int tx = tid % 16, ty = tid / 16;                 // f32: the thread's block

  if (k_begin < k_end) load(k_begin);
  for (int kc = k_begin; kc < k_end; kc += BK) {
    store();
    __syncthreads();
    if (kc + BK < k_end) load(kc + BK);
    if constexpr (BF && WGRAD) {
      const __nv_bfloat16* At = reinterpret_cast<const __nv_bfloat16*>(As);
      const __nv_bfloat16* Bt = reinterpret_cast<const __nv_bfloat16*>(Bs);
      const int lr = tid & 7, lq = (tid >> 3) & 3;  // row of, and which, 8 x 8 matrix
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        unsigned b[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {  // n-tiles 2 jj, 2 jj + 1: b0 and b1 of each
          unsigned r[4];
          ldsm_x4_t(r, Bt + (k0 + lr + (lq & 1) * 8) * LDT + wn + 16 * jj + (lq >> 1) * 8);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned a[4];
          ldsm_x4_t(a, At + (k0 + lr + (lq >> 1) * 8) * LDT + wm + 16 * i + (lq & 1) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i * 4 + j], a, b[j][0], b[j][1]);
        }
      }
    } else if constexpr (BF) {
      const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(As);
      const __nv_bfloat16* Bb = reinterpret_cast<const __nv_bfloat16*>(Bs);
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        unsigned b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* bp = Bb + (wn + j * 8 + g) * LD + k0 + 2 * tq;
          b[j][0] = ld32(bp);
          b[j][1] = ld32(bp + 8);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned a[4];
          frag_a(a, Ab, LD, wm + i * 16, k0, g, tq);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i * 4 + j], a, b[j][0], b[j][1]);
        }
      }
    } else {
      const float* Af = reinterpret_cast<const float*>(As);
      const float* Bf = reinterpret_cast<const float*>(Bs);
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(Af + kk * BM + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(Af + kk * BM + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bf + kk * BN + tx * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(Bf + kk * BN + tx * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
  // the epilogue by runs of neighbouring columns: bf16 the mma's pairs, f32
  // the thread's 8; vector stores where the run is whole and aligned
  constexpr int RUN = BF ? 2 : 8;
  const bool vout = MODE == ProdMode::DX ? C % RUN == 0 : G % RUN == 0;
#pragma unroll
  for (int i = 0; i < (BF ? 16 : 8); ++i)
#pragma unroll
    for (int j0 = 0; j0 < (BF ? 4 : 8); j0 += RUN) {
      // bf16: mma tile i (m-tile i / 4, n-tile i % 4), elements j0, j0 + 1;
      // f32: row i, columns 0 .. 7
      const int m = BF ? m0 + wm + (i / 4) * 16 + g + 8 * (j0 >> 1) : m0 + ty * 8 + i;
      const int n = BF ? n0 + wn + (i % 4) * 8 + 2 * tq : n0 + tx * 8;
      if (m >= Mdim || n >= Ndim) continue;
      const float* v = &acc[i][j0];
      long base;
      if (WGRAD) {
        base = ((long)blockIdx.y * K + m) * G + n;
      } else if (MODE == ProdMode::DX) {
        const int t = m / B, b = m - t * B;
        base = seq_row(p.x_tm, t, b, B, Tn) * C + n;
      } else {
        base = (long)m * G + n;
      }
      float w[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r)
        w[r] = MODE == ProdMode::XPROJ && n + r < Ndim ? v[r] + p.bias[n + r] : v[r];
      if (vout && n + RUN <= Ndim) {
        if (MODE == ProdMode::DX) {
          T* d = static_cast<T*>(p.dx) + base;
          if constexpr (BF) {
            *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(w[0], w[1]);
          } else {
            reinterpret_cast<float4*>(d)[0] = make_float4(w[0], w[1], w[2], w[3]);
            reinterpret_cast<float4*>(d)[1] = make_float4(w[4], w[5], w[6], w[7]);
          }
        } else {
          float* d = (WGRAD ? p.w_part : p.xp) + base;
#pragma unroll
          for (int r = 0; r < RUN; r += 2)
            *reinterpret_cast<float2*>(d + r) = make_float2(w[r], w[r + 1]);
        }
      } else {
        for (int r = 0; r < RUN && n + r < Ndim; ++r) {
          if (MODE == ProdMode::DX)
            stf(static_cast<T*>(p.dx), base + r, w[r]);
          else
            (WGRAD ? p.w_part : p.xp)[base + r] = w[r];
        }
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_wgrad_prod(ProdParams p) {
  prod_tile<T, ProdMode::WGRAD>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_dx_prod(ProdParams p) {
  prod_tile<T, ProdMode::DX>(p);
}

__global__ void __launch_bounds__(THREADS) lstm_xproj_prod(ProdParams p) {
  prod_tile<float, ProdMode::XPROJ>(p);
}

// sums the row-range partials and (proj) the per-row dbias, each in a fixed order
__global__ void lstm_wgrad_reduce(const float* w_part, const float* db_part, float* dw_hh,
                                  float* dw_ih, float* dbias, int H, int C, int n_split,
                                  int B, int proj) {
  const int G = 4 * H;
  const long KG = (long)(H + C) * G;
  const long total = KG + (proj ? G : 0);
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (idx < KG) {
      for (int z = 0; z < n_split; ++z) s += w_part[z * KG + idx];
      if (idx < (long)H * G)
        dw_hh[idx] = s;
      else
        dw_ih[idx - (long)H * G] = s;
    } else {
      const long n = idx - KG;
      for (int b = 0; b < B; ++b) s += db_part[(long)b * G + n];
      dbias[n] = s;
    }
  }
}

// ------------------------------------------------------------------ launches
// the plan's constraints (ops/lstm_train_kernel.py `_plan`), checked again here
bool plan_ok(int bf, int H, int C, int CL, int U, int M, int Cp, int nbuf) {
  const int Hp = CL * U;
  if (!(CL == 1 || CL == 2 || CL == 4 || CL == 8) || U <= 0 || U % 8 || Hp % 16 || Hp < H)
    return false;
  if (M <= 0 || nbuf < 1 || nbuf > 2) return false;
  if (bf) {
    if (M % 16 || Cp % 16 || Cp < C || (M / 16) * (U / 8) > 2 * (THREADS / 32)) return false;
  } else {
    if (M % 4 || Cp != C || (M / 4) * (U / 2) > THREADS) return false;
  }
  const int V = bf ? 8 : 4;
  return (long)M * ((C + V - 1) / V) <= (long)XCH * THREADS;
}

// the clusters of CL CTAs with `smem` bytes each that fit on the card at once
template <typename P>
cudaError_t max_clusters(void (*kernel)(P), int CL, size_t smem, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute* attr, int* clusters) {
  // the kernel's limit stays at the most a block may use: launches of other
  // plans must not find it lowered
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err == cudaSuccess && *clusters < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// n_clusters clusters of CL CTAs (the wrapper: the row tiles, at most the
// clusters in flight, which it queries once through lstm_train_clusters)
template <typename P>
cudaError_t launch_cluster(void (*kernel)(P), const P& params, int CL, int n_clusters,
                           size_t smem, cudaStream_t stream) {
  static const void* opened[16];  // kernels whose shared-memory limit is raised
  int i = 0;
  while (i < 16 && opened[i] != nullptr && opened[i] != (const void*)kernel) ++i;
  if (i == 16 || opened[i] == nullptr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (i < 16) opened[i] = (const void*)kernel;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * n_clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, params);
}

template <typename T>
cudaError_t fwd_launch(const FwdParams& p, int n_clusters, size_t smem, cudaStream_t stream) {
  return p.proj ? launch_cluster(lstm_fwd_cluster<T, true>, p, p.CL, n_clusters, smem, stream)
                : launch_cluster(lstm_fwd_cluster<T, false>, p, p.CL, n_clusters, smem, stream);
}

// float32 where W_ih does not fit beside the tile: xp = x @ W_ih + bias for
// every step first (tiled product), then the chain on xp as the hoisted
// variant runs it
cudaError_t fwd_launch_xproj(FwdParams p, float* xp, int n_clusters, size_t smem,
                             cudaStream_t stream) {
  const int G = 4 * p.H;
  ProdParams q{p.x, nullptr, nullptr, nullptr, p.w_ih, nullptr, nullptr, p.bias, xp,
               p.B, p.T, p.C, p.H, p.reverse, p.s_bf16, 0, p.x_tm};
  const long tiles = (long)((p.B * p.T + BM - 1) / BM) * ((G + BN - 1) / BN);
  lstm_xproj_prod<<<dim3((unsigned)tiles), THREADS, 0, stream>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.x = xp;
  p.w_ih = nullptr;
  p.bias = nullptr;
  p.C = p.Cp = p.proj = 0;
  return fwd_launch<float>(p, n_clusters, smem, stream);
}

template <typename T>
cudaError_t bwd_launch(const BwdParams& p, const ProdParams& q, float* dw_ih, float* dw_hh,
                       float* dbias, int n_split, int n_clusters, size_t smem,
                       cudaStream_t stream) {
  const int G = 4 * p.H, K = p.H + q.C, R = p.B * p.T;
  cudaError_t err = launch_cluster(lstm_bwd_cluster<T>, p, p.CL, n_clusters, smem, stream);
  if (err != cudaSuccess) return err;
  const dim3 wgrid(((K + BM - 1) / BM) * ((G + BN - 1) / BN), n_split);
  lstm_wgrad_prod<T><<<wgrid, THREADS, 0, stream>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.proj) {
    const long tiles = (long)((R + BM - 1) / BM) * ((q.C + BN - 1) / BN);
    lstm_dx_prod<T><<<dim3((unsigned)tiles), THREADS, 0, stream>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long total = (long)K * G + (p.proj ? G : 0);
  const int blocks = total / 256 + 1 < 4096 ? (int)(total / 256 + 1) : 4096;
  lstm_wgrad_reduce<<<blocks, 256, 0, stream>>>(q.w_part, p.db_part, dw_hh, dw_ih, dbias,
                                                p.H, q.C, n_split, p.B, p.proj);
  return cudaGetLastError();
}

}  // namespace

// xproj = 1 (float32 with the projection, W_ih not resident): xp_scratch
// [T, B, 4H] float32 takes x @ W_ih + bias, and the chain's layout is the
// hoisted one (Cp = 0)
extern "C" int lstm_train_fwd(const void* x, const void* h0, const void* c0,
                              const void* w_ih, const void* bias, const void* w_hh,
                              void* y, void* hT, void* cT, void* gates, void* cseq,
                              void* xp_scratch, int B, int T, int C, int H, int reverse,
                              int x_bf16, int s_bf16, int proj, int x_tm, int CL, int U,
                              int M, int Cp, int nbuf, int xproj, long smem, int n_clusters,
                              void* stream) {
  const long want = fwd_smem_bytes(x_bf16, CL, U, M, Cp, nbuf);
  if ((!proj && (C != 0 || Cp != 0 || !x_tm)) || smem != want || smem > SMEM_MAX ||
      !plan_ok(x_bf16, H, xproj ? 0 : C, CL, U, M, Cp, nbuf) ||
      (xproj && (x_bf16 || !proj || Cp != 0 || xp_scratch == nullptr)) || n_clusters < 1 ||
      n_clusters > (B + M - 1) / M)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{x, h0, c0, w_ih, static_cast<const float*>(bias), w_hh, y, hT, cT, gates,
              cseq, B, T, C, H, reverse, s_bf16, proj, x_tm, CL, U, M, Cp, nbuf};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xproj)
    return static_cast<int>(
        fwd_launch_xproj(p, static_cast<float*>(xp_scratch), n_clusters, smem, s));
  return static_cast<int>(x_bf16 ? fwd_launch<__nv_bfloat16>(p, n_clusters, smem, s)
                                 : fwd_launch<float>(p, n_clusters, smem, s));
}

extern "C" int lstm_train_bwd(const void* x, const void* h0, const void* c0,
                              const void* w_ih, const void* w_hh, const void* y,
                              const void* gates, const void* cseq, const void* dy,
                              const void* dhT, const void* dcT, void* dx, void* dh0,
                              void* dc0, void* dw_ih, void* dw_hh, void* dbias, void* dg,
                              void* db_part, void* w_part, int B, int T, int C, int H,
                              int reverse, int x_bf16, int s_bf16, int n_split,
                              int rows_per_split, int proj, int x_tm, int CL, int U, int M,
                              int nbuf, long smem, int n_clusters, void* stream) {
  const long want = bwd_smem_bytes(x_bf16, CL, U, M, nbuf);
  if ((!proj && (C != 0 || !x_tm)) || !plan_ok(x_bf16, H, 0, CL, U, M, 0, nbuf) ||
      smem != want || smem > SMEM_MAX || rows_per_split % BK || n_clusters < 1 ||
      n_clusters > (B + M - 1) / M)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{h0, c0, w_hh, gates, cseq, dy,
              static_cast<const float*>(dhT), static_cast<const float*>(dcT),
              static_cast<float*>(dh0), static_cast<float*>(dc0), dg,
              static_cast<float*>(db_part), B, T, H, reverse, s_bf16, proj, x_tm,
              CL, U, M, nbuf};
  ProdParams q{x, h0, y, dg, w_ih, static_cast<float*>(w_part), dx, nullptr, nullptr,
               B, T, C, H, reverse, s_bf16, rows_per_split, x_tm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwi = static_cast<float*>(dw_ih);
  float* dwh = static_cast<float*>(dw_hh);
  float* db = static_cast<float*>(dbias);
  const cudaError_t err =
      x_bf16 ? bwd_launch<__nv_bfloat16>(p, q, dwi, dwh, db, n_split, n_clusters, smem, s)
             : bwd_launch<float>(p, q, dwi, dwh, db, n_split, n_clusters, smem, s);
  return static_cast<int>(err);
}

// clusters of the forward (fwd = 1) or backward chain kernel that fit on the
// card at once for a plan's cluster size and shared memory, or a negative
// error code
extern "C" int lstm_train_clusters(int fwd, int x_bf16, int proj, int CL, long smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  cudaError_t err;
  if (fwd && x_bf16)
    err = proj ? max_clusters(lstm_fwd_cluster<__nv_bfloat16, true>, CL, smem, cfg, attr, &n)
               : max_clusters(lstm_fwd_cluster<__nv_bfloat16, false>, CL, smem, cfg, attr, &n);
  else if (fwd)
    err = proj ? max_clusters(lstm_fwd_cluster<float, true>, CL, smem, cfg, attr, &n)
               : max_clusters(lstm_fwd_cluster<float, false>, CL, smem, cfg, attr, &n);
  else if (x_bf16)
    err = max_clusters(lstm_bwd_cluster<__nv_bfloat16>, CL, smem, cfg, attr, &n);
  else
    err = max_clusters(lstm_bwd_cluster<float>, CL, smem, cfg, attr, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" const char* lstm_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
