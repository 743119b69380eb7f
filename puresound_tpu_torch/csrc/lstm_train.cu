// LSTM scans for training, for Hopper (sm_90a): forward, and backward in two
// passes, with the input projection inside the kernel (proj = 1) or hoisted
// out of it (proj = 0), on batch-major or time-major sequences (x_tm).
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
// backward at 0.214 / 3.15 ms. The hoisted variant at that shape does 70.5
// GFLOP forward (1.05 ms f32 by operations) and moves about 690 MB in bf16
// (0.21 ms by bytes; xp and the gates 275 MB each), and 141 GFLOP backward
// (2.10 ms f32; 0.23 ms bf16 by bytes). But every call is also a chain of T dependent
// steps, and without tensor cores the float32 products run on CUDA cores; as
// in skim_stream.cu, one CTA's serial chain of steps is expected to set the
// time.
//
// What this design does about it. Forward: one CTA of 1024 threads per tile of
// BT = 8 rows (112 CTAs at 896 rows: one wave on 132 SMs). Thread n owns gate
// column n (looping when 4H > 1024) and computes its pre-activation for the 8
// rows from x_t and h in shared memory (the 8 row values of one input channel
// are one 32-byte broadcast read), with W_ih and W_hh streaming from L2
// (0.79 MB bf16 / 1.57 MB f32 per step per CTA); then thread (row, unit) runs
// the cell update; stores are coalesced across units. Two barriers per step.
// Backward, in two passes, because CTAs cannot carry a sum across a sequential
// grid as the TPU kernel does:
//  (a) the recurrent pass, one CTA per row tile walking time backwards, keeps
//      dh/dc in shared memory, writes dx_t and writes dgates (rounded to the
//      dot dtype, exactly the operand the weight products read) to a
//      [T, B, 4H] scratch; dbias is summed per tile in float32. Its dh and
//      dx products have only H + C = 384 output columns for 1024 threads,
//      so each column's 4H-long sum is split into THREADS / (H + C) ranges
//      that run on separate threads and are added in a fixed order;
//  (b) a tiled weight-gradient product: each CTA owns a 64 x 64 tile of
//      [dW_hh; dW_ih] and one of n_split fixed row ranges of the T*B rows,
//      reading h_prev straight from y shifted by one step (h0 at the boundary,
//      no concatenated copy); a last kernel sums the n_split partials and the
//      per-tile dbias in a fixed order. No atomics: the result is
//      deterministic. Tensor cores (wgmma) and TMA are later work.
// The hoisted variant is the same kernels with C = 0: no x tile, xp_t read
// straight from device memory in place of the projection, and no dx / dW_ih /
// dbias work. The layout flag only changes the x / y / dy / dx index
// arithmetic, so the time-major and batch-major entries compute the same
// sums in the same order, bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;          // rows per CTA of the recurrent kernels
constexpr int THREADS = 1024;  // threads of the recurrent kernels
constexpr int WT = 64;         // weight-gradient tile (dW rows x gate columns)
constexpr int RB = 32;         // rows per shared-memory stage of that product
constexpr int WTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// row of step t and sequence `row` in a [B, T, *] (tm = 0) or [T, B, *] array
__device__ __forceinline__ long seq_row(int tm, int t, long row, int B, int T) {
  return tm ? (long)t * B + row : row * T + t;
}

// acc[b] += v[b] * w for the BT = 8 row values stored at v (16-byte aligned)
__device__ __forceinline__ void fma8(float* acc, const float* v, float w) {
  const float4 lo = *reinterpret_cast<const float4*>(v);
  const float4 hi = *reinterpret_cast<const float4*>(v + 4);
  acc[0] += lo.x * w;
  acc[1] += lo.y * w;
  acc[2] += lo.z * w;
  acc[3] += lo.w * w;
  acc[4] += hi.x * w;
  acc[5] += hi.y * w;
  acc[6] += hi.z * w;
  acc[7] += hi.w * w;
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
};

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, Tn = p.T, C = p.C, H = p.H, G = 4 * H;
  float* x_s = smem;            // [C][BT] x_t
  float* h_s = x_s + C * BT;    // [H][BT] h, rounded to the dot dtype
  float* pre_s = h_s + H * BT;  // [G][BT] gate pre-activations
  float* c_s = pre_s + G * BT;  // [BT][H] c (float32)
  const T* x = static_cast<const T*>(p.x);
  const T* w_ih = static_cast<const T*>(p.w_ih);
  const T* w_hh = static_cast<const T*>(p.w_hh);
  T* y = static_cast<T*>(p.y);
  T* gates = static_cast<T*>(p.gates);
  T* cseq = static_cast<T*>(p.cseq);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);

  for (int idx = tid; idx < BT * H; idx += nthr) {
    const int b = idx / H, j = idx % H;
    float hv = 0.f, cv = 0.f;
    if (b < nb) {
      hv = lds(p.h0, (long)(b0 + b) * H + j, p.s_bf16);
      cv = lds(p.c0, (long)(b0 + b) * H + j, p.s_bf16);
    }
    h_s[j * BT + b] = rnd<T>(hv);
    c_s[idx] = cv;
  }

  for (int s = 0; s < Tn; ++s) {
    const int t = p.reverse ? Tn - 1 - s : s;
    // x_s was last read before the previous step's second barrier
    for (int idx = tid; idx < BT * C; idx += nthr) {
      const int b = idx / C, k = idx % C;
      x_s[k * BT + b] =
          b < nb ? ldf(x, seq_row(p.x_tm, t, b0 + b, B, Tn) * C + k) : 0.f;
    }
    __syncthreads();
    for (int n = tid; n < G; n += nthr) {
      float ax[BT], ah[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) ax[b] = ah[b] = 0.f;
#pragma unroll 4
      for (int k = 0; k < C; ++k) fma8(ax, x_s + k * BT, ldf(w_ih, (long)k * G + n));
#pragma unroll 4
      for (int k = 0; k < H; ++k) fma8(ah, h_s + k * BT, ldf(w_hh, (long)k * G + n));
      if (p.proj) {
        const float bn = p.bias[n];
#pragma unroll
        for (int b = 0; b < BT; ++b) pre_s[n * BT + b] = (ax[b] + bn) + ah[b];
      } else {  // the hoisted xp_t, read once, coalesced across n
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xp = b < nb ? ldf(x, ((long)t * B + b0 + b) * G + n) : 0.f;
          pre_s[n * BT + b] = xp + ah[b];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < BT * H; idx += nthr) {
      const int b = idx / H, j = idx % H;
      const float ig = sigm(pre_s[j * BT + b]);
      const float fg = sigm(pre_s[(H + j) * BT + b]);
      const float gg = tanhf(pre_s[(2 * H + j) * BT + b]);
      const float og = sigm(pre_s[(3 * H + j) * BT + b]);
      const float c = fg * c_s[idx] + ig * gg;
      const float h = og * tanhf(c);
      c_s[idx] = c;
      h_s[j * BT + b] = rnd<T>(h);
      if (b < nb) {
        const long row = b0 + b;
        stf(y, seq_row(p.x_tm, t, row, B, Tn) * H + j, h);
        if (gates != nullptr) {
          const long g = ((long)t * B + row) * G + j;
          stf(gates, g, ig);
          stf(gates, g + H, fg);
          stf(gates, g + 2 * H, gg);
          stf(gates, g + 3 * H, og);
        }
        if (cseq != nullptr) stf(cseq, ((long)t * B + row) * H + j, c);
        if (s == Tn - 1) {
          sts(p.hT, row * H + j, h, p.s_bf16);
          sts(p.cT, row * H + j, c, p.s_bf16);
        }
      }
    }
  }
}

// -------------------------------------------------- backward (a): recurrence
struct BwdParams {
  const void* x;       // [B, T, C] or [T, B, C] (T); null when proj = 0
  const void* h0;      // [B, H]     (state dtype)
  const void* c0;      // [B, H]
  const void* w_ih_t;  // [4H, C]    (T) torch layout, rows read coalesced; or null
  const void* w_hh_t;  // [4H, H]    (T)
  const void* y;       // [B, T, H] or [T, B, H] (T)
  const void* gates;   // [T, B, 4H] (T)
  const void* cseq;    // [T, B, H]  (T)
  const void* dy;      // y's layout (T)
  const float* dhT;    // [B, H]
  const float* dcT;    // [B, H]
  void* dx;            // x's layout (T), or null
  float* dh0;          // [B, H]
  float* dc0;          // [B, H]
  void* dg;            // [T, B, 4H] (T) dgates rounded to the dot dtype: scratch,
                       // or the output dxp_t when proj = 0
  float* db_part;      // [n_tiles, 4H] per-tile dbias, or null
  int B, T, C, H, reverse, s_bf16, proj, x_tm;  // proj = 0: C = 0
  int n_slices;        // the 4H sums of dh / dx split into this many ranges
};

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, Tn = p.T, C = p.C, H = p.H, G = 4 * H;
  float* dg_s = smem;            // [G][BT] dgates rounded to the dot dtype
  float* dgu_s = dg_s + G * BT;  // [G][BT] dgates in float32 (dbias)
  float* dh_s = dgu_s + G * BT;  // [BT][H] dh carry
  float* dc_s = dh_s + BT * H;   // [BT][H] dc carry
  float* db_s = dc_s + BT * H;   // [G] this tile's dbias
  float* part_s = db_s + G;      // [n_slices][BT][H + C] partial dh | dx sums
  const int KC = H + C, S = p.n_slices, span = (G + S - 1) / S;
  const T* gates = static_cast<const T*>(p.gates);
  const T* cseq = static_cast<const T*>(p.cseq);
  const T* dy = static_cast<const T*>(p.dy);
  const T* w_ih_t = static_cast<const T*>(p.w_ih_t);
  const T* w_hh_t = static_cast<const T*>(p.w_hh_t);
  T* dx = static_cast<T*>(p.dx);
  T* dg = static_cast<T*>(p.dg);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);

  for (int idx = tid; idx < BT * H; idx += nthr) {
    const int b = idx / H, j = idx % H;
    const long g = (long)(b0 + b) * H + j;
    dh_s[idx] = b < nb ? p.dhT[g] : 0.f;
    dc_s[idx] = b < nb ? p.dcT[g] : 0.f;
  }
  for (int n = tid; n < G; n += nthr) db_s[n] = 0.f;
  __syncthreads();

  // s walks the forward's steps backwards; s == 0 is its first step
  for (int s = Tn - 1; s >= 0; --s) {
    const int t = p.reverse ? Tn - 1 - s : s;
    const int tp = p.reverse ? t + 1 : t - 1;  // time of the forward's previous step
    for (int idx = tid; idx < BT * H; idx += nthr) {
      const int b = idx / H, j = idx % H;
      float d[4] = {0.f, 0.f, 0.f, 0.f};  // i, f, g, o
      if (b < nb) {
        const long row = b0 + b;
        const long gb = ((long)t * B + row) * G + j;
        const float ig = ldf(gates, gb), fg = ldf(gates, gb + H);
        const float gg = ldf(gates, gb + 2 * H), og = ldf(gates, gb + 3 * H);
        const float cn = ldf(cseq, ((long)t * B + row) * H + j);
        float cp;
        if (s == 0) {
          const float c0 = lds(p.c0, row * H + j, p.s_bf16);
          cp = p.proj ? c0 : rnd<T>(c0);
        } else {
          cp = ldf(cseq, ((long)tp * B + row) * H + j);
        }
        const float tc = tanhf(cn);
        const float dh = dh_s[idx] + ldf(dy, seq_row(p.x_tm, t, row, B, Tn) * H + j);
        const float dc = dc_s[idx] + dh * og * (1.f - tc * tc);
        d[0] = dc * gg * ig * (1.f - ig);
        d[1] = dc * cp * fg * (1.f - fg);
        d[2] = dc * ig * (1.f - gg * gg);
        d[3] = dh * tc * og * (1.f - og);
        dc_s[idx] = dc * fg;
#pragma unroll
        for (int q = 0; q < 4; ++q) stf(dg, gb + q * H, d[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dgu_s[(q * H + j) * BT + b] = d[q];
        dg_s[(q * H + j) * BT + b] = rnd<T>(d[q]);
      }
    }
    __syncthreads();
    // tasks: (range, column) of the dh | dx products, a column being one
    // of dh [0, H) or dx [H, H + C) and a range one of the S slices of the
    // 4H sum (so S * (H + C) threads share the products); dbias after
    const int n_tasks = S * KC + (p.proj ? G : 0);
    for (int task = tid; task < n_tasks; task += nthr) {
      if (task < S * KC) {
        const int sl = task / KC, k = task % KC;
        const bool is_h = k < H;
        const int col = is_h ? k : k - H;
        const int ld = is_h ? H : C;
        const T* w = (is_h ? w_hh_t : w_ih_t) + col;
        const int n1 = min(G, (sl + 1) * span);
        float acc[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
        for (int n = sl * span; n < n1; ++n)
          fma8(acc, dg_s + n * BT, ldf(w, (long)n * ld));
#pragma unroll
        for (int b = 0; b < BT; ++b) part_s[(sl * BT + b) * KC + k] = acc[b];
      } else {
        const int n = task - S * KC;
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < BT; ++b) sum += dgu_s[n * BT + b];
        db_s[n] += sum;
      }
    }
    __syncthreads();
    // the ranges' partial sums, added in a fixed order
    for (int idx = tid; idx < BT * KC; idx += nthr) {
      const int b = idx / KC, k = idx % KC;
      float v = 0.f;
      for (int sl = 0; sl < S; ++sl) v += part_s[(sl * BT + b) * KC + k];
      if (k < H)
        dh_s[b * H + k] = v;
      else if (b < nb)
        stf(dx, seq_row(p.x_tm, t, b0 + b, B, Tn) * C + (k - H), v);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < BT * H; idx += nthr) {
    const int b = idx / H, j = idx % H;
    if (b < nb) {
      p.dh0[(long)(b0 + b) * H + j] = dh_s[idx];
      p.dc0[(long)(b0 + b) * H + j] = dc_s[idx];
    }
  }
  if (p.proj)
    for (int n = tid; n < G; n += nthr) p.db_part[(long)blockIdx.x * G + n] = db_s[n];
}

// ------------------------------------------- backward (b): weight gradients
struct WgradParams {
  const void* x;   // [B, T, C] or [T, B, C] (T); null when C = 0
  const void* h0;  // [B, H]     (state dtype)
  const void* y;   // x's layout, H wide (T)
  const void* dg;  // [T, B, 4H] (T)
  float* w_part;   // [n_split, H + C, 4H] partial [dW_hh; dW_ih]
  int B, T, C, H, reverse, s_bf16, rows_per_split, x_tm;
};

template <typename T>
__global__ void __launch_bounds__(WTHREADS) lstm_wgrad_kernel(WgradParams p) {
  __shared__ __align__(16) float a_s[RB][WT];  // [h_prev | x] rows
  __shared__ __align__(16) float g_s[RB][WT];  // dgates rows
  const int B = p.B, Tn = p.T, C = p.C, H = p.H, G = 4 * H, K = H + C;
  const int R = B * Tn;  // the wrapper keeps B * T below 2^31
  const T* x = static_cast<const T*>(p.x);
  const T* y = static_cast<const T*>(p.y);
  const T* dg = static_cast<const T*>(p.dg);
  const int n0 = blockIdx.x * WT, k0 = blockIdx.y * WT;
  const int r_begin = blockIdx.z * p.rows_per_split;
  const int r_end = min(R, r_begin + p.rows_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += RB) {
    for (int e = tid; e < RB * WT; e += WTHREADS) {
      const int rr = e / WT, kk = e % WT;
      const int r = r0 + rr;  // row r = t * B + b of the [T, B, *] scratch
      const int k = k0 + kk, n = n0 + kk;
      float a = 0.f, g = 0.f;
      if (r < r_end) {
        const int t = r / B, b = r - t * B;
        if (k < H) {
          const bool first = p.reverse ? t == Tn - 1 : t == 0;
          const int tp = p.reverse ? t + 1 : t - 1;
          a = first ? lds(p.h0, (long)b * H + k, p.s_bf16)
                    : ldf(y, seq_row(p.x_tm, tp, b, B, Tn) * H + k);
        } else if (k < K) {
          a = ldf(x, seq_row(p.x_tm, t, b, B, Tn) * C + (k - H));
        }
        if (n < G) g = ldf(dg, (long)r * G + n);
      }
      a_s[rr][kk] = rnd<T>(a);
      g_s[rr][kk] = g;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[rr][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&g_s[rr][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * gv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (k < K && n < G) p.w_part[((long)blockIdx.z * K + k) * G + n] = acc[i][j];
    }
}

// sums the row-range partials and (proj) the per-tile dbias, each in a fixed order
__global__ void lstm_wgrad_reduce(const float* w_part, const float* db_part, float* dw_hh,
                                  float* dw_ih, float* dbias, int H, int C, int n_split,
                                  int n_tiles, int proj) {
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
      for (int tile = 0; tile < n_tiles; ++tile) s += db_part[(long)tile * G + n];
      dbias[n] = s;
    }
  }
}

size_t fwd_smem(int C, int H) {
  return sizeof(float) * ((size_t)BT * (C + H + 4 * H) + (size_t)BT * H);
}

// slices of the backward's 4H sums: as many as keep every thread busy
int bwd_slices(int H, int C) { return THREADS / (H + C) > 1 ? THREADS / (H + C) : 1; }

size_t bwd_smem(int H, int C) {
  return sizeof(float) * ((size_t)2 * BT * 4 * H + (size_t)2 * BT * H + 4 * H +
                          (size_t)bwd_slices(H, C) * BT * (H + C));
}

template <typename T>
cudaError_t fwd_launch(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = fwd_smem(p.C, p.H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<T><<<(p.B + BT - 1) / BT, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_launch(const BwdParams& p, float* w_part, float* dw_ih, float* dw_hh,
                       float* dbias, int n_split, int rows_per_split,
                       cudaStream_t stream) {
  const int G = 4 * p.H, K = p.H + p.C, n_tiles = (p.B + BT - 1) / BT;
  const size_t smem = bwd_smem(p.H, p.C);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_bwd_kernel<T><<<n_tiles, THREADS, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  WgradParams w{p.x, p.h0, p.y, p.dg, w_part, p.B, p.T, p.C, p.H, p.reverse, p.s_bf16,
                rows_per_split, p.x_tm};
  const dim3 grid((G + WT - 1) / WT, (K + WT - 1) / WT, n_split);
  lstm_wgrad_kernel<T><<<grid, WTHREADS, 0, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long total = (long)K * G + (p.proj ? G : 0);
  const int blocks = total / 256 + 1 < 4096 ? (int)(total / 256 + 1) : 4096;
  lstm_wgrad_reduce<<<blocks, 256, 0, stream>>>(w_part, p.db_part, dw_hh, dw_ih, dbias,
                                                p.H, p.C, n_split, n_tiles, p.proj);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_train_fwd(const void* x, const void* h0, const void* c0,
                              const void* w_ih, const void* bias, const void* w_hh,
                              void* y, void* hT, void* cT, void* gates, void* cseq, int B,
                              int T, int C, int H, int reverse, int x_bf16, int s_bf16,
                              int proj, int x_tm, void* stream) {
  if (!proj && (C != 0 || !x_tm)) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{x, h0, c0, w_ih, static_cast<const float*>(bias), w_hh, y, hT, cT, gates,
              cseq, B, T, C, H, reverse, s_bf16, proj, x_tm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_bf16 ? fwd_launch<__nv_bfloat16>(p, s) : fwd_launch<float>(p, s));
}

extern "C" int lstm_train_bwd(const void* x, const void* h0, const void* c0,
                              const void* w_ih_t, const void* w_hh_t, const void* y,
                              const void* gates, const void* cseq, const void* dy,
                              const void* dhT, const void* dcT, void* dx, void* dh0,
                              void* dc0, void* dw_ih, void* dw_hh, void* dbias, void* dg,
                              void* db_part, void* w_part, int B, int T, int C, int H,
                              int reverse, int x_bf16, int s_bf16, int n_split,
                              int rows_per_split, int proj, int x_tm, void* stream) {
  if (!proj && (C != 0 || !x_tm)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{x, h0, c0, w_ih_t, w_hh_t, y, gates, cseq, dy,
              static_cast<const float*>(dhT), static_cast<const float*>(dcT), dx,
              static_cast<float*>(dh0), static_cast<float*>(dc0), dg,
              static_cast<float*>(db_part), B, T, C, H, reverse, s_bf16, proj, x_tm,
              bwd_slices(H, C)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(w_part);
  float* dwi = static_cast<float*>(dw_ih);
  float* dwh = static_cast<float*>(dw_hh);
  float* db = static_cast<float*>(dbias);
  const cudaError_t err =
      x_bf16 ? bwd_launch<__nv_bfloat16>(p, wp, dwi, dwh, db, n_split, rows_per_split, s)
             : bwd_launch<float>(p, wp, dwi, dwh, db, n_split, rows_per_split, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
