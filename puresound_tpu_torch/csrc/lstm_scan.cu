// LSTM recurrence over pre-projected inputs, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of puresound_tpu/ops/lstm_scan_kernel.py
// (lstm_scan, pallas_call at :109): per step t (T-1 .. 0 under `reverse`,
// y stays input-aligned), for every row independently,
//   gates = xp[row, t] + h @ W_hh   (i, f, g, o);  c = f*c + i*g;  h = o*tanh(c)
// h and c are carried in float32; the dot's operands are rounded to the dot
// dtype (float32 or bfloat16) and summed in float32. y is stored in xp's
// dtype (float32 or bfloat16), hT / cT in the state's dtype. The wrapper
// hands W_hh over in float32 (exact for bfloat16 weights).
//
// What bounds it on the H100. At DPCRN's serving shapes with 2048 streams
// (H = 128), the intra scan is 4,096 rows x 64 steps and the inter scan
// 131,072 rows x 2 steps: 34.4 GFLOP either way, 0.51 ms at the 67 TFLOP/s
// of float32 without tensor cores, against a 537 MB float32 xp read (0.16
// ms at 3.35 TB/s). So operations bound it, and within one CTA the steps
// are a serial chain.
//
// What this design does about it. A CTA owns BT = RG x 8 rows for all T
// steps (RG up to 512 / H, halved while the CTAs would not cover the SMs
// once: 16 rows at H = 128 for the intra scan's 4,096 rows, 32 for the
// inter scan). Thread (rg, j) owns hidden unit j of 8 rows: it computes all
// four gate columns of unit j for its 8 rows (lstm_gates.cuh), so the cell
// update runs in registers with no gate round trip through shared memory,
// and c stays in its registers for the whole scan. h lives in shared memory,
// double-buffered ([2][H][BT + 4], the padding spreads the stores over
// banks). W_hh (256 KB in float32, above one SM's shared memory) streams
// through shared memory in tiles of 32 rows, copied with cp.async while the
// previous tile is in use, so the FMA loop waits on no L2 load: each k reads
// the 8 rows' h as two broadcast 16-byte loads and the four weights of unit
// j. A first version that read W_hh from L1/L2 inside the loop ran at a
// quarter of the FMA rate (PERF.md). Tensor cores (mma / wgmma) are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_gates.cuh"

namespace {

using namespace lstm_gates;

constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float ldf(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

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
cudaError_t launch(ScanParams p, cudaStream_t stream) {
  p.RG = row_groups(p.B, p.H, 1);
  p.KT = tile_rows<float>(4 * p.H);
  const int BT = p.RG * RB;
  const size_t smem = sizeof(float) * (2 * (size_t)p.KT * 4 * p.H + 2 * (size_t)p.H * (BT + 4));
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_kernel<XT, DOT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (p.RG * p.H + 31) / 32 * 32;
  lstm_scan_kernel<XT, DOT_BF16><<<(p.B + BT - 1) / BT, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lstm_scan(const void* xp, const void* h0, const void* c0, const void* w_hh,
                         void* y, void* hT, void* cT, int B, int T, int H, int reverse,
                         int x_bf16, int s_bf16, int dot_bf16, void* stream) {
  ScanParams p{xp, h0, c0, static_cast<const float*>(w_hh), y, hT, cT, B, T, H,
               reverse, s_bf16, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = dot_bf16 ? launch<__nv_bfloat16, true>(p, s) : launch<__nv_bfloat16, false>(p, s);
  else
    err = dot_bf16 ? launch<float, true>(p, s) : launch<float, false>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
