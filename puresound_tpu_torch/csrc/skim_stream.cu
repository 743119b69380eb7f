// Fused SkiM streaming frames for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   puresound_tpu/ops/skim_stream_kernel.py::fused_skim_frames (body _make_kernel),
// FiLM and unconditioned blocks. Per frame t and block i, for a tile of streams:
//   FiLM:  xn = LN(x); x = (xn @ Wsx + se[i]) * xn + (xn @ Wbx + be[i])
//   LSTM:  gates = x @ W_ih + h @ W_hh + b (i, f, g, o); c = f*c + i*g; h = o*tanh(c)
//   out:   x += LN(h @ proj_w + proj_b)
// Loads in the input dtype (float32 or bfloat16), all math in float32; with
// bf16 weights (dot_dtype=bf16) each dot operand is rounded to bf16 and the
// sum runs in float32. h/c stay in shared memory (float32) for the whole chunk
// and are written back in the state's dtype; y is written in x's dtype.
//
// What bounds it on the H100: the weights (flagship n=4, C=128, H=256: about
// 1.8 M values, 3.7 MB in bf16 / 7.4 MB in f32) fit in the 50 MB L2 but not in
// one SM's 227 KB of shared memory, so every CTA streams all of them from L2
// once per frame: L2 bytes = weights x frames x tiles. The frame loop and the
// block loop are serial (each step needs the previous h). Measured on an H100
// SXM (80 GB, 700 W) at the flagship shapes in f32, the serial chain of one CTA
// is the bound up to one wave (B <= 8 x 132): a chunk of 15 frames takes 4.7 ms
// at B = 8 and 4.9 ms at B = 1024 (PERF.md).
//
// What this design does about it: one CTA per tile of BT=8 streams, one thread
// per hidden unit (looping when H > blockDim). Thread j computes the four gate
// pre-activations of unit j for all 8 streams, so each weight is read once per
// tile and frame and reused 8 times from a register; reads of a weight row are
// coalesced across j; the cell update is thread-local and c of unit j never
// leaves its owner's shared-memory slot. The tile's x and h values are
// broadcast from shared memory. LayerNorm is one warp per stream. A ragged last
// tile is masked. Tensor cores (wgmma) and TMA-fed weight tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;         // streams per CTA
constexpr int THREADS = 256;  // 8 warps

struct Params {
  const void* x;     // [B, F, C]
  const void* se;    // [n, B, C]
  const void* be;    // [n, B, C]
  const void* h_in;  // [n, B, H]
  const void* c_in;  // [n, B, H]
  void* y;           // [B, F, C]
  void* h_out;       // [n, B, H]
  void* c_out;       // [n, B, H]
  const void* w_mat; // per block: wsx[C,C] wbx[C,C] w_ih[C,4H] w_hh[H,4H] proj_w[H,C]
  const float* w_vec;// per block: fg[C] fb[C] b[4H] proj_b[C] ln_g[C] ln_b[C]
  int B, F, C, H, n_blocks, film_mask, x_bf16, s_bf16;
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

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const long mat_stride = 2L * C * C + (long)C * G + (long)H * G + (long)H * C;
  const int vec_stride = 2 * C + G + 3 * C;

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
        for (int b = warp; b < BT; b += nwarps)
          warp_ln(x_s + b * C, C, fg, fb, xn_s + b * C, false);
        __syncthreads();
        // output o < C: scale column o; o >= C: bias column o - C
        for (int o = tid; o < 2 * C; o += nthr) {
          const int col = o < C ? o : o - C;
          const TW* w = wm + (o < C ? 0 : (long)C * C);
          float acc[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
          for (int k = 0; k < C; ++k) {
            const float wk = wload(w, (long)k * C + col);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b] += rnd(xn_s[b * C + k], wm) * wk;
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
      for (int j = tid; j < H; j += nthr) {
        float a[4][BT];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int b = 0; b < BT; ++b) a[q][b] = 0.f;
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
      for (int o = tid; o < C; o += nthr) {
        float acc[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float wk = wload(pw, (long)k * C + o);
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] += rnd(hn_s[b * H + k], wm) * wk;
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
  const size_t smem =
      sizeof(float) * (2L * p.n_blocks * BT * p.H + 4L * BT * p.C + (long)BT * p.H);
  cudaError_t err = cudaFuncSetAttribute(
      skim_frames_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + BT - 1) / BT);
  skim_frames_kernel<TW><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int skim_stream_frames(const void* x, const void* se, const void* be,
                                  const void* h_in, const void* c_in, void* y,
                                  void* h_out, void* c_out, const void* w_mat,
                                  const void* w_vec, int B, int F, int C, int H,
                                  int n_blocks, int film_mask, int x_bf16, int s_bf16,
                                  int w_bf16, void* stream) {
  Params p{x, se, be, h_in, c_in, y, h_out, c_out, w_mat,
           static_cast<const float*>(w_vec), B, F, C, H, n_blocks, film_mask,
           x_bf16, s_bf16};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
  return static_cast<int>(err);
}

extern "C" const char* skim_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
