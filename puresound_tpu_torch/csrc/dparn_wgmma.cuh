// DPARN's intra attention pass on Hopper's tensor cores (wgmma), the bf16
// route of dparn_attention.cuh for the model's geometry: F = 64 tokens a
// row, C = FFD = 128 channels, 8 heads of Dh = 16, bf16 weights, bf16 dots.
//
// A persistent CTA walks pairs of rows. Two consumer warpgroups own a row
// each (232 registers a thread, setmaxnreg); one thread of a producer
// warpgroup keeps the 13 weight products of a row ([128 x 128]
// each, repacked per call by `pack_kernel`, from any strides, into the
// swizzled K-major image wgmma reads, W^T) flowing through a ring of STAGES 32 KB slots with the
// bulk copy engine, full / empty mbarriers between them. Both warpgroups
// take the products in the same order, so each slot read from L2 serves two
// rows. Per warpgroup, a row's bf16 operands live in four swizzled [64 x
// 128] shared buffers (A: the product input; Q, K; V transposed); its
// float32 residual x stays in registers in the accumulator layout (thread
// quad g of warp w holds tokens 16w + g and 16w + g + 8, channels 8j + 2t,
// 8j + 2t + 1), so the residual adds, the bias / ReLU epilogues and the
// two-pass LayerNorms (eps 1e-5, quad shuffles) run in registers.
//
// Products: wgmma m64n128k16 over 8 K slices (A and W^T from shared memory).
// Attention per head: S = Q_h K_h^T (m64n64k16), divided by sqrt(Dh); the
// softmax in registers over the row's 64 keys (max, exp, sum, normalise by
// the sum's reciprocal, then P rounded to bf16: JAX's cast point); O_h = P V_h (m64n16k16, P as
// the register A operand, V_h^T from shared memory), rounded into A.
// Cast points are dparn_attention.cuh's: q, k, v, P, O, the hidden layer
// and the rounded copies of x are bf16; sums, softmax and norms float32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace dparn_wgmma {

using namespace hopper;

constexpr int F = 64, C = 128, DH = 16, HEADS = C / DH;
constexpr int NWG = 2;                       // consumer warpgroups, a row each
constexpr int THREADS = (NWG + 1) * 128;     // + the producer warpgroup (one thread copies)
constexpr int STAGES = 3;                    // weight slots in the ring
constexpr int NPROD = 13;                    // 2 x (q, k, v, o, ff1, ff2) + fc
constexpr int TILE = C * C * 2;              // one weight image, bytes
constexpr int BUF = F * C * 2;               // one bf16 [64 x 128] row buffer
constexpr size_t SMEM = 1024 + (size_t)STAGES * TILE + (size_t)NWG * 4 * BUF + 2 * STAGES * 8;
constexpr float EPS = 1e-5f;
constexpr float INV_SQRT_DH = 0.25f;         // 1 / sqrt(16): a power of two

// the flat weight index of product p (JAX's order: 12 a layer, then fc)
__host__ __device__ constexpr int prod_weight(int p) {
  return p == 12 ? 24 : 12 * (p / 6) + (p % 6 < 4 ? p % 6 : (p % 6 == 4 ? 6 : 8));
}

struct Params {
  const void* x;        // element (r, f, c) at r * sr + f * sf + c
  const void* pe;       // [F, C]
  const __nv_bfloat16* w[28];  // the 28 weights, JAX's flat order (vectors read from here)
  long ws[28][2];              // their strides (in, out) in elements: views need no copy
  __nv_bfloat16* packed;       // NPROD swizzled W^T images (pack_kernel)
  void* y;
  long sr, sf;
  int R, x_bf16, pe_bf16, y_bf16, residual;
};

// packed[p] = W_p^T [n][k] in the swizzled K-major layout (2 atom columns)
__global__ void pack_kernel(Params prm) {
  const int p = blockIdx.y, wi = prod_weight(p);
  const __nv_bfloat16* W = prm.w[wi];   // element (k, n) at k * ws[0] + n * ws[1]
  const long sk = prm.ws[wi][0], sn = prm.ws[wi][1];
  char* dst = reinterpret_cast<char*>(prm.packed) + (size_t)p * TILE;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < C * C; i += gridDim.x * blockDim.x) {
    const int n = i / C, k = i % C;
    *reinterpret_cast<__nv_bfloat16*>(dst + swz(n, k, C, C)) = W[k * sk + n * sn];
  }
}

// two consecutive values (i even) of a float32 or bfloat16 tensor
__device__ __forceinline__ float2 ld2(const void* p, long i, int bf16) {
  if (bf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}
__device__ __forceinline__ void st2(void* p, long i, float2 v, int bf16) {
  if (bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(v.x, v.y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = v;
}

// w[c], w[c + 1] of a bf16 vector (c even; the wrapper aligns vectors)
__device__ __forceinline__ float2 ldw2(const __nv_bfloat16* w, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + c));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// v = LN(v) * g + b per token over the 128 channels (v in the accumulator
// layout: v[4j], v[4j + 1] token r0, v[4j + 2], v[4j + 3] token r1), two-pass
__device__ __forceinline__ void layer_norm(float (&v)[64], const __nv_bfloat16* g,
                                           const __nv_bfloat16* b, int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s0 += v[4 * j] + v[4 * j + 1];
    s1 += v[4 * j + 2] + v[4 * j + 3];
  }
  const float m0 = quad_sum(s0) / C, m1 = quad_sum(s1) / C;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float a = v[4 * j] - m0, bb = v[4 * j + 1] - m0;
    const float c = v[4 * j + 2] - m1, d = v[4 * j + 3] - m1;
    q0 += a * a + bb * bb;
    q1 += c * c + d * d;
  }
  const float r0 = rsqrtf(quad_sum(q0) / C + EPS), r1 = rsqrtf(quad_sum(q1) / C + EPS);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 gg = ldw2(g, 8 * j + 2 * t), bb = ldw2(b, 8 * j + 2 * t);
    v[4 * j] = (v[4 * j] - m0) * r0 * gg.x + bb.x;
    v[4 * j + 1] = (v[4 * j + 1] - m0) * r0 * gg.y + bb.y;
    v[4 * j + 2] = (v[4 * j + 2] - m1) * r1 * gg.x + bb.x;
    v[4 * j + 3] = (v[4 * j + 3] - m1) * r1 * gg.y + bb.y;
  }
}

// the accumulator layout's values stored rounded into a swizzled token-major buffer
__device__ __forceinline__ void store_rows(char* buf, const float (&v)[64], int r0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<unsigned*>(buf + swz(r0, c, F, C)) = bf16x2(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<unsigned*>(buf + swz(r0 + 8, c, F, C)) = bf16x2(v[4 * j + 2], v[4 * j + 3]);
  }
}

// the same into the transposed (channel-major) buffer: V^T [C][F]
__device__ __forceinline__ void store_cols(char* buf, const float (&v)[64], int r0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<__nv_bfloat16*>(buf + swz(c + (e & 1), r0 + 8 * (e >> 1), C, F)) =
          __float2bfloat16(v[4 * j + e]);
  }
}

__global__ void __launch_bounds__(THREADS, 1) attn_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  // 1,024-byte aligned base: the swizzle is a function of the address bits
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t s0 = smem_addr(sm);
  const uint32_t ring = s0;
  const uint32_t bars = s0 + STAGES * TILE + NWG * 4 * BUF;   // full[STAGES], empty[STAGES]
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long npairs = ((long)p.R + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {   // ------------------------------------ producer
    // registers to the consumers: 128 x 40 + 256 x 232 fit the SM's 65,536
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == NWG * 4 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long pair = blockIdx.x; pair < npairs; pair += gridDim.x)
        for (int q = 0; q < NPROD; ++q) {
          mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);
          mbar_expect_tx(bars + 8 * stage, TILE);
          bulk_load(ring + stage * TILE, reinterpret_cast<const char*>(p.packed) + (size_t)q * TILE,
                    TILE, bars + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;                       // this thread's tokens r0, r0 + 8
  char* bA = reinterpret_cast<char*>(sm) + STAGES * TILE + wg * 4 * BUF;
  char* bQ = bA + BUF;
  char* bK = bQ + BUF;
  char* bV = bK + BUF;
  const uint32_t sA = smem_addr(bA), sQ = smem_addr(bQ), sK = smem_addr(bK), sV = smem_addr(bV);
  auto wsync = [&]() {      // this warpgroup's shared writes visible to its wgmma
    fence_async_smem();
    bar_sync(1 + wg, 128);
  };
  int stage = 0;
  uint32_t phase = 0;
  float x[64], acc[64];

  // acc = A . W_q for the next product in the ring (every consumer warp
  // takes part in the ring even when its row is past the end)
  auto product = [&](uint32_t a, bool live) {
    mbar_wait(bars + 8 * stage, phase);
    if (live) {
      const uint32_t b = ring + stage * TILE;
      pin(acc);
      wg_fence();
#pragma unroll
      for (int k = 0; k < C / 16; ++k)
        wgmma_m64n128(acc, desc_tile(a, 0, k, F, C), desc_tile(b, 0, k, C, C), k > 0);
      wg_commit();
      wg_wait0();
      pin(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto bias = [&](int wi, bool relu) {
    const __nv_bfloat16* bv = p.w[wi];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = ldw2(bv, 8 * j + 2 * t);
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
      if (relu)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] = fmaxf(acc[4 * j + e], 0.f);
    }
  };

  for (long pair = blockIdx.x; pair < npairs; pair += gridDim.x) {
    const long row = 2 * pair + wg;
    const bool live = row < p.R;
    const long base = row * p.sr;
    if (live) {   // x into registers; A = rnd(x + pe)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int f = r0 + 4 * e;
          const float2 xv = ld2(p.x, base + f * p.sf + c, p.x_bf16);
          const float2 pv = ld2(p.pe, (long)f * C + c, p.pe_bf16);
          x[4 * j + e] = xv.x;
          x[4 * j + e + 1] = xv.y;
          acc[4 * j + e] = xv.x + pv.x;
          acc[4 * j + e + 1] = xv.y + pv.y;
        }
      }
      store_rows(bA, acc, r0, t);
      wsync();
    }
#pragma unroll
    for (int layer = 0; layer < 2; ++layer) {
      const int w0 = 12 * layer;
      product(sA, live);                         // q
      if (live) store_rows(bQ, acc, r0, t);
      product(sA, live);                         // k
      if (live) store_rows(bK, acc, r0, t);
      product(sA, live);                         // v
      if (live) {
        store_cols(bV, acc, r0, t);
        wsync();
        // per head: O_h = softmax(Q_h K_h^T / sqrt(Dh)) V_h into A's columns
        for (int h = 0; h < HEADS; ++h) {
          float s[32];
          pin(s);
          wg_fence();
          wgmma_m64n64(s, desc_tile(sQ, 0, h, F, C), desc_tile(sK, 0, h, F, C), 0);
          wg_commit();
          wg_wait0();
          pin(s);
          float mx0 = __int_as_float(0xff800000), mx1 = mx0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] *= INV_SQRT_DH;   // / sqrt(Dh), exact
            mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
          mx0 = quad_max(mx0);
          mx1 = quad_max(mx1);
          float sum0 = 0.f, sum1 = 0.f;
          // exp by ex2.approx (a few ulp; P is rounded to bf16 next)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[4 * j] = __expf(s[4 * j] - mx0);
            s[4 * j + 1] = __expf(s[4 * j + 1] - mx0);
            s[4 * j + 2] = __expf(s[4 * j + 2] - mx1);
            s[4 * j + 3] = __expf(s[4 * j + 3] - mx1);
            sum0 += s[4 * j] + s[4 * j + 1];
            sum1 += s[4 * j + 2] + s[4 * j + 3];
          }
          const float i0 = 1.f / quad_sum(sum0), i1 = 1.f / quad_sum(sum1);
          unsigned a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {   // P's keys 16kk .. 16kk + 15: S tiles 2kk, 2kk + 1
            a[kk][0] = bf16x2(s[8 * kk] * i0, s[8 * kk + 1] * i0);
            a[kk][1] = bf16x2(s[8 * kk + 2] * i1, s[8 * kk + 3] * i1);
            a[kk][2] = bf16x2(s[8 * kk + 4] * i0, s[8 * kk + 5] * i0);
            a[kk][3] = bf16x2(s[8 * kk + 6] * i1, s[8 * kk + 7] * i1);
          }
          float o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = 0.f;
          pin(o);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n16_rs(o, a[kk], desc_tile(sV, DH * h, kk, C, F), kk > 0);
          wg_commit();
          wg_wait0();
          pin(o);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = DH * h + 8 * j + 2 * t;
            *reinterpret_cast<unsigned*>(bA + swz(r0, c, F, C)) = bf16x2(o[4 * j], o[4 * j + 1]);
            *reinterpret_cast<unsigned*>(bA + swz(r0 + 8, c, F, C)) =
                bf16x2(o[4 * j + 2], o[4 * j + 3]);
          }
        }
        wsync();
      }
      product(sA, live);                         // o . Wo; x = LN(x + it)
      if (live) {
#pragma unroll
        for (int i = 0; i < 64; ++i) x[i] += acc[i];
        layer_norm(x, p.w[w0 + 4], p.w[w0 + 5], t);
        bar_sync(1 + wg, 128);                   // every warp's product has read A
        store_rows(bA, x, r0, t);
        wsync();
      }
      product(sA, live);                         // hidden = relu(rnd(x) W1 + b1)
      if (live) {
        bias(w0 + 7, true);
        store_rows(bQ, acc, r0, t);
        wsync();
      }
      product(sQ, live);                         // x = LN(x + hidden W2 + b2)
      if (live) {
        bias(w0 + 9, false);
#pragma unroll
        for (int i = 0; i < 64; ++i) x[i] += acc[i];
        layer_norm(x, p.w[w0 + 10], p.w[w0 + 11], t);
        store_rows(bA, x, r0, t);
        wsync();
      }
    }
    product(sA, live);                           // y = LN(rnd(x) Wfc + bfc)
    if (live) {
      bias(25, false);
      layer_norm(acc, p.w[26], p.w[27], t);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const long i = base + (long)(r0 + 4 * e) * p.sf + 8 * j + 2 * t;
          float2 v = make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
          if (p.residual) {
            const float2 xv = ld2(p.x, i, p.x_bf16);
            v.x += xv.x;
            v.y += xv.y;
          }
          st2(p.y, i, v, p.y_bf16);
        }
      bar_sync(1 + wg, 128);                     // every warp's product has read A
    }
  }
}

// CTAs of a launch: persistent, at most one an SM (the plan's number)
inline int ctas(int R, int sms) {
  const long pairs = ((long)R + 1) / 2;
  return (int)(pairs < sms ? pairs : sms);
}

inline cudaError_t run(const Params& p, int n_ctas, cudaStream_t stream) {
  pack_kernel<<<dim3(16, NPROD), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  attn_kernel<<<n_ctas, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dparn_wgmma
