// The LSTM gate product shared by lstm_scan.cu and dual_path.cu.
//
// A CTA owns RG x 8 rows; thread (rg, j) owns hidden unit j of 8 rows and
// accumulates its four gate columns (i, f, g, o of unit j) over an input
// held in shared memory as [K][BTP] (the 8 rows of one k are two float4s).
// The weights W [K][4H] stream through shared memory in tiles of KT rows,
// copied with cp.async and double-buffered, so the FMA loop reads only
// shared memory while the next tile is in flight; every thread of the CTA
// takes part in the copy and the barriers. gate_dot_q is the int8 form
// (JAX's dot_hh): the input is h quantized to int8, 4 k a word ([K/4][BTP]
// words), W int8 packed the same way ([K/4][4H] words), summed by __dp4a on
// the CUDA cores in int32 (exact) and scaled once by scale / 127^2.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace lstm_gates {

constexpr int RB = 8;  // rows per thread

__device__ __forceinline__ float ldw(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  return BF ? __bfloat162float(__float2bfloat16(v)) : v;
}
// a weight of type WT rounded to the dot dtype: bfloat16 weights already are
template <typename WT, bool DB>
__device__ __forceinline__ float rndw(WT v) {
  return rnd<DB && !std::is_same<WT, __nv_bfloat16>::value>(ldw(&v, 0));
}
// a value of a tensor whose dtype (float32 or bfloat16) is chosen at run time
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
__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// issue the copy of rows [k0, k0 + rows) of W [K][G] into dst [rows][G]
// (a row is a multiple of 16 bytes: the wrappers check it)
template <typename WT>
__device__ __forceinline__ void stage_rows(WT* dst, const WT* W, int k0, int rows, int G) {
  const int chunks = rows * G * static_cast<int>(sizeof(WT)) / 16;
  const char* src = reinterpret_cast<const char*>(W + (long)k0 * G);
  char* d = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) cp_async16(d + 16 * i, src + 16L * i);
}

// The staged-tile loop: W [n][G] of T through w_s (2 x KT x G) in tiles of
// KT rows, double-buffered; body(tile, k0, rows) runs on each staged tile
// between the barriers. Called by every thread of the CTA.
template <typename T, typename Body>
__device__ __forceinline__ void staged_rows(const T* W, int n, int G, T* w_s, int KT,
                                            Body body) {
  const int ntiles = (n + KT - 1) / KT;
  stage_rows(w_s, W, 0, n < KT ? n : KT, G);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KT, rows = n - k0 < KT ? n - k0 : KT;
    if (t + 1 < ntiles) {
      const int k1 = k0 + KT;
      stage_rows(w_s + ((t + 1) & 1) * KT * G, W, k1, n - k1 < KT ? n - k1 : KT, G);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(w_s + (t & 1) * KT * G, k0, rows);
    __syncthreads();  // the buffer is refilled two tiles on
  }
}

// acc[q][r] += sum_{k < n} in_s[k][col + r] * W[k][q*H + j], the weights
// rounded to the dot dtype (DB: bfloat16). w_s holds 2 x KT x 4H weights.
// Called by every thread of the CTA; only `live` threads accumulate.
template <typename WT, bool DB>
__device__ void gate_dot(float (&acc)[4][RB], const float* in_s, int BTP, int col,
                         const WT* W, int n, int H, int j, bool live, WT* w_s, int KT) {
  const int G = 4 * H;
  staged_rows(W, n, G, w_s, KT, [&](const WT* tile, int k0, int rows) {
    if (live) {
      const WT* ws = tile + j;
      const float* in = in_s + k0 * BTP + col;
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        const float w0 = rndw<WT, DB>(ws[kk * G]), w1 = rndw<WT, DB>(ws[kk * G + H]);
        const float w2 = rndw<WT, DB>(ws[kk * G + 2 * H]);
        const float w3 = rndw<WT, DB>(ws[kk * G + 3 * H]);
        const float4 lo = *reinterpret_cast<const float4*>(in + kk * BTP);
        const float4 hi = *reinterpret_cast<const float4*>(in + kk * BTP + 4);
        const float v[RB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[0][r] += v[r] * w0;
          acc[1][r] += v[r] * w1;
          acc[2][r] += v[r] * w2;
          acc[3][r] += v[r] * w3;
        }
      }
    }
  });
}

// clip(round(v * 127), -127, 127), round half to even (jnp.round): h in
// (-1, 1) at the fixed scale of JAX's dot_hh
__device__ __forceinline__ signed char quant_h(float v) {
  return static_cast<signed char>(max(-127, min(127, __float2int_rn(v * 127.f))));
}

// The int8 form of gate_dot: acc[q][r] += scale[q*H + j] * sum_{g < ng}
// dp4a(inq_s[g][col + r], W[g][q*H + j]), inq_s the quantized rows as int8
// x4 words [ng][BTP], W [ng][4H] words staged through w_s (2 x KT x 4H).
__device__ void gate_dot_q(float (&acc)[4][RB], const int* inq_s, int BTP, int col,
                           const int* W, int ng, int H, int j, bool live, int* w_s, int KT,
                           const float* scale) {
  const int G = 4 * H;
  int ia[4][RB];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < RB; ++r) ia[q][r] = 0;
  staged_rows(W, ng, G, w_s, KT, [&](const int* tile, int g0, int rows) {
    if (live) {
      const int* ws = tile + j;
      const int* in = inq_s + g0 * BTP + col;
#pragma unroll 4
      for (int gg = 0; gg < rows; ++gg) {
        const int w0 = ws[gg * G], w1 = ws[gg * G + H], w2 = ws[gg * G + 2 * H];
        const int w3 = ws[gg * G + 3 * H];
        const int4 lo = *reinterpret_cast<const int4*>(in + gg * BTP);
        const int4 hi = *reinterpret_cast<const int4*>(in + gg * BTP + 4);
        const int v[RB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          ia[0][r] = __dp4a(v[r], w0, ia[0][r]);
          ia[1][r] = __dp4a(v[r], w1, ia[1][r]);
          ia[2][r] = __dp4a(v[r], w2, ia[2][r]);
          ia[3][r] = __dp4a(v[r], w3, ia[3][r]);
        }
      }
    }
  });
  if (live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float s = scale[q * H + j];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[q][r] += (float)ia[q][r] * s;
    }
  }
}

// the byte of unit j, row r in a quantized row buffer [H/4][BTP] of int8 x4 words
__device__ __forceinline__ void put_q(int* hq, int BTP, int j, int r, signed char v) {
  reinterpret_cast<signed char*>(hq)[((j >> 2) * BTP + r) * 4 + (j & 3)] = v;
}

// rows of W per staged tile: up to 32, two tiles within 128 KB
template <typename WT>
inline int tile_rows(int G) {
  const int kt = 65536 / (G * static_cast<int>(sizeof(WT)));
  return kt < 1 ? 1 : (kt > 32 ? 32 : kt);
}

// rows of int8 x4 words per staged tile in the bytes of KT rows of WT
template <typename WT>
__host__ __device__ inline int tile_rows_q(int KT) {
  const int kt = KT * static_cast<int>(sizeof(WT)) / 4;
  return kt < 1 ? 1 : kt;
}

// the current card's SMs (an H100 SXM's 132 where they cannot be read)
inline int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// row groups of 8 rows per CTA: as many as fit 512 threads (at most 64),
// halved while the smaller tiles still fit one wave on `sms` SMs (a small
// batch spreads its serial chains over more SMs)
inline int row_groups(long rows, int width, int copies, int sms = sm_count()) {
  int rg = 512 / width;
  rg = rg < 1 ? 1 : (rg > 64 ? 64 : rg);
  while (rg > 1 && (rows + RB * (rg / 2) - 1) / (RB * (rg / 2)) * copies <= sms) rg /= 2;
  return rg;
}

}  // namespace lstm_gates
