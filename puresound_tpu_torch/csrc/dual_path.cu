// DPCRN's dual-path bottleneck for one chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of puresound_tpu/ops/dual_path_kernel.py
// (dual_path_chunk, pallas_call at :433, body dual_path_body :94-168). Per
// block, on x [F, K, B, CH] held in float32 between passes (rows of the
// intra pass r = k*B + b, R = K*B; rows of the inter pass (f, b)):
//   intra: a bidirectional LSTM over f, zero initial state, per direction
//          gates = x[f, r] @ W_ih + h @ W_hh + b;  c = f*c + i*g;  h = o*tanh(c)
//          x[f, r] += LN(yf[f, r] @ PW_f + yb[f, r] @ PW_b + pb)
//   inter: an LSTM over k from the carried h / c [F, B, H], and per frame
//          x[f, k, b] += LN(h @ PW_i + pb_i)
// LN is two-pass over CH, eps 1e-5. Each dot rounds its operands to the dot
// dtype and sums in float32; the LSTM state is float32; yf / yb hold the
// dot dtype's values (in float32 storage); y is written in x's dtype and
// the carries in theirs. Weights are all float32 or all bfloat16.
//
// What bounds it on the H100. At 2048 streams (F = 64, K = 2, CH = H = 128)
// one call is 463.8 GFLOP: per block 137.4 in the intra scans, 17.2 in the
// intra projection, 68.7 in the inter scan and 8.6 in its projection; 6.92
// ms at the 67 TFLOP/s of float32 without tensor cores, against about 0.27
// GB (float32) of x, y and carries. Operations bound it, and the intra pass
// is a serial chain of 64 steps per row.
//
// What this design does about it. A TPU tile keeps the whole [F, K*bt, CH]
// activation in 100 MB of VMEM; one SM's 227 KB of shared memory holds
// about three streams' worth. So the call is three passes per block with
// scratch in device memory (x_scr [F, R, CH] and yf / yb [2, F, R, H],
// float32, about 0.4 GB at 2048 streams), all launched by one C call:
//  A. the intra scans: one CTA per (row tile, direction) walks all F steps
//     with c in registers and h in shared memory (double-buffered); thread
//     (rg, j) owns hidden unit j of 8 rows and computes its four gate
//     columns, the input projection included (x_t staged in shared memory
//     per step), so gates never leave registers (lstm_gates.cuh);
//  B. the intra projection: one CTA per 32 rows, thread (rg, c) owns output
//     channel c of 8 rows, then a warp-per-row LayerNorm from shared memory
//     and the residual add;
//  C. the inter scan: one CTA per (f, b) row tile runs the K steps, each
//     with its projection, LayerNorm and residual, keeping h / c on chip
//     from the carry read to the carry write. The last block writes y.
// The LSTM weights (W_ih, W_hh: 512 KB per direction in f32, 256 KB in
// bf16) stream through shared memory in cp.async tiles of 32 rows,
// double-buffered, so the FMA loops of A and C read only shared memory; a
// first version that read them from L1/L2 inside the loop ran at about a
// quarter of the FMA rate (PERF.md). Row tiles are 32 rows, halved
// (down to 8) while the CTAs would not cover the SMs once, so a small
// batch spreads its serial chains over more SMs. The projection weights
// stream from L1/L2. Tensor cores (mma / wgmma) and TMA are later work.
//
// int8_hh (JAX's dot_hh): each w_hh comes as int8 x4 words [H/4][4H] with
// its scales / 127^2; h is quantized (clip(rint(h * 127), +-127)) as it is
// written to shared memory, where it stays int8 (a quarter of the bytes),
// and the recurrent product runs as __dp4a on the CUDA cores, its weight
// tiles staged like the float ones (lstm_gates.cuh gate_dot_q). xscr_half:
// the scratch x_scr is bfloat16, x is first copied into it rounded, and
// every write to it (the intra residual, each inter step) rounds; the last
// block's y carries the same rounding.
#include "dual_path_passes.cuh"

using namespace dual_path_passes;

extern "C" int dual_path_chunk(const void* x, const void* const* h_in, const void* const* c_in,
                               const void* const* weights, const void* const* s_hh, void* y,
                               void* const* h_out, void* const* c_out, void* x_scr,
                               void* y_dir, int n, int F, int K, int B, int CH, int H,
                               int x_bf16, int s_bf16, int w_bf16, int dot_bf16,
                               int xscr_half, void* stream) {
  Chunk q{x, h_in, c_in, weights, s_hh, y, h_out, c_out, x_scr,
          static_cast<float*>(y_dir), n, F, K, B, CH, H, x_bf16, s_bf16, x_bf16, xscr_half};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16)
    err = dot_bf16 ? run<__nv_bfloat16, true>(q, s) : run<__nv_bfloat16, false>(q, s);
  else
    err = dot_bf16 ? run<float, true>(q, s) : run<float, false>(q, s);
  return static_cast<int>(err);
}

extern "C" const char* dual_path_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
