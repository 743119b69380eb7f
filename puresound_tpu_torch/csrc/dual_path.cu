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
// dot dtype's values (float32 storage on the CUDA cores, bfloat16 on the
// tensor cores); the x operand of the tensor cores' products is a bfloat16
// copy of x, which is the dot-dtype rounding; y is written in x's dtype and
// the carries in theirs. Weights are all float32 or all bfloat16.
//
// What bounds it on the H100. At 2048 streams (F = 64, K = 2, CH = H = 128)
// one call is 463.8 GFLOP: per block 137.4 in the intra scans, 17.2 in the
// intra projection, 68.7 in the inter scan and 8.6 in its projection; 6.92
// ms at the 67 TFLOP/s of float32 without tensor cores, 0.47 ms at the 989
// TFLOP/s of bf16, against about 0.27 GB (float32) of x, y and carries.
// Operations bound it, and the intra pass is a serial chain of 64 steps per
// row: a step of a row tile needs the whole h of the step before.
//
// What this design does about it. A TPU tile keeps the whole [F, K*bt, CH]
// activation in 100 MB of VMEM; one SM's 227 KB of shared memory holds
// about three streams' worth. So the call is three passes per block with
// scratch in device memory (x_scr [F, R, CH] and yf / yb [2, F, R, H]),
// all launched by one C call. The launch plan (ops/dual_path_kernel.py
// `_plan`, checked again in dual_path_tc.cuh) picks one of two routes.
//
// Tensor cores (bf16 weights and dots, CH in {64, 128}, H in {32, 64, 128};
// every serving size of both NS models), dual_path_tc.cuh:
//  A. the intra scans on mma.sync m16n8k16 (bf16 -> f32). A direction's
//     W_ih + W_hh is 256 KB in bf16 at H = 128, more than an SM holds, so a
//     cluster of 2 CTAs splits the hidden units: each keeps its half of both
//     matrices resident (128 KB, gate-interleaved by the wrapper so that a
//     warp's four gate n-tiles hold i, f, g, o of the same units), and each
//     step writes its h half into both CTAs' next h tile through distributed
//     shared memory, one cluster barrier a step. The x product stays in the
//     chain: x_t's bf16 rows come in by cp.async, a step ahead where two
//     buffers fit. Hoisting x @ W_ih into a GEMM first (W_hh alone resident)
//     would write and read a 1.07 GB float32 scratch at 2048 streams, about
//     0.32 ms of HBM traffic per block and direction; the cluster reads x
//     once a step from L2. Row tiles are 16 to 128 rows, the smallest whose
//     clusters (2 directions x 2 CTAs a tile) fit the 132 SMs once: 128 at
//     2048 streams, 16 at 256. yf / yb are stored in bf16: they hold bf16
//     values, so that is exact, and it halves pass B's reads.
//  B. the intra projection + LN + residual as a GEMM on wgmma: [PW_f; PW_b]
//     (64 KB in bf16) resident, tiles of 128 rows ([yf | yb], K = 2H) by
//     cp.async two buffers deep, a row's CH sums in one quad so the two-pass
//     LayerNorm runs in registers; it writes x_scr and, without xscr_half,
//     x_scr's bf16 copy, pass C's operand. Bytes bound it.
//  C. the inter scan: the chain kernel of A over rows (f, b) and K steps,
//     from the carries, h / c on chip from the carry read to the carry
//     write; after each step's exchange, each CTA of the cluster projects
//     half of the tile's rows (h @ PW_i on mma.sync, PW_i resident), the
//     LayerNorm's row sums through shared memory in a fixed order, and adds
//     the residual. The last block writes y.
// What bounds it now: the chain's step latency (products, the cell's
// transcendentals, the cluster barrier) at small batch, and the tensor
// cores' feed from shared memory (each fragment load a 4-byte read) at
// large batch; PERF.md has the device ms by pass.
//
// CUDA cores (float32 weights or dots, other widths):
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
// The LSTM weights (W_ih, W_hh: 512 KB per direction in f32) stream through
// shared memory in cp.async tiles of 32 rows, double-buffered, so the FMA
// loops of A and C read only shared memory; a first version that read them
// from L1/L2 inside the loop ran at about a quarter of the FMA rate
// (PERF.md). Row tiles are 32 rows, halved (down to 8) while the CTAs would
// not cover the SMs once, so a small batch spreads its serial chains over
// more SMs. The projection weights stream from L1/L2.
//
// int8_hh (JAX's dot_hh): h is quantized (clip(rint(h * 127), +-127)) as it
// is written to shared memory, where it stays int8, and each w_hh comes
// with its scales / 127^2. On the tensor cores the recurrent product runs as
// mma.sync m16n8k32 (s8 x s8 -> s32) against w_hh's int8 image, packed by
// the wrapper like the bf16 ones; on the CUDA cores as __dp4a against int8
// x4 words [H/4][4H] (lstm_gates.cuh gate_dot_q). Integer sums are exact, so
// both give the same product; each column's sum is scaled once. xscr_half:
// the scratch x_scr is bfloat16, x is first copied into it rounded, and
// every write to it (the intra residual, each inter step) rounds; the last
// block's y carries the same rounding, and x_scr is then the tensor-core
// passes' bf16 operand itself.
#include "dual_path_passes.cuh"

using namespace dual_path_passes;

// plan: dp_tc::PLAN_FIELDS; img: tensor cores, IMAGES a block, else null;
// y_dir: float32 on the CUDA cores, bfloat16 on the tensor cores; x16: the
// tensor cores' bf16 copy of x_scr [F, R, CH] (null under xscr_half)
extern "C" int dual_path_chunk(const void* x, const void* const* h_in, const void* const* c_in,
                               const void* const* weights, const void* const* s_hh, void* y,
                               void* const* h_out, void* const* c_out, void* x_scr,
                               void* y_dir, int n, int F, int K, int B, int CH, int H,
                               int x_bf16, int s_bf16, int w_bf16, int dot_bf16,
                               int xscr_half, const int* plan, const void* const* img,
                               void* x16, void* stream) {
  Chunk q{x, h_in, c_in, weights, s_hh, y, h_out, c_out, x_scr, y_dir, n, F, K, B, CH, H,
          x_bf16, s_bf16, x_bf16, xscr_half, plan, img, static_cast<__nv_bfloat16*>(x16)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16)
    err = dot_bf16 ? run<__nv_bfloat16, true>(q, s) : run<__nv_bfloat16, false>(q, s);
  else
    err = dot_bf16 ? run<float, true>(q, s) : run<float, false>(q, s);
  return static_cast<int>(err);
}

extern "C" const char* dual_path_error_string(int err) {
  if (err == dp_tc::PLAN_MISMATCH) return "the launch plan differs from dual_path_tc.cuh's";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

