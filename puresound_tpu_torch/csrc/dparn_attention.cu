// DPARN's intra-frequency attention pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of puresound_tpu/ops/dparn_attention_kernel.py
// (dparn_intra_pass, pallas_call at :252). Per row of x [R, F, C] (one
// stream's frame, F frequency tokens):
//   2 x post-norm encoder layer: q, k, v = (x + pe) W (pe on layer 1 only);
//       per head softmax(q k^T / sqrt(Dh)) v; x = LN(x + o Wo);
//       x = LN(x + relu(x W1 + b1) W2 + b2)
//   y = LN(x Wfc + bfc)
// Each product rounds its operands to the dot dtype and sums in float32;
// softmax and the two-pass LayerNorms (eps 1e-5) run in float32; y is
// written in x's dtype.
//
// What bounds it on the H100. At R = 4,096 rows (2,048 streams, K = 2) and
// F = 64, C = FFD = 128, 8 heads, one call is about 129 GFLOP against 0.13
// GB of x and y in float32: operations bound it, 1.9 ms at the 67 TFLOP/s of
// float32 without tensor cores.
//
// What this design does about it. A TPU tile keeps r_tile rows in VMEM;
// here nothing of a row's ~30 stock ops' intermediates leaves the SM. Under
// bf16 weights and dots at the model's geometry (F = 64, C = FFD = 128, 8
// heads: the serving path) a persistent CTA runs two rows at once on wgmma,
// one per consumer warpgroup, with the weights streamed once per row pair by
// the bulk copy engine through an mbarrier ring (dparn_wgmma.cuh): the bound
// there is the bf16 tensor-core peak, 0.13 ms. Every other shape and dtype
// keeps one CTA a row with the row, Q, K, V and the logits in float32 shared
// memory and cp.async weight tiles on CUDA cores (dparn_attention.cuh;
// float32 dots stay off the tensor cores: TF32 would change the numerics).
// The launch plan comes from ops/dparn_attention_kernel.py `plan` and is
// checked again here.
#include "dparn_attention.cuh"

// plan: path, rows a CTA, warpgroups, stages, KT, shared bytes, CTAs (`plan`
// in the wrapper); strides: each weight's (in, out) strides in elements;
// packed: 13 x 128 x 128 bf16 scratch for the wgmma path
extern "C" int dparn_intra_pass(const void* x, const void* pe, const void* const* weights,
                                const long* strides, void* y, int R, int F, int C, int FFD,
                                int heads, int x_bf16, int pe_bf16, int w_bf16, int dot_bf16,
                                const int* plan, void* packed, void* stream) {
  dparn_attn::AttnParams p{};
  p.x = x;
  p.pe = pe;
  for (int i = 0; i < dparn_attn::NW; ++i) {
    p.w[i] = weights[i];
    p.ws[i][0] = strides[2 * i];
    p.ws[i][1] = strides[2 * i + 1];
  }
  p.y = y;
  p.packed = packed;
  p.sr = (long)F * C;
  p.sf = C;
  p.R = R;
  p.F = F;
  p.C = C;
  p.FFD = FFD;
  p.heads = heads;
  p.x_bf16 = x_bf16;
  p.pe_bf16 = pe_bf16;
  p.y_bf16 = x_bf16;
  p.residual = 0;
  return static_cast<int>(
      dparn_attn::dispatch(p, plan, w_bf16, dot_bf16, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* dparn_attention_error_string(int err) {
  return dparn_attn::error_string(err);
}
