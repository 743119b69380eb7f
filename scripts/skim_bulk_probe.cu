// The per-SM bulk-copy rate that sizes fused_skim_frames's tensor-core route
// (puresound_tpu_torch/csrc/skim_stream_tc.cuh): each CTA streams `stages`
// stages of 16 KB from `src` (n_src stages, which stay in L2) through 4
// slots of shared memory, one copy in flight a slot, no compute. Built and
// timed by scripts/skim_bulk_probe.py.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int STAGE_BYTES = 16384;   // skim_stream_tc.cuh's ring stage

__global__ void bulk_rate_kernel(const unsigned char* src, int n_src, int stages, int* sink) {
  extern __shared__ __align__(16) unsigned char sm[];
  const uint32_t ring = hopper::smem_addr(sm), bars = ring + 4 * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 4; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_fence_init();
    for (int s = 0; s < stages; ++s) {
      const int slot = s & 3;
      if (s >= 4) hopper::mbar_wait(bars + 8 * slot, (uint32_t)((s - 4) >> 2) & 1);
      hopper::mbar_expect_tx(bars + 8 * slot, STAGE_BYTES);
      hopper::bulk_load(ring + slot * STAGE_BYTES,
                        src + (size_t)((blockIdx.x * 7 + s) % n_src) * STAGE_BYTES, STAGE_BYTES,
                        bars + 8 * slot);
    }
    for (int s = stages > 4 ? stages - 4 : 0; s < stages; ++s)
      hopper::mbar_wait(bars + 8 * (s & 3), (uint32_t)(s >> 2) & 1);
    sink[blockIdx.x] = sm[blockIdx.x % STAGE_BYTES];
  }
}

}  // namespace

// `ctas` CTAs of 32 threads each stream `stages` stages of src into shared memory
extern "C" int skim_bulk_rate(const void* src, int n_src, int ctas, int stages, void* sink,
                              void* stream) {
  const int smem = 4 * STAGE_BYTES + 64;
  cudaError_t err =
      cudaFuncSetAttribute(bulk_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bulk_rate_kernel<<<ctas, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), n_src, stages, static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}
