// The fused LSH-sampled decode (lsh_fused.cu) at head dim 128 with bf16
// K/V: the same template (lsh_common.cuh) instantiated for Llama-3.1-8B's
// and Llama-3.2-3B's decode, the exact, poly and none debias for group
// sizes 1, 2, 3, 4 and 8.
// A source of its own so that nvcc compiles these instances beside the
// others; mp_lsh_fused_decode (lsh_fused.cu) calls lsh_fused_bf16_d128.
//
// Replaces, bounds and design: as lsh_fused.cu. At d = 128 a gathered bf16
// row is 256 bytes (16 swizzled 16-byte units, two 128-byte lines); the
// pass's rows take 80 KB of shared memory, the scan's ring the same 40 KB
// as at d = 64; P.V gives each warp 32 output dims.
#include "lsh_common.cuh"

namespace mp {

int lsh_fused_bf16_d128(int g, int debias, const LshArgs& a, cudaStream_t st) {
  return dispatch_lsh_group<__nv_bfloat16, false, 128>(g, debias, a, st);
}

}  // namespace mp
