// The two-stage LSH attend (lsh_masked.cu) at head dim 128 with bf16 K/V:
// Llama-3.1-8B and Llama-3.2-3B at odd L, the exact, poly and none debias
// for group sizes 1, 2, 3, 4 and 8. A source of its own so that nvcc
// compiles these instances beside the others; mp_lsh_masked_attention
// (lsh_masked.cu) calls lsh_masked_bf16_d128.
//
// Replaces, bounds and design: as lsh_masked.cu. A gathered bf16 row at
// d = 128 is 256 bytes (16 swizzled 16-byte units, two 128-byte lines); the
// pass's rows take 80 KB of shared memory; P.V gives each warp 32 output
// dims.
#include "lsh_common.cuh"

namespace mp {

int lsh_masked_bf16_d128(int g, int debias, const LshArgs& a,
                         cudaStream_t st) {
  return dispatch_lsh_group<__nv_bfloat16, true, 128>(g, debias, a, st);
}

}  // namespace mp
