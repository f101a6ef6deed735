// The two-stage LSH attend (lsh_masked.cu) at head dim 128 with int8 K/V
// and per-token f32 scales: the exact, poly and none debias for group
// sizes 1, 2, 3, 4 and 8. A source of its own so that nvcc compiles these
// instances beside the others; mp_lsh_masked_attention (lsh_masked.cu)
// calls lsh_masked_int8_d128.
//
// Replaces, bounds and design: as lsh_masked.cu. An int8 row at d = 128 is
// 128 bytes, 8 swizzled 16-byte units as a bf16 row at d = 64; P.V gives
// each warp 32 output dims, the int8 V widened to bf16 exactly.
#include "lsh_common.cuh"

namespace mp {

int lsh_masked_int8_d128(int g, int debias, const LshArgs& a,
                         cudaStream_t st) {
  return dispatch_lsh_group<int8_t, true, 128>(g, debias, a, st);
}

}  // namespace mp
