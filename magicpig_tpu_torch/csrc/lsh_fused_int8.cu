// The fused LSH-sampled decode (lsh_fused.cu) at head dim 64 with int8 K/V
// and per-token f32 scales (int4-grid K too): `bench.py`'s lsh mode at
// Llama-3.2-1B's shapes, the exact, poly and none debias for group sizes
// 1, 2, 4 and 8. A source of its own so that nvcc compiles these instances
// beside the others; mp_lsh_fused_decode (lsh_fused.cu) calls
// lsh_fused_int8_d64.
//
// Replaces, bounds and design: as lsh_fused.cu; the int8 rows (64 bytes, 4
// swizzled units) halve the gathered bytes and leave the scan as it is.
#include "lsh_common.cuh"

namespace mp {

int lsh_fused_int8_d64(int g, int debias, const LshArgs& a, cudaStream_t st) {
  return dispatch_lsh_group<int8_t, false, 64>(g, debias, a, st);
}

}  // namespace mp
