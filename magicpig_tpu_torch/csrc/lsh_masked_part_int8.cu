// The masked attend from collision words (lsh_masked.cu) in its general tile
// with int8 K/V: the template of
// lsh_common.cuh at G = 16 (kHeadTile) with kPart, for
// every form that has no exact instance (any group size at head dims 16
// and 32; group sizes other than 1, 2, 4 and 8 at 64, and other than 1, 2,
// 3, 4 and 8 at 128), one instance a head dim, the debias form read from
// the arguments. A source of its own so that nvcc compiles these
// instances beside the others; launch_lsh_decode (lsh_common.cuh) calls
// lsh_masked_part_int8.
//
// Replaces, bounds and design: as lsh_masked.cu; the general tile's block
// takes up to 16 query heads of its kv head (common.cuh, `Heads`).
#include "lsh_common.cuh"

namespace mp {

int lsh_masked_part_int8(int d, const LshArgs& a, cudaStream_t st) {
  return launch_lsh_part<int8_t, true>(d, a, st);
}

}  // namespace mp
