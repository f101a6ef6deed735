// Shared by the split-sequence kernels (flash_decode.cu, lsh_common.cuh,
// rescore_attend.cu, block_attend.cu): the head dim, and the LSE merge of
// per-split partials (out / l, lse) that the block kernels launch after
// their splits (flash_decode and the LSH kernels merge in the same launch).
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kDecD = 64;          // head dim

// Merge `nsplit` partials of `rows` (request, query head) rows each:
// part_o [nsplit, rows, 64], part_lse and part_cnt [nsplit, rows] (part_cnt
// and cnt may be null). Defined in flash_decode.cu.
int launch_merge(const float* part_o, const float* part_lse,
                 const float* part_cnt, float* out, float* lse, float* cnt,
                 int nsplit, int rows, cudaStream_t stream);

}  // namespace mp
