// Shared by the split-sequence kernels (flash_decode.cu, lsh_common.cuh):
// the head dim.
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kDecD = 64;          // head dim

}  // namespace mp
