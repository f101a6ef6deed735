// Both block_topk attends (rescore_attend.cu, block_attend.cu) in their
// general tile: `chunk_attend_tile` of chunk_attend.cuh (up to
// mp::kHeadTile query heads a block), for every form that has no exact
// instance (any group size at head dims 16 and 32; group sizes other than
// 1, 2, 4 and 8 at 64, and other than 1, 2, 3, 4 and 8 at 128): the
// rescore over bf16, int8 and (at 64 and 128) packed int4 K, the
// stored-score attend over bf16 and int8 V. A source of its own so that
// nvcc compiles these instances beside the others; mp_rescore_attend and
// mp_block_attend call rescore_attend_part and block_attend_part.
//
// Replaces and bounds: as rescore_attend.cu and block_attend.cu. Design:
// chunk_attend.cuh (a block takes `chunk` tokens of its (request, kv head,
// block of heads)'s selected blocks through a bulk-copy ring, an online
// softmax carries across them, and the blocks merge in the same launch).
#include "chunk_attend.cuh"

namespace {

template <typename KT, typename VT, int kD>
__global__ void __launch_bounds__(mp::kAttThreads, 1)
rescore_attend_part_kernel(const __grid_constant__ mp::ChunkArgs a) {
  mp::chunk_attend_tile<KT, VT, false, kD>(a);
}

template <typename VT, int kD>
__global__ void __launch_bounds__(mp::kAttThreads, 1)
block_attend_part_kernel(const __grid_constant__ mp::ChunkArgs a) {
  mp::chunk_attend_tile<int8_t, VT, true, kD>(a);
}

template <typename KT, typename VT, int kD>
int launch_rescore(const mp::ChunkArgs& a, cudaStream_t st) {
  static unsigned smem_set = 0;
  return mp::launch_chunk_tile<KT, VT, false, kD>(
      rescore_attend_part_kernel<KT, VT, kD>, a, smem_set, st);
}

template <typename VT, int kD>
int launch_stored(const mp::ChunkArgs& a, cudaStream_t st) {
  static unsigned smem_set = 0;
  return mp::launch_chunk_tile<int8_t, VT, true, kD>(
      block_attend_part_kernel<VT, kD>, a, smem_set, st);
}

template <int kD>
int rescore_kind(int k_kind, const mp::ChunkArgs& a, cudaStream_t st) {
  switch (k_kind) {
    case mp::kKeyBf16:
      return launch_rescore<__nv_bfloat16, __nv_bfloat16, kD>(a, st);
    case mp::kKeyInt8: return launch_rescore<int8_t, int8_t, kD>(a, st);
    case mp::kKeyInt4:
      if constexpr (kD >= 64) return launch_rescore<mp::Int4x2, int8_t, kD>(a, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kD>
int stored_kind(bool v_int8, const mp::ChunkArgs& a, cudaStream_t st) {
  return v_int8 ? launch_stored<int8_t, kD>(a, st)
                : launch_stored<__nv_bfloat16, kD>(a, st);
}

}  // namespace

namespace mp {

int rescore_attend_part(int k_kind, int head_dim, const ChunkArgs& a,
                        cudaStream_t st) {
  switch (head_dim) {
    case 16: return rescore_kind<16>(k_kind, a, st);
    case 32: return rescore_kind<32>(k_kind, a, st);
    case 64: return rescore_kind<64>(k_kind, a, st);
    case 128: return rescore_kind<128>(k_kind, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int block_attend_part(bool v_int8, int head_dim, const ChunkArgs& a,
                      cudaStream_t st) {
  switch (head_dim) {
    case 16: return stored_kind<16>(v_int8, a, st);
    case 32: return stored_kind<32>(v_int8, a, st);
    case 64: return stored_kind<64>(v_int8, a, st);
    case 128: return stored_kind<128>(v_int8, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mp
