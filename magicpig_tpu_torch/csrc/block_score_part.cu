// The block scorer (block_score.cu) in its general tile: the tile kernel of
// block_score.cuh (up to mp::kHeadTile query heads a block), for every form
// that has no exact instance (any group size at head dims 16 and 32, bf16
// and int8 K; group sizes other than 1, 2, 4 and 8 at 64, and other than 1,
// 2, 3, 4 and 8 at 128, bf16, int8 and packed int4 K), in each of its three
// variants. A source of its own so that nvcc compiles these instances
// beside the others; mp_block_score (block_score.cu) calls
// block_score_part.
//
// Replaces and bounds: as block_score.cu. Design: block_score.cuh,
// `block_score_tile_kernel` (a block scores up to 16 query heads of its kv
// head, K brought by bulk copies and widened once for all of them).
#include "block_score.cuh"

namespace {

template <typename KT, int kD>
int launch_part(int group, const void* q, const void* k, const void* k_scale,
                const void* length, void* scores, void* block_max, int batch,
                int s_cap, int hkv, int block_size, float sm_scale,
                cudaStream_t st) {
  return launch_tile<KT, kD>(group, q, k, k_scale, length, scores,
                            block_max, batch, s_cap, hkv, block_size,
                            sm_scale, st);
}

template <int kD>
int launch_kind(int k_kind, int group, const void* q, const void* k,
                const void* k_scale, const void* length, void* scores,
                void* block_max, int batch, int s_cap, int hkv,
                int block_size, float sm_scale, cudaStream_t st) {
  switch (k_kind) {
    case mp::kKeyBf16:
      return launch_part<__nv_bfloat16, kD>(group, q, k, k_scale, length,
                                            scores, block_max, batch, s_cap,
                                            hkv, block_size, sm_scale, st);
    case mp::kKeyInt8:
      return launch_part<int8_t, kD>(group, q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    case mp::kKeyInt4:
      if constexpr (kD >= 64)
        return launch_part<mp::Int4x2, kD>(group, q, k, k_scale, length,
                                           scores, block_max, batch, s_cap,
                                           hkv, block_size, sm_scale, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace mp {

int block_score_part(int k_kind, int head_dim, int group, const void* q,
                     const void* k, const void* k_scale, const void* length,
                     void* scores, void* block_max, int batch, int s_cap,
                     int hkv, int block_size, float sm_scale,
                     cudaStream_t st) {
  switch (head_dim) {
    case 16:
      return launch_kind<16>(k_kind, group, q, k, k_scale, length, scores,
                             block_max, batch, s_cap, hkv, block_size,
                             sm_scale, st);
    case 32:
      return launch_kind<32>(k_kind, group, q, k, k_scale, length, scores,
                             block_max, batch, s_cap, hkv, block_size,
                             sm_scale, st);
    case 64:
      return launch_kind<64>(k_kind, group, q, k, k_scale, length, scores,
                             block_max, batch, s_cap, hkv, block_size,
                             sm_scale, st);
    case 128:
      return launch_kind<128>(k_kind, group, q, k, k_scale, length, scores,
                              block_max, batch, s_cap, hkv, block_size,
                              sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mp
