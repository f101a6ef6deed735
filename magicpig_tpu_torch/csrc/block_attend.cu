// Attention over the selected blocks of the block_topk estimator from
// stored scores (the store pipeline: exact_scores_ranked wrote the masked
// scores and the block maxes).
//
// Replaces magicpig_tpu/ops/pallas/block_attend.py::block_attend (the
// pallas_call at block_attend.py:224): bf16 V, or int8 V with f32 row
// scales.
//
// Bound on the H100: reading the selected blocks' scores (4 bytes a token
// and query head) and V rows (128 bytes a token and kv head in bf16 at d =
// 64, 256 at d = 128) once; ~2 flops per byte, so device memory bounds
// it. Design: the rescore's attend (chunk_attend.cuh), its chunks and its
// in-launch merge; a chunk's
// G score rows arrive by G bulk copies beside its V rows, where the rescore
// recomputes them. Scores past the length arrive as -inf and give p = 0
// (their bf16 V rows zeroed in shared memory, their V scales unused); a
// chunk whose scores are all -inf writes (0, -inf). With the same chunk the
// result equals the rescore's bit for bit.
#include "chunk_attend.cuh"

namespace {

template <int G, typename VT, int kD>
__global__ void __launch_bounds__(mp::kBlkThreads)
block_attend_kernel(const __grid_constant__ mp::ChunkArgs a) {
  mp::chunk_attend<G, int8_t, VT, true, kD>(a);
}

template <int G, typename VT, int kD>
int launch(const mp::ChunkArgs& a, cudaStream_t st) {
  static unsigned smem_set = 0;
  return mp::launch_chunk_attend<G, int8_t, VT, true, kD>(
      block_attend_kernel<G, VT, kD>, a, smem_set, st);
}

template <typename VT, int kD>
int dispatch(int g, const mp::ChunkArgs& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch<1, VT, kD>(a, st);
    case 2: return launch<2, VT, kD>(a, st);
    case 3:   // head dim 128 only (chunk_args_ok)
      if constexpr (kD == 128) return launch<3, VT, kD>(a, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: return launch<4, VT, kD>(a, st);
    case 8: return launch<8, VT, kD>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// v_int8: V int8 with row scales; otherwise bf16, v_scale null. head_dim
// (16, 32, 64 or 128), group sizes, partials, tickets and chunk as for
// mp_rescore_attend (the general tile: block_attend_part).
extern "C" int mp_block_attend(const void* scores, const void* blk_ids,
                               const void* v, const void* v_scale,
                               void* part_o, void* part_lse, void* tickets,
                               void* out, void* lse, int batch, int s_cap,
                               int hq, int hkv, int head_dim, int nsel,
                               int block_size, int chunk, int v_int8,
                               void* stream) {
  mp::ChunkArgs a{};
  a.scores = static_cast<const float*>(scores);
  a.blk_ids = static_cast<const int*>(blk_ids);
  a.v = v;
  a.v_scale = static_cast<const float*>(v_scale);
  a.part_o = static_cast<float*>(part_o);
  a.part_lse = static_cast<float*>(part_lse);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.tickets = static_cast<int*>(tickets);
  a.batch = batch;
  a.s_cap = s_cap;
  a.hkv = hkv;
  a.nsel = nsel;
  a.block_size = block_size;
  a.chunk = chunk;
  if (!mp::chunk_args_ok(a, hq, head_dim) ||
      (v_int8 != 0) != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  a.group = g;
  if (!mp::exact_group(g, head_dim))
    return mp::block_attend_part(v_int8 != 0, head_dim, a, st);
  if (head_dim == 128)
    return v_int8 ? dispatch<int8_t, 128>(g, a, st)
                  : dispatch<__nv_bfloat16, 128>(g, a, st);
  return v_int8 ? dispatch<int8_t, 64>(g, a, st)
                : dispatch<__nv_bfloat16, 64>(g, a, st);
}
