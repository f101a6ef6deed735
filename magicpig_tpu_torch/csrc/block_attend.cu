// Attention over the selected blocks of the block_topk estimator from
// stored scores (the store pipeline: exact_scores_ranked wrote the masked
// scores and the block maxes).
//
// Replaces magicpig_tpu/ops/pallas/block_attend.py::block_attend (the
// pallas_call at block_attend.py:224): bf16 V, or int8 V with f32 row
// scales.
//
// Bound on the H100: reading the selected blocks' scores (4 bytes a token
// and query head) and V rows (128 bytes a token and kv head in bf16) once;
// ~2 flops per byte, so device memory bounds it. Design: as in
// rescore_attend.cu, one block of 128 threads per (selected block, kv head,
// request) in place of the TPU's per-(request, kv head) loop, each writing
// a normalised partial and its LSE for the merge of flash_decode.cu; the
// block reads its G score rows (coalesced) where the rescore recomputes
// them. Scores past the length arrive as -inf and give p = 0; a block whose
// scores are all -inf writes (0, -inf). The V scale multiplies p.
#include "block_common.cuh"
#include "decode_common.cuh"

namespace {

template <int G, typename VT>
__global__ void __launch_bounds__(mp::kBlkThreads)
block_attend_kernel(const float* __restrict__ scores,
                    const int* __restrict__ blk_ids,
                    const VT* __restrict__ v,
                    const float* __restrict__ v_scale,
                    float* __restrict__ part_o,
                    float* __restrict__ part_lse, int batch, int s_cap,
                    int hkv, int block_size) {
  using namespace mp;
  __shared__ BlockAttendSmem<G, VT> sm;

  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nsel = gridDim.x;
  const int tid = threadIdx.x;
  const int hq = hkv * G;
  const size_t row0 = (static_cast<size_t>(j) * batch + b) * hq + kh * G;
  const int id = selected_block(blk_ids, b, kh, j, hkv, nsel,
                                s_cap / block_size);
  if (id < 0) {
    write_empty_block(part_o, part_lse, row0, G, tid);
    return;
  }
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  const size_t tok0 = head * s_cap + static_cast<size_t>(id) * block_size;
  const float* sc = scores + head * G * s_cap +
                    static_cast<size_t>(id) * block_size;
  for (int i = tid; i < G * block_size; i += kBlkThreads)
    sm.ps[i] = sc[static_cast<size_t>(i / block_size) * s_cap +
                  i % block_size];
  __syncthreads();
  attend_block<G, VT>(sm, block_size, block_size, v + tok0 * kBlkD,
                      v_scale != nullptr ? v_scale + tok0 : nullptr, part_o,
                      part_lse, row0, tid);
}

template <int G, typename VT>
int launch(const void* scores, const void* blk_ids, const void* v,
           const void* v_scale, void* part_o, void* part_lse, void* out,
           void* lse, int batch, int s_cap, int hkv, int nsel,
           int block_size, cudaStream_t stream) {
  dim3 grid(nsel, hkv, batch);
  block_attend_kernel<G, VT><<<grid, mp::kBlkThreads, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const int*>(blk_ids),
      static_cast<const VT*>(v), static_cast<const float*>(v_scale),
      static_cast<float*>(part_o), static_cast<float*>(part_lse), batch,
      s_cap, hkv, block_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mp::launch_merge(static_cast<const float*>(part_o),
                          static_cast<const float*>(part_lse), nullptr,
                          static_cast<float*>(out), static_cast<float*>(lse),
                          nullptr, nsel, batch * hkv * G, stream);
}

template <typename VT>
int dispatch(int g, const void* scores, const void* blk_ids, const void* v,
             const void* v_scale, void* part_o, void* part_lse, void* out,
             void* lse, int batch, int s_cap, int hkv, int nsel,
             int block_size, cudaStream_t st) {
#define MP_ATTEND_CASE(G)                                                  \
  case G:                                                                  \
    return launch<G, VT>(scores, blk_ids, v, v_scale, part_o, part_lse,   \
                         out, lse, batch, s_cap, hkv, nsel, block_size, st);
  switch (g) {
    MP_ATTEND_CASE(1)
    MP_ATTEND_CASE(2)
    MP_ATTEND_CASE(4)
    MP_ATTEND_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_ATTEND_CASE
}

}  // namespace

// v_int8: V int8 with row scales; otherwise bf16, v_scale null.
extern "C" int mp_block_attend(const void* scores, const void* blk_ids,
                               const void* v, const void* v_scale,
                               void* part_o, void* part_lse, void* out,
                               void* lse, int batch, int s_cap, int hq,
                               int hkv, int head_dim, int nsel,
                               int block_size, int v_int8, void* stream) {
  const int g = hkv > 0 ? hq / hkv : 0;
  if (head_dim != mp::kBlkD || g * hkv != hq || nsel <= 0 ||
      block_size <= 0 || block_size % 64 != 0 || s_cap % block_size != 0 ||
      g * block_size > mp::kMaxBlockScores ||
      (v_int8 != 0) != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_int8)
    return dispatch<int8_t>(g, scores, blk_ids, v, v_scale, part_o,
                            part_lse, out, lse, batch, s_cap, hkv, nsel,
                            block_size, st);
  return dispatch<__nv_bfloat16>(g, scores, blk_ids, v, v_scale, part_o,
                                 part_lse, out, lse, batch, s_cap, hkv, nsel,
                                 block_size, st);
}
