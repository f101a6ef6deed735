// Attention over the selected blocks of the block_topk estimator, with the
// blocks' scores recomputed from the quantized K (the rescore pipeline: the
// ranking pass stored only block maxes).
//
// Replaces magicpig_tpu/ops/pallas/rescore_attend.py::rescore_attend (the
// pallas_call at rescore_attend.py:217): int8 K and V with f32 row scales,
// packed int4 K (its packed=True form, in the port's layout, ops/pack4.py)
// with int8 V, or bf16 K and V.
//
// Bound on the H100: reading the selected blocks' K and V rows and their
// scales once, 136 bytes a token and kv head in int8 (104 with packed int4
// K); the arithmetic is
// ~4 flops per byte, so device memory bounds it. Design: the TPU grid is
// one step per (request, kv head) with a loop over the selected blocks, 16
// steps at B = 2 on one core. On the card that would be 16 blocks on 132
// SMs, so one block of 128 threads takes one (selected block, kv head,
// request), writes its normalised partial and its LSE, and the LSE merge of
// flash_decode.cu combines the partials. The scores come from the scorer's
// own routine (block_common.cuh: mma.sync over 16 keys at a time, each
// warp's 32 keys of a step read straight from device memory, all before
// its products), so ranking and attend
// agree bit for bit; tokens at or past the length are not read, a block
// wholly past it writes the empty partial (0, -inf), and a row of empty
// partials merges to (0, -inf). The V scale multiplies p.
#include "block_common.cuh"
#include "decode_common.cuh"

namespace {

template <int G, typename KT, typename VT>
__global__ void __launch_bounds__(mp::kBlkThreads)
rescore_attend_kernel(const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ blk_ids,
                      const KT* __restrict__ k,
                      const float* __restrict__ k_scale,
                      const VT* __restrict__ v,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ length,
                      float* __restrict__ part_o,
                      float* __restrict__ part_lse, int batch, int s_cap,
                      int hkv, int block_size, float sm_scale) {
  using namespace mp;
  __shared__ BlockAttendSmem<G, VT> sm;

  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nsel = gridDim.x;
  const int tid = threadIdx.x;
  const int hq = hkv * G;
  const size_t row0 = (static_cast<size_t>(j) * batch + b) * hq + kh * G;
  const int id = selected_block(blk_ids, b, kh, j, hkv, nsel,
                                s_cap / block_size);
  const int t0 = id * block_size;
  const int n = id < 0 ? 0 : min(block_size, min(length[b], s_cap) - t0);
  if (n <= 0) {
    write_empty_block(part_o, part_lse, row0, G, tid);
    return;
  }
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  const int warp = tid >> 5, lane = tid & 31, r = lane >> 2, t = lane & 3;
  uint32_t qb[4][2];
  load_q_frag<G>(q + head * G * kBlkD, sm_scale, lane, qb);

  // 32 keys a warp at a time, the warps in turn: the four rows a lane
  // needs (keys m0 + r, + 8, + 16, + 24) and their scales are all loaded
  // before the two 16-key products, so a warp waits on device memory once
  // a step.
  constexpr int kRowBytes = key_row_bytes<KT>();
  const size_t tok0 = head * s_cap + t0;
  const uint8_t* k_blk = reinterpret_cast<const uint8_t*>(k) + tok0 * kRowBytes;
  for (int m0 = 32 * warp; m0 < n; m0 += 32 * (kBlkThreads / 32)) {
    uint4 x[4][2] = {};
    float ksc[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = m0 + r + 8 * i;
      if (key < n) {
        key_chunks(k_blk + static_cast<size_t>(key) * kRowBytes, t, 0, x[i], k);
        if (k_scale != nullptr) ksc[i] = k_scale[tok0 + key];
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t wa[8], wb[8];
      key_words(x[2 * m], t, wa, k);
      key_words(x[2 * m + 1], t, wb, k);
      float d[4];
      mma_scores(wa, wb, qb, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 2 * m + (i >> 1), h = 2 * t + (i & 1);
        const int key = m0 + r + 8 * row;
        if (h < G && key < n)
          sm.ps[h * block_size + key] = score_of(d[i], ksc[row]);
      }
    }
  }
  __syncthreads();
  attend_block<G, VT>(sm, block_size, n, v + tok0 * kBlkD,
                     v_scale != nullptr ? v_scale + tok0 : nullptr, part_o,
                     part_lse, row0, tid);
}

template <int G, typename KT, typename VT>
int launch(const void* q, const void* blk_ids, const void* k,
           const void* k_scale, const void* v, const void* v_scale,
           const void* length, void* part_o, void* part_lse, void* out,
           void* lse, int batch, int s_cap, int hkv, int nsel,
           int block_size, float sm_scale, cudaStream_t stream) {
  dim3 grid(nsel, hkv, batch);
  rescore_attend_kernel<G, KT, VT><<<grid, mp::kBlkThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(blk_ids),
      static_cast<const KT*>(k), static_cast<const float*>(k_scale),
      static_cast<const VT*>(v), static_cast<const float*>(v_scale),
      static_cast<const int*>(length), static_cast<float*>(part_o),
      static_cast<float*>(part_lse), batch, s_cap, hkv, block_size,
      sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mp::launch_merge(static_cast<const float*>(part_o),
                          static_cast<const float*>(part_lse), nullptr,
                          static_cast<float*>(out), static_cast<float*>(lse),
                          nullptr, nsel, batch * hkv * G, stream);
}

template <typename KT, typename VT>
int dispatch(int g, const void* q, const void* blk_ids, const void* k,
             const void* k_scale, const void* v, const void* v_scale,
             const void* length, void* part_o, void* part_lse, void* out,
             void* lse, int batch, int s_cap, int hkv, int nsel,
             int block_size, float sm_scale, cudaStream_t st) {
#define MP_RESCORE_CASE(G)                                                   \
  case G:                                                                    \
    return launch<G, KT, VT>(q, blk_ids, k, k_scale, v, v_scale, length,    \
                             part_o, part_lse, out, lse, batch, s_cap, hkv,  \
                             nsel, block_size, sm_scale, st);
  switch (g) {
    MP_RESCORE_CASE(1)
    MP_RESCORE_CASE(2)
    MP_RESCORE_CASE(4)
    MP_RESCORE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_RESCORE_CASE
}

}  // namespace

// k_kind (a KeyKind): bf16 K and V, scales null; int8 K and V with row
// scales; packed int4 K and int8 V with row scales.
extern "C" int mp_rescore_attend(const void* q, const void* blk_ids,
                                 const void* k, const void* k_scale,
                                 const void* v, const void* v_scale,
                                 const void* length, void* part_o,
                                 void* part_lse, void* out, void* lse,
                                 int batch, int s_cap, int hq, int hkv,
                                 int head_dim, int nsel, int block_size,
                                 int k_kind, float sm_scale, void* stream) {
  const int g = hkv > 0 ? hq / hkv : 0;
  const bool quant = k_kind != mp::kKeyBf16;
  if (head_dim != mp::kBlkD || g * hkv != hq || nsel <= 0 ||
      block_size <= 0 || block_size % 64 != 0 || s_cap % block_size != 0 ||
      g * block_size > mp::kMaxBlockScores ||
      quant != (k_scale != nullptr) || quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_kind) {
    case mp::kKeyBf16:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(
          g, q, blk_ids, k, k_scale, v, v_scale, length, part_o, part_lse,
          out, lse, batch, s_cap, hkv, nsel, block_size, sm_scale, st);
    case mp::kKeyInt8:
      return dispatch<int8_t, int8_t>(
          g, q, blk_ids, k, k_scale, v, v_scale, length, part_o, part_lse,
          out, lse, batch, s_cap, hkv, nsel, block_size, sm_scale, st);
    case mp::kKeyInt4:
      return dispatch<mp::Int4x2, int8_t>(
          g, q, blk_ids, k, k_scale, v, v_scale, length, part_o, part_lse,
          out, lse, batch, s_cap, hkv, nsel, block_size, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
