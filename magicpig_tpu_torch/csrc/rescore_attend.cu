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
// K) at d = 64, 264 (200) at d = 128; ~4 flops per byte, so device memory
// bounds it. Every head dim is an instance of one template. The TPU grid is one
// step per (request, kv head) with a loop over the selected blocks; here
// one block of 128 threads takes one chunk of one selected block of one
// (kv head, request), brings its K and V rows and scales by bulk copies
// under one mbarrier, scores the keys with the scorer's own routine (so
// ranking and attend agree bit for bit), and runs the softmax and P.V on
// tensor cores; the chunks merge in the same launch (chunk_attend.cuh).
// Tokens at or past the length are not read.
#include "chunk_attend.cuh"

namespace {

template <int G, typename KT, typename VT, int kD>
__global__ void __launch_bounds__(mp::kBlkThreads)
rescore_attend_kernel(const __grid_constant__ mp::ChunkArgs a) {
  mp::chunk_attend<G, KT, VT, false, kD>(a);
}

template <int G, typename KT, typename VT, int kD>
int launch(const mp::ChunkArgs& a, cudaStream_t st) {
  static unsigned smem_set = 0;
  return mp::launch_chunk_attend<G, KT, VT, false, kD>(
      rescore_attend_kernel<G, KT, VT, kD>, a, smem_set, st);
}

template <typename KT, typename VT, int kD>
int dispatch(int g, const mp::ChunkArgs& a, cudaStream_t st) {
  switch (g) {
    case 1: return launch<1, KT, VT, kD>(a, st);
    case 2: return launch<2, KT, VT, kD>(a, st);
    case 3:   // head dim 128 only (chunk_args_ok)
      if constexpr (kD == 128) return launch<3, KT, VT, kD>(a, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: return launch<4, KT, VT, kD>(a, st);
    case 8: return launch<8, KT, VT, kD>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kD>
int dispatch_kind(int k_kind, int g, const mp::ChunkArgs& a,
                  cudaStream_t st) {
  switch (k_kind) {
    case mp::kKeyBf16:
      return dispatch<__nv_bfloat16, __nv_bfloat16, kD>(g, a, st);
    case mp::kKeyInt8: return dispatch<int8_t, int8_t, kD>(g, a, st);
    case mp::kKeyInt4: return dispatch<mp::Int4x2, int8_t, kD>(g, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// k_kind (a KeyKind): bf16 K and V, scales null; int8 K and V with row
// scales; packed int4 K and int8 V with row scales. head_dim: 16, 32, 64
// or 128 (packed int4 at 64 and 128); hq any multiple of hkv (the exact
// instances at hq / hkv 1, 2, 4 and 8, and 3 at 128; the general tile,
// rescore_attend_part in chunk_attend_part.cu, otherwise). part_o [nsel *
// chunks a block, B * Hq, head_dim] and part_lse [nsel * chunks a block,
// B * Hq] hold the partials; tickets [B * Hkv * ceil(hq / hkv / 8)] (B *
// Hkv for the exact instances) is 0 between calls; chunk: tokens a CUDA
// block, a multiple of 64 up to 512 (at most 256 for bf16 K and V at
// head_dim 128).
extern "C" int mp_rescore_attend(const void* q, const void* blk_ids,
                                 const void* k, const void* k_scale,
                                 const void* v, const void* v_scale,
                                 const void* length, void* part_o,
                                 void* part_lse, void* tickets, void* out,
                                 void* lse, int batch, int s_cap, int hq,
                                 int hkv, int head_dim, int nsel,
                                 int block_size, int chunk, int k_kind,
                                 float sm_scale, void* stream) {
  mp::ChunkArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.blk_ids = static_cast<const int*>(blk_ids);
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.length = static_cast<const int*>(length);
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
  a.sm_scale = sm_scale;
  const bool quant = k_kind != mp::kKeyBf16;
  if (!mp::chunk_args_ok(a, hq, head_dim) ||
      (k_kind == mp::kKeyInt4 && head_dim < 64) ||
      quant != (k_scale != nullptr) || quant != (v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  a.group = g;
  if (!mp::exact_group(g, head_dim))
    return mp::rescore_attend_part(k_kind, head_dim, a, st);
  return head_dim == 128 ? dispatch_kind<128>(k_kind, g, a, st)
                         : dispatch_kind<64>(k_kind, g, a, st);
}
