// Fused LSH-sampled decode: the >=2-of-L SimHash collision scan, the
// length mask, the collision-probability debias, online softmax, the
// weighted V sum and the sampled count, in one pass (lsh_common.cuh with
// the scan, collide_common.cuh).
//
// Replaces magicpig_tpu/ops/pallas/lsh_fused.py::lsh_fused_attention2 (the
// pallas_call at lsh_fused.py:286), reached through
// magicpig_tpu/ops/pallas/lsh_decode.py::lsh_fused_decode, with bf16 K/V or
// int8 K/V and per-token f32 scales, and each of its three debias forms
// (lsh_fused.py:139-158), at head dims 64 and 128 (Llama-3.1-8B's decode).
// Any L, odd or even (the TPU kernel takes even L). This source holds the
// C entry and the bf16 instances at d = 64; the int8 and d = 128 ones
// compile beside it in lsh_fused_int8.cu, lsh_fused_d128.cu and
// lsh_fused_int8_d128.cu (twelve instances each).
//
// Bound on the H100: device memory. The signatures must all be read to
// know which tokens are sampled: K*L bits per token and kv head, 188 bytes
// at K=10, L=150, against 256 bytes of bf16 K+V at d = 64 (512 at d =
// 128), so the scan stream is not small. K, V and the key norm are needed only for tokens that
// some query head of the group samples (~2% per head at the defaults); int8
// rows halve those bytes and leave the signature words as they are. The
// block streams its split's plane rows by TMA into a ring in shared memory
// and matches them there (collide_common.cuh), then gathers and attends
// only the sampled rows and merges the splits in the same launch
// (lsh_common.cuh).
#include "lsh_common.cuh"

namespace mp {

int lsh_fused_bf16_d64(int g, int debias, const LshArgs& a, cudaStream_t st) {
  return dispatch_lsh_group<__nv_bfloat16, false, 64>(g, debias, a, st);
}

}  // namespace mp

// k_scale and v_scale null: bf16 K/V; both set: int8 K/V with those
// per-token scales [B, Hkv, S]. debias: 0 exact, 1 poly (poly_coef: a host
// array of the 21 coefficients, low degree first), 2 none. Partials
// [nsplit, B * Hq] for nsplit = ceil(S / split); tickets [B * Hkv] int32,
// 0 between calls (the kernel resets each one it uses); split: tokens a
// block, a power of two from 32 to 2048.
extern "C" int mp_lsh_fused_decode(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* k_norm,
                                   const void* planes, const void* q_bits,
                                   const void* length, void* part_o,
                                   void* part_lse, void* part_cnt,
                                   void* tickets, void* out, void* lse,
                                   void* cnt, int batch, int s_cap, int hq,
                                   int hkv, int head_dim, int K, int L,
                                   int split, float sm_scale, int debias,
                                   const void* poly_coef, void* stream) {
  mp::LshArgs a{};
  a.q = q; a.k = k; a.v = v; a.k_scale = k_scale; a.v_scale = v_scale;
  a.k_norm = k_norm;
  a.planes = static_cast<const int*>(planes);
  a.q_bits = static_cast<const int*>(q_bits);
  a.length = static_cast<const int*>(length);
  a.part_o = static_cast<float*>(part_o);
  a.part_lse = static_cast<float*>(part_lse);
  a.part_cnt = static_cast<float*>(part_cnt);
  a.tickets = static_cast<int*>(tickets);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.cnt = static_cast<float*>(cnt);
  a.batch = batch; a.s_cap = s_cap; a.hkv = hkv; a.K = K; a.L = L;
  a.split = split;
  a.sm_scale = sm_scale;
  return mp::launch_lsh_decode<false>(a, hq, head_dim, debias, poly_coef,
                                      stream);
}
