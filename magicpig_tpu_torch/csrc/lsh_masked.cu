// Two-stage LSH-sampled decode, stage 2: the debiased masked attend over
// the offload region from precomputed collision words (stage 1 is
// collision_words.cu), with the length mask, the collision-probability
// debias, online softmax, the weighted V sum and the sampled count.
//
// Replaces magicpig_tpu/ops/pallas/lsh_decode.py::lsh_masked_attention (the
// pallas_call at lsh_decode.py:271), the attend of the two-stage fallback
// of magicpig_tpu/ops/pallas/lsh_decode.py::lsh_fused_decode (odd L), with
// bf16 K/V or int8 K/V and per-token f32 scales, and the exact, poly and
// none debias forms, at head dims 64 (this source's instances) and 128
// (lsh_masked_d128.cu, lsh_masked_int8_d128.cu: Llama-3.1-8B at odd L).
// The TPU kernel streams a [B, Hq, S] int8 mask; this one reads the packed
// words [B, Hq, S/32] int32 the scan wrote (8x fewer bytes: one bit a
// token and head), so the unpack happens in the kernel.
//
// Bound on the H100: device memory: the words (4 bytes per 32 tokens and
// query head) and the K/V/norm rows some head of the group sampled. The
// attend is the fused kernel's (lsh_common.cuh with kWords): a block reads
// its split's words instead of scanning the signatures, gathers the
// sampled rows only, scores only the sampled pairs and merges the splits
// in the same launch.
#include "lsh_common.cuh"

// words [B, Hq, S/32] int32: bit j of word w set iff token 32w + j is
// sampled for that head; bits at or past the length are ignored. Other
// arguments as mp_lsh_fused_decode.
extern "C" int mp_lsh_masked_attention(const void* q, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale,
                                       const void* k_norm, const void* words,
                                       const void* length, void* part_o,
                                       void* part_lse, void* part_cnt,
                                       void* tickets, void* out, void* lse,
                                       void* cnt, int batch, int s_cap,
                                       int hq, int hkv, int head_dim, int K,
                                       int L, int split, float sm_scale,
                                       int debias, const void* poly_coef,
                                       void* stream) {
  mp::LshArgs a{};
  a.q = q; a.k = k; a.v = v; a.k_scale = k_scale; a.v_scale = v_scale;
  a.k_norm = k_norm;
  a.words = static_cast<const int*>(words);
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
  return mp::launch_lsh_decode<true>(a, hq, head_dim, debias, poly_coef,
                                     stream);
}
