// Building blocks of the block_topk kernels (block_score.cu,
// rescore_attend.cu, block_attend.cu): the score routine on tensor cores,
// shared by the scorer and the rescore so that ranking and attend see
// bit-identical numbers (the attend itself: chunk_attend.cuh).
//
// Layouts (token order, no fold): q [B, Hq, d] bf16; K and V
// [B, Hkv, S, d] int8 or bf16, or K packed int4 [B, Hkv, S, d/2] (Int4x2
// below) with V int8; per-row scales [B, Hkv, S] f32 (quantized only);
// scores [B, Hkv, G, S] f32; block ids [B, Hkv, NB'] int32. The head dim d
// is a template parameter kD, 16, 32, 64 or 128 (packed int4 K at 64 and
// 128 only, where the JAX package packs K).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace mp {

constexpr int kBlkThreads = 128;

// One byte of a packed int4 K row (ops/pack4.py): byte j of a token's d/2
// holds channel j in its low nibble and channel j + d/2 in its high one.
struct Int4x2 {
  int8_t bits;
};

// K selector of the C entry points: 0 bf16, 1 int8, 2 packed int4.
enum KeyKind : int { kKeyBf16 = 0, kKeyInt8 = 1, kKeyInt4 = 2 };

// ---- The score routine: 16 keys against the G heads on mma.sync.
//
// One m16n8k16 bf16 product a k-step, f32 sums: the 16 keys are the rows
// (A), the G queries the columns (B, zero columns up to 8), the kD
// channels kD / 16 k-steps, in kD / 64 passes of 64 channels. The channels
// are ordered so that one lane's 16 channels of a pass are contiguous in
// every K kind: lane (r = lane / 4, t = lane % 4) holds channels 64p + 16t
// .. 64p + 16t + 15 of keys r and r + 8 in pass p, "piece" 4p + t of the
// row, and k-step kk = 4p + j takes channels 64p + 16t + 4j + {0, 1} at k
// positions 2t, 2t + 1 and 64p + 16t + 4j + {2, 3} at 2t + 8, 2t + 9. So a
// lane reads one 16-byte unit of an int8 row a pass (two of bf16), and a
// packed int4 row's unit holds a piece's channels in one nibble: piece P
// lies in unit P % (kD / 32), low nibbles for P < kD / 32 (at d = 64
// lanes t < 2 take the low nibbles and t >= 2 the high ones of the same
// two units; at d = 128 pass 0 takes unit t's low nibbles and pass 1 its
// high ones). The packed form thus puts each 4-bit value in the register
// and k position that the int8 form puts it: the same products, summed in
// the same order. Each score depends on its own key row and query alone,
// so the scorer and the rescore, which tile the keys differently, agree
// bit for bit.

// Channels of the score routine's fragments: kD, or 64 for the head dims
// below it, whose rows the routine reads as 64 channels with the channels
// at and past kD zero (lanes t >= kD / 16 hold no channel): the products
// of zeros add exact zeros, so the scores are those of the kD channels.
__host__ __device__ constexpr int frag_dim(int kD) { return kD < 64 ? 64 : kD; }

// Bytes of one key row of kD channels.
template <typename KT, int kD>
__host__ __device__ constexpr int key_row_bytes() {
  return std::is_same<KT, Int4x2>::value ? kD / 2
                                         : kD * static_cast<int>(sizeof(KT));
}

// The B operand: q * sm_scale rounded to bf16 (as the TPU kernel rounds it
// before the dot), head n = lane / 4's channels of k-step kk in qb[kk]
// (zero for n >= gn, the block's heads, G for the exact instances, and for
// channels at or past kD).
template <int G, int kD>
__device__ __forceinline__ void load_q_frag(const __nv_bfloat16* q_h,
                                            float sm_scale, int lane,
                                            uint32_t (&qb)[frag_dim(kD) / 16][2],
                                            int gn = G) {
  const int n = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < frag_dim(kD) / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w = 0u;
      if (n < gn && 16 * t + 4 * (kk % 4) + 2 * h < kD) {
        const __nv_bfloat16* p =
            q_h + n * kD + 64 * (kk / 4) + 16 * t + 4 * (kk % 4) + 2 * h;
        w = pack_f32_as_bf16(__bfloat162float(p[0]) * sm_scale,
                             __bfloat162float(p[1]) * sm_scale);
      }
      qb[kk][h] = w;
    }
}

// The raw bytes of lane t's channels of one key row starting at `row`,
// kD / 32 units: bf16 units 8p + 2t and 8p + 2t + 1 of each pass p (XORed
// with `swz`, the scorer's shared-memory swizzle; 0 in device memory), the
// int8 unit 4p + t of each pass, or the packed int4 unit t % (kD / 32).
// Below d = 64 lane t reads its units only for t < kD / 16 (its 16
// channels lie in the row) and holds zeros otherwise.
template <int kD>
__device__ __forceinline__ void key_chunks(const uint8_t* row, int t, int swz,
                                           uint4 (&x)[frag_dim(kD) / 32],
                                           const __nv_bfloat16*) {
  const uint4* u = reinterpret_cast<const uint4*>(row);
  if constexpr (kD < 64) {
    const bool in = t < kD / 16;
    x[0] = in ? u[(2 * t) ^ swz] : make_uint4(0, 0, 0, 0);
    x[1] = in ? u[(2 * t + 1) ^ swz] : make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int p = 0; p < kD / 64; ++p) {
      x[2 * p] = u[(8 * p + 2 * t) ^ swz];
      x[2 * p + 1] = u[(8 * p + 2 * t + 1) ^ swz];
    }
  }
}
template <int kD>
__device__ __forceinline__ void key_chunks(const uint8_t* row, int t, int,
                                           uint4 (&x)[frag_dim(kD) / 32],
                                           const int8_t*) {
  if constexpr (kD < 64) {
    x[0] = t < kD / 16 ? reinterpret_cast<const uint4*>(row)[t]
                       : make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int p = 0; p < kD / 64; ++p)
      x[p] = reinterpret_cast<const uint4*>(row)[4 * p + t];
  }
}
template <int kD>
__device__ __forceinline__ void key_chunks(const uint8_t* row, int t, int,
                                           uint4 (&x)[frag_dim(kD) / 32],
                                           const Int4x2*) {
  static_assert(kD >= 64, "packed int4 K at head dims 64 and 128 only");
  x[0] = reinterpret_cast<const uint4*>(row)[t % (kD / 32)];
}

// Sixteen biased bytes (value + bias in 0..255) to eight bf16 pairs, in
// byte order: each byte placed in the mantissa of 2^23 gives 2^23 + byte
// exactly (one byte permute), minus 2^23 + bias (one add); integers this
// small are exact in bf16.
__device__ __forceinline__ void widen_biased(const uint32_t (&u)[4],
                                             float bias, uint32_t* w) {
  const float off = 8388608.f + bias;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float lo = __uint_as_float(__byte_perm(u[i], 0x4B000000u,
                                                   0x7540u | (2 * j))) - off;
      const float hi = __uint_as_float(__byte_perm(u[i], 0x4B000000u,
                                                   0x7540u | (2 * j + 1))) - off;
      w[2 * i + j] = pack_f32_as_bf16(lo, hi);
    }
}

// The A operand words of one key row from its raw bytes: word 8p + j holds
// channels 64p + 16t + 2j, 64p + 16t + 2j + 1.
template <int kD>
__device__ __forceinline__ void key_words(const uint4 (&x)[kD / 32], int,
                                          uint32_t (&w)[kD / 8],
                                          const __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < kD / 32; ++i) {
    w[4 * i] = x[i].x;
    w[4 * i + 1] = x[i].y;
    w[4 * i + 2] = x[i].z;
    w[4 * i + 3] = x[i].w;
  }
}
template <int kD>
__device__ __forceinline__ void key_words(const uint4 (&x)[kD / 32], int,
                                          uint32_t (&w)[kD / 8],
                                          const int8_t*) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    const uint32_t u[4] = {x[p].x ^ 0x80808080u, x[p].y ^ 0x80808080u,
                           x[p].z ^ 0x80808080u, x[p].w ^ 0x80808080u};
    widen_biased(u, 128.f, w + 8 * p);
  }
}
// Packed int4: piece 4p + t in the low nibbles below kD / 32, else the
// high ones; a two's-complement nibble XOR 8 is value + 8.
template <int kD>
__device__ __forceinline__ void key_words(const uint4 (&x)[kD / 32], int t,
                                          uint32_t (&w)[kD / 8],
                                          const Int4x2*) {
  const uint32_t v[4] = {x[0].x, x[0].y, x[0].z, x[0].w};
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    const int sh = (4 * p + t) >= kD / 32 ? 4 : 0;
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = ((v[i] >> sh) & 0x0F0F0F0Fu) ^ 0x08080808u;
    widen_biased(u, 8.f, w + 8 * p);
  }
}

// Scores of keys r and r + 8 (A words wa, wb) for heads 2t, 2t + 1:
// d[0], d[1] key r; d[2], d[3] key r + 8. Unscaled: the caller multiplies
// by the row's K scale (1 for bf16) with score_of.
template <int kD>
__device__ __forceinline__ void mma_scores(const uint32_t (&wa)[kD / 8],
                                           const uint32_t (&wb)[kD / 8],
                                           const uint32_t (&qb)[kD / 16][2],
                                           float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t a[4] = {wa[2 * kk], wb[2 * kk], wa[2 * kk + 1],
                           wb[2 * kk + 1]};
    mma_bf16_16816(d, a, qb[kk][0], qb[kk][1]);
  }
}

// The general tile's form of mma_scores: the same A words against the
// heads of kNT n8 tiles (1 or 2; qb[n] and d[n] as mma_scores's qb and d),
// the products of a k-step on the one pair of A words. Each column's sum
// is mma_scores's: the same words and k-steps in the same order, the head
// in the same column of its n8 tile.
template <int kD, int kNT>
__device__ __forceinline__ void mma_scores_tiles(
    const uint32_t (&wa)[kD / 8], const uint32_t (&wb)[kD / 8],
    const uint32_t (&qb)[2][kD / 16][2], float (&d)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t a[4] = {wa[2 * kk], wb[2 * kk], wa[2 * kk + 1],
                           wb[2 * kk + 1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      mma_bf16_16816(d[n], a, qb[n][kk][0], qb[n][kk][1]);
  }
}

// The B operands of the general tile's up to 16 heads: load_q_frag for
// heads 0-7 and 8-15 of the block (row q_h, `gn` of them; the second
// n8 tile zero when gn <= 8).
template <int kD>
__device__ __forceinline__ void load_q_tiles(
    const __nv_bfloat16* q_h, float sm_scale, int lane,
    uint32_t (&qb)[2][frag_dim(kD) / 16][2], int gn) {
  load_q_frag<8, kD>(q_h, sm_scale, lane, qb[0], gn);
  load_q_frag<8, kD>(q_h + 8 * kD, sm_scale, lane, qb[1], gn - 8);
}

__device__ __forceinline__ float score_of(float dot, float kscale) {
  return __fmul_rn(dot, kscale);
}

// Selected block `j` of (request b, kv head kh): its id, or -1 when the id
// lies outside [0, nb).
__device__ __forceinline__ int selected_block(const int* blk_ids, int b,
                                              int kh, int j, int hkv,
                                              int nsel, int nb) {
  const int id = blk_ids[(static_cast<size_t>(b) * hkv + kh) * nsel + j];
  return id >= 0 && id < nb ? id : -1;
}

}  // namespace mp
