// Building blocks of the block_topk kernels (block_score.cu,
// rescore_attend.cu, block_attend.cu): the G scores of one token, shared by
// the scorer and the rescore so that ranking and attend see bit-identical
// numbers, and the softmax-and-attend over one selected block.
//
// Layouts (token order, no fold): q [B, Hq, 64] bf16; K and V
// [B, Hkv, S, 64] int8 or bf16, or K packed int4 [B, Hkv, S, 32] (Int4x2
// below) with V int8; per-row scales [B, Hkv, S] f32 (quantized only);
// scores [B, Hkv, G, S] f32; block ids [B, Hkv, NB'] int32.
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kBlkD = 64;              // head dim
constexpr int kBlkThreads = 128;
constexpr int kBlkTile = 64;           // V tokens per shared-memory tile
constexpr int kMaxBlockScores = 8192;  // G * block_size floats per block

// The G query heads of one kv head, times sm_scale and rounded to bf16 (as
// the TPU kernels do before the dot), kept as f32.
template <int G>
__device__ __forceinline__ void load_scaled_q(float (*qs)[kBlkD],
                                              const __nv_bfloat16* q_h,
                                              float sm_scale, int tid) {
  for (int i = tid; i < G * kBlkD; i += kBlkThreads)
    qs[i / kBlkD][i % kBlkD] = __bfloat162float(
        __float2bfloat16_rn(__bfloat162float(q_h[i]) * sm_scale));
}

// One byte of a packed int4 K row (ops/pack4.py): byte j of a token's 32
// holds channel j in its low nibble and channel j + 32 in its high one.
struct Int4x2 {
  int8_t bits;
};

// K elements of one token's row: 64, or 32 packed bytes.
template <typename KT>
struct KeyRow {
  static constexpr int kElems = kBlkD;
};
template <>
struct KeyRow<Int4x2> {
  static constexpr int kElems = kBlkD / 2;
};

// K selector of the C entry points: 0 bf16, 1 int8, 2 packed int4.
enum KeyKind : int { kKeyBf16 = 0, kKeyInt8 = 1, kKeyInt4 = 2 };

__device__ __forceinline__ float key_value(const int8_t* row, int e) {
  return static_cast<float>(row[e]);
}
__device__ __forceinline__ float key_value(const __nv_bfloat16* row, int e) {
  return __bfloat162float(row[e]);
}

// One 16-byte chunk of a key row as f32 values: 16 int8 or 8 bf16.
__device__ __forceinline__ void chunk_values(const uint4& w, float* out,
                                             const int8_t*) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          static_cast<float>(static_cast<int8_t>(words[i] >> (8 * j)));
}
__device__ __forceinline__ void chunk_values(const uint4& w, float* out,
                                             const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The G scores of one token: sum over e = 0..63, in that order, of
// qs[g][e] * k[e] in f32 (fmaf), times the row's scale. Both the scorer
// and the rescore call this, so ranking and attend agree bit for bit.
template <int G, typename KT>
__device__ __forceinline__ void token_scores(const KT* __restrict__ krow,
                                             float kscale,
                                             const float (*qs)[kBlkD],
                                             float (&s)[G]) {
  constexpr int kPerChunk = 16 / sizeof(KT);
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  const uint4* src = reinterpret_cast<const uint4*>(krow);
#pragma unroll
  for (int c = 0; c < kBlkD / kPerChunk; ++c) {
    float kv[kPerChunk];
    chunk_values(__ldg(src + c), kv, krow);
#pragma unroll
    for (int j = 0; j < kPerChunk; ++j)
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = fmaf(qs[g][c * kPerChunk + j], kv[j], acc[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = acc[g] * kscale;
}

// The packed int4 form: the row's 32 bytes in two 16-byte loads, each
// nibble sign-extended by shifts of its 32-bit word (low nibble of byte b:
// (int)(w << (28 - 8b)) >> 28; high: (int)(w << (24 - 8b)) >> 28), and the
// same fmaf over e = 0..63 in the same order as the int8 form, so the two
// give bit-identical scores for the same 4-bit values.
template <int G>
__device__ __forceinline__ void token_scores(const Int4x2* __restrict__ krow,
                                             float kscale,
                                             const float (*qs)[kBlkD],
                                             float (&s)[G]) {
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  const uint4* src = reinterpret_cast<const uint4*>(krow);
  const uint4 w0 = __ldg(src), w1 = __ldg(src + 1);
  const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int h = 0; h < 2; ++h)              // low nibbles e < 32, then high
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int shift = (h == 0 ? 28 : 24) - 8 * b;
        const float kv =
            static_cast<float>(static_cast<int>(words[i] << shift) >> 28);
        const int e = h * (kBlkD / 2) + 4 * i + b;
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(qs[g][e], kv, acc[g]);
      }
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = acc[g] * kscale;
}

template <typename VT>
struct VTile;
template <>
struct VTile<int8_t> {
  static constexpr int kPad = kBlkD + 16;   // row stride in bytes
  int8_t v[kBlkTile][kPad];
};
template <>
struct VTile<__nv_bfloat16> {
  static constexpr int kPad = kBlkD + 8;    // row stride in elements
  __nv_bfloat16 v[kBlkTile][kPad];
};

template <int G, typename VT>
struct __align__(16) BlockAttendSmem {
  float ps[kMaxBlockScores];   // [G][block_size]: scores, then p (x V scale)
  VTile<VT> vt;
  float qs[G][kBlkD];
  float m[G];
  float l[G];
};

__device__ __forceinline__ void write_empty_block(float* part_o,
                                                  float* part_lse,
                                                  size_t row0, int g_count,
                                                  int tid) {
  for (int i = tid; i < g_count * kBlkD; i += kBlkThreads)
    part_o[row0 * kBlkD + i] = 0.f;
  if (tid < g_count) part_lse[row0 + tid] = kNegInf;
}

// Softmax over the scores sm.ps[g][0..n) of one selected block (natural-log
// units, -inf masked) and the weighted sum of its n V rows from v_blk
// ([n, 64], scales vs_blk or null). Writes the normalised partial
// part_o[row0 + g] and its lse part_lse[row0 + g]; a head with no finite
// score writes (0, -inf). The V scale multiplies p, not V.
template <int G, typename VT>
__device__ __forceinline__ void attend_block(
    BlockAttendSmem<G, VT>& sm, int bs, int n, const VT* __restrict__ v_blk,
    const float* __restrict__ vs_blk, float* __restrict__ part_o,
    float* __restrict__ part_lse, size_t row0, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kBlkThreads / 32;
  for (int g = warp; g < G; g += kWarps) {
    float* s = sm.ps + g * bs;
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s[i]);
    mx = warp_max(mx);
    const float mu = mx == kNegInf ? 0.f : mx;
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(s[i] - mu);
      sum += p;
      s[i] = vs_blk != nullptr ? p * vs_blk[i] : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm.m[g] = mx;
      sm.l[g] = sum;
    }
  }
  __syncthreads();

  constexpr int kAcc = (G * kBlkD + kBlkThreads - 1) / kBlkThreads;
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  constexpr int kPerChunk = 16 / sizeof(VT);
  for (int t0 = 0; t0 < n; t0 += kBlkTile) {
    const int rows = min(kBlkTile, n - t0);
    for (int c = tid; c < kBlkTile * (kBlkD / kPerChunk); c += kBlkThreads) {
      const int row = c / (kBlkD / kPerChunk);
      const int col = (c % (kBlkD / kPerChunk)) * kPerChunk;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row < rows)
        x = __ldg(reinterpret_cast<const uint4*>(
            v_blk + static_cast<size_t>(t0 + row) * kBlkD + col));
      *reinterpret_cast<uint4*>(&sm.vt.v[row][col]) = x;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kBlkThreads;
      if (idx < G * kBlkD) {
        const int g = idx / kBlkD, d = idx % kBlkD;
        const float* p = sm.ps + g * bs + t0;
        float a = acc[r];
        for (int j = 0; j < rows; ++j)
          a = fmaf(p[j], key_value(&sm.vt.v[j][0], d), a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = tid + r * kBlkThreads;
    if (idx < G * kBlkD) {
      const float l = sm.l[idx / kBlkD];
      part_o[row0 * kBlkD + idx] = l > 0.f ? acc[r] / l : 0.f;
    }
  }
  if (tid < G)
    part_lse[row0 + tid] =
        sm.l[tid] > 0.f ? sm.m[tid] + logf(sm.l[tid]) : kNegInf;
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
