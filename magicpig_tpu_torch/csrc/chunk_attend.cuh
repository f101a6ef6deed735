// The attend of the block_topk estimator over its selected blocks, shared
// by the rescore pipeline (rescore_attend.cu: the scores recomputed from K
// by the scorer's routine) and the store pipeline (block_attend.cu: the
// scores the scorer stored). One template, one flag: kStored reads each
// head's scores; otherwise the block scores its chunk itself. Everything
// after the scores is the same code, so the two pipelines agree bit for
// bit.
//
// Layouts as in block_common.cuh: q [B, Hq, d] bf16; K [B, Hkv, S, d]
// bf16 or int8, or packed int4 [B, Hkv, S, d/2]; V [B, Hkv, S, d] bf16 or
// int8; row scales [B, Hkv, S] f32 (quantized only); stored scores
// [B, Hkv, G, S] f32; block ids [B, Hkv, NB'] int32; d (kD) 16, 32, 64 or
// 128 (below 64 the scores take the scorer's zero-padded fragments, and
// P.V runs on d / 16 warps, one m-tile each). Group sizes: the exact
// instances (1, 2, 4 and 8 at d = 64 and 128, and 3 at 128), else the
// general tile (common.cuh, `Heads`: a block attends at most 8 query heads
// of its kv head; each sub-group takes its own chunks, partials, ticket
// and merge).
//
// Bound on the H100: reading the selected rows once (K, V and scales, or
// V and the G stored scores); ~4 flops per byte, so device memory bounds
// it. A block of 128 threads per (selected block, kv head, request), with
// the attend per thread over every row (P.V one f32 FMA per value, V tiles
// loaded between barriers, K read straight from device memory and a second
// launch for the merge), ran 6-8x that bound on the card: a chain of about
// twelve dependent round trips per block. This design: one block of 128
// threads per chunk (`chunk` tokens, a multiple of 64 up to 512) of one
// selected block of one (kv head, request), so the serve's 48 selected
// blocks give 192 blocks at 128 tokens:
//  - at block start one thread issues the chunk's bulk copies (K rows, V
//    rows and scales, or the G score rows; contiguous in the token-major
//    layout) under one mbarrier: only the rows below the length, so
//    nothing at or past it is read, and the scale tail past a multiple of
//    4 rows by plain loads; the query fragment is built meanwhile;
//  - the rescore scores the chunk's keys from shared memory with the
//    scorer's routine (block_common.cuh: mma.sync, 16 keys a step, int8 and
//    packed int4 widened to bf16 in registers), scores at or past the
//    length -inf;
//  - one softmax per head over the chunk (a warp a head, natural-log
//    units); p times the V scale, rounded to bf16 as the plain version and
//    the TPU kernel round the P.V operand, goes into a row of P in a
//    permuted order (below); the row sum takes p unrounded; a p of 0 is 0
//    whatever the V scale holds;
//  - P.V on mma.sync m16n8k16 with V^T as A (warp w: dims kD/4 w .. kD/4
//    (w + 1) - 1, one m-tile of 16 at d = 64, two at d = 128, both on the
//    same B fragment) and P^T as B (the G heads as columns): int8 V
//    widened to bf16 exactly
//    in registers, f32 sums. Rows that no head attends (past the length,
//    or all -inf) hold zeros in bf16 V, since a NaN there times p = 0 would
//    be NaN on the tensor cores; int8 values are always finite;
//  - each chunk writes its normalised partial and its lse; the last block
//    of the (request, kv head) to take a ticket (an acquire-release atomic,
//    common.cuh; tickets shared with flash_decode) merges the partials in
//    a fixed order and resets the ticket to 0: one launch a call, and a
//    result that does not depend on the schedule.
// A chunk whose block id lies outside [0, NB) or whose rows all lie at or
// past the length writes the empty partial (0, -inf); a row of empty
// partials merges to (0, -inf).
//
// The P.V k order: the 16 rows of a k-step are permuted so that lane
// (r = lane / 4, t = lane % 4) reads rows t, t + 4, t + 8, t + 12 (the
// four lanes of a column neighbouring rows in each load): mma k position
// 2t + e + 8h takes row t + 4e + 8h, and P is stored in that order so that
// B's words are single 32-bit loads.
#pragma once

#include <type_traits>

#include "block_common.cuh"
#include "hopper_common.cuh"

namespace mp {

constexpr int kMaxChunk = 512;        // tokens a block
constexpr int kChunkHeader = 128;     // mbarrier, flag, m, l, alpha
constexpr int kChunkSmemMax = 227 * 1024;
constexpr int kMergeBytes = 32 * 1024;  // the merge's batch of partials,
                                        // per 64 dims of a partial

// Partials the merge brings into shared memory at a time (each G rows of
// kD values and their lse): 31 at G = 4 at both head dims (42 at G = 3,
// d = 128), the batch's
// bytes growing with d, so that `chunk_plan` keeps at d = 128 the chunks
// phase 2 measured fastest (256 tokens at 11 of 128 blocks, not 512).
template <int G, int kD>
__host__ __device__ constexpr int merge_batch(int total) {
  return total < kMergeBytes * (frag_dim(kD) / 64) / (G * (kD + 1) * 4)
             ? total
             : kMergeBytes * (frag_dim(kD) / 64) / (G * (kD + 1) * 4);
}

// Arguments of one launch (null where the form has none). Partials
// [nsel * nchunk, B * Hq] (part_o with d values a row); tickets [B * Hkv *
// sub-groups], 0 between calls; group: query heads a kv head.
struct ChunkArgs {
  const __nv_bfloat16* q;
  const int* blk_ids;
  const void *k, *v;
  const float *k_scale, *v_scale, *scores;
  const int* length;
  float *part_o, *part_lse, *out, *lse;
  int* tickets;
  int batch, s_cap, hkv, group, nsel, block_size, chunk;
  float sm_scale;
};

// Byte offsets of a chunk's shared memory (after the header), each a
// multiple of 16: K rows, V rows, K and V scales, the G score rows, P.
struct ChunkSmem {
  int k, v, ks, vs, ps, pb, bytes;
};

// Row strides of the scores (floats) and of P (words: bf16 pairs), padded
// so that the heads' rows start in distinct banks and stay 16-byte aligned.
__host__ __device__ constexpr int s_stride(int chunk) { return chunk + 4; }
__host__ __device__ constexpr int p_stride(int chunk) { return chunk / 2 + 4; }

__host__ __device__ inline ChunkSmem chunk_smem(int chunk, int g, int krow,
                                                int vrow, bool kscale,
                                                bool vscale) {
  ChunkSmem o;
  int at = kChunkHeader;
  o.k = at;
  at += chunk * krow;
  o.v = at;
  at += chunk * vrow;
  o.ks = at;
  at += kscale ? chunk * 4 : 0;
  o.vs = at;
  at += vscale ? chunk * 4 : 0;
  o.ps = at;
  at += g * s_stride(chunk) * 4;
  o.pb = at;
  at += g * p_stride(chunk) * 4;
  o.bytes = at;
  return o;
}

// Position of chunk row i in P's permuted order.
__device__ __forceinline__ int p_pos(int i) {
  const int j = i & 15;
  return (i & ~15) + 2 * (j & 3) + ((j >> 2) & 1) + 8 * (j >> 3);
}

// The A operand of one P.V k-step: V^T rows dim and dim + 1 (a lane's m
// and m + 8) over chunk rows k0 + t + {0, 4, 8, 12} of kD values, as bf16
// pairs.
template <int kD>
__device__ __forceinline__ void v_frag(const uint8_t* v_s, int k0, int t,
                                       int dim, uint32_t (&a)[4],
                                       const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(
        v_s + (k0 + t + 4 * i) * kD * 2 + dim * 2);
  a[0] = __byte_perm(w[0], w[1], 0x5410);
  a[1] = __byte_perm(w[0], w[1], 0x7632);
  a[2] = __byte_perm(w[2], w[3], 0x5410);
  a[3] = __byte_perm(w[2], w[3], 0x7632);
}
template <int kD>
__device__ __forceinline__ void v_frag(const uint8_t* v_s, int k0, int t,
                                       int dim, uint32_t (&a)[4],
                                       const int8_t*) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = *reinterpret_cast<const uint16_t*>(v_s + (k0 + t + 4 * i) * kD +
                                              dim);
  // Bytes (row, dim), (row, dim + 1) of two rows, biased to 0..255.
  const uint32_t u[2] = {__byte_perm(h[0], h[1], 0x5410) ^ 0x80808080u,
                         __byte_perm(h[2], h[3], 0x5410) ^ 0x80808080u};
  constexpr float kOff = 8388608.f + 128.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7540u | j)) - kOff;
    a[2 * i] = pack_f32_as_bf16(x[0], x[2]);
    a[2 * i + 1] = pack_f32_as_bf16(x[1], x[3]);
  }
}

// KT: the K type (unused when kStored); VT: __nv_bfloat16, or int8_t with
// the row scales; kD: the head dim, 16, 32, 64 or 128; kPart: the general
// tile (mp::Heads).
template <int G, typename KT, typename VT, bool kStored, int kD,
          bool kPart = false>
__device__ __forceinline__ void chunk_attend(const ChunkArgs& a) {
  constexpr bool kKQ = !kStored && !std::is_same<KT, __nv_bfloat16>::value;
  constexpr bool kVQ = std::is_same<VT, int8_t>::value;
  constexpr int kKRow = kStored ? 0 : key_row_bytes<KT, kD>();
  constexpr int kVRow = kD * static_cast<int>(sizeof(VT));
  constexpr int kDP = frag_dim(kD);
  constexpr int kMT = kD < 64 ? 1 : kD / 64;   // P.V m-tiles of 16 dims a warp
  constexpr int kWarps = kBlkThreads / 32;
  constexpr int kPVWarps = kD / (16 * kMT);    // warps of the P.V
  extern __shared__ __align__(128) uint8_t chunk_smem_buf[];
  uint8_t* sm = chunk_smem_buf;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  int* is_last = reinterpret_cast<int*>(sm + 8);
  float* m_s = reinterpret_cast<float*>(sm + 16);   // 8 floats each: m, l,
  float* l_s = m_s + 8;                             // then the merge's alpha

  const int C = a.chunk;
  const ChunkSmem o = chunk_smem(C, G, kKRow, kVRow, kKQ, kVQ);
  const int nch = (a.block_size + C - 1) / C;
  const int part = blockIdx.x, j = part / nch, c = part % nch;
  const int b = blockIdx.z;
  const Heads<G, kPart> hd(blockIdx.y, a.group);
  const int kh = hd.kh, gn = hd.gn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool pv_warp = kPVWarps == kWarps || warp < kPVWarps;
  const int r = lane >> 2, t = lane & 3;
  const int hq = a.hkv * hd.group;
  const size_t head = static_cast<size_t>(b) * a.hkv + kh;
  const size_t row0 = hd.row(b, a.hkv);
  const size_t stride = static_cast<size_t>(a.batch) * hq;
  const size_t prow = part * stride + row0;
  const int id = selected_block(a.blk_ids, b, kh, j, a.hkv, a.nsel,
                                a.s_cap / a.block_size);
  const int t0 = id * a.block_size + c * C;
  int n = min(C, a.block_size - c * C);
  if constexpr (!kStored) n = min(n, min(a.length[b], a.s_cap) - t0);
  if (id < 0) n = 0;

  if (n <= 0) {
    for (int i = tid; i < gn * kD; i += kBlkThreads)
      a.part_o[prow * kD + i] = 0.f;
    if (tid < gn) a.part_lse[prow + tid] = kNegInf;
  } else {
    uint8_t* k_s = sm + o.k;
    uint8_t* v_s = sm + o.v;
    float* ks_s = reinterpret_cast<float*>(sm + o.ks);
    float* vs_s = reinterpret_cast<float*>(sm + o.vs);
    float* ps = reinterpret_cast<float*>(sm + o.ps);
    uint32_t* pb = reinterpret_cast<uint32_t*>(sm + o.pb);
    const int sst = s_stride(C), pst = p_stride(C);
    const size_t tok0 = head * a.s_cap + t0;
    const int n4 = n & ~3;
    // One round trip: every copy of the chunk leaves before anything else.
    if (tid == 0) {
      hp::mbar_init(bar, 1);
      hp::fence_barrier_init();
      uint32_t bytes = n * kVRow + (kVQ ? n4 * 4 : 0);
      bytes += kStored ? gn * n * 4 : n * kKRow + (kKQ ? n4 * 4 : 0);
      hp::mbar_arrive_expect_tx(bar, bytes);
      hp::bulk_load(v_s, static_cast<const uint8_t*>(a.v) + tok0 * kVRow,
                    n * kVRow, bar);
      if (kVQ && n4 > 0) hp::bulk_load(vs_s, a.v_scale + tok0, n4 * 4, bar);
      if constexpr (kStored) {
        const float* sc = a.scores + (head * hd.group + hd.g0) * a.s_cap + t0;
        for (int g = 0; g < gn; ++g)
          hp::bulk_load(ps + g * sst, sc + static_cast<size_t>(g) * a.s_cap,
                        n * 4, bar);
      } else {
        hp::bulk_load(k_s, static_cast<const uint8_t*>(a.k) + tok0 * kKRow,
                      n * kKRow, bar);
        if (kKQ && n4 > 0) hp::bulk_load(ks_s, a.k_scale + tok0, n4 * 4, bar);
      }
    }
    if (tid < n - n4) {
      if (kKQ) ks_s[n4 + tid] = a.k_scale[tok0 + n4 + tid];
      if (kVQ) vs_s[n4 + tid] = a.v_scale[tok0 + n4 + tid];
    }
    uint32_t qb[kDP / 16][2];
    if constexpr (!kStored)
      load_q_frag<G, kD>(a.q + row0 * kD, a.sm_scale, lane, qb, gn);
    __syncthreads();                      // the barrier's init, the tails
    hp::mbar_wait(bar, 0);

    // ---- scores of the chunk's keys, 16 a warp at a time.
    const int n16 = (n + 15) & ~15;
    if constexpr (!kStored) {
#pragma unroll 2
      for (int m0 = 16 * warp; m0 < n; m0 += 16 * kWarps) {
        uint4 xa[kDP / 32], xb[kDP / 32];
        key_chunks<kD>(k_s + (m0 + r) * kKRow, t, 0, xa,
                       static_cast<const KT*>(nullptr));
        key_chunks<kD>(k_s + (m0 + r + 8) * kKRow, t, 0, xb,
                       static_cast<const KT*>(nullptr));
        uint32_t wa[kDP / 8], wb[kDP / 8];
        key_words<kDP>(xa, t, wa, static_cast<const KT*>(nullptr));
        key_words<kDP>(xb, t, wb, static_cast<const KT*>(nullptr));
        float d[4];
        mma_scores<kDP>(wa, wb, qb, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = 2 * t + (i & 1), key = m0 + r + 8 * (i >> 1);
          if (h < gn)
            ps[h * sst + key] =
                key < n ? score_of(d[i], kKQ ? ks_s[key] : 1.f) : kNegInf;
        }
      }
      __syncthreads();
    }

    // ---- one softmax per head; P in bf16, permuted, zero past n.
    for (int g = warp; g < gn; g += kWarps) {
      const float* s = ps + g * sst;
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s[i]);
      mx = warp_max(mx);
      const float mu = mx == kNegInf ? 0.f : mx;
      float sum = 0.f;
      __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(pb + g * pst);
      for (int i = lane; i < n16; i += 32) {
        float pv = 0.f;
        if (i < n) {
          const float p = expf(s[i] - mu);
          sum += p;
          pv = kVQ ? (p == 0.f ? 0.f : p * vs_s[i]) : p;
        }
        prow[p_pos(i)] = __float2bfloat16_rn(pv);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = mx;
        l_s[g] = sum;
      }
    }
    if constexpr (!kVQ) {
      // bf16 V: rows that no head attends hold zeros.
      for (int i = tid; i < n16; i += kBlkThreads) {
        bool dead = i >= n;
        if (!dead) {
          dead = true;
#pragma unroll
          for (int g = 0; g < G; ++g)
            dead = dead && (g >= gn || ps[g * sst + i] == kNegInf);
        }
        if (dead)
#pragma unroll
          for (int u = 0; u < kVRow / 16; ++u)
            reinterpret_cast<uint4*>(v_s + i * kVRow)[u] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();

    // ---- P.V: D^T[dim, head] over the chunk's rows, 16 a k-step, the
    // even and odd k-steps in two sums (two chains of products); m-tile mt
    // of warp w holds dims 16 (kMT w + mt) .. + 15.
    float d[kMT][2][4] = {};
    const auto pv_step = [&](int k0, int e) {
      uint32_t b0 = 0u, b1 = 0u;
      if (r < gn) {
        b0 = pb[r * pst + k0 / 2 + t];
        b1 = pb[r * pst + k0 / 2 + 4 + t];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t af[4];
        v_frag<kD>(v_s, k0, t, 16 * (kMT * warp + mt) + 2 * r, af,
                   static_cast<const VT*>(nullptr));
        mma_bf16_16816(d[mt][e], af, b0, b1);
      }
    };
    for (int k0 = 0; pv_warp && k0 < n16; k0 += 32) {
      pv_step(k0, 0);
      if (k0 + 16 < n16) pv_step(k0 + 16, 1);
    }
    // d0, d2: head 2t at dims dim, dim + 1; d1, d3: head 2t + 1.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int dim = 16 * (kMT * warp + mt) + 2 * r;
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][0][i] += d[mt][1][i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = 2 * t + e;
        if (h < gn && pv_warp) {
          const float l = l_s[h];
          *reinterpret_cast<float2*>(a.part_o + (prow + h) * kD + dim) =
              l > 0.f ? make_float2(d[mt][0][e] / l, d[mt][0][e + 2] / l)
                      : make_float2(0.f, 0.f);
        }
      }
    }
    if (tid < gn)
      a.part_lse[prow + tid] =
          l_s[tid] > 0.f ? m_s[tid] + logf(l_s[tid]) : kNegInf;
  }

  // ---- the last chunk of this (request, kv head) to finish merges all.
  __syncthreads();
  if (tid == 0) *is_last = take_ticket(&a.tickets[hd.slot(b, a.hkv)], gridDim.x);
  __syncthreads();
  if (!*is_last) return;
  // The partials come into shared memory in batches (merge_batch), one
  // round trip each: a warp a head takes the batch's max lse and weights
  // each partial by exp(lse - max) once (an empty partial: weight 0); each
  // output value then sums its weighted partials in partial order, and the
  // running sums rescale from batch to batch.
  const int total = gridDim.x, cap = merge_batch<G, kD>(total);
  float* o_st = reinterpret_cast<float*>(sm + kChunkHeader);
  float* w_st = o_st + cap * G * kD;                // lse, then weights
  float* alpha = l_s + 8;
  constexpr int kAcc = (G * kD + kBlkThreads - 1) / kBlkThreads;
  float num[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) num[i] = 0.f;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int p0 = 0; p0 < total; p0 += cap) {
    const int nb = min(cap, total - p0);
    for (int i = tid; i < nb * gn * (kD / 4); i += kBlkThreads) {
      const int p = i / (gn * kD / 4), u = i % (gn * kD / 4);
      hp::cp_async_16(o_st + p * G * kD + 4 * u,
                      a.part_o + ((p0 + p) * stride + row0) * kD + 4 * u);
    }
    // (Read past L1, which may hold stale lines of other blocks' rows.)
    for (int i = tid; i < nb * G; i += kBlkThreads)
      if (i % G < gn)
        w_st[i] = __ldcg(a.part_lse + (p0 + i / G) * stride + row0 + i % G);
    hp::cp_async_commit();
    hp::cp_async_wait<0>();
    __syncthreads();
    for (int g = warp; g < gn; g += kWarps) {
      float mx = kNegInf;
      for (int p = lane; p < nb; p += 32) mx = fmaxf(mx, w_st[p * G + g]);
      mx = fmaxf(warp_max(mx), m_s[g]);
      const float mu = mx == kNegInf ? 0.f : mx;
      float sum = 0.f;
      for (int p = lane; p < nb; p += 32) {
        const float w = expf(w_st[p * G + g] - mu);
        w_st[p * G + g] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float keep = expf(m_s[g] - mu);
        alpha[g] = keep;
        l_s[g] = l_s[g] * keep + sum;
        m_s[g] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kBlkThreads;
      if (idx < gn * kD) {
        const int g = idx / kD;
        float x = num[i] * alpha[g];
#pragma unroll 8
        for (int p = 0; p < nb; ++p)
          x = fmaf(w_st[p * G + g], o_st[p * G * kD + idx], x);
        num[i] = x;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kBlkThreads;
    if (idx < gn * kD) {
      const float l = l_s[idx / kD];
      a.out[row0 * kD + idx] = l > 0.f ? num[i] / l : 0.f;
    }
  }
  if (tid < gn)
    a.lse[row0 + tid] = l_s[tid] > 0.f ? m_s[tid] + logf(l_s[tid]) : kNegInf;
}

// Host: check the launch's shared memory (a chunk's rows and scores, or
// the merge's batch, whichever is larger) and launch `kernel` (a
// __global__ taking ChunkArgs) on grid (nsel * chunks a block, Hkv, B).
// Returns a cudaError_t: cudaErrorInvalidValue where a chunk's rows do
// not fit a block (bf16 K and V at d = 128 above 256 tokens).
template <int G, typename KT, typename VT, bool kStored, int kD,
          bool kPart, typename Kernel>
int launch_chunk_attend(Kernel* kernel, const ChunkArgs& a, unsigned& smem_set,
                        cudaStream_t stream) {
  constexpr bool kKQ = !kStored && !std::is_same<KT, __nv_bfloat16>::value;
  constexpr bool kVQ = std::is_same<VT, int8_t>::value;
  const ChunkSmem o = chunk_smem(a.chunk, G,
                                 kStored ? 0 : key_row_bytes<KT, kD>(),
                                 kD * static_cast<int>(sizeof(VT)), kKQ, kVQ);
  const int nch = (a.block_size + a.chunk - 1) / a.chunk;
  const int total = a.nsel * nch;
  const int merge =
      kChunkHeader + merge_batch<G, kD>(total) * G * (kD + 1) * 4;
  const int smem = o.bytes > merge ? o.bytes : merge;
  if (smem > kChunkSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = hp::allow_smem(kernel, kChunkSmemMax, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(total, a.hkv * (kPart ? group_blocks(a.group, G) : 1), a.batch);
  kernel<<<grid, kBlkThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The sizes every form needs: d = 16, 32, 64 or 128, hq a multiple of
// hkv, block_size a multiple of 64 dividing s_cap, chunk a multiple of 64
// up to 512.
// The general tile of both attends (chunk_attend_part.cu): k_kind a KeyKind
// (packed int4 at d = 64 and 128), or V int8 / bf16 for the stored scores.
int rescore_attend_part(int k_kind, int head_dim, const ChunkArgs& a,
                        cudaStream_t st);
int block_attend_part(bool v_int8, int head_dim, const ChunkArgs& a,
                      cudaStream_t st);

inline bool chunk_args_ok(const ChunkArgs& a, int hq, int head_dim) {
  const int g = a.hkv > 0 ? hq / a.hkv : 0;
  return head_dim_ok(head_dim) && g >= 1 && g * a.hkv == hq && a.nsel > 0 &&
         a.block_size > 0 && a.block_size % 64 == 0 &&
         a.s_cap % a.block_size == 0 && a.chunk >= 64 &&
         a.chunk <= kMaxChunk && a.chunk % 64 == 0 && a.tickets != nullptr;
}

}  // namespace mp
