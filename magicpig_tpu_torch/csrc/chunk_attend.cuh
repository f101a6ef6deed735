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
// 128 (below 64 the scores take the scorer's zero-padded fragments). Group
// sizes: the exact instances (1, 2, 4 and 8 at d = 64 and 128, and 3 at
// 128: `chunk_attend`, designed below), else the general tile
// (`chunk_attend_tile`, designed where it is defined: a block attends up
// to 16 query heads of its kv head over several stages of its selected
// blocks).
//
// Bound on the H100: reading the selected rows once (K, V and scales, or
// V and the G stored scores); ~4 flops per byte, so device memory bounds
// it. A block of 128 threads per (selected block, kv head, request), with
// the attend per thread over every row (P.V one f32 FMA per value, V tiles
// loaded between barriers, K read straight from device memory and a second
// launch for the merge), ran 6-8x that bound on the card: a chain of about
// twelve dependent round trips per block. The exact instances' design: one
// block of 128 threads per chunk (`chunk` tokens, a multiple of 64 up to
// 512) of one selected block of one (kv head, request), so the serve's 48
// selected blocks give 192 blocks at 128 tokens:
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
// the row scales; kD: the head dim, 64 or 128 (the exact instances).
template <int G, typename KT, typename VT, bool kStored, int kD>
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
  const Heads<G, false> hd(blockIdx.y, a.group);
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
          typename Kernel>
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
  dim3 grid(total, a.hkv, a.batch);
  kernel<<<grid, kBlkThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- The general tile (chunk_attend_part.cu): up to kHeadTile query
// heads of one kv head a block, so that for every group of up to 16 heads
// the selected rows' K, V and scales (or V and the stored scores) are read
// once. A (request, kv head, block of heads) takes its selected blocks as
// one list of 64-token units (block after block, in the order of the ids),
// cut into `chunk` tokens a CUDA block (`tile_plan` in
// ops/kernels/block_attend.py: about one block per SM over the grid, whole
// fills); the ids of a block's selected blocks are read once into shared
// memory. Each CUDA block:
//  - one copy warp: its first lane brings each fill, up to four units of
//    one selected block (256 rows), its rows below the length (K and V
//    rows, or V rows and the block's stored score rows) and the row scales
//    of its whole multiples of 4 rows, by one cp.async.bulk each into a
//    slot of a ring of 1 to 4 (`AttRing`, at most 200 KB) under full and
//    empty mbarriers; a fill with no such row (an id outside [0, NB), or
//    wholly past the length) is skipped by every warp alike. An SM's bulk
//    copies arrived about 0.44 us apart whatever their size (8 or 16 KB),
//    so a copy of 64 rows at a time left the compute waiting: a fill
//    copies four times the rows a copy;
//  - four compute warps, warp u taking unit u of every fill (64 rows, its
//    wait and release once a unit), no block barrier per fill, each unit's
//    four row tiles of 16 in two loops that are not unrolled (one or two
//    n8 tiles of heads compiled in): a serve's layer finds the kernel's
//    code out of L2 after its weight GEMMs, and with the four row tiles
//    unrolled the fetch of the instructions added ~11 us to a launch at
//    G = 16, d = 128 (PERF.md, Findings). The first loop: the scores,
//    into the lane's own words of shared memory (`unit_sc`), by the
//    scorer's routine (block_common.cuh: the query fragments of the
//    block's heads loaded once, each key pair's A words widened once, one
//    mma.sync a k-step for each n8 tile of heads), or the stored ones from
//    shared memory, in the accumulator layout (keys on rows, heads on
//    columns), and their max; the second: an online softmax per head in
//    log2 units against the unit's max (shuffles; the row sum per lane;
//    ex2.approx; a max that moved every row tile rounded p unlike the
//    plain version in more rows, and one form left its tolerance), p times
//    the V scale rounded to bf16 (a p of 0 is 0 whatever the scale), moved
//    by shuffles into the B operand of P.V (P^T, heads on N, the k order of
//    `p_pos`); P.V with each V^T A fragment (`v_frag`, int8 widened
//    exactly) loaded once a k-step for every n8 tile of heads; bf16 V rows
//    that no head of the block attends zeroed in the fragment (NaN x 0 is
//    NaN on the tensor cores); the warps' lanes release the slot after
//    their reads behind a proxy fence;
//  - the four warps' states meet once in shared memory (over the ring),
//    each head's max and sum once, the values in warp order; a block that
//    is its (request, kv head, block of heads)'s only one writes out and
//    lse, else its normalised partial and lse, and the last block to take
//    the ticket merges the partials in order (an empty partial weighs
//    nothing; all empty: (0, -inf)) and resets the ticket; it brings them
//    into shared memory a batch at a time, every copy of a batch in flight
//    at once (a walk over them from device memory, one round trip a
//    partial, cost more than the fills).
// Globaltimer probes of builds not kept (PERF.md, Findings) put a block's
// time at G = 16, d = 128 in its chain: ~0.5 us of set-up, ~4-5 us to its
// first copy in, ~3-4 us of compute a warp's unit (row tiles unrolled),
// ~2 us to meet the warps' states, ~0.7 us for the ticket and ~4 us of
// merge; more warps (two blocks an SM, or eight compute warps) and fewer
// dependent loads did not shorten it.
// The rescore and the stored-score attend differ only in where the scores
// come from: with the same split they agree bit for bit (rows past the
// length arrive as -inf from the scorer and add exact zeros).
constexpr int kAttWarps = 4;                       // compute warps
constexpr int kAttThreads = (kAttWarps + 1) * 32;  // and a copy warp
constexpr int kAttRT = 4;                          // row tiles of 16 a unit
constexpr int kAttTile = 16 * kAttRT;              // tokens a unit (stage
                                                   // of the split plan)
constexpr int kAttFill = kAttWarps * kAttTile;     // tokens a fill at most
constexpr int kScoreStride = kAttFill + 4;         // a stored score row
                                                   // (floats; distinct banks)
constexpr int kAttRingBytes = 200 * 1024;          // the ring at most
constexpr int kUnitScores = kAttRT * 2 * 4 * 32;   // a warp's unit scores
constexpr int kAttMaxIds = 1024;                   // selected blocks a block

// A slot of the ring holds one fill: up to kAttFill rows of one selected
// block, warp w's unit of 64 at 64 w. Slots: up to 4, as many as
// kAttRingBytes holds, at least 1 (bf16 K and V at d = 128: 1).
template <typename KT, typename VT, bool kStored, int kD>
struct AttRing {
  static constexpr bool kKQ =
      !kStored && !std::is_same<KT, __nv_bfloat16>::value;
  static constexpr bool kVQ = std::is_same<VT, int8_t>::value;
  static constexpr int kKRow = kStored ? 0 : key_row_bytes<KT, kD>();
  static constexpr int kVRow = kD * static_cast<int>(sizeof(VT));
  static constexpr int kV = kAttFill * kKRow;                // V rows
  static constexpr int kKS = kV + kAttFill * kVRow;          // K scales
  static constexpr int kVS = kKS + (kKQ ? kAttFill * 4 : 0); // V scales
  static constexpr int kS = kVS + (kVQ ? kAttFill * 4 : 0);  // stored scores
  static constexpr int kBytes =
      kS + (kStored ? kHeadTile * kScoreStride * 4 : 0);
  static constexpr int kFit = kAttRingBytes / kBytes;
  static constexpr int kStages = kFit < 1 ? 1 : (kFit < 4 ? kFit : 4);
  static constexpr int kRed = kAttWarps * kHeadTile * kD * 4;  // over the ring
  static constexpr int kSmem =
      kStages * kBytes > kRed ? kStages * kBytes : kRed;  // then the ids
  static_assert(kS % 16 == 0 &&
                    kSmem + 4 * kAttMaxIds + 4 * kAttWarps * kUnitScores +
                            2048 <= kChunkSmemMax,
                "slots of whole 16-byte units in a block's shared memory");
};

template <typename KT, typename VT, bool kStored, int kD>
__device__ __forceinline__ void chunk_attend_tile(const ChunkArgs& a) {
  using R = AttRing<KT, VT, kStored, kD>;
  constexpr bool kKQ = R::kKQ, kVQ = R::kVQ;
  constexpr int kDP = frag_dim(kD);
  constexpr int kMT = kD / 16;                     // P.V m-tiles of 16 dims
  extern __shared__ __align__(128) uint8_t chunk_smem_buf[];
  uint8_t* sm = chunk_smem_buf;
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  __shared__ float red_m[kAttWarps][kHeadTile], red_l[kAttWarps][kHeadTile];
  __shared__ float red_L[kHeadTile], red_M[kHeadTile];
  __shared__ float unit_sc[kAttWarps][kUnitScores];
  __shared__ int is_last;

  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.z;
  const Heads<kHeadTile, true> hd(blockIdx.y, a.group);
  const int kh = hd.kh, gn = hd.gn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = a.s_cap / a.block_size, tpb = a.block_size / kAttTile;
  const int i0 = split * (a.chunk / kAttTile);
  const int i1 = min(i0 + a.chunk / kAttTile, a.nsel * tpb);
  const int len = kStored ? 0 : min(a.length[b], a.s_cap);
  const size_t head = static_cast<size_t>(b) * a.hkv + kh;
  const size_t row0 = hd.row(b, a.hkv);
  const size_t stride = static_cast<size_t>(a.batch) * a.hkv * hd.group;
  // The ids of the selected blocks the block's units lie in, read once into
  // shared memory after the ring (the loops look them up at every fill).
  int* ids = reinterpret_cast<int*>(sm + R::kSmem);
  const int j0 = i0 / tpb;
  for (int x = tid; j0 + x <= (i1 - 1) / tpb; x += kAttThreads)
    ids[x] = selected_block(a.blk_ids, b, kh, j0 + x, a.hkv, a.nsel, nb);
  // The fill that starts at unit i: units [i, e) of one selected block
  // (at most kAttWarps, never past a multiple of kAttWarps within the
  // block or past i1); its rows that are read (<= 0: none), its first
  // token in tok0.
  const auto fill_of = [&](int i, int& tok0, int& next) {
    const int blk0 = i - i % tpb;
    next = min(min(i1, blk0 + tpb),
               blk0 + ((i - blk0) / kAttWarps + 1) * kAttWarps);
    const int id = ids[i / tpb - j0];
    tok0 = id * a.block_size + (i % tpb) * kAttTile;
    if (id < 0) return 0;
    const int rows = (next - i) * kAttTile;
    return kStored ? rows : min(rows, len - tok0);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < R::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kAttWarps * 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  float m[2][2], l[2][2], acc[kMT][2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = kNegInf;
      l[nt][e] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int r = lane >> 2, t = lane & 3;

  if (warp == kAttWarps) {
    // Copy warp.
    if (lane == 0)
      for (int i = i0, c = 0, next; i < i1; i = next) {
        int tok0;
        const int n = fill_of(i, tok0, next);
        if (n <= 0) continue;
        const int s = c % R::kStages;
        if (c >= R::kStages) hp::mbar_wait(&empty[s], (c / R::kStages - 1) & 1);
        ++c;
        uint8_t* st = sm + s * R::kBytes;
        const size_t tok = head * a.s_cap + tok0;
        const int n4 = n & ~3;            // scales by bulk copy; the tail by
                                          // the compute lanes
        hp::mbar_arrive_expect_tx(
            &full[s], n * R::kVRow + (kStored ? gn * n * 4 : n * R::kKRow) +
                          (kKQ ? n4 * 4 : 0) + (kVQ ? n4 * 4 : 0));
        if constexpr (!kStored)
          hp::bulk_load(st, static_cast<const uint8_t*>(a.k) + tok * R::kKRow,
                        n * R::kKRow, &full[s]);
        hp::bulk_load(st + R::kV,
                      static_cast<const uint8_t*>(a.v) + tok * R::kVRow,
                      n * R::kVRow, &full[s]);
        if (kKQ && n4 > 0)
          hp::bulk_load(st + R::kKS, a.k_scale + tok, n4 * 4, &full[s]);
        if (kVQ && n4 > 0)
          hp::bulk_load(st + R::kVS, a.v_scale + tok, n4 * 4, &full[s]);
        if constexpr (kStored) {
          const float* sc = a.scores + row0 * a.s_cap + tok0;
          for (int g = 0; g < gn; ++g)
            hp::bulk_load(st + R::kS + g * kScoreStride * 4,
                          sc + static_cast<size_t>(g) * a.s_cap, n * 4,
                          &full[s]);
        }
      }
  } else {
    uint32_t qb[2][kDP / 16][2];
    if constexpr (!kStored)
      load_q_tiles<kD>(a.q + row0 * kD, a.sm_scale, lane, qb, gn);
    const int src = 4 * t + (r >> 1);             // P^T's lanes (below)
    const uint32_t sel = (r & 1) ? 0x7632u : 0x5410u;
    // A warp's units with kNT n8 tiles of heads (1 up to 8 heads, else 2)
    // in two loops over the unit's row tiles of 16 rows, neither unrolled:
    // the scores into the warp's lanes' own words of `unit_sc` and their
    // max, then the softmax against the unit's max and P.V. A row tile
    // wholly past n is not computed (it would add exact zeros).
    float* usc = unit_sc[warp] + lane;      // [row tile][n8 tile][i][lane]
    const auto consume = [&](auto nt_c) {
      constexpr int kNT = decltype(nt_c)::value;
      for (int i = i0, c = 0, next; i < i1; i = next) {
        int tok0;
        const int fn = fill_of(i, tok0, next);
        if (fn <= 0) continue;
        const int cc = c++;
        const int s = cc % R::kStages;
        // This warp's unit: the fill's rows 64 warp .. + 63 (n of them),
        // its scales and scores at the same offset.
        const int u0 = kAttTile * warp, n = min(kAttTile, fn - u0);
        const size_t tok = head * a.s_cap + tok0 + u0;
        const int n4 = n & ~3;
        const int nrt = n > 0 ? min(kAttRT, (n + 15) / 16) : 0;
        hp::mbar_wait(&full[s], (cc / R::kStages) & 1);
        __syncwarp();   // the lanes leave the wait apart; mma.sync needs all
        const uint8_t* slot = sm + s * R::kBytes;
        const uint8_t* st = slot + u0 * R::kKRow;
        const uint8_t* vt = slot + R::kV + u0 * R::kVRow;
        const float* ks_s = reinterpret_cast<const float*>(slot + R::kKS) + u0;
        const float* vs_s = reinterpret_cast<const float*>(slot + R::kVS) + u0;
        const float* ss = reinterpret_cast<const float*>(slot + R::kS) + u0;
        // Scores [n8 tile][i]: i 0, 1 row 16 rt + r, heads 8 nt + 2t, + 1;
        // i 2, 3 row 16 rt + r + 8; -inf past n and past gn heads.
        float tm[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll 1
        for (int rt = 0; rt < nrt; ++rt) {
          const int ka = 16 * rt + r, kb = ka + 8;
          float sc[2][4];
          if constexpr (kStored) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int i2 = 0; i2 < 4; ++i2) {
                const int h = 8 * nt + 2 * t + (i2 & 1);
                const float x = ss[min(h, kHeadTile - 1) * kScoreStride +
                                   (i2 < 2 ? ka : kb)];
                sc[nt][i2] = h < gn ? x : kNegInf;
              }
          } else {
            // Rows ka (h 0) and kb (h 1): their K scales from the slot, a
            // tail past the last whole 4 from device memory.
            float ksc[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int key = ka + 8 * h;
              ksc[h] = !kKQ ? 1.f : key < n4 ? ks_s[key]
                                   : key < n ? __ldg(a.k_scale + tok + key)
                                             : 1.f;
            }
            uint4 xa[kDP / 32], xb[kDP / 32];
            key_chunks<kD>(st + ka * R::kKRow, t, 0, xa,
                           static_cast<const KT*>(nullptr));
            key_chunks<kD>(st + kb * R::kKRow, t, 0, xb,
                           static_cast<const KT*>(nullptr));
            uint32_t wa[kDP / 8], wb[kDP / 8];
            key_words<kDP>(xa, t, wa, static_cast<const KT*>(nullptr));
            key_words<kDP>(xb, t, wb, static_cast<const KT*>(nullptr));
            float d[2][4];
            mma_scores_tiles<kDP, kNT>(wa, wb, qb, d);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int i2 = 0; i2 < 4; ++i2) {
                const int h = 8 * nt + 2 * t + (i2 & 1);
                sc[nt][i2] = h < gn && (i2 < 2 ? ka : kb) < n
                                 ? score_of(d[nt][i2], ksc[i2 >> 1])
                                 : kNegInf;
              }
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2) {
              tm[nt][i2 & 1] = fmaxf(tm[nt][i2 & 1], sc[nt][i2]);
              usc[((rt * 2 + nt) * 4 + i2) * 32] = sc[nt][i2];
            }
        }
        // Online softmax of the lane's heads over the unit, in log2 units
        // (m too; ex2 on the special-function unit).
        float mu[2][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = tm[nt][e];
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
            const float mn = fmaxf(m[nt][e], x * kLog2e);
            mu[nt][e] = mn == kNegInf ? 0.f : mn;
            const float al = hp::ex2(m[nt][e] - mu[nt][e]);
            m[nt][e] = mn;
            l[nt][e] *= al;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              acc[mt][nt][e] *= al;
              acc[mt][nt][2 + e] *= al;
            }
          }
#pragma unroll 1
        for (int rt = 0; rt < nrt; ++rt) {
          // Rows 16 rt + r (h 0) and + 8 (h 1): their V scales.
          float vsc[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = 16 * rt + r + 8 * h;
            vsc[h] = !kVQ ? 0.f : key < n4 ? vs_s[key]
                                 : key < n ? __ldg(a.v_scale + tok + key)
                                           : 0.f;
          }
          bool live_a = false, live_b = false;
          uint32_t b0[2], b1[2];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            float p[4];
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2) {
              const float x = usc[((rt * 2 + nt) * 4 + i2) * 32];
              p[i2] = hp::ex2(fmaf(x, kLog2e, -mu[nt][i2 & 1]));
              l[nt][i2 & 1] += p[i2];
              if constexpr (kVQ)
                p[i2] = p[i2] == 0.f ? 0.f : p[i2] * vsc[i2 >> 1];
            }
            live_a = live_a || p[0] != 0.f || p[1] != 0.f;
            live_b = live_b || p[2] != 0.f || p[3] != 0.f;
            // Lane (r, t) holds P[row r | r + 8][heads 2t, 2t + 1]; P^T's
            // B wants at lane (r, t) head r's rows t, t + 4 (b0) and t + 8,
            // t + 12 (b1): lanes 4t + r / 2 and 16 above it hold them.
            const uint32_t wa = pack_f32_as_bf16(p[0], p[1]);
            const uint32_t wb = pack_f32_as_bf16(p[2], p[3]);
            const uint32_t x0 = __shfl_sync(0xffffffffu, wa, src);
            const uint32_t x1 = __shfl_sync(0xffffffffu, wa, src + 16);
            const uint32_t y0 = __shfl_sync(0xffffffffu, wb, src);
            const uint32_t y1 = __shfl_sync(0xffffffffu, wb, src + 16);
            b0[nt] = __byte_perm(x0, x1, sel);
            b1[nt] = __byte_perm(y0, y1, sel);
          }
          // bf16 V: the A fragment's rows that no head attends (every p 0:
          // lanes (j, *) hold row j's p, ballot bits 4j .. 4j + 3) read as
          // zeros; stale rows past n among them.
          uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
          if constexpr (!kVQ) {
            const uint32_t ba = __ballot_sync(0xffffffffu, live_a);
            const uint32_t bb = __ballot_sync(0xffffffffu, live_b);
            const auto keep = [](uint32_t bal, int j, uint32_t half) {
              return ((bal >> (4 * j)) & 0xFu) != 0u ? half : 0u;
            };
            lo = keep(ba, t, 0x0000ffffu) | keep(ba, t + 4, 0xffff0000u);
            hi = keep(bb, t, 0x0000ffffu) | keep(bb, t + 4, 0xffff0000u);
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t af[4];
            v_frag<kD>(vt, 16 * rt, t, 16 * mt + 2 * r, af,
                       static_cast<const VT*>(nullptr));
            af[0] &= lo;
            af[1] &= lo;
            af[2] &= hi;
            af[3] &= hi;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              mma_bf16_16816(acc[mt][nt], af, b0[nt], b1[nt]);
          }
        }
        // The lanes release the slot after their own reads, ordered
        // before the copy warp's next bulk copy into it by the proxy fence.
        hp::fence_proxy_async();
        hp::mbar_arrive(&empty[s]);
      }
    };
    if (gn > 8)
      consume(std::integral_constant<int, 2>{});
    else
      consume(std::integral_constant<int, 1>{});
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 4);
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 8);
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 16);
      }
  }

  // ---- the warps' states, over the ring once every warp is done with it.
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(sm);   // [warp][head][kD]
  if (warp < kAttWarps)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = 8 * nt + 2 * t + e;
        if (h >= gn) continue;
        if (r == 0) {
          red_m[warp][h] = m[nt][e];
          red_l[warp][h] = l[nt][e];
        }
        float* o = red_o + (warp * kHeadTile + h) * kD + 2 * r;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {   // rows r, r + 8: dims 2r, 2r + 1
          o[16 * mt] = acc[mt][nt][e];
          o[16 * mt + 1] = acc[mt][nt][2 + e];
        }
      }
  __syncthreads();
  // Each head's max and sum over the warps once; each warp's state then
  // enters by its factor (in red_m), the values in warp order.
  if (tid < gn) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kAttWarps; ++w) mx = fmaxf(mx, red_m[w][tid]);
    const float mu = mx == kNegInf ? 0.f : mx;
    float sl = 0.f;
#pragma unroll
    for (int w = 0; w < kAttWarps; ++w) {
      const float f = hp::ex2(red_m[w][tid] - mu);
      sl += red_l[w][tid] * f;
      red_m[w][tid] = f;
    }
    red_L[tid] = sl;
    red_M[tid] = mu;
  }
  __syncthreads();
  const bool single = nsplit == 1;
  float* po = single ? a.out + row0 * kD
                     : a.part_o + (split * stride + row0) * kD;
  float* pl = single ? a.lse + row0 : a.part_lse + split * stride + row0;
  for (int idx = tid; idx < gn * kD; idx += kAttThreads) {
    const int g = idx / kD;
    float so = 0.f;
#pragma unroll
    for (int w = 0; w < kAttWarps; ++w)
      so += red_o[(w * kHeadTile + g) * kD + idx % kD] * red_m[w][g];
    const float sl = red_L[g];
    po[idx] = sl > 0.f ? so / sl : 0.f;
    if (idx % kD == 0)
      pl[g] = sl > 0.f ? red_M[g] * kLn2 + logf(sl) : kNegInf;
  }
  if (single) return;

  // ---- the last block of this (request, kv head, block of heads) merges:
  // the partials come into shared memory a batch at a time (every copy of
  // a batch in flight at once, one round trip), then each thread's values
  // run over them in partial order (an empty partial weighs nothing).
  __syncthreads();
  if (tid == 0) is_last = take_ticket(&a.tickets[hd.slot(b, a.hkv)], nsplit);
  __syncthreads();
  if (!is_last) return;
  constexpr int kItems = (kHeadTile * kD / 4 + kAttThreads - 1) / kAttThreads;
  const int per = gn * kD;                         // floats of a partial
  const int cap = R::kSmem / 4 / (per + kHeadTile);
  float* o_st = reinterpret_cast<float*>(sm);      // [cap][per]
  float* l_st = o_st + cap * per;                  // [cap][kHeadTile]
  float mx[kItems], den[kItems], o4[kItems][4];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    mx[k] = kNegInf;
    den[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o4[k][j] = 0.f;
  }
  for (int p0 = 0; p0 < nsplit; p0 += cap) {
    const int nb = min(cap, nsplit - p0);
    // (cp.async.cg and __ldcg read past L1, which may hold stale lines of
    // other blocks' rows.)
    for (int i = tid; i < nb * per / 4; i += kAttThreads) {
      const int p = i / (per / 4), u = i % (per / 4);
      hp::cp_async_16(o_st + p * per + 4 * u,
                      a.part_o + ((p0 + p) * stride + row0) * kD + 4 * u);
    }
    hp::cp_async_commit();
    for (int i = tid; i < nb * gn; i += kAttThreads)
      l_st[(i / gn) * kHeadTile + i % gn] =
          __ldcg(a.part_lse + (p0 + i / gn) * stride + row0 + i % gn);
    hp::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int idx = tid + k * kAttThreads;       // four values from 4 idx
      if (idx >= per / 4) break;
      const int g = 4 * idx / kD;
      for (int p = 0; p < nb; ++p) {
        const float ls = l_st[p * kHeadTile + g];
        if (ls == kNegInf) continue;
        const float4 ov = reinterpret_cast<const float4*>(o_st + p * per)[idx];
        const float nm = fmaxf(mx[k], ls);
        const float keep = expf(mx[k] - nm), w = expf(ls - nm);
        den[k] = den[k] * keep + w;
        o4[k][0] = o4[k][0] * keep + w * ov.x;
        o4[k][1] = o4[k][1] * keep + w * ov.y;
        o4[k][2] = o4[k][2] * keep + w * ov.z;
        o4[k][3] = o4[k][3] * keep + w * ov.w;
        mx[k] = nm;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = tid + k * kAttThreads;
    if (idx >= per / 4) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a.out[row0 * kD + 4 * idx + j] = den[k] > 0.f ? o4[k][j] / den[k] : 0.f;
    if ((4 * idx) % kD == 0)
      a.lse[row0 + 4 * idx / kD] =
          den[k] > 0.f ? mx[k] + logf(den[k]) : kNegInf;
  }
}

// Host: launch `kernel` (a __global__ taking ChunkArgs over
// chunk_attend_tile) on grid (ceil(nsel * block_size / chunk), Hkv *
// ceil(group / 16), B), kAttThreads a block.
template <typename KT, typename VT, bool kStored, int kD, typename Kernel>
int launch_chunk_tile(Kernel* kernel, const ChunkArgs& a, unsigned& smem_set,
                      cudaStream_t stream) {
  // The ring, then the ids of the selected blocks a block's units lie in
  // (at most kAttMaxIds).
  constexpr int kMax = AttRing<KT, VT, kStored, kD>::kSmem + 4 * kAttMaxIds;
  const int ids = a.chunk / a.block_size + 2;
  if (ids > kAttMaxIds) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = AttRing<KT, VT, kStored, kD>::kSmem + 4 * ids;
  const cudaError_t err = hp::allow_smem(kernel, kMax, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.nsel * a.block_size + a.chunk - 1) / a.chunk,
            a.hkv * group_blocks(a.group, kHeadTile), a.batch);
  kernel<<<grid, kAttThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The general tile of both attends (chunk_attend_part.cu): k_kind a KeyKind
// (packed int4 at d = 64 and 128), or V int8 / bf16 for the stored scores.
int rescore_attend_part(int k_kind, int head_dim, const ChunkArgs& a,
                        cudaStream_t st);
int block_attend_part(bool v_int8, int head_dim, const ChunkArgs& a,
                      cudaStream_t st);

// The sizes every form needs: d = 16, 32, 64 or 128, hq a multiple of
// hkv, block_size a multiple of 64 dividing s_cap, chunk a multiple of 64
// (up to 512 in the exact instances).
inline bool chunk_args_ok(const ChunkArgs& a, int hq, int head_dim) {
  const int g = a.hkv > 0 ? hq / a.hkv : 0;
  // The exact instances' chunk of one selected block, or the general
  // tile's tokens a CUDA block over the list of selected blocks.
  const bool chunk_ok =
      a.chunk >= 64 && a.chunk % 64 == 0 &&
      (!exact_group(g, head_dim) || a.chunk <= kMaxChunk);
  return head_dim_ok(head_dim) && g >= 1 && g * a.hkv == hq && a.nsel > 0 &&
         a.block_size > 0 && a.block_size % 64 == 0 &&
         a.s_cap % a.block_size == 0 && chunk_ok && a.tickets != nullptr;
}

}  // namespace mp
