// The LSH-sampled decode attend shared by the fused kernel (lsh_fused.cu:
// the collision scan in the same pass) and the two-stage kernel
// (lsh_masked.cu: the collision words precomputed). One template, one
// flag: kWords reads each head's selection words from a [B, Hq, S/32]
// int32 array; otherwise the block scans the signatures itself
// (collide_common.cuh). Everything after the selection is the same code:
// the length mask, the collision-probability debias, online softmax, the
// weighted V sum over the sampled rows only, and the sampled count.
//
// K/V come bf16, or int8 with per-token f32 scales (the TPU kernels'
// quant=True form: the raw score is q . K_int8 times the K scale, the
// cosine uses the stored norms of the dequantized keys, and the V scale
// multiplies p in the P.V sum). The debias form is a compile-time
// parameter (lsh_fused.py:139-158 of the JAX package): exact (the collision
// weight, below), poly (log w + eps as a degree-20 polynomial of the
// clipped cosine, its 21 coefficients passed by value and evaluated by
// Horner's rule with one rounded multiply and one rounded add a step, as
// the plain version does) and none (the scaled score, unweighted).
//
// Design: one block of 128 threads per (512-token split, kv head,
// request), as in flash_decode.cu. The block first finds its selection
// words: 16 words per head (read, or scanned with each thread owning one
// word and every 8th table for all G heads, the (once, twice) pairs merged
// in shared memory), ANDed with the split's valid tokens. Then it walks
// the split in 64-token tiles, skipping a tile no head of the group
// sampled, reading a K/V/norm row only where some head sampled the token
// (other rows are zero-filled in shared memory, never read; the none form
// reads no norm), scores only sampled (head, token) pairs, and sums P.V
// over those rows only, with the exact debias in libm acosf, log1pf and
// expm1f. Splits merge by LSE (launch_merge in flash_decode.cu).
#pragma once

#include <type_traits>

#include "collide_common.cuh"
#include "common.cuh"
#include "decode_common.cuh"

namespace mp {

constexpr int kLshWordsPerChunk = kDecChunk / 32;             // 16
constexpr int kLshSlices = kDecThreads / kLshWordsPerChunk;   // 8
constexpr float kPi = 3.14159265358979323846f;
constexpr float kDebiasEps = 1e-4f;
constexpr int kPolyTerms = 21;                                // degree 20

// Debias forms (LSHConfig.lsh_debias), a template parameter of the kernel.
enum Debias : int { kExact = 0, kPoly = 1, kNone = 2 };

struct PolyCoef {
  float c[kPolyTerms];   // power basis, low degree first
};

// Arguments of one launch. Selection: planes [B, Hkv, L, K, S/32] and
// q_bits [B, Hq, L, K] for the scan, or words [B, Hq, S/32] (the other
// pointers null). k_scale, v_scale [B, Hkv, S]: int8 K/V only.
struct LshArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *k_norm;
  const int *planes, *q_bits, *words, *length;
  float *part_o, *part_lse, *part_cnt, *out, *lse, *cnt;
  int batch, s_cap, hkv, K, L;
  float sm_scale;
  PolyCoef poly;
};

template <int G>
struct LshSmem {
  DecodeTileSmem<G> tile;
  uint32_t once[kLshSlices][G][kLshWordsPerChunk];
  uint32_t twice[kLshSlices][G][kLshWordsPerChunk];
  uint32_t sel[G][kLshWordsPerChunk];   // sampled and valid tokens
  uint32_t any[kLshWordsPerChunk];      // sampled by some head of the group
  float qnorm[G];
  float knorm[kDecTile];
  int count[G];
};

// Valid-token mask of a word whose first token is `first` (of [.., stop)).
__device__ __forceinline__ uint32_t valid_bits(int first, int stop) {
  const int n = min(max(stop - first, 0), 32);
  return n >= 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// T: __nv_bfloat16, or int8_t with the row scales. kDebias: a Debias
// form. kWords: selection words given (else scanned from the planes).
template <int G, typename T, int kDebias, bool kWords>
__global__ void __launch_bounds__(kDecThreads)
lsh_split_kernel(const LshArgs a) {
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  __shared__ LshSmem<G> sm;
  extern __shared__ uint32_t qcode[];   // scan only: [G][L] query codes

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(a.q);
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int K = a.K, L = a.L, s_cap = a.s_cap;
  const int hq = a.hkv * G;
  const int words = s_cap / 32;
  const int start = split * kDecChunk;
  const int stop = min(min(a.length[b], s_cap), start + kDecChunk);
  const size_t part = (static_cast<size_t>(split) * a.batch + b) * hq + kh * G;

  if (start >= stop) {
    write_empty_partial<G>(a.part_o, a.part_lse, a.part_cnt, part, tid);
    return;
  }

  // Query: raw f32 values (the debias needs the unscaled dot), norms and,
  // for the scan, packed sign bits.
  const size_t qrow = static_cast<size_t>(b) * hq + kh * G;
  for (int i = tid; i < G * kDecD; i += kDecThreads)
    sm.tile.qf[i / kDecD][i % kDecD] = __bfloat162float(q[qrow * kDecD + i]);
  if constexpr (!kWords)
    load_qcodes(qcode, a.q_bits + qrow * L * K, G * L, K, tid, kDecThreads);
  if (tid < G) sm.count[tid] = 0;
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int d = 0; d < kDecD; ++d) s += sm.tile.qf[tid][d] * sm.tile.qf[tid][d];
    sm.qnorm[tid] = sqrtf(s);
  }

  // ---- the split's selection words, ANDed with its valid tokens.
  if constexpr (kWords) {
    if (tid < G * kLshWordsPerChunk) {
      const int g = tid / kLshWordsPerChunk, wi = tid % kLshWordsPerChunk;
      const int first = start + 32 * wi;
      uint32_t t = 0u;
      if (first < stop)
        t = static_cast<uint32_t>(a.words[(qrow + g) * words + first / 32]) &
            valid_bits(first, stop);
      sm.sel[g][wi] = t;
      atomicAdd(&sm.count[g], __popc(t));
    }
  } else {
    // Thread (slice, wi) owns word wi, tables slice + 8n.
    const int wi = tid % kLshWordsPerChunk;
    const int slice = tid / kLshWordsPerChunk;
    uint32_t once[G], twice[G];
    if (start + 32 * wi < stop) {
      const int* pw = a.planes + static_cast<size_t>(b * a.hkv + kh) * L * K * words +
                      start / 32 + wi;
      scan_tables<G>(pw, words, qcode, K, L, slice, kLshSlices, once, twice);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) once[g] = twice[g] = 0u;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm.once[slice][g][wi] = once[g];
      sm.twice[slice][g][wi] = twice[g];
    }
    __syncthreads();
    if (tid < G * kLshWordsPerChunk) {
      const int g = tid / kLshWordsPerChunk, w = tid % kLshWordsPerChunk;
      uint32_t o = 0u, t = 0u;
      for (int s = 0; s < kLshSlices; ++s)
        merge_collisions(o, t, sm.once[s][g][w], sm.twice[s][g][w]);
      t &= valid_bits(start + 32 * w, stop);
      sm.sel[g][w] = t;
      atomicAdd(&sm.count[g], __popc(t));
    }
  }
  __syncthreads();
  if (tid < kLshWordsPerChunk) {
    uint32_t any = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) any |= sm.sel[g][tid];
    sm.any[tid] = any;
  }
  __syncthreads();

  // ---- debiased online softmax over the sampled tokens of the split.
  const size_t head_off = (static_cast<size_t>(b) * a.hkv + kh) * s_cap;
  const T* k_h = static_cast<const T*>(a.k) + head_off * kDecD;
  const T* v_h = static_cast<const T*>(a.v) + head_off * kDecD;
  const float* n_h = static_cast<const float*>(a.k_norm) + head_off;
  const float fK = static_cast<float>(K), fL = static_cast<float>(L);

  OnlineSoftmax<G> st;
  st.init();
  for (int t0 = start; t0 < stop; t0 += kDecTile) {
    const int w0 = (t0 - start) / 32;     // first of this tile's 2 words
    if ((sm.any[w0] | sm.any[w0 + 1]) == 0u) continue;   // block-uniform
    if constexpr (kQ)
      load_kv_tile<G>(sm.tile, k_h, v_h,
                      static_cast<const float*>(a.k_scale) + head_off,
                      static_cast<const float*>(a.v_scale) + head_off, t0,
                      stop, tid, &sm.any[w0]);
    else
      load_kv_tile<G>(sm.tile, k_h, v_h, t0, stop, tid, &sm.any[w0]);
    if (kDebias != kNone && tid < kDecTile) {
      const bool need = t0 + tid < stop &&
                        ((sm.any[w0 + (tid >> 5)] >> (tid & 31)) & 1u);
      sm.knorm[tid] = need ? n_h[t0 + tid] : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < G * kDecTile; p += kDecThreads) {
      const int g = p / kDecTile, j = p % kDecTile;
      float score = kNegInf;
      if ((sm.sel[g][w0 + (j >> 5)] >> (j & 31)) & 1u) {
        float raw = row_dot(sm.tile.ks[j], sm.tile.qf[g]);
        if constexpr (kQ) raw *= sm.tile.ksc[j];
        float log_w = 0.f;                       // the none form
        if constexpr (kDebias != kNone) {
          float c = raw / fmaxf(sm.qnorm[g] * sm.knorm[j], 1e-20f);
          c = fminf(fmaxf(c, -1.f), 1.f);
          if constexpr (kDebias == kPoly) {
            log_w = a.poly.c[kPolyTerms - 1];
#pragma unroll
            for (int i = kPolyTerms - 2; i >= 0; --i)
              log_w = __fadd_rn(__fmul_rn(log_w, c), a.poly.c[i]);
          } else {
            const float u = powf(1.f - acosf(c) / kPi, fK);
            // w = P[>= 2 of L tables collide], without the cancellation of
            // 1 - (1-u)^(L-1) (1 + (L-1) u) (see ops/debias.py).
            const float log_miss = L > 1 ? (fL - 1.f) * log1pf(-u) : 0.f;
            const float w = -expm1f(log_miss + log1pf((fL - 1.f) * u));
            log_w = logf(w + kDebiasEps);
          }
        }
        score = (raw * a.sm_scale - log_w) * kLog2e;
      }
      sm.tile.ps[g][j] = score;
    }
    __syncthreads();
    st.softmax_tile(sm.tile, tid);
    __syncthreads();
    st.template accumulate_pv_rows<kQ>(sm.tile, tid, &sm.any[w0]);
    __syncthreads();
  }
  st.write_partial(sm.tile, a.part_o, a.part_lse, part, tid);
  if (tid < G) a.part_cnt[part + tid] = static_cast<float>(sm.count[tid]);
}

template <int G, typename T, int kDebias, bool kWords>
int launch_lsh(const LshArgs& a, cudaStream_t stream) {
  const int nsplit = (a.s_cap + kDecChunk - 1) / kDecChunk;
  const size_t dyn = kWords ? 0 : static_cast<size_t>(G) * a.L * sizeof(uint32_t);
  dim3 grid(nsplit, a.hkv, a.batch);
  lsh_split_kernel<G, T, kDebias, kWords><<<grid, kDecThreads, dyn, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(a.part_o, a.part_lse, a.part_cnt, a.out, a.lse, a.cnt,
                      nsplit, a.batch * a.hkv * G, stream);
}

template <int G, bool kWords>
int dispatch_lsh_form(int debias, bool quant, const LshArgs& a,
                      cudaStream_t st) {
#define MP_LSH_FORM(D)                                                   \
  case D:                                                                \
    return quant ? launch_lsh<G, int8_t, D, kWords>(a, st)               \
                 : launch_lsh<G, __nv_bfloat16, D, kWords>(a, st);
  switch (debias) {
    MP_LSH_FORM(kExact)
    MP_LSH_FORM(kPoly)
    MP_LSH_FORM(kNone)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_LSH_FORM
}

// Check the sizes, copy the polynomial (a host array of the 21
// coefficients, low degree first; debias 1 only) into the arguments, and
// launch the form for hq / hkv heads a group. k_scale and v_scale null:
// bf16 K/V; both set: int8. debias: 0 exact, 1 poly, 2 none.
template <bool kWords>
int launch_lsh_decode(LshArgs a, int hq, int head_dim, int debias,
                      const void* poly_coef, void* stream) {
  if (head_dim != kDecD || hq % a.hkv != 0 || a.s_cap % 32 != 0 ||
      a.K < 1 || a.K > kMaxK || a.L < 1 ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr) ||
      (debias == kPoly) != (poly_coef != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (poly_coef != nullptr)
    for (int i = 0; i < kPolyTerms; ++i)
      a.poly.c[i] = static_cast<const float*>(poly_coef)[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = a.k_scale != nullptr;
  switch (hq / a.hkv) {
    case 1: return dispatch_lsh_form<1, kWords>(debias, quant, a, st);
    case 2: return dispatch_lsh_form<2, kWords>(debias, quant, a, st);
    case 4: return dispatch_lsh_form<4, kWords>(debias, quant, a, st);
    case 8: return dispatch_lsh_form<8, kWords>(debias, quant, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mp
