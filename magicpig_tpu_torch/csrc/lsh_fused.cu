// Fused LSH-sampled decode: the >=2-of-L SimHash collision scan, the
// length mask, the collision-probability debias, online softmax, the
// weighted V sum and the sampled count, in one pass.
//
// Replaces magicpig_tpu/ops/pallas/lsh_fused.py::lsh_fused_attention2 (the
// pallas_call at lsh_fused.py:286), reached through
// magicpig_tpu/ops/pallas/lsh_decode.py::lsh_fused_decode, with bf16 K/V or
// int8 K/V and per-token f32 scales (its quant=True form: the raw score is
// q . K_int8 times the K scale, the cosine uses the stored norms of the
// dequantized keys, and the V scale multiplies p in the P.V sum), and each
// of its three debias forms (lsh_fused.py:139-158), chosen at compile time:
// exact (the collision weight, below), poly (log w + eps as a degree-20
// polynomial of the clipped cosine, its 21 coefficients passed by value and
// evaluated by Horner's rule with one rounded multiply and one rounded add a
// step, as the plain version does) and none (the scaled score, unweighted).
//
// Bound on the H100: device memory. The signatures must all be read to
// know which tokens are sampled: K*L bits per token and kv head, 188 bytes
// at K=10, L=150, against 256 bytes of bf16 K+V at d = 64, so the scan
// stream is not small. K, V and the key norm are needed only for tokens that
// some query head of the group samples (~2% per head at the defaults); int8
// rows halve those bytes and leave the signature words as they are.
// Design: one block of 128 threads per (512-token split, kv head, request),
// as in flash_decode.cu. The block first scans its 16 signature words per
// (table, bit) with coalesced 4-byte reads along the token axis, each thread
// owning one word and every 8th table for all G heads, and combines the
// per-thread (once, twice) words with (o1,t1)+(o2,t2) = (o1|o2,
// t1|t2|(o1&o2)); any L, odd or even. Then it walks the split in 64-token
// tiles, reading a K/V/norm row only where some head sampled the token
// (other rows are zero-filled in shared memory, never read; the none form
// reads no norm), scores only sampled (head, token) pairs, and sums P.V over
// those rows only, with the exact debias in libm acosf, log1pf and expm1f.
// Whether a fully gathered form beats this streamed scan is for a
// measurement to decide.
#include <type_traits>

#include "common.cuh"
#include "decode_common.cuh"

namespace {

constexpr int kWordsPerChunk = mp::kDecChunk / 32;            // 16
constexpr int kSlices = mp::kDecThreads / kWordsPerChunk;     // 8
constexpr int kMaxK = 16;                                     // bits per table
constexpr float kPi = 3.14159265358979323846f;
constexpr float kDebiasEps = 1e-4f;
constexpr int kPolyTerms = 21;                                // degree 20

// Debias forms (LSHConfig.lsh_debias), a template parameter of the kernel.
enum Debias : int { kExact = 0, kPoly = 1, kNone = 2 };

struct PolyCoef {
  float c[kPolyTerms];   // power basis, low degree first
};

template <int G>
struct LshSmem {
  mp::DecodeTileSmem<G> tile;
  uint32_t once[kSlices][G][kWordsPerChunk];
  uint32_t twice[kSlices][G][kWordsPerChunk];
  uint32_t sel[G][kWordsPerChunk];      // sampled and valid tokens
  uint32_t any[kWordsPerChunk];         // sampled by some head of the group
  float qnorm[G];
  float knorm[mp::kDecTile];
  int count[G];
};

// T: __nv_bfloat16, or int8_t with the row scales k_scale, v_scale [B,
// Hkv, S] (null for bf16). kDebias: a Debias form; poly holds its
// coefficients (read by the poly form only).
template <int G, typename T, int kDebias>
__global__ void __launch_bounds__(mp::kDecThreads)
lsh_fused_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const float* __restrict__ k_norm,
                       const int* __restrict__ planes,
                       const int* __restrict__ q_bits,
                       const int* __restrict__ length,
                       float* __restrict__ part_o,
                       float* __restrict__ part_lse,
                       float* __restrict__ part_cnt, int batch, int s_cap,
                       int hkv, int K, int L, float sm_scale,
                       const PolyCoef poly) {
  using namespace mp;
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  __shared__ LshSmem<G> sm;
  extern __shared__ uint32_t qcode[];   // [G][L]: K query bits per table

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = hkv * G;
  const int words = s_cap / 32;
  const int start = split * kDecChunk;
  const int stop = min(min(length[b], s_cap), start + kDecChunk);
  const size_t part = (static_cast<size_t>(split) * batch + b) * hq + kh * G;

  if (start >= stop) {
    write_empty_partial<G>(part_o, part_lse, part_cnt, part, tid);
    return;
  }

  // Query: raw f32 values (the debias needs the unscaled dot), norms and
  // packed sign bits.
  const size_t qrow = static_cast<size_t>(b) * hq + kh * G;
  for (int i = tid; i < G * kDecD; i += kDecThreads)
    sm.tile.qf[i / kDecD][i % kDecD] = __bfloat162float(q[qrow * kDecD + i]);
  for (int i = tid; i < G * L; i += kDecThreads) {
    const int* bits = q_bits + (qrow * L + i) * K;   // i = g * L + l
    uint32_t c = 0;
    for (int kb = 0; kb < K; ++kb) c |= static_cast<uint32_t>(bits[kb] & 1) << kb;
    qcode[i] = c;
  }
  if (tid < G) sm.count[tid] = 0;
  __syncthreads();
  if (tid < G) {
    float s = 0.f;
    for (int d = 0; d < kDecD; ++d) s += sm.tile.qf[tid][d] * sm.tile.qf[tid][d];
    sm.qnorm[tid] = sqrtf(s);
  }

  // ---- >=2-of-L scan: thread (slice, wi) owns word wi, tables slice + 8n.
  {
    const int wi = tid % kWordsPerChunk;
    const int slice = tid / kWordsPerChunk;
    const int w = start / 32 + wi;
    uint32_t once[G], twice[G];
#pragma unroll
    for (int g = 0; g < G; ++g) once[g] = twice[g] = 0u;
    if (start + 32 * wi < stop) {
      const int* pw = planes + static_cast<size_t>(b * hkv + kh) * L * K * words + w;
#pragma unroll 2
      for (int l = slice; l < L; l += kSlices) {
        // All K words of table l first (predicated, independent loads in
        // flight together), then the AND over bits for every head.
        const int* pl = pw + static_cast<size_t>(l) * K * words;
        uint32_t wv[kMaxK];
#pragma unroll
        for (int kb = 0; kb < kMaxK; ++kb)
          wv[kb] = kb < K ? static_cast<uint32_t>(__ldg(pl + static_cast<size_t>(kb) * words)) : 0u;
        uint32_t qc[G], match[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          qc[g] = qcode[g * L + l];
          match[g] = 0xffffffffu;
        }
#pragma unroll
        for (int kb = 0; kb < kMaxK; ++kb) {
          if (kb < K) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              // (q_bit - 1): 0 keeps the key bits, all ones flips them.
              match[g] &= wv[kb] ^ (((qc[g] >> kb) & 1u) - 1u);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          twice[g] |= once[g] & match[g];
          once[g] |= match[g];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm.once[slice][g][wi] = once[g];
      sm.twice[slice][g][wi] = twice[g];
    }
  }
  __syncthreads();
  if (tid < G * kWordsPerChunk) {
    const int g = tid / kWordsPerChunk, wi = tid % kWordsPerChunk;
    uint32_t o = 0u, t = 0u;
    for (int s = 0; s < kSlices; ++s) {
      t |= sm.twice[s][g][wi] | (o & sm.once[s][g][wi]);
      o |= sm.once[s][g][wi];
    }
    const int nvalid = min(max(stop - (start + 32 * wi), 0), 32);
    t &= nvalid >= 32 ? 0xffffffffu : ((1u << nvalid) - 1u);
    sm.sel[g][wi] = t;
    atomicAdd(&sm.count[g], __popc(t));
  }
  __syncthreads();
  if (tid < kWordsPerChunk) {
    uint32_t a = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) a |= sm.sel[g][tid];
    sm.any[tid] = a;
  }
  __syncthreads();

  // ---- debiased online softmax over the sampled tokens of the split.
  const size_t head_off = (static_cast<size_t>(b) * hkv + kh) * s_cap;
  const T* k_h = k + head_off * kDecD;
  const T* v_h = v + head_off * kDecD;
  const float* n_h = k_norm + head_off;
  const float fK = static_cast<float>(K), fL = static_cast<float>(L);

  OnlineSoftmax<G> st;
  st.init();
  for (int t0 = start; t0 < stop; t0 += kDecTile) {
    const int w0 = (t0 - start) / 32;     // first of this tile's 2 words
    if ((sm.any[w0] | sm.any[w0 + 1]) == 0u) continue;   // block-uniform
    if constexpr (kQ)
      load_kv_tile<G>(sm.tile, k_h, v_h, k_scale + head_off,
                      v_scale + head_off, t0, stop, tid, &sm.any[w0]);
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
            log_w = poly.c[kPolyTerms - 1];
#pragma unroll
            for (int i = kPolyTerms - 2; i >= 0; --i)
              log_w = __fadd_rn(__fmul_rn(log_w, c), poly.c[i]);
          } else {
            const float u = powf(1.f - acosf(c) / kPi, fK);
            // w = P[>= 2 of L tables collide], without the cancellation of
            // 1 - (1-u)^(L-1) (1 + (L-1) u) (see ops/debias.py).
            const float log_miss = L > 1 ? (fL - 1.f) * log1pf(-u) : 0.f;
            const float w = -expm1f(log_miss + log1pf((fL - 1.f) * u));
            log_w = logf(w + kDebiasEps);
          }
        }
        score = (raw * sm_scale - log_w) * kLog2e;
      }
      sm.tile.ps[g][j] = score;
    }
    __syncthreads();
    st.softmax_tile(sm.tile, tid);
    __syncthreads();
    st.template accumulate_pv_rows<kQ>(sm.tile, tid, &sm.any[w0]);
    __syncthreads();
  }
  st.write_partial(sm.tile, part_o, part_lse, part, tid);
  if (tid < G) part_cnt[part + tid] = static_cast<float>(sm.count[tid]);
}

template <int G, typename T, int kDebias>
int launch_lsh(const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale,
               const void* k_norm, const void* planes, const void* q_bits,
               const void* length, void* part_o, void* part_lse,
               void* part_cnt, void* out, void* lse, void* cnt, int batch,
               int s_cap, int hkv, int K, int L, float sm_scale,
               const PolyCoef& poly, cudaStream_t stream) {
  const int nsplit = (s_cap + mp::kDecChunk - 1) / mp::kDecChunk;
  const size_t dyn = static_cast<size_t>(G) * L * sizeof(uint32_t);
  dim3 grid(nsplit, hkv, batch);
  lsh_fused_split_kernel<G, T, kDebias><<<grid, mp::kDecThreads, dyn,
                                           stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(k_norm), static_cast<const int*>(planes),
      static_cast<const int*>(q_bits), static_cast<const int*>(length),
      static_cast<float*>(part_o), static_cast<float*>(part_lse),
      static_cast<float*>(part_cnt), batch, s_cap, hkv, K, L, sm_scale,
      poly);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mp::launch_merge(static_cast<const float*>(part_o),
                          static_cast<const float*>(part_lse),
                          static_cast<const float*>(part_cnt),
                          static_cast<float*>(out), static_cast<float*>(lse),
                          static_cast<float*>(cnt), nsplit, batch * hkv * G,
                          stream);
}

template <int G, int kDebias>
int dispatch_type(bool quant, const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* k_norm, const void* planes, const void* q_bits,
                  const void* length, void* part_o, void* part_lse,
                  void* part_cnt, void* out, void* lse, void* cnt, int batch,
                  int s_cap, int hkv, int K, int L, float sm_scale,
                  const PolyCoef& poly, cudaStream_t st) {
  if (quant)
    return launch_lsh<G, int8_t, kDebias>(
        q, k, v, k_scale, v_scale, k_norm, planes, q_bits, length, part_o,
        part_lse, part_cnt, out, lse, cnt, batch, s_cap, hkv, K, L, sm_scale,
        poly, st);
  return launch_lsh<G, __nv_bfloat16, kDebias>(
      q, k, v, nullptr, nullptr, k_norm, planes, q_bits, length, part_o,
      part_lse, part_cnt, out, lse, cnt, batch, s_cap, hkv, K, L, sm_scale,
      poly, st);
}

template <int G>
int dispatch_debias(int debias, bool quant, const void* q, const void* k,
                    const void* v, const void* k_scale, const void* v_scale,
                    const void* k_norm, const void* planes,
                    const void* q_bits, const void* length, void* part_o,
                    void* part_lse, void* part_cnt, void* out, void* lse,
                    void* cnt, int batch, int s_cap, int hkv, int K, int L,
                    float sm_scale, const PolyCoef& poly, cudaStream_t st) {
#define MP_DEBIAS_CASE(D)                                                    \
  case D:                                                                    \
    return dispatch_type<G, D>(quant, q, k, v, k_scale, v_scale, k_norm,     \
                               planes, q_bits, length, part_o, part_lse,     \
                               part_cnt, out, lse, cnt, batch, s_cap, hkv,   \
                               K, L, sm_scale, poly, st);
  switch (debias) {
    MP_DEBIAS_CASE(kExact)
    MP_DEBIAS_CASE(kPoly)
    MP_DEBIAS_CASE(kNone)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_DEBIAS_CASE
}

}  // namespace

// k_scale and v_scale null: bf16 K/V; both set: int8 K/V with those
// per-token scales [B, Hkv, S]. debias: 0 exact, 1 poly (poly_coef: a host
// array of the 21 coefficients, low degree first), 2 none.
extern "C" int mp_lsh_fused_decode(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* k_norm,
                                   const void* planes, const void* q_bits,
                                   const void* length, void* part_o,
                                   void* part_lse, void* part_cnt, void* out,
                                   void* lse, void* cnt, int batch, int s_cap,
                                   int hq, int hkv, int head_dim, int K,
                                   int L, float sm_scale, int debias,
                                   const void* poly_coef, void* stream) {
  if (head_dim != mp::kDecD || hq % hkv != 0 || s_cap % 32 != 0 || K < 1 ||
      K > kMaxK || L < 1 || (k_scale == nullptr) != (v_scale == nullptr) ||
      (debias == kPoly) != (poly_coef != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PolyCoef poly{};
  if (poly_coef != nullptr)
    for (int i = 0; i < kPolyTerms; ++i)
      poly.c[i] = static_cast<const float*>(poly_coef)[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
#define MP_LSH_CASE(G)                                                      \
  case G:                                                                   \
    return dispatch_debias<G>(debias, quant, q, k, v, k_scale, v_scale,     \
                              k_norm, planes, q_bits, length, part_o,       \
                              part_lse, part_cnt, out, lse, cnt, batch,     \
                              s_cap, hkv, K, L, sm_scale, poly, st);
  switch (hq / hkv) {
    MP_LSH_CASE(1)
    MP_LSH_CASE(2)
    MP_LSH_CASE(4)
    MP_LSH_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_LSH_CASE
}
