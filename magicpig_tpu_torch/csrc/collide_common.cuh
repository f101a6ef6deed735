// The >=2-of-L SimHash collision scan over flat bit-plane signatures
// (ops/bitcodes.py), shared by the standalone scan (collision_words.cu) and
// the fused LSH decode (lsh_common.cuh), so that both run the same code.
//
// planes: [B, Hkv, L, K, W] int32, W = S/32 words; token t is bit t%32 of
// word t/32. A thread owns one word of one (request, kv head) and a set of
// tables (l0, l0 + step, ...): per table it reads the K plane words
// (coalesced along W across the threads of a warp), matches them against
// the K query bits of each of the G heads of the group,
//   match = AND_k (plane[l, k] XOR (q_bit[l, k] - 1)),
// and folds the match words into (once, twice) accumulators. Partial
// accumulators of other tables merge with the associative
//   (o1, t1) + (o2, t2) = (o1 | o2, t1 | t2 | (o1 & o2)),
// so any split of the tables, odd L included, gives the same bits.
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kMaxK = 16;   // bits per table

// Pack the K 0/1 query bits of each (head, table) into one word:
// qcode[i] for i = g * L + l, bit kb = q_bits[(g, l, kb)]. q_bits points at
// the group's first head, [G, L, K] int32.
__device__ __forceinline__ void load_qcodes(uint32_t* qcode,
                                            const int* q_bits, int n, int K,
                                            int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    const int* bits = q_bits + static_cast<size_t>(i) * K;
    uint32_t c = 0;
    for (int kb = 0; kb < K; ++kb) c |= static_cast<uint32_t>(bits[kb] & 1) << kb;
    qcode[i] = c;
  }
}

// (once, twice) of tables l0, l0 + step, ... < L for word pw[0] of G heads;
// pw points at word w of table 0, bit 0 of the (request, kv head), and
// `words` is W (the stride between plane rows).
template <int G>
__device__ __forceinline__ void scan_tables(const int* __restrict__ pw,
                                            int words, const uint32_t* qcode,
                                            int K, int L, int l0, int step,
                                            uint32_t (&once)[G],
                                            uint32_t (&twice)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) once[g] = twice[g] = 0u;
#pragma unroll 2
  for (int l = l0; l < L; l += step) {
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

// (o, t) += (o2, t2), the associative merge of two table sets.
__device__ __forceinline__ void merge_collisions(uint32_t& o, uint32_t& t,
                                                 uint32_t o2, uint32_t t2) {
  t |= t2 | (o & o2);
  o |= o2;
}

}  // namespace mp
