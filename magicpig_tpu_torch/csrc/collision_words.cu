// Standalone >=2-of-L collision scan: packed collision words of every query
// head, bit j of word w set iff key 32w + j collides with the query in at
// least two of the L tables.
//
// Replaces both drop-in Pallas scans of the JAX package:
// magicpig_tpu/ops/pallas/collide.py::collision_words_pallas (pallas_call at
// collide.py:76, planes [B, Hkv, L, K, W]) and
// magicpig_tpu/ops/pallas/mask.py::collision_words_pallas (pallas_call at
// mask.py:87, the same planes viewed as [B, Hkv, L*K, W]); the flat layout
// makes them one function. Bit-exact: the result is made of bitwise
// operations only.
//
// Bound on the H100: device memory. Every plane word is read once (K*L*4
// bytes per 32 tokens and kv head, 188 bytes a token-head at K=10, L=150),
// the output is 1/(K*L) of that per head. Design: one thread per word,
// reading coalesced along W; the tables of a word are split over the 8
// warps of a 256-thread block (warp s takes tables s, s + 8, ...), so a
// thread runs ~L/8 tables with the K loads of a table in flight together
// (the scan of collide_common.cuh, which the fused LSH kernel runs too),
// and the 8 partial (once, twice) pairs merge in shared memory. The G
// heads of a kv head share each plane word read.
#include "collide_common.cuh"

namespace {

constexpr int kWordsPerBlock = 32;
constexpr int kScanSlices = 8;
constexpr int kScanThreads = kWordsPerBlock * kScanSlices;   // 256

template <int G>
__global__ void __launch_bounds__(kScanThreads)
collision_words_kernel(const int* __restrict__ planes,
                       const int* __restrict__ q_bits, int* __restrict__ out,
                       int words, int hkv, int K, int L) {
  using namespace mp;
  extern __shared__ uint32_t qcode[];   // [G][L]
  __shared__ uint32_t s_once[kScanSlices][G][kWordsPerBlock];
  __shared__ uint32_t s_twice[kScanSlices][G][kWordsPerBlock];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wi = tid % kWordsPerBlock, slice = tid / kWordsPerBlock;
  const int w0 = blockIdx.x * kWordsPerBlock;
  const size_t head0 = static_cast<size_t>(b) * hkv * G + kh * G;   // b*Hq + kh*G

  load_qcodes(qcode, q_bits + head0 * L * K, G * L, K, tid, kScanThreads);
  __syncthreads();

  uint32_t once[G], twice[G];
  if (w0 + wi < words) {
    const int* pw = planes + (static_cast<size_t>(b) * hkv + kh) * L * K * words + w0 + wi;
    scan_tables<G>(pw, words, qcode, K, L, slice, kScanSlices, once, twice);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) once[g] = twice[g] = 0u;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s_once[slice][g][wi] = once[g];
    s_twice[slice][g][wi] = twice[g];
  }
  __syncthreads();
  for (int i = tid; i < G * kWordsPerBlock; i += kScanThreads) {
    const int g = i / kWordsPerBlock, j = i % kWordsPerBlock;
    if (w0 + j >= words) continue;
    uint32_t o = 0u, t = 0u;
    for (int s = 0; s < kScanSlices; ++s)
      merge_collisions(o, t, s_once[s][g][j], s_twice[s][g][j]);
    out[(head0 + g) * words + w0 + j] = static_cast<int>(t);
  }
}

template <int G>
int launch(const void* planes, const void* q_bits, void* out, int batch,
           int words, int hkv, int K, int L, cudaStream_t stream) {
  dim3 grid((words + kWordsPerBlock - 1) / kWordsPerBlock, hkv, batch);
  const size_t dyn = static_cast<size_t>(G) * L * sizeof(uint32_t);
  collision_words_kernel<G><<<grid, kScanThreads, dyn, stream>>>(
      static_cast<const int*>(planes), static_cast<const int*>(q_bits),
      static_cast<int*>(out), words, hkv, K, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes [B, Hkv, L, K, W] int32, q_bits [B, Hq, L, K] int32 0/1 ->
// out [B, Hq, W] int32.
extern "C" int mp_collision_words(const void* planes, const void* q_bits,
                                  void* out, int batch, int words, int hq,
                                  int hkv, int K, int L, void* stream) {
  if (hq % hkv != 0 || words < 1 || K < 1 || K > mp::kMaxK || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hq / hkv) {
    case 1: return launch<1>(planes, q_bits, out, batch, words, hkv, K, L, st);
    case 2: return launch<2>(planes, q_bits, out, batch, words, hkv, K, L, st);
    case 4: return launch<4>(planes, q_bits, out, batch, words, hkv, K, L, st);
    case 8: return launch<8>(planes, q_bits, out, batch, words, hkv, K, L, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
