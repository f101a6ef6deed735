// Standalone >=2-of-L collision scan: packed collision words of every query
// head, bit j of word w set iff key 32w + j collides with the query in at
// least two of the L tables; with a length, only the keys before it.
//
// Replaces both drop-in Pallas scans of the JAX package:
// magicpig_tpu/ops/pallas/collide.py::collision_words_pallas (pallas_call at
// collide.py:76, planes [B, Hkv, L, K, W]) and
// magicpig_tpu/ops/pallas/mask.py::collision_words_pallas (pallas_call at
// mask.py:87, the same planes viewed as [B, Hkv, L*K, W]); the flat layout
// makes them one function. With a length it also does the AND with the
// valid words that the JAX callers apply right after their scan
// (runtime/server.py:505-512, lsh_decode.py:353-358). Bit-exact: the result
// is made of bitwise operations only.
//
// Bound on the H100: device memory. Every plane word of the valid words is
// read once (K*L*4 bytes per 32 tokens and kv head, 188 bytes a token-head
// at K=10, L=150); the output is 1/(K*L) of that per head. Design: a block
// of 128 threads scans a tile of `block_words` words of one (request, kv
// head) through collide_common.cuh's ring (TMA boxes of whole tables into
// shared memory, matched there, the G heads of the group sharing every
// word read). A tile wholly past the length writes zeros and exits before
// reading anything; the tile that holds the length reads only its valid
// words. Tiles are small (16 words by default, `SCAN_WORDS`; 8, 32 and 64
// measured slower) so that several blocks share each SM (a 48 KB ring: four
// a SM) and the hardware's scheduler evens out requests of unequal length.
// Group sizes 1, 2, 3, 4 and 8 are exact instances; every other one takes
// the general tile (common.cuh, `Heads`): a block scans for at most 8 query
// heads of its kv head, so a group of 16 reads its kv head's planes twice.
#include "collide_common.cuh"

namespace {

constexpr int kScanThreads = 128;
constexpr int kRingBytes = 48 * 1024;

template <int G, bool kPart>
__global__ void __launch_bounds__(kScanThreads)
collision_words_kernel(const __grid_constant__ CUtensorMap map, int use_map,
                       const int* __restrict__ planes,
                       const int* __restrict__ q_bits,
                       const int* __restrict__ length, int* __restrict__ out,
                       int words, int hkv, int group, int K, int L, int nw,
                       int tables) {
  using namespace mp;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bar[kScanStages];

  const int b = blockIdx.z, tid = threadIdx.x;
  const Heads<G, kPart> hd(blockIdx.y, group);
  const int kh = hd.kh, gn = hd.gn;
  const int w0 = blockIdx.x * nw;
  const int len = length == nullptr ? words * 32
                                    : max(min(length[b], words * 32), 0);
  const int wlen = (len + 31) / 32;
  const int head = b * hkv + kh;
  const size_t head0 = hd.row(b, hkv);                  // b*Hq + kh*group + g0
  const int n_out = min(nw, words - w0);
  if (w0 >= wlen) {
    for (int i = tid; i < gn * n_out; i += kScanThreads)
      out[(head0 + i / n_out) * words + w0 + i % n_out] = 0;
    return;
  }

  ScanTile tile{};
  tile.map = use_map ? &map : nullptr;
  tile.rows = planes + static_cast<size_t>(head) * L * K * words;
  tile.q_bits = q_bits + head0 * L * K;
  tile.row0 = head * L * K;
  tile.words = words;
  tile.w0 = w0;
  tile.nw = nw;
  tile.wlen = wlen;
  tile.K = K;
  tile.L = L;
  tile.tables = tables;
  scan_begin<G, kScanThreads>(tile, ring, bar, tid, gn);
  uint32_t* part = reinterpret_cast<uint32_t*>(ring);
  scan_run<G, kScanThreads>(tile, ring, bar, part, tid, gn);
  for (int i = tid; i < gn * n_out; i += kScanThreads) {
    const int g = i / n_out, w = i % n_out;
    const uint32_t t = w0 + w < wlen
        ? scan_word<G, kScanThreads>(part, nw, g, w) & valid_bits(32 * (w0 + w), len)
        : 0u;
    out[(head0 + g) * words + w0 + w] = static_cast<int>(t);
  }
}

template <int G, bool kPart = false>
int launch(const void* planes, const void* q_bits, const void* length,
           void* out, int batch, int words, int hkv, int K, int L, int nw,
           cudaStream_t stream, int group = G) {
  static_assert(4 * kScanThreads * G * 4 <= kRingBytes, "partials fit the ring");
  const int tables = mp::scan_stage_tables(K, L, nw, G, kScanThreads, kRingBytes);
  if (tables < 1) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned smem_set = 0;   // the ring: above 48 KB
  auto* kernel = collision_words_kernel<G, kPart>;
  const cudaError_t err = hp::allow_smem(kernel, kRingBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA where its boxes fit (mp::scan_tma_fits); otherwise every tile comes
  // by cp.async.
  CUtensorMap map{};
  const int use_map = mp::scan_tma_fits(words, nw);
  if (use_map && !mp::scan_map(&map, planes, words, batch * hkv * L * K, nw, K,
                               tables))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = kPart ? mp::group_blocks(group, G) : 1;
  dim3 grid((words + nw - 1) / nw, hkv * blocks, batch);
  kernel<<<grid, kScanThreads, kRingBytes, stream>>>(
      map, use_map, static_cast<const int*>(planes),
      static_cast<const int*>(q_bits), static_cast<const int*>(length),
      static_cast<int*>(out), words, hkv, group, K, L, nw, tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes [B, Hkv, L, K, W] int32, q_bits [B, Hq, L, K] int32 0/1, length
// [B] int32 or null (every word) -> out [B, Hq, W] int32. block_words: words
// a block, a power of two from 1 to 64. hq: any multiple of hkv (the scan
// has no head dim; 1, 2, 3, 4 and 8 heads a kv head are exact instances).
extern "C" int mp_collision_words(const void* planes, const void* q_bits,
                                  const void* length, void* out, int batch,
                                  int words, int hq, int hkv, int K, int L,
                                  int block_words, void* stream) {
  if (hkv <= 0 || hq < hkv || hq % hkv != 0 || words < 1 || K < 1 || K > mp::kMaxK ||
      L < 1 || block_words < 1 || block_words > mp::kScanMaxWords ||
      (block_words & (block_words - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = block_words;
  switch (hq / hkv) {
    case 1: return launch<1>(planes, q_bits, length, out, batch, words, hkv, K, L, nw, st);
    case 2: return launch<2>(planes, q_bits, length, out, batch, words, hkv, K, L, nw, st);
    case 3: return launch<3>(planes, q_bits, length, out, batch, words, hkv, K, L, nw, st);
    case 4: return launch<4>(planes, q_bits, length, out, batch, words, hkv, K, L, nw, st);
    case 8: return launch<8>(planes, q_bits, length, out, batch, words, hkv, K, L, nw, st);
    default:   // the general tile
      return launch<mp::kGroupTile, true>(planes, q_bits, length, out, batch,
                                          words, hkv, K, L, nw, st, hq / hkv);
  }
}
