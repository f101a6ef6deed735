// The block scorer's kernel and launch templates (block_score.cu: the
// design, the exact instances and the C entry; block_score_part.cu: the
// general tile's instances, compiled beside them).
#pragma once

#include <type_traits>

#include "block_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 32;      // keys a warp takes at a time
constexpr int kScPad = 36;         // staged score row stride (floats)

// A warp's stage: the tile's key rows, then their 32 f32 scales. Two
// stages for rows of 128 bytes or more (bf16 at d = 64; int8 and bf16 at
// d = 128), four for the narrower ones. bf16 at d = 128 (256-byte rows)
// takes 71 KB, above the 48 KB a block gets without the dynamic-size
// attribute (set at the first launch).
template <typename KT, int kD>
struct Ring {
  static constexpr int kRowBytes = mp::key_row_bytes<KT, kD>();
  static constexpr int kStages = kRowBytes >= 128 ? 2 : 4;
  static constexpr int kBytes = kTileKeys * kRowBytes + kTileKeys * 4;
  static constexpr int kSmem =
      kWarps * kStages * kBytes + kWarps * 8 * kScPad * 4;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory on the H100");
};

// kRank: mask at the length and store the block max (else score every
// token, store no block max; length and block_max are unused). kD: the
// head dim, 64 or 128 (the exact instances).
template <int G, typename KT, bool kStoreScores, bool kRank, int kD>
__global__ void __launch_bounds__(kThreads)
block_score_kernel(const __nv_bfloat16* __restrict__ q,
                   const KT* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const int* __restrict__ length,
                   float* __restrict__ scores,
                   float* __restrict__ block_max, int s_cap, int hkv,
                   int block_size, float sm_scale) {
  using namespace mp;
  using R = Ring<KT, kD>;
  constexpr bool kBf16 = std::is_same<KT, __nv_bfloat16>::value;
  constexpr int kDP = frag_dim(kD);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red[kWarps];

  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = kRank ? min(length[b], s_cap) : s_cap;
  const int t0 = blk * block_size;
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  float* sc = kStoreScores ? scores + head * G * s_cap : nullptr;

  if (t0 >= len) {
    if (kStoreScores)
      for (int i = tid; i < G * block_size; i += kThreads)
        sc[static_cast<size_t>(i / block_size) * s_cap + t0 +
           i % block_size] = kNegInf;
    if (tid == 0) block_max[head * nb + blk] = kNegInf;
    return;
  }
  const int stop = min(len, t0 + block_size);
  uint32_t qb[kDP / 16][2];
  load_q_frag<G, kD>(q + head * G * kD, sm_scale, lane, qb);

  const uint8_t* k_h = reinterpret_cast<const uint8_t*>(k) +
                       head * s_cap * R::kRowBytes;
  const float* ks_h = kBf16 ? nullptr : k_scale + head * s_cap;
  uint8_t* ring = smem + warp * R::kStages * R::kBytes;
  float* staged = reinterpret_cast<float*>(smem + kWarps * R::kStages * R::kBytes) +
                  warp * 8 * kScPad;
  // This warp's tiles: warp, warp + 4, ...; the first `nv` have a key
  // below the length.
  const int ntiles = block_size / kTileKeys;
  const int nvalid = (stop - t0 + kTileKeys - 1) / kTileKeys;
  const int mine = (ntiles - warp + kWarps - 1) / kWarps;
  const int nv = nvalid > warp ? (nvalid - warp + kWarps - 1) / kWarps : 0;

  auto fetch = [&](int j) {
    const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
    uint8_t* dst = ring + (j % R::kStages) * R::kBytes;
    constexpr int kUnits = R::kRowBytes / 16;
#pragma unroll
    for (int c = lane; c < kTileKeys * kUnits; c += 32) {
      const int r = c / kUnits, u = c % kUnits;
      const bool ok = tok0 + r < stop;
      const uint8_t* src = k_h +
          static_cast<size_t>(ok ? tok0 + r : tok0) * R::kRowBytes + 16 * u;
      hp::cp_async_16(dst + r * R::kRowBytes + 16 * (kBf16 ? u ^ (r & 1) : u),
                      src, ok);
    }
    if (!kBf16 && lane < kTileKeys / 4)
      hp::cp_async_16(dst + kTileKeys * R::kRowBytes + 16 * lane,
                      ks_h + tok0 + 4 * lane);
  };

  const int r = lane >> 2, t = lane & 3;
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < R::kStages - 1; ++j) {
    if (j < nv) fetch(j);
    hp::cp_async_commit();
  }
  for (int j = 0; j < nv; ++j) {
    if (j + R::kStages - 1 < nv) fetch(j + R::kStages - 1);
    hp::cp_async_commit();
    hp::cp_async_wait<R::kStages - 1>();
    __syncwarp();
    const uint8_t* st = ring + (j % R::kStages) * R::kBytes;
    const float* scl = reinterpret_cast<const float*>(st + kTileKeys * R::kRowBytes);
    const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int ka = 16 * m + r, kb = ka + 8;
      uint4 xa[kDP / 32], xb[kDP / 32];
      key_chunks<kD>(st + ka * R::kRowBytes, t, ka & 1, xa, k);
      key_chunks<kD>(st + kb * R::kRowBytes, t, kb & 1, xb, k);
      uint32_t wa[kDP / 8], wb[kDP / 8];
      key_words<kDP>(xa, t, wa, k);
      key_words<kDP>(xb, t, wb, k);
      float d[4];
      mma_scores<kDP>(wa, wb, qb, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? ka : kb, h = 2 * t + (i & 1);
        const float s = tok0 + key < stop
                            ? score_of(d[i], kBf16 ? 1.f : scl[key])
                            : kNegInf;
        if (h < G) {
          mx = fmaxf(mx, s);
          if (kStoreScores) staged[h * kScPad + key] = s;
        }
      }
    }
    if (kStoreScores) {
      __syncwarp();
      for (int c = lane; c < G * kTileKeys / 4; c += 32) {
        const int h = c / (kTileKeys / 4), p = c % (kTileKeys / 4);
        __stcs(reinterpret_cast<float4*>(
                   sc + static_cast<size_t>(h) * s_cap + tok0 + 4 * p),
               *reinterpret_cast<const float4*>(staged + h * kScPad + 4 * p));
      }
    }
    __syncwarp();
  }
  if (kStoreScores)   // this warp's tiles wholly past the length
    for (int j = nv; j < mine; ++j) {
      const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
      for (int c = lane; c < G * kTileKeys / 4; c += 32)
        *reinterpret_cast<float4*>(sc + static_cast<size_t>(c / (kTileKeys / 4)) *
                                            s_cap + tok0 + 4 * (c % (kTileKeys / 4))) =
            make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
    }
  if (!kRank) return;
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    block_max[head * nb + blk] = m;
  }
}

// ---- The general tile (block_score_part.cu): up to kHeadTile query heads
// of one kv head a block, one block per (ranking block, block of heads,
// request); so for every group of up to 16 heads K is read from device
// memory and widened once. One copy warp: its first lane brings the
// ranking block's K rows below the length, 64 at a time, and their row
// scales (the whole multiples of 4; a tail of 1-3 scales is read by the
// compute lanes themselves) by cp.async.bulk into a ring of stages
// (`TileRing`) under full and empty mbarriers. Four compute warps, each
// taking whole stages in turn (warp w the stages w, w + 4, ...: four
// independent row tiles of 16 keys, so that the wait and the release come
// once per 64 keys): every key pair's A words widened once, then one
// mma.sync a k-step for each n8 tile of heads (two above 8 heads), the
// query fragments of the block's heads loaded once into registers. The
// warp's lanes release the stage once their reads are done, behind a
// proxy fence (the order the decode tile needs, flash_decode.cu). The scores
// leave in the mma accumulator layout: each store instruction writes four
// heads' 8 consecutive keys, four whole 32-byte sectors, streaming. The
// block max spans the block's heads and keys; above 16 heads a kv head the
// blocks of heads combine theirs by an atomic max on a block max the
// wrapper sets to -inf (a max is exact in any order).
constexpr int kTileWarps = 4;                      // compute warps
constexpr int kTileThreads = (kTileWarps + 1) * 32;
constexpr int kTileRT = 4;                         // row tiles of 16 a stage
constexpr int kStageKeys = 16 * kTileRT;           // keys a stage
constexpr int kTileStages = 8;                     // at most

// Stages: two a compute warp (8) for rows of up to 128 bytes (a 512-key
// ranking block whole in the ring), one a warp (4) for the wider ones.
template <typename KT, int kD>
struct TileRing {
  static constexpr int kRowBytes = mp::key_row_bytes<KT, kD>();
  static constexpr int kStages = kRowBytes <= 128 ? 8 : 4;
  static constexpr int kKeys = kStageKeys * kRowBytes;   // then the scales
  static constexpr int kBytes = kKeys + kStageKeys * 4;
  static constexpr int kSmem = kStages * kBytes;
  static_assert(kKeys % 16 == 0 && kSmem <= 227 * 1024,
                "stages of whole 16-byte units in a block's shared memory");
};

// max(*p, x) stored at p by integer atomics, exact for every non-NaN
// float: a value with the sign bit clear orders as a signed integer, one
// with it set in reverse as an unsigned one (-0 included).
__device__ __forceinline__ void atomic_max_f32(float* p, float x) {
  if (!signbit(x))
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
}

// Variants as block_score_kernel's; kD 16, 32, 64 or 128; `group` query
// heads a kv head, blockIdx.y = kv head * ceil(group / 16) + block of
// heads (mp::Heads).
template <typename KT, bool kStoreScores, bool kRank, int kD>
__global__ void __launch_bounds__(kTileThreads)
block_score_tile_kernel(const __nv_bfloat16* __restrict__ q,
                        const KT* __restrict__ k,
                        const float* __restrict__ k_scale,
                        const int* __restrict__ length,
                        float* __restrict__ scores,
                        float* __restrict__ block_max, int s_cap, int hkv,
                        int group, int block_size, float sm_scale) {
  using namespace mp;
  using R = TileRing<KT, kD>;
  constexpr bool kBf16 = std::is_same<KT, __nv_bfloat16>::value;
  constexpr int kDP = frag_dim(kD);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kTileStages], empty[kTileStages];
  __shared__ float red[kTileWarps];

  const int blk = blockIdx.x, b = blockIdx.z, nb = gridDim.x;
  const Heads<kHeadTile, true> hd(blockIdx.y, group);
  const int gn = hd.gn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = kRank ? min(length[b], s_cap) : s_cap;
  const int t0 = blk * block_size;
  const size_t head = static_cast<size_t>(b) * hkv + hd.kh;
  float* sc = kStoreScores ? scores + hd.row(b, hkv) * s_cap : nullptr;
  float* bmax = kRank ? block_max + head * nb + blk : nullptr;

  if (t0 >= len) {              // every block of heads writes the same
    if (kStoreScores)
      for (int i = tid; i < gn * block_size; i += kTileThreads)
        sc[static_cast<size_t>(i / block_size) * s_cap + t0 +
           i % block_size] = kNegInf;
    if (kRank && tid == 0) *bmax = kNegInf;
    return;
  }
  const int stop = min(len, t0 + block_size);
  const int nstage = (stop - t0 + kStageKeys - 1) / kStageKeys;
  const uint8_t* k_h = reinterpret_cast<const uint8_t*>(k) +
                       head * s_cap * R::kRowBytes;
  const float* ks_h = kBf16 ? nullptr : k_scale + head * s_cap;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < R::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 32);               // the warp that takes it
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  float mx = kNegInf;
  if (warp == kTileWarps) {
    // Copy warp: the rows below the length only.
    if (lane == 0)
      for (int i = 0; i < nstage; ++i) {
        const int s = i % R::kStages;
        if (i >= R::kStages) hp::mbar_wait(&empty[s], (i / R::kStages - 1) & 1);
        const int tok0 = t0 + i * kStageKeys;
        const int n = min(kStageKeys, stop - tok0);
        const int n4 = kBf16 ? 0 : n & ~3;
        uint8_t* st = smem + s * R::kBytes;
        hp::mbar_arrive_expect_tx(&full[s], n * R::kRowBytes + n4 * 4);
        hp::bulk_load(st, k_h + static_cast<size_t>(tok0) * R::kRowBytes,
                      n * R::kRowBytes, &full[s]);
        if (n4 > 0) hp::bulk_load(st + R::kKeys, ks_h + tok0, n4 * 4, &full[s]);
      }
  } else {
    const int r = lane >> 2, t = lane & 3;
    uint32_t qb[2][kDP / 16][2];
    load_q_tiles<kD>(q + hd.row(b, hkv) * kD, sm_scale, lane, qb, gn);
    // The warp's stages (warp, warp + 4, ...) with kNT n8 tiles of heads (1
    // up to 8 heads, else 2), branch-free within a stage (rows past n
    // computed and masked), so that the four row tiles' chains interleave;
    // then the stages wholly past the length, whose scores it writes -inf.
    const auto consume = [&](auto nt_c) {
      constexpr int kNT = decltype(nt_c)::value;
      for (int i = warp; i < nstage; i += kTileWarps) {
        const int s = i % R::kStages;
        const int tok0 = t0 + i * kStageKeys;      // the stage's first key
        const int n = min(kStageKeys, stop - tok0);
        const int n4 = kBf16 ? 0 : n & ~3;
        // Scales of rows 16 rt + r (h 0) and + 8 (h 1); the tail rows past
        // the last whole 4 from device memory.
        float scl[kTileRT][2];
#pragma unroll
        for (int rt = 0; rt < kTileRT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = 16 * rt + r + 8 * h;
            scl[rt][h] = !kBf16 && key >= n4 && key < n
                             ? __ldg(ks_h + tok0 + key) : 1.f;
          }
        hp::mbar_wait(&full[s], (i / R::kStages) & 1);
        __syncwarp();   // the lanes leave the wait apart; mma.sync needs all
        const uint8_t* st = smem + s * R::kBytes;
        float d[kTileRT][2][4];
#pragma unroll
        for (int rt = 0; rt < kTileRT; ++rt) {
          const int ka = 16 * rt + r, kb = ka + 8; // the lane's stage rows
          uint4 xa[kDP / 32], xb[kDP / 32];
          key_chunks<kD>(st + ka * R::kRowBytes, t, 0, xa, k);
          key_chunks<kD>(st + kb * R::kRowBytes, t, 0, xb, k);
          uint32_t wa[kDP / 8], wb[kDP / 8];
          key_words<kDP>(xa, t, wa, k);
          key_words<kDP>(xb, t, wb, k);
          mma_scores_tiles<kDP, kNT>(wa, wb, qb, d[rt]);
          if (!kBf16) {
            const float* ss = reinterpret_cast<const float*>(st + R::kKeys);
            scl[rt][0] = ka < n4 ? ss[ka] : scl[rt][0];
            scl[rt][1] = kb < n4 ? ss[kb] : scl[rt][1];
          }
        }
        hp::fence_proxy_async();
        hp::mbar_arrive(&empty[s]);
#pragma unroll
        for (int rt = 0; rt < kTileRT; ++rt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2) {
              const int key = 16 * rt + r + 8 * (i2 >> 1);
              const int h = 8 * nt + 2 * t + (i2 & 1);
              const float x = key < n ? score_of(d[rt][nt][i2],
                                                 scl[rt][i2 >> 1])
                                      : kNegInf;
              if (h < gn) {
                mx = fmaxf(mx, x);
                if (kStoreScores)
                  __stcs(sc + static_cast<size_t>(h) * s_cap + tok0 + key, x);
              }
            }
      }
    };
    if (gn > 8)
      consume(std::integral_constant<int, 2>{});
    else
      consume(std::integral_constant<int, 1>{});
    if (kStoreScores)
      for (int i = nstage + (warp - nstage % kTileWarps + kTileWarps) %
                                kTileWarps;
           i < block_size / kStageKeys; i += kTileWarps) {
        const int tok0 = t0 + i * kStageKeys;
#pragma unroll
        for (int rt = 0; rt < kTileRT; ++rt)
#pragma unroll
          for (int h = 2 * t; h < kHeadTile; h += 8)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (h + e < gn) {
                float* row = sc + static_cast<size_t>(h + e) * s_cap + tok0 +
                             16 * rt + r;
                __stcs(row, kNegInf);
                __stcs(row + 8, kNegInf);
              }
      }
  }
  if (!kRank) return;
  if (warp < kTileWarps) {
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) m = fmaxf(m, red[w]);
    if (group > kHeadTile)
      atomic_max_f32(bmax, m);
    else
      *bmax = m;
  }
}

// One variant of `kernel` (a block_score_kernel or block_score_tile_kernel
// instance) on grid (ranking blocks, hkv * blocks, batch), its shared
// memory allowed at its first launch (bf16 at d = 128 needs more than the
// default 48 KB).
template <typename KT, typename Kernel, typename... Extra>
int launch_kernel(Kernel* kernel, unsigned& smem_set, int smem, int threads,
                  int blocks, const void* q, const void* k,
                  const void* k_scale, const void* length, void* scores,
                  void* block_max, int batch, int s_cap, int hkv,
                  int block_size, float sm_scale, cudaStream_t stream,
                  Extra... extra) {
  const cudaError_t err = hp::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(s_cap / block_size, hkv * blocks, batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const float*>(k_scale), static_cast<const int*>(length),
      static_cast<float*>(scores), static_cast<float*>(block_max), s_cap,
      hkv, extra..., block_size, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int G, typename KT, bool kStoreScores, bool kRank, int kD>
int launch_variant(const void* q, const void* k, const void* k_scale,
                   const void* length, void* scores, void* block_max,
                   int batch, int s_cap, int hkv, int block_size,
                   float sm_scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_kernel<KT>(
      block_score_kernel<G, KT, kStoreScores, kRank, kD>, smem_set,
      Ring<KT, kD>::kSmem, kThreads, 1, q, k, k_scale, length, scores,
      block_max, batch, s_cap, hkv, block_size, sm_scale, stream);
}

template <typename KT, bool kStoreScores, bool kRank, int kD>
int launch_tile_variant(int group, const void* q, const void* k,
                        const void* k_scale, const void* length,
                        void* scores, void* block_max, int batch, int s_cap,
                        int hkv, int block_size, float sm_scale,
                        cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_kernel<KT>(
      block_score_tile_kernel<KT, kStoreScores, kRank, kD>, smem_set,
      TileRing<KT, kD>::kSmem, kTileThreads,
      mp::group_blocks(group, mp::kHeadTile), q, k, k_scale, length, scores,
      block_max, batch, s_cap, hkv, block_size, sm_scale, stream, group);
}

// The variant that `scores` and `block_max` ask for (either may be null).
template <int G, typename KT, int kD>
int launch(const void* q, const void* k, const void* k_scale,
           const void* length, void* scores, void* block_max, int batch,
           int s_cap, int hkv, int block_size, float sm_scale,
           cudaStream_t stream) {
  if (block_max == nullptr)
    return launch_variant<G, KT, true, false, kD>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  if (scores != nullptr)
    return launch_variant<G, KT, true, true, kD>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  return launch_variant<G, KT, false, true, kD>(
      q, k, k_scale, length, nullptr, block_max, batch, s_cap, hkv,
      block_size, sm_scale, stream);
}

// The general tile's variant that `scores` and `block_max` ask for.
template <typename KT, int kD>
int launch_tile(int group, const void* q, const void* k, const void* k_scale,
                const void* length, void* scores, void* block_max, int batch,
                int s_cap, int hkv, int block_size, float sm_scale,
                cudaStream_t stream) {
  if (block_max == nullptr)
    return launch_tile_variant<KT, true, false, kD>(
        group, q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  if (scores != nullptr)
    return launch_tile_variant<KT, true, true, kD>(
        group, q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  return launch_tile_variant<KT, false, true, kD>(
      group, q, k, k_scale, length, nullptr, block_max, batch, s_cap, hkv,
      block_size, sm_scale, stream);
}

}  // namespace

namespace mp {

// The general tile of every K kind and head dim (block_score_part.cu): k_kind
// a KeyKind (packed int4 at d = 64 and 128 only), `group` query heads a kv
// head; the other arguments as mp_block_score's (above 16 heads a kv head
// block_max must hold -inf at the call).
int block_score_part(int k_kind, int head_dim, int group, const void* q,
                     const void* k, const void* k_scale, const void* length,
                     void* scores, void* block_max, int batch, int s_cap,
                     int hkv, int block_size, float sm_scale,
                     cudaStream_t st);

}  // namespace mp
