// The >=2-of-L SimHash collision scan over flat bit-plane signatures
// (ops/bitcodes.py), shared by the standalone scan (collision_words.cu) and
// the fused LSH decode (lsh_common.cuh), so that both run the same code.
//
// planes: [B, Hkv, L, K, W] int32, W = S/32 words; token t is bit t%32 of
// word t/32. For each query head g of a kv head's group the match word of
// table l is
//   match = AND_k (plane[l, k] XOR (q_bit[g, l, k] - 1)),
// and the tables fold into (once, twice) words through the associative
//   (o1, t1) + (o2, t2) = (o1 | o2, t1 | t2 | (o1 & o2)),
// so any split of the tables, odd L included, gives the same bits.
//
// A block scans one tile: nw words (a power of two up to 64) of one
// (request, kv head) through all L*K plane rows. Bound on the H100: device
// memory, every plane word of the tile read once (K*L*4 bytes a word). The
// design keeps bytes in flight, off every thread's chain of loads, and the
// matching short:
//  - The rows stream into a ring of kScanStages stages in shared memory, T
//    whole tables (T*K rows) a stage, each stage under an mbarrier, the
//    first stages issued at block start. A tile whose words are all valid
//    comes by one TMA box a stage (a tensor map over the planes viewed as
//    [B*Hkv*L*K, W] int32, box [T*K rows, nw words]), issued by one thread.
//    A tile that holds the request's last valid word, a tile under 4 words,
//    or planes whose rows TMA cannot stride (W % 4 != 0) come by cp.async
//    copies of the valid words only (16 bytes where a whole group is
//    valid, else 4), every thread's copies arriving on the stage's
//    mbarrier: no word at or past the valid ones is read.
//  - Each stage also brings the query bits of its tables for the G heads
//    (4-byte cp.async copies by every thread, on the same mbarrier; in the
//    fused kernel's general tile for its block's heads, up to 16, laid out
//    as the 4, 8, 12 or 16 heads it matches, `scan_tile_heads`), laid
//    out by (table, bit, head) and turned in place into flip words
//    (q_bit - 1) once the stage has landed: a head's match of a plane word
//    is one LOP3, one vector load gives a bit's flips for four heads (a
//    bit's three flips at G = 3 padded to four words, so that the load
//    stays 16-byte aligned), and no step at block start waits on the query
//    bits.
//  - A thread owns two words of a row and a slot of the tables (all K bits
//    of each, one 8-byte load a bit, the flips' load shared by both words);
//    a warp reads 32 consecutive words of two or more rows a load, the odd
//    slot of each pair walking its bits backwards so that the two rows sit
//    in different banks. Threads fold their tables into (once, twice)
//    registers; the partials merge in shared memory after the last stage.
// On the card (H100 80GB HBM3, 700 W; the standalone scan over 16384-token
// capacities, B=2, Hkv 8, K=10, L=150: 49 MB) the TMA ring alone streams
// the rows in 18.7 us (2.6 TB/s: rows of 64 bytes 2 KB apart) and the
// matching alone takes ~16 us; together ~21 (`PERF.md` §6).
#pragma once

#include "common.cuh"
#include "hopper_common.cuh"

namespace mp {

constexpr int kMaxK = 16;           // bits per table
constexpr int kScanStages = 3;      // ring depth
constexpr int kScanMaxWords = 64;   // words of a tile
constexpr int kScanMaxRows = 256;   // rows of a TMA box

// Words of a tile's row in shared memory: whole pairs (a thread matches two
// words at a time); TMA's rows (nw % 4 == 0) as they come.
__host__ __device__ inline int scan_row_words(int nw) { return nw < 2 ? 2 : nw; }

// Flip words a (table, bit) takes in a stage for G matched heads: G, padded
// to 4 at G = 3 so that load_flips reads them with one aligned 16-byte load.
__host__ __device__ constexpr int scan_flip_words(int G) { return G == 3 ? 4 : G; }

// The heads the fused LSH kernel's general tile matches for a group of
// `group` heads a kv head: its block's heads (at most kHeadTile) rounded up
// to whole 4-head flip vectors, so that a group of 3 matches 4 heads, 5 to
// 7 match 8 and 16 match 16.
__host__ __device__ inline int scan_tile_heads(int group) {
  const int g = group < kHeadTile ? group : kHeadTile;
  return (g + 3) / 4 * 4;
}

// Bytes of a stage's plane rows (a multiple of 16); its flip words follow.
__host__ __device__ inline int scan_rows_bytes(int K, int tables, int nw) {
  return (tables * K * scan_row_words(nw) * 4 + 15) / 16 * 16;
}

// Bytes of one stage of the ring, rows and flips (a multiple of 128, TMA's
// alignment).
__host__ __device__ inline int scan_stage_bytes(int K, int tables, int nw,
                                                int G) {
  return (scan_rows_bytes(K, tables, nw) + tables * K * scan_flip_words(G) * 4 +
          127) / 128 * 128;
}

// Tables a stage for a ring of `ring_bytes`, for a block of `threads`
// threads (2 * threads / row words table slots): as many as fit (at most a
// box's rows), a whole number of rounds of the slots where that leaves one,
// then evened out over the stages that L needs, so that the last box reads
// few rows past the kv head's. 0 if not even one fits.
__host__ __device__ inline int scan_stage_tables(int K, int L, int nw, int G,
                                                 int threads, int ring_bytes) {
  const int rw = scan_row_words(nw);
  int t = (ring_bytes - kScanStages * (128 + 16)) /
          (kScanStages * K * (rw + scan_flip_words(G)) * 4);
  t = t < kScanMaxRows / K ? t : kScanMaxRows / K;
  const int slots = 2 * threads / rw;
  if (t >= slots) t = t / slots * slots;
  if (t < 1) return 0;
  const int n = (L + t - 1) / t;
  return (L + n - 1) / n;
}

// Valid-token mask of a word whose first token is `first` (of [.., stop)).
__device__ __forceinline__ uint32_t valid_bits(int first, int stop) {
  const int n = min(max(stop - first, 0), 32);
  return n >= 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// (o, t) += (o2, t2), the associative merge of two table sets.
__device__ __forceinline__ void merge_collisions(uint32_t& o, uint32_t& t,
                                                 uint32_t o2, uint32_t t2) {
  t |= t2 | (o & o2);
  o |= o2;
}

// One block's tile and how its rows come.
struct ScanTile {
  const CUtensorMap* map;   // the planes as [B*Hkv*L*K, W] int32; null: no TMA
  const int* rows;          // the (request, kv head)'s first plane row
  const int* q_bits;        // its group's first head's bits, [G, L, K] 0/1
  int row0;                 // that row's index in the map
  int words;                // W
  int w0, nw;               // the tile's first word and its word count
  int wlen;                 // the request's valid words: none at or past is read
  int K, L, tables;         // tables: T a stage (scan_stage_tables)
};

// TMA when the map exists (scan_map) and every word of the tile is valid.
__device__ __forceinline__ bool scan_by_tma(const ScanTile& t) {
  return t.map != nullptr && t.w0 + t.nw <= t.wlen;
}

__device__ __forceinline__ int scan_stages(const ScanTile& t) {
  return (t.L + t.tables - 1) / t.tables;
}

// Issue stage `stage` into its slot of the ring (every thread calls it): the
// query bits of its tables at (table, bit, head) for the first `gn` heads
// (G for the exact instances; the general tile's heads past gn have no
// bits, and their words are garbage that the callers drop), then the rows,
// every thread's copies arriving on the stage's mbarrier. kByWord (the
// fused kernel's general tile): consecutive threads copy consecutive flip
// words, so that a warp's copies land in distinct banks (copying a head at
// a time, as the exact instances do, writes words scan_flip_words(G) apart:
// 16-way bank conflicts at 16 heads).
template <int G, int kThreads, bool kByWord = false>
__device__ __forceinline__ void scan_issue(const ScanTile& t, uint8_t* ring,
                                           uint64_t* bar, int stage, int tid,
                                           int gn) {
  constexpr int FW = scan_flip_words(G);
  const int slot = stage % kScanStages;
  uint8_t* dst = ring + slot * scan_stage_bytes(t.K, t.tables, t.nw, G);
  const int r0 = stage * t.tables * t.K;
  const int rows = min(t.tables * t.K, t.L * t.K - r0);
  uint8_t* fl = dst + scan_rows_bytes(t.K, t.tables, t.nw);
  if constexpr (kByWord) {
    for (int e = tid; e < rows * FW; e += kThreads) {
      const int i = e / FW, g = e % FW;
      if (g < gn)
        hp::cp_async_4(fl + 4 * e,
                       t.q_bits + static_cast<size_t>(g) * t.L * t.K + r0 + i);
    }
  } else {
    for (int g = 0; g < gn; ++g) {
      const int* q = t.q_bits + static_cast<size_t>(g) * t.L * t.K + r0;
      for (int i = tid; i < rows; i += kThreads)
        hp::cp_async_4(fl + 4 * (i * FW + g), q + i);
    }
  }
  if (scan_by_tma(t)) {
    if (tid == 0) {
      hp::mbar_arrive_expect_tx(&bar[slot], t.tables * t.K * t.nw * 4);
      hp::tma_load_2d(dst, t.map, t.w0, t.row0 + r0, &bar[slot]);
    }
    hp::cp_async_mbar_arrive_noinc(&bar[slot]);
    return;
  }
  // A thread keeps one column of 16-byte groups (where W and nw allow them)
  // or of words: the whole valid groups by 16-byte copies, the rest of the
  // valid words by 4-byte ones.
  const int nv = min(t.nw, t.wlen - t.w0);   // the tile's valid words, >= 1
  const int rw = scan_row_words(t.nw);
  const int* src = t.rows + static_cast<size_t>(r0) * t.words + t.w0;
  int done = 0;
  if (t.words % 4 == 0 && t.nw % 4 == 0) {
    const int ng = t.nw / 4, j = tid % ng;
    done = nv / 4 * 4;
    if (4 * j < done)
      for (int r = tid / ng; r < rows; r += kThreads / ng)
        hp::cp_async_16(dst + 16 * (r * ng + j), src + static_cast<size_t>(r) * t.words + 4 * j);
  }
  const int j = done + tid % t.nw;
  if (j < nv)
    for (int r = tid / t.nw; r < rows; r += kThreads / t.nw)
      hp::cp_async_4(dst + 4 * (r * rw + j), src + static_cast<size_t>(r) * t.words + j);
  hp::cp_async_mbar_arrive_noinc(&bar[slot]);
}

// Initialise the ring's mbarriers and issue its first stages: called by every
// thread at block start, before the rest of the block's set-up (which must
// end in a __syncthreads before scan_run).
template <int G, int kThreads, bool kByWord = false>
__device__ __forceinline__ void scan_begin(const ScanTile& t, uint8_t* ring,
                                           uint64_t* bar, int tid, int gn) {
  if (tid == 0) {
    for (int s = 0; s < kScanStages; ++s)   // every thread's copies, and TMA's
      hp::mbar_init(&bar[s], kThreads + (scan_by_tma(t) ? 1 : 0));
    hp::fence_barrier_init();
  }
  __syncthreads();
  const int n = min(kScanStages, scan_stages(t));
  for (int i = 0; i < n; ++i)
    scan_issue<G, kThreads, kByWord>(t, ring, bar, i, tid, gn);
}

// The G flip words of one (table, bit), in vector loads.
template <int G>
__device__ __forceinline__ void load_flips(const uint32_t* p, uint32_t (&f)[G]) {
  if constexpr (G == 1) {
    f[0] = p[0];
  } else if constexpr (G == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = v.x;
    f[1] = v.y;
  } else if constexpr (G == 3) {   // the padded fourth word unused
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
  } else {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  }
}

// Match and fold every table of the tile for HM heads (the stages' flip
// layout of scan_issue<HM>); on return the threads' (once, twice) partials
// are in `part`, laid out for G heads (G >= HM; at most 4 * kThreads * G
// words, which may overlay the ring), and visible to the whole block:
// scan_word<G> merges them.
template <int G, int kThreads, int HM = G, bool kByWord = false>
__device__ __forceinline__ void scan_run(const ScanTile& t, uint8_t* ring,
                                         uint64_t* bar, uint32_t* part,
                                         int tid, int gn) {
  // Thread (slot, pair): slot tid / (rw / 2) takes the tables l with
  // l % slots == slot, all K bits of its two words (one 8-byte load a bit,
  // the flips' vector load shared by both). A warp reads 32 consecutive
  // words of two or more rows a load; the odd slot of each pair of slots
  // walks its bits backwards, so that its row and the even slot's lie an
  // odd number of rows apart: in the other half of the banks.
  const int rw = scan_row_words(t.nw), lpr = rw / 2;
  const int pair = tid % lpr, slot = tid / lpr, slots = kThreads / lpr;
  const bool back = slot & 1;
  constexpr int FW = scan_flip_words(HM);
  const int xstep = back ? -rw : rw, fstep = back ? -FW : FW;
  const int stage_bytes = scan_stage_bytes(t.K, t.tables, t.nw, HM);
  const int rows_bytes = scan_rows_bytes(t.K, t.tables, t.nw);
  const int nst = scan_stages(t);
  uint32_t once[2][HM], twice[2][HM];
#pragma unroll
  for (int g = 0; g < HM; ++g) once[0][g] = once[1][g] = twice[0][g] = twice[1][g] = 0u;
  for (int i = 0; i < nst; ++i) {
    const int slot_i = i % kScanStages;
    uint8_t* stage = ring + slot_i * stage_bytes;
    uint32_t* flips = reinterpret_cast<uint32_t*>(stage + rows_bytes);
    const int l0 = i * t.tables, n = min(t.tables, t.L - l0);
    hp::mbar_wait(&bar[slot_i], (i / kScanStages) & 1);
    for (int e = tid; e < n * t.K * FW; e += kThreads) flips[e] -= 1u;  // q_bit - 1
    __syncthreads();
    const uint32_t* st = reinterpret_cast<const uint32_t*>(stage) + 2 * pair +
                         (back ? (t.K - 1) * rw : 0);
    const uint32_t* fl = flips + (back ? (t.K - 1) * FW : 0);
    for (int tt = ((slot - l0) % slots + slots) % slots; tt < n; tt += slots) {
      const uint32_t* xp = st + tt * t.K * rw;
      const uint32_t* fp = fl + tt * t.K * FW;
      uint32_t m0[HM], m1[HM];
#pragma unroll
      for (int g = 0; g < HM; ++g) m0[g] = m1[g] = 0xffffffffu;
#pragma unroll 2
      for (int k = 0; k < t.K; ++k) {
        const uint2 x = *reinterpret_cast<const uint2*>(xp);
        uint32_t f[HM];
        load_flips<HM>(fp, f);
#pragma unroll
        for (int g = 0; g < HM; ++g) {
          m0[g] &= x.x ^ f[g];
          m1[g] &= x.y ^ f[g];
        }
        xp += xstep;
        fp += fstep;
      }
#pragma unroll
      for (int g = 0; g < HM; ++g) {
        twice[0][g] |= once[0][g] & m0[g];
        once[0][g] |= m0[g];
        twice[1][g] |= once[1][g] & m1[g];
        once[1][g] |= m1[g];
      }
    }
    // The slot is free; the fused tile also orders its threads' reads (and
    // the flips' writes) before the next copies into it, TMA's async ones
    // among them, by a proxy fence.
    if constexpr (kByWord) hp::fence_proxy_async();
    __syncthreads();
    if (i + kScanStages < nst)
      scan_issue<HM, kThreads, kByWord>(t, ring, bar, i + kScanStages, tid,
                                        gn);
  }
#pragma unroll
  for (int g = 0; g < HM; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      part[(slot * G + g) * rw + 2 * pair + e] = once[e][g];
      part[((slots + slot) * G + g) * rw + 2 * pair + e] = twice[e][g];
    }
  __syncthreads();
}

// Head g's collision word w (< nw) of the tile: the partials merged.
template <int G, int kThreads>
__device__ __forceinline__ uint32_t scan_word(const uint32_t* part, int nw,
                                              int g, int w) {
  const int rw = scan_row_words(nw), slots = 2 * kThreads / rw;
  uint32_t o = 0u, t = 0u;
  for (int s = 0; s < slots; ++s)
    merge_collisions(o, t, part[(s * G + g) * rw + w],
                     part[((slots + s) * G + g) * rw + w]);
  return t;
}

// Whether TMA can bring tiles of nw words: rows and boxes 16-byte aligned.
inline bool scan_tma_fits(int words, int nw) { return words % 4 == 0 && nw % 4 == 0; }

// The tensor map of scan_issue, boxes of T*K rows by nw words; false when
// cuTensorMapEncodeTiled refuses it.
inline bool scan_map(CUtensorMap* map, const void* planes, int words,
                     int rows, int nw, int K, int tables) {
  return hp::int32_map_2d(map, planes, static_cast<uint64_t>(words),
                          static_cast<uint64_t>(rows),
                          static_cast<uint32_t>(nw),
                          static_cast<uint32_t>(tables * K));
}

}  // namespace mp
