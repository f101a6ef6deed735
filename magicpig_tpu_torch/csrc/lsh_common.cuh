// The LSH-sampled decode attend shared by the fused kernel (lsh_fused.cu:
// the collision scan in the same pass) and the two-stage kernel
// (lsh_masked.cu: the collision words precomputed). One template, one
// flag: kWords reads each head's selection words from a [B, Hq, S/32]
// int32 array; otherwise the block scans the signatures itself
// (collide_common.cuh). Everything after the selection is the same code:
// the length mask, the collision-probability debias, the softmax, the
// weighted V sum over the sampled rows only, the sampled count, and the
// merge of the splits.
//
// Head dims 16, 32, 64 and 128, both kernels, are instances of one
// template; a gathered row is d * 2 bytes of bf16 (d of int8; 16 bytes,
// one swizzled unit, for int8 at d = 16), and P.V gives each warp 8 or
// more output dims (d / 4 at 64 and 128; at d = 16 two warps take 8 each
// and the other two idle). Exact instances at group sizes 1, 2, 4 and 8 at
// head dims 64 and 128, and 3 (Llama-3.2-3B: 24 query heads over 8) at 128:
// every per-head loop runs to G, the P.V's and the merge's head rows past
// G are zero or unwritten, and the scan pads a bit's three flip words to
// four (collide_common.cuh). Every other form takes the general tile
// (common.cuh, `Heads`): an instance at G = kHeadTile = 16 whose block
// serves up to 16 query heads of its kv head, so that one block per
// (split, kv head, request) streams each signature plane word from device
// memory once for any group of up to 16 (more: ceil(G / 16) blocks). Its
// per-head loops run to the block's heads `gn` (the heads past it have no
// selection, sample nothing and write nothing); its scan matches gn heads
// rounded up to whole 4-head flip vectors (`with_tile_heads`: a group of 3
// pays for 4 heads, 5-7 for 8, 16 for 16; each count its own instance of
// the matching loop, picked at run time); P.V puts heads 8-15 on the
// fragments' rows 8-15; a pass gathers at most 128 rows (`LshSmem::kCap`),
// so that as many blocks share an SM as of the exact instances; and the
// debias form is read from the arguments (kAnyDebias), so that one
// instance a K/V type, head dim and kernel serves all three; the last
// block merges the splits in registers, four values a thread. Its work
// beside the bytes: the matching's 16 heads x L x K LOP3s a plane word at
// G = 16; on the card each block's serial chain of scan stages, passes and
// merge bounds it, not either count.
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
// Bound on the H100: device memory: the selection (words, or every
// signature word for the scan) and the K/V/norm rows that some head of the
// group sampled, 2-21% of the rows at the served K and L. Walking each
// split in 64-token tiles (zero-filling the unsampled rows, four barriers
// and a dependent load a tile, every (head, token) pair of a tile visited
// and a second launch for the merge) cost 10-30x that bound on the card;
// this design gathers. One block of 128 threads takes one split (`split`
// tokens, a power of two from 32 to 2048) of one (kv head, request):
//  - it gets the split's selection words (read, or scanned by the ring of
//    collide_common.cuh, whose stages overlay the gathered rows' buffer and
//    whose first TMA boxes leave before the query is loaded), ANDed with the
//    valid tokens; ORs them across the group's heads; and numbers the
//    sampled rows and each head's sampled pairs by prefix popcounts over
//    the words (warp scans);
//  - per pass of at most 160 rows (whole words; one pass unless nearly
//    every key is sampled), it writes the rows' token indices and each
//    head's pairs into shared memory (a thread a token, slots by
//    popcounts) and fetches exactly those K rows, V rows, norms and scales
//    in one batch of coalesced cp.async copies (nothing is zero-filled, no
//    unsampled row is read); it scores only the sampled (head, row) pairs,
//    laid out densely by head so that every lane that runs the debias has
//    a pair, takes one softmax per head over the pass (online across
//    passes) and runs P.V on mma.sync over the pass's rows (P dense per
//    head, bf16, zero where the head did not sample);
//  - a split that is its request's only one writes the output; otherwise
//    it writes its partial, and the last block of the (request, kv head)
//    to take a ticket (an atomic after __threadfence) brings the partials
//    into shared memory in batches, merges them by LSE and resets the
//    ticket to 0 for the next call: one launch a call.
#pragma once

#include <type_traits>

#include "collide_common.cuh"
#include "common.cuh"
#include "hopper_common.cuh"

namespace mp {

constexpr int kLshThreads = 128;
constexpr int kLshMaxWords = 64;       // words of a split: 2048 tokens
constexpr int kLshCap = 160;           // rows gathered a pass: a 512-token
                                       // split sampled up to 31% in one
constexpr float kPi = 3.14159265358979323846f;
constexpr float kDebiasEps = 1e-4f;
constexpr int kPolyTerms = 21;         // degree 20
constexpr int kMaxDynSmem = 227 * 1024;  // a block's most on the H100
constexpr int kScanRingBytes = 40 * 1024;  // the fused scan's ring: the size
                                           // of a pass's bf16 rows at d = 64

// Debias forms (LSHConfig.lsh_debias), a template parameter of the kernel;
// kAnyDebias: the form in LshArgs::debias (the general tile's instances).
enum Debias : int { kExact = 0, kPoly = 1, kNone = 2, kAnyDebias = 3 };

struct PolyCoef {
  float c[kPolyTerms];   // power basis, low degree first
};

// Arguments of one launch. Selection: planes [B, Hkv, L, K, S/32] and
// q_bits [B, Hq, L, K] for the scan (with the planes' tensor map when
// scan_tma is set, and scan_tables tables a ring stage), or words
// [B, Hq, S/32] (the other pointers null). k_scale, v_scale [B, Hkv, S]:
// int8 K/V only. Partials [nsplit, B * Hq] (part_o with d values a row);
// tickets [B * Hkv * blocks of heads], 0 between calls. group: query heads
// a kv head; debias: the form, read where the kernel's is kAnyDebias.
struct LshArgs {
  CUtensorMap plane_map;
  const void *q, *k, *v, *k_scale, *v_scale, *k_norm;
  const int *planes, *q_bits, *words, *length;
  float *part_o, *part_lse, *part_cnt, *out, *lse, *cnt;
  int* tickets;
  int batch, s_cap, hkv, group, debias, K, L, split, scan_tables, scan_tma;
  float sm_scale;
  PolyCoef poly;
};

// kScan: the fused kernel's, whose union also holds the scan's ring (the
// same 40 KB at both head dims; the rows' 80 KB of bf16 at d = 128 are the
// union's size there, in both kernels). kD: the head dim. kCap: rows
// gathered a pass, kLshCap but 128 for the general tile's 16 heads, so that
// as many of its blocks share an SM as of the exact instances' (two at
// rows of 256 bytes, ~99 KB each; three at d = 64, ~71 KB).
template <int G, typename T, bool kScan, int kD>
struct __align__(128) LshSmem {
  static constexpr int kRowBytes = kD * static_cast<int>(sizeof(T));
  static constexpr int kCap = G > 8 ? 128 : kLshCap;
  // The general tile's ring takes the whole union where the rows are
  // larger (64 KB at d = 128 in bf16): more tables a stage, fewer stages.
  static constexpr int kTileRing = 2 * kCap * kRowBytes;
  static constexpr int kRingBytes =
      !kScan ? 128
             : G > 8 && kTileRing > kScanRingBytes ? kTileRing
                                                   : kScanRingBytes;
  union {
    uint8_t ring[kRingBytes];          // the scan's stages (128-aligned)
    uint32_t scan_part[kScan ? 4 * kLshThreads * G : 1];  // then its
                                       // threads' partials
    struct {                           // a pass's gathered rows
      uint8_t k[kCap * kRowBytes];     // 16-byte units swizzled (k_unit)
      uint8_t v[kCap * kRowBytes];
    } rows;
  } u;
  float qf[G][kD];                     // raw query
  float ps[G * kCap];                  // the pass's pair scores, then p
  float knorm[kCap];
  float ksc[kCap];                     // int8 only
  float vsc[kCap];
  uint32_t sel[G][kLshMaxWords];       // sampled and valid tokens
  uint32_t any[kLshMaxWords];          // sampled by some head of the group
  int anybase[kLshMaxWords + 1];       // rows before each word
  int hbase[G][kLshMaxWords + 1];      // head g's pairs before each word
  uint16_t pslot[G][kCap];             // the pass's row of head g's pairs
  uint16_t rowtok[kCap];               // each gathered row's token - start
  uint32_t pdense[G][kCap / 2];        // the P.V operand, bf16 pairs: p of
                                       // head g at each of the pass's rows
  float qnorm[G], m[G], l[G], alpha[G];
  float cnt[G];                        // the merge's summed counts
  int off[G + 1];                      // the pass's pairs before head g
  int is_last;
  uint64_t scan_bar[kScanStages];      // the ring's stages
};

// Calls f(std::integral_constant<int, HM>{}) with the heads the general
// tile's scan matches for `group` heads a kv head (scan_tile_heads: 4, 8,
// 12 or 16): one instance of the matching a head count, so that a group
// of 3 pays for 4 heads and not 16.
template <typename F>
__device__ __forceinline__ void with_tile_heads(int group, F&& f) {
  switch (scan_tile_heads(group)) {
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 12: f(std::integral_constant<int, 12>{}); break;
    default: f(std::integral_constant<int, 16>{}); break;
  }
}

// Byte offset of 16-byte unit `unit` of gathered K row `row` (kUnits units
// a row, by the row's bytes: 4 for int8 at d = 64, 8 for bf16 at 64 and
// int8 at 128, 16 for bf16 at 128): within each 128-byte line the unit
// index is XORed with the line's index (rows of 4 units) or the row's
// (rows of 8 or more: a row spans kUnits / 8 lines), so that lanes reading
// the same unit of different rows hit distinct banks.
template <int kUnits>
__device__ __forceinline__ int k_unit(int row, int unit) {
  if constexpr (kUnits >= 8) {
    const int line = row * (kUnits / 8) + unit / 8;
    return line * 128 + 16 * ((unit & 7) ^ (row & 7));
  } else {
    const int lin = row * kUnits + unit, line = lin >> 3;
    return line * 128 + 16 * ((lin & 7) ^ (line & 7));
  }
}

// q . K for one gathered K row of kD values.
template <int kD>
__device__ __forceinline__ float key_dot(const uint8_t* kbuf, int row,
                                         const float* qg,
                                         const __nv_bfloat16*) {
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kD / 8; ++u)
    acc += dot8(*reinterpret_cast<const uint4*>(kbuf + k_unit<kD / 8>(row, u)),
                qg + 8 * u);
  return acc;
}
template <int kD>
__device__ __forceinline__ float key_dot(const uint8_t* kbuf, int row,
                                         const float* qg, const int8_t*) {
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kD / 16; ++u) {
    const uint4 x =
        *reinterpret_cast<const uint4*>(kbuf + k_unit<kD / 16>(row, u));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc = fmaf(static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)))),
                 qg[16 * u + i], acc);
  }
  return acc;
}

// A V element as the bits of a bf16 (int8 values are exact in bf16).
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bf16_bits(int8_t x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(x)));
}

// T: __nv_bfloat16, or int8_t with the row scales. kDebias: a Debias
// form. kWords: selection words given (else scanned from the planes). kD:
// the head dim. kPart: the general tile (mp::Heads).
template <int G, typename T, int kDebias, bool kWords, int kD,
          bool kPart = false>
__global__ void __launch_bounds__(kLshThreads)
lsh_split_kernel(const __grid_constant__ LshArgs a) {
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  using Smem = LshSmem<G, T, !kWords, kD>;
  constexpr int kRowBytes = Smem::kRowBytes;
  constexpr int kCap = Smem::kCap;
  constexpr int kUnits = kRowBytes / 16;
  constexpr int kWarps = kLshThreads / 32;
  // Warps of the P.V (two at d = 16) and their n-tiles of 8 output dims.
  constexpr int kPVWarps = kD / 8 < kWarps ? kD / 8 : kWarps;
  constexpr int kNT = kD / (8 * kPVWarps);
  extern __shared__ __align__(128) uint8_t lsh_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(lsh_smem);

  const int split = blockIdx.x, b = blockIdx.z;
  const Heads<G, kPart> hd(blockIdx.y, a.group);
  const int kh = hd.kh, gn = hd.gn;
  const int debias = kDebias == kAnyDebias ? a.debias : kDebias;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool pv_warp = kPVWarps == kWarps || warp < kPVWarps;
  const int K = a.K, L = a.L, s_cap = a.s_cap;
  const int nw = a.split / 32;
  const int hq = a.hkv * hd.group;
  const int words = s_cap / 32;
  const int len = min(a.length[b], s_cap);
  const int n_act = (len + a.split - 1) / a.split;   // splits with tokens
  const size_t row = hd.row(b, a.hkv);               // first head's
  if (split >= n_act) {
    if (split == 0)                                  // an empty request
      for (int i = tid; i < gn * kD; i += kLshThreads) {
        a.out[row * kD + i] = 0.f;
        if (i < gn) {
          a.lse[row + i] = kNegInf;
          a.cnt[row + i] = 0.f;
        }
      }
    return;
  }
  const int start = split * a.split;
  const int stop = min(len, start + a.split);

  // The scan's first stages leave before anything else is loaded.
  ScanTile tile{};
  if constexpr (!kWords) {
    const int head = b * a.hkv + kh;
    tile.map = a.scan_tma ? &a.plane_map : nullptr;
    tile.rows = a.planes + static_cast<size_t>(head) * L * K * words;
    tile.q_bits = a.q_bits + row * L * K;
    tile.row0 = head * L * K;
    tile.words = words;
    tile.w0 = start / 32;
    tile.nw = nw;
    tile.wlen = (len + 31) / 32;
    tile.K = K;
    tile.L = L;
    tile.tables = a.scan_tables;
    if constexpr (kPart)
      with_tile_heads(a.group, [&](auto hm) {
        scan_begin<decltype(hm)::value, kLshThreads, true>(
            tile, sm.u.ring, sm.scan_bar, tid, gn);
      });
    else
      scan_begin<G, kLshThreads>(tile, sm.u.ring, sm.scan_bar, tid, gn);
  }

  // Query: raw f32 values (the debias needs the unscaled dot) and norms;
  // the given words load beside them (the scan's query bits come with its
  // stages).
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  for (int i = tid; i < gn * kD; i += kLshThreads)
    sm.qf[i / kD][i % kD] = __bfloat162float(q[row * kD + i]);
  if constexpr (kWords) {
    for (int i = tid; i < gn * nw; i += kLshThreads) {
      const int g = i / nw, w = i % nw, first = start + 32 * w;
      uint32_t t = 0u;
      if (first < stop)
        t = static_cast<uint32_t>(a.words[(row + g) * words + first / 32]) &
            valid_bits(first, stop);
      sm.sel[g][w] = t;
    }
  }
  __syncthreads();
  for (int g = warp; g < gn; g += kWarps) {
    float x2 = 0.f;
#pragma unroll
    for (int j = lane; j < kD; j += 32) x2 += sm.qf[g][j] * sm.qf[g][j];
    const float s = warp_sum(x2);
    if (lane == 0) {
      sm.qnorm[g] = sqrtf(s);
      sm.m[g] = kNegInf;
      sm.l[g] = 0.f;
    }
  }

  // ---- the scan's selection words, ANDed with the split's valid tokens.
  if constexpr (!kWords) {
    if constexpr (kPart)
      with_tile_heads(a.group, [&](auto hm) {
        scan_run<G, kLshThreads, decltype(hm)::value, true>(
            tile, sm.u.ring, sm.scan_bar, sm.u.scan_part, tid, gn);
      });
    else
      scan_run<G, kLshThreads>(tile, sm.u.ring, sm.scan_bar, sm.u.scan_part,
                               tid, gn);
    for (int i = tid; i < gn * nw; i += kLshThreads) {
      const int g = i / nw, w = i % nw;
      sm.sel[g][w] = scan_word<G, kLshThreads>(sm.u.scan_part, nw, g, w) &
                     valid_bits(start + 32 * w, stop);
    }
    __syncthreads();
  }

  // ---- prefix popcounts over the words: list 0 the rows some head
  // sampled, list 1 + g head g's pairs; warp w scans lists w, w + 4, ...
  // side by side (independent shuffle chains).
  {
    constexpr int kLists = (G + kWarps) / kWarps;
    int carry[kLists];
#pragma unroll
    for (int i = 0; i < kLists; ++i) carry[i] = 0;
    for (int h = 0; 32 * h < nw; ++h) {
      const int w = lane + 32 * h;
      int c[kLists], inc[kLists];
#pragma unroll
      for (int i = 0; i < kLists; ++i) {
        const int li = warp + kWarps * i;
        uint32_t x = 0u;
        if (li <= gn && w < nw) {
          if (li == 0) {
#pragma unroll
            for (int g = 0; g < (kPart ? gn : G); ++g) x |= sm.sel[g][w];
            sm.any[w] = x;
          } else {
            x = sm.sel[li - 1][w];
          }
        }
        c[i] = inc[i] = __popc(x);
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < kLists; ++i) {
          const int y = __shfl_up_sync(0xffffffffu, inc[i], off);
          if (lane >= off) inc[i] += y;
        }
#pragma unroll
      for (int i = 0; i < kLists; ++i) {
        const int li = warp + kWarps * i;
        if (li <= gn && w < nw)
          (li == 0 ? sm.anybase : sm.hbase[li - 1])[w] = carry[i] + inc[i] - c[i];
        carry[i] += __shfl_sync(0xffffffffu, inc[i], 31);
      }
    }
#pragma unroll
    for (int i = 0; i < kLists; ++i) {
      const int li = warp + kWarps * i;
      if (li <= gn && lane == 0)
        (li == 0 ? sm.anybase : sm.hbase[li - 1])[nw] = carry[i];
    }
  }
  __syncthreads();

  // ---- passes of whole words, at most kCap rows each.
  const size_t head_off = (static_cast<size_t>(b) * a.hkv + kh) * s_cap;
  const uint8_t* k_h = static_cast<const uint8_t*>(a.k) + head_off * kRowBytes;
  const uint8_t* v_h = static_cast<const uint8_t*>(a.v) + head_off * kRowBytes;
  const float* n_h = static_cast<const float*>(a.k_norm) + head_off;
  const float* ks_h = kQ ? static_cast<const float*>(a.k_scale) + head_off : nullptr;
  const float* vs_h = kQ ? static_cast<const float*>(a.v_scale) + head_off : nullptr;
  const float fK = static_cast<float>(K), fL = static_cast<float>(L);
  // P.V on mma.sync: warp w owns output dims 8 kNT w .. 8 kNT (w + 1) - 1
  // (kNT n-tiles of 8); lane (r = lane / 4, t = lane % 4) accumulates heads
  // r and (kRows 4: the general tile's 16) r + 8 at dims 8 kNT w + 8nt + 2t
  // + {0, 1} (heads >= gn are zero rows of P).
  constexpr int kRows = G > 8 ? 4 : 2;
  const int pr = lane >> 2, pt = lane & 3;
  float acc[kNT][kRows] = {};

  for (int w0 = 0; w0 < nw;) {
    // The pass: words w0 .. w1 - 1, the longest run whose rows fit (the
    // fitting words after w0 form a prefix: a ballot counts them).
    const int r0 = sm.anybase[w0];
    int w1 = w0 + 1;
#pragma unroll
    for (int h = 0; h < kLshMaxWords / 32; ++h) {
      const int w = lane + 32 * h;
      w1 += __popc(__ballot_sync(0xffffffffu, w > w0 && w < nw &&
                                 sm.anybase[w + 1] - r0 <= kCap));
    }
    const int nr = sm.anybase[w1] - r0;
    if (nr == 0) {                                   // block-uniform
      w0 = w1;
      continue;
    }
    // The pass's rows in token order, and each head's pairs as rows: a
    // thread a token, its slot by popcounts below its bit.
    for (int t = 32 * w0 + tid; t < 32 * w1; t += kLshThreads) {
      const int w = t >> 5, bit = t & 31;
      const uint32_t below = (1u << bit) - 1u, any = sm.any[w];
      if ((any >> bit) & 1u) {
        const int slot = sm.anybase[w] - r0 + __popc(any & below);
        sm.rowtok[slot] = static_cast<uint16_t>(t);
#pragma unroll
        for (int g = 0; g < (kPart ? gn : G); ++g) {
          const uint32_t x = sm.sel[g][w];
          if ((x >> bit) & 1u)
            sm.pslot[g][sm.hbase[g][w] - sm.hbase[g][w0] + __popc(x & below)] =
                static_cast<uint16_t>(slot);
        }
      }
    }
    for (int i = tid; i < gn * kCap / 2; i += kLshThreads)
      (&sm.pdense[0][0])[i] = 0u;
    if (tid <= gn) {
      int o = 0;
      for (int g = 0; g < tid; ++g) o += sm.hbase[g][w1] - sm.hbase[g][w0];
      sm.off[tid] = o;
    }
    __syncthreads();

    // Fetch exactly those rows, coalesced: K (swizzled) and V units, norms,
    // scales.
    for (int c = tid; c < nr * 2 * kUnits; c += kLshThreads) {
      const int rr = c / (2 * kUnits), part = c % (2 * kUnits);
      const size_t tok = start + sm.rowtok[rr];
      if (part < kUnits)
        hp::cp_async_16(sm.u.rows.k + k_unit<kUnits>(rr, part),
                        k_h + tok * kRowBytes + 16 * part);
      else
        hp::cp_async_16(sm.u.rows.v + rr * kRowBytes + 16 * (part - kUnits),
                        v_h + tok * kRowBytes + 16 * (part - kUnits));
    }
    for (int rr = tid; rr < nr; rr += kLshThreads) {
      const size_t tok = start + sm.rowtok[rr];
      if (debias != kNone) hp::cp_async_4(&sm.knorm[rr], n_h + tok);
      if (kQ) {
        hp::cp_async_4(&sm.ksc[rr], ks_h + tok);
        hp::cp_async_4(&sm.vsc[rr], vs_h + tok);
      }
    }
    hp::cp_async_commit();
    hp::cp_async_wait<0>();
    __syncthreads();

    // Score the sampled pairs only, densely by head.
    const int np = sm.off[gn];
    for (int i = tid; i < np; i += kLshThreads) {
      int g = 0;
      while (g + 1 < gn && i >= sm.off[g + 1]) ++g;
      const int slot = sm.pslot[g][i - sm.off[g]];
      float raw = key_dot<kD>(sm.u.rows.k, slot, sm.qf[g],
                              static_cast<const T*>(nullptr));
      if constexpr (kQ) raw *= sm.ksc[slot];
      float log_w = 0.f;                       // the none form
      if (debias != kNone) {
        float c = raw / fmaxf(sm.qnorm[g] * sm.knorm[slot], 1e-20f);
        c = fminf(fmaxf(c, -1.f), 1.f);
        if (debias == kPoly) {
          log_w = a.poly.c[kPolyTerms - 1];
#pragma unroll
          for (int t = kPolyTerms - 2; t >= 0; --t)
            log_w = __fadd_rn(__fmul_rn(log_w, c), a.poly.c[t]);
        } else {
          const float u = powf(1.f - acosf(c) / kPi, fK);
          // w = P[>= 2 of L tables collide], without the cancellation of
          // 1 - (1-u)^(L-1) (1 + (L-1) u) (see ops/debias.py).
          const float log_miss = L > 1 ? (fL - 1.f) * log1pf(-u) : 0.f;
          const float w = -expm1f(log_miss + log1pf((fL - 1.f) * u));
          log_w = logf(w + kDebiasEps);
        }
      }
      sm.ps[i] = (raw * a.sm_scale - log_w) * kLog2e;
    }
    __syncthreads();

    // One softmax per head over the pass (log2 units), online across
    // passes. The P.V operand is p (times the V scale) rounded to bf16, as
    // the TPU kernel feeds its matrix unit, placed at its row in the head's
    // dense row of P; the row sum takes p unrounded.
    for (int g = warp; g < gn; g += kWarps) {
      const int o = sm.off[g], n = sm.off[g + 1] - o;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sm.ps[o + j]);
      mx = warp_max(mx);
      const float m_old = sm.m[g];
      const float mn = fmaxf(m_old, mx);
      const float mu = mn == kNegInf ? 0.f : mn;
      float sum = 0.f;
      __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(sm.pdense[g]);
      for (int j = lane; j < n; j += 32) {
        const float p = exp2f(sm.ps[o + j] - mu);
        const int slot = sm.pslot[g][j];
        sum += p;
        prow[slot] = __float2bfloat16_rn(kQ ? p * sm.vsc[slot] : p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = exp2f(m_old - mu);
        sm.alpha[g] = al;
        sm.l[g] = sm.l[g] * al + sum;
        sm.m[g] = mn;
      }
    }
    __syncthreads();

    // P.V: D[head, dim] += P[head, row] V[row, dim] over the pass's rows,
    // 16 a k-step (rows past nr read as zero).
    const T* vbuf = reinterpret_cast<const T*>(sm.u.rows.v);
    float d[kNT][4] = {};
    for (int k0 = 0; pv_warp && k0 < nr; k0 += 16) {
      const int ka = k0 + 2 * pt;
      uint32_t af[4] = {0u, 0u, 0u, 0u};     // rows past gn of P are zero
      if (pr < gn) {
        af[0] = sm.pdense[pr][ka / 2];
        af[2] = sm.pdense[pr][ka / 2 + 4];
      }
      if (G > 8 && pr + 8 < gn) {
        af[1] = sm.pdense[pr + 8][ka / 2];
        af[3] = sm.pdense[pr + 8][ka / 2 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = 8 * kNT * warp + 8 * nt + pr;
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = ka + (i & 1) + 8 * (i >> 1);
          v[i] = kr < nr ? bf16_bits(vbuf[kr * kD + n]) : 0u;
        }
        mma_bf16_16816(d[nt], af, v[0] | (v[1] << 16), v[2] | (v[3] << 16));
      }
    }
#pragma unroll
    for (int h = 0; h < kRows / 2; ++h)
      if (pr + 8 * h < gn) {
        const float al = sm.alpha[pr + 8 * h];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e)
            acc[nt][e] = acc[nt][e] * al + d[nt][e];
      }
    __syncthreads();
    w0 = w1;
  }

  // ---- the split's normalised output and natural-log LSE, per head.
  const size_t part = static_cast<size_t>(split) * a.batch * hq + row;
  float* o_dst = n_act == 1 ? a.out + row * kD : a.part_o + part * kD;
#pragma unroll
  for (int h = 0; h < kRows / 2; ++h) {
    const int hr = pr + 8 * h;
    if (hr < gn && pv_warp) {
      const float li = sm.l[hr];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(o_dst + hr * kD + 8 * kNT * warp + 8 * nt +
                                   2 * pt) =
            li > 0.f ? make_float2(acc[nt][2 * h] / li, acc[nt][2 * h + 1] / li)
                     : make_float2(0.f, 0.f);
    }
  }
  if (tid < gn) {
    const float li = sm.l[tid];
    const float lse = li > 0.f ? sm.m[tid] * kLn2 + logf(li) : kNegInf;
    const float cnt = static_cast<float>(sm.hbase[tid][nw]);
    if (n_act == 1) {
      a.lse[row + tid] = lse;
      a.cnt[row + tid] = cnt;
    } else {
      a.part_lse[part + tid] = lse;
      a.part_cnt[part + tid] = cnt;
    }
  }
  if (n_act == 1) return;

  // The last split of this (request, kv head) to finish merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ti = hd.slot(b, a.hkv);
    sm.is_last = atomicAdd(&a.tickets[ti], 1) == n_act - 1;
    if (sm.is_last) atomicExch(&a.tickets[ti], 0);
  }
  __syncthreads();
  if (!sm.is_last) return;
  __threadfence();
  const size_t stride = static_cast<size_t>(a.batch) * hq;
  if constexpr (kPart) {
    // The general tile's 16 heads: a register merge, four values a thread
    // by vector loads, 8 splits in flight, one pass with a running max (a
    // split with no sample has lse -inf: weight 0, a zero partial).
    for (int idx = tid; idx < gn * kD / 4; idx += kLshThreads) {
      const int g = 4 * idx / kD;
      const bool first = (4 * idx) % kD == 0;
      float mx = kNegInf, den = 0.f, cnt = 0.f, acc[4] = {};
#pragma unroll 8
      for (int sp = 0; sp < n_act; ++sp) {
        const size_t pi = sp * stride + row;
        const float ls = __ldcg(a.part_lse + pi + g);
        const float4 ov =
            __ldcg(reinterpret_cast<const float4*>(a.part_o + pi * kD) + idx);
        if (first) cnt += __ldcg(a.part_cnt + pi + g);
        const float nm = fmaxf(mx, ls);
        const float mu = nm == kNegInf ? 0.f : nm;
        const float keep = expf(mx - mu), w = expf(ls - mu);
        den = den * keep + w;
        acc[0] = acc[0] * keep + w * ov.x;
        acc[1] = acc[1] * keep + w * ov.y;
        acc[2] = acc[2] * keep + w * ov.z;
        acc[3] = acc[3] * keep + w * ov.w;
        mx = nm;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a.out[row * kD + 4 * idx + j] = den > 0.f ? acc[j] / den : 0.f;
      if (first) {
        a.lse[row + g] = den > 0.f ? mx + logf(den) : kNegInf;
        a.cnt[row + g] = cnt;
      }
    }
    return;
  }
  // The partials come into shared memory (the gathered rows' buffer, then
  // the scores') in batches of kBatch splits, one round trip each: a warp a
  // head takes the max of the batch's lse and weights each split by
  // exp(lse - max) once; each output value then sums its weighted partials
  // (a split with no sample has lse -inf: weight 0, a zero partial), and
  // the running sums rescale from batch to batch.
  constexpr int kAcc = (G * kD + kLshThreads - 1) / kLshThreads;
  constexpr int kFit = 2 * kCap * kRowBytes / (G * kD * 4);
  constexpr int kBatch = kFit < kCap / 2 ? kFit : kCap / 2;
  float* o_st = reinterpret_cast<float*>(sm.u.rows.k);
  float* w_st = sm.ps;                         // lse, then weights
  float* cnt_st = sm.ps + kBatch * G;
  float num[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) num[r] = 0.f;
  if (tid < G) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
    sm.cnt[tid] = 0.f;
  }
  for (int sp0 = 0; sp0 < n_act; sp0 += kBatch) {
    const int nsp = min(kBatch, n_act - sp0);
    for (int c = tid; c < nsp * gn * (kD / 4); c += kLshThreads) {
      const int sp = c / (gn * kD / 4), u = c % (gn * kD / 4);
      hp::cp_async_16(o_st + sp * G * kD + 4 * u,
                      a.part_o + ((sp0 + sp) * stride + row) * kD + 4 * u);
    }
    for (int c = tid; c < nsp * G; c += kLshThreads) {
      if (c % G >= gn) continue;
      const size_t pi = (sp0 + c / G) * stride + row + c % G;
      hp::cp_async_4(w_st + c, a.part_lse + pi);
      hp::cp_async_4(cnt_st + c, a.part_cnt + pi);
    }
    hp::cp_async_commit();
    hp::cp_async_wait<0>();
    __syncthreads();
    for (int g = warp; g < gn; g += kWarps) {
      float mx = kNegInf, cnt = 0.f;
      for (int sp = lane; sp < nsp; sp += 32) {
        mx = fmaxf(mx, w_st[sp * G + g]);
        cnt += cnt_st[sp * G + g];
      }
      mx = fmaxf(warp_max(mx), sm.m[g]);
      const float mu = mx == kNegInf ? 0.f : mx;
      float sum = 0.f;
      for (int sp = lane; sp < nsp; sp += 32) {
        const float wt = expf(w_st[sp * G + g] - mu);
        w_st[sp * G + g] = wt;
        sum += wt;
      }
      sum = warp_sum(sum);
      cnt = warp_sum(cnt);
      if (lane == 0) {
        const float keep = expf(sm.m[g] - mu);
        sm.alpha[g] = keep;
        sm.l[g] = sm.l[g] * keep + sum;
        sm.m[g] = mx;
        sm.cnt[g] += cnt;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kLshThreads;
      if (idx < gn * kD) {
        const int g = idx / kD;
        float x = num[r] * sm.alpha[g];
#pragma unroll 8
        for (int sp = 0; sp < nsp; ++sp)
          x = fmaf(w_st[sp * G + g], o_st[sp * G * kD + idx], x);
        num[r] = x;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int idx = tid + r * kLshThreads;
    if (idx < gn * kD) {
      const float den = sm.l[idx / kD];
      a.out[row * kD + idx] = den > 0.f ? num[r] / den : 0.f;
    }
  }
  if (tid < gn) {
    const float den = sm.l[tid];
    a.lse[row + tid] = den > 0.f ? sm.m[tid] + logf(den) : kNegInf;
    a.cnt[row + tid] = sm.cnt[tid];
  }
}

template <int G, typename T, int kDebias, bool kWords, int kD,
          bool kPart = false>
int launch_lsh(LshArgs a, cudaStream_t stream) {
  if constexpr (!kWords) {
    // The ring's stages, and a tensor map over the planes where TMA's boxes
    // fit (scan_tma_fits; otherwise every tile comes by cp.async).
    const int words = a.s_cap / 32, nw = a.split / 32;
    a.scan_tables = scan_stage_tables(a.K, a.L, nw,
                                      kPart ? scan_tile_heads(a.group) : G,
                                      kLshThreads,
                                      LshSmem<G, T, true, kD>::kRingBytes);
    if (a.scan_tables < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.scan_tma = scan_tma_fits(words, nw);
    if (a.scan_tma && !scan_map(&a.plane_map, a.planes, words,
                                a.batch * a.hkv * a.L * a.K, nw, a.K,
                                a.scan_tables))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // The scan's query codes grow with L: allow the card's most once.
  static unsigned smem_set = 0;
  const int dyn = static_cast<int>(sizeof(LshSmem<G, T, !kWords, kD>));
  auto* kernel = lsh_split_kernel<G, T, kDebias, kWords, kD, kPart>;
  const cudaError_t err = hp::allow_smem(kernel, kMaxDynSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = kPart ? group_blocks(a.group, G) : 1;
  dim3 grid((a.s_cap + a.split - 1) / a.split, a.hkv * blocks, a.batch);
  kernel<<<grid, kLshThreads, dyn, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The general tile of one K/V type (every group size, every debias form)
// at head dim d.
template <typename T, bool kWords>
int launch_lsh_part(int d, const LshArgs& a, cudaStream_t st) {
  switch (d) {
    case 16: return launch_lsh<kHeadTile, T, kAnyDebias, kWords, 16, true>(a, st);
    case 32: return launch_lsh<kHeadTile, T, kAnyDebias, kWords, 32, true>(a, st);
    case 64: return launch_lsh<kHeadTile, T, kAnyDebias, kWords, 64, true>(a, st);
    case 128: return launch_lsh<kHeadTile, T, kAnyDebias, kWords, 128, true>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The debias forms of one group size, K/V type and head dim.
template <int G, typename T, bool kWords, int kD>
int dispatch_lsh_debias(int debias, const LshArgs& a, cudaStream_t st) {
  switch (debias) {
    case kExact: return launch_lsh<G, T, kExact, kWords, kD>(a, st);
    case kPoly: return launch_lsh<G, T, kPoly, kWords, kD>(a, st);
    case kNone: return launch_lsh<G, T, kNone, kWords, kD>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Every form of one K/V type and head dim for g = hq / hkv heads a group
// (3 at head dim 128 only).
template <typename T, bool kWords, int kD>
int dispatch_lsh_group(int g, int debias, const LshArgs& a,
                       cudaStream_t st) {
  switch (g) {
    case 1: return dispatch_lsh_debias<1, T, kWords, kD>(debias, a, st);
    case 2: return dispatch_lsh_debias<2, T, kWords, kD>(debias, a, st);
    case 3:
      if constexpr (kD == 128)
        return dispatch_lsh_debias<3, T, kWords, kD>(debias, a, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: return dispatch_lsh_debias<4, T, kWords, kD>(debias, a, st);
    case 8: return dispatch_lsh_debias<8, T, kWords, kD>(debias, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forms of both kernels (dispatch_lsh_group<T, kWords, kD>), by K/V
// type and head dim, each compiled in its own source so that nvcc builds
// them side by side: lsh_fused.cu (bf16, d = 64), lsh_fused_int8.cu,
// lsh_fused_d128.cu and lsh_fused_int8_d128.cu; lsh_masked.cu (d = 64,
// bf16 and int8), lsh_masked_d128.cu and lsh_masked_int8_d128.cu.
int lsh_fused_bf16_d64(int g, int debias, const LshArgs& a, cudaStream_t st);
int lsh_fused_int8_d64(int g, int debias, const LshArgs& a, cudaStream_t st);
int lsh_fused_bf16_d128(int g, int debias, const LshArgs& a, cudaStream_t st);
int lsh_fused_int8_d128(int g, int debias, const LshArgs& a, cudaStream_t st);
int lsh_masked_bf16_d128(int g, int debias, const LshArgs& a, cudaStream_t st);
int lsh_masked_int8_d128(int g, int debias, const LshArgs& a, cudaStream_t st);
// The general tile (launch_lsh_part) at head dim d, in four more sources:
// lsh_fused_part.cu, lsh_fused_part_int8.cu, lsh_masked_part.cu and
// lsh_masked_part_int8.cu.
int lsh_fused_part_bf16(int d, const LshArgs& a, cudaStream_t st);
int lsh_fused_part_int8(int d, const LshArgs& a, cudaStream_t st);
int lsh_masked_part_bf16(int d, const LshArgs& a, cudaStream_t st);
int lsh_masked_part_int8(int d, const LshArgs& a, cudaStream_t st);

// Check the sizes, copy the polynomial (a host array of the 21
// coefficients, low degree first; debias 1 only) into the arguments, and
// launch the form for hq / hkv heads a group. k_scale and v_scale null:
// bf16 K/V; both set: int8. debias: 0 exact, 1 poly, 2 none. split: tokens
// a block, a power of two from 32 to 2048. head_dim: 16, 32, 64 or 128; hq
// any multiple of hkv (the exact instances, else the general tile).
template <bool kWords>
int launch_lsh_decode(LshArgs a, int hq, int head_dim, int debias,
                      const void* poly_coef, void* stream) {
  const bool quant = a.k_scale != nullptr;
  if (!head_dim_ok(head_dim) || a.hkv <= 0 || hq < a.hkv ||
      debias < kExact || debias > kNone ||
      hq % a.hkv != 0 || a.s_cap % 32 != 0 || a.K < 1 || a.K > kMaxK ||
      a.L < 1 || a.split < 32 || a.split > 32 * kLshMaxWords ||
      (a.split & (a.split - 1)) != 0 || a.tickets == nullptr ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr) ||
      (debias == kPoly) != (poly_coef != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch == 0 || a.s_cap == 0) return static_cast<int>(cudaSuccess);
  if (poly_coef != nullptr)
    for (int i = 0; i < kPolyTerms; ++i)
      a.poly.c[i] = static_cast<const float*>(poly_coef)[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / a.hkv;
  a.group = g;
  a.debias = debias;
  if (!exact_group(g, head_dim)) {
    if constexpr (kWords)
      return quant ? lsh_masked_part_int8(head_dim, a, st)
                   : lsh_masked_part_bf16(head_dim, a, st);
    return quant ? lsh_fused_part_int8(head_dim, a, st)
                 : lsh_fused_part_bf16(head_dim, a, st);
  }
  if constexpr (kWords) {
    if (head_dim == 128)
      return quant ? lsh_masked_int8_d128(g, debias, a, st)
                   : lsh_masked_bf16_d128(g, debias, a, st);
    return quant ? dispatch_lsh_group<int8_t, true, 64>(g, debias, a, st)
                 : dispatch_lsh_group<__nv_bfloat16, true, 64>(g, debias, a,
                                                                st);
  } else {
    if (head_dim == 128)
      return quant ? lsh_fused_int8_d128(g, debias, a, st)
                   : lsh_fused_bf16_d128(g, debias, a, st);
    return quant ? lsh_fused_int8_d64(g, debias, a, st)
                 : lsh_fused_bf16_d64(g, debias, a, st);
  }
}

}  // namespace mp
