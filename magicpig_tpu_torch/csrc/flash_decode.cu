// Split-sequence flash decode with LSE export, its splits merged in the
// same launch.
//
// Replaces magicpig_tpu/ops/pallas/decode.py::flash_decode (the pallas_call
// at decode.py:184), bf16 K/V, or int8 K/V with per-token f32 scales (its
// quant=True form). One query per request attends the cache rows
// [start[b], length[b]) (start null: 0; a sliding window's lower bound,
// which the JAX package applies as a mask over the whole prefix); the G
// query heads of a kv head share every K/V read; fully masked rows give out
// 0 and lse -inf.
//
// Bound on the H100: reading K and V once, 256 bytes per token and kv head
// at d = 64 in bf16 (512 at d = 128), 136 in int8 (rows and scales; 264 at
// d = 128), over 3.35 TB/s; the arithmetic is 2 G flops per byte, at the
// CUDA cores' ridge by G = 16. Head dims 16, 32, 64 and 128, bf16 and
// int8, are instances of one template (an int8 row at d = 128 is 128
// bytes, as a bf16 one at d = 64: the same ring). Group sizes: the exact
// instances (SIMT, below) and the general tile (common.cuh, `Heads`: a
// block takes up to 16 query heads of its kv head on the M rows of
// mma.sync, `tile_warp`; the heads past `gn` hold a zero query and write
// nothing; a ticket per block of heads), so that K and V are read once per
// kv head for every group of up to 16. Design, one block per (split, kv
// head, request) (and block of heads), the split size chosen by the
// wrapper from the capacity and the SM count (`chunk`, a multiple of 64
// tokens):
//  - one copy warp: its first lane brings each 64-token tile of K and V
//    (contiguous in the [B, Hkv, S, d] layout: 8 KB each in bf16 at d = 64,
//    16 KB at d = 128, 4 KB in int8 at d = 64 and 8 KB at 128) with
//    cp.async.bulk into a three-stage
//    ring, only the rows in [start, length): tiles wholly before start are
//    never copied, and the tile that holds start is copied from that row
//    on; it signals a full mbarrier per stage;
//  - four compute warps, 16 tokens of each tile each, no block barrier per
//    tile (the general tile: `tile_warp`). Exact instances: a lane holds 8
//    dims of one token (16-byte shared loads, 32 / (d
//    / 8) tokens a pass, conflict-free), the G scores are reduced over the
//    d / 8 lanes of a token, the online softmax is per warp in registers
//    (log2 units) over 4 passes at a time (so that the scores of a pass
//    group take as many registers at d = 128 as at d = 64), and each warp
//    releases the stage on its empty mbarrier; rows outside [start, length)
//    are never read from device memory, and their scores and V values are
//    selected away, not multiplied (stale shared memory may hold NaNs);
//  - int8 rows are widened in registers; the K scale multiplies the score
//    and the V scale the probability, which is rounded to bf16 as the TPU
//    kernel's P.V operand is (the row sums take it unrounded);
//  - the four warps' states meet once in shared memory; a split that is
//    the request's only one writes out and lse directly; otherwise it
//    writes its partial, and the last block of the (request, kv head) to
//    take a ticket (an atomic after __threadfence) merges the partials by
//    LSE and resets the ticket to 0 for the next call. So one launch per
//    call, and no memset;
//  - the active splits of a request are those that hold a row of [start,
//    length): a split wholly before start returns at once, as one past the
//    length does, writes no partial and takes no ticket, so the merge never
//    sees it; the active ones number their partials from 0. An empty
//    range (start >= length) gives out 0 and lse -inf.
#include <type_traits>

#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kTile = 64;             // tokens per copy
constexpr int kStages = 3;
constexpr int kWarps = 4;             // compute warps; one more copies
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kGroupPasses = 4;       // passes a softmax update takes

template <typename T, int kD>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * kD * static_cast<int>(sizeof(T));
}

template <typename T, int kD>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * kStages * tile_bytes<T, kD>();
}

// Eight consecutive elements of a row as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// int8 to f32 on the full-rate units: byte b + 128 placed in the mantissa
// of 2^23 gives 2^23 + 128 + b exactly; one byte permute and one add.
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = __uint_as_float(
               __byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i & 3))) -
           8388736.f;
}

// ---- The general tile: up to mp::kHeadTile (16) query heads of one kv
// head on the M rows of mma.sync.m16n8k16, rows past `gn` zero. Lane (g =
// lane / 4, t = lane % 4) holds rows g and g + 8 of each fragment. A warp
// takes 16 tokens of each 64-token tile (two n-tiles of 8):
//  - S = Q K^T: Q is the A operand, in registers from the start; K is the B
//    operand as the stage holds it (rows as they came, unswizzled). The
//    dot product does not care which dims meet at which k, so A's k columns
//    take the dims that B's k rows hold (`TileShape::dims`): lane (g, t)
//    reads chunks 4c + t (16 bytes, less in rows under 64 bytes) of token
//    g's row, and no transpose is needed. Where a row spans 128 bytes or
//    more, odd tokens read their chunks in swapped pairs, so that the eight
//    lanes of a 16-byte load phase hit distinct banks. int8 K widens to
//    bf16 exactly; the K scale multiplies the score columns.
//  - the online softmax per row across the lane quad that holds it (log2
//    units); columns outside [start, length) selected to -inf.
//  - P (times the V scale for int8), rounded to bf16, is the A operand of
//    P.V where the S accumulators lie (n-tiles 0 and 1: k = tokens 0-7 and
//    8-15). V is the B operand, whose k pairs are two tokens of one dim: lane
//    (g, t) reads column group g (dims g d/8 .. (g + 1) d/8 - 1) of its four
//    tokens 2t, 2t + 1, 2t + 8, 2t + 9 and pairs them by byte permutes
//    (bf16) or conversions (int8); output n-tile nt, column n is dim
//    n d/8 + nt, so the lane's accumulators hold rows g and g + 8 at the
//    dims of column groups 2t and 2t + 1. These loads share banks four ways
//    (four tokens of one column group); the kernel needs a fraction of the
//    SM's shared-memory rate at the HBM rate. bf16 V rows outside [start,
//    length) are zeroed in registers (stale shared memory may hold NaNs).
// The lanes reconverge after each stage's wait (they leave it apart, and
// mma.sync needs the whole warp); each lane releases the stage itself,
// after a proxy fence that orders its reads before the copy warp's next
// bulk copy into it. The warps' states meet over the ring once every warp
// is done with it.
template <typename T, int kD>
struct TileShape {
  static constexpr int kRowBytes = kD * static_cast<int>(sizeof(T));
  static constexpr int kW = kRowBytes / 4 < 16 ? kRowBytes / 4 : 16;  // chunk
  static constexpr int kE = kW / static_cast<int>(sizeof(T));  // its dims
  static constexpr int kSPC = kE / 4;          // its k-steps
  static constexpr int kKS = kD / 16;          // k-steps of S
  static constexpr int kChunks = kKS / kSPC;   // chunks of a row a lane reads
  static constexpr int kCG = kRowBytes / 8;    // bytes of a column group
  static constexpr int kNT = kD / 8;           // n-tiles of P.V
};

// N bytes (2, 4, 8 or a multiple of 16, aligned) of shared memory as words.
template <int N>
__device__ __forceinline__ void lds_words(const uint8_t* p,
                                          uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// Signed byte i of w as f32, exactly (load8's byte permute and add).
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return __uint_as_float(
             __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540u | i)) -
         8388736.f;
}

// A compute warp of the general tile over the block's tiles; leaves its
// (m, l) per head in red_m, red_l [kWarps][16] and its unnormalised output
// in red_o [kWarps][16][kD], which overlays the ring.
template <typename T, int kD>
__device__ __forceinline__ void tile_warp(
    const __nv_bfloat16* __restrict__ q, size_t row, int gn,
    const uint8_t* k_s, const uint8_t* v_s, uint64_t* full, uint64_t* empty,
    const float* ks_h, const float* vs_h, int start, int lo, int stop,
    int ntiles, float scale_log2, int warp, int lane, float* red_m,
    float* red_l, float* red_o) {
  using S = TileShape<T, kD>;
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  constexpr int kTileBytes = tile_bytes<T, kD>();
  constexpr int kVW = (S::kCG + 3) / 4;
  const int g = lane >> 2, t = lane & 3;
  // Q's A fragments: k-step j holds dims dd + {0, 1} (k = 2t, 2t + 1) and
  // dd + {2, 3} (k = 2t + 8, 2t + 9) of heads g and g + 8.
  uint32_t qa[S::kKS][4];
#pragma unroll
  for (int j = 0; j < S::kKS; ++j) {
    const int dd = S::kE * (4 * (j / S::kSPC) + t) + 4 * (j % S::kSPC);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 x = make_uint2(0u, 0u);
      if (g + 8 * h < gn)
        x = *reinterpret_cast<const uint2*>(q + (row + g + 8 * h) * kD + dd);
      qa[j][h] = x.x;
      qa[j][2 + h] = x.y;
    }
  }
  float m[2] = {mp::kNegInf, mp::kNegInf}, l[2] = {0.f, 0.f};
  float acc[S::kNT][4];
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bool sw = S::kChunks > 1 && (g & 1);    // odd tokens: pairs swapped

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const int t0 = start + i * kTile + 16 * warp;   // the warp's first token
    // The lane's columns: tokens 8 nt + 2t + e of the warp's 16.
    bool valid[2][2];
    float ksc[2][2], vsc[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tt = t0 + 8 * nt + 2 * t + e;
        valid[nt][e] = tt >= lo && tt < stop;
        ksc[nt][e] = kQ && valid[nt][e] ? __ldg(ks_h + tt) : 1.f;
        vsc[nt][e] = kQ && valid[nt][e] ? __ldg(vs_h + tt) : 1.f;
      }
    hp::mbar_wait(&full[s], (i / kStages) & 1);
    __syncwarp();       // the lanes leave the wait apart; mma.sync needs all
    const uint8_t* kt = k_s + s * kTileBytes + 16 * warp * S::kRowBytes;
    const uint8_t* vt = v_s + s * kTileBytes + 16 * warp * S::kRowBytes;

    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t kw[S::kChunks][S::kW / 4];
      const uint8_t* kr = kt + (8 * nt + g) * S::kRowBytes + S::kW * t;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        lds_words<S::kW>(kr + 4 * S::kW * (c ^ (sw ? 1 : 0)), kw[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
        const int cs = S::kChunks > 1 ? (c ^ 1) : c;   // where chunk c landed
#pragma unroll
        for (int sp = 0; sp < S::kSPC; ++sp) {
          uint32_t b0, b1;
          if constexpr (kQ) {
            const uint32_t w = sw ? kw[cs][sp] : kw[c][sp];
            b0 = mp::pack_f32_as_bf16(i8_at(w, 0), i8_at(w, 1));
            b1 = mp::pack_f32_as_bf16(i8_at(w, 2), i8_at(w, 3));
          } else {
            b0 = sw ? kw[cs][2 * sp] : kw[c][2 * sp];
            b1 = sw ? kw[cs][2 * sp + 1] : kw[c][2 * sp + 1];
          }
          mp::mma_bf16_16816(sc[nt], qa[c * S::kSPC + sp], b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kQ ? sc[nt][e] * ksc[nt][e & 1] : sc[nt][e];
        sc[nt][e] = valid[nt][e & 1] ? x * scale_log2 : mp::kNegInf;
      }
    // Online softmax of rows g (r = 0) and g + 8 (r = 1) over the quad.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                       fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == mp::kNegInf ? 0.f : mn;
      const float al = hp::ex2(m[r] - mu);
      m[r] = mn;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = hp::ex2(sc[nt][2 * r + e] - mu);
          sc[nt][2 * r + e] = p;
          ps += p;
        }
      l[r] = l[r] * al + ps;                      // the lane's columns
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt) {
        acc[nt][2 * r] *= al;
        acc[nt][2 * r + 1] *= al;
      }
    }
    // The TPU kernel's P.V operand: p (times the V scale) in bf16.
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p0 = sc[nt][2 * r], p1 = sc[nt][2 * r + 1];
        if constexpr (kQ) {
          p0 *= vsc[nt][0];
          p1 *= vsc[nt][1];
        }
        pa[2 * nt + r] = mp::pack_f32_as_bf16(p0, p1);
      }
    uint32_t vw[4][kVW];                          // tokens 8 nt + 2t + e
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lds_words<S::kCG>(vt + (8 * nt + 2 * t + e) * S::kRowBytes + S::kCG * g,
                          vw[2 * nt + e]);
        if constexpr (!kQ)
#pragma unroll
          for (int w = 0; w < kVW; ++w)
            vw[2 * nt + e][w] = valid[nt][e] ? vw[2 * nt + e][w] : 0u;
      }
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt) {
      uint32_t b0, b1;
      if constexpr (kQ) {
        b0 = mp::pack_f32_as_bf16(i8_at(vw[0][nt / 4], nt % 4),
                                  i8_at(vw[1][nt / 4], nt % 4));
        b1 = mp::pack_f32_as_bf16(i8_at(vw[2][nt / 4], nt % 4),
                                  i8_at(vw[3][nt / 4], nt % 4));
      } else {
        const uint32_t sel = nt & 1 ? 0x7632u : 0x5410u;
        b0 = __byte_perm(vw[0][nt / 2], vw[1][nt / 2], sel);
        b1 = __byte_perm(vw[2][nt / 2], vw[3][nt / 2], sel);
      }
      mp::mma_bf16_16816(acc[nt], pa, b0, b1);
    }
    // Each lane releases the stage after its own reads, ordered before the
    // copy warp's next bulk copy into it (an async-proxy write) by the proxy
    // fence: without it repeated calls differed in a few outputs.
    hp::fence_proxy_async();
    hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hp::named_barrier(1, kWarps * 32);   // every compute warp is done with
                                       // the ring
  const int h0 = mp::kHeadTile * warp + g;
  if (t == 0) {
    red_m[h0] = m[0];
    red_m[h0 + 8] = m[1];
    red_l[h0] = l[0];
    red_l[h0 + 8] = l[1];
  }
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dim = (2 * t + e) * S::kNT + nt;
      red_o[h0 * kD + dim] = acc[nt][e];
      red_o[(h0 + 8) * kD + dim] = acc[nt][2 + e];
    }
}

// The last block's merge of its request's partials for the gn * kD values
// of its heads, V consecutive values a thread (1, or 4 by vector loads):
// one pass with a running max, loads of 8 splits at a time in flight
// (every active split has a token: its lse is finite).
template <int V, int kD>
__device__ __forceinline__ void merge_partials(
    const float* part_o, const float* part_lse, float* out, float* lse,
    size_t row, int gn, int n_act, size_t split_stride, int tid) {
  using Vec = std::conditional_t<V == 4, float4, float>;
  for (int idx = tid; idx < gn * kD / V; idx += kThreads) {
    const int g = V * idx / kD;
    float mx = mp::kNegInf, denom = 0.f, acc[V] = {};
#pragma unroll 8
    for (int sp = 0; sp < n_act; ++sp) {
      const size_t pi = sp * split_stride + row;
      const float ls = __ldcg(part_lse + pi + g);
      const Vec ov =
          __ldcg(reinterpret_cast<const Vec*>(part_o + pi * kD) + idx);
      const float* o = reinterpret_cast<const float*>(&ov);
      const float nm = fmaxf(mx, ls);
      const float keep = expf(mx - nm), w = expf(ls - nm);
      denom = denom * keep + w;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = acc[j] * keep + w * o[j];
      mx = nm;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) out[row * kD + V * idx + j] = acc[j] / denom;
    if ((V * idx) % kD == 0) lse[row + g] = mx + logf(denom);
  }
}

// T: __nv_bfloat16, or int8_t with the row scales k_scale, v_scale [B,
// Hkv, S] (null for bf16). kD: the head dim, 16, 32, 64 or 128. kPart: the
// general tile (G = mp::kHeadTile, `group` query heads a kv head, the
// compute of `tile_warp`); else an exact instance (the SIMT compute below).
// start_row [B]: each request's first row (null: 0). part_o [nsplit, B *
// Hq, kD] and part_lse [nsplit, B * Hq] hold the partials of requests with
// more than one active split; tickets [B * Hkv * blocks] is 0 between
// calls.
template <int G, typename T, int kD, bool kPart>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ length,
                    const int* __restrict__ start_row,
                    float* __restrict__ part_o,
                    float* __restrict__ part_lse, int* __restrict__ tickets,
                    float* __restrict__ out, float* __restrict__ lse,
                    int batch, int s_cap, int hkv, int group, int chunk,
                    float scale_log2) {
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  constexpr int kC = kD / 8;          // lanes of a token: 8 dims each
  constexpr int kR = 32 / kC;         // tokens of a pass
  constexpr int kP = 16 / kR;         // passes over a warp's 16 tokens
  // Passes a softmax update takes (1 and 2 at d = 16 and 32).
  constexpr int kGP = kP < kGroupPasses ? kP : kGroupPasses;
  constexpr int kTileBytes = tile_bytes<T, kD>();
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float red_m[kWarps][G], red_l[kWarps][G];
  // The warps' outputs: here for the exact instances, over the ring for the
  // general tile (whose 16 heads would take 32 KB at d = 128).
  __shared__ float red_o_s[kPart ? 1 : kWarps * G * kD];
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const mp::Heads<G, kPart> hd(blockIdx.y, group);
  const int kh = hd.kh, gn = hd.gn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = hkv * hd.group;
  const int len = max(min(length[b], s_cap), 0);
  const int lo = start_row == nullptr ? 0 : min(max(start_row[b], 0), len);
  const int first = lo / chunk;                   // first split with rows
  const int n_act = lo < len ? (len + chunk - 1) / chunk - first : 0;
  const size_t row = hd.row(b, hkv);              // first head row
  if (split < first || split >= first + n_act) {
    if (n_act == 0 && split == 0)                 // an empty range
      for (int i = tid; i < gn * kD; i += kThreads) {
        out[row * kD + i] = 0.f;
        if (i < gn) lse[row + i] = mp::kNegInf;
      }
    return;
  }
  // The split's 64-token tiles, from the one that holds its first row.
  const int start = max(split * chunk, lo / kTile * kTile);
  const int stop = min(len, (split + 1) * chunk);
  const int ntiles = (stop - start + kTile - 1) / kTile;
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  uint8_t* k_s = smem;                            // stage i at i * tile bytes
  uint8_t* v_s = smem + kStages * kTileBytes;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      // Exact instances: a warp's lane 0 releases the stage; the general
      // tile: every lane, once its own loads are done.
      hp::mbar_init(&empty[s], kPart ? kWarps * 32 : kWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // Copy warp.
    if (lane == 0) {
      const T* k_h = k + head * s_cap * kD;
      const T* v_h = v + head * s_cap * kD;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hp::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const int t0 = start + i * kTile;
        const int r0 = max(t0, lo) - t0;          // the tile's rows before lo
        constexpr int kRowBytes = kD * static_cast<int>(sizeof(T));
        const uint32_t bytes = (min(kTile, stop - t0) - r0) * kRowBytes;
        hp::mbar_arrive_expect_tx(&full[s], 2 * bytes);
        const size_t off = static_cast<size_t>(t0 + r0) * kD;
        hp::bulk_load(k_s + s * kTileBytes + r0 * kRowBytes, k_h + off, bytes,
                      &full[s]);
        hp::bulk_load(v_s + s * kTileBytes + r0 * kRowBytes, v_h + off, bytes,
                      &full[s]);
      }
    }
    __syncwarp();
  } else if constexpr (kPart) {
    tile_warp<T, kD>(q, row, gn, k_s, v_s, full, empty,
                     kQ ? k_scale + head * s_cap : nullptr,
                     kQ ? v_scale + head * s_cap : nullptr, start, lo, stop,
                     ntiles, scale_log2, warp, lane, &red_m[0][0],
                     &red_l[0][0], reinterpret_cast<float*>(smem));
  } else {
    // Compute warp: lane = (token r of kR, dims 8c..8c+7); this warp's
    // tokens of a tile are warp * 16 + r + kR p, p = 0..kP-1.
    const int r = lane / kC, c = lane % kC;
    const int tok = warp * 16 + r;
    float qf[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load8(q + (row + g) * kD + 8 * c, qf[g]);
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[g][j] *= scale_log2;
    }
    float m[G], l[G], acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = mp::kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
    }
    const float* ks_h = kQ ? k_scale + head * s_cap : nullptr;
    const float* vs_h = kQ ? v_scale + head * s_cap : nullptr;

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int t0 = start + i * kTile;
      bool valid[kP];
      float ksc[kP], vsc[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int t = t0 + tok + kR * p;
        valid[p] = t >= lo && t < stop;
        ksc[p] = kQ && valid[p] ? __ldg(ks_h + t) : 1.f;
        vsc[p] = kQ && valid[p] ? __ldg(vs_h + t) : 1.f;
      }
      hp::mbar_wait(&full[s], (i / kStages) & 1);
      const T* kt = reinterpret_cast<const T*>(k_s + s * kTileBytes);
      const T* vt = reinterpret_cast<const T*>(v_s + s * kTileBytes);
#pragma unroll
      for (int p0 = 0; p0 < kP; p0 += kGP) {
        float sc[G][kGP];
#pragma unroll
        for (int p = 0; p < kGP; ++p) {
          float kx[8];
          load8(kt + (tok + kR * (p0 + p)) * kD + 8 * c, kx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) a = fmaf(kx[j], qf[g][j], a);
            sc[g][p] = a;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int p = 0; p < kGP; ++p) {
            float a = sc[g][p];
#pragma unroll
            for (int off = 1; off < kC; off <<= 1)
              a += __shfl_xor_sync(0xffffffffu, a, off);
            sc[g][p] = valid[p0 + p] ? a * ksc[p0 + p] : mp::kNegInf;
          }
        // Online softmax over the group's tokens; the kC lanes of a token
        // hold the same values, the kR tokens of a pass are lanes kC apart.
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mx = sc[g][0];
          if constexpr (kGP == 4) {
            mx = fmaxf(fmaxf(sc[g][0], sc[g][1]), fmaxf(sc[g][2], sc[g][3]));
          } else {
#pragma unroll
            for (int p = 1; p < kGP; ++p) mx = fmaxf(mx, sc[g][p]);
          }
#pragma unroll
          for (int off = kC; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[g], mx);
          const float mu = mn == mp::kNegInf ? 0.f : mn;
          const float al = hp::ex2(m[g] - mu);
          float ps = 0.f;
#pragma unroll
          for (int p = 0; p < kGP; ++p) {
            sc[g][p] = hp::ex2(sc[g][p] - mu);
            ps += sc[g][p];
          }
#pragma unroll
          for (int off = kC; off < 32; off <<= 1)
            ps += __shfl_xor_sync(0xffffffffu, ps, off);
          l[g] = l[g] * al + ps;
          m[g] = mn;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] *= al;
        }
#pragma unroll
        for (int p = 0; p < kGP; ++p) {
          float vx[8];
          load8(vt + (tok + kR * (p0 + p)) * kD + 8 * c, vx);
#pragma unroll
          for (int j = 0; j < 8; ++j) vx[j] = valid[p0 + p] ? vx[j] : 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            // The TPU kernel's P.V operand: p (times the V scale) in bf16.
            const float w =
                __bfloat162float(__float2bfloat16_rn(sc[g][p] * vsc[p0 + p]));
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(w, vx[j], acc[g][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[s]);
    }

    // The warp's state: accumulators summed over its kR token lanes.
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = acc[g][j];
#pragma unroll
        for (int off = kC; off < 32; off <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (r == 0) red_o_s[(warp * G + g) * kD + 8 * c + j] = a;
      }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
  }
  __syncthreads();
  const float* red_o = kPart ? reinterpret_cast<const float*>(smem) : red_o_s;

  // The block's (out / l, natural-log lse) per head; partials numbered
  // from the first active split.
  const size_t part = static_cast<size_t>(split - first) * batch * hq + row;
  for (int idx = tid; idx < gn * kD; idx += kThreads) {
    const int g = idx / kD;
    float mx = mp::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    const float mu = mx == mp::kNegInf ? 0.f : mx;
    float sum_l = 0.f, sum_o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = hp::ex2(red_m[w][g] - mu);
      sum_l += red_l[w][g] * f;
      sum_o += red_o[(w * G + g) * kD + idx % kD] * f;
    }
    const float o_val = sum_l > 0.f ? sum_o / sum_l : 0.f;
    const float lse_val =
        sum_l > 0.f ? mu * mp::kLn2 + logf(sum_l) : mp::kNegInf;
    if (n_act == 1) {
      out[row * kD + idx] = o_val;
      if (idx % kD == 0) lse[row + g] = lse_val;
    } else {
      part_o[part * kD + idx] = o_val;
      if (idx % kD == 0) part_lse[part + g] = lse_val;
    }
  }
  if (n_act == 1) return;

  // The last split of this (request, kv head) to finish merges them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ti = hd.slot(b, hkv);
    is_last = atomicAdd(&tickets[ti], 1) == n_act - 1;
    if (is_last) atomicExch(&tickets[ti], 0);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The general tile's 16 heads merge four values a thread (vector loads).
  merge_partials<kPart ? 4 : 1, kD>(part_o, part_lse, out, lse, row, gn,
                                    n_act, static_cast<size_t>(batch) * hq,
                                    tid);
}

template <int G, typename T, int kD, bool kPart>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* length, const void* start_row, void* part_o,
                  void* part_lse, void* tickets, void* out, void* lse,
                  int batch, int s_cap, int hkv, int group, int chunk,
                  float sm_scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  auto* kernel = flash_decode_kernel<G, T, kD, kPart>;
  const cudaError_t err =
      hp::allow_smem(kernel, smem_bytes<T, kD>(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = kPart ? mp::group_blocks(group, G) : 1;
  dim3 grid((s_cap + chunk - 1) / chunk, hkv * blocks, batch);
  kernel<<<grid, kThreads, smem_bytes<T, kD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(length),
      static_cast<const int*>(start_row), static_cast<float*>(part_o),
      static_cast<float*>(part_lse),
      static_cast<int*>(tickets), static_cast<float*>(out),
      static_cast<float*>(lse), batch, s_cap, hkv, group, chunk,
      sm_scale * mp::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_scale and v_scale null: bf16 K/V; both set: int8 K/V with those
// per-token scales [B, Hkv, S]. head_dim: 16, 32, 64 or 128; hq a multiple
// of hkv (the exact instances at hq / hkv 1, 2, 4 and 8, and 3 at head dim
// 128; every other form the general tile). start_row: [B] int32 first
// rows, or null for 0. `chunk`: tokens per split, a positive multiple of
// 64. tickets: [B * Hkv * ceil(hq / hkv / 16)] (B * Hkv for the exact
// instances).
extern "C" int mp_flash_decode(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* length, const void* start_row,
                               void* part_o,
                               void* part_lse, void* tickets, void* out,
                               void* lse, int batch, int s_cap, int hq,
                               int hkv, int head_dim, int chunk,
                               float sm_scale, void* stream) {
  const bool quant = k_scale != nullptr;
  if (!mp::head_dim_ok(head_dim) || hkv <= 0 || hq < hkv ||
      hq % hkv != 0 || chunk <= 0 || chunk % kTile != 0 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s_cap == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
#define MP_DECODE_FORM(G, T, D, P)                                           \
  launch_decode<G, T, D, P>(q, k, v, k_scale, v_scale, length, start_row,    \
                            part_o, part_lse, tickets, out, lse, batch,      \
                            s_cap, hkv, g, chunk, sm_scale, st)
#define MP_DECODE_TYPES(G, D, P)                                             \
  (quant ? MP_DECODE_FORM(G, int8_t, D, P)                                   \
         : MP_DECODE_FORM(G, __nv_bfloat16, D, P))
  if (!mp::exact_group(g, head_dim)) {
    switch (head_dim) {
      case 16: return MP_DECODE_TYPES(mp::kHeadTile, 16, true);
      case 32: return MP_DECODE_TYPES(mp::kHeadTile, 32, true);
      case 64: return MP_DECODE_TYPES(mp::kHeadTile, 64, true);
      default: return MP_DECODE_TYPES(mp::kHeadTile, 128, true);
    }
  }
#define MP_DECODE_CASE(G)                                                    \
  case G:                                                                    \
    if (head_dim == 128) return MP_DECODE_TYPES(G, 128, false);              \
    return MP_DECODE_TYPES(G, 64, false);
  switch (g) {
    MP_DECODE_CASE(1)
    MP_DECODE_CASE(2)
    case 3:   // Llama-3.2-3B's 24 query heads over 8: head dim 128 (exact_group)
      return MP_DECODE_TYPES(3, 128, false);
    MP_DECODE_CASE(4)
    MP_DECODE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_DECODE_CASE
#undef MP_DECODE_TYPES
#undef MP_DECODE_FORM
}

extern "C" const char* mp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime; point it at the caller's device.
extern "C" int mp_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
