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
// d = 128), over 3.35 TB/s; the arithmetic is ~2 flops per byte. Head dims
// 16, 32, 64 and 128, bf16 and int8, are instances of one template (an
// int8 row at d = 128 is 128 bytes, as a bf16 one at d = 64: the same
// ring; at d = 16 a token's dims take 2 lanes, 16 tokens a pass). Group
// sizes: the exact instances and the general tile (common.cuh, `Heads`: a
// block takes at most 8 query heads of its kv head; the heads past `gn`
// hold a zero query and write nothing; a ticket per sub-group). Design,
// one block per (split, kv head, request), the split size chosen by the
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
//    tile: a lane holds 8 dims of one token (16-byte shared loads, 32 / (d
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

// T: __nv_bfloat16, or int8_t with the row scales k_scale, v_scale [B,
// Hkv, S] (null for bf16). kD: the head dim, 16, 32, 64 or 128. kPart: the
// general tile (mp::Heads), `group` query heads a kv head. start_row [B]:
// each request's first row (null: 0). part_o [nsplit, B * Hq, kD] and
// part_lse [nsplit, B * Hq] hold the partials of requests with more than
// one active split; tickets [B * Hkv * sub-groups] is 0 between calls.
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
  __shared__ float red_o[kWarps][G][kD];
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
      hp::mbar_init(&empty[s], kWarps);
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
  } else {
    // Compute warp: lane = (token r of kR, dims 8c..8c+7); this warp's
    // tokens of a tile are warp * 16 + r + kR p, p = 0..kP-1.
    const int r = lane / kC, c = lane % kC;
    const int tok = warp * 16 + r;
    float qf[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < gn) {
        load8(q + (row + g) * kD + 8 * c, qf[g]);
      } else {                                    // the general tile's empty heads
#pragma unroll
        for (int j = 0; j < 8; ++j) qf[g][j] = 0.f;
      }
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
        if (r == 0) red_o[warp][g][8 * c + j] = a;
      }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
  }
  __syncthreads();

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
      sum_o += red_o[w][g][idx % kD] * f;
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
  // One pass over the partials with a running max; loads of 8 splits at a
  // time in flight (every active split has a token: its lse is finite).
  const size_t split_stride = static_cast<size_t>(batch) * hq;
  for (int idx = tid; idx < gn * kD; idx += kThreads) {
    const int g = idx / kD;
    float mx = mp::kNegInf, acc = 0.f, denom = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_act; ++sp) {
      const size_t pi = sp * split_stride + row;
      const float ls = __ldcg(part_lse + pi + g);
      const float ov = __ldcg(part_o + pi * kD + idx);
      const float nm = fmaxf(mx, ls);
      const float keep = expf(mx - nm), w = expf(ls - nm);
      denom = denom * keep + w;
      acc = acc * keep + w * ov;
      mx = nm;
    }
    out[row * kD + idx] = acc / denom;
    if (idx % kD == 0) lse[row + g] = mx + logf(denom);
  }
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
  const int blocks = kPart ? mp::group_blocks(group) : 1;
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
// 64. tickets: [B * Hkv * ceil(hq / hkv / 8)] (B * Hkv for the exact
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
      case 16: return MP_DECODE_TYPES(mp::kGroupTile, 16, true);
      case 32: return MP_DECODE_TYPES(mp::kGroupTile, 32, true);
      case 64: return MP_DECODE_TYPES(mp::kGroupTile, 64, true);
      default: return MP_DECODE_TYPES(mp::kGroupTile, 128, true);
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
