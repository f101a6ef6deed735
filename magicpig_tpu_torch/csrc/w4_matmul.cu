// Packed-nibble int4 matmul at decode size: x [M, kin] bf16 times a
// group-128 int4 weight, f32 out [M, out] = sum_g (x_g @ unpack(q_g)) * s_g,
// bf16 activations times exact nibbles, summed in f32, no activation
// quantization.
//
// Replaces magicpig_tpu/ops/pallas/w4_matmul.py::w4_matmul (the pallas_call
// at w4_matmul.py:121). Weight layout (models/llama.py::Quant4Weight):
// int8 q [kin/2, out], packed row g*64 + j holding input g*128 + j in the
// low nibble and input g*128 + 64 + j in the high nibble; f32 scales
// [kin/128, out].
//
// Bound on the H100: at M = 2 (decode) reading the packed weight once, half
// a byte per weight plus 4 bytes of scale per 128 weights, over 3.35 TB/s.
// A design with the products on CUDA cores (each nibble shifted, converted
// by I2F and multiplied by M FMAs) spent its time on the conversion, which
// the card issues at 16 a clock per SM against 128 FMAs; and every split-K
// call launched a second kernel for the reduce. This design:
//  - the products run on mma.sync m16n8k16 with the weight as A (output
//    columns as its rows) and x as B (its rows as columns: a block takes
//    8 rows of x), f32 sums per 128-input group, each group's sums scaled
//    by the group scale into the accumulators, as the TPU kernel does;
//  - a nibble pair becomes a bf16 pair without a conversion: one byte
//    permute puts a byte's low nibble in the mantissa of one half and its
//    high nibble (the word shifted by one) in the other, a LOP3 masks them,
//    flips their sign bits and sets the exponent of 128, and one bf16x2 FMA
//    takes them to the signed values (128 + u) - 136 and (128 + 8u) / 8 - 24,
//    exact. So the k order of a product pairs input g*128 + j with
//    g*128 + 64 + j; x comes into shared memory with the first stage and
//    each lane pairs its inputs so;
//  - each warp owns 8 * kLaneCols output columns (lane (r, t): columns
//    kLaneCols * r onwards, its bytes of each packed row) and streams its
//    packed rows, one group and its scales a stage, through its own ring of
//    cp.async stages, so that loads overlap the products without block
//    barriers. kLaneCols is 16 where the output's column tiles alone fill
//    the card (the lm_head: half the blocks, twice the bytes a row each),
//    else 8;
//  - a block (4 warps) takes a split of whole groups; with more than one
//    split each writes its partial, and the last block of the output tile
//    to take a ticket (an acquire-release atomic, common.cuh; tickets
//    shared with flash_decode) sums the splits' partials in split order
//    and resets the ticket to 0: one launch a call, no float atomics, a
//    result that does not depend on the schedule. (The splits of a tile
//    as one thread block cluster, summed through distributed shared
//    memory, ran slower on the card at the layers' shapes: PERF.md.)
// M > 8 runs in 8-row slices, one more grid dimension.
#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 128;                    // inputs per scale group
constexpr int kGroupRows = kGroup / 2;         // packed rows a group
constexpr int kMRows = 8;                      // rows of x a block
constexpr int kMaxGroups = 16;                 // groups of a split
constexpr int kMaxSplits = 16;                 // partials a reduce sums
constexpr int kStages = 2;                     // a warp's ring

// Sizes for kLaneCols columns a lane (its bytes of a packed row).
template <int kLaneCols>
struct Tile {
  static constexpr int kWarpCols = 8 * kLaneCols;   // output columns a warp
  static constexpr int kCols = kWarps * kWarpCols;  // output columns a block
  static constexpr int kMTiles = kLaneCols / 2;     // products a k-step
  static constexpr int kWords = kLaneCols / 4;      // a lane's words a row
  static constexpr int kStageBytes = kGroupRows * kWarpCols + kWarpCols * 4;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
};

// A row of x in shared memory over ng groups, padded by 16 bytes so that
// the 8 rows' reads of one instruction hit distinct banks.
__host__ __device__ constexpr int x_row_bytes(int ng) { return ng * kGroup * 2 + 16; }

// A block's shared memory: the rings, then m8 rows of x over gps groups.
template <int kLaneCols>
constexpr int smem_bytes(int gps, int m8) {
  return Tile<kLaneCols>::kRingBytes + m8 * x_row_bytes(gps);
}

// One weight register: the nibbles of byte k of w (w1 = w >> 1) as the
// bf16 pair (low nibble, high nibble), signed.
template <int k>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w1) {
  constexpr uint32_t sel = k | (k << 4) | ((4 + k) << 8) | ((4 + k) << 12);
  const uint32_t p = (__byte_perm(w, w1, sel) & 0x0078000Fu) ^ 0x43404308u;
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(v) : "r"(p), "r"(0x3E003F80u), "r"(0xC1C0C308u));
  return v;
}

// The products of a k-step from m-tile i on: m-tile i's weights (columns
// kLaneCols * r + 2i (m = r) and + 2i + 1 (m = r + 8) of packed rows a and
// b) times the x fragment.
template <int kLaneCols, int i>
__device__ __forceinline__ void mtiles(const uint32_t (&wa)[kLaneCols / 4],
                                       const uint32_t (&wa1)[kLaneCols / 4],
                                       const uint32_t (&wb)[kLaneCols / 4],
                                       const uint32_t (&wb1)[kLaneCols / 4],
                                       uint2 xb, float (&d)[kLaneCols / 2][4]) {
  if constexpr (i < kLaneCols / 2) {
    constexpr int w = i >> 1, k = 2 * (i & 1);
    const uint32_t a[4] = {nibble_pair<k>(wa[w], wa1[w]),
                           nibble_pair<k + 1>(wa[w], wa1[w]),
                           nibble_pair<k>(wb[w], wb1[w]),
                           nibble_pair<k + 1>(wb[w], wb1[w])};
    mp::mma_bf16_16816(d[i], a, xb.x, xb.y);
    mtiles<kLaneCols, i + 1>(wa, wa1, wb, wb1, xb, d);
  }
}

// A lane's words of a packed row in shared memory.
template <int kWords>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[kWords]) {
  if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
}

// Grid (tiles, splits, M slices). part: f32 [ksplit, M, out] (unused with
// one split); tickets [tiles x M slices], 0 between calls; gps: groups a
// split.
template <int kLaneCols>
__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ part,
                 float* __restrict__ y, int* __restrict__ tickets, int m,
                 int kin, int out, int gps) {
  using T = Tile<kLaneCols>;
  constexpr int kWarpCols = T::kWarpCols, kCols = T::kCols;
  constexpr int kMTiles = T::kMTiles, kWords = T::kWords;
  constexpr int kStageBytes = T::kStageBytes;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int is_last;
  const int tile = blockIdx.x, split = blockIdx.y, ksplit = gridDim.y;
  const int m0 = blockIdx.z * kMRows, m8 = min(kMRows, m - m0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, t = lane & 3;
  const int g0 = split * gps;
  const int ng = min(kin / kGroup, g0 + gps) - g0;
  const int col0 = tile * kCols + warp * kWarpCols;   // this warp's columns
  const bool active = col0 < out;
  uint8_t* ring = smem + warp * kStages * kStageBytes;
  uint8_t* xs = smem + T::kRingBytes;
  const int xrow = x_row_bytes(ng);

  // Group g0 + gi of this warp's columns: 64 rows of kWarpCols bytes and
  // their scales, 16 bytes a copy, neighbouring lanes on neighbouring
  // bytes.
  auto fetch = [&](int gi) {
    uint8_t* st = ring + (gi % kStages) * kStageBytes;
    const int8_t* src = q + static_cast<size_t>(g0 + gi) * kGroupRows * out + col0;
#pragma unroll
    for (int j = 0; j < kGroupRows * kWarpCols / 16 / 32; ++j) {
      const int u = lane + 32 * j;
      hp::cp_async_16(st + 16 * u, src + static_cast<size_t>(u / (kWarpCols / 16)) * out +
                                       16 * (u % (kWarpCols / 16)));
    }
    if (lane < kWarpCols / 4)
      hp::cp_async_16(st + kGroupRows * kWarpCols + 16 * lane,
                      scale + static_cast<size_t>(g0 + gi) * out + col0 + 4 * lane);
  };
  // x rows m0 .. m0 + m8 over this split's inputs, raw, in the first
  // stage's copies: one round trip before the products start.
  for (int n = 0; n < m8; ++n)
    for (int u = tid; u < ng * (kGroup / 8); u += kThreads)
      hp::cp_async_16(xs + n * xrow + 16 * u,
                      x + static_cast<size_t>(m0 + n) * kin + g0 * kGroup + 8 * u);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (active && s < ng) fetch(s);
    hp::cp_async_commit();
  }

  float acc[kMTiles][4] = {};
  for (int gi = 0; gi < ng; ++gi) {
    if (active && gi + kStages - 1 < ng) fetch(gi + kStages - 1);
    hp::cp_async_commit();
    hp::cp_async_wait<kStages - 1>();
    if (gi == 0)
      __syncthreads();                       // x, from every thread's copies
    else
      __syncwarp();
    if (!active) continue;
    const uint8_t* st = ring + (gi % kStages) * kStageBytes;
    float d[kMTiles][4] = {};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      // Packed rows 8s + t and 8s + 4 + t: k positions 2t, 2t + 1 and
      // 2t + 8, 2t + 9 of the product.
      uint32_t wa[kWords], wb[kWords], wa1[kWords], wb1[kWords];
      load_words(st + (8 * s + t) * kWarpCols + kLaneCols * r, wa);
      load_words(st + (8 * s + 4 + t) * kWarpCols + kLaneCols * r, wb);
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        wa1[w] = wa[w] >> 1;
        wb1[w] = wb[w] >> 1;
      }
      // x row r's inputs j, j + 64 and j + 4, j + 68 (j = 8s + t) as bf16
      // pairs: the k order of the weight's registers.
      uint2 xb = make_uint2(0u, 0u);
      if (r < m8) {
        const uint8_t* xr = xs + r * xrow + 2 * (gi * kGroup + 8 * s + t);
        const auto h = [xr](int i) {
          return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(xr + 2 * i));
        };
        xb = make_uint2(__byte_perm(h(0), h(64), 0x5410),
                        __byte_perm(h(4), h(68), 0x5410));
      }
      mtiles<kLaneCols, 0>(wa, wa1, wb, wb1, xb, d);
    }
    // The group's sums times its scales: d[i][0], d[i][1] at column
    // kLaneCols * r + 2i, d[i][2], d[i][3] at kLaneCols * r + 2i + 1.
    float sc[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; c += 4)
      *reinterpret_cast<float4*>(sc + c) = *reinterpret_cast<const float4*>(
          st + kGroupRows * kWarpCols + 4 * (kLaneCols * r + c));
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const float s0 = sc[2 * i], s1 = sc[2 * i + 1];
      acc[i][0] = fmaf(d[i][0], s0, acc[i][0]);
      acc[i][1] = fmaf(d[i][1], s0, acc[i][1]);
      acc[i][2] = fmaf(d[i][2], s1, acc[i][2]);
      acc[i][3] = fmaf(d[i][3], s1, acc[i][3]);
    }
    __syncwarp();
  }

  // Rows m0 + 2t (acc[i][0], acc[i][2]) and m0 + 2t + 1 (acc[i][1],
  // acc[i][3]), columns col0 + kLaneCols * r onwards: to y, or with more
  // than one split to this split's partial.
  float* dst = ksplit == 1 ? y : part + static_cast<size_t>(split) * m * out;
  if (active)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (2 * t + e < m8) {
        float* o = dst + static_cast<size_t>(m0 + 2 * t + e) * out + col0 +
                   kLaneCols * r;
#pragma unroll
        for (int c = 0; c < kLaneCols; c += 4)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[c / 2][e], acc[c / 2][e + 2], acc[c / 2 + 1][e],
                          acc[c / 2 + 1][e + 2]);
      }
  if (ksplit == 1) return;

  // The last split of this output tile to finish sums them all, in order.
  __syncthreads();
  if (tid == 0) is_last = mp::take_ticket(tickets + blockIdx.z * gridDim.x + tile, ksplit);
  __syncthreads();
  if (!is_last) return;
  const size_t plane = static_cast<size_t>(m) * out;
  for (int i = tid; i < m8 * kCols / 4; i += kThreads) {
    const int col = tile * kCols + 4 * (i % (kCols / 4));
    if (col >= out) continue;
    const size_t at = static_cast<size_t>(m0 + i / (kCols / 4)) * out + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < ksplit; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(part + s * plane + at));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(y + at) = sum;
  }
}

template <int kLaneCols>
int launch_w4(const void* x, const void* q, const void* scale, void* part,
              void* y, void* tickets, int m, int kin, int out, int ksplit,
              int gps, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      hp::allow_smem(w4_matmul_kernel<kLaneCols>,
                     smem_bytes<kLaneCols>(kMaxGroups, kMRows), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((out + Tile<kLaneCols>::kCols - 1) / Tile<kLaneCols>::kCols, ksplit,
            (m + kMRows - 1) / kMRows);
  w4_matmul_kernel<kLaneCols>
      <<<grid, kThreads, smem_bytes<kLaneCols>(gps, min(kMRows, m)), stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(scale), static_cast<float*>(part),
          static_cast<float*>(y), static_cast<int*>(tickets), m, kin, out, gps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: f32 [ksplit, M, out] (ignored when ksplit == 1); y: f32 [M, out];
// tickets: int32, at least (column tiles) x (M / 8 rounded up), 0 between
// calls; split s takes the groups [s * gps, (s + 1) * gps) of kin / 128;
// lane_cols: 8 (256 columns a tile), or 16 (512).
extern "C" int mp_w4_matmul(const void* x, const void* q, const void* scale,
                            void* part, void* y, void* tickets, int m,
                            int kin, int out, int ksplit, int gps,
                            int lane_cols, void* stream) {
  const int groups = kin / kGroup;
  if (m < 1 || kin % kGroup != 0 || out % (8 * lane_cols) != 0 || gps < 1 ||
      gps > kMaxGroups || ksplit < 1 || ksplit > kMaxSplits ||
      (ksplit - 1) * gps >= groups || ksplit * gps < groups ||
      (ksplit > 1 && tickets == nullptr) || (lane_cols != 8 && lane_cols != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lane_cols == 8
             ? launch_w4<8>(x, q, scale, part, y, tickets, m, kin, out, ksplit, gps, st)
             : launch_w4<16>(x, q, scale, part, y, tickets, m, kin, out, ksplit, gps, st);
}
