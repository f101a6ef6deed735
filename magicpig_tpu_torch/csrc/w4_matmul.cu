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
// a byte per weight plus 4 bytes of scale per 128 weights, over 3.35 TB/s;
// the arithmetic is 4 flops per weight byte per row of x. Design: the TPU
// kernel walks (out block, kin block) with the kin axis innermost so that
// one f32 accumulator block stays resident; on the card the out axis is cut
// into 256-column tiles and the kin axis into splits of whole groups, one
// block of 256 threads each, so that even a 2048-wide output fills the 132
// SMs. A lane owns 8 adjacent output columns and loads them 8 bytes at a
// time (a warp reads 256 contiguous bytes of a packed row); each of the 8
// warps takes 8 of a group's 64 packed rows. The nibbles are sign-extended
// by shifts in registers and never stored. x rows of the block's groups sit
// in shared memory as f32 (read as broadcasts); each warp's group partial is
// scaled by the group scale into its accumulators, the 8 warps are summed in
// a fixed order through shared memory, and with more than one split a
// second kernel sums the splits' partials in order (no atomics: the result
// does not depend on the schedule). M > 4 runs in 4-row slices, one more
// grid dimension.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 8;
constexpr int kCols = 32 * kColsPerLane;       // output columns per block
constexpr int kGroup = 128;                    // inputs per scale group
constexpr int kRowsPerWarp = kGroup / 2 / kWarps;   // packed rows: 8
constexpr int kMaxGroups = 16;                 // groups of x per block
constexpr int kMTile = 4;                      // rows of x per block (max)
constexpr int kSmemFloats = kMTile * kMaxGroups * kGroup;   // 32 KB
static_assert(kSmemFloats >= kWarps * kMTile * kCols, "reduce buffer");

// The signed nibble at bit `sh` (0, 4, ..., 28) of w, as a float.
__device__ __forceinline__ float nibble(uint32_t w, int sh) {
  return static_cast<float>(static_cast<int32_t>(w << (28 - sh)) >> 28);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ part,
                 int m, int kin, int out, int groups_per_split) {
  __shared__ __align__(16) float smem[kSmemFloats];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = kin / kGroup;
  const int g0 = split * groups_per_split;
  const int ng = min(groups, g0 + groups_per_split) - g0;
  const int span = ng * kGroup;                // inputs of this block

  // x[m0 .. m0+MT, g0*128 .. +span] as f32; rows past m are zeros.
  for (int i = tid; i < MT * span; i += kThreads) {
    const int r = i / span, c = i % span;
    smem[i] = m0 + r < m
                  ? __bfloat162float(x[static_cast<size_t>(m0 + r) * kin +
                                       g0 * kGroup + c])
                  : 0.f;
  }
  __syncthreads();

  const int col = tile * kCols + lane * kColsPerLane;
  float acc[MT][kColsPerLane];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;

  if (col < out) {
    for (int gi = 0; gi < ng; ++gi) {
      const int g = g0 + gi;
      const int8_t* qrow =
          q + static_cast<size_t>(g * (kGroup / 2) + warp * kRowsPerWarp) * out + col;
      uint2 w[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        w[r] = __ldg(reinterpret_cast<const uint2*>(qrow + static_cast<size_t>(r) * out));
      float p[MT][kColsPerLane];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) p[r][c] = 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int j = gi * kGroup + warp * kRowsPerWarp + r;
        float xl[MT], xh[MT];
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          xl[mm] = smem[mm * span + j];            // input g*128 + j
          xh[mm] = smem[mm * span + j + kGroup / 2];   // input g*128 + 64 + j
        }
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const uint32_t word = c < 4 ? w[r].x : w[r].y;
          const int sh = (c & 3) * 8;
          const float lo = nibble(word, sh), hi = nibble(word, sh + 4);
#pragma unroll
          for (int mm = 0; mm < MT; ++mm)
            p[mm][c] = fmaf(xh[mm], hi, fmaf(xl[mm], lo, p[mm][c]));
        }
      }
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(g) * out + col));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(g) * out + col + 4));
      const float s[kColsPerLane] = {s0.x, s0.y, s0.z, s0.w,
                                     s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[mm][c] = fmaf(p[mm][c], s[c], acc[mm][c]);
    }
  }
  __syncthreads();                             // x no longer read

  // Sum the 8 warps in order: red[warp][row][column of the tile].
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      smem[(warp * MT + mm) * kCols + lane * kColsPerLane + c] = acc[mm][c];
  __syncthreads();
  const int oc = tile * kCols + tid;
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += smem[(wi * MT + mm) * kCols + tid];
    if (oc < out && m0 + mm < m)
      part[(static_cast<size_t>(split) * m + m0 + mm) * out + oc] = sum;
  }
}

// out[i] = sum over splits, in order, of part[split][i].
__global__ void w4_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int ksplit,
                                 size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < ksplit; ++s) sum += part[static_cast<size_t>(s) * n + i];
  out[i] = sum;
}

template <int MT>
int launch_w4(const void* x, const void* q, const void* scale, void* part,
              int m, int kin, int out, int ksplit, int gps,
              cudaStream_t stream) {
  dim3 grid((out + kCols - 1) / kCols, ksplit, (m + MT - 1) / MT);
  w4_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(part), m, kin,
      out, gps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: f32 [ksplit, M, out] (the output itself when ksplit == 1); y: f32
// [M, out]; split s takes the groups [s * gps, (s + 1) * gps) of kin / 128.
extern "C" int mp_w4_matmul(const void* x, const void* q, const void* scale,
                            void* part, void* y, int m, int kin, int out,
                            int ksplit, int gps, void* stream) {
  const int groups = kin / kGroup;
  if (m < 1 || kin % kGroup != 0 || out % kColsPerLane != 0 || gps < 1 ||
      gps > kMaxGroups || ksplit < 1 || (ksplit - 1) * gps >= groups ||
      ksplit * gps < groups || (ksplit == 1) != (part == y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = m == 1   ? launch_w4<1>(x, q, scale, part, m, kin, out, ksplit, gps, st)
            : m == 2 ? launch_w4<2>(x, q, scale, part, m, kin, out, ksplit, gps, st)
                     : launch_w4<kMTile>(x, q, scale, part, m, kin, out, ksplit, gps, st);
  if (err != 0 || ksplit == 1) return err;
  const size_t n = static_cast<size_t>(m) * out;
  w4_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(y), ksplit, n);
  return static_cast<int>(cudaGetLastError());
}
