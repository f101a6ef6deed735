// Causal flash prefill attention for Hopper.
//
// Replaces magicpig_tpu/ops/pallas/prefill.py::flash_prefill_pallas (the
// pallas_call at prefill.py:249). Same contract: queries at absolute
// positions q_offset[b] + i attend keys t with t <= position, t < length[b]
// and, with a window, position - t < window; optional natural-log LSE out.
//
// Bound on the H100: at Llama-3.2-1B width an 8K prompt is ~275 GFLOP of
// attention per layer against ~50 MB of q/k/v/out, so the kernel is
// compute-bound and has to run on the tensor cores. Design: one block per
// (request, kv head, 256 query rows), the rows being the G query heads of
// that kv head times 256/G queries, so each K/V tile read from device memory
// feeds all G heads. Sixteen warps each own one 16-row mma.sync m16n8k16
// tile (bf16 in, f32 accumulate); scores, probabilities and the output
// accumulator stay in registers in the FlashAttention-2 layout, and only
// 64-key K/V tiles pass through shared memory. The causal triangle is
// skipped per block (key tiles past the block's last query are never read)
// and per warp. wgmma, TMA and a pipelined tile ring are later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kRows = 256;              // query rows per block
constexpr int kWarps = kRows / 16;      // one 16-row MMA tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;              // keys per shared-memory tile
constexpr int kPad = kD + 8;            // row stride (bf16): conflict-free

__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ length,
                     const int* __restrict__ q_offset,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int sq, int skv, int hq, int hkv, int window,
                     float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTileK][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileK][kPad];

  const int g_heads = hq / hkv;
  const int qt = kRows / g_heads;       // queries per head in this block
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int q0 = blockIdx.x * qt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;             // fragment row group
  const int tq = lane & 3;              // fragment column pair

  const int len = length[b];
  const int qoff = q_offset[b];

  // This warp's 16 rows: one query head, 16 consecutive queries.
  const int head = kh * g_heads + (warp * 16) / qt;
  const int i_base = q0 + (warp * 16) % qt;
  const int r0 = i_base + gr;           // query index of rows gr and gr + 8
  const int r1 = r0 + 8;
  const int pos0 = qoff + r0;
  const int pos1 = qoff + r1;

  // Key range of the whole block: [lo, hi).
  const int q_last = min(q0 + qt, sq) - 1;
  int hi = min(len, qoff + q_last + 1);
  hi = min(hi, skv);
  int lo = 0;
  if (window > 0) lo = max(0, qoff + q0 - window + 1);
  // Key range of this warp (for skipping tiles it cannot see).
  const int w_last = min(i_base + 15, sq - 1);
  const int w_hi = min(hi, qoff + w_last + 1);
  const int w_lo = window > 0 ? max(0, qoff + i_base - window + 1) : 0;

  // Q fragments (4 k-steps of 16 over d = 64), straight from device memory.
  uint32_t qa[kD / 16][4];
  {
    const size_t row_stride = static_cast<size_t>(hq) * kD;
    const __nv_bfloat16* q_b = q + static_cast<size_t>(b) * sq * row_stride +
                               static_cast<size_t>(head) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + 2 * tq;
      uint32_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;
      if (r0 < sq) {
        const __nv_bfloat16* p = q_b + r0 * row_stride + c;
        x0 = *reinterpret_cast<const uint32_t*>(p);
        x2 = *reinterpret_cast<const uint32_t*>(p + 8);
      }
      if (r1 < sq) {
        const __nv_bfloat16* p = q_b + r1 * row_stride + c;
        x1 = *reinterpret_cast<const uint32_t*>(p);
        x3 = *reinterpret_cast<const uint32_t*>(p + 8);
      }
      qa[kk][0] = x0;
      qa[kk][1] = x1;
      qa[kk][2] = x2;
      qa[kk][3] = x3;
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = mp::kNegInf, m1 = mp::kNegInf;   // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;                   // this thread's partial sums

  const size_t kv_row = static_cast<size_t>(hkv) * kD;
  const __nv_bfloat16* k_b = k + static_cast<size_t>(b) * skv * kv_row +
                             static_cast<size_t>(kh) * kD;
  const __nv_bfloat16* v_b = v + static_cast<size_t>(b) * skv * kv_row +
                             static_cast<size_t>(kh) * kD;

  for (int t0 = (lo / kTileK) * kTileK; t0 < hi; t0 += kTileK) {
    // Cooperative tile load: 64 rows x 8 vectors of 16 bytes, K and V.
    for (int c = tid; c < kTileK * (kD / 8); c += kThreads) {
      const int row = c / (kD / 8);
      const int col = (c % (kD / 8)) * 8;
      const int t = t0 + row;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (t < hi) {
        kx = *reinterpret_cast<const uint4*>(k_b + t * kv_row + col);
        vx = *reinterpret_cast<const uint4*>(v_b + t * kv_row + col);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[row][col]) = vx;
    }
    __syncthreads();

    if (t0 < w_hi && t0 + kTileK > w_lo && i_base < sq) {
      // S = Q K^T for 8 column tiles of 8 keys.
      float s[kTileK / 8][4];
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const __nv_bfloat16* kr = &ks[j * 8 + gr][kk * 16 + 2 * tq];
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
          mp::mma_bf16_16816(s[j], qa[kk], b0, b1);
        }
      }
      // Mask, scale (log2 units), row max.
      float mx0 = mp::kNegInf, mx1 = mp::kNegInf;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + j * 8 + 2 * tq + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          const int row = e < 2 ? r0 : r1;
          bool ok = key <= pos && key < hi && row < sq;
          if (window > 0) ok = ok && pos - key < window;
          const float x = ok ? s[j][e] * scale_log2 : mp::kNegInf;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mu0 = mn0 == mp::kNegInf ? 0.f : mn0;
      const float mu1 = mn1 == mp::kNegInf ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mu0);
        s[j][1] = exp2f(s[j][1] - mu0);
        s[j][2] = exp2f(s[j][2] - mu1);
        s[j][3] = exp2f(s[j][3] - mu1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
      // O += P V: P from the score registers (C layout of two adjacent
      // 8-key tiles == A layout of one 16-key step), V from shared memory.
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = mp::pack_f32_as_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = mp::pack_f32_as_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = mp::pack_f32_as_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = mp::pack_f32_as_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int kr = kk * 16 + 2 * tq;
#pragma unroll
        for (int jd = 0; jd < kD / 8; ++jd) {
          const int col = jd * 8 + gr;
          const uint32_t b0 = mp::pack_bf16(vs[kr][col], vs[kr + 1][col]);
          const uint32_t b1 = mp::pack_bf16(vs[kr + 8][col], vs[kr + 9][col]);
          mp::mma_bf16_16816(o[jd], pa, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // Row sums live spread over the 4 threads of a quad.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const size_t row_stride = static_cast<size_t>(hq) * kD;
  __nv_bfloat16* out_b = out + static_cast<size_t>(b) * sq * row_stride +
                         static_cast<size_t>(head) * kD;
#pragma unroll
  for (int jd = 0; jd < kD / 8; ++jd) {
    const int c = jd * 8 + 2 * tq;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(out_b + r0 * row_stride + c) =
          mp::pack_f32_as_bf16(o[jd][0] * inv0, o[jd][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(out_b + r1 * row_stride + c) =
          mp::pack_f32_as_bf16(o[jd][2] * inv1, o[jd][3] * inv1);
  }
  if (lse != nullptr && tq == 0) {
    float* lse_b = lse + static_cast<size_t>(b) * sq * hq + head;
    if (r0 < sq)
      lse_b[static_cast<size_t>(r0) * hq] =
          l0 > 0.f ? m0 * mp::kLn2 + logf(l0) : mp::kNegInf;
    if (r1 < sq)
      lse_b[static_cast<size_t>(r1) * hq] =
          l1 > 0.f ? m1 * mp::kLn2 + logf(l1) : mp::kNegInf;
  }
}

}  // namespace

extern "C" int mp_flash_prefill(const void* q, const void* k, const void* v,
                                const void* length, const void* q_offset,
                                void* out, void* lse, int batch, int sq,
                                int skv, int hq, int hkv, int head_dim,
                                int window, float sm_scale, void* stream) {
  if (head_dim != kD || hq % hkv != 0 || kRows % (16 * (hq / hkv)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qt = kRows / (hq / hkv);
  dim3 grid((sq + qt - 1) / qt, hkv, batch);
  flash_prefill_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(length),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, skv, hq, hkv, window,
      sm_scale * mp::kLog2e);
  return static_cast<int>(cudaGetLastError());
}
