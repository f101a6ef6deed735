// Backward of the training flash prefill (FlashAttention-2) for Hopper.
//
// Replaces no Pallas kernel: the JAX package differentiates its training
// attention through a custom VJP whose backward is XLA
// (magicpig_tpu/ops/attention.py::_fp_train_bwd, the VJP of
// _flash_prefill_train), and the port's forward of that VJP is the
// flash_prefill kernel (flash_prefill.cu) with its LSE. Same contract as
// _fp_train_bwd: queries at positions q_offset[b] + i see keys t with
// t <= position, t < kv_len[b] and, with a window, position - t < window;
// p = exp(s - lse) recomputed tile by tile (an lse of -inf, a row that
// sees nothing, is taken as 0), delta = rowsum(dO * O),
// dS = p * (dP - delta) * scale, and the G query heads of a kv head summed
// into dK and dV. Inputs bf16 (q, k, v, out, dO), lse f32 [B, Sq, Hq];
// dq, dk, dv out in f32.
//
// Bound on the H100: at the RULER byte model's size (B = 8, S = 8192, 8/4
// heads of 64) one layer's backward is ~1.9 TFLOP of products (seven per
// visible (query, key) pair of heads, below) against ~50 MB of inputs and
// outputs, so it is bound by tensor-core operations. This first form runs
// the products on mma.sync m16n8k16 (bf16 in, f32 sums) with every operand
// fragment from registers or ldmatrix; no pipelining (wgmma and TMA are
// later work). A call runs three kernels:
//  - delta: one warp per (request, query, head) row, rowsum(dO * O);
//  - dK/dV: one block of 4 warps per (key tile of 64, kv head, request).
//    Each warp keeps its 16 keys' K and V fragments and their dK and dV
//    sums in registers, and walks the G query heads and the 64-query tiles
//    that can see the block's keys (from the first query at or after the
//    tile's first key, to the window's end), staging each tile's Q and dO
//    in shared memory (rows padded to 144 bytes, so ldmatrix reads hit
//    distinct banks): S^T = K Q^T and dP^T = V dO^T, then p and dS in
//    registers, rounded to bf16 as the A operands of dV += P^T dO and
//    dK += dS^T Q. No atomics: a key tile's sums belong to one block.
//  - dQ: one block per (query tile of 64, query head, request), the last
//    tiles first, walks the key tiles its queries can see and recomputes
//    S, dP, p and dS for dQ += dS K. This costs three more products per
//    pair (seven in all, against five with f32 atomics into dQ from the
//    dK/dV blocks), and in return dQ is deterministic: the same inputs
//    give the same bits on every run, so a kernel run can be held to
//    another and a resumed training run to an unbroken one.
// Rows past sq and keys past kv_len are staged as zeros, so no NaN there
// reaches a product. Head dim 64 only (both models the port trains);
// the wrapper raises on other forms before any launch.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;           // queries or keys a block stages at once
constexpr int kHalf = 32;           // columns of S a warp holds at once
constexpr int kThreads = 128;       // 4 warps of 16 rows
constexpr int kStride = kD + 8;     // padded shared row: 144 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. Without .trans lane (g, t) gets row g, columns
// 2t and 2t+1 of each; with .trans rows 2t and 2t+1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragments (16 rows x 64 columns, four k-steps) of rows r .. r + 15
// of a row-major bf16 tensor whose row i starts at base + i * stride; rows
// at or past n are zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4],
                                            const __nv_bfloat16* base,
                                            size_t stride, int r, int n,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r + g, rb = ra + 8;
  const __nv_bfloat16* pa = base + static_cast<size_t>(ra) * stride + 2 * t;
  const __nv_bfloat16* pb = base + static_cast<size_t>(rb) * stride + 2 * t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ra < n ? ld_pair(pa + 16 * kk) : 0u;
    a[kk][1] = rb < n ? ld_pair(pb + 16 * kk) : 0u;
    a[kk][2] = ra < n ? ld_pair(pa + 16 * kk + 8) : 0u;
    a[kk][3] = rb < n ? ld_pair(pb + 16 * kk + 8) : 0u;
  }
}

// Rows r0 .. r0 + 63 of such a tensor into a padded shared tile, 16 bytes
// a thread at a time; rows at or past n are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* base,
                                          size_t stride, int r0, int n,
                                          int tid) {
  for (int i = tid; i < kTile * (kD / 8); i += kThreads) {
    const int row = i / (kD / 8), ch = i % (kD / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(r0 + row) * stride + ch * 8);
    *reinterpret_cast<uint4*>(s + row * kStride + ch * 8) = val;
  }
}

__device__ __forceinline__ bool visible(int i, int key, int sq, int klen,
                                        int qo, int window) {
  const int pos = qo + i;
  return i < sq && key < klen && key <= pos &&
         (window <= 0 || pos - key < window);
}

// The A fragment of a 16 x 16 product from two f32 accumulator tiles
// (n-tiles j and j + 1 of a 16-row strip), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* lo,
                                         const float* hi) {
  a[0] = mp::pack_f32_as_bf16(lo[0], lo[1]);
  a[1] = mp::pack_f32_as_bf16(lo[2], lo[3]);
  a[2] = mp::pack_f32_as_bf16(hi[0], hi[1]);
  a[3] = mp::pack_f32_as_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float lse_log2(float lse) {
  return lse == mp::kNegInf ? 0.f : lse * mp::kLog2e;
}

__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * kD;
  const float2 o = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(out + at)[lane]);
  const float2 d = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(dout + at)[lane]);
  const float sum = mp::warp_sum(o.x * d.x + o.y * d.y);
  if (lane == 0) delta[row] = sum;
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_len,
                      const int* __restrict__ q_offset,
                      float* __restrict__ dk, float* __restrict__ dv, int sq,
                      int skv, int hq, int hkv, int window, float scale,
                      float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 do_s[kTile * kStride];
  __shared__ float lse_s[kTile], delta_s[kTile];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int group = hq / hkv;
  const int klen = min(kv_len[b], skv), qo = q_offset[b];
  const int k0 = blockIdx.x * kTile, kw = k0 + 16 * warp;
  const size_t q_stride = static_cast<size_t>(hq) * kD;
  const size_t kv_stride = static_cast<size_t>(hkv) * kD;

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // Queries that can see a key of the tile: from the first at or after
  // its first key to the last inside the window of its last valid key.
  const int i_lo = max(0, k0 - qo);
  const int i_hi = window > 0
                       ? min(sq, min(k0 + kTile, klen) - 1 + window - qo)
                       : sq;
  if (k0 < klen && i_lo < i_hi) {
    uint32_t kf[4][4], vf[4][4];
    const size_t kv_base = (static_cast<size_t>(b) * skv * hkv + h) * kD;
    load_a_rows(kf, k + kv_base, kv_stride, kw, klen, lane);
    load_a_rows(vf, v + kv_base, kv_stride, kw, klen, lane);
    for (int gi = 0; gi < group; ++gi) {
      const int hh = h * group + gi;
      const size_t q_base = (static_cast<size_t>(b) * sq * hq + hh) * kD;
      const size_t l_base = static_cast<size_t>(b) * sq * hq + hh;
      for (int i0 = (i_lo / kTile) * kTile; i0 < i_hi; i0 += kTile) {
        __syncthreads();
        load_tile(q_s, q + q_base, q_stride, i0, sq, tid);
        load_tile(do_s, dout + q_base, q_stride, i0, sq, tid);
        if (tid < kTile) {
          const int i = i0 + tid;
          const bool in = i < sq;
          lse_s[tid] = in ? lse_log2(lse[l_base + static_cast<size_t>(i) * hq])
                          : 0.f;
          delta_s[tid] = in ? delta[l_base + static_cast<size_t>(i) * hq] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c0 = half * kHalf;
          float s[4][4], dp[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
          // S^T = K Q^T and dP^T = V dO^T: B from the rows of Q and dO.
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              const int off = (c0 + 16 * jp + 8 * (mi >> 1) + mr) * kStride +
                              16 * kk + 8 * (mi & 1);
              uint32_t bq[4], bo[4];
              ldsm_x4(bq, smem_addr(q_s + off));
              ldsm_x4(bo, smem_addr(do_s + off));
              mp::mma_bf16_16816(s[2 * jp], kf[kk], bq[0], bq[1]);
              mp::mma_bf16_16816(s[2 * jp + 1], kf[kk], bq[2], bq[3]);
              mp::mma_bf16_16816(dp[2 * jp], vf[kk], bo[0], bo[1]);
              mp::mma_bf16_16816(dp[2 * jp + 1], vf[kk], bo[2], bo[3]);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int key = kw + g + 8 * (c >> 1);
              const int il = c0 + 8 * j + 2 * t + (c & 1);
              const float p =
                  visible(i0 + il, key, sq, klen, qo, window)
                      ? exp2f(s[j][c] * scale_log2 - lse_s[il])
                      : 0.f;
              s[j][c] = p;
              dp[j][c] = p * (dp[j][c] - delta_s[il]) * scale;
            }
          // dV += P^T dO and dK += dS^T Q: B from the rows of dO and Q,
          // transposed.
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t pa[4], da[4];
            acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
            acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
              const int off = (c0 + 16 * kk + 8 * (mi & 1) + mr) * kStride +
                              16 * jp + 8 * (mi >> 1);
              uint32_t bo[4], bq[4];
              ldsm_x4_t(bo, smem_addr(do_s + off));
              ldsm_x4_t(bq, smem_addr(q_s + off));
              mp::mma_bf16_16816(dv_acc[2 * jp], pa, bo[0], bo[1]);
              mp::mma_bf16_16816(dv_acc[2 * jp + 1], pa, bo[2], bo[3]);
              mp::mma_bf16_16816(dk_acc[2 * jp], da, bq[0], bq[1]);
              mp::mma_bf16_16816(dk_acc[2 * jp + 1], da, bq[2], bq[3]);
            }
          }
        }
      }
    }
  }
  // Every key row below skv is written: zeros where no query sees it.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kw + g + 8 * rr;
    if (key >= skv) continue;
    const size_t row = ((static_cast<size_t>(b) * skv + key) * hkv + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(dk + row + 8 * j + 2 * t) =
          make_float2(dk_acc[j][2 * rr], dk_acc[j][2 * rr + 1]);
      *reinterpret_cast<float2*>(dv + row + 8 * j + 2 * t) =
          make_float2(dv_acc[j][2 * rr], dv_acc[j][2 * rr + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ q_offset, float* __restrict__ dq,
                    int sq, int skv, int hq, int hkv, int window, float scale,
                    float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile * kStride];
  const int hh = blockIdx.y, b = blockIdx.z, h = hh / (hq / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int klen = min(kv_len[b], skv), qo = q_offset[b];
  // Query tiles last-first: the late ones see the most keys.
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile, iw = i0 + 16 * warp;
  const size_t q_stride = static_cast<size_t>(hq) * kD;
  const size_t kv_stride = static_cast<size_t>(hkv) * kD;

  float dq_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[j][c] = 0.f;

  // Keys some query of the tile can see.
  const int i_last = min(i0 + kTile, sq) - 1;
  const int k_lo = window > 0 ? max(0, qo + i0 - window + 1) : 0;
  const int k_hi = min(klen, qo + i_last + 1);
  if (k_lo < k_hi) {
    uint32_t qf[4][4], of[4][4];
    const size_t q_base = (static_cast<size_t>(b) * sq * hq + hh) * kD;
    load_a_rows(qf, q + q_base, q_stride, iw, sq, lane);
    load_a_rows(of, dout + q_base, q_stride, iw, sq, lane);
    float l2[2], dl[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = iw + g + 8 * rr;
      const size_t li = (static_cast<size_t>(b) * sq + i) * hq + hh;
      l2[rr] = i < sq ? lse_log2(lse[li]) : 0.f;
      dl[rr] = i < sq ? delta[li] : 0.f;
    }
    const size_t kv_base = (static_cast<size_t>(b) * skv * hkv + h) * kD;
    for (int kt0 = (k_lo / kTile) * kTile; kt0 < k_hi; kt0 += kTile) {
      __syncthreads();
      load_tile(k_s, k + kv_base, kv_stride, kt0, klen, tid);
      load_tile(v_s, v + kv_base, kv_stride, kt0, klen, tid);
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * kHalf;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
        // S = Q K^T and dP = dO V^T: B from the rows of K and V.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const int off = (c0 + 16 * jp + 8 * (mi >> 1) + mr) * kStride +
                            16 * kk + 8 * (mi & 1);
            uint32_t bk[4], bv[4];
            ldsm_x4(bk, smem_addr(k_s + off));
            ldsm_x4(bv, smem_addr(v_s + off));
            mp::mma_bf16_16816(s[2 * jp], qf[kk], bk[0], bk[1]);
            mp::mma_bf16_16816(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
            mp::mma_bf16_16816(dp[2 * jp], of[kk], bv[0], bv[1]);
            mp::mma_bf16_16816(dp[2 * jp + 1], of[kk], bv[2], bv[3]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int rr = c >> 1;
            const int key = kt0 + c0 + 8 * j + 2 * t + (c & 1);
            const float p =
                visible(iw + g + 8 * rr, key, sq, klen, qo, window)
                    ? exp2f(s[j][c] * scale_log2 - l2[rr])
                    : 0.f;
            dp[j][c] = p * (dp[j][c] - dl[rr]) * scale;
          }
        // dQ += dS K: B from the rows of K, transposed.
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t da[4];
          acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            const int off = (c0 + 16 * kk + 8 * (mi & 1) + mr) * kStride +
                            16 * jp + 8 * (mi >> 1);
            uint32_t bk[4];
            ldsm_x4_t(bk, smem_addr(k_s + off));
            mp::mma_bf16_16816(dq_acc[2 * jp], da, bk[0], bk[1]);
            mp::mma_bf16_16816(dq_acc[2 * jp + 1], da, bk[2], bk[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = iw + g + 8 * rr;
    if (i >= sq) continue;
    const size_t row = ((static_cast<size_t>(b) * sq + i) * hq + hh) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dq + row + 8 * j + 2 * t) =
          make_float2(dq_acc[j][2 * rr], dq_acc[j][2 * rr + 1]);
  }
}

}  // namespace

// delta: f32 scratch [B, Sq, Hq]; dq [B, Sq, Hq, 64], dk and dv
// [B, Skv, Hkv, 64] f32, every element written.
extern "C" int mp_flash_prefill_bwd(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    const void* kv_len, const void* q_offset,
                                    void* delta, void* dq, void* dk, void* dv,
                                    int batch, int sq, int skv, int hq,
                                    int hkv, int head_dim, int window,
                                    float sm_scale, void* stream) {
  if (head_dim != kD || hkv <= 0 || hq % hkv != 0 || batch <= 0 || sq <= 0 ||
      skv <= 0 || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(out);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* len = static_cast<const int*>(kv_len);
  const auto* off = static_cast<const int*>(q_offset);
  auto* dl = static_cast<float*>(delta);
  const int rows = batch * sq * hq;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(ob, db, dl, rows);
  const float scale_log2 = sm_scale * mp::kLog2e;
  flash_bwd_dkdv_kernel<<<dim3((skv + kTile - 1) / kTile, hkv, batch),
                          kThreads, 0, st>>>(
      qb, kb, vb, db, lb, dl, len, off, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, skv, hq, hkv, window, sm_scale,
      scale_log2);
  flash_bwd_dq_kernel<<<dim3((sq + kTile - 1) / kTile, hq, batch), kThreads,
                        0, st>>>(qb, kb, vb, db, lb, dl, len, off,
                                 static_cast<float*>(dq), sq, skv, hq, hkv,
                                 window, sm_scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
