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
// dq, dk, dv out in f32. Head dims 16, 32, 64 and 128, any group size.
//
// Bound on the H100: at the RULER byte model's size (B = 8, S = 8192, 8/4
// heads of 64) one layer's backward is ~1.9 TFLOP of products (seven per
// visible (query, key) pair of heads, below) against ~50 MB of inputs and
// outputs, so it is bound by tensor-core operations and runs every product
// on warpgroup MMAs (wgmma) fed by TMA, in the manner of the forward
// (flash_prefill.cu). One template for the four head dims: a tile's rows
// are d * 2 bytes and the 128-byte swizzle spans 64 columns, so a tile is
// d / 64 column halves of 128-byte rows (one below 64: its 64-column TMA
// box reads the d columns and zero-fills the rest), each half its own TMA
// boxes of 64 rows (8 KB) and swizzle pattern; only d columns are written
// back. A call runs three kernels:
//  - delta: one warp per (request, query head, row of the query span
//    padded to 128), rowsum(dO * O) and lse in log2 units (0 for -inf), both
//    into a [B, Hq, Sq padded] scratch, so that a tile's 64 values are one
//    256-byte bulk copy; padded rows hold 0;
//  - dK/dV: one block per (128 keys, kv head, request), two warpgroups of
//    64 keys each. The block's K and V tiles come by TMA once; then it
//    walks every (query head of the group, 64-query tile) that can see its
//    keys (from the first query at or after its first key to the window's
//    end; any group size is a run-time loop), Q and dO by TMA and lse and
//    delta by bulk copies into a three-stage ring with full and empty
//    mbarriers. Thread 0 issues the copies, refilling each stage as soon as
//    both warpgroups have released it (polled, so that one warpgroup may
//    run two steps ahead of the other). There is no producer warp: at d =
//    128 a warpgroup's dK and dV alone are 128 registers a thread, ~250
//    with S^T and dP^T, and ptxas holds a 384-thread block to 168 whatever
//    setmaxnreg asks (this kernel spilled there), while 256 threads may
//    take 255. S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16 from shared
//    memory (K-major); P^T and dS^T in registers on the accumulator layout,
//    rounded to bf16 as the register A operands of dV += P^T dO and
//    dK += dS^T Q (dO and Q read through transposed, MN-major
//    descriptors). Each product is its own commit group, so that P^T is
//    formed while dP^T runs and dS^T while dV's product runs. dK and dV
//    stay in registers and are written once; no atomics: a key's sums
//    belong to one warpgroup.
//  - dQ: one block per (128 queries, query head, request), the last query
//    tiles first, 384 threads. A producer warpgroup brings the Q and dO
//    tiles once, then 64-key K and V tiles through a two-stage ring; each
//    of two consumer warpgroups (64 queries; dQ, S and dP fit in 168
//    registers) recomputes S = Q K^T and dP = dO V^T (p formed while dP
//    runs), p and dS, and runs dQ += dS K with dS as the register A
//    operand and K through a transposed descriptor. This costs three more
//    products per pair (seven in all, against five with f32 atomics into
//    dQ from the dK/dV blocks), and in return dQ is deterministic: the same
//    inputs give the same bits on every run.
// The softmax scale multiplies dK and dQ once, when they are written, not
// every dS.
// Only tiles that some row can see are loaded; the mask is evaluated only
// on tiles that cross the diagonal, the window's edge, kv_len or the query
// span's end, and masked pairs give p = dS = 0 by selection, so a NaN in
// the rows past kv_len reaches no sum; the dQ kernel zeroes K rows past
// kv_len in shared memory on the tile that holds them (0 * NaN is NaN in
// dS K), and TMA zero-fills rows past the tensors' ends. dK and dV rows
// past kv_len are 0.
#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kRows = 64;                 // rows of a streamed tile
constexpr int kStages = 2;                // dQ's ring
constexpr int kDkdvStages = 3;            // dK/dV's ring
constexpr int kThreads = 384;             // dQ: producer + 2 consumers
constexpr int kDkdvThreads = 256;         // dK/dV: 2 warpgroups
constexpr uint32_t kBox = kRows * 128;    // one TMA box: 64 rows x 128 B
constexpr int kPad = 128;                 // the query span's padding

// Column halves of a tile of head dim kD: kD / 64, and one below 64.
template <int kD>
__host__ __device__ constexpr int halves() {
  return kD < 64 ? 1 : kD / 64;
}

// A 64-row tile (halves of 8 KB) and a 128-row one (halves of 16 KB, rows
// 64 .. 127 of a half 8 KB in: a warpgroup's rows are one box).
template <int kD>
__host__ __device__ constexpr uint32_t tile64() {
  return kBox * halves<kD>();
}

// Two 128-row tiles and a ring of `stages` pairs of 64-row tiles.
template <int kD, int stages>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * 2 * tile64<kD>() + 2 * stages * tile64<kD>() + 1024;
}

// Descriptor offsets (16-byte units) of k-step kk of a K-major operand whose
// halves are `half` bytes apart, and of an MN-major one (16 rows a step).
__device__ __forceinline__ uint64_t k_step(int kk, uint32_t half) {
  return (kk / 4) * (half >> 4) + 2 * (kk % 4);
}

__device__ __forceinline__ uint64_t mn_step(int c, int kk) {
  return c * (kBox >> 4) + 128 * kk;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (hp::smem_u32(p) & 1023u)) & 1023u);
}

// The mask of one thread's accumulator tile: element x sits in row r =
// (x >> 1) & 1 and column c = 8 (x / 4) + (x & 1) past the thread's own
// first column. With lag[r] = (query position - key) at column 0 of row r,
// the pair is visible when the row and column are in range, 0 <= lag[r] +
// sign c (causal) and lag[r] + sign c < window: c is a constant after
// unrolling, so an element costs a few compares. sign is +1 where columns
// are queries (dK/dV), -1 where they are keys (dQ).
template <int kSign>
__device__ __forceinline__ void mask_tile(float (&p)[32], const bool (&row_ok)[2],
                                          const int (&lag)[2], int col_lim,
                                          int window) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int c = 8 * (x / 4) + (x & 1), r = (x >> 1) & 1;
    const int d = lag[r] + kSign * c;
    if (!(row_ok[r] && c < col_lim && d >= 0 && (window <= 0 || d < window)))
      p[x] = 0.f;
  }
}

// The register A operands of a 64 x 64 product's four k-steps from its f32
// accumulators (C layout of two adjacent 8-column blocks == A layout of one
// 16-column step), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = mp::pack_f32_as_bf16(acc[8 * kk + 2 * r],
                                      acc[8 * kk + 2 * r + 1]);
}

// A 64 x 64 x kD product on wgmma, acc = A B^T, as one commit group: the A
// operand's halves `a_half` bytes apart and the B operand's `b_half`.
template <int kD>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint64_t a,
                                           uint64_t b, uint32_t a_half,
                                           uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    hp::wgmma_ss_m64n64k16(acc, a + k_step(kk, a_half), b + k_step(kk, b_half),
                           kk);
  hp::wgmma_commit();
}

// acc (+)= A B over 64 keys or queries (4 k-steps of 16 rows of the 64-row
// tile B, MN-major) in each column half, A the register operands, as one
// commit group.
template <int kHalves>
__device__ __forceinline__ void product_rs(float (&acc)[kHalves][32],
                                           const uint32_t (&a)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_rs_m64n64k16(acc[c], a[kk], b + mn_step(c, kk), 1);
  hp::wgmma_commit();
}

__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ lse2,
                       float* __restrict__ delta, int sq, int sq_pad, int hq,
                       int d, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % sq_pad, bh = row / sq_pad;
  const int hh = bh % hq, b = bh / hq;
  float sum = 0.f, l2 = 0.f;
  if (i < sq) {
    const size_t at = (static_cast<size_t>(b) * sq + i) * hq + hh;
    const __nv_bfloat162* o =
        reinterpret_cast<const __nv_bfloat162*>(out + at * d);
    const __nv_bfloat162* g =
        reinterpret_cast<const __nv_bfloat162*>(dout + at * d);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 x = __bfloat1622float2(o[c]), y = __bfloat1622float2(g[c]);
      sum += x.x * y.x + x.y * y.y;
    }
    sum = mp::warp_sum(sum);
    const float l = lse[at];
    l2 = l == mp::kNegInf ? 0.f : l * mp::kLog2e;
  }
  if (lane == 0) {
    lse2[row] = l2;
    delta[row] = sum;
  }
}

template <int kD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_len,
                      const int* __restrict__ q_offset,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int batch, int sq, int sq_pad, int skv, int hq, int hkv,
                      int window, float scale, float scale_log2) {
  constexpr int kHalves = halves<kD>();
  constexpr uint32_t kTile = tile64<kD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kDkdvStages], empty[kDkdvStages];
  __shared__ __align__(16) float lse_s[kDkdvStages][kRows];
  __shared__ __align__(16) float delta_s[kDkdvStages][kRows];

  uint8_t* k_s = align_1024(smem_raw);          // 128 rows, halves of 16 KB
  uint8_t* v_s = k_s + 2 * kTile;
  uint8_t* q_s = v_s + 2 * kTile;               // stage s at s * kTile
  uint8_t* do_s = q_s + kDkdvStages * kTile;

  // Key tiles first-first: the early ones see the most queries.
  const int per_tile = hkv * batch;
  const int k0 = static_cast<int>(blockIdx.x) / per_tile * 2 * kRows;
  const int h = static_cast<int>(blockIdx.x) % per_tile % hkv;
  const int b = static_cast<int>(blockIdx.x) % per_tile / hkv;
  const int group = hq / hkv;
  const int klen = min(kv_len[b], skv), qo = q_offset[b];
  // Queries that can see a key of the block: from the first at or after
  // its first key to the last inside the window of its last valid key.
  const int i_lo = max(0, k0 - qo);
  const int i_hi = window > 0
                       ? min(sq, min(k0 + 2 * kRows, klen) - 1 + window - qo)
                       : sq;
  const int it0 = i_lo / kRows * kRows;
  const int n_qt = i_lo < i_hi ? (i_hi - it0 + kRows - 1) / kRows : 0;
  const int n_steps = k0 < klen ? group * n_qt : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < kDkdvStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);            // one arrival per warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  // Step n's Q and dO tiles, lse and delta into stage n % kDkdvStages.
  auto issue = [&](int n) {
    const int s = n % kDkdvStages;
    const int hh = h * group + n / n_qt;
    const int i0 = it0 + (n % n_qt) * kRows;
    const size_t row = (static_cast<size_t>(b) * hq + hh) * sq_pad + i0;
    hp::mbar_arrive_expect_tx(&full[s], 2 * kTile + 2 * kRows * 4);
#pragma unroll
    for (int c = 0; c < kHalves; ++c) {
      hp::tma_load_4d(q_s + s * kTile + c * kBox, &tm_q, 64 * c, hh, i0, b,
                      &full[s]);
      hp::tma_load_4d(do_s + s * kTile + c * kBox, &tm_do, 64 * c, hh, i0, b,
                      &full[s]);
    }
    hp::bulk_load(lse_s[s], lse2 + row, kRows * 4, &full[s]);
    hp::bulk_load(delta_s[s], delta + row, kRows * 4, &full[s]);
  };
  if (threadIdx.x == 0 && n_steps > 0) {
    hp::mbar_arrive_expect_tx(&kv_full, 4 * kTile);
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at = c * 2 * kBox + r * kBox;
        hp::tma_load_4d(k_s + at, &tm_k, 64 * c, h, k0 + kRows * r, b,
                        &kv_full);
        hp::tma_load_4d(v_s + at, &tm_v, 64 * c, h, k0 + kRows * r, b,
                        &kv_full);
      }
    for (int n = 0; n < min(kDkdvStages, n_steps); ++n) issue(n);
  }

  // Warpgroup cw owns keys kw .. kw + 63; this thread keys key_a and
  // key_a + 8 of them (the accumulator layout), and query columns 8 j + 2 tq
  // and + 1 of each tile.
  const int cw = threadIdx.x / 128;
  const int tw = threadIdx.x - 128 * cw;
  const int warp = tw >> 5, lane = tw & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int kw = k0 + cw * kRows;
  const int key_a = kw + warp * 16 + gr, key_b = key_a + 8;

  float dk_acc[kHalves][32], dv_acc[kHalves][32];
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  if (n_steps > 0) {
    const uint64_t k_desc = hp::sw128_desc(k_s + cw * kBox);
    const uint64_t v_desc = hp::sw128_desc(v_s + cw * kBox);
    int next = min(kDkdvStages, n_steps);         // thread 0: steps issued
    hp::mbar_wait(&kv_full, 0);
    for (int n = 0; n < n_steps; ++n) {
      const int s = n % kDkdvStages;
      const int i0 = it0 + (n % n_qt) * kRows;
      const uint64_t q_desc = hp::sw128_desc(q_s + s * kTile);
      const uint64_t do_desc = hp::sw128_desc(do_s + s * kTile);
      // Thread 0 refills every stage both warpgroups have released, and
      // waits only when this step's own copies are not issued yet: a
      // warpgroup runs up to two steps ahead of the other.
      if (threadIdx.x == 0) {
        for (; next < n_steps && next < n + kDkdvStages; ++next) {
          const int held = next - kDkdvStages;   // the step it last held
          const uint32_t parity = (held / kDkdvStages) & 1;
          uint64_t* bar = &empty[next % kDkdvStages];
          if (next > n) {
            if (!hp::mbar_try_wait(hp::smem_u32(bar), parity)) break;
          } else {
            hp::mbar_wait(bar, parity);
          }
          issue(next);
        }
      }
      __syncwarp();
      hp::mbar_wait(&full[s], (n / kDkdvStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T (keys down, queries across), two
      // commit groups: P^T is formed while dP^T runs.
      float st[32], dpt[32];
      hp::wgmma_fence();
      product_ss<kD>(st, k_desc, q_desc, 2 * kBox, kBox);
      product_ss<kD>(dpt, v_desc, do_desc, 2 * kBox, kBox);
      hp::wgmma_wait<1>();
      hp::fence_regs(st);

      // P^T; the mask only on tiles that cross the diagonal, an edge,
      // kv_len or the query span's end (a masked p is exactly 0), in a
      // branch: tested on every tile it was the step's largest cost, and a
      // copy of the whole step for masked tiles ran slower still.
      const bool need_mask = i0 + kRows > sq || kw + kRows > klen ||
                             kw + kRows - 1 > qo + i0 ||
                             (window > 0 && qo + i0 + kRows - 1 - kw >= window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(&lse_s[s][8 * j + 2 * tq]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] =
              hp::ex2(fmaf(st[4 * j + e], scale_log2, (e & 1) ? -l.y : -l.x));
      }
      if (need_mask) {
        const int q0 = qo + i0 + 2 * tq;          // column 0's position
        mask_tile<1>(st, {key_a < klen, key_b < klen}, {q0 - key_a, q0 - key_b},
                     sq - i0 - 2 * tq, window);
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(pa, st);

      // dV += P^T dO (dO through a transposed descriptor), running while
      // dS^T / scale is formed (dK is scaled once, when written).
      hp::wgmma_fence();
      product_rs<kHalves>(dv_acc, pa, do_desc);
      hp::wgmma_wait<1>();
      hp::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(&delta_s[s][8 * j + 2 * tq]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
      if (need_mask) {         // a NaN past kv_len times a masked p of 0
#pragma unroll
        for (int x = 0; x < 32; ++x)
          if (st[x] == 0.f) dpt[x] = 0.f;
      }
      acc_to_a(da, dpt);

      // dK += dS^T Q.
      hp::wgmma_fence();
      product_rs<kHalves>(dk_acc, da, q_desc);
      hp::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kHalves; ++c) {
        hp::fence_regs(dv_acc[c]);
        hp::fence_regs(dk_acc[c]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::fence_regs(pa[kk]);
        hp::fence_regs(da[kk]);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[s]);
    }
  }

  // Every key row below skv is written: zeros where no query sees it.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = rr ? key_b : key_a;
    if (key >= skv) continue;
    const size_t row = ((static_cast<size_t>(b) * skv + key) * hkv + h) * kD;
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * tq;
        if (col >= kD) continue;
        *reinterpret_cast<float2*>(dk + row + col) =
            make_float2(dk_acc[c][4 * j + 2 * rr] * scale,
                        dk_acc[c][4 * j + 2 * rr + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + col) =
            make_float2(dv_acc[c][4 * j + 2 * rr], dv_acc[c][4 * j + 2 * rr + 1]);
      }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ q_offset, float* __restrict__ dq,
                    int batch, int sq, int sq_pad, int skv, int hq, int hkv,
                    int window, float scale, float scale_log2) {
  constexpr int kHalves = halves<kD>();
  constexpr uint32_t kTile = tile64<kD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  uint8_t* q_s = align_1024(smem_raw);          // 128 rows, halves of 16 KB
  uint8_t* do_s = q_s + 2 * kTile;
  uint8_t* k_s = do_s + 2 * kTile;              // stage s at s * kTile
  uint8_t* v_s = k_s + kStages * kTile;

  // Query tiles last-first: the late ones see the most keys.
  const int n_qtiles = sq_pad / (2 * kRows);
  const int per_tile = hq * batch;
  const int q0 =
      (n_qtiles - 1 - static_cast<int>(blockIdx.x) / per_tile) * 2 * kRows;
  const int hh = static_cast<int>(blockIdx.x) % per_tile % hq;
  const int b = static_cast<int>(blockIdx.x) % per_tile / hq;
  const int h = hh / (hq / hkv);
  const int klen = min(kv_len[b], skv), qo = q_offset[b];
  // Keys some query of the block can see: [lo, hi), walked in tiles.
  const int q_last = min(q0 + 2 * kRows, sq) - 1;
  const int hi = min(klen, qo + q_last + 1);
  const int lo = window > 0 ? max(0, qo + q0 - window + 1) : 0;
  const int t_begin = lo / kRows * kRows;
  const int ntiles = hi > lo ? (hi - t_begin + kRows - 1) / kRows : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hp::regs_dec<24>();
    if (threadIdx.x == 0 && ntiles > 0) {
      hp::mbar_arrive_expect_tx(&q_full, 4 * kTile);
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t at = c * 2 * kBox + r * kBox;
          hp::tma_load_4d(q_s + at, &tm_q, 64 * c, hh, q0 + kRows * r, b,
                          &q_full);
          hp::tma_load_4d(do_s + at, &tm_do, 64 * c, hh, q0 + kRows * r, b,
                          &q_full);
        }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % kStages;
        const int t0 = t_begin + n * kRows;
        if (n >= kStages) hp::mbar_wait(&empty[s], (n / kStages - 1) & 1);
        hp::mbar_arrive_expect_tx(&full[s], 2 * kTile);
#pragma unroll
        for (int c = 0; c < kHalves; ++c) {
          hp::tma_load_4d(k_s + s * kTile + c * kBox, &tm_k, 64 * c, h, t0, b,
                          &full[s]);
          hp::tma_load_4d(v_s + s * kTile + c * kBox, &tm_v, 64 * c, h, t0, b,
                          &full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns queries qw .. qw + 63; this thread rows
  // i_a and i_a + 8 of them, and key columns 8 j + 2 tq and + 1 of a tile.
  hp::regs_inc<240>();
  const int cw = wg - 1;
  const int tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int qw = q0 + cw * kRows;
  const int i_a = qw + warp * 16 + gr, i_b = i_a + 8;
  const size_t row0 = (static_cast<size_t>(b) * hq + hh) * sq_pad;
  const float l_a = lse2[row0 + i_a], l_b = lse2[row0 + i_b];
  const float d_a = delta[row0 + i_a], d_b = delta[row0 + i_b];

  float dq_acc[kHalves][32];
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[c][i] = 0.f;

  if (ntiles > 0) {
    const uint64_t q_desc = hp::sw128_desc(q_s + cw * kBox);
    const uint64_t do_desc = hp::sw128_desc(do_s + cw * kBox);
    hp::mbar_wait(&q_full, 0);
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % kStages;
      const int t0 = t_begin + n * kRows;
      uint8_t* k_tile = k_s + s * kTile;
      hp::mbar_wait(&full[s], (n / kStages) & 1);
      if (t0 + kRows > klen && klen < skv) {       // block-uniform
        // K rows past kv_len to zero (whole rows: swizzle-free).
        const uint4 zero = make_uint4(0, 0, 0, 0);
        uint4* rows = reinterpret_cast<uint4*>(k_tile);
        for (int c = max(klen - t0, 0) * 8 + cw * 128 + tw; c < kRows * 8;
             c += 256)
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf) rows[hf * (kBox / 16) + c] = zero;
        hp::fence_proxy_async();
        hp::named_barrier(1, 256);
      }
      const uint64_t k_desc = hp::sw128_desc(k_tile);
      const uint64_t v_desc = hp::sw128_desc(v_s + s * kTile);

      // S = Q K^T and dP = dO V^T (queries down, keys across), two commit
      // groups: p is formed while dP runs.
      float sc[32], dp[32];
      hp::wgmma_fence();
      product_ss<kD>(sc, q_desc, k_desc, 2 * kBox, kBox);
      product_ss<kD>(dp, do_desc, v_desc, 2 * kBox, kBox);
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);

      // p, the mask in a branch as in dK/dV; then dS / scale (dQ is scaled
      // once, when written).
      const bool need_mask = t0 + kRows - 1 > qo + qw || t0 + kRows > klen ||
                             (window > 0 && qo + qw + kRows - 1 - t0 >= window);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sc[x] = hp::ex2(fmaf(sc[x], scale_log2, (x & 2) ? -l_b : -l_a));
      if (need_mask) {
        const int k0 = t0 + 2 * tq;               // column 0's key
        mask_tile<-1>(sc, {i_a < sq, i_b < sq}, {qo + i_a - k0, qo + i_b - k0},
                      klen - k0, window);
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        dp[x] = sc[x] * (dp[x] - ((x & 2) ? d_b : d_a));
      if (need_mask) {         // a NaN past kv_len times a masked p of 0
#pragma unroll
        for (int x = 0; x < 32; ++x)
          if (sc[x] == 0.f) dp[x] = 0.f;
      }
      uint32_t da[4][4];
      acc_to_a(da, dp);

      // dQ += dS K (K through a transposed descriptor).
      hp::wgmma_fence();
      product_rs<kHalves>(dq_acc, da, k_desc);
      hp::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kHalves; ++c) hp::fence_regs(dq_acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hp::fence_regs(da[kk]);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[s]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = rr ? i_b : i_a;
    if (i >= sq) continue;
    const size_t row = ((static_cast<size_t>(b) * sq + i) * hq + hh) * kD;
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * tq;
        if (col >= kD) continue;
        *reinterpret_cast<float2*>(dq + row + col) =
            make_float2(dq_acc[c][4 * j + 2 * rr] * scale,
                        dq_acc[c][4 * j + 2 * rr + 1] * scale);
      }
  }
}

template <int kD>
int launch_bwd(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
               const CUtensorMap& tm_v, const CUtensorMap& tm_do,
               const float* lse2, const float* delta, const int* kv_len,
               const int* q_offset, float* dq, float* dk, float* dv, int batch,
               int sq, int sq_pad, int skv, int hq, int hkv, int window,
               float sm_scale, cudaStream_t stream) {
  static unsigned dkdv_set = 0, dq_set = 0;
  constexpr int kDkdvSmem = smem_bytes<kD, kDkdvStages>();
  constexpr int kDqSmem = smem_bytes<kD, kStages>();
  cudaError_t err =
      hp::allow_smem(flash_bwd_dkdv_kernel<kD>, kDkdvSmem, dkdv_set);
  if (err == cudaSuccess)
    err = hp::allow_smem(flash_bwd_dq_kernel<kD>, kDqSmem, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = sm_scale * mp::kLog2e;
  const int n_ktiles = (skv + 2 * kRows - 1) / (2 * kRows);
  flash_bwd_dkdv_kernel<kD><<<n_ktiles * hkv * batch, kDkdvThreads,
                              kDkdvSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse2, delta, kv_len, q_offset, dk, dv, batch,
      sq, sq_pad, skv, hq, hkv, window, sm_scale, scale_log2);
  flash_bwd_dq_kernel<kD><<<(sq_pad / (2 * kRows)) * hq * batch, kThreads,
                            kDqSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse2, delta, kv_len, q_offset, dq, batch, sq,
      sq_pad, skv, hq, hkv, window, sm_scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: f32 [2, B, Hq, Sq padded to a multiple of 128] (lse in log2
// units, then delta); dq [B, Sq, Hq, d], dk and dv [B, Skv, Hkv, d] f32,
// every element written; head_dim 16, 32, 64 or 128.
extern "C" int mp_flash_prefill_bwd(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    const void* kv_len, const void* q_offset,
                                    void* scratch, void* dq, void* dk, void* dv,
                                    int batch, int sq, int skv, int hq,
                                    int hkv, int head_dim, int window,
                                    float sm_scale, void* stream) {
  if (!mp::head_dim_ok(head_dim) || hkv <= 0 || hq % hkv != 0 || batch <= 0 ||
      sq <= 0 || skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Boxes of 64 columns (one 128-byte swizzle span) by 64 rows; at d = 16
  // and 32 the columns past d come zero-filled.
  const uint32_t box[4] = {64, 1, kRows, 1};
  const uint64_t d = static_cast<uint64_t>(head_dim);
  const uint64_t qdim[4] = {d, static_cast<uint64_t>(hq),
                            static_cast<uint64_t>(sq),
                            static_cast<uint64_t>(batch)};
  const uint64_t kdim[4] = {d, static_cast<uint64_t>(hkv),
                            static_cast<uint64_t>(skv),
                            static_cast<uint64_t>(batch)};
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!hp::bf16_map_4d(&tm_q, q, qdim, box) ||
      !hp::bf16_map_4d(&tm_do, dout, qdim, box) ||
      !hp::bf16_map_4d(&tm_k, k, kdim, box) ||
      !hp::bf16_map_4d(&tm_v, v, kdim, box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sq_pad = (sq + kPad - 1) / kPad * kPad;
  const int rows = batch * hq * sq_pad;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + rows;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      lse2, delta, sq, sq_pad, hq, head_dim, rows);
  const auto* len = static_cast<const int*>(kv_len);
  const auto* off = static_cast<const int*>(q_offset);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
#define MP_BWD(D)                                                            \
  launch_bwd<D>(tm_q, tm_k, tm_v, tm_do, lse2, delta, len, off, dqf, dkf,  \
                dvf, batch, sq, sq_pad, skv, hq, hkv, window, sm_scale, st)
  switch (head_dim) {
    case 16: return MP_BWD(16);
    case 32: return MP_BWD(32);
    case 64: return MP_BWD(64);
    default: return MP_BWD(128);
  }
#undef MP_BWD
}
