// Causal flash prefill attention for Hopper.
//
// Replaces magicpig_tpu/ops/pallas/prefill.py::flash_prefill_pallas (the
// pallas_call at prefill.py:249). Same contract: queries at absolute
// positions q_offset[b] + i attend keys t with t <= position, t < length[b]
// and, with a window, position - t < window; optional natural-log LSE out.
//
// Bound on the H100: at Llama-3.2-1B width (d = 64) an 8K prompt is ~275
// GFLOP of attention per layer against ~50 MB of q/k/v/out, at
// Llama-3.1-8B width (d = 128) twice both, so the kernel is compute-bound
// and has to run on the tensor cores at the warpgroup rate. One template
// for head dims 16, 32, 64 and 128: a tile's rows are d * 2 bytes, and the
// 128-byte swizzle spans 64 columns, so a tile is d / 64 column halves of
// 128-byte rows, each its own TMA box and swizzle pattern (16 KB for 128
// rows) placed one after the other. Below d = 64 a tile is one such half:
// its TMA box of 64 columns reads the d columns of each row and fills the
// rest with zeros (columns past the tensor's d), S takes d / 16 k-steps,
// and P.V runs over the 64 columns, of which the output keeps the first d.
// Design, one block per (128 queries, query head, request), 384 threads:
//  - a producer warpgroup (40 registers after setmaxnreg) whose first
//    thread brings the Q tile and then 128-key K and V tiles by TMA, with
//    the 128-byte swizzle, into a two-stage ring of shared memory, each
//    stage with a full and an empty mbarrier for K and for V (161 KB of
//    shared memory at d = 128);
//  - two consumer warpgroups (232 registers), 64 query rows each:
//    S = Q K^T on wgmma m64n128k16 from shared memory (d / 16 k-steps, the
//    descriptor moving to the next column half after 4), the online
//    softmax in registers on the accumulator layout (log2 units), P
//    rounded to bf16 in registers as the A operand of O += P V on wgmma
//    m64n64k16, one per column half of V, read through a transposed
//    (MN-major) descriptor;
//  - the G query heads of a kv head sit in neighbouring blocks and share
//    each K/V tile through L2 (K and V of an 8K layer are 16 MB);
//  - only key tiles that some row of the block can see are loaded; the
//    mask is evaluated only on tiles that cross the causal diagonal, the
//    window's edge or the length; V rows past the length are zeroed in
//    shared memory on the tile that holds them (a probability of 0 times a
//    NaN there is NaN), and TMA zero-fills rows past the tensor's end;
//  - query tiles start last-first, so the longest causal rows go first;
//  - the output is staged in bf16 in the block's Q tile (XOR-swizzled
//    16-byte chunks) and stored with 16-byte stores.
#include "common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBM = 128;                        // query rows per block
constexpr int kBN = 128;                        // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;                   // producer + 2 consumers
constexpr uint32_t kHalfBytes = kBN * 64 * 2;   // 64 columns of a tile: 16 KB

// Column halves of a tile of head dim kD: kD / 64, and one below 64.
template <int kD>
__host__ __device__ constexpr int halves() {
  return kD < 64 ? 1 : kD / 64;
}

// A K, V or Q tile of head dim kD.
template <int kD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kHalfBytes * halves<kD>();
}

template <int kD>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<kD>() + 1024;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int* __restrict__ length,
                     const int* __restrict__ q_offset,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int sq, int skv, int hq, int hkv, int window,
                     int n_qtiles, float scale_log2) {
  constexpr int kHalves = halves<kD>();
  constexpr uint32_t kTileBytes = tile_bytes<kD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], k_empty[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages], v_empty[kStages];

  // 128-byte swizzled tiles need a 1024-byte aligned base.
  uint8_t* q_s =
      smem_raw + ((1024u - (hp::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* k_s = q_s + kTileBytes;                 // stage i at i * kTileBytes
  uint8_t* v_s = k_s + kStages * kTileBytes;

  const int heads_x_batch = gridDim.x / n_qtiles;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads_x_batch;
  const int h = static_cast<int>(blockIdx.x) % heads_x_batch % hq;
  const int b = static_cast<int>(blockIdx.x) % heads_x_batch / hq;
  const int kh = h / (hq / hkv);
  const int len = min(length[b], skv);
  const int qoff = q_offset[b];
  const int q0 = qt * kBM;
  const int q_last = min(q0 + kBM, sq) - 1;
  // Keys the block can see: [lo, hi), walked in tiles from t_begin.
  const int hi = min(len, qoff + q_last + 1);
  const int lo = window > 0 ? max(0, qoff + q0 - window + 1) : 0;
  const int t_begin = (lo / kBN) * kBN;
  const int ntiles = hi > lo ? (hi - t_begin + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&k_empty[s], 8);         // one arrival per consumer warp
      hp::mbar_init(&v_empty[s], 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    hp::regs_dec<40>();
    if (threadIdx.x == 0 && ntiles > 0) {
      hp::mbar_arrive_expect_tx(&q_full, kTileBytes);
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        hp::tma_load_4d(q_s + c * kHalfBytes, &tm_q, 64 * c, h, q0, b, &q_full);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        const uint32_t round = i / kStages;
        const int t0 = t_begin + i * kBN;
        if (i >= kStages) hp::mbar_wait(&k_empty[s], (round - 1) & 1);
        hp::mbar_arrive_expect_tx(&k_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hp::tma_load_4d(k_s + s * kTileBytes + c * kHalfBytes, &tm_k, 64 * c,
                          kh, t0, b, &k_full[s]);
        if (i >= kStages) hp::mbar_wait(&v_empty[s], (round - 1) & 1);
        hp::mbar_arrive_expect_tx(&v_full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hp::tma_load_4d(v_s + s * kTileBytes + c * kHalfBytes, &tm_v, 64 * c,
                          kh, t0, b, &v_full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns block rows cw * 64 .. cw * 64 + 63; this
  // thread rows r0 and r0 + 8 of them (the accumulator layout).
  hp::regs_inc<232>();
  const int cw = wg - 1;
  const int tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = cw * 64 + warp * 16 + gr;
  const int pos0 = qoff + q0 + r0, pos1 = pos0 + 8;
  // The warpgroup's rows of each column half of Q.
  const uint64_t q_desc = hp::sw128_desc(q_s + cw * 64 * 128);

  float o[kHalves][32];                         // O's columns 64 c .. 64 c + 63
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = mp::kNegInf, m1 = mp::kNegInf;     // running max, raw scores
  float l0 = 0.f, l1 = 0.f;                     // this thread's partial sums

  if (ntiles > 0) hp::mbar_wait(&q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int t0 = t_begin + i * kBN;

    // S = Q K^T: d / 16 k-steps of 16 (32 bytes each), four in each column
    // half (16 KB further on: 1024 in the descriptor's 16-byte units).
    float sc[64];
    const uint64_t k_desc = hp::sw128_desc(k_s + s * kTileBytes);
    hp::mbar_wait(&k_full[s], parity);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint64_t step = (kk / 4) * (kHalfBytes >> 4) + 2 * (kk % 4);
      hp::wgmma_ss_m64n128k16(sc, q_desc + step, k_desc + step, kk);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&k_empty[s]);

    // Mask, only on tiles that cross the diagonal, an edge or the length.
    const bool need_mask = t0 + kBN - 1 > qoff + q0 || t0 + kBN > len ||
                           (window > 0 && qoff + q_last - t0 >= window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + j * 8 + 2 * tq + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          bool ok = key <= pos && key < len;
          if (window > 0) ok = ok && pos - key < window;
          if (!ok) sc[4 * j + e] = mp::kNegInf;
        }
    }

    // Online softmax; the row max runs over the quad's 4 threads.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mu0 = mx0 == mp::kNegInf ? 0.f : mx0 * scale_log2;
    const float mu1 = mx1 == mp::kNegInf ? 0.f : mx1 * scale_log2;
    const float al0 = hp::ex2(m0 * scale_log2 - mu0);
    const float al1 = hp::ex2(m1 * scale_log2 - mu1);
    m0 = mx0;
    m1 = mx1;
    // P in bf16 as eight A fragments of 16 keys (C layout of two adjacent
    // 8-key column blocks == A layout of one 16-key step).
    uint32_t pa[kBN / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = hp::ex2(
            fmaf(sc[8 * kk + e], scale_log2, (e & 2) ? -mu1 : -mu0));
      ps0 += (p[0] + p[1]) + (p[4] + p[5]);
      ps1 += (p[2] + p[3]) + (p[6] + p[7]);
      pa[kk][0] = mp::pack_f32_as_bf16(p[0], p[1]);
      pa[kk][1] = mp::pack_f32_as_bf16(p[2], p[3]);
      pa[kk][2] = mp::pack_f32_as_bf16(p[4], p[5]);
      pa[kk][3] = mp::pack_f32_as_bf16(p[6], p[7]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= al0;
        o[c][4 * j + 1] *= al0;
        o[c][4 * j + 2] *= al1;
        o[c][4 * j + 3] *= al1;
      }

    // O += P V: 8 k-steps of 16 keys (16 rows of 128 bytes each), in each
    // column half.
    uint8_t* v_tile = v_s + s * kTileBytes;
    hp::mbar_wait(&v_full[s], parity);
    if (t0 + kBN > len && len < skv) {            // block-uniform
      const uint4 zero = make_uint4(0, 0, 0, 0);
      uint4* rows = reinterpret_cast<uint4*>(v_tile);
      for (int c = max(len - t0, 0) * 8 + cw * 128 + tw; c < kBN * 8; c += 256)
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)      // a whole row: swizzle-free
          rows[hf * (kHalfBytes / 16) + c] = zero;
      hp::fence_proxy_async();
      hp::named_barrier(1, 256);
    }
    const uint64_t v_desc = hp::sw128_desc(v_tile);
    hp::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hp::wgmma_rs_m64n64k16(o[c], pa[kk],
                               v_desc + c * (kHalfBytes >> 4) + 128 * kk, 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kHalves; ++c) hp::fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) hp::fence_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&v_empty[s]);
  }

  // Row sums live spread over the 4 threads of a quad.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;

  // Stage this warpgroup's 64 rows in its (consumed) rows of the Q tile,
  // column half by column half: 16-byte chunk j of row r of a half at chunk
  // j ^ (r % 8), conflict-free both ways.
  uint8_t* stage = q_s + cw * 64 * 128;
  const int lr = warp * 16 + gr;                  // local row; lr + 8 too
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint8_t* half = stage + c * kHalfBytes;
      const int off = ((j ^ (lr & 7)) << 4) + tq * 4;
      *reinterpret_cast<uint32_t*>(half + lr * 128 + off) =
          mp::pack_f32_as_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(half + (lr + 8) * 128 + off) =
          mp::pack_f32_as_bf16(o[c][4 * j + 2] * inv1,
                               o[c][4 * j + 3] * inv1);
    }
  hp::named_barrier(2 + cw, 128);
  constexpr int kChunks = kD / 8;                 // 16-byte chunks of a row
  for (int i = tw; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks, ch = i % kChunks;
    const int qi = q0 + cw * 64 + row;
    if (qi < sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * sq + qi) * hq + h) * kD + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + (ch / 8) * kHalfBytes +
                                          row * 128 +
                                          (((ch % 8) ^ (row & 7)) << 4));
  }
  if (tq == 0 && lse != nullptr) {
    const int qi0 = q0 + r0, qi1 = qi0 + 8;
    float* lse_b = lse + static_cast<size_t>(b) * sq * hq + h;
    if (qi0 < sq)
      lse_b[static_cast<size_t>(qi0) * hq] =
          l0 > 0.f ? m0 * scale_log2 * mp::kLn2 + logf(l0) : mp::kNegInf;
    if (qi1 < sq)
      lse_b[static_cast<size_t>(qi1) * hq] =
          l1 > 0.f ? m1 * scale_log2 * mp::kLn2 + logf(l1) : mp::kNegInf;
  }
}

template <int kD>
int launch_prefill(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                   const CUtensorMap& tm_v, const void* length,
                   const void* q_offset, void* out, void* lse, int batch,
                   int sq, int skv, int hq, int hkv, int window,
                   float sm_scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  const cudaError_t err =
      hp::allow_smem(flash_prefill_kernel<kD>, smem_bytes<kD>(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (sq + kBM - 1) / kBM;
  flash_prefill_kernel<kD><<<n_qtiles * hq * batch, kThreads,
                             smem_bytes<kD>(), stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(length),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, skv, hq, hkv, window, n_qtiles,
      sm_scale * mp::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head_dim: 16, 32, 64 or 128.
extern "C" int mp_flash_prefill(const void* q, const void* k, const void* v,
                                const void* length, const void* q_offset,
                                void* out, void* lse, int batch, int sq,
                                int skv, int hq, int hkv, int head_dim,
                                int window, float sm_scale, void* stream) {
  if (!mp::head_dim_ok(head_dim) || hkv <= 0 || hq % hkv != 0 ||
      batch <= 0 || sq <= 0 || skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Boxes of 64 columns (one 128-byte swizzle span) by 128 rows; at d = 16
  // and 32 the columns past d come zero-filled.
  const uint32_t box[4] = {64, 1, kBN, 1};
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t d = static_cast<uint64_t>(head_dim);
  const uint64_t qdim[4] = {d, static_cast<uint64_t>(hq),
                            static_cast<uint64_t>(sq),
                            static_cast<uint64_t>(batch)};
  const uint64_t kdim[4] = {d, static_cast<uint64_t>(hkv),
                            static_cast<uint64_t>(skv),
                            static_cast<uint64_t>(batch)};
  if (!hp::bf16_map_4d(&tm_q, q, qdim, box))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv == 0) {                 // no key: no tile is loaded, any map will do
    tm_k = tm_q;
    tm_v = tm_q;
  } else if (!hp::bf16_map_4d(&tm_k, k, kdim, box) ||
             !hp::bf16_map_4d(&tm_v, v, kdim, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MP_PREFILL(D)                                                        \
  launch_prefill<D>(tm_q, tm_k, tm_v, length, q_offset, out, lse, batch, sq, \
                    skv, hq, hkv, window, sm_scale, st)
  switch (head_dim) {
    case 16: return MP_PREFILL(16);
    case 32: return MP_PREFILL(32);
    case 64: return MP_PREFILL(64);
    default: return MP_PREFILL(128);
  }
#undef MP_PREFILL
}
