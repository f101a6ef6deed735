// Split-sequence flash decode with LSE export, and the LSE merge of the
// per-split partials (also used by the fused LSH decode).
//
// Replaces magicpig_tpu/ops/pallas/decode.py::flash_decode (the pallas_call
// at decode.py:184), bf16 K/V, or int8 K/V with per-token f32 scales (its
// quant=True form). One query per request attends a cache prefix of
// length[b]; the G query heads of a kv head share every K/V read; fully
// masked rows give out 0 and lse -inf.
//
// Bound on the H100: reading K and V once, 256 bytes per token and kv head
// at d = 64 in bf16, 136 in int8 (rows and scales), over 3.35 TB/s; the
// arithmetic is ~2 flops per byte. int8 rows are widened to bf16 in shared
// memory; the K scale multiplies each score, the V scale each probability
// in the P.V sum (decode_common.cuh). Design:
// the TPU kernel walks the sequence in order on one core, but one block per
// (request, kv head) would put 16 blocks on 132 SMs at B = 2. So the
// sequence is cut into 512-token splits, one block each (blocks past the
// request's length exit at once); 64-token K/V tiles go through shared
// memory with 16-byte loads, the G x 64 scores and the online softmax are
// f32, and a second small kernel merges the splits by their LSE.
#include <type_traits>

#include "common.cuh"
#include "decode_common.cuh"

namespace {

// T: __nv_bfloat16, or int8_t with the row scales k_scale, v_scale [B,
// Hkv, S] (null for bf16).
template <int G, typename T>
__global__ void __launch_bounds__(mp::kDecThreads)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ length,
                          float* __restrict__ part_o,
                          float* __restrict__ part_lse, int batch, int s_cap,
                          int hkv, float scale_log2) {
  using namespace mp;
  constexpr bool kQ = std::is_same<T, int8_t>::value;
  __shared__ DecodeTileSmem<G> sm;

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = hkv * G;
  const int start = split * kDecChunk;
  const int stop = min(min(length[b], s_cap), start + kDecChunk);
  const size_t part = (static_cast<size_t>(split) * batch + b) * hq + kh * G;

  if (start >= stop) {
    write_empty_partial<G>(part_o, part_lse, nullptr, part, tid);
    return;
  }
  const __nv_bfloat16* q_b = q + (static_cast<size_t>(b) * hq + kh * G) * kDecD;
  for (int i = tid; i < G * kDecD; i += kDecThreads)
    sm.qf[i / kDecD][i % kDecD] = __bfloat162float(q_b[i]) * scale_log2;

  const size_t head_off = (static_cast<size_t>(b) * hkv + kh) * s_cap;
  const T* k_h = k + head_off * kDecD;
  const T* v_h = v + head_off * kDecD;

  OnlineSoftmax<G> st;
  st.init();
  for (int t0 = start; t0 < stop; t0 += kDecTile) {
    if constexpr (kQ)
      load_kv_tile<G>(sm, k_h, v_h, k_scale + head_off, v_scale + head_off,
                      t0, stop, tid, nullptr);
    else
      load_kv_tile<G>(sm, k_h, v_h, t0, stop, tid, nullptr);
    __syncthreads();
    for (int p = tid; p < G * kDecTile; p += kDecThreads) {
      const int g = p / kDecTile, j = p % kDecTile;
      float score = kNegInf;
      if (t0 + j < stop) {
        score = row_dot(sm.ks[j], sm.qf[g]);
        if constexpr (kQ) score *= sm.ksc[j];
      }
      sm.ps[g][j] = score;
    }
    __syncthreads();
    st.softmax_tile(sm, tid);
    __syncthreads();
    st.template accumulate_pv<kQ>(sm, tid);
    __syncthreads();
  }
  st.write_partial(sm, part_o, part_lse, part, tid);
}

template <int G, typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* length, void* part_o, void* part_lse, void* out,
                  void* lse, int batch, int s_cap, int hkv, float sm_scale,
                  cudaStream_t stream) {
  const int nsplit = (s_cap + mp::kDecChunk - 1) / mp::kDecChunk;
  dim3 grid(nsplit, hkv, batch);
  flash_decode_split_kernel<G, T><<<grid, mp::kDecThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(length),
      static_cast<float*>(part_o), static_cast<float*>(part_lse), batch,
      s_cap, hkv, sm_scale * mp::kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mp::launch_merge(static_cast<const float*>(part_o),
                          static_cast<const float*>(part_lse), nullptr,
                          static_cast<float*>(out), static_cast<float*>(lse),
                          nullptr, nsplit, batch * hkv * G, stream);
}

// One block per (request, query head), one thread per output lane.
__global__ void merge_kernel(const float* __restrict__ part_o,
                             const float* __restrict__ part_lse,
                             const float* __restrict__ part_cnt,
                             float* __restrict__ out, float* __restrict__ lse,
                             float* __restrict__ cnt, int nsplit, int rows) {
  const int r = blockIdx.x;
  const int d = threadIdx.x;
  float mx = mp::kNegInf;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_lse[static_cast<size_t>(s) * rows + r]);
  float acc = 0.f, denom = 0.f, c = 0.f;
  if (mx != mp::kNegInf) {
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = static_cast<size_t>(s) * rows + r;
      const float w = expf(part_lse[i] - mx);
      denom += w;
      acc += w * part_o[i * mp::kDecD + d];
    }
  }
  if (part_cnt != nullptr && d == 0)
    for (int s = 0; s < nsplit; ++s)
      c += part_cnt[static_cast<size_t>(s) * rows + r];
  out[static_cast<size_t>(r) * mp::kDecD + d] = denom > 0.f ? acc / denom : 0.f;
  if (d == 0) {
    lse[r] = denom > 0.f ? mx + logf(denom) : mp::kNegInf;
    if (cnt != nullptr) cnt[r] = c;
  }
}

}  // namespace

int mp::launch_merge(const float* part_o, const float* part_lse,
                     const float* part_cnt, float* out, float* lse,
                     float* cnt, int nsplit, int rows, cudaStream_t stream) {
  merge_kernel<<<rows, kDecD, 0, stream>>>(part_o, part_lse, part_cnt, out,
                                           lse, cnt, nsplit, rows);
  return static_cast<int>(cudaGetLastError());
}

// k_scale and v_scale null: bf16 K/V; both set: int8 K/V with those
// per-token scales [B, Hkv, S].
extern "C" int mp_flash_decode(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* length, void* part_o,
                               void* part_lse, void* out, void* lse,
                               int batch, int s_cap, int hq, int hkv,
                               int head_dim, float sm_scale, void* stream) {
  if (head_dim != mp::kDecD || hq % hkv != 0 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
#define MP_DECODE_CASE(G)                                                    \
  case G:                                                                    \
    return quant ? launch_decode<G, int8_t>(q, k, v, k_scale, v_scale,       \
                                            length, part_o, part_lse, out,   \
                                            lse, batch, s_cap, hkv,          \
                                            sm_scale, st)                    \
                 : launch_decode<G, __nv_bfloat16>(                          \
                       q, k, v, nullptr, nullptr, length, part_o, part_lse,  \
                       out, lse, batch, s_cap, hkv, sm_scale, st);
  switch (hq / hkv) {
    MP_DECODE_CASE(1)
    MP_DECODE_CASE(2)
    MP_DECODE_CASE(4)
    MP_DECODE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MP_DECODE_CASE
}

extern "C" const char* mp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime; point it at the caller's device.
extern "C" int mp_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
