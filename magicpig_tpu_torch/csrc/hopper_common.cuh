// Hopper (sm_90a) building blocks of the redesigned kernels: mbarriers,
// bulk and tensor (TMA) copies into shared memory, cp.async copies (the
// block scorer's rings, the LSH attend's gathers, the collision scan's
// ragged tiles), warpgroup MMA (wgmma)
// with its shared-memory descriptors, register reallocation and named
// barriers, each a thin wrapper of one PTX instruction; and, on the host,
// the dynamic shared-memory limit and the encoding of a tiled tensor map.
//
// A waiting thread polls its mbarrier with try_wait; after 2 s on the
// global timer it traps, so that a phase error ends the launch with an
// error the wrapper reports instead of hanging the card.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed; trap after 2 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t n = 1; !mbar_try_wait(addr, parity); ++n)
    if ((n & 255u) == 0u && global_ns() - t0 > 2000000000ull) __trap();
}

// 2^x on the special-function unit (approximate, flushes denormals): the
// exponent of the attention kernels' softmax in log2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- copies ------------------------------------------------------------------

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to shared memory, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes (both addresses 16-byte aligned) from device memory to shared
// memory by cp.async, past L1; with `full` false nothing is read and the 16
// bytes are zero-filled. Completion: cp_async_commit, then cp_async_wait.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes by cp.async, through L1.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Closes the calling thread's group of cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One arrival on `bar` once every cp.async the calling thread issued so far
// has landed; the barrier's count must include it (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until at most kPending of the calling thread's groups are in
// flight. Other threads' copies are visible after a barrier (__syncwarp
// among a warp's lanes, __syncthreads across warps).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// One box of a 2-D tensor map at element coordinates (c0 innermost),
// completion counted on `bar`; elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile."
      "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 4-D tensor map at element coordinates (c0 innermost),
// completion counted on `bar`; elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile."
      "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy accesses to shared memory ordered before the async proxy's
// later ones: writes made visible to wgmma operand reads, reads done before
// a bulk copy overwrites the buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// -- warpgroups --------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Keeps the compiler from touching registers that an in-flight wgmma
// reads or writes: call after wgmma_wait on the accumulators and the
// register A operand.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle that a TMA box
// with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes (64 bf16),
// groups of 8 rows 1024 bytes apart (stride byte offset), the tile based at
// a 1024-byte boundary. For a K-major operand the leading byte offset is
// unused (1); a step of 16 elements along K adds 32 bytes to the start
// address. For an MN-major operand 64 elements wide the same fields hold,
// and a step of 16 along K adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (K-major, descriptors), D f32 in the accumulator layout.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major, descriptors), D f32 in the accumulator layout.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a_desc,
                                               uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the mma.sync
// m16n8k16 A fragment, one 16-row slice per warp), B from shared memory
// MN-major (transposed descriptor), D f32.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

// -- host ----------------------------------------------------------------------

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB needs
// it) on the current device, once per device: `done` holds one bit each.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Tiled tensor maps.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver once (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor [d3, d2, d1, d0] (d0 contiguous, d0 * 2 a multiple of 128
// bytes) read in boxes of `box` (innermost first, box[0] * 2 = 128 bytes)
// with the 128-byte swizzle. Returns false when the driver refuses it.
inline bool bf16_map_4d(CUtensorMap* map, const void* base,
                        const uint64_t (&dims)[4], const uint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t bdim[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An int32 matrix [rows, cols] (cols contiguous, cols * 4 a multiple of 16
// bytes) read in boxes of box_rows x box_cols (box_cols * 4 a multiple of
// 16), unswizzled. Returns false when cuTensorMapEncodeTiled refuses it.
inline bool int32_map_2d(CUtensorMap* map, const void* base, uint64_t cols,
                         uint64_t rows, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t gdim[2] = {cols, rows};
  const cuuint64_t gstride[1] = {cols * 4};
  const cuuint32_t bdim[2] = {box_cols, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base),
            gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hp
