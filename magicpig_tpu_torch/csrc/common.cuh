// Shared device helpers for the port's attention kernels (sm_90a).
//
// Each .cu file in this directory exports plain C entry points that take raw
// device pointers, sizes and a cudaStream_t, launch on that stream, and
// return cudaGetLastError(). The Python wrappers in
// magicpig_tpu_torch/ops/kernels/ check shapes and types before the call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mp {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -__builtin_huge_valf();

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Two bf16 values in one 32-bit register, `lo` in the low half: the operand
// order of mma.sync fragments (lower column index in the low half).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  uint32_t l = static_cast<uint32_t>(__bfloat16_as_ushort(lo));
  uint32_t h = static_cast<uint32_t>(__bfloat16_as_ushort(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t pack_f32_as_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// D = A * B + D for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16
// (col), D 16x8 f32. Fragment layout (g = lane / 4, t = lane % 4):
//   a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 2t+8..)   a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)                b1 (k 2t+8..2t+9, n g)
//   d0 d1 (g, 2t..2t+1)                 d2 d3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ticket of a launch's in-launch merge: once the block's writes are
// done (after a __syncthreads), one thread adds one to *ticket at device
// scope with acquire-release order; the block that takes the last of
// `count` resets it to 0 for the next launch and returns true. The
// release makes the block's writes visible to the last block, and the
// acquire orders the last block's reads after the next __syncthreads
// behind every block's writes.
__device__ __forceinline__ bool take_ticket(int* ticket, int count) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(ticket) : "memory");
  const bool last = old == count - 1;
  if (last) atomicExch(ticket, 0);
  return last;
}

// ---- Group sizes and head dims of the decode-side kernels.
//
// Each kernel has exact instances for the group sizes G = hq / hkv of 1, 2,
// 4 and 8 at head dims 64 and 128, and 3 at 128 (their code is as it was
// before the other forms came). Every other form (any G at head dims 16
// and 32, and the other G at 64 and 128) takes the kernel's general tile,
// which serves any group size with ceil(group / tile) blocks of at most
// `tile` query heads per kv head: a block takes one of them (blockIdx.y =
// kv head * blocks + block, `Heads`), and its heads past `gn` are empty
// (no query read, no selection, no output written). The tile is a kernel's
// own: kHeadTile (16, one mma.sync M tile of heads) for the decode and both
// LSH kernels, so that every served group reads its kv head's K/V or
// signatures once; kGroupTile (8: an instance at G = 8 with kPart set) for
// the block scorer, both attends of the selected blocks and the standalone
// collision scan.
constexpr int kGroupTile = 8;
constexpr int kHeadTile = 16;

__host__ __device__ inline bool exact_group(int g, int head_dim) {
  return (head_dim == 64 || head_dim == 128) &&
         (g == 1 || g == 2 || g == 4 || g == 8 || (g == 3 && head_dim == 128));
}

__host__ __device__ inline int group_blocks(int group, int tile) {
  return (group + tile - 1) / tile;
}

// The head dims the decode-side kernels take: every one that divides 128
// from 16 (a bf16 row of at least 32 bytes, an int8 one of 16).
__host__ __device__ inline bool head_dim_ok(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128;
}

// The query heads of one block. Exact instances (kPart false): the kv
// head's G heads, blockIdx.y the kv head. The general tile (kPart, G the
// tile): the block blockIdx.y % blocks of kv head blockIdx.y / blocks,
// `group` heads a kv head. `slot` (b * hkv * blocks + blockIdx.y) numbers
// the block's (request, kv head, block of heads) for the merge tickets.
template <int G, bool kPart>
struct Heads {
  int kh, group, g0, gn;
  __device__ __forceinline__ Heads(int y, int group_) {
    if constexpr (kPart) {
      const int blocks = group_blocks(group_, G);
      kh = y / blocks;
      group = group_;
      g0 = (y % blocks) * G;
      gn = min(G, group_ - g0);
    } else {
      kh = y;
      group = G;
      g0 = 0;
      gn = G;
    }
  }
  // Row of the block's first query head in [B * Hq].
  __device__ __forceinline__ size_t row(int b, int hkv) const {
    return (static_cast<size_t>(b) * hkv + kh) * group + g0;
  }
  // The block's merge ticket: one per (request, kv head, block of heads).
  __device__ __forceinline__ int slot(int b, int hkv) const {
    if constexpr (kPart)
      return b * static_cast<int>(gridDim.y) + static_cast<int>(blockIdx.y);
    return b * hkv + kh;
  }
};

// Eight bf16 values (one 16-byte vector) dotted with eight f32 values.
__device__ __forceinline__ float dot8(const uint4& kv, const float* q) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&kv);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(f.x, q[2 * i], acc);
    acc = fmaf(f.y, q[2 * i + 1], acc);
  }
  return acc;
}

}  // namespace mp
