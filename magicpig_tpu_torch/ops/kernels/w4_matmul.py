"""Packed-nibble int4 matmul at decode size: wrapper of the hand-written
kernel `csrc/w4_matmul.cu`, with its plain version `w4_matmul_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/w4_matmul.py::w4_matmul`
(pallas_call at w4_matmul.py:121). x [M, kin] in bf16 times a group-128
int4 weight, f32 [M, out] = sum_g (x_g @ unpack(q_g)) * s_g: bf16 values
times exact nibbles, summed in float32, with no activation quantization.
At M = 2 the product is bound by reading the packed weight once (half a
byte per weight plus the group scales); the nibbles are unpacked in
registers and never stored.

The weight layout is the JAX package's (`models/llama.py::Quant4Weight`):
int8 [kin/2, out], packed row g*64 + j holding input g*128 + j in the low
nibble and g*128 + 64 + j in the high one; scales f32 [kin/128, out].
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops.kernels import _lib

W4_GROUP = 128          # inputs per int4 scale group
MAX_M = 64              # rows the kernel takes (decode size)
M_TILE = 4              # rows per CUDA block (kMTile in w4_matmul.cu)
COLS_PER_BLOCK = 256    # output columns per CUDA block (kCols)
TARGET_BLOCKS = 264     # two waves of the H100's 132 SMs
MAX_GROUPS_PER_BLOCK = 16   # x slice in shared memory: 16 * 128 * 4 rows f32


def unpack_weight4(p: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., in//2, out] -> int8 [..., in, out], the nibbles
    sign-extended (the inverse of `models.llama._pack_nibbles`)."""
    *lead, kp, out = p.shape
    half = W4_GROUP // 2
    lo = (p << 4) >> 4                       # arithmetic: sign-extends
    hi = p >> 4
    st = torch.stack([lo.reshape(*lead, kp // half, half, out),
                      hi.reshape(*lead, kp // half, half, out)], dim=-3)
    return st.reshape(*lead, kp * 2, out)


def w4_supported(m: int, kin: int, out: int) -> bool:
    """The shapes the JAX package sends to its kernel
    (`ops/pallas/w4_matmul.py::w4_block_shapes` is not None): M <= 64,
    kin and out 128-aligned, and kin/2 at most 1024 or a multiple of 512."""
    if m > MAX_M or kin % 128 or out % 128:
        return False
    kp = kin // 2
    return kp <= 1024 or kp % 512 == 0


def w4_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version: per group, bf16-rounded x times the exact nibbles in
    float32, scaled by the group scale and summed over the groups in
    order."""
    m, kin = x.shape
    g, out = scale.shape
    w = unpack_weight4(q).float().reshape(g, W4_GROUP, out)
    xg = x.to(torch.bfloat16).float().reshape(m, g, W4_GROUP).transpose(0, 1)
    parts = torch.bmm(xg, w) * scale.float()[:, None, :]      # [g, M, out]
    acc = parts[0]
    for i in range(1, g):
        acc = acc + parts[i]
    return acc


def split_k(kin: int, out: int, m: int) -> tuple[int, int]:
    """(K-splits, groups per split) over CUDA blocks: enough blocks for two
    waves of the card where the groups allow, at most 16 groups of x in a
    block's shared memory, no empty split."""
    groups = kin // W4_GROUP
    tiles = -(-out // COLS_PER_BLOCK) * -(-m // M_TILE)
    want = max(-(-TARGET_BLOCKS // tiles), -(-groups // MAX_GROUPS_PER_BLOCK))
    per = max(1, groups // want)
    return -(-groups // per), per


def w4_matmul(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [M, kin] @ group-int4 W -> f32 [M, out] (M <= 64, kin and out
    128-aligned). q: packed int8 [kin/2, out]; scale: f32 [kin/128, out].
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return w4_matmul_plain(x, q, scale)
    name = "w4_matmul"
    _lib.require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    m, kin = x.shape
    g, out = scale.shape
    _lib.require(w4_supported(m, kin, out) and g * W4_GROUP == kin,
                 f"{name}: shape M={m} kin={kin} out={out} unsupported")
    _lib.require(q.dtype == torch.int8 and q.shape == (kin // 2, out),
                 f"{name}: q must be int8 [kin/2, out]")
    _lib.require(scale.dtype == torch.float32, f"{name}: scale must be f32")
    x = x.to(torch.bfloat16).contiguous()
    _lib.require_cuda(name, x, q, scale)
    ksplit, per = split_k(kin, out, m)
    y = torch.empty((m, out), dtype=torch.float32, device=x.device)
    part = (torch.empty((ksplit, m, out), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    _lib.launch(name, "mp_w4_matmul", x.device, x, q, scale, part, y, m, kin,
                out, ksplit, per)
    return y
