"""Packed-nibble int4 matmul at decode size: wrapper of the hand-written
kernel `csrc/w4_matmul.cu`, with its plain version `w4_matmul_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/w4_matmul.py::w4_matmul`
(pallas_call at w4_matmul.py:121). x [M, kin] in bf16 times a group-128
int4 weight, f32 [M, out] = sum_g (x_g @ unpack(q_g)) * s_g: bf16 values
times exact nibbles, summed in float32, with no activation quantization.
At M = 2 the product is bound by reading the packed weight once (half a
byte per weight plus the group scales); the nibbles become bf16 in
registers without a conversion instruction, the products run on tensor
cores, and K-splits are summed in the same launch (see the source).

The weight layout is the JAX package's (`models/llama.py::Quant4Weight`):
int8 [kin/2, out], packed row g*64 + j holding input g*128 + j in the low
nibble and g*128 + 64 + j in the high one; scales f32 [kin/128, out].
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.flash_decode import device_state

W4_GROUP = 128          # inputs per int4 scale group
MAX_M = 64              # rows the kernel takes (decode size)
M_TILE = 8              # rows of x per CUDA block (kMRows in w4_matmul.cu)
COLS_PER_BLOCK = 256    # output columns per CUDA block at 8 columns a lane
WIDE_COLS = 512         # ... at 16 columns a lane (kLaneCols)
TARGET_BLOCKS = 264     # two blocks for each of the H100's 132 SMs
MAX_GROUPS_PER_BLOCK = 16   # x slice in shared memory (kMaxGroups)
MAX_SPLITS = 16         # K-splits the last block of a tile sums


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


def split_groups(groups: int, ksplit: int) -> tuple[int, int]:
    """(K-splits, groups per split) for about `ksplit` splits of whole
    groups, none empty: the groups per split rounded up."""
    per = -(-groups // max(1, min(ksplit, groups)))
    return -(-groups // per), per


def split_k(kin: int, out: int, m: int) -> tuple[int, int]:
    """(K-splits, groups per split) over CUDA blocks of 256 columns: enough
    splits for two blocks per SM where the groups allow, at most
    MAX_SPLITS (each a load of the reducing block) and at least the
    16-group x slice of a block's shared memory needs."""
    groups = kin // W4_GROUP
    tiles = -(-out // COLS_PER_BLOCK) * -(-m // M_TILE)
    floor = -(-groups // MAX_GROUPS_PER_BLOCK)
    want = max(floor, min(MAX_SPLITS, -(-TARGET_BLOCKS // tiles)))
    return split_groups(groups, want)


def w4_plan(kin: int, out: int, m: int, num_sms: int) -> tuple[int, int, int]:
    """(columns a lane, K-splits, groups per split): 16 columns a lane and
    the fewest splits where the output's 512-column tiles alone fill the
    card (the lm_head), else 8 and `split_k`. `chip_smoke.py` phase 2
    sweeps the splits at each served shape (`PERF.md`)."""
    groups = kin // W4_GROUP
    if -(-out // WIDE_COLS) * -(-m // M_TILE) >= num_sms:
        return (16, *split_groups(groups, -(-groups // MAX_GROUPS_PER_BLOCK)))
    return (8, *split_k(kin, out, m))


def launch_w4(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              ksplit: int, per: int, lane_cols: int = 8) -> torch.Tensor:
    """One launch of the kernel with the given plan (checked inputs on a
    card): the wrapper's, and `chip_smoke.py`'s sweep of the splits."""
    m, kin = x.shape
    out = scale.shape[1]
    y = torch.empty((m, out), dtype=torch.float32, device=x.device)
    part = (torch.empty((ksplit, m, out), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    tiles = -(-out // (32 * lane_cols)) * -(-m // M_TILE)
    _lib.launch("w4_matmul", "mp_w4_matmul", x.device, x, q, scale, part, y,
                device_state(x.device, tiles)[0], m, kin, out, ksplit, per,
                lane_cols)
    shape = f"{kin}x{out}"
    _lib.W4_SHAPE_LAUNCHES[shape] = _lib.W4_SHAPE_LAUNCHES.get(shape, 0) + 1
    return y


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
    lane_cols, ksplit, per = w4_plan(kin, out, m,
                                     device_state(x.device, 1)[1])
    return launch_w4(x, q, scale, ksplit, per, lane_cols)
