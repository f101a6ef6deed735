"""Llama-family model (port of `magicpig_tpu/models/llama.py`).

Weights keep the JAX package's layout: stacked per-layer tensors
[num_layers, in, out], applied as `x @ w`. A matmul weight is a tensor in
the model dtype, a `QuantWeight` (W8A8: int8 per output channel, the
activations quantized per token on the fly) or a `Quant4Weight` (int4 in
128-input groups, two values per byte). Large plain products stay
`torch.matmul`, as the JAX package left them to XLA; the int8 product is
`torch._int_mm`; the int4 product at decode size is the hand-written
kernel `ops/kernels/w4_matmul.py`.

Under tensor parallelism (`parallel/`) a row-split weight's product takes
a `reduce` (`parallel.sharded.Shard`): x holds the rank's slice of the
input, w its rows, and the partial products are summed over the ranks
before the one cast to the model dtype: W8A8's exact int32 products (as
GSPMD sums the JAX package's int32 dot, so the sum is the unsharded
product bit for bit), W4A8's and the int4 kernel's float32 sums, a plain
product's output. W8A8 and W4A8 quantize x by the amax of its whole row
(`reduce.max`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.ops.kernels.w4_matmul import (
    W4_GROUP,
    unpack_weight4,
    w4_matmul,
    w4_supported,
)
from magicpig_tpu_torch.ops.norms import rms_norm
from magicpig_tpu_torch.ops.quant import div_exact
from magicpig_tpu_torch.ops.rope import rope_cos_sin, rope_rows, rotate

W4_DEQUANT_MIN_M = 512   # rows from which an int4 product dequantizes first


@dataclasses.dataclass
class QuantWeight:
    """int8 weight with per-output-channel f32 scales (W8A8)."""

    q: torch.Tensor       # int8 [..., in, out]
    scale: torch.Tensor   # f32 [..., out]


@dataclasses.dataclass
class Quant4Weight:
    """int4 weight with per-(128-input group, output channel) f32 scales.

    Nibble-packed int8, group-local half-split (the JAX package's layout):
    packed row g*64 + j holds input g*128 + j in the low nibble and input
    g*128 + 64 + j in the high nibble, each in [-7, 7].
    """

    q: torch.Tensor       # int8 [..., in//2, out]
    scale: torch.Tensor   # f32 [..., in//128, out]


def _map(w, fn):
    """fn applied to a weight's tensors (None stays None)."""
    if w is None:
        return None
    if isinstance(w, (QuantWeight, Quant4Weight)):
        return type(w)(q=fn(w.q), scale=fn(w.scale))
    return fn(w)


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of [..., in, out]
    (row-major results, also for a transposed view such as embed.T)."""
    wf = w.float().contiguous()
    scale = div_exact(wf.abs().amax(dim=-2), 127.0)           # [..., out]
    q = torch.round(wf / torch.clamp(scale.unsqueeze(-2), min=1e-12))
    return QuantWeight(q=torch.clamp(q, -127, 127).to(torch.int8),
                       scale=scale)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] [..., in, out] -> packed int8 [..., in//2,
    out] in the group-local half-split layout (Quant4Weight)."""
    *lead, kin, out = q.shape
    qq = q.reshape(*lead, kin // W4_GROUP, 2, W4_GROUP // 2, out)
    packed = (qq[..., 0, :, :] & 0x0F) | (qq[..., 1, :, :] << 4)
    return packed.reshape(*lead, kin // 2, out).to(torch.int8)


def quantize_weight4(w: torch.Tensor) -> Quant4Weight:
    """Symmetric int4 quantization of [..., in, out] with group-128 scales
    (row-major results, also for a transposed view such as embed.T)."""
    wf = w.float().contiguous()
    *lead, kin, out = wf.shape
    if kin % W4_GROUP:
        raise ValueError(f"int4 weights need in % {W4_GROUP} == 0, got {kin}")
    wg = wf.reshape(*lead, kin // W4_GROUP, W4_GROUP, out)
    scale = div_exact(wg.abs().amax(dim=-2), 7.0)             # [..., g, out]
    q = torch.round(wg / torch.clamp(scale.unsqueeze(-2), min=1e-12))
    q = torch.clamp(q, -7, 7).reshape(*lead, kin, out).to(torch.int8)
    return Quant4Weight(q=_pack_nibbles(q), scale=scale)


def _stack(parts):
    """Per-layer quantized weights -> one stacked weight."""
    parts = list(parts)
    return type(parts[0])(q=torch.stack([p.q for p in parts]),
                          scale=torch.stack([p.scale for p in parts]))


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, exact. CUDA's integer GEMM
    takes M > 16 only, so fewer rows are padded with zeros."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a, b)[:m]


def _row_scale(xf: torch.Tensor, reduce=None) -> torch.Tensor:
    """Per-token int8 activation scale amax / 127 (the amax over the
    whole row: over the ranks under `reduce`)."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce is not None:
        amax = reduce.max(amax)
    return div_exact(amax, 127.0)


def _linear8(x: torch.Tensor, w: QuantWeight, reduce=None) -> torch.Tensor:
    """W8A8: per-token int8 activations (amax / 127, round half to even,
    clip), an exact int8 product, rescaled by both scales."""
    xf = x.float()
    sx = _row_scale(xf, reduce)
    xq = torch.clamp(torch.round(xf / torch.clamp(sx, min=1e-12)), -127, 127)
    kin = w.q.shape[-2]
    acc = _int8_matmul(xq.to(torch.int8).reshape(-1, kin), w.q)
    if reduce is not None:
        acc = reduce.sum(acc)
    acc = acc.reshape(*x.shape[:-1], -1)
    return (acc.float() * sx * w.scale).to(x.dtype)


def _linear4_part(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  reduce=None) -> torch.Tensor:
    """x @ W for a Quant4Weight's (q, scale) without the kernel: from
    W4_DEQUANT_MIN_M rows one dequantized weight in x's dtype and a plain
    matmul; below, per-token int8 activations and one exact integer product
    per 128-input group (a float32 product is exact there: every partial sum
    is an integer below 128 * 127 * 7 < 2^24), the group scales applied to
    the partials (W4A8)."""
    g, out = scale.shape
    kin = g * W4_GROUP
    m = x.numel() // kin
    wq = unpack_weight4(q).float().reshape(g, W4_GROUP, out)
    if m >= W4_DEQUANT_MIN_M:
        wde = (wq * scale[:, None, :]).reshape(kin, out).to(x.dtype)
        y = torch.matmul(x, wde)
        return y if reduce is None else reduce.sum(y)
    xf = x.float().reshape(m, kin)
    sx = _row_scale(xf, reduce)
    xq = torch.clamp(torch.round(xf / torch.clamp(sx, min=1e-12)), -127, 127)
    res = torch.bmm(xq.reshape(m, g, W4_GROUP).transpose(0, 1), wq)
    outv = (res * scale[:, None, :]).sum(0)
    if reduce is not None:
        outv = reduce.sum(outv)
    return (outv * sx).to(x.dtype).reshape(*x.shape[:-1], out)


def _linear4(x: torch.Tensor, w: Quant4Weight, reduce=None) -> torch.Tensor:
    """Decode-size products (the kernel's shapes) through the packed-nibble
    kernel, bf16 activations times exact nibbles; the rest `_linear4_part`.
    The JAX package routes the same way on its TPU."""
    g, out = w.scale.shape
    kin = g * W4_GROUP
    m = x.numel() // kin
    if m < W4_DEQUANT_MIN_M and w4_supported(m, kin, out):
        y = w4_matmul(x.reshape(m, kin), w.q, w.scale)
        if reduce is not None:
            y = reduce.sum(y)
        return y.to(x.dtype).reshape(*x.shape[:-1], out)
    return _linear4_part(x, w.q, w.scale, reduce)


def linear(x: torch.Tensor, w, reduce=None) -> torch.Tensor:
    """x @ w for a plain tensor, a QuantWeight or a Quant4Weight; with
    `reduce`, w is a row-split weight and the products are summed over the
    ranks (module docstring)."""
    if isinstance(w, Quant4Weight):
        return _linear4(x, w, reduce)
    if isinstance(w, QuantWeight):
        return _linear8(x, w, reduce)
    y = torch.matmul(x, w)
    return y if reduce is None else reduce.sum(y)


@dataclasses.dataclass
class LayerParams:
    """Stacked transformer-layer weights; leading dim = num_layers. With
    fused weights (`fuse_params`) wqkv and w_gateup are set and wq, wk, wv,
    w_gate, w_up are None."""

    wq: object            # [N, hidden, Hq*d] (each w* may be quantized)
    wk: object            # [N, hidden, Hkv*d]
    wv: object            # [N, hidden, Hkv*d]
    wo: object            # [N, Hq*d, hidden]
    w_gate: object        # [N, hidden, inter]
    w_up: object          # [N, hidden, inter]
    w_down: object        # [N, inter, hidden]
    ln_attn: torch.Tensor  # [N, hidden]
    ln_mlp: torch.Tensor   # [N, hidden]
    wqkv: object = None      # [N, hidden, (Hq + 2 Hkv) d]
    w_gateup: object = None  # [N, hidden, 2 inter]

    def _apply(self, fn) -> "LayerParams":
        return LayerParams(**{f.name: _map(getattr(self, f.name), fn)
                              for f in dataclasses.fields(self)})

    def layer(self, i: int) -> "LayerParams":
        return self._apply(lambda t: t[i])

    def to(self, device: torch.device | str) -> "LayerParams":
        return self._apply(lambda t: t.to(device))


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor      # [vocab, hidden]
    lm_head: object          # [hidden, vocab] (a view of embed when tied
    #                          and exact; its own quantized copy otherwise)
    final_ln: torch.Tensor   # [hidden]
    layers: LayerParams
    cos: torch.Tensor        # [max_len, head_dim] RoPE cache, f32
    sin: torch.Tensor

    def to(self, device: torch.device | str) -> "LlamaParams":
        """A copy on `device` (a tied lm_head becomes its own copy)."""
        return LlamaParams(
            embed=self.embed.to(device),
            lm_head=_map(self.lm_head, lambda t: t.to(device)),
            final_ln=self.final_ln.to(device), layers=self.layers.to(device),
            cos=self.cos.to(device), sin=self.sin.to(device))


_QUANTIZERS = {"int8": quantize_weight, "int4": quantize_weight4}


def init_params(config: ModelConfig, max_len: int,
                generator: torch.Generator,
                device: torch.device | str = "cuda") -> LlamaParams:
    """Random weights (N(0, 1/fan_in)), drawn in the model dtype on `device`
    from `generator` (which must live on that device): a full-width model
    never passes through the host or through float32. Quantized weights
    (`config.weight_quant`) are drawn and quantized one layer at a time, so
    the model never exists unquantized; the embedding stays exact, and a
    tied lm_head is its own quantized copy of embed.T."""
    n = config.num_hidden_layers
    h = config.hidden_size
    hq = config.num_attention_heads * config.head_dim
    hkv = config.num_key_value_heads * config.head_dim
    inter = config.intermediate_size
    dt = config.dtype
    quantize = _QUANTIZERS.get(config.weight_quant)

    def draw(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return x.mul_(fan_in ** -0.5)   # in place: no second copy

    def w(shape, fan_in):
        if quantize is None:
            return draw(shape, fan_in)
        if len(shape) == 2:
            return quantize(draw(shape, fan_in))
        return _stack(quantize(draw(shape[1:], fan_in))
                      for _ in range(shape[0]))

    layers = LayerParams(
        wq=w((n, h, hq), h),
        wk=w((n, h, hkv), h),
        wv=w((n, h, hkv), h),
        wo=w((n, hq, h), hq),
        w_gate=w((n, h, inter), h),
        w_up=w((n, h, inter), h),
        w_down=w((n, inter, h), inter),
        ln_attn=torch.ones((n, h), dtype=dt, device=device),
        ln_mlp=torch.ones((n, h), dtype=dt, device=device),
    )
    embed = draw((config.vocab_size, h), h)
    if not config.tie_word_embeddings:
        lm_head = w((h, config.vocab_size), h)
    elif quantize is None:
        lm_head = embed.T
    else:
        lm_head = quantize(embed.T)
    cos, sin = rope_cos_sin(config, max_len, device=device)
    params = LlamaParams(embed=embed, lm_head=lm_head,
                         final_ln=torch.ones((h,), dtype=dt, device=device),
                         layers=layers, cos=cos, sin=sin)
    if quantize is not None and config.fuse_small_linears:
        params = fuse_params(params)
    return params


def _concat_qw(ws):
    """Quantized weights joined along `out` (both formats scale per output
    channel, so the products are those of the separate weights)."""
    return type(ws[0])(q=torch.cat([w.q for w in ws], dim=-1),
                       scale=torch.cat([w.scale for w in ws], dim=-1))


def fuse_params(params: LlamaParams) -> LlamaParams:
    """The fused qkv and gate|up forms of quantized per-projection weights;
    the unfused fields become None."""
    lw = params.layers
    if not isinstance(lw.wq, (QuantWeight, Quant4Weight)):
        raise TypeError("fuse_params applies to quantized weights")
    layers = dataclasses.replace(
        lw, wqkv=_concat_qw((lw.wq, lw.wk, lw.wv)),
        w_gateup=_concat_qw((lw.w_gate, lw.w_up)),
        wq=None, wk=None, wv=None, w_gate=None, w_up=None)
    return dataclasses.replace(params, layers=layers)


def quantize_params(params: LlamaParams, bits: int = 8) -> LlamaParams:
    """Every matmul weight of exact params to int8 (bits=8) or group-128
    int4 (bits=4), one layer at a time; the embedding stays exact and a
    tied lm_head becomes its own quantized copy."""
    quantize = {8: quantize_weight, 4: quantize_weight4}[bits]
    lw = params.layers
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layers = dataclasses.replace(
        lw, **{k: _stack(quantize(w) for w in getattr(lw, k)) for k in names})
    return dataclasses.replace(params, layers=layers,
                               lm_head=quantize(params.lm_head))


def qkv_proj(lp: LayerParams, config: ModelConfig, hidden: torch.Tensor,
             positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """RMSNorm + QKV projection + RoPE for one layer.

    hidden: [B, S, h]; positions: [B, S].
    Returns q [B, S, Hq, d], k [B, S, Hkv, d], v [B, S, Hkv, d].
    """
    b, s, _ = hidden.shape
    d = config.head_dim
    x = rms_norm(hidden, lp.ln_attn, config.rms_norm_eps)
    if lp.wqkv is not None:
        hq = config.num_attention_heads * d
        hkv = config.num_key_value_heads * d
        q, k, v = linear(x, lp.wqkv).split((hq, hkv, hkv), dim=-1)
        v = v.contiguous()     # a column slice; the kernels take dense rows
    else:
        q, k, v = linear(x, lp.wq), linear(x, lp.wk), linear(x, lp.wv)
    q = q.reshape(b, s, config.num_attention_heads, d)
    k = k.reshape(b, s, config.num_key_value_heads, d)
    v = v.reshape(b, s, config.num_key_value_heads, d)
    rows = rope_rows(cos, sin, positions)      # one lookup for q and k
    return rotate(q, *rows), rotate(k, *rows), v


def post_attention(lp: LayerParams, config: ModelConfig,
                   attn_out: torch.Tensor, residual: torch.Tensor,
                   reduce=None) -> torch.Tensor:
    """o_proj + residual + MLP block. attn_out: [B, S, Hq*d]; residual:
    [B, S, h]. With `reduce` (tensor parallelism) attn_out holds the rank's
    heads, the MLP runs at its columns, and o_proj's and down_proj's
    products are summed over the ranks."""
    hidden = residual + linear(attn_out.to(residual.dtype), lp.wo, reduce)
    x = rms_norm(hidden, lp.ln_mlp, config.rms_norm_eps)
    if lp.w_gateup is not None:
        g, u = linear(x, lp.w_gateup).chunk(2, dim=-1)
    else:
        g, u = linear(x, lp.w_gate), linear(x, lp.w_up)
    gate = F.silu(g.float()).to(x.dtype)
    return hidden + linear(gate * u.to(x.dtype), lp.w_down, reduce)


def unembed(params: LlamaParams, config: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head. hidden: [B, h] -> f32 logits [B, V]."""
    x = rms_norm(hidden, params.final_ln, config.rms_norm_eps)
    return linear(x, params.lm_head).float()
