"""Training the port's Llama models (the counterpart of the JAX package's
training path, `examples/train_needle.py` and `examples/train_ruler_lm.py`).

`forward_all` is the full-sequence causal forward at every position, each
layer recomputed in the backward (`torch.utils.checkpoint`, as JAX's
`jax.checkpoint`), its attention `FlashPrefillTrain`: on the card the
flash_prefill kernel forward and the flash_prefill_bwd kernel backward.
The optimizer is optax's `adamw` as both JAX trainers build it: AdamW with
betas (0.9, 0.999), eps 1e-8 and weight decay 0.01 over every leaf of
`LlamaParams`, the RoPE tables `cos` and `sin` included (the JAX step
differentiates the whole pytree, so optax trains and decays them too), at
`cosine_decay_schedule(lr, steps, 0.1)`. A rolling partial (`save_partial`
/ `load_partial`) holds the step, the leaves and the optimizer's state, so
a resumed run continues the schedule and the moments where it stopped.
"""

from __future__ import annotations

import hashlib
import math
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from magicpig_tpu_torch.config import ModelConfig
from magicpig_tpu_torch.models.convert import leaves, load_params
from magicpig_tpu_torch.models.llama import (
    LlamaParams,
    init_params,
    post_attention,
    qkv_proj,
    unembed,
)
from magicpig_tpu_torch.ops.kernels.flash_prefill import flash_prefill_train

BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 0.01
FINAL_LR_SHARE = 0.1     # the cosine schedule's alpha


def initial_params(config: ModelConfig, max_len: int, seed: int,
                   device: torch.device | str,
                   init: str | None = None) -> LlamaParams:
    """The checkpoint `init` (a JAX `.npz`), or `init_params` drawn on the
    CPU from a generator seeded with `seed` (the same numbers on every
    machine) and moved to `device`."""
    if init:
        return load_params(init, config, max_len, device=device)
    gen = torch.Generator().manual_seed(seed)
    return init_params(config, max_len, gen, device="cpu").to(device)


def digest(params: LlamaParams) -> str:
    """sha256 of the leaves' bytes in `leaves` order: the same draw on two
    machines gives the same digest."""
    h = hashlib.sha256()
    for t in leaves(params):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def trainable(params: LlamaParams) -> list[torch.Tensor]:
    """Every leaf, in `leaves` order, set to require grad. A leaf must be
    a tensor of its own, as in the JAX pytree: a view (a tied lm_head is
    embed.T) raises ValueError."""
    out = leaves(params)
    for t in out:
        if t._base is not None:
            raise ValueError("params leaves must be tensors of their own, "
                             "not views (a tied lm_head is embed.T)")
        t.requires_grad_(True)
    return out


def cosine_decay(lr: float, steps: int, step: int) -> float:
    """optax.cosine_decay_schedule(lr, steps, 0.1) at `step`."""
    t = min(step, steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / steps))
    return lr * ((1.0 - FINAL_LR_SHARE) * cosine + FINAL_LR_SHARE)


def adamw(params: LlamaParams, lr: float) -> torch.optim.AdamW:
    """optax.adamw's update (weight decay 0.01) over every leaf."""
    return torch.optim.AdamW(trainable(params), lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY)


def forward_all(params: LlamaParams, config: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """Causal forward of tokens [B, S]; f32 logits at every position
    [B, S, V]. The attention takes `min(512, S)`-key blocks in its plain
    versions (S a multiple of that), as JAX's trainers call it."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    block_k = min(512, s)

    def layer(i: int, hidden: torch.Tensor) -> torch.Tensor:
        lp = params.layers.layer(i)
        q, k, v = qkv_proj(lp, config, hidden, positions, params.cos,
                           params.sin)
        o = flash_prefill_train(q, k, v, 0, s, block_k=block_k)
        return post_attention(lp, config, o.reshape(b, s, -1), hidden)

    hidden = params.embed[tokens]
    for i in range(config.num_hidden_layers):
        hidden = checkpoint(layer, i, hidden, use_reentrant=False)
    return unembed(params, config, hidden)


def masked_loss(logits: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor):
    """(sum(ce * w) / max(sum(w), 1), accuracy where w >= 1): the needle
    trainer's loss (w its 0/1 mask) and the RULER trainer's (w 1 on answer
    bytes, the LM weight elsewhere)."""
    ce = F.cross_entropy(logits.flatten(0, -2), target.flatten().long(),
                         reduction="none").view(target.shape)
    w = weight.float()
    loss = (ce * w).sum() / torch.clamp(w.sum(), min=1.0)
    ans = (w >= 1.0).float()
    acc = ((logits.argmax(-1) == target).float() * ans).sum() / torch.clamp(
        ans.sum(), min=1.0)
    return loss, acc


def train_step(params: LlamaParams, config: ModelConfig,
               optimizer: torch.optim.Optimizer, lr: float, loss_fn,
               tokens: torch.Tensor, *batch):
    """One optimizer step at learning rate `lr` on loss_fn(logits of
    tokens, *batch) -> (loss, acc); returns them (detached, before the
    update)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss, acc = loss_fn(forward_all(params, config, tokens), *batch)
    loss.backward()
    optimizer.step()
    return loss.detach(), acc.detach()


def partial_path(out: str) -> str:
    return out + ".partial.pt"


def save_partial(path: str, step: int, params: LlamaParams,
                 optimizer: torch.optim.Optimizer) -> None:
    """The rolling partial after `step`: the leaves, the optimizer's state
    and the step, written to a temporary file and then moved into place."""
    tmp = path + ".tmp"
    torch.save({"step": step,
                "leaves": [t.detach().cpu() for t in leaves(params)],
                "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, path)


def load_partial(path: str, params: LlamaParams,
                 optimizer: torch.optim.Optimizer) -> int:
    """Restore a partial into params (in place) and the optimizer; returns
    the first step still to run."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for t, saved in zip(leaves(params), state["leaves"], strict=True):
            t.copy_(saved)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"]) + 1
