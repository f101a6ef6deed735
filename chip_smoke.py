#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`magicpig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # one CUDA card, no arguments

Phases, each announced by one flushed progress line with elapsed seconds:
  0. device: a CUDA card or exit non-zero; its name and power limit;
  1. build: the kernels of `magicpig_tpu_torch/csrc/`, one nvcc per source
     started together, then one link; the counts of warpgroup MMA (HGMMA),
     TMA (UTMALDG), bulk-copy (UBLKCP), mma.sync (HMMA), cp.async (LDGSTS)
     and integer-to-float (I2F) instructions in the prefill, decode, block
     scorer, both block attends, int4 matmul, collision scan and both LSH
     kernels' SASS (mma.sync in the scorer, the attends and the int4
     matmul, bulk copies in the attends, cp.async in the scorer, the int4
     matmul and the LSH kernels, TMA in the collision scan and the fused
     LSH kernel, and no I2F in the int4 matmul, or it fails; at head dim
     128 too: HGMMA and UTMALDG in the prefill, UBLKCP in the bf16 and int8
     decode, HMMA, UTMALDG and LDGSTS in the fused LSH kernel's bf16 and
     int8 forms and its group-3 form, HMMA and LDGSTS in the masked attend,
     HMMA and LDGSTS in the scorer, HMMA and UBLKCP in both attends; TMA in
     the group-3 scan; and in the kernels' general tile and small head dims
     the same: HGMMA and UTMALDG in the prefill at d = 16, UBLKCP in the
     decode, HMMA, UTMALDG and LDGSTS in the fused LSH kernel, HMMA and
     LDGSTS in the masked attend and the scorer, HMMA and UBLKCP in both
     attends, TMA in the scan; HGMMA and UTMALDG in the training
     backward's dK/dV and dQ kernels at d = 64 and 128, UBLKCP in dK/dV;
     the disassembly runs beside phase 2 and is checked after it);
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the shapes of the Llama-3.2-1B decode paths (Hq 32, Hkv 8, d 64;
     prefill 8192 and 12000 tokens, decode at the hot cache (B=2, capacity
     384, lengths 68 and 69, bf16 and int8), decode and LSH over 16384
     tokens at B=2, K=10, L=150, with bf16 and with int8 K/V (decode also
     at splits of 512, 1024 and 2048 tokens), the LSH
     kernel with each of its
     exact, poly and none debias forms, and both LSH kernels at splits of
     512, 1024 and 2048 tokens (counts equal); the block_topk scorer,
     rescore-attend and block-attend over 65536 tokens at B=2, lengths 65536
     and 40000, 512-token blocks, 11 selected, the scorer and rescore also
     over packed int4 K, where they must equal the int8 kernels on the
     unpacked rows bit for bit, and both attends at chunks of 128, 256
     and 512 tokens; the attends also at the block_topk serves' own shape (B=2,
     3 of 32 blocks of a 16384-token offload, lengths 11932 and 6932); the
     int4 matmul at M=2 on each product of the 1B's decode step with fused
     weights (`W4_SHAPES`), each also at 1 to 16 K-splits),
     within `TOL` of it, with its time, its plain version's, a
     library call's where one computes the same function, and the least
     time the card could take; each tolerance must also reject the plain
     version run with a planted fault (a 64-token V or K tile, a whole
     ranking block of K, or one 128-input group of one output tile of the
     int4 weight, zeroed), and the block ids the kernels rank first must be
     the plain version's. The two-stage LSH kernels: the collision scan at
     K=10, L=150 and K=8, L=75 bit for bit (planted collisions in one word
     must change the result), the scan with phase 2's lengths (bit for
     bit, plane bits past each length poisoned, which would collide if
     read; blocks of 8 to 64 words timed), the masked attend from its
     words at K=8, L=75 in its six forms, the odd-L routes timed against
     each other, and
     the scorer's scores-only form (`exact_scores`) over bf16 and int8 K;
     then the head-dim-128 forms at Llama-3.1-8B's shapes (Hq 32, Hkv 8, d
     128): prefill over 8192 and 12000 tokens, bf16 and int8 decode at B=2
     over 16384 + 11000 tokens (splits of 512, 1024 and 2048 timed) and the
     bf16 one at the hot cache, the fused LSH kernel (K=10, L=150) in its
     six forms (bf16 and int8; exact, poly, none) over the same caches
     (counts exact, splits timed for both exact forms), the block scorer,
     rescore-attend and block-attend at both block shapes (bf16, int8 and
     packed int4 K; chunks swept), the masked attend from words at K=8,
     L=75 in its six forms (splits swept for both exact forms), and the
     int4 matmul on each product of the 8B's decode step (`W4_SHAPES_8B`,
     K-splits swept) and, at M=1, on each of the 1B's unfused products at
     a model rank's shapes at 2 model ranks (`W4_SHAPES_TP`, rows
     "w4_matmul_tp_..."); then the group-size-3 forms at Llama-3.2-3B's decode
     shape (Hq 24, Hkv 8, d 128, rows "..._g3") over the same caches: bf16
     and int8 decode (and bf16 at the hot cache), the fused LSH kernel bf16
     and int8 exact, the collision scan at K=10, L=150 and K=8, L=75 bit for
     bit, the masked attend bf16 exact, and the block kernels at both block
     shapes; then the rows at MagicPIG's context length ("..._98k", B=2 in
     a 98304-token state, bench.py's M): bf16 and int8 decode over 98000
     and 61000 tokens, the fused LSH kernel (bf16, exact, K=10, L=150) over
     offloads of 97932 and 60932 tokens, the packed int4 scorer and
     rescore-attend over 192 ranking blocks (16 selected), and flash
     prefill at a query offset (the last 256 queries of a 98000-token
     prefix, as a chunk of a chunked prefill runs it; queries scaled so
     that each attends a few keys) at d 64 and 128
     ("flash_prefill[_d128]_q_offset"); then the sliding-window rows at
     Mistral-7B-v0.1's shapes (window 4096, rows "..._window"): flash
     prefill over 16000 tokens with the window (the bound counts the
     pairs in the window; SDPA with the band mask beside it), flash decode
     from a first row per request at the windowed serve's dense shape
     (lengths 16001 and 4091, first rows 11905 and 0), bf16 and int8, and
     at its hot caches with the sinks fully and partly aged (first rows 4
     and 2), the start ignored and one tile late both rejected; then the
     kernels' general tile and the small head dims (`FORM_SHAPES`, rows
     named as the forms' launch counters, "..._g5", "..._d128_g16",
     "..._d16"): flash prefill over 8192 tokens at d 16 and 32, and at
     SmolLM2-360M's decode shape (15/5 heads of 64: G = 3), group sizes 5,
     6 and 7 at Hq 40 / 48 / 56 over Hkv 8 at d 128 and 64,
     Llama-3.1-405B's (128/8 heads of 128: G = 16) and d 16 and 32 at Hq
     32, Hkv 8: bf16 and int8 decode, the fused LSH kernel and the masked
     attend (bf16 exact; int8 at the shapes the serves run; its five other
     forms at G 6, d 128 and at d 32), the collision scan once a new group
     size, and the block kernels (packed int4 where the serves' shapes
     take it); each within `TOL` of its plain version and its planted fault
     rejected;
  3. serve: `LLM("llama-3.2-1b")` at full width and depth with random
     weights drawn on the card; two requests (12000 and 7000 tokens)
     prefilled into slots 0 and 1, 16 greedy decode steps, clear(), a third
     request (9000 tokens) and 8 more steps; every kernel launch of this
     run is counted and must equal what the path implies. On the card an
     engine's first decode step runs eagerly and every later one replays
     its CUDA graph of the whole step, so the 16 steps are one eager step
     and 15 replays; then clear(), the two first prompts again and the
     same 16 input tokens through the eager step (`LLM._decode`): logits
     equal bit for bit, greedy tokens, the mean sampled fraction and the
     first step's fractions equal. Then a profiled pass: a warm prefill,
     then the eager and the graphed step, each 8 decode steps timed and 2
     under torch.profiler (wall, device busy time, idle share, launches,
     for the graphed step the graph's kernel nodes, kernels by device
     time).
     Then the same weights under the block_topk estimator with int8
     offload (the rescore pipeline): the two first requests, 16 steps,
     launches counted exactly, the realized fraction checked, the graphed
     run held to the eager step, and a profiled decode pass of each. Then
     three quantized configurations of
     bench.py, each with its own random weights drawn and quantized on the
     card, the two first requests, 16 steps, launches counted exactly, the
     graphed run held to the eager step and the profiled passes: its "lsh"
     mode (W8A8 fused weights, LSH K=10,
     L=150 over int8 offload K/V), its "full_int8" mode with int4 weights
     (K=0, every layer dense over int8 K/V, int4 fused weights through the
     packed-nibble kernel at decode size) and its "block_topk4" mode (W8A8
     fused weights, block_topk over packed int4 K and int8 V through the
     packed scorer and rescore, a dense int8 layer 0; the realized fraction
     exact). Between the LSH serve and block_topk, on the LSH serve's
     weights and projections: the sampled mode at K=10, L=150 (its first
     step's sampled fraction in sparse layer 1 equal to the LSH serve's)
     and the masked mode at odd L (K=8, L=75: the scan and the masked
     attend), each counted and profiled like the others. Then, the 1B
     engines freed, `LLM("llama-3.1-8b")` at full width and depth (32
     layers, d 128, random bf16 weights drawn on the card, LSH K=10, L=150,
     dense layers 0 and 16) on the same two prompts, 16 steps, launches of
     the d = 128 forms counted exactly, the graphed run held to the eager
     step, a warm 12000-token prefill and the decode steps profiled; then,
     on the same weights odd L (K=8, L=75: the scan and the d = 128 masked
     attend); on the same weights the reference's baselines, Quest (41
     16-token pages), TopK and OracleSampling (328 tokens), dense layers 0
     and 1, their realized fractions exact (656 / 9432, 328 / 9432); on
     W8A8 and int4 weights quantized from the same bf16 draw,
     the 8B in bench.py's lsh, block_topk4 and full_int8 (+ W4) modes, each
     counted (each int4 shape too), held to its eager step and profiled;
     then `LLM("llama-3.2-3b")` at full width and depth (28 layers, 24/8
     heads of 128: group size 3) under LSH K=10, L=150 on the same prompts,
     counted, held to its eager step, a warm prefill and the decode
     profiled. Then the kernels' general tile at full width: SmolLM2-360M
     from its published config.json values (`SMOLLM2_360M`: 32 layers,
     15/5 heads of 64, G = 3) at full depth, max_length 8192, prompts of
     7000 and 4000 tokens, under LSH (the engine's defaults), block_topk
     over int8 offload and odd L (K=8, L=75), and Llama-3.1-405B
     (`LLAMA_31_405B`: 128/8 heads of 128, G = 16) at full width cut to 4
     of its 126 layers, prompts of 12000 and 7000 tokens, under LSH and
     block_topk int8: each 16 steps counted, held to its eager step bit for
     bit and profiled. Then the 1B at MagicPIG's context length: B=8 slots of a
     98304-token state, each built by `synthetic_prefill` at 98000 tokens,
     in bf16 LSH (K=10, L=150) and in bench.py's block_topk4 mode (16 of
     192 blocks, the realized fraction exact), 16 greedy steps, launches
     counted, the graphed run held to the eager step bit for bit, and a
     profiled pass through `utils/profiling` (StepTimer wall, a Chrome
     trace under traces/, device busy, idle share, graph
     nodes). Then the `Scheduler` over two slots at max_length 98304 and
     chunk_size 8192: four requests of 98000, 61000, 30000 and 12000
     random tokens, 16 tokens each, synchronous and then interleaved (one
     chunk a step): flash_prefill launches equal the requests (chunks)
     times the layers, one graph capture per engine across admissions and
     releases, first-token logits of the two runs within 5e-2 of the
     largest |logit|, greedy tokens equal up to the first near tie of the
     synchronous run; then idle slots: a `Scheduler` over four slots fed
     four requests one at a time, 200 tokens each, so the last slot's hot
     length passes its 384-row cache before it is used: the graphed run
     raises no device assert and its tokens equal an eager engine's. Before
     the 98K serves, Mistral-7B-v0.1 from its published config.json values
     (sliding window 4096) at full width and depth, random bf16 weights,
     LSH K=10, L=150, prompts of 16000 and 4090 tokens: offload lengths
     4032 and 4022 (the window's clip), 16 steps counted and held to the
     eager step bit for bit while request 1's sinks leave the window, the
     first step with the window off moving request 0's logits past 5e-2
     of their largest, a warm prefill and the decode profiled; then a
     two-layer checkpoint at its width written, read back by
     `load_checkpoint` byte for byte, and `examples/generation_torch.py`
     run on it in its own process over a 6240-byte prompt (beside phase 4,
     which times nothing). Last, sharded
     serving over torch.distributed on the one card (`parallel/`): NCCL at
     one rank in this process (the 1B under LSH over the 12000- and
     7000-token prompts, `shard_engine` over a 1 x 1 mesh on the
     unsharded engine's weights: 16 steps' logits equal bit for bit, the
     step captured once with its collectives, launches exact); then four
     gloo ranks sharing the card, started once: two of them on a 1 x 2
     mesh (the 8B at full depth, bf16 LSH, one 8192-token prompt, 8 eager
     steps on the unsharded run's tokens) and all four on a 2 x 2 mesh
     (the ring over "data": the 1B over 8192 + 6144 tokens through the
     zigzag ring, 8 steps; then bench.py's block_topk4 mode with int4
     weights, 4 steps), each rank's launches exact at its local shapes,
     prefill logits within `SHARD_TOL` of the unsharded engine on the
     card; with the smooth runs (LSH at K=1, L=32, 4 steps: the 8B at 1 x
     2 over a 2048-token prompt and the 1B with int4 weights through the
     ring at 2 x 2 over 4096 + 3072 tokens), whose every decode step is
     also held within `SHARD_TOL`; each planted fault (one rank keeping its own
     partial of an all-reduce in the prefill or in the first decode step,
     a ring pass not rotated, the kv-head shards swapped) outside the
     bounds of its run; a line per run and rank with
     wall and device busy per step, the collectives' share, launches and
     graph nodes, the card's name and power limit;
  4. reference: a two-layer cut of the same width at K=1, L=32 (nearly
     every key sampled) on the card against the same engine on the CPU
     (the plain versions); then the same cut under block_topk with bf16
     offload (the store pipeline, every block attended), launches counted;
     then the cut with int4 fused weights, LSH K=1, L=32 over int8 offload
     and a dense int8 layer 0 (all three kernels of the quantized slice),
     launches counted; then, 2 steps each, block_topk over packed int4 K on
     the store pipeline and LSH K=1, L=32 over int4-grid K with the poly
     debias against the CPU, and the bf16 poly, bf16 none and int8 none LSH
     forms on the card alone, launches counted; then the sampled mode at
     K=1, L=32 (its 128-id budget truncating) and the masked mode at K=1,
     L=31 over int8 offload with the poly debias against the CPU, and the
     other masked-attend forms at K=8, L=75 on the card alone; then at
     head dim 128 (hidden 1024, 8/2 heads of 128): the store pipeline over
     bf16 and packed int4 K, LSH K=1, L=32 over int8 offload with poly and
     over bf16 with none, each against the CPU, and the bf16 poly and int8
     none LSH forms, block_topk over int8 K and the masked attend's other
     forms at K=8, L=75 on the card alone; then with Llama-3.2-3B's head
     shape (hidden 768, 6/2 heads of 128, group size 3): odd L (K=1, L=31)
     over int8 with poly, the sampled mode at K=1, L=32 and the store
     pipeline over bf16 and packed int4 K against the CPU, and block_topk
     over int8 K, bench.py's block_topk4, LSH over int8 offload and odd L
     (K=8, L=75) over bf16 on the card alone; then chunked prefill
     (`start_prefill`, 512-token chunks) at d 64 (1B width) and d 128 (the
     8B's head shape) against the CPU, 2 steps of LSH at K=1, L=32,
     launches counted; then with a sliding window of 512 at Mistral's head
     shape (hidden 1024, 8/2 heads of 128) against the CPU, 4 steps each:
     LSH K=1, L=32 over a 510-token prompt whose position crosses the
     window, the same over int8 offload and dense on 1500 tokens, and
     chunked prefill; then llama-tiny (8/2 heads of 16) and the same model
     at head dim 32, two layers each, 2 steps against the CPU under LSH
     K=1, L=32, odd L (K=1, L=31), the sampled mode and block_topk over int8
     offload (every block attended), launches counted; then the baselines
     at the 8B's head shape (layer 1's
     query weight x4): TopK and Quest at full budget and OracleSampling at
     2048 draws against the K=0 engine on layer 1's f32 output (2e-3,
     0.15) and the logits (5e-2, 0.15), each tolerance rejecting the top
     token of every head dropped, and at their default budgets the sparse
     choice of a card engine's step, on its inputs, equal on the CPU;
  5. train: the training attention's backward kernel (`flash_prefill_bwd`)
     against its plain version at the needle trainer's shape (B = 32, S =
     1024, 8/4 heads of 64), the RULER LM's (B = 8, S = 8192) and a cut with
     a window of 1024, query offsets and lengths short of 4096 keys, and at
     every head dim and group size (`BWD_FORMS`: Llama-3.2-3B's 24/8 heads
     of 128 at B = 2, S = 4096 and with the window cut, Llama-3.1-405B's
     128/8, SmolLM2-360M's 15/5 of 64, llama-tiny's 8/2 at d 16 and 32),
     within `BWD_TOL` of each gradient's largest |value|, bit-equal from
     run to run, one key tile's dV dropped rejected, SDPA's backward timed
     beside each form (the window's through its mask); then
     `examples/train_needle_torch.py` at full width (needle-12m, B = 32, S
     = 1024, 20 steps from the weights `init_params` draws on the CPU from
     seed 0) through the kernels and through their plain versions
     (patched into FlashPrefillTrain), each step's loss within
     `TRAIN_LOSS_TOL` of the other's and steps 0 and 19 of the JAX
     example's on the CPU from the same weights
     (`results/train_needle_jax_cpu/`, the weights' digest checked), every
     leaf's step-0 gradient within `TRAIN_GRAD_TOL` of the plain versions',
     a backward that drops dq rejected by both checks, launches counted (the prefill twice
     a layer and step, the backward once); then
     `examples/train_ruler_lm_torch.py` at full width (B = 8, S = 8192, 3
     steps) the same two ways; ms per step of both models, steps 1-2 of a
     3-step run of each profiled (device busy, idle share, kernels by
     device time), and the backward's time against its bound, with the
     card's name and power limit; then Llama-3.2-3B's width cut to 2
     layers (`TRAIN_3B`: B = 2, S = 4096, 3 steps, seed 0's weights drawn
     on the CPU) through `training` the same two ways and with the dq
     fault, losses and every leaf's step-0 gradient held to the plain
     versions', the fault rejected by both, launches counted under the d =
     128 names, its last step profiled; and llama-tiny at d 16 and its d 32
     twin, 3 steps each, losses held to the plain versions'.
Any failure raises. The last two lines are the kernels' JSON and the result
JSON; the card's name and power limit come just before them.
"""

import contextlib
import gc
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
# INT32 operations a second, the rate of the scan's LOP3s: 64 INT32 lanes a
# SM x 132 SMs x the 1.98 GHz boost clock (H100 SXM5, NVIDIA's Hopper
# architecture white paper).
H100_INT32_OPS = 64 * 132 * 1.98e9
ATTEND_CHUNKS = (128, 256, 512)    # the attends' chunks swept

# Each kernel against its plain version on the card, as (atol, rtol,
# rms_share): |kernel - plain| <= atol + rtol * |plain| + rms_share *
# rms(plain) everywhere (rms over the finite entries). The prefill output
# is bf16: one rounding step of it is up to 2^-7 of its value, and the
# kernel's bf16 probabilities in P.V move an early query's output, a mix of
# a few V rows, by a few 1e-3 in the units of V. The decode partials are
# f32 and differ by the plain version's bf16 probabilities (flash_decode
# rounds its own to bf16 too, from its approximate exp2), an error that
# scales with the output: under 0.01 of its rms; the block-attend partials
# (rescore_attend, block_attend) likewise. The lse differs by f32 rounding
# alone. The block scores are f32 sums of the same bf16-exact products in
# another order (the scorer's on tensor cores): 1.4e-6 at most where they
# reach ~5. The int8 decode and LSH partials as their bf16 forms (the plain
# versions round p times the V scale to bf16, as flash_decode and the LSH
# kernels do). The int4 matmul's
# output is an f32 sum of the same exact products (bf16 times a nibble) in
# another order.
TOL = {
    "flash_prefill": (4e-3, 1e-2, 0.0),
    "flash_decode": (0.0, 0.0, 0.015),
    "lsh_fused_decode": (0.0, 0.0, 0.015),
    "block_scores": (1e-5, 1e-5, 0.0),
    "block_attend": (0.0, 0.0, 0.015),
    "w4_matmul": (0.0, 0.0, 1e-5),
    "lse": (1e-4, 1e-5, 0.0),
}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, calls: int = 20, batches: int = 5) -> float:
    """Time of one call: CUDA events around `calls` back-to-back calls,
    divided by `calls`; the median over `batches` such runs, after a
    warm-up run."""
    import torch
    times = []
    for i in range(batches + 1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        if i:
            times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(fn) -> tuple:
    """Run `fn` once under torch.profiler: (device busy ms, kernel
    launches, kernels by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_kernels(prof)


def device_kernels(prof) -> tuple:
    """(device busy ms, kernel launches, kernels by device time) of a
    finished torch.profiler session."""
    import torch
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=_device_us, reverse=True)
    return (sum(map(_device_us, kernels)) / 1e3,
            sum(e.count for e in kernels), kernels)


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call: the kernel time torch.profiler records over
    `calls` calls, divided by `calls` (no host time between launches). The
    profiler now and then drops kernels from a session, so three sessions
    run and the one that recorded the most kernels counts."""
    import torch
    fn()
    torch.cuda.synchronize()
    sessions = [profiled(lambda: [fn() for _ in range(calls)])
                for _ in range(3)]
    return max(sessions, key=lambda s: s[1])[0] / calls


def timings(kernel, plain, library=None) -> dict:
    """Event time per call of the kernel (its `ms`), its plain version and
    the library call, and profiler device time of the kernel and the
    library call. The plain versions are timed over fewer calls (3 x 3): the
    slowest takes ~67 ms a call, and its time is a reference, not a
    yardstick."""
    return dict(
        ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, calls=3, batches=3),
        library_ms=None if library is None else cuda_ms(library),
        device_ms=device_ms(kernel),
        library_device_ms=None if library is None else device_ms(library))


def limit_share(got, want, tol) -> tuple:
    """(max |got - want|, max over elements of |got - want| / its limit
    under `tol`, a `TOL` entry); equal values, such as the -inf lse of an
    empty row, count as 0, and a NaN anywhere gives NaN."""
    import torch
    atol, rtol, rms_share = tol
    got, want = got.float(), want.float()
    finite = want[torch.isfinite(want)]
    rms = float(finite.square().mean().sqrt()) if finite.numel() else 0.0
    same = got == want
    err = torch.where(same, 0.0, (got - want).abs())
    limit = atol + rms_share * rms + rtol * want.abs()
    share = torch.where(same, 0.0, err / limit)
    return float(err.max()), float(share.max())


def check_close(name, got, want, tol) -> tuple:
    """got within `tol` of want everywhere, or raise; returns the max abs
    error and the largest share of its limit an element used."""
    err, share = limit_share(got, want, tol)
    if not share <= 1:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{err:.3e}, {share:.2f}x the limit of (atol, rtol, rms_share) "
            f"{tol})")
    return err, share


def check_rejects(name, faulty, want, tol, fault="a skipped 64-token V "
                  "tile") -> float:
    """The tolerance can see a fault: the plain version run on inputs with
    a planted fault (by default one 64-token V tile zeroed, a kernel that
    skipped a tile) must fail it. Returns how many times its limit that
    fault's worst element is."""
    share = limit_share(faulty, want, tol)[1]
    if not share > 1:
        raise AssertionError(f"{name}: the tolerance {tol} passes {fault}")
    return share


def drop_tile(v, dim: int, start: int, n: int = 64):
    """A copy of v with the n tokens from `start` along `dim` zeroed."""
    v = v.clone()
    v.narrow(dim, start, n).zero_()
    return v


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernels whose SASS phase 1 counts (one template instance each: G = 4 for
# the block and LSH kernels, and G = 3 for the fused LSH kernel at d = 128
# and the scan; the LSH template's two kernels told apart by
# its kWords flag in the mangled name, the head dims 64 and 128 by the
# last template argument, and the bf16 and int8 (`a`) forms at d = 128 of
# the decode and the fused LSH kernel (its exact form) by their types),
# and the instructions counted: warpgroup MMA, TMA tensor load, bulk copy,
# mma.sync, cp.async and integer-to-float conversion.
SASS_KERNELS = {
    "flash_prefill_kernel": ("flash_prefill_kernel", "ILi64E"),
    "flash_prefill_kernel d128": ("flash_prefill_kernel", "ILi128E"),
    "flash_decode_kernel": ("flash_decode_kernel", "Li64ELb0EE"),
    "flash_decode_kernel d128": ("flash_decode_kernel",
                                 "bfloat16Li128ELb0EE"),
    "flash_decode_kernel int8 d128": ("flash_decode_kernel", "EaLi128ELb0EE"),
    "block_score_kernel": ("block_score_kernel", "Li4E", "Li64EEEv"),
    "block_score_kernel d128": ("block_score_kernel", "Li4E", "Li128EEEv"),
    "rescore_attend_kernel": ("rescore_attend_kernel", "Li4E", "Li64EE"),
    "rescore_attend_kernel d128": ("rescore_attend_kernel", "Li4E",
                                   "Li128EE"),
    "block_attend_kernel": ("block_attend_kernel", "Li4E", "Li64EE"),
    "block_attend_kernel d128": ("block_attend_kernel", "Li4E", "Li128EE"),
    "w4_matmul_kernel": ("w4_matmul_kernel",),
    "lsh_masked (lsh_split_kernel, words)": ("lsh_split_kernel", "Li4E",
                                             "Lb1ELi64E"),
    "lsh_fused (lsh_split_kernel, scan)": ("lsh_split_kernel", "Li4E",
                                           "Lb0ELi64E"),
    "lsh_fused d128 (lsh_split_kernel, scan)": (
        "lsh_split_kernel", "Li4E13__nv_bfloat16Li0ELb0ELi128E"),
    "lsh_fused int8 d128 (lsh_split_kernel, scan)": (
        "lsh_split_kernel", "Li4EaLi0ELb0ELi128E"),
    "lsh_fused g3 d128 (lsh_split_kernel, scan)": (
        "lsh_split_kernel", "Li3E13__nv_bfloat16Li0ELb0ELi128E"),
    "lsh_masked d128 (lsh_split_kernel, words)": (
        "lsh_split_kernel", "Li4E13__nv_bfloat16Li0ELb1ELi128E"),
    "collision_words_kernel": ("collision_words_kernel", "Li4E"),
    "collision_words_kernel g3": ("collision_words_kernel", "Li3E"),
    # The general tile (kPart: G = 16 in the decode and LSH kernels, 8 in
    # the scan; the block scorer's and both attends' own tile kernels) and
    # the small head dims.
    "flash_prefill_kernel d16": ("flash_prefill_kernel", "ILi16E"),
    "flash_decode_kernel tile d16": ("flash_decode_kernel", "Li16ELb1EE"),
    "flash_decode_kernel tile d128": ("flash_decode_kernel",
                                      "bfloat16Li128ELb1EE"),
    "lsh_fused tile d64 (lsh_split_kernel, scan)": (
        "lsh_split_kernel", "Li16E13__nv_bfloat16Li3ELb0ELi64ELb1EE"),
    "lsh_masked tile d16 (lsh_split_kernel, words)": (
        "lsh_split_kernel", "Li3ELb1ELi16ELb1EE"),
    "block_score_tile_kernel d16": ("block_score_tile_kernel", "Li16EEEv"),
    "block_score_tile_kernel d128": ("block_score_tile_kernel", "Li128EEEv"),
    "rescore_attend_part_kernel d16": ("rescore_attend_part_kernel", "Li16EE"),
    "rescore_attend_part_kernel d128": ("rescore_attend_part_kernel",
                                        "Li128EE"),
    "block_attend_part_kernel d32": ("block_attend_part_kernel", "Li32EE"),
    "collision_words_kernel tile": ("collision_words_kernel", "Li8ELb1E"),
    # The training backward's two kernels at head dims 64 and 128.
    "flash_bwd_dkdv_kernel": ("flash_bwd_dkdv_kernel", "ILi64E"),
    "flash_bwd_dkdv_kernel d128": ("flash_bwd_dkdv_kernel", "ILi128E"),
    "flash_bwd_dq_kernel": ("flash_bwd_dq_kernel", "ILi64E"),
    "flash_bwd_dq_kernel d128": ("flash_bwd_dq_kernel", "ILi128E"),
}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA", "LDGSTS", "I2F")


def start_sass_dump(so):
    """The toolkit's cuobjdump of the built library's SASS, started in the
    background (it takes ~20 s) into a file beside the library. Returns
    (process, file)."""
    from pathlib import Path

    from magicpig_tpu_torch.ops.kernels import _lib

    tool = Path(_lib.nvcc_path()).parent / "cuobjdump"
    path = so.with_suffix(".sass")
    with open(path, "w") as out:
        proc = subprocess.Popen([str(tool), "--dump-sass", str(so)],
                                stdout=out)
    return proc, path


def sass_counts(dump) -> dict:
    """Per kernel of `SASS_KERNELS` (its first instance whose mangled name
    holds every listed part), the counts of `SASS_OPS` instructions in the
    SASS dump that `start_sass_dump` started."""
    proc, path = dump
    if proc.wait() != 0:
        raise RuntimeError(f"cuobjdump failed with exit code {proc.returncode}")
    sass = path.read_text()
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k, parts in SASS_KERNELS.items()
                         if all(p in fn for p in parts)), None)
            if name in counts:
                name = None          # one template instance is enough
            elif name is not None:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += f" {op}" in line
    return counts


def check_sass(counts) -> None:
    """The redesigned kernels use what they were designed for: mma.sync in
    the scorer, both attends of the selected blocks and the int4 matmul
    (which converts no integer to float: its nibbles become bf16 by bit
    operations), bulk copies in both attends, cp.async in the scorer, the
    int4 matmul and both LSH kernels, TMA in both collision scans (the
    fused kernel's and the standalone one, at G = 3 too); and in both head
    dims' forms of the prefill warpgroup MMA and TMA, of the decode bulk
    copies (int8 at d = 128 too), of the fused LSH kernel mma.sync, TMA and
    cp.async (int8 and G = 3 at d = 128 too), of the masked attend mma.sync
    and cp.async, of the scorer mma.sync and cp.async, of both attends
    mma.sync and bulk copies; the same in the general tile's instances and
    at the small head dims (the prefill at d = 16, the decode at d = 16
    and 128, with mma.sync,
    the fused LSH kernel at d = 64, the masked attend, the rescore at d =
    16, the block-attend at d = 32, the scan), where the scorer's and the
    rescore's 16-head tiles (d = 16 and 128) use mma.sync and bulk copies;
    and in the
    training backward's dK/dV and dQ kernels at head dims 64 and 128
    warpgroup MMA and TMA, bulk copies (lse and delta) in dK/dV."""
    if counts.get("w4_matmul_kernel", {}).get("I2F", 1) != 0:
        raise AssertionError("w4_matmul_kernel: I2F in its SASS")
    for name, op in (("block_score_kernel", "HMMA"),
                     ("rescore_attend_kernel", "HMMA"),
                     ("rescore_attend_kernel", "UBLKCP"),
                     ("block_attend_kernel", "HMMA"),
                     ("block_attend_kernel", "UBLKCP"),
                     ("w4_matmul_kernel", "HMMA"),
                     ("w4_matmul_kernel", "LDGSTS"),
                     ("block_score_kernel", "LDGSTS"),
                     ("lsh_masked (lsh_split_kernel, words)", "LDGSTS"),
                     ("lsh_fused (lsh_split_kernel, scan)", "LDGSTS"),
                     ("lsh_fused (lsh_split_kernel, scan)", "UTMALDG"),
                     ("collision_words_kernel", "UTMALDG"),
                     *((f"flash_prefill_kernel{dim}", op)
                       for dim in ("", " d128") for op in ("HGMMA", "UTMALDG")),
                     *((f"flash_decode_kernel{dim}", "UBLKCP")
                       for dim in ("", " d128", " int8 d128")),
                     *((f"lsh_fused{dim} (lsh_split_kernel, scan)", op)
                       for dim in ("", " d128", " int8 d128", " g3 d128")
                       for op in ("HMMA", "UTMALDG", "LDGSTS")),
                     ("lsh_masked d128 (lsh_split_kernel, words)", "HMMA"),
                     ("lsh_masked d128 (lsh_split_kernel, words)", "LDGSTS"),
                     ("collision_words_kernel g3", "UTMALDG"),
                     ("block_score_kernel d128", "HMMA"),
                     ("block_score_kernel d128", "LDGSTS"),
                     *((f"{kernel} d128", op)
                       for kernel in ("rescore_attend_kernel",
                                      "block_attend_kernel")
                       for op in ("HMMA", "UBLKCP")),
                     ("flash_prefill_kernel d16", "HGMMA"),
                     ("flash_prefill_kernel d16", "UTMALDG"),
                     *((f"flash_decode_kernel tile d{dim}", op)
                       for dim in (16, 128) for op in ("UBLKCP", "HMMA")),
                     *(("lsh_fused tile d64 (lsh_split_kernel, scan)", op)
                       for op in ("HMMA", "UTMALDG", "LDGSTS")),
                     ("lsh_masked tile d16 (lsh_split_kernel, words)", "HMMA"),
                     ("lsh_masked tile d16 (lsh_split_kernel, words)",
                      "LDGSTS"),
                     *((kernel, op) for kernel in (
                         "block_score_tile_kernel d16",
                         "block_score_tile_kernel d128",
                         "rescore_attend_part_kernel d16",
                         "rescore_attend_part_kernel d128",
                         "block_attend_part_kernel d32")
                       for op in ("HMMA", "UBLKCP")),
                     ("collision_words_kernel tile", "UTMALDG"),
                     *((f"flash_bwd_{part}_kernel{dim}", op)
                       for part in ("dkdv", "dq") for dim in ("", " d128")
                       for op in ("HGMMA", "UTMALDG")),
                     ("flash_bwd_dkdv_kernel", "UBLKCP"),
                     ("flash_bwd_dkdv_kernel d128", "UBLKCP")):
        if counts.get(name, {}).get(op, 0) == 0:
            raise AssertionError(f"{name}: no {op} instruction in its SASS")


def attend_chunk_sweep(name: str, call) -> dict:
    """An attend of the selected blocks (`call(chunk)`: its launcher, None
    for `chunk_plan`'s choice) timed at each chunk of ATTEND_CHUNKS, device
    us, each chunk's output within `TOL` of the default's: the evidence for
    `chunk_plan`."""
    want, times = call(None)[0], {}
    for chunk in ATTEND_CHUNKS:
        check_close(f"{name} chunk {chunk}", call(chunk)[0], want,
                    TOL["block_attend"])
        times[chunk] = round(device_ms(lambda: call(chunk)) * 1e3, 2)
    log(f"  {name} device us by chunk tokens: {times}")
    return times


def evicted_us(torch, fn, key: str, reps: int = 12) -> float:
    """Device us of the kernel whose name holds `key` in `fn()`, with the
    50 MB L2 emptied before each call by a 512 MB read: its code and its
    rows come from device memory, as a serve's layer finds them after its
    weight GEMMs. The median of `reps` calls (profiler events)."""
    from torch.profiler import ProfilerActivity, profile

    evict = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            evict.sum()
            fn()
        torch.cuda.synchronize()
    del evict
    times = sorted(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and key in e.name)
    if not times:
        raise AssertionError(f"no kernel named *{key}* in the profile")
    return times[len(times) // 2]


def serve_selected(max_length: int) -> int:
    """The blocks a block_topk serve at `max_length` selects (LSHConfig's
    defaults): 8% of the offload capacity's 512-token blocks, rounded up
    (2 at SmolLM2's 8192, 3 at 16384)."""
    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.runtime.state import offload_capacity

    lsh = LSHConfig(estimator="block_topk", offload_quant="int8")
    nb = offload_capacity(lsh, max_length) // lsh.block_topk_block_size
    return min(nb, max(1, math.ceil(nb * lsh.block_topk_budget_frac)))


def attend_split_sweep(torch, name: str, call, tokens: int) -> dict:
    """The attends' general tile (`call(chunk)`: its launcher at `chunk`
    tokens a CUDA block, None for `tile_plan`'s choice) at a serve's
    selected count (`tokens` a (request, kv head, block of heads)), the
    kernel alone after an L2 eviction (`evicted_us`): at the plan's choice
    ("plan"), at ATTEND_CHUNKS tokens a CUDA block and at the whole
    list (one CUDA block a triple, no merge), device us, each output within
    `TOL` of the plan's: the evidence for `tile_plan`."""
    want = call(None)[0]
    times = {"plan": round(evicted_us(torch, lambda: call(None),
                                      "attend_part"), 2)}
    for chunk in sorted({c for c in ATTEND_CHUNKS if c < tokens}
                        | {tokens}):
        check_close(f"{name} chunk {chunk}", call(chunk)[0], want,
                    TOL["block_attend"])
        times[chunk] = round(evicted_us(torch, lambda: call(chunk),
                                        "attend_part"), 2)
    log(f"  {name} at {tokens} selected tokens a triple, L2 evicted: "
        f"device us by tokens a CUDA block: {times}")
    return times


def w4_split_sweep(name: str, x, w) -> dict:
    """The int4 matmul timed at about 1 to 16 K-splits (at most 16 groups a
    split) with the wrapper's columns a lane, device us: the evidence for
    `w4_plan`."""
    from magicpig_tpu_torch.ops.kernels.flash_decode import device_state
    from magicpig_tpu_torch.ops.kernels.w4_matmul import (
        MAX_GROUPS_PER_BLOCK, W4_GROUP, launch_w4, split_groups, w4_plan)

    (m, kin), out = x.shape, w.scale.shape[1]
    lane_cols = w4_plan(kin, out, m, device_state(x.device, 1)[1])[0]
    groups, times = kin // W4_GROUP, {}
    for want in (1, 2, 4, 8, 16):
        ksplit, per = split_groups(groups, want)
        if per <= MAX_GROUPS_PER_BLOCK and ksplit not in times:
            times[ksplit] = round(device_ms(
                lambda: launch_w4(x, w.q, w.scale, ksplit, per, lane_cols)) * 1e3, 2)
    log(f"  {name} device us by K-splits ({lane_cols} columns a lane): {times}")
    return times


def lsh_split_sweep(torch, name: str, entry: str, args, selection) -> dict:
    """An LSH kernel's device time (us) for splits of 512, 1024 and 2048
    tokens on the given inputs (`args` as `lsh_masked_attention`'s, its
    selection replaced by `selection`), each split's counts equal to the
    first's: the evidence for `LSH_SPLIT`."""
    from magicpig_tpu_torch.ops.kernels.lsh_masked import launch_attend

    q, k, v, k_norm, _, length, K, L, ks, vs, debias = args
    times, counts = {}, None
    for split in (512, 1024, 2048):
        def call():
            return launch_attend(name, entry, q, k, v, ks, vs, k_norm,
                                 selection, length, K, L, debias, split=split)
        cnt = call()[2]
        if counts is not None and not torch.equal(cnt, counts):
            raise AssertionError(f"{name}: split {split} changes the counts")
        counts = cnt
        times[split] = round(device_ms(call) * 1e3, 2)
    log(f"  {name} (Hq {q.shape[1]}) device us by split tokens: {times}")
    return times


def phase_kernels(torch, F, dev):
    """Each kernel against its plain version at the slice's shapes."""
    from magicpig_tpu_torch.ops import bitcodes

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    hq, hkv, d, K, L = 32, 8, 64, 10, 150
    results = {}

    # -- flash prefill: one 8192-token prompt, causal, and the serve's
    # 12000-token prompt.
    results.update(prefill_kernel(torch, F, rnd, 8192, "flash_prefill"))
    results.update(prefill_kernel(torch, F, rnd, 12000, "flash_prefill_12000"))

    # -- flash decode: B=2 over a 16384-token cache, one request ragged.
    b, s = 2, 16384
    lens = [16384, 11000]
    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    results["flash_decode"] = decode_row(torch, F, q, k, v, length, lens,
                                         "flash_decode")
    decode_split_sweep(torch, q, k, v, length)

    # -- fused LSH decode: the same caches as centered keys, K=10, L=150.
    proj = torch.randn((d, K * L), generator=gen, device=dev)
    k_norm = k.float().norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    q_bits = bitcodes.hash_bits(q, proj, K)
    results["lsh_fused_decode"], (nbytes, rows, flops) = lsh_row(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L), lens,
        "lsh_fused_decode")
    lsh_split_sweep(torch, "lsh_fused_decode", "mp_lsh_fused_decode",
                    (q, k, v, k_norm, None, length, K, L, None, None, "exact"),
                    (planes, q_bits))
    results.update(lsh_debias_forms(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L, None, None),
        nbytes, rows, flops))
    results.update(int8_decode_kernels(torch, q, k, v, length, lens, proj, K, L))
    results.update(hot_decode_kernels(torch, F, rnd))
    log_timings(results)
    two_stage = two_stage_kernels(torch, F, gen, q, k, v, length, lens,
                                  planes, q_bits)
    log_timings(two_stage)
    results.update(two_stage)
    return results


def head_tile_faults(hq: int, hkv: int) -> list:
    """Planted faults of the decode and LSH kernels' 16-head tile, as
    (label, function of the plain output [B, Hq, d]), for a group of hq /
    hkv heads: from 16 heads, the last head of each 16-head block given its
    neighbour's output (a tile that lost its last M row); from 48, the
    third block given the first block's outputs (a block that read the
    wrong heads' queries)."""
    g = hq // hkv

    def last_head(want):
        w = want.unflatten(1, (hkv, g))
        f = w.clone()
        f[:, :, 15::16] = w[:, :, 14::16]
        return f.flatten(1, 2)

    def third_block(want):
        w = want.unflatten(1, (hkv, g))
        f = w.clone()
        f[:, :, 32:48] = w[:, :, :16]
        return f.flatten(1, 2)

    faults = []
    if g >= 16:
        faults.append(("the last head of each 16-head block given its "
                       "neighbour's output", last_head))
    if g >= 48:
        faults.append(("the third 16-head block given the first block's "
                       "outputs", third_block))
    return faults


def reject_head_faults(name: str, want, hq: int, hkv: int, tol) -> None:
    """Each of `head_tile_faults` fails the tolerance."""
    for label, fault in head_tile_faults(hq, hkv):
        share = check_rejects(name, fault(want), want, tol, fault=label)
        log(f"  {name}: {label}: its worst element {share:.1f}x the limit")


def decode_row(torch, F, q, k, v, length, lens, name: str) -> dict:
    """flash_decode (bf16) over the given caches against its plain version,
    a skipped 64-token V tile rejected (and the faults of the 16-head tile,
    `head_tile_faults`), SDPA (length mask, GQA) beside it, the bound from
    the valid tokens' K and V bytes."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_decode

    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    (got, got_lse) = flash_decode(q, k, v, length)
    (want, want_lse) = attention.full_decode(q, k, v, length)
    tol = TOL["flash_decode"]
    err, share = check_close(name, got, want, tol)
    err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects(name, attention.full_decode(
        q, k, drop_tile(v, 2, 8192), length)[0], want, tol)
    reject_head_faults(name, want, hq, hkv, tol)
    mask = (torch.arange(s, device=q.device)[None]
            < length[:, None])[:, None, None]
    q4 = q[:, :, None]
    nbytes = (sum(lens) * hkv * d * 2 * 2 + q.numel() * 2
              + b * hq * (d + 1) * 4)
    flops = 4 * d * hq * sum(lens)
    row = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        **timings(lambda: flash_decode(q, k, v, length),
                  lambda: attention.full_decode(q, k, v, length),
                  lambda: F.scaled_dot_product_attention(
                      q4, k, v, attn_mask=mask, enable_gqa=True)))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
        f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x the "
        "limit")
    return row


def lsh_row(torch, args, lens, name: str):
    """The fused LSH kernel (bf16, exact) on `args` (q, centered K, V, key
    norms, planes, query bits, length, K, L) against its plain version:
    counts exact, a skipped 64-token V tile rejected (and the faults of the
    16-head tile, `head_tile_faults`), the bound from the
    bytes this run needs (every valid signature word; K, V and the norm of
    the tokens some head of the group sampled; q, its bits, outputs).
    Returns (the row, (bytes, sampled rows, flops))."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.kernels import _lib, lsh_fused_decode
    from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain

    q, k, v, k_norm, planes, q_bits, length, K, L = args
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    got, got_lse, got_cnt = lsh_fused_decode(*args)
    want, want_lse, want_cnt = lsh_fused_decode_plain(*args)
    if not torch.equal(got_cnt, want_cnt):
        raise AssertionError(f"{name}: sampled counts differ")
    tol = TOL["lsh_fused_decode"]
    err, share = check_close(name, got, want, tol)
    err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects(name, lsh_fused_decode_plain(
        q, k, drop_tile(v, 2, 8192), k_norm, planes, q_bits, length, K,
        L)[0], want, tol)
    reject_head_faults(name, want, hq, hkv, tol)
    sampled = bitcodes.sampled_mask(q_bits, planes, length)    # [B, Hq, S]
    rows = int(sampled.reshape(b, hkv, -1, s).any(dim=2).sum())
    words = sum((n + 31) // 32 for n in lens) * hkv * L * K
    nbytes = (words * 4 + rows * (2 * d * 2 + 4) + q.numel() * 2
              + q_bits.numel() * 4 + b * hq * (d + 2) * 4)
    flops = 4 * d * int(want_cnt.sum())
    # The matching's ALU bound: one LOP3 a plane word and matched head (the
    # general tile matches its heads rounded up to 4, `scan_tile_heads`).
    g = hq // hkv
    matched = (g if _lib.exact_group(g, d) else
               -(-min(g, _lib.HEAD_TILE) // 4) * 4 * _lib.head_blocks(
                   g, d, _lib.HEAD_TILE))
    match_ms = words * matched / H100_INT32_OPS * 1e3
    row = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        match_bound_ms=match_ms,
        **timings(lambda: lsh_fused_decode(*args),
                  lambda: lsh_fused_decode_plain(*args)),
        sampled_frac=float(want_cnt.sum()) / (hq * sum(lens)),
        rows_frac=rows / (hkv * sum(lens)))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
        f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x the "
        f"limit; counts exact, sampled {row['sampled_frac']:.4f}, rows read "
        f"{row['rows_frac']:.4f}; the matching's bound {match_ms:.4f} ms "
        f"({matched} heads' LOP3s a plane word at the INT32 rate)")
    return row, (nbytes, rows, flops)


def phase_kernels_d128(torch, F, dev):
    """The head-dim-128 forms at Llama-3.1-8B's shapes (Hq 32, Hkv 8, d
    128): flash_prefill over 8192 and 12000 tokens, causal; bf16 and int8
    flash_decode at B=2 over 16384 + 11000 tokens (split sizes swept) and
    the bf16 form at the hot cache; the fused LSH kernel, K=10, L=150 over
    the same caches in all six forms (bf16 and int8; exact, poly, none;
    counts exact; split sizes swept for both exact forms); the masked
    attend from words (the odd-L route), K=8, L=75, in its six forms (split
    sizes swept for both exact forms). Each against its plain version
    within the d = 64 rows' `TOL`, a skipped tile rejected."""
    from magicpig_tpu_torch.ops import bitcodes

    gen = torch.Generator(device=dev)
    gen.manual_seed(1283)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    hq, hkv, d, K, L = 32, 8, 128, 10, 150
    results = {}
    results.update(prefill_kernel(torch, F, rnd, 8192, "flash_prefill_d128",
                                  d=d))
    results.update(prefill_kernel(torch, F, rnd, 12000,
                                  "flash_prefill_d128_12000", d=d))
    b, s = 2, 16384
    lens = [16384, 11000]
    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    results["flash_decode_d128"] = decode_row(torch, F, q, k, v, length, lens,
                                              "flash_decode_d128")
    decode_split_sweep(torch, q, k, v, length)
    proj = torch.randn((d, K * L), generator=gen, device=dev)
    k_norm = k.float().norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    q_bits = bitcodes.hash_bits(q, proj, K)
    results["lsh_fused_decode_d128"], (nbytes, rows, flops) = lsh_row(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L), lens,
        "lsh_fused_decode_d128")
    lsh_split_sweep(torch, "lsh_fused_decode_d128", "mp_lsh_fused_decode",
                    (q, k, v, k_norm, None, length, K, L, None, None, "exact"),
                    (planes, q_bits))
    results.update(lsh_debias_forms(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L, None, None),
        nbytes, rows, flops))
    results.update(two_stage_kernels(torch, F, gen, q, k, v, length, lens,
                                     planes, q_bits, scans=False,
                                     sweep=(False, True)))
    del planes, q_bits
    results.update(int8_decode_kernels(torch, q, k, v, length, lens, proj, K, L))
    results.update(hot_decode_kernels(torch, F, rnd, d=d))
    log_timings(results)
    return results


def phase_kernels_g3(torch, F, dev):
    """Group size 3 at head dim 128, Llama-3.2-3B's decode shape (Hq 24,
    Hkv 8, d 128) over the 8B rows' caches, rows "<form>_d128_g3" (the
    collision scan's "collision_words..._g3"): bf16 and int8 flash_decode
    at B=2 over 16384 + 11000 tokens (splits swept) and the bf16 one at the
    hot cache; the fused LSH kernel, K=10, L=150, bf16 and int8, exact
    (counts exact, splits swept); the collision scan at K=10, L=150 (also
    with the lengths) and K=8, L=75 (bit for bit, planted collisions); the
    masked attend from words at K=8, L=75, bf16 exact; then the block
    kernels at both block shapes (`phase_block_kernels`,
    `serve_attend_kernels`): the scorer over bf16, int8 and packed int4 K,
    the rescore-attend over int8 and packed int4 K, the block-attend. Each
    against its plain version within `TOL`, its planted fault rejected. The
    3B has the 8B's KV heads and head dim: each row reads its G = 4 row's
    bytes, and only the query heads and the arithmetic differ."""
    from magicpig_tpu_torch.ops import bitcodes

    gen = torch.Generator(device=dev)
    gen.manual_seed(1289)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    hq, hkv, d, K, L, tag = 24, 8, 128, 10, 150, "_g3"
    b, s = 2, 16384
    lens = [16384, 11000]
    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    results = {"flash_decode_d128" + tag: decode_row(
        torch, F, q, k, v, length, lens, "flash_decode_d128" + tag)}
    decode_split_sweep(torch, q, k, v, length)
    proj = torch.randn((d, K * L), generator=gen, device=dev)
    k_norm = k.float().norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    q_bits = bitcodes.hash_bits(q, proj, K)
    results["lsh_fused_decode_d128" + tag], _ = lsh_row(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L), lens,
        "lsh_fused_decode_d128" + tag)
    lsh_split_sweep(torch, "lsh_fused_decode_d128", "mp_lsh_fused_decode",
                    (q, k, v, k_norm, None, length, K, L, None, None, "exact"),
                    (planes, q_bits))
    results.update(two_stage_kernels(torch, F, gen, q, k, v, length, lens,
                                     planes, q_bits, forms=((False, "exact"),),
                                     tag=tag, sweep=()))
    del planes, q_bits
    results.update(int8_decode_kernels(torch, q, k, v, length, lens, proj, K,
                                       L, tag=tag, debias_forms=False))
    results.update(hot_decode_kernels(torch, F, rnd, d=d, hq=hq, tag=tag))
    log_timings(results)
    del q, k, v, k_norm
    results.update(phase_block_kernels(torch, dev, d=d, hq=hq, tag=tag))
    results.update(serve_attend_kernels(torch, dev, d=d, hq=hq, tag=tag))
    return results


# The kernels' general tile and the small head dims in phase 2, as (head
# dim, Hq, Hkv, whether every kernel runs, not only the decode paths'):
# SmolLM2-360M's decode shape (15/5 heads of 64: G = 3 at d = 64); group
# sizes 5, 6 and 7 at the decode shapes Hq 40 / 48 / 56 over Hkv 8 at d =
# 128 (Mistral-Small-Instruct-2409's 48/8 and Yi-34B's 56/8) and at d = 64;
# Llama-3.1-405B's 128/8 heads of 128 (G = 16: one block of every
# kernel's 16-head tile a kv head); StarCoder-15B's multi-query 48 heads of 128 over one (three
# 16-head blocks); head dims 16 and 32 at Hq 32, Hkv 8 (llama-tiny's group
# of 4).
FORM_SHAPES = ((64, 15, 5, True), (128, 40, 8, False), (128, 48, 8, False),
               (128, 56, 8, False), (64, 40, 8, False), (64, 48, 8, False),
               (64, 56, 8, False), (128, 128, 8, True), (128, 48, 1, False),
               (16, 32, 8, True), (32, 32, 8, True))
# The forms whose fused LSH kernel runs its five other forms too (one new
# group size, one new head dim): Mistral-Small's G = 6 at d = 128, d = 32.
FORM_DEBIAS = ((128, 48, 8), (32, 32, 8))
# Shapes whose rows cover the decode-side kernels of the 16-head tile only
# (flash decode, both LSH kernels, the scan), not the block kernels.
TILE_ONLY = ((128, 48, 1),)
# The general tile's served shapes (SmolLM2-360M's, the 405B cut's): the
# decode and fused LSH kernels' splits and the rescore's tokens a CUDA
# block (at the serve's selected count) swept, the evidence for the tile's
# `split_tokens`, `LSH_SPLIT` and `tile_plan`.
TILE_SWEEPS = ((64, 15, 5), (128, 128, 8))
# Their serves' max_length (the rescore's sweep runs at its selected count).
TILE_SWEEP_LEN = {(64, 15, 5): 8192, (128, 128, 8): 16384}


def phase_kernels_forms(torch, F, dev):
    """The kernels' general tile and the small head dims (`FORM_SHAPES`),
    rows named as the forms' launch counters ("..._d<d>" at head dims other
    than 64, "..._g<G>" at group sizes other than 1, 2, 4, 8 and 3 at d =
    128): flash_prefill over 8192 tokens at d = 16 and 32 (SDPA beside
    it); at each shape over B=2, 16384 + 11000 tokens: bf16 and int8
    flash_decode (SDPA beside the bf16 one), the fused LSH kernel bf16
    exact (K=10, L=150; counts exact) and the masked attend from words bf16
    exact (K=8, L=75), then (but at `TILE_ONLY`) the block kernels over a
    65536-token offload (the int8 scorer and rescore, the bf16 scorer and
    block-attend); at the shapes marked full also the int8 LSH kernel and,
    at d = 64 and 128, the packed int4 forms; the collision scan (K=10,
    L=150, also with the lengths, and K=8, L=75) once a group size; the
    fused kernel's five other forms at `FORM_DEBIAS`. Each within `TOL` of
    its plain version, its planted faults rejected (the 16-head tile's
    too, `head_tile_faults`); the decode and fused LSH splits and the
    rescore's tokens a CUDA block swept at `TILE_SWEEPS`, no other
    sweeps."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.kernels import _lib

    gen = torch.Generator(device=dev)
    gen.manual_seed(2222)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    results = {}
    for d in (16, 32):
        results.update(prefill_kernel(torch, F, rnd, 8192,
                                      f"flash_prefill_d{d}", d=d))
    K, L, b, s = 10, 150, 2, 16384
    lens = [16384, 11000]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    scanned = {3, 4}     # the scan's exact instances, rows of phases before
    for d, hq, hkv, full in FORM_SHAPES:
        g = hq // hkv
        sfx = "" if d == 64 else f"_d{d}"
        tag = _lib.group_suffix(g, d)
        rows_of = {}
        q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
        rows_of["flash_decode" + sfx + tag] = decode_row(
            torch, F, q, k, v, length, lens, "flash_decode" + sfx + tag)
        sweep = (d, hq, hkv) in TILE_SWEEPS
        if sweep:
            decode_split_sweep(torch, q, k, v, length)
        proj = torch.randn((d, K * L), generator=gen, device=dev)
        k_norm = k.float().norm(dim=-1)
        planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1),
                                                    proj, K)
                              for i in range(b)])
        q_bits = bitcodes.hash_bits(q, proj, K)
        args = (q, k, v, k_norm, planes, q_bits, length, K, L)
        rows_of["lsh_fused_decode" + sfx + tag], (nbytes, n_rows, flops) = (
            lsh_row(torch, args, lens, "lsh_fused_decode" + sfx + tag))
        if sweep:
            lsh_split_sweep(torch, "lsh_fused_decode" + sfx + tag,
                            "mp_lsh_fused_decode",
                            (q, k, v, k_norm, None, length, K, L, None, None,
                             "exact"), (planes, q_bits))
        debias = (d, hq, hkv) in FORM_DEBIAS
        if debias:
            rows_of.update(lsh_debias_forms(torch, (*args, None, None),
                                            nbytes, n_rows, flops, tag))
        rows_of.update(two_stage_kernels(
            torch, F, gen, q, k, v, length, lens, planes, q_bits,
            forms=((False, "exact"),), tag=tag, scans=g not in scanned,
            sweep=(), routes=False))
        scanned.add(g)
        del planes, q_bits, k_norm
        rows_of.update(int8_decode_kernels(
            torch, q, k, v, length, lens, proj if full or debias else None,
            K, L, tag=tag, debias_forms=debias, sweeps=False))
        del q, k, v
        log_timings(rows_of)
        results.update(rows_of)
        if (d, hq, hkv) not in TILE_ONLY:
            results.update(phase_block_kernels(
                torch, dev, d=d, hq=hq, hkv=hkv, tag=tag, sweeps=sweep,
                packed=full and d >= 64))
        torch.cuda.empty_cache()
    return results


LONG_P, LONG_M = 98000, 98304   # bench.py's P and M (bench.py:278-279)
LONG_P2 = 61000                 # phase 2's second request


def phase_kernels_long(torch, F, dev):
    """The decode-side kernels at MagicPIG's context length, rows "..._98k":
    B=2 (where every plain version fits) in a 98304-token state (bench.py's
    M) at the 1B's shapes (Hq 32, Hkv 8, d 64): bf16 and int8 flash_decode
    over 98000 and 61000 tokens (6x the 16384-token rows' splits; split
    sizes swept); the fused LSH kernel, bf16, exact, K=10, L=150, over
    offloads of 97932 and 60932 tokens (the 98000-token prompt's middle:
    3072 signature words a table, counts exact; split sizes swept); the
    packed int4 scorer and rescore-attend over 98304 tokens (192 ranking
    blocks of 512, the 16 of the 8% budget; lengths 97932 and 60932). Then
    the prefill at a query offset, as each chunk of a chunked prefill runs
    it, at d 64 and d 128. Each within `TOL` of its plain version, its
    planted fault rejected."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.quant import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(9800)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    hq, hkv, d, K, L, b = 32, 8, 64, 10, 150, 2
    results = {}
    lens = [LONG_P, LONG_P2]
    q, k, v = rnd(b, hq, d), rnd(b, hkv, LONG_M, d), rnd(b, hkv, LONG_M, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    results["flash_decode_98k"] = decode_row(torch, F, q, k, v, length, lens,
                                             "flash_decode_98k")
    decode_split_sweep(torch, q, k, v, length)
    results.update(int8_decode_kernels(torch, q, k, v, length, lens, None, K,
                                       L, tag="_98k"))
    lens = [n - 68 for n in lens]      # sink 4 + local 64 stay hot
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    proj = torch.randn((d, K * L), generator=gen, device=dev)
    k_norm = k.float().norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    q_bits = bitcodes.hash_bits(q, proj, K)
    results["lsh_fused_decode_98k"], _ = lsh_row(
        torch, (q, k, v, k_norm, planes, q_bits, length, K, L), lens,
        "lsh_fused_decode_98k")
    lsh_split_sweep(torch, "lsh_fused_decode", "mp_lsh_fused_decode",
                    (q, k, v, k_norm, None, length, K, L, None, None, "exact"),
                    (planes, q_bits))
    del planes, q_bits, k_norm
    vq, vs = quantize_rows(v)
    bs, n_sel = 512, 16              # ceil(8% of 192 blocks)

    def same_top(name, got_max, want_max):
        got = torch.topk(got_max, n_sel).indices.sort(dim=-1).values
        want = torch.topk(want_max, n_sel).indices.sort(dim=-1).values
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: top-{n_sel} block ids differ from "
                                 "the plain version's")

    def selected_tokens(ids):
        start = ids.long() * bs
        return int((length.long()[:, None, None] - start).clamp(0, bs).sum())

    results.update(packed_block_kernels(torch, q, k, vq, vs, length, bs,
                                        n_sel, same_top, selected_tokens,
                                        "_98k"))
    del q, k, v, vq, vs
    torch.cuda.empty_cache()
    for dd in (64, 128):
        results.update(prefill_offset_kernel(torch, F, rnd, dd))
    log_timings(results)
    return results


def phase_kernels_window(torch, F, dev):
    """The sliding-window forms at Mistral-7B-v0.1's shapes (Hq 32, Hkv 8,
    d 128, window 4096), rows "..._window": flash_prefill over a 16000-token
    prompt with the window (`prefill_window_kernel`); flash_decode with a
    first row per request at the serve's dense shape, bf16 and int8, and
    at its hot caches with the sinks fully and partly aged
    (`window_decode_kernels`). Each against its plain version within `TOL`,
    its planted faults rejected."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4096)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    results = prefill_window_kernel(torch, F, rnd, MISTRAL_PROMPTS[0],
                                    MISTRAL_V01["sliding_window"])
    torch.cuda.empty_cache()
    results.update(window_decode_kernels(torch, F, rnd))
    log_timings(results)
    return results


def prefill_window_kernel(torch, F, rnd, s: int, window: int,
                          d: int = 128) -> dict:
    """flash_prefill over one s-token prompt with a sliding window (query t
    sees keys (t - window, t]), Hq 32, Hkv 8, head dim d, against its plain
    version; a skipped 64-token V tile and the window ignored (causal over
    the whole prefix) both rejected; the library call SDPA with the band
    mask (the memory-efficient kernel, which takes a boolean mask; K and V
    expanded to the 32 query heads beforehand). The bound counts only the
    (query, key) pairs inside the window. Row "flash_prefill_d128_window"."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_prefill

    hq, hkv = 32, 8
    name = f"flash_prefill_d{d}_window"
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    dev = q.device
    length = torch.full((1,), s, dtype=torch.int32, device=dev)
    got = flash_prefill(q, k, v, length, window=window)
    want = attention.flash_prefill(q, k, v, length, window=window)
    tol = TOL["flash_prefill"]
    err, share = check_close(name, got, want, tol)
    teeth = check_rejects(name, attention.flash_prefill(
        q, k, drop_tile(v, 1, s // 2), length, window=window), want, tol)
    teeth_w = check_rejects(name, attention.flash_prefill(q, k, v, length),
                            want, tol, "the window ignored")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    pos = torch.arange(s, device=dev)
    band = ((pos[None] <= pos[:, None])
            & (pos[:, None] - pos[None] < window))           # [S, S]

    def library():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    try:
        library()
    except RuntimeError as e:     # no kernel of the library takes this call
        log(f"  {name}: no library time (SDPA: {str(e)[:200]})")
        library = None

    pairs = sum(min(t + 1, window) for t in range(s))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())          # q, out, k, v
    row = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 4 * d * hq * pairs),
        **timings(lambda: flash_prefill(q, k, v, length, window=window),
                  lambda: attention.flash_prefill(q, k, v, length,
                                                  window=window),
                  library))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
        f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x, the "
        f"window ignored {teeth_w:.1f}x the limit; {pairs / (s * (s + 1) / 2):.3f}"
        " of the causal pairs")
    return {name: row}


def window_decode_kernels(torch, F, rnd, d: int = 128, hq: int = 32) -> dict:
    """flash_decode with a first row `start` per request, as the windowed
    serve calls it: at the dense layers' shape of its first step (B=2 in a
    16384-row cache, lengths 16001 and 4091, starts 11905 and 0: request 0
    attends its last 4096 rows), bf16 and int8 (row "flash_decode[_int8]
    _d128_window"), and at the sparse layers' hot caches (capacity 384,
    lengths 69 and 72, starts 4 and 2: request 0's four sinks out of the
    window, request 1's first two; bf16, "flash_decode_d128_hot_window").
    Each against its plain version with the same `start`, the bytes and
    the bound counted from each start; the plain version with the start
    ignored and with it one 64-token tile late both rejected; SDPA with
    the range as a mask beside the bf16 rows."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_decode
    from magicpig_tpu_torch.ops.quant import quantize_rows

    b, hkv = 2, 8
    results = {}
    shapes = (("", 16384, [MISTRAL_PROMPTS[0] + 1, MISTRAL_PROMPTS[1] + 1],
               list(MISTRAL_STEP_START)),
              ("_hot", 384, [69, 72], [4, 2]))
    for where, cap, lens, starts in shapes:
        q, k, v = rnd(b, hq, d), rnd(b, hkv, cap, d), rnd(b, hkv, cap, d)
        dev = q.device
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        late = start + 64
        rows = torch.arange(cap, device=dev)[None]
        mask = ((rows >= start[:, None]) & (rows < length[:, None]))[:, None,
                                                                     None]
        q4 = q[:, :, None]
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        forms = [(f"flash_decode_d{d}{where}_window", (k, v, None, None),
                  d * 2, lambda: F.scaled_dot_product_attention(
                      q4, k, v, attn_mask=mask, enable_gqa=True))]
        if not where:
            forms.append((f"flash_decode_int8_d{d}_window", (kq, vq, ks, vs),
                          d + 4, None))
        n_rows = sum(n - lo for n, lo in zip(lens, starts))
        for name, (kk, vv, ksc, vsc), row_bytes, library in forms:
            got, got_lse = flash_decode(q, kk, vv, length, ksc, vsc, start)
            want, want_lse = attention.full_decode(q, kk, vv, length, ksc,
                                                   vsc, start)
            tol = TOL["flash_decode"]
            err, share = check_close(name, got, want, tol)
            err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                                       TOL["lse"])[0])
            ignored = check_rejects(name, attention.full_decode(
                q, kk, vv, length, ksc, vsc)[0], want, tol,
                "the start ignored")
            shifted = check_rejects(name, attention.full_decode(
                q, kk, vv, length, ksc, vsc, late)[0], want, tol,
                "the start one tile late")
            nbytes = (n_rows * hkv * row_bytes * 2 + q.numel() * 2
                      + b * hq * (d + 1) * 4 + 2 * b * 4)
            results[name] = dict(
                max_abs_err=err, tol=tol,
                bound=bound_ms(nbytes, 4 * d * hq * n_rows),
                **timings(lambda: flash_decode(q, kk, vv, length, ksc, vsc,
                                               start),
                          lambda: attention.full_decode(q, kk, vv, length,
                                                        ksc, vsc, start),
                          library))
            log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of "
                f"its limit (tol {tol}); the start ignored {ignored:.1f}x, "
                f"one tile late {shifted:.1f}x the limit; {n_rows} of "
                f"{sum(lens)} rows in range")
    return results


def prefill_offset_kernel(torch, F, rnd, d: int) -> dict:
    """flash_prefill as the last chunk of a chunked prefill calls it: the
    queries of a 256-token span at positions 97744..97999 (q_offset) over
    a 98304-row staged K/V whose first 98000 rows are valid, Hq 32, Hkv 8,
    head dim d; against its plain version, a skipped 64-token V tile (the
    one holding the first query's top key) rejected, SDPA over the valid
    keys with the span's causal mask beside it. Row
    "flash_prefill[_d128]_q_offset"."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_prefill

    hq, hkv, sq = 32, 8, 256
    name = "flash_prefill" + ("" if d == 64 else f"_d{d}") + "_q_offset"
    # Queries scaled by 3 (scores of std 3): each puts most of its weight
    # on ~100 of its 98000 keys (its top key ~5%), so that one skipped tile
    # shows; at std 1 every key weighs ~1/98000 and the output sits under
    # the atol.
    q = rnd(1, sq, hq, d) * 3
    dev = q.device
    k, v = rnd(1, LONG_M, hkv, d), rnd(1, LONG_M, hkv, d)
    length = torch.full((1,), LONG_P, dtype=torch.int32, device=dev)
    off = torch.full((1,), LONG_P - sq, dtype=torch.int32, device=dev)
    got = flash_prefill(q, k, v, length, off)
    want = attention.flash_prefill(q, k, v, length, off)
    tol = TOL["flash_prefill"]
    err, share = check_close(name, got, want, tol)
    top = int((k[0, :LONG_P - sq + 1, 0].float() @ q[0, 0, 0].float()).argmax())
    teeth = check_rejects(name, attention.flash_prefill(
        q, k, drop_tile(v, 1, top // 64 * 64), length, off), want, tol,
        "a skipped 64-token V tile (the first query's top key's)")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x[:, :LONG_P].transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(LONG_P, device=dev)[None]
            <= torch.arange(LONG_P - sq, LONG_P, device=dev)[:, None])
    keys = sum(range(LONG_P - sq + 1, LONG_P + 1))    # (query, key) pairs
    nbytes = 2 * (2 * q.numel() + 2 * LONG_P * hkv * d)   # q, out, k, v
    row = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 4 * d * hq * keys),
        **timings(lambda: flash_prefill(q, k, v, length, off),
                  lambda: attention.flash_prefill(q, k, v, length, off),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
        f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x the "
        "limit")
    return {name: row}


def prefill_kernel(torch, F, rnd, s: int, name: str, d: int = 64) -> dict:
    """flash_prefill over one s-token prompt, causal, Hq 32, Hkv 8, head dim
    d, against its plain version, a skipped V tile rejected, SDPA beside
    it."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_prefill

    hq, hkv = 32, 8
    dev = torch.device("cuda")
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    length = torch.full((1,), s, dtype=torch.int32, device=dev)
    got = flash_prefill(q, k, v, length)
    want = attention.flash_prefill(q, k, v, length)
    tol = TOL["flash_prefill"]
    err, share = check_close(name, got, want, tol)
    teeth = check_rejects(name, attention.flash_prefill(
        q, k, drop_tile(v, 1, s // 2), length), want, tol)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())          # q, out, k, v
    flops = 4 * d * hq * (s * (s + 1) // 2)
    result = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        **timings(lambda: flash_prefill(q, k, v, length),
                  lambda: attention.flash_prefill(q, k, v, length),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True)))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
        f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x the "
        f"limit")
    return {name: result}


def decode_split_sweep(torch, q, k, v, length, k_scale=None,
                       v_scale=None) -> dict:
    """flash_decode's device time (us) for splits of 512, 1024 and 2048
    tokens on the given caches, the split the wrapper picks among them: the
    evidence for `split_tokens`."""
    from magicpig_tpu_torch.ops.kernels import _lib
    from magicpig_tpu_torch.ops.kernels.flash_decode import (launch_name,
                                                             tickets_for)

    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    name = launch_name(k_scale is not None, d, hq // hkv)
    tickets, _ = tickets_for(q.device, b, hq, hkv, d, _lib.HEAD_TILE)
    times = {}
    for chunk in (512, 1024, 2048):
        n = -(-s // chunk)
        f32 = dict(dtype=torch.float32, device=q.device)
        part_o, part_lse = (torch.empty((n, b * hq, d), **f32),
                            torch.empty((n, b * hq), **f32))
        out, lse = torch.empty((b, hq, d), **f32), torch.empty((b, hq), **f32)
        times[chunk] = round(device_ms(lambda: _lib.launch(
            name, "mp_flash_decode", q.device, q, k, v, k_scale, v_scale,
            length, None, part_o, part_lse, tickets, out, lse, b, s, hq, hkv,
            d, chunk, d ** -0.5)) * 1e3, 2)
    log(f"  {name} (Hq {hq}) device us by split tokens: {times}")
    return times


def hot_decode_kernels(torch, F, rnd, d: int = 64, hq: int = 32,
                       tag: str = "") -> dict:
    """flash_decode as the sparse layers' hot caches call it every step: B=2,
    capacity 384, lengths 68 and 69, Hq `hq` over 8 kv heads, bf16 (SDPA
    beside it) and, at d = 64, int8 (no library call takes int8 K/V with
    row scales); each against its plain version, a zeroed first V tile
    rejected. Rows "flash_decode_d128{tag}_hot" at d = 128."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_decode
    from magicpig_tpu_torch.ops.quant import quantize_rows

    b, hkv, s, lens = 2, 8, 384, [68, 69]
    dev = torch.device("cuda")
    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None] < length[:, None])[:, None, None]
    q4 = q[:, :, None]
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    results = {}
    forms = (
            ("flash_decode_hot", (k, v, None, None),
             (k, drop_tile(v, 2, 0), None, None), d * 2,
             lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                   enable_gqa=True)),
            ("flash_decode_int8_hot", (kq, vq, ks, vs),
             (kq, drop_tile(vq, 2, 0), ks, vs), d + 4, None))
    if d != 64:              # bf16 only: "flash_decode_d128_hot"
        forms = ((f"flash_decode_d{d}{tag}_hot", *forms[0][1:]),)
    for name, args, faulty, row_bytes, library in forms:
        kk, vv, ksc, vsc = args
        got, got_lse = flash_decode(q, kk, vv, length, ksc, vsc)
        want, want_lse = attention.full_decode(q, kk, vv, length, ksc, vsc)
        tol = TOL["flash_decode"]
        err, share = check_close(name, got, want, tol)
        err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                                   TOL["lse"])[0])
        fk, fv, fks, fvs = faulty
        teeth = check_rejects(name, attention.full_decode(
            q, fk, fv, length, fks, fvs)[0], want, tol)
        nbytes = (sum(lens) * hkv * row_bytes * 2 + q.numel() * 2
                  + b * hq * (d + 1) * 4)
        results[name] = dict(
            max_abs_err=err, tol=tol,
            bound=bound_ms(nbytes, 4 * d * hq * sum(lens)),
            **timings(lambda: flash_decode(q, kk, vv, length, ksc, vsc),
                      lambda: attention.full_decode(q, kk, vv, length, ksc,
                                                    vsc),
                      library))
        log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
            f"limit (tol {tol}); a zeroed first tile's worst element "
            f"{teeth:.1f}x the limit")
    return results


def plant_collisions(planes, q_bits, b: int, h: int, w: int):
    """A copy of planes in which the 32 keys of word w of request b match
    query head h in tables 0 and 1 (their plane words set to the head's
    bits), so that the head's word w gets every bit set."""
    g = q_bits.shape[1] // planes.shape[1]
    planes = planes.clone()
    planes[b, h // g, :2, :, w] = -q_bits[b, h, :2]   # 1 -> all ones, 0 -> 0
    return planes


def scan_kernel(torch, planes, q_bits, label: str) -> dict:
    """The collision scan against its plain version, bit for bit; planted
    collisions in one word must change the plain result. Bound: every plane
    word read once, q_bits read and the words written once (bitwise
    operations on the CUDA cores, not counted)."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.kernels import collision_words

    got = collision_words(q_bits, planes)
    want = bitcodes.collision_words(q_bits, planes)
    if not torch.equal(got, want):
        raise AssertionError(f"collision_words {label}: differs from the "
                             "plain scan")
    faulty = bitcodes.collision_words(q_bits, plant_collisions(planes, q_bits,
                                                               1, 13, 40))
    if torch.equal(faulty, got):
        raise AssertionError(f"collision_words {label}: equality passes "
                             "planted collisions")
    nbytes = (planes.numel() + q_bits.numel() + got.numel()) * 4
    log(f"kernel collision_words {label} bit-exact; planted collisions "
        f"change {int((faulty != got).sum())} word(s)")
    return dict(max_abs_err=0.0, tol="bit-exact", bound=bound_ms(nbytes, 0),
                **timings(lambda: collision_words(q_bits, planes),
                          lambda: bitcodes.collision_words(q_bits, planes)))


def poison_past_length(planes, q_bits, length):
    """A copy of planes whose bits at or past each request's length (whole
    words, and the tail of the word that holds it) carry the first query
    head of each group's own bits: read, they would make that head collide
    with every key in every table."""
    from magicpig_tpu_torch.ops import bitcodes

    g = q_bits.shape[1] // planes.shape[1]
    keep = bitcodes.valid_words(length, planes.shape[-1])[:, None, None, None]
    return (planes & keep) | (-q_bits[:, ::g, :, :, None] & ~keep)


def scan_length_kernel(torch, planes, q_bits, length, lens) -> dict:
    """The collision scan with lengths, as both serves call it, against its
    plain version bit for bit on planes poisoned past each length (the
    plain scan without the length must see the poison); blocks of 8, 16, 32
    and 64 words timed. Bound: the plane words before each length read
    once, q_bits and the lengths read, every output word written."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.kernels import collision_words
    from magicpig_tpu_torch.ops.kernels.collision_words import launch_scan

    b, hq, L, K = q_bits.shape
    hkv, w = planes.shape[1], planes.shape[-1]
    poisoned = poison_past_length(planes, q_bits, length)
    want = bitcodes.collision_words(q_bits, planes, length)
    if torch.equal(bitcodes.collision_words(q_bits, poisoned), want):
        raise AssertionError("collision_words with lengths: the poison "
                             "collides nowhere")
    for label, p in (("clean", planes), ("poisoned", poisoned)):
        if not torch.equal(collision_words(q_bits, p, length), want):
            raise AssertionError(f"collision_words with lengths ({label} "
                                 "planes): differs from the plain scan")
    del poisoned
    sweep = {bw: round(device_ms(lambda: launch_scan(
        q_bits, planes, length, bw)) * 1e3, 2) for bw in (8, 16, 32, 64)}
    valid = sum((n + 31) // 32 for n in lens)
    nbytes = (valid * hkv * L * K + q_bits.numel() + b * hq * w + b) * 4
    log(f"kernel collision_words with lengths {lens} bit-exact, the poison "
        f"past them unread; device us by block words: {sweep}")
    return dict(max_abs_err=0.0, tol="bit-exact", bound=bound_ms(nbytes, 0),
                **timings(lambda: collision_words(q_bits, planes, length),
                          lambda: bitcodes.collision_words(q_bits, planes,
                                                           length)))


# The masked attend's forms: (int8 K/V, debias).
MASKED_FORMS = tuple((quant, debias) for quant in (False, True)
                     for debias in ("exact", "poly", "none"))


def two_stage_kernels(torch, F, gen, q, k, v, length, lens, planes, q_bits,
                      forms=MASKED_FORMS, tag: str = "", scans: bool = True,
                      sweep=(False,), routes: bool = True):
    """The two-stage LSH route's kernels on the caches of phase 2: with
    `scans`, the collision scan at K=10, L=150 (the sampled serve's; also
    with the lengths) and at K=8, L=75 (the odd-L serve's); the masked
    attend from the words at K=8, L=75 in each of `forms` (bf16 and int8
    K/V, each with the exact, poly and none debias), counts exact, within
    `TOL` of its plain version, a skipped V tile rejected, the none form
    nearer its own plain version than the exact form's, its split sizes
    swept for the exact forms of the K/V types in `sweep`; and, with
    `routes`, the odd-L routes on the same inputs, the scan and the masked
    attend against the fused kernel called directly. Rows named by form
    and head dim, then
    `tag`. The none form's library yardstick is SDPA with the boolean
    sample mask (bf16 only)."""
    from magicpig_tpu_torch.ops import bitcodes
    from magicpig_tpu_torch.ops.kernels import (collision_words, lsh_decode,
                                                lsh_fused_decode,
                                                lsh_masked_attention)
    from magicpig_tpu_torch.ops.kernels.lsh_masked import (
        launch_name, lsh_masked_attention_plain)
    from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows

    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    K, L = 8, 75
    results = {}
    if scans:
        results["collision_words" + tag] = scan_kernel(
            torch, planes, q_bits, f"K=10, L=150, Hq {hq}")
        results["collision_words_length" + tag] = scan_length_kernel(
            torch, planes, q_bits, length, lens)
    proj = torch.randn((d, K * L), generator=gen, device=q.device)
    valid_words = sum((n + 31) // 32 for n in lens)
    tol = TOL["lsh_fused_decode"]
    for quant in sorted({quant for quant, _ in forms}):
        kk, vv, ks, vs, kd = k, v, None, None, k.float()
        if quant:
            kk, ks = quantize_rows(k)
            vv, vs = quantize_rows(v)
            kd = dequantize_rows(kk, ks, torch.float32)
        k_norm = kd.norm(dim=-1)
        planes75 = torch.stack([bitcodes.build_planes(kd[i].transpose(0, 1),
                                                      proj, K)
                                for i in range(b)])
        del kd
        qb = bitcodes.hash_bits(q, proj, K)
        if scans and not quant:
            results["collision_words_l75" + tag] = scan_kernel(
                torch, planes75, qb, f"K=8, L=75, Hq {hq}")
        words = collision_words(qb, planes75, length)
        mask = bitcodes.unpack_words(words, s)                 # [B, Hq, S]
        rows = int(mask.reshape(b, hkv, -1, s).any(dim=2).sum())
        row_bytes = 2 * d * 2 + 4 if not quant else 2 * d + 8 + 4
        exact = None
        for debias in (debias for fq, debias in forms if fq == quant):
            form = launch_name(quant, debias, d)      # its launch counter
            name = form + tag
            args = (q, kk, vv, k_norm, words, length, K, L, ks, vs, debias)
            got, got_lse, got_cnt = lsh_masked_attention(*args)
            want, want_lse, want_cnt = lsh_masked_attention_plain(*args)
            if not torch.equal(got_cnt, want_cnt):
                raise AssertionError(f"{name}: sampled counts differ")
            err, share = check_close(name, got, want, tol)
            err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                                       TOL["lse"])[0])
            teeth = check_rejects(name, lsh_masked_attention_plain(
                q, kk, drop_tile(vv, 2, 8192), k_norm, words, length, K, L,
                ks, vs, debias)[0], want, tol)
            moved = 0.0
            if debias == "exact":
                exact = got
            elif exact is not None:
                # At K=8, L=75 the polynomial lies closer to the exact
                # weight than the plain version's bf16 rounding, so only
                # the none form is told apart here; phase 4's poly cut
                # (K=1, L=31, where the fit is off by units) tells poly.
                moved = float((got - exact).abs().max())
                if debias == "none" and not err < moved:
                    raise AssertionError(f"{name}: nearer the exact form "
                                         f"({moved:.2e}) than its own "
                                         f"({err:.2e})")
            nbytes = (valid_words * hq * 4 + rows * (row_bytes - (
                4 if debias == "none" else 0)) + q.numel() * 2
                + b * hq * (d + 2) * 4)
            library = None
            if debias == "none" and not quant:
                q4, m4 = q[:, :, None], mask[:, :, None]
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, kk, vv, attn_mask=m4, enable_gqa=True)
            results[name] = dict(
                max_abs_err=err, tol=tol,
                bound=bound_ms(nbytes, 4 * d * int(want_cnt.sum())),
                **timings(lambda: lsh_masked_attention(*args),
                          lambda: lsh_masked_attention_plain(*args), library),
                sampled_frac=float(want_cnt.sum()) / (hq * sum(lens)),
                rows_frac=rows / (hkv * sum(lens)))
            log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of "
                f"its limit (tol {tol}); a skipped tile's worst element "
                f"{teeth:.1f}x the limit; counts exact, sampled "
                f"{results[name]['sampled_frac']:.4f}"
                + (f"; {moved:.2e} from the exact form" if moved else ""))
            if debias == "exact" and quant in sweep:
                lsh_split_sweep(torch, form, "mp_lsh_masked_attention", args,
                                (words,))
        if not quant and routes:
            # The odd-L routes on the same inputs: lsh_decode's two stages
            # against the fused kernel called directly.
            args = (q, kk, vv, k_norm, planes75, qb, length, K, L)
            two, fused = lsh_decode(*args), lsh_fused_decode(*args)
            if not torch.equal(two[2], fused[2]):
                raise AssertionError("odd-L routes: sampled counts differ")
            err = check_close("odd-L routes", two[0], fused[0], tol)[0]
            same = all(torch.equal(a, c) for a, c in zip(two, fused))
            route = {"two-stage": dict(ms=cuda_ms(lambda: lsh_decode(*args)),
                                       device_ms=device_ms(
                                           lambda: lsh_decode(*args))),
                     "fused": dict(ms=cuda_ms(lambda: lsh_fused_decode(*args)),
                                   device_ms=device_ms(
                                       lambda: lsh_fused_decode(*args)))}
            log(f"routes K=8, L=75, bf16 exact, Hq {hq}, d {d}: two-stage "
                f"{route['two-stage']}"
                f", fused {route['fused']}; outputs "
                f"{'equal' if same else f'within tol (err {err:.2e})'}")
        del planes75, words, mask
    return results


def int8_decode_kernels(torch, q, k, v, length, lens, proj, K, L,
                        tag: str = "", debias_forms: bool = True,
                        sweeps: bool = True):
    """The int8 forms of flash decode and the fused LSH decode, on the same
    caches quantized per row (for LSH as centered keys whose norms and
    signatures are those of the dequantized rows, as the fill stores
    them), rows named with `tag` after the head dim; with `debias_forms`
    also the poly and none forms of the LSH kernel; with `proj` None the
    decode alone; with `sweeps` their split sizes timed. No PyTorch call
    takes int8 K/V with row scales: no library time."""
    from magicpig_tpu_torch.ops import attention, bitcodes
    from magicpig_tpu_torch.ops.kernels import flash_decode, lsh_fused_decode
    from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain
    from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows

    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    results = {}
    sfx = "" if d == 64 else f"_d{d}"

    # -- flash decode over int8 K/V.
    name = "flash_decode_int8" + sfx + tag
    got, got_lse = flash_decode(q, kq, vq, length, ks, vs)
    want, want_lse = attention.full_decode(q, kq, vq, length, ks, vs)
    tol = TOL["flash_decode"]
    err, share = check_close(name, got, want, tol)
    err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects(name, attention.full_decode(
        q, kq, drop_tile(vq, 2, 8192), length, ks, vs)[0], want, tol)
    nbytes = (sum(lens) * hkv * (d * 2 + 8) + q.numel() * 2
              + b * hq * (d + 1) * 4)
    results[name] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 4 * d * hq * sum(lens)),
        **timings(lambda: flash_decode(q, kq, vq, length, ks, vs),
                  lambda: attention.full_decode(q, kq, vq, length, ks, vs)))
    log(f"kernel {name} err {err:.2e}, worst element "
        f"{share:.2f} of its limit (tol {tol}); a skipped tile's worst "
        f"element {teeth:.1f}x the limit")
    if sweeps:
        decode_split_sweep(torch, q, kq, vq, length, ks, vs)
    if proj is None:
        return results

    # -- fused LSH decode over int8 centered keys and values.
    kd = dequantize_rows(kq, ks, torch.float32)
    k_norm = kd.norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(kd[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    del kd
    q_bits = bitcodes.hash_bits(q, proj, K)
    args = (q, kq, vq, k_norm, planes, q_bits, length, K, L, ks, vs)
    form = "lsh_fused_decode_int8" + sfx          # its launch counter
    name = form + tag
    got, got_lse, got_cnt = lsh_fused_decode(*args)
    want, want_lse, want_cnt = lsh_fused_decode_plain(*args)
    if not torch.equal(got_cnt, want_cnt):
        raise AssertionError(f"{name}: sampled counts differ")
    tol = TOL["lsh_fused_decode"]
    err, share = check_close(name, got, want, tol)
    err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects(name, lsh_fused_decode_plain(
        q, kq, drop_tile(vq, 2, 8192), k_norm, planes, q_bits, length, K, L,
        ks, vs)[0], want, tol)
    sampled = bitcodes.sampled_mask(q_bits, planes, length)    # [B, Hq, S]
    rows = int(sampled.reshape(b, hkv, -1, s).any(dim=2).sum())
    words = sum((n + 31) // 32 for n in lens) * hkv * L * K
    nbytes = (words * 4 + rows * (2 * d + 8 + 4) + q.numel() * 2
              + q_bits.numel() * 4 + b * hq * (d + 2) * 4)
    results[name] = dict(
        max_abs_err=err, tol=tol,
        bound=bound_ms(nbytes, 4 * d * int(want_cnt.sum())),
        **timings(lambda: lsh_fused_decode(*args),
                  lambda: lsh_fused_decode_plain(*args)),
        sampled_frac=float(want_cnt.sum()) / (hq * sum(lens)),
        rows_frac=rows / (hkv * sum(lens)))
    log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of "
        f"its limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x "
        f"the limit; counts exact, sampled "
        f"{results[name]['sampled_frac']:.4f}, rows read "
        f"{results[name]['rows_frac']:.4f}")
    if d != 64 and sweeps:   # int8 rows at d = 128: bf16's shared memory at 64
        lsh_split_sweep(torch, form, "mp_lsh_fused_decode",
                        (q, kq, vq, k_norm, None, length, K, L, ks, vs,
                         "exact"), (planes, q_bits))
    if debias_forms:
        results.update(lsh_debias_forms(torch, args, nbytes, rows,
                                        4 * d * int(want_cnt.sum()), tag))
    return results


def lsh_debias_forms(torch, args, nbytes, rows, flops, tag: str = ""):
    """The poly and none debias forms of the fused LSH kernel on the inputs
    of its exact form (`args`, scales None for bf16): counts exact, within
    `TOL` of the plain version, a skipped V tile rejected, and bound by the
    exact form's bytes (the none form reads no key norm). Each must move
    the output away from the exact form's. Rows named by form and head
    dim, then `tag`."""
    from magicpig_tpu_torch.ops.kernels import lsh_fused_decode
    from magicpig_tpu_torch.ops.kernels.lsh_fused import (
        launch_name, lsh_fused_decode_plain)

    q, k, v, k_norm, planes, q_bits, length, K, L, ks, vs = args
    exact = lsh_fused_decode_plain(*args)[0]
    tol, results = TOL["lsh_fused_decode"], {}
    for debias in ("poly", "none"):
        name = launch_name(ks is not None, debias, q.shape[-1]) + tag
        full = (*args, debias)
        got, got_lse, got_cnt = lsh_fused_decode(*full)
        want, want_lse, want_cnt = lsh_fused_decode_plain(*full)
        if not torch.equal(got_cnt, want_cnt):
            raise AssertionError(f"{name}: sampled counts differ")
        err, share = check_close(name, got, want, tol)
        err = max(err, check_close(f"{name} lse", got_lse, want_lse,
                                   TOL["lse"])[0])
        teeth = check_rejects(name, lsh_fused_decode_plain(
            q, k, drop_tile(v, 2, 8192), k_norm, planes, q_bits, length, K, L,
            ks, vs, debias)[0], want, tol)
        # The kernel computed this form, not the exact one: it lies nearer
        # the plain version of its own form than the exact form's.
        moved = float((got - exact).abs().max())
        if not err < moved:
            raise AssertionError(f"{name}: nearer the exact form ({moved:.2e})"
                                 f" than its own ({err:.2e})")
        results[name] = dict(
            max_abs_err=err, tol=tol,
            bound=bound_ms(nbytes - (4 * rows if debias == "none" else 0),
                           flops),
            **timings(lambda: lsh_fused_decode(*full),
                      lambda: lsh_fused_decode_plain(*full)))
        log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
            f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x "
            f"the limit; counts exact; {moved:.2e} from the exact form")
    return results


# The int4 products of a decode step of the 1B with fused weights
# (`bench.py`'s full_int8 mode with int4 weights), as (kernels-line name,
# kin, out): q|k|v, o, gate|up, down, and the lm_head, whose numbers stay
# in the line's `w4_matmul` entry.
W4_SHAPES = (("w4_matmul_wqkv", 2048, 3072), ("w4_matmul_wo", 2048, 2048),
             ("w4_matmul_gateup", 2048, 16384),
             ("w4_matmul_wdown", 8192, 2048), ("w4_matmul", 2048, 128256))
# The same products of Llama-3.1-8B (hidden 4096, 32/8 heads of 128,
# intermediate 14336, the untied lm_head).
W4_SHAPES_8B = (("w4_matmul_8b_wqkv", 4096, 6144),
                ("w4_matmul_8b_wo", 4096, 4096),
                ("w4_matmul_8b_gateup", 4096, 28672),
                ("w4_matmul_8b_wdown", 14336, 4096),
                ("w4_matmul_8b_lm_head", 4096, 128256))
# The 1B's unfused products at a model rank's shapes at 2 model ranks (the
# sharded phase's int4 runs, M = 1 a rank): q, k and v (and gate, up) at
# half their columns, o and down at half their input rows, the lm_head at
# half the vocabulary.
W4_SHAPES_TP = (("w4_matmul_tp_wq", 2048, 1024), ("w4_matmul_tp_wkv", 2048, 256),
                ("w4_matmul_tp_wo", 1024, 2048),
                ("w4_matmul_tp_gateup", 2048, 4096),
                ("w4_matmul_tp_wdown", 4096, 2048),
                ("w4_matmul_tp_lm_head", 2048, 64128))


def phase_w4_kernel(torch, dev, shapes=W4_SHAPES, m: int = 2):
    """The packed-nibble int4 matmul against its plain version at M=m (a
    decode step's rows: B=2, or a model rank's one) on each product a
    decode step runs (`W4_SHAPES`, the 8B's `W4_SHAPES_8B`, or a model
    rank's `W4_SHAPES_TP`), weights N(0, 1/kin) quantized on the card, each
    with a zeroed weight group rejected. The library yardstick is a bf16
    torch.matmul over the dequantized weight (no int4 PyTorch call takes
    this packing)."""
    from magicpig_tpu_torch.models.llama import quantize_weight4
    from magicpig_tpu_torch.ops.kernels import w4_matmul
    from magicpig_tpu_torch.ops.kernels.w4_matmul import (unpack_weight4,
                                                         w4_matmul_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    tol = TOL["w4_matmul"]
    results = {}
    for name, kin, out in shapes:
        x = torch.randn((m, kin), generator=gen, device=dev, dtype=torch.bfloat16)
        w = quantize_weight4(torch.randn((kin, out), generator=gen, device=dev,
                                         dtype=torch.bfloat16).mul_(kin ** -0.5))
        got = w4_matmul(x, w.q, w.scale)
        want = w4_matmul_plain(x, w.q, w.scale)
        err, share = check_close(name, got, want, tol)
        faulty = w.q.clone()
        tile = min(5, out // 256 - 1)          # group 3 of tile 5 (or the last)
        faulty[3 * 64:4 * 64, tile * 256:(tile + 1) * 256] = 0
        teeth = check_rejects(name, w4_matmul_plain(x, faulty, w.scale), want,
                              tol, "a skipped 128-input group of one output "
                              "tile")
        del faulty
        wde = (unpack_weight4(w.q).float().reshape(kin // 128, 128, out)
               * w.scale[:, None, :]).reshape(kin, out).to(torch.bfloat16)
        nbytes = w.q.numel() + w.scale.numel() * 4 + x.numel() * 2 + m * out * 4
        results[name] = dict(
            max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * m * kin * out),
            **timings(lambda: w4_matmul(x, w.q, w.scale),
                      lambda: w4_matmul_plain(x, w.q, w.scale),
                      lambda: torch.matmul(x, wde)),
            device_ms_cold=w4_cold_ms(torch, x, w, w4_matmul))
        log(f"kernel {name} [{kin}, {out}] err {err:.2e}, worst element "
            f"{share:.2f} of its limit (tol {tol}); a skipped group's worst "
            f"element {teeth:.1f}x the limit; device us with the weight "
            f"out of L2 {results[name]['device_ms_cold'] * 1e3:.2f}")
        w4_split_sweep(name, x, w)
        del wde, w
    log_timings(results)
    return results


def w4_cold_ms(torch, x, w, w4_matmul) -> float:
    """Device ms of the int4 matmul on a weight that is not in the 50 MB
    L2, as each layer of a serve finds its own: the calls cycle through
    copies of the weight, 96 MB or more in all."""
    import itertools

    copies = max(1, min(32, -(-(96 << 20) // w.q.numel())))
    weights = [(w.q, w.scale)] + [(w.q.clone(), w.scale.clone())
                                  for _ in range(copies - 1)]
    turn = itertools.cycle(weights)
    ms = device_ms(lambda: w4_matmul(x, *next(turn)))
    del weights
    return ms


def log_timings(results) -> None:
    for name, r in results.items():
        lib = ("-" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f})")
        log(f"  {name}: ms per call (device ms): kernel {r['ms']:.4f} "
            f"({r['device_ms']:.4f})  plain {r['plain_ms']:.4f}  library "
            f"{lib}  bound "
            f"{r['bound'][0] * 1e3:.1f} us ({r['bound'][1]})")


def phase_block_kernels(torch, dev, d: int = 64, hq: int = 32,
                        tag: str = "", hkv: int = 8, sweeps: bool = True,
                        packed: bool = True):
    """The block_topk kernels against their plain versions: B=2 over a
    65536-token offload (lengths 65536 and 40000), 512-token blocks, 11
    selected (the default 8% budget of 128 blocks), Hq `hq` (32), Hkv
    `hkv` (8), head dim d (rows named "..._d<d>" at d other than 64, then
    `tag`); the scorer and the rescore on int8 K/V, the store pipeline's
    scorer and attend on bf16, with `packed` the packed int4 forms, with
    `sweeps` the attends' chunks timed (the general tile: the rescore's
    tokens a CUDA block at the serve's selected count, `attend_split_sweep`);
    at d = 64 also the scores-only form. From 16 heads a kv head the
    16-head tile's planted fault (`head_tile_faults`) fails the scorer's
    and both attends' tolerances."""
    from magicpig_tpu_torch.ops.kernels import (_lib, block_attend,
                                                block_rank,
                                                exact_scores_ranked,
                                                rescore_attend)
    from magicpig_tpu_torch.ops.kernels.block_attend import (
        block_attend_plain, launch_block_attend)
    from magicpig_tpu_torch.ops.kernels.block_score import (block_scores_plain,
                                                            scaled_query)
    from magicpig_tpu_torch.ops.kernels.rescore_attend import (
        launch_rescore_attend, rescore_attend_plain)
    from magicpig_tpu_torch.ops.quant import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    b, s, bs, n_sel = 2, 65536, 512, 11
    sfx = ("" if d == 64 else f"_d{d}") + tag
    g = hq // hkv
    tile = not _lib.exact_group(g, d)
    lens = [65536, 40000]
    q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev, dtype=torch.bfloat16)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    valid = sum(lens) * hkv                    # valid (token, kv head) rows
    qs = scaled_query(q, hkv).to(torch.bfloat16)
    kt = k.transpose(-1, -2)

    def library():
        return torch.matmul(qs, kt)            # scores only, no block max

    def same_top(name, got_max, want_max):
        got = torch.topk(got_max, n_sel).indices.sort(dim=-1).values
        want = torch.topk(want_max, n_sel).indices.sort(dim=-1).values
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: top-{n_sel} block ids differ from "
                                 "the plain version's")

    def selected_tokens(ids):
        """Valid tokens in the selected blocks, over requests and kv heads."""
        start = ids.long() * bs
        return int((length.long()[:, None, None] - start).clamp(0, bs).sum())

    results = {}
    tol, lse_tol = TOL["block_scores"], TOL["lse"]

    # -- block_rank: int8 K, block maxes only.
    got = block_rank(q, kq, ks, length, bs)
    want = block_scores_plain(q, kq, ks, length, bs)[1]
    err, share = check_close("block_rank" + sfx, got, want, tol)
    same_top("block_rank" + sfx, got, want)
    teeth = check_rejects("block_rank" + sfx, block_scores_plain(
        q, drop_tile(kq, 2, 7 * bs, bs), ks, length, bs)[1], want, tol,
        "a skipped ranking block of K")
    nbytes = valid * (d + 4) + q.numel() * 2 + got.numel() * 4
    results["block_rank" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * d * g * valid),
        **timings(lambda: block_rank(q, kq, ks, length, bs),
                  lambda: block_scores_plain(q, kq, ks, length, bs), library))
    log(f"kernel block_rank{sfx}     err {err:.2e}, worst element {share:.2f} of "
        f"its limit (tol {tol}); a skipped ranking block's worst element "
        f"{teeth:.1f}x the limit; top-{n_sel} ids equal")

    # -- exact_scores_ranked: bf16 K, scores and block maxes.
    got_s, got_m = exact_scores_ranked(q, k, None, length, bs)
    want_s, want_m = block_scores_plain(q, k, None, length, bs)
    err, share = check_close("exact_scores_ranked" + sfx, got_s, want_s, tol)
    err2, share2 = check_close("exact_scores_ranked" + sfx + " max", got_m, want_m, tol)
    err, share = max(err, err2), max(share, share2)
    same_top("exact_scores_ranked" + sfx, got_m, want_m)
    teeth = check_rejects("exact_scores_ranked" + sfx, block_scores_plain(
        q, drop_tile(k, 2, 4096), None, length, bs)[0], want_s, tol,
        "a skipped 64-token K tile")
    nbytes = (valid * d * 2 + q.numel() * 2 + got_s.numel() * 4
              + got_m.numel() * 4)
    results["exact_scores_ranked" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * d * g * valid),
        **timings(lambda: exact_scores_ranked(q, k, None, length, bs),
                  lambda: block_scores_plain(q, k, None, length, bs), library))
    log(f"kernel exact_scores_ranked{sfx} err {err:.2e}, worst element {share:.2f} of "
        f"its limit (tol {tol}); a skipped K tile's worst element "
        f"{teeth:.1f}x the limit; top-{n_sel} ids equal")
    reject_head_faults("exact_scores_ranked" + sfx, want_s.flatten(1, 2), hq,
                       hkv, tol)
    del want_s
    if sfx == "" and hq == 32:     # no path calls the scores-only form
        results.update(exact_scores_kernel(torch, q, k, kq, ks, bs, library))
    del library

    # -- rescore_attend: int8 K and V, the blocks block_rank picked.
    ids = torch.topk(block_rank(q, kq, ks, length, bs), n_sel).indices.to(torch.int32)
    got, got_lse = rescore_attend(q, ids, kq, ks, vq, vs, length, bs)
    want, want_lse = rescore_attend_plain(q, ids, kq, ks, vq, vs, length, bs)
    tol = TOL["block_attend"]
    err, share = check_close("rescore_attend" + sfx, got, want, tol)
    err = max(err, check_close("rescore_attend" + sfx + " lse", got_lse, want_lse,
                               lse_tol)[0])
    first = int(ids[0, 0, 0]) * bs
    teeth = check_rejects("rescore_attend" + sfx, rescore_attend_plain(
        q, ids, kq, ks, drop_tile(vq, 2, first), vs, length, bs)[0], want, tol)
    tokens = selected_tokens(ids)
    nbytes = (tokens * (2 * d + 8) + ids.numel() * 4 + q.numel() * 2
              + b * hq * (d + 1) * 4)
    results["rescore_attend" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 4 * d * g * tokens),
        **timings(lambda: rescore_attend(q, ids, kq, ks, vq, vs, length, bs),
                  lambda: rescore_attend_plain(q, ids, kq, ks, vq, vs,
                                               length, bs)),
        selected_tokens=tokens)
    log(f"kernel rescore_attend{sfx} err {err:.2e}, worst element {share:.2f} of "
        f"its limit (tol {tol}); a skipped tile's worst element "
        f"{teeth:.1f}x the limit; {tokens} valid selected rows")
    reject_head_faults("rescore_attend" + sfx, want, hq, hkv, tol)
    if sweeps and tile:
        n_served = serve_selected(TILE_SWEEP_LEN[(d, hq, hkv)])
        served = ids[:, :, :n_served].contiguous()
        attend_split_sweep(torch, "rescore_attend" + sfx,
                           lambda c: launch_rescore_attend(
                               q, served, kq, ks, vq, vs, length, bs, c),
                           served.shape[2] * bs)
    elif sweeps:
        attend_chunk_sweep("rescore_attend" + sfx,
                           lambda c: launch_rescore_attend(
                               q, ids, kq, ks, vq, vs, length, bs, c))

    # -- block_attend: bf16 V, the stored scores of the bf16 scorer.
    ids = torch.topk(got_m, n_sel).indices.to(torch.int32)
    got, got_lse = block_attend(got_s, ids, v, None, bs)
    want, want_lse = block_attend_plain(got_s, ids, v, None, bs)
    err, share = check_close("block_attend" + sfx, got, want, tol)
    err = max(err, check_close("block_attend" + sfx + " lse", got_lse, want_lse,
                               lse_tol)[0])
    first = int(ids[0, 0, 0]) * bs
    teeth = check_rejects("block_attend" + sfx, block_attend_plain(
        got_s, ids, drop_tile(v, 2, first), None, bs)[0], want, tol)
    tokens = selected_tokens(ids)
    nbytes = (ids.numel() * bs * g * 4 + tokens * d * 2 + ids.numel() * 4
              + b * hq * (d + 1) * 4)
    results["block_attend" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * d * g * tokens),
        **timings(lambda: block_attend(got_s, ids, v, None, bs),
                  lambda: block_attend_plain(got_s, ids, v, None, bs)),
        selected_tokens=tokens)
    log(f"kernel block_attend{sfx}   err {err:.2e}, worst element {share:.2f} of "
        f"its limit (tol {tol}); a skipped tile's worst element "
        f"{teeth:.1f}x the limit; {tokens} valid selected rows")
    reject_head_faults("block_attend" + sfx, want, hq, hkv, tol)
    if sweeps and not tile:
        attend_chunk_sweep("block_attend" + sfx, lambda c: launch_block_attend(
            got_s, ids, v, None, bs, c))
    del got_s, got_m
    if packed:
        results.update(packed_block_kernels(torch, q, k, vq, vs, length, bs,
                                            n_sel, same_top, selected_tokens,
                                            sfx, sweeps and not tile))
    log_timings(results)
    return results


def exact_scores_kernel(torch, q, k, kq, ks, bs, library) -> dict:
    """The scorer's scores-only form (`exact_scores`: every token, no
    length mask, no block max) over the block phase's bf16 and int8 K,
    within `TOL` of its plain version, a zeroed ranking block of K
    rejected. No path runs it; the kernels line keeps the bf16 numbers, the
    int8 form is logged. Bound: K (and its scales) read once, the scores
    written once."""
    from magicpig_tpu_torch.ops.kernels import exact_scores
    from magicpig_tpu_torch.ops.kernels.block_score import exact_scores_plain

    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    tol, results = TOL["block_scores"], {}
    for label, kk, kks in (("bf16", k, None), ("int8", kq, ks)):
        got = exact_scores(q, kk, kks)
        want = exact_scores_plain(q, kk, kks)
        err, share = check_close(f"exact_scores {label}", got, want, tol)
        teeth = check_rejects(f"exact_scores {label}", exact_scores_plain(
            q, drop_tile(kk, 2, 7 * bs, bs), kks), want, tol,
            "a skipped ranking block of K")
        row = d * kk.element_size() + (4 if kks is not None else 0)
        nbytes = b * hkv * s * row + q.numel() * 2 + got.numel() * 4
        r = dict(max_abs_err=err, tol=tol,
                 bound=bound_ms(nbytes, 2 * d * hq * s * b),
                 **timings(lambda: exact_scores(q, kk, kks),
                           lambda: exact_scores_plain(q, kk, kks), library))
        log(f"kernel exact_scores {label} (scores only, unmasked) err "
            f"{err:.2e}, worst element {share:.2f} of its limit (tol {tol}); "
            f"a skipped ranking block's worst element {teeth:.1f}x the limit")
        if label == "bf16":
            results["exact_scores"] = r
        else:
            log_timings({"exact_scores int8": r})
        del got, want
    return results


def packed_block_kernels(torch, q, k, vq, vs, length, bs, n_sel, same_top,
                         selected_tokens, sfx: str = "", sweeps: bool = True):
    """The packed int4 forms of the block scorer and rescore-attend on the
    same keys put on the 4-bit grid: each within `TOL` of its plain version,
    bit for bit the int8 kernel's numbers on the unpacked rows, and a
    planted fault rejected (one ranking block of packed K zeroed; for the
    rescore also one 64-token V tile). The scorer's library yardstick is the
    bf16 matmul of the int8 rows. Rows named with `sfx` ("_d128" at head dim
    128); with `sweeps` the rescore's chunks timed."""
    from magicpig_tpu_torch.ops.kernels import (block_rank, exact_scores_ranked,
                                                rescore_attend)
    from magicpig_tpu_torch.ops.kernels.block_score import (block_scores_plain,
                                                            scaled_query)
    from magicpig_tpu_torch.ops.kernels.rescore_attend import (
        launch_rescore_attend, rescore_attend_plain)
    from magicpig_tpu_torch.ops.pack4 import pack_k4
    from magicpig_tpu_torch.ops.quant import quantize_rows

    b, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    k4, ks = quantize_rows(k, bits=4)
    kp = pack_k4(k4)
    valid = int(length.sum()) * hkv
    qs, kt = scaled_query(q, hkv).to(torch.bfloat16), k.transpose(-1, -2)
    tol, results = TOL["block_scores"], {}

    def library():
        return torch.matmul(qs, kt)

    def bit_equal(name, got, want):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: differs from the int8 kernel on the "
                                 "unpacked rows")

    def k_block_zeroed(blk):
        return drop_tile(kp, 2, blk * bs, bs)

    # -- block_rank over packed K.
    got = block_rank(q, kp, ks, length, bs)
    want = block_scores_plain(q, kp, ks, length, bs)[1]
    err, share = check_close("block_rank_int4" + sfx, got, want, tol)
    bit_equal("block_rank_int4" + sfx, [got], [block_rank(q, k4, ks, length, bs)])
    same_top("block_rank_int4" + sfx, got, want)
    teeth = check_rejects("block_rank_int4" + sfx, block_scores_plain(
        q, k_block_zeroed(5), ks, length, bs)[1], want, tol,
        "a skipped ranking block of packed K")
    nbytes = valid * (d // 2 + 4) + q.numel() * 2 + got.numel() * 4
    results["block_rank_int4" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * d * g * valid),
        **timings(lambda: block_rank(q, kp, ks, length, bs),
                  lambda: block_scores_plain(q, kp, ks, length, bs), library))
    log(f"kernel block_rank_int4{sfx} err {err:.2e}, worst element {share:.2f} "
        f"of its limit (tol {tol}); equal to the int8 kernel's bit for bit; "
        f"a skipped ranking block's worst element {teeth:.1f}x the limit; "
        f"top-{n_sel} ids equal")

    # -- exact_scores_ranked over packed K.
    got_s, got_m = exact_scores_ranked(q, kp, ks, length, bs)
    want_s, want_m = block_scores_plain(q, kp, ks, length, bs)
    err, share = check_close("exact_scores_ranked_int4" + sfx, got_s, want_s, tol)
    err2, share2 = check_close("exact_scores_ranked_int4" + sfx + " max", got_m, want_m,
                               tol)
    err, share = max(err, err2), max(share, share2)
    bit_equal("exact_scores_ranked_int4" + sfx, [got_s, got_m],
              exact_scores_ranked(q, k4, ks, length, bs))
    same_top("exact_scores_ranked_int4" + sfx, got_m, want_m)
    teeth = check_rejects("exact_scores_ranked_int4" + sfx, block_scores_plain(
        q, k_block_zeroed(6), ks, length, bs)[0], want_s, tol,
        "a skipped ranking block of packed K")
    nbytes = (valid * (d // 2 + 4) + q.numel() * 2 + got_s.numel() * 4
              + got_m.numel() * 4)
    results["exact_scores_ranked_int4" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 2 * d * g * valid),
        **timings(lambda: exact_scores_ranked(q, kp, ks, length, bs),
                  lambda: block_scores_plain(q, kp, ks, length, bs), library))
    log(f"kernel exact_scores_ranked_int4{sfx} err {err:.2e}, worst element {share:.2f} "
        f"of its limit (tol {tol}); equal to the int8 kernel's bit for bit; "
        f"a skipped ranking block's worst element {teeth:.1f}x the limit; "
        f"top-{n_sel} ids equal")
    del got_s, want_s, library

    # -- rescore_attend over packed K and int8 V, the blocks ranked first.
    ids = torch.topk(got_m, n_sel).indices.to(torch.int32)
    args = (q, ids, kp, ks, vq, vs, length, bs)
    got, got_lse = rescore_attend(*args)
    want, want_lse = rescore_attend_plain(*args)
    tol = TOL["block_attend"]
    err, share = check_close("rescore_attend_int4" + sfx, got, want, tol)
    err = max(err, check_close("rescore_attend_int4" + sfx + " lse", got_lse, want_lse,
                               TOL["lse"])[0])
    bit_equal("rescore_attend_int4" + sfx, [got, got_lse],
              rescore_attend(q, ids, k4, ks, vq, vs, length, bs))
    first = int(ids[0, 0, 0])
    teeth = check_rejects("rescore_attend_int4" + sfx, rescore_attend_plain(
        q, ids, kp, ks, drop_tile(vq, 2, first * bs), vs, length, bs)[0],
        want, tol)
    teeth_k = check_rejects("rescore_attend_int4" + sfx, rescore_attend_plain(
        q, ids, k_block_zeroed(first), ks, vq, vs, length, bs)[0], want, tol,
        "a skipped ranking block of packed K")
    tokens = selected_tokens(ids)
    nbytes = (tokens * (d // 2 + 4 + d + 4) + ids.numel() * 4
              + q.numel() * 2 + b * hq * (d + 1) * 4)
    results["rescore_attend_int4" + sfx] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, 4 * d * g * tokens),
        **timings(lambda: rescore_attend(*args),
                  lambda: rescore_attend_plain(*args)),
        selected_tokens=tokens)
    log(f"kernel rescore_attend_int4{sfx} err {err:.2e}, worst element "
        f"{share:.2f} of its limit (tol {tol}); equal to the int8 kernel's "
        f"bit for bit; a skipped V tile's worst element {teeth:.1f}x and a "
        f"skipped K block's {teeth_k:.1f}x the limit; {tokens} valid "
        "selected rows")
    if sweeps:
        attend_chunk_sweep("rescore_attend_int4" + sfx,
                           lambda c: launch_rescore_attend(*args, c))
    return results


def serve_attend_kernels(torch, dev, d: int = 64, hq: int = 32,
                         tag: str = "") -> dict:
    """The rescore-attend (int8 K, packed int4 K) and the block-attend (bf16
    V, stored scores) at the block_topk serves' own shape, rows "_serve":
    B=2 over a 16384-token offload holding the phase-3 prompts' offload
    lengths (11932 and 6932), 512-token blocks, the 3 of 32 that each
    scorer ranks first (48 selected blocks of work against the phase-2
    shape's 176), Hq `hq` (32), Hkv 8, head dim d (rows "..._d128_serve" at
    128, `tag` before "_serve"). Each within `TOL` of its plain version, a
    skipped V tile rejected."""
    from magicpig_tpu_torch.ops.kernels import (block_attend, block_rank,
                                                exact_scores_ranked,
                                                rescore_attend)
    from magicpig_tpu_torch.ops.kernels.block_attend import (
        block_attend_plain, launch_block_attend)
    from magicpig_tpu_torch.ops.kernels.rescore_attend import (
        launch_rescore_attend, rescore_attend_plain)
    from magicpig_tpu_torch.ops.pack4 import pack_k4
    from magicpig_tpu_torch.ops.quant import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    b, hkv, s, bs, n_sel = 2, 8, 16384, 512, 3
    sfx = ("" if d == 64 else f"_d{d}") + tag
    g = hq // hkv
    length = torch.tensor([11932, 6932], dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    k4, ks4 = quantize_rows(k, bits=4)
    kp = pack_k4(k4)
    scores, bmax = exact_scores_ranked(q, k, None, length, bs)
    tol, out_bytes = TOL["block_attend"], b * hq * (d + 1) * 4

    def top(block_max):
        return torch.topk(block_max, n_sel).indices.to(torch.int32)

    def tokens_of(ids):
        start = ids.long() * bs
        return int((length.long()[:, None, None] - start).clamp(0, bs).sum())

    ids8, ids4, ids16 = (top(block_rank(q, kq, ks, length, bs)),
                         top(block_rank(q, kp, ks4, length, bs)), top(bmax))
    cases = {
        # name: (kernel of V, its launcher at a chunk, plain version of V,
        # V, selected ids, bytes each valid selected token reads, scores
        # stored)
        f"rescore_attend{sfx}_serve": (
            lambda vv: rescore_attend(q, ids8, kq, ks, vv, vs, length, bs),
            lambda c: launch_rescore_attend(q, ids8, kq, ks, vq, vs, length,
                                            bs, c),
            lambda vv: rescore_attend_plain(q, ids8, kq, ks, vv, vs, length,
                                            bs), vq, ids8, 2 * d + 8, False),
        f"rescore_attend_int4{sfx}_serve": (
            lambda vv: rescore_attend(q, ids4, kp, ks4, vv, vs, length, bs),
            lambda c: launch_rescore_attend(q, ids4, kp, ks4, vq, vs, length,
                                            bs, c),
            lambda vv: rescore_attend_plain(q, ids4, kp, ks4, vv, vs, length,
                                            bs), vq, ids4, d // 2 + d + 8, False),
        f"block_attend{sfx}_serve": (
            lambda vv: block_attend(scores, ids16, vv, None, bs),
            lambda c: launch_block_attend(scores, ids16, v, None, bs, c),
            lambda vv: block_attend_plain(scores, ids16, vv, None, bs), v,
            ids16, 2 * d, True),
    }
    results = {}
    for name, (kernel, launch, plain, vv, ids, per_token,
               stored) in cases.items():
        got, got_lse = kernel(vv)
        want, want_lse = plain(vv)
        err, share = check_close(name, got, want, tol)
        err = max(err, check_close(name + " lse", got_lse, want_lse,
                                   TOL["lse"])[0])
        teeth = check_rejects(name, plain(drop_tile(
            vv, 2, int(ids[0, 0, 0]) * bs))[0], want, tol)
        tokens = tokens_of(ids)
        # Rescore: the valid selected rows' K, V and scales; block-attend:
        # every selected token's G stored scores and the valid rows' V.
        nbytes = (tokens * per_token + ids.numel() * 4 + q.numel() * 2
                  + out_bytes + (ids.numel() * bs * g * 4 if stored else 0))
        flops = (2 if stored else 4) * d * g * tokens
        results[name] = dict(
            max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
            **timings(lambda: kernel(vv), lambda: plain(vv)),
            selected_tokens=tokens)
        log(f"kernel {name} err {err:.2e}, worst element {share:.2f} of its "
            f"limit (tol {tol}); a skipped tile's worst element {teeth:.1f}x "
            f"the limit; {tokens} valid selected rows")
        attend_chunk_sweep(name, launch)
    log_timings(results)
    return results


def first_step_fractions(run):
    """`run()`, one decode step, with every sparse layer's sampled fraction
    recorded (the engine's sparse decode wrapped for that step only).
    Returns (what `run` returned, the fractions of sparse layers 1, 2, ...
    in order)."""
    from magicpig_tpu_torch.runtime import engine

    inner, fracs = engine.decode_sparse_layer, []

    def recorded(*args, **kwargs):
        out, frac = inner(*args, **kwargs)
        fracs.append(frac)
        return out, frac

    engine.decode_sparse_layer = recorded
    try:
        out = run()
    finally:
        engine.decode_sparse_layer = inner
    return out, fracs


class Decoder:
    """`decoder(tokens, n)`: n greedy steps of an engine from `tokens`,
    returning the last step's argmax, through `llm.inference` (on the card
    the first step of an engine runs eagerly, every later one replays its
    CUDA graph) or, with `eager`, through the eager step `llm._decode`
    (its fractions summed in `frac_sum` as the engine sums them). Every
    step's logits are checked for shape and finiteness (`finite`); while
    `record` is a list, each step's input tokens and logits go to it."""

    def __init__(self, llm, eager: bool = False):
        import torch
        self.llm, self.eager, self.record = llm, eager, None
        self.finite = torch.ones((), dtype=torch.bool, device=llm.device)
        self.frac_sum = torch.zeros((), dtype=torch.float64,
                                    device=llm.device)

    def step(self, tokens):
        import torch
        if self.eager:
            self.llm._guard_decode(1)
            logits, frac = self.llm._decode(tokens)
            self.frac_sum = self.frac_sum + frac
        else:
            logits = self.llm.inference(tokens)
        if logits.shape != (self.llm.batch_size, self.llm.config.vocab_size):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        self.finite = self.finite & torch.isfinite(logits).all()
        if self.record is not None:
            self.record.append((tokens, logits))
        return logits

    def __call__(self, tokens, n: int):
        for _ in range(n):
            tokens = self.step(tokens).argmax(dim=-1)
        return tokens


def check_graphed(torch, llm, prompts, graphed, label: str,
                  refill=None) -> None:
    """The graphed run against the eager step. `graphed` holds the run's
    `record` (each step's input tokens and logits: the first step eager,
    the rest replays of the captured step), its `avg_sparsity` and the
    first step's sampled fractions (`first_fracs`). clear(), the two
    prompts prefilled again (or `refill()`), and the same input tokens through
    `llm._decode`: logits equal bit for bit (the same kernels in the same
    order on the same inputs; every hand-written kernel is deterministic),
    so greedy tokens too, and the mean sampled fraction and the first
    step's fractions equal, or raise."""
    llm.clear()
    if refill is None:
        llm.prefill(prompts[0], request_id=0)
        llm.prefill(prompts[1], request_id=1)
    else:
        refill()
    eager = Decoder(llm, eager=True)
    record = graphed["record"]
    first, fracs = first_step_fractions(lambda: eager.step(record[0][0]))
    logits = [first] + [eager.step(tokens) for tokens, _ in record[1:]]
    fracs = [float(f) for f in fracs]
    avg = float(eager.frac_sum) / len(record) if llm.lsh.enabled else 0.0
    diffs = [float((g.float() - e.float()).abs().max())
             for (_, g), e in zip(record, logits)]
    same = [torch.equal(g, e) for (_, g), e in zip(record, logits)]
    tokens_same = all(torch.equal(g.argmax(-1), e.argmax(-1))
                      for (_, g), e in zip(record, logits))
    log(f"serve {label}: graphed vs eager over {len(record)} steps: logits "
        f"equal bit for bit in {sum(same)} of {len(same)} steps (max |diff| "
        f"{max(diffs):.3e}), greedy tokens equal {tokens_same}; avg sparsity "
        f"{graphed['avg_sparsity']!r} / {avg!r}; first-step fractions equal "
        f"{graphed['first_fracs'] == fracs}")
    if not (all(same) and tokens_same and graphed["avg_sparsity"] == avg
            and graphed["first_fracs"] == fracs and bool(eager.finite)):
        raise AssertionError(f"serve {label}: the graphed step disagrees "
                             "with the eager step")


def phase_serve(torch, dev):
    """The main path at Llama-3.2-1B width and depth, kernels counted."""
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime.engine import LLM

    t = time.perf_counter()
    llm = LLM("llama-3.2-1b", K=10, L=150, batch_size=2, max_length=16384,
              device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"serve: engine with random weights in {time.perf_counter() - t:.1f} s")
    cfg = llm.config
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen, device=dev)
               for n in (12000, 7000, 9000)]
    decode = Decoder(llm)

    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    l0 = llm.prefill(prompts[0], request_id=0)
    l1 = llm.prefill(prompts[1], request_id=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    finite = torch.isfinite(l0).all() & torch.isfinite(l1).all()
    first = torch.cat([l0.argmax(-1), l1.argmax(-1)])
    snap = llm.sparsity_snapshot()
    decode.record = []
    t = time.perf_counter()
    tokens, first_fracs = first_step_fractions(lambda: decode(first, 1))
    decode(tokens, 15)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / 16
    graphed = dict(record=decode.record, avg_sparsity=llm.avg_sparsity_since(snap),
                   first_fracs=[float(f) for f in first_fracs])
    decode.record = None
    log(f"serve: prefill 12000 + 7000 tokens {prefill_s:.2f} s, "
        f"decode B=2 {decode_ms:.2f} ms/step")
    llm.clear()
    t = time.perf_counter()
    l2 = llm.prefill(prompts[2], request_id=0)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t
    finite = finite & torch.isfinite(l2).all()
    t = time.perf_counter()
    decode(torch.cat([l2.argmax(-1), l2.argmax(-1)]), 8)
    torch.cuda.synchronize()
    decode2_ms = (time.perf_counter() - t) * 1e3 / 8
    launches = dict(LAUNCHES)
    layers = cfg.num_hidden_layers
    n_dense = sum(1 for kind, _ in llm.groups if kind == "dense")
    steps = 16 + 8
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_prefill=layers * 3, flash_decode=layers * steps,
                  lsh_fused_decode=(layers - n_dense) * steps)
    log(f"serve: after clear(), prefill 9000 tokens {prefill2_s:.2f} s, "
        f"decode {decode2_ms:.2f} ms/step; avg sparsity "
        f"{llm.avg_sparsity:.5f}; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launches {launches} != path's {expect}")
    if not 0 < llm.avg_sparsity < 1:
        raise AssertionError(f"avg sparsity {llm.avg_sparsity} not in (0, 1)")
    check_graphed(torch, llm, prompts[:2], graphed, "LSH")
    del graphed

    # Where the time goes: the two first requests again, a warm prefill
    # timed and then profiled, 4 warm-up decode steps, then the eager and
    # the graphed step each 8 steps timed and 2 profiled. The idle share
    # sets the profiled device time against the unprofiled wall time (the
    # profiler's own cost is on the host).
    first = profile_prefill(torch, llm, prompts, "")
    tokens = decode(first, 4)
    profile_decode(torch, llm, decode, tokens,
                   "decode B=2, 12000 + 7000 tokens")
    if not bool(finite & decode.finite):
        raise AssertionError("non-finite logits in the serve phase")
    return dict(prefill_s=prefill_s, decode_ms=decode_ms,
                prefill2_s=prefill2_s, decode2_ms=decode2_ms,
                avg_sparsity=llm.avg_sparsity, launches=launches,
                params=llm.params, projections=llm.projections,
                prompts=prompts[:2],
                first_fracs=[float(f) for f in first_fracs])


PROFILED_STEPS = 2   # the profiler's processing costs seconds per step


def profile_prefill(torch, llm, prompts, label: str):
    """clear(), then a warm prefill of the first prompt timed and then
    profiled (wall, device busy, idle share, launches, kernels by device
    time), then the second prompt into slot 1. Returns the two requests'
    greedy first tokens."""
    llm.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    l0 = llm.prefill(prompts[0], request_id=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    busy, n, kernels = profiled(lambda: llm.prefill(prompts[0], request_id=0))
    log(f"profile: {label}prefill {prompts[0].numel()} tokens wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}, {n} launches")
    for e in kernels[:6]:
        log(f"  {_device_us(e) / 1e3:9.2f} ms {e.count:5d} calls  {e.key[:70]}")
    l1 = llm.prefill(prompts[1], request_id=1)
    return torch.cat([l0.argmax(-1), l1.argmax(-1)])


def profile_decode(torch, llm, decode, tokens, label: str,
                   named: tuple = ()) -> None:
    """The eager step (`llm._decode`), then the graphed step (`decode`,
    through `llm.inference`), each 8 steps timed and 2 under
    torch.profiler: wall and device busy time per step, the idle share
    (profiled device time against the unprofiled wall time; the profiler's
    own cost is on the host), launches per step (for the graphed step the
    captured graph's kernel nodes, beside the kernels the profiler saw) and
    the kernels by device time; then each kernel whose name holds one of
    `named`, wherever it ranks."""
    from magicpig_tpu_torch.runtime.engine import graph_kernel_nodes

    nodes = graph_kernel_nodes(llm._graph.graph)
    for name, run in (("eager", Decoder(llm, eager=True)), ("graphed", decode)):
        t = time.perf_counter()
        tokens = run(tokens, 8)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / 8
        n_prof = PROFILED_STEPS
        busy, n, kernels = profiled(lambda: run(tokens, n_prof))
        busy /= n_prof
        launches = (f"{n / n_prof:.0f} launches/step" if name == "eager" else
                    f"{nodes} graph kernel nodes/step ({n / n_prof:.0f} "
                    "launches/step profiled)")
        log(f"profile: {label} {name}: wall {wall:.2f} ms/step, device busy "
            f"{busy:.3f} ms/step, idle share {max(0.0, 1 - busy / wall):.3f}, "
            f"{launches}")
        for e in kernels[:12]:
            log(f"  {_device_us(e) / n_prof:9.1f} us/step "
                f"{e.count / n_prof:5.1f} calls/step  {e.key[:70]}")
        for part in named:
            for e in kernels:
                if part in e.key:
                    log(f"  {part}: {_device_us(e) / n_prof:.1f} us/step "
                        f"{e.count / n_prof:.1f} calls/step  {e.key[:70]}")


def serve_counted(torch, dev, prompts, lsh, label: str, expect_fn,
                  weight_quant: str = "none", params=None, check_frac=None,
                  projections=None, model="llama-3.2-1b",
                  prefill_profile: bool = False, after_prefill=None,
                  after_check=None, max_length: int = 16384,
                  profile_named: tuple = ()):
    """A serve of `model` (a preset's name, Llama-3.2-1B by default, or a
    `ModelConfig`) at full width and depth: `params`, or random weights
    drawn (and quantized as `weight_quant` says, q/k/v and gate|up fused) on
    the card; the two first requests prefilled, 16 greedy steps (the first
    with each sparse layer's sampled fraction recorded; on the card the
    first step runs eagerly and the other 15 replay the captured step),
    every kernel launch counted and held to `expect_fn(llm)` (the int4
    matmul's by weight shape too, under its "w4_shapes"), the sampled or
    realized fraction checked (`check_frac(fraction)` raises, or in (0, 1)
    for a sparse engine), finite logits; then the graphed run held to the
    eager step (`check_graphed`), then (with `prefill_profile`) a warm
    prefill timed and profiled, then a profiled decode pass of each.
    `after_prefill(llm)` runs after the counted run's prefills and
    `after_check(llm, graphed)` after `check_graphed`; either raises on a
    fault. `max_length`: the engine's (16384). `profile_named`: kernels
    the decode profile names wherever they rank (`profile_decode`)."""
    import dataclasses

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.ops.kernels import (LAUNCHES, W4_SHAPE_LAUNCHES,
                                                reset_launches)
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = preset(model) if isinstance(model, str) else model
    if weight_quant != "none":
        cfg = dataclasses.replace(cfg, weight_quant=weight_quant,
                                  fuse_small_linears=True)
    lens = " + ".join(str(p.numel()) for p in prompts[:2])
    t = time.perf_counter()
    llm = LLM(cfg, batch_size=2, max_length=max_length, lsh=lsh,
              params=params, projections=projections, device=dev, seed=1)
    torch.cuda.synchronize()
    log(f"serve {label}: engine ({weight_quant} weights) in "
        f"{time.perf_counter() - t:.1f} s")
    decode = Decoder(llm)

    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    l0 = llm.prefill(prompts[0], request_id=0)
    l1 = llm.prefill(prompts[1], request_id=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    finite = torch.isfinite(l0).all() & torch.isfinite(l1).all()
    if after_prefill is not None:
        after_prefill(llm)
    decode.record = []
    t = time.perf_counter()
    tokens, first_fracs = first_step_fractions(
        lambda: decode(torch.cat([l0.argmax(-1), l1.argmax(-1)]), 1))
    tokens = decode(tokens, 15)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / 16
    graphed = dict(record=decode.record, avg_sparsity=llm.avg_sparsity,
                   first_fracs=[float(f) for f in first_fracs])
    decode.record = None
    launches, w4_shapes = dict(LAUNCHES), dict(W4_SHAPE_LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    expect.update(expect_fn(llm))
    expect_w4 = expect.pop("w4_shapes", {})
    log(f"serve {label}: prefill {lens} tokens {prefill_s:.2f} s, "
        f"decode B=2 {decode_ms:.2f} ms/step; avg sparsity "
        f"{llm.avg_sparsity:.6f}; launches {launches}"
        + (f", int4 matmul by weight shape {w4_shapes}" if w4_shapes else ""))
    if launches != expect or w4_shapes != expect_w4:
        raise AssertionError(f"launches {launches}, {w4_shapes} != path's "
                             f"{expect}, {expect_w4}")
    if check_frac is not None:
        check_frac(llm.avg_sparsity)
    elif lsh.enabled and not 0 < llm.avg_sparsity < 1:
        raise AssertionError(f"avg sparsity {llm.avg_sparsity} not in (0, 1)")
    check_graphed(torch, llm, prompts, graphed, label)
    if after_check is not None:
        after_check(llm, graphed)
    del graphed
    if prefill_profile:
        tokens = decode(profile_prefill(torch, llm, prompts, f"{label} "), 4)
    profile_decode(torch, llm, decode, tokens, f"{label} decode B=2, {lens} "
                   "tokens", profile_named)
    if not bool(finite & decode.finite):
        raise AssertionError(f"non-finite logits in the {label} serve")
    return dict(prefill_s=prefill_s, decode_ms=decode_ms,
                avg_sparsity=llm.avg_sparsity, launches=launches,
                w4_shapes=w4_shapes, first_fracs=[float(f) for f in first_fracs])


def phase_serve_block(torch, dev, params, prompts):
    """The block_topk estimator with int8 offload (the rescore pipeline) on
    the LSH run's weights and first two prompts; the realized fraction is
    exact."""
    from magicpig_tpu_torch.config import LSHConfig

    lsh = LSHConfig(estimator="block_topk", offload_quant="int8")

    def expect(llm):
        n = llm.config.num_hidden_layers
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        return dict(flash_prefill=2 * n, flash_decode=16 * n,
                    block_rank=16 * n_sparse, rescore_attend=16 * n_sparse)

    return serve_counted(torch, dev, prompts, lsh, "block_topk int8", expect,
                         params=params, check_frac=exact_fraction(lsh, prompts))


def phase_serve_two_stage(torch, dev, serve):
    """The two-stage LSH decode on the LSH run's weights, projections and
    first two prompts (`serve`, phase_serve's result): the sampled mode at K=10,
    L=150 (the collision scan, the budget ids, the gathered decode), whose
    first step's sampled count in sparse layer 1 must equal the masked
    serve's (the same query, the same collision words; later layers see
    activations that the two estimators round differently); and the masked
    mode at K=8, L=75, odd L: the scan and the masked attend."""
    from magicpig_tpu_torch.config import LSHConfig

    def expect_fn(*names):
        def expect(llm):
            n = llm.config.num_hidden_layers
            n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
            return dict(flash_prefill=2 * n, flash_decode=16 * n,
                        **{name: 16 * n_sparse for name in names})
        return expect

    params, prompts = serve["params"], serve["prompts"]
    sampled = serve_counted(
        torch, dev, prompts, LSHConfig(K=10, L=150, decode_mode="sampled"),
        "sampled K=10/L=150", expect_fn("collision_words"), params=params,
        projections=serve["projections"])
    got, want = sampled["first_fracs"], serve["first_fracs"]
    if got[0] != want[0]:
        raise AssertionError(f"sampled serve: layer 1's first-step fraction "
                             f"{got[0]} != the masked serve's {want[0]}")
    worst = max(abs(a - b) / b for a, b in zip(got, want))
    log(f"serve sampled: first step, sparse layer 1 sampled fraction "
        f"{got[0]:.6f} equals the masked serve's; all layers within "
        f"{worst:.2e} of it (relative)")
    torch.cuda.empty_cache()
    odd = serve_counted(
        torch, dev, prompts, LSHConfig(K=8, L=75), "odd L K=8/L=75",
        expect_fn("collision_words", "lsh_masked_attention"), params=params)
    return sampled, odd


def exact_fraction(lsh, prompts, max_length: int = 16384):
    """A check of block_topk's realized fraction at the two first prompts:
    the budget's blocks of 512 (8% of the offload capacity's, rounded up:
    3 of 32 at max_length 16384) against the prompts' offloaded tokens
    (11932 and 6932 give 1536 / 9432)."""
    from magicpig_tpu_torch.runtime.state import offload_capacity

    bs = lsh.block_topk_block_size
    nb = offload_capacity(lsh, max_length) // bs
    blocks = min(nb, max(1, math.ceil(nb * lsh.block_topk_budget_frac)))
    off = [n - lsh.num_sink_tokens - lsh.num_local_tokens
           for n in (prompts[0].numel(), prompts[1].numel())]
    want_frac = sum(min(blocks * bs, n) for n in off) / sum(off)

    def check_frac(frac):
        if abs(frac - want_frac) > 1e-6:
            raise AssertionError(f"avg sparsity {frac} != {want_frac}")

    return check_frac


def phase_serve_bench_modes(torch, dev, prompts):
    """bench.py's lsh mode (W8A8 weights, int8 offload) and its full_int8
    mode with int4 weights."""
    from magicpig_tpu_torch.config import LSHConfig

    def lsh_expect(llm):
        n, steps = llm.config.num_hidden_layers, 16
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        # flash decode: the dense layer and every sparse layer's hot partial.
        return dict(flash_prefill=2 * n, flash_decode=steps * n,
                    lsh_fused_decode_int8=steps * n_sparse)

    def full_int8_expect(llm):
        n, steps = llm.config.num_hidden_layers, 16
        # Per decode step 4 int4 products a layer (wqkv, wo, w_gateup,
        # w_down) and the lm_head; at prefill (M >= 512) the layers take the
        # dequantized weight and only each request's last-token lm_head
        # (M = 1) the kernel.
        *layers, (_, kin, out) = W4_SHAPES          # the lm_head last
        w4_shapes = {f"{k}x{o}": steps * n for _, k, o in layers}
        w4_shapes[f"{kin}x{out}"] = steps + 2
        return dict(flash_prefill=2 * n, flash_decode_int8=steps * n,
                    w4_matmul=steps * (4 * n + 1) + 2, w4_shapes=w4_shapes)

    def block_topk4_expect(llm):
        n, steps = llm.config.num_hidden_layers, 16
        n_dense = sum(1 for kind, _ in llm.groups if kind == "dense")
        n_sparse = n - n_dense
        # flash decode: the dense layer over int8 K/V, every sparse layer's
        # hot partial in bf16; the sparse layers' packed scorer and rescore.
        return dict(flash_prefill=2 * n, flash_decode=steps * n_sparse,
                    flash_decode_int8=steps * n_dense,
                    block_rank_int4=steps * n_sparse,
                    rescore_attend_int4=steps * n_sparse)

    lsh_mode = serve_counted(
        torch, dev, prompts, LSHConfig(K=10, L=150, offload_quant="int8"),
        "bench lsh (W8A8, int8 offload)", lsh_expect, weight_quant="int8")
    torch.cuda.empty_cache()
    full_int8 = serve_counted(
        torch, dev, prompts, LSHConfig(K=0, L=0, dense_quant="int8"),
        "bench full_int8 (W4, dense int8)", full_int8_expect,
        weight_quant="int4")
    torch.cuda.empty_cache()
    # bench.py's block_topk4 mode (bench.py:66-73): packed int4 K, int8 V,
    # a dense int8 layer 0; 3 of 32 blocks, so the realized fraction is
    # 1536 / 9432 as for int8 offload.
    lsh = LSHConfig(K=1, L=0, estimator="block_topk", offload_quant="int4",
                    dense_quant="int8")
    block_topk4 = serve_counted(
        torch, dev, prompts, lsh, "bench block_topk4 (W8A8, packed int4 K)",
        block_topk4_expect, weight_quant="int8",
        check_frac=exact_fraction(lsh, prompts))
    return lsh_mode, full_int8, block_topk4


def phase_serve_8b(torch, dev):
    """`LLM("llama-3.1-8b")` at full width and depth (32 layers, hidden 4096,
    32/8 heads of 128, intermediate 14336, vocab 128256, untied lm_head,
    dense layers 0 and 16) on the two prompts of the 1B serves (12000 and
    7000 random tokens, drawn again from their seed), 16 greedy steps each,
    every launch counted (the int4 matmul's by weight shape too), the
    graphed run held to the eager step, the decode steps profiled. The bf16
    weights are drawn once on the card (with the hash projections after
    them, from the generator an `LLM(seed=1)` draws from) and quantized from
    that draw: bf16 weights under LSH K=10, L=150 over bf16 K/V (a warm
    prefill profiled too), and at odd L, K=8, L=75 (the collision scan and
    the masked attend at d = 128; its projections drawn by the engine);
    then `bench.py`'s lsh mode (W8A8 fused weights,
    LSH over int8 offload K/V), its block_topk4 mode (W8A8, packed int4 K
    and int8 V, dense int8 layers; the realized fraction exact) and its
    full_int8 mode with int4 fused weights (K=0, every layer dense over
    int8 K/V). Returns the five serves' results in that order."""
    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.models.llama import (fuse_params, init_params,
                                                 quantize_params)
    from magicpig_tpu_torch.ops.hashing import make_hash_projections

    model, n_ctx = "llama-3.1-8b", 16384
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, 128256, (n,), generator=gen, device=dev)
               for n in (12000, 7000)]
    t = time.perf_counter()
    cfg = preset(model)
    gen.manual_seed(1)
    params = init_params(cfg, n_ctx, gen, dev)
    projections = make_hash_projections(cfg.head_dim, 10, 150, gen, dev)
    w4 = fuse_params(quantize_params(params, 4))
    torch.cuda.synchronize()
    log(f"serve llama-3.1-8b: bf16 weights drawn and int4 weights quantized "
        f"in {time.perf_counter() - t:.1f} s")

    def counts(steps=16, **per_step):
        def expect(llm):
            n = llm.config.num_hidden_layers
            n_dense = sum(1 for kind, _ in llm.groups if kind == "dense")
            layers = dict(all=n, dense=n_dense, sparse=n - n_dense)
            return dict(flash_prefill_d128=2 * n,
                        **{name: steps * layers[which]
                           for name, which in per_step.items()})
        return expect

    def full_int8_expect(llm):
        n, steps = llm.config.num_hidden_layers, 16
        # As the 1B's: 4 int4 products a layer and the lm_head a step; at
        # prefill each request's last-token lm_head.
        *layers, (_, kin, out) = W4_SHAPES_8B
        w4_shapes = {f"{k}x{o}": steps * n for _, k, o in layers}
        w4_shapes[f"{kin}x{out}"] = steps + 2
        return dict(flash_prefill_d128=2 * n, flash_decode_int8_d128=steps * n,
                    w4_matmul=steps * (4 * n + 1) + 2, w4_shapes=w4_shapes)

    bf16 = serve_counted(
        torch, dev, prompts, LSHConfig(K=10, L=150), "llama-3.1-8b LSH",
        counts(flash_decode_d128="all", lsh_fused_decode_d128="sparse"),
        model=model, params=params, projections=projections,
        prefill_profile=True)
    gc.collect()
    torch.cuda.empty_cache()
    odd = serve_counted(
        torch, dev, prompts, LSHConfig(K=8, L=75), "llama-3.1-8b odd L K=8/L=75",
        counts(flash_decode_d128="all", collision_words="sparse",
               lsh_masked_attention_d128="sparse"),
        model=model, params=params)
    gc.collect()
    torch.cuda.empty_cache()
    serve_8b_baselines(torch, dev, prompts, params,
                       counts(flash_decode_d128="all"))
    w8 = fuse_params(quantize_params(params, 8))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lsh_mode = serve_counted(
        torch, dev, prompts, LSHConfig(K=10, L=150, offload_quant="int8"),
        "llama-3.1-8b bench lsh (W8A8, int8 offload)",
        counts(flash_decode_d128="all", lsh_fused_decode_int8_d128="sparse"),
        weight_quant="int8", model=model, params=w8, projections=projections)
    gc.collect()
    torch.cuda.empty_cache()
    lsh = LSHConfig(K=1, L=0, estimator="block_topk", offload_quant="int4",
                    dense_quant="int8")
    block_topk4 = serve_counted(
        torch, dev, prompts, lsh,
        "llama-3.1-8b bench block_topk4 (W8A8, packed int4 K)",
        counts(flash_decode_d128="sparse", flash_decode_int8_d128="dense",
               block_rank_int4_d128="sparse",
               rescore_attend_int4_d128="sparse"),
        weight_quant="int8", model=model, params=w8,
        check_frac=exact_fraction(lsh, prompts))
    del w8
    gc.collect()
    torch.cuda.empty_cache()
    full_int8 = serve_counted(
        torch, dev, prompts, LSHConfig(K=0, L=0, dense_quant="int8"),
        "llama-3.1-8b bench full_int8 (W4, dense int8)", full_int8_expect,
        weight_quant="int4", model=model, params=w4)
    return bf16, odd, lsh_mode, block_topk4, full_int8


# The baselines' budgets in the 8B serves: a 16384-token offload capacity
# (16384 - 68 rounded up to 128), 41 of its 1024 16-token Quest pages (4%,
# rounded up), 328 TopK or OracleSampling tokens (2%, rounded up); the
# realized fraction over offloads of 11932 and 6932 tokens is the budget
# over their mean, 9432.
BASELINE_BUDGETS = {"quest": 41 * 16, "topk": 328, "oracle_sampling": 328}


def serve_8b_baselines(torch, dev, prompts, params, expect):
    """The reference's accuracy baselines at the 8B's full width and depth
    on the bf16 LSH serve's weights and prompts, each with its default
    budget and dense layers {0, 1}: Quest (16-token pages, 4%), TopK (2%)
    and OracleSampling (2%; its draws from the decode step, so the graphed
    run draws as the eager one does). 16 steps each, counted (flash decode
    in every layer, no other hand-written kernel: the baselines are plain
    PyTorch), the realized fraction exact, held to the eager step bit for
    bit and profiled. Returns the three serves' results."""
    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.runtime.server import _static_budget

    def after_prefill(llm):
        off_cap = llm.state.off_v[0].shape[2]
        dense = [i for i, (kind, _) in enumerate(llm.groups) if kind == "dense"]
        lsh = llm.lsh
        pages = _static_budget(off_cap // lsh.quest_page_size,
                               lsh.quest_budget_frac, floor=1)
        tokens = _static_budget(off_cap, lsh.topk_budget_frac, floor=16)
        if (off_cap, dense, llm.state.off_len.tolist(), pages * 16,
                tokens) != (16384, [0, 1], [11932, 6932], 656, 328):
            raise AssertionError(
                f"{lsh.estimator}: offload capacity {off_cap}, dense layers "
                f"{dense}, offloads {llm.state.off_len.tolist()}, budgets "
                f"{pages * 16} / {tokens}")

    results = {}
    for estimator, budget in BASELINE_BUDGETS.items():
        want = budget / 9432

        def check_frac(frac, want=want, estimator=estimator):
            log(f"serve llama-3.1-8b {estimator}: realized fraction "
                f"{frac:.6f}, the budgets give {want:.6f}")
            if abs(frac - want) > 1e-6:
                raise AssertionError(f"avg sparsity {frac} != {want}")

        results[estimator] = serve_counted(
            torch, dev, prompts, LSHConfig(estimator=estimator),
            f"llama-3.1-8b {estimator}", expect, model="llama-3.1-8b",
            params=params, check_frac=check_frac, after_prefill=after_prefill)
        gc.collect()
        torch.cuda.empty_cache()
    return results


def phase_serve_3b(torch, dev):
    """`LLM("llama-3.2-3b")` at full width and depth (28 layers, hidden 3072,
    24/8 heads of 128: group size 3; intermediate 8192, vocab 128256, tied
    embeddings, dense layers 0 and 16), random bf16 weights drawn on the
    card by the engine (`seed=1`), on the two prompts of the 1B and 8B
    serves (12000 and 7000 random tokens, drawn again from their seed),
    LSH K=10, L=150, exact debias: 16 greedy steps, every launch counted
    (the G = 3 forms of the d = 128 prefill, decode and fused LSH kernel),
    the graphed run held to the eager step bit for bit, a warm prefill and
    the decode steps profiled."""
    from magicpig_tpu_torch.config import LSHConfig

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, 128256, (n,), generator=gen, device=dev)
               for n in (12000, 7000)]

    def expect(llm):
        n = llm.config.num_hidden_layers
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        return dict(flash_prefill_d128=2 * n, flash_decode_d128=16 * n,
                    lsh_fused_decode_d128=16 * n_sparse)

    return serve_counted(torch, dev, prompts, LSHConfig(K=10, L=150),
                         "llama-3.2-3b LSH", expect, model="llama-3.2-3b",
                         prefill_profile=True)


# SmolLM2-360M as its published config.json gives it
# (huggingface.co/HuggingFaceTB/SmolLM2-360M, config.json): 15 query heads
# over 5 kv heads of 64 (group size 3 at head dim 64), tied embeddings,
# 8192 positions.
SMOLLM2_360M = dict(
    architectures=["LlamaForCausalLM"], vocab_size=49152, hidden_size=960,
    intermediate_size=2560, num_hidden_layers=32, num_attention_heads=15,
    num_key_value_heads=5, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=100000, rope_scaling=None, max_position_embeddings=8192,
    tie_word_embeddings=True, bos_token_id=0, eos_token_id=0,
    torch_dtype="bfloat16")
SMOLLM2_PROMPTS = (7000, 4000)
SMOLLM2_MAX_LEN = 8192
# Llama-3.1-405B as its published config.json gives it
# (huggingface.co/meta-llama/Llama-3.1-405B, config.json): 128 query heads
# over 8 kv heads of 128 (group size 16), the 8B's rope scaling; served
# here at its full width with its depth cut from 126 layers to 4
# (`LLAMA405B_LAYERS`: layer 0 dense, 1-3 sparse; ~34 GB of bf16 weights).
LLAMA_31_405B = dict(
    architectures=["LlamaForCausalLM"], vocab_size=128256, hidden_size=16384,
    intermediate_size=53248, num_hidden_layers=126, num_attention_heads=128,
    num_key_value_heads=8, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=500000.0, max_position_embeddings=131072,
    rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192,
                      rope_type="llama3"),
    tie_word_embeddings=False, bos_token_id=128000, eos_token_id=128001,
    torch_dtype="bfloat16")
LLAMA405B_LAYERS = 4


BLOCK_KERNELS = ("block_score", "rescore_attend")   # B7 and B8 by name


def phase_serve_forms(torch, dev):
    """The kernels' general tile at full width. SmolLM2-360M at full width
    and depth (32 layers, hidden 960, 15/5 heads of 64: G = 3 at d = 64;
    intermediate 2560, vocab 49152, tied embeddings, dense layers 0 and 16;
    the config built by `from_hf_config` from the published config.json
    values, `SMOLLM2_360M`), max_length 8192, random bf16 weights drawn on
    the card by the engine (`seed=1`), two requests of 7000 and 4000 random
    tokens: under LSH K=10, L=150 (the engine's defaults: masked, bf16 KV;
    the slice's main path), block_topk over int8 offload (the realized
    fraction exact) and odd L (K=8, L=75): 16 greedy steps each (the first
    eager, 15 replays), every launch counted (the "_g3" forms of the
    decode, the fused and masked LSH kernels, the scorer and the rescore),
    the graphed run held to the eager step bit for bit, the LSH serve's
    prefill and each serve's decode profiled. Then Llama-3.1-405B
    (`LLAMA_31_405B`) at full width, its depth cut to 4 layers (layer 0
    dense), prompts of 12000 and 7000 tokens at max_length 16384, under
    LSH K=10, L=150 and block_topk int8 (G = 16: the "_d128_g16" forms, one
    block of every kernel's 16-head tile a kv head) on one draw of its
    weights, the same checks; the weights freed after. The block_topk
    serves' profiles name the scorer's and the rescore's device time a step
    (`BLOCK_KERNELS`). Returns the serves' results."""
    from magicpig_tpu_torch.config import LSHConfig, ModelConfig
    from magicpig_tpu_torch.models.llama import init_params

    def expect_fn(decode, prefill, **sparse):
        def expect(llm):
            n = llm.config.num_hidden_layers
            n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
            return {prefill: 2 * n, decode: 16 * n,
                    **{name: 16 * n_sparse for name in sparse}}
        return expect

    out = {}
    cfg = ModelConfig.from_hf_config(SMOLLM2_360M, name="smollm2-360m")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=dev) for n in SMOLLM2_PROMPTS]
    block = LSHConfig(estimator="block_topk", offload_quant="int8")
    for key, label, lsh, sparse, kw in (
            ("smollm2", "LSH", LSHConfig(), ("lsh_fused_decode_g3",),
             dict(prefill_profile=True)),
            ("smollm2_block", "block_topk int8", block,
             ("block_rank_g3", "rescore_attend_g3"),
             dict(check_frac=exact_fraction(block, prompts, SMOLLM2_MAX_LEN),
                  profile_named=BLOCK_KERNELS)),
            ("smollm2_odd", "odd L K=8/L=75", LSHConfig(K=8, L=75),
             ("collision_words", "lsh_masked_attention_g3"), {})):
        out[key] = serve_counted(
            torch, dev, prompts, lsh, f"smollm2-360m {label}",
            expect_fn("flash_decode_g3", "flash_prefill",
                      **dict.fromkeys(sparse)),
            model=cfg, max_length=SMOLLM2_MAX_LEN, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    del prompts

    cfg = ModelConfig.from_hf_config(
        dict(LLAMA_31_405B, num_hidden_layers=LLAMA405B_LAYERS),
        name="llama-3.1-405b")
    gen.manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=dev) for n in (12000, 7000)]
    gen.manual_seed(1)       # the draw of an `LLM(seed=1)`, once for both
    params = init_params(cfg, 16384, gen, dev)
    block = LSHConfig(estimator="block_topk", offload_quant="int8")
    for key, lsh, sparse, kw in (
            ("405b", LSHConfig(K=10, L=150), ("lsh_fused_decode_d128_g16",),
             dict(prefill_profile=True)),
            ("405b_block", block,
             ("block_rank_d128_g16", "rescore_attend_d128_g16"),
             dict(check_frac=exact_fraction(block, prompts),
                  profile_named=BLOCK_KERNELS))):
        out[key] = serve_counted(
            torch, dev, prompts, lsh,
            f"llama-3.1-405b ({LLAMA405B_LAYERS} layers) "
            f"{'LSH' if key == '405b' else 'block_topk int8'}",
            expect_fn("flash_decode_d128_g16", "flash_prefill_d128",
                      **dict.fromkeys(sparse)),
            model=cfg, params=params, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# Mistral-7B-v0.1 as its published config.json gives it
# (huggingface.co/mistralai/Mistral-7B-v0.1, config.json): Mistral's 7B
# shape with a sliding window of 4096 tokens.
MISTRAL_V01 = dict(
    architectures=["MistralForCausalLM"], vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, hidden_act="silu", rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=32768, sliding_window=4096,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
    torch_dtype="bfloat16")
# Request 0 a window and more past its start (the offload clipped, the
# dense layers bounded); request 1 six tokens short of the window, so that
# its sinks leave it one by one during 16 steps (positions 4096-4099).
MISTRAL_PROMPTS = (16000, 4090)
MISTRAL_STEP_START = (11905, 0)     # the dense decode's first row at step 1


def mistral_config(**overrides):
    """The port's config of Mistral-7B-v0.1 from its published values
    (`MISTRAL_V01`, with `overrides`), through `from_hf_config`."""
    from magicpig_tpu_torch.config import ModelConfig

    return ModelConfig.from_hf_config(dict(MISTRAL_V01, **overrides),
                                      name="mistral-7b-v0.1")


def phase_serve_mistral(torch, dev):
    """Mistral-7B-v0.1 at full width and depth (32 layers, hidden 4096,
    32/8 heads of 128, intermediate 14336, vocab 32000, untied lm_head,
    sliding window 4096; the config built by `from_hf_config` from the
    published config.json values), random bf16 weights drawn on the card
    by the engine (`seed=1`), LSH K=10, L=150 (masked), dense layers 0 and
    16, two requests of 16000 and 4090 random tokens: request 0's offload
    clipped to its last 4096 tokens less the 64 local ones (4032 rows; the
    JAX fill's clip), its dense layers attending 4096 of its 16001 rows at
    the first step (flash decode from row 11905); request 1 (4022 offload
    rows) crossing the window during the 16 steps, its sinks leaving the
    hot partial one by one. 16 greedy steps (the first eager, 15 replays),
    every launch counted, the graphed run held to the eager step bit for
    bit, the sampled fraction in (0, 1); then the planted fault: the first
    step again with the window off (every decode bound 0) must move
    request 0's logits by more than `SCHED_TOL` of their largest value and
    leave request 1's (whose rows all lie in the window at that step) bit
    for bit; then a warm prefill and the decode steps profiled."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig

    cfg = mistral_config()
    window, label = cfg.sliding_window, "mistral-7b-v0.1 LSH window 4096"
    lsh = LSHConfig(K=10, L=150)
    sink, local = lsh.num_sink_tokens, lsh.num_local_tokens
    off_want = [p - local - max(sink, p - window) for p in MISTRAL_PROMPTS]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=dev) for n in MISTRAL_PROMPTS]

    def expect(llm):
        n = llm.config.num_hidden_layers
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        return dict(flash_prefill_d128=2 * n, flash_decode_d128=16 * n,
                    lsh_fused_decode_d128=16 * n_sparse)

    def after_prefill(llm):
        off, dense = llm.state.off_len.tolist(), llm.state.dense_len.tolist()
        starts = [max(0, n + 1 - window) for n in dense]
        log(f"serve {label}: offload lengths {off} (the window's clip: "
            f"{off_want}), dense lengths {dense}, the first step's dense "
            f"rows from {starts}; request 1's sinks leave the window at "
            f"positions {window}-{window + sink - 1}")
        if off != off_want or starts != list(MISTRAL_STEP_START):
            raise AssertionError(f"serve {label}: offload lengths {off} / "
                                 f"first rows {starts} != {off_want} / "
                                 f"{MISTRAL_STEP_START}")

    def after_check(llm, graphed):
        tokens, windowed = graphed["record"][0]
        llm.clear()
        llm.prefill(prompts[0], request_id=0)
        llm.prefill(prompts[1], request_id=1)
        llm.config = dataclasses.replace(cfg, sliding_window=None)
        try:
            faulty, _ = llm._decode(tokens)
        finally:
            llm.config = cfg
        moved = float((faulty[0].float() - windowed[0].float()).abs().max()
                      / windowed[0].float().abs().max())
        same = torch.equal(faulty[1], windowed[1])
        log(f"serve {label}: the window off at the first step moves request "
            f"0's logits by {moved:.3e} of their largest ({moved / SCHED_TOL:.1f}x "
            f"the limit {SCHED_TOL}); request 1's equal bit for bit {same}")
        if not (moved > SCHED_TOL and same):
            raise AssertionError(f"serve {label}: the window changes nothing "
                                 "the tolerance can see")

    return serve_counted(torch, dev, prompts, lsh, label, expect, model=cfg,
                         prefill_profile=True, after_prefill=after_prefill,
                         after_check=after_check)


def write_safetensors(torch, path, tensors: dict) -> None:
    """A .safetensors file of `tensors` (bf16, f16 or f32, on any device),
    written as the format defines it: an 8-byte little-endian header
    length, the JSON header (names in sorted order, each with its dtype,
    shape and byte offsets in the data), padded with spaces to 8 bytes,
    then the raw data."""
    codes = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in sorted(tensors):
            t = tensors[name].contiguous().reshape(-1).view(torch.uint8)
            f.write(t.cpu().numpy().data)


ROOT = pathlib.Path(__file__).resolve().parent
CKPT_DIR = ROOT / "_ckpt"           # the phase's checkpoints (git-ignored)
GENERATION_TEXT = ("MagicPIG samples the keys of a long context by "
                   "locality-sensitive hashing and attends them on the card. "
                   ) * 60             # 6240 bytes: past the window of 4096


def phase_checkpoint(torch, dev):
    """The local-checkpoint path: a two-layer checkpoint at Mistral-7B-v0.1
    width (random bf16 weights drawn on the card, HF names and [out, in]
    layouts, the lm_head untied; ~1.4 GB in two shards) and its config.json
    (the published values, two layers) written with `write_safetensors`
    (the card has no safetensors package) into a temporary directory under
    `_ckpt/`; loaded by `load_checkpoint` onto the card, each tensor the
    reader gives and each weight of the params byte-equal to what was
    written (the linear weights transposed) and the config that of the
    published values; then `examples/generation_torch.py --model <dir> --M
    8192 --G 16` on a 6240-byte text file (the byte tokenizer: 6241 tokens,
    past the window, so that dense layer 0 is bounded and sparse layer 1's
    offload clipped) in its own process, which must exit 0 and report its
    prefill and generation. That process is started by the returned
    `start()` and checked by the `finish()` it returns: `main` runs it
    beside phase 4, which times nothing (so its decoding latency is read
    with phase 4 on the card too); the checkpoint's directory goes with
    `finish()`."""
    import dataclasses
    import shutil
    import tempfile

    from magicpig_tpu_torch.models.loader import (SafetensorsFiles,
                                                  load_checkpoint)

    n_layers = 2
    cfg = mistral_config(num_hidden_layers=n_layers)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hq, hkv = (cfg.num_attention_heads * cfg.head_dim,
               cfg.num_key_value_heads * cfg.head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def draw(*shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        return x.mul_(shape[-1] ** -0.5)

    def norm():
        return 1 + draw(h) * 0.1

    sd = {"model.embed_tokens.weight": draw(cfg.vocab_size, h),
          "model.norm.weight": norm(), "lm_head.weight": draw(cfg.vocab_size, h)}
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "self_attn.q_proj.weight": draw(hq, h),
                   pre + "self_attn.k_proj.weight": draw(hkv, h),
                   pre + "self_attn.v_proj.weight": draw(hkv, h),
                   pre + "self_attn.o_proj.weight": draw(h, hq),
                   pre + "mlp.gate_proj.weight": draw(inter, h),
                   pre + "mlp.up_proj.weight": draw(inter, h),
                   pre + "mlp.down_proj.weight": draw(h, inter),
                   pre + "input_layernorm.weight": norm(),
                   pre + "post_attention_layernorm.weight": norm()})
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    CKPT_DIR.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=CKPT_DIR)
    try:
        path = pathlib.Path(tmp) / "mistral-7b-v0.1-2l"
        path.mkdir()
        (path / "config.json").write_text(json.dumps(
            dict(MISTRAL_V01, num_hidden_layers=n_layers)))
        t = time.perf_counter()
        shards = ({k: v for k, v in sd.items() if ".layers." in k},
                  {k: v for k, v in sd.items() if ".layers." not in k})
        for i, shard in enumerate(shards):
            write_safetensors(torch, path / f"model-{i + 1:05d}-of-00002"
                              ".safetensors", shard)
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        got_cfg, params = load_checkpoint(str(path), 8192, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        want_cfg = dataclasses.replace(cfg, name=path.name)
        if got_cfg != want_cfg:
            raise AssertionError(f"checkpoint config {got_cfg} != {want_cfg}")
        with SafetensorsFiles(sorted(str(p) for p in
                                     path.glob("*.safetensors")), dev) as files:
            if sorted(files) != sorted(sd):
                raise AssertionError("the reader's names differ from the "
                                     "written")
            same = all(torch.equal(files[k], v) for k, v in sd.items())
        lw = params.layers
        pairs = [(params.embed, sd["model.embed_tokens.weight"]),
                 (params.lm_head, sd["lm_head.weight"].T),
                 (params.final_ln, sd["model.norm.weight"])]
        for i in range(n_layers):
            pre = f"model.layers.{i}."
            pairs += [(getattr(lw, name)[i], sd[pre + hf].T) for name, hf in (
                ("wq", "self_attn.q_proj.weight"),
                ("wk", "self_attn.k_proj.weight"),
                ("wv", "self_attn.v_proj.weight"),
                ("wo", "self_attn.o_proj.weight"),
                ("w_gate", "mlp.gate_proj.weight"),
                ("w_up", "mlp.up_proj.weight"),
                ("w_down", "mlp.down_proj.weight"))]
            pairs += [(lw.ln_attn[i], sd[pre + "input_layernorm.weight"]),
                      (lw.ln_mlp[i], sd[pre + "post_attention_layernorm.weight"])]
        same_params = all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in pairs)
        log(f"checkpoint: {nbytes / 1e9:.2f} GB of bf16 in 2 shards written "
            f"in {write_s:.1f} s, loaded by load_checkpoint in {load_s:.2f} s "
            f"({nbytes / 1e9 / load_s:.2f} GB/s, the files in the page "
            f"cache); every tensor byte-equal {same}, every weight of the "
            f"params {same_params}; config {got_cfg.name}, window "
            f"{got_cfg.sliding_window}, {got_cfg.num_hidden_layers} layers")
        if not (same and same_params):
            raise AssertionError("the loaded checkpoint differs from the "
                                 "written one")
        del params, pairs, lw, sd, shards
        gc.collect()
        torch.cuda.empty_cache()
        data = path / "prompt.txt"
        data.write_text(GENERATION_TEXT)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    cmd = [sys.executable, str(ROOT / "examples" / "generation_torch.py"),
           "--model", str(path), "--M", "8192", "--G", "16", "--data",
           str(data), "--device", dev.type]
    run = {}

    def start():
        run["out"] = open(pathlib.Path(tmp) / "stdout", "w+")
        run["err"] = open(pathlib.Path(tmp) / "stderr", "w+")
        run["t"] = time.perf_counter()
        run["proc"] = subprocess.Popen(cmd, stdout=run["out"],
                                       stderr=run["err"], text=True, cwd=ROOT)
        log("generation_torch.py started in its own process")

    def finish(kill: bool = False):
        """Wait for the process and check it (with `kill`: stop it, check
        nothing); the checkpoint's directory goes either way."""
        try:
            proc = run["proc"]
            if kill:
                proc.kill()
            proc.wait(timeout=600)
            gen_s = time.perf_counter() - run["t"]
            run["out"].seek(0)
            run["err"].seek(0)
            stdout, stderr = run["out"].read(), run["err"].read()
            run["out"].close()
            run["err"].close()
        finally:
            if "proc" in run and run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            shutil.rmtree(tmp, ignore_errors=True)
        if kill:
            return None
        lines = stdout.splitlines()
        info = [l for l in lines if l.startswith("[INFO]")]
        n_prompt = len(GENERATION_TEXT.encode()) + 1       # the byte tokenizer
        log(f"generation_torch.py: exit {proc.returncode} in {gen_s:.1f} s "
            f"(phase 4 on the card beside it); {info}; text "
            f"{lines[-1][:80]!r}" if lines else "no output")
        if (proc.returncode != 0
                or f"[INFO] Prefill {n_prompt} tokens" not in info
                or not any(l.startswith("[INFO] Generate") for l in info)):
            raise AssertionError(f"generation_torch.py failed:\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
        return dict(load_s=load_s, gen_s=gen_s)

    return start, finish


def state_bytes(state) -> int:
    """Bytes of every tensor of an engine's decode state."""
    import dataclasses
    total = 0
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        for t in value if isinstance(value, list) else [value]:
            total += t.numel() * t.element_size()
    return total


TRACE_DIR = str(pathlib.Path(__file__).resolve().parent / "traces")


def profile_decode_traced(torch, llm, decode, tokens, label: str):
    """The eager step, then the graphed step, each 8 steps under
    `utils/profiling.StepTimer` (wall, the card synchronized at both ends);
    then 2 graphed steps under `utils/profiling.trace`, whose Chrome trace
    goes to traces/ beside this script: device busy per step, the idle share
    against the timed wall, the graph's kernel nodes. Returns the tokens
    and the graphed step's (wall ms, busy ms, idle share)."""
    import os

    from magicpig_tpu_torch.runtime.engine import graph_kernel_nodes
    from magicpig_tpu_torch.utils.profiling import StepTimer, annotate, trace

    walls = {}
    for name, run in (("eager", Decoder(llm, eager=True)), ("graphed", decode)):
        timer = StepTimer()
        with timer:
            tokens = run(tokens, 8)
            timer.step(8)
        walls[name] = timer.ms_per_token
        log(f"profile: {label} {name}: {timer.report(llm.batch_size)} "
            f"(B={llm.batch_size})")
    before = set(os.listdir(TRACE_DIR)) if os.path.isdir(TRACE_DIR) else set()
    region = f"{label} graphed decode"
    with trace(TRACE_DIR) as prof:
        with annotate(region):
            tokens = decode(tokens, PROFILED_STEPS)
    (written,) = set(os.listdir(TRACE_DIR)) - before
    # The annotated region has a device-side span of its own: not a kernel.
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key != region),
                     key=_device_us, reverse=True)
    busy = sum(map(_device_us, kernels)) / 1e3 / PROFILED_STEPS
    wall = walls["graphed"]
    idle = max(0.0, 1 - busy / wall)
    nodes = graph_kernel_nodes(llm._graph.graph) if llm._graph else 0
    log(f"profile: {label} graphed: wall {wall:.2f} ms/step, device busy "
        f"{busy:.3f} ms/step, idle share {idle:.3f}, "
        f"{nodes} graph kernel nodes/step; "
        f"eager wall {walls['eager']:.2f} ms/step; trace {written} "
        f"({os.path.getsize(os.path.join(TRACE_DIR, written)) / 1e6:.1f} MB)")
    for e in kernels[:10]:
        log(f"  {_device_us(e) / PROFILED_STEPS:9.1f} us/step "
            f"{e.count / PROFILED_STEPS:5.1f} calls/step  {e.key[:70]}")
    return tokens, (wall, busy, idle)


def long_serve(torch, dev, lsh, label: str, expect_fn, batch: int,
               weight_quant: str = "none", check_frac=None):
    """`LLM("llama-3.2-1b")` at full width and depth with `batch` slots of
    bench.py's M (98304 tokens), each slot's state built by
    `synthetic_prefill` at bench.py's P (98000 tokens): 16 greedy steps
    (one eager, 15 replays), every launch held to `expect_fn(llm)`, the
    sampled or realized fraction checked, the graphed run held to the eager
    step bit for bit (the state rebuilt by the same synthetic_prefill),
    then a profiled pass through `utils/profiling`."""
    import dataclasses

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.runtime.synthetic import synthetic_prefill

    cfg = preset("llama-3.2-1b")
    if weight_quant != "none":
        cfg = dataclasses.replace(cfg, weight_quant=weight_quant,
                                  fuse_small_linears=True)
    torch.cuda.reset_peak_memory_stats()
    llm = LLM(cfg, batch_size=batch, max_length=LONG_M, lsh=lsh, device=dev,
              seed=1)
    nbytes = state_bytes(llm.state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    synthetic_prefill(llm, LONG_P, seed=11)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t
    log(f"serve {label}: B={batch}, state {nbytes / 1e9:.3f} GB, "
        f"synthetic_prefill of {LONG_P} tokens a slot {fill_s:.1f} s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    tokens = torch.randint(1, cfg.vocab_size, (batch,), generator=gen,
                           device=dev)
    decode = Decoder(llm)
    reset_launches()
    decode.record = []
    t = time.perf_counter()
    out, first_fracs = first_step_fractions(lambda: decode(tokens, 1))
    decode(out, 15)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / 16
    graphed = dict(record=decode.record, avg_sparsity=llm.avg_sparsity,
                   first_fracs=[float(f) for f in first_fracs])
    decode.record = None
    launches = dict(LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    expect.update(expect_fn(llm))
    log(f"serve {label}: decode B={batch} {decode_ms:.2f} ms/step over 16 "
        f"steps; avg sparsity {llm.avg_sparsity!r}; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launches {launches} != path's {expect}")
    if check_frac is not None:
        check_frac(llm.avg_sparsity)
    elif not 0 < llm.avg_sparsity < 1:
        raise AssertionError(f"avg sparsity {llm.avg_sparsity} not in (0, 1)")
    check_graphed(torch, llm, None, graphed, label,
                  refill=lambda: synthetic_prefill(llm, LONG_P, seed=11))
    del graphed
    tokens, profile = profile_decode_traced(torch, llm, decode, out,
                                            f"{label} decode B={batch}")
    if not bool(decode.finite):
        raise AssertionError(f"non-finite logits in the {label} serve")
    return dict(launches=launches, decode_ms=decode_ms, fill_s=fill_s,
                state_bytes=nbytes, profile=profile,
                avg_sparsity=llm.avg_sparsity)


LONG_BATCH = 8     # bench.py --max-batch


def phase_serve_long(torch, dev):
    """The 1B at MagicPIG's context length: bf16 LSH at K=10, L=150 (the
    main path's defaults), then bench.py's block_topk4 mode (W8A8 weights,
    packed int4 K, int8 V, a dense int8 layer 0; 16 of 192 blocks), B=8
    each."""
    import math

    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.runtime.state import offload_capacity

    def lsh_expect(llm):
        n = llm.config.num_hidden_layers
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        return dict(flash_decode=16 * n, lsh_fused_decode=16 * n_sparse)

    def block_topk4_expect(llm):
        n = llm.config.num_hidden_layers
        n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
        return dict(flash_decode=16 * n_sparse,
                    flash_decode_int8=16 * (n - n_sparse),
                    block_rank_int4=16 * n_sparse,
                    rescore_attend_int4=16 * n_sparse)

    bt4 = LSHConfig(K=1, L=0, estimator="block_topk", offload_quant="int4",
                    dense_quant="int8")
    off = LONG_P - 68                          # sink 4 and local 64 stay hot
    blocks = -(-offload_capacity(bt4, LONG_M) // 512)     # 192 at 98304
    want_frac = min(math.ceil(blocks * bt4.block_topk_budget_frac) * 512,
                    off) / off

    def check_frac(frac):
        if abs(frac - want_frac) > 1e-6:
            raise AssertionError(f"avg sparsity {frac} != {want_frac}")

    lsh_run = long_serve(torch, dev, LSHConfig(K=10, L=150), "98K LSH bf16",
                         lsh_expect, LONG_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    bt4 = long_serve(torch, dev, bt4,
                     "98K bench block_topk4 (W8A8, packed int4 K)",
                     block_topk4_expect, LONG_BATCH, weight_quant="int8",
                     check_frac=check_frac)
    gc.collect()
    torch.cuda.empty_cache()
    return lsh_run, bt4


SCHED_PROMPTS = (98000, 61000, 30000, 12000)
SCHED_CHUNK = 8192
SCHED_TOL = 5e-2    # of the largest |logit|: phase 4's bf16 limit


def scheduler_run(torch, dev, prompts, interleave: bool) -> dict:
    """One `Scheduler` serve of the 1B at full width and depth, B=2,
    max_length 98304, chunk_size 8192: the four prompts submitted at once,
    16 greedy tokens each. Records each request's first-token logits, its
    prefill time (the card synchronized around each prefill or chunk) and,
    at every token it gets, the gap of the top two logits over the largest
    |logit|; holds the launches to the path's and the engine to one graph
    capture."""
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.runtime.serving import Scheduler

    llm = LLM("llama-3.2-1b", batch_size=2, max_length=LONG_M,
              chunk_size=SCHED_CHUNK, device=dev, seed=0)
    sched = Scheduler(llm, interleave=interleave)
    rec = dict(first={}, margin={}, prefill_s={}, steps=0)
    prefill, start_prefill, inference = (llm.prefill, llm.start_prefill,
                                         llm.inference)

    def margins(logits):
        x = logits.float()
        top = x.topk(2, dim=-1).values
        return ((top[:, 0] - top[:, 1]) / x.abs().amax(-1)).tolist()

    def first(n, logits, dt):
        rec["first"][n] = logits.float()
        rec["margin"][n] = {0: margins(logits)[0]}
        rec["prefill_s"][n] = rec["prefill_s"].get(n, 0.0) + dt

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def timed_prefill(ids, request_id=0):
        logits, dt = timed(prefill, ids, request_id=request_id)
        first(ids.numel(), logits, dt)
        return logits

    def timed_start(ids, request_id=0):
        cp = start_prefill(ids, request_id)
        step = cp.step

        def timed_step():
            logits, dt = timed(step)
            if logits is None:
                rec["prefill_s"][cp.true_len] = (
                    rec["prefill_s"].get(cp.true_len, 0.0) + dt)
            else:
                first(cp.true_len, logits, dt)
            return logits
        cp.step = timed_step
        return cp

    def recorded_inference(tokens):
        logits = inference(tokens)
        m = margins(logits)
        for slot, req in sched.active.items():
            rec["margin"][req.prompt.numel()][len(req.generated)] = m[slot]
        rec["steps"] += 1
        return logits

    llm.prefill, llm.start_prefill = timed_prefill, timed_start
    llm.inference = recorded_inference
    for p in prompts:
        sched.submit(p, max_tokens=16)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    finished = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    n, steps = llm.config.num_hidden_layers, rec["steps"]
    n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
    chunks = sum(-(-p.numel() // SCHED_CHUNK) for p in prompts)
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_prefill=n * (chunks if interleave else len(prompts)),
                  flash_decode=n * steps, lsh_fused_decode=n_sparse * steps)
    tokens = {r.prompt.numel(): r.generated for r in finished}
    mode = "interleaved" if interleave else "synchronous"
    log(f"serve scheduler {mode}: {len(finished)} requests, {steps} decode "
        f"steps in {wall:.2f} s; prefill s by prompt "
        f"{ {k: round(v, 3) for k, v in rec['prefill_s'].items()} }; "
        f"{llm.graph_captures} graph capture(s); launches {launches}")
    if launches != expect:
        raise AssertionError(f"launches {launches} != path's {expect}")
    if llm.graph_captures != (dev.type == "cuda"):
        raise AssertionError(f"{llm.graph_captures} graph captures, not 1")
    if sorted(tokens) != sorted(p.numel() for p in prompts) or any(
            len(t) != 16 for t in tokens.values()):
        raise AssertionError(f"requests served {tokens}")
    if not all(bool(torch.isfinite(x).all()) for x in rec["first"].values()):
        raise AssertionError("non-finite first-token logits")
    return dict(rec, tokens=tokens, wall=wall, launches=launches,
                chunks=chunks)


def phase_serve_scheduler(torch, dev):
    """The `Scheduler` at MagicPIG's context length: four requests (98000,
    61000, 30000 and 12000 random tokens) over two slots, synchronous, then
    interleaved (one 8192-token chunk a step). Each request's first-token
    logits agree within `SCHED_TOL` of the largest |logit|, and its greedy
    tokens agree up to the first token whose synchronous top two logits lie
    within that limit of each other."""
    from magicpig_tpu_torch.config import preset

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    vocab = preset("llama-3.2-1b").vocab_size
    prompts = [torch.randint(1, vocab, (n,), generator=gen, device=dev)
               for n in SCHED_PROMPTS]
    runs = {}
    for interleave in (False, True):
        runs[interleave] = scheduler_run(torch, dev, prompts, interleave)
        gc.collect()
        torch.cuda.empty_cache()
    sync, inter = runs[False], runs[True]
    agree, report = 0, {}
    for n in SCHED_PROMPTS:
        a, b = inter["first"][n], sync["first"][n]
        err = float((a - b).abs().max() / b.abs().max())
        if err > SCHED_TOL:
            raise AssertionError(f"{n}-token request: first-token logits "
                                 f"differ by {err:.3e} of the largest")
        near = [i for i, m in sync["margin"][n].items() if m < SCHED_TOL]
        held = min(near, default=16)
        ts, ti = sync["tokens"][n], inter["tokens"][n]
        if ts[:held] != ti[:held]:
            raise AssertionError(f"{n}-token request: tokens {ts} != {ti} "
                                 f"before the first near tie ({held})")
        same = sum(x == y for x, y in zip(ts, ti))
        agree += same
        report[n] = dict(first_err=round(err, 5), held=held, equal=same)
    log(f"serve scheduler: synchronous vs interleaved per request "
        f"(first-token err of the largest |logit|, tokens held before the "
        f"first near tie, tokens equal of 16): {report}; {agree} of "
        f"{16 * len(SCHED_PROMPTS)} tokens equal")
    return dict(sync=sync, inter=inter, agree=agree, report=report)


IDLE_LAYERS = 16


def phase_serve_idle(torch, dev):
    """Idle slots under the graph: a `Scheduler` over four slots of the 1B
    (full width, `IDLE_LAYERS` layers) at max_length 4096 is fed four
    requests one at a time, 200 greedy tokens each, so slot 3 stays free
    (decoded with stale tokens) for 600 steps, past its 384-row hot cache.
    The graphed engine runs with no device assert, and every request's
    tokens equal those of an engine on the same weights that runs every
    step eagerly."""
    import dataclasses

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.ops.sampling import greedy_sample
    from magicpig_tpu_torch.runtime import state as state_lib
    from magicpig_tpu_torch.runtime.engine import LLM
    from magicpig_tpu_torch.runtime.serving import Scheduler

    cfg = dataclasses.replace(preset("llama-3.2-1b"),
                              num_hidden_layers=IDLE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    prompts = [torch.randint(1, cfg.vocab_size, (1000 + 100 * i,),
                             generator=gen, device=dev) for i in range(4)]

    def serve(llm):
        sched, idle = Scheduler(llm), None
        for i, p in enumerate(prompts):
            if i == 3:
                idle = int(llm.state.hot_len[3])
            sched.submit(p, max_tokens=200)
            sched.run()
        torch.cuda.synchronize()
        return ([r.generated for r in sched.finished],
                [r.slot for r in sched.finished], idle)

    graphed = LLM(cfg, batch_size=4, max_length=4096, device=dev, seed=2)
    t = time.perf_counter()
    tokens, slots, idle = serve(graphed)
    wall = time.perf_counter() - t
    eager = LLM(cfg, batch_size=4, max_length=4096, params=graphed.params,
                projections=graphed.projections, device=dev, seed=2)

    def eager_step(tokens):
        logits, frac = eager._decode(tokens)
        return logits, frac, greedy_sample(logits)

    eager._step = eager_step
    t = time.perf_counter()
    want, want_slots, _ = serve(eager)
    eager_wall = time.perf_counter() - t
    cap = state_lib.hot_capacity(graphed.lsh)
    log(f"serve idle slots: 4 requests one at a time over B=4, slots "
        f"{slots}, slot 3's hot length {idle} (hot capacity {cap}) when it "
        f"was admitted; graphed {wall:.1f} s ({graphed.graph_captures} "
        f"capture), eager {eager_wall:.1f} s; tokens equal "
        f"{tokens == want}")
    if slots != [0, 1, 2, 3] or want_slots != slots or not idle > cap:
        raise AssertionError(f"slots {slots}, idle hot length {idle}")
    if tokens != want or graphed.graph_captures != (dev.type == "cuda"):
        raise AssertionError("the graphed idle-slot serve differs from the "
                             "eager one")
    return dict(idle_hot=idle, wall=wall, eager_wall=eager_wall)


def phase_reference_chunked(torch, dev):
    """Chunked prefill (`start_prefill`, 512-token chunks: flash_prefill at
    a query offset over the staged K/V) on two-layer cuts at d = 64 (1B
    width) and d = 128 (the 8B's head shape, as `phase_reference_d128`)
    against the same engines on the CPU, then 2 steps of LSH at K=1, L=32
    (nearly every key sampled, so bf16 rounding cannot move the sample).
    Returns the d = 128 form's launches."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset

    counted = {}
    cfg128 = dataclasses.replace(preset("llama-3.1-8b"), hidden_size=1024,
                                 num_attention_heads=8, num_key_value_heads=2,
                                 intermediate_size=3584)
    for name, cfg in (("flash_prefill", None), ("flash_prefill_d128", cfg128)):
        card, host, launches = card_vs_cpu(
            torch, dev, LSHConfig(K=1, L=32, dense_layers=(0,)),
            f"chunked prefill {name}, LSH K=1/L=32", 1500, steps=2, cfg=cfg,
            chunk=512)
        want = dict.fromkeys(launches, 0)
        want.update({name: 2 * 3, name.replace("prefill", "decode"): 2 * 2,
                     "lsh_fused_decode" + name[len("flash_prefill"):]: 2})
        if launches != want:
            raise AssertionError(f"launches {launches} != path's {want}")
        counted[name] = launches[name]
        del card, host
    return counted


def card_vs_cpu(torch, dev, lsh, label: str, n_prompt: int = 1500,
                weight_quant: str = "none", steps: int = 4, cfg=None,
                chunk: int | None = None):
    """Two layers at 1B width (or `cfg`), layer 1 sparse: the card engine
    against the same engine on the CPU (the plain versions), prefill of an
    n_prompt token prompt (with `chunk`, `start_prefill` in chunks of that
    many tokens) and `steps` greedy steps. Returns (card engine, CPU
    engine, the card's launches in this run)."""
    import dataclasses

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = dataclasses.replace(cfg or preset("llama-3.2-1b"),
                              num_hidden_layers=2, weight_quant=weight_quant,
                              fuse_small_linears=weight_quant != "none")
    kw = {} if chunk is None else dict(chunk_size=chunk)
    card = LLM(cfg, batch_size=1, max_length=2048, lsh=lsh, device=dev,
               seed=3, **kw)
    host = LLM(cfg, batch_size=1, max_length=2048, lsh=lsh, device="cpu",
               params=card.params.to("cpu"),
               projections=card.projections.cpu(), **kw)
    prompt = torch.randint(1, cfg.vocab_size, (n_prompt,),
                           generator=torch.Generator().manual_seed(5))

    def prefill(llm):
        if chunk is None:
            return llm.prefill(prompt)
        cp = llm.start_prefill(prompt)
        while not cp.done:
            cp.step()
        return cp.logits

    reset_launches()
    a, b = prefill(card).cpu(), prefill(host)
    errs = [float((a - b).abs().max() / b.abs().max())]
    tok = b.argmax(-1)
    for _ in range(steps):
        a, b = card.inference(tok).cpu(), host.inference(tok)
        errs.append(float((a - b).abs().max() / b.abs().max()))
        tok = b.argmax(-1)
    launches = dict(LAUNCHES)
    log(f"reference: 2-layer {label} card vs CPU, max |logit err| / max "
        f"|logit| per call {['%.2e' % e for e in errs]}; sparsity card "
        f"{card.avg_sparsity:.4f} cpu {host.avg_sparsity:.4f}")
    # bf16 activations round differently on the two devices (2^-8 per
    # rounding); through two layers that stays well under 5%.
    if max(errs) > 5e-2:
        raise AssertionError("card engine disagrees with the CPU engine")
    return card, host, launches


def phase_reference(torch, dev):
    """LSH at K=1/L=32 (nearly all keys sampled), then block_topk with bf16
    offload (the store pipeline: exact_scores_ranked and block_attend), then
    LSH K=1/L=32 over int8 offload with a dense int8 layer and int4
    weights; each card engine against its CPU twin. block_topk attends every block
    here (3 hold the 1032 offloaded tokens, the 4th none, so the empty
    partial is exercised too): with half of them chosen, the two devices'
    bf16 activations ranked a different block first at 2 of 5 steps in
    one run and the logits then differed by 5.1e-2 and 5.9e-2."""
    from magicpig_tpu_torch.config import LSHConfig

    card, host, _ = card_vs_cpu(
        torch, dev, LSHConfig(K=1, L=32, dense_layers=(0,)), "K=1/L=32")
    if min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("K=1/L=32 should sample nearly every key")
    lsh = LSHConfig(estimator="block_topk", dense_layers=(0,),
                    block_topk_budget_frac=1.0)
    card, host, launches = card_vs_cpu(torch, dev, lsh,
                                          "block_topk bf16 offload", 1100)
    steps = 4
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_prefill=2, flash_decode=2 * steps,
                  exact_scores_ranked=steps, block_attend=steps)
    if launches != expect:
        raise AssertionError(f"launches {launches} != path's {expect}")
    if card.avg_sparsity != host.avg_sparsity:
        raise AssertionError("card and CPU realized fractions differ")
    # The quantized slice's three kernels: int4 fused weights, LSH over
    # int8 offload, a dense int8 layer 0; 2 steps (the CPU's int4 lm_head
    # takes about a second a step). Per step: flash decode int8 in
    # layer 0, the hot partial and the int8 LSH partial in layer 1, 4 int4
    # products a layer and the lm_head; the 1100-token prefill's products
    # take the dequantized weight, its last-token lm_head the kernel. At
    # K=1, L=32 nearly every key is sampled, as in the bf16 LSH cut: at
    # K=10, L=150 the two devices' bf16 activations flip a few SimHash
    # signs (sampled fractions 0.0232 and 0.0233 in one run), and the
    # debias weights of the few keys sampled on one device only moved the
    # decode logits by 0.13 of the largest; phase 2 holds the kernel at
    # K=10, L=150 on identical inputs, counts exact.
    lsh = LSHConfig(K=1, L=32, offload_quant="int8", dense_quant="int8",
                    dense_layers=(0,))
    steps = 2
    card, host, quant = card_vs_cpu(torch, dev, lsh, "int4 weights, int8 "
                                    "offload and dense K/V, K=1/L=32", 1100,
                                    weight_quant="int4", steps=steps)
    expect = dict.fromkeys(quant, 0)
    expect.update(flash_prefill=2, flash_decode=steps, flash_decode_int8=steps,
                  lsh_fused_decode_int8=steps, w4_matmul=steps * 9 + 1)
    if quant != expect:
        raise AssertionError(f"launches {quant} != path's {expect}")
    if min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("K=1/L=32 should sample nearly every key")
    del card, host
    return {**launches, **phase_reference_int4(torch, dev)}


def phase_reference_int4(torch, dev):
    """The int4 slice's cuts, 2 steps each: block_topk with packed int4 K on
    the store pipeline, every block attended (the packed scorer's stored
    token-order scores through the unchanged block_attend), and LSH at K=1,
    L=32 over int4-grid K with the polynomial debias, each card engine
    against its CPU twin; then the other debias forms of the fused kernel
    (bf16 poly, bf16 none, int8 none) on the card alone, launches counted
    and logits finite (phase 2 holds each against its plain version).
    Returns each kernel form's launches from the run of its path."""
    from magicpig_tpu_torch.config import LSHConfig

    steps, counted = 2, {}

    def expect(launches, **want):
        full = dict.fromkeys(launches, 0)
        full.update(flash_prefill=2, flash_decode=2 * steps, **want)
        if launches != full:
            raise AssertionError(f"launches {launches} != path's {full}")

    lsh = LSHConfig(estimator="block_topk", dense_layers=(0,),
                    block_topk_budget_frac=1.0, offload_quant="int4",
                    block_topk_pipeline="store")
    card, host, launches = card_vs_cpu(torch, dev, lsh, "block_topk packed "
                                       "int4 K, store pipeline", 1100,
                                       steps=steps)
    expect(launches, exact_scores_ranked_int4=steps, block_attend=steps)
    if card.avg_sparsity != host.avg_sparsity:
        raise AssertionError("card and CPU realized fractions differ")
    counted["exact_scores_ranked_int4"] = launches["exact_scores_ranked_int4"]
    lsh = LSHConfig(K=1, L=32, offload_quant="int4", lsh_debias="poly",
                    dense_layers=(0,))
    card, host, launches = card_vs_cpu(torch, dev, lsh, "LSH K=1/L=32, int4 "
                                       "K, poly debias", 1100, steps=steps)
    expect(launches, lsh_fused_decode_int8_poly=steps)
    if min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("K=1/L=32 should sample nearly every key")
    counted["lsh_fused_decode_int8_poly"] = steps
    del card, host
    for offload, debias in (("none", "poly"), ("none", "none"),
                            ("int8", "none")):
        lsh = LSHConfig(K=10, L=150, offload_quant=offload,
                        lsh_debias=debias, dense_layers=(0,))
        name = ("lsh_fused_decode" + ("_int8" if offload == "int8" else "")
                + f"_{debias}")
        launches = card_counted(torch, dev, lsh, f"LSH {offload} offload, "
                                f"{debias} debias", steps)
        expect(launches, **{name: steps})
        counted[name] = steps
    return counted


def phase_reference_two_stage(torch, dev):
    """The two-stage slice's cuts, 2 steps each: the sampled mode at K=1,
    L=32, where nearly every one of the 1032 offloaded keys is sampled and
    the 128-id budget truncates (equal masks give equal ids), and the
    masked mode at K=1, L=31 (odd: the scan and the masked attend) over
    int8 offload with the poly debias, each card engine against its CPU
    twin; then the other forms of the masked attend at K=8, L=75 (bf16
    poly and none, int8 exact and none) on the card alone, launches
    counted and logits finite (the bf16 exact form runs in phase 3's odd-L
    serve; phase 2 holds each form against its plain version). Returns
    each kernel form's launches from the run of its path."""
    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.ops.kernels.lsh_masked import launch_name

    steps, counted = 2, {}

    def expect(launches, **want):
        full = dict.fromkeys(launches, 0)
        full.update(flash_prefill=2, flash_decode=2 * steps,
                    collision_words=steps, **want)
        if launches != full:
            raise AssertionError(f"launches {launches} != path's {full}")

    lsh = LSHConfig(K=1, L=32, decode_mode="sampled", dense_layers=(0,))
    card, host, launches = card_vs_cpu(torch, dev, lsh, "sampled K=1/L=32, "
                                       "the budget truncating", 1100,
                                       steps=steps)
    expect(launches)
    if lsh.sample_budget(card.state.off_k[0].shape[2]) != 128:
        raise AssertionError("the sampled cut's budget is not 128")
    if min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("K=1/L=32 should sample nearly every key")
    lsh = LSHConfig(K=1, L=31, offload_quant="int8", lsh_debias="poly",
                    dense_layers=(0,))
    card, host, launches = card_vs_cpu(torch, dev, lsh, "masked K=1/L=31, "
                                       "int8 offload, poly debias", 1100,
                                       steps=steps)
    expect(launches, lsh_masked_attention_int8_poly=steps)
    if min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("K=1/L=31 should sample nearly every key")
    counted["lsh_masked_attention_int8_poly"] = steps
    del card, host
    for offload, debias in (("none", "poly"), ("none", "none"),
                            ("int8", "exact"), ("int8", "none")):
        lsh = LSHConfig(K=8, L=75, offload_quant=offload, lsh_debias=debias,
                        dense_layers=(0,))
        name = launch_name(offload == "int8", debias)
        launches = card_counted(torch, dev, lsh, f"LSH K=8/L=75, {offload} "
                                f"offload, {debias} debias", steps)
        expect(launches, **{name: steps})
        counted[name] = steps
    return counted


def phase_reference_d128(torch, dev):
    """The d = 128 forms that no 8B serve runs, on a narrow two-layer config
    with Llama-3.1-8B's head shape (hidden 1024, 8/2 heads of 128,
    intermediate 3584, vocab 128256; layer 0 dense, layer 1 sparse), 2
    steps each: against the CPU twin, block_topk on the store pipeline over
    bf16 and over packed int4 K (every block attended), LSH K=1, L=32 over
    int8 offload with the poly debias and over bf16 with none; on the card
    alone (launches counted, logits finite; phase 2 holds each kernel
    against its plain version), the bf16 poly and int8 none LSH forms at
    K=10, L=150, block_topk over int8 K (the rescore pipeline) and the
    masked attend's forms at K=8, L=75 that no 8B serve runs (bf16 poly and
    none, int8 exact, poly and none). Returns each form's launches from the
    run of its path."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.ops.kernels.lsh_masked import launch_name

    cfg = dataclasses.replace(preset("llama-3.1-8b"), hidden_size=1024,
                              num_attention_heads=8, num_key_value_heads=2,
                              intermediate_size=3584)
    steps, counted = 2, {}

    def expect(launches, **want):
        full = dict.fromkeys(launches, 0)
        full.update(flash_prefill_d128=2, flash_decode_d128=2 * steps,
                    **{name: steps for name in want})
        if launches != full:
            raise AssertionError(f"launches {launches} != path's {full}")
        counted.update({name: steps for name in want})

    for label, lsh, forms, sparse in (
            ("block_topk bf16, store pipeline",
             LSHConfig(estimator="block_topk", dense_layers=(0,),
                       block_topk_budget_frac=1.0),
             ("exact_scores_ranked_d128", "block_attend_d128"), False),
            ("block_topk packed int4 K, store pipeline",
             LSHConfig(estimator="block_topk", dense_layers=(0,),
                       block_topk_budget_frac=1.0, offload_quant="int4",
                       block_topk_pipeline="store"),
             ("exact_scores_ranked_int4_d128", "block_attend_d128"), False),
            ("LSH K=1/L=32, int8 offload, poly debias",
             LSHConfig(K=1, L=32, offload_quant="int8", lsh_debias="poly",
                       dense_layers=(0,)),
             ("lsh_fused_decode_int8_poly_d128",), True),
            ("LSH K=1/L=32, bf16, none debias",
             LSHConfig(K=1, L=32, lsh_debias="none", dense_layers=(0,)),
             ("lsh_fused_decode_none_d128",), True)):
        card, host, launches = card_vs_cpu(torch, dev, lsh, f"d128 {label}",
                                           1100, steps=steps, cfg=cfg)
        expect(launches, **dict.fromkeys(forms))
        if sparse and min(card.avg_sparsity, host.avg_sparsity) < 0.9:
            raise AssertionError("K=1/L=32 should sample nearly every key")
        if not sparse and card.avg_sparsity != host.avg_sparsity:
            raise AssertionError("card and CPU realized fractions differ")
        del card, host
    for label, lsh, form in (
            ("LSH bf16, poly debias",
             LSHConfig(K=10, L=150, lsh_debias="poly", dense_layers=(0,)),
             "lsh_fused_decode_poly_d128"),
            ("LSH int8 offload, none debias",
             LSHConfig(K=10, L=150, offload_quant="int8", lsh_debias="none",
                       dense_layers=(0,)),
             "lsh_fused_decode_int8_none_d128")):
        expect(card_counted(torch, dev, lsh, f"d128 {label}", steps, cfg=cfg),
               **{form: None})
    launches = card_counted(
        torch, dev, LSHConfig(estimator="block_topk", offload_quant="int8",
                              dense_layers=(0,)),
        "d128 block_topk int8 offload, rescore pipeline", steps, cfg=cfg)
    expect(launches, block_rank_d128=None, rescore_attend_d128=None)
    for offload, debias in (("none", "poly"), ("none", "none"),
                            ("int8", "exact"), ("int8", "poly"),
                            ("int8", "none")):
        lsh = LSHConfig(K=8, L=75, offload_quant=offload, lsh_debias=debias,
                        dense_layers=(0,))
        form = launch_name(offload == "int8", debias, 128)
        launches = card_counted(torch, dev, lsh, f"d128 LSH K=8/L=75, "
                                f"{offload} offload, {debias} debias", steps,
                                cfg=cfg)
        scan = launches.pop("collision_words")
        if scan != steps:
            raise AssertionError(f"collision_words {scan} != {steps}")
        expect(launches, **{form: None})
    return counted


def phase_reference_g3(torch, dev):
    """The G = 3 forms on a narrow two-layer config with Llama-3.2-3B's head
    shape (hidden 768, 6/2 heads of 128, intermediate 2048, vocab 128256;
    layer 0 dense, layer 1 sparse), 2 steps each: against the CPU twin, odd
    L (K=1, L=31) over int8 offload with the poly debias (the scan and the
    int8 masked attend), the sampled mode at K=1, L=32 (the scan), and
    block_topk on the store pipeline over bf16 and over packed int4 K
    (every block attended); on the card alone (launches counted, logits
    finite; phase 2 holds each kernel against its plain version),
    block_topk over int8 K (the rescore pipeline), `bench.py`'s block_topk4
    (packed int4 K, int8 V, a dense int8 layer 0: the packed scorer and
    rescore, the int8 decode), LSH K=10, L=150 over int8 offload (the fused
    kernel's int8 form) and odd L (K=8, L=75) over bf16 (the masked
    attend's bf16 exact form). Returns each form's launches from the run of
    its path."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset

    cfg = dataclasses.replace(preset("llama-3.2-3b"), hidden_size=768,
                              num_attention_heads=6, num_key_value_heads=2,
                              intermediate_size=2048)
    steps, counted = 2, {}

    def expect(launches, dense="flash_decode_d128", **want):
        full = dict.fromkeys(launches, 0)
        full.update(flash_prefill_d128=2, flash_decode_d128=steps)
        full[dense] += steps
        full.update({name: steps for name in want})
        if launches != full:
            raise AssertionError(f"launches {launches} != path's {full}")
        counted.update({name: steps for name in want})
        counted.setdefault(dense, steps)

    for label, lsh, forms, sparse in (
            ("odd L K=1/L=31, int8 offload, poly debias",
             LSHConfig(K=1, L=31, offload_quant="int8", lsh_debias="poly",
                       dense_layers=(0,)),
             ("collision_words", "lsh_masked_attention_int8_poly_d128"), True),
            ("sampled K=1/L=32",
             LSHConfig(K=1, L=32, decode_mode="sampled", dense_layers=(0,)),
             ("collision_words",), True),
            ("block_topk bf16, store pipeline",
             LSHConfig(estimator="block_topk", dense_layers=(0,),
                       block_topk_budget_frac=1.0),
             ("exact_scores_ranked_d128", "block_attend_d128"), False),
            ("block_topk packed int4 K, store pipeline",
             LSHConfig(estimator="block_topk", dense_layers=(0,),
                       block_topk_budget_frac=1.0, offload_quant="int4",
                       block_topk_pipeline="store"),
             ("exact_scores_ranked_int4_d128", "block_attend_d128"), False)):
        card, host, launches = card_vs_cpu(torch, dev, lsh, f"g3 {label}",
                                           1100, steps=steps, cfg=cfg)
        expect(launches, **dict.fromkeys(forms))
        if sparse and min(card.avg_sparsity, host.avg_sparsity) < 0.9:
            raise AssertionError("K=1 should sample nearly every key")
        if not sparse and card.avg_sparsity != host.avg_sparsity:
            raise AssertionError("card and CPU realized fractions differ")
        del card, host
    for label, lsh, dense, forms in (
            ("block_topk int8 offload, rescore pipeline",
             LSHConfig(estimator="block_topk", offload_quant="int8",
                       dense_layers=(0,)),
             "flash_decode_d128", ("block_rank_d128", "rescore_attend_d128")),
            ("bench block_topk4 (packed int4 K, dense int8 layer 0)",
             LSHConfig(K=1, L=0, estimator="block_topk", offload_quant="int4",
                       dense_quant="int8", dense_layers=(0,)),
             "flash_decode_int8_d128",
             ("block_rank_int4_d128", "rescore_attend_int4_d128")),
            ("LSH K=10/L=150, int8 offload",
             LSHConfig(K=10, L=150, offload_quant="int8", dense_layers=(0,)),
             "flash_decode_d128", ("lsh_fused_decode_int8_d128",)),
            ("odd L K=8/L=75, bf16",
             LSHConfig(K=8, L=75, dense_layers=(0,)),
             "flash_decode_d128",
             ("collision_words", "lsh_masked_attention_d128"))):
        expect(card_counted(torch, dev, lsh, f"g3 {label}", steps, cfg=cfg),
               dense, **dict.fromkeys(forms))
    return counted


def phase_reference_forms(torch, dev):
    """The small head dims against the CPU: llama-tiny (hidden 128, 8/2
    heads of 16, intermediate 256, vocab 512) and the same model at head
    dim 32, each cut to two layers (layer 0 dense, layer 1 sparse), 2 steps
    each on a 1100-token prompt: LSH K=1, L=32 (the fused kernel), odd L
    (K=1, L=31: the scan and the masked attend), the sampled mode (K=1, L=32:
    the scan) and block_topk over int8 offload with every block attended
    (the rescore pipeline's scorer and attend), logits within phase 4's 5e-2
    of the CPU engine's, launches counted (the "_d16" / "_d32" forms).
    Returns each form's launches from the run of its path."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset

    steps, counted = 2, {}
    for d in (16, 32):
        cfg = dataclasses.replace(preset("llama-tiny"), head_dim=d)
        sfx = f"_d{d}"

        def expect(launches, *forms):
            full = dict.fromkeys(launches, 0)
            full.update({"flash_prefill" + sfx: 2,
                         "flash_decode" + sfx: 2 * steps})
            full.update({name: steps for name in forms})
            if launches != full:
                raise AssertionError(f"launches {launches} != path's {full}")
            counted.update({name: steps for name in forms})
            counted.update({"flash_prefill" + sfx: 2,
                            "flash_decode" + sfx: 2 * steps})

        for label, lsh, forms, sparse in (
                ("LSH K=1/L=32", LSHConfig(K=1, L=32, dense_layers=(0,)),
                 ("lsh_fused_decode" + sfx,), True),
                ("odd L K=1/L=31", LSHConfig(K=1, L=31, dense_layers=(0,)),
                 ("collision_words", "lsh_masked_attention" + sfx), True),
                ("sampled K=1/L=32",
                 LSHConfig(K=1, L=32, decode_mode="sampled",
                           dense_layers=(0,)), ("collision_words",), True),
                ("block_topk int8, rescore pipeline",
                 LSHConfig(estimator="block_topk", offload_quant="int8",
                           dense_layers=(0,), block_topk_budget_frac=1.0),
                 ("block_rank" + sfx, "rescore_attend" + sfx), False)):
            card, host, launches = card_vs_cpu(
                torch, dev, lsh, f"d{d} {label}", 1100, steps=steps, cfg=cfg)
            expect(launches, *forms)
            if sparse and min(card.avg_sparsity, host.avg_sparsity) < 0.9:
                raise AssertionError("K=1 should sample nearly every key")
            if not sparse and card.avg_sparsity != host.avg_sparsity:
                raise AssertionError("card and CPU realized fractions differ")
            del card, host
    return counted


def phase_reference_window(torch, dev):
    """Sliding-window cuts against the CPU: two layers at Mistral-7B-v0.1's
    head shape cut narrow (hidden 1024, 8/2 heads of 128, intermediate
    3584, vocab 32000) with a window of 512 tokens (the hot capacity is
    384), 4 steps each: LSH K=1, L=32 over a 510-token prompt, whose
    position crosses the window at the third step (the dense layer's first
    row and the sinks' aging move under the replayed graph); the same over
    int8 offload and a dense int8 layer on a 1500-token prompt (the offload
    clipped to 448 rows; flash decode's int8 form with a first row); and
    chunked prefill (512-token chunks, each chunk's queries windowed) of
    the 1500-token prompt. Launches counted exactly. Returns the int8
    form's launches with a window, from its cut."""
    from magicpig_tpu_torch.config import LSHConfig

    cfg = mistral_config(hidden_size=1024, intermediate_size=3584,
                         num_attention_heads=8, num_key_value_heads=2,
                         sliding_window=512)
    steps = 4

    def expect(launches, label, prefills=2, **want):
        full = dict.fromkeys(launches, 0)
        full.update(flash_prefill_d128=prefills, **want)
        if launches != full:
            raise AssertionError(f"{label}: launches {launches} != path's "
                                 f"{full}")

    lsh = LSHConfig(K=1, L=32, dense_layers=(0,))
    label = "window 512 LSH K=1/L=32, crossing the window"
    card, host, launches = card_vs_cpu(torch, dev, lsh, label, 510,
                                       steps=steps, cfg=cfg)
    expect(launches, label, flash_decode_d128=2 * steps,
           lsh_fused_decode_d128=steps)
    if card.state.pos.tolist() != [514]:
        raise AssertionError(f"{label}: position {card.state.pos.tolist()}")
    lsh = LSHConfig(K=1, L=32, dense_layers=(0,), offload_quant="int8",
                    dense_quant="int8")
    label = "window 512 LSH K=1/L=32, int8 offload and dense"
    card, host, launches = card_vs_cpu(torch, dev, lsh, label, 1500,
                                       steps=steps, cfg=cfg)
    expect(launches, label, flash_decode_d128=steps,
           flash_decode_int8_d128=steps, lsh_fused_decode_int8_d128=steps)
    counted = {"flash_decode_int8_d128": launches["flash_decode_int8_d128"]}
    if card.state.off_len.tolist() != [448]:
        raise AssertionError(f"{label}: offload {card.state.off_len.tolist()}")
    lsh = LSHConfig(K=1, L=32, dense_layers=(0,))
    label = "window 512 LSH K=1/L=32, chunked prefill"
    card, host, launches = card_vs_cpu(torch, dev, lsh, label, 1500,
                                       steps=steps, cfg=cfg, chunk=512)
    expect(launches, label, prefills=3 * 2, flash_decode_d128=2 * steps,
           lsh_fused_decode_d128=steps)
    return counted


def recorded_layers(run):
    """`run()` with the attention output of layer 1 (f32, before the bf16
    cast) of each decode step recorded: the dense layer's of a K=0 engine,
    the sparse layer's otherwise. Returns (what `run` returned, the
    outputs). Only eager steps call the wrapped functions."""
    from magicpig_tpu_torch.runtime import engine

    dense, sparse, outs = (engine.decode_dense_layer,
                           engine.decode_sparse_layer, [])

    def rec_dense(state, di, *args, **kwargs):
        out = dense(state, di, *args, **kwargs)
        if di == 1:
            outs.append(out.clone())
        return out

    def rec_sparse(*args, **kwargs):
        out, frac = sparse(*args, **kwargs)
        outs.append(out.clone())
        return out, frac

    engine.decode_dense_layer, engine.decode_sparse_layer = rec_dense, rec_sparse
    try:
        result = run()
    finally:
        engine.decode_dense_layer, engine.decode_sparse_layer = dense, sparse
    return result, outs


def drop_top_token():
    """The planted fault of phase 4's baseline cuts, as a context: the
    highest-scoring offload token of every head dropped from TopK's and
    Quest's masks (`baselines._masked_softmax_wv`) and from oracle
    sampling's draws (`baselines.sample_ids`)."""
    import contextlib

    import torch

    from magicpig_tpu_torch.ops import baselines

    @contextlib.contextmanager
    def planted():
        softmax_wv, sample_ids = baselines._masked_softmax_wv, baselines.sample_ids

        def faulty_softmax_wv(scores, mask, v):
            top = torch.where(mask, scores, -torch.inf).argmax(-1, keepdim=True)
            return softmax_wv(scores, mask.scatter(-1, top, False), v)

        def faulty_sample_ids(scores, u):
            top = scores.argmax(-1, keepdim=True)
            return sample_ids(scores.scatter(-1, top, -torch.inf), u)

        baselines._masked_softmax_wv = faulty_softmax_wv
        baselines.sample_ids = faulty_sample_ids
        try:
            yield
        finally:
            baselines._masked_softmax_wv = softmax_wv
            baselines.sample_ids = sample_ids

    return planted()


BASELINE_CUT_STEPS = 4
BASELINE_LAYER_TOL = {"topk": 2e-3, "quest": 2e-3, "oracle_sampling": 0.15}


def phase_reference_baselines(torch, dev):
    """The reference's baselines on two layers with Llama-3.1-8B's head
    shape (hidden 1024, 8/2 heads of 128, intermediate 3584, vocab 128256;
    `dense_layers=(0,)`, so layer 1 is sparse), 1100-token prompts.

    At full budget (TopK and Quest 1.0, every offloaded token attended;
    OracleSampling 8.0, 2048 draws) each engine against the K=0 engine on
    the card with the same weights, fed the K=0 engine's greedy tokens for
    4 eager steps: layer 0 is dense in both, so layer 1's inputs are the
    same bit for bit, and its attention output (f32, before the bf16 cast)
    must stay within 2e-3 of its largest |value| (0.15 for oracle
    sampling; tests/test_engine.py:170-200 holds the logits so in f32).
    The bf16 logits follow within 5e-2 of the largest (0.15): from there on
    every activation is rounded to bf16, which alone parts them by ~5e-3.
    Layer 1's query weight is scaled by 4, so that each head attends a few
    keys and the planted fault (`drop_top_token`) moves the layer past each
    tolerance, as it must. Then at the default budgets (41 TopK tokens, 6
    Quest pages of a 2048-token capacity) the sparse choice of a card
    engine's first step, on its own inputs (the offload state after the
    prefill, the step's query) on the card and on the CPU: the TopK and
    Quest masks equal, as phase 2 holds block_topk's choice. (A CPU twin
    computes its own bf16 activations, and its Quest pages part from the
    card's near a tie: its first step's logits differed by 4.97e-2 of the
    largest, on the edge of phase 4's 5e-2.) Returns nothing; any failure
    raises."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.ops import baselines
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime import engine, server
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = dataclasses.replace(preset("llama-3.1-8b"), num_hidden_layers=2,
                              hidden_size=1024, num_attention_heads=8,
                              num_key_value_heads=2, intermediate_size=3584)
    prompt = torch.randint(1, cfg.vocab_size, (1100,),
                           generator=torch.Generator().manual_seed(5))
    steps = BASELINE_CUT_STEPS

    def eager_run(llm, tokens=None):
        """Prefill and `steps` eager steps (the K=0 engine's greedy tokens
        when `tokens` is None): (tokens fed, logits, layer-1 outputs, the
        steps' realized fractions)."""
        def run():
            logits, fracs = [llm.prefill(prompt)], []
            fed = [logits[0].argmax(-1)] if tokens is None else tokens
            for i in range(steps):
                llm._guard_decode(1)
                out, frac = llm._decode(fed[i])
                logits.append(out)
                fracs.append(float(frac))
                if tokens is None:
                    fed.append(logits[-1].argmax(-1))
            return fed[:steps], logits[1:], fracs
        (fed, logits, fracs), outs = recorded_layers(run)
        return fed, logits, outs, fracs

    def rel(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    full = LLM(cfg, max_length=2048, lsh=LSHConfig(K=0, L=0), device=dev,
               seed=3)
    params = full.params
    params.layers.wq[1] *= 4
    tokens, full_logits, full_outs, _ = eager_run(full)
    for estimator, kw in (("topk", dict(topk_budget_frac=1.0)),
                          ("quest", dict(quest_budget_frac=1.0)),
                          ("oracle_sampling", dict(os_budget_frac=8.0))):
        lsh = LSHConfig(estimator=estimator, dense_layers=(0,), **kw)
        tol = BASELINE_LAYER_TOL[estimator]
        logit_tol = max(5e-2, tol)
        errs = {}
        for fault in (False, True):
            llm = LLM(cfg, max_length=2048, lsh=lsh, params=params, device=dev)
            reset_launches()
            if fault:
                with drop_top_token():
                    _, logits, outs, fracs = eager_run(llm, tokens)
            else:
                _, logits, outs, fracs = eager_run(llm, tokens)
                expect = dict.fromkeys(LAUNCHES, 0)
                expect.update(flash_prefill_d128=2, flash_decode_d128=2 * steps)
                if dict(LAUNCHES) != expect:
                    raise AssertionError(f"{estimator}: launches "
                                         f"{dict(LAUNCHES)} != {expect}")
            errs[fault] = (rel(outs, full_outs), rel(logits, full_logits),
                           fracs)
            del llm
        (layer, logit, frac), (layer_f, logit_f, _) = errs[False], errs[True]
        log(f"reference: 2-layer d128 {estimator} at full budget vs the K=0 "
            f"engine on the card: layer 1 max |err| / max |out| {layer:.2e} "
            f"(tolerance {tol:g}), logits {logit:.2e} ({logit_tol:g}); "
            f"realized fractions {frac}; the top token of every head "
            f"dropped: layer {layer_f:.2e}, logits {logit_f:.2e}")
        if not (layer < tol and logit < logit_tol and frac == [1.0] * steps):
            raise AssertionError(f"{estimator} at full budget does not track "
                                 "the K=0 engine")
        if not (layer_f > tol and logit_f > logit_tol):
            raise AssertionError(f"{estimator}: the tolerance does not reject "
                                 "the dropped top token")
    del full, params
    gc.collect()

    for estimator in ("topk", "quest"):
        lsh = LSHConfig(estimator=estimator, dense_layers=(0,))
        inner, queries = engine.decode_sparse_layer, []

        def recording(state, si, q, *args, inner=inner, queries=queries,
                      **kwargs):
            queries.append(q.clone())
            return inner(state, si, q, *args, **kwargs)

        engine.decode_sparse_layer = recording
        try:
            card = LLM(cfg, max_length=2048, lsh=lsh, device=dev, seed=3)
            reset_launches()
            logits = card.inference(card.prefill(prompt).argmax(-1))
        finally:
            engine.decode_sparse_layer = inner
        expect = dict.fromkeys(LAUNCHES, 0)
        expect.update(flash_prefill_d128=2, flash_decode_d128=2)
        if dict(LAUNCHES) != expect or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"launches {dict(LAUNCHES)} != path's "
                                 f"{expect}, or non-finite logits")
        st, q = card.state, queries[0]     # the first, eager step
        off_cap = st.off_v[0].shape[2]
        if estimator == "topk":
            n = server._static_budget(off_cap, lsh.topk_budget_frac, floor=16)

            def select(q, st):
                k, _ = server._off_kv(st, 0, lsh)
                return baselines.topk_select(
                    baselines.masked_scores(q, k, st.off_len), n)
        else:
            page = lsh.quest_page_size
            n = server._static_budget(off_cap // page, lsh.quest_budget_frac,
                                      floor=1)

            def select(q, st):
                return baselines.quest_select(q, st.quest_min[0],
                                              st.quest_max[0], st.off_len,
                                              page, n, off_cap)
        on_card = select(q, st).cpu()
        on_host = select(q.cpu(), dataclasses.replace(st, **{
            f.name: (getattr(st, f.name).cpu()
                     if isinstance(getattr(st, f.name), torch.Tensor)
                     else [t.cpu() for t in getattr(st, f.name)])
            for f in dataclasses.fields(st)}))
        log(f"reference: 2-layer d128 {estimator} default budget ({n} "
            f"{'tokens' if estimator == 'topk' else 'pages'}): the card "
            f"chose {int(on_card.sum())} (head, token) pairs, the CPU on the "
            f"same inputs {int(on_host.sum())}, equal {torch.equal(on_card, on_host)}")
        if not torch.equal(on_card, on_host):
            raise AssertionError(f"{estimator}: the card's sparse choice is "
                                 "not the CPU's")
        del card


def card_counted(torch, dev, lsh, label: str, steps: int, cfg=None) -> dict:
    """Two layers at 1B width (or `cfg`) on the card alone, layer 1 sparse:
    a 1100-token prefill and `steps` greedy steps, finite logits. Returns
    the launches of this run."""
    import dataclasses

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = dataclasses.replace(cfg or preset("llama-3.2-1b"),
                              num_hidden_layers=2)
    card = LLM(cfg, batch_size=1, max_length=2048, lsh=lsh, device=dev, seed=3)
    prompt = torch.randint(1, cfg.vocab_size, (1100,),
                           generator=torch.Generator().manual_seed(5))
    reset_launches()
    logits = card.prefill(prompt)
    finite = torch.isfinite(logits).all()
    for _ in range(steps):
        logits = card.inference(logits.argmax(-1))
        finite = finite & torch.isfinite(logits).all()
    launches = dict(LAUNCHES)
    if not bool(finite):
        raise AssertionError(f"non-finite logits, {label}")
    log(f"reference: 2-layer {label} on the card, {steps} steps, sparsity "
        f"{card.avg_sparsity:.4f}, logits finite")
    return launches


# -- phase 3b: multi-GPU serving over torch.distributed ------------------------

# The sharded engines against the unsharded one on the card. A row-split
# product sums bf16 partials (rounded once more than the whole product), so
# the prefill logits, through dense flash attention, move smoothly: 1.8e-2
# to 2.1e-2 of the largest |logit| (8B at 1 x 2, the 1B at 2 x 2, under
# LSH and block_topk4), held to phase 4's bf16 limit SHARD_TOL. A sparse
# decode step at K=10, L=150 or under block_topk4 is not smooth in its
# inputs: a key's SimHash sign, or a block's rank, flips on a rounding
# difference, and the step attends another set of keys (the sampled
# fraction moves by 2e-3 relative); its logits stay correlated with the
# unsharded step's, 0.16-0.29 relative L2 error, where an unrelated state
# gives ~1-1.4 (the planted ring faults): SHARD_DECODE_TOL bounds that, a
# guard that a fault of one all-reduce can pass. The decode path itself
# (the decode-time row-split sums, the vocabulary and batch gathers, the
# fraction's reduction, the int4 kernel's split products) is held by the
# smooth runs: LSH at K=1, L=32 (SMOOTH_LSH: nearly every key collides in
# two of the 32 tables, so a rounding flip moves no key's weight much, as
# in phase 4's K=1, L=32 cuts), every prefill and decode step within
# SHARD_TOL, with an all-reduce skipped at the first decode step as their
# planted fault. Each planted fault must fail its run's bounds.
SHARD_TOL = 5e-2        # prefill (and smooth decode) logits: max |diff| / max
SHARD_DECODE_TOL = 0.5  # each sparse decode step's logits: relative L2 error
SHARD_FRAC_TOL = 0.05   # of the unsharded sampled fraction
SMOOTH_LSH = dict(K=1, L=32)
SHARD_STEPS_1X1 = 16
SHARD_STEPS_8B = 8
RING_PROMPTS = (8192, 6144)
RING_STEPS = 8
BT4_STEPS = 4
SMOOTH_STEPS = 4
# The smooth runs' prompts: a prefill is most of a gloo run's time (gloo
# stages every all-reduce through the host), and decode is what they hold.
SMOOTH_PROMPT = 2048                # the 8B at 1 x 2
SMOOTH_PROMPTS = (4096, 3072)       # the 1B with int4 weights at 2 x 2
FAULT_STEPS = 2
RANKS_SHARE = "ranks share one H100"
# The all-reduce rank 1 skips: layer 1's down_proj, of the prefill's first
# prompt ("skip_sum") or of the first decode step ("skip_sum_decode").
SKIP_CALL = 3


def shard_collective_share(kernels) -> tuple:
    """(device busy ms, the collectives' device ms): NCCL's kernels, or
    under gloo the host-staging copies of its collectives."""
    busy = sum(map(_device_us, kernels)) / 1e3
    coll = sum(_device_us(e) for e in kernels
               if "nccl" in e.key.lower() or e.key.startswith("Memcpy"))
    return busy, coll / 1e3


def ring_live_pairs(n: int, rank: int) -> int:
    """The (query chunk, key chunk) pairs of a zigzag ring that are not
    wholly in the future (the flash-prefill launches of one layer)."""
    def start(r, h):
        return r if h == 0 else 2 * n - 1 - r
    return sum(start(rank, qi) >= start((rank - t) % n, ki)
               for t in range(n) for qi in range(2) for ki in range(2))


def shard_error(got, want) -> float:
    """max |got - want| over the largest |want| (numpy arrays)."""
    import numpy as np
    return float(np.abs(got - want).max() / np.abs(want).max())


def shard_errors(pre, logits, ref) -> dict:
    """Per stage (the prefill logits, each step's) the max-abs error over
    the largest |logit| and the relative L2 error, against `ref`."""
    import numpy as np

    def l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    want = ref["logits"][:len(logits)]
    return dict(
        max=[shard_error(pre, ref["prefill"])]
        + [shard_error(g, w) for g, w in zip(logits, want)],
        l2=[l2(pre, ref["prefill"])] + [l2(g, w) for g, w in zip(logits, want)])


def unsharded_reference(torch, dev, cfg, lsh, prompt_lens, seed: int,
                        steps: int, batch: int, max_length: int, label: str,
                        n_model: int = 2, local: bool = True):
    """The unsharded engine on the card: the prompts (drawn on the card
    from `seed`) prefilled, `steps` greedy steps; returns the prompts' and
    steps' logits (host f32), the tokens fed at each step, the mean
    sampled fraction and the step wall time."""
    import numpy as np
    from magicpig_tpu_torch.runtime.engine import LLM

    llm = LLM(cfg, batch_size=batch, max_length=max_length, lsh=lsh,
              device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                             device=dev) for n in prompt_lens]
    pre = [llm.prefill(p, request_id=r)[0].float().cpu().numpy()
           for r, p in enumerate(prompts)]
    local = local_heads_check(torch, llm, n_model, label) if local else None
    tok = torch.stack([torch.tensor(int(np.argmax(x))) for x in pre]).to(dev)
    tok = tok.reshape(-1).repeat(batch // len(prompts))
    snap = llm.sparsity_snapshot()
    fed, logits = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        fed.append(tok.cpu().numpy())
        out = llm.inference(tok)
        logits.append(out.float().cpu().numpy())
        tok = out.argmax(-1)
    wall = (time.perf_counter() - t) * 1e3 / steps
    frac = llm.avg_sparsity_since(snap)
    log(f"sharded {label}: unsharded reference on the card, prefill "
        f"{' + '.join(map(str, prompt_lens))} tokens, {steps} steps "
        f"{wall:.2f} ms/step, avg sparsity {frac:.6f}")
    del llm, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill=np.stack(pre), logits=np.stack(logits),
                tokens=np.stack(fed), frac=frac, wall=wall, local=local)


# Of the largest |output|: phase 2's decode-kernel tolerance. A slice's
# flash decode picks its split from its head count, and each split's P
# enters the bf16 P.V at that split's running max (measured 1.1e-3).
LOCAL_TOL = TOL["flash_decode"][2]


def local_heads_check(torch, llm, n_model: int, label: str) -> float:
    """The attention layers at a model rank's local shapes: after the
    engine's prefill, its first dense and first sparse layer decode random
    q, k, v on a copy of the whole state, and on each of the n_model
    kv-head slices of it (`shard_state`) with that slice's heads
    (the server functions, as a sharded engine calls them; no collective).
    Each slice's output
    equals its heads' output of the whole layer within LOCAL_TOL, and the
    slices' sampled fractions average to the whole layer's. Returns the
    largest error."""
    import dataclasses

    from magicpig_tpu_torch.parallel.mesh import shard_state
    from magicpig_tpu_torch.runtime import server

    def copy(state):
        return dataclasses.replace(state, **{
            f.name: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for f in dataclasses.fields(state)
            for v in [getattr(state, f.name)]})

    cfg, dev = llm.config, llm.device
    b, hq, hkv, d = (llm.batch_size, cfg.num_attention_heads,
                     cfg.num_key_value_heads, cfg.head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    q, k, v = (torch.randn((b, h, d), generator=gen, device=dev,
                           dtype=cfg.dtype) for h in (hq, hkv, hkv))
    si = next(gi for kind, gi in llm.groups if kind == "sparse")

    def layers(state, q, k, v):
        dense = server.decode_dense_layer(copy(state), 0, q, k, v)
        sparse, frac = server.decode_sparse_layer(
            copy(state), si, q, k, v, llm.projections, llm.lsh)
        return dense, sparse, float(frac)

    want = layers(llm.state, q, k, v)
    errs, fracs = [], []
    for m in range(n_model):
        st = shard_state(llm.state, 1, 0, n_model, m)
        hs = slice(m * hq // n_model, (m + 1) * hq // n_model)
        ks = slice(m * hkv // n_model, (m + 1) * hkv // n_model)
        got = layers(st, *(x.contiguous() for x in (q[:, hs], k[:, ks],
                                                    v[:, ks])))
        errs += [float((g - w[:, hs]).abs().max() / w.abs().max())
                 for g, w in zip(got[:2], want[:2])]
        fracs.append(got[2])
        del st
    frac_err = abs(sum(fracs) / n_model - want[2])
    log(f"sharded {label}: the dense and sparse layer at {n_model} kv-head "
        f"slices ({hq // n_model}/{hkv // n_model} heads) against the whole "
        f"layer: max error {max(errs):.3e} (bound {LOCAL_TOL}), sampled "
        f"fraction {sum(fracs) / n_model!r} / {want[2]!r}")
    if max(errs) > LOCAL_TOL or frac_err > 1e-6:
        raise AssertionError(f"sharded {label}: a kv-head slice's attention "
                             "differs from the whole layer's")
    torch.cuda.empty_cache()
    return max(errs)


def _faulty_sum(shard, skip: int):
    """`shard.sum` whose call number `skip` (from now) still joins the
    all-reduce but keeps this rank's own partial: one layer's all-reduce
    skipped on this rank, the collectives still matched."""
    import torch.distributed as dist
    inner, calls = shard.sum, [0]

    def faulty(t):
        calls[0] += 1
        if calls[0] - 1 != skip:
            return inner(t)
        dist.all_reduce(t.clone(), group=shard.model)
        return t
    return faulty


def _ring_no_rotate(ring_mod):
    """`_Ring.pass_on` that passes the K/V on but keeps the rank's own (a
    ring step's K/V not rotated); the collectives still matched."""
    inner = ring_mod._Ring.pass_on

    def pass_on(self, kb, vb):
        inner(self, kb, vb)
        return kb, vb
    return inner, pass_on


def _sharded_rank(rank: int, runs: list) -> list:
    """One rank of the gloo runs: for each run the engine built as in the
    parent (the same seed draws the same weights), sharded over its mesh
    (None for a rank outside it),
    the prompts prefilled and the parent's tokens decoded eagerly (gloo's
    collectives cannot be captured), the launches counted, two steps
    profiled (`run["profile"]`); then the planted faults, each on a fresh
    fill."""
    import dataclasses

    import numpy as np
    import torch

    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, W4_SHAPE_LAUNCHES, reset_launches
    from magicpig_tpu_torch.parallel import ring as ring_mod
    from magicpig_tpu_torch.parallel.mesh import make_mesh, shard_engine, split_weight
    from magicpig_tpu_torch.parallel.sharded import COLLECTIVES, reset_collectives
    from magicpig_tpu_torch.runtime.engine import LLM

    out = []
    for run in runs:
        dev = torch.device(run.get("device", "cuda"))
        cfg = dataclasses.replace(preset(run["model"]), **run.get("cfg", {}))
        lsh = LSHConfig(**run["lsh"])
        mesh = make_mesh(*run["mesh"])
        if mesh.get_coordinate() is None:
            # Outside this run's mesh: meanwhile start the profiler once
            # (its first session in a process costs seconds).
            if run.get("profile", True):
                profiled(lambda: torch.ones(1, device=dev).add_(1))
            out.append(None)
            continue
        t = time.perf_counter()
        llm = LLM(cfg, batch_size=run["batch"], max_length=run["max_length"],
                  lsh=lsh, device=dev, seed=0)
        full_kv = (llm.params.layers.wk, llm.params.layers.wv)
        shard_engine(llm, mesh, seq_axis=run["seq_axis"])
        m, nm = llm.shard.m, llm.shard.n_model
        if "swap_kv" not in run["faults"]:
            full_kv = None
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        gen = torch.Generator(device=dev)
        gen.manual_seed(run["seed"])
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                                 device=dev) for n in run["prompts"]]
        tokens = [torch.from_numpy(x).to(dev) for x in run["tokens"]]

        def serve(steps, before_decode=None):
            llm.clear()
            pre = [llm.prefill(p, request_id=r)[0].float().cpu().numpy()
                   for r, p in enumerate(prompts)]
            if before_decode is not None:
                before_decode()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = [llm.inference(x).float().cpu().numpy()
                      for x in tokens[:steps]]
            wall = (time.perf_counter() - t) * 1e3 / steps
            return np.stack(pre), np.stack(logits), wall

        reset_launches()
        reset_collectives()
        snap = llm.sparsity_snapshot()
        t = time.perf_counter()
        pre, logits, wall = serve(len(tokens))
        serve_s = time.perf_counter() - t
        res = dict(prefill=pre, logits=logits, wall=wall, build_s=build_s,
                   serve_s=serve_s, frac=llm.avg_sparsity_since(snap),
                   launches={k: v for k, v in LAUNCHES.items() if v},
                   w4_shapes=dict(W4_SHAPE_LAUNCHES),
                   collectives=dict(COLLECTIVES),
                   graph_captures=llm.graph_captures)
        x = tokens[-1]
        t = time.perf_counter()
        if run.get("profile", True):
            busy, n, kernels = profiled(
                lambda: [llm.inference(x) for _ in range(2)])
            busy, coll = shard_collective_share(kernels)
            res.update(busy=busy / 2, coll=coll / 2, profiled_launches=n / 2)
        res["profile_s"] = time.perf_counter() - t
        res["faults"] = {}
        t = time.perf_counter()
        def skip_sum():
            # Call 2i is layer i's o_proj all-reduce, 2i + 1 its down_proj.
            llm.shard.sum = _faulty_sum(llm.shard, SKIP_CALL)
        for fault in run["faults"]:
            at_decode = None
            if fault == "skip_sum" and rank == run["fault_rank"]:
                skip_sum()                  # in the first prompt's prefill
            if fault == "skip_sum_decode" and rank == run["fault_rank"]:
                at_decode = skip_sum        # in the first decode step
            if fault == "no_rotate":
                inner, ring_mod._Ring.pass_on = _ring_no_rotate(ring_mod)
            if fault == "swap_kv":
                lw = llm.params.layers
                good = (lw.wk, lw.wv)
                lw.wk, lw.wv = (split_weight(w, "out", nm, nm - 1 - m)
                                for w in full_kv)
            try:
                res["faults"][fault] = serve(FAULT_STEPS, at_decode)[:2]
            finally:
                llm.shard.__dict__.pop("sum", None)
                if fault == "no_rotate":
                    ring_mod._Ring.pass_on = inner
                if fault == "swap_kv":
                    lw.wk, lw.wv = good
        res["faults_s"] = time.perf_counter() - t
        out.append(res)
        del llm, full_kv, prompts
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_sharded_run(label: str, ranks: list, ref: dict, expect: dict,
                      frac: bool, steps_note: str, smooth: bool = False) -> dict:
    """Every rank's results equal rank 0's; rank 0's prefill logits within
    SHARD_TOL of the unsharded reference and each step's within
    SHARD_DECODE_TOL (`smooth`: within SHARD_TOL, as the prefill's), its
    sampled fraction within SHARD_FRAC_TOL; each rank's launches exact;
    every planted fault outside the bounds. Logs a line per rank and one
    for the run."""
    import numpy as np

    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if not (np.array_equal(res["prefill"], r0["prefill"])
                and np.array_equal(res["logits"], r0["logits"])):
            raise AssertionError(f"sharded {label}: rank {r}'s logits differ "
                                 "from rank 0's")
    errs = shard_errors(r0["prefill"], r0["logits"], ref)
    tokens_same = bool((r0["logits"].argmax(-1)
                        == ref["logits"][:len(r0["logits"])].argmax(-1)).all())
    frac_err = abs(r0["frac"] - ref["frac"]) / max(ref["frac"], 1e-12)

    def passes(e):
        if smooth:
            return max(e["max"]) <= SHARD_TOL
        return e["max"][0] <= SHARD_TOL and max(e["l2"][1:]) <= SHARD_DECODE_TOL
    bounds = (f"steps' max of the largest (bound {SHARD_TOL})" if smooth else
              f"steps' relative L2 (bound {SHARD_DECODE_TOL})")
    faults = {}
    for name, (pre, logits) in r0["faults"].items():
        e = faults[name] = shard_errors(pre, logits, ref)
        steps = e["max" if smooth else "l2"][1:]
        log(f"sharded {label}: planted fault {name}: prefill "
            f"{e['max'][0]:.3e} (bound {SHARD_TOL}), {bounds} "
            f"{[f'{x:.3e}' for x in steps]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for r, res in enumerate(ranks):
        busy = ("not profiled" if "busy" not in res else
                f"device busy {res['busy']:.3f} ms/step, collectives "
                f"{res['coll']:.3f} ms/step "
                f"({res['coll'] / max(res['busy'], 1e-9):.3f} of busy), "
                f"{res['profiled_launches']:.0f} launches/step profiled")
        log(f"sharded {label} rank {r}: wall {res['wall']:.2f} ms/step, {busy}, "
            f"graph captures {res['graph_captures']}; engine {res['build_s']:.1f}"
            f" s, serve {res['serve_s']:.1f} s, profile {res['profile_s']:.1f} s,"
            f" faults {res['faults_s']:.1f} s; launches {res['launches']}"
            + (f", int4 shapes {res['w4_shapes']}" if res["w4_shapes"] else "")
            + f"; collective calls {res['collectives']} ({smi}; {RANKS_SHARE})")
    log(f"sharded {label}: {steps_note}; against the unsharded engine: "
        f"prefill logits {errs['max'][0]:.3e} of the largest (bound "
        f"{SHARD_TOL}), steps' max {[f'{e:.3e}' for e in errs['max'][1:]]}, "
        f"relative L2 {[f'{e:.3e}' for e in errs['l2'][1:]]} (bound "
        f"{f'{SHARD_TOL} on the max' if smooth else SHARD_DECODE_TOL}), "
        f"greedy tokens equal {tokens_same}; avg "
        f"sparsity {r0['frac']!r} vs {ref['frac']!r} (relative "
        f"{frac_err:.3e}, bound {SHARD_FRAC_TOL if frac else '-'})")
    if not passes(errs) or (frac and frac_err > SHARD_FRAC_TOL):
        raise AssertionError(f"sharded {label}: disagrees with the unsharded "
                             "engine")
    for name, e in faults.items():
        if passes(e):
            raise AssertionError(f"sharded {label}: the planted fault {name} "
                                 "passes the tolerance")
    for r, res in enumerate(ranks):
        want = expect(r)
        w4 = want.pop("w4_shapes", {})
        if res["launches"] != want or res["w4_shapes"] != w4:
            raise AssertionError(f"sharded {label} rank {r}: launches "
                                 f"{res['launches']}, {res['w4_shapes']} != "
                                 f"{want}, {w4}")
        if res["graph_captures"] != 0:
            raise AssertionError(f"sharded {label}: a gloo step was captured")
    return dict(err=errs, faults=faults, frac=r0["frac"],
                launches=[res["launches"] for res in ranks],
                w4_shapes=r0["w4_shapes"])


def sharded_nccl_1x1(torch, dev) -> dict:
    """NCCL at one rank, in this process: the 1B (bf16 LSH K=10, L=150,
    B=2, phase 3's 12000- and 7000-token prompts) unsharded and then
    through `shard_engine` over a 1 x 1 mesh on the same weights, 16 steps
    each on the unsharded run's tokens: every step's logits equal bit for
    bit, the sharded step captured once with its collectives inside the
    graph, launches exact."""
    import tempfile

    import torch.distributed as dist

    from magicpig_tpu_torch.config import LSHConfig
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.parallel.launch import init_process
    from magicpig_tpu_torch.parallel.mesh import make_mesh, shard_engine
    from magicpig_tpu_torch.parallel.sharded import COLLECTIVES, reset_collectives
    from magicpig_tpu_torch.runtime.engine import LLM, graph_kernel_nodes

    lsh = LSHConfig(K=10, L=150)
    ref = LLM("llama-3.2-1b", batch_size=2, max_length=16384, lsh=lsh,
              device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompts = [torch.randint(1, ref.config.vocab_size, (n,), generator=gen,
                             device=dev) for n in (12000, 7000)]

    def serve(llm, feed=None):
        """Prefill, then 16 steps on `feed` (or greedy): (step logits, the
        tokens fed, wall ms/step, launches, collective calls)."""
        reset_launches()
        reset_collectives()
        tok = torch.cat([llm.prefill(p, request_id=r).argmax(-1)
                         for r, p in enumerate(prompts)])
        out, fed = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(SHARD_STEPS_1X1):
            tok = tok if feed is None else feed[i]
            fed.append(tok)
            out.append(llm.inference(tok))
            tok = out[-1].argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / SHARD_STEPS_1X1
        return out, fed, wall, dict(LAUNCHES), dict(COLLECTIVES)

    def steady_ms(llm, tok, n=8):
        """Wall ms/step of n more graphed steps (after the serve)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            llm.inference(tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    want, fed, ref_wall, ref_launches, _ = serve(ref)
    ref_steady = steady_ms(ref, fed[-1])
    ref_nodes = graph_kernel_nodes(ref._graph.graph)
    tmp = tempfile.mkdtemp(prefix="nccl_1x1_")
    init_process(0, 1, "nccl", f"{tmp}/store", "cuda")
    try:
        llm = LLM("llama-3.2-1b", batch_size=2, max_length=16384, lsh=lsh,
                  params=ref.params, projections=ref.projections, device=dev)
        shard_engine(llm, make_mesh(1, 1))
        got, _, wall, launches, calls = serve(llm, fed)
        steady = steady_ms(llm, fed[-1])
        nodes = graph_kernel_nodes(llm._graph.graph)
        same = [torch.equal(g, w) for g, w in zip(got, want)]
        tok = fed[-1]
        busy, n, kernels = profiled(lambda: [llm.inference(tok) for _ in range(2)])
        busy, coll = shard_collective_share(kernels)
        captures = llm.graph_captures
    finally:
        dist.destroy_process_group()
    layers = llm.config.num_hidden_layers
    n_sparse = sum(1 for kind, _ in llm.groups if kind == "sparse")
    expect = {k: 0 for k in launches}
    expect.update(flash_prefill=2 * layers,
                  flash_decode=SHARD_STEPS_1X1 * layers,
                  lsh_fused_decode=SHARD_STEPS_1X1 * n_sparse)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"sharded nccl 1x1 (llama-3.2-1b, B=2, 12000 + 7000 tokens): logits "
        f"equal to the unsharded engine's bit for bit in {sum(same)} of "
        f"{len(same)} steps; graph captures {captures}; wall over the 16 "
        f"steps {wall:.2f} ms/step (unsharded {ref_wall:.2f}), 8 more graphed "
        f"{steady:.2f} (unsharded {ref_steady:.2f}), device busy {busy / 2:.3f} "
        f"ms/step, collectives {coll / 2:.3f} ms/step "
        f"({coll / max(busy, 1e-9):.3f} of busy), {n / 2:.0f} launches/step "
        f"profiled, graph kernel nodes {nodes} (unsharded {ref_nodes}); "
        f"collective calls in the two prefills, the eager and the captured "
        f"step {calls}; "
        f"launches {({k: v for k, v in launches.items() if v})} ({smi})")
    if not all(same) or captures != 1 or nodes <= ref_nodes:
        raise AssertionError("sharded nccl 1x1: differs from the unsharded "
                             "engine, or its step was not captured with its "
                             "collectives")
    if launches != expect or launches != ref_launches:
        raise AssertionError(f"sharded nccl 1x1: launches {launches} != "
                             f"{expect} (unsharded {ref_launches})")
    if not calls["sum"] or not calls["gather"]:
        raise AssertionError(f"sharded nccl 1x1: collectives not called {calls}")
    del llm, ref, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall=steady, nodes=nodes, launches=launches)


def sharded_gloo(torch, dev) -> dict:
    """gloo, four ranks started once on the card. Mesh 1 x 2 on ranks 0
    and 1 (2 and 3 idle): Llama-3.1-8B at full width and depth, bf16 LSH
    (K=10, L=150), one 8192-token prompt, 8 eager steps on the unsharded
    run's tokens; planted fault: rank 1 keeps its own partial of layer 1's
    MLP all-reduce in the prefill. Then its smooth run (SMOOTH_LSH, a
    SMOOTH_PROMPT-token prompt, 4 steps, every step within SHARD_TOL), the
    same all-reduce skipped in the first decode step. Mesh 2 x 2 with
    seq_axis="data": the 1B at full width and depth, bf16 LSH, two prompts
    (8192 and 6144 tokens) prefilled through the zigzag ring, 8 eager
    steps (faults: a ring step's K/V not rotated, the kv-head shards of
    the two model ranks swapped); bench.py's block_topk4 mode with int4
    weights (unfused) without the ring, 4 steps (fault: the skipped
    all-reduce in the prefill); the smooth run with int4 weights through
    the ring (SMOOTH_LSH, SMOOTH_PROMPTS, 4 steps; fault: the all-reduce
    skipped in the first decode step). Each run against the unsharded
    engine on the card."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.parallel.launch import launch

    max_length = 8192 + 512
    lsh = dict(K=10, L=150)
    bt4 = dict(K=1, L=0, estimator="block_topk", offload_quant="int4",
               dense_quant="int8")
    cfg8, cfg = preset("llama-3.1-8b"), preset("llama-3.2-1b")
    cfg4 = dataclasses.replace(cfg, weight_quant="int4")
    label8 = "gloo 1x2 llama-3.1-8b"
    refs = dict(
        b8=unsharded_reference(torch, dev, cfg8, LSHConfig(**lsh), (8192,),
                               31, SHARD_STEPS_8B, 1, max_length, label8),
        b8_smooth=unsharded_reference(
            torch, dev, cfg8, LSHConfig(**SMOOTH_LSH), (SMOOTH_PROMPT,), 31,
            SMOOTH_STEPS, 1, max_length, f"{label8} smooth", local=False),
        ring=unsharded_reference(torch, dev, cfg, LSHConfig(**lsh),
                                 RING_PROMPTS, 37, RING_STEPS, 2, max_length,
                                 "gloo 2x2 ring llama-3.2-1b"),
        bt4=unsharded_reference(torch, dev, cfg4, LSHConfig(**bt4),
                                RING_PROMPTS, 37, BT4_STEPS, 2, max_length,
                                "gloo 2x2 block_topk4 W4 llama-3.2-1b"),
        smooth=unsharded_reference(torch, dev, cfg4, LSHConfig(**SMOOTH_LSH),
                                   SMOOTH_PROMPTS, 37, SMOOTH_STEPS, 2,
                                   max_length,
                                   "gloo 2x2 ring W4 llama-3.2-1b smooth",
                                   local=False))
    b8 = dict(model="llama-3.1-8b", lsh=lsh, mesh=(1, 2), seq_axis=None,
              batch=1, max_length=max_length, seed=31, prompts=(8192,),
              tokens=refs["b8"]["tokens"], faults=("skip_sum",), fault_rank=1)
    b8_smooth = dict(b8, lsh=SMOOTH_LSH, prompts=(SMOOTH_PROMPT,),
                     tokens=refs["b8_smooth"]["tokens"],
                     faults=("skip_sum_decode",), profile=False)
    ring = dict(model="llama-3.2-1b", lsh=lsh, mesh=(2, 2), seq_axis="data",
                batch=2, max_length=max_length, seed=37, prompts=RING_PROMPTS,
                tokens=refs["ring"]["tokens"], faults=("no_rotate", "swap_kv"))
    block = dict(ring, cfg=dict(weight_quant="int4"), lsh=bt4, seq_axis=None,
                 tokens=refs["bt4"]["tokens"], faults=("skip_sum",),
                 fault_rank=1)
    smooth = dict(block, lsh=SMOOTH_LSH, seq_axis="data",
                  prompts=SMOOTH_PROMPTS, tokens=refs["smooth"]["tokens"],
                  faults=("skip_sum_decode",), profile=False)
    t = time.perf_counter()
    ranks = launch(_sharded_rank, 4, [b8, b8_smooth, ring, block, smooth],
                   backend="gloo", device="cuda", timeout=600)
    spawn_s = time.perf_counter() - t
    if any(r[i] is not None for r in ranks[2:] for i in (0, 1)):
        raise AssertionError("sharded: a rank outside the 1 x 2 mesh ran it")

    layers8 = cfg8.num_hidden_layers
    n_dense8 = len(LSHConfig(**lsh).dense_layers_for(layers8))   # 0 and 16
    layers = cfg.num_hidden_layers
    n_dense = len(LSHConfig(**lsh).dense_layers_for(layers))     # layer 0
    n_prompts = len(RING_PROMPTS)

    def b8_expect(steps):
        return lambda r: dict(
            flash_prefill_d128=layers8, flash_decode_d128=steps * layers8,
            lsh_fused_decode_d128=steps * (layers8 - n_dense8))

    def ring_expect(steps):
        return lambda r: dict(
            flash_prefill=layers * n_prompts * ring_live_pairs(2, r // 2),
            flash_decode=steps * layers,
            lsh_fused_decode=steps * (layers - n_dense))

    def w4_expect(steps):
        # Per step and layer 7 int4 products (wq, wk, wv, wo, w_gate, w_up,
        # w_down at the rank's columns or rows) and the lm_head's shard;
        # each prompt's last-token lm_head at prefill; M = 1 a rank.
        shapes = {f"{kin}x{out}": n for (_, kin, out), n
                  in zip(W4_SHAPES_TP, (1, 2, 1, 2, 1))}
        w4 = {k: steps * layers * n for k, n in shapes.items()}
        _, kin, out = W4_SHAPES_TP[-1]
        w4[f"{kin}x{out}"] = steps + n_prompts
        return dict(w4_matmul=sum(w4.values()), w4_shapes=w4)

    def bt4_expect(r):
        return dict(flash_prefill=layers * n_prompts,
                    flash_decode=BT4_STEPS * (layers - n_dense),
                    flash_decode_int8=BT4_STEPS * n_dense,
                    block_rank_int4=BT4_STEPS * (layers - n_dense),
                    rescore_attend_int4=BT4_STEPS * (layers - n_dense),
                    **w4_expect(BT4_STEPS))

    def smooth_expect(r):
        return dict(ring_expect(SMOOTH_STEPS)(r), **w4_expect(SMOOTH_STEPS))

    note = f"launch of the five runs {spawn_s:.1f} s"
    out = dict(
        b8=check_sharded_run(
            label8, [r[0] for r in ranks[:2]], refs["b8"],
            b8_expect(SHARD_STEPS_8B), True,
            f"2 ranks, 8192 tokens, {SHARD_STEPS_8B} eager steps, {note}"),
        b8_smooth=check_sharded_run(
            f"{label8} smooth", [r[1] for r in ranks[:2]], refs["b8_smooth"],
            b8_expect(SMOOTH_STEPS), True,
            f"2 ranks, {SMOOTH_PROMPT} tokens, LSH K=1, L=32, {SMOOTH_STEPS} "
            "eager steps", smooth=True),
        ring=check_sharded_run(
            "gloo 2x2 ring llama-3.2-1b", [r[2] for r in ranks], refs["ring"],
            ring_expect(RING_STEPS), True,
            f"4 ranks, zigzag ring over data, {RING_STEPS} eager steps"),
        block=check_sharded_run(
            "gloo 2x2 block_topk4 W4 llama-3.2-1b", [r[3] for r in ranks],
            refs["bt4"], bt4_expect, False,
            f"4 ranks, no ring, {BT4_STEPS} eager steps (realized fraction: "
            "the budget clamped to each length)"),
        smooth=check_sharded_run(
            "gloo 2x2 ring W4 llama-3.2-1b smooth", [r[4] for r in ranks],
            refs["smooth"], smooth_expect, True,
            f"4 ranks, zigzag ring over data, int4 weights, LSH K=1, L=32, "
            f"{' + '.join(map(str, SMOOTH_PROMPTS))} tokens, {SMOOTH_STEPS} "
            "eager steps", smooth=True))
    return out


def phase_sharded(torch, dev) -> dict:
    """Multi-GPU serving over torch.distributed, on the one card: NCCL at
    one rank, then gloo ranks sharing it, 2 or 4 a run (NCCL takes one
    card per rank)."""
    t = time.perf_counter()
    out = dict(nccl=sharded_nccl_1x1(torch, dev), gloo=sharded_gloo(torch, dev))
    out["seconds"] = time.perf_counter() - t
    log(f"phase 3 sharded serving done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 5: training (the needle and RULER-LM trainers, the backward kernel)
# ---------------------------------------------------------------------------

# The backward kernel's dq, dk and dv (f32 from bf16 inputs, p and dS
# rounded to bf16 as the operands of their products) against the plain
# version on the same bf16 inputs: the largest |error| of each gradient
# within this share of its largest |value|.
BWD_TOL = 1e-2
# A training run through the kernels against the same run through their
# plain versions on the card (the same bf16 inputs, patched into
# FlashPrefillTrain), and against the JAX example on the CPU: each step's
# loss within this share of the other's. The readings were 1.0e-4 (kernels
# against plain) and 4e-5-6e-5 (against JAX); a backward that drops dq
# (`TRAIN_FAULT`) came to 1.0e-3.
TRAIN_LOSS_TOL = 3e-4
# The needle loss's gradient at step 0, every leaf, through the kernels
# against the plain versions on the card: the largest |error| of each leaf
# within this share of its largest |value|. It holds FlashPrefillTrain's
# wiring: a backward that drops dq leaves the query weights no gradient.
TRAIN_GRAD_TOL = 2e-2
NEEDLE_STEPS = 20          # as the JAX reference ran (results/train_needle_jax_cpu)
NEEDLE_SEED = 0
RULER_STEPS = 3
RULER_POOL = 8
JAX_NEEDLE_LOG = ROOT / "results" / "train_needle_jax_cpu" / "jax_cpu.log"
# (row, batch, sq, skv, q_offset, kv_len, window, (hq, hkv, d)): the needle
# trainer's shape, the RULER LM's, and a cut with a window, offsets and
# lengths short of the keys, at their 8/4 heads of 64; then the forms of
# every head dim and group size: Llama-3.2-3B's 24/8 heads of 128 (G = 3)
# at the training run's B = 2, S = 4096, Llama-3.1-405B's 128/8 (G = 16),
# SmolLM2-360M's 15/5 of 64 (G = 3), llama-tiny's 8/2 heads at d 16 (with
# the window cut's offsets and lengths) and d 32, and the window cut at
# the 3B's heads.
_BWD_WINDOW = (4, 1024, 4096, (3000, 1500, 2000, 3072),
               (4000, 2600, 3100, 4096), 1024)
BWD_FORMS = (
    ("flash_prefill_bwd", 32, 1024, 1024, (0,), (1024,), None, (8, 4, 64)),
    ("flash_prefill_bwd_8192", 8, 8192, 8192, (0,), (8192,), None,
     (8, 4, 64)),
    ("flash_prefill_bwd_window", *_BWD_WINDOW, (8, 4, 64)),
    ("flash_prefill_bwd_d128_g3", 2, 4096, 4096, (0,), (4096,), None,
     (24, 8, 128)),
    ("flash_prefill_bwd_d128_g16", 1, 2048, 2048, (0,), (2048,), None,
     (128, 8, 128)),
    ("flash_prefill_bwd_g3", 4, 2048, 2048, (0,), (2048,), None, (15, 5, 64)),
    ("flash_prefill_bwd_d16_window", *_BWD_WINDOW, (8, 2, 16)),
    ("flash_prefill_bwd_d32", 4, 1024, 1024, (0,), (1024,), None, (8, 2, 32)),
    ("flash_prefill_bwd_d128_g3_window", *_BWD_WINDOW, (24, 8, 128)),
)


def visible_pairs(torch, sq: int, q_offset, kv_len, window) -> int:
    """(query, key) pairs the training attention's mask lets through, over
    the requests of a batch, for one head."""
    total = 0
    for off, n in zip(q_offset, kv_len):
        pos = off + torch.arange(sq, dtype=torch.int64)
        hi = torch.clamp(torch.minimum(pos, torch.tensor(n - 1)) + 1, min=0)
        lo = (torch.zeros_like(pos) if window is None
              else torch.clamp(pos - window + 1, min=0))
        total += int(torch.clamp(hi - lo, min=0).sum())
    return total


def bwd_kernel(torch, F, form) -> dict:
    """flash_prefill_bwd against its plain version at one form, out and
    lse from the prefill kernel; bit-equal repeats; one key tile's dV
    dropped rejected; SDPA's backward beside it. The bound: the inputs read
    and gradients written once, and five products of 2 d operations per
    visible (query, key, head) triple (S recomputed, dP, dV, dK, dQ)."""
    from magicpig_tpu_torch.ops import attention
    from magicpig_tpu_torch.ops.kernels import flash_prefill, flash_prefill_bwd

    name, b, sq, skv, off, kvl, window, (hq, hkv, d) = form
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, do = rnd(b, sq, hq, d), rnd(b, sq, hq, d)
    k, v = rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
    off = [off[i % len(off)] for i in range(b)]
    kvl = [kvl[i % len(kvl)] for i in range(b)]
    off_t = torch.tensor(off, dtype=torch.int32, device=dev)
    kvl_t = torch.tensor(kvl, dtype=torch.int32, device=dev)
    out, lse = flash_prefill(q, k, v, kvl_t, off_t, window=window,
                             return_lse=True)

    def kernel():
        return flash_prefill_bwd(q, k, v, out, lse, do, off_t, kvl_t,
                                 window=window)

    def plain():
        return attention.flash_prefill_train_backward(
            q, k, v, out, lse, do, off_t, kvl_t, 512, window=window)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    errs = {}
    for g_name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{name}: {g_name} differs between runs")
        w = w.float()
        limit = BWD_TOL * float(w.abs().max())
        err = float((g - w).abs().max())
        if not err <= limit:
            raise AssertionError(f"{name}: {g_name} max abs err {err:.3e} > "
                                 f"{BWD_TOL} of its largest |value| ({limit:.3e})")
        errs[g_name] = (err, err / limit)
    # The planted fault: a kernel that dropped one key tile's dV.
    tile = (min(kvl) // 2) // 64 * 64
    faulty = got[2].clone()
    faulty[:, tile:tile + 64].zero_()
    want_v = want[2].float()
    fault_share = float((faulty - want_v).abs().max()) / (
        BWD_TOL * float(want_v.abs().max()))
    if not fault_share > 1:
        raise AssertionError(f"{name}: the tolerance passes a dropped dV tile")

    # SDPA's backward: causal over whole spans as is, else (every query
    # row here sees a key) through the training mask as a [B, 1, Sq, Skv]
    # boolean on the memory-efficient kernel, K/V expanded to the query
    # heads in the graph (its backward sums the group).
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    try:
        if window is None and min(off) == 0 and min(kvl) == skv == sq:
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True)
        else:
            from torch.nn.attention import SDPBackend, sdpa_kernel
            q_pos = off_t[:, None].long() + torch.arange(sq, device=dev)
            mask = attention._fp_mask(q_pos, torch.arange(skv, device=dev),
                                     kvl_t.long(), window)
            if not bool(mask.any(-1).all()):
                raise AssertionError(f"{name}: a query row sees no key")
            g = hq // hkv
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                ot = F.scaled_dot_product_attention(
                    qt, kt.repeat_interleave(g, dim=1),
                    vt.repeat_interleave(g, dim=1), attn_mask=mask[:, None])

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        library()
    except RuntimeError as e:   # no kernel of the library takes this call
        log(f"  {name}: no library time (SDPA: {str(e)[:200]})")
        library = None

    pairs = visible_pairs(torch, sq, off, kvl, window) * hq
    nbytes = (2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
              + 4 * (q.numel() + 2 * k.numel()))
    row = dict(max_abs_err=max(e[0] for e in errs.values()), tol=BWD_TOL,
               bound=bound_ms(nbytes, 5 * 2 * d * pairs),
               **timings(kernel, plain, library))
    log(f"kernel {name} (B={b}, Sq={sq}, Skv={skv}, {hq}/{hkv} heads of "
        f"{d}, q_offset {form[4]}, "
        f"kv_len {form[5]} by request, window {window}): max abs err (share "
        f"of the limit, "
        f"{BWD_TOL} of the largest |grad|) "
        + ", ".join(f"{n} {e:.2e} ({s:.2f})" for n, (e, s) in errs.items())
        + f"; repeats bit-equal; a dropped dV tile {fault_share:.1f}x the "
        "limit")
    return {name: row}


def jax_needle_reference() -> dict:
    """The digest of the JAX reference run's initial weights and its losses
    by step, from its log (`results/train_needle_jax_cpu/run.sh`)."""
    ref = {"losses": {}}
    for line in JAX_NEEDLE_LOG.read_text().splitlines():
        if line.startswith("init digest "):
            ref["digest"] = line.split()[-1]
        elif line.startswith("step ") and ": loss " in line:
            step, rest = line[len("step "):].split(": loss ")
            ref["losses"][int(step)] = float(rest.split()[0])
    return ref


# The runs held to the kernels' run: FlashPrefillTrain's two kernel calls
# patched by `mock` with their plain versions, and the planted fault, a
# backward that returns dq as zeros.
TRAIN_PLAIN = "plain versions"
TRAIN_FAULT = "dq dropped"


def train_route(torch, route: str | None):
    """The patch that sends FlashPrefillTrain through `route` (None: the
    kernels)."""
    import importlib
    from unittest import mock

    from magicpig_tpu_torch.ops import attention

    # The module (the package's `flash_prefill` is its function).
    fp = importlib.import_module("magicpig_tpu_torch.ops.kernels.flash_prefill")
    if route is None:
        return contextlib.nullcontext()
    if route == TRAIN_PLAIN:
        return mock.patch.multiple(fp, flash_prefill=attention.flash_prefill,
                                   flash_prefill_bwd=fp.flash_prefill_bwd_plain)
    kernel = fp.flash_prefill_bwd

    def dq_dropped(*args, **kwargs):
        dq, dk, dv = kernel(*args, **kwargs)
        return torch.zeros_like(dq), dk, dv

    return mock.patch.object(fp, "flash_prefill_bwd", dq_dropped)


def needle_grads(torch, module, route: str | None) -> list:
    """Every leaf's gradient (`convert.NPZ_LEAVES` order) of the needle
    trainer's loss at its first step (seed NEEDLE_SEED's weights and first
    batch, B = 32, S = 1024) on the card, through `train_route(route)`."""
    import numpy as np

    from magicpig_tpu_torch import training

    cfg = module.model_config()
    params = training.initial_params(cfg, 1024, NEEDLE_SEED, "cuda")
    leaves = training.trainable(params)
    batch = module.make_batch(np.random.default_rng(NEEDLE_SEED + 1), 32,
                              1024, 4)
    toks, tgt, msk = (torch.from_numpy(x).cuda() for x in batch)
    with train_route(torch, route):
        loss, _ = training.masked_loss(
            training.forward_all(params, cfg, toks), tgt, msk)
        return torch.autograd.grad(loss, leaves)


def grad_shares(got: list, want: list) -> dict:
    """Each leaf's largest |error| as a share of TRAIN_GRAD_TOL times its
    largest |value|, by leaf name."""
    from magicpig_tpu_torch.models.convert import NPZ_LEAVES

    return {name: float((g - w).abs().max())
            / (TRAIN_GRAD_TOL * max(float(w.abs().max()), 1e-30))
            for name, g, w in zip(NPZ_LEAVES, got, want, strict=True)}


def train_counted(torch, module, argv: list, layers: int, label: str,
                  route: str | None = None) -> dict:
    """One run of an example trainer's `train` on the card through the
    kernels, or through `train_route(route)`, its launches counted: a run
    on the kernels launches the prefill twice a layer and step (forward and
    the checkpoint's recomputation) and the backward once, the plain run
    neither; every other count stays 0."""
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    args = module.parse_args(argv)
    patch = train_route(torch, route)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with patch:
        run = module.train(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: n for k, n in LAUNCHES.items() if n}
    steps = args.steps
    expect = {} if route == TRAIN_PLAIN else {
        "flash_prefill": 2 * layers * steps,
        "flash_prefill_bwd": layers * steps}
    if launches != expect:
        raise AssertionError(f"train {label}: launches {launches} != {expect}")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"train {label}: losses {run['losses']}")
    # The first and the last step print (waiting for the device).
    first, last = run["printed"][0], run["printed"][-1]
    run.update(launches=launches, seconds=seconds,
               step_ms=(last - first) * 1e3 / (steps - 1))
    log(f"train {label}: {steps} steps in {seconds:.1f} s, "
        f"{run['step_ms']:.1f} ms per step after the first; losses "
        f"{[round(x, 4) for x in run['losses']]}; launches {launches}")
    return run


def profile_train(torch, module, argv: list, step_ms: float,
                  label: str) -> None:
    """Steps 1 and 2 of a 3-step run through the kernels under
    torch.profiler, started when step 0 has finished on the device (so the
    set-up and the first step's allocations stay out) and stopped when
    step 2 has: device busy and wall per step, the idle share of that wall
    (the profiler's own host time in it) and of `step_ms` (the counted
    run's steps after the first, unprofiled), and the kernels by device
    time."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from magicpig_tpu_torch import training

    steps = 3
    args = module.parse_args(argv + ["--steps", str(steps)])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    train_step, ends = training.train_step, []

    def step(*a, **kw):
        out = train_step(*a, **kw)
        ends.append(None)
        if len(ends) in (1, steps):
            torch.cuda.synchronize()
            ends[-1] = time.perf_counter()
            (prof.start if len(ends) == 1 else prof.stop)()
        return out

    with mock.patch.object(training, "train_step", step):
        module.train(args)
    steps -= 1
    wall = (ends[-1] - ends[0]) * 1e3 / steps
    busy, n, kernels = device_kernels(prof)
    busy /= steps
    log(f"profile: train {label}: steps 1-{steps}: device busy {busy:.3f} "
        f"ms/step, wall {wall:.3f} ms/step under the profiler, idle share "
        f"{1 - busy / wall:.3f} of it and {1 - busy / step_ms:.3f} of the "
        f"unprofiled {step_ms:.1f} ms/step, {n / steps:.0f} launches/step")
    for e in kernels[:10]:
        log(f"  {_device_us(e) / steps:9.1f} us/step "
            f"{e.count / steps:5.1f} calls/step  {e.key[:70]}")


def loss_share(got: list, want: list) -> float:
    """The largest share of TRAIN_LOSS_TOL that a step's loss uses."""
    return max(abs(g - w) / (TRAIN_LOSS_TOL * abs(w))
               for g, w in zip(got, want, strict=True))


def check_losses(label: str, got: list, want: list) -> float:
    """Each step's loss within TRAIN_LOSS_TOL of the other's; returns the
    largest share of that limit used."""
    share = loss_share(got, want)
    if not share <= 1:
        raise AssertionError(f"{label}: losses {got} vs {want} differ by more "
                             f"than {TRAIN_LOSS_TOL} relative")
    return share


# Llama-3.2-3B's width trained through `training` (no trainer example has
# this model): the preset (hidden 3072, 24/8 heads of 128, G = 3, tied
# embeddings, vocab 128256) cut from 28 layers to 2 (f32 weights and
# AdamW's moments are 16 bytes a parameter; the cut keeps the run within
# its time), B = 2, S = 4096, 3 steps on the needle trainer's batches and
# masked loss, from the weights `init_params` draws on the CPU from seed 0.
TRAIN_3B = dict(layers=2, batch=2, seq=4096, steps=3, lr=3e-4)


def train_3b_config(torch):
    import dataclasses

    from magicpig_tpu_torch.config import preset

    return dataclasses.replace(preset("llama-3.2-3b"),
                               num_hidden_layers=TRAIN_3B["layers"],
                               dtype=torch.float32)


def train_run(torch, cfg, host_params, batches, route: str | None,
              label: str, lr: float, profile_last: bool = False) -> dict:
    """One optimizer step a batch of `batches` (tokens, target, mask) on
    the card, from a copy of `host_params`, through the kernels or
    `train_route(route)`: losses, every leaf's step-0 gradient (kept on the
    card), ms per step 1 (and the last step's), launches (the prefill twice
    a layer and step, the backward once, under their head dim's names; none
    on the plain route); with `profile_last`, the last step under
    torch.profiler (device busy, idle share, kernels by time)."""
    from torch.profiler import ProfilerActivity, profile

    from magicpig_tpu_torch import training
    from magicpig_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from magicpig_tpu_torch.ops.kernels.flash_prefill import (
        bwd_launch_name,
        launch_name,
    )

    params = host_params.to("cuda")
    opt = training.adamw(params, lr)
    steps = len(batches)
    losses, ends, grads, prof = [], [], None, None
    reset_launches()
    torch.cuda.synchronize()
    ends.append(time.perf_counter())
    with train_route(torch, route):
        for i, batch in enumerate(batches):
            if profile_last and i == steps - 1:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            loss, _ = training.train_step(
                params, cfg, opt, training.cosine_decay(lr, steps, i),
                training.masked_loss, *batch)
            losses.append(float(loss))          # waits for the device
            if prof is not None:
                torch.cuda.synchronize()
                prof.stop()
            ends.append(time.perf_counter())
            if i == 0:
                grads = [t.grad.detach().clone()
                         for t in training.leaves(params)]
                torch.cuda.synchronize()
                ends[-1] = time.perf_counter()
    launches = {k: n for k, n in LAUNCHES.items() if n}
    layers = cfg.num_hidden_layers
    expect = {} if route == TRAIN_PLAIN else {
        launch_name(cfg.head_dim): 2 * layers * steps,
        bwd_launch_name(cfg.head_dim): layers * steps}
    if launches != expect:
        raise AssertionError(f"train {label}: launches {launches} != {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {label}: losses {losses}")
    run = dict(losses=losses, grads=grads, launches=launches,
               step_ms=(ends[2] - ends[1]) * 1e3,
               last_ms=(ends[-1] - ends[-2]) * 1e3)
    log(f"train {label}: {steps} steps in {ends[-1] - ends[0]:.1f} s, "
        f"{run['step_ms']:.1f} ms step 1; "
        f"losses {[round(x, 4) for x in losses]}; launches {launches}")
    if prof is not None:
        busy, n, kernels = device_kernels(prof)
        wall = run["last_ms"]
        log(f"profile: train {label}: step {steps - 1}: device busy "
            f"{busy:.3f} ms, wall {wall:.1f} ms under the profiler, idle "
            f"share {1 - busy / wall:.3f} of it and "
            f"{1 - busy / run['step_ms']:.3f} of the unprofiled "
            f"{run['step_ms']:.1f} ms, {n} launches")
        for e in kernels[:10]:
            log(f"  {_device_us(e):9.1f} us  {e.count:5d} calls  "
                f"{e.key[:70]}")
        run["busy_ms"] = busy
    del params, opt
    return run


def phase_train_3b(torch) -> dict:
    """TRAIN_3B through the kernels, through their plain versions and with
    the planted TRAIN_FAULT: each step's loss within TRAIN_LOSS_TOL of the
    plain versions' and every leaf's step-0 gradient within
    TRAIN_GRAD_TOL, the fault rejected by both."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "examples"))
    import train_needle_torch

    from magicpig_tpu_torch.training import initial_params, leaves

    cfg = train_3b_config(torch)
    t = time.perf_counter()
    host = initial_params(cfg, TRAIN_3B["seq"], 0, "cpu")
    rng = np.random.default_rng(1)
    batches = [[torch.from_numpy(x).cuda() for x in train_needle_torch.
                make_batch(rng, TRAIN_3B["batch"], TRAIN_3B["seq"])]
               for _ in range(TRAIN_3B["steps"])]
    label = (f"llama-3.2-3b {TRAIN_3B['layers']} layers B={TRAIN_3B['batch']} "
             f"S={TRAIN_3B['seq']}")
    log(f"train {label}: {sum(x.numel() for x in leaves(host)) / 1e6:.0f} M "
        f"parameters (the tied lm_head a leaf of its own, as in JAX's "
        f"pytree) drawn on the CPU in {time.perf_counter() - t:.1f} s")
    lr = TRAIN_3B["lr"]
    plain = train_run(torch, cfg, host, batches, TRAIN_PLAIN,
                      f"{label} {TRAIN_PLAIN}", lr)
    torch.cuda.empty_cache()
    run = train_run(torch, cfg, host, batches, None, label, lr,
                    profile_last=True)
    shares = grad_shares(run.pop("grads"), plain["grads"])
    torch.cuda.empty_cache()
    faulty = train_run(torch, cfg, host, batches, TRAIN_FAULT,
                       f"{label} planted fault, {TRAIN_FAULT}", lr)
    fault = grad_shares(faulty.pop("grads"), plain.pop("grads"))
    del host
    torch.cuda.empty_cache()
    worst, fault_worst = (max(x, key=x.get) for x in (shares, fault))
    if not shares[worst] <= 1:
        raise AssertionError(f"train {label}: step 0's gradient of {worst} "
                             f"through the kernels {shares[worst]:.2f}x the "
                             f"limit ({TRAIN_GRAD_TOL} of its largest |value|)")
    if not fault[fault_worst] > 1:
        raise AssertionError(f"train {label}: the gradient limit passes a "
                             f"backward with {TRAIN_FAULT}")
    share = check_losses(f"train {label} kernels vs plain", run["losses"],
                         plain["losses"])
    share_fault = loss_share(faulty["losses"], run["losses"])
    if not share_fault > 1:
        raise AssertionError(f"train {label}: the loss limit passes a "
                             f"backward with {TRAIN_FAULT} ({share_fault:.3f} "
                             f"of it)")
    log(f"train {label}: losses through the kernels within {share:.3f} of "
        f"the limit ({TRAIN_LOSS_TOL} relative) of the plain versions' at "
        f"every step, a backward with {TRAIN_FAULT} {share_fault:.1f}x it; "
        f"step 0's gradients within {shares[worst]:.3f} of the limit "
        f"({TRAIN_GRAD_TOL} of each leaf's largest |value|; worst {worst}), "
        f"the fault {fault[fault_worst]:.1f}x it ({fault_worst})")
    return dict(run=run, plain=plain, label=label, layers=cfg.num_hidden_layers)


def phase_train_tiny(torch) -> dict:
    """llama-tiny (8/2 heads of 16) and its d = 32 twin, all 4 layers,
    trained 3 steps at B = 4, S = 1024 on random tokens (next-token loss)
    through the kernels and through their plain versions: each step's loss
    within TRAIN_LOSS_TOL of the other's, launches counted under the head
    dim's names. Returns the kernel runs by head dim."""
    import dataclasses

    import numpy as np

    from magicpig_tpu_torch.config import preset
    from magicpig_tpu_torch.training import initial_params

    runs = {}
    for d in (16, 32):
        cfg = dataclasses.replace(preset("llama-tiny"), head_dim=d,
                                  dtype=torch.float32)
        rng = np.random.default_rng(d)
        batches = []
        for _ in range(3):
            toks = rng.integers(1, cfg.vocab_size, size=(4, 1024))
            target = np.roll(toks, -1, axis=1)
            mask = np.ones(toks.shape, bool)
            mask[:, -1] = False
            batches.append([torch.from_numpy(x).cuda() for x in (
                toks.astype(np.int32), target.astype(np.int32), mask)])
        host = initial_params(cfg, 1024, 0, "cpu")
        label = f"llama-tiny d{d} B=4 S=1024"
        plain = train_run(torch, cfg, host, batches, TRAIN_PLAIN,
                          f"{label} {TRAIN_PLAIN}", 1e-3)
        run = train_run(torch, cfg, host, batches, None, label, 1e-3)
        share = check_losses(f"train {label} kernels vs plain",
                             run["losses"], plain["losses"])
        log(f"train {label}: losses through the kernels within {share:.3f} "
            f"of the limit of the plain versions'")
        runs[d] = run
    return runs


def phase_train(torch, F, smi: str) -> dict:
    """The backward kernel against its plain version at three forms, then
    `examples/train_needle_torch.py` at full width (needle-12m, B = 32, S =
    1024, 20 steps, weights drawn on the CPU from seed 0) through the
    kernels and through the plain versions, each step's loss held to the
    other's and steps 0 and 19 to the JAX example's on the CPU from the
    same weights (their digest checked), every leaf's step-0 gradient held
    to the plain versions', a backward that drops dq rejected by both;
    then
    `examples/train_ruler_lm_torch.py` at full width (B = 8, S = 8192, 3
    steps) the same two ways. Returns the kernel rows and the runs."""
    sys.path.insert(0, str(ROOT / "examples"))
    import train_needle_torch
    import train_ruler_lm_torch

    from magicpig_tpu_torch.training import digest, initial_params

    rows = {}
    for form in BWD_FORMS:
        rows.update(bwd_kernel(torch, F, form))
        torch.cuda.empty_cache()
    log_timings(rows)

    plain = needle_grads(torch, train_needle_torch, TRAIN_PLAIN)
    shares = grad_shares(needle_grads(torch, train_needle_torch, None), plain)
    worst = max(shares, key=shares.get)
    if not shares[worst] <= 1:
        raise AssertionError(f"train needle: step 0's gradient of {worst} "
                             f"through the kernels {shares[worst]:.2f}x the "
                             f"limit ({TRAIN_GRAD_TOL} of its largest |value|)")
    fault = grad_shares(needle_grads(torch, train_needle_torch, TRAIN_FAULT),
                        plain)
    fault_worst = max(fault, key=fault.get)
    if not fault[fault_worst] > 1:
        raise AssertionError(f"train needle: the gradient limit passes a "
                             f"backward with {TRAIN_FAULT}")
    log(f"train needle: step 0's gradients through the kernels within "
        f"{shares[worst]:.3f} of the limit ({TRAIN_GRAD_TOL} of each leaf's "
        f"largest |value|) of the plain versions' (worst {worst}); a backward "
        f"with {TRAIN_FAULT} {fault[fault_worst]:.1f}x it ({fault_worst})")
    del plain
    torch.cuda.empty_cache()

    ref = jax_needle_reference()
    cfg = train_needle_torch.model_config()
    drawn = digest(initial_params(cfg, 1024, NEEDLE_SEED, "cpu"))
    if drawn != ref["digest"]:
        raise AssertionError(f"train needle: the initial weights' digest "
                             f"{drawn} is not the JAX reference's "
                             f"{ref['digest']}")
    out = CKPT_DIR / "train"
    shape = ["--batch", "32", "--seq", "1024", "--seed", str(NEEDLE_SEED),
             "--out", str(out / "needle.npz")]
    argv = ["--steps", str(NEEDLE_STEPS), *shape]
    needle = train_counted(torch, train_needle_torch, argv,
                           cfg.num_hidden_layers, "needle-12m B=32 S=1024")
    profile_train(torch, train_needle_torch, shape, needle["step_ms"],
                  "needle-12m B=32 S=1024")
    needle_plain = train_counted(torch, train_needle_torch, argv,
                                 cfg.num_hidden_layers,
                                 f"needle-12m {TRAIN_PLAIN}", TRAIN_PLAIN)
    share = check_losses("train needle kernels vs plain", needle["losses"],
                         needle_plain["losses"])
    faulty = train_counted(torch, train_needle_torch, argv,
                           cfg.num_hidden_layers,
                           f"needle-12m planted fault, {TRAIN_FAULT}",
                           TRAIN_FAULT)
    share_fault = loss_share(faulty["losses"], needle["losses"])
    if not share_fault > 1:
        raise AssertionError(f"train needle: the loss limit passes a backward "
                             f"with {TRAIN_FAULT} ({share_fault:.3f} of it)")
    jax_steps = sorted(ref["losses"])
    share_jax = check_losses(
        "train needle kernels vs JAX on the CPU",
        [needle["losses"][i] for i in jax_steps],
        [ref["losses"][i] for i in jax_steps])
    log(f"train needle: losses through the kernels within {share:.3f} of "
        f"the limit ({TRAIN_LOSS_TOL} relative) of the plain versions' at "
        f"every step, and within {share_jax:.3f} of it of the JAX example's "
        f"on the CPU at steps {jax_steps} ({[ref['losses'][i] for i in jax_steps]}); "
        f"a backward with {TRAIN_FAULT} {share_fault:.1f}x the limit")
    torch.cuda.empty_cache()

    rcfg = train_ruler_lm_torch.model_config()
    shape = ["--batch", "8", "--seq", "8192", "--pool", str(RULER_POOL),
             "--out", str(out / "ruler_lm.npz")]
    argv = ["--steps", str(RULER_STEPS), *shape]
    ruler = train_counted(torch, train_ruler_lm_torch, argv,
                          rcfg.num_hidden_layers, "ruler-byte-lm B=8 S=8192")
    profile_train(torch, train_ruler_lm_torch, shape, ruler["step_ms"],
                  "ruler-byte-lm B=8 S=8192")
    ruler_plain = train_counted(torch, train_ruler_lm_torch, argv,
                                rcfg.num_hidden_layers,
                                f"ruler-byte-lm {TRAIN_PLAIN}", TRAIN_PLAIN)
    share_r = check_losses("train ruler-lm kernels vs plain",
                           ruler["losses"], ruler_plain["losses"])
    torch.cuda.empty_cache()
    for label, run, row, layers in (
            ("needle-12m B=32 S=1024", needle, "flash_prefill_bwd",
             cfg.num_hidden_layers),
            ("ruler-byte-lm B=8 S=8192", ruler, "flash_prefill_bwd_8192",
             rcfg.num_hidden_layers)):
        r = rows[row]
        log(f"train {label} on {smi}: {run['step_ms']:.1f} ms per step; "
            f"flash_prefill_bwd {layers} launches per step, "
            f"{r['ms']:.3f} ms each (device {r['device_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.3f} ms by {r['bound'][1]}, plain "
            f"{r['plain_ms']:.1f} ms, SDPA's backward "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} ms)")
    log(f"train ruler-lm: losses through the kernels within {share_r:.3f} of "
        f"the limit of the plain versions' at every step")
    llama_3b = phase_train_3b(torch)
    tiny = phase_train_tiny(torch)
    r = rows["flash_prefill_bwd_d128_g3"]
    log(f"train {llama_3b['label']} on {smi}: {llama_3b['run']['step_ms']:.1f} "
        f"ms per step; flash_prefill_bwd_d128 {llama_3b['layers']} launches "
        f"per step, {r['ms']:.3f} ms each (device {r['device_ms']:.3f} ms, "
        f"bound {r['bound'][0]:.3f} ms by {r['bound'][1]}, plain "
        f"{r['plain_ms']:.1f} ms, SDPA's backward "
        f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} ms)")
    return dict(rows=rows, needle=needle, ruler=ruler, llama_3b=llama_3b,
                tiny=tiny)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"phase 0 device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from magicpig_tpu_torch.ops.kernels import _lib

    t = time.perf_counter()
    so = _lib.build()
    _lib.library()
    regs = [l.split("Used")[1].split(",")[0].strip()
            for l in _lib.last_build_log.splitlines() if "Used" in l]
    spills = [l.strip() for l in _lib.last_build_log.splitlines()
              if "spill" in l and not l.strip().startswith("0 bytes stack")]
    log(f"phase 1 build: {so.name} in {time.perf_counter() - t:.1f} s "
        f"(nvcc {_lib.last_build_seconds}; each source done at "
        f"{ {k: round(v, 1) for k, v in _lib.last_source_seconds.items()} }"
        f" s); registers {regs}; "
        f"spills {spills or 'none'}")
    dump = start_sass_dump(so)
    try:
        log("phase 2 kernels vs plain versions")
        kern = phase_kernels(torch, F, dev)
        torch.cuda.empty_cache()
        kern.update(phase_kernels_d128(torch, F, dev))
        torch.cuda.empty_cache()
        kern.update(phase_block_kernels(torch, dev))
        torch.cuda.empty_cache()
        kern.update(serve_attend_kernels(torch, dev))
        torch.cuda.empty_cache()
        kern.update(phase_w4_kernel(torch, dev))
        torch.cuda.empty_cache()
        kern.update(phase_block_kernels(torch, dev, d=128))
        torch.cuda.empty_cache()
        kern.update(serve_attend_kernels(torch, dev, d=128))
        torch.cuda.empty_cache()
        kern.update(phase_w4_kernel(torch, dev, W4_SHAPES_8B))
        torch.cuda.empty_cache()
        kern.update(phase_w4_kernel(torch, dev, W4_SHAPES_TP, m=1))
        torch.cuda.empty_cache()
        kern.update(phase_kernels_g3(torch, F, dev))
        torch.cuda.empty_cache()
        kern.update(phase_kernels_long(torch, F, dev))
        torch.cuda.empty_cache()
        kern.update(phase_kernels_window(torch, F, dev))
        torch.cuda.empty_cache()
        forms_rows = phase_kernels_forms(torch, F, dev)
        kern.update(forms_rows)
        torch.cuda.empty_cache()
        sass = sass_counts(dump)
    finally:
        dump[0].kill()
        dump[0].wait()
    log(f"phase 1 SASS ({', '.join(SASS_OPS)} instructions): {sass}")
    check_sass(sass)

    log("phase 3 serve llama-3.2-1b")
    serve = phase_serve(torch, dev)
    torch.cuda.empty_cache()
    sampled, odd = phase_serve_two_stage(torch, dev, serve)
    torch.cuda.empty_cache()
    params, prompts = serve.pop("params"), serve.pop("prompts")
    del serve["projections"]
    block = phase_serve_block(torch, dev, params, prompts)
    del params
    torch.cuda.empty_cache()
    lsh_mode, full_int8, block_topk4 = phase_serve_bench_modes(torch, dev,
                                                               prompts)
    del prompts
    gc.collect()         # the 1B engines (their graphs hold them in cycles)
    torch.cuda.empty_cache()
    log("phase 3 serve llama-3.1-8b")
    (serve_8b, odd_8b, lsh_8b, block_topk4_8b,
     full_int8_8b) = phase_serve_8b(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 3 serve llama-3.2-3b")
    serve_3b = phase_serve_3b(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 3 serve smollm2-360m and llama-3.1-405b (4 layers): the "
        "kernels' general tile")
    serve_forms = phase_serve_forms(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 3 serve mistral-7b-v0.1 (sliding window)")
    serve_mistral = phase_serve_mistral(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 3 load_checkpoint (examples/generation_torch.py runs beside "
        "phase 4)")
    start_generation, finish_generation = phase_checkpoint(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3 serve llama-3.2-1b at {LONG_P} tokens")
    long_lsh, long_bt4 = phase_serve_long(torch, dev)
    log("phase 3 serve llama-3.2-1b through the Scheduler")
    sched = phase_serve_scheduler(torch, dev)
    phase_serve_idle(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 3 sharded serving over torch.distributed (NCCL at one rank, "
        "then gloo ranks sharing the card)")
    sharded = phase_sharded(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 4 reference on a small input, examples/generation_torch.py "
        "on the checkpoint beside it")
    start_generation()
    try:
        store = phase_reference(torch, dev)
        masked_forms = phase_reference_two_stage(torch, dev)
        forms_d128 = phase_reference_d128(torch, dev)
        forms_g3 = phase_reference_g3(torch, dev)
        chunked = phase_reference_chunked(torch, dev)
        window = phase_reference_window(torch, dev)
        forms_cut = phase_reference_forms(torch, dev)
        phase_reference_baselines(torch, dev)
    except BaseException:
        finish_generation(kill=True)
        raise
    finish_generation()
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 5 train: the backward kernel, needle-12m, ruler-byte-lm, a "
        "llama-3.2-3b cut and llama-tiny")
    train = phase_train(torch, F, smi)
    kern.update(train["rows"])

    # Each kernel's launches come from the counted run of the path that
    # uses it: the LSH serve, the block_topk int8 serve (rescore pipeline),
    # the block_topk bf16 reference (store pipeline), bench.py's lsh mode
    # (int8 LSH), its full_int8 mode with int4 weights (int8 decode, int4
    # matmul), its block_topk4 mode (the packed scorer and rescore), and
    # phase 4's int4 cuts (the packed store scorer, the debias forms).
    launches = {**serve["launches"],
                "block_rank": block["launches"]["block_rank"],
                "rescore_attend": block["launches"]["rescore_attend"],
                "exact_scores_ranked": store["exact_scores_ranked"],
                "block_attend": store["block_attend"],
                "lsh_fused_decode_int8":
                    lsh_mode["launches"]["lsh_fused_decode_int8"],
                "flash_decode_int8": full_int8["launches"]["flash_decode_int8"],
                "w4_matmul": full_int8["launches"]["w4_matmul"],
                "block_rank_int4": block_topk4["launches"]["block_rank_int4"],
                "rescore_attend_int4":
                    block_topk4["launches"]["rescore_attend_int4"],
                **{name: store[name] for name in (
                    "exact_scores_ranked_int4", "lsh_fused_decode_poly",
                    "lsh_fused_decode_none", "lsh_fused_decode_int8_poly",
                    "lsh_fused_decode_int8_none")},
                "collision_words": sampled["launches"]["collision_words"],
                "lsh_masked_attention":
                    odd["launches"]["lsh_masked_attention"],
                **masked_forms}
    # No path of the port (or of the JAX package) calls the scores-only
    # scorer, so its count stands as the LSH serve measured it; every counted
    # run above holds every kernel not on its path, this one too, at 0.
    score_src = ("magicpig_tpu_torch/csrc/block_score.cu",
                 "magicpig_tpu/ops/pallas/score.py:225")
    sources = {"flash_prefill": ("magicpig_tpu_torch/csrc/flash_prefill.cu",
                                 "magicpig_tpu/ops/pallas/prefill.py:249"),
               "flash_decode": ("magicpig_tpu_torch/csrc/flash_decode.cu",
                                "magicpig_tpu/ops/pallas/decode.py:184"),
               "lsh_fused_decode": ("magicpig_tpu_torch/csrc/lsh_fused.cu",
                                    "magicpig_tpu/ops/pallas/lsh_fused.py:286"),
               "block_rank": score_src,
               "exact_scores_ranked": score_src,
               "rescore_attend": ("magicpig_tpu_torch/csrc/rescore_attend.cu",
                                  "magicpig_tpu/ops/pallas/rescore_attend.py:217"),
               "block_attend": ("magicpig_tpu_torch/csrc/block_attend.cu",
                                "magicpig_tpu/ops/pallas/block_attend.py:224"),
               "w4_matmul": ("magicpig_tpu_torch/csrc/w4_matmul.cu",
                             "magicpig_tpu/ops/pallas/w4_matmul.py:121")}
    sources["collision_words"] = ("magicpig_tpu_torch/csrc/collision_words.cu",
                                  "magicpig_tpu/ops/pallas/collide.py:76")
    # With lengths (the serves' call): the same kernel and count, the other
    # pallas_call site.
    sources["collision_words_length"] = (sources["collision_words"][0],
                                         "magicpig_tpu/ops/pallas/mask.py:87")
    launches["collision_words_length"] = launches["collision_words"]
    sources["lsh_masked_attention"] = (
        "magicpig_tpu_torch/csrc/lsh_masked.cu",
        "magicpig_tpu/ops/pallas/lsh_decode.py:271")
    sources["exact_scores"] = score_src
    # The training backward: no TPU kernel (the JAX package's backward is
    # XLA); its launches from the trainers' kernel runs, the windowed cut's
    # as the needle run's.
    launches_of_bwd = {}
    bwd_src = ("magicpig_tpu_torch/csrc/flash_prefill_bwd.cu",
               "magicpig_tpu/ops/attention.py:216")
    for name, run in (("flash_prefill_bwd", train["needle"]),
                      ("flash_prefill_bwd_8192", train["ruler"]),
                      ("flash_prefill_bwd_window", train["needle"])):
        sources[name] = bwd_src
        launches[name] = run["launches"]["flash_prefill_bwd"]
    # The other forms: each head dim's count from the run at that head dim
    # (the 3B cut at d = 128, whose count the G = 16 and windowed d = 128
    # rows share; the needle's at d = 64 for SmolLM2's G = 3; llama-tiny's
    # d 16 and d 32 runs).
    for name, counter, run, of in (
            ("flash_prefill_bwd_d128_g3", "flash_prefill_bwd_d128",
             train["llama_3b"]["run"], "llama-3.2-3b"),
            ("flash_prefill_bwd_d128_g16", "flash_prefill_bwd_d128",
             train["llama_3b"]["run"], "llama-3.2-3b"),
            ("flash_prefill_bwd_d128_g3_window", "flash_prefill_bwd_d128",
             train["llama_3b"]["run"], "llama-3.2-3b"),
            ("flash_prefill_bwd_g3", "flash_prefill_bwd", train["needle"],
             "needle-12m"),
            ("flash_prefill_bwd_d16_window", "flash_prefill_bwd_d16",
             train["tiny"][16], "llama-tiny d16"),
            ("flash_prefill_bwd_d32", "flash_prefill_bwd_d32",
             train["tiny"][32], "llama-tiny d32")):
        sources[name] = bwd_src
        launches[name] = run["launches"][counter]
        launches_of_bwd[name] = f"{counter} {of}"
    sources["flash_decode_int8"] = sources["flash_decode"]
    # The fused LSH kernel's instances compile in one source per K/V type
    # and head dim (lsh_fused.cu holds bf16 at d = 64 and the C entry).
    for form in ("_int8", "_poly", "_none", "_int8_poly", "_int8_none"):
        sources["lsh_fused_decode" + form] = (
            (sources["lsh_fused_decode"][0].replace(".cu", "_int8.cu")
             if "_int8" in form else sources["lsh_fused_decode"][0]),
            sources["lsh_fused_decode"][1])
        sources["lsh_masked_attention" + form] = sources["lsh_masked_attention"]
    for name in ("block_rank", "exact_scores_ranked", "rescore_attend"):
        sources[name + "_int4"] = sources[name]
    # The head-dim-128 forms: their kernels' sources (the fused LSH
    # kernel's in lsh_fused_d128.cu and lsh_fused_int8_d128.cu, the masked
    # attend's in lsh_masked_d128.cu and lsh_masked_int8_d128.cu), launches
    # from the run of the path that uses each: the 8B serves (bf16 LSH, odd
    # L; bench.py's lsh, block_topk4 and full_int8 modes) and phase 4's d =
    # 128 cuts. The 12000-token prefill and the hot cache share their
    # form's.
    for name, run in (("flash_prefill_d128", serve_8b["launches"]),
                      ("flash_decode_d128", serve_8b["launches"]),
                      ("lsh_fused_decode_d128", serve_8b["launches"]),
                      ("lsh_masked_attention_d128", odd_8b["launches"]),
                      ("lsh_fused_decode_int8_d128", lsh_8b["launches"]),
                      ("flash_decode_int8_d128", full_int8_8b["launches"]),
                      ("block_rank_int4_d128", block_topk4_8b["launches"]),
                      ("rescore_attend_int4_d128",
                       block_topk4_8b["launches"]),
                      *((name, forms_d128) for name in forms_d128)):
        base = name[:-len("_d128")]
        src = sources[base][0]
        if base.startswith("lsh_masked"):
            src = src.replace(".cu", ("_int8" if "_int8" in base else "")
                              + "_d128.cu")
        elif base.startswith("lsh_fused"):
            src = src.replace(".cu", "_d128.cu")
        sources[name] = (src, sources[base][1])
        launches[name] = run[name]
    # The phase-2 shapes of the serve's own calls: its 12000-token prompt
    # and the hot caches; launches as their kernel's.
    for shape, kernel in (("flash_prefill_12000", "flash_prefill"),
                          ("flash_decode_hot", "flash_decode"),
                          ("flash_decode_int8_hot", "flash_decode_int8"),
                          ("flash_prefill_d128_12000", "flash_prefill_d128"),
                          ("flash_decode_d128_hot", "flash_decode_d128"),
                          *((f"{name}_d128_serve", f"{name}_d128") for name in (
                              "rescore_attend", "rescore_attend_int4",
                              "block_attend"))):
        sources[shape] = sources[kernel]
        launches[shape] = launches[kernel]
    # The serve-shape rows and the other int4 products: their kernel's
    # source. Rows of one kernel at two shapes share its count:
    # `launches_of` names the count a row's `launches` is, and rows that
    # name the same one must not be summed. The int4 products' rows each
    # carry their own shape's share of the serve's count (the lm_head's in
    # the `w4_matmul` row).
    launches_of = {}
    for shape, kernel in (("flash_prefill_12000", "flash_prefill"),
                          ("flash_decode_hot", "flash_decode"),
                          ("flash_decode_int8_hot", "flash_decode_int8"),
                          ("flash_prefill_d128_12000", "flash_prefill_d128"),
                          ("flash_decode_d128_hot", "flash_decode_d128"),
                          ("collision_words_length", "collision_words"),
                          *((f"{name}_d128_serve", f"{name}_d128") for name in (
                              "rescore_attend", "rescore_attend_int4",
                              "block_attend"))):
        launches_of[shape] = kernel
    launches_of["flash_prefill_bwd_8192"] = "flash_prefill_bwd ruler-byte-lm"
    launches_of["flash_prefill_bwd_window"] = "flash_prefill_bwd"
    launches_of.update(launches_of_bwd)
    for name in ("rescore_attend", "rescore_attend_int4", "block_attend"):
        sources[name + "_serve"] = sources[name]
        launches[name + "_serve"] = launches[name]
        launches_of[name + "_serve"] = name
    # The scan at K=8, L=75: the odd-L serve's count (the sampled serve's
    # is the K=10, L=150 rows').
    sources["collision_words_l75"] = sources["collision_words"]
    launches["collision_words_l75"] = odd["launches"]["collision_words"]
    launches_of["collision_words_l75"] = "collision_words odd L"
    # Group size 3 at d = 128 (rows "..._g3"): the kernel of the row's d =
    # 128 form; launches from the 3B serve (the bf16 decode and the fused
    # LSH kernel) or phase 4's G = 3 cut (every other form, the scan's
    # rows from its odd-L run). A row's shapes share one count.
    g3_runs = {**forms_g3,
               "flash_decode_d128": serve_3b["launches"]["flash_decode_d128"],
               "lsh_fused_decode_d128":
                   serve_3b["launches"]["lsh_fused_decode_d128"]}
    for name in kern:
        if ("_g3" not in name or name in forms_rows
                or name.startswith("flash_prefill_bwd")):
            continue
        form = name.replace("_g3", "").removesuffix("_serve").removesuffix(
            "_hot")
        if form.startswith("collision_words"):
            form = "collision_words"
        sources[name] = sources[form]
        launches[name] = g3_runs[form]
        launches_of[name] = form + " G=3"
    # MagicPIG's context length (rows "..._98k"): launches from the 98K
    # serves (bf16 LSH; block_topk4), the store pipeline's from phase 4;
    # the prefill at a query offset from the interleaved Scheduler serve
    # (its chunks times the layers) and, at d = 128, phase 4's chunked cut.
    for name, form, count in (
            ("flash_decode_98k", "flash_decode",
             long_lsh["launches"]["flash_decode"]),
            ("flash_decode_int8_98k", "flash_decode_int8",
             long_bt4["launches"]["flash_decode_int8"]),
            ("lsh_fused_decode_98k", "lsh_fused_decode",
             long_lsh["launches"]["lsh_fused_decode"]),
            ("block_rank_int4_98k", "block_rank_int4",
             long_bt4["launches"]["block_rank_int4"]),
            ("rescore_attend_int4_98k", "rescore_attend_int4",
             long_bt4["launches"]["rescore_attend_int4"]),
            ("exact_scores_ranked_int4_98k", "exact_scores_ranked_int4",
             launches["exact_scores_ranked_int4"]),
            ("flash_prefill_q_offset", "flash_prefill",
             sched["inter"]["launches"]["flash_prefill"]),
            ("flash_prefill_d128_q_offset", "flash_prefill_d128",
             chunked["flash_prefill_d128"])):
        sources[name] = sources[form]
        launches[name] = count
        launches_of[name] = (form if name.startswith("exact") else
                             f"{form} {'chunked' if 'q_offset' in name else '98K'}")
    # The sliding window (rows "..._window"): the prefill's and the bf16
    # decode's launches from the Mistral-7B-v0.1 serve (every dense and hot
    # decode there takes a first row), the int8 decode's from phase 4's
    # windowed int8 cut.
    for name, form, count in (
            ("flash_prefill_d128_window", "flash_prefill_d128",
             serve_mistral["launches"]["flash_prefill_d128"]),
            ("flash_decode_d128_window", "flash_decode_d128",
             serve_mistral["launches"]["flash_decode_d128"]),
            ("flash_decode_d128_hot_window", "flash_decode_d128",
             serve_mistral["launches"]["flash_decode_d128"]),
            ("flash_decode_int8_d128_window", "flash_decode_int8_d128",
             window["flash_decode_int8_d128"])):
        sources[name] = sources[form]
        launches[name] = count
        launches_of[name] = f"{form} window"
    # The general tile's forms and the small head dims (`phase_kernels_forms`,
    # rows named as their launch counters): their instances' sources; the
    # launches from the first run of the path that uses each, SmolLM2-360M's
    # serves, the 405B cut's and phase 4's small-head-dim cuts. A form that
    # no serve or cut runs counts 0.
    form_runs = (("smollm2-360m LSH", serve_forms["smollm2"]["launches"]),
                 ("smollm2-360m block_topk int8",
                  serve_forms["smollm2_block"]["launches"]),
                 ("smollm2-360m odd L", serve_forms["smollm2_odd"]["launches"]),
                 ("llama-3.1-405b LSH", serve_forms["405b"]["launches"]),
                 ("llama-3.1-405b block_topk int8",
                  serve_forms["405b_block"]["launches"]),
                 ("phase 4 head dim 16 / 32 cuts", forms_cut))
    for name in forms_rows:
        counter = name.replace("_length", "").replace("_l75", "")
        base = re.sub(r"_d(16|32|128)|_g\d+", "", counter)
        src, replaces = sources[base]
        if name.startswith("collision_words_length"):
            replaces = sources["collision_words_length"][1]
        part = base.split("_int")[0].removesuffix("_poly").removesuffix(
            "_none")
        part_src = {"lsh_fused_decode": "lsh_fused_part{}.cu",
                    "lsh_masked_attention": "lsh_masked_part{}.cu",
                    "block_rank": "block_score_part.cu",
                    "exact_scores_ranked": "block_score_part.cu",
                    "rescore_attend": "chunk_attend_part.cu",
                    "block_attend": "chunk_attend_part.cu"}.get(part)
        if part_src is not None:
            src = "magicpig_tpu_torch/csrc/" + part_src.format(
                "_int8" if "_int8" in base and part.startswith("lsh") else "")
        sources[name] = (src, replaces)
        run = next(((label, r[counter]) for label, r in form_runs
                    if r.get(counter)), (None, 0))
        launches[name] = run[1]
        launches_of[name] = (f"{counter} {run[0]}" if run[0] else
                             f"{counter}: no serve or cut at this form")
    for shapes, run, where in (
            (W4_SHAPES, full_int8, ""), (W4_SHAPES_8B, full_int8_8b, ""),
            (W4_SHAPES_TP, sharded["gloo"]["block"],
             " rank 0 of the 2x2 block_topk4 run")):
        for name, kin, out in shapes:
            sources[name] = sources["w4_matmul"]
            launches[name] = run["w4_shapes"][f"{kin}x{out}"]
            launches_of[name] = f"w4_matmul {kin}x{out}{where}"
    kernels = []
    for name, r in kern.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "launches_of": launches_of.get(name, name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"]})
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
