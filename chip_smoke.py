#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`magicpig_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # one CUDA card, no arguments

Phases, each announced by one flushed progress line with elapsed seconds:
  0. device: a CUDA card or exit non-zero; its name and power limit;
  1. build: the kernels of `magicpig_tpu_torch/csrc/` with one nvcc call;
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the shapes of the Llama-3.2-1B decode path (Hq 32, Hkv 8, d 64;
     prefill 8192 tokens, decode and LSH over 16384 tokens at B=2, K=10,
     L=150), within `TOL` of it, with its time, its plain version's, a
     library call's where one computes the same function, and the least
     time the card could take; each tolerance must also reject the plain
     version run with one 64-token V tile zeroed (a skipped tile);
  3. serve: `LLM("llama-3.2-1b")` at full width and depth with random
     weights drawn on the card; two requests (12000 and 7000 tokens)
     prefilled into slots 0 and 1, 32 greedy decode steps, clear(), a third
     request (9000 tokens) and 16 more steps; every kernel launch of this
     run is counted and must equal what the path implies. Then a profiled
     pass: a warm prefill and 8 decode steps under torch.profiler (wall,
     device busy time, idle share, launches, kernels by device time);
  4. reference: a two-layer cut of the same width at K=1, L=32 (nearly
     every key sampled) on the card against the same engine on the CPU
     (the plain versions).
Any failure raises. The last two lines are the kernels' JSON and the result
JSON; the card's name and power limit come just before them.
"""

import json
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak

# Each kernel against its plain version on the card, as (atol, rtol,
# rms_share): |kernel - plain| <= atol + rtol * |plain| + rms_share *
# rms(plain) everywhere (rms over the finite entries). The prefill output
# is bf16: one rounding step of it is up to 2^-7 of its value, and the
# kernel's bf16 probabilities in P.V move an early query's output, a mix of
# a few V rows, by a few 1e-3 in the units of V. The decode partials are
# f32 and differ by the plain version's bf16 probabilities, an error that
# scales with the output: under 0.01 of its rms. The lse differs by f32
# rounding alone.
TOL = {
    "flash_prefill": (4e-3, 1e-2, 0.0),
    "flash_decode": (0.0, 0.0, 0.015),
    "lsh_fused_decode": (0.0, 0.0, 0.015),
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
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=_device_us, reverse=True)
    return (sum(map(_device_us, kernels)) / 1e3,
            sum(e.count for e in kernels), kernels)


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call: the kernel time torch.profiler records over
    `calls` calls, divided by `calls` (no host time between launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return profiled(lambda: [fn() for _ in range(calls)])[0] / calls


def timings(kernel, plain, library=None) -> dict:
    """Event time per call (the kernel's `ms`) and profiler device time of
    the kernel, its plain version and the library call."""
    return dict(
        ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
        library_ms=None if library is None else cuda_ms(library),
        device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
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


def check_rejects(name, faulty, want, tol) -> float:
    """The tolerance can see a fault: the plain version run on V with one
    64-token tile zeroed (a kernel that skipped a tile) must fail it.
    Returns how many times its limit that fault's worst element is."""
    share = limit_share(faulty, want, tol)[1]
    if not share > 1:
        raise AssertionError(f"{name}: the tolerance {tol} passes a skipped "
                             f"64-token V tile")
    return share


def drop_tile(v, dim: int, start: int):
    """A copy of v with the 64 tokens from `start` along `dim` zeroed."""
    v = v.clone()
    v.narrow(dim, start, 64).zero_()
    return v


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, F, dev):
    """Each kernel against its plain version at the slice's shapes."""
    from magicpig_tpu_torch.ops import attention, bitcodes
    from magicpig_tpu_torch.ops.kernels import (flash_decode, flash_prefill,
                                                lsh_fused_decode)
    from magicpig_tpu_torch.ops.kernels.lsh_fused import lsh_fused_decode_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    hq, hkv, d, K, L = 32, 8, 64, 10, 150
    results = {}

    # -- flash prefill: one 8192-token prompt, causal.
    s = 8192
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    length = torch.full((1,), s, dtype=torch.int32, device=dev)
    got = flash_prefill(q, k, v, length)
    want = attention.flash_prefill(q, k, v, length)
    tol = TOL["flash_prefill"]
    err, share = check_close("flash_prefill", got, want, tol)
    teeth = check_rejects("flash_prefill", attention.flash_prefill(
        q, k, drop_tile(v, 1, 4096), length), want, tol)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())          # q, out, k, v
    flops = 4 * d * hq * (s * (s + 1) // 2)
    results["flash_prefill"] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        **timings(lambda: flash_prefill(q, k, v, length),
                  lambda: attention.flash_prefill(q, k, v, length),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True)))
    log(f"kernel flash_prefill  err {err:.2e}, worst element "
        f"{share:.2f} of its limit (tol {tol}); a "
        f"skipped tile's worst element {teeth:.1f}x the limit")
    del q, k, v, got, want, qt, kt, vt

    # -- flash decode: B=2 over a 16384-token cache, one request ragged.
    b, s = 2, 16384
    lens = [16384, 11000]
    q, k, v = rnd(b, hq, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    (got, got_lse) = flash_decode(q, k, v, length)
    (want, want_lse) = attention.full_decode(q, k, v, length)
    tol = TOL["flash_decode"]
    err, share = check_close("flash_decode", got, want, tol)
    err = max(err, check_close("flash_decode lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects("flash_decode", attention.full_decode(
        q, k, drop_tile(v, 2, 8192), length)[0], want, tol)
    mask = (torch.arange(s, device=dev)[None] < length[:, None])[:, None, None]
    q4 = q[:, :, None]
    nbytes = (sum(lens) * hkv * d * 2 * 2 + q.numel() * 2
              + b * hq * (d + 1) * 4)
    flops = 4 * d * hq * sum(lens)
    results["flash_decode"] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        **timings(lambda: flash_decode(q, k, v, length),
                  lambda: attention.full_decode(q, k, v, length),
                  lambda: F.scaled_dot_product_attention(
                      q4, k, v, attn_mask=mask, enable_gqa=True)))
    log(f"kernel flash_decode   err {err:.2e}, worst element "
        f"{share:.2f} of its limit (tol {tol}); a "
        f"skipped tile's worst element {teeth:.1f}x the limit")

    # -- fused LSH decode: the same caches as centered keys, K=10, L=150.
    proj = torch.randn((d, K * L), generator=gen, device=dev)
    k_norm = k.float().norm(dim=-1)
    planes = torch.stack([bitcodes.build_planes(k[i].transpose(0, 1), proj, K)
                          for i in range(b)])
    q_bits = bitcodes.hash_bits(q, proj, K)
    got, got_lse, got_cnt = lsh_fused_decode(q, k, v, k_norm, planes, q_bits,
                                             length, K, L)
    want, want_lse, want_cnt = lsh_fused_decode_plain(q, k, v, k_norm, planes,
                                                      q_bits, length, K, L)
    if not torch.equal(got_cnt, want_cnt):
        raise AssertionError("lsh_fused_decode: sampled counts differ")
    tol = TOL["lsh_fused_decode"]
    err, share = check_close("lsh_fused_decode", got, want, tol)
    err = max(err, check_close("lsh_fused_decode lse", got_lse, want_lse,
                               TOL["lse"])[0])
    teeth = check_rejects("lsh_fused_decode", lsh_fused_decode_plain(
        q, k, drop_tile(v, 2, 8192), k_norm, planes, q_bits, length, K,
        L)[0], want, tol)
    # Bytes this run needs: every valid signature word; K, V and the norm
    # of the tokens some head of the group sampled; q, its bits, outputs.
    sampled = bitcodes.sampled_mask(q_bits, planes, length)    # [B, Hq, S]
    rows = int(sampled.reshape(b, hkv, -1, s).any(dim=2).sum())
    words = sum((n + 31) // 32 for n in lens) * hkv * L * K
    nbytes = (words * 4 + rows * (2 * d * 2 + 4) + q.numel() * 2
              + q_bits.numel() * 4 + b * hq * (d + 2) * 4)
    flops = 4 * d * int(want_cnt.sum())
    results["lsh_fused_decode"] = dict(
        max_abs_err=err, tol=tol, bound=bound_ms(nbytes, flops),
        **timings(lambda: lsh_fused_decode(q, k, v, k_norm, planes, q_bits,
                                           length, K, L),
                  lambda: lsh_fused_decode_plain(q, k, v, k_norm, planes,
                                                 q_bits, length, K, L)),
        sampled_frac=float(want_cnt.sum()) / (hq * sum(lens)),
        rows_frac=rows / (hkv * sum(lens)))
    log(f"kernel lsh_fused      err {err:.2e}, worst element "
        f"{share:.2f} of its limit (tol {tol}); a "
        f"skipped tile's worst element {teeth:.1f}x the limit; counts exact, "
        f"sampled {results['lsh_fused_decode']['sampled_frac']:.4f}, "
        f"rows read {results['lsh_fused_decode']['rows_frac']:.4f}")
    for name, r in results.items():
        lib = ("-" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f})")
        log(f"  {name}: ms per call (device ms): kernel {r['ms']:.4f} "
            f"({r['device_ms']:.4f})  plain {r['plain_ms']:.4f} "
            f"({r['plain_device_ms']:.4f})  library {lib}  bound "
            f"{r['bound'][0] * 1e3:.1f} us ({r['bound'][1]})")
    return results


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
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def decode(tokens, n):
        nonlocal finite
        for _ in range(n):
            logits = llm.inference(tokens)
            if logits.shape != (2, cfg.vocab_size):
                raise AssertionError(f"logits shape {tuple(logits.shape)}")
            finite = finite & torch.isfinite(logits).all()
            tokens = logits.argmax(dim=-1)
        return tokens

    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    l0 = llm.prefill(prompts[0], request_id=0)
    l1 = llm.prefill(prompts[1], request_id=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    finite = finite & torch.isfinite(l0).all() & torch.isfinite(l1).all()
    first = torch.cat([l0.argmax(-1), l1.argmax(-1)])
    t = time.perf_counter()
    decode(first, 32)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / 32
    log(f"serve: prefill 12000 + 7000 tokens {prefill_s:.2f} s, "
        f"decode B=2 {decode_ms:.2f} ms/step")
    llm.clear()
    t = time.perf_counter()
    l2 = llm.prefill(prompts[2], request_id=0)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t
    finite = finite & torch.isfinite(l2).all()
    t = time.perf_counter()
    decode(torch.cat([l2.argmax(-1), l2.argmax(-1)]), 16)
    torch.cuda.synchronize()
    decode2_ms = (time.perf_counter() - t) * 1e3 / 16
    launches = dict(LAUNCHES)
    layers = cfg.num_hidden_layers
    n_dense = sum(1 for kind, _ in llm.groups if kind == "dense")
    steps = 32 + 16
    expect = {"flash_prefill": layers * 3,
              "flash_decode": (n_dense + (layers - n_dense)) * steps,
              "lsh_fused_decode": (layers - n_dense) * steps}
    log(f"serve: after clear(), prefill 9000 tokens {prefill2_s:.2f} s, "
        f"decode {decode2_ms:.2f} ms/step; avg sparsity "
        f"{llm.avg_sparsity:.5f}; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launches {launches} != path's {expect}")
    if not 0 < llm.avg_sparsity < 1:
        raise AssertionError(f"avg sparsity {llm.avg_sparsity} not in (0, 1)")

    # Where the time goes: the two first requests again, a warm prefill
    # timed and then profiled, 4 warm-up decode steps, 8 steps timed and 8
    # profiled. The idle share sets the profiled device time against the
    # unprofiled wall time (the profiler's own cost is on the host).
    llm.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    llm.prefill(prompts[0], request_id=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    busy, n, kernels = profiled(lambda: llm.prefill(prompts[0], request_id=0))
    log(f"profile: prefill 12000 tokens wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
        f"{n} launches")
    for e in kernels[:6]:
        log(f"  {_device_us(e) / 1e3:9.2f} ms {e.count:5d} calls  {e.key[:70]}")
    l1 = llm.prefill(prompts[1], request_id=1)
    tokens = decode(torch.cat([l0.argmax(-1), l1.argmax(-1)]), 4)
    t = time.perf_counter()
    tokens = decode(tokens, 8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / 8
    busy, n, kernels = profiled(lambda: decode(tokens, 8))
    busy /= 8
    log(f"profile: decode B=2, 12000 + 7000 tokens: wall {wall:.2f} ms/step, "
        f"device busy {busy:.3f} ms/step, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}, {n / 8:.0f} launches/step")
    for e in kernels[:8]:
        log(f"  {_device_us(e) / 8:9.1f} us/step {e.count / 8:5.1f} "
            f"calls/step  {e.key[:70]}")
    if not bool(finite):
        raise AssertionError("non-finite logits in the serve phase")
    return dict(prefill_s=prefill_s, decode_ms=decode_ms,
                prefill2_s=prefill2_s, decode2_ms=decode2_ms,
                avg_sparsity=llm.avg_sparsity, launches=launches)


def phase_reference(torch, dev):
    """Two layers at 1B width, K=1/L=32 (nearly all keys sampled): the card
    engine against the same engine on the CPU."""
    import dataclasses

    from magicpig_tpu_torch.config import LSHConfig, preset
    from magicpig_tpu_torch.runtime.engine import LLM

    cfg = dataclasses.replace(preset("llama-3.2-1b"), num_hidden_layers=2)
    lsh = LSHConfig(K=1, L=32, dense_layers=(0,))
    card = LLM(cfg, batch_size=1, max_length=2048, lsh=lsh, device=dev, seed=3)
    host = LLM(cfg, batch_size=1, max_length=2048, lsh=lsh, device="cpu",
               params=card.params.to("cpu"),
               projections=card.projections.cpu())
    prompt = torch.randint(1, cfg.vocab_size, (1500,),
                           generator=torch.Generator().manual_seed(5))
    a, b = card.prefill(prompt).cpu(), host.prefill(prompt)
    errs = [float((a - b).abs().max() / b.abs().max())]
    tok = b.argmax(-1)
    for _ in range(4):
        a, b = card.inference(tok).cpu(), host.inference(tok)
        errs.append(float((a - b).abs().max() / b.abs().max()))
        tok = b.argmax(-1)
    log(f"reference: 2-layer K=1/L=32 card vs CPU, max |logit err| / max "
        f"|logit| per call {['%.2e' % e for e in errs]}; sparsity card "
        f"{card.avg_sparsity:.4f} cpu {host.avg_sparsity:.4f}")
    # bf16 activations round differently on the two devices (2^-8 per
    # rounding); through two layers that stays well under 5%.
    if max(errs) > 5e-2 or min(card.avg_sparsity, host.avg_sparsity) < 0.9:
        raise AssertionError("card engine disagrees with the CPU engine")
    return errs


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
        f"(nvcc {_lib.last_build_seconds}); registers {regs}; "
        f"spills {spills or 'none'}")

    log("phase 2 kernels vs plain versions")
    kern = phase_kernels(torch, F, dev)
    torch.cuda.empty_cache()

    log("phase 3 serve llama-3.2-1b")
    serve = phase_serve(torch, dev)
    torch.cuda.empty_cache()

    log("phase 4 reference on a small input")
    phase_reference(torch, dev)

    sources = {"flash_prefill": ("magicpig_tpu_torch/csrc/flash_prefill.cu",
                                 "magicpig_tpu/ops/pallas/prefill.py:249"),
               "flash_decode": ("magicpig_tpu_torch/csrc/flash_decode.cu",
                                "magicpig_tpu/ops/pallas/decode.py:184"),
               "lsh_fused_decode": ("magicpig_tpu_torch/csrc/lsh_fused.cu",
                                    "magicpig_tpu/ops/pallas/lsh_fused.py:286")}
    kernels = []
    for name, r in kern.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
