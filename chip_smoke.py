#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build of every kernel in transformerengine_tpu_torch/csrc (nvcc,
     timed, with ptxas register and shared-memory reports);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time, the plain version's time, the
     time of one library call where one computes the same function, and
     its bound on this card; then its other dtypes, head dims, masks and
     options at small shapes;
  4. FP8-resident serving at LLAMA_8B width (seeded random weights, FP8
     KV cache, B = 8, prompts of 512 and 384 tokens, 32 new tokens)
     through prefill and decode_steps, with TTFT, decode ms/step, tok/s
     and each kernel's launch count held to its expectation;
  5. the card against the CPU, for three seeds: two layers at LLAMA_8B
     width with the same weights, equal fp8 payload bytes, the prefill's
     and every decode step's logits within tolerance, and equal greedy
     tokens.
Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
PROMPT_LENS = (512, 384)
NEW_TOKENS = 32
BATCH = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median device time of one call. The call is captured once in a CUDA
    graph and replayed between two CUDA events, so the time is the
    device's alone, without the host's launch overhead; the 50 MB L2 is
    flushed before every replay (the serving path reads each weight and
    cache once per step)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()        # first call outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times)


def check(name: str, got, ref, atol) -> float:
    """Holds every |got - ref| to ``atol``, a number or a tensor that
    broadcasts against ``ref``; returns the largest absolute error."""
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    ok = math.isfinite(err) and bool((diff <= atol).all())
    if isinstance(atol, float):
        limit = f"tolerance {atol:.1e}"
    else:
        used = float((diff / atol.clamp_min(1e-30)).max())
        limit = f"{used:.3f} of a tolerance of {float(atol.min()):.1e} " \
                f"to {float(atol.max()):.1e}"
    log(f"  {name}: max_abs_err {err:.3e} ({limit}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def row_tol(ref, rtol: float):
    """``rtol`` times the largest |ref| of each row (the last dimension):
    one head's output vector. Rows of zeros (padded queries) get none."""
    return rtol * ref.float().abs().amax(dim=-1, keepdim=True)


# Attention outputs in bf16 against their plain versions: rounding both to
# bf16 differs by at most one ulp, 2^-7 of the value at most; the softmax
# weights, rounded to bf16 on one side or at other running maxima, add a
# small share of that. Twice the one-ulp limit, of each row's largest
# element.
BF16_ROW_RTOL = 2 ** -6
# LSE is f32 on both sides: sums of up to 512 terms in another order
# differ by at most 512 f32 ulps of the sum, 3e-5 in its logarithm.
LSE_ATOL = 1e-4


def check_matvec(torch, timer, results):
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.ops.decode_matmul import (
        decode_tn_matvec, decode_tn_matvec_plain)
    log("[3a] decode_tn_matvec: the four decode GEMMs of one LLAMA_8B layer "
        "at M = 8 (x bf16, f32 out)")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"qkv": (6144, 4096), "out": (4096, 4096),
              "wi": (28672, 4096), "wo": (4096, 14336)}
    totals = {}
    for wname in ("fp8", "bf16"):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
                   flops=0.0, err=0.0)
        for gemm, (n, k) in shapes.items():
            x = torch.randn((BATCH, k), generator=g, device="cuda").to(
                torch.bfloat16)
            w = torch.randn((n, k), generator=g, device="cuda")
            s = (w.abs().amax() / 448.0).reshape(1)
            if wname == "fp8":
                w = (w / s).to(torch.float8_e4m3fn)
            else:
                w, s = w.to(torch.bfloat16), None
            got = decode_tn_matvec(x, w, s)
            torch.cuda.synchronize()
            ref = decode_tn_matvec_plain(x, w, s)
            # f32 sums over K in another order: relative to the largest
            # output, 1e-4 leaves room for K = 14336 terms.
            err = check(f"{wname} {gemm} N={n} K={k}", got, ref,
                        1e-4 * float(ref.abs().max()))
            tot["err"] = max(tot["err"], err)
            tot["ms"] += timer(lambda: decode_tn_matvec(x, w, s))
            tot["plain_ms"] += timer(lambda: decode_tn_matvec_plain(x, w, s))
            if wname == "bf16":
                wt = w.t()
                tot["library_ms"] += timer(
                    lambda: torch.mm(x, wt, out_dtype=torch.float32))
            tot["nbytes"] += (n * k * w.element_size() + BATCH * k * 2
                              + BATCH * n * 4)
            tot["flops"] += 2 * BATCH * n * k
        b_ms, b_by = bound_ms(tot["nbytes"], tot["flops"])
        log(f"  {wname} one layer (4 GEMMs): kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms'] if wname == 'bf16' else 'n/a'} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        totals[wname] = (tot, b_ms, b_by)
    tot, b_ms, b_by = totals["fp8"]
    results["decode_tn_matvec"] = dict(
        name="decode_tn_matvec", route="cuda",
        source="transformerengine_tpu_torch/csrc/decode_matvec.cu",
        replaces="transformerengine_tpu/ops/decode_matmul.py:246",
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="fp8 weights, the 4 GEMMs of one LLAMA_8B layer, M=8")
    _build.LAUNCHES.clear()


def mixed_lengths(torch, n: int, lens=PROMPT_LENS):
    return torch.tensor([lens[i % len(lens)] for i in range(n)],
                        dtype=torch.int32, device="cuda")


def check_flash(torch, timer, results):
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain)
    b, s, hq, hkv, d = BATCH, max(PROMPT_LENS), 32, 8, 128
    log(f"[3b] flash_attention fwd: prefill B={b} S={s} Hq={hq} Hkv={hkv} "
        f"D={d} bf16, padding-causal, lengths {PROMPT_LENS} mixed")
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(
        torch.bfloat16)
    lens = mixed_lengths(torch, b)
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, lens, lens, scale=scale, causal=True)
    torch.cuda.synchronize()
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    o_ref, lse_ref = flash_fwd_plain(qs, k, v, lens, lens, causal=True)
    err = check("O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
    check("LSE", lse, lse_ref, LSE_ATOL)
    ms = timer(lambda: flash_fwd(q, k, v, lens, lens, scale=scale,
                                 causal=True))
    plain_ms = timer(lambda: flash_fwd_plain(qs, k, v, lens, lens,
                                             causal=True))
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, :, None] < lens[:, None, None])
            & (pos[None, None, :] < lens[:, None, None]))[:, None]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
    pairs = sum(int(n) * (int(n) + 1) // 2 for n in lens.tolist()) * hq
    flops = 4 * d * pairs
    # Q, K and V are read over each sequence's valid rows only (padded
    # rows are masked and need no read); O and LSE are written in full.
    rows = int(lens.sum())
    nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) + 2 * b * s * hq * d \
        + 4 * b * hq * s
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f}"
        f" ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP)")
    results["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:2057",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"prefill B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16")


def check_decode_attention(torch, timer, results):
    from transformerengine_tpu_torch.inference.kv_cache import (
        calibrate_kv_scale, quantize_for_cache)
    from transformerengine_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    b, hq, hkv, d = BATCH, 32, 8, 128
    s_alloc = -(-(max(PROMPT_LENS) + NEW_TOKENS) // 128) * 128
    lens = mixed_lengths(torch, b) + NEW_TOKENS // 2
    log(f"[3c] decode_attention: B={b} Hq={hq} Hkv={hkv} D={d}, fp8 cache "
        f"(B, {s_alloc}, Hkv, D) with per-slot scales, lengths "
        f"{sorted(set(lens.tolist()))}")
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(
        torch.bfloat16)
    # Each slot's K and V at its own magnitude, 2^-4 to 2^3, so that the
    # per-slot scales differ by up to 128x and a kernel that took another
    # slot's scale would be far off.
    mag = 2.0 ** (torch.arange(b, device="cuda") - b // 2)
    k = torch.randn((b, s_alloc, hkv, d), generator=g, device="cuda") \
        * mag[:, None, None, None]
    v = torch.randn((b, s_alloc, hkv, d), generator=g, device="cuda") \
        * mag[:, None, None, None]
    kv_scale = calibrate_kv_scale(k, v, per_slot=True)
    kc = quantize_for_cache(k, kv_scale, torch.float8_e4m3fn)
    vc = quantize_for_cache(v, kv_scale, torch.float8_e4m3fn)
    dq = 1.0 / kv_scale
    out = decode_attention(q, kc, vc, lens, kv_scale=dq)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, kc, vc, lens, kv_scale=dq,
                                 scale=d ** -0.5, out_dtype=torch.bfloat16)
    # The kernel keeps the softmax weights in f32 (the reference's Pallas
    # form); the plain version rounds them to bf16 (its einsum form).
    err = check("O", out, ref, row_tol(ref, BF16_ROW_RTOL))
    ms = timer(lambda: decode_attention(q, kc, vc, lens, kv_scale=dq))
    plain_ms = timer(lambda: decode_attention_plain(
        q, kc, vc, lens, kv_scale=dq, scale=d ** -0.5,
        out_dtype=torch.bfloat16))
    total_len = int(lens.sum())
    nbytes = 2 * total_len * hkv * d + 2 * 2 * b * hq * d + 4 * b + 4 * b
    flops = 4 * hq * d * total_len
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="transformerengine_tpu_torch/csrc/decode_attention.cu",
        replaces="transformerengine_tpu/ops/decode_attention.py:146",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"decode B={b} Hq={hq} Hkv={hkv} D={d} fp8 cache")


def check_variants(torch) -> None:
    """The kernels' other dtypes, head dims, masks and options, at small
    shapes, each against its plain version on the card."""
    from transformerengine_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from transformerengine_tpu_torch.ops.decode_matmul import (
        decode_tn_matvec, decode_tn_matvec_plain)
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain)
    log("[3d] other variants at small shapes")
    g = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    f32, bf16, e4m3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
    # decode_tn_matvec: each M tier, ragged N, and K not a multiple of the
    # staged chunk; f32 sums in another order (1e-4 of the largest output).
    for m, n, k, xt, wt in ((3, 1000, 1040, f32, e4m3),
                            (12, 333, 4112, bf16, bf16),
                            (20, 300, 2064, f32, bf16),
                            (32, 1024, 1024, bf16, e4m3)):
        x, w = randn(m, k, dtype=xt), randn(n, k)
        s = None
        if wt == e4m3:
            s = (w.abs().amax() / 448.0).reshape(1)
            w = w / s
        w = w.to(wt)
        ref = decode_tn_matvec_plain(x, w, s)
        check(f"matvec M={m} N={n} K={k} x {xt} w {wt}",
              decode_tn_matvec(x, w, s), ref, 1e-4 * float(ref.abs().max()))
    # flash: f32 is compared at f32 precision; bf16 and LSE as in [3b].
    for dt, sq, skv, d, causal, lens in (
            (f32, 70, 70, 64, False, None),
            (f32, 70, 70, 128, True, (70, 33)),
            (bf16, 40, 100, 256, True, None),
            (bf16, 96, 96, 64, True, (1, 96))):
        q = randn(2, sq, 4, d, dtype=dt)
        k, v = randn(2, skv, 2, d, dtype=dt), randn(2, skv, 2, d, dtype=dt)
        ln = (torch.tensor(lens, dtype=torch.int32, device="cuda")
              if lens else None)
        offset = skv - sq if causal else 0
        o, lse = flash_fwd(q, k, v, ln, ln, scale=d ** -0.5, causal=causal,
                           offset=offset)
        qs = (q.float() * (d ** -0.5 * LOG2E)).to(dt)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, ln, ln, causal=causal,
                                         offset=offset)
        tol = 1e-4 if dt == f32 else row_tol(o_ref, BF16_ROW_RTOL)
        name = (f"flash {dt} Sq={sq} Skv={skv} D={d} causal={causal} "
                f"lengths={lens}")
        check(f"{name} O", o, o_ref, tol)
        check(f"{name} LSE", lse, lse_ref, LSE_ATOL)
    # decode attention: a bf16 cache under an f32 query (the plain version
    # rounds q and the softmax weights to bf16, the kernel does not), with
    # a window and a sink; an f32 cache at D = 256 (both in f32).
    for qt, ct, d, hq, window, sink, tol in (
            (f32, bf16, 64, 16, 20, True, 2e-2),
            (f32, f32, 256, 2, -1, False, 1e-4),
            (bf16, e4m3, 128, 8, 50, True, 2e-2)):
        b, s_max, hkv = 3, 256, 2
        q = randn(b, 1, hq, d, dtype=qt)
        kc, vc = (randn(b, s_max, hkv, d, dtype=ct) for _ in range(2))
        lengths = torch.tensor([1, 130, 256], dtype=torch.int32, device="cuda")
        scale = torch.tensor([0.5, 1.0, 2.0], device="cuda")
        sinks = randn(hq) if sink else None
        out = decode_attention(q, kc, vc, lengths, kv_scale=scale,
                               window_left=window, softmax_sink=sinks)
        ref = decode_attention_plain(q, kc, vc, lengths, kv_scale=scale,
                                     scale=d ** -0.5, window_left=window,
                                     out_dtype=qt, softmax_sink=sinks)
        check(f"decode q {qt} cache {ct} D={d} G={hq // hkv} "
              f"window={window} sink={sink}", out, ref,
              tol * float(ref.abs().max()))


def shrink_embedding(model) -> None:
    """Scales the seeded embedding to stddev 0.02, Llama's own init. The
    reference draws it at stddev 1, and with tied input and output
    embeddings of that size every greedy step repeats the previous token,
    which would hide any fault of the model's path."""
    model.embedding.data.mul_(0.02)


def prompts(torch, b: int, s: int, vocab: int, lens, device, seed: int = 3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(1, vocab, (b, s), generator=g, dtype=torch.int32)
    lengths = torch.tensor([lens[i % len(lens)] for i in range(b)],
                           dtype=torch.int32)
    return tokens.to(device), lengths.to(device)


def serve(torch, results) -> None:
    from transformerengine_tpu_torch import Float8CurrentScaling, _build
    from transformerengine_tpu_torch.inference import (
        InferenceParams, decode_steps, generate, prefill)
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.quantize.prequant import (
        prequantize_kernels)
    cfg = LLAMA_8B
    layers = cfg.num_layers
    log(f"[4] FP8-resident serve: LLAMA_8B width, {layers} layers, B={BATCH},"
        f" prompts {PROMPT_LENS} mixed, {NEW_TOKENS} new tokens, fp8 cache")
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device="cuda", seed=0)
    shrink_embedding(model)
    prequantize_kernels(model, Float8CurrentScaling())
    torch.cuda.synchronize()
    log(f"  init + prequantize: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    tokens, lengths = prompts(torch, BATCH, max(PROMPT_LENS), cfg.vocab_size,
                              PROMPT_LENS, "cuda")
    ip = InferenceParams(BATCH, max(PROMPT_LENS) + NEW_TOKENS,
                         torch.float8_e4m3fn)
    warm = generate(model, tokens, lengths, 2, inference_params=ip)
    torch.cuda.synchronize()
    del warm

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    first, caches = prefill(model, tokens, ip, lengths)
    first_host = first.cpu()
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = decode_steps(model, caches, first, NEW_TOKENS - 1)
    toks_host = toks.cpu()
    decode_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()

    out = torch.cat([first_host[:, None], toks_host], dim=1)
    if out.shape != (BATCH, NEW_TOKENS) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {out.shape} {out.min()} {out.max()}")
    with torch.no_grad():
        logits = model(tokens[:, :16])
    if logits.shape != (BATCH, 16, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("the model's logits are not finite")
    step_ms = decode_s / (NEW_TOKENS - 1) * 1e3
    log(f"  TTFT {ttft * 1e3:.2f} ms (prefill of {BATCH}x{max(PROMPT_LENS)} "
        f"tokens), decode {step_ms:.3f} ms/step, "
        f"{BATCH / (step_ms / 1e3):.1f} tok/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    expect = {"flash_attention_fwd": layers,
              "decode_attention": layers * (NEW_TOKENS - 1),
              "decode_tn_matvec": 4 * layers * (NEW_TOKENS - 1)}
    for name, n in expect.items():
        got = counts.get(name, 0)
        log(f"  launches {name}: {got} (expected {n}) "
            f"{'ok' if got == n else 'FAIL'}")
        if got != n:
            raise AssertionError(f"{name} launched {got} times, expected {n}")
        results[name]["launches"] = got
    results["_serve"] = dict(ttft_ms=ttft * 1e3, decode_ms_per_step=step_ms,
                             tok_per_s=BATCH / (step_ms / 1e3), layers=layers)
    profile_decode(torch, model, caches, toks[:, -1], results["_serve"])
    del model, caches


def profile_decode(torch, model, caches, tok, stats, steps: int = 4) -> None:
    """Device time by kernel over a few more decode steps, from the
    profiler's CUDA kernel events, and the device's busy share of the
    steps' wall time (the profiler's own host cost lowers that share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from transformerengine_tpu_torch.inference import decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_steps(model, caches, tok, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    busy_us = sum(kernels.values())
    if not kernels:
        log("  decode profile: the profiler saw no CUDA kernels; device "
            "time by kernel not measured")
        return
    log(f"  decode profile over {steps} steps: device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step of {wall_us / steps / 1e3:.3f} "
        f"ms/step wall ({100 * busy_us / wall_us:.1f}% busy)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"    {us / steps / 1e3:8.3f} ms/step  {name[:90]}")
    stats["profile"] = dict(
        busy_ms_per_step=busy_us / steps / 1e3,
        wall_ms_per_step=wall_us / steps / 1e3,
        top_ms_per_step={n[:90]: us / steps / 1e3 for n, us in top})


def forced_logits(torch, model, tokens, lengths, ip, forced, dev):
    """(B, NEW, V) logits at each generated position of ``model`` when the
    earlier generated tokens are ``forced`` (B, NEW): the prompt's last
    position, then one decode step per forced token."""
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    from transformerengine_tpu_torch.inference import KVCache
    caches = [KVCache.allocate(ip, layer.self_attention.num_kv_heads,
                               layer.self_attention.head_dim, dev)
              for layer in model.layers]
    tokens, lengths, forced = (t.to(dev) for t in (tokens, lengths, forced))
    b, s = tokens.shape
    out = []
    with torch.no_grad():
        lg = model(tokens, SequenceDescriptor.from_seqlens(lengths),
                   kv_caches=caches)
        for c in caches:
            c.length -= s - lengths
        out.append(lg[torch.arange(b, device=dev), (lengths - 1).long()])
        for i in range(forced.shape[1] - 1):
            out.append(model(forced[:, i:i + 1], kv_caches=caches)[:, -1])
    return torch.stack(out, dim=1).float().cpu()


# Card against CPU: the largest difference of the logits, relative to the
# largest logit. Both sides keep bf16 activations and sum in other orders,
# so an activation can round to its neighbouring bf16 value. In decode the
# fp8 KV cache magnifies that, since an e4m3 code (2^-4 apart) and a
# slot's scale, calibrated from the activations' amax, can each move with
# it; and decode attention on the card keeps its softmax weights in f32
# where the CPU's plain version rounds them to bf16. Each limit is about
# twice the largest reading on an H100 (PERF.md): 7.3e-3 of four for the
# prefill's logits, 1.45e-2 of five for the decode steps'.
PREFILL_RTOL = 2 ** -6
STEPS_RTOL = 2 ** -5
CARD_VS_CPU_SEEDS = (1, 2, 3)


def greedy_agreement(torch, toks, card_logits) -> str:
    """Holds the card's greedy tokens to the CPU's: equal, except that a
    row may leave the CPU's tokens at a near-tie, where the logits'
    difference swaps the top two. Along the CPU's tokens the card's own
    picks must be the argmax of its logits up to and through that step.
    Returns a description of where the rows left the CPU's tokens."""
    picks = card_logits.argmax(dim=-1)
    top = float(card_logits.abs().max())
    notes = []
    for row in range(toks["cpu"].shape[0]):
        cpu, card = toks["cpu"][row], toks["card"][row]
        diff = torch.nonzero(cpu != card).flatten()
        upto = int(diff[0]) + 1 if diff.numel() else cpu.numel()
        if not torch.equal(card[:upto], picks[row, :upto]):
            raise AssertionError(f"row {row}: the card's greedy tokens "
                                 f"{card.tolist()} are not the argmax of its "
                                 f"logits {picks[row].tolist()}")
        if diff.numel():
            t = upto - 1
            step = card_logits[row, t]
            gap = float(step[card[t]] - step[cpu[t]]) / top
            notes.append(f"row {row} leaves the CPU's tokens at step {t}, "
                         f"a near-tie of {gap:.3e} of the largest logit")
    return "; ".join(notes) or "greedy tokens equal"


def card_vs_cpu(torch) -> None:
    from transformerengine_tpu_torch import Float8CurrentScaling
    from transformerengine_tpu_torch.inference import (
        InferenceParams, generate)
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.quantize.prequant import (
        PrequantizedKernel, prequantize_kernels)
    cfg = dataclasses.replace(LLAMA_8B, num_layers=2)
    b, s, new = 2, 64, 8
    log(f"[5] card vs CPU: 2 layers at LLAMA_8B width, same weights, B={b} "
        f"prompt {s}, {new} new tokens, fp8 weights and cache, seeds "
        f"{CARD_VS_CPU_SEEDS}")
    failures = []
    for seed in CARD_VS_CPU_SEEDS:
        t0 = time.perf_counter()
        cpu = LlamaModel(cfg, device="cpu", seed=seed)
        shrink_embedding(cpu)
        card = LlamaModel(cfg, device="cuda", seed=seed)
        card.load_state_dict(cpu.state_dict())
        for m in (cpu, card):
            prequantize_kernels(m, Float8CurrentScaling())
        pk_cpu = {n: m for n, m in cpu.named_modules()
                  if isinstance(m, PrequantizedKernel)}
        pk_card = {n: m for n, m in card.named_modules()
                   if isinstance(m, PrequantizedKernel)}
        if pk_cpu.keys() != pk_card.keys() or not pk_cpu:
            raise AssertionError("prequantized kernels differ in name")
        for n, m in pk_cpu.items():
            same = torch.equal(m.data.view(torch.uint8),
                               pk_card[n].data.cpu().view(torch.uint8)) and \
                torch.equal(m.scale_inv, pk_card[n].scale_inv.cpu())
            if not same:
                raise AssertionError(f"fp8 payload of {n} differs card vs CPU")
        tokens, lengths = prompts(torch, b, s, cfg.vocab_size, (s, s - 14),
                                  "cpu", seed=seed)
        ip = InferenceParams(b, s + new, torch.float8_e4m3fn)
        toks = {name: generate(m, tokens, lengths, new, inference_params=ip,
                               device=dev).cpu()
                for name, m, dev in (("cpu", cpu, "cpu"),
                                     ("card", card, "cuda"))}
        # Both devices decode along the CPU's tokens, so every step's
        # logits can be compared.
        lg = {name: forced_logits(torch, m, tokens, lengths, ip, toks["cpu"],
                                  dev)
              for name, m, dev in (("cpu", cpu, "cpu"),
                                   ("card", card, "cuda"))}
        del cpu, card
        top = float(lg["cpu"].abs().max())
        diff = (lg["card"] - lg["cpu"]).abs() / top
        first, steps = float(diff[:, 0].max()), float(diff.max())
        ok = math.isfinite(steps) and first <= PREFILL_RTOL and \
            steps <= STEPS_RTOL
        log(f"  seed {seed}: fp8 payload bytes and scales equal for "
            f"{len(pk_cpu)} kernels; logits' largest difference over the "
            f"largest logit ({top:.3f}): last-token prefill {first:.3e} "
            f"(tolerance {PREFILL_RTOL:.3e}), all {new} steps {steps:.3e} "
            f"(tolerance {STEPS_RTOL:.3e}); {time.perf_counter() - t0:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        log(f"    {greedy_agreement(torch, toks, lg['card'])}")
        if not ok:
            failures.append(seed)
    if failures:
        raise AssertionError(f"card and CPU disagree for seeds {failures}")


def main() -> int:
    if not (HERE / "transformerengine_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from transformerengine_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"[2] built {lib.name} in {time.perf_counter() - t0:.1f} s")

    # Plain f32 matmuls in full f32 (no TF32), as the references assume.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    results = {}
    check_matvec(torch, timer, results)
    check_flash(torch, timer, results)
    check_decode_attention(torch, timer, results)
    check_variants(torch)
    _build.LAUNCHES.clear()
    serve(torch, results)
    torch.cuda.empty_cache()
    card_vs_cpu(torch)

    serve_stats = results.pop("_serve")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"serve": serve_stats, "card": smi,
                    "shapes": {k: r["shape"] for k, r in results.items()}}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
