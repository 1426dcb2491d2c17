#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 3,4,5,...,26] [--train-seeds 21]
                          [--moe-seeds 31] [--gptoss-seeds 51]

Phases, each of which raises (and so exits non-zero) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build of every kernel in transformerengine_tpu_torch/csrc (nvcc,
     timed, with ptxas register and shared-memory reports);
  3. each kernel against its plain PyTorch version on the card, at its
     path's shapes, with its time, the plain version's time, the time of
     one library call where one computes the same function, and its bound
     on this card; then its other dtypes, head dims, masks and options at
     small shapes. The fused quantize kernels are reached through the
     quantizer API (``DelayedScaleQuantizer.quantize`` in the 2x layout
     and ``quantize_normed``), the MXFP8 norm kernel through
     ``BlockScaleQuantizer.quantize_normed``. Paged decode attention at
     phase 9's shape (fp8 pages, a shuffled table) and then bf16 and f32
     pages, sinks and a length of 0; the KN decode GEMM at the four GEMMs
     of an LLAMA_8B layer in its e4m3 and its packed e2m1 branch, then
     M = 1 and 32, f32 x and the packed form at small shapes; both decode
     GEMMs repeatable bit for bit, their row 0 the same at M = 1 as at
     M = 8, and every e4m3 code and packed byte through them exactly;
     the two NVFP4 kernels at the training path's x and gradient shapes,
     with and without the RHT (amaxes, payloads and scales equal), then
     f32, a zero tensor, -0 codes, subnormal scales, other sign masks and
     stochastic rounding (neighbours, repeatability, bias); the grouped
     MXFP8 QDQ of the MoE's expert kernels at MIXTRAL_8X7B's two stacks,
     then f32, e5m2, zero blocks and an unaligned shape (the chain); flash
     attention's window and sink branches: the banded forward with a
     learnable sink at phase 17's prefill shape and the banded backward at
     phase 16's training shape, each timed beside SDPA with the band as a
     boolean mask, then left, right and two-sided bands, the off-by-one
     sink, a sink with padded rows, the bottom-right offset, f32, D 128
     and 256 at small shapes, and decode attention at GPT-OSS's decode
     shape with its window and sink; the flash kernels' FP8 branches at
     the training shape (e4m3 Q/K/V from a current-scaling quantize, O in
     bf16 or through the fp8 O epilogue, a bf16 dO or e4m3 O and e5m2 dO),
     each timed beside SDPA on the dequantized bf16 tensors, then
     padding-causal lengths with fully masked rows, GQA groups of 4 and 8,
     D 64 and 128, a window with a sink and O scales that saturate; the
     flash kernels' segment branches at phase 20's packed batch (the
     loader's first batch's ids; bf16, and e4m3 Q/K/V with fp8 O and dO as
     the fp8_mha recipe runs them), each timed beside SDPA with the
     block-diagonal causal mask, then f32, GQA groups of 4 and 8, D 64
     and 256, a window with a sink, an all-zero row, non-contiguous ids,
     no causal rule, the bottom-right offset, the FP8 branches, and ids
     with lengths in one descriptor (the ids win); the flash kernels' bias
     and ALiBi branches at the encoder's training shape (B 2, S 2048, Hq
     32, Hkv 8, D 128, bf16, padding lengths 2048 and 1536, an f32 (1, 32,
     2048, 2048) relative bias; dbias held too), each timed beside SDPA
     with the bias as a float mask, then a per-batch bf16 bias, causal
     (dbias exactly 0 above the diagonal), a window with a sink, f32, D 64
     and 256, GQA groups of 4 and 8, and ALiBi with padding, the
     bottom-right offset and a window; the flash kernels' dropout
     branches (rate 0.1, fixed seed words, the first above 2^31) at phase
     6's causal training shape and at the encoder's with its relative
     bias, forward and backward against their plain versions on the same
     seed words, a planted wrong seed that must fail, the plain mask's
     keep share, each timed beside SDPA at dropout_p 0.1; then f32, D 64
     and 256, GQA groups of 4, 8 and 16, padding, segment ids, a window
     with a sink, the bottom-right offset, a bias, ALiBi, the reference's
     small explicit tiles and rate 0.5 at small shapes; the flash kernels'
     soft-cap branch (Gemma-2's cap of 50, scores of std 20) at phase 6's
     causal training shape, forward and backward against their plain
     versions, with a planted wrong cap that must fail, each timed beside
     PyTorch's compiled flex_attention with the cap as its score mod;
     dropout on FP8 Q/K/V at row 2f's shape (O in
     bf16 and through the fp8 O epilogue, a bf16 dO and e4m3 O with an
     e5m2 dO) with a planted wrong seed word and the keep share, each
     timed beside SDPA at dropout_p 0.1 on the dequantized tensors; then
     f32, D 64, 128 and 256, GQA groups of 4, 8 and 16, padding with fully
     masked rows, segment ids, a window with a sink, the bottom-right
     offset, dropout with the cap, caps of 1 and 1e4, ALiBi with explicit
     slopes, and FP8 dropout with padding and with a window and a sink at
     small shapes; the flash kernels' runtime positions (the ring's
     q-position offset, read on the card from a row of a (cp, 3) table)
     at one rank's shard of LLAMA_8B over S 8192 (B 1, L 2048, qoff
     +2048: every key visible), bf16 and e4m3 Q/K/V, forward and
     backward, each timed beside SDPA without a mask, then every (rank,
     step) of a cp-4 ring, contiguous and striped, with the windows
     (-1, -1), (37, 0) and (2, 0), against the plain versions, with two
     planted faults (the striped ring's live -1 left bound read as an
     inactive side, an offset one tile off) that must fail, and offsets
     at the edges of the kernels' 64-row tiles (rows masked whole write
     O = 0 and LSE = -1e30; a step where each query sees at most one key,
     whose dQ and dK cancel to 0, held to 0 within f32 rounding); the
     flash kernels' tensor-core bodies: two launches bitwise equal at
     rows 4 and 4b's shapes (O, LSE, dQ, dK, dV, dbias), then Sq and Skv
     of 200, 136 and 72 (no multiple of the tiles), D 64, 128 and 256,
     GQA groups of 1, 4 and 8, a window, a sink, segment ids and runtime
     positions, bf16 and e4m3, forward and backward;
  4. FP8-resident serving at LLAMA_8B width (seeded random weights, FP8
     KV cache, B = 8, prompts of 512 and 384 tokens, 32 new tokens)
     through prefill and decode_steps, with TTFT, decode ms/step, tok/s
     and each kernel's launch count held to its expectation;
  5. serving, the card against the CPU, for three seeds: two layers at
     LLAMA_8B width with the same weights, equal fp8 payload bytes, the
     prefill's and every decode step's logits within tolerance, and
     near-equal greedy tokens; then one seed with MXFP8 (K, N)-resident
     weights and the paged cache, and one with NVFP4 (K/2, N) packed ones
     under autocast;
  6. FP8 training at LLAMA_8B width, 4 layers, B = 2, S = 2048, under
     DelayedScaling(amax_history_len=16): five SGD steps with finite
     losses, the delayed-scaling state rolled, and exact launch counts;
     ms/step, tokens/s, the device's busy share and top kernels, and the
     same step without a recipe. Then the quantizer API on the step's own
     activations (both orientations, and the fused norm + cast), held to
     the layers' one-orientation payloads;
  7. training, the card against the CPU: one step of two layers at
     LLAMA_8B width, B = 1, S = 256, without a recipe, under
     DelayedScaling, MXFP8BlockScaling, NVFP4BlockScaling and
     DelayedScaling(fp8_dpa=True, fp8_mha=True): loss, every gradient (in
     norm and largest element), the updated scales and the residual
     stream layer by layer (under NVFP4 and FP8 attention op by op: the
     card quantizes the CPU's inputs, and takes its fp8 O, and each of its
     own is held to the CPU's); beside them, the CPU's own difference when its attention runs
     unfused. The same card step with planted faults must fail the
     check;
  8. MXFP8 training at LLAMA_8B width, 4 layers, B = 2, S = 2048, under
     MXFP8BlockScaling(): five SGD steps with finite losses and exact
     launch counts of the three MXFP8 kernels and flash attention, ms/step,
     tokens/s, peak memory, the device's busy share and top kernels beside
     phase 6's DelayedScaling step; then the forward without a gradient
     at the same shape, with its own exact launch counts;
  9. paged, MXFP8-resident serving at LLAMA_8B width (phase 4's shape,
     pages of 128): ``prequantize_kernels(model, MXFP8BlockScaling(),
     block_decode="quantized")``, then ``"bf16"``, each with TTFT, decode
     ms/step, tok/s, resident GiB, the device's busy share and exact launch
     counts (at load and per decode step);
 10. continuous batching at LLAMA_8B width: 8 slots, 16 seeded requests
     of 64-512 tokens, 32 new tokens each, fp8 weights and cache:
     requests/s, tok/s, admission ms, decode ms/step, exact launch counts,
     and four requests against the card's own batch-1 generate;
 11. NVFP4 training as phase 8, under NVFP4BlockScaling() (the RHT on the
     input's and gradient's colwise usages): five steps, then the forward
     without a gradient, with exact launch counts of the two NVFP4
     kernels (none without a gradient) and flash attention;
 12. paged, NVFP4-resident serving as phase 9, under
     ``autocast(NVFP4BlockScaling())``: the packed (K/2, N) form, then
     ``"bf16"``; the prefill's activations through the two NVFP4 kernels,
     the decode batch's rowwise alone;
 13. Mixtral training at MIXTRAL_8X7B width (8 experts, top-2), 4 layers,
     B = 2, S = 2048, ``mixtral_loss``: five SGD steps without a recipe,
     five under MXFP8BlockScaling() (two grouped QDQ launches a layer in
     the forward, none in the backward), then three MXFP8 forwards
     without a gradient, each call with exact launch counts; ms/step,
     tok/s, the ratio of the two steps, peak memory, the busy share and
     the top kernels;
 14. Mixtral bf16 serving at MIXTRAL_8X7B width, 8 layers, phase 4's
     batch, prompts and fp8 cache: TTFT, decode ms/step, busy share and
     exact launch counts; then two sequences' cached tokens (the
     reference test's bf16 cache) against the card's own full-recompute
     greedy decoding, near-ties of the logits or the router excused;
 15. Mixtral training, the card against the CPU: one step of 2 layers at
     a reduced width (hidden 1024, FFN 3584, 8 experts), B = 1, S = 256,
     without a recipe and under MXFP8, the MoE held op by op (the card's
     MoE layers take the CPU's inputs and routing, their own routing
     differing only at near-ties): loss, gradients and the local
     difference, with planted faults that must be caught;
 16. GPT-OSS training at GPTOSS_20B width (64/8 heads of 64, 32 experts of
     FFN 2880, top-4, clamped SwiGLU, biased projections, a band of 128 on
     even layers, a learnable sink in every layer), 4 layers, B = 2,
     S = 2048, ``gptoss_loss``: five bf16 SGD steps with a sink gradient
     on every layer, then three forwards without a gradient, with exact
     launch counts of the window and sink branch (no plain flash launch);
     ms/step, tok/s, peak memory, busy share and top kernels;
 17. GPT-OSS bf16 serving at GPTOSS_20B, all 24 layers, phase 4's batch,
     prompts and fp8 cache: TTFT, decode ms/step, busy share, Python calls
     per step and exact launch counts (a banded-and-sink flash forward per
     layer per prefill, a decode launch with the layer's window and sink
     per layer per step); then two sequences' cached tokens against the
     card's own full-recompute greedy decoding, as in phase 14;
 18. GPT-OSS training, the card against the CPU: one bf16 step of 2
     layers (one banded, one full, sinks on both) with the attention at
     GPTOSS_20B's shape and the rest reduced (hidden 1024, 8 experts of
     FFN 1024, top-4), B = 1, S = 384, the MoE held op by op as in phase
     15; planted faults (the kernels ignoring the band, the sink dropped
     from the forward, dsink zeroed) must be caught;
 19. FP8-attention training at phase 6's shape (LLAMA_8B width, 4 layers,
     B = 2, S = 2048) under DelayedScaling(fp8_dpa, fp8_mha) (the fp8 O
     epilogue, fp8 O and e5m2 dO in the backward kernels),
     Float8CurrentScaling(fp8_dpa, fp8_mha), Float8CurrentScaling() (no
     FP8 attention) and MXFP8BlockScaling(fp8_dpa) (two steps): SGD steps
     with exact launch counts of each flash branch, the fp8_mha_o delayed
     state moved, then one forward without a gradient each; ms/step,
     tok/s, peak memory, busy share and the ratio to phase 6's step;
 20. packed-document training at phase 6's shape (LLAMA_8B width, 4
     layers, B = 2, S = 2048) on the native PackedDataLoader's batches of
     seeded documents (64-4096 tokens, log-uniform; the longer ones split)
     and the next-token loss within each document: three SGD steps
     without a recipe, under DelayedScaling() and under
     DelayedScaling(fp8_dpa=True, fp8_mha=True), with exact launch counts
     of the segment branches (no flash launch without segments), then one
     forward without a gradient each; ms/step, non-pad tok/s, peak
     memory, busy share and the ratio to phase 6's step; then one bf16
     step of 2 layers, B = 1, S = 256 on a packed row of three documents,
     the card against the CPU, with a planted fault (the kernels given
     all-ones ids) that the check must catch;
 21. encoder training at LLAMA_8B width (hidden 4096, FFN 14336, 32/8
     heads), 4 TransformerLayers (cut from the reference's depth for the
     time limit) with LayerNorm, GELU, the padding mask (lengths 2048 and
     1536) and the relative-position bias, B = 2, S = 2048, a seeded
     linear read-out as the loss: three SGD steps without a recipe, two
     under MXFP8BlockScaling() and two under DelayedScaling(fp8_dpa=True,
     fp8_mha=True), each with exact launch counts (the bias branch of
     every flash launch, no FP8 one: the bias closes the gates), ms/step,
     tok/s, peak memory and a profiled step's busy share; then two bf16
     steps of 4 ALiBi attention blocks with their ALiBi launches counted;
 22. the encoder step, the card against the CPU: 2 layers at LLAMA_8B
     width, B = 1, S = 256 (200 valid), bf16: the read-out, every
     gradient and rel_embedding's, with planted faults (the bias ignored,
     dbias zeroed) that the check must catch;
 23. dropout training at LLAMA_8B width, 4 TransformerLayers, B = 2,
     S = 2048, attention, hidden and drop-path dropout at 0.1 drawn from
     one card generator: phase 21's encoder in bf16 beside the same
     stack's step without dropout (ms/step, tok/s, peak memory, the busy
     share of a profiled step; the peaks within 0.5 GiB, no mask being
     stored), then a causal RoPE stack (RMSNorm, SwiGLU) under
     DelayedScaling(fp8_dpa=True, fp8_mha=True), where dropout closes the
     FP8 attention gates; exact launch counts of the dropout branches
     and no FP8 flash launch;
 24. the dropout step, the card against the CPU: phase 22's 2 encoder
     layers with attention dropout at 0.1 on the same seed words on both
     sides, held to phase 22's limits, with planted faults (the card's
     seed words off by one, the mask not replayed in the backward) that
     the check must catch;
 25. ``flex_attention`` at LLAMA_8B width (phase 6's attention shape: B 2,
     S 2048, Hq 32, Hkv 8, D 128, bf16), forward and backward:
     ``impl="flash"`` with ``soft_cap_mod(50)`` and ``causal_mask_mod``
     over three timed calls with exact launch counts of the soft-cap
     branch, ``impl="chunked"`` with the same mods against it,
     ``impl="chunked"`` with ``relative_position_bias_mod`` (the table's
     gradient nonzero) under a stated peak, ms per call, busy share and
     peak GiB; dropout on FP8 Q/K/V through ``flash_attention``
     (``qkv_quantizers`` and ``mha_proj``, the entry point; the layers
     close their FP8 gates under dropout) with exact launch counts; then
     the card against the CPU at a small shape for each impl and for FP8
     Q/K/V with dropout;
 26. context parallelism on one card: the parent computes its references
     at full width (one flash call and one 2-layer LlamaModel step on the
     whole sequence), moves them to the host and frees the card, then
     spawns 4 ranks (``torch.multiprocessing``, a gloo group with a short
     timeout; gloo takes host tensors, so the exchanged tensors cross
     through the host). Each rank runs LLAMA_8B's attention over S 8192
     (B 1, 32/8 heads of 128, bf16, causal) through ``fused_attn`` with
     RING, RING_STRIPED (the striped reorder), ALL_GATHER, ULYSSES_A2A,
     the hierarchical 2 x 2 form and the FP8 ring under
     DelayedScaling(fp8_dpa=True), forward and backward, held to the
     parent's call (the FP8 ring to the bf16 ring), then one training
     step of the 2-layer model on its shard (global RoPE positions, the
     loss and gradients summed over the group, SGD), held to the
     parent's step; exact launches per rank and layer, ms a call and a
     step, the bytes staged through the host.
Then one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
A kernel's ``launches`` is the sum of its counts over the runs of the
paths (phases 4, 6, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 20, 21, 23,
25 and 26, phase 9's load included; phase 26's summed over its ranks),
each counted from zero; comparisons with the plain versions do not
count.
``--phases`` runs a subset (for iterating on one path); the default runs
all. ``--train-seeds`` gives phase 7 other seeds (``21,22,23`` reads
what its limits were set from), ``--moe-seeds`` phase 15 (``31,32,33``),
``--gptoss-seeds`` phase 18 (``51,52,53``).
"""
from __future__ import annotations

import collections
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
FP8_FLOPS = 1979e12              # H100 SXM dense fp8 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
PROMPT_LENS = (512, 384)
NEW_TOKENS = 32
BATCH = 8
# The device of the training phases' card side (a CPU rehearsal of their
# control flow sets it to "cpu").
CARD = "cuda"
# The training phase: the ln_mlp rung's shape at LLAMA_8B width.
TRAIN_B, TRAIN_S, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 2, 2048, 4, 5, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple:
    return bound_ms_mixed(nbytes, [(flops, peak)])


def bound_ms_mixed(nbytes: float, products) -> tuple:
    """(the least time in ms, "bytes" or "operations") for work that
    moves ``nbytes`` and runs ``products`` [(flops, peak), ...] (products
    at different peaks take the sum of their times)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / peak for f, peak in products) * 1e3
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

    def events(self, fn, reps: int = 10) -> float:
        """Median device time of ``fn`` between two CUDA events, without a
        graph (for calls that cannot be captured, such as an autograd
        backward); the L2 is flushed before each call."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
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


def same_rows(torch, name: str, one, full) -> None:
    """Row 0 of a decode GEMM must not depend on M: one row of x against
    the first row of its M = BATCH result, bit for bit."""
    ok = torch.equal(one, full[:1])
    log(f"  {name}: row 0 at M = 1 against M = {full.shape[0]} "
        f"{'equal' if ok else 'DIFFERS'}")
    if not ok:
        raise AssertionError(f"{name}: row 0 depends on M")


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
            name = f"{wname} {gemm} N={n} K={k}"
            err = check(name, got, ref, 1e-4 * float(ref.abs().max()))
            if not torch.equal(decode_tn_matvec(x, w, s), got):
                raise AssertionError("decode_tn_matvec is not deterministic")
            same_rows(torch, name, decode_tn_matvec(x[:1], w, s), got)
            tot["err"] = max(tot["err"], err)
            tot["ms"] += timer(lambda: decode_tn_matvec(x, w, s))
            tot["plain_ms"] += timer(lambda: decode_tn_matvec_plain(x, w, s))
            # torch.mm on the weight widened to bf16 (the fp8 weight's
            # scale on the f32 result): the same function.
            wt = w.to(torch.bfloat16).t()
            if s is None:
                tot["library_ms"] += timer(
                    lambda: torch.mm(x, wt, out_dtype=torch.float32))
            else:
                tot["library_ms"] += timer(
                    lambda: torch.mm(x, wt, out_dtype=torch.float32) * s)
            del wt
            tot["nbytes"] += (n * k * w.element_size() + BATCH * k * 2
                              + BATCH * n * 4)
            tot["flops"] += 2 * BATCH * n * k
        b_ms, b_by = bound_ms(tot["nbytes"], tot["flops"])
        log(f"  {wname} one layer (4 GEMMs): kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, torch.mm on the bf16 weight "
            f"{tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"results equal from run to run")
        totals[wname] = (tot, b_ms, b_by)
    for name, wname, about in (
            ("decode_tn_matvec", "fp8", "fp8 weights"),
            ("decode_tn_matvec_bf16", "bf16", "bf16 weights")):
        tot, b_ms, b_by = totals[wname]
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/decode_matvec.cu",
            replaces="transformerengine_tpu/ops/decode_matmul.py:246",
            max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=tot["library_ms"],
            shape=f"{about}, the 4 GEMMs of one LLAMA_8B layer, M=8")
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


# The flash backward's gradients (bf16) against the plain version: ds and
# p are rounded to bf16 on both sides, from f32 scores summed in other
# orders, so a few round one ulp (2^-8) apart, and the gradients are
# rounded to bf16. Relative to each gradient's largest |ref|, as the CPU
# tests hold the plain version to the reference (2^-6; readings there
# below 5.4e-3).
BWD_RTOL = 2 ** -6


def check_flash_bwd(torch, timer, results):
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd)
    b, s, hq, hkv, d = TRAIN_B, TRAIN_S, 32, 8, 128
    log(f"[3e] flash_attention bwd (dQ and dK/dV kernels): training B={b} "
        f"S={s} Hq={hq} Hkv={hkv} D={d} bf16, causal")
    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), \
        randn(b, s, hkv, d), randn(b, s, hq, d)
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True)
    got = flash_bwd(q, k, v, o, lse, do, scale=scale, causal=True)
    torch.cuda.synchronize()
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale, causal=True)
    err = 0.0
    for name, a, r in zip(("dQ", "dK", "dV"), got, ref):
        differ = int((a != r).sum())
        err = max(err, check(
            f"{name} ({differ} of {r.numel()} elements differ)", a, r,
            BWD_RTOL * float(r.float().abs().max())))
    del got, ref
    ms = timer(lambda: flash_bwd(q, k, v, o, lse, do, scale=scale,
                                 causal=True))
    plain_ms = timer(lambda: flash_bwd_plain(qs, k, v, do, lse, delta,
                                             scale=scale, causal=True),
                     reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         scale=scale, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = timer.events(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out
    pairs = b * hq * s * (s + 1) // 2
    flops = 5 * 2 * d * pairs
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    # Read Q, K, V, O, dO and LSE; write dQ, dK, dV.
    nbytes = 2 * (3 * q_el + 2 * kv_el) + 4 * b * hq * s \
        + 2 * (q_el + 2 * kv_el)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    results["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:1477",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal")


def payload_diff(torch, got, ref) -> tuple:
    """(elements that differ, largest code distance, largest difference
    of the fp8 values) of two fp8 payloads of one dtype."""
    a, r = got.view(torch.uint8).int(), ref.view(torch.uint8).int()
    differ = a != r
    n = int(differ.sum())
    if n == 0:
        return 0, 0, 0.0
    # Codes of one sign are ordered like their values: one fp8 step apart
    # means codes one apart with the same sign bit.
    same_sign = (a ^ r) < 128
    dist = torch.where(same_sign, (a - r).abs(), torch.full_like(a, 255))
    vals = (got.float() - ref.float()).abs()
    return n, int(dist[differ].max()), float(vals.max())


def delayed_quantizer(torch, role: str, x, recipe):
    """A delayed quantizer for ``role`` whose scale is the one a history
    holding 0.9x this tensor's amax gives, so the largest values
    saturate, as after a step whose amax was a little lower."""
    from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    quant = getattr(QuantizerFactory.create_set(recipe, device="cuda"), role)
    quant.amax_history[-1] = x.float().abs().amax() * 0.9
    quant.scale.copy_(compute_scale_from_amax(
        quant.amax_history.max(), quant.q_dtype).reshape(1))
    return quant


def check_casts(torch, timer, results):
    from transformerengine_tpu_torch import DelayedScaling
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        cast_transpose_plain)
    from transformerengine_tpu_torch.quantize.tensor import (
        get_colwise, get_rowwise)
    m = TRAIN_B * TRAIN_S
    recipe = DelayedScaling(amax_history_len=16)
    log(f"[3f] cast_transpose through DelayedScaleQuantizer.quantize (2x "
        f"layout), bf16: the MLP's ({m}, 14336) activation (x, e4m3) and a "
        f"({m}, 4096) gradient (dgrad, e5m2)")
    g = torch.Generator(device="cuda").manual_seed(6)
    for role, n, mag in (("x", 14336, 1.0), ("dgrad", 4096, 1e-4)):
        x = (torch.randn((m, n), generator=g, device="cuda") * mag).to(
            torch.bfloat16)
        quant = delayed_quantizer(torch, role, x, recipe)
        out = quant.quantize(x)
        torch.cuda.synchronize()
        row, col, amax = cast_transpose_plain(x, quant.scale, quant.q_dtype)
        rw, cw = get_rowwise(out), get_colwise(out)
        diffs = [payload_diff(torch, rw.data, row),
                 payload_diff(torch, cw.data, col)]
        same_amax = float(rw.amax) == float(amax[0])
        ok = diffs[0][0] == diffs[1][0] == 0 and same_amax
        log(f"  {role} ({m}, {n}) {quant.q_dtype}: row/col payload bytes "
            f"differ at {diffs[0][0]}/{diffs[1][0]} elements, amax "
            f"{float(rw.amax):.6e} {'equal' if same_amax else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("cast_transpose payloads are not bit-equal")
        if role == "x":
            ms = timer(lambda: quant.quantize(x))
            plain_ms = timer(lambda: cast_transpose_plain(
                x, quant.scale, quant.q_dtype))
            # Read x, write two one-byte payloads; about four f32
            # operations an element (abs, max, multiply, clip).
            nbytes = m * n * 2 + 2 * m * n + 8
            b_ms, b_by = bound_ms(nbytes, 4 * m * n, F32_FLOPS)
            log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
            results["cast_transpose"] = dict(
                name="cast_transpose", route="cuda",
                source="transformerengine_tpu_torch/csrc/cast_transpose.cu",
                replaces="transformerengine_tpu/ops/quantize_kernels.py:78",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"({m}, {n}) bf16 -> e4m3 both orientations")


# The fused norm's payloads against its plain version: the row sums run
# in another order, so rsigma may differ by an f32 ulp, and where the
# normalized value then lands on the other side of a bf16 rounding
# boundary, its fp8 code moves by at most one step. Allowed: one element
# in 10^5, each one step apart. rsigma: f32 ulps (relative 1e-6).
NORM_DIFF_SHARE = 1e-5
RSIGMA_RTOL = 1e-6


def check_norm_payloads(torch, name, outs, ref, scale) -> float:
    """Holds norm_cast_transpose's (row, col, amax, rsigma[, mu]) to its
    plain version's; returns the largest difference of the dequantized
    values (payload over ``scale``)."""
    worst = 0.0
    for part, a, r in (("row", outs[0], ref[0]), ("col", outs[1], ref[1])):
        n, dist, val = payload_diff(torch, a, r)
        limit = NORM_DIFF_SHARE * r.numel()
        ok = n <= limit and dist <= 1
        log(f"  {name} {part}: {n} of {r.numel()} bytes differ (limit "
            f"{limit:.0f}), largest code distance {dist} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {part} payload disagrees")
        worst = max(worst, val)
    check(f"{name} rsigma", outs[3], ref[3],
          RSIGMA_RTOL * float(ref[3].abs().max()))
    if len(ref) > 4:
        check(f"{name} mu", outs[4], ref[4],
              1e-6 * float(ref[4].abs().max()) + 1e-7)
    amax_rel = abs(float(outs[2][0]) - float(ref[2][0])) / float(ref[2][0])
    log(f"  {name} amax {float(outs[2][0]):.6e}, relative difference "
        f"{amax_rel:.2e} (limit 2^-7, one bf16 ulp)")
    if amax_rel > 2 ** -7:
        raise AssertionError(f"{name} amax disagrees")
    return worst / float(scale.reshape(()))


def check_norm_cast(torch, timer, results):
    from transformerengine_tpu_torch import DelayedScaling
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        norm_cast_transpose_plain)
    from transformerengine_tpu_torch.quantize.tensor import (
        get_colwise, get_rowwise)
    m, h = TRAIN_B * TRAIN_S, 4096
    log(f"[3g] norm_cast_transpose through "
        f"DelayedScaleQuantizer.quantize_normed: RMSNorm of the layers' "
        f"({m}, {h}) bf16 input, e4m3")
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((m, h), generator=g, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((h,), generator=g, device="cuda")
    recipe = DelayedScaling(amax_history_len=16)
    # The scale from the normalized values' amax (about 4.5 for N(0, 1)).
    quant = delayed_quantizer(torch, "x", x.float() * 1.1, recipe)

    def fused():
        return quant.quantize_normed(x, gamma, None, norm="rmsnorm",
                                     zero_centered_gamma=False, epsilon=1e-5)

    out, mu, rsigma = fused()
    torch.cuda.synchronize()
    ref = norm_cast_transpose_plain(x, gamma, None, quant.scale,
                                    quant.q_dtype, norm="rmsnorm",
                                    zero_centered_gamma=False, epsilon=1e-5)
    rw, cw = get_rowwise(out), get_colwise(out)
    err = check_norm_payloads(
        torch, "rmsnorm", (rw.data, cw.data, rw.amax.reshape(1),
                           rsigma.reshape(m, 1)), ref, quant.scale)
    ms = timer(fused)
    plain_ms = timer(lambda: norm_cast_transpose_plain(
        x, gamma, None, quant.scale, quant.q_dtype, norm="rmsnorm",
        zero_centered_gamma=False, epsilon=1e-5))
    # Read x and gamma, write two payloads and rsigma; about ten f32
    # operations an element (square, sum, normalize, scale, abs, max, cast).
    nbytes = m * h * 2 + h * 4 + 2 * m * h + m * 4 + 8
    b_ms, b_by = bound_ms(nbytes, 10 * m * h, F32_FLOPS)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    results["norm_cast_transpose"] = dict(
        name="norm_cast_transpose", route="cuda",
        source="transformerengine_tpu_torch/csrc/norm_cast_transpose.cu",
        replaces="transformerengine_tpu/ops/quantize_kernels.py:158",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"RMSNorm ({m}, {h}) bf16 -> e4m3 both orientations")


def check_train_variants(torch) -> None:
    """The training kernels' other dtypes, head dims, masks and options,
    at small shapes, each against its plain version on the card."""
    from transformerengine_tpu_torch import DelayedScaling
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd)
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        cast_transpose, cast_transpose_plain, norm_cast_transpose,
        norm_cast_transpose_plain)
    from transformerengine_tpu_torch.quantize.tensor import (
        get_colwise, get_rowwise)
    log("[3h] training kernels' other variants at small shapes")
    g = torch.Generator(device="cuda").manual_seed(8)
    f32, bf16 = torch.float32, torch.bfloat16
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # flash backward: f32 at D 64, padding-causal with fully masked rows
    # (the second sequence's rows past 33), bottom-right (Sq < Skv) at
    # D 256, GQA group 1, and a sequence of one token. f32 is held at f32
    # precision (1e-4 of the largest |ref|).
    for dt, sq, skv, hq, hkv, d, causal, lens in (
            (f32, 70, 70, 4, 2, 64, False, None),
            (f32, 70, 70, 4, 2, 128, True, (70, 33)),
            (bf16, 40, 100, 4, 4, 256, True, None),
            (bf16, 96, 96, 4, 1, 64, True, (1, 96)),
            (bf16, 130, 130, 8, 8, 128, True, (130, 77))):
        q, do = randn(2, sq, hq, d, dtype=dt), randn(2, sq, hq, d, dtype=dt)
        k, v = randn(2, skv, hkv, d, dtype=dt), randn(2, skv, hkv, d, dtype=dt)
        ln = (torch.tensor(lens, dtype=torch.int32, device="cuda")
              if lens else None)
        offset = skv - sq if causal else 0
        scale = d ** -0.5
        o, lse = flash_fwd(q, k, v, ln, ln, scale=scale, causal=causal,
                           offset=offset)
        got = flash_bwd(q, k, v, o, lse, do, ln, ln, scale=scale,
                        causal=causal, offset=offset)
        qs = (q.float() * (scale * LOG2E)).to(dt)
        delta = (do.float() * o.float()).sum(dim=-1)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, ln, ln, scale=scale,
                              causal=causal, offset=offset)
        rtol = 1e-4 if dt == f32 else BWD_RTOL
        name = (f"flash bwd {dt} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} "
                f"causal={causal} lengths={lens}")
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            check(f"{name} {gname}", a, r,
                  rtol * float(r.float().abs().max()) + 1e-30)
        if lens is not None:
            masked = [float(t[i, n:].abs().max()) for t in got
                      for i, n in enumerate(lens) if n < t.shape[1]]
            log(f"  {name}: largest |gradient| of padded rows and keys "
                f"{max(masked)} (exact zeros)")
            if any(masked):
                raise AssertionError("padded rows or keys got gradients")
    # cast_transpose: f32 input, e5m2, a shape not a multiple of the tile,
    # and shapes not multiples of 16 (the kernel that masks ragged edges),
    # the last through the quantizer API's 2x layout.
    recipe = DelayedScaling(amax_history_len=16)
    for m, n, xt, qt in ((80, 48, f32, e4m3), (96, 208, f32, e5m2),
                         (272, 528, bf16, e5m2), (24, 40, bf16, e4m3),
                         (1, 4097, f32, e5m2), (100, 37, bf16, e4m3)):
        x = randn(m, n, dtype=xt) * 3
        scale = torch.tensor([7.5], device="cuda")
        if m == 100:
            quant = delayed_quantizer(torch, "x", x, recipe)
            scale = quant.scale
            out = quant.quantize(x)
            got = (get_rowwise(out).data, get_colwise(out).data,
                   get_rowwise(out).amax.reshape(1))
        else:
            got = cast_transpose(x, scale, qt)
        ref = cast_transpose_plain(x, scale, qt)
        same = all(payload_diff(torch, a, r)[0] == 0
                   for a, r in zip(got[:2], ref[:2])) and \
            float(got[2][0]) == float(ref[2][0])
        log(f"  cast_transpose ({m}, {n}) {xt} -> {qt}: payloads and amax "
            f"{'equal ok' if same else 'DIFFER FAIL'}")
        if not same:
            raise AssertionError("cast_transpose payloads are not bit-equal")
    # norm_cast_transpose: LayerNorm with beta and zero-centered gamma,
    # e5m2; f32 input LayerNorm; RMSNorm with zero-centered gamma.
    for m, h, xt, norm, zcg, beta, qt in (
            (256, 384, bf16, "layernorm", True, True, e5m2),
            (264, 256, f32, "layernorm", False, True, e4m3),
            (512, 1024, bf16, "rmsnorm", True, False, e4m3)):
        x = randn(m, h, dtype=xt) * 2 + 0.5
        gamma = randn(h) * 0.2 + (0.0 if zcg else 1.0)
        bt = randn(h) * 0.1 if beta else None
        scale = torch.tensor([40.0 if qt == e4m3 else 5000.0], device="cuda")
        kw = dict(norm=norm, zero_centered_gamma=zcg, epsilon=1e-5)
        got = norm_cast_transpose(x, gamma, bt, scale, qt, **kw)
        ref = norm_cast_transpose_plain(x, gamma, bt, scale, qt, **kw)
        check_norm_payloads(torch, f"{norm} ({m}, {h}) {xt} zcg={zcg} "
                            f"beta={beta} {qt}", got, ref, scale)


# The MLP's activation at the training shape and a hidden-sized tensor.
MXFP8_SHAPES = ((TRAIN_B * TRAIN_S, 14336), (TRAIN_B * TRAIN_S, 4096))


def mxfp8_input(torch, g, m: int, n: int, dtype=None, mag: float = 1.0):
    """Normal values, the second half of the rows 2^10 larger: a colwise
    block that took a row's scale would be far off."""
    x = torch.randn((m, n), generator=g, device="cuda") * mag
    x[m // 2:] *= 1024.0
    return x.to(dtype or torch.bfloat16)


def check_bytes_equal(torch, name: str, got, ref,
                      parts=("row", "col", "srow", "scol")) -> None:
    """Holds payloads and scale grids (None where absent) to the plain
    version's, byte for byte."""
    found, ok = [], True
    for part, a, r in zip(parts, got, ref):
        if r is None and a is None:
            continue
        n = payload_diff(torch, a, r)[0] if a.shape == r.shape else -1
        found.append(f"{part} {n}")
        ok = ok and n == 0
    log(f"  {name}: bytes that differ from the plain version: "
        f"{', '.join(found)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: bytes are not equal")


def check_mxfp8_quantize(torch, timer, results):
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        mxfp8_quantize_1x, mxfp8_quantize_1x_plain, mxfp8_quantize_2x,
        mxfp8_quantize_2x_plain)
    e4m3 = torch.float8_e4m3fn
    log(f"[3i] mxfp8_quantize_2x and mxfp8_quantize_1x: {MXFP8_SHAPES} "
        f"bf16 -> e4m3 with E8M0 scales, rows of two magnitudes 2^10 apart")
    g = torch.Generator(device="cuda").manual_seed(9)
    for m, n in MXFP8_SHAPES:
        x = mxfp8_input(torch, g, m, n)
        got = mxfp8_quantize_2x(x)
        torch.cuda.synchronize()
        check_bytes_equal(torch, f"2x ({m}, {n})", got,
                          mxfp8_quantize_2x_plain(x, e4m3))
        for colwise in (False, True):
            got = mxfp8_quantize_1x(x, colwise=colwise)
            torch.cuda.synchronize()
            check_bytes_equal(
                torch, f"1x {'colwise' if colwise else 'rowwise'} ({m}, {n})",
                got, mxfp8_quantize_1x_plain(x, e4m3, colwise=colwise),
                ("data", "scale"))
        ms2 = timer(lambda: mxfp8_quantize_2x(x))
        plain2 = timer(lambda: mxfp8_quantize_2x_plain(x, e4m3))
        ms_row = timer(lambda: mxfp8_quantize_1x(x))
        ms_col = timer(lambda: mxfp8_quantize_1x(x, colwise=True))
        plain1 = timer(lambda: mxfp8_quantize_1x_plain(x, e4m3,
                                                       colwise=True))
        # Read x once; write each payload and its grid, a byte an element
        # and a byte per 32; about four f32 operations an element and
        # orientation (abs, max, multiply, clip).
        el = m * n
        b2, by2 = bound_ms(2 * el + 2 * (el + el // 32), 8 * el, F32_FLOPS)
        b1, by1 = bound_ms(2 * el + el + el // 32, 4 * el, F32_FLOPS)
        log(f"  ({m}, {n}): 2x kernel {ms2:.4f} ms, plain {plain2:.4f} ms, "
            f"bound {b2:.4f} ms ({by2}); 1x rowwise {ms_row:.4f} ms, "
            f"colwise {ms_col:.4f} ms, plain (colwise) {plain1:.4f} ms, bound "
            f"{b1:.4f} ms ({by1})")
        if n != 14336:
            continue
        results["mxfp8_quantize_2x"] = dict(
            name="mxfp8_quantize_2x", route="cuda",
            source="transformerengine_tpu_torch/csrc/mxfp8_quantize.cu",
            replaces="transformerengine_tpu/ops/quantize_kernels.py:826",
            max_abs_err=0.0, ms=ms2, plain_ms=plain2, bound_ms=b2,
            bound_by=by2, library_ms=None,
            shape=f"({m}, {n}) bf16 -> e4m3 + E8M0, both orientations")
        results["mxfp8_quantize_1x"] = dict(
            name="mxfp8_quantize_1x", route="cuda",
            source="transformerengine_tpu_torch/csrc/mxfp8_quantize.cu",
            replaces="transformerengine_tpu/ops/quantize_kernels.py:765",
            max_abs_err=0.0, ms=(ms_row + ms_col) / 2, plain_ms=plain1,
            bound_ms=b1, bound_by=by1, library_ms=None,
            shape=f"({m}, {n}) bf16 -> e4m3 + E8M0, one orientation (the "
                  f"mean of rowwise {ms_row:.4f} and colwise {ms_col:.4f} ms)")


def check_mxfp8_norm_outs(torch, name: str, outs, x, gamma, beta, kw):
    """Holds mxfp8_norm_quantize_2x's (row, col, srow, scol, rsigma[, mu])
    to its plain version: payloads and grids byte for byte to the plain
    normalize and quantize from the kernel's own statistics; the
    statistics to the plain version's within f32 ulps; and against the
    fully plain version (statistics summed in another order) at most one
    byte in 10^5 one step apart. Returns the largest difference of the
    rowwise dequantized values against the fully plain version's."""
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        mxfp8_norm_quantize_2x_plain)
    from transformerengine_tpu_torch.quantize.scaling_modes import (
        ScalingMode)
    from transformerengine_tpu_torch.quantize.tensor import ScaledTensor1x
    layernorm = kw["norm"] == "layernorm"
    q = outs[0].dtype
    own = mxfp8_norm_quantize_2x_plain(
        x, gamma, beta, q, stats=(outs[5] if layernorm else None, outs[4]),
        **kw)
    check_bytes_equal(torch, f"{name} (its own statistics)", outs[:4],
                      own[:4])
    ref = mxfp8_norm_quantize_2x_plain(x, gamma, beta, q, **kw)
    check(f"{name} rsigma", outs[4], ref[4],
          RSIGMA_RTOL * float(ref[4].abs().max()))
    if layernorm:
        check(f"{name} mu", outs[5], ref[5],
              1e-6 * float(ref[5].abs().max()) + 1e-7)
    for part, a, r in zip(("row", "col", "srow", "scol"), outs[:4], ref[:4]):
        if r is None:
            continue
        n, dist, _ = payload_diff(torch, a, r)
        limit = NORM_DIFF_SHARE * r.numel()
        ok = n <= limit and dist <= 1
        log(f"  {name} {part} against the fully plain version: {n} of "
            f"{r.numel()} bytes differ (limit {limit:.0f}), largest code "
            f"distance {dist} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {part} disagrees")

    def values(row, srow):
        return ScaledTensor1x(row, srow, None, torch.float32,
                              scaling_mode=ScalingMode.MXFP8_1D_SCALING
                              ).dequantize()
    return float((values(outs[0], outs[2]) - values(ref[0], ref[2])).abs()
                 .max())


def check_mxfp8_norm(torch, timer, results):
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        mxfp8_norm_quantize_2x_plain)
    from transformerengine_tpu_torch.quantize.quantizer import (
        BlockScaleQuantizer, QuantizeLayout)
    m, h = TRAIN_B * TRAIN_S, 4096
    e4m3 = torch.float8_e4m3fn
    log(f"[3j] mxfp8_norm_quantize_2x through "
        f"BlockScaleQuantizer.quantize_normed: RMSNorm of the layers' "
        f"({m}, {h}) bf16 input, e4m3, both orientations and rowwise-only")
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((m, h), generator=g, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((h,), generator=g, device="cuda")
    quant = BlockScaleQuantizer(e4m3, QuantizeLayout.ROWWISE_COLWISE)
    kw = dict(norm="rmsnorm", zero_centered_gamma=False, epsilon=1e-5)
    err, ms = 0.0, {}
    for layout in (None, QuantizeLayout.ROWWISE):
        ro = layout is not None

        def fused(layout=layout):
            return quant.quantize_normed(x, gamma, None, layout=layout, **kw)

        out, _, rsigma = fused()
        torch.cuda.synchronize()
        rw, cw = (out, None) if ro else (out.rowwise, out.colwise)
        outs = (rw.data, None if ro else cw.data, rw.scale_inv,
                None if ro else cw.scale_inv, rsigma.reshape(m, 1))
        err = max(err, check_mxfp8_norm_outs(
            torch, "rmsnorm rowwise-only" if ro else "rmsnorm 2x", outs, x,
            gamma, None, dict(kw, rowwise_only=ro)))
        ms[ro] = timer(fused)
    plain_ms = timer(lambda: mxfp8_norm_quantize_2x_plain(x, gamma, None,
                                                          e4m3, **kw))
    # Read x and gamma, write two payloads, two grids and rsigma; about
    # fourteen f32 operations an element (square, sum, normalize, scale,
    # round, and both orientations' abs, max, multiply, clip).
    el = m * h
    b_ms, b_by = bound_ms(2 * el + 4 * h + 2 * (el + el // 32) + 4 * m,
                          14 * el, F32_FLOPS)
    log(f"  2x kernel {ms[False]:.4f} ms, rowwise-only {ms[True]:.4f} ms, "
        f"plain (2x) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["mxfp8_norm_quantize_2x"] = dict(
        name="mxfp8_norm_quantize_2x", route="cuda",
        source="transformerengine_tpu_torch/csrc/mxfp8_norm_quantize.cu",
        replaces="transformerengine_tpu/ops/quantize_kernels.py:553",
        max_abs_err=err, ms=ms[False], plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"RMSNorm ({m}, {h}) bf16 -> e4m3 + E8M0, both orientations "
              f"(rowwise-only {ms[True]:.4f} ms)")


def check_mxfp8_variants(torch) -> None:
    """The MXFP8 kernels' other dtypes, formats and shapes, each against
    its plain version on the card."""
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        mxfp8_norm_quantize_2x, mxfp8_quantize_2x, mxfp8_quantize_2x_plain)
    from transformerengine_tpu_torch.quantize.quantizer import (
        BlockScaleQuantizer, QuantizeLayout)
    log("[3k] MXFP8 kernels' other variants at small shapes")
    g = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    # Ragged shapes; f32 and e5m2; blocks below the E8M0 clip (amax under
    # 2^-118: exponent -127, multiplier 2^127) with subnormal elements;
    # all-zero blocks; gradient-sized values.
    for m, n, xt, qt, mag in ((100, 37, bf16, e4m3, 3.0),
                              (24, 40, f32, e5m2, 1.0),
                              (33, 4097, f32, e4m3, 1e-37),
                              (256, 384, bf16, e4m3, 1e-5),
                              (96, 160, f32, e5m2, 2.0 ** 20)):
        x = mxfp8_input(torch, g, m, n, f32, mag)
        if mag < 1e-30:
            x[:, :64] *= 2.0 ** -12           # subnormal elements
        x[:32, :32] = 0.0
        x = x.to(xt)
        check_bytes_equal(torch, f"2x ({m}, {n}) {xt} -> {qt} magnitude "
                          f"{mag:g}", mxfp8_quantize_2x(x, qt),
                          mxfp8_quantize_2x_plain(x, qt))
        if m == 100:
            quant = BlockScaleQuantizer(qt, QuantizeLayout.ROWWISE_COLWISE)
            for layout in (QuantizeLayout.ROWWISE, QuantizeLayout.COLWISE):
                t = quant.quantize(x, layout=layout)
                ref = quant._quantize_2d(x if layout is QuantizeLayout.ROWWISE
                                         else x.t())
                check_bytes_equal(torch, f"quantizer API {layout.name} "
                                  f"({m}, {n})", (t.data, t.scale_inv),
                                  ref[:2], ("data", "scale"))
    # The fused norm: LayerNorm with beta and zero-centered gamma, an f32
    # LayerNorm rowwise-only to e5m2, RMSNorm with zero-centered gamma.
    for m, h, xt, norm, zcg, beta, qt, ro in (
            (256, 384, bf16, "layernorm", True, True, e4m3, False),
            (64, 96, f32, "layernorm", False, True, e5m2, True),
            (512, 1024, bf16, "rmsnorm", True, False, e4m3, False)):
        x = (torch.randn((m, h), generator=g, device="cuda") * 2 + 0.5).to(xt)
        gamma = torch.randn((h,), generator=g, device="cuda") * 0.2 + \
            (0.0 if zcg else 1.0)
        bt = torch.randn((h,), generator=g, device="cuda") * 0.1 \
            if beta else None
        kw = dict(norm=norm, zero_centered_gamma=zcg, epsilon=1e-5,
                  rowwise_only=ro)
        check_mxfp8_norm_outs(
            torch, f"{norm} ({m}, {h}) {xt} zcg={zcg} beta={beta} {qt} "
            f"rowwise_only={ro}", mxfp8_norm_quantize_2x(x, gamma, bt, qt,
                                                         **kw),
            x, gamma, bt, kw)


# The grouped QDQ's shapes on the MoE path at MIXTRAL_8X7B width: the
# stacked up-projections (E, H, 2F) and down-projections (E, F, H).
QDQ_SHAPES = ((8, 4096, 28672), (8, 14336, 4096))


def check_mxfp8_qdq_grouped(torch, timer, results):
    """mxfp8_qdq_2x_grouped at the MoE path's shapes, byte for byte
    against its plain version (the reference's chain), timed; then f32,
    e5m2, zero blocks and signed zeros at a small shape, and an unaligned
    shape, which the wrapper declines (None) and the grouped layer takes
    through the chain. Runs before any model is resident: the plain
    version's f32 temporaries at (8, 4096, 28672) are 3.8 GB each."""
    from transformerengine_tpu_torch.grouped_dense import _qdq_kernel
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        mxfp8_qdq_2x_grouped, mxfp8_qdq_2x_grouped_plain)
    from transformerengine_tpu_torch.quantize.quantizer import (
        BlockScaleQuantizer)
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    log(f"[3q] mxfp8_qdq_2x_grouped: {QDQ_SHAPES} bf16 expert kernels -> "
        f"MXFP8 along K -> bf16 nn and tn, columns of two magnitudes 2^8 "
        f"apart")
    g = torch.Generator(device="cuda").manual_seed(17)
    times = {}
    for shape in QDQ_SHAPES:
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        x[:, :, shape[2] // 2:] *= 256.0
        x[0, :32, :32] = 0.0
        x = x.to(torch.bfloat16)
        got = mxfp8_qdq_2x_grouped(x)
        torch.cuda.synchronize()
        check_bytes_equal(torch, f"{shape}", got,
                          mxfp8_qdq_2x_grouped_plain(x, e4m3), ("nn", "tn"))
        del got
        ms = timer(lambda: mxfp8_qdq_2x_grouped(x))
        plain = timer(lambda: mxfp8_qdq_2x_grouped_plain(x, e4m3))
        torch.cuda.empty_cache()
        # Read the kernels once (2 bytes an element), write nn and tn (2
        # each); about six f32 operations an element (abs, max, multiply,
        # clip, multiply, round).
        el = x.numel()
        bound, by = bound_ms(6 * el, 6 * el, F32_FLOPS)
        log(f"  {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), {bound / ms:.1%} of the bound")
        times[shape] = (ms, plain, bound, by)
        del x
    ms, plain, bound, by = times[QDQ_SHAPES[0]]
    ms2, plain2, bound2, _ = times[QDQ_SHAPES[1]]
    results["mxfp8_qdq_2x_grouped"] = dict(
        name="mxfp8_qdq_2x_grouped", route="cuda",
        source="transformerengine_tpu_torch/csrc/mxfp8_qdq_grouped.cu",
        replaces="transformerengine_tpu/ops/quantize_kernels.py:704",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
        library_ms=None,
        shape=f"{QDQ_SHAPES[0]} bf16 -> MXFP8 -> bf16 nn and tn; at "
              f"{QDQ_SHAPES[1]} {ms2:.4f} ms, plain {plain2:.4f} ms, bound "
              f"{bound2:.4f} ms")
    for shape, xt, qt in (((2, 64, 128), torch.float32, e5m2),
                          ((3, 96, 256), torch.bfloat16, e4m3),
                          ((2, 64, 384), torch.float32, e4m3)):
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        x[:, :, shape[2] // 2:] *= 256.0
        x[0, :32, :32] = 0.0
        x[1, :32, 5] = -0.0
        x[-1, :32, 6] = 2.0 ** -130
        x = x.to(xt)
        check_bytes_equal(torch, f"{shape} {xt} -> {qt}",
                          mxfp8_qdq_2x_grouped(x, qt),
                          mxfp8_qdq_2x_grouped_plain(x, qt), ("nn", "tn"))
    x = torch.randn((2, 48, 96), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    if mxfp8_qdq_2x_grouped(x) is not None:
        raise AssertionError("the wrapper took an unaligned shape")
    qdq = _qdq_kernel(BlockScaleQuantizer(e4m3), x)
    check_bytes_equal(torch, "(2, 48, 96) through the grouped layer's chain",
                      (qdq.nn.contiguous(), qdq.tn),
                      mxfp8_qdq_2x_grouped_plain(x, e4m3),
                      ("nn", "tn"))

# The x and gradient shapes of the training path's GEMMs: M = B * S tokens
# against the layer's widths (hidden, QKV, FFN, and the gated FFN's two
# halves).
NVFP4_SHAPES = tuple((TRAIN_B * TRAIN_S, n) for n in (4096, 6144, 14336,
                                                      28672))


def nvfp4_input(torch, g, m: int, n: int, dtype=None):
    """Normal values with rows of three magnitudes (1e-3, 1 and 1e3): the
    small rows' blocks take subnormal e4m3 scales under the tensor scale
    of the large ones."""
    x = torch.randn((m, n), generator=g, device="cuda")
    x[:m // 4] *= 1e-3
    x[m // 2:] *= 1e3
    return x.to(dtype or torch.bfloat16)


def check_nvfp4_pair(torch, name: str, x, mask, seed=None):
    """Both NVFP4 kernels on ``x`` against their plain versions: the two
    amaxes equal, then payloads and scales byte for byte under the tensor
    scales the amaxes give. Returns the kernels' outputs."""
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        nvfp4_amax_2x, nvfp4_amax_2x_plain, nvfp4_quantize_2x,
        nvfp4_quantize_2x_plain)
    from transformerengine_tpu_torch.quantize.qmath import nvfp4_tensor_scale
    amax = nvfp4_amax_2x(x, mask)
    torch.cuda.synchronize()
    ref = nvfp4_amax_2x_plain(x, mask)
    same = all(float(a) == float(r) for a, r in zip(amax, ref))
    log(f"  {name}: amaxes {[float(a) for a in amax]} "
        f"{'equal' if same else 'DIFFER from'} the plain version's "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: nvfp4_amax_2x disagrees")
    ts = [nvfp4_tensor_scale(a) for a in amax]
    got = nvfp4_quantize_2x(x, *ts, mask, seed)
    torch.cuda.synchronize()
    check_bytes_equal(torch, name, got, nvfp4_quantize_2x_plain(
        x, *ts, mask, seed), ("row", "srow", "col", "scol"))
    return amax, ts, got


def check_nvfp4_quantize(torch, timer, results):
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        nvfp4_amax_2x, nvfp4_amax_2x_plain, nvfp4_quantize_2x,
        nvfp4_quantize_2x_plain)
    log(f"[3o] nvfp4_amax_2x and nvfp4_quantize_2x: {NVFP4_SHAPES} bf16 -> "
        f"e2m1 with e4m3 scales per 16, without and with the RHT (sign "
        f"mask 0, the recipe's), rows of three magnitudes")
    g = torch.Generator(device="cuda").manual_seed(12)
    for m, n in NVFP4_SHAPES:
        x = nvfp4_input(torch, g, m, n)
        el = m * n
        # Read x once (the amax pass writes two floats); the quantize pass
        # writes two one-byte payloads and two grids of a byte per 16.
        # Operations an element: abs and max, and with the RHT 32 more (16
        # products and 16 sums); the quantize about 19 an orientation
        # (abs, max, scale, clip, 14 comparisons) and the RHT's 32.
        for mask in (None, 0):
            rht = mask is not None
            _, ts, _ = check_nvfp4_pair(
                torch, f"({m}, {n}) {'with' if rht else 'without'} the RHT",
                x, mask)
            ms_a = timer(lambda: nvfp4_amax_2x(x, mask))
            plain_a = timer(lambda: nvfp4_amax_2x_plain(x, mask))
            ms_q = timer(lambda: nvfp4_quantize_2x(x, *ts, mask))
            plain_q = timer(lambda: nvfp4_quantize_2x_plain(x, *ts, mask))
            ba, bya = bound_ms(2 * el + 8, (34 if rht else 2) * el,
                               F32_FLOPS)
            bq, byq = bound_ms(2 * el + 2 * (el + el // 16),
                               (70 if rht else 38) * el, F32_FLOPS)
            log(f"    amax kernel {ms_a:.4f} ms, plain {plain_a:.4f} ms, "
                f"bound {ba:.4f} ms ({bya}); quantize kernel {ms_q:.4f} ms, "
                f"plain {plain_q:.4f} ms, bound {bq:.4f} ms ({byq})")
            if n != 14336 or not rht:
                continue
            shape = f"({m}, {n}) bf16 with the RHT"
            results["nvfp4_amax_2x"] = dict(
                name="nvfp4_amax_2x", route="cuda",
                source="transformerengine_tpu_torch/csrc/nvfp4_quantize.cu",
                replaces="transformerengine_tpu/ops/quantize_kernels.py:376",
                max_abs_err=0.0, ms=ms_a, plain_ms=plain_a, bound_ms=ba,
                bound_by=bya, library_ms=None,
                shape=shape + ": amax(|x|) and amax(|RHT(x^T)|)")
            results["nvfp4_quantize_2x"] = dict(
                name="nvfp4_quantize_2x", route="cuda",
                source="transformerengine_tpu_torch/csrc/nvfp4_quantize.cu",
                replaces="transformerengine_tpu/ops/quantize_kernels.py:458",
                max_abs_err=0.0, ms=ms_q, plain_ms=plain_q, bound_ms=bq,
                bound_by=byq, library_ms=None,
                shape=shape + " -> e2m1 + e4m3 scales, both orientations")


# Stochastic rounding's bias: each code's mean over SR_SEEDS seeds lies
# within 6 standard deviations of the scaled value (a draw between
# neighbours ``gap`` apart has a deviation of at most gap / 2), and the
# mean over every element and seed within 5 / sqrt(count * SR_SEEDS) grid
# units of it (no gap exceeds 2, so no draw deviates by more than 1). At
# 6 deviations no element of the 2 x 16384 fails by chance (2e-9 each).
SR_SEEDS = 256


def check_nvfp4_sr(torch, x, mask) -> None:
    """Stochastic rounding on the card: one seed gives the same bytes
    twice (and the plain version's, in check_nvfp4_pair); every code is
    one of the two grid neighbours of its scaled value, with its sign;
    over SR_SEEDS seeds the codes are unbiased (SR_SEEDS's rule)."""
    from transformerengine_tpu_torch.ops.quantize_kernels import (
        nvfp4_quantize_2x)
    from transformerengine_tpu_torch.quantize.hadamard import (
        rht_matrix, rotate)
    amax, ts, near = check_nvfp4_pair(torch, "round to nearest, the scales",
                                      x, mask)
    _, _, one = check_nvfp4_pair(torch, "stochastic rounding, seed 7", x,
                                 mask, seed=7)
    again = nvfp4_quantize_2x(x, *ts, mask, 7)
    check_bytes_equal(torch, "the same seed again", again, one,
                      ("row", "srow", "col", "scol"))
    grid = torch.tensor((0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0),
                        device="cuda")
    rot = rotate(x.t().float(), rht_matrix(mask, "cuda"))
    for v, t, scales, data_i, name in ((x.float(), ts[0], near[1], 0,
                                        "rowwise"),
                                       (rot, ts[1], near[3], 2, "colwise")):
        s_eff = scales.float() * t
        inv = torch.where(s_eff > 0, 1.0 / s_eff.clamp_min(2.0 ** -126),
                          torch.zeros_like(s_eff))
        y = v * inv.repeat_interleave(16, dim=1)
        y = torch.copysign(y.abs().clamp(max=6.0), y)
        lo_i = ((y.abs()[..., None] >= grid).sum(-1) - 1).clamp(0, 7)
        lo, up = grid[lo_i], grid[(lo_i + 1).clamp(max=7)]
        total = torch.zeros_like(y)
        for seed in range(SR_SEEDS):
            codes = nvfp4_quantize_2x(x, *ts, mask, seed)[data_i].float()
            mag = codes.abs()
            if not bool((((mag == lo) | (mag == up))
                         & (codes * y >= 0)).all()):
                raise AssertionError(f"{name} seed {seed}: a code is not a "
                                     f"neighbour of its value")
            total += codes
        mean = total / SR_SEEDS
        dev = ((mean - y).abs() / ((up - lo).clamp_min(1e-30) / 2)
               * SR_SEEDS ** 0.5)
        worst = float(dev.max())
        bias = float((mean - y).mean().abs()) * (y.numel() * SR_SEEDS) ** 0.5
        ok = worst <= 6 and bias <= 5
        log(f"  stochastic rounding {name} over {SR_SEEDS} seeds: every code "
            f"a neighbour of its value; largest deviation of a mean "
            f"{worst:.2f} standard deviations (limit 6), overall bias "
            f"{bias:.2f} (limit 5) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"stochastic rounding {name} is biased")


def check_nvfp4_variants(torch) -> None:
    """The NVFP4 kernels' other inputs at small shapes, each against its
    plain version on the card."""
    log("[3p] NVFP4 kernels' other variants at small shapes")
    g = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    # f32 input with a sign mask; bf16 with another.
    check_nvfp4_pair(torch, "(208, 400) f32, sign mask 0x1234",
                     nvfp4_input(torch, g, 208, 400, f32), 0x1234)
    check_nvfp4_pair(torch, "(256, 512) bf16, sign mask 0xBEEF",
                     nvfp4_input(torch, g, 256, 512), 0xBEEF)
    # An all-zero tensor: amaxes 0, tensor scales 1, zero scales and codes.
    zeros = torch.zeros((64, 128), dtype=bf16, device="cuda")
    amax, ts, out = check_nvfp4_pair(torch, "(64, 128) zeros", zeros, 0)
    if any(float(a) for a in amax) or any(float(t) != 1.0 for t in ts) or \
            any(bool(o.view(torch.uint8).any()) for o in out):
        raise AssertionError("an all-zero tensor does not quantize to zeros")
    # Negative values that round to -0 beside a larger element, and
    # blocks of 1e-6 under a tensor scale set by values near 1: subnormal
    # e4m3 scales.
    x = torch.randn((128, 256), generator=g, device="cuda")
    x[:32] = -x[:32].abs() * 1e-3
    x[:32, ::16] = 6.0
    x[64:96] *= 1e-6
    _, _, out = check_nvfp4_pair(torch, "(128, 256) f32, -0 codes and "
                                 "subnormal scales", x, 0)
    neg0 = int((out[0].view(torch.uint8) == 0x80).sum())
    sub = int(((out[1].view(torch.uint8) & 0x7F) < 8).sum())
    log(f"    {neg0} codes are -0 and {sub} rowwise scales subnormal")
    if not neg0 or not sub:
        raise AssertionError("the input made no -0 code or subnormal scale")
    check_nvfp4_sr(torch, nvfp4_input(torch, g, 64, 256, f32), 0x5A5A)


def paged_pool(torch, g, n_pages: int, page: int, hkv: int, d: int,
               table, mag, dtype):
    """(K, V) pools of ``n_pages`` random pages; the pages that ``table``
    (B, max_pages) gives each slot take that slot's magnitude ``mag`` (B,),
    and fp8 pools are quantized with each slot's calibrated scale. Returns
    (k, v, dequant scales (B,) or None)."""
    shape = (n_pages, page, hkv, d)
    k = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    page_mag = torch.ones(n_pages, device="cuda")
    idx = table.long().clamp_min(0)
    page_mag[idx.flatten()] = mag[:, None].expand_as(idx).flatten()
    k, v = k * page_mag[:, None, None, None], v * page_mag[:, None, None, None]
    if dtype != torch.float8_e4m3fn:
        return k.to(dtype), v.to(dtype), None
    from transformerengine_tpu_torch.inference.kv_cache import (
        calibrate_kv_scale, quantize_for_cache)
    b = table.shape[0]
    kv_scale = calibrate_kv_scale(k[idx].reshape(b, -1, hkv, d),
                                  v[idx].reshape(b, -1, hkv, d),
                                  per_slot=True)
    page_scale = torch.ones(n_pages, device="cuda")
    page_scale[idx.flatten()] = kv_scale[:, None].expand_as(idx).flatten()
    return (quantize_for_cache(k, page_scale, dtype),
            quantize_for_cache(v, page_scale, dtype), 1.0 / kv_scale)


def check_paged_attention(torch, timer, results):
    from transformerengine_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    b, hq, hkv, d, page = BATCH, 32, 8, 128, 128
    mpps = -(-(max(PROMPT_LENS) + NEW_TOKENS) // page)
    n_pages = b * mpps
    lens = mixed_lengths(torch, b) + NEW_TOKENS // 2
    log(f"[3l] paged_decode_attention: B={b} Hq={hq} Hkv={hkv} D={d}, fp8 "
        f"pages of {page} ({n_pages} in the pool, a shuffled table of {mpps} "
        f"a sequence) with per-slot scales, lengths "
        f"{sorted(set(lens.tolist()))}")
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(
        torch.bfloat16)
    table = torch.randperm(n_pages, generator=g, device="cuda").to(
        torch.int32).reshape(b, mpps)
    # Slot magnitudes 2^-4 to 2^3, as in [3c].
    mag = 2.0 ** (torch.arange(b, device="cuda") - b // 2)
    kc, vc, dq = paged_pool(torch, g, n_pages, page, hkv, d, table, mag,
                            torch.float8_e4m3fn)

    def kernel():
        return paged_decode_attention(q, kc, vc, table, lens, kv_scale=dq)

    def plain():
        return paged_decode_attention_plain(
            q, kc, vc, table, lens, kv_scale=dq, scale=d ** -0.5,
            out_dtype=torch.bfloat16)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    # Both keep the softmax in f32 (the reference's Pallas form); the
    # bf16 outputs round apart where the f32 sums' order moves them.
    err = check("O", out, ref, row_tol(ref, BF16_ROW_RTOL))
    ms, plain_ms = timer(kernel), timer(plain)
    total_len = int(lens.sum())
    nbytes = 2 * total_len * hkv * d + 2 * 2 * b * hq * d + 4 * b * mpps \
        + 4 * b + 4 * b
    flops = 4 * hq * d * total_len
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); library: none (no PyTorch call reads an fp8 paged "
        f"cache)")
    results["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="transformerengine_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="transformerengine_tpu/ops/paged_attention.py:87",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"decode B={b} Hq={hq} Hkv={hkv} D={d} fp8 pages of {page}")


def check_paged_variants(torch) -> None:
    """The paged kernel's other page and query dtypes, head dims and
    options at small shapes: a shuffled table with unallocated entries
    past the lengths, a length of 0 (a zero row), a sequence that fills
    its whole table, and the sink."""
    from transformerengine_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    log("[3m] paged_decode_attention's other variants at small shapes")
    g = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16, e4m3 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
    b, hkv, page, mpps = 4, 2, 16, 6
    n_pages = b * mpps + 5
    lens = torch.tensor([37, 0, page * mpps, 5], dtype=torch.int32,
                        device="cuda")
    for qt, ct, d, hq, sink in ((f32, f32, 64, 8, False),
                                (f32, f32, 256, 4, True),
                                (bf16, bf16, 128, 8, True),
                                (f32, bf16, 64, 16, False),
                                (bf16, e4m3, 64, 2, True)):
        table = torch.randperm(n_pages, generator=g, device="cuda")[
            :b * mpps].to(torch.int32).reshape(b, mpps)
        table[0, 3:] = -1
        table[3, 1:] = -1
        mag = torch.rand(b, generator=g, device="cuda") * 2 + 0.5
        kc, vc, dq = paged_pool(torch, g, n_pages, page, hkv, d, table, mag,
                                ct)
        if dq is None:
            dq = torch.rand(b, generator=g, device="cuda") + 0.5
        q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(qt)
        sinks = torch.randn(hq, generator=g, device="cuda") if sink else None
        out = paged_decode_attention(q, kc, vc, table, lens, kv_scale=dq,
                                     softmax_sink=sinks)
        ref = paged_decode_attention_plain(
            q, kc, vc, table, lens, kv_scale=dq, scale=d ** -0.5,
            out_dtype=qt, softmax_sink=sinks)
        # f32 outputs: f32 sums in another order (1e-5 of the largest);
        # bf16 outputs as in [3l].
        tol = (1e-5 * float(ref.abs().max()) if qt == f32
               else row_tol(ref, BF16_ROW_RTOL))
        check(f"paged q {qt} pages {ct} D={d} G={hq // hkv} sink={sink}",
              out, ref, tol)
        if bool(out[1].abs().max() != 0):
            raise AssertionError("a length of 0 must give a zero row")


# The four GEMMs of one LLAMA_8B layer as (K, N).
LAYER_KN = {"qkv": (4096, 6144), "out": (4096, 4096), "wi": (4096, 28672),
            "wo": (14336, 4096)}


def kn_operands(torch, g, m: int, k: int, n: int, packed: bool = False,
                xt=None):
    """x (M, K) and a block-scaled (K, N) weight: e4m3 codes with
    E8M0-derived bf16 scales (block 32), or split-plane packed e2m1 codes
    with e4m3-valued bf16 scales (block 16) and an out_scale."""
    x = torch.randn((m, k), generator=g, device="cuda").to(
        xt or torch.bfloat16)
    if packed:
        block = 16
        payload = torch.randint(0, 256, (k // 2, n), generator=g,
                                device="cuda", dtype=torch.uint8)
        scale = (torch.rand((k // block, n), generator=g, device="cuda") * 4
                 + 0.05).to(torch.float8_e4m3fn).to(torch.bfloat16)
        out_scale = torch.tensor([0.37], device="cuda")
    else:
        block = 32
        payload = torch.randn((k, n), generator=g, device="cuda").to(
            torch.float8_e4m3fn)
        exp = torch.randint(-12, -5, (k // block, n), generator=g,
                            device="cuda")
        scale = torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                            exp).to(torch.bfloat16)
        out_scale = None
    return x, payload, scale, out_scale, block


def check_kn_matvec(torch, timer, results):
    g = torch.Generator(device="cuda").manual_seed(14)
    log("[3n] decode_kn_matvec: the four decode GEMMs of one LLAMA_8B layer "
        "at M = 8 (x bf16, (K, N) e4m3 with E8M0-derived bf16 scales, f32 "
        "out)")
    kn_layer(torch, timer, results, g, False)
    log("[3n] decode_kn_matvec, packed branch: the same GEMMs against "
        "NVFP4's (K/2, N) split-plane e2m1 codes, e4m3-valued bf16 scales "
        "(block 16) and an out_scale")
    kn_layer(torch, timer, results, g, True)
    kn_variants(torch, g)
    decode_codes(torch)


def decode_codes(torch) -> None:
    """Every weight code through both decode GEMMs, bit for bit against the
    plain versions: x one-hot, so each output is one dequantized weight
    (times its scale). Every e4m3 code but the NaNs (which no payload
    holds) of an (N, K) weight, and of a (K, N) payload under scales of 1,
    2^-7, 0.375 and 3 (the bf16 product rounds like the reference's); every
    packed byte, both its codes."""
    from transformerengine_tpu_torch.ops.decode_matmul import (
        decode_kn_matvec, decode_kn_matvec_plain, decode_tn_matvec,
        decode_tn_matvec_plain)
    codes = torch.arange(256, dtype=torch.int32)
    codes = torch.where((codes & 0x7f) == 0x7f, 0, codes).to(torch.uint8)
    e4m3 = codes.view(torch.float8_e4m3fn).to("cuda")
    packed = torch.arange(256, dtype=torch.int32).to(torch.uint8).to("cuda")

    def one_hot(m: int, k: int, at):
        x = torch.zeros((m, k), device="cuda")
        for row, col in enumerate(at):
            x[row, col] = 1.0
        return x.to(torch.bfloat16)

    def exact(name: str, got, ref) -> None:
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: a dequantized code differs")

    w = e4m3[:, None].repeat(1, 64)
    x = one_hot(1, 64, (5,))
    exact("tn e4m3", decode_tn_matvec(x, w, None),
          decode_tn_matvec_plain(x, w, None))
    for s in (1.0, 2.0 ** -7, 0.375, 3.0):
        sc = torch.full((2, 256), s, device="cuda").to(torch.bfloat16)
        p = e4m3[None, :].repeat(16, 1)
        x = one_hot(1, 16, (3,))
        exact(f"kn e4m3 x {s}",
              decode_kn_matvec(x, p, sc[:1], block=16),
              decode_kn_matvec_plain(x, p, sc[:1], block=16))
        p = packed[None, :].repeat(16, 1)
        x = one_hot(2, 32, (2, 16 + 7))
        exact(f"kn packed x {s}",
              decode_kn_matvec(x, p, sc, block=16, packed=True),
              decode_kn_matvec_plain(x, p, sc, block=16, packed=True))
    log("  every e4m3 code and packed byte, both kernels: equal to the plain "
        "versions bit for bit")


def kn_layer(torch, timer, results, g, packed: bool) -> None:
    """One branch of decode_kn_matvec at the four GEMMs of one LLAMA_8B
    layer, M = BATCH: each held against its plain version, repeated for
    determinism and timed beside its bound and torch.mm on the
    dequantized weight (the out_scale folded into it)."""
    from transformerengine_tpu_torch.ops.decode_matmul import (
        decode_kn_matvec, decode_kn_matvec_plain, dequantize_kn)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, flops=0.0,
               err=0.0)
    for gemm, (k, n) in LAYER_KN.items():
        x, p, s, o, block = kn_operands(torch, g, BATCH, k, n, packed)

        def kernel():
            return decode_kn_matvec(x, p, s, o, block=block, packed=packed)

        def plain():
            return decode_kn_matvec_plain(x, p, s, o, block=block,
                                          packed=packed)

        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        # f32 sums over K in another order: 1e-4 of the largest output, as
        # [3a].
        err = check(f"{gemm} K={k} N={n}", got, ref,
                    1e-4 * float(ref.abs().max()))
        again = kernel()
        if not torch.equal(again, got):
            raise AssertionError("decode_kn_matvec is not deterministic")
        same_rows(torch, f"{gemm} K={k} N={n}",
                  decode_kn_matvec(x[:1], p, s, o, block=block,
                                   packed=packed), got)
        tot["err"] = max(tot["err"], err)
        tot["ms"] += timer(kernel)
        tot["plain_ms"] += timer(plain)
        w = dequantize_kn(p, s, block, packed)
        if o is not None:
            w = (w.float() * o.float()).to(torch.bfloat16)
        tot["library_ms"] += timer(
            lambda: torch.mm(x, w, out_dtype=torch.float32))
        del w
        tot["nbytes"] += (p.numel() + s.numel() * 2 + BATCH * k * 2
                          + BATCH * n * 4 + (4 if o is not None else 0))
        tot["flops"] += 2 * BATCH * n * k
    b_ms, b_by = bound_ms(tot["nbytes"], tot["flops"])
    log(f"  one layer (4 GEMMs): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, torch.mm on the dequantized bf16 (K, N) "
        f"weight {tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{tot['nbytes'] / 1e6:.1f} MB); results equal from run to run")
    name = "decode_kn_matvec_packed" if packed else "decode_kn_matvec"
    results[name] = dict(
        name=name, route="cuda",
        source="transformerengine_tpu_torch/csrc/decode_kn_matvec.cu",
        replaces="transformerengine_tpu/ops/decode_matmul.py:178",
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=tot["library_ms"],
        shape=("NVFP4 (K/2, N) packed e2m1 weights with an out_scale"
               if packed else "MXFP8 (K, N) e4m3 weights")
        + ", the 4 GEMMs of one LLAMA_8B layer, M=8")


def kn_variants(torch, g) -> None:
    """M = 1 and 32, f32 x, the packed form at M = 8 and 3, and shapes
    off the tiles (N not a multiple of 128, K not of the 1024-row
    chunk)."""
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.ops.decode_matmul import (
        decode_kn_matvec, decode_kn_matvec_plain)
    for m, k, n, packed, xt in ((1, 4096, 4096, False, None),
                                (32, 4096, 4096, False, None),
                                (8, 4096, 4096, False, torch.float32),
                                (8, 4096, 4096, True, None),
                                (3, 1056, 1040, True, torch.float32),
                                (17, 2080, 1552, False, None)):
        x, p, s, o, block = kn_operands(torch, g, m, k, n, packed, xt)
        ref = decode_kn_matvec_plain(x, p, s, o, block=block, packed=packed)
        check(f"M={m} K={k} N={n} x {x.dtype} "
              f"{'packed e2m1, out_scale' if packed else 'e4m3'}",
              decode_kn_matvec(x, p, s, o, block=block, packed=packed), ref,
              1e-4 * float(ref.abs().max()))
    _build.LAUNCHES.clear()


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
    from transformerengine_tpu_torch import Float8CurrentScaling
    from transformerengine_tpu_torch.inference import InferenceParams
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
    ip = InferenceParams(BATCH, max(PROMPT_LENS) + NEW_TOKENS,
                         torch.float8_e4m3fn)
    expect = {"flash_attention_fwd": layers,
              "decode_attention": layers * (NEW_TOKENS - 1),
              "decode_tn_matvec": 4 * layers * (NEW_TOKENS - 1)}
    results["_serve"] = drive_serving(torch, model, ip, expect, results)
    del model


def hold_launches(counts: dict, expect: dict, results) -> None:
    """Holds each kernel's launch count to ``expect`` (a kernel expected
    0 times must not launch), and adds the counts to the results."""
    for name, n in expect.items():
        got = counts.get(name, 0)
        log(f"  launches {name}: {got} (expected {n}) "
            f"{'ok' if got == n else 'FAIL'}")
        if got != n:
            raise AssertionError(f"{name} launched {got} times, expected {n}")
        if got:
            add_launches(results, name, got)


def drive_serving(torch, model, ip, expect: dict, results) -> dict:
    """The serving path at B = BATCH: a warm-up generate, then, with every
    launch count from zero, a prefill of the mixed-length prompts and
    NEW_TOKENS - 1 one-step decodes, each synchronized. Checks the tokens,
    the logits and the launch counts (``expect``); returns TTFT, decode
    ms/step and tok/s, the host's calls per step and the device profile of
    four more steps."""
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.inference import (
        decode_steps, generate, prefill)
    vocab = model.config.vocab_size
    tokens, lengths = prompts(torch, BATCH, max(PROMPT_LENS), vocab,
                              PROMPT_LENS, "cuda")
    warm = generate(model, tokens, lengths, 2, inference_params=ip)
    torch.cuda.synchronize()
    del warm

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    first, caches = prefill(model, tokens, ip, lengths)
    first_host = first.cpu()
    ttft = time.perf_counter() - t0
    # One call a step, synchronized, so that the median and the least
    # step time show the host's cost apart from its slower moments.
    step_s, steps, tok = [], [], first
    for _ in range(NEW_TOKENS - 1):
        t0 = time.perf_counter()
        tok = decode_steps(model, caches, tok, 1)[:, 0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(tok)
    toks = torch.stack(steps, dim=1)
    toks_host = toks.cpu()
    decode_s = sum(step_s)
    counts = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()

    out = torch.cat([first_host[:, None], toks_host], dim=1)
    if out.shape != (BATCH, NEW_TOKENS) or int(out.min()) < 0 or \
            int(out.max()) >= vocab:
        raise AssertionError(f"bad tokens {out.shape} {out.min()} {out.max()}")
    with torch.no_grad():
        logits = model(tokens[:, :16])
    if logits.shape != (BATCH, 16, vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("the model's logits are not finite")
    step_ms = decode_s / (NEW_TOKENS - 1) * 1e3
    median_ms = statistics.median(step_s) * 1e3
    least_ms = min(step_s) * 1e3
    log(f"  TTFT {ttft * 1e3:.2f} ms (prefill of {BATCH}x{max(PROMPT_LENS)} "
        f"tokens), decode {step_ms:.3f} ms/step (median {median_ms:.3f}, "
        f"least {least_ms:.3f}), {BATCH / (step_ms / 1e3):.1f} tok/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    hold_launches(counts, expect, results)
    calls = host_calls_per_step(model, caches, toks[:, -1])
    log(f"  host: {calls} Python calls per decode step")
    stats = dict(ttft_ms=ttft * 1e3, decode_ms_per_step=step_ms,
                 decode_median_ms=median_ms, decode_least_ms=least_ms,
                 tok_per_s=BATCH / (step_ms / 1e3),
                 layers=len(model.layers), host_calls_per_step=calls)
    profile_decode(torch, model, caches, toks[:, -1], stats)
    return stats


def resident_gib(model) -> float:
    """GiB held by the resident kernels' buffers."""
    from transformerengine_tpu_torch.quantize.prequant import (
        PrequantizedKernel)
    return sum(t.numel() * t.element_size() for m in model.modules()
               if isinstance(m, PrequantizedKernel)
               for t in m.buffers()) / 2 ** 30


def serve_paged_block(torch, results, phase: str, recipe, load: dict,
                      in_autocast: bool, key: str, kn_key: str,
                      prefill: dict) -> None:
    """Paged serving with ``recipe``'s block-scaled resident weights at
    phase 4's shape, in the ``"quantized"`` form and then ``"bf16"``: the
    launches at load (``load``), in the prefill (``prefill``) and per
    decode step (the ``"quantized"`` form's GEMMs under ``kn_key``) held
    exactly, TTFT, decode ms/step, tok/s, resident GiB and the busy share.
    With ``in_autocast`` the model runs under ``autocast(recipe)``, which
    quantizes every activation before its GEMM: the ``"quantized"`` form
    takes it dequantized into the KN decode kernel, the ``"bf16"`` form
    into a plain GEMM."""
    import contextlib
    from transformerengine_tpu_torch import _build, autocast
    from transformerengine_tpu_torch.inference import InferenceParams
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.quantize.prequant import (
        BlockResidentKernel, prequantize_kernels)
    cfg = LLAMA_8B
    layers = cfg.num_layers
    name = type(recipe).__name__
    ip = InferenceParams(BATCH, max(PROMPT_LENS) + NEW_TOKENS,
                         torch.float8_e4m3fn, is_paged=True, page_size=128)
    stats = {}
    for mode in ("quantized", "bf16"):
        log(f"[{phase}] paged, {name}-resident serve (block_decode={mode!r}"
            f"{', under autocast' if in_autocast else ''}): LLAMA_8B width, "
            f"{layers} layers, B={BATCH}, prompts {PROMPT_LENS} mixed, "
            f"{NEW_TOKENS} new tokens, fp8 pages of {ip.page_size}")
        t0 = time.perf_counter()
        model = LlamaModel(cfg, device="cuda", seed=0)
        shrink_embedding(model)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        prequantize_kernels(model, recipe, block_decode=mode)
        torch.cuda.synchronize()
        at_load = dict(_build.LAUNCHES)
        kn = [m for m in model.modules() if isinstance(m, BlockResidentKernel)]
        log(f"  init + prequantize: {time.perf_counter() - t0:.1f} s; "
            f"resident kernels {resident_gib(model):.2f} GiB, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
            f"{len(kn)} (K, N) kernels, {sum(m.packed for m in kn)} of them "
            f"packed")
        hold_launches(at_load, load, results)
        steps = layers * (NEW_TOKENS - 1)
        expect = {"decode_kn_matvec": 0, "decode_kn_matvec_packed": 0}
        if mode == "quantized":
            if len(kn) != 4 * layers:
                raise AssertionError(f"{len(kn)} (K, N) resident kernels")
            expect[kn_key] = 4 * steps
            expect["decode_tn_matvec"] = 0
        else:
            expect["decode_tn_matvec"] = 0 if in_autocast else 4 * steps
        expect.update({"flash_attention_fwd": layers,
                       "paged_decode_attention": steps,
                       "decode_attention": 0, **prefill})
        scope = autocast(recipe=recipe) if in_autocast \
            else contextlib.nullcontext()
        with scope:
            stats[mode] = drive_serving(torch, model, ip, expect, results)
        if mode == "bf16" and not in_autocast:
            # These launches ran decode_tn_matvec's bf16-weight branch.
            n = expect["decode_tn_matvec"]
            results["decode_tn_matvec"]["launches"] -= n
            add_launches(results, "decode_tn_matvec_bf16", n)
        stats[mode]["resident_gib"] = resident_gib(model)
        del model, kn
        torch.cuda.empty_cache()
    q, h = stats["quantized"], stats["bf16"]
    log(f"  decode ms/step: quantized {q['decode_ms_per_step']:.3f}, bf16 "
        f"{h['decode_ms_per_step']:.3f}; resident {q['resident_gib']:.2f} "
        f"against {h['resident_gib']:.2f} GiB")
    results[key] = stats


def serve_paged_mxfp8(torch, results) -> None:
    from transformerengine_tpu_torch import MXFP8BlockScaling
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    serve_paged_block(torch, results, "9", MXFP8BlockScaling(),
                      {"mxfp8_quantize_1x": 4 * LLAMA_8B.num_layers}, False,
                      "_serve_paged_mxfp8", "decode_kn_matvec", {})


def serve_paged_nvfp4(torch, results) -> None:
    """NVFP4's weights are quantized at load in one orientation, plain
    (no NVFP4 kernel), and every GEMM's activation under autocast: in the
    prefill (M = BATCH x the longest prompt, a multiple of 16) both
    orientations, one nvfp4_amax_2x and one nvfp4_quantize_2x a GEMM, as
    the reference; at decode (M = BATCH = 8) the rowwise usage alone,
    plain, where the reference's colwise RHT fails."""
    from transformerengine_tpu_torch import NVFP4BlockScaling
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    gemms = 4 * LLAMA_8B.num_layers
    serve_paged_block(torch, results, "12", NVFP4BlockScaling(),
                      {"nvfp4_amax_2x": 0, "nvfp4_quantize_2x": 0}, True,
                      "_serve_paged_nvfp4", "decode_kn_matvec_packed",
                      {"nvfp4_amax_2x": gemms, "nvfp4_quantize_2x": gemms})


BATCH_SLOTS, BATCH_REQUESTS, BATCH_CHECKED = 8, 16, 4


def serve_batching(torch, results) -> None:
    from transformerengine_tpu_torch import Float8CurrentScaling, _build
    from transformerengine_tpu_torch.inference import (
        ContinuousBatchingEngine, InferenceParams, generate)
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.quantize.prequant import (
        prequantize_kernels)
    cfg = LLAMA_8B
    layers = cfg.num_layers
    plen = max(PROMPT_LENS)
    g = torch.Generator(device="cpu").manual_seed(10)
    lens = torch.randint(64, plen + 1, (BATCH_REQUESTS,), generator=g)
    reqs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g).tolist()
            for n in lens]
    log(f"[10] continuous batching: LLAMA_8B width, {layers} layers, fp8 "
        f"weights (Float8CurrentScaling), fp8 cache with per-slot scales, "
        f"{BATCH_SLOTS} slots, prompt_len {plen}, {BATCH_REQUESTS} requests "
        f"of {int(lens.min())}-{int(lens.max())} tokens (seeded), "
        f"{NEW_TOKENS} new tokens each")
    model = LlamaModel(cfg, device="cuda", seed=0)
    shrink_embedding(model)
    prequantize_kernels(model, Float8CurrentScaling())
    kw = dict(max_batch_size=BATCH_SLOTS, max_sequence_length=plen
              + NEW_TOKENS, prompt_len=plen, max_new_tokens=NEW_TOKENS,
              kv_cache_dtype=torch.float8_e4m3fn)
    warm = ContinuousBatchingEngine(model, **dict(kw, max_new_tokens=2))
    warm.submit(reqs[0])
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = ContinuousBatchingEngine(model, **kw)
    rids = [eng.submit(r) for r in reqs]
    admit_s, decode_s, admitted = [], [], [0]
    admit = eng._admit

    def timed_admit():
        n0 = len(eng.emitted)
        t = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        if len(eng.emitted) > n0:
            admit_s.append(time.perf_counter() - t)
            admitted[0] += len(eng.emitted) - n0

    eng._admit = timed_admit
    _build.LAUNCHES.clear()
    results_out = {}
    t_all = time.perf_counter()
    while eng.queue or eng.active:
        t0 = time.perf_counter()
        a0 = sum(admit_s)
        results_out.update(eng.step())
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0 - (sum(admit_s) - a0))
    wall = time.perf_counter() - t_all
    counts = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()
    eng._admit = admit
    n_steps = len(decode_s)
    if sorted(results_out) != sorted(rids) or any(
            len(results_out[r]) != NEW_TOKENS or min(results_out[r]) < 0
            or max(results_out[r]) >= cfg.vocab_size for r in rids):
        raise AssertionError("the engine did not finish every request with "
                             f"{NEW_TOKENS} tokens in the vocabulary")
    n_tok = sum(len(t) for t in results_out.values())
    step_ms = sum(decode_s) / n_steps * 1e3
    log(f"  {BATCH_REQUESTS} requests in {wall:.2f} s: "
        f"{BATCH_REQUESTS / wall:.2f} requests/s, {n_tok / wall:.1f} tok/s; "
        f"admission {sum(admit_s) / admitted[0] * 1e3:.2f} ms a request "
        f"({admitted[0]} admissions in {len(admit_s)} steps), decode "
        f"{step_ms:.3f} ms/step over {n_steps} steps")
    hold_launches(counts, {"flash_attention_fwd": layers * admitted[0],
                           "decode_attention": layers * n_steps,
                           "decode_tn_matvec": 4 * layers * n_steps,
                           "paged_decode_attention": 0,
                           "decode_kn_matvec": 0}, results)
    # Requests against the card's own batch-1 generate of the same prompt.
    ip1 = InferenceParams(1, plen + NEW_TOKENS, torch.float8_e4m3fn)
    notes = []
    for rid in rids[::BATCH_REQUESTS // BATCH_CHECKED]:
        tokens = torch.zeros((1, plen), dtype=torch.int32)
        tokens[0, :len(reqs[rid])] = torch.tensor(reqs[rid])
        length = torch.tensor([len(reqs[rid])], dtype=torch.int32)
        ref = generate(model, tokens, length, NEW_TOKENS,
                       inference_params=ip1)[0].cpu()
        got = torch.tensor(results_out[rid], dtype=torch.int32)
        diff = torch.nonzero(got != ref).flatten()
        if not diff.numel():
            notes.append(f"request {rid} equal")
            continue
        t = int(diff[0])
        lg = forced_logits(torch, model, tokens, length, ip1, ref[None],
                           "cuda")[0, t]
        top2 = lg.topk(2).values
        gap = float(top2[0] - top2[1]) / float(lg.abs().max())
        notes.append(f"request {rid} leaves its batch-1 run at step {t}, "
                     f"where that run's top two logits lie {gap:.3e} of the "
                     f"largest apart")
        if gap > STEPS_RTOL:
            raise AssertionError(f"request {rid} differs from its batch-1 "
                                 f"run at step {t}, not at a near-tie")
    log(f"  against batch-1 generate: {'; '.join(notes)}")
    results["_batching"] = dict(
        requests_per_s=BATCH_REQUESTS / wall, tok_per_s=n_tok / wall,
        admission_ms=sum(admit_s) / admitted[0] * 1e3,
        decode_ms_per_step=step_ms, decode_steps=n_steps,
        admissions=admitted[0], wall_s=wall, agreement="; ".join(notes))
    del model, eng


def host_calls_per_step(model, caches, tok) -> int:
    """Python calls (cProfile's count, builtins included) of one more
    decode step: the host's work per step, which sets decode ms/step
    while the card idles, and which the shared host's speed does not
    move. Comparable across commits on one device type (the kernel
    wrappers' own calls differ between the card and the CPU)."""
    import cProfile
    import pstats
    from transformerengine_tpu_torch.inference import decode_steps
    prof = cProfile.Profile()
    prof.enable()
    decode_steps(model, caches, tok, 1, device=tok.device)
    prof.disable()
    return sum(v[1] for v in pstats.Stats(prof).stats.values())


def profile_decode(torch, model, caches, tok, stats, steps: int = 4) -> None:
    """Device time by kernel over a few more decode steps, and the
    device's busy share of the steps' wall time."""
    from transformerengine_tpu_torch.inference import decode_steps
    busy, wall, kernels = device_profile(
        torch, lambda: decode_steps(model, caches, tok, steps), 1)
    log_profile("decode", stats, busy, wall, kernels, steps)


def forced_logits(torch, model, tokens, lengths, ip, forced, dev):
    """(B, NEW, V) logits at each generated position of ``model`` when the
    earlier generated tokens are ``forced`` (B, NEW): the prompt's last
    position, then one decode step per forced token."""
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    from transformerengine_tpu_torch.inference import allocate_caches
    caches = allocate_caches(model, ip, dev)
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
# Decode steps a seed compares. The limits were read over eight; four
# keep the phase inside its share of the time limit (the CPU side widens
# every weight at every decode GEMM).
CARD_VS_CPU_NEW = 4
PAGED_VS_CPU_SEED = 4
# NVFP4-resident paged serving under autocast(NVFP4BlockScaling()): every
# activation is quantized before its GEMM with a tensor scale from its
# amax. Where card and CPU give each activation the same codes, the
# logits agree to the GEMMs' sum orders; where one activation's amax
# lands an ulp apart, its tensor scale moves every block scale and code
# that follow it, and the logits differ by a tenth of the largest (seed 5
# read 9.95e-2 at prefill and 0.136 over four steps). Seed 6 is one of
# the first kind: it read 5.2e-6 at prefill and 3.1e-5 over four steps,
# seed 7 4.9e-6 and 5.6e-6 (an H100 80GB HBM3 at 700 W; PERF.md,
# section 6). The limit, about three times the largest reading of seeds
# 6 and 7, fails any wrong code, block scale or tensor scale.
NVFP4_VS_CPU_SEED = 6
NVFP4_RTOL = 1e-4


def greedy_agreement(torch, toks, card_logits, coupled: bool = False) -> str:
    """Holds the card's greedy tokens to the CPU's: equal, except that a
    row may leave the CPU's tokens at a near-tie, where the logits'
    difference swaps the top two. Along the CPU's tokens the card's own
    picks must be the argmax of its logits up to and through that step.
    With ``coupled`` the rows share one tensor scale per activation
    (NVFP4 under autocast), so once any row leaves the CPU's tokens the
    forced logits of every row may differ from the card's own run: the
    picks are held up to and through the first step at which any row
    leaves. Returns a description of where the rows left the CPU's
    tokens."""
    picks = card_logits.argmax(dim=-1)
    top = float(card_logits.abs().max())
    notes = []
    left = torch.nonzero((toks["cpu"] != toks["card"]).any(dim=0)).flatten()
    first_any = int(left[0]) + 1 if left.numel() else toks["cpu"].shape[1]
    for row in range(toks["cpu"].shape[0]):
        cpu, card = toks["cpu"][row], toks["card"][row]
        diff = torch.nonzero(cpu != card).flatten()
        upto = int(diff[0]) + 1 if diff.numel() else cpu.numel()
        held = min(upto, first_any) if coupled else upto
        if not torch.equal(card[:held], picks[row, :held]):
            raise AssertionError(f"row {row}: the card's greedy tokens "
                                 f"{card.tolist()} are not the argmax of its "
                                 f"logits {picks[row].tolist()}")
        if diff.numel():
            t = upto - 1
            step = card_logits[row, t]
            gap = float(step[card[t]] - step[cpu[t]]) / top
            notes.append(f"row {row} leaves the CPU's tokens at step {t}, "
                         f"where the card's logit of its token less that of "
                         f"the CPU's is {gap:.3e} of the largest logit")
    return "; ".join(notes) or "greedy tokens equal"


def same_resident_bytes(torch, cpu, card) -> int:
    """Holds every buffer of the two models' resident kernels equal byte
    for byte (fp8 payloads, scales, block-scaled (K, N) payloads); returns
    the number of kernels."""
    from transformerengine_tpu_torch.quantize.prequant import (
        PrequantizedKernel)
    pk_cpu = {n: m for n, m in cpu.named_modules()
              if isinstance(m, PrequantizedKernel)}
    pk_card = {n: m for n, m in card.named_modules()
               if isinstance(m, PrequantizedKernel)}
    if pk_cpu.keys() != pk_card.keys() or not pk_cpu:
        raise AssertionError("prequantized kernels differ in name")
    for n, m in pk_cpu.items():
        bufs = dict(pk_card[n].named_buffers())
        for bname, t in m.named_buffers():
            other = bufs[bname].cpu()
            if t.dtype != other.dtype or not torch.equal(
                    t.contiguous().view(torch.uint8),
                    other.contiguous().view(torch.uint8)):
                raise AssertionError(f"{n}.{bname} differs card vs CPU")
    return len(pk_cpu)


def card_vs_cpu(torch, nvfp4_seeds=(NVFP4_VS_CPU_SEED,)) -> None:
    """Phase 5; ``nvfp4_seeds`` are the NVFP4 check's seeds."""
    from transformerengine_tpu_torch import (
        Float8CurrentScaling, MXFP8BlockScaling, NVFP4BlockScaling)
    b, s, new = 2, 64, CARD_VS_CPU_NEW
    log(f"[5] card vs CPU: 2 layers at LLAMA_8B width, same weights, B={b} "
        f"prompt {s}, {new} new tokens, fp8 weights and cache, seeds "
        f"{CARD_VS_CPU_SEEDS}; then seed {PAGED_VS_CPU_SEED} with MXFP8 "
        f"(K, N)-resident weights (block_decode='quantized') and the paged "
        f"cache (pages of 16), and seeds {nvfp4_seeds} the same with NVFP4 "
        f"(packed) under autocast")
    failures = []
    paged = dict(is_paged=True, page_size=16)
    for seed in CARD_VS_CPU_SEEDS:
        if not card_vs_cpu_seed(torch, seed, Float8CurrentScaling(), {},
                                {}, b, s, new):
            failures.append(seed)
    if not card_vs_cpu_seed(torch, PAGED_VS_CPU_SEED, MXFP8BlockScaling(),
                            dict(block_decode="quantized"), paged, b, s,
                            new):
        failures.append(PAGED_VS_CPU_SEED)
    for seed in nvfp4_seeds:
        if not card_vs_cpu_seed(torch, seed, NVFP4BlockScaling(),
                                dict(block_decode="quantized"), paged, b, s,
                                new, in_autocast=True,
                                limits=(NVFP4_RTOL, NVFP4_RTOL)):
            failures.append(seed)
    if failures:
        raise AssertionError(f"card and CPU disagree for seeds {failures}")


def card_vs_cpu_seed(torch, seed: int, recipe, prequant_kw: dict,
                     ip_kw: dict, b: int, s: int, new: int,
                     in_autocast: bool = False,
                     limits=(PREFILL_RTOL, STEPS_RTOL)) -> bool:
    """One seed of phase 5: the same two-layer model on the CPU and the
    card, prequantized on each, with equal resident bytes; the greedy
    tokens of ``generate`` and the logits along the CPU's tokens, under
    ``autocast(recipe)`` with ``in_autocast``; ``limits`` are the prefill's
    and the steps' tolerances."""
    import contextlib
    from transformerengine_tpu_torch import autocast
    from transformerengine_tpu_torch.inference import (
        InferenceParams, generate)
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.quantize.prequant import (
        prequantize_kernels)
    cfg = dataclasses.replace(LLAMA_8B, num_layers=2)
    t0 = time.perf_counter()
    cpu = LlamaModel(cfg, device="cpu", seed=seed)
    shrink_embedding(cpu)
    card = LlamaModel(cfg, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    for m in (cpu, card):
        prequantize_kernels(m, recipe, **prequant_kw)
    n_kernels = same_resident_bytes(torch, cpu, card)
    tokens, lengths = prompts(torch, b, s, cfg.vocab_size, (s, s - 14),
                              "cpu", seed=seed)
    ip = InferenceParams(b, s + new, torch.float8_e4m3fn, **ip_kw)
    prefill_rtol, steps_rtol = limits
    with autocast(recipe=recipe) if in_autocast \
            else contextlib.nullcontext():
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
    ok = math.isfinite(steps) and first <= prefill_rtol and \
        steps <= steps_rtol
    log(f"  seed {seed} ({type(recipe).__name__}"
        f"{', ' + str(prequant_kw) if prequant_kw else ''}"
        f"{', ' + str(ip_kw) if ip_kw else ''}"
        f"{', under autocast' if in_autocast else ''}): resident bytes equal "
        f"for {n_kernels} kernels; logits' largest difference over the "
        f"largest logit ({top:.3f}): last-token prefill {first:.3e} "
        f"(tolerance {prefill_rtol:.3e}), all {new} steps {steps:.3e} "
        f"(tolerance {steps_rtol:.3e}); {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    log(f"    {greedy_agreement(torch, toks, lg['card'], in_autocast)}")
    return ok


def add_launches(results, name: str, n: int) -> None:
    """Adds one path's launch count to kernel ``name``'s entry."""
    entry = results.setdefault(name, dict(name=name))
    entry["launches"] = entry.get("launches", 0) + n


def train_batch(torch, vocab: int, b: int, s: int, device, seed: int = 11):
    """A fixed (tokens, targets) batch from ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(1, vocab, (b, s), generator=g, dtype=torch.int32)
    targets = torch.randint(0, vocab, (b, s), generator=g, dtype=torch.int32)
    return tokens.to(device), targets.to(device)


def train_step(torch, model, tokens, targets, recipe, lr: float = TRAIN_LR,
               loss_fn=None):
    """One step as the reference trains: the loss (``loss_fn(model,
    tokens, targets)``, by default the cross entropy of the model's
    logits), its backward (which also rolls the delayed-scaling state in
    the modules' buffers) and ``p -= lr * g`` in the parameter dtype (none
    when ``lr`` is 0). Returns the loss."""
    from transformerengine_tpu_torch import autocast
    from transformerengine_tpu_torch.models.llama import cross_entropy_loss
    model.zero_grad(set_to_none=True)
    with autocast(enabled=recipe is not None, recipe=recipe):
        loss = loss_fn(model, tokens, targets) if loss_fn is not None \
            else cross_entropy_loss(model(tokens), targets)
    loss.backward()
    if lr:
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(lr * p.grad.to(p.dtype))
    return loss.detach()


def delayed_state(model) -> dict:
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("_scale", "_amax_history"))}


def check_delayed_state(torch, model, recipe, n_sets: int) -> None:
    """Every delayed quantizer's history holds a non-zero amax, and its
    scale is compute_scale_from_amax of that history's max."""
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    state = delayed_state(model)
    prefixes = [n[:-len("_amax_history")] for n in state
                if n.endswith("_amax_history")]
    if len(prefixes) != 3 * n_sets:
        raise AssertionError(f"{len(prefixes)} delayed quantizers, expected "
                             f"{3 * n_sets}")
    fmt = recipe.fp8_format
    for prefix in prefixes:
        hist, scale = state[prefix + "_amax_history"], state[prefix + "_scale"]
        dtype = fmt.bwd_dtype if prefix.endswith("_dgrad") else fmt.fwd_dtype
        want = compute_scale_from_amax(hist.max(), dtype, recipe.margin)
        if not float(hist.max()) > 0 or \
                not torch.equal(scale.reshape(()), want.reshape(())):
            raise AssertionError(f"{prefix}: history max {float(hist.max())}, "
                                 f"scale {float(scale)} != {float(want)}")
    log(f"  after step 1: all {len(prefixes)} delayed quantizers hold a "
        f"non-zero amax and the scale of their history ok")


def device_profile(torch, fn, steps: int):
    """(device busy us, wall us, {kernel: device us}) of ``steps`` calls
    of ``fn``, from the profiler's CUDA kernel events (the profiler's own
    host cost lowers the busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    return sum(kernels.values()), wall_us, kernels


def log_profile(label: str, stats: dict, busy_us, wall_us, kernels,
                steps: int) -> None:
    if not kernels:
        log(f"  {label} profile: the profiler saw no CUDA kernels; device "
            f"time by kernel not measured")
        return
    log(f"  {label} profile over {steps} steps: device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step of {wall_us / steps / 1e3:.3f} "
        f"ms/step wall ({100 * busy_us / wall_us:.1f}% busy)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"    {us / steps / 1e3:8.3f} ms/step  {name[:90]}")
    stats["profile"] = dict(
        busy_ms_per_step=busy_us / steps / 1e3,
        wall_ms_per_step=wall_us / steps / 1e3,
        top_ms_per_step={n[:90]: us / steps / 1e3 for n, us in top})


def train(torch, results) -> None:
    from transformerengine_tpu_torch import DelayedScaling, _build
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    cfg = dataclasses.replace(LLAMA_8B, num_layers=TRAIN_LAYERS)
    b, s = TRAIN_B, TRAIN_S
    recipe = DelayedScaling(amax_history_len=16)
    log(f"[6] FP8 training: LLAMA_8B width, {TRAIN_LAYERS} layers, B={b} "
        f"S={s}, DelayedScaling(amax_history_len=16) HYBRID, {TRAIN_STEPS} "
        f"SGD steps at lr {TRAIN_LR} on one batch")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=CARD, seed=0)
    shrink_embedding(model)
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, CARD)
    torch.cuda.synchronize()
    log(f"  init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    # Per step: one flash forward and one backward (a dQ and a dK/dV
    # launch) per layer, and no other kernel of the port: under tensor
    # scaling the layers quantize one orientation with plain ops.
    expect = {"flash_attention_fwd": TRAIN_LAYERS,
              "flash_attention_bwd_dq": TRAIN_LAYERS,
              "flash_attention_bwd_dkv": TRAIN_LAYERS}
    totals = collections.Counter()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        loss = float(train_step(torch, model, tokens, targets, recipe))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        totals.update(counts)
        losses.append(loss)
        if counts != expect:
            raise AssertionError(f"step {step + 1} launched {counts}, "
                                 f"expected {expect}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {step + 1}: loss {loss}")
        if step == 0:
            check_delayed_state(torch, model, recipe, 4 * TRAIN_LAYERS)
    step_ms = statistics.median(times[1:]) * 1e3
    log(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
        f"per step {expect} in every step ok")
    log(f"  step times {[round(t * 1e3, 2) for t in times]} ms; median of "
        f"steps 2-{TRAIN_STEPS} {step_ms:.2f} ms/step, "
        f"{b * s / (step_ms / 1e3):.0f} tok/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    stats = dict(ms_per_step=step_ms, tok_per_s=b * s / (step_ms / 1e3),
                 losses=losses, layers=TRAIN_LAYERS)
    busy, wall, kernels = device_profile(
        torch, lambda: train_step(torch, model, tokens, targets, recipe), 1)
    log_profile("fp8 step", stats, busy, wall, kernels, 1)
    bf16_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(torch, model, tokens, targets, None)
        torch.cuda.synchronize()
        bf16_times.append(time.perf_counter() - t0)
    bf16_ms = statistics.median(bf16_times[1:]) * 1e3
    log(f"  without a recipe (bf16): step times "
        f"{[round(t * 1e3, 2) for t in bf16_times]} ms, median of the last "
        f"two {bf16_ms:.2f} ms/step, {b * s / (bf16_ms / 1e3):.0f} tok/s")
    stats["bf16_ms_per_step"] = bf16_ms
    add_launches(results, "flash_attention_fwd", totals["flash_attention_fwd"])
    add_launches(results, "flash_attention_bwd",
                 totals["flash_attention_bwd_dq"]
                 + totals["flash_attention_bwd_dkv"])
    quantizer_api_path(torch, model, tokens, recipe, results)
    results["_train"] = stats
    del model


def mxfp8_counts(layers: int, train: bool) -> dict:
    """The launches of one MXFP8 training step or forward without a
    gradient. Per layer and step: the fused norm + 2x quantize of the
    attention's and the MLP's input; the 2x quantize of the QKV kernel,
    the attention output and its kernel, the MLP's up kernel, its
    activation and its down kernel in the forward, and of each GEMM's
    gradient (four) in the backward; a flash forward and backward.
    Without a gradient: the QKV GEMM's input after its unfused norm and
    the attention output rowwise, the four kernels colwise and the MLP's
    activation rowwise (seven 1x quantizes), the MLP's fused norm
    rowwise-only, and a flash forward."""
    if train:
        return {"mxfp8_norm_quantize_2x": 2 * layers,
                "mxfp8_quantize_2x": 10 * layers,
                "flash_attention_fwd": layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    return {"mxfp8_norm_quantize_2x": layers, "mxfp8_quantize_1x": 7 * layers,
            "flash_attention_fwd": layers}


def nvfp4_counts(layers: int, train: bool) -> dict:
    """The launches of one NVFP4 training step or forward without a
    gradient. Per layer and step: x and the kernel of each of the four
    GEMMs in the forward, and each GEMM's gradient in the backward, each
    quantized in both orientations through one nvfp4_amax_2x and one
    nvfp4_quantize_2x launch (twelve of each; NVFP4 has no fused norm);
    a flash forward and backward. Without a gradient x is quantized
    rowwise and the kernels colwise in plain PyTorch (the reference has
    no one-orientation NVFP4 kernel): no NVFP4 launch, a flash forward."""
    if train:
        return {"nvfp4_amax_2x": 12 * layers,
                "nvfp4_quantize_2x": 12 * layers,
                "flash_attention_fwd": layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    return {"flash_attention_fwd": layers}


def timed_steps(torch, fn, expect: dict, n: int, what: str):
    """``n`` synchronized calls of ``fn``, each with exactly the launches
    ``expect``: (their outputs as floats, seconds each, summed counts)."""
    from transformerengine_tpu_torch import _build
    totals = collections.Counter()
    outs, times = [], []
    for i in range(n):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        totals.update(counts)
        if counts != expect:
            raise AssertionError(f"{what} {i + 1} launched {counts}, "
                                 f"expected {expect}")
        outs.append(out)
    return outs, times, totals


def train_block(torch, results, phase: str, recipe, about: str, counts,
                key: str, beside) -> None:
    """A block-scaled recipe's training phase at LLAMA_8B width: five SGD
    steps with finite losses and exact launch counts (``counts``), ms/step,
    tok/s, peak memory and the profiled busy share, beside the earlier
    steps named in ``beside`` ({results key: label}); then three forwards
    without a gradient with their own exact counts."""
    from transformerengine_tpu_torch import autocast
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    cfg = dataclasses.replace(LLAMA_8B, num_layers=TRAIN_LAYERS)
    b, s = TRAIN_B, TRAIN_S
    name = type(recipe).__name__
    log(f"[{phase}] {about} training: LLAMA_8B width, {TRAIN_LAYERS} layers, "
        f"B={b} S={s}, {name}(), {TRAIN_STEPS} SGD steps at lr {TRAIN_LR} "
        f"on one batch, then the forward without a gradient")
    torch.cuda.reset_peak_memory_stats()
    model = LlamaModel(cfg, device=CARD, seed=0)
    shrink_embedding(model)
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, CARD)
    expect = counts(TRAIN_LAYERS, True)
    losses, times, totals = timed_steps(
        torch, lambda: float(train_step(torch, model, tokens, targets,
                                        recipe)), expect, TRAIN_STEPS, "step")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
        f"per step {expect} in every step ok")
    log(f"  step times {[round(t * 1e3, 2) for t in times]} ms; median of "
        f"steps 2-{TRAIN_STEPS} {step_ms:.2f} ms/step, "
        f"{b * s / (step_ms / 1e3):.0f} tok/s, peak {peak:.2f} GiB")
    stats = dict(ms_per_step=step_ms, tok_per_s=b * s / (step_ms / 1e3),
                 losses=losses, layers=TRAIN_LAYERS, peak_gib=peak)
    for other, label in beside.items():
        other_ms = results.get(other, {}).get("ms_per_step")
        if other_ms:
            log(f"  beside the {label} step: {other_ms:.2f} ms/step "
                f"({step_ms / other_ms:.3f}x)")
    busy, wall, kernels = device_profile(
        torch, lambda: train_step(torch, model, tokens, targets, recipe), 1)
    log_profile(f"{about} step", stats, busy, wall, kernels, 1)

    expect_fwd = counts(TRAIN_LAYERS, False)
    with torch.no_grad(), autocast(recipe=recipe):
        outs, fwd_times, fwd_counts = timed_steps(
            torch, lambda: model(tokens), expect_fwd, 3,
            "forward without a gradient")
    totals.update(fwd_counts)
    logits = outs[-1]
    if logits.shape != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("the forward's logits are not finite")
    fwd_ms = statistics.median(fwd_times) * 1e3
    log(f"  forward without a gradient: launches {expect_fwd} in each of 3 "
        f"runs ok, logits finite, {[round(t * 1e3, 2) for t in fwd_times]} "
        f"ms (median {fwd_ms:.2f})")
    stats["forward_ms"] = fwd_ms
    for kernel, n in totals.items():
        add_launches(results, "flash_attention_bwd" if kernel.startswith(
            "flash_attention_bwd") else kernel, n)
    results[key] = stats
    del model, logits, outs


def train_mxfp8(torch, results) -> None:
    from transformerengine_tpu_torch import MXFP8BlockScaling
    train_block(torch, results, "8", MXFP8BlockScaling(),
                "MXFP8 (E4M3, E8M0 scales per 32)", mxfp8_counts,
                "_train_mxfp8", {"_train": "phase 6 DelayedScaling"})


def train_nvfp4(torch, results) -> None:
    from transformerengine_tpu_torch import NVFP4BlockScaling
    train_block(torch, results, "11", NVFP4BlockScaling(),
                "NVFP4 (E2M1, E4M3 scales per 16 under an f32 tensor scale, "
                "the RHT on the input's and gradient's colwise usages)",
                nvfp4_counts, "_train_nvfp4",
                {"_train": "phase 6 DelayedScaling",
                 "_train_mxfp8": "phase 8 MXFP8"})


def quantizer_api_path(torch, model, tokens, recipe, results) -> None:
    """The quantizer API on the training step's own activations, counted
    as a path of its own: per layer, the attention block's input through
    its delayed x quantizer's ``quantize_normed`` (norm_cast_transpose),
    and the MLP's normed input through its x quantizer's 2x ``quantize``
    (cast_transpose). Each is held to the one-orientation payload the
    layer quantizes in its forward."""
    from transformerengine_tpu_torch import _build, autocast
    from transformerengine_tpu_torch.ops.normalization import rmsnorm_fwd
    from transformerengine_tpu_torch.quantize.quantizer import QuantizeLayout
    from transformerengine_tpu_torch.quantize.tensor import (
        get_colwise, get_rowwise)
    layers = len(model.layers)
    log(f"[6b] quantizer API on the step's activations: {layers} layers, "
        f"quantize_normed of each attention input, 2x quantize of each MLP "
        f"input, with the layers' own delayed state")
    inputs = {}
    hooks = []
    for i, layer in enumerate(model.layers):
        for name, mod in (("attn", layer.self_attention), ("mlp", layer.mlp)):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, key=(i, name): inputs.__setitem__(
                    key, args[0].detach())))
    with torch.no_grad(), autocast(recipe=recipe):
        model(tokens)
    for h in hooks:
        h.remove()
    outs = []
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with torch.no_grad(), autocast(recipe=recipe):
        for i, layer in enumerate(model.layers):
            qkv, mlp = layer.self_attention.qkv, layer.mlp
            x = inputs[i, "attn"].reshape(-1, qkv.scale.shape[0])
            fused = qkv.quantizer_set("ln_dense").x.quantize_normed(
                x, qkv.scale, None, norm="rmsnorm", zero_centered_gamma=False,
                epsilon=qkv.epsilon)
            y = inputs[i, "mlp"].reshape(-1, mlp.scale.shape[0])
            normed, _ = rmsnorm_fwd(y, mlp.scale, epsilon=mlp.epsilon)
            both = mlp.quantizer_set("mlp1").x.quantize(normed)
            outs.append((x, fused, normed, both))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()
    expect = {"norm_cast_transpose": layers, "cast_transpose": layers}
    log(f"  launches {counts} (expected {expect}) "
        f"{'ok' if counts == expect else 'FAIL'}")
    if counts != expect:
        raise AssertionError(f"quantizer API path launched {counts}")
    with torch.no_grad(), autocast(recipe=recipe):
        for i, (layer, (x, fused, normed, both)) in enumerate(
                zip(model.layers, outs)):
            qkv, mlp = layer.self_attention.qkv, layer.mlp
            # What the layers quantize in their forward: the norm, then
            # one orientation through qmath.
            ln, rs = rmsnorm_fwd(x, qkv.scale, epsilon=qkv.epsilon)
            one = qkv.quantizer_set("ln_dense").x.quantize(
                ln, layout=QuantizeLayout.ROWWISE)
            two, _, rsigma = fused
            n, dist, _ = payload_diff(torch, get_rowwise(two).data, one.data)
            nc, distc, _ = payload_diff(torch, get_colwise(two).data,
                                        one.data.t().contiguous())
            limit = NORM_DIFF_SHARE * one.data.numel()
            rs_err = float(((rsigma - rs).abs() / rs).max())
            one_mlp = mlp.quantizer_set("mlp1").x.quantize(
                normed, layout=QuantizeLayout.ROWWISE)
            same_mlp = torch.equal(
                get_rowwise(both).data.view(torch.uint8),
                one_mlp.data.view(torch.uint8)) and torch.equal(
                get_colwise(both).data.view(torch.uint8),
                one_mlp.data.t().contiguous().view(torch.uint8))
            ok = n <= limit and nc <= limit and max(dist, distc) <= 1 and \
                rs_err <= RSIGMA_RTOL and same_mlp
            log(f"  layer {i}: quantize_normed row/col bytes differ from the "
                f"layer's at {n}/{nc} of {one.data.numel()} (limit "
                f"{limit:.0f}, one step), rsigma {rs_err:.1e}; MLP 2x payloads "
                f"{'equal' if same_mlp else 'DIFFER'} to the 1x and its "
                f"transpose {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"layer {i}: the quantizer API's "
                                     f"payloads disagree with the layer's")
    for name, n in counts.items():
        add_launches(results, name, n)


# Training, card against CPU: one step from the same weights (and, under
# DelayedScaling, the same delayed state), without SGD. Per recipe, the
# limits of the loss's absolute difference, of each gradient's difference
# in norm over its norm (``gnorm``), of each gradient's largest
# difference over its largest |CPU| (``grad``) and of each updated
# scale's relative difference. Readings of seeds 21-23 on an H100
# (PERF.md, section 6): bf16 gnorm 1.16e-2 to 1.18e-2, and 0.269 to 0.271
# with dK planted without its ln 2; DelayedScaling gnorm 0.161 to 0.169
# (the CPU against itself with unfused attention reads the same), 0.321
# to 0.322 with the planted dK and 0.99 with e4m3 gradients. Under
# DelayedScaling a one-ulp difference upstream flips e5m2 codes (25 %
# steps), and every quantized GEMM of the backward adds flips, so the
# first layer's gradients differ by 16 % in norm: there the limit sits
# between the readings and the planted dK with little room on either
# side, and the bf16 check is the sharp one for the kernels. The loss
# limits cover the unfused attention's readings (up to 1.28e-2 under
# DelayedScaling). Under MXFP8BlockScaling (E4M3 both ways, flips of one
# e4m3 step, 6-12 %) seeds 21-23 read gnorm 0.0986 to 0.101 (the CPU
# against its own unfused attention 0.109 to 0.111), grad 0.087 to 0.122,
# loss 3.1e-4 to 4.2e-3 (unfused 1.2e-3 to 8.0e-3); the planted dK 0.288
# to 0.293, the planted colwise fault above 5e5 (an H100 80GB HBM3 at
# 700 W; PERF.md, section 6). The MXFP8 gnorm limit sits 2x above the
# readings and 1.4x below the planted dK. Under NVFP4BlockScaling the
# whole-step comparison is chaotic: e2m1 codes a step apart differ by up
# to a third of their value, so a one-ulp difference upstream moves the
# first layer's gradients by a third in norm, as far as a dK without its
# ln 2 does (seeds 21-23 read gnorm 0.334 to 0.338 and the planted dK
# 0.453 to 0.456 that way; the CPU against its own unfused attention
# 0.357 to 0.363). So NVFP4 is held op by op: the CPU's step records the
# input of every 2x quantize, and the card's step quantizes the CPU's
# input in its place (``nvfp4_inputs``), noting how far its own input was
# from it ("local": the largest difference over the largest |CPU|, over
# every quantize). Each quantize then gives both sides the same codes, the
# gradients differ by the sum orders of the unquantized ops, and a fault
# of any op shows in the next quantize's input or in the gradients. Seeds
# 21-23 read local 4.31e-3 to 9.35e-3 (the CPU against its own unfused
# attention 4.90e-3 to 6.10e-3), gnorm 1.04e-4 to 1.10e-4, grad 6.9e-4
# to 1.48e-3, loss 4.8e-6 to 9.5e-6; the planted dK local 0.286 to 0.337,
# the gradient's colwise usage without the RHT gnorm 1.386 to 1.389, the
# GEMMs without the tensor scales gnorm above 1.3e11 (an H100 80GB HBM3
# at 700 W; PERF.md, section 6). The limits sit 2.2x to 3.3x above the
# readings; the local limit 9.2x below the planted dK, the gnorm limit
# 5700x below the gradient without the RHT. The planted faults run the
# same way; each must fail the local or the gradient-norm limit.
# DelayedScaling(fp8_dpa, fp8_mha) (the flash kernels' FP8 branches) is as
# chaotic as a whole step: its fp8 O payload differs from the CPU's by an
# e4m3 step (up to 1/8 of the value) in about 4 % of its values (the f32
# O before the cast sums in another order), and seeds 21-23 read the
# residual stream 3.1e-2 to 5.4e-2 apart, gnorm 0.178 to 0.183 and grad up
# to 0.206 whole, the planted dK 0.332 that way. So it is held op by op as
# NVFP4 is (``tensor_scale_inputs``): every per-tensor quantize's input
# and every fp8 O of the forward's epilogue. Seeds 21-23 read local
# 1.79e-2 to 3.57e-2 (an fp8 O code one step apart near the top of the
# range: 16 of 448), gnorm 1.80e-4 to 1.92e-4, grad 1.40e-3 to 2.94e-3,
# loss 7.6e-6 to 2.4e-5, scale at most 1.2e-7; the planted faults local
# 0.335 to 0.353 (dK without its ln 2), 0.990 to 1.066 (sv_inv dropped),
# 0.993 (the O scale left out of the epilogue), above 7.6e7 (sdo dropped
# from dV) and 0.973 to 0.987 with gnorm 0.968 to 0.970 (e4m3 gradients)
# (an H100 80GB HBM3 at 700 W; PERF.md, section 6). The local limit is
# 2^-3, the most one e4m3 step can move the O payload (32 of 448 near the
# top), 3.5x the readings and 2.7x below the planted dK; the others sit
# 2.5x to 2.7x above their readings (scale at 2^-20, eight f32 ulps).
TRAIN_VS_CPU_SEED = 21
TRAIN_VS_CPU_LIMITS = {
    "bf16": dict(loss=3e-3, gnorm=2 ** -5, grad=2 ** -5),
    "delayed": dict(loss=2 ** -5, gnorm=0.25, grad=0.4, scale=2 ** -4),
    "mxfp8": dict(loss=2 ** -6, gnorm=0.2, grad=0.25),
    "nvfp4": dict(loss=2 ** -15, gnorm=2 ** -12, grad=2 ** -8,
                  local=2 ** -5),
    "fp8_attn": dict(loss=2 ** -14, gnorm=2 ** -11, grad=2 ** -7,
                     scale=2 ** -20, local=2 ** -3)}
# The delayed quantizers that fp8_mha makes and never reads (the output
# projection's dense x quantizer and the fp8_mha_o kernel quantizer, as
# the reference makes them): their state stays as it was.
FP8_MHA_UNUSED = ("out.dense_x_", "out.fp8_mha_o_kernel_")
# The limits a planted fault must fail (one is enough).
TRAIN_VS_CPU_CAUGHT = {"nvfp4": ("local", "gnorm"),
                       "fp8_attn": ("local", "gnorm")}


def nvfp4_inputs(torch, record=None, force=None, local=None):
    """A context in which every NVFP4 2x quantize appends its input to
    ``record`` (on the CPU), or quantizes the next input of ``force`` in
    place of its own, in the same order, appending to ``local`` the
    largest difference of its own input over the largest |forced|."""
    import contextlib
    from transformerengine_tpu_torch.quantize.quantizer import NVFP4Quantizer

    @contextlib.contextmanager
    def ctx():
        real = NVFP4Quantizer._fused_2x

        def hooked(self, x2d, seed=None):
            if record is not None:
                record.append(x2d.detach().cpu().clone())
            if force is not None:
                ref = force.pop(0)
                if ref.shape != x2d.shape:
                    raise AssertionError(f"quantize {len(local)}: input "
                                         f"{tuple(x2d.shape)}, recorded "
                                         f"{tuple(ref.shape)}")
                ref = ref.to(device=x2d.device, dtype=x2d.dtype)
                top = float(ref.float().abs().max())
                d = float((x2d.float() - ref.float()).abs().max())
                local.append(d / top if top else d)
                x2d = ref
            out = real(self, x2d, seed)
            if out is None:
                raise AssertionError("an NVFP4 quantize of the step left the "
                                     "fused 2x pass")
            return out
        NVFP4Quantizer._fused_2x = hooked
        try:
            yield
        finally:
            NVFP4Quantizer._fused_2x = real
    return ctx()


def tensor_scale_inputs(torch, record=None, force=None, local=None):
    """The FP8-attention step's counterpart of ``nvfp4_inputs``: a context
    in which every per-tensor quantize (current and delayed scaling, one
    orientation) and every fp8 O of the flash forward's epilogue appends
    its input (the O payload) to ``record`` (on the CPU), or takes the
    next of ``force`` in place of its own, in the same order, appending to
    ``local`` its own's largest difference over the largest |forced|."""
    import contextlib
    from transformerengine_tpu_torch.ops import flash_attention as fa
    from transformerengine_tpu_torch.quantize.quantizer import (
        CurrentScaleQuantizer, DelayedScaleQuantizer)

    def held(x):
        if record is not None:
            record.append(x.detach().cpu().clone())
        if force is None:
            return x
        ref = force.pop(0)
        if ref.shape != x.shape or ref.dtype != x.dtype:
            raise AssertionError(f"input {len(local)}: {tuple(x.shape)} "
                                 f"{x.dtype}, recorded {tuple(ref.shape)} "
                                 f"{ref.dtype}")
        ref = ref.to(x.device)
        top = float(ref.float().abs().max())
        d = float((x.float() - ref.float()).abs().max())
        local.append(d / top if top else d)
        return ref

    @contextlib.contextmanager
    def ctx():
        reals = {cls: cls._quantize_2d
                 for cls in (CurrentScaleQuantizer, DelayedScaleQuantizer)}
        real_fwd = fa.flash_fwd

        def fwd(*args, **kwargs):
            out = real_fwd(*args, **kwargs)
            if kwargs.get("out_scale") is None:
                return out
            return (held(out[0]),) + tuple(out[1:])
        for cls, real in reals.items():
            cls._quantize_2d = (lambda self, x2d, colwise=False, seed=None,
                                _real=real: _real(self, held(x2d), colwise,
                                                  seed))
        fa.flash_fwd = fwd
        try:
            yield
        finally:
            for cls, real in reals.items():
                cls._quantize_2d = real
            fa.flash_fwd = real_fwd
    return ctx()


# The recipes phase 7 holds op by op, each with the context that records
# the CPU's inputs and makes the card take them.
OP_BY_OP = {"nvfp4": nvfp4_inputs, "fp8_attn": tensor_scale_inputs}


def step_readings(torch, model, tokens, targets, recipe, dev,
                  loss_fn=None) -> tuple:
    """(loss, [residual stream after each layer], {name: grad}, {delayed
    state}) of one step of ``model`` without SGD, all on the CPU. A MoE
    layer returns (stream, aux loss)."""
    acts = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: acts.append(
            (out[0] if isinstance(out, tuple) else out).detach().float()
            .cpu()))
        for layer in model.layers]
    loss = train_step(torch, model, tokens.to(dev), targets.to(dev), recipe,
                      lr=0, loss_fn=loss_fn)
    for h in hooks:
        h.remove()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    state = {n: t.cpu() for n, t in delayed_state(model).items()}
    return float(loss), acts, grads, state


def _worst(values: dict, key: str, out: dict) -> None:
    out[key + "_of"] = max(values, key=values.get)
    out[key] = values[out[key + "_of"]]


def differences(got, ref, local=None) -> dict:
    """The loss's absolute difference, each layer's residual stream, and
    the worst gradient (in norm and largest element) and updated-scale
    differences, relative, of two ``step_readings``; with ``local`` (from
    ``nvfp4_inputs``) the worst quantize input's difference."""
    out = dict(loss=abs(got[0] - ref[0]),
               stream=[float((a - r).abs().max() / r.abs().max())
                       for a, r in zip(got[1], ref[1])])
    _worst({n: float((got[2][n] - g).norm() / g.norm())
            for n, g in ref[2].items()}, "gnorm", out)
    _worst({n: float((got[2][n] - g).abs().max() / g.abs().max())
            for n, g in ref[2].items()}, "grad", out)
    scales = {n: float(((got[3][n] - t).abs() / t).max())
              for n, t in ref[3].items() if n.endswith("_scale")}
    if scales:
        _worst(scales, "scale", out)
    if local:
        _worst(dict(enumerate(local)), "local", out)
    return out


def planted_faults(torch, recipe) -> dict:
    """Faults the comparison must catch, each a context for one card step:
    dK without the ln 2 of its epilogue; under DelayedScaling the
    gradients cast to e4m3 instead of e5m2; under MXFP8 every colwise
    usage taken as the transpose of the rowwise payload, each element
    with the rowwise scale of its 32-row block's first row (a quantize
    that reused the row scales); under NVFP4 the gradient's colwise usage
    without the RHT (x's stays rotated, so the rotations no longer cancel
    in the wgrad GEMM), and GEMMs that leave out the operands' tensor
    scales; under fp8_mha the FP8 kernels without V's sv_inv at the
    forward's write-out, without the O scale in the fp8 O epilogue, and
    without sdo in dV."""
    import contextlib
    from transformerengine_tpu_torch.common.recipe import (
        E4M3, DelayedScaling, MXFP8BlockScaling, NVFP4BlockScaling)
    from transformerengine_tpu_torch.ops import flash_attention as fa
    from transformerengine_tpu_torch.ops import gemm
    from transformerengine_tpu_torch.quantize.quantizer import (
        BlockScaleQuantizer, NVFP4Quantizer)
    from transformerengine_tpu_torch.quantize.tensor import ScaledTensor1x

    @contextlib.contextmanager
    def dk_without_ln2():
        real = fa.flash_bwd

        def faulty(*args, **kwargs):
            dq, dk, dv = real(*args, **kwargs)
            return dq, (dk.float() / fa.LN2).to(dk.dtype), dv
        fa.flash_bwd = faulty
        try:
            yield recipe
        finally:
            fa.flash_bwd = real

    @contextlib.contextmanager
    def colwise_from_rowwise():
        real = BlockScaleQuantizer._fused_2x

        def faulty(self, x2d, seed=None):
            (row, srow, _, _), _ = real(self, x2d, seed)
            m, n = row.shape
            scol = srow[::32].t().repeat_interleave(32, dim=0)[:n]
            return ((row, srow, None, None),
                    (row.t().contiguous(), scol.contiguous(), None, None))
        BlockScaleQuantizer._fused_2x = faulty
        try:
            yield recipe
        finally:
            BlockScaleQuantizer._fused_2x = real

    @contextlib.contextmanager
    def gradient_without_rht():
        real = NVFP4Quantizer._fused_2x

        def faulty(self, x2d, seed=None):
            if self.stochastic_rounding:         # the gradient's quantizer
                self = dataclasses.replace(self, with_rht=False)
            return real(self, x2d, seed)
        NVFP4Quantizer._fused_2x = faulty
        try:
            yield recipe
        finally:
            NVFP4Quantizer._fused_2x = real

    @contextlib.contextmanager
    def no_tensor_scales():
        real = gemm.q_dot

        def strip(t):
            return dataclasses.replace(t, tensor_scale_inv=None) \
                if isinstance(t, ScaledTensor1x) else t

        def faulty(lhs, rhs, lhs_cdim, rhs_cdim):
            return real(strip(lhs), strip(rhs), lhs_cdim, rhs_cdim)
        gemm.q_dot = faulty
        try:
            yield recipe
        finally:
            gemm.q_dot = real

    @contextlib.contextmanager
    def fp8_scale_dropped(helper: str, index: int):
        """The FP8 kernels' scale vector with entry ``index`` set to 1."""
        real = getattr(fa, helper)

        def faulty(*args, **kwargs):
            scales = real(*args, **kwargs).clone()
            scales[index] = 1.0
            return scales
        setattr(fa, helper, faulty)
        try:
            yield recipe
        finally:
            setattr(fa, helper, real)

    faults = {"dK without ln 2": dk_without_ln2}
    if getattr(recipe, "fp8_mha", False):
        faults["sv_inv dropped at write-out"] = lambda: fp8_scale_dropped(
            "fp8_fwd_scales", 1)
        faults["the O scale left out of the epilogue"] = \
            lambda: fp8_scale_dropped("fp8_fwd_scales", 2)
        faults["sdo dropped from dV"] = lambda: fp8_scale_dropped(
            "fp8_bwd_scales", 4)
    if isinstance(recipe, DelayedScaling):
        faults["e4m3 gradients"] = lambda: contextlib.nullcontext(
            dataclasses.replace(recipe, fp8_format=E4M3))
    if isinstance(recipe, MXFP8BlockScaling):
        faults["colwise from the rowwise payload"] = colwise_from_rowwise
    if isinstance(recipe, NVFP4BlockScaling):
        faults["the gradient's colwise usage without the RHT"] = \
            gradient_without_rht
        faults["GEMMs without the tensor scales"] = no_tensor_scales
    return faults


def _fmt(d: dict) -> str:
    text = (f"loss {d['loss']:.2e}, gnorm {d['gnorm']:.3e} ({d['gnorm_of']}),"
            f" grad {d['grad']:.3e} ({d['grad_of']})")
    if "scale" in d:
        text += f", scale {d['scale']:.3e} ({d['scale_of']})"
    if "local" in d:
        text += f", local {d['local']:.3e} (quantize {d['local_of']})"
    return text


def train_vs_cpu_recipes() -> tuple:
    """(name, recipe) of each step phase 7 compares."""
    from transformerengine_tpu_torch import (
        DelayedScaling, MXFP8BlockScaling, NVFP4BlockScaling)
    return (("bf16", None), ("delayed", DelayedScaling(amax_history_len=16)),
            ("mxfp8", MXFP8BlockScaling()), ("nvfp4", NVFP4BlockScaling()),
            ("fp8_attn", DelayedScaling(amax_history_len=16, fp8_dpa=True,
                                        fp8_mha=True)))


def train_card_vs_cpu(torch, seed: int = TRAIN_VS_CPU_SEED) -> list:
    """Phase 7 for one seed; returns what failed."""
    import copy
    import os
    from transformerengine_tpu_torch import DelayedScaling
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    cfg = dataclasses.replace(LLAMA_8B, num_layers=2)
    b, s = 1, 256
    log(f"[7] training, card vs CPU: 2 layers at LLAMA_8B width, B={b} S={s},"
        f" one step without a recipe, one under "
        f"DelayedScaling(amax_history_len=16), one under "
        f"MXFP8BlockScaling() (M = 256: the fused norm path), one under "
        f"NVFP4BlockScaling() (the two NVFP4 kernels) and one under "
        f"DelayedScaling(amax_history_len=16, fp8_dpa=True, fp8_mha=True) "
        f"(the flash kernels' FP8 branches), seed {seed}")
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, "cpu", seed)
    failures = []
    # Each recipe starts from a copy of one fresh CPU model: the copy is
    # what a new model of the seed would be (the delayed state registers
    # on a model's first step under a recipe), without drawing its 1e9
    # weights again (about 7 s of the CPU's generator a model).
    fresh = LlamaModel(cfg, device="cpu", seed=seed)
    shrink_embedding(fresh)
    for rname, recipe in train_vs_cpu_recipes():
        t0 = time.perf_counter()
        limits = TRAIN_VS_CPU_LIMITS[rname]
        cpu = copy.deepcopy(fresh)
        if isinstance(recipe, DelayedScaling):
            # A warm-up step on the CPU sets the delayed state from real
            # amaxes (no SGD): at the initial scale 1 the gradients would
            # fall among e5m2's subnormals.
            train_step(torch, cpu, tokens, targets, recipe, lr=0)
        start = {n: t.clone() for n, t in cpu.state_dict().items()}
        # NVFP4 and FP8 attention are held op by op: see
        # TRAIN_VS_CPU_LIMITS.
        hold = OP_BY_OP.get(rname, nvfp4_inputs)
        inputs = [] if rname in OP_BY_OP else None
        with hold(torch, record=inputs):
            ref = step_readings(torch, cpu, tokens, targets, recipe, "cpu")
        unused = FP8_MHA_UNUSED if getattr(recipe, "fp8_mha", False) else ()
        for name, t in ref[3].items():
            if name.endswith("_amax_history") and torch.equal(t, start[name]) \
                    and not any(u in name for u in unused):
                raise AssertionError(f"{name} did not roll")
        card = LlamaModel(cfg, device=CARD, seed=seed)

        def forced_step(model, dev, rec):
            model.load_state_dict(start)
            local = []
            with hold(torch, force=None if inputs is None else list(inputs),
                      local=local):
                got = step_readings(torch, model, tokens, targets, rec, dev)
            return differences(got, ref, local)

        got = forced_step(card, CARD, recipe)
        planted = {}
        for fname, fault in planted_faults(torch, recipe).items():
            with fault() as rec:
                planted[fname] = forced_step(card, CARD, rec)
        del card
        os.environ["TE_TPU_ATTN_BACKEND"] = "unfused"
        try:
            unfused = forced_step(cpu, "cpu", recipe)
        finally:
            del os.environ["TE_TPU_ATTN_BACKEND"]
        del cpu, inputs
        ok = all(got[k] <= limits[k] for k in limits)
        log(f"  {rname} ({time.perf_counter() - t0:.1f} s), limits "
            + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
        log("    residual stream after each layer, largest difference over "
            "the largest |CPU|: " + ", ".join(
                f"{e:.3e} [{u:.3e}]"
                for e, u in zip(got["stream"], unfused["stream"])))
        log(f"    card against CPU: {_fmt(got)} {'ok' if ok else 'FAIL'}")
        log(f"    CPU with unfused attention against its flash path "
            f"(one-ulp roundings elsewhere; no limit): {_fmt(unfused)}")
        if not ok:
            failures.append(f"{rname} seed {seed}")
        by = TRAIN_VS_CPU_CAUGHT.get(rname, ("gnorm",))
        for fname, d in planted.items():
            # A fault that makes a gradient NaN is caught as well.
            caught = [k for k in by if not d[k] <= limits[k]]
            log(f"    planted fault '{fname}': {_fmt(d)}: "
                + (f"caught by {', '.join(caught)}" if caught
                   else "NOT CAUGHT"))
            if not caught:
                failures.append(f"{rname} seed {seed}: '{fname}' not caught")
    return failures


# The Mixtral phases: MIXTRAL_8X7B width with the depth cut (32 layers of
# bf16 experts hold 93 GB): 4 layers train at the training phases' B and
# S, 8 serve at phase 4's batch and prompts.
MOE_TRAIN_LAYERS = 4
MOE_SERVE_LAYERS = 8


def mixtral_counts(layers: int, recipe: str) -> dict:
    """The launches of one Mixtral training step ("bf16", "mxfp8") or one
    MXFP8 forward without a gradient ("mxfp8_forward"). Per layer: a flash
    forward and, in a step, a backward. Under MXFP8, the attention's fused
    norm + 2x quantize; the 2x quantize of the QKV kernel, the attention
    output and the output kernel in the forward and of two gradients in
    the backward; the MoE's x rowwise before each grouped GEMM and its
    gradient rowwise in the backward (mxfp8_quantize_1x), and each expert
    stack through the grouped QDQ in the forward only (the backward reads
    the tn saved by the forward). Without a gradient the attention
    quantizes its two inputs rowwise and its two kernels colwise, after an
    unfused norm."""
    counts = {"flash_attention_fwd": layers}
    if recipe != "mxfp8_forward":
        counts.update(flash_attention_bwd_dq=layers,
                      flash_attention_bwd_dkv=layers)
    if recipe == "mxfp8":
        counts.update(mxfp8_norm_quantize_2x=layers,
                      mxfp8_quantize_2x=5 * layers,
                      mxfp8_quantize_1x=4 * layers,
                      mxfp8_qdq_2x_grouped=2 * layers)
    elif recipe == "mxfp8_forward":
        counts.update(mxfp8_quantize_1x=6 * layers,
                      mxfp8_qdq_2x_grouped=2 * layers)
    return counts


def train_mixtral(torch, results) -> None:
    """Phase 13: the Mixtral training step at MIXTRAL_8X7B width, 4 layers,
    without a recipe and under MXFP8BlockScaling, then three MXFP8 forwards
    without a gradient, each call with exact launch counts."""
    from transformerengine_tpu_torch import MXFP8BlockScaling, autocast
    from transformerengine_tpu_torch.models.mixtral import (
        MIXTRAL_8X7B, MixtralModel, mixtral_loss)
    layers = MOE_TRAIN_LAYERS
    cfg = dataclasses.replace(MIXTRAL_8X7B, num_layers=layers)
    b, s = TRAIN_B, TRAIN_S
    log(f"[13] Mixtral training: MIXTRAL_8X7B width (8 experts of FFN "
        f"14336, top-2), {layers} layers, B={b} S={s}, mixtral_loss, "
        f"{TRAIN_STEPS} SGD steps at lr {TRAIN_LR} on one batch without a "
        f"recipe, then {TRAIN_STEPS} under MXFP8BlockScaling(), then the "
        f"MXFP8 forward without a gradient")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MixtralModel(cfg, device=CARD, seed=0)
    shrink_embedding(model)
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, CARD)
    torch.cuda.synchronize()
    log(f"  init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    stats = dict(layers=layers)
    totals = collections.Counter()
    for name, recipe in (("bf16", None), ("mxfp8", MXFP8BlockScaling())):
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = timed_steps(
            torch, lambda: float(train_step(torch, model, tokens, targets,
                                            recipe, loss_fn=mixtral_loss)),
            mixtral_counts(layers, name), TRAIN_STEPS, f"{name} step")
        totals.update(counts)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name} losses {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {name}: losses {[round(x, 5) for x in losses]} (all finite); "
            f"launches per step {mixtral_counts(layers, name)} in every step "
            f"ok")
        log(f"  {name}: step times {[round(t * 1e3, 2) for t in times]} ms; "
            f"median of steps 2-{TRAIN_STEPS} {step_ms:.2f} ms/step, "
            f"{b * s / (step_ms / 1e3):.0f} tok/s, peak {peak:.2f} GiB")
        stats[name] = dict(ms_per_step=step_ms,
                           tok_per_s=b * s / (step_ms / 1e3), losses=losses,
                           peak_gib=peak)
    ratio = stats["mxfp8"]["ms_per_step"] / stats["bf16"]["ms_per_step"]
    log(f"  MXFP8 step / bf16 step: {ratio:.3f}")
    stats["mxfp8_over_bf16"] = ratio
    busy, wall, kernels = device_profile(
        torch, lambda: train_step(torch, model, tokens, targets,
                                  MXFP8BlockScaling(), loss_fn=mixtral_loss),
        1)
    log_profile("MXFP8 step", stats["mxfp8"], busy, wall, kernels, 1)
    with torch.no_grad(), autocast(recipe=MXFP8BlockScaling()):
        logits, fwd_times, counts = timed_steps(
            torch, lambda: model(tokens), mixtral_counts(layers,
                                                         "mxfp8_forward"),
            3, "forward without a gradient")
    totals.update(counts)
    if logits[-1].shape != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(logits[-1]).all()):
        raise AssertionError("the forward's logits are not finite")
    fwd_ms = statistics.median(fwd_times) * 1e3
    log(f"  forward without a gradient: launches "
        f"{mixtral_counts(layers, 'mxfp8_forward')} in each of 3 runs ok, "
        f"logits finite, {[round(t * 1e3, 2) for t in fwd_times]} ms "
        f"(median {fwd_ms:.2f})")
    stats["forward_ms"] = fwd_ms
    for kernel, n in totals.items():
        add_launches(results, "flash_attention_bwd" if kernel.startswith(
            "flash_attention_bwd") else kernel, n)
    results["_train_mixtral"] = stats
    del model, logits


def serve_mixtral(torch, results) -> None:
    """Phase 14: greedy bf16 serving of MixtralModel at MIXTRAL_8X7B width,
    8 layers, phase 4's batch, prompts and fp8 KV cache: TTFT, decode
    ms/step and tok/s, busy share and exact launch counts through the
    engine's prefill and decode steps; then the cached tokens of two
    sequences against the card's own full-recompute greedy decoding
    (:func:`cached_vs_recompute`)."""
    from transformerengine_tpu_torch.inference import InferenceParams
    from transformerengine_tpu_torch.models.mixtral import (
        MIXTRAL_8X7B, MixtralModel)
    layers = MOE_SERVE_LAYERS
    cfg = dataclasses.replace(MIXTRAL_8X7B, num_layers=layers)
    log(f"[14] Mixtral bf16 serve: MIXTRAL_8X7B width, {layers} layers, "
        f"B={BATCH}, prompts {PROMPT_LENS} mixed, {NEW_TOKENS} new tokens, "
        f"fp8 cache; the MoE in plain PyTorch")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MixtralModel(cfg, device="cuda", seed=0)
    shrink_embedding(model)
    torch.cuda.synchronize()
    log(f"  init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    ip = InferenceParams(BATCH, max(PROMPT_LENS) + NEW_TOKENS,
                         torch.float8_e4m3fn)
    # bf16 weights: the decode GEMMs are cuBLAS products, not the resident
    # matvec, and no recipe runs the grouped QDQ.
    expect = {"flash_attention_fwd": layers,
              "decode_attention": layers * (NEW_TOKENS - 1),
              "decode_tn_matvec": 0, "mxfp8_qdq_2x_grouped": 0}
    stats = drive_serving(torch, model, ip, expect, results)
    stats["agreement"] = cached_vs_recompute(torch, model)
    results["_serve_mixtral"] = stats
    del model


MOE_RECOMPUTE_ROWS = (0, 1)
# The cached step and the recompute round their bf16 activations at other
# places (other GEMM shapes, decode attention against flash), so a
# token's router logits differ between them by up to 5.9e-2 at 8 layers
# before any choice differs (phase 14 prints the reading; an H100 80GB
# HBM3 at 700 W, PERF.md section 6). A token whose 2nd and 3rd expert lie
# within twice that layer's difference may swap them, and its logits then
# move by far more than a logit near-tie allows. Such a swap is excused
# where the layer's difference stays within this limit, about twice the
# largest reading: a fault of the cached path moves the router logits by
# more.
MOE_ROUTE_DIFF = 2 ** -3


def router_logits(torch, out: list):
    """A context appending each MoE layer's router logits (f32 copies)."""
    import contextlib
    from transformerengine_tpu_torch import moe as moe_mod

    @contextlib.contextmanager
    def ctx():
        real = moe_mod.compute_routing

        def routing(logits, topk, **kwargs):
            out.append(logits.detach().float().clone())
            return real(logits, topk, **kwargs)
        moe_mod.compute_routing = routing
        try:
            yield
        finally:
            moe_mod.compute_routing = real
    return ctx()


def route_swap(own, cached, topk: int = 2) -> str:
    """Where a token's top-``topk`` experts first differ between the
    recompute's router logits ``own`` and the cached step's ``cached``
    (one (E,) vector a layer): "a swap ..." when the recompute's k-th and
    (k+1)-th logits there lie within twice the layer's largest difference
    and that difference within MOE_ROUTE_DIFF (a near-tie), else why
    not."""
    for layer, (a, c) in enumerate(zip(own, cached)):
        top_a = set(a.topk(topk).indices.tolist())
        if top_a == set(c.topk(topk).indices.tolist()):
            continue
        v = a.sort(descending=True).values
        gap = float(v[topk - 1] - v[topk])
        diff = float((a - c).abs().max())
        kind = "a swap" if gap <= 2 * diff and diff <= MOE_ROUTE_DIFF \
            else "not a near-tie: a change"
        return (f"{kind} of experts at layer {layer}, router gap "
                f"{gap:.3e}, router logits {diff:.3e} apart")
    return "the same experts in every layer"


def cached_vs_recompute(torch, model) -> str:
    """The reference test's check (``tests/test_mixtral.py``): greedy
    tokens through the cache (the engine's prefill and one-step decodes
    at B = BATCH over phase 4's prompts, with the reference's default bf16
    cache) against greedy decoding that recomputes the whole sequence at
    every step, for two sequences, with each step's router logits beside
    the cached step's. A sequence may leave the recompute's tokens only at
    a near-tie: the recompute's top two logits within STEPS_RTOL of the
    largest, or a swap of experts at a router near-tie
    (:func:`route_swap`); the rest of it is not compared."""
    from transformerengine_tpu_torch.inference import (
        InferenceParams, decode_steps, prefill)
    vocab = model.config.vocab_size
    tokens, lengths = prompts(torch, BATCH, max(PROMPT_LENS), vocab,
                              PROMPT_LENS, "cuda")
    s = tokens.shape[1]
    ip = InferenceParams(BATCH, s + NEW_TOKENS)
    routes = []
    with router_logits(torch, routes):
        first, caches = prefill(model, tokens, ip, lengths)
        cached, step_routes = [first], [routes[:]]
        for _ in range(NEW_TOKENS - 1):
            routes.clear()
            cached.append(decode_steps(model, caches, cached[-1], 1)[:, 0])
            step_routes.append(routes[:])
    cached = torch.stack(cached, dim=1).cpu()
    notes, largest = [], 0.0
    with torch.no_grad():
        for row in MOE_RECOMPUTE_ROWS:
            n = int(lengths[row])
            seq = tokens[row, :n]
            for t in range(NEW_TOKENS):
                routes = []
                with router_logits(torch, routes):
                    lg = model(seq[None])[0, -1].float()
                at = row * s + n - 1 if t == 0 else row
                own = [r[-1] for r in routes]
                diff = max(float((a - c[at]).abs().max())
                           for a, c in zip(own, step_routes[t]))
                tok = int(lg.argmax())
                if tok != int(cached[row, t]):
                    top2 = lg.topk(2).values
                    gap = float(top2[0] - top2[1]) / float(lg.abs().max())
                    why = route_swap(own, [c[at] for c in step_routes[t]],
                                     model.config.topk)
                    notes.append(f"row {row} leaves the recompute at step "
                                 f"{t}, where its top two logits lie "
                                 f"{gap:.3e} of the largest apart; {why}")
                    if gap > STEPS_RTOL and not why.startswith("a swap"):
                        raise AssertionError(
                            f"row {row}: cached token {int(cached[row, t])} "
                            f"!= recomputed {tok} at step {t}, not at a "
                            f"near-tie ({why})")
                    break
                largest = max(largest, diff)
                seq = torch.cat([seq, torch.tensor([tok], device=seq.device,
                                                   dtype=seq.dtype)])
            else:
                notes.append(f"row {row} equal over {NEW_TOKENS} tokens")
    note = (f"{'; '.join(notes)}; router logits of equal steps at most "
            f"{largest:.3e} apart")
    log(f"  cached (bf16 cache) against full-recompute greedy: {note}")
    return note


# Phase 15: one Mixtral training step, card against CPU, at a reduced
# width (hidden 1024, per-expert FFN 3584, 8 experts, top-2, 8 query and
# 2 KV heads of 128, the vocabulary of 32000), 2 layers, B = 1, S = 256:
# the CPU's step at MIXTRAL_8X7B width would take minutes.
MOE_VS_CPU_SEED = 31
MOE_VS_CPU_CONFIG = dict(hidden_size=1024, intermediate_size=3584,
                         num_attention_heads=8, num_kv_heads=2, head_dim=128,
                         num_layers=2)
# Routing is discontinuous, so phase 15 holds the MoE op by op: the CPU's
# step records each MoE layer's input and routing, and the card's step
# feeds each MoE layer the CPU's input in place of its own ("local": the
# largest difference of its own over the largest |CPU|, the attention and
# residual path's share) and routes by the CPU's map. The card's own map
# from the same input may differ only where the CPU's 2nd and 3rd router
# logits lie within MOE_NEAR_TIE of each other (the f32 router GEMM sums
# in another order). Seeds 31-33 read (an H100 80GB HBM3 at 700 W;
# PERF.md, section 6): without a recipe loss 1.6e-5 to 9.6e-5, gnorm
# 8.3e-3 to 8.7e-3, grad 8.6e-3 to 1.05e-2, local 6.0e-3 to 6.5e-3; under
# MXFP8 (e4m3 codes a step apart after one-ulp differences upstream, as
# in phase 7) loss 2.4e-4 to 6.5e-4, gnorm 6.7e-2 to 6.9e-2, grad 6.8e-2
# to 7.5e-2, local 6.1e-3 to 7.9e-3; no routing choice differed. The
# combine without the second expert read gnorm 0.80 to 0.91 and local
# 0.27 to 0.35, the up projection's dgrad from nn gnorm 1.33 to 1.40. The
# limits sit 1.7x to 3x above the readings, the gnorm limits 6x and more
# below the faults, the local limit 17x.
MOE_NEAR_TIE = 1e-4
MOE_VS_CPU_LIMITS = {
    "bf16": dict(loss=2 ** -12, gnorm=2 ** -6, grad=2 ** -5, local=2 ** -6),
    "mxfp8": dict(loss=2 ** -9, gnorm=2 ** -3, grad=2 ** -3, local=2 ** -6)}


def moe_ops(torch, record=None, force=None, local=None, excused=None):
    """A context in which each MoE layer's input and router logits and map
    are appended to ``record`` (on the CPU), or in which each MoE layer
    takes the next input of ``force`` in place of its own (appending to
    ``local`` how far its own was) and routes by the recorded map
    (appending to ``excused`` how many of its own choices differed at a
    near-tie; a difference elsewhere raises)."""
    import contextlib
    from transformerengine_tpu_torch import moe as moe_mod
    from transformerengine_tpu_torch.nn.moe import MoELayerNormMLP
    from transformerengine_tpu_torch.ops.router import fused_moe_aux_loss

    def pre_hook(module, args):
        x = args[0]
        if record is not None:
            record.append(x.detach().cpu().clone())
        if force is None:
            return None
        ref = force.pop(0).to(device=x.device, dtype=x.dtype)
        top = float(ref.float().abs().max())
        local.append(float((x.detach().float() - ref.float()).abs().max())
                     / top)
        # ref's values exactly (x - x is an exact zero), x's gradient path:
        # x + (ref - x) would round where x lies far from ref.
        return (ref + (x - x.detach()),)

    @contextlib.contextmanager
    def ctx():
        real = moe_mod.compute_routing

        def routing(logits, topk, **kwargs):
            probs, rmap, aux = real(logits, topk, **kwargs)
            if record is not None:
                record.append((logits.detach().cpu().clone(), rmap.cpu()))
            if force is None:
                return probs, rmap, aux
            ref_logits, ref_map = force.pop(0)
            s = ref_logits.sort(dim=-1, descending=True).values
            tie = (s[:, topk - 1] - s[:, topk]) < MOE_NEAR_TIE
            differ = (rmap.cpu() != ref_map).any(dim=-1)
            if (differ & ~tie).any():
                raise AssertionError(
                    f"{int((differ & ~tie).sum())} tokens route otherwise "
                    f"on the card than on the CPU, not at a near-tie")
            excused.append(int(differ.sum()))
            ref_map = ref_map.to(logits.device)
            lf = logits.float()
            probs = torch.where(ref_map, torch.softmax(torch.where(
                ref_map, lf, float("-inf")), dim=-1), 0.0)
            aux = fused_moe_aux_loss(torch.softmax(lf, dim=-1), ref_map,
                                     topk=topk,
                                     coeff=kwargs.get("aux_loss_coeff", 1e-2))
            return probs, ref_map, aux

        moe_mod.compute_routing = routing
        handle = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: pre_hook(mod, args)
            if isinstance(mod, MoELayerNormMLP) else None)
        try:
            yield
        finally:
            moe_mod.compute_routing = real
            handle.remove()
    return ctx()


def moe_planted_faults(torch, recipe) -> dict:
    """Faults phase 15 must catch, each a context for one card step: a
    combine that drops each token's second expert; under MXFP8 the up
    projection's dgrad read from nn (reinterpreted as tn's shape) in place
    of tn."""
    import contextlib
    from transformerengine_tpu_torch import grouped_dense as gd
    from transformerengine_tpu_torch import moe as moe_mod
    from transformerengine_tpu_torch.quantize.microbatch import (
        GroupedQDQKernel)

    @contextlib.contextmanager
    def patched(module, name, make):
        real = getattr(module, name)
        setattr(module, name, make(real))
        try:
            yield
        finally:
            setattr(module, name, real)

    def drop_second(real):
        def combine(expert_out, probs, aux):
            second = probs.topk(2, dim=-1).indices[:, 1:]
            return real(expert_out, probs.scatter(1, second, 0.0), aux)
        return combine

    def wi_from_nn(real):
        hidden = MOE_VS_CPU_CONFIG["hidden_size"]

        def qdq(quantizer, kernel):
            out = real(quantizer, kernel)
            if kernel.shape[1] != hidden:
                return out
            return GroupedQDQKernel(nn=out.nn,
                                    tn=out.nn.reshape(out.tn.shape))
        return qdq

    faults = {"combine without the second expert":
              lambda: patched(moe_mod, "token_combine", drop_second)}
    if recipe is not None:
        faults["the up projection's dgrad from nn in place of tn"] = \
            lambda: patched(gd, "_qdq_kernel", wi_from_nn)
    return faults


def mixtral_card_vs_cpu(torch, seed: int = MOE_VS_CPU_SEED) -> list:
    """Phase 15; returns what failed."""
    from transformerengine_tpu_torch import MXFP8BlockScaling
    from transformerengine_tpu_torch.models.mixtral import (
        MIXTRAL_8X7B, MixtralModel, mixtral_loss)
    cfg = dataclasses.replace(MIXTRAL_8X7B, **MOE_VS_CPU_CONFIG)
    b, s = 1, 256
    log(f"[15] Mixtral training, card vs CPU: 2 layers, hidden "
        f"{cfg.hidden_size}, 8 experts of FFN {cfg.intermediate_size}, "
        f"top-2, {cfg.num_attention_heads}/{cfg.num_kv_heads} heads of 128, "
        f"vocabulary {cfg.vocab_size}, B={b} S={s}, one step without a "
        f"recipe and one under MXFP8BlockScaling(), the MoE held op by op, "
        f"seed {seed}")
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, "cpu", seed)
    failures = []
    for rname, recipe in (("bf16", None), ("mxfp8", MXFP8BlockScaling())):
        t0 = time.perf_counter()
        limits = MOE_VS_CPU_LIMITS[rname]
        cpu = MixtralModel(cfg, device="cpu", seed=seed)
        shrink_embedding(cpu)
        start = {n: t.clone() for n, t in cpu.state_dict().items()}
        recorded = []
        with moe_ops(torch, record=recorded):
            ref = step_readings(torch, cpu, tokens, targets, recipe, "cpu",
                                loss_fn=mixtral_loss)
        del cpu
        card = MixtralModel(cfg, device=CARD, seed=seed)

        def forced_step(rec_fault=None):
            card.load_state_dict(start)
            local, excused = [], []
            with moe_ops(torch, force=list(recorded), local=local,
                         excused=excused):
                got = step_readings(torch, card, tokens, targets, recipe,
                                    CARD, loss_fn=mixtral_loss)
            out = differences(got, ref, local)
            out["excused"] = sum(excused)
            return out

        got = forced_step()
        planted = {}
        for fname, fault in moe_planted_faults(torch, recipe).items():
            with fault():
                planted[fname] = forced_step()
        del card
        ok = all(got[k] <= limits[k] for k in limits)
        log(f"  {rname} ({time.perf_counter() - t0:.1f} s), limits "
            + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
        log("    residual stream after each layer, largest difference over "
            "the largest |CPU|: " + ", ".join(f"{e:.3e}"
                                             for e in got["stream"]))
        log(f"    card against CPU: {_fmt(got)}; {got['excused']} routing "
            f"choices differed at a near-tie {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mixtral {rname} seed {seed}")
        for fname, d in planted.items():
            caught = [k for k in ("loss", "gnorm", "local")
                      if not d[k] <= limits[k]]
            log(f"    planted fault '{fname}': {_fmt(d)}: "
                + (f"caught by {', '.join(caught)}" if caught
                   else "NOT CAUGHT"))
            if not caught:
                failures.append(f"mixtral {rname} seed {seed}: '{fname}' "
                                f"not caught")
    return failures


# ---------------------------------------------------------------------------
# GPT-OSS: flash attention's window and sink (phase 3), the training step
# (16), serving (17) and the step card against CPU (18)
# ---------------------------------------------------------------------------

GPTOSS_HEADS = (64, 8, 64)       # Hq, Hkv, D at GPTOSS_20B width
GPTOSS_BAND = 128


def band_rows(n: int, left: int) -> int:
    """Visible (query, key) pairs of one causal sequence of ``n`` tokens
    under a band of ``left`` earlier keys: query i sees min(i, left) + 1."""
    full = min(n, left + 1)
    return full * (full + 1) // 2 + (n - full) * (left + 1)


def band_mask(torch, s: int, left: int, lens=None):
    """Boolean (B or 1, 1, S, S) mask, True where a query sees a key:
    causal, within ``left`` earlier keys and, with ``lens``, both inside
    the sequence; the one PyTorch call that computes the band (SDPA with
    an explicit mask) takes it."""
    pos = torch.arange(s, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                             <= left)
    mask = mask[None]
    if lens is not None:
        mask = (mask & (pos[None, :, None] < lens[:, None, None])
                & (pos[None, None, :] < lens[:, None, None]))
    return mask[:, None]


def check_flash_sw(torch, timer, results):
    """[3r] the banded forward with a learnable sink at phase 17's prefill
    shape, against its plain version; timed with its plain version, SDPA
    with the band and padding as a boolean mask (the window alone: no
    PyTorch call takes the sink) and its bound."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain)
    b, s = BATCH, max(PROMPT_LENS)
    hq, hkv, d = GPTOSS_HEADS
    window = (GPTOSS_BAND, 0)
    log(f"[3r] flash_attention fwd, window and sink: prefill B={b} S={s} "
        f"Hq={hq} Hkv={hkv} D={d} bf16, padding-causal, lengths "
        f"{PROMPT_LENS} mixed, band {window}, a learnable sink")
    g = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(
        torch.bfloat16)
    sink = torch.randn((hq,), generator=g, device="cuda") * 2
    lens = mixed_lengths(torch, b, PROMPT_LENS)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=True, window=window, softmax_sink=sink)
    o, lse = flash_fwd(q, k, v, lens, lens, **kw)
    torch.cuda.synchronize()
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    pkw = dict(causal=True, window=window, softmax_sink=sink)
    o_ref, lse_ref = flash_fwd_plain(qs, k, v, lens, lens, **pkw)
    err = check("O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
    check("LSE", lse, lse_ref, LSE_ATOL)
    pad = lens < s
    if float(o[pad][:, int(lens.min()):].abs().max()) != 0.0:
        raise AssertionError("padded rows must write O = 0")
    ms = timer(lambda: flash_fwd(q, k, v, lens, lens, **kw))
    plain_ms = timer(lambda: flash_fwd_plain(qs, k, v, lens, lens, **pkw))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = band_mask(torch, s, GPTOSS_BAND, lens)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
    pairs = sum(band_rows(int(n), GPTOSS_BAND) for n in lens.tolist()) * hq
    flops = 4 * d * pairs
    rows = int(lens.sum())
    nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) + 2 * b * s * hq * d \
        + 4 * b * hq * s + 4 * hq
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with the band "
        f"as a mask (no sink) {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {flops / 1e9:.3f} GFLOP over the band's pairs, "
        f"{nbytes / 1e6:.1f} MB)")
    results["flash_attention_fwd_sw"] = dict(
        name="flash_attention_fwd_sw", route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:2057",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"prefill B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, band "
              f"{GPTOSS_BAND}, learnable sink")


def check_flash_bwd_sw(torch, timer, results):
    """[3s] the banded backward at phase 16's training shape, from a
    forward with a sink, against its plain version; timed with its plain
    version, SDPA's backward with the band as a boolean mask and its
    bound."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd)
    b, s = TRAIN_B, TRAIN_S
    hq, hkv, d = GPTOSS_HEADS
    window = (GPTOSS_BAND, 0)
    log(f"[3s] flash_attention bwd, window (dQ and dK/dV kernels): training "
        f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, causal, band {window}")
    g = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), \
        randn(b, s, hkv, d), randn(b, s, hq, d)
    sink = torch.randn((hq,), generator=g, device="cuda")
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True, window=window,
                       softmax_sink=sink)
    kw = dict(scale=scale, causal=True, window=window)
    got = flash_bwd(q, k, v, o, lse, do, softmax_sink=sink, **kw)
    torch.cuda.synchronize()
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    ref = flash_bwd_plain(qs, k, v, do, lse, delta, **kw)
    err = 0.0
    for name, a, r in zip(("dQ", "dK", "dV"), got, ref):
        differ = int((a != r).sum())
        err = max(err, check(
            f"{name} ({differ} of {r.numel()} elements differ)", a, r,
            BWD_RTOL * float(r.float().abs().max())))
    del got, ref
    ms = timer(lambda: flash_bwd(q, k, v, o, lse, do, softmax_sink=sink,
                                 **kw))
    plain_ms = timer(lambda: flash_bwd_plain(qs, k, v, do, lse, delta, **kw),
                     reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band_mask(torch, s, GPTOSS_BAND), scale=scale,
        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = timer.events(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out
    pairs = b * hq * band_rows(s, GPTOSS_BAND)
    flops = 5 * 2 * d * pairs
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    nbytes = 2 * (3 * q_el + 2 * kv_el) + 4 * b * hq * s \
        + 2 * (q_el + 2 * kv_el)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"  kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward with "
        f"the band as a mask {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {flops / 1e9:.1f} GFLOP over the band's pairs, "
        f"{nbytes / 1e6:.1f} MB)")
    results["flash_attention_bwd_sw"] = dict(
        name="flash_attention_bwd_sw", route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:1477",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal, "
              f"band {GPTOSS_BAND}")


def variant_mask(torch, g, mask, b: int, sq: int, skv: int):
    """A small variant's mask arguments and the (B, Sq) queries and (B,
    Skv) keys that see nothing: ``mask`` None, a tuple of lengths, or a
    :func:`small_ids` kind (the queries' ids are the last Sq keys', as
    under the bottom-right offset)."""
    if mask is None:
        return {}, None, None
    if isinstance(mask, str):
        kseg = small_ids(torch, g, b, skv, mask)
        qseg = kseg[:, skv - sq:].contiguous()
        return (dict(q_segment_ids=qseg, kv_segment_ids=kseg), qseg == 0,
                kseg == 0)
    ln = torch.tensor(mask, dtype=torch.int32, device="cuda")
    pos = torch.arange(max(sq, skv), device="cuda")
    return (dict(q_seqlens=ln, kv_seqlens=ln), pos[None, :sq] >= ln[:, None],
            pos[None, :skv] >= ln[:, None])


def check_zero_grads(name, grads, qzero, kzero) -> None:
    """A query that sees no key gets dQ = 0; a key no query sees, dK =
    dV = 0."""
    for gname, a, zero in zip(("dQ", "dK", "dV"), grads,
                              (qzero, kzero, kzero)):
        if zero is not None and bool(zero.any()) and \
                float(a[zero].float().abs().max()) != 0.0:
            raise AssertionError(f"{name} {gname}: a token that sees "
                                 f"nothing must get a zero gradient")


def flash_variants(torch, g, cases) -> None:
    """Each case (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, mask)
    forward (O, LSE) and backward (dQ, dK, dV from the kernel's own O and
    LSE) against its plain version; ``mask`` as :func:`variant_mask`
    takes it, its queries that see nothing writing O = 0 and LSE = -1e30
    (the sink with one) and getting zero gradients."""
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain)
    f32 = torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    for dt, sq, skv, d, hq, hkv, causal, window, sink, mask in cases:
        q, do = randn(2, sq, hq, d, dtype=dt), randn(2, sq, hq, d, dtype=dt)
        k, v = randn(2, skv, hkv, d, dtype=dt), randn(2, skv, hkv, d,
                                                      dtype=dt)
        s0 = (None if sink is None else torch.zeros(hq, device="cuda")
              if sink == "off_by_one" else randn(hq) * 2)
        mk, qzero, kzero = variant_mask(torch, g, mask, 2, sq, skv)
        offset = skv - sq if causal else 0
        scale = d ** -0.5
        kw = dict(causal=causal, offset=offset, window=window or (-1, -1),
                  **mk)
        o, lse = flash_fwd(q, k, v, scale=scale, softmax_sink=s0, **kw)
        qs = (q.float() * (scale * LOG2E)).to(dt)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, softmax_sink=s0, **kw)
        name = (f"{dt} Sq={sq} Skv={skv} D={d} G={hq // hkv} causal={causal}"
                f" window={window} sink={sink} mask={mask}")
        tol = 1e-4 if dt == f32 else row_tol(o_ref, BF16_ROW_RTOL)
        check(f"fwd {name} O", o, o_ref, tol)
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, softmax_sink=s0,
                        **kw)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale, **kw)
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            rel = 1e-4 if dt == f32 else BWD_RTOL
            check(f"bwd {name} {gname}", a, r,
                  rel * float(r.float().abs().max()))
        check_zero_grads(f"bwd {name}", got, qzero, kzero)


def check_sw_variants(torch, timer) -> None:
    """[3t] the window and sink branches at small shapes (the cases of
    :func:`flash_variants`): left only, right only, both sides, the
    off-by-one sink, a learnable sink with padded rows, the bottom-right
    offset with a band, f32, D 128 and 256 and a group of 8; then
    decode_attention at GPT-OSS's decode shape with its window and
    sink."""
    from transformerengine_tpu_torch.inference.kv_cache import (
        calibrate_kv_scale, quantize_for_cache)
    from transformerengine_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    log("[3t] flash attention's window and sink at small shapes, forward "
        "and backward")
    g = torch.Generator(device="cuda").manual_seed(23)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, lengths)
    flash_variants(torch, g, (
        (f32, 70, 70, 64, 4, 2, False, (10, -1), None, None),
        (bf16, 96, 96, 64, 4, 2, False, (-1, 7), None, None),
        (bf16, 100, 100, 128, 4, 2, False, (20, 9), "off_by_one", None),
        (f32, 70, 70, 128, 4, 2, True, (16, 0), "learnable", (70, 33)),
        (bf16, 40, 100, 256, 4, 2, True, (24, 0), "learnable", None),
        (bf16, 150, 150, 64, 16, 2, True, (32, 0), "learnable",
         (150, 77))))
    b, hq, hkv, d = BATCH, *GPTOSS_HEADS
    s_alloc = -(-(max(PROMPT_LENS) + NEW_TOKENS) // 128) * 128
    lens = mixed_lengths(torch, b, PROMPT_LENS) + NEW_TOKENS // 2
    qd = randn(b, 1, hq, d, dtype=bf16)
    kf, vf = randn(b, s_alloc, hkv, d), randn(b, s_alloc, hkv, d)
    kv_scale = calibrate_kv_scale(kf, vf, per_slot=True)
    kc = quantize_for_cache(kf, kv_scale, torch.float8_e4m3fn)
    vc = quantize_for_cache(vf, kv_scale, torch.float8_e4m3fn)
    sinks = randn(hq) * 2
    kw = dict(kv_scale=1.0 / kv_scale, window_left=GPTOSS_BAND,
              softmax_sink=sinks)
    out = decode_attention(qd, kc, vc, lens, **kw)
    ref = decode_attention_plain(qd, kc, vc, lens, scale=d ** -0.5,
                                 out_dtype=bf16, **kw)
    check(f"decode_attention B={b} Hq={hq} Hkv={hkv} D={d} fp8 cache, "
          f"window {GPTOSS_BAND}, sink", out, ref,
          row_tol(ref, BF16_ROW_RTOL))
    ms = timer(lambda: decode_attention(qd, kc, vc, lens, **kw))
    nbytes = 2 * b * (GPTOSS_BAND + 1) * hkv * d + 2 * 2 * b * hq * d
    b_ms, b_by = bound_ms(nbytes, 4 * hq * d * b * (GPTOSS_BAND + 1))
    log(f"  decode_attention at GPT-OSS's decode shape: kernel {ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, the band's keys)")


GPTOSS_TRAIN_LAYERS = 4


def gptoss_counts(layers: int, train: bool) -> dict:
    """Launches of one GPT-OSS step (``train``) or forward without a
    gradient: every layer's attention is banded or has a sink, so each
    flash launch takes the window and sink branch, and none the plain
    one."""
    counts = {"flash_attention_fwd_sw": layers}
    if train:
        counts.update(flash_attention_bwd_dq_sw=layers,
                      flash_attention_bwd_dkv_sw=layers)
    return counts


def train_gptoss(torch, results) -> None:
    """Phase 16: the GPT-OSS training step at GPTOSS_20B width, 4 layers
    (two banded, two full, a learnable sink in each), B = 2, S = 2048,
    ``gptoss_loss``: five bf16 SGD steps with finite losses, a sink
    gradient on every layer and exact launch counts, then three forwards
    without a gradient."""
    from transformerengine_tpu_torch.models.gptoss import (
        GPTOSS_20B, GptOssModel, gptoss_loss)
    layers = GPTOSS_TRAIN_LAYERS
    cfg = dataclasses.replace(GPTOSS_20B, num_layers=layers)
    b, s = TRAIN_B, TRAIN_S
    log(f"[16] GPT-OSS training: GPTOSS_20B width (hidden 2880, 64/8 heads "
        f"of 64, 32 experts of FFN 2880, top-4, vocabulary 201088), {layers} "
        f"layers (bands of {cfg.sliding_window} on the even ones, a sink in "
        f"each), B={b} S={s}, gptoss_loss, {TRAIN_STEPS} bf16 SGD steps at "
        f"lr {TRAIN_LR}, then the forward without a gradient")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GptOssModel(cfg, device=CARD, seed=0)
    shrink_embedding(model)
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, CARD)
    torch.cuda.synchronize()
    log(f"  init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    expect = gptoss_counts(layers, True)
    losses, times, totals = timed_steps(
        torch, lambda: float(train_step(torch, model, tokens, targets, None,
                                        loss_fn=gptoss_loss)),
        expect, TRAIN_STEPS, "step")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    sinks = [float(layer.self_attention.softmax_offset.grad.abs().max())
             for layer in model.layers]
    if not all(x > 0 and math.isfinite(x) for x in sinks):
        raise AssertionError(f"sink gradients {sinks}")
    step_ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = dict(layers=layers, ms_per_step=step_ms,
                 tok_per_s=b * s / (step_ms / 1e3), losses=losses,
                 peak_gib=peak, sink_grad_max=sinks)
    log(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
        f"per step {expect} in every step ok; the sink's largest gradient "
        f"per layer {[f'{x:.3e}' for x in sinks]}")
    log(f"  step times {[round(t * 1e3, 2) for t in times]} ms; median of "
        f"steps 2-{TRAIN_STEPS} {step_ms:.2f} ms/step, "
        f"{b * s / (step_ms / 1e3):.0f} tok/s, peak {peak:.2f} GiB")
    busy, wall, kernels = device_profile(
        torch, lambda: train_step(torch, model, tokens, targets, None,
                                  loss_fn=gptoss_loss), 1)
    log_profile("step", stats, busy, wall, kernels, 1)
    with torch.no_grad():
        logits, fwd_times, counts = timed_steps(
            torch, lambda: model(tokens), gptoss_counts(layers, False), 3,
            "forward without a gradient")
    totals.update(counts)
    if logits[-1].shape != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(logits[-1]).all()):
        raise AssertionError("the forward's logits are not finite")
    stats["forward_ms"] = statistics.median(fwd_times) * 1e3
    log(f"  forward without a gradient: launches "
        f"{gptoss_counts(layers, False)} in each of 3 runs ok, logits "
        f"finite, {[round(t * 1e3, 2) for t in fwd_times]} ms")
    for kernel, n in totals.items():
        add_launches(results, "flash_attention_bwd_sw" if kernel.startswith(
            "flash_attention_bwd") else kernel, n)
    results["_train_gptoss"] = stats
    del model, logits


def serve_gptoss(torch, results) -> None:
    """Phase 17: greedy bf16 serving of GptOssModel at GPTOSS_20B width and
    full depth (24 layers), phase 4's batch, prompts and fp8 cache: TTFT,
    decode ms/step, busy share, Python calls per step and exact launch
    counts (the prefill's banded-and-sink flash, the decode kernel with
    each layer's window and sink); then two sequences' cached tokens
    against the card's own full-recompute greedy decoding."""
    from transformerengine_tpu_torch.inference import InferenceParams
    from transformerengine_tpu_torch.models.gptoss import (
        GPTOSS_20B, GptOssModel)
    cfg = GPTOSS_20B
    layers = cfg.num_layers
    log(f"[17] GPT-OSS bf16 serve: GPTOSS_20B, {layers} layers, B={BATCH}, "
        f"prompts {PROMPT_LENS} mixed, {NEW_TOKENS} new tokens, fp8 cache, "
        f"bands of {cfg.sliding_window} on the even layers, sinks on all")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GptOssModel(cfg, device="cuda", seed=0)
    shrink_embedding(model)
    torch.cuda.synchronize()
    log(f"  init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    ip = InferenceParams(BATCH, max(PROMPT_LENS) + NEW_TOKENS,
                         torch.float8_e4m3fn)
    expect = {"flash_attention_fwd_sw": layers, "flash_attention_fwd": 0,
              "decode_attention": layers * (NEW_TOKENS - 1),
              "decode_tn_matvec": 0}
    stats = drive_serving(torch, model, ip, expect, results)
    stats["agreement"] = cached_vs_recompute(torch, model)
    results["_serve_gptoss"] = stats
    del model


# Phase 18: one GPT-OSS training step, card against CPU: the attention at
# GPTOSS_20B's shape (64/8 heads of 64, a band of 128 on layer 0, a sink
# in both layers), the rest reduced as phase 15 reduces Mixtral (hidden
# 1024, 8 experts of FFN 1024, top-4, the vocabulary of 32000), 2 layers,
# B = 1, S = 384 (longer than the band): the CPU's step at full width
# would take minutes. The MoE is held op by op, as in phase 15.
GPTOSS_VS_CPU_SEED = 51
GPTOSS_VS_CPU_CONFIG = dict(hidden_size=1024, intermediate_size=1024,
                            num_experts=8, vocab_size=32000, num_layers=2)
GPTOSS_VS_CPU_S = 384
# Seeds 51-53 read (an H100 80GB HBM3 at 700 W; PERF.md, section 6): loss
# 1.2e-5 to 3.01e-4, gnorm 8.8e-3 to 1.03e-2, grad 1.02e-2 to 1.54e-2,
# local 8.0e-3 to 1.17e-2 over three runs of each seed; no routing choice
# differed. The card's side moves from run to run (seed 51's loss 2.07e-4
# to 3.01e-4, seed 52's grad 1.02e-2 to 1.54e-2), so the limits sit 3x to
# 4x above the largest readings. The kernels ignoring the band read loss
# 1.1e-3 to 3.8e-3, gnorm 0.47 to 0.48 and local 0.20 to 0.25; the sink
# dropped from the forward gnorm 6.1 to 9.0 and local 0.70 to 0.91; dsink
# zeroed gnorm 1.0 (the sinks' own gradients alone).
GPTOSS_VS_CPU_LIMITS = dict(loss=2 ** -10, gnorm=2 ** -5, grad=2 ** -4,
                            local=2 ** -5)


def gptoss_planted_faults(torch) -> dict:
    """Faults phase 18 must catch, each a context for one card step: the
    kernels ignoring the band, the sink dropped from the forward's
    epilogue, and the sink's gradient zeroed."""
    import contextlib
    from transformerengine_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def patched(name, make):
        real = getattr(fa, name)
        setattr(fa, name, make(real))
        try:
            yield
        finally:
            setattr(fa, name, real)

    def no_band(real):
        return lambda window: fa.NO_WINDOW

    def no_sink(real):
        def fwd(*args, softmax_sink=None, **kwargs):
            return real(*args, **kwargs)
        return fwd

    def zero_dsink(real):
        return lambda sink, o, lse, do: torch.zeros_like(sink)

    return {"the kernels ignore the band": lambda: patched("_window", no_band),
            "the sink dropped from the forward": lambda: patched(
                "flash_fwd", no_sink),
            "dsink zeroed": lambda: patched("sink_grad", zero_dsink)}


def gptoss_card_vs_cpu(torch, seed: int = GPTOSS_VS_CPU_SEED) -> list:
    """Phase 18; returns what failed."""
    from transformerengine_tpu_torch.models.gptoss import (
        GPTOSS_20B, GptOssModel, gptoss_loss)
    cfg = dataclasses.replace(GPTOSS_20B, **GPTOSS_VS_CPU_CONFIG)
    b, s = 1, GPTOSS_VS_CPU_S
    log(f"[18] GPT-OSS training, card vs CPU: 2 layers (a band of "
        f"{cfg.sliding_window} on layer 0, sinks on both), "
        f"{cfg.num_attention_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, hidden {cfg.hidden_size}, {cfg.num_experts} experts "
        f"of FFN {cfg.intermediate_size}, top-{cfg.topk}, vocabulary "
        f"{cfg.vocab_size}, B={b} S={s}, one bf16 step, the MoE held op by "
        f"op, seed {seed}")
    t0 = time.perf_counter()
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, "cpu", seed)
    limits = GPTOSS_VS_CPU_LIMITS

    def seeded(device):
        """The model of ``seed`` with its sinks and biases drawn (the
        reference initializes them at zero, where they would hide their
        faults)."""
        model = GptOssModel(cfg, device=device, seed=seed)
        shrink_embedding(model)
        gen = torch.Generator(device="cpu").manual_seed(seed + 1000)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("softmax_offset", "bias")):
                    std = 1.0 if name.endswith("softmax_offset") else 0.1
                    p.copy_(torch.randn(p.shape, generator=gen) * std)
        return model

    cpu = seeded("cpu")
    start = {n: t.clone() for n, t in cpu.state_dict().items()}
    recorded = []
    with moe_ops(torch, record=recorded):
        ref = step_readings(torch, cpu, tokens, targets, None, "cpu",
                            loss_fn=gptoss_loss)
    del cpu
    card = GptOssModel(cfg, device=CARD, seed=seed)

    def forced_step():
        card.load_state_dict(start)
        local, excused = [], []
        with moe_ops(torch, force=list(recorded), local=local,
                     excused=excused):
            got = step_readings(torch, card, tokens, targets, None, CARD,
                                loss_fn=gptoss_loss)
        out = differences(got, ref, local)
        out["excused"] = sum(excused)
        return out

    got = forced_step()
    planted = {}
    for fname, fault in gptoss_planted_faults(torch).items():
        with fault():
            planted[fname] = forced_step()
    del card
    failures = []
    ok = all(got[k] <= limits[k] for k in limits)
    log(f"  ({time.perf_counter() - t0:.1f} s), limits "
        + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
    log("    residual stream after each layer, largest difference over the "
        "largest |CPU|: " + ", ".join(f"{e:.3e}" for e in got["stream"]))
    log(f"    card against CPU: {_fmt(got)}; {got['excused']} routing "
        f"choices differed at a near-tie {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"gptoss seed {seed}")
    for fname, d in planted.items():
        caught = [k for k in ("loss", "gnorm", "local")
                  if not d[k] <= limits[k]]
        log(f"    planted fault '{fname}': {_fmt(d)}: "
            + (f"caught by {', '.join(caught)}" if caught else "NOT CAUGHT"))
        if not caught:
            failures.append(f"gptoss seed {seed}: '{fname}' not caught")
    return failures


# ---------------------------------------------------------------------------
# FP8 attention: the flash kernels' FP8 branches (phase 3, [3u]-[3w]) and
# the LlamaModel training step under fp8_dpa and fp8_mha (phase 19)
# ---------------------------------------------------------------------------

def fp8_payloads(torch, tensors, dtype=None):
    """Current-scaling payloads of bf16 tensors (the fp8_dpa quantizers'
    rowwise quantize) and their dequant scales, (payloads, (n,) f32)."""
    from transformerengine_tpu_torch.quantize.quantizer import (
        CurrentScaleQuantizer, QuantizeLayout)
    out = [CurrentScaleQuantizer(dtype or torch.float8_e4m3fn).quantize(
        t, layout=QuantizeLayout.ROWWISE) for t in tensors]
    return ([t.data for t in out],
            torch.cat([t.scale_inv.reshape(1) for t in out]))


def check_fp8_o(torch, name: str, got, ref, rtol: float = BF16_ROW_RTOL):
    """Holds an fp8 O payload to its plain version: within one fp8 step of
    the plain value (a value at a rounding tie of the cast moves by one
    code) plus ``rtol`` of each row's largest (the f32 O before the cast
    differs as a bf16 O does). Returns the largest difference."""
    r = ref.float()
    step = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -6)))
                      - 3)
    tol = step + rtol * r.abs().amax(dim=-1, keepdim=True)
    return check(f"{name} (fp8 payload; {int((got != ref).sum())} of "
                 f"{ref.numel()} codes differ)", got, ref, tol)


FP8_SHAPE = (TRAIN_B, TRAIN_S, 32, 8, 128)     # B, S, Hq, Hkv, D
# The fp8 O epilogue's scale: the delayed scale of an amax history 0.9x
# this O's amax, so the largest values saturate at 448.
FP8_O_HEADROOM = 0.9


def fp8_inputs(torch, seed: int, shape=FP8_SHAPE):
    """Seeded bf16 Q, K, V and dO at ``shape`` (B, S, Hq, Hkv, D), and
    the current-scaling e4m3 payloads of Q, K and V with their scales."""
    b, s, hq, hkv, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), \
        randn(b, s, hkv, d), randn(b, s, hq, d)
    pays, sinv = fp8_payloads(torch, (q, k, v))
    return (q, k, v, do), pays, sinv


def check_flash_fp8(torch, timer, results):
    """[3u] rows 2f and 2o: the FP8 forward at the training shape (B 2,
    S 2048, Hq 32, Hkv 8, D 128, causal) on e4m3 payloads, with a bf16 O
    and with the fp8 O epilogue, each against its plain version; timed
    with the plain version and SDPA on the dequantized bf16 Q/K/V (no
    PyTorch call takes fp8 Q/K/V)."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_plain, fp8_fwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[3u] flash_attention fwd, FP8 branch: training B={b} S={s} Hq={hq}"
        f" Hkv={hkv} D={d}, causal, e4m3 Q/K/V from a current-scaling "
        f"quantize of seeded bf16 tensors; O in bf16 (row 2f) and the fp8 O "
        f"epilogue (row 2o)")
    _, (qd, kd, vd), sinv = fp8_inputs(torch, 31)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=True, scale_invs=sinv)
    o, lse = flash_fwd(qd, kd, vd, **kw)
    torch.cuda.synchronize()
    sc = fp8_fwd_scales(sinv, scale)
    o_ref, lse_ref = flash_fwd_plain(qd, kd, vd, causal=True, fp8_scales=sc,
                                     out_dtype=torch.bfloat16)
    err_f = check("O (bf16)", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
    check("LSE", lse, lse_ref, LSE_ATOL)
    amax = o_ref.float().abs().amax() * FP8_O_HEADROOM
    oscale = compute_scale_from_amax(amax, torch.float8_e4m3fn).reshape(1)
    o8, lse8, am = flash_fwd(qd, kd, vd, out_dtype=torch.float8_e4m3fn,
                             out_scale=oscale, **kw)
    torch.cuda.synchronize()
    sc8 = fp8_fwd_scales(sinv, scale, oscale)
    o8_ref, _, am_ref = flash_fwd_plain(qd, kd, vd, causal=True,
                                        fp8_scales=sc8,
                                        out_dtype=torch.float8_e4m3fn)
    err_o = check_fp8_o(torch, "O (fp8 epilogue)", o8, o8_ref)
    check("LSE (fp8 epilogue)", lse8, lse_ref, LSE_ATOL)
    check("O amax", am, am_ref, 2 ** -8 * float(am_ref))
    saturated = int((o8.float().abs() == 448.0).sum())
    if not saturated:
        raise AssertionError("the O scale was set to saturate some values")
    log(f"  {saturated} O values saturate at 448 on both sides ok")
    ms_f = timer(lambda: flash_fwd(qd, kd, vd, **kw))
    ms_o = timer(lambda: flash_fwd(qd, kd, vd, out_dtype=torch.float8_e4m3fn,
                                   out_scale=oscale, **kw))
    plain_f = timer(lambda: flash_fwd_plain(qd, kd, vd, causal=True,
                                            fp8_scales=sc,
                                            out_dtype=torch.bfloat16))
    plain_o = timer(lambda: flash_fwd_plain(qd, kd, vd, causal=True,
                                            fp8_scales=sc8,
                                            out_dtype=torch.float8_e4m3fn))
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           for t, si in zip((qd, kd, vd), sinv.unbind())]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        *deq, is_causal=True, scale=scale, enable_gqa=True))
    pairs = b * hq * s * (s + 1) // 2
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    # Q, K and V payloads read once; O (bf16 or fp8) and LSE written. The
    # scores are an e4m3 x e4m3 product (fp8 peak), the PV product bf16 x
    # e4m3 (bf16 peak), as the reference's kernel runs them.
    prods = [(2 * d * pairs, FP8_FLOPS), (2 * d * pairs, BF16_FLOPS)]
    for name, ms, plain_ms, o_bytes, err in (
            ("flash_attention_fwd_fp8", ms_f, plain_f, 2, err_f),
            ("flash_attention_fwd_fp8_mha", ms_o, plain_o, 1, err_o)):
        nbytes = q_el + 2 * kv_el + o_bytes * q_el + 4 * b * hq * s
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on "
            f"the dequantized bf16 Q/K/V {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {4 * d * pairs / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:2057",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} e4m3 "
                  f"causal, O {'bf16' if o_bytes == 2 else 'e4m3'}")


def check_flash_bwd_fp8(torch, timer, results):
    """[3v] rows 4f and 4o: the FP8 backward at the training shape from
    e4m3 Q/K/V payloads, with a bf16 dO (fp8_dpa) and with e4m3 O and e5m2
    dO payloads (fp8_mha), each against its plain version; timed with the
    plain version and SDPA's backward on the dequantized bf16 tensors."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, fp8_bwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[3v] flash_attention bwd, FP8 branch (dQ and dK/dV kernels): "
        f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d}, causal, e4m3 Q/K/V; "
        f"bf16 dO (row 4f), e4m3 O and e5m2 dO (row 4o)")
    (_, _, _, do), (qd, kd, vd), sinv = fp8_inputs(torch, 32)
    scale = d ** -0.5
    o, lse = flash_fwd(qd, kd, vd, scale=scale, causal=True, scale_invs=sinv)
    oscale = compute_scale_from_amax(o.float().abs().amax(),
                                     torch.float8_e4m3fn).reshape(1)
    o8, _, _ = flash_fwd(qd, kd, vd, scale=scale, causal=True,
                         scale_invs=sinv, out_dtype=torch.float8_e4m3fn,
                         out_scale=oscale)
    (do8,), sdo = fp8_payloads(torch, (do,), torch.float8_e5m2)
    so = (1.0 / oscale).reshape(1)
    one = torch.ones((), device="cuda")
    cases = (("flash_attention_bwd_fp8", o, do, {}, one, None),
             ("flash_attention_bwd_fp8_mha", o8, do8,
              dict(o_scale_inv=so, do_scale_inv=sdo), sdo, so))
    kw = dict(scale=scale, causal=True, scale_invs=sinv,
              grad_dtype=torch.bfloat16)
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           .requires_grad_() for t, si in zip((qd, kd, vd), sinv.unbind())]
    out = F.scaled_dot_product_attention(*deq, is_causal=True, scale=scale,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = timer.events(lambda: torch.autograd.grad(
        out, deq, dot, retain_graph=True))
    pairs = b * hq * s * (s + 1) // 2
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    for name, o_in, do_in, extra, sdo_t, so_t in cases:
        got = flash_bwd(qd, kd, vd, o_in, lse, do_in, **kw, **extra)
        torch.cuda.synchronize()
        delta = (do_in.float() * o_in.float()).sum(dim=-1)
        if so_t is not None:
            delta = delta * (so_t.reshape(()) * sdo_t.reshape(()))
        sc = fp8_bwd_scales(sinv, scale, sdo_t)
        ref = flash_bwd_plain(qd, kd, vd, do_in, lse, delta, scale=scale,
                              causal=True, fp8_scales=sc,
                              grad_dtype=torch.bfloat16)
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            differ = int((a != r).sum())
            err = max(err, check(
                f"{name} {gname} ({differ} of {r.numel()} elements differ)",
                a, r, BWD_RTOL * float(r.float().abs().max())))
        del got, ref
        ms = timer(lambda: flash_bwd(qd, kd, vd, o_in, lse, do_in, **kw,
                                     **extra))
        plain_ms = timer(lambda: flash_bwd_plain(
            qd, kd, vd, do_in, lse, delta, scale=scale, causal=True,
            fp8_scales=sc, grad_dtype=torch.bfloat16), reps=5)
        fp8_do = so_t is not None
        # Five products over the causal pairs: s = Q K^T (e4m3 x e4m3) and
        # dp = dO V^T (e5m2 x e4m3 with an fp8 dO) at the fp8 peak, the
        # other three (p or ds in bf16 times a payload or dO) at bf16's.
        n_fp8 = 2 if fp8_do else 1
        prods = [(n_fp8 * 2 * d * pairs, FP8_FLOPS),
                 ((5 - n_fp8) * 2 * d * pairs, BF16_FLOPS)]
        io_bytes = 1 if fp8_do else 2
        # Read Q, K, V (e4m3), O and dO, LSE; write dQ, dK, dV (bf16).
        nbytes = q_el + 2 * kv_el + 2 * io_bytes * q_el + 4 * b * hq * s \
            + 2 * (q_el + 2 * kv_el)
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"backward on dequantized bf16 {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {10 * d * pairs / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1477",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} e4m3 causal,"
                  f" dO {'e5m2' if fp8_do else 'bf16'}")
    del out, deq


def fp8_variants(torch, cases, seed: int, dropout=None) -> None:
    """Each case (Sq, D, Hq, Hkv, window, sink, mask, O scale: the fp8
    epilogue's scale over 448 / amax(O), above 1 saturating) through the
    FP8 branches, forward (bf16 O and the fp8 O epilogue: O, LSE, the O
    amax) and backward (bf16 dO, and e4m3 O with e5m2 dO), each against
    its plain version; ``mask`` as :func:`variant_mask` takes it (Sq =
    Skv), its queries that see nothing writing O = 0. ``dropout``: the
    kernels' dropout kwargs and the plain versions' Dropout
    (:func:`drop_kw`), or None."""
    dkw, drop = dropout if dropout is not None else ({}, None)
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain,
        fp8_bwd_scales, fp8_fwd_scales)
    e4m3, e5m2, bf16 = torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16
    for i, (sq, d, hq, hkv, window, sink, mask, ratio) in enumerate(cases):
        (_, _, _, do), (qd, kd, vd), sinv = fp8_inputs(
            torch, seed + i, (2, sq, hq, hkv, d))
        g = torch.Generator(device="cuda").manual_seed(seed + 10 + i)
        s0 = torch.randn((hq,), generator=g, device="cuda") * 2 \
            if sink else None
        mk, qzero, kzero = variant_mask(torch, g, mask, 2, sq, sq)
        scale = d ** -0.5
        pkw = dict(causal=True, window=window or (-1, -1), softmax_sink=s0,
                   **mk)
        kw = dict(scale=scale, scale_invs=sinv, **pkw, **dkw)
        pkw["dropout"] = drop
        name = f"Sq={sq} D={d} G={hq // hkv} window={window} sink={sink} " \
               f"mask={mask}" + (" dropout" if drop is not None else "")
        o, lse = flash_fwd(qd, kd, vd, **kw)
        o_ref, lse_ref = flash_fwd_plain(
            qd, kd, vd, fp8_scales=fp8_fwd_scales(sinv, scale),
            out_dtype=bf16, **pkw)
        check(f"fwd {name} O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        oscale = (448.0 * ratio / o_ref.float().abs().amax()).reshape(1)
        o8, _, am = flash_fwd(qd, kd, vd, out_dtype=e4m3, out_scale=oscale,
                              **kw)
        o8_ref, _, am_ref = flash_fwd_plain(
            qd, kd, vd, fp8_scales=fp8_fwd_scales(sinv, scale, oscale),
            out_dtype=e4m3, **pkw)
        check_fp8_o(torch, f"fwd {name} fp8 O, scale x{ratio}", o8, o8_ref)
        check(f"fwd {name} O amax", am, am_ref, 2 ** -8 * float(am_ref))
        if ratio > 1 and not bool((o8.float().abs() == 448.0).any()):
            raise AssertionError("the O scale was set to saturate")
        if qzero is not None and bool(qzero.any()) and \
                float(o8[qzero].float().abs().max()) != 0.0:
            raise AssertionError("fully masked rows must write O = 0")
        (do8,), sdo = fp8_payloads(torch, (do,), e5m2)
        so = (1.0 / oscale).reshape(1)
        for bname, o_in, do_in, extra, sdo_t, so_t in (
                ("bf16 dO", o, do, {}, torch.ones((), device="cuda"), None),
                ("e4m3 O, e5m2 dO", o8, do8,
                 dict(o_scale_inv=so, do_scale_inv=sdo), sdo, so)):
            got = flash_bwd(qd, kd, vd, o_in, lse, do_in, grad_dtype=bf16,
                            **extra, **kw)
            delta = (do_in.float() * o_in.float()).sum(dim=-1)
            if so_t is not None:
                delta = delta * (so_t.reshape(()) * sdo_t.reshape(()))
            ref = flash_bwd_plain(qd, kd, vd, do_in, lse, delta, scale=scale,
                                  causal=True, window=window or (-1, -1),
                                  fp8_scales=fp8_bwd_scales(sinv, scale,
                                                            sdo_t),
                                  grad_dtype=bf16, dropout=drop, **mk)
            for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
                check(f"bwd {name} {bname} {gname}", a, r,
                      BWD_RTOL * float(r.float().abs().max()))
            check_zero_grads(f"bwd {name} {bname}", got, qzero, kzero)


def check_fp8_variants(torch) -> None:
    """[3w] the FP8 branches at small shapes (the cases of
    :func:`fp8_variants`): padding-causal lengths with fully masked rows,
    GQA groups of 4 and 8, D 64 and 128, a window with a learnable sink,
    and O scales that saturate."""
    log("[3w] flash attention's FP8 branches at small shapes, forward and "
        "backward")
    # (Sq, D, Hq, Hkv, window, sink, lengths, O scale ratio)
    fp8_variants(torch, ((160, 64, 8, 2, None, False, (160, 77), 0.5),
                         (130, 128, 16, 2, None, False, None, 2.0),
                         (192, 64, 8, 1, (32, 0), True, (192, 50), 1.0),
                         (96, 128, 4, 1, (16, 0), True, None, 4.0)), 40)


# Phase 19: the LlamaModel training step with FP8 attention, phase 6's
# shape (LLAMA_8B width, 4 layers, B 2, S 2048, lr 1e-3), four recipes.
FP8_MXFP8_STEPS = 2


def fp8_attention_recipes() -> tuple:
    """(name, recipe, steps) of phase 19."""
    from transformerengine_tpu_torch import (
        DelayedScaling, Float8CurrentScaling, MXFP8BlockScaling)
    return (("delayed_mha", DelayedScaling(amax_history_len=16, fp8_dpa=True,
                                           fp8_mha=True), TRAIN_STEPS),
            ("current_mha", Float8CurrentScaling(fp8_dpa=True, fp8_mha=True),
             TRAIN_STEPS),
            ("current", Float8CurrentScaling(), TRAIN_STEPS),
            ("mxfp8_dpa", MXFP8BlockScaling(fp8_dpa=True), FP8_MXFP8_STEPS))


def fp8_attention_counts(name: str, layers: int, train: bool) -> dict:
    """The launches of one step (``train``) or forward without a gradient
    under phase 19's recipe ``name``: per layer one flash forward, and a
    dQ and a dK/dV launch, of the recipe's branch (``_fp8`` with FP8
    Q/K/V, ``_fp8_mha`` with the fp8 O epilogue and with fp8 O and dO in
    the backward; none of the bf16 flash under fp8_dpa, none of FP8 under
    plain current scaling); MXFP8's quantize kernels as phase 8's."""
    fwd, bwd = {"delayed_mha": ("_fp8_mha", "_fp8_mha"),
                "current_mha": ("_fp8", "_fp8_mha"),
                "current": ("", ""),
                "mxfp8_dpa": ("_fp8", "_fp8")}[name]
    out = {"flash_attention_fwd" + fwd: layers}
    if name == "mxfp8_dpa":
        out.update({k: v for k, v in mxfp8_counts(layers, train).items()
                    if not k.startswith("flash")})
    if train:
        out.update({"flash_attention_bwd_dq" + bwd: layers,
                    "flash_attention_bwd_dkv" + bwd: layers})
    return out


def check_fp8_mha_state(torch, model, layers: int) -> str:
    """Every layer's fp8_mha_o delayed state moved: the O (x) and dO
    (dgrad) scales off 1 and their histories non-zero."""
    moved = []
    for i in range(layers):
        out = model.layers[i].self_attention.out
        for role in ("x", "dgrad"):
            scale = float(getattr(out, f"fp8_mha_o_{role}_scale"))
            hist = getattr(out, f"fp8_mha_o_{role}_amax_history")
            if scale == 1.0 or not float(hist.abs().max()) > 0:
                raise AssertionError(f"layer {i} fp8_mha_o_{role}: scale "
                                     f"{scale}, history max "
                                     f"{float(hist.abs().max())}")
            moved.append(scale)
    return (f"every layer's fp8_mha_o O and dO scales moved "
            f"({min(moved):.4g} to {max(moved):.4g}) and their histories "
            f"hold amaxes ok")


def train_fp8_attention(torch, results) -> None:
    """Phase 19: the LlamaModel training step at LLAMA_8B width, 4 layers,
    B = 2, S = 2048, under DelayedScaling(fp8_dpa, fp8_mha),
    Float8CurrentScaling(fp8_dpa, fp8_mha), Float8CurrentScaling() and
    MXFP8BlockScaling(fp8_dpa): SGD steps with finite losses and exact
    launch counts, then one forward without a gradient each; ms/step,
    tok/s, peak memory, busy share and the ratio to phase 6's step."""
    from transformerengine_tpu_torch import autocast
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    cfg = dataclasses.replace(LLAMA_8B, num_layers=TRAIN_LAYERS)
    b, s, layers = TRAIN_B, TRAIN_S, TRAIN_LAYERS
    log(f"[19] FP8-attention training: LLAMA_8B width, {layers} layers, B={b}"
        f" S={s}, SGD at lr {TRAIN_LR} on one batch, then the forward "
        f"without a gradient, under each of "
        f"{[n for n, _, _ in fp8_attention_recipes()]}")
    tokens, targets = train_batch(torch, cfg.vocab_size, b, s, CARD)
    totals = collections.Counter()
    stats = {}
    base = results.get("_train", {}).get("ms_per_step")
    for name, recipe, steps in fp8_attention_recipes():
        torch.cuda.reset_peak_memory_stats()
        model = LlamaModel(cfg, device=CARD, seed=0)
        shrink_embedding(model)
        expect = fp8_attention_counts(name, layers, True)
        losses, times, counts = timed_steps(
            torch, lambda: float(train_step(torch, model, tokens, targets,
                                            recipe)), expect, steps, "step")
        totals.update(counts)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        st = dict(ms_per_step=step_ms, tok_per_s=b * s / (step_ms / 1e3),
                  losses=losses, peak_gib=peak, steps=steps)
        log(f"  {name} {recipe}:")
        log(f"    losses {[round(x, 5) for x in losses]} (all finite); "
            f"launches per step {expect} in every step ok")
        log(f"    step times {[round(t * 1e3, 2) for t in times]} ms; median "
            f"of steps 2-{steps} {step_ms:.2f} ms/step, "
            f"{b * s / (step_ms / 1e3):.0f} tok/s, peak {peak:.2f} GiB"
            + (f"; {step_ms / base:.3f}x phase 6's DelayedScaling step "
               f"({base:.2f} ms)" if base else ""))
        if name == "delayed_mha":
            log("    " + check_fp8_mha_state(torch, model, layers))
        busy, wall, kernels = device_profile(
            torch, lambda: train_step(torch, model, tokens, targets, recipe),
            1)
        log_profile(f"{name} step", st, busy, wall, kernels, 1)
        expect_fwd = fp8_attention_counts(name, layers, False)
        with torch.no_grad(), autocast(recipe=recipe):
            outs, fwd_times, fwd_counts = timed_steps(
                torch, lambda: model(tokens), expect_fwd, 1,
                "forward without a gradient")
        totals.update(fwd_counts)
        if outs[0].shape != (b, s, cfg.vocab_size) or \
                not bool(torch.isfinite(outs[0]).all()):
            raise AssertionError(f"{name}: the forward's logits are not "
                                 f"finite")
        st["forward_ms"] = fwd_times[0] * 1e3
        log(f"    forward without a gradient: launches {expect_fwd} ok, "
            f"logits finite, {fwd_times[0] * 1e3:.2f} ms")
        stats[name] = st
        del model, outs
        torch.cuda.empty_cache()
    for kernel, n in totals.items():
        add_launches(results, bwd_row(kernel), n)
    results["_train_fp8_attention"] = stats


# ---------------------------------------------------------------------------
# Packed documents: the flash kernels' segment branches (phase 3,
# [3x]-[3z]) and the LlamaModel step on the loader's packed batches
# (phase 20)
# ---------------------------------------------------------------------------

# The packed dataset: PACK_DOCS documents of lengths log-uniform over
# PACK_LENS (some longer than TRAIN_S, which the packer splits), tokens
# uniform in [1, vocab), all drawn from PACK_SEED.
PACK_SEED, PACK_DOCS, PACK_LENS = 61, 256, (64, 4096)


def write_packed_docs(path: str, vocab: int) -> None:
    """Writes the packed dataset as a TEBIN001 file. The lengths are drawn
    before the tokens, so the packing does not depend on ``vocab``."""
    import numpy as np
    from transformerengine_tpu_torch.data import write_token_bin
    rng = np.random.default_rng(PACK_SEED)
    lens = np.exp(rng.uniform(math.log(PACK_LENS[0]), math.log(PACK_LENS[1]),
                              PACK_DOCS)).astype(np.int64)
    write_token_bin(path, [rng.integers(1, vocab, int(n), dtype=np.int32)
                           for n in lens])


def packed_loader(vocab: int, b: int, s: int):
    """A context holding the port's native PackedDataLoader (one thread,
    so the batches come in a fixed order) over the packed dataset, written
    into a temporary directory under the package's build directory."""
    import contextlib
    import os
    import tempfile
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.data import PackedDataLoader

    @contextlib.contextmanager
    def ctx():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            path = os.path.join(tmp, "packed.tebin")
            write_packed_docs(path, vocab)
            loader = PackedDataLoader(path, b, s, seed=PACK_SEED,
                                      n_threads=1)
            try:
                if not loader.native:
                    raise AssertionError("the native packer did not build")
                yield loader
            finally:
                loader.close()
    return ctx()


def loader_batch(torch, loader, device):
    """The loader's next (tokens, segment_ids, positions) on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in loader.next_batch())


def seg_pairs(torch, seg) -> int:
    """Visible (query, key) pairs of a packed batch: equal nonzero ids
    with j <= i."""
    pos = torch.arange(seg.shape[1], device=seg.device)
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
    return int((same & (pos[None, :] <= pos[:, None])).sum())


def seg_mask(torch, seg):
    """(B, 1, S, S) boolean block-diagonal causal mask of a packed batch,
    True where a query sees a key: what SDPA takes for it."""
    s = seg.shape[1]
    pos = torch.arange(s, device=seg.device)
    mask = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0) \
        & (pos[:, None] >= pos[None, :])
    return mask[:, None]


def packed_ids(torch, loader_vocab: int):
    """The segment ids of the loader's first batch at phase 20's shape, on
    the card."""
    with packed_loader(loader_vocab, TRAIN_B, TRAIN_S) as loader:
        return loader_batch(torch, loader, "cuda")[1]


def check_masked_rows(torch, name, zero, o, lse, sink=None) -> None:
    """The queries ``zero`` (B, Sq), which see no key, write O = 0 and
    LSE = -1e30 (the sink with one)."""
    if zero is None or not bool(zero.any()):
        return
    if float(o[zero].float().abs().max()) != 0.0:
        raise AssertionError(f"{name}: a query that sees no key must write "
                             f"O = 0")
    got = lse.permute(0, 2, 1)[zero]
    what = f"{name} LSE of the {int(zero.sum())} queries that see no key"
    if sink is None:
        if not bool((got == -1e30).all()):
            raise AssertionError(f"{what} must be -1e30")
        log(f"  {what}: -1e30 ok")
    else:
        # sink * log2(e) * ln(2): the sink within an f32 ulp or two.
        check(f"{what} (the sink)", got, sink.float().expand_as(got),
              1e-6 * max(1.0, float(sink.abs().max())))


def check_flash_seg(torch, timer, results):
    """[3x] rows 2s and 2os: the forward's segment branch at phase 20's
    packed batch (B 2, S 2048, Hq 32, Hkv 8, D 128, padding-causal, the
    ids of the loader's first batch), in bf16 and, as phase 20's fp8_mha
    recipe runs it, on e4m3 payloads with the fp8 O epilogue; each
    against its plain version, timed with it, with SDPA under the
    block-diagonal causal boolean mask (on the dequantized bf16 tensors
    for 2os) and with the bound of the same-segment causal pairs."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain, fp8_fwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    seg = packed_ids(torch, LLAMA_8B.vocab_size)
    docs = [int(seg[i].max()) for i in range(b)]
    rows = int((seg != 0).sum())
    log(f"[3x] flash_attention fwd, segment branch: phase 20's packed batch "
        f"B={b} S={s} Hq={hq} Hkv={hkv} D={d}, padding-causal, the loader's "
        f"first batch ({docs} segments a row, {b * s - rows} padding "
        f"tokens); bf16 (row 2s) and e4m3 Q/K/V with the fp8 O epilogue "
        f"(row 2os)")
    (q, k, v, _), (qd, kd, vd), sinv = fp8_inputs(torch, 61, FP8_SHAPE)
    scale = d ** -0.5
    ids = dict(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True, **ids)
    torch.cuda.synchronize()
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    o_ref, lse_ref = flash_fwd_plain(qs, k, v, causal=True, **ids)
    err = check("O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
    check("LSE", lse, lse_ref, LSE_ATOL)
    check_masked_rows(torch, "bf16", seg == 0, o, lse)
    ms = timer(lambda: flash_fwd(q, k, v, scale=scale, causal=True, **ids))
    plain_ms = timer(lambda: flash_fwd_plain(qs, k, v, causal=True, **ids))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = seg_mask(torch, seg)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
    del qt, kt, vt
    # The fp8 O epilogue at the scale of this O's amax (delayed scaling's
    # state after a step), as phase 20's fp8_mha recipe runs it.
    sc = fp8_fwd_scales(sinv, scale)
    o_deq, _ = flash_fwd_plain(qd, kd, vd, causal=True, fp8_scales=sc,
                               out_dtype=torch.bfloat16, **ids)
    oscale = compute_scale_from_amax(o_deq.float().abs().amax(),
                                     torch.float8_e4m3fn).reshape(1)
    del o_deq
    kw8 = dict(scale=scale, causal=True, scale_invs=sinv,
               out_dtype=torch.float8_e4m3fn, out_scale=oscale, **ids)
    o8, lse8, am = flash_fwd(qd, kd, vd, **kw8)
    torch.cuda.synchronize()
    sc8 = fp8_fwd_scales(sinv, scale, oscale)
    pkw8 = dict(causal=True, fp8_scales=sc8, out_dtype=torch.float8_e4m3fn,
                **ids)
    o8_ref, lse8_ref, am_ref = flash_fwd_plain(qd, kd, vd, **pkw8)
    err8 = check_fp8_o(torch, "O (fp8 epilogue)", o8, o8_ref)
    check("LSE (fp8 epilogue)", lse8, lse8_ref, LSE_ATOL)
    check("O amax", am, am_ref, 2 ** -8 * float(am_ref))
    check_masked_rows(torch, "fp8", seg == 0, o8, lse8)
    ms8 = timer(lambda: flash_fwd(qd, kd, vd, **kw8))
    plain8 = timer(lambda: flash_fwd_plain(qd, kd, vd, **pkw8))
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           for t, si in zip((qd, kd, vd), sinv.unbind())]
    library8 = timer(lambda: F.scaled_dot_product_attention(
        *deq, attn_mask=mask, scale=scale, enable_gqa=True))
    del deq, mask
    pairs = seg_pairs(torch, seg) * hq
    causal_pairs = b * hq * s * (s + 1) // 2
    flops = 4 * d * pairs
    # Q, K and V read over the rows with an id; O, LSE written in full;
    # the ids read once.
    q_rows, kv_rows = rows * hq * d, rows * hkv * d
    for name, kms, pms, lms, e, el, o_bytes, prods in (
            ("flash_attention_fwd_seg", ms, plain_ms, library_ms, err, 2, 2,
             [(flops, BF16_FLOPS)]),
            ("flash_attention_fwd_fp8_mha_seg", ms8, plain8, library8, err8,
             1, 1, [(flops / 2, FP8_FLOPS), (flops / 2, BF16_FLOPS)])):
        nbytes = el * (q_rows + 2 * kv_rows) + o_bytes * b * s * hq * d \
            + 4 * b * hq * s + 4 * 2 * b * s
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA with "
            f"the block-diagonal causal mask {lms:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}, {flops / 1e9:.2f} GFLOP over the same-segment "
            f"causal pairs, {100 * pairs / causal_pairs:.1f} % of the "
            f"causal triangle's; {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:2057",
            max_abs_err=e, ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lms,
            shape=f"packed B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                  f"{'bf16' if el == 2 else 'e4m3, O e4m3'}, {docs} "
                  f"segments")


def check_flash_bwd_seg(torch, timer, results):
    """[3y] rows 4s and 4os: the backward's segment branch at the same
    packed batch, from a bf16 dO and (as phase 20's fp8_mha recipe) from
    e4m3 Q/K/V with e4m3 O and e5m2 dO payloads; each against its plain
    version, timed with it and with SDPA's backward under the mask."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd, fp8_bwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    seg = packed_ids(torch, LLAMA_8B.vocab_size)
    log(f"[3y] flash_attention bwd, segment branch (dQ and dK/dV kernels): "
        f"the packed batch of [3x]; bf16 (row 4s), e4m3 Q/K/V with e4m3 O "
        f"and e5m2 dO (row 4os)")
    (q, k, v, do), (qd, kd, vd), sinv = fp8_inputs(torch, 62, FP8_SHAPE)
    scale = d ** -0.5
    ids = dict(q_segment_ids=seg, kv_segment_ids=seg)
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True, **ids)
    o8p, lse8p = flash_fwd(qd, kd, vd, scale=scale, causal=True,
                           scale_invs=sinv, **ids)
    oscale = compute_scale_from_amax(o8p.float().abs().amax(),
                                     torch.float8_e4m3fn).reshape(1)
    o8, _, _ = flash_fwd(qd, kd, vd, scale=scale, causal=True,
                         scale_invs=sinv, out_dtype=torch.float8_e4m3fn,
                         out_scale=oscale, **ids)
    del o8p
    (do8,), sdo = fp8_payloads(torch, (do,), torch.float8_e5m2)
    so = (1.0 / oscale).reshape(1)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    zero = seg == 0
    mask = seg_mask(torch, seg)
    dot = do.transpose(1, 2).contiguous()
    pairs = seg_pairs(torch, seg) * hq
    rows = int((seg != 0).sum())
    q_rows, kv_rows = rows * hq * d, rows * hkv * d
    cases = (("flash_attention_bwd_seg", (q, k, v, o, lse, do),
              dict(scale=scale, causal=True, **ids),
              (qs, k, v, do, lse), dict(scale=scale, causal=True, **ids),
              None, 2),
             ("flash_attention_bwd_fp8_mha_seg", (qd, kd, vd, o8, lse8p, do8),
              dict(scale=scale, causal=True, scale_invs=sinv,
                   grad_dtype=torch.bfloat16, o_scale_inv=so,
                   do_scale_inv=sdo, **ids),
              (qd, kd, vd, do8, lse8p),
              dict(scale=scale, causal=True,
                   fp8_scales=fp8_bwd_scales(sinv, scale, sdo),
                   grad_dtype=torch.bfloat16, **ids),
              so.reshape(()) * sdo.reshape(()), 1))
    for name, args, kw, pargs, pkw, dscale, el in cases:
        got = flash_bwd(*args, **kw)
        torch.cuda.synchronize()
        delta = (args[5].float() * args[3].float()).sum(dim=-1)
        if dscale is not None:
            delta = delta * dscale
        ref = flash_bwd_plain(*pargs, delta, **pkw)
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            differ = int((a != r).sum())
            err = max(err, check(
                f"{name} {gname} ({differ} of {r.numel()} elements differ)",
                a, r, BWD_RTOL * float(r.float().abs().max())))
        check_zero_grads(name, got, zero, zero)
        del got, ref
        ms = timer(lambda: flash_bwd(*args, **kw))
        plain_ms = timer(lambda: flash_bwd_plain(*pargs, delta, **pkw),
                         reps=5)
        if el == 2:
            src = (q, k, v)
        else:
            src = [(t.float() * si).to(torch.bfloat16)
                   for t, si in zip((qd, kd, vd), sinv.unbind())]
        leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in src]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=scale, enable_gqa=True)
        library_ms = timer.events(lambda: torch.autograd.grad(
            out, leaves, dot, retain_graph=True))
        del out, leaves
        # Five products over the same-segment causal pairs; for 4os s and
        # dp at the fp8 peak. Read Q, K, V over the rows with an id, O,
        # dO (in full: delta's rows), LSE and the ids; write dQ, dK, dV.
        n_fp8 = 0 if el == 2 else 2
        prods = [(n_fp8 * 2 * d * pairs, FP8_FLOPS),
                 ((5 - n_fp8) * 2 * d * pairs, BF16_FLOPS)]
        nbytes = el * (q_rows + 2 * kv_rows) + 2 * el * b * s * hq * d \
            + 4 * b * hq * s + 4 * 2 * b * s \
            + 2 * b * s * (hq + 2 * hkv) * d
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"backward with the mask{'' if el == 2 else ' (dequantized bf16)'}"
            f" {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{10 * d * pairs / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1477",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"packed B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                  f"{'bf16' if el == 2 else 'e4m3, O e4m3, dO e5m2'}")
    del mask


def small_ids(torch, g, b: int, s: int, kind: str):
    """(B, S) int32 segment ids on the card: "packed" (contiguous
    documents of random lengths, then padding), "gaps" (ids drawn at
    random from 0-3 per token: non-contiguous, documents that reappear
    and zeros among them) or "zero_row" (packed, then row 1 all 0)."""
    if kind == "gaps":
        return torch.randint(0, 4, (b, s), generator=g, device="cuda",
                             dtype=torch.int32)
    cuts = torch.rand((b, 3), generator=g, device="cuda").sort(dim=1).values
    pos = torch.arange(s, device="cuda")[None, :, None] / s
    ids = (pos >= cuts[:, None, :]).sum(dim=-1).to(torch.int32) + 1
    ids = torch.where(pos[..., 0] < 0.9, ids, torch.zeros_like(ids))
    if kind == "zero_row":
        ids[1] = 0
    return ids


def check_seg_variants(torch) -> None:
    """[3z] the segment branches at small shapes, through
    :func:`flash_variants` (f32; GQA groups of 4 and 8; D 64, 128 and
    256; a window with a learnable sink; an all-zero row; non-contiguous
    ids; no causal rule; the bottom-right offset with other q and kv ids)
    and :func:`fp8_variants` (the FP8 branches with packed and
    non-contiguous ids, a window and a sink); then ids with lengths in
    one descriptor through ``flash_attention``, where the ids win."""
    from transformerengine_tpu_torch.attention import (
        AttnMaskType, SequenceDescriptor)
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_attention, flash_fwd_plain)
    log("[3z] flash attention's segment branches at small shapes, forward "
        "and backward")
    g = torch.Generator(device="cuda").manual_seed(63)
    f32, bf16 = torch.float32, torch.bfloat16
    # (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, ids)
    flash_variants(torch, g, (
        (f32, 96, 96, 64, 4, 2, True, None, None, "packed"),
        (bf16, 130, 130, 64, 8, 2, True, None, None, "gaps"),
        (bf16, 150, 150, 128, 16, 2, True, None, None, "zero_row"),
        (bf16, 100, 100, 256, 4, 2, True, (24, 0), "learnable", "packed"),
        (bf16, 70, 70, 128, 4, 1, False, None, None, "gaps"),
        (f32, 40, 100, 64, 4, 2, True, None, None, "packed")))
    # (Sq, D, Hq, Hkv, window, sink, ids, O scale ratio)
    fp8_variants(torch, ((160, 64, 8, 2, None, False, "packed", 1.0),
                         (96, 128, 8, 1, (16, 0), True, "gaps", 2.0)), 70)
    # Ids and lengths in one descriptor: the ids win, as in the
    # reference's wrapper.
    q, k, v = (torch.randn((2, 64, 4, 64), generator=g, device="cuda").to(
        bf16) for _ in range(3))
    seg = small_ids(torch, g, 2, 64, "gaps")
    lens = torch.tensor([64, 20], dtype=torch.int32, device="cuda")
    desc = dataclasses.replace(
        SequenceDescriptor.from_segment_ids_and_pos(seg),
        q_seqlens=lens, kv_seqlens=lens)
    o = flash_attention(q, k, v, desc,
                        attn_mask_type=AttnMaskType.PADDING_CAUSAL)
    qs = (q.float() * (64 ** -0.5 * LOG2E)).to(bf16)
    o_ref, _ = flash_fwd_plain(qs, k, v, causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg)
    check("flash_attention, ids and lengths in one descriptor (the ids "
          "win)", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))


# Phase 20: the LlamaModel training step on packed documents, phase 6's
# shape (LLAMA_8B width, 4 layers, B 2, S 2048, lr 1e-3), three recipes,
# PACKED_STEPS steps each on the loader's batches.
PACKED_STEPS = 3


def packed_recipes() -> tuple:
    """(name, recipe, flash branch suffix) of phase 20."""
    from transformerengine_tpu_torch import DelayedScaling
    return (("bf16", None, "_seg"), ("delayed", DelayedScaling(), "_seg"),
            ("delayed_mha", DelayedScaling(fp8_dpa=True, fp8_mha=True),
             "_fp8_mha_seg"))


def packed_loss(torch, model, tokens, seg, pos):
    """The packed batch's next-token cross entropy: a target counts where
    it continues its own document."""
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    from transformerengine_tpu_torch.models.llama import cross_entropy_loss
    desc = SequenceDescriptor.from_segment_ids_and_pos(seg, seg, pos, pos)
    logits = model(tokens, desc, pos)
    mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:], mask=mask)


def packed_step(torch, model, batch, recipe, lr: float = TRAIN_LR):
    tokens, seg, pos = batch
    return train_step(torch, model, tokens, tokens, recipe, lr=lr,
                      loss_fn=lambda m, t, _: packed_loss(
                          torch, m, t, seg.to(t.device), pos.to(t.device)))


def train_packed(torch, results) -> None:
    """Phase 20: packed-document training at LLAMA_8B width, 4 layers,
    B = 2, S = 2048, on the port's PackedDataLoader's batches: steps
    without a recipe, under DelayedScaling() and under
    DelayedScaling(fp8_dpa=True, fp8_mha=True), each step with exact
    launch counts of the segment branches (no flash launch without
    segments), then one forward without a gradient each; ms/step, tok/s
    over the non-pad tokens, peak memory, busy share and the ratio to
    phase 6's step; then the card against the CPU."""
    from transformerengine_tpu_torch import autocast
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    cfg = dataclasses.replace(LLAMA_8B, num_layers=TRAIN_LAYERS)
    b, s, layers = TRAIN_B, TRAIN_S, TRAIN_LAYERS
    log(f"[20] packed-document training: LLAMA_8B width, {layers} layers, "
        f"B={b} S={s}, the native PackedDataLoader over {PACK_DOCS} seeded "
        f"documents of {PACK_LENS[0]}-{PACK_LENS[1]} tokens (log-uniform), "
        f"{PACKED_STEPS} SGD steps at lr {TRAIN_LR} under each of "
        f"{[n for n, _, _ in packed_recipes()]}, then the forward without a "
        f"gradient")
    totals = collections.Counter()
    stats = {}
    base = results.get("_train", {})
    with packed_loader(cfg.vocab_size, b, s) as loader:
        for name, recipe, branch in packed_recipes():
            torch.cuda.reset_peak_memory_stats()
            model = LlamaModel(cfg, device=CARD, seed=0)
            shrink_embedding(model)
            expect = {"flash_attention_fwd" + branch: layers,
                      "flash_attention_bwd_dq" + branch: layers,
                      "flash_attention_bwd_dkv" + branch: layers}
            batches = [loader_batch(torch, loader, CARD)
                       for _ in range(PACKED_STEPS)]
            nonpad = [int((bt[1] != 0).sum()) for bt in batches]
            it = iter(batches)
            losses, times, counts = timed_steps(
                torch, lambda: float(packed_step(torch, model, next(it),
                                                 recipe)),
                expect, PACKED_STEPS, "step")
            totals.update(counts)
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"{name}: losses {losses}")
            step_ms = statistics.median(times[1:]) * 1e3
            tok_s = statistics.median(n / t for n, t in
                                      zip(nonpad[1:], times[1:]))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ref = base.get("bf16_ms_per_step" if recipe is None
                           else "ms_per_step")
            st = dict(ms_per_step=step_ms, nonpad_tok_per_s=tok_s,
                      nonpad_tokens=nonpad, losses=losses, peak_gib=peak)
            log(f"  {name} {recipe}:")
            log(f"    losses {[round(x, 5) for x in losses]} (all finite); "
                f"launches per step {expect} in every step ok")
            log(f"    step times {[round(t * 1e3, 2) for t in times]} ms; "
                f"median of steps 2-{PACKED_STEPS} {step_ms:.2f} ms/step, "
                f"{tok_s:.0f} non-pad tok/s (non-pad tokens {nonpad} of "
                f"{b * s}), peak {peak:.2f} GiB"
                + (f"; {step_ms / ref:.3f}x phase 6's "
                   f"{'bf16' if recipe is None else 'DelayedScaling'} step "
                   f"({ref:.2f} ms)" if ref else ""))
            busy, wall, kernels = device_profile(
                torch, lambda: packed_step(torch, model, batches[-1], recipe),
                1)
            log_profile(f"{name} packed step", st, busy, wall, kernels, 1)
            tokens, seg, pos = batches[-1]
            desc = SequenceDescriptor.from_segment_ids_and_pos(seg, seg, pos,
                                                               pos)
            expect_fwd = {"flash_attention_fwd" + branch: layers}
            with torch.no_grad(), autocast(enabled=recipe is not None,
                                           recipe=recipe):
                outs, fwd_times, fwd_counts = timed_steps(
                    torch, lambda: model(tokens, desc, pos), expect_fwd, 1,
                    "forward without a gradient")
            totals.update(fwd_counts)
            if outs[0].shape != (b, s, cfg.vocab_size) or \
                    not bool(torch.isfinite(outs[0]).all()):
                raise AssertionError(f"{name}: the forward's logits are not "
                                     f"finite")
            st["forward_ms"] = fwd_times[0] * 1e3
            log(f"    forward without a gradient: launches {expect_fwd} ok, "
                f"logits finite, {fwd_times[0] * 1e3:.2f} ms")
            stats[name] = st
            del model, outs, batches, it
            torch.cuda.empty_cache()
    for kernel, n in totals.items():
        add_launches(results, bwd_row(kernel), n)
    results["_train_packed"] = stats
    failures = packed_card_vs_cpu(torch)
    if failures:
        raise AssertionError(f"packed step, card against CPU: {failures}")


# Phase 20's card against the CPU: one bf16 step of 2 layers at LLAMA_8B
# width on one packed row of three documents and padding, held to phase
# 7's bf16 limits.
PACKED_VS_CPU_SEED, PACKED_VS_CPU_S = 71, 256
PACKED_VS_CPU_DOCS = (120, 80, 40)


def packed_card_vs_cpu(torch) -> list:
    """Phase 20's card-against-CPU check; returns what failed. The planted
    fault gives the card's flash kernels all-ones ids, which ignores the
    packing."""
    import contextlib
    import numpy as np
    from transformerengine_tpu_torch.data import pack_sequences
    from transformerengine_tpu_torch.models.llama import LLAMA_8B, LlamaModel
    from transformerengine_tpu_torch.ops import flash_attention as fa
    cfg = dataclasses.replace(LLAMA_8B, num_layers=2)
    rng = np.random.default_rng(PACKED_VS_CPU_SEED)
    docs = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
            for n in PACKED_VS_CPU_DOCS]
    offsets = np.cumsum([0, *PACKED_VS_CPU_DOCS]).astype(np.int64)
    packed = pack_sequences(np.concatenate(docs), offsets, PACKED_VS_CPU_S,
                            use_native=True)
    batch = tuple(torch.from_numpy(a) for a in packed)
    if batch[0].shape[0] != 1:
        raise AssertionError("the three documents must pack into one row")
    log(f"  card vs CPU: one bf16 step of 2 layers at LLAMA_8B width, B=1 "
        f"S={PACKED_VS_CPU_S}, one packed row of documents of "
        f"{PACKED_VS_CPU_DOCS} tokens and {int((batch[1] == 0).sum())} "
        f"padding, seed {PACKED_VS_CPU_SEED}")
    limits = TRAIN_VS_CPU_LIMITS["bf16"]
    t0 = time.perf_counter()
    cpu = LlamaModel(cfg, device="cpu", seed=PACKED_VS_CPU_SEED)
    shrink_embedding(cpu)
    start = {n: t.clone() for n, t in cpu.state_dict().items()}

    def readings(model, dev):
        tokens, seg, pos = (t.to(dev) for t in batch)
        return step_readings(
            torch, model, tokens, tokens, None, dev,
            loss_fn=lambda m, t, _: packed_loss(torch, m, t, seg, pos))

    ref = readings(cpu, "cpu")
    del cpu
    card = LlamaModel(cfg, device=CARD, seed=PACKED_VS_CPU_SEED)
    card.load_state_dict(start)
    got = differences(readings(card, CARD), ref)

    @contextlib.contextmanager
    def ids_ignored():
        real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

        def ones(kw):
            for key in ("q_segment_ids", "kv_segment_ids"):
                if kw.get(key) is not None:
                    kw[key] = torch.ones_like(kw[key])
            return kw

        fa.flash_fwd = lambda *a, **kw: real_fwd(*a, **ones(kw))
        fa.flash_bwd = lambda *a, **kw: real_bwd(*a, **ones(kw))
        try:
            yield
        finally:
            fa.flash_fwd, fa.flash_bwd = real_fwd, real_bwd

    card.load_state_dict(start)
    with ids_ignored():
        planted = differences(readings(card, CARD), ref)
    del card
    ok = all(got[k] <= limits[k] for k in limits)
    log(f"    ({time.perf_counter() - t0:.1f} s) limits "
        + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
    log("    residual stream after each layer, largest difference over the "
        "largest |CPU|: " + ", ".join(f"{e:.3e}" for e in got["stream"]))
    log(f"    card against CPU: {_fmt(got)} {'ok' if ok else 'FAIL'}")
    failures = [] if ok else ["packed bf16"]
    caught = [k for k in limits if not planted[k] <= limits[k]]
    log(f"    planted fault 'all-ones ids (the packing ignored)': "
        f"{_fmt(planted)}: "
        + (f"caught by {', '.join(caught)}" if caught else "NOT CAUGHT"))
    if not caught:
        failures.append("packed: 'all-ones ids' not caught")
    return failures


# Phase 3's bias and ALiBi rows and phases 21 and 22: the encoder
# TransformerLayer (relative-position bias, LayerNorm, GELU, a padding
# mask) at LLAMA_8B width. The rows' shape is its attention at the
# training shape: B 2, S 2048, Hq 32, Hkv 8, D 128, lengths 2048 and 1536.
ENC_LENS = (2048, 1536)
ENC_LAYERS = 4
ENC_SEED = 81
# dbias is f32 on both sides: the same f32 products, the scores summed in
# other orders, far below one bf16 ulp of the largest element.
DBIAS_RTOL = 2 ** -10


def encoder_bias(torch, s: int, hq: int, seed: int):
    """The f32 (1, Hq, S, S) bidirectional bias of a
    RelativePositionBiases at the reference's 32 buckets and max distance
    128, its embedding drawn from ``seed`` as the layer draws it."""
    from transformerengine_tpu_torch.nn.transformer import (
        RelativePositionBiases)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mod = RelativePositionBiases(32, 128, hq, device="cuda", generator=g)
    with torch.no_grad():
        return mod(s, s, True)


def enc_inputs(torch, seed: int):
    """bf16 q, k, v, dO at the training shape and the padding lengths, on
    the card."""
    b, s, hq, hkv, d = FP8_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)

    lens = torch.tensor(ENC_LENS[:b], dtype=torch.int32, device="cuda")
    return (randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d),
            randn(b, s, hq, d), lens)


def enc_sdpa_mask(torch, bias, lens, s: int):
    """SDPA's float attn_mask for a bias under the padding mask, (B, H, S,
    S) bf16: the bias where a query sees a key, -inf elsewhere (a query
    past its length sees nothing: SDPA writes NaN there, and is timed
    alone)."""
    pos = torch.arange(s, device="cuda")
    valid = (pos[None, :, None] < lens[:, None, None]) \
        & (pos[None, None, :] < lens[:, None, None])
    return torch.where(valid[:, None], bias.to(torch.bfloat16),
                       float("-inf")).to(torch.bfloat16)


def enc_terms(torch, term: str, hq: int, s: int):
    """(flash kwargs, plain kwargs, the bias SDPA adds) of a term:
    "bias" the relative bias, "alibi" ALiBi (its bias materialized for
    SDPA as the unfused backend does)."""
    from transformerengine_tpu_torch.attention import alibi_bias
    from transformerengine_tpu_torch.flex_attention import AlibiMod
    if term == "bias":
        bias = encoder_bias(torch, s, hq, ENC_SEED)
        return dict(bias=bias), dict(bias=bias), bias
    mod = AlibiMod(hq)
    return (dict(score_mod=mod),
            dict(alibi_slopes=mod.slopes(hq, "cuda")),
            alibi_bias(hq, s, s, "cuda"))


def enc_pairs(lens, hq: int) -> int:
    """Visible (query, key) pairs of the bidirectional padding mask."""
    return hq * sum(int(n) * int(n) for n in lens.tolist())


def check_flash_bias(torch, timer, results):
    """[3A] rows 2b and 2a: the forward's bias and ALiBi branches at the
    encoder's training shape (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16, the
    padding mask with lengths 2048 and 1536, no causal rule), the bias an
    f32 (1, 32, 2048, 2048) relative bias; each against its plain
    version, timed with it and with SDPA under the bias as a float
    attn_mask, and with its bound."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[3A] flash_attention fwd, bias (row 2b) and ALiBi (row 2a) "
        f"branches: the encoder's B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, "
        f"padding lengths {ENC_LENS}, no causal rule; an f32 (1, {hq}, {s}, "
        f"{s}) relative bias")
    q, k, v, _, lens = enc_inputs(torch, 71)
    scale = d ** -0.5
    zero = torch.arange(s, device="cuda")[None, :] >= lens[:, None]
    pairs = enc_pairs(lens, hq)
    causal_pairs = b * hq * s * (s + 1) // 2
    rows = int(lens.sum())
    for term, row in (("bias", "2b"), ("alibi", "2a")):
        kw, pkw, lib_bias = enc_terms(torch, term, hq, s)
        name = f"flash_attention_fwd_{term}"
        o, lse = flash_fwd(q, k, v, lens, lens, scale=scale, causal=False,
                           **kw)
        torch.cuda.synchronize()
        qs = q if term == "alibi" else (q.float() * (scale * LOG2E)).to(
            q.dtype)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, lens, lens, causal=False,
                                         scale=scale, **pkw)
        err = check(f"{name} O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
        check(f"{name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, name, zero, o, lse)
        del o, lse, o_ref, lse_ref
        ms = timer(lambda: flash_fwd(q, k, v, lens, lens, scale=scale,
                                     causal=False, **kw))
        plain_ms = timer(lambda: flash_fwd_plain(
            qs, k, v, lens, lens, causal=False, scale=scale, **pkw), reps=5)
        mask = enc_sdpa_mask(torch, lib_bias, lens, s)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
        del qt, kt, vt, mask
        flops = 4 * d * pairs
        # Q, K and V read over the valid rows, the bias (2b) once in
        # full; O and LSE written in full.
        nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) \
            + 2 * b * s * hq * d + 4 * b * hq * s \
            + (kw["bias"].numel() * 4 if term == "bias" else 4 * hq)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"  {name} (row {row}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, SDPA with the bias as a float mask {library_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP over the "
            f"visible pairs, {pairs / causal_pairs:.2f}x the causal "
            f"triangle's; {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:724",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"encoder B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, "
                  f"padding {ENC_LENS}, {term}")
        del kw, pkw, lib_bias


def check_flash_bwd_bias(torch, timer, results):
    """[3B] rows 4b and 4a: the backward's bias (with dbias) and ALiBi
    branches at the shape of [3A]; dQ, dK, dV and the per-batch f32 dbias
    against the plain version, zero gradients for the padded rows and
    keys and a zero dbias past the lengths; timed with the plain version
    and with SDPA's backward under the float mask (its gradient included:
    the mask is a leaf that needs one)."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[3B] flash_attention bwd, bias (row 4b, with dbias) and ALiBi "
        f"(row 4a) branches (dQ and dK/dV kernels): the shape of [3A]")
    q, k, v, do, lens = enc_inputs(torch, 72)
    scale = d ** -0.5
    zero = torch.arange(s, device="cuda")[None, :] >= lens[:, None]
    pairs = enc_pairs(lens, hq)
    rows = int(lens.sum())
    for term, row in (("bias", "4b"), ("alibi", "4a")):
        kw, pkw, lib_bias = enc_terms(torch, term, hq, s)
        name = f"flash_attention_bwd_{term}"
        o, lse = flash_fwd(q, k, v, lens, lens, scale=scale, causal=False,
                           **kw)
        got = flash_bwd(q, k, v, o, lse, do, lens, lens, scale=scale,
                        causal=False, **kw)
        torch.cuda.synchronize()
        qs = q if term == "alibi" else (q.float() * (scale * LOG2E)).to(
            q.dtype)
        delta = (do.float() * o.float()).sum(dim=-1)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, lens, lens,
                              scale=scale, causal=False, **pkw)
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            differ = int((a != r).sum())
            err = max(err, check(
                f"{name} {gname} ({differ} of {r.numel()} elements differ)",
                a, r, BWD_RTOL * float(r.float().abs().max())))
        check_zero_grads(name, got, zero, zero)
        if term == "bias":
            differ = int((got[3] != ref[3]).sum())
            err = max(err, check(
                f"{name} dbias ({differ} of {ref[3].numel()} differ)",
                got[3], ref[3], DBIAS_RTOL * float(ref[3].abs().max())))
            past = ~(~zero[:, :, None] & ~zero[:, None, :])
            if float(got[3].abs().amax(dim=1)[past].max()) != 0.0:
                raise AssertionError(f"{name}: dbias past the lengths must "
                                     f"be exactly 0")
            log(f"  {name} dbias past the lengths: exactly 0 ok")
        del got, ref
        ms = timer(lambda: flash_bwd(q, k, v, o, lse, do, lens, lens,
                                     scale=scale, causal=False, **kw))
        plain_ms = timer(lambda: flash_bwd_plain(
            qs, k, v, do, lse, delta, lens, lens, scale=scale, causal=False,
            **pkw), reps=3)
        leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
        mask = enc_sdpa_mask(torch, lib_bias, lens, s).requires_grad_()
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=scale, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        library_ms = timer.events(lambda: torch.autograd.grad(
            out, (*leaves, mask), dot, retain_graph=True))
        del out, leaves, mask, dot, o, lse
        flops = 10 * d * pairs
        # Read Q, K, V over the valid rows, O and dO in full (delta's
        # rows), LSE, the bias once (4b); write dQ, dK, dV and (4b) the
        # per-batch f32 dbias.
        nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) \
            + 2 * 2 * b * s * hq * d + 4 * b * hq * s \
            + 2 * b * s * (hq + 2 * hkv) * d \
            + (kw["bias"].numel() * 4 + 4 * b * hq * s * s
               if term == "bias" else 4 * hq)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"  {name} (row {row}): kernels {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA backward with the float mask and its "
            f"gradient {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1477",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"encoder B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, "
                  f"padding {ENC_LENS}, {term}")
        del kw, pkw, lib_bias


def check_bias_variants(torch) -> None:
    """[3C] the bias and ALiBi branches at small shapes, forward (O, LSE)
    and backward (dQ, dK, dV, dbias) against the plain versions: a
    per-batch bf16 bias, causal (dbias exactly 0 above the diagonal,
    whole skipped tiles included), a window with a sink, f32, D 64 and
    256, GQA groups of 4 and 8, and ALiBi with padding, the bottom-right
    offset and a window."""
    from transformerengine_tpu_torch.flex_attention import AlibiMod
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain)
    log("[3C] flash attention's bias and ALiBi at small shapes, forward and "
        "backward")
    g = torch.Generator(device="cuda").manual_seed(73)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, lengths, term,
    # bias batch, bias dtype)
    cases = (
        (bf16, 96, 96, 64, 4, 2, False, None, None, (96, 50), "bias", 2,
         bf16),
        (bf16, 200, 200, 128, 8, 2, True, None, None, None, "bias", 1, f32),
        (bf16, 100, 100, 64, 4, 2, True, (24, 0), "learnable", None, "bias",
         1, f32),
        (f32, 70, 70, 64, 4, 1, False, None, None, (70, 33), "bias", 1, f32),
        (bf16, 64, 64, 256, 4, 2, True, None, None, None, "bias", 2, bf16),
        (bf16, 80, 80, 64, 16, 2, False, None, None, (80, 80), "bias", 1,
         f32),
        (bf16, 96, 96, 128, 8, 2, False, None, None, (96, 41), "alibi", 0,
         None),
        (bf16, 40, 100, 64, 4, 2, True, None, None, None, "alibi", 0, None),
        (f32, 64, 64, 256, 4, 2, True, (16, 0), "off_by_one", None, "alibi",
         0, None))
    for (dt, sq, skv, d, hq, hkv, causal, window, sink, lens, term, bb,
         bdt) in cases:
        q, do = randn(2, sq, hq, d, dtype=dt), randn(2, sq, hq, d, dtype=dt)
        k, v = randn(2, skv, hkv, d, dtype=dt), randn(2, skv, hkv, d,
                                                      dtype=dt)
        s0 = (None if sink is None else torch.zeros(hq, device="cuda")
              if sink == "off_by_one" else randn(hq) * 2)
        mk, qzero, kzero = variant_mask(torch, g, lens, 2, sq, skv)
        offset = skv - sq if causal else 0
        scale = d ** -0.5
        if term == "bias":
            bias = (randn(bb, hq, sq, skv) * 2).to(bdt)
            kw, pkw = dict(bias=bias), dict(bias=bias)
        else:
            mod = AlibiMod(hq)
            kw = dict(score_mod=mod)
            pkw = dict(alibi_slopes=mod.slopes(hq, "cuda"), scale=scale)
        base = dict(causal=causal, offset=offset, window=window or (-1, -1),
                    **mk)
        o, lse = flash_fwd(q, k, v, scale=scale, softmax_sink=s0, **base,
                           **kw)
        qs = q if term == "alibi" else (q.float() * (scale * LOG2E)).to(dt)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, softmax_sink=s0, **base,
                                         **pkw)
        name = (f"{term} {dt} Sq={sq} Skv={skv} D={d} G={hq // hkv} "
                f"causal={causal} window={window} sink={sink} lens={lens}"
                + (f" bias ({bb}, ...) {bdt}" if term == "bias" else ""))
        tol = 1e-4 if dt == f32 else row_tol(o_ref, BF16_ROW_RTOL)
        check(f"fwd {name} O", o, o_ref, tol)
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, softmax_sink=s0,
                        **base, **kw)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale, **base,
                              **{k_: v_ for k_, v_ in pkw.items()
                                 if k_ != "scale"})
        for gname, a, r in zip(("dQ", "dK", "dV", "dbias"), got, ref):
            rel = (1e-4 if dt == f32 else BWD_RTOL) if gname != "dbias" \
                else DBIAS_RTOL
            check(f"bwd {name} {gname}", a, r,
                  rel * float(r.float().abs().max()))
        check_zero_grads(f"bwd {name}", got, qzero, kzero)
        if term == "bias" and causal and window is None:
            upper = torch.ones((sq, skv), dtype=torch.bool,
                               device="cuda").triu(offset + 1)
            if float(got[3][..., upper].abs().max()) != 0.0:
                raise AssertionError(f"bwd {name}: dbias above the diagonal "
                                     f"must be exactly 0")
            log(f"  bwd {name}: dbias above the diagonal exactly 0 ok")


def encoder_stack(torch, layers: int, device, seed: int, alibi=False,
                  **dropout):
    """``layers`` encoder TransformerLayers at LLAMA_8B width (hidden 4096,
    FFN 14336, 32/8 heads of 128): LayerNorm, GELU, the padding mask and
    the relative bias, with ``dropout`` (the layers' attention_dropout,
    hidden_dropout, drop_path); with ``alibi`` instead ``layers`` ALiBi
    MultiHeadAttention blocks (LayerNorm, the padding mask), as a
    ModuleList whose blocks add to the residual stream."""
    from transformerengine_tpu_torch.attention import (
        AttnBiasType, AttnMaskType)
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    from transformerengine_tpu_torch.nn.transformer import (
        MultiHeadAttention, TransformerLayer)
    cfg = LLAMA_8B
    g = torch.Generator(device=device).manual_seed(seed)
    if alibi:
        return torch.nn.ModuleList(
            MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads,
                               num_gqa_groups=cfg.num_kv_heads,
                               layernorm_epsilon=cfg.norm_eps,
                               attn_mask_type=AttnMaskType.PADDING,
                               attn_bias_type=AttnBiasType.ALIBI,
                               device=device, generator=g)
            for _ in range(layers))
    return torch.nn.ModuleList(
        TransformerLayer(cfg.hidden_size, cfg.intermediate_size,
                         cfg.num_attention_heads,
                         num_gqa_groups=cfg.num_kv_heads,
                         layernorm_epsilon=cfg.norm_eps,
                         norm_type="layernorm", mlp_activations=("gelu",),
                         self_attn_mask_type=AttnMaskType.PADDING,
                         enable_relative_embedding=True, device=device,
                         generator=g, **dropout)
        for _ in range(layers))


def encoder_batch(torch, b: int, s: int, lens, device, seed: int):
    """(x, the descriptor, the read-out r, the valid token count): x
    (B, S, 4096) bf16 and r (B, S, 4096) f32 drawn with numpy from
    ``seed``."""
    import numpy as np
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    rng = np.random.default_rng(seed)
    h = LLAMA_8B.hidden_size
    x = torch.from_numpy(rng.standard_normal((b, s, h)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    r = torch.from_numpy(rng.standard_normal((b, s, h)).astype(
        np.float32)).to(device)
    ln = torch.tensor(lens, dtype=torch.int32, device=device)
    return x, SequenceDescriptor.from_seqlens(ln), r, int(sum(lens))


def encoder_loss(stack, x, desc, r, n_valid, alibi=False, **train):
    """The read-out ``sum(y * r) / n_valid`` of the stack's output;
    ``train`` (deterministic, generator) goes to each layer."""
    y = x
    for block in stack:
        y = y + block(y, desc) if alibi else block(y, desc, **train)
    return (y.float() * r).sum() / n_valid


def encoder_recipes() -> tuple:
    """(name, recipe, steps) of phase 21."""
    from transformerengine_tpu_torch import DelayedScaling, MXFP8BlockScaling
    return (("bf16", None, 3), ("mxfp8", MXFP8BlockScaling(), 2),
            ("delayed_mha", DelayedScaling(fp8_dpa=True, fp8_mha=True), 2))


def train_encoder(torch, results) -> None:
    """Phase 21: the encoder stack at LLAMA_8B width, 4 layers (cut from
    the reference's depth for the time limit), B = 2, S = 2048, lengths
    2048 and 1536: SGD steps at lr 1e-3 without a recipe, under
    MXFP8BlockScaling() and under DelayedScaling(fp8_dpa=True,
    fp8_mha=True), each with finite losses and exact launch counts (a
    bias forward and a bias dQ and dK/dV launch per layer per step, no
    FP8 flash branch: the bias closes the gates; under MXFP8 its
    quantize kernels as a Llama layer's); ms/step, tok/s, peak memory and
    the busy share of one profiled step each. Then two bf16 steps of 4
    ALiBi attention blocks at the same shape, their ALiBi launches
    counted."""
    b, s, layers = TRAIN_B, TRAIN_S, ENC_LAYERS
    log(f"[21] encoder training: LLAMA_8B width, {layers} TransformerLayers "
        f"(LayerNorm, GELU, padding mask, relative bias: 32 buckets, max "
        f"distance 128), B={b} S={s}, lengths {ENC_LENS}, read-out loss, "
        f"SGD at lr {TRAIN_LR}: {[(n, k) for n, _, k in encoder_recipes()]}")
    x, desc, r, n_valid = encoder_batch(torch, b, s, ENC_LENS, CARD,
                                        ENC_SEED)
    bias_counts = {f"flash_attention_{k}_bias": layers
                   for k in ("fwd", "bwd_dq", "bwd_dkv")}
    totals = collections.Counter()
    stats = {}
    for name, recipe, steps in encoder_recipes():
        torch.cuda.reset_peak_memory_stats()
        stack = encoder_stack(torch, layers, CARD, ENC_SEED)
        expect = dict(bias_counts)
        if name == "mxfp8":
            expect.update({"mxfp8_norm_quantize_2x": 2 * layers,
                           "mxfp8_quantize_2x": 10 * layers})

        def step():
            return train_step(torch, stack, x, None, recipe,
                              loss_fn=lambda m, t, _: encoder_loss(
                                  m, t, desc, r, n_valid))
        losses, times, counts = timed_steps(
            torch, lambda: float(step()), expect, steps, "step")
        totals.update(counts)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        st = dict(ms_per_step=step_ms, tok_per_s=b * s / (step_ms / 1e3),
                  valid_tok_per_s=n_valid / (step_ms / 1e3), losses=losses,
                  peak_gib=peak)
        log(f"  {name} {recipe}: losses {[round(v, 5) for v in losses]} "
            f"(all finite); launches per step {expect} in every step ok")
        log(f"    step times {[round(t * 1e3, 2) for t in times]} ms; median "
            f"of steps 2-{steps} {step_ms:.2f} ms/step, "
            f"{st['tok_per_s']:.0f} tok/s ({st['valid_tok_per_s']:.0f} "
            f"valid), peak {peak:.2f} GiB")
        busy, wall, kernels = device_profile(torch, step, 1)
        log_profile(f"{name} encoder step", st, busy, wall, kernels, 1)
        stats[name] = st
        del stack
        torch.cuda.empty_cache()
    stack = encoder_stack(torch, layers, CARD, ENC_SEED, alibi=True)
    expect = {f"flash_attention_{k}_alibi": layers
              for k in ("fwd", "bwd_dq", "bwd_dkv")}
    losses, times, counts = timed_steps(
        torch, lambda: float(train_step(
            torch, stack, x, None, None, loss_fn=lambda m, t, _: encoder_loss(
                m, t, desc, r, n_valid, alibi=True))), expect, 2, "step")
    totals.update(counts)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"ALiBi: losses {losses}")
    log(f"  ALiBi attention blocks ({layers}, bf16): losses "
        f"{[round(v, 5) for v in losses]}, launches {expect} in both steps "
        f"ok, step times {[round(t * 1e3, 2) for t in times]} ms")
    stats["alibi_ms_per_step"] = times[-1] * 1e3
    del stack
    for kernel, n in totals.items():
        add_launches(results, bwd_row(kernel), n)
    results["_train_encoder"] = stats


# Phase 22: the encoder step, card against CPU: 2 layers at LLAMA_8B
# width, B 1, S 256 with 200 valid tokens, the relative bias, bf16.
ENC_VS_CPU_SEED, ENC_VS_CPU_S, ENC_VS_CPU_LEN = 83, 256, 200
# The read-out's difference over its terms' size (||y * r|| / n: one
# bf16 ulp of every output element, 2^-8, with random signs, adds up like
# a norm), each parameter's gradient in norm (gnorm) and its largest
# element (grad) over its largest |CPU|, and rel_embedding's gradient in
# norm (rel). Both sides run bf16 GEMMs and the same attention in other
# summation orders: as phase 7's bf16 step, one-ulp roundings that
# accumulate through the layers. Readings on an H100 at this seed: loss
# 1.52e-3, gnorm 6.48e-3, grad 7.59e-3, rel 6.48e-3; the limits sit about
# 2.5x above them, and the planted faults read 8.7e-3 to 1.0.
ENC_VS_CPU_LIMITS = dict(loss=2 ** -8, gnorm=2 ** -6, grad=2 ** -6,
                         rel=2 ** -6)


def encoder_card_vs_cpu(torch) -> list:
    """Phase 22's check; returns what failed. Planted faults: the card's
    kernels given a zero bias (the relative bias ignored), and dbias
    zeroed (rel_embedding learns nothing); each must fail a limit."""
    import contextlib
    from transformerengine_tpu_torch.ops import flash_attention as fa
    s, n = ENC_VS_CPU_S, ENC_VS_CPU_LEN
    log(f"[22] encoder step, card against CPU: 2 layers at LLAMA_8B width, "
        f"B=1 S={s} ({n} valid), the relative bias, bf16, seed "
        f"{ENC_VS_CPU_SEED}")
    t0 = time.perf_counter()

    def readings(device, start=None):
        stack = encoder_stack(torch, 2, device, ENC_VS_CPU_SEED)
        if start is not None:
            stack.load_state_dict(start)
        x, desc, r, n_valid = encoder_batch(torch, 1, s, (n,), device,
                                            ENC_VS_CPU_SEED)
        stack.zero_grad(set_to_none=True)
        y = x
        for layer in stack:
            y = layer(y, desc)
        loss = (y.float() * r).sum() / n_valid
        loss.backward()
        size = float((y.detach().float() * r).norm()) / n_valid
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in stack.named_parameters()}
        return float(loss.detach()), size, grads, {
            k: v.cpu() for k, v in stack.state_dict().items()}

    loss_c, size, grads_c, start = readings("cpu")

    def differences(loss, grads) -> dict:
        out = dict(loss=abs(loss - loss_c) / size, gnorm=0.0, grad=0.0,
                   rel=0.0)
        for k, ref in grads_c.items():
            diff = (grads[k] - ref)
            gn = float(diff.norm() / ref.norm().clamp_min(1e-30))
            if gn > out["gnorm"]:
                out["gnorm"], out["gnorm_of"] = gn, k
            out["grad"] = max(out["grad"], float(
                diff.abs().max() / ref.abs().max().clamp_min(1e-30)))
            if k.endswith("rel_embedding"):
                out["rel"] = max(out["rel"], gn)
        return out

    def fmt(d) -> str:
        return ", ".join(f"{k} {d[k]:.3e}" for k in ENC_VS_CPU_LIMITS) + \
            f" (gnorm of {d.get('gnorm_of')})"

    def card():
        loss, _, grads, _ = readings(CARD, start)
        return differences(loss, grads)

    got = card()

    @contextlib.contextmanager
    def patched(fwd=None, bwd=None):
        real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd
        fa.flash_fwd = fwd(real_fwd) if fwd else real_fwd
        fa.flash_bwd = bwd(real_bwd) if bwd else real_bwd
        try:
            yield
        finally:
            fa.flash_fwd, fa.flash_bwd = real_fwd, real_bwd

    def zero_bias(real):
        def call(*a, **kw):
            if kw.get("bias") is not None:
                kw["bias"] = torch.zeros_like(kw["bias"])
            return real(*a, **kw)
        return call

    def zero_dbias(real):
        def call(*a, **kw):
            out = real(*a, **kw)
            return (*out[:3], torch.zeros_like(out[3])) if len(out) == 4 \
                else out
        return call

    planted = {}
    with patched(fwd=zero_bias, bwd=zero_bias):
        planted["the relative bias ignored"] = card()
    with patched(bwd=zero_dbias):
        planted["dbias zeroed"] = card()
    limits = ENC_VS_CPU_LIMITS
    ok = all(got[k] <= limits[k] for k in limits)
    log(f"    ({time.perf_counter() - t0:.1f} s) limits "
        + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
    log(f"    card against CPU: {fmt(got)} {'ok' if ok else 'FAIL'}")
    failures = [] if ok else ["encoder bf16"]
    for what, diff in planted.items():
        caught = [k for k in limits if not diff[k] <= limits[k]]
        log(f"    planted fault '{what}': {fmt(diff)}: "
            + (f"caught by {', '.join(caught)}" if caught else "NOT CAUGHT"))
        if not caught:
            failures.append(f"encoder: '{what}' not caught")
    return failures


# Phase 3's dropout rows (3D-3H) and phases 23 and 24: attention dropout
# at rate 0.1, what a fine-tune sets, from fixed seed words (the first
# above 2^31 as uint32). The rows' shapes are phase 6's causal training
# attention (2d, 4d) and phase 21's encoder attention with its relative
# bias (2db, 4db).
DROP_RATE = 0.1
DROP_WORDS = (0x9ABCDEF0 - 2 ** 32, 0x2468ACE1)
# 32-bit integer operations of the keep hash per visited score (the two
# index terms' xor and the origins' sum, the finalizer's three shifts,
# three xors and two multiplies, the compare and the select): the bound
# counts them at F32_FLOPS, the rate of the CUDA cores (the card's table
# gives no other for 32-bit integer work). The backward's bound counts
# them once a score, as the function needs; that its dQ and dK/dV
# kernels each hash every score again is a cost of their design.
HASH_OPS = 14


def drop_seed(torch, words=DROP_WORDS):
    from transformerengine_tpu_torch.ops.flash_attention import dropout_seed
    return dropout_seed(torch.tensor(words, dtype=torch.int32), "cuda")


def drop_kw(torch, words=DROP_WORDS) -> tuple:
    """(the kernels' dropout kwargs, the plain versions' Dropout)."""
    from transformerengine_tpu_torch.ops.flash_attention import Dropout
    seed = drop_seed(torch, words)
    return (dict(dropout_probability=DROP_RATE, dropout_seed=seed),
            Dropout(seed, DROP_RATE))


def planted_seed(torch) -> tuple:
    """The dropout of a wrong seed (the second word off by one)."""
    return drop_kw(torch, (DROP_WORDS[0], DROP_WORDS[1] + 1))


def check_keep_rate(torch, b, hq, hkv, s, visible, what: str) -> None:
    """The kept share of the visible scores of the plain mask is 1 - rate
    within five binomial standard deviations."""
    from transformerengine_tpu_torch.ops.flash_attention import dropout_keep
    keep = dropout_keep(drop_seed(torch), b, hq, hkv, s, s, DROP_RATE)
    n = int(visible.sum()) * hq
    share = float((keep & visible[:, None]).sum()) / n
    bound = 5 * math.sqrt(DROP_RATE * (1 - DROP_RATE) / n)
    ok = abs(share - (1 - DROP_RATE)) <= bound
    log(f"  {what} keep share {share:.6f} of {n} visible scores (1 - rate "
        f"{1 - DROP_RATE}, bound {bound:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: keep share {share}")


def must_differ(name: str, got, wrong, atol,
                what: str = "a wrong seed") -> None:
    """A planted fault: ``got`` held against a plain version with
    ``what`` must fail the tolerance that it meets on the right one."""
    diff = (got.float() - wrong.float()).abs()
    if bool((diff <= atol).all()):
        raise AssertionError(f"{name}: the plain version with {what} was "
                             f"not caught")
    log(f"  {name} against the plain version with {what}: max_abs_err "
        f"{float(diff.max()):.3e}, caught ok")


def drop_inputs(torch, term: str, seed: int):
    """(q, k, v, dO, mask kwargs, the visible (B, S, S) pairs, causal,
    flash kwargs, plain kwargs, SDPA kwargs, what) of a dropout row:
    "causal" phase 6's attention, "bias" phase 21's with its bias."""
    b, s, hq, hkv, d = FP8_SHAPE
    pos = torch.arange(s, device="cuda")
    if term == "causal":
        g = torch.Generator(device="cuda").manual_seed(seed)

        def randn(*sh):
            return torch.randn(sh, generator=g, device="cuda").to(
                torch.bfloat16)
        q, k, v, do = (randn(b, s, hq, d), randn(b, s, hkv, d),
                       randn(b, s, hkv, d), randn(b, s, hq, d))
        visible = (pos[:, None] >= pos[None, :]).expand(b, s, s)
        return (q, k, v, do, {}, visible, True, {}, {},
                dict(is_causal=True), "causal")
    q, k, v, do, lens = enc_inputs(torch, seed)
    bias = encoder_bias(torch, s, hq, ENC_SEED)
    valid = pos[None, :] < lens[:, None]
    visible = valid[:, :, None] & valid[:, None, :]
    return (q, k, v, do, dict(q_seqlens=lens, kv_seqlens=lens), visible,
            False, dict(bias=bias), dict(bias=bias),
            dict(attn_mask=enc_sdpa_mask(torch, bias, lens, s)),
            f"padding {ENC_LENS}, an f32 (1, {hq}, {s}, {s}) relative bias")


def check_flash_dropout(torch, timer, results):
    """[3D] row 2d and [3F] row 2db: the forward's dropout branch at phase
    6's causal training shape and, with the relative bias, at the
    encoder's (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16, rate 0.1); each
    against its plain version on the same seed words (the masks are equal
    bit for bit, so O meets row 2's bf16 tolerance), a planted wrong seed
    that must fail it, the plain mask's keep share, and timed with the
    plain version and with SDPA at dropout_p 0.1."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain)
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    kw, drop = drop_kw(torch)
    for term, label, row in (("causal", "3D", "2d"), ("bias", "3F", "2db")):
        (q, k, v, _, mk, visible, causal, fkw, pkw, skw,
         what) = drop_inputs(torch, term, 74)
        name = "flash_attention_fwd" + ("_bias" if fkw else "") + "_dropout"
        log(f"[{label}] flash_attention fwd, dropout branch (row {row}): "
            f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, {what}, rate "
            f"{DROP_RATE}, seed words {DROP_WORDS}")
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal, **mk, **fkw,
                           **kw)
        torch.cuda.synchronize()
        qs = (q.float() * (scale * LOG2E)).to(q.dtype)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, causal=causal, **mk,
                                         **pkw, dropout=drop)
        tol = row_tol(o_ref, BF16_ROW_RTOL)
        err = check(f"{name} O", o, o_ref, tol)
        check(f"{name} LSE", lse, lse_ref, LSE_ATOL)
        if mk:
            check_masked_rows(torch, name, ~visible.any(dim=2), o, lse)
        wrong = flash_fwd_plain(qs, k, v, causal=causal, **mk, **pkw,
                                dropout=planted_seed(torch)[1])[0]
        must_differ(f"{name} O", o, wrong, tol)
        del o, lse, o_ref, lse_ref, wrong
        check_keep_rate(torch, b, hq, hkv, s, visible, name)
        ms = timer(lambda: flash_fwd(q, k, v, scale=scale, causal=causal,
                                     **mk, **fkw, **kw))
        plain_ms = timer(lambda: flash_fwd_plain(
            qs, k, v, causal=causal, **mk, **pkw, dropout=drop), reps=3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = timer.events(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, dropout_p=DROP_RATE, scale=scale, enable_gqa=True,
            **skw))
        del qt, kt, vt, skw
        pairs = int(visible.sum()) * hq
        rows = int(visible.any(dim=2).sum())
        flops, ops = 4 * d * pairs, HASH_OPS * pairs
        # Q, K and V read over the valid rows, the bias (2db) once; O and
        # LSE written in full.
        nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) \
            + 2 * b * s * hq * d + 4 * b * hq * s \
            + (fkw["bias"].numel() * 4 if fkw else 0)
        b_ms, b_by = bound_ms_mixed(nbytes, [(flops, BF16_FLOPS),
                                             (ops, F32_FLOPS)])
        log(f"  {name} (row {row}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, SDPA with dropout_p {DROP_RATE} {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP at the bf16 "
            f"peak and {ops / 1e9:.2f} G hash operations at the CUDA cores' "
            f"rate; {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:724",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, {what}, "
                  f"dropout {DROP_RATE}")
        del q, k, v, fkw, pkw


def check_flash_bwd_dropout(torch, timer, results):
    """[3E] row 4d and [3G] row 4db: the backward's dropout branch (dQ
    and dK/dV kernels replaying the forward's mask) at the shapes of [3D]
    and [3F]; dQ, dK, dV (and dbias) against the plain version on the same
    seed words, a planted wrong seed that must fail, zero gradients past
    the lengths; timed with the plain version and with SDPA's backward at
    dropout_p 0.1 (its float mask's gradient included under the bias)."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd)
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    kw, drop = drop_kw(torch)
    for term, label, row in (("causal", "3E", "4d"), ("bias", "3G", "4db")):
        (q, k, v, do, mk, visible, causal, fkw, pkw, skw,
         what) = drop_inputs(torch, term, 75)
        name = "flash_attention_bwd" + ("_bias" if fkw else "") + "_dropout"
        log(f"[{label}] flash_attention bwd, dropout branch (row {row}, dQ "
            f"and dK/dV kernels): the shape of row {row.replace('4', '2')}")
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal, **mk, **fkw,
                           **kw)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, causal=causal,
                        **mk, **fkw, **kw)
        torch.cuda.synchronize()
        qs = (q.float() * (scale * LOG2E)).to(q.dtype)
        delta = (do.float() * o.float()).sum(dim=-1)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale,
                              causal=causal, **mk, **pkw, dropout=drop)
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV", "dbias"), got, ref):
            differ = int((a != r).sum())
            rtol = DBIAS_RTOL if gname == "dbias" else BWD_RTOL
            err = max(err, check(
                f"{name} {gname} ({differ} of {r.numel()} elements differ)",
                a, r, rtol * float(r.float().abs().max())))
        if mk:
            zero = ~visible.any(dim=2)
            check_zero_grads(name, got, zero, zero)
        wrong = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale,
                                causal=causal, **mk, **pkw,
                                dropout=planted_seed(torch)[1])
        must_differ(f"{name} dV", got[2], wrong[2],
                    BWD_RTOL * float(ref[2].float().abs().max()))
        del got, ref, wrong
        ms = timer(lambda: flash_bwd(q, k, v, o, lse, do, scale=scale,
                                     causal=causal, **mk, **fkw, **kw))
        plain_ms = timer(lambda: flash_bwd_plain(
            qs, k, v, do, lse, delta, scale=scale, causal=causal, **mk,
            **pkw, dropout=drop), reps=3)
        leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
        if "attn_mask" in skw:
            skw["attn_mask"].requires_grad_()
            leaves.append(skw["attn_mask"])
        out = F.scaled_dot_product_attention(
            *leaves[:3], dropout_p=DROP_RATE, scale=scale, enable_gqa=True,
            **skw)
        dot = do.transpose(1, 2).contiguous()
        library_ms = timer.events(lambda: torch.autograd.grad(
            out, leaves, dot, retain_graph=True))
        del out, leaves, dot, skw, o, lse
        pairs = int(visible.sum()) * hq
        rows = int(visible.any(dim=2).sum())
        flops, ops = 10 * d * pairs, HASH_OPS * pairs
        # Read Q, K, V over the valid rows, O and dO in full, LSE, the bias
        # once (4db); write dQ, dK, dV and (4db) the per-batch f32 dbias.
        nbytes = 2 * (rows * hq * d + 2 * rows * hkv * d) \
            + 2 * 2 * b * s * hq * d + 4 * b * hq * s \
            + 2 * b * s * (hq + 2 * hkv) * d \
            + (fkw["bias"].numel() * 4 + 4 * b * hq * s * s if fkw else 0)
        b_ms, b_by = bound_ms_mixed(nbytes, [(flops, BF16_FLOPS),
                                             (ops, F32_FLOPS)])
        log(f"  {name} (row {row}): kernels {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA backward with dropout_p {DROP_RATE} "
            f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops / 1e9:.1f} GFLOP, {ops / 1e9:.2f} G hash operations; "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1477",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16, {what}, "
                  f"dropout {DROP_RATE}")
        del q, k, v, do, fkw, pkw


def check_dropout_variants(torch) -> None:
    """[3H] the dropout branches at small shapes, forward (O, LSE) and
    backward (dQ, dK, dV, dbias) against the plain versions: f32, D 64
    and 256, GQA groups of 4 and 8, padding with fully masked rows,
    segment ids, a window with a sink, the bottom-right offset, a bias,
    ALiBi, the reference's small explicit tiles, rate 0.5 and seed words
    of 2^31 and above."""
    from transformerengine_tpu_torch.flex_attention import AlibiMod
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, Dropout, flash_bwd, flash_bwd_plain, flash_fwd,
        flash_fwd_plain)
    log("[3H] flash attention's dropout at small shapes, forward and "
        "backward")
    g = torch.Generator(device="cuda").manual_seed(76)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, mask, term, rate,
    # block_q, block_k, seed words)
    cases = (
        (bf16, 96, 96, 64, 4, 2, True, None, None, None, None, 0.1, 32, 64,
         DROP_WORDS),
        (f32, 100, 100, 128, 8, 2, False, None, None, (100, 41), "bias",
         0.3, 16, 32, (-1, -(2 ** 31))),
        (bf16, 130, 130, 256, 4, 1, True, (24, 0), "learnable", (130, 70),
         None, 0.2, 512, 1024, DROP_WORDS),
        (bf16, 80, 80, 64, 16, 2, True, None, None, "packed", None, 0.1, 512,
         1024, (5, 7)),
        (f32, 70, 90, 64, 16, 2, True, None, "off_by_one", None, "alibi",
         0.5, 512, 1024, DROP_WORDS),
        (bf16, 64, 64, 128, 32, 8, False, None, None, (64, 17), "bias", 0.1,
         8, 16, DROP_WORDS))
    for (dt, sq, skv, d, hq, hkv, causal, window, sink, mask, term, rate,
         bq, bk, words) in cases:
        q, do = randn(2, sq, hq, d, dtype=dt), randn(2, sq, hq, d, dtype=dt)
        k, v = randn(2, skv, hkv, d, dtype=dt), randn(2, skv, hkv, d,
                                                      dtype=dt)
        s0 = (None if sink is None else torch.zeros(hq, device="cuda")
              if sink == "off_by_one" else randn(hq) * 2)
        mk, qzero, kzero = variant_mask(torch, g, mask, 2, sq, skv)
        offset = skv - sq if causal else 0
        scale = d ** -0.5
        kw, pkw = {}, {}
        if term == "bias":
            bias = randn(1, hq, sq, skv) * 2
            kw, pkw = dict(bias=bias), dict(bias=bias)
        elif term == "alibi":
            mod = AlibiMod(hq)
            kw = dict(score_mod=mod)
            pkw = dict(alibi_slopes=mod.slopes(hq, "cuda"))
        seed = drop_seed(torch, words)
        dkw = dict(dropout_probability=rate, dropout_seed=seed, block_q=bq,
                   block_k=bk)
        drop = Dropout(seed, rate, bq, bk)
        base = dict(causal=causal, offset=offset, window=window or (-1, -1),
                    **mk)
        o, lse = flash_fwd(q, k, v, scale=scale, softmax_sink=s0, **base,
                           **kw, **dkw)
        qs = q if term == "alibi" else (q.float() * (scale * LOG2E)).to(dt)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, softmax_sink=s0,
                                         scale=scale, dropout=drop, **base,
                                         **pkw)
        name = (f"{dt} Sq={sq} Skv={skv} D={d} G={hq // hkv} causal="
                f"{causal} window={window} sink={sink} mask={mask} term="
                f"{term} rate={rate} tiles {bq}x{bk} seed {words}")
        tol = 1e-4 if dt == f32 else row_tol(o_ref, BF16_ROW_RTOL)
        check(f"fwd {name} O", o, o_ref, tol)
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, softmax_sink=s0,
                        **base, **kw, **dkw)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale,
                              dropout=drop, **base, **pkw)
        for gname, a, r in zip(("dQ", "dK", "dV", "dbias"), got, ref):
            rel = (1e-4 if dt == f32 else BWD_RTOL) if gname != "dbias" \
                else DBIAS_RTOL
            check(f"bwd {name} {gname}", a, r,
                  rel * float(r.float().abs().max()))
        check_zero_grads(f"bwd {name}", got, qzero, kzero)


# Phase 23: dropout in training at LLAMA_8B width, 4 layers, B 2, S 2048,
# every rate 0.1 (attention, hidden and drop path).
DROP_LAYERS = 4
DROP_STEPS = 3
# With no stored mask the dropout encoder's peak stays within this of the
# same stack's step without dropout (a (B, Hq, S, S) bool mask would add
# 256 MiB a layer).
DROP_PEAK_GIB = 0.5


def causal_stack(torch, layers: int, device, seed: int, **dropout):
    """``layers`` causal TransformerLayers at LLAMA_8B width with RoPE,
    RMSNorm and SwiGLU (a Llama decoder block's options) and ``dropout``,
    as a ModuleList."""
    from transformerengine_tpu_torch.attention import AttnMaskType
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    from transformerengine_tpu_torch.nn.transformer import TransformerLayer
    cfg = LLAMA_8B
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.nn.ModuleList(
        TransformerLayer(cfg.hidden_size, cfg.intermediate_size,
                         cfg.num_attention_heads,
                         num_gqa_groups=cfg.num_kv_heads,
                         layernorm_epsilon=cfg.norm_eps, norm_type="rmsnorm",
                         mlp_activations=("silu", "linear"),
                         self_attn_mask_type=AttnMaskType.CAUSAL,
                         enable_rotary_pos_emb=True, device=device,
                         generator=g, **dropout)
        for _ in range(layers))


def train_dropout(torch, results) -> None:
    """Phase 23: SGD steps with every dropout rate at 0.1 (attention,
    hidden, drop path), training calls drawing from one card generator:
    phase 21's encoder stack in bf16 beside the same stack's step without
    dropout (ms/step, tok/s, peak memory, the busy share of a profiled
    step; the peaks within DROP_PEAK_GIB of each other, as no mask is
    stored), then a causal RoPE stack under DelayedScaling(fp8_dpa=True,
    fp8_mha=True), where dropout alone closes the FP8 attention gates.
    Exact launch counts: a dropout forward, dQ and dK/dV per layer per
    step (the encoder's with its bias), and no FP8 flash launch."""
    from transformerengine_tpu_torch import DelayedScaling
    b, s, layers = TRAIN_B, TRAIN_S, DROP_LAYERS
    rates = dict(attention_dropout=DROP_RATE, hidden_dropout=DROP_RATE,
                 drop_path=DROP_RATE)
    log(f"[23] dropout training: LLAMA_8B width, {layers} TransformerLayers, "
        f"B={b} S={s}, attention, hidden and drop-path dropout {DROP_RATE}, "
        f"read-out loss, SGD at lr {TRAIN_LR}: the encoder (bf16, beside its "
        f"step without dropout), then a causal RoPE stack under "
        f"DelayedScaling(fp8_dpa, fp8_mha)")
    gen = torch.Generator(device=CARD).manual_seed(23)
    train_kw = dict(deterministic=False, generator=gen)
    x, desc, r, n_valid = encoder_batch(torch, b, s, ENC_LENS, CARD,
                                        ENC_SEED)
    totals = collections.Counter()
    stats = {}
    runs = (("encoder_no_dropout", "encoder", None, {}, 2,
             {f"flash_attention_{k}_bias": layers
              for k in ("fwd", "bwd_dq", "bwd_dkv")}),
            ("encoder_dropout", "encoder", None, train_kw, DROP_STEPS,
             {f"flash_attention_{k}_bias_dropout": layers
              for k in ("fwd", "bwd_dq", "bwd_dkv")}),
            ("causal_delayed_mha", "causal",
             DelayedScaling(amax_history_len=16, fp8_dpa=True, fp8_mha=True),
             train_kw, DROP_STEPS,
             {f"flash_attention_{k}_dropout": layers
              for k in ("fwd", "bwd_dq", "bwd_dkv")}))
    for name, kind, recipe, kw, steps, expect in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if kind == "encoder":
            stack = encoder_stack(torch, layers, CARD, ENC_SEED,
                                  **(rates if kw else {}))
            desc_used = desc
        else:
            stack = causal_stack(torch, layers, CARD, ENC_SEED, **rates)
            desc_used = None

        def step():
            return train_step(torch, stack, x, None, recipe,
                              loss_fn=lambda m, t, _: encoder_loss(
                                  m, t, desc_used, r, n_valid, **kw))
        losses, times, counts = timed_steps(
            torch, lambda: float(step()), expect, steps, "step")
        if kw:
            totals.update(counts)
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        st = dict(ms_per_step=step_ms, tok_per_s=b * s / (step_ms / 1e3),
                  losses=losses, peak_gib=peak)
        log(f"  {name} {recipe}: losses {[round(v, 5) for v in losses]} (all "
            f"finite); launches per step {expect} in every step ok")
        log(f"    step times {[round(t * 1e3, 2) for t in times]} ms; median "
            f"of steps 2-{steps} {step_ms:.2f} ms/step, "
            f"{st['tok_per_s']:.0f} tok/s, peak {peak:.2f} GiB")
        if kw:
            busy, wall, kernels = device_profile(torch, step, 1)
            log_profile(f"{name} step", st, busy, wall, kernels, 1)
        stats[name] = st
        del stack
    grown = stats["encoder_dropout"]["peak_gib"] - \
        stats["encoder_no_dropout"]["peak_gib"]
    ratio = stats["encoder_dropout"]["ms_per_step"] / \
        stats["encoder_no_dropout"]["ms_per_step"]
    ok = grown <= DROP_PEAK_GIB
    log(f"  the dropout encoder's step: {ratio:.3f}x the step without "
        f"dropout, peak {grown:+.3f} GiB (limit {DROP_PEAK_GIB}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dropout grew the encoder's peak by {grown} GiB")
    stats["encoder_dropout_ratio"] = ratio
    for kernel, n in totals.items():
        add_launches(results, bwd_row(kernel), n)
    results["_train_dropout"] = stats


# Phase 24: the dropout step, card against CPU: phase 22's encoder (2
# layers at LLAMA_8B width, B 1, S 256 with 200 valid, the relative bias,
# bf16) with attention dropout at 0.1 on the same seed words on both
# sides (the masks are equal bit for bit), so phase 22's limits hold.
DROP_VS_CPU_WORDS = ((0x13572468, -0x2468ACE0), (0x7FFFFFFF, 0x0BADF00D))


def dropout_card_vs_cpu(torch) -> list:
    """Phase 24's check; returns what failed. Each layer's attention
    takes the seed words of DROP_VS_CPU_WORDS in place of its generator's
    draw. Planted faults: the card's words off by one (another mask), and
    the backward kernels given no dropout (the mask not replayed); each
    must fail a limit."""
    import contextlib
    from transformerengine_tpu_torch.nn import transformer as tr
    from transformerengine_tpu_torch.ops import flash_attention as fa
    s, n = ENC_VS_CPU_S, ENC_VS_CPU_LEN
    log(f"[24] dropout step, card against CPU: 2 encoder layers at LLAMA_8B "
        f"width, B=1 S={s} ({n} valid), the relative bias, attention "
        f"dropout {DROP_RATE} on the seed words {DROP_VS_CPU_WORDS}, bf16")
    t0 = time.perf_counter()

    @contextlib.contextmanager
    def words(offset=0):
        real = tr.draw_seed
        it = iter(DROP_VS_CPU_WORDS)
        tr.draw_seed = lambda generator: fa.dropout_seed(
            [w + offset for w in next(it)])
        try:
            yield
        finally:
            tr.draw_seed = real

    def readings(device, start=None, offset=0):
        stack = encoder_stack(torch, 2, device, ENC_VS_CPU_SEED,
                              attention_dropout=DROP_RATE)
        if start is not None:
            stack.load_state_dict(start)
        x, desc, r, n_valid = encoder_batch(torch, 1, s, (n,), device,
                                            ENC_VS_CPU_SEED)
        stack.zero_grad(set_to_none=True)
        y = x
        with words(offset):
            for layer in stack:
                y = layer(y, desc, deterministic=False,
                          generator=torch.Generator(device=device))
        loss = (y.float() * r).sum() / n_valid
        loss.backward()
        size = float((y.detach().float() * r).norm()) / n_valid
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in stack.named_parameters()}
        return float(loss.detach()), size, grads, {
            k: v.cpu() for k, v in stack.state_dict().items()}

    loss_c, size, grads_c, start = readings("cpu")

    def differences(loss, grads) -> dict:
        out = dict(loss=abs(loss - loss_c) / size, gnorm=0.0, grad=0.0,
                   rel=0.0)
        for k, ref in grads_c.items():
            diff = grads[k] - ref
            gn = float(diff.norm() / ref.norm().clamp_min(1e-30))
            if gn > out["gnorm"]:
                out["gnorm"], out["gnorm_of"] = gn, k
            out["grad"] = max(out["grad"], float(
                diff.abs().max() / ref.abs().max().clamp_min(1e-30)))
            if k.endswith("rel_embedding"):
                out["rel"] = max(out["rel"], gn)
        return out

    def fmt(d) -> str:
        return ", ".join(f"{k} {d[k]:.3e}" for k in ENC_VS_CPU_LIMITS) + \
            f" (gnorm of {d.get('gnorm_of')})"

    def card(offset=0):
        loss, _, grads, _ = readings(CARD, start, offset)
        return differences(loss, grads)

    got = card()
    planted = {"the card's seed words off by one": card(offset=1)}
    real_bwd = fa.flash_bwd

    def no_replay(*a, **kw):
        kw.pop("dropout_probability", None)
        return real_bwd(*a, **kw)
    fa.flash_bwd = no_replay
    try:
        planted["the mask not replayed in the backward"] = card()
    finally:
        fa.flash_bwd = real_bwd
    limits = ENC_VS_CPU_LIMITS
    ok = all(got[k] <= limits[k] for k in limits)
    log(f"    ({time.perf_counter() - t0:.1f} s) limits "
        + ", ".join(f"{k} {v:.3e}" for k, v in limits.items()))
    log(f"    card against CPU: {fmt(got)} {'ok' if ok else 'FAIL'}")
    failures = [] if ok else ["dropout bf16"]
    for what, diff in planted.items():
        caught = [k for k in limits if not diff[k] <= limits[k]]
        log(f"    planted fault '{what}': {fmt(diff)}: "
            + (f"caught by {', '.join(caught)}" if caught else "NOT CAUGHT"))
        if not caught:
            failures.append(f"dropout: '{what}' not caught")
    return failures


# ---------------------------------------------------------------------------
# The soft cap and FP8 dropout: phase 3's rows [3I]-[3M] and phase 25
# (flex_attention at LLAMA_8B width)
# ---------------------------------------------------------------------------

# Gemma-2's published attention logit cap, at phase 6's causal training
# attention (rows 2c and 4c); dropout on FP8 Q/K/V (rows 2fd, 2od, 4fd,
# 4od) takes row 2f's shape and DROP_RATE from DROP_WORDS.
SOFT_CAP = 50.0
# The standard deviation of the rows' scores q . k * scale: q and k are
# drawn with CAP_SPREAD ** 0.5 where tanh bends (scores of std 1 would
# leave a cap of 50 all but linear, and a wrong cap would go unseen).
CAP_SPREAD = 20.0
# f32 operations of the cap per visited score, each counted as one at the
# CUDA cores' rate (the product with the scale, the division, tanh, the
# products with the cap and log2(e)): the least the forward does. The
# backward needs them once a score and the derivative's six (cap * ds,
# 1 - t, two products, the sum and the division); that its dQ and dK/dV
# kernels each compute them again is a cost of their design, which the
# bound does not count.
CAP_OPS = 5
CAP_GRAD_OPS = 6


def cap_inputs(torch, seed: int, shape=None, dtype=None):
    """Seeded Q, K (scores of std CAP_SPREAD), V and dO at ``shape`` (B,
    S, Hq, Hkv, D; FP8_SHAPE by default), bf16 by default."""
    b, s, hq, hkv, d = shape or FP8_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    spread = CAP_SPREAD ** 0.5

    def randn(*sh, m=1.0):
        return (torch.randn(sh, generator=g, device="cuda") * m).to(
            dtype or torch.bfloat16)
    return (randn(b, s, hq, d, m=spread), randn(b, s, hkv, d, m=spread),
            randn(b, s, hkv, d), randn(b, s, hq, d))


_FLEX_LIBRARY = []


def flex_library(torch, q, k, v, scale):
    """PyTorch's own ``flex_attention`` on rows 2c and 4c's inputs: the
    soft cap as its score mod, a causal block mask, GQA, compiled by
    ``torch.compile`` (its Triton kernels; eager it would materialize the
    scores). The library column of those rows, timed here and used
    nowhere in the port. Returns a call on (B, H, S, D) copies of q, k, v
    that require a gradient, and the copies; the compiled function is
    built once (inductor's caches under the build directory, compiled in
    this process)."""
    import os
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention)
    if not _FLEX_LIBRARY:
        cache = HERE / "transformerengine_tpu_torch" / "_build"
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              str(cache / "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
        import torch._inductor.config as inductor_config
        inductor_config.compile_threads = 1
        s = q.shape[1]
        mask = create_block_mask(lambda b, h, qi, ki: ki <= qi, None, None,
                                 s, s, device="cuda")
        _FLEX_LIBRARY.append((torch.compile(flex_attention, dynamic=False),
                              mask))
    fn, mask = _FLEX_LIBRARY[0]

    def soft_cap(score, b, h, qi, ki):
        return SOFT_CAP * torch.tanh(score / SOFT_CAP)
    ts = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    return (lambda: fn(*ts, score_mod=soft_cap, block_mask=mask,
                       scale=scale, enable_gqa=True)), ts


def check_flash_softcap(torch, timer, results):
    """[3I] row 2c: the forward's soft-cap branch at phase 6's causal
    training shape (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16) with the cap
    at 50, against its plain version (tanhf on both sides, so O meets row
    2's bf16 tolerance), a planted wrong cap (45) that must fail; timed
    with the plain version and PyTorch's compiled ``flex_attention``
    (:func:`flex_library`), whose O is held to the same tolerance."""
    from transformerengine_tpu_torch.flex_attention import SoftCapMod
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_plain)
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    name = "flash_attention_fwd_softcap"
    log(f"[3I] flash_attention fwd, soft-cap branch (row 2c): B={b} S={s} "
        f"Hq={hq} Hkv={hkv} D={d} bf16, causal, cap {SOFT_CAP}, scores of "
        f"std {CAP_SPREAD}")
    q, k, v, _ = cap_inputs(torch, 77)
    kw = dict(scale=scale, causal=True, score_mod=SoftCapMod(SOFT_CAP))
    o, lse = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal=True, scale=scale,
                                     soft_cap=SOFT_CAP)
    tol = row_tol(o_ref, BF16_ROW_RTOL)
    err = check(f"{name} O", o, o_ref, tol)
    check(f"{name} LSE", lse, lse_ref, LSE_ATOL)
    wrong = flash_fwd_plain(q, k, v, causal=True, scale=scale,
                            soft_cap=0.9 * SOFT_CAP)[0]
    must_differ(f"{name} O", o, wrong, tol, f"the cap {0.9 * SOFT_CAP}")
    t0 = time.perf_counter()
    lib, _ = flex_library(torch, q, k, v, scale)
    o_lib = lib().detach().transpose(1, 2)
    torch.cuda.synchronize()
    log(f"  PyTorch's flex_attention compiled and run in "
        f"{time.perf_counter() - t0:.1f} s")
    check("flex_attention (PyTorch's, compiled) O", o_lib, o_ref, tol)
    del o, lse, o_ref, lse_ref, wrong, o_lib
    # With the inputs' gradients on, as row 4c's backward needs: one
    # compiled graph for both rows.
    library_ms = timer.events(lib)
    ms = timer(lambda: flash_fwd(q, k, v, **kw))
    plain_ms = timer(lambda: flash_fwd_plain(
        q, k, v, causal=True, scale=scale, soft_cap=SOFT_CAP), reps=3)
    pairs = b * hq * s * (s + 1) // 2
    flops, ops = 4 * d * pairs, CAP_OPS * pairs
    # Q, K and V read once; O and LSE written.
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d) + 4 * b * hq * s
    b_ms, b_by = bound_ms_mixed(nbytes, [(flops, BF16_FLOPS),
                                         (ops, F32_FLOPS)])
    log(f"  {name} (row 2c): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"PyTorch's compiled flex_attention {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} GFLOP at the bf16 peak "
        f"and {ops / 1e9:.2f} G cap operations at the CUDA cores' rate; "
        f"{nbytes / 1e6:.1f} MB)")
    results[name] = dict(
        name=name, route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:724",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal, soft cap "
              f"{SOFT_CAP}")


def check_flash_bwd_softcap(torch, timer, results):
    """[3J] row 4c: the backward's soft-cap branch (dQ and dK/dV kernels)
    at row 2c's shape, against its plain version; a planted wrong cap
    must fail (the derivative's form, which the bf16 tolerance cannot
    see, is held bit for bit on the CPU by
    tests/test_torch_softcap_kernels.py); timed with the plain version and
    the backward of PyTorch's compiled ``flex_attention``
    (:func:`flex_library`), whose gradients are held to the same
    tolerances."""
    from transformerengine_tpu_torch.flex_attention import SoftCapMod
    from transformerengine_tpu_torch.ops import flash_attention as fa
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    name = "flash_attention_bwd_softcap"
    log(f"[3J] flash_attention bwd, soft-cap branch (row 4c, dQ and dK/dV "
        f"kernels): the shape of row 2c")
    q, k, v, do = cap_inputs(torch, 78)
    kw = dict(scale=scale, causal=True, score_mod=SoftCapMod(SOFT_CAP))
    o, lse = fa.flash_fwd(q, k, v, **kw)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    delta = (do.float() * o.float()).sum(dim=-1)

    def plain(cap=SOFT_CAP):
        return fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=scale,
                                  causal=True, soft_cap=cap)
    ref = plain()
    err, tols = 0.0, []
    for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
        tols.append(BWD_RTOL * float(r.float().abs().max()))
        err = max(err, check(f"{name} {gname} ({int((a != r).sum())} of "
                             f"{r.numel()} elements differ)", a, r, tols[-1]))
    must_differ(f"{name} dQ", got[0], plain(0.9 * SOFT_CAP)[0], tols[0],
            f"the cap {0.9 * SOFT_CAP}")
    lib, leaves = flex_library(torch, q, k, v, scale)
    out = lib()
    dot = do.transpose(1, 2).contiguous()
    for gname, a, r, t in zip(("dQ", "dK", "dV"), torch.autograd.grad(
            out, leaves, dot, retain_graph=True), ref, tols):
        check(f"flex_attention (PyTorch's, compiled) {gname}",
              a.transpose(1, 2), r, t)
    library_ms = timer.events(lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True))
    del got, ref, out, leaves, dot
    ms = timer(lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw))
    plain_ms = timer(plain, reps=3)
    pairs = b * hq * s * (s + 1) // 2
    flops = 10 * d * pairs
    ops = (CAP_OPS + CAP_GRAD_OPS) * pairs
    # Read Q, K, V, O, dO and LSE; write dQ, dK and dV.
    nbytes = 2 * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s
    b_ms, b_by = bound_ms_mixed(nbytes, [(flops, BF16_FLOPS),
                                         (ops, F32_FLOPS)])
    log(f"  {name} (row 4c): kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"the backward of PyTorch's compiled flex_attention {library_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.1f} "
        f"GFLOP, {ops / 1e9:.2f} G cap operations; {nbytes / 1e6:.1f} MB)")
    results[name] = dict(
        name=name, route="cuda",
        source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="transformerengine_tpu/ops/flash_attention.py:1477",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal, soft cap "
              f"{SOFT_CAP}")


def check_flash_fp8_dropout(torch, timer, results):
    """[3K] rows 2fd and 2od: the FP8 forward with dropout at row 2f's
    shape (e4m3 Q/K/V, causal, rate 0.1 on DROP_WORDS), O in bf16 and
    through the fp8 O epilogue, each against its plain version on the same
    seed words, a planted wrong seed word that must fail, the keep share;
    timed with the plain version and SDPA at dropout_p 0.1 on the
    dequantized bf16 Q/K/V."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_plain, fp8_fwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    kw_d, drop = drop_kw(torch)
    bad = planted_seed(torch)[1]
    log(f"[3K] flash_attention fwd, FP8 with dropout (rows 2fd and 2od): "
        f"B={b} S={s} Hq={hq} Hkv={hkv} D={d}, causal, e4m3 Q/K/V, rate "
        f"{DROP_RATE}, seed words {DROP_WORDS}; O in bf16 and through the "
        f"fp8 O epilogue")
    _, (qd, kd, vd), sinv = fp8_inputs(torch, 33)
    kw = dict(scale=scale, causal=True, scale_invs=sinv, **kw_d)
    sc = fp8_fwd_scales(sinv, scale)
    o, lse = flash_fwd(qd, kd, vd, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_fwd_plain(qd, kd, vd, causal=True, fp8_scales=sc,
                                     out_dtype=torch.bfloat16, dropout=drop)
    tol = row_tol(o_ref, BF16_ROW_RTOL)
    err_f = check("flash_attention_fwd_fp8_dropout O (bf16)", o, o_ref, tol)
    check("flash_attention_fwd_fp8_dropout LSE", lse, lse_ref, LSE_ATOL)
    must_differ("flash_attention_fwd_fp8_dropout O", o, flash_fwd_plain(
        qd, kd, vd, causal=True, fp8_scales=sc, out_dtype=torch.bfloat16,
        dropout=bad)[0], tol, "a seed word off by one")
    amax = o_ref.float().abs().amax() * FP8_O_HEADROOM
    oscale = compute_scale_from_amax(amax, torch.float8_e4m3fn).reshape(1)
    sc8 = fp8_fwd_scales(sinv, scale, oscale)
    o8, _, am = flash_fwd(qd, kd, vd, out_dtype=torch.float8_e4m3fn,
                          out_scale=oscale, **kw)
    torch.cuda.synchronize()
    o8_ref, _, am_ref = flash_fwd_plain(qd, kd, vd, causal=True,
                                        fp8_scales=sc8,
                                        out_dtype=torch.float8_e4m3fn,
                                        dropout=drop)
    err_o = check_fp8_o(torch, "flash_attention_fwd_fp8_mha_dropout O", o8,
                        o8_ref)
    check("flash_attention_fwd_fp8_mha_dropout O amax", am, am_ref,
          2 ** -8 * float(am_ref))
    del o, lse, o_ref, lse_ref, o8, o8_ref
    pos = torch.arange(s, device="cuda")
    check_keep_rate(torch, b, hq, hkv, s,
                    (pos[:, None] >= pos[None, :]).expand(b, s, s),
                    "flash_attention_fwd_fp8_dropout")
    ms_f = timer(lambda: flash_fwd(qd, kd, vd, **kw))
    ms_o = timer(lambda: flash_fwd(qd, kd, vd, out_dtype=torch.float8_e4m3fn,
                                   out_scale=oscale, **kw))
    plain_f = timer(lambda: flash_fwd_plain(
        qd, kd, vd, causal=True, fp8_scales=sc, out_dtype=torch.bfloat16,
        dropout=drop), reps=3)
    plain_o = timer(lambda: flash_fwd_plain(
        qd, kd, vd, causal=True, fp8_scales=sc8,
        out_dtype=torch.float8_e4m3fn, dropout=drop), reps=3)
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           for t, si in zip((qd, kd, vd), sinv.unbind())]
    library_ms = timer.events(lambda: F.scaled_dot_product_attention(
        *deq, is_causal=True, dropout_p=DROP_RATE, scale=scale,
        enable_gqa=True))
    del deq
    pairs = b * hq * s * (s + 1) // 2
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    prods = [(2 * d * pairs, FP8_FLOPS), (2 * d * pairs, BF16_FLOPS),
             (HASH_OPS * pairs, F32_FLOPS)]
    for name, ms, plain_ms, o_bytes, err, row in (
            ("flash_attention_fwd_fp8_dropout", ms_f, plain_f, 2, err_f,
             "2fd"),
            ("flash_attention_fwd_fp8_mha_dropout", ms_o, plain_o, 1, err_o,
             "2od")):
        nbytes = q_el + 2 * kv_el + o_bytes * q_el + 4 * b * hq * s
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name} (row {row}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, SDPA with dropout_p {DROP_RATE} on the dequantized bf16 "
            f"Q/K/V {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{4 * d * pairs / 1e9:.2f} GFLOP, {HASH_OPS * pairs / 1e9:.2f} G "
            f"hash operations, {nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:2057",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} e4m3 causal,"
                  f" O {'bf16' if o_bytes == 2 else 'e4m3'}, dropout "
                  f"{DROP_RATE}")


def check_flash_bwd_fp8_dropout(torch, timer, results):
    """[3L] rows 4fd and 4od: the FP8 backward with dropout at row 2fd's
    shape, a bf16 dO and e4m3 O with an e5m2 dO, each against its plain
    version on the same seed words, a planted wrong seed word that must
    fail; timed with the plain version and SDPA's backward at dropout_p
    0.1 on the dequantized bf16 tensors."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, fp8_bwd_scales)
    from transformerengine_tpu_torch.quantize.qmath import (
        compute_scale_from_amax)
    b, s, hq, hkv, d = FP8_SHAPE
    scale = d ** -0.5
    kw_d, drop = drop_kw(torch)
    bad = planted_seed(torch)[1]
    log(f"[3L] flash_attention bwd, FP8 with dropout (rows 4fd and 4od, dQ "
        f"and dK/dV kernels): the shape of row 2fd; bf16 dO, and e4m3 O with "
        f"e5m2 dO")
    (_, _, _, do), (qd, kd, vd), sinv = fp8_inputs(torch, 34)
    o, lse = flash_fwd(qd, kd, vd, scale=scale, causal=True, scale_invs=sinv,
                       **kw_d)
    oscale = compute_scale_from_amax(o.float().abs().amax(),
                                     torch.float8_e4m3fn).reshape(1)
    o8, _, _ = flash_fwd(qd, kd, vd, scale=scale, causal=True,
                         scale_invs=sinv, out_dtype=torch.float8_e4m3fn,
                         out_scale=oscale, **kw_d)
    (do8,), sdo = fp8_payloads(torch, (do,), torch.float8_e5m2)
    so = (1.0 / oscale).reshape(1)
    one = torch.ones((), device="cuda")
    kw = dict(scale=scale, causal=True, scale_invs=sinv,
              grad_dtype=torch.bfloat16, **kw_d)
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           .requires_grad_() for t, si in zip((qd, kd, vd), sinv.unbind())]
    out = F.scaled_dot_product_attention(*deq, is_causal=True,
                                         dropout_p=DROP_RATE, scale=scale,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = timer.events(lambda: torch.autograd.grad(
        out, deq, dot, retain_graph=True))
    del out, deq, dot
    pairs = b * hq * s * (s + 1) // 2
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    for name, row, o_in, do_in, extra, sdo_t, so_t in (
            ("flash_attention_bwd_fp8_dropout", "4fd", o, do, {}, one, None),
            ("flash_attention_bwd_fp8_mha_dropout", "4od", o8, do8,
             dict(o_scale_inv=so, do_scale_inv=sdo), sdo, so)):
        got = flash_bwd(qd, kd, vd, o_in, lse, do_in, **kw, **extra)
        torch.cuda.synchronize()
        delta = (do_in.float() * o_in.float()).sum(dim=-1)
        if so_t is not None:
            delta = delta * (so_t.reshape(()) * sdo_t.reshape(()))
        sc = fp8_bwd_scales(sinv, scale, sdo_t)

        def plain(dropout=drop):
            return flash_bwd_plain(qd, kd, vd, do_in, lse, delta, scale=scale,
                                   causal=True, fp8_scales=sc,
                                   grad_dtype=torch.bfloat16, dropout=dropout)
        ref = plain()
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            err = max(err, check(
                f"{name} {gname} ({int((a != r).sum())} of {r.numel()} "
                f"elements differ)", a, r,
                BWD_RTOL * float(r.float().abs().max())))
        must_differ(f"{name} dV", got[2], plain(bad)[2],
                BWD_RTOL * float(ref[2].float().abs().max()),
                "a seed word off by one")
        del got, ref
        ms = timer(lambda: flash_bwd(qd, kd, vd, o_in, lse, do_in, **kw,
                                     **extra))
        plain_ms = timer(plain, reps=3)
        fp8_do = so_t is not None
        n_fp8 = 2 if fp8_do else 1
        prods = [(n_fp8 * 2 * d * pairs, FP8_FLOPS),
                 ((5 - n_fp8) * 2 * d * pairs, BF16_FLOPS),
                 (HASH_OPS * pairs, F32_FLOPS)]
        io_bytes = 1 if fp8_do else 2
        nbytes = q_el + 2 * kv_el + 2 * io_bytes * q_el + 4 * b * hq * s \
            + 2 * (q_el + 2 * kv_el)
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name} (row {row}): kernels {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, SDPA backward with dropout_p {DROP_RATE} on dequantized "
            f"bf16 {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{10 * d * pairs / 1e9:.1f} GFLOP, "
            f"{HASH_OPS * pairs / 1e9:.2f} G hash operations, "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1477",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"training B={b} S={s} Hq={hq} Hkv={hkv} D={d} e4m3 causal,"
                  f" dO {'e5m2' if fp8_do else 'bf16'}, dropout {DROP_RATE}")


def check_softcap_variants(torch) -> None:
    """[3M] the soft cap at small shapes, forward (O, LSE) and backward
    (dQ, dK, dV) against the plain versions: f32, D 64, 128 and 256, GQA
    groups of 4, 8 and 16, padding with fully masked rows, segment ids, a
    window with a sink, the bottom-right offset, dropout with the cap,
    caps of 1 (saturated) and 1e4 (linear), and ALiBi with explicit
    slopes; then FP8 Q/K/V with dropout at small shapes (padding with
    fully masked rows, a window with a sink, GQA 8)."""
    from transformerengine_tpu_torch.flex_attention import (
        AlibiSlopesMod, SoftCapMod)
    from transformerengine_tpu_torch.ops.flash_attention import (
        Dropout, flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain)
    log("[3M] flash attention's soft cap and explicit ALiBi slopes at small "
        "shapes, forward and backward; FP8 Q/K/V with dropout")
    g = torch.Generator(device="cuda").manual_seed(79)
    f32, bf16 = torch.float32, torch.bfloat16
    # (dtype, Sq, Skv, D, Hq, Hkv, causal, window, sink, mask, term,
    # dropout (rate, block_q, block_k) or None)
    cases = (
        (f32, 96, 96, 64, 4, 1, True, None, None, None, 50.0, None),
        (bf16, 130, 130, 256, 8, 1, True, (24, 0), "learnable", (130, 70),
         30.0, None),
        (bf16, 80, 80, 128, 16, 1, True, None, None, "packed", 50.0,
         (0.1, 32, 64)),
        (f32, 64, 64, 64, 4, 2, False, None, None, (64, 17), 1.0, None),
        (bf16, 70, 90, 128, 8, 2, True, None, "off_by_one", None, 1e4,
         (0.2, 512, 1024)),
        (bf16, 96, 96, 64, 8, 2, True, None, None, None, "slopes", None))
    for (dt, sq, skv, d, hq, hkv, causal, window, sink, mask, term,
         dro) in cases:
        spread = CAP_SPREAD ** 0.5

        def randn(*shape, m=1.0):
            return (torch.randn(shape, generator=g, device="cuda") * m).to(dt)
        q, do = randn(2, sq, hq, d, m=spread), randn(2, sq, hq, d)
        k, v = randn(2, skv, hkv, d, m=spread), randn(2, skv, hkv, d)
        s0 = (None if sink is None else torch.zeros(hq, device="cuda")
              if sink == "off_by_one" else
              torch.randn(hq, generator=g, device="cuda") * 2)
        mk, qzero, kzero = variant_mask(torch, g, mask, 2, sq, skv)
        scale = d ** -0.5
        if term == "slopes":
            slopes = torch.rand(hq, generator=g, device="cuda") * 0.5
            kw, pkw = dict(score_mod=AlibiSlopesMod(slopes)), \
                dict(alibi_slopes=slopes)
        else:
            kw, pkw = dict(score_mod=SoftCapMod(term)), dict(soft_cap=term)
        dkw = {}
        if dro is not None:
            seed = drop_seed(torch)
            dkw = dict(dropout_probability=dro[0], dropout_seed=seed,
                       block_q=dro[1], block_k=dro[2])
            pkw["dropout"] = Dropout(seed, *dro)
        base = dict(causal=causal, offset=skv - sq if causal else 0,
                    window=window or (-1, -1), **mk)
        o, lse = flash_fwd(q, k, v, scale=scale, softmax_sink=s0, **base,
                           **kw, **dkw)
        o_ref, lse_ref = flash_fwd_plain(q, k, v, softmax_sink=s0,
                                         scale=scale, **base, **pkw)
        name = (f"{dt} Sq={sq} Skv={skv} D={d} G={hq // hkv} causal="
                f"{causal} window={window} sink={sink} mask={mask} term="
                f"{term} dropout={dro}")
        tol = 1e-4 if dt == f32 else row_tol(o_ref, BF16_ROW_RTOL)
        check(f"fwd {name} O", o, o_ref, tol)
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, softmax_sink=s0,
                        **base, **kw, **dkw)
        ref = flash_bwd_plain(q, k, v, do, lse, delta, scale=scale, **base,
                              **pkw)
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            check(f"bwd {name} {gname}", a, r,
                  (1e-4 if dt == f32 else BWD_RTOL)
                  * float(r.float().abs().max()))
        check_zero_grads(f"bwd {name}", got, qzero, kzero)
    # (Sq, D, Hq, Hkv, window, sink, lengths, O scale ratio)
    fp8_variants(torch, ((160, 64, 8, 2, None, False, (160, 77), 0.5),
                         (192, 64, 8, 1, (32, 0), True, (192, 50), 2.0)),
                 44, dropout=drop_kw(torch))


# Phase 25: flex_attention at LLAMA_8B width, phase 6's attention shape
# (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16), forward and backward.
FLEX_CALLS = 3
# The chunked impl's KV block in phase 25 (its smallest): the backward's
# per-block temporaries are (B, Hkv, G, S, block_k) f32, 64 MiB each.
FLEX_BLOCK_K = 128
# The relative bias's table: the T5 encoder's 32 heads and a reach of 128
# keys each way.
FLEX_REL_DIST = 128
# The chunked relative-bias call's peak above what was allocated before
# it (q, k, v, dO and the table in bf16): a materialized backward would
# hold the (2, 32, 2048, 2048) f32 scores, 1 GiB, and several tensors of
# that size beside them.
FLEX_PEAK_GIB = 0.75
# Chunked (f32 throughout) against flash (p and ds rounded to bf16 before
# their products), relative to each output's largest |value|: the flash
# row's bf16 tolerance of O, and 2^-5 for the gradients, whose bf16 ds of
# both kernels meet 2^-6 against their own plain version.
FLEX_RTOL, FLEX_GRAD_RTOL = 2 ** -6, 2 ** -5
# Card against CPU at a small shape (B 1, S 256, Hq 8, Hkv 2, D 64, the
# scores' spread of the rows): f32 impls 1e-4 of the largest |value|
# (summation order, tanh's few ulps); the flash impl and the FP8 op in
# bf16 at the bf16 rows' tolerance.
FLEX_VS_CPU = (1, 256, 8, 2, 64)
FLEX_VS_CPU_RTOL = 1e-4


def flex_call(torch, leaves, do, impl, mod, mask, **kw):
    """One forward and backward of ``flex_attention``: (O, [dQ, dK, dV,
    the mod's tensors' gradients])."""
    from transformerengine_tpu_torch.flex_attention import flex_attention
    tensors = mod.tensors() if hasattr(mod, "tensors") else ()
    for t in (*leaves, *tensors):
        t.grad = None
    o = flex_attention(*leaves, score_mod=mod, mask_mod=mask, impl=impl,
                       **kw)
    o.backward(do)
    return o.detach(), [t.grad for t in (*leaves, *tensors)]


def train_flex(torch, results) -> None:
    """Phase 25: ``flex_attention`` at LLAMA_8B width (phase 6's
    attention shape) forward and backward: ``impl="flash"`` with
    ``soft_cap_mod(50)`` and ``causal_mask_mod`` over FLEX_CALLS timed
    calls with exact launch counts (one soft-cap forward, dQ and dK/dV
    launch a call); ``impl="chunked"`` with the same mods against the
    flash impl on the card; ``impl="chunked"`` with
    ``relative_position_bias_mod`` (the table's gradient nonzero) under
    FLEX_PEAK_GIB; dropout on FP8 Q/K/V through ``flash_attention``
    (:func:`fp8_dropout_path`); then the card against the CPU at a small
    shape for each impl and for the FP8 op with dropout. ms per call, busy
    share and peak GiB."""
    from transformerengine_tpu_torch.flex_attention import (
        causal_mask_mod, relative_position_bias_mod, soft_cap_mod)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[25] flex_attention at LLAMA_8B width: B={b} S={s} Hq={hq} "
        f"Hkv={hkv} D={d} bf16, scores of std {CAP_SPREAD}, forward and "
        f"backward: flash and chunked with soft_cap_mod({SOFT_CAP}) and "
        f"causal_mask_mod, chunked with relative_position_bias_mod "
        f"(block_k {FLEX_BLOCK_K})")
    q, k, v, do = cap_inputs(torch, 25)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cap = soft_cap_mod(SOFT_CAP)
    expect = {f"flash_attention_{n}_softcap": 1
              for n in ("fwd", "bwd_dq", "bwd_dkv")}
    outs, times, counts = timed_steps(
        torch, lambda: flex_call(torch, leaves, do, "flash", cap,
                                 causal_mask_mod), expect, FLEX_CALLS,
        "flex_attention(impl=\"flash\") call")
    for kernel, n in counts.items():
        add_launches(results, bwd_row(kernel), n)
    stats = dict(flash_ms=statistics.median(times[1:]) * 1e3)
    o_f, g_f = outs[-1]
    log(f"  flash: call times {[round(t * 1e3, 2) for t in times]} ms, "
        f"median of calls 2-{FLEX_CALLS} {stats['flash_ms']:.2f} ms; "
        f"launches per call {expect} in every call ok")

    def profiled(label, key, fn, held=()):
        """ms and peak of a call of ``fn`` after a first one (first-use
        costs; its gradients on ``leaves`` and ``held`` are let go before
        the peak's base), then the busy share of a third; returns the
        timed call's outputs."""
        fn()
        for t in (*leaves, *held):
            t.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stats[key + "_ms"] = (time.perf_counter() - t0) * 1e3
        stats[key + "_peak_gib"] = \
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        busy, wall, kernels = device_profile(torch, fn, 1)
        prof = {}
        log_profile(f"{label} call", prof, busy, wall, kernels, 1)
        stats[key + "_profile"] = prof.get("profile")
        return out

    profiled("flash", "flash", lambda: flex_call(
        torch, leaves, do, "flash", cap, causal_mask_mod))
    o_c, g_c = profiled("chunked", "chunked", lambda: flex_call(
        torch, leaves, do, "chunked", cap, causal_mask_mod,
        block_k=FLEX_BLOCK_K))
    check("chunked against flash O", o_c, o_f, row_tol(o_f, FLEX_RTOL))
    for gname, a, r in zip(("dQ", "dK", "dV"), g_c, g_f):
        check(f"chunked against flash {gname}", a, r,
              FLEX_GRAD_RTOL * float(r.float().abs().max()))
    del outs, o_f, g_f, o_c, g_c
    g = torch.Generator(device="cuda").manual_seed(26)
    table = (torch.randn((hq, 2 * FLEX_REL_DIST + 1), generator=g,
                         device="cuda") * 2).to(torch.bfloat16)
    table.requires_grad_()
    rel = relative_position_bias_mod(table)
    torch.cuda.empty_cache()
    o_r, g_r = profiled("chunked relative-bias", "chunked_rel",
                        lambda: flex_call(torch, leaves, do, "chunked", rel,
                                          causal_mask_mod,
                                          block_k=FLEX_BLOCK_K), (table,))
    peak, dtab = stats["chunked_rel_peak_gib"], g_r[3]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (o_r, *g_r))
    ok = finite and float(dtab.float().abs().max()) > 0 and \
        peak <= FLEX_PEAK_GIB
    log(f"  chunked, relative bias: peak {peak:.3f} GiB above its inputs "
        f"(limit {FLEX_PEAK_GIB}), the table's gradient largest "
        f"{float(dtab.float().abs().max()):.3e}, all finite {finite} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the chunked relative-bias call failed its "
                             "checks")
    del o_r, g_r, dtab
    log(f"  ms per call (forward and backward, after a first call): flash "
        f"{stats['flash_ms']:.2f}, chunked {stats['chunked_ms']:.2f}, "
        f"chunked with the relative bias {stats['chunked_rel_ms']:.2f}; "
        f"peak GiB above the inputs: flash {stats['flash_peak_gib']:.3f}, "
        f"chunked {stats['chunked_peak_gib']:.3f}, relative bias "
        f"{peak:.3f}")
    fp8_dropout_path(torch, results, q, k, v, do, stats)
    failures = flex_card_vs_cpu(torch)
    if failures:
        raise AssertionError(f"flex_attention, card against CPU: {failures}")
    results["_train_flex"] = stats


def fp8_dropout_path(torch, results, q, k, v, do, stats) -> None:
    """Phase 25's run of dropout on FP8 Q/K/V through ``flash_attention``
    (the entry point; the layers close their FP8 gates under dropout, as
    the reference's do) at phase 6's attention shape, causal, rate
    DROP_RATE on DROP_WORDS: ``qkv_quantizers`` under current scaling,
    then ``mha_proj`` under delayed scaling (the fp8 O epilogue, e5m2 dO),
    forward and backward, FLEX_CALLS calls each with exact launch counts."""
    from transformerengine_tpu_torch.attention import AttnMaskType
    from transformerengine_tpu_torch.ops.flash_attention import (
        dropout_seed, flash_attention)
    from transformerengine_tpu_torch.quantize.quantizer import (
        CurrentScaleQuantizer, DelayedScaleQuantizer, QuantizeLayout)
    e4m3, e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
    rowwise = QuantizeLayout.ROWWISE
    b, s, hq, hkv, d = FP8_SHAPE
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    g = torch.Generator(device="cuda").manual_seed(28)
    w = (torch.randn((hq * d, hq * d), generator=g, device="cuda")
         / (hq * d) ** 0.5).to(torch.bfloat16).requires_grad_()
    dout = torch.randn((b, s, hq * d), generator=g, device="cuda").to(
        torch.bfloat16)
    delayed = [DelayedScaleQuantizer(
        dt, rowwise, scale=torch.ones((1,), device="cuda"),
        amax_history=torch.zeros((16,), device="cuda"))
        for dt in (e4m3, e4m3, e4m3, e4m3, e4m3, e5m2, e5m2)]
    kw = dict(attn_mask_type=AttnMaskType.CAUSAL,
              dropout_probability=DROP_RATE,
              dropout_seed=dropout_seed(DROP_WORDS, "cuda"))
    runs = (("fp8_dpa", "qkv_quantizers", "_fp8_dropout",
             dict(qkv_quantizers=[CurrentScaleQuantizer(e4m3, rowwise)
                                  for _ in range(3)]), do),
            ("fp8_mha", "mha_proj", "_fp8_mha_dropout",
             dict(mha_proj=(w, delayed)), dout))
    for name, arg, branch, extra, grad in runs:
        def call():
            for t in (*leaves, w):
                t.grad = None
            out = flash_attention(*leaves, **kw, **extra)
            out.backward(grad)
            return out.detach()
        expect = {f"flash_attention_{n}{branch}": 1
                  for n in ("fwd", "bwd_dq", "bwd_dkv")}
        outs, times, counts = timed_steps(torch, call, expect, FLEX_CALLS,
                                          f"{name} with dropout call")
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (outs[-1], *(x.grad for x in leaves)))
        if not finite:
            raise AssertionError(f"{name} with dropout: not finite")
        for kernel, n in counts.items():
            add_launches(results, bwd_row(kernel), n)
        stats[name + "_dropout_ms"] = statistics.median(times[1:]) * 1e3
        log(f"  flash_attention({arg}=..., dropout {DROP_RATE}) ({name}), "
            f"forward and backward: "
            f"call times {[round(t * 1e3, 2) for t in times]} ms, launches "
            f"per call {expect} in every call, finite ok")


def flex_card_vs_cpu(torch) -> list:
    """Phase 25's card against CPU at FLEX_VS_CPU: each impl (flash with
    the cap and the causal mask, and with the causal mask alone; chunked
    and reference with the relative bias, the table's gradient included),
    and ``flash_attention`` on FP8
    Q/K/V (current scaling) with dropout at DROP_RATE on DROP_WORDS; O and
    every gradient. Returns what failed."""
    from transformerengine_tpu_torch.flex_attention import (
        causal_mask_mod, relative_position_bias_mod, soft_cap_mod)
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_attention)
    from transformerengine_tpu_torch.quantize.quantizer import (
        CurrentScaleQuantizer, QuantizeLayout)
    b, s, hq, hkv, d = FLEX_VS_CPU
    log(f"  card against CPU: B={b} S={s} Hq={hq} Hkv={hkv} D={d}")
    g = torch.Generator(device="cpu").manual_seed(27)
    spread = CAP_SPREAD ** 0.5
    base = [torch.randn(sh, generator=g) * m for sh, m in (
        ((b, s, hq, d), spread), ((b, s, hkv, d), spread), ((b, s, hkv, d), 1),
        ((b, s, hq, d), 1))]
    table = torch.randn((hq, 2 * 32 + 1), generator=g)
    failures = []

    def run(dev, dtype, fn):
        ts = [t.to(device=dev, dtype=dtype, copy=True) for t in base]
        leaves = [t.requires_grad_() for t in ts[:3]]
        o = fn(leaves, dev)
        o.backward(ts[3].to(o.dtype))
        return [o.detach()] + [t.grad for t in leaves]

    def flex(lv, impl, mod, **kw):
        from transformerengine_tpu_torch.flex_attention import flex_attention
        return flex_attention(*lv, score_mod=mod, mask_mod=causal_mask_mod,
                              impl=impl, **kw)

    tabs = {}

    def rel_case(impl):
        def fn(lv, dev):
            tabs[dev] = table.to(device=dev, copy=True).requires_grad_()
            return flex(lv, impl, relative_position_bias_mod(tabs[dev]),
                        block_k=128)
        return fn

    def fp8_case(lv, dev):
        from transformerengine_tpu_torch.attention import AttnMaskType
        from transformerengine_tpu_torch.ops.flash_attention import (
            dropout_seed)
        zs = [CurrentScaleQuantizer(torch.float8_e4m3fn,
                                    QuantizeLayout.ROWWISE)
              for _ in range(3)]
        return flash_attention(*lv, attn_mask_type=AttnMaskType.CAUSAL,
                               qkv_quantizers=zs,
                               dropout_probability=DROP_RATE,
                               dropout_seed=dropout_seed(DROP_WORDS, dev))

    # (what, dtype, tolerance, call)
    cases = (
        ("flash, soft cap and causal", torch.bfloat16, BWD_RTOL,
         lambda lv, dev: flex(lv, "flash", soft_cap_mod(SOFT_CAP))),
        ("flash, causal mask alone (ALiBi branch, zero slopes)",
         torch.bfloat16, BWD_RTOL, lambda lv, dev: flex(lv, "flash", None)),
        ("chunked, relative bias and causal", torch.float32,
         FLEX_VS_CPU_RTOL, rel_case("chunked")),
        ("reference, relative bias and causal", torch.float32,
         FLEX_VS_CPU_RTOL, rel_case("reference")),
        ("FP8 Q/K/V with dropout", torch.bfloat16, BWD_RTOL, fp8_case))
    for what, dtype, rtol, fn in cases:
        cpu = run("cpu", dtype, fn)
        card = run("cuda", dtype, fn)
        if "relative bias" in what:
            cpu.append(tabs["cpu"].grad)
            card.append(tabs["cuda"].grad)
        for gname, a, r in zip(("O", "dQ", "dK", "dV", "dtable"), card, cpu):
            r = r.float()
            used = float((a.float().cpu() - r).abs().max()
                         / r.abs().max().clamp_min(1e-30))
            ok = used <= rtol
            log(f"    {what} {gname}: {used:.3e} of the largest |CPU value| "
                f"(limit {rtol:.1e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{what} {gname}")
    return failures


# ---------------------------------------------------------------------------
# Context parallelism: the flash kernels' runtime positions (phase 3,
# [3N]-[3P]) and the ring, all-gather, Ulysses and hierarchical attention
# and the LlamaModel step on 4 gloo ranks of one card (phase 26)
# ---------------------------------------------------------------------------

# One rank's shard of LLAMA_8B's attention over S 8192 split 4 ways: B 1,
# L 2048, Hq 32, Hkv 8, D 128.
QOFF_SHAPE = (1, 2048, 32, 8, 128)
# A ring step on an earlier chunk: qoff = +2048, every key visible.
QOFF = 2048


def positions_row(torch, qoff: int, left: int = 0, right: int = 0):
    """The runtime positions as the ring passes them: the offset view of
    a (1, 3) int32 table [qoff, left, right] on the card."""
    table = torch.tensor([[qoff, left, right]], dtype=torch.int32,
                         device="cuda")
    return dict(q_position_offset=table[0, 0:1])


def qoff_inputs(torch, seed: int):
    """Row 2q's and 2fq's inputs: seeded bf16 Q, K, V and dO at
    QOFF_SHAPE, their e4m3 payloads and scales, and the dequantized bf16
    Q, K, V (BHSD) that SDPA takes for the FP8 rows."""
    (q, k, v, do), pays, sinv = fp8_inputs(torch, seed, QOFF_SHAPE)
    deq = [(t.float() * si).to(torch.bfloat16).transpose(1, 2).contiguous()
           for t, si in zip(pays, sinv.unbind())]
    return (q, k, v, do), pays, sinv, deq


def check_flash_qoff(torch, timer, results):
    """[3N] rows 2q and 2fq: the forward's runtime-position branch at one
    rank's shard of LLAMA_8B over S 8192 (B 1, L 2048, Hq 32, Hkv 8, D
    128, causal, qoff +2048 read on the card: every key visible), on bf16
    and on e4m3 Q/K/V (the FP8 ring's step), against its plain version
    with the same tensor offset, and O against the no-mask plain version;
    timed with the plain version and SDPA without a mask (on the
    dequantized tensors for 2fq)."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_fwd, flash_fwd_plain, fp8_fwd_scales)
    b, s, hq, hkv, d = QOFF_SHAPE
    scale = d ** -0.5
    log(f"[3N] flash_attention fwd, runtime positions (rows 2q, 2fq): B={b} "
        f"L={s} Hq={hq} Hkv={hkv} D={d}, causal, qoff +{QOFF} on the card "
        f"(a ring step on an earlier chunk); bf16 and e4m3 Q/K/V")
    (q, k, v, _), (qd, kd, vd), sinv, deq = qoff_inputs(torch, 91)
    pos = positions_row(torch, QOFF)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    sc = fp8_fwd_scales(sinv, scale)
    bf16 = dict(fwd=lambda: flash_fwd(q, k, v, scale=scale, causal=True,
                                      **pos),
                plain=lambda **kw: flash_fwd_plain(qs, k, v, **kw),
                lib=[t.transpose(1, 2).contiguous() for t in (q, k, v)],
                in_bytes=2, what="bf16")
    fp8 = dict(fwd=lambda: flash_fwd(qd, kd, vd, scale=scale, causal=True,
                                     scale_invs=sinv, **pos),
               plain=lambda **kw: flash_fwd_plain(
                   qd, kd, vd, fp8_scales=sc, out_dtype=torch.bfloat16, **kw),
               lib=deq, in_bytes=1, what="e4m3")
    pairs = b * hq * s * s
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    for name, c in (("flash_attention_fwd_qoff", bf16),
                    ("flash_attention_fwd_fp8_qoff", fp8)):
        o, lse = c["fwd"]()
        torch.cuda.synchronize()
        o_ref, lse_ref = c["plain"](causal=True, **pos)
        tol = row_tol(o_ref, BF16_ROW_RTOL)
        err = check(f"{name} O", o, o_ref, tol)
        check(f"{name} LSE", lse, lse_ref, LSE_ATOL)
        # Every key is visible: the plain version without a mask agrees.
        check(f"{name} O against no mask", o, c["plain"](causal=False)[0],
              tol)
        del o, lse, o_ref, lse_ref
        ms = timer(c["fwd"])
        plain_ms = timer(lambda: c["plain"](causal=True, **pos), reps=5)
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            *c["lib"], scale=scale, enable_gqa=True))
        # Q, K and V read once; O (bf16) and LSE written.
        nbytes = c["in_bytes"] * (q_el + 2 * kv_el) + 2 * q_el \
            + 4 * b * hq * s
        prods = ([(4 * d * pairs, BF16_FLOPS)] if c["in_bytes"] == 2 else
                 [(2 * d * pairs, FP8_FLOPS), (2 * d * pairs, BF16_FLOPS)])
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"without a mask {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {4 * d * pairs / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:478",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"B={b} L={s} Hq={hq} Hkv={hkv} D={d} {c['what']} causal,"
                  f" qoff +{QOFF} on the card")


def check_flash_bwd_qoff(torch, timer, results):
    """[3O] rows 4q and 4fq: the backward's runtime-position branch (dQ
    and dK/dV kernels) at row 2q's shape and offset, bf16 and e4m3 Q/K/V
    with a bf16 dO (the FP8 ring's step), against its plain version;
    timed with the plain version and SDPA's backward without a mask."""
    import torch.nn.functional as F
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd, fp8_bwd_scales)
    b, s, hq, hkv, d = QOFF_SHAPE
    scale = d ** -0.5
    log(f"[3O] flash_attention bwd, runtime positions (rows 4q, 4fq; dQ and "
        f"dK/dV kernels): the shape and offset of row 2q")
    (q, k, v, do), (qd, kd, vd), sinv, deq = qoff_inputs(torch, 92)
    pos = positions_row(torch, QOFF)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    one = torch.ones((), device="cuda")
    pairs = b * hq * s * s
    q_el, kv_el = b * s * hq * d, b * s * hkv * d
    for name, (qq, kk, vv), fp8_kw, plain_q, lib_in in (
            ("flash_attention_bwd_qoff", (q, k, v), {}, qs,
             [t.transpose(1, 2).contiguous() for t in (q, k, v)]),
            ("flash_attention_bwd_fp8_qoff", (qd, kd, vd),
             dict(scale_invs=sinv), qd, deq)):
        o, lse = flash_fwd(qq, kk, vv, scale=scale, causal=True, **pos,
                           **fp8_kw)
        kw = dict(scale=scale, causal=True, **pos, **fp8_kw,
                  **(dict(grad_dtype=torch.bfloat16) if fp8_kw else {}))
        got = flash_bwd(qq, kk, vv, o, lse, do, **kw)
        torch.cuda.synchronize()
        delta = (do.float() * o.float()).sum(dim=-1)
        plain_kw = dict(scale=scale, causal=True, **pos)
        if fp8_kw:
            plain_kw.update(fp8_scales=fp8_bwd_scales(sinv, scale, one),
                            grad_dtype=torch.bfloat16)
        ref = flash_bwd_plain(plain_q, kk, vv, do, lse, delta, **plain_kw)
        err = 0.0
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            err = max(err, check(
                f"{name} {gname} ({int((a != r).sum())} of {r.numel()} "
                f"elements differ)", a, r,
                BWD_RTOL * float(r.float().abs().max())))
        del got, ref
        ms = timer(lambda: flash_bwd(qq, kk, vv, o, lse, do, **kw))
        plain_ms = timer(lambda: flash_bwd_plain(
            plain_q, kk, vv, do, lse, delta, **plain_kw), reps=5)
        leaves = [t.detach().requires_grad_() for t in lib_in]
        out = F.scaled_dot_product_attention(*leaves, scale=scale,
                                             enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        library_ms = timer.events(lambda: torch.autograd.grad(
            out, leaves, dot, retain_graph=True))
        del out, leaves
        in_bytes = 1 if fp8_kw else 2
        # Five products over every pair: s = Q K^T at the fp8 peak on
        # e4m3 Q/K/V, the other four (dO V^T with a bf16 dO, p and ds in
        # bf16) at bf16's.
        n_fp8 = 1 if fp8_kw else 0
        prods = [(n_fp8 * 2 * d * pairs, FP8_FLOPS),
                 ((5 - n_fp8) * 2 * d * pairs, BF16_FLOPS)]
        # Read Q, K, V, O, dO and LSE; write dQ, dK, dV (bf16).
        nbytes = in_bytes * (q_el + 2 * kv_el) + 2 * 2 * q_el \
            + 4 * b * hq * s + 2 * (q_el + 2 * kv_el)
        b_ms, b_by = bound_ms_mixed(nbytes, prods)
        log(f"  {name}: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"backward without a mask {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {10 * d * pairs / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        results[name] = dict(
            name=name, route="cuda",
            source="transformerengine_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="transformerengine_tpu/ops/flash_attention.py:1124",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms,
            shape=f"B={b} L={s} Hq={hq} Hkv={hkv} D={d} "
                  f"{'e4m3' if fp8_kw else 'bf16'} causal, qoff +{QOFF} on "
                  f"the card, dO bf16")


# The variants check's shape (B 1, L 256 a rank, Hq 4, Hkv 2, D 64) and
# its ring: cp 4, the windows (-1, -1), (37, 0) and (2, 0) (the last one
# makes the striped layout's live -1 left bound).
QOFF_VARIANT = (1, 256, 4, 2, 64)
QOFF_CP = 4
QOFF_WINDOWS = ((-1, -1), (37, 0), (2, 0))
# Offsets at the edges of the kernels' 64-row and 64-key tiles, and a
# step masked whole.
QOFF_EDGES = (-1, -63, -64, -65, -127, 63, 65, -256)


def one_key_step(L: int, pos) -> bool:
    """Whether every query of a ring step (B 1, L queries and keys, causal,
    its runtime positions ``pos``) sees at most one key."""
    from transformerengine_tpu_torch.ops.flash_attention import (
        _plain_offset, _visible, _window)
    seen = _visible(L, L, None, None, True,
                    _plain_offset(0, pos["q_position_offset"]),
                    _window(pos["window"], scalar=True), "cuda").sum(dim=-1)
    return int(seen.max()) <= 1


# A step where each query sees at most one key has p one-hot and O = V,
# so ds = p (dp - delta) cancels and dQ and dK are exactly 0: both the
# kernels and the plain version return only the f32 rounding of dp and
# delta, in other summation orders (the tensor cores' dp against the plain
# version's f32 dot), and a limit relative to that noise asks for equal
# bits. Such a gradient is held to zero within 2^-20 (8 f32 ulps) of the
# largest gradient of its terms (the plain version with delta 0).
CANCELLED_RTOL = 2 ** -20


def check_cancelled(name: str, got, ref, terms) -> None:
    """[3P] a gradient that cancels to zero (see CANCELLED_RTOL): the
    kernels' and the plain version's both within CANCELLED_RTOL of the
    largest |terms|."""
    tol = CANCELLED_RTOL * float(terms.float().abs().max())
    check(f"{name} (one key a query: exactly 0, the plain version "
          f"{float(ref.float().abs().max()):.1e})", got,
          got.new_zeros(got.shape), tol)
    if float(ref.float().abs().max()) > tol:
        raise AssertionError(f"{name}: the plain version does not cancel")


def check_qoff_variants(torch) -> None:
    """[3P] every (rank, step) of a cp-4 ring, contiguous and striped, for
    each of QOFF_WINDOWS: the step's runtime positions, a row of the
    ring's own (cp, 3) table on the card, through the forward and
    backward kernels in bf16 against their plain versions with the same
    row. Two planted faults must fail: the live -1 left bound read as an
    inactive side, and an offset one tile (64) off. Then QOFF_EDGES, the
    offsets at the edges of the kernels' tiles, with the rows they mask
    whole held to O = 0, LSE = -1e30 and a zero dQ."""
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, NEG_INF, flash_bwd, flash_bwd_plain, flash_fwd,
        flash_fwd_plain)
    from transformerengine_tpu_torch.parallel.ring_attention import (
        _ring_table, _step_positions)
    b, L, hq, hkv, d = QOFF_VARIANT
    scale = d ** -0.5
    log(f"[3P] runtime positions, every (rank, step) of a cp {QOFF_CP} ring, "
        f"contiguous and striped, windows {QOFF_WINDOWS}: B={b} L={L} "
        f"Hq={hq} Hkv={hkv} D={d} bf16, causal")
    g = torch.Generator(device="cuda").manual_seed(93)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = randn(b, L, hq, d), randn(b, L, hkv, d), \
        randn(b, L, hkv, d), randn(b, L, hq, d)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    kw = dict(scale=scale, causal=True)
    n, planted = 0, {"live": 0, "tile": 0}
    for striped in (False, True):
        for window in QOFF_WINDOWS:
            for idx in range(QOFF_CP):
                table = _ring_table(idx, QOFF_CP, L, striped, window, "cuda")
                rows = table.tolist()
                for s in range(QOFF_CP):
                    pos = _step_positions(table, s, window)
                    name = (f"{'striped' if striped else 'contiguous'} "
                            f"window={window} rank {idx} step {s} "
                            f"{rows[s]}")
                    o, lse = flash_fwd(q, k, v, **kw, **pos)
                    o_ref, lse_ref = flash_fwd_plain(qs, k, v, causal=True,
                                                     **pos)
                    tol = row_tol(o_ref, BF16_ROW_RTOL)
                    check(f"fwd {name} O", o, o_ref, tol)
                    check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
                    got = flash_bwd(q, k, v, o, lse, do, **kw, **pos)
                    delta = (do.float() * o.float()).sum(dim=-1)
                    ref = flash_bwd_plain(qs, k, v, do, lse, delta, **kw,
                                          **pos)
                    one_key = one_key_step(L, pos)
                    if one_key:
                        terms = flash_bwd_plain(qs, k, v, do, lse,
                                                torch.zeros_like(delta),
                                                **kw, **pos)
                    for i, (gname, a, r) in enumerate(zip(
                            ("dQ", "dK", "dV"), got, ref)):
                        if one_key and gname != "dV":
                            check_cancelled(f"bwd {name} {gname}", a, r,
                                            terms[i])
                            continue
                        check(f"bwd {name} {gname}", a, r,
                              BWD_RTOL * max(float(r.float().abs().max()),
                                             1e-30))
                    n += 1
                    if window[0] >= 0 and rows[s][1] == -1:
                        # The live -1 left bound read as inactive.
                        wrong = dict(pos, window=(-1, pos["window"][1]))
                        must_differ(f"fwd {name} LSE", lse, flash_fwd_plain(
                            qs, k, v, causal=True, **wrong)[1], LSE_ATOL,
                            "the live -1 left bound read as inactive")
                        planted["live"] += 1
                    if not striped and rows[s][0] == 0 and window[0] < 0:
                        # The diagonal step's offset one tile off.
                        off = torch.full((1,), 64, dtype=torch.int32,
                                         device="cuda")
                        must_differ(f"fwd {name} O", o, flash_fwd_plain(
                            qs, k, v, causal=True, q_position_offset=off,
                            window=pos["window"])[0], tol,
                            "the offset one tile (64) off")
                        planted["tile"] += 1
    if not (planted["live"] and planted["tile"]):
        raise AssertionError(f"the planted faults did not run: {planted}")
    log(f"  {n} (rank, step, layout, window) cases forward and backward ok; "
        f"planted faults caught: the live -1 read as inactive "
        f"{planted['live']} times, the offset one tile off "
        f"{planted['tile']} times")
    # Offsets at the edges of the kernels' 64-row and 64-key tiles: rows
    # masked whole write O = 0 and LSE = -1e30 and get zero gradients.
    for qoff in QOFF_EDGES:
        pos = positions_row(torch, qoff)
        o, lse = flash_fwd(q, k, v, **kw, **pos)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, causal=True, **pos)
        check(f"fwd qoff {qoff} O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
        check(f"fwd qoff {qoff} LSE", lse, lse_ref, LSE_ATOL)
        # (B, L): a query sees the same keys in every head.
        dead = (lse_ref <= NEG_INF / 2)[:, 0]
        check_masked_rows(torch, f"fwd qoff {qoff}", dead, o, lse)
        got = flash_bwd(q, k, v, o, lse, do, **kw, **pos)
        ref = flash_bwd_plain(qs, k, v, do, lse,
                              (do.float() * o.float()).sum(dim=-1), **kw,
                              **pos)
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            check(f"bwd qoff {qoff} {gname}", a, r,
                  BWD_RTOL * max(float(r.float().abs().max()), 1e-30))
        check_zero_grads(f"bwd qoff {qoff}", got, dead, None)
    log(f"  offsets {QOFF_EDGES} at the tiles' edges forward and backward "
        f"ok, fully masked rows zero")


def check_flash_determinism(torch) -> None:
    """[3Q] the tensor-core bodies are deterministic: two launches on the
    same inputs give bitwise-equal O and LSE, and dQ, dK, dV (and dbias),
    at row 4's shape (B 2, S 2048, Hq 32, Hkv 8, D 128, bf16, causal) and
    at row 4b's (the encoder's padding mask and f32 relative bias). The
    backward's two kernels sum without atomics, in a fixed order."""
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_fwd)
    b, s, hq, hkv, d = FP8_SHAPE
    log(f"[3Q] flash attention's determinism: two launches bitwise equal "
        f"at rows 4 and 4b's shapes (B={b} S={s} Hq={hq} Hkv={hkv} D={d})")
    q, k, v, do, lens = enc_inputs(torch, 91)
    bias = encoder_bias(torch, s, hq, ENC_SEED)
    scale = d ** -0.5
    for row, args, kw in (("4", (), dict(causal=True)),
                          ("4b", (lens, lens), dict(causal=False,
                                                   bias=bias))):
        outs = []
        for _ in range(2):
            o, lse = flash_fwd(q, k, v, *args, scale=scale, **kw)
            grads = flash_bwd(q, k, v, o, lse, do, *args, scale=scale, **kw)
            outs.append((o, lse, *grads))
        torch.cuda.synchronize()
        names = ("O", "LSE", "dQ", "dK", "dV", "dbias")
        for name, a, r in zip(names, *outs):
            if not torch.equal(a, r):
                raise AssertionError(f"row {row}: {name} differs between "
                                     f"two launches")
        log(f"  row {row}: {', '.join(names[:len(outs[0])])} bitwise equal "
            f"ok")
        del outs


# [3R] the tensor-core bodies at their tiles' edges: (dtype, Sq, Skv, D, Hq,
# Hkv, window, sink, segment ids, runtime q offset), causal at the
# bottom-right offset Skv - Sq (plus the runtime offset, where one is
# given). Sq and Skv are no multiples of 64; D 64, 128 and 256 take the
# three tile shapes; groups of 1, 4 and 8.
EDGE_CASES = tuple(
    (dt, *case) for dt in ("bf16", "e4m3") for case in (
        (200, 136, 64, 4, 4, None, False, None, None),
        (136, 200, 128, 8, 2, (40, 0), True, None, None),
        (200, 200, 256, 8, 1, None, False, "gaps", None),
        (200, 136, 128, 16, 2, (70, 0), False, None, 72),
        (72, 200, 64, 32, 4, None, True, "packed", None)))


def check_edge_variants(torch) -> None:
    """[3R] :data:`EDGE_CASES` through the bf16 and e4m3 (current-scaling
    payloads, a bf16 dO) tensor-core bodies, forward and backward, each
    against its plain version with [3b]'s and [3e]'s tolerances; the
    queries that see no key write O = 0 and LSE = -1e30 (the sink with
    one) and get zero gradients."""
    from transformerengine_tpu_torch.ops.flash_attention import (
        LOG2E, flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain,
        fp8_bwd_scales, fp8_fwd_scales)
    log("[3R] flash attention's tensor-core bodies at their tiles' edges, "
        "bf16 and e4m3, forward and backward")
    g = torch.Generator(device="cuda").manual_seed(97)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf16)

    for dt, sq, skv, d, hq, hkv, window, sink, ids, qoff in EDGE_CASES:
        q, do = randn(2, sq, hq, d), randn(2, sq, hq, d)
        k, v = randn(2, skv, hkv, d), randn(2, skv, hkv, d)
        s0 = randn(hq).float() * 2 if sink else None
        mk, qzero, kzero = variant_mask(torch, g, ids, 2, sq, skv)
        scale = d ** -0.5
        kw = dict(causal=True, offset=skv - sq, window=window or (-1, -1),
                  **mk)
        if qoff is not None:
            kw.update(positions_row(torch, qoff))
        name = (f"{dt} Sq={sq} Skv={skv} D={d} G={hq // hkv} "
                f"window={window} sink={sink} ids={ids} qoff={qoff}")
        if dt == "e4m3":
            (q, k, v), sinv = fp8_payloads(torch, (q, k, v))
            fkw, bkw = dict(scale_invs=sinv), dict(grad_dtype=bf16)
            pf = dict(fp8_scales=fp8_fwd_scales(sinv, scale), out_dtype=bf16)
            pb = dict(fp8_scales=fp8_bwd_scales(
                sinv, scale, torch.ones((), device="cuda")), grad_dtype=bf16)
            qs = q
        else:
            fkw = bkw = pf = pb = {}
            qs = (q.float() * (scale * LOG2E)).to(bf16)
        o, lse = flash_fwd(q, k, v, scale=scale, softmax_sink=s0, **fkw,
                           **kw)
        o_ref, lse_ref = flash_fwd_plain(qs, k, v, softmax_sink=s0, **pf,
                                         **kw)
        check(f"fwd {name} O", o, o_ref, row_tol(o_ref, BF16_ROW_RTOL))
        check(f"fwd {name} LSE", lse, lse_ref, LSE_ATOL)
        check_masked_rows(torch, f"fwd {name}", qzero, o, lse, s0)
        got = flash_bwd(q, k, v, o, lse, do, scale=scale, softmax_sink=s0,
                        **fkw, **bkw, **kw)
        delta = (do.float() * o.float()).sum(dim=-1)
        ref = flash_bwd_plain(qs, k, v, do, lse, delta, scale=scale, **pb,
                              **kw)
        for gname, a, r in zip(("dQ", "dK", "dV"), got, ref):
            check(f"bwd {name} {gname}", a, r,
                  BWD_RTOL * float(r.float().abs().max()))
        check_zero_grads(f"bwd {name}", got, qzero, kzero)

# Phase 26: LLAMA_8B's attention over S 8192 split over 4 ranks on one
# card, and a 2-layer LlamaModel step at LLAMA_8B width (cut for time, as
# phase 6 cuts to 4).
CP_SIZE = 4
CP_S = 8192
CP_LAYERS = 2
CP_SEED = 101
CP_LR = 1e-3
# The gloo group's timeout and the phase's deadline: a rank that hangs
# fails the phase instead of eating the run.
CP_TIMEOUT_S = 240
# Limits, each about twice the largest reading of the first run on an
# H100 (PERF.md section 6): O against each row's largest |ref| (9.95e-3:
# the ring rounds each step's O to bf16 before its f32 merge), a gradient
# against its largest |ref| (7.6e-3: the ring sums cp bf16-rounded step
# gradients in f32 where the one flash call rounds once), the FP8 ring
# against the bf16 ring on the same e4m3 payloads dequantized, O per row
# (2.84e-2: the dequantized values and scales round to bf16, the FP8
# kernels' products do not) and the gradients per tensor (1.52e-2), the
# step's loss (1.06e-4 of 12.58, absolute) and each gradient's norm of
# the difference over its norm (1.06e-2, the embedding's).
CP_LIMITS = dict(o=2e-2, grad=1.5e-2, fp8_o=6e-2, fp8_grad=3e-2,
                 loss=2e-4, gnorm=2e-2)
# The FP8 ring's K and V, chunk j (rank j's) times the j-th factor: each
# chunk's scale differs, so a step that dequantizes a chunk with another
# chunk's scale (the planted fault: the scales left behind as the
# payloads rotate) is off by a factor of 2 to 8.
CP_FP8_CHUNK_SCALES = (1.0, 0.5, 2.0, 0.25)
CP_STRATEGIES = ("RING", "RING_STRIPED", "ALL_GATHER", "ULYSSES_A2A",
                 "HIERARCHICAL", "FP8_RING")


def cp_launches(strategy: str, layers: int = 1) -> dict:
    """The exact launches of one rank's forward and backward: the ring's
    cp steps each way (2 over the hierarchical form's outer ring of 2),
    one of each for ALL_GATHER (all with the runtime positions) and
    ULYSSES_A2A (without)."""
    n = {"RING": CP_SIZE, "RING_STRIPED": CP_SIZE, "FP8_RING": CP_SIZE,
         "HIERARCHICAL": 2, "ALL_GATHER": 1, "ULYSSES_A2A": 1}[strategy]
    suffix = ("" if strategy == "ULYSSES_A2A" else
              "_fp8_qoff" if strategy == "FP8_RING" else "_qoff")
    return {f"flash_attention_{k}{suffix}": n * layers
            for k in ("fwd", "bwd_dq", "bwd_dkv")}


def cp_inputs(torch, spec):
    """The seeded bf16 Q, K, V and dO of the whole sequence (B, S, H, D)."""
    b, s, hq, hkv, d = spec["shape"]
    g = torch.Generator(device=spec["device"]).manual_seed(spec["seed"])

    def randn(*sh):
        return torch.randn(sh, generator=g, device=spec["device"]).to(
            torch.bfloat16)
    return randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), \
        randn(b, s, hq, d)


def cp_reference(torch, spec) -> dict:
    """The parent's references on the whole sequence, on the host: one
    flash forward and backward of cp_inputs (O, dQ, dK, dV), and one
    bf16 step of the model (the loss and every gradient), before the
    step's update."""
    from transformerengine_tpu_torch.models.llama import (
        LlamaModel, cross_entropy_loss)
    from transformerengine_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_fwd)
    dev = spec["device"]
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    q, k, v, do = cp_inputs(torch, spec)
    scale = q.shape[-1] ** -0.5
    t0 = time.perf_counter()
    o, lse = flash_fwd(q, k, v, scale=scale, causal=True)
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, scale=scale, causal=True)
    ref = {"o": o.cpu(), "dq": dq.cpu(), "dk": dk.cpu(), "dv": dv.cpu()}
    del q, k, v, do, o, lse, dq, dk, dv
    model = LlamaModel(spec["cfg"], device=dev, seed=spec["seed"])
    shrink_embedding(model)
    tokens, targets = train_batch(torch, spec["cfg"].vocab_size, 1,
                                  spec["shape"][1], dev, spec["seed"])
    loss = cross_entropy_loss(model(tokens), targets)
    loss.backward()
    ref["loss"] = float(loss.detach())
    ref["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    if dev != "cpu":
        torch.cuda.synchronize()
        ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ref["seconds"] = time.perf_counter() - t0
    del model, loss
    return ref


def cp_shard(torch, x, idx: int, striped: bool):
    """Rank ``idx``'s shard of a (B, S, ...) tensor: its contiguous
    chunk, or of the striped reorder."""
    from transformerengine_tpu_torch.parallel.cp_utils import (
        reorder_causal_striped)
    if striped:
        x = reorder_causal_striped(x, CP_SIZE)
    n = x.shape[1] // CP_SIZE
    return x[:, idx * n:(idx + 1) * n]


def cp_held(got, ref, rows: bool) -> float:
    """The largest |got - ref| over ``ref``'s largest element of each row
    (``rows``) or of the whole tensor, which the caller holds to its
    limit."""
    diff = (got.float() - ref.float()).abs()
    if rows:
        den = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        den = ref.float().abs().max().clamp_min(1e-30)
    return float((diff / den).max())


def cp_fp8_inputs(torch, full):
    """The FP8 ring's inputs: cp_inputs with K and V scaled chunk by chunk
    (CP_FP8_CHUNK_SCALES)."""
    q, k, v, do = full
    f = torch.tensor(CP_FP8_CHUNK_SCALES, device=k.device).repeat_interleave(
        k.shape[1] // CP_SIZE).reshape(1, -1, 1, 1)
    return q, (k.float() * f).to(k.dtype), (v.float() * f).to(v.dtype), do


def cp_run(torch, strategy: str, q, k, v, do, world, inner, outer):
    """One forward and backward of ``strategy`` on this rank's shard
    through the entry points (``fused_attn`` with the group; the
    hierarchical form through ``hierarchical_attn``): O, dQ, dK, dV."""
    from transformerengine_tpu_torch import DelayedScaling, autocast
    from transformerengine_tpu_torch.attention import (
        AttnMaskType, CPStrategy, fused_attn)
    from transformerengine_tpu_torch.parallel.ring_attention import (
        hierarchical_attn)
    if strategy == "HIERARCHICAL":
        o = hierarchical_attn(q, k, v, inner, outer, causal=True)
    else:
        cp = CPStrategy[strategy if strategy != "FP8_RING" else "RING"]
        with autocast(enabled=strategy == "FP8_RING",
                      recipe=DelayedScaling(fp8_dpa=True)):
            o = fused_attn((q, k, v), attn_mask_type=AttnMaskType.CAUSAL,
                           context_parallel_strategy=cp,
                           context_parallel_group=world)
    if do is None:
        return o
    o.backward(do)
    return dict(o=o.detach(), dq=q.grad, dk=k.grad, dv=v.grad)


def cp_fp8_target(torch, q, k, v, do, world) -> dict:
    """The FP8 ring's reference on this rank: the bf16 ring on the same
    e4m3 payloads dequantized (q against this rank's amax, K and V chunk
    by chunk, as the FP8 ring quantizes them)."""
    from transformerengine_tpu_torch.parallel.ring_attention import (
        _kv_dq, _kv_q)
    deq = [_kv_dq(*_kv_q(t.detach()), t.dtype).requires_grad_()
           for t in (q, k, v)]
    return cp_run(torch, "RING", *deq, do, world, None, None)


def cp_fp8_fault(torch, q, k, v, world):
    """The FP8 ring's forward with a planted fault: the K/V scales stay
    behind as their payloads rotate, so each step scales the resident
    chunk's scores and values by this rank's own K/V scales."""
    from transformerengine_tpu_torch.parallel import ring_attention as ra
    rotate = ra._rotate

    def stale_scales(kv, group):
        moved = rotate(kv, group)
        return {**moved, "ks": kv["ks"], "vs": kv["vs"]} \
            if "ks" in kv else moved
    ra._rotate = stale_scales
    try:
        with torch.no_grad():
            return cp_run(torch, "FP8_RING", q, k, v, None, world, None,
                          None)
    finally:
        ra._rotate = rotate


def cp_attention(torch, spec, idx: int, world, inner, outer, ref) -> dict:
    """Each strategy's forward and backward on this rank's shard through
    the entry points, held to the parent's single flash call, with exact
    launches, the ms of a call and the bytes staged through the host. The
    FP8 ring runs on chunk-scaled K and V (cp_fp8_inputs) and is held to
    the bf16 ring on its payloads dequantized (cp_fp8_target), and its
    planted fault (cp_fp8_fault) must fail that check."""
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.attention import (
        AttnMaskType, CPStrategy, fused_attn)
    from transformerengine_tpu_torch.parallel import group as grp
    dev = spec["device"]
    full = cp_inputs(torch, spec)
    # A first call (the kernels' first loads, the group's first sends)
    # outside the timed ones.
    leaves = [cp_shard(torch, t, idx, False).contiguous().requires_grad_()
              for t in full[:3]]
    fused_attn(leaves, attn_mask_type=AttnMaskType.CAUSAL,
               context_parallel_strategy=CPStrategy.RING,
               context_parallel_group=world).backward(
                   cp_shard(torch, full[3], idx, False))
    sync(torch, dev)
    out = {}
    for strategy in CP_STRATEGIES:
        striped = strategy == "RING_STRIPED"
        fp8 = strategy == "FP8_RING"
        inputs = cp_fp8_inputs(torch, full) if fp8 else full
        leaves = [cp_shard(torch, t, idx, striped).contiguous()
                  .requires_grad_(i < 3) for i, t in enumerate(inputs)]
        sync(torch, dev)
        _build.LAUNCHES.clear()
        staged = sum(grp.STAGED.values())
        t0 = time.perf_counter()
        got = cp_run(torch, strategy, *leaves, world, inner, outer)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        reading = dict(ms=ms, launches=launches,
                       staged=sum(grp.STAGED.values()) - staged,
                       ok_launches=launches == cp_launches(strategy))
        if fp8:
            target = cp_fp8_target(torch, *leaves, world)
            lims = ("fp8_o", "fp8_grad")
            fault = cp_fp8_fault(torch, *leaves[:3], world)
            reading["fault_err"] = cp_held(fault, target["o"], rows=True)
        else:
            target = {n: cp_shard(torch, ref[n], idx, striped).to(dev)
                      for n in ("o", "dq", "dk", "dv")}
            lims = ("o", "grad")
        _build.LAUNCHES.clear()
        errs = {n: cp_held(got[n], target[n], rows=n == "o") for n in got}
        out[strategy] = dict(
            reading, errs=errs,
            ok=all(errs[n] <= CP_LIMITS[lims[n != "o"]] for n in errs))
    return out


def cp_step(torch, spec, idx: int, world, ref_grads, ref_loss) -> dict:
    """One bf16 training step of the model on this rank's shard: the
    forward with the tokens' global RoPE positions, this rank's summed
    cross entropy over the global token count, the backward, every
    gradient and the loss summed over the group, SGD, and the update
    read back (every rank's weights must agree); held to the parent's
    step (rank 0 reads the gradients)."""
    import torch.distributed as dist
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.models.llama import (
        LlamaModel, cross_entropy_loss)
    from transformerengine_tpu_torch.parallel import group as grp
    dev = spec["device"]
    cfg = dataclasses.replace(spec["cfg"], context_parallel_group=world)
    model = LlamaModel(cfg, device=dev, seed=spec["seed"])
    shrink_embedding(model)
    s = spec["shape"][1]
    L = s // CP_SIZE
    tokens, targets = train_batch(torch, cfg.vocab_size, 1, s, dev,
                                  spec["seed"])
    positions = torch.arange(idx * L, (idx + 1) * L, device=dev)[None]
    sync(torch, dev)
    _build.LAUNCHES.clear()
    staged = sum(grp.STAGED.values())
    t0 = time.perf_counter()
    logits = model(tokens[:, idx * L:(idx + 1) * L], positions=positions)
    loss = cross_entropy_loss(logits, targets[:, idx * L:(idx + 1) * L]) \
        * (L / s)
    del logits
    loss.backward()
    sync(torch, dev)
    t_grad = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    _build.LAUNCHES.clear()
    params = list(model.parameters())
    for p in params:
        p.grad = grp.all_reduce_sum(p.grad, world)
    total = float(grp.all_reduce_sum(loss.detach(), world))
    with torch.no_grad():
        for p in params:
            p.sub_(CP_LR * p.grad.to(p.dtype))
    sync(torch, dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    # The update read back: every rank must hold the same weights after
    # the step (each parameter's f64 sum, gathered over the group).
    sums = torch.stack([p.detach().sum(dtype=torch.float64)
                        for p in params]).cpu()
    every = [torch.empty_like(sums) for _ in range(CP_SIZE)]
    dist.all_gather(every, sums, group=world)
    out = dict(loss=total, step_ms=step_ms,
               fwd_bwd_ms=(t_grad - t0) * 1e3, launches=launches,
               staged=sum(grp.STAGED.values()) - staged,
               ok_launches=launches == cp_launches("RING", cfg.num_layers),
               replicas_agree=all(torch.equal(every[0], e) for e in every))
    if idx == 0:
        gnorm = {}
        for n, p in model.named_parameters():
            r = ref_grads[n].to(dev).float()
            gnorm[n] = float((p.grad.float() - r).norm()
                             / r.norm().clamp_min(1e-30))
        out["gnorm"] = gnorm
        out["loss_err"] = abs(total - ref_loss)
    if dev != "cpu":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def sync(torch, dev) -> None:
    if dev != "cpu":
        torch.cuda.synchronize()


def cp_rank(rank: int, spec: dict, results) -> None:
    """One rank of phase 26 (a process of its own): the gloo group, the
    hierarchical form's inner and outer groups, then cp_attention and
    cp_step; puts (rank, its readings) or (rank, the traceback)."""
    import datetime
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
            world_size=CP_SIZE,
            timeout=datetime.timedelta(seconds=spec["timeout"]))
        # Inner pairs {0, 1}, {2, 3} and outer pairs {0, 2}, {1, 3}: every
        # rank makes each group, in one order.
        inner = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
        outer = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
        ref = torch.load(spec["ref"], mmap=True)
        world = dist.group.WORLD
        out = dict(attention=cp_attention(torch, spec, rank, world, inner,
                                          outer, ref))
        if spec["device"] != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out["step"] = cp_step(torch, spec, rank, world, ref["grads"],
                              ref["loss"])
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, out))
    except Exception:
        # The parent reports it and fails the phase.
        results.put((rank, traceback.format_exc()))


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_cp(torch, results) -> None:
    """[26] context parallelism over 4 gloo ranks on one card: the parent
    computes its references at full width and moves them to the host,
    frees the card, then spawns the ranks (cp_rank) and holds their
    readings: each strategy's O and gradients, the model step's loss and
    gradients, exact launches per rank and layer, ms and staged bytes."""
    import torch.multiprocessing as multiprocessing
    from transformerengine_tpu_torch import _build
    from transformerengine_tpu_torch.models.llama import LLAMA_8B
    b, s, hq, hkv, d = 1, CP_S, LLAMA_8B.num_attention_heads, \
        LLAMA_8B.num_kv_heads, LLAMA_8B.hidden_size // \
        LLAMA_8B.num_attention_heads
    spec = dict(device=CARD, shape=(b, s, hq, hkv, d), seed=CP_SEED,
                cfg=dataclasses.replace(LLAMA_8B, num_layers=CP_LAYERS),
                timeout=CP_TIMEOUT_S, port=free_port(),
                ref=str(_build.BUILD_DIR / "cp_reference.pt"))
    log(f"[26] context parallelism: {CP_SIZE} gloo ranks on one card "
        f"(CUDA tensors cross through the host: gloo takes host tensors), "
        f"LLAMA_8B attention B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 "
        f"causal through {', '.join(CP_STRATEGIES)}, and a {CP_LAYERS}-layer "
        f"LlamaModel step at LLAMA_8B width over the same {s} tokens")
    t0 = time.perf_counter()
    ref = cp_reference(torch, spec)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(ref, spec["ref"])
    log(f"  the parent's references (one flash call, one step on the whole "
        f"sequence): {ref['seconds']:.1f} s, peak "
        f"{ref.get('peak_gib', 0.0):.2f} GiB, loss {ref['loss']:.6f}; saved "
        f"in {time.perf_counter() - t0:.1f} s")
    ref_loss = ref["loss"]
    del ref
    if CARD != "cpu":
        torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=cp_rank, args=(r, spec, queue))
             for r in range(CP_SIZE)]
    t0 = time.perf_counter()
    readings = {}
    try:
        for p in procs:
            p.start()
        while len(readings) < CP_SIZE:
            left = CP_TIMEOUT_S + 60 - (time.perf_counter() - t0)
            if left <= 0:
                late = sorted(set(range(CP_SIZE)) - set(readings))
                raise AssertionError(f"phase 26: ranks {late} did not "
                                     f"finish in time")
            try:
                rank, got = queue.get(timeout=min(left, 5.0))
            except Exception:
                dead = [r for r, p in enumerate(procs)
                        if r not in readings and p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"phase 26: ranks {dead} died "
                                         f"without a result")
                continue
            if isinstance(got, str):
                raise AssertionError(f"phase 26: rank {rank} failed:\n{got}")
            readings[rank] = got
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        Path(spec["ref"]).unlink(missing_ok=True)
    log(f"  ranks ran in {time.perf_counter() - t0:.1f} s (spawn, the group, "
        f"the strategies and the step)")
    failures = []
    totals = collections.Counter()
    for strategy in CP_STRATEGIES:
        for r in range(CP_SIZE):
            a = readings[r]["attention"][strategy]
            totals.update(a["launches"])
            log(f"  {strategy:13s} rank {r}: "
                + ", ".join(f"{n} {e:.3e}" for n, e in a["errs"].items())
                + f"; {a['ms']:.1f} ms a call (forward and backward), "
                f"{a['staged'] / 1e6:.1f} MB staged; launches "
                f"{a['launches']} {'ok' if a['ok_launches'] else 'FAIL'}")
            if not (a["ok"] and a["ok_launches"]):
                failures.append(f"{strategy} rank {r}")
            if "fault_err" in a:
                # Rank 0's causal steps see only its own chunk, so only
                # the later ranks can read a stale scale.
                caught = a["fault_err"] > CP_LIMITS["fp8_o"]
                log(f"  {strategy:13s} rank {r}: planted fault (the K/V "
                    f"scales not rotated) O {a['fault_err']:.3e} "
                    f"{'fails, as it must' if caught else 'passes'}")
                if r > 0 and not caught:
                    failures.append(f"{strategy} rank {r} planted fault "
                                    f"passed")
    for r in range(CP_SIZE):
        st = readings[r]["step"]
        totals.update(st["launches"])
        log(f"  step rank {r}: {st['step_ms']:.1f} ms (forward and backward "
            f"{st['fwd_bwd_ms']:.1f} ms, then the gradients summed over the "
            f"group and SGD), {st['staged'] / 1e6:.1f} MB staged, peak "
            f"{st.get('peak_gib', 0.0):.2f} GiB; launches {st['launches']} "
            f"{'ok' if st['ok_launches'] else 'FAIL'}; weights after the "
            f"update {'agree' if st['replicas_agree'] else 'DIFFER'}")
        if not st["ok_launches"]:
            failures.append(f"step rank {r} launches")
        if not st["replicas_agree"]:
            failures.append(f"step rank {r} weights after the update")
    st = readings[0]["step"]
    worst = max(st["gnorm"], key=st["gnorm"].get)
    ok = st["loss_err"] <= CP_LIMITS["loss"] and \
        st["gnorm"][worst] <= CP_LIMITS["gnorm"]
    log(f"  step against the whole-sequence step: loss {st['loss']:.6f} "
        f"against {ref_loss:.6f} ({st['loss_err']:.3e}); the worst gradient "
        f"{worst} {st['gnorm'][worst]:.3e} (norm of the difference over its "
        f"norm; median {statistics.median(st['gnorm'].values()):.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("step against the whole-sequence step")
    if failures:
        raise AssertionError(f"phase 26: {failures}")
    for name, n in totals.items():
        add_launches(results, bwd_row(name), n)
    results["_train_cp"] = dict(
        ms={k: statistics.median(readings[r]["attention"][k]["ms"]
                                 for r in range(CP_SIZE))
            for k in CP_STRATEGIES},
        step_ms=statistics.median(readings[r]["step"]["step_ms"]
                                  for r in range(CP_SIZE)),
        loss=st["loss"], loss_err=st["loss_err"],
        gnorm_worst=st["gnorm"][worst])


def bwd_row(kernel: str) -> str:
    """The results row of a launch name: a branch's dQ and dK/dV kernels
    share one row."""
    for part in ("_dq", "_dkv"):
        kernel = kernel.replace("flash_attention_bwd" + part,
                                "flash_attention_bwd")
    return kernel


PHASES = ("3", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14",
          "15", "16", "17", "18", "19", "20", "21", "22", "23", "24", "25",
          "26")


def main() -> int:
    if not (HERE / "transformerengine_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of 3-26")
    parser.add_argument("--train-seeds", default=str(TRAIN_VS_CPU_SEED),
                        help="comma-separated seeds of phase 7 (its limits "
                        "were set from the readings of 21,22,23)")
    parser.add_argument("--moe-seeds", default=str(MOE_VS_CPU_SEED),
                        help="comma-separated seeds of phase 15 (its limits "
                        "were set from the readings of 31,32,33)")
    parser.add_argument("--gptoss-seeds", default=str(GPTOSS_VS_CPU_SEED),
                        help="comma-separated seeds of phase 18 (its limits "
                        "were set from the readings of 51,52,53)")
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"phases are {PHASES}")
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
    timings = {}

    def run(phase, fn, *args):
        if phase in phases:
            t = time.perf_counter()
            fn(torch, *args)
            timings[phase] = timings.get(phase, 0.0) + \
                time.perf_counter() - t
            _build.LAUNCHES.clear()
            torch.cuda.empty_cache()

    run("3", check_matvec, timer, results)
    run("3", check_flash, timer, results)
    run("3", check_decode_attention, timer, results)
    run("3", check_variants)
    run("3", check_flash_bwd, timer, results)
    run("3", check_casts, timer, results)
    run("3", check_norm_cast, timer, results)
    run("3", check_train_variants)
    run("3", check_mxfp8_quantize, timer, results)
    run("3", check_mxfp8_norm, timer, results)
    run("3", check_mxfp8_variants)
    run("3", check_mxfp8_qdq_grouped, timer, results)
    run("3", check_paged_attention, timer, results)
    run("3", check_paged_variants)
    run("3", check_kn_matvec, timer, results)
    run("3", check_nvfp4_quantize, timer, results)
    run("3", check_nvfp4_variants)
    run("3", check_flash_sw, timer, results)
    run("3", check_flash_bwd_sw, timer, results)
    run("3", check_sw_variants, timer)
    run("3", check_flash_fp8, timer, results)
    run("3", check_flash_bwd_fp8, timer, results)
    run("3", check_fp8_variants)
    run("3", check_flash_seg, timer, results)
    run("3", check_flash_bwd_seg, timer, results)
    run("3", check_seg_variants)
    run("3", check_flash_bias, timer, results)
    run("3", check_flash_bwd_bias, timer, results)
    run("3", check_bias_variants)
    run("3", check_flash_dropout, timer, results)
    run("3", check_flash_bwd_dropout, timer, results)
    run("3", check_dropout_variants)
    run("3", check_flash_softcap, timer, results)
    run("3", check_flash_bwd_softcap, timer, results)
    run("3", check_flash_fp8_dropout, timer, results)
    run("3", check_flash_bwd_fp8_dropout, timer, results)
    run("3", check_softcap_variants)
    run("3", check_flash_qoff, timer, results)
    run("3", check_flash_bwd_qoff, timer, results)
    run("3", check_qoff_variants)
    run("3", check_flash_determinism)
    run("3", check_edge_variants)
    run("4", serve, results)
    run("9", serve_paged_mxfp8, results)
    run("12", serve_paged_nvfp4, results)
    run("10", serve_batching, results)
    run("5", card_vs_cpu)
    run("6", train, results)
    run("8", train_mxfp8, results)
    run("11", train_nvfp4, results)
    run("13", train_mixtral, results)
    run("14", serve_mixtral, results)
    run("16", train_gptoss, results)
    run("17", serve_gptoss, results)
    run("19", train_fp8_attention, results)
    run("20", train_packed, results)
    run("21", train_encoder, results)
    run("23", train_dropout, results)
    run("25", train_flex, results)
    run("26", train_cp, results)
    failed = []
    for seed in map(int, args.train_seeds.split(",")):
        run("7", lambda torch, seed=seed: failed.extend(
            train_card_vs_cpu(torch, seed)))
    for seed in map(int, args.moe_seeds.split(",")):
        run("15", lambda torch, seed=seed: failed.extend(
            mixtral_card_vs_cpu(torch, seed)))
    for seed in map(int, args.gptoss_seeds.split(",")):
        run("18", lambda torch, seed=seed: failed.extend(
            gptoss_card_vs_cpu(torch, seed)))
    run("22", lambda torch: failed.extend(encoder_card_vs_cpu(torch)))
    run("24", lambda torch: failed.extend(dropout_card_vs_cpu(torch)))
    if failed:
        raise AssertionError(f"training step, card against CPU: {failed}")
    log(f"phase seconds: {', '.join(f'{p} {t:.1f}' for p, t in timings.items())}")

    stats = {k: results.pop(k) for k in ("_serve", "_train", "_train_mxfp8",
                                         "_train_nvfp4", "_serve_paged_mxfp8",
                                         "_serve_paged_nvfp4", "_batching",
                                         "_train_mixtral", "_serve_mixtral",
                                         "_train_gptoss", "_serve_gptoss",
                                         "_train_fp8_attention",
                                         "_train_packed", "_train_encoder",
                                         "_train_dropout", "_train_flex",
                                         "_train_cp")
             if k in results}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({**stats, "card": smi,
                    "shapes": {k: r.get("shape") for k, r in results.items()}}))
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
