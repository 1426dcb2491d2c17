#!/usr/bin/env python3
"""Runs the tensor-core kernels' CUDA sources on the CPU, in a host
simulation, through the port's own wrappers, and holds each result to the
wrapper's plain version (the tolerances of ``chip_smoke.py`` phase 3):
the flash attention kernels, the decode GEMMs, the two decode attention
kernels and the two NVFP4 quantize kernels (byte for byte).

    python3 tools/flash_host_sim/run.py [--quick]
                                        [--kernels flash,decode,decode_attn,nvfp4]
                                        [--out DIR]

No CUDA toolkit is needed: ``g++`` (C++20, pthreads) compiles the units
(``csrc/flash_attention*.cu``, ``csrc/decode_matvec.cu``,
``csrc/decode_kn_matvec.cu``, ``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu`` and ``csrc/nvfp4_quantize.cu``) against
the headers here, which stand in
for the CUDA ones. Each block's threads are ``std::thread``s (a grid's
blocks run one after another), ``__syncthreads`` a barrier, and the
instructions of ``csrc/ptx.cuh`` (ldmatrix, mma.sync, cp.async, prmt, the
e4m3 pair conversion, the bf16 pair product) are replaced by
``ptx_sim.cuh``, which exchanges each lane's operands through a per-warp
buffer and computes every lane's fragment from the PTX layouts. So a
wrong fragment index, mask, tile edge, stage or byte permute shows here as
a wrong result; the timing, the hardware's summation order and the
compiler's register use show only on the card. The simulated card holds
264 blocks (132 SMs, two blocks each), which sets the grids that size
themselves to fill it (the decode GEMMs' split K, the decode attention
kernels' split sequence, the NVFP4 passes' persistent grids). ``nvfp4``
also builds ``nvfp4_sweep.cpp``, which holds the NVFP4 rounding to
nearest to the table walk it replaced over every f32 of magnitude at most
8 (about 11 s on 4 threads). Launches with ``<<<...>>>``
and ``extern __shared__`` arrays are rewritten in a copy of the sources;
the wrappers run their kernel path on CPU tensors (their ``_build`` hooks
pointed at the simulated library). ``--quick`` runs one case of each; the
whole set takes some minutes (flash at D = 256 is the slowest). Exits 1 if
a case fails."""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
CSRC = REPO / "transformerengine_tpu_torch" / "csrc"
FLAGS = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-ffp-contract=off",
         "-w", f"-I{HERE / 'include'}"]


UNITS = {"flash": "flash_attention*.cu",
         "decode": "decode*matvec.cu",
         "decode_attn": "*decode_attention.cu",
         "nvfp4": "nvfp4_quantize.cu",
         "norm": "*norm*.cu"}


def build(out: Path, kinds) -> Path:
    """Copies and rewrites the units of ``kinds`` (keys of ``UNITS``) and
    the headers into ``out``, compiles them and returns the shared
    library."""
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    units = [p for kind in kinds for p in sorted(CSRC.glob(UNITS[kind]))]
    for p in [*CSRC.glob("*.cuh"), *units]:
        shutil.copy(p, src / p.name)
    shutil.copy(HERE / "ptx_sim.cuh", src / "ptx.cuh")
    for p in src.iterdir():
        s = p.read_text()
        s = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                   r"(\w+)\[\];", r"\1* \2 = (\1*)sim::smem();", s)
        s = re.sub(r"(\w+)<<<(.*?)>>>\(", r"sim::launch(\1, \2)(", s)
        p.write_text(s)
    units = [src / p.name for p in units] + [HERE / "sim.cpp"]

    def compile_one(p: Path) -> Path:
        obj = src / (p.stem + ".o")
        subprocess.run(["g++", *FLAGS, "-x", "c++", "-c", str(p), "-o",
                        str(obj)], check=True)
        return obj

    with ThreadPoolExecutor(8) as ex:
        objs = list(ex.map(compile_one, units))
    lib = out / "libkernels_sim.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(lib),
                    *map(str, objs)], check=True)
    return lib


class Sim:
    """The simulated library and a context that routes the wrappers'
    kernel path to it."""

    def __init__(self, lib: Path):
        from transformerengine_tpu_torch import _build
        self._build = _build
        self.lib = ctypes.CDLL(str(lib))
        for name in ("te_flash_attention_fwd", "te_flash_attention_bwd_dq",
                     "te_flash_attention_bwd_dkv", "te_decode_tn_matvec",
                     "te_decode_kn_matvec", "te_decode_attention",
                     "te_paged_decode_attention", "te_nvfp4_amax_2x",
                     "te_nvfp4_quantize_2x", "te_mxfp8_norm_quantize",
                     "te_norm_cast_transpose"):
            if not hasattr(self.lib, name):
                continue
            fn = getattr(self.lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int

    @contextlib.contextmanager
    def on(self):
        b = self._build
        saved = (b.library, b.on_cpu, b.stream)
        b.library = lambda: self.lib
        b.on_cpu = lambda *a: False
        b.stream = lambda t: ctypes.c_void_p(0)
        try:
            yield
        finally:
            b.library, b.on_cpu, b.stream = saved


BF16_ROW_RTOL = 2 ** -6
LSE_ATOL = 1e-4
BWD_RTOL = 2 ** -6
DBIAS_RTOL = 2 ** -10


def run_case(torch, fa, sim, fails, name, dtype, b, sq, skv, hq, hkv, d,
             seed=0, do_dtype=None, **kw):
    """One case: the wrapper's kernel path on the simulation against its
    plain version, forward (O, LSE, an fp8 O's amax) and backward (dQ,
    dK, dV, dbias)."""
    def check(what, got, ref, atol):
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = math.isfinite(err) and bool((diff <= atol).all())
        print(f"  {name} {what}: {err:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fails.append(f"{name} {what}")

    def row_tol(ref, rtol):
        return rtol * ref.float().abs().amax(dim=-1, keepdim=True)

    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    do = torch.randn((b, sq, hq, d), generator=g)
    fp8 = dtype == torch.float8_e4m3fn
    extra = {}
    if fp8:
        si = torch.stack([t.abs().max() / 448 for t in (q, k, v)]).float()
        q, k, v = (t / s for t, s in zip((q, k, v), si))
        extra["scale_invs"] = si
    q, k, v = (t.to(dtype) for t in (q, k, v))
    t0 = time.time()
    with sim.on():
        got = fa.flash_fwd(q, k, v, scale=d ** -0.5, **extra, **kw)
    ref = fa.flash_fwd(q, k, v, scale=d ** -0.5, **extra, **kw)
    print(f"[{name}] forward {time.time() - t0:.1f} s", flush=True)
    o_ref, lse_ref = ref[0], ref[1]
    if o_ref.dtype == torch.float8_e4m3fn:
        check("O (fp8)", got[0], o_ref, row_tol(o_ref, 2 ** -3) + 1e-6)
        check("O amax", got[2], ref[2], 1e-2 * float(ref[2]))
    else:
        check("O", got[0], o_ref, row_tol(o_ref, BF16_ROW_RTOL))
    check("LSE", got[1], lse_ref, LSE_ATOL)
    bkw = {n: x for n, x in kw.items() if n not in ("out_dtype",
                                                   "out_scale")}
    dos = do.to(do_dtype or (torch.bfloat16 if fp8 else dtype))
    if o_ref.dtype == torch.float8_e4m3fn:
        extra.update(o_scale_inv=torch.tensor([1.0]),
                     do_scale_inv=torch.tensor([0.5]))
        dos = (do * 2).to(torch.float8_e5m2)
    t0 = time.time()
    with sim.on():
        got = fa.flash_bwd(q, k, v, o_ref, lse_ref, dos, scale=d ** -0.5,
                           **extra, **bkw)
    ref = fa.flash_bwd(q, k, v, o_ref, lse_ref, dos, scale=d ** -0.5,
                       **extra, **bkw)
    print(f"[{name}] backward {time.time() - t0:.1f} s", flush=True)
    for what, a, r in zip(("dQ", "dK", "dV", "dbias"), got, ref):
        rtol = DBIAS_RTOL if what == "dbias" else BWD_RTOL
        check(what, a, r, rtol * float(r.float().abs().max()) + 1e-30)


def cases(torch):
    """(name, dtype, B, Sq, Skv, Hq, Hkv, D, kwargs): the tensor-core
    bodies at their tiles' edges, every branch, and the FMA body."""
    from transformerengine_tpu_torch.flex_attention import (
        AlibiMod, SoftCapMod)
    bf, e4, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    lens = torch.tensor([130, 7], dtype=torch.int32)
    seg = torch.tensor([[1] * 50 + [2] * 70 + [0] * 30 + [3] * 50,
                        [5] * 200], dtype=torch.int32)
    seed = torch.tensor([0x1234567, -0x2468ACE], dtype=torch.int32)
    drop = dict(dropout_probability=0.1, dropout_seed=seed)
    out = []
    for dt in (bf, e4):
        for d in (64, 128, 256):
            for hq, hkv in ((4, 4), (8, 2), (8, 1)):
                out.append((f"{dt} D{d} G{hq // hkv} 200x136", dt, 2, 200,
                            136, hq, hkv, d, dict(causal=True, offset=-64)))
    out += [
        ("bf16 D80", bf, 2, 100, 90, 4, 2, 80, dict(causal=True,
                                                     offset=-10)),
        ("e4m3 D144", e4, 1, 70, 100, 4, 2, 144, dict(causal=True,
                                                       offset=30)),
        ("bf16 lengths", bf, 2, 130, 130, 4, 2, 64,
         dict(causal=True, q_seqlens=lens, kv_seqlens=lens)),
        ("bf16 window sink", bf, 2, 200, 200, 4, 2, 64,
         dict(causal=True, window=(37, 0), softmax_sink=torch.randn(4))),
        ("bf16 two-sided window", bf, 1, 150, 150, 4, 2, 128,
         dict(causal=False, window=(20, 30))),
        ("bf16 segments", bf, 2, 200, 200, 4, 2, 64,
         dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
        ("e4m3 segments", e4, 2, 200, 200, 4, 2, 64,
         dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)),
        ("bf16 bias", bf, 2, 150, 150, 4, 2, 64,
         dict(causal=False, bias=torch.randn(1, 4, 150, 150))),
        ("bf16 alibi", bf, 2, 150, 150, 4, 2, 64,
         dict(causal=True, score_mod=AlibiMod(4))),
        ("bf16 soft cap", bf, 2, 150, 150, 4, 2, 128,
         dict(causal=True, score_mod=SoftCapMod(5.0))),
        ("bf16 dropout", bf, 2, 150, 130, 4, 2, 64,
         dict(causal=True, offset=-20, **drop)),
        ("bf16 soft cap dropout", bf, 2, 150, 150, 4, 2, 64,
         dict(causal=True, score_mod=SoftCapMod(5.0), **drop)),
        ("e4m3 dropout", e4, 2, 150, 150, 4, 2, 64,
         dict(causal=True, **drop)),
        ("e4m3 fp8 O, e5m2 dO", e4, 2, 150, 150, 4, 2, 64,
         dict(causal=True, out_dtype=e4, out_scale=torch.tensor([2.0]))),
        ("e4m3 f32 dO (the FMA backward)", e4, 2, 100, 100, 4, 2, 64,
         dict(causal=True, do_dtype=f32)),
        ("f32 lengths (the FMA bodies)", f32, 2, 70, 70, 4, 2, 128,
         dict(causal=True, q_seqlens=torch.tensor([70, 33],
                                                  dtype=torch.int32),
              kv_seqlens=torch.tensor([70, 33], dtype=torch.int32))),
    ]
    for qoff, win in ((256, (-1, -1)), (63, (37, 0)), (-1, (2, 0)),
                      (-300, (-1, -1))):
        w = tuple(torch.tensor([x], dtype=torch.int32) if x >= 0 else x
                  for x in win)
        out.append((f"bf16 qoff {qoff} window {win}", bf, 1, 128, 256, 4,
                    2, 64, dict(causal=True, window=w,
                                q_position_offset=torch.tensor(
                                    [qoff], dtype=torch.int32))))
    return out


# The decode GEMMs against their plain versions: f32 sums over K in another
# order, 1e-4 of the largest output (chip_smoke.py [3a], [3d] and [3n]).
MATVEC_RTOL = 1e-4


def hold(fails, name, got, ref, atol) -> None:
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = math.isfinite(err) and err <= atol
    print(f"  {name}: {err:.3e} (tolerance {atol:.1e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fails.append(name)


def same_rows(fails, name, small, big) -> None:
    """Row m of out must not depend on M: M rows against the first M of a
    larger M, bit for bit."""
    ok = torch_equal(small, big[:small.shape[0]])
    print(f"  {name}: rows of M={small.shape[0]} against M={big.shape[0]} "
          f"{'equal' if ok else 'DIFFER'}", flush=True)
    if not ok:
        fails.append(name)


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def run_tn(torch, dm, sim, fails, m, n, k, xt, wt, seed=0) -> None:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(xt)
    w = torch.randn((n, k), generator=g)
    s = None
    if wt == torch.float8_e4m3fn:
        s = (w.abs().amax() / 448.0).reshape(1)
        w = w / s
    w = w.to(wt)
    name = f"tn M={m} N={n} K={k} x {xt} w {wt}"
    t0 = time.time()
    with sim.on():
        got = dm.decode_tn_matvec(x, w, s)
        one = dm.decode_tn_matvec(x[:1], w, s)
    print(f"[{name}] {time.time() - t0:.1f} s", flush=True)
    ref = dm.decode_tn_matvec_plain(x, w, s)
    hold(fails, name, got, ref, MATVEC_RTOL * float(ref.abs().max()))
    same_rows(fails, name, one, got)


def kn_operands(torch, g, m, k, n, packed, block, xt):
    """x and a block-scaled (K, N) weight as chip_smoke.kn_operands makes
    them: e4m3 codes with power-of-two bf16 scales, or packed e2m1 codes
    with e4m3-valued bf16 scales and an out_scale."""
    x = torch.randn((m, k), generator=g).to(xt)
    if packed:
        payload = torch.randint(0, 256, (k // 2, n), generator=g,
                                dtype=torch.uint8)
        scale = (torch.rand((k // block, n), generator=g) * 4 + 0.05).to(
            torch.float8_e4m3fn).to(torch.bfloat16)
        out_scale = torch.tensor([0.37])
    else:
        payload = torch.randn((k, n), generator=g).to(torch.float8_e4m3fn)
        exp = torch.randint(-12, -5, (k // block, n), generator=g)
        scale = torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                            exp).to(torch.bfloat16)
        out_scale = None
    return x, payload, scale, out_scale


def run_kn(torch, dm, sim, fails, m, k, n, packed, block, xt,
           seed=0) -> None:
    g = torch.Generator().manual_seed(seed)
    x, p, sc, o = kn_operands(torch, g, m, k, n, packed, block, xt)
    name = (f"kn M={m} K={k} N={n} block {block} x {xt} "
            f"{'packed e2m1' if packed else 'e4m3'}")
    t0 = time.time()
    with sim.on():
        got = dm.decode_kn_matvec(x, p, sc, o, block=block, packed=packed)
        one = dm.decode_kn_matvec(x[:1], p, sc, o, block=block,
                                  packed=packed)
    print(f"[{name}] {time.time() - t0:.1f} s", flush=True)
    ref = dm.decode_kn_matvec_plain(x, p, sc, o, block=block, packed=packed)
    hold(fails, name, got, ref, MATVEC_RTOL * float(ref.abs().max()))
    same_rows(fails, name, one, got)


def decode_cases(torch):
    """(function, args): each M tier of both tensor-core bodies, ragged N,
    K with a tail (a 64-k step's part, a chunk's part), blocks of 16, 32
    and 48, packed and not, several chunks and one, one and two 16-row
    tiles a block (the simulation's card holds 264 blocks); and the FMA
    bodies (an f32 x, a block of 8)."""
    bf, e4, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    return [
        (run_tn, (8, 100, 1040, bf, e4)),
        (run_tn, (3, 70, 208, bf, bf)),
        (run_tn, (12, 33, 96, bf, e4)),
        (run_tn, (17, 40, 336, bf, e4)),
        (run_tn, (32, 50, 144, bf, bf)),
        (run_tn, (3, 4300, 64, bf, e4)),
        (run_tn, (5, 40, 160, f32, e4)),
        (run_kn, (8, 1024, 256, False, 32, bf)),
        (run_kn, (8, 1056, 1040, True, 16, bf)),
        (run_kn, (3, 480, 160, False, 48, bf)),
        (run_kn, (12, 640, 160, True, 32, bf)),
        (run_kn, (17, 512, 144, False, 32, bf)),
        (run_kn, (32, 256, 128, True, 16, bf)),
        (run_kn, (5, 512, 272, False, 16, f32)),
        (run_kn, (4, 256, 128, False, 8, bf)),
    ]


# The decode attention kernels against their plain versions, at phase 3's
# tolerances (chip_smoke.py [3c], [3d], [3l] and [3m]). The contiguous
# kernel's plain version is the reference's einsum form, which rounds the
# softmax weights (and, for an e4m3 or bf16 cache, q) to bf16: f32 outputs
# of it are held at 2e-2 of the largest output, 1e-4 on an f32 cache. The
# paged plain version keeps f32 throughout: 1e-5. bf16 outputs: 2^-6 of
# each row's largest element.
ATTN_F32_RTOL = {"contiguous": 2e-2, "contiguous f32": 1e-4, "paged": 1e-5}


def attn_tolerance(ref, paged: bool, qt, ct):
    import torch
    if qt == torch.bfloat16:
        return BF16_ROW_RTOL * ref.float().abs().amax(dim=-1, keepdim=True)
    key = ("paged" if paged else
           "contiguous f32" if ct == torch.float32 else "contiguous")
    return ATTN_F32_RTOL[key] * float(ref.abs().max())


def attn_inputs(torch, g, b: int, s: int, hq: int, hkv: int, d: int, qt, ct,
                lead: int):
    """q (B, 1, Hq, D) and K/V of (lead, S, Hkv, D) rows at each row's own
    magnitude (2^-2 to 2^2), with (B,) dequant scales: e4m3 payloads
    quantized by each row's calibrated scale, bf16 and f32 ones at scales
    of 0.5-1.5."""
    mag = 2.0 ** (torch.arange(lead) % 5 - 2.0)
    k = torch.randn((lead, s, hkv, d), generator=g) * mag[:, None, None, None]
    v = torch.randn((lead, s, hkv, d), generator=g) * mag[:, None, None, None]
    if ct == torch.float8_e4m3fn:
        dq = torch.maximum(k.abs().amax(dim=(1, 2, 3)),
                           v.abs().amax(dim=(1, 2, 3))) / 448.0
        k, v = (t / dq[:, None, None, None] for t in (k, v))
    else:
        dq = torch.rand(lead, generator=g) + 0.5
    q = torch.randn((b, 1, hq, d), generator=g).to(qt)
    return q, k.to(ct), v.to(ct), dq


def run_decode_attn(torch, sim, fails, name, qt, ct, b, hq, hkv, d, lens,
                    s=None, page=None, max_pages=None, window=-1,
                    sink=False, repeat=False, seed=0) -> None:
    """One case of ``decode_attention`` (``s``) or
    ``paged_decode_attention`` (``page``, ``max_pages``: a shuffled table
    whose entries past a row's pages are -1 on every other row): the
    kernel on the simulation against its plain version; rows of length 0
    exactly zero; with ``repeat``, two launches bitwise equal with a launch
    at another grid shape (one batch row) between them."""
    from transformerengine_tpu_torch.ops import decode_attention as da
    from transformerengine_tpu_torch.ops import paged_attention as pa
    g = torch.Generator().manual_seed(seed)
    paged = page is not None
    lengths = torch.tensor(lens, dtype=torch.int32)
    sinks = torch.randn(hq, generator=g) * 2 if sink else None
    if paged:
        n_pages = b * max_pages + 3
        q, kc, vc, dq = attn_inputs(torch, g, b, page, hq, hkv, d, qt, ct,
                                    n_pages)
        table = torch.randperm(n_pages, generator=g)[:b * max_pages].to(
            torch.int32).reshape(b, max_pages)
        for r in range(0, b, 2):
            table[r, -(-lens[r] // page):] = -1
        dq = dq[table.long().clamp_min(0)[:, 0]]

        def call(rows=slice(None)):
            return pa.paged_decode_attention(
                q[rows], kc, vc, table[rows], lengths[rows],
                kv_scale=dq[rows], softmax_sink=sinks)

        ref = pa.paged_decode_attention_plain(
            q, kc, vc, table, lengths, kv_scale=dq, scale=d ** -0.5,
            out_dtype=qt, softmax_sink=sinks)
    else:
        q, kc, vc, dq = attn_inputs(torch, g, b, s, hq, hkv, d, qt, ct, b)

        def call(rows=slice(None)):
            return da.decode_attention(
                q[rows], kc[rows], vc[rows], lengths[rows],
                kv_scale=dq[rows], window_left=window, softmax_sink=sinks)

        ref = da.decode_attention_plain(
            q, kc, vc, lengths, kv_scale=dq, scale=d ** -0.5,
            window_left=window, out_dtype=qt, softmax_sink=sinks)
        if sinks is None:
            # A row of length 0: the reference's Pallas form (the kernel's)
            # gives zeros, its einsum form (the plain version) the mean of
            # V over the masked keys.
            ref[lengths <= 0] = 0
    t0 = time.time()
    with sim.on():
        got = call()
        if repeat:
            call(slice(0, 1))
            again = call()
    print(f"[{name}] {time.time() - t0:.1f} s", flush=True)
    diff = (got.float() - ref.float()).abs()
    tol = attn_tolerance(ref, paged, qt, ct)
    err = float(diff.max())
    ok = math.isfinite(err) and bool((diff <= tol).all())
    print(f"  {name} O: {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fails.append(f"{name} O")
    for r, n in enumerate(lens):
        if n <= 0 and bool(got[r].abs().max() != 0):
            print(f"  {name}: row {r} of length 0 is not zero", flush=True)
            fails.append(f"{name} zero row")
    if repeat:
        same = torch_equal(got, again)
        print(f"  {name}: two launches, one at another grid shape between "
              f"them, {'equal' if same else 'DIFFER'}", flush=True)
        if not same:
            fails.append(f"{name} repeat")


def decode_attn_cases(torch):
    """Keyword arguments of :func:`run_decode_attn`: one split (a row of
    one tile) and many (the simulated card's 264 blocks over B * Hkv rows,
    up to the span's tiles), splits left empty (lengths 0, 1 and below one
    tile), a full cache and a full table, a window whose edge falls inside
    a split's tile and which spans split boundaries, the sink with a length
    of 0 (a zero row), G 1, 4 and 8, D 64, 128 and 256, caches e4m3, bf16
    and f32, q bf16 and f32, pages of 16 (rows look their pages up one by
    one) and of 128 (a tile's page read once); and the head groups' edges:
    G 2, 3, 5 and 32, D 48 and 80 (an odd count of 16-byte chunks)."""
    bf, e4, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    return [
        dict(name="contiguous one split", qt=bf, ct=e4, b=2, hq=8, hkv=2,
             d=128, s=64, lens=(64, 37), repeat=True),
        dict(name="contiguous many splits, lengths 528, 0, 1", qt=bf, ct=e4,
             b=3, hq=8, hkv=2, d=128, s=640, lens=(528, 0, 1), repeat=True),
        dict(name="contiguous G1 f32 below one tile and full", qt=f32,
             ct=f32, b=2, hq=4, hkv=4, d=64, s=640, lens=(40, 640)),
        dict(name="contiguous G8 window edge inside a split, sink", qt=bf,
             ct=bf, b=2, hq=16, hkv=2, d=64, s=640, lens=(600, 300),
             window=100, sink=True, repeat=True),
        dict(name="contiguous window across split boundaries", qt=f32,
             ct=e4, b=3, hq=8, hkv=2, d=128, s=512, lens=(449, 385, 512),
             window=127),
        dict(name="contiguous window edge on a tile, G1 D256", qt=f32,
             ct=bf, b=2, hq=2, hkv=2, d=256, s=448, lens=(385, 320),
             window=64),
        dict(name="contiguous sink with length 0, D256", qt=f32, ct=bf, b=3,
             hq=4, hkv=1, d=256, s=256, lens=(0, 256, 100), sink=True),
        dict(name="contiguous q bf16, f32 cache, D256 G8", qt=bf, ct=f32,
             b=2, hq=8, hkv=1, d=256, s=192, lens=(150, 3)),
        dict(name="contiguous G3 D80", qt=bf, ct=e4, b=2, hq=6, hkv=2,
             d=80, s=320, lens=(300, 129), repeat=True),
        dict(name="contiguous G32 D64", qt=f32, ct=bf, b=2, hq=64, hkv=2,
             d=64, s=192, lens=(150, 64), window=70),
        dict(name="paged one split, full table", qt=bf, ct=e4, b=2, hq=8,
             hkv=2, d=128, page=16, max_pages=4, lens=(64, 20)),
        dict(name="paged pages of 128, lengths 528, 0, 1, sink", qt=bf,
             ct=e4, b=3, hq=8, hkv=2, d=128, page=128, max_pages=5,
             lens=(528, 0, 1), sink=True, repeat=True),
        dict(name="paged pages of 16, full table, length 0 with sink",
             qt=f32, ct=f32, b=4, hq=8, hkv=2, d=64, page=16, max_pages=40,
             lens=(37, 0, 640, 5), sink=True, repeat=True),
        dict(name="paged G1 D256 bf16 pages of 32", qt=f32, ct=bf, b=2,
             hq=2, hkv=2, d=256, page=32, max_pages=6, lens=(192, 70)),
        dict(name="paged G4 e4m3 f32 q pages of 64", qt=f32, ct=e4, b=2,
             hq=8, hkv=2, d=64, page=64, max_pages=5, lens=(300, 64)),
        dict(name="paged G2 D256 e4m3", qt=f32, ct=e4, b=2, hq=4, hkv=2,
             d=256, page=64, max_pages=3, lens=(192, 100)),
        dict(name="paged G5 D48", qt=bf, ct=bf, b=2, hq=10, hkv=2, d=48,
             page=32, max_pages=4, lens=(128, 33), sink=True),
    ]


def nvfp4_input(torch, g, m: int, n: int, dtype, kind: str = "rows"):
    """x (M, N) of ``dtype``. ``rows``: normal values with rows of three
    magnitudes, 1e-3, 1 and 1e3 (``chip_smoke.nvfp4_input``'s rule: the
    small rows' blocks take subnormal e4m3 scales). ``cancel``: every
    column's runs of 16 rows are a constant or a signed Hadamard row,
    which the RHT (sign mask 0) turns into one nonzero value and 15 exact
    zeros; rows of +0 and of -0; small negative values beside a large
    one, which round to -0."""
    x = torch.randn((m, n), generator=g)
    if kind == "rows":
        x[:m // 4] *= 1e-3
        x[m // 2:] *= 1e3
        return x.to(dtype)
    i = torch.arange(16)
    ij = i[:, None] & i[None, :]
    had = 1.0 - 2.0 * (sum((ij >> b) & 1 for b in range(4)) & 1).float()
    cols = torch.arange(n)
    sign = torch.where(cols % 2 == 1, had[:, cols % 16], torch.ones(()))
    y = x[::16].repeat_interleave(16, dim=0) * sign.repeat(m // 16, 1)
    y[16:32] = 0.0
    y[32:48] = -0.0
    y[48:64:2] = -x[48:64:2].abs() * 1e-3
    y[48:64:2, ::16] = 6.0
    return y.to(dtype)


def run_nvfp4(torch, sim, fails, name, dtype, m, n, mask, seed=None,
              kind="rows", repeat=False, data_seed=0) -> None:
    """Both NVFP4 kernels on the simulation against their plain versions:
    the amaxes equal, then payloads and scale grids byte for byte under
    the tensor scales they give. With ``repeat``, two launches of each
    give equal bytes and amaxes with a launch at another shape between
    them (the amax pass's running maxima and ticket are reset)."""
    from transformerengine_tpu_torch.ops import quantize_kernels as qk
    from transformerengine_tpu_torch.quantize.qmath import (
        nvfp4_tensor_scale)
    g = torch.Generator().manual_seed(data_seed)
    x = nvfp4_input(torch, g, m, n, dtype, kind)
    t0 = time.time()
    with sim.on():
        amax = qk.nvfp4_amax_2x(x, mask)
        ts = [nvfp4_tensor_scale(a) for a in amax]
        got = qk.nvfp4_quantize_2x(x, *ts, mask, seed)
        if repeat:
            other = x[:16 * (m // 32) or 16, :n - 16 or 16].contiguous()
            qk.nvfp4_amax_2x(other, mask)
            qk.nvfp4_quantize_2x(other, *ts, mask, seed)
            again_amax = qk.nvfp4_amax_2x(x, mask)
            again = qk.nvfp4_quantize_2x(x, *ts, mask, seed)
    print(f"[{name}] {time.time() - t0:.1f} s", flush=True)
    ref_amax = qk.nvfp4_amax_2x_plain(x, mask)
    same = all(float(a) == float(r) for a, r in zip(amax, ref_amax))
    print(f"  {name} amaxes {[float(a) for a in amax]}: "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fails.append(f"{name} amax")
    ref = qk.nvfp4_quantize_2x_plain(x, *ts, mask, seed)
    for part, a, r in zip(("row", "srow", "col", "scol"), got, ref):
        bad = int((a.view(torch.uint8) != r.view(torch.uint8)).sum()) \
            if a.shape == r.shape else -1
        print(f"  {name} {part}: {bad} bytes differ "
              f"{'ok' if bad == 0 else 'FAIL'}", flush=True)
        if bad:
            fails.append(f"{name} {part}")
    if kind == "cancel":
        codes = torch.cat([got[0].view(torch.uint8).flatten(),
                           got[2].view(torch.uint8).flatten()])
        signed = int((codes == 0x80).sum()), int((codes == 0).sum())
        print(f"  {name}: {signed[0]} -0 codes, {signed[1]} +0 codes",
              flush=True)
        if not all(signed):
            fails.append(f"{name} made no -0 or no +0 code")
    if repeat:
        ok = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                 for a, b in zip(got, again)) and \
            all(torch.equal(a, b) for a, b in zip(amax, again_amax))
        print(f"  {name}: two launches, one at another shape between "
              f"them, {'equal' if ok else 'DIFFER'}", flush=True)
        if not ok:
            fails.append(f"{name} repeat")


def nvfp4_cases(torch):
    """Keyword arguments of :func:`run_nvfp4`: bf16 and f32 x, without the
    RHT, with it under sign mask 0 (the recipe's) and under other masks,
    round to nearest and seeds, shapes that are not tile multiples (48 x
    80, 208 x 336), the cancelling input with and without the RHT, and
    more tiles (17 x 17) than the simulated card's 264 blocks, so that
    blocks walk two tiles."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        dict(name="bf16 208x336 RHT mask 0", dtype=bf, m=208, n=336, mask=0,
             repeat=True),
        dict(name="bf16 208x336 no RHT", dtype=bf, m=208, n=336, mask=None,
             repeat=True),
        dict(name="f32 48x80 RHT mask 0x1234", dtype=f32, m=48, n=80,
             mask=0x1234),
        dict(name="f32 208x336 no RHT seed 7", dtype=f32, m=208, n=336,
             mask=None, seed=7),
        dict(name="bf16 48x80 RHT mask 0xBEEF seed 11", dtype=bf, m=48,
             n=80, mask=0xBEEF, seed=11),
        dict(name="bf16 208x336 RHT mask 0 seed 3", dtype=bf, m=208, n=336,
             mask=0, seed=3),
        dict(name="f32 208x336 RHT mask 0", dtype=f32, m=208, n=336, mask=0,
             data_seed=1),
        dict(name="bf16 128x256 cancelling, RHT mask 0", dtype=bf, m=128,
             n=256, mask=0, kind="cancel"),
        dict(name="f32 128x256 cancelling, no RHT", dtype=f32, m=128, n=256,
             mask=None, kind="cancel"),
        dict(name="bf16 1040x2064 RHT mask 0 (blocks walk two tiles)",
             dtype=bf, m=1040, n=2064, mask=0),
    ]


# The fused norms' statistics against the plain version's (chip_smoke.py
# RSIGMA_RTOL and its mu limit): sums in another order, f32 ulps.
RSIGMA_RTOL = 1e-6
MU_RTOL, MU_ATOL = 1e-6, 1e-7


def run_norm(torch, sim, fails, name, form, dtype, m, h, norm="rmsnorm",
             zcg=False, beta=False, q="e4m3", rowwise_only=False,
             zero_row=False, clip=False, repeat=False, seed=0) -> None:
    """One case of ``mxfp8_norm_quantize_2x`` (``form`` "mxfp8") or
    ``norm_cast_transpose`` ("tensor") on the simulation: payloads, grids
    and the amax byte for byte against the plain version from the kernel's
    own statistics; rsigma and mu within f32 ulps of the plain version's.
    ``zero_row``: rows 3 and m - 5 are zeros, whose rsigma is exactly
    1 / sqrt(eps). ``clip``: a quarter of gamma's columns scaled by 2^-140,
    so their blocks' amaxes fall below the E8M0 clip (2^-118). With
    ``repeat``, two launches bitwise equal with a launch at another shape
    between them (the per-tensor amax's ticket is reset)."""
    from transformerengine_tpu_torch.ops import quantize_kernels as qk
    qt = torch.float8_e4m3fn if q == "e4m3" else torch.float8_e5m2
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, h), generator=g) * 2 + 0.5
    gamma = torch.randn(h, generator=g) * 0.2 + (0.0 if zcg else 1.0)
    bt = torch.randn(h, generator=g) * 0.1 if beta else None
    if zero_row:
        x[3] = 0.0
        x[m - 5] = 0.0
    if clip:
        gamma[: h // 4] *= 2.0 ** -140
    x = x.to(dtype)
    eps = 1e-5
    kw = dict(norm=norm, zero_centered_gamma=zcg, epsilon=eps)
    scale = torch.tensor([40.0 if q == "e4m3" else 5000.0])
    if form == "mxfp8":
        def call(xx=x, gm=gamma, bb=bt):
            return qk.mxfp8_norm_quantize_2x(xx, gm, bb, qt, **kw,
                                             rowwise_only=rowwise_only)
        parts = ("row", "col", "srow", "scol")
        stats_at = 4
    else:
        def call(xx=x, gm=gamma, bb=bt):
            return qk.norm_cast_transpose(xx, gm, bb, scale, qt, **kw)
        parts = ("row", "col", "amax")
        stats_at = 3
    t0 = time.time()
    with sim.on():
        got = call()
        if repeat:
            hh = h // 2 if h % 256 == 0 else h
            call(x[:m // 2 if m % 64 == 0 else 32, :hh].contiguous(),
                 gamma[:hh].contiguous(), None if bt is None else
                 bt[:hh].contiguous())
            again = call()
    print(f"[{name}] {time.time() - t0:.1f} s", flush=True)
    layernorm = norm == "layernorm"
    rsigma = got[stats_at]
    mu = got[stats_at + 1] if layernorm else None
    if form == "mxfp8":
        own = qk.mxfp8_norm_quantize_2x_plain(
            x, gamma, bt, qt, **kw, rowwise_only=rowwise_only,
            stats=(mu, rsigma))
        ref = qk.mxfp8_norm_quantize_2x_plain(x, gamma, bt, qt, **kw,
                                              rowwise_only=rowwise_only)
    else:
        own = qk.norm_cast_transpose_plain(x, gamma, bt, scale, qt, **kw,
                                           stats=(mu, rsigma))
        ref = qk.norm_cast_transpose_plain(x, gamma, bt, scale, qt, **kw)
    for part, a, r in zip(parts, got, own):
        if r is None:
            bad = 0 if a is None else -1
        elif a is None or a.shape != r.shape:
            bad = -1
        elif part == "amax":
            bad = int(a.float() != r.float())
        else:
            bad = int((a.view(torch.uint8) != r.view(torch.uint8)).sum())
        print(f"  {name} {part}: {bad} bytes differ from the plain version "
              f"on the kernel's statistics {'ok' if bad == 0 else 'FAIL'}",
              flush=True)
        if bad:
            fails.append(f"{name} {part}")
    hold(fails, f"{name} rsigma", rsigma, ref[stats_at],
         RSIGMA_RTOL * float(ref[stats_at].abs().max()))
    if layernorm:
        hold(fails, f"{name} mu", mu, ref[stats_at + 1],
             MU_RTOL * float(ref[stats_at + 1].abs().max()) + MU_ATOL)
    if zero_row:
        want = float(1.0 / torch.sqrt(torch.tensor(eps, dtype=torch.float32)))
        ok = float(rsigma[3]) == want == float(rsigma[m - 5])
        print(f"  {name}: zero rows' rsigma {float(rsigma[3])!r} "
              f"{'equal' if ok else 'DIFFERS from'} 1 / sqrt(eps) {want!r}",
              flush=True)
        if not ok:
            fails.append(f"{name} zero row")
    if clip and form == "mxfp8":
        clipped = int((got[2] == 0).sum())
        print(f"  {name}: {clipped} rowwise blocks at the E8M0 clip",
              flush=True)
        if not clipped:
            fails.append(f"{name} reached no clipped block")
    if repeat:
        def same(a, b):
            if a is None or b is None:
                return a is None and b is None
            return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

        ok = all(same(a, b) for a, b in zip(got, again))
        print(f"  {name}: two launches, one at another shape between them, "
              f"{'equal' if ok else 'DIFFER'}", flush=True)
        if not ok:
            fails.append(f"{name} repeat")


def norm_cases(torch):
    """Keyword arguments of :func:`run_norm`, each named with the cluster
    size C, the slices and the tiles its shape gives (make_plan in
    csrc/norm_quant.cuh: the smallest C of 2, 4 and 8 whose slice of 32
    rows fits 32 KB; two tiles of the slice where they fit 192 KB, else
    x read twice in chunks):
    bf16 and f32 x, RMSNorm and LayerNorm with beta, zero-centered gamma,
    e4m3 and e5m2, both orientations and rowwise only, 32-column blocks
    that do not divide evenly over C, a ragged last strip (M = 264, the
    per-tensor form), zero rows, blocks below the E8M0 clip, more strips
    than the clusters the simulation holds at once (16 blocks over C:
    clusters walk several strips, each strip's tile loaded during the one
    before), shapes past the two tiles' budget (x read twice, in chunks),
    and two launches equal with one at another shape between."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        dict(name="mxfp8 bf16 RMSNorm 2x e4m3, C 8 (blocks 8 and 9), zero "
             "rows, repeat", form="mxfp8", dtype=bf, m=64, h=2080,
             zero_row=True, repeat=True),
        dict(name="mxfp8 f32 LayerNorm beta 2x e5m2, C 8 (blocks 8 and 9)",
             form="mxfp8", dtype=f32, m=64, h=2080, norm="layernorm",
             beta=True, q="e5m2"),
        dict(name="mxfp8 bf16 LayerNorm beta zero-centered rowwise-only "
             "e4m3, C 4 (blocks 8/8/8/9)", form="mxfp8", dtype=bf, m=96,
             h=1056, norm="layernorm", beta=True, zcg=True,
             rowwise_only=True),
        dict(name="mxfp8 bf16 RMSNorm zero-centered 2x e5m2, C 2 (blocks "
             "8/8)", form="mxfp8", dtype=bf, m=64, h=512, zcg=True,
             q="e5m2"),
        dict(name="mxfp8 f32 RMSNorm 2x below the E8M0 clip, C 2",
             form="mxfp8", dtype=f32, m=32, h=256, clip=True),
        dict(name="mxfp8 f32 RMSNorm 2x, 5 strips over 2 clusters of 8 "
             "(blocks 4 and 5), repeat", form="mxfp8", dtype=f32, m=160,
             h=1056, repeat=True),
        dict(name="mxfp8 f32 LayerNorm beta 2x past the budget (C 8, "
             "blocks 30, chunks of 256 columns), 3 strips over 2 clusters",
             form="mxfp8", dtype=f32, m=96, h=7680, norm="layernorm",
             beta=True),
        dict(name="mxfp8 f32 LayerNorm beta 2x past the budget (C 8, "
             "blocks 48 and 49, chunks of 256 columns)", form="mxfp8",
             dtype=f32, m=32, h=12320, norm="layernorm", beta=True),
        dict(name="tensor bf16 RMSNorm e4m3, M 264 (a strip of 8 rows), "
             "C 2, repeat", form="tensor", dtype=bf, m=264, h=384,
             repeat=True),
        dict(name="tensor f32 LayerNorm beta zero-centered e5m2, M 264, "
             "C 8 (blocks 8 and 9)", form="tensor", dtype=f32, m=264,
             h=2176, norm="layernorm", beta=True, zcg=True, q="e5m2"),
        dict(name="tensor bf16 LayerNorm beta e4m3, zero rows, C 4",
             form="tensor", dtype=bf, m=64, h=1152, norm="layernorm",
             beta=True, zero_row=True),
        dict(name="tensor f32 RMSNorm e4m3, M 136: 5 strips (the last of 8 "
             "rows) over 2 clusters of 8", form="tensor", dtype=f32, m=136,
             h=1152),
        dict(name="tensor f32 RMSNorm e4m3 past the budget (C 8, blocks 48 "
             "and 49), M 40, repeat", form="tensor", dtype=f32, m=40,
             h=12416, repeat=True),
    ]


SWEEP = HERE / "nvfp4_sweep.cpp"


def nvfp4_sweep(out: Path, threads: int = 4) -> tuple:
    """Builds and runs ``nvfp4_sweep.cpp``: (exit code, its output)."""
    exe = out / "nvfp4_sweep"
    subprocess.run(["g++", *FLAGS[:1], "-O2", *FLAGS[2:], f"-I{CSRC}",
                    str(SWEEP), str(HERE / "sim.cpp"), "-o", str(exe)],
                   check=True)
    done = subprocess.run([str(exe), str(threads)], capture_output=True,
                          text=True)
    return done.returncode, done.stdout + done.stderr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernels",
                    default="flash,decode,decode_attn,nvfp4,norm",
                    help="comma-separated: flash, decode, decode_attn, "
                    "nvfp4, norm")
    ap.add_argument("--out", help="build directory (default: a temporary "
                    "one)")
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(4)
    from transformerengine_tpu_torch.ops import decode_matmul as dm
    from transformerengine_tpu_torch.ops import flash_attention as fa
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        sim = Sim(build(out, kinds))
        print(f"built in {time.time() - t0:.1f} s", flush=True)
        fails: list = []
        if "decode" in kinds:
            todo = decode_cases(torch)
            for fn, shape in (todo[:1] + todo[7:8] if args.quick else todo):
                fn(torch, dm, sim, fails, *shape)
        if "decode_attn" in kinds:
            todo = decode_attn_cases(torch)
            for case in (todo[1:2] + todo[-3:-2] if args.quick else todo):
                run_decode_attn(torch, sim, fails, **case)
        if "nvfp4" in kinds:
            todo = nvfp4_cases(torch)
            for case in (todo[:2] if args.quick else todo):
                run_nvfp4(torch, sim, fails, **case)
            rc, log = nvfp4_sweep(out)
            print(log, end="", flush=True)
            if rc:
                fails.append("nvfp4 rounding sweep")
        if "norm" in kinds:
            todo = norm_cases(torch)
            for case in (todo[:1] + todo[8:9] if args.quick else todo):
                run_norm(torch, sim, fails, **case)
        if "flash" in kinds:
            todo = cases(torch)
            for name, dt, *shape, kw in (todo[:1] if args.quick else todo):
                do_dtype = kw.pop("do_dtype", None)
                run_case(torch, fa, sim, fails, name, dt, *shape,
                         do_dtype=do_dtype, **kw)
    print("failed:", fails or "none")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
