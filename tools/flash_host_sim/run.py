#!/usr/bin/env python3
"""Runs the flash attention kernels' CUDA sources on the CPU, in a host
simulation, through the port's own wrappers, and holds each result to the
wrapper's plain version (the tolerances of ``chip_smoke.py`` phase 3).

    python3 tools/flash_host_sim/run.py [--quick] [--out DIR]

No CUDA toolkit is needed: ``g++`` (C++20, pthreads) compiles the flash
units (``csrc/flash_attention*.cu``) against the headers here, which
stand in for the CUDA ones. Each block's threads are ``std::thread``s,
``__syncthreads`` a barrier, and the warp-wide instructions of
``csrc/ptx.cuh`` (ldmatrix, mma.sync, cp.async) are replaced by
``ptx_sim.cuh``, which exchanges each lane's operands through a per-warp
buffer and computes every lane's fragment from the PTX layouts. So a
wrong fragment index, mask, tile edge or stage shows here as a wrong
result; the timing, the hardware's summation order and the compiler's
register use show only on the card. Launches with ``<<<...>>>`` and
``extern __shared__`` arrays are rewritten in a copy of the sources;
the wrappers run their kernel path on CPU tensors (their ``_build``
hooks pointed at the simulated library). ``--quick`` runs one case; the
whole set takes some minutes (D = 256 is the slowest). Exits 1 if a case
fails."""
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


def build(out: Path) -> Path:
    """Copies and rewrites the flash sources into ``out``, compiles them
    and returns the shared library."""
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for p in [CSRC / "common.cuh", CSRC / "flash_mma.cuh",
              *CSRC.glob("flash_attention*.cu")]:
        shutil.copy(p, src / p.name)
    shutil.copy(HERE / "ptx_sim.cuh", src / "ptx.cuh")
    for p in src.iterdir():
        s = p.read_text()
        s = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                   r"(\w+)\[\];", r"\1* \2 = (\1*)sim::smem();", s)
        s = re.sub(r"(\w+)<<<(.*?)>>>\(", r"sim::launch(\1, \2)(", s)
        p.write_text(s)
    units = sorted(src.glob("flash_attention*.cu")) + [HERE / "sim.cpp"]

    def compile_one(p: Path) -> Path:
        obj = src / (p.stem + ".o")
        subprocess.run(["g++", *FLAGS, "-x", "c++", "-c", str(p), "-o",
                        str(obj)], check=True)
        return obj

    with ThreadPoolExecutor(8) as ex:
        objs = list(ex.map(compile_one, units))
    lib = out / "libflash_sim.so"
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
                     "te_flash_attention_bwd_dkv"):
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", help="build directory (default: a temporary "
                    "one)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(4)
    from transformerengine_tpu_torch.ops import flash_attention as fa
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(args.out or tmp)
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        sim = Sim(build(out))
        print(f"built in {time.time() - t0:.1f} s", flush=True)
        fails: list = []
        todo = cases(torch)
        for name, dt, *shape, kw in (todo[:1] if args.quick else todo):
            do_dtype = kw.pop("do_dtype", None)
            run_case(torch, fa, sim, fails, name, dt, *shape,
                     do_dtype=do_dtype, **kw)
    print("failed:", fails or "none")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
