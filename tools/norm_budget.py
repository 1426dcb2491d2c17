#!/usr/bin/env python3
"""Times the fused norm-quantize kernels (``PERF.md`` §6 rows 6 and 9) as
built with each shared-memory budget of ``csrc/norm_quant.cuh``
(``TE_NORM_QUANT_BUDGET``: the cluster size C is the smallest of 2, 4 and 8
whose slice of 32 rows fits it), on one card, in turns.

    python3 tools/norm_budget.py [--budgets 32768,65536,131072] [--turns 2]

Each budget gets a library of its own holding only the two norm units
(``nvcc -shared``, seconds, under ``transformerengine_tpu_torch/_build/``,
with each instance's registers and spills from ``-Xptxas -v``), and the
wrappers are pointed at it in turn. At (4096, 4096) bf16 every turn holds
each call to the plain version on the kernel's own statistics (bytes and
amax equal) and times, with ``chip_smoke.Timer`` (CUDA-graph replays, L2
flushed): row 9 (``mxfp8_norm_quantize_2x``, RMSNorm, both orientations),
its rowwise-only form, its LayerNorm form with beta (the encoder's), row 6
(``norm_cast_transpose``, RMSNorm, e4m3) and the timer's copy yardstick
(``dst.copy_(x)``). Prints the card's name and power limit, one JSON line
of label -> ms per turn and budget, and last one JSON line of each
budget's medians. Needs one CUDA card and nvcc."""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

UNITS = ("mxfp8_norm_quantize.cu", "norm_cast_transpose.cu")
NAMES = ("te_mxfp8_norm_quantize", "te_norm_cast_transpose")


def build(budget: int) -> ctypes.CDLL:
    """The two norm units compiled with ``budget`` into a library of their
    own; prints each kernel instance's registers and spills."""
    from transformerengine_tpu_torch import _build
    out = _build.BUILD_DIR / f"norm_budget_{budget}"
    out.mkdir(parents=True, exist_ok=True)
    flags = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-DTE_NORM_QUANT_BUDGET={budget}", f"-I{_build.CSRC}"]

    def compile_one(unit: str) -> Path:
        obj = out / (Path(unit).stem + ".o")
        done = subprocess.run([*flags, "-c", str(_build.CSRC / unit), "-o",
                               str(obj)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc {unit}:\n{done.stdout}{done.stderr}")
        for entry in _build._ptxas_summary(done.stdout + done.stderr):
            print(f"[budget {budget} {unit}] {entry}", flush=True)
        return obj

    with ThreadPoolExecutor(len(UNITS)) as ex:
        objs = list(ex.map(compile_one, UNITS))
    lib_path = out / "libnorm.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    *map(str, objs), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def turn(torch, timer, inputs) -> dict:
    """One turn on the library that ``_build.library`` returns now: each
    call checked, then timed."""
    from transformerengine_tpu_torch.ops import quantize_kernels as qk
    x, gamma, beta, scale = inputs
    e4m3 = torch.float8_e4m3fn
    rms = dict(norm="rmsnorm", zero_centered_gamma=False, epsilon=1e-5)
    ln = dict(norm="layernorm", zero_centered_gamma=False, epsilon=1e-5)
    calls = {
        "9": lambda: qk.mxfp8_norm_quantize_2x(x, gamma, None, e4m3, **rms),
        "9 rowwise-only": lambda: qk.mxfp8_norm_quantize_2x(
            x, gamma, None, e4m3, **rms, rowwise_only=True),
        "9 layernorm": lambda: qk.mxfp8_norm_quantize_2x(
            x, gamma, beta, e4m3, **ln),
        "6": lambda: qk.norm_cast_transpose(x, gamma, None, scale, e4m3,
                                            **rms),
    }
    ms = {}
    for label, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        if label.startswith("9"):
            kw = ln if "layernorm" in label else rms
            layernorm = "layernorm" in label
            own = qk.mxfp8_norm_quantize_2x_plain(
                x, gamma, beta if layernorm else None, e4m3, **kw,
                rowwise_only="rowwise" in label,
                stats=(got[5] if layernorm else None, got[4]))
            pairs = list(zip(got[:4], own[:4]))
        else:
            own = qk.norm_cast_transpose_plain(x, gamma, None, scale, e4m3,
                                               **rms, stats=(None, got[3]))
            pairs = list(zip(got[:3], own[:3]))
        for a, r in pairs:
            if (a is None) != (r is None) or (
                    a is not None and not torch.equal(
                        a.view(torch.uint8), r.view(torch.uint8))):
                raise AssertionError(f"row {label} disagrees with its plain "
                                     f"version on its own statistics")
        ms[label] = timer(call)
    dst = torch.empty_like(x)
    ms["copy"] = timer(lambda: dst.copy_(x))
    return ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budgets", default="32768,65536,131072")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from transformerengine_tpu_torch import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    budgets = [int(b) for b in args.budgets.split(",")]
    with ThreadPoolExecutor(len(budgets)) as ex:
        libs = dict(zip(budgets, ex.map(build, budgets)))
    g = torch.Generator(device="cuda").manual_seed(19)
    m = h = 4096
    x = torch.randn((m, h), generator=g, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((h,), generator=g, device="cuda")
    beta = 0.1 * torch.randn((h,), generator=g, device="cuda")
    scale = torch.tensor([40.0], device="cuda")
    timer = chip_smoke.Timer(torch)
    readings = {b: [] for b in budgets}
    saved = _build.library
    try:
        for _ in range(args.turns):
            for b in budgets + budgets[::-1]:
                _build.library = lambda lib=libs[b]: lib
                ms = turn(torch, timer, (x, gamma, beta, scale))
                readings[b].append(ms)
                print(json.dumps({"budget": b, "ms": ms}), flush=True)
    finally:
        _build.library = saved
    print(json.dumps({str(b): {k: statistics.median(r[k] for r in rs)
                               for k in rs[0]}
                      for b, rs in readings.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
