#!/usr/bin/env python3
"""Times the tensor-core kernels' rows of two checkouts on one card, in
turns (parent, change, change, parent by default).

    python3 tools/flash_ab.py PARENT_DIR CHANGE_DIR [--order 0,1,1,0]
                              [--group flash|decode|decode_attn|nvfp4|norm|all]

Each turn runs, in a process of its own, the checkout's own
``chip_smoke.py`` row checks, which build its kernels on first use, hold
each kernel to its plain version and time it (CUDA-graph replays, L2
flushed). ``flash`` (the flash attention kernels): rows 2 and 4, their
FP8 branches 2f, 2o, 4f and 4o, and their runtime-position branches 2q,
2fq, 4q and 4fq (``check_flash``, ``check_flash_bwd``,
``check_flash_fp8``, ``check_flash_bwd_fp8``, ``check_flash_qoff`` and
``check_flash_bwd_qoff``). ``decode`` (the decode GEMMs): rows 1 and 1b
(``decode_tn_matvec`` on fp8 and bf16 weights, ``check_matvec``) and 13
and 13p (``decode_kn_matvec`` on e4m3 and packed e2m1 weights,
``check_kn_matvec``), each with its library call's time beside it (as
``<row> lib``). ``decode_attn`` (the decode attention kernels): rows 3
(``decode_attention``, ``check_decode_attention``) and 14
(``paged_decode_attention``, ``check_paged_attention``) with their library
calls' times, and row 3 at GPT-OSS's decode shape with its window and sink
(``3g``), timed in either tree by this checkout's ``check_decode_gptoss``
(the wrapper's API is the same in both). ``nvfp4`` (the NVFP4 quantize
kernels): rows 10 (``nvfp4_amax_2x``) and 11 (``nvfp4_quantize_2x``) at
the MLP's shape with the RHT (``check_nvfp4_quantize``), and, timed in
either tree by this checkout's ``time_nvfp4_shapes``, both kernels at
every ``[3o]`` shape without and with the RHT and the timer's two
yardsticks (``torch.aminmax`` and a copy of x, as ``3o aminmax`` and
``3o copy``). ``norm`` (the fused norm-quantize kernels): rows 6
(``norm_cast_transpose`` through ``quantize_normed``, ``check_norm_cast``)
and 9 (``mxfp8_norm_quantize_2x`` through ``quantize_normed``,
``check_mxfp8_norm``) at (4096, 4096) bf16, and, timed in either tree by
this checkout's ``time_norm_shapes``, row 9 rowwise-only and as LayerNorm
with beta, row 6 through its wrapper alone and the timer's copy of x (as
``norm 9 rowwise-only``, ``norm 9 layernorm``, ``norm 6 wrapper``,
``norm copy``). Prints the card's name and power limit, one JSON line of
row -> ms per turn, and last one JSON line of each checkout's per-row
median. Needs one CUDA card."""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROWS = {"flash_attention_fwd": "2", "flash_attention_fwd_fp8": "2f",
        "flash_attention_fwd_fp8_mha": "2o", "flash_attention_fwd_qoff": "2q",
        "flash_attention_fwd_fp8_qoff": "2fq", "flash_attention_bwd": "4",
        "flash_attention_bwd_fp8": "4f", "flash_attention_bwd_fp8_mha": "4o",
        "flash_attention_bwd_qoff": "4q", "flash_attention_bwd_fp8_qoff": "4fq",
        "decode_tn_matvec": "1", "decode_tn_matvec_bf16": "1b",
        "decode_kn_matvec": "13", "decode_kn_matvec_packed": "13p",
        "decode_attention": "3", "paged_decode_attention": "14",
        "decode_attention_gptoss": "3g", "nvfp4_amax_2x": "10",
        "nvfp4_quantize_2x": "11", "nvfp4_shapes": "3o",
        "norm_cast_transpose": "6", "mxfp8_norm_quantize_2x": "9",
        "norm_shapes": "norm"}

CHECKS = {"flash": ("check_flash", "check_flash_bwd", "check_flash_fp8",
                    "check_flash_bwd_fp8", "check_flash_qoff",
                    "check_flash_bwd_qoff"),
          "decode": ("check_matvec", "check_kn_matvec"),
          "decode_attn": ("check_decode_attention", "check_paged_attention"),
          "nvfp4": ("check_nvfp4_quantize",),
          "norm": ("check_norm_cast", "check_mxfp8_norm")}
# Rows timed by functions of this checkout's chip_smoke.py (which return
# the time, or a dict of label -> time) on each tree's port: results key
# -> function.
EXTRAS = {"decode_attn": (("decode_attention_gptoss",
                           "check_decode_gptoss"),),
          "nvfp4": (("nvfp4_shapes", "time_nvfp4_shapes"),),
          "norm": (("norm_shapes", "time_norm_shapes"),)}
HERE_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

TURN = """
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from transformerengine_tpu_torch import _build
_build.library()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
timer, results = cs.Timer(torch), {}
for name in %r:
    getattr(cs, name)(torch, timer, results)
    torch.cuda.empty_cache()
ms = {k: r["ms"] for k, r in results.items()}
ms.update({k + " lib": r["library_ms"] for k, r in results.items()
           if r.get("library_ms") is not None})
extras = %r
if extras:
    spec = importlib.util.spec_from_file_location("ab_helpers", %r)
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    for key, name in extras:
        got = getattr(helpers, name)(torch, timer)
        if isinstance(got, dict):
            ms.update({key + " " + k: v for k, v in got.items()})
        else:
            ms[key] = got
print("TURN " + json.dumps(ms))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, help="the parent's and the change's "
                    "checkout directories")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--group", choices=("flash", "decode", "decode_attn",
                                        "nvfp4", "norm", "all"),
                    default="all")
    args = ap.parse_args()
    checks = sum((CHECKS[g] for g in CHECKS
                  if args.group in (g, "all")), ())
    extras = sum((EXTRAS[g] for g in EXTRAS
                  if args.group in (g, "all")), ())
    trees = [Path(t).resolve() for t in args.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    readings = {0: [], 1: []}
    for i in map(int, args.order.split(",")):
        out = subprocess.run([sys.executable, "-c",
                              TURN % (checks, extras, str(HERE_SMOKE))],
                             cwd=trees[i],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        line = [l for l in out.stdout.splitlines() if l.startswith("TURN ")]
        ms = {ROWS[k.split(" ")[0]] + k[len(k.split(" ")[0]):]: v
              for k, v in json.loads(line[-1][5:]).items()
              if k.split(" ")[0] in ROWS}
        readings[i].append(ms)
        print(json.dumps({"tree": str(trees[i].name), "ms": ms}), flush=True)
    print(json.dumps({str(trees[i].name): {
        row: statistics.median(r[row] for r in readings[i])
        for row in readings[i][0]} for i in (0, 1) if readings[i]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
