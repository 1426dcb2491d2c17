#!/usr/bin/env python3
"""Times the phases of each block of the decode attention kernel on the
card: a copy of ``csrc/decode_attn.cuh`` with ``clock64`` probes at the
phases' edges, built with the two decode attention units into a library of
its own, run at ``chip_smoke.py`` row 3's shape (B rows, Hq 32, Hkv 8, D
128, an e4m3 cache of 640 slots, lengths 528 and 400) after an L2 flush.

    python3 tools/decode_attn_probe.py [--batch 8] [--reps 2]

Prints the card's name and power limit, then for each run the blocks'
start and end times (``%globaltimer``, us) and, per phase, the median, 90th
percentile and largest count of SM cycles over the blocks that ran it:
``q+len+issue`` (q's and the length's loads, the tile's copies issued),
``wait tile`` (until the tile landed), ``compute`` (scores, softmax, PV),
``to partial`` (the loop's end), ``write+ticket`` (the partial results
written, the fence and the ticket) and ``combine`` (the last block's sum
of the splits). Needs one CUDA card and nvcc."""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = '''__device__ unsigned long long* probe_buf;
}  // namespace
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(k)                                                         \\
  if (threadIdx.x == 0 && probe_buf != nullptr) {                        \\
    const size_t blk =                                                   \\
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +      \\
        blockIdx.x;                                                      \\
    probe_buf[blk * 16 + (k)] = clock64();                               \\
    if ((k) == 0 || (k) >= 8)                                            \\
      probe_buf[blk * 16 + 8 + ((k) & 7)] = gtimer();                    \\
  }'''

# (anchor, text put before it, text put after it): probe k sits at phase
# edge k; 8 + (k & 7) holds the global time of 0 (start) and of 9 and 10
# (a block's end, without and with the combine).
EDGES = (
    ("}  // namespace\n", None, None),
    ("  // Head h's q: the lane's kW columns", "  PROBE(0);\n", None),
    ("  if (active) store_f32<kW>(qs + g * D + lane * kW, qr);\n", None,
     "  PROBE(1);\n"),
    ("    __syncthreads();  // the tile (and q) landed for every thread\n",
     None, "    PROBE(2);\n"),
    ("    __syncthreads();  // the stage is refilled next", "    PROBE(4);\n",
     None),
    ("  if (splits == 1) {\n    write_out", "  PROBE(5);\n", None),
    ("  if (!*last) return;", None, None),
    ("  if (threadIdx.x == 0) tickets[row] = 0u;\n", None,
     "  PROBE(7);\n  PROBE(10);\n"),
)
PHASES = (("q+len+issue", 0, 1), ("wait tile", 1, 2), ("compute", 2, 4),
          ("to partial", 4, 5), ("write+ticket", 5, 6), ("combine", 6, 7))


def probed_header() -> str:
    s = (REPO / "transformerengine_tpu_torch" / "csrc" /
         "decode_attn.cuh").read_text()
    for anchor, before, after in EDGES:
        if anchor not in s:
            raise SystemExit(f"decode_attn.cuh no longer has {anchor!r}")
    s = s.replace("}  // namespace\n", PROBE + "\n", 1)
    s = s.replace("  if (!*last) return;",
                  "  PROBE(6);\n  if (!*last) {\n    PROBE(9);\n    return;\n  }",
                  1)
    for anchor, before, after in EDGES[1:]:
        if anchor in ("}  // namespace\n", "  if (!*last) return;"):
            continue
        s = s.replace(anchor, (before or "") + anchor + (after or ""), 1)
    return s


def build(tmp: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(REPO))
    from transformerengine_tpu_torch import _build
    for p in _build.CSRC.glob("*.cuh"):
        (tmp / p.name).write_text(p.read_text())
    (tmp / "decode_attn.cuh").write_text(probed_header())
    units = []
    for name in ("decode_attention.cu", "paged_decode_attention.cu"):
        src = (_build.CSRC / name).read_text()
        if name == "decode_attention.cu":
            src += ('\nextern "C" int te_probe_set(void* p) {\n  return (int)'
                    'cudaMemcpyToSymbol(decode_attn::probe_buf, &p, '
                    'sizeof(p));\n}\n')
        (tmp / name).write_text(src)
        units.append(str(tmp / name))
    lib = tmp / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(tmp), *units, "-o", str(lib)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for fn in ("te_decode_attention", "te_paged_decode_attention"):
        getattr(cdll, fn).argtypes = _build._SIGNATURES[fn]
        getattr(cdll, fn).restype = ctypes.c_int
    _build._lib = cdll
    return cdll


def pct(values, q: float):
    values = sorted(values)
    return values[min(len(values) - 1, int(len(values) * q))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        from transformerengine_tpu_torch.ops.decode_attention import (
            decode_attention)
        g = torch.Generator(device="cuda").manual_seed(2)
        b, hq, hkv, d, s = args.batch, 32, 8, 128, 640
        lens = torch.tensor([(528, 400)[i % 2] for i in range(b)],
                            dtype=torch.int32, device="cuda")
        q = torch.randn((b, 1, hq, d), generator=g, device="cuda").to(
            torch.bfloat16)
        kc, vc = (torch.randn((b, s, hkv, d), generator=g, device="cuda")
                  .to(torch.float8_e4m3fn) for _ in range(2))
        dq = torch.rand(b, generator=g, device="cuda") + 0.5
        n_blocks = b * hkv * 64
        probe = torch.zeros(n_blocks * 16, dtype=torch.int64, device="cuda")
        lib.te_probe_set(ctypes.c_void_p(probe.data_ptr()))
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
        decode_attention(q, kc, vc, lens, kv_scale=dq)
        for rep in range(args.reps):
            probe.zero_()
            flush.zero_()
            torch.cuda.synchronize()
            decode_attention(q, kc, vc, lens, kv_scale=dq)
            torch.cuda.synchronize()
            rows = [r for r in probe.reshape(n_blocks, 16).cpu().tolist()
                    if r[0]]
            t0 = min(r[8] for r in rows)
            starts = [(r[8] - t0) / 1e3 for r in rows]
            ends = [((r[10] or r[9]) - t0) / 1e3 for r in rows
                    if r[10] or r[9]]
            print(f"run {rep}: B={b}, {len(rows)} blocks; start us "
                  f"median {pct(starts, .5):.2f} max {max(starts):.2f}; "
                  f"end us median {pct(ends, .5):.2f} p90 "
                  f"{pct(ends, .9):.2f} max {max(ends):.2f}")
            for name, k0, k1 in PHASES:
                v = [r[k1] - r[k0] for r in rows if r[k0] and r[k1]]
                if v:
                    print(f"  {name}: cycles median {pct(v, .5)}, p90 "
                          f"{pct(v, .9)}, max {max(v)} ({len(v)} blocks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
