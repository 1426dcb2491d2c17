#!/usr/bin/env python3
"""Times the phases of each block of the fused norm-quantize kernels on
the card: a copy of ``csrc/norm_quant.cuh`` with ``clock64`` probes at the
phases' edges, built with the two norm units into a library of its own,
run at (4096, 4096) bf16 (``PERF.md`` §6 rows 6 and 9) after an L2 flush.

    python3 tools/norm_quant_probe.py [--budget 32768] [--reps 2]
                                      [--variants base,no-exchange,...]
                                      [--no-probe]

``--budget`` is the shared-memory budget that sets the cluster size
(``TE_NORM_QUANT_BUDGET``). Prints the card's name and power limit, then
for each call (row 9 in both orientations, rowwise only and as LayerNorm
with beta; row 6) the blocks' start and end times (``%globaltimer``, us,
from the first start), how many blocks each SM ran, and per phase the
median, 90th percentile and largest count of SM cycles over the blocks,
each block's strips summed, of each phase in PHASES. ``--variants`` builds
variants of the body that each drop a step (VARIANTS: their results are
wrong, so their calls are timed only). Needs one CUDA card and nvcc."""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PROBE = '''namespace {
__device__ unsigned long long* nq_probe_buf;
__device__ __forceinline__ unsigned long long nq_gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace
#define PROBE_START()                                                    \\
  unsigned long long nq_last = clock64();                                \\
  if (threadIdx.x == 0 && nq_probe_buf != nullptr) {                     \\
    unsigned long long* b = nq_probe_buf + (size_t)blockIdx.x * 16;      \\
    unsigned sm;                                                         \\
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                      \\
    b[9] = nq_gtimer();                                                  \\
    b[11] = sm;                                                          \\
  }
#define PROBE_ADD(k)                                                     \\
  if (threadIdx.x == 0 && nq_probe_buf != nullptr) {                     \\
    const unsigned long long now = clock64();                            \\
    nq_probe_buf[(size_t)blockIdx.x * 16 + (k)] += now - nq_last;        \\
    nq_last = now;                                                       \\
  }
#define PROBE_END()                                                      \\
  if (threadIdx.x == 0 && nq_probe_buf != nullptr)                       \\
    nq_probe_buf[(size_t)blockIdx.x * 16 + 10] = nq_gtimer();
'''

# (anchor, text put before it, text put after it): thread 0 adds the
# cycles since its last probe to slot k (summed over the block's strips);
# slots 9 and 10 hold the global times of the block's start and end, 11
# its SM, 12 its strips.
EDGES = (
    ("  const Shared s = carve(nq_smem, p.nbl);\n", None,
     "  PROBE_START();\n"),
    ("  if (W > 0) mbar_wait(&s.bar[2 * kWarps], 0);  // gamma and beta\n",
     None, "  PROBE_ADD(1);\n"),
    ("      push(recv, part, C, rank);\n", None, "      PROBE_ADD(2);\n"),
    ("      if (!a.layernorm) reload_tile", "      PROBE_ADD(3);\n", None),
    ("      gather(recv, C, part);\n", "      PROBE_ADD(4);\n", None),
    ("      finish(a, rs, rs);\n      if (rank == 0", "      PROBE_ADD(5);\n",
     None),
    ("      __syncthreads();  // strip k's y, for its colwise step\n",
     "      PROBE_ADD(6);\n",
     "      PROBE_ADD(7);\n      if (threadIdx.x == 0 && nq_probe_buf != "
     "nullptr)\n        nq_probe_buf[(size_t)blockIdx.x * 16 + 12] += 1;\n"),
    ("  if (!kMx) finish_amax(amax, s.amax, a.amax);\n", "  PROBE_ADD(8);\n",
     "  PROBE_ADD(13);\n  PROBE_END();\n"),
)
PHASES = ((1, "init"), (2, "tile, first partials pushed"),
          (3, "last strip's colwise"), (4, "next tile issued, barrier"),
          (5, "statistics"), (6, "rowwise and E8M0 runs"),
          (7, "block barrier"), (8, "last colwise"), (13, "amax"))
# Variants of the body that each take a step's cost away (their results
# are wrong; the call is timed, not checked): name -> [(text, its
# replacement wherever it stands)].
VARIANTS = {
    "base": [],
    # Each block takes C times its own partial for the cluster's sum: no
    # distributed shared memory, no cluster barrier in the statistics.
    "no-exchange": [
        ("  if (lane < C) {\n    float* dst = cluster_map(\n        recv + "
         "rank * kRows + (threadIdx.x >> 5) * kWarpRows, lane);\n#pragma "
         "unroll\n    for (int i = 0; i < kWarpRows; ++i) dst[i] = part[i];"
         "\n  }\n",
         "  if (lane == 0) {\n#pragma unroll\n    for (int i = 0; i < "
         "kWarpRows; ++i) recv[(threadIdx.x >> 5) * kWarpRows + i] = part[i] "
         "* C;\n  }\n"),
        ("    for (int k = 0; k < C; ++k) t = __fadd_rn(t, recv[k * kRows + "
         "r0 + i]);", "    t = recv[r0 + i];"),
        ("  cluster_sync();\n  gather(", "  __syncwarp();\n  gather("),
        ("cluster_arrive();\n", "__syncwarp();\n"),
        ("cluster_wait();\n", "__syncwarp();\n")],
    # The colwise codes and grid computed but not stored.
    "no-col-stores": [
        ("  const int hr = min(kHalf, max(0, rows - kHalf * half));",
         "  int hr = min(kHalf, max(0, rows - kHalf * half));"),
        ("    uint8_t* dst = a.col + (size_t)n * a.M + m0 + kHalf * half;\n",
         "    uint8_t* dst = a.col + (size_t)n * a.M + m0 + kHalf * half;\n"
         "    if (q[0] != 0x01234567u || q[3] != 0x89abcdefu) hr = 0;\n"),
        ("    if (kMx && half == 0)\n      a.scol[",
         "    if (kMx && half == 0 && ex == 1000)\n      a.scol[")],
    # The rowwise codes and E8M0 bytes computed but not stored.
    "no-row-stores": [
        ("        if (on) {\n          *reinterpret_cast<uint2*>(a.row",
         "        if (on && q[0] == 0x01234567u && q[3] == 0x89abcdefu) {\n"
         "          *reinterpret_cast<uint2*>(a.row")],
}
SETTERS = {"mxfp8_norm_quantize.cu": "te_probe_set_mx",
           "norm_cast_transpose.cu": "te_probe_set_t"}


def probed_header(variant: str = "base") -> str:
    s = (REPO / "transformerengine_tpu_torch" / "csrc" /
         "norm_quant.cuh").read_text()
    for old, new in (sub for v in variant.split("+") for sub in VARIANTS[v]):
        if old not in s:
            raise SystemExit(f"norm_quant.cuh no longer has {old!r}")
        s = s.replace(old, new)
    for anchor, _, _ in EDGES:
        if anchor not in s:
            raise SystemExit(f"norm_quant.cuh no longer has {anchor!r}")
    s = s.replace("namespace norm_quant {\n",
                  "namespace norm_quant {\n" + PROBE, 1)
    for anchor, before, after in EDGES:
        s = s.replace(anchor, (before or "") + anchor + (after or ""), 1)
    return s


def build(tmp: Path, budget: int, variant: str = "base") -> ctypes.CDLL:
    from transformerengine_tpu_torch import _build
    for p in _build.CSRC.glob("*.cuh"):
        (tmp / p.name).write_text(p.read_text())
    (tmp / "norm_quant.cuh").write_text(probed_header(variant))
    units = []
    for name, setter in SETTERS.items():
        src = (_build.CSRC / name).read_text()
        src += (f'\nextern "C" int {setter}(void* p) {{\n  return (int)'
                'cudaMemcpyToSymbol(norm_quant::nq_probe_buf, &p, '
                'sizeof(p));\n}\n')
        (tmp / name).write_text(src)
        units.append(str(tmp / name))
    lib = tmp / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-DTE_NORM_QUANT_BUDGET={budget}", "-shared", "-I",
                    str(tmp), *units, "-o", str(lib)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for fn in ("te_mxfp8_norm_quantize", "te_norm_cast_transpose"):
        getattr(cdll, fn).argtypes = _build._SIGNATURES[fn]
        getattr(cdll, fn).restype = ctypes.c_int
    for fn in SETTERS.values():
        getattr(cdll, fn).argtypes = (ctypes.c_void_p,)
    return cdll


def pct(values, q: float):
    values = sorted(values)
    return values[min(len(values) - 1, int(len(values) * q))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", default="base",
                    help="comma-separated: " + ", ".join(VARIANTS))
    ap.add_argument("--no-probe", action="store_true",
                    help="time the calls only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from transformerengine_tpu_torch.ops import quantize_kernels as qk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import chip_smoke
    from concurrent.futures import ThreadPoolExecutor
    from transformerengine_tpu_torch import _build
    variants = args.variants.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [Path(tmp) / v for v in variants]
        for d in dirs:
            d.mkdir()
        with ThreadPoolExecutor(len(variants)) as ex:
            libs = list(ex.map(lambda dv: build(dv[0], args.budget, dv[1]),
                               zip(dirs, variants)))
    g = torch.Generator(device="cuda").manual_seed(19)
    m = h = 4096
    x = torch.randn((m, h), generator=g, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((h,), generator=g, device="cuda")
    beta = 0.1 * torch.randn((h,), generator=g, device="cuda")
    scale = torch.tensor([40.0], device="cuda")
    e4m3 = torch.float8_e4m3fn
    rms = dict(norm="rmsnorm", zero_centered_gamma=False, epsilon=1e-5)
    ln = dict(norm="layernorm", zero_centered_gamma=False, epsilon=1e-5)
    calls = (
        ("9 (2x)", "te_probe_set_mx",
         lambda: qk.mxfp8_norm_quantize_2x(x, gamma, None, e4m3, **rms)),
        ("9 rowwise-only", "te_probe_set_mx",
         lambda: qk.mxfp8_norm_quantize_2x(x, gamma, None, e4m3, **rms,
                                           rowwise_only=True)),
        ("9 layernorm", "te_probe_set_mx",
         lambda: qk.mxfp8_norm_quantize_2x(x, gamma, beta, e4m3, **ln)),
        ("6", "te_probe_set_t",
         lambda: qk.norm_cast_transpose(x, gamma, None, scale, e4m3,
                                        **rms)),
    )
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    buf = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
    timer = chip_smoke.Timer(torch)
    for variant, lib in zip(variants, libs):
        _build._lib = lib
        print(f"variant {variant}: " + ", ".join(
            f"{label} {timer(call):.4f} ms" for label, _, call in calls),
              flush=True)
        if not args.no_probe:
            probe(torch, lib, calls, flush, buf, args.reps)
    return 0


def probe(torch, lib, calls, flush, buf, reps: int) -> None:
    """Prints each call's blocks' times and phases after an L2 flush."""
    for label, setter, call in calls:
        call()
        for rep in range(reps):
            buf.zero_()
            getattr(lib, setter)(ctypes.c_void_p(buf.data_ptr()))
            flush.zero_()
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
            getattr(lib, setter)(ctypes.c_void_p(None))
            rows = buf.view(-1, 16).cpu()
            rows = rows[rows[:, 9] != 0]
            t0 = int(rows[:, 9].min())
            start = (rows[:, 9] - t0).double() / 1e3
            end = (rows[:, 10] - t0).double() / 1e3
            per_sm = torch.bincount(rows[:, 11].long())
            print(f"{label} rep {rep}: {rows.shape[0]} blocks on "
                  f"{int((per_sm > 0).sum())} SMs (at most "
                  f"{int(per_sm.max())} a SM); starts {float(start.min()):.2f}"
                  f"-{float(start.max()):.2f} us (median "
                  f"{float(start.median()):.2f}), ends "
                  f"{float(end.min()):.2f}-{float(end.max()):.2f} us (median "
                  f"{float(end.median()):.2f})", flush=True)
            strips = rows[:, 12].tolist()
            print(f"    strips a block: {min(strips)}-{max(strips)}",
                  flush=True)
            for k, name in PHASES:
                d = [int(v) for v in rows[:, k].tolist()]
                print(f"    {name:30s} cycles a block (strips summed) "
                      f"median {pct(d, 0.5):7d}  p90 {pct(d, 0.9):7d}  max "
                      f"{max(d):7d}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
