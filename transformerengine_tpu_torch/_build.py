"""Build, load and launch the port's CUDA kernels.

The sources in ``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together, then one link) into a
single shared library under ``_build/``, at first use, and loaded with
``ctypes``. The library's name carries a hash of the sources, so an edit
rebuilds and a finished build is reused. Every C entry point returns the
``cudaError_t`` of its launch; :func:`launch` raises when it is not 0.

``LAUNCHES`` counts the launches of each kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Keep in step with DTypeCode in csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
               torch.float8_e5m2: 3}

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# The flash kernels' dropout arguments: the seed words' pointer, the
# threshold, 1 / (1 - rate) and the reference's two tile sizes. Before
# them each flash entry point takes the runtime positions' pointer (after
# the static offset and window), the softmax scale and the soft cap (0 for
# none).
_DROPOUT = (_P, _U, _F, _I, _I)
# C entry points: name -> argument types (all return int).
_SIGNATURES = {
    "te_decode_tn_matvec": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _P),
    "te_flash_attention_fwd": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P, _F, _F,
                               *_DROPOUT, _P),
    "te_decode_attention": (_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _F, _I, _P),
    "te_flash_attention_bwd_dq": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _I,
                                  _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                  _F, _F, *_DROPOUT, _P),
    "te_flash_attention_bwd_dkv": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                                   _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                   _F, _F, *_DROPOUT, _P),
    "te_cast_transpose": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _P),
    "te_norm_cast_transpose": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _P),
    "te_mxfp8_quantize_2x": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _P),
    "te_mxfp8_quantize_1x": (_P, _I, _I, _P, _P, _I, _I, _I, _P),
    "te_mxfp8_norm_quantize": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _P),
    "te_paged_decode_attention": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _P,
                                  _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _P),
    "te_decode_kn_matvec": (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P),
    "te_mxfp8_qdq_2x_grouped": (_P, _I, _I, _P, _P, _I, _I, _I, _P),
    "te_nvfp4_amax_2x": (_P, _I, _I, _I, _P, _I, _I, _P),
    "te_nvfp4_quantize_2x": (_P, _I, _P, _I, _I, _I, _U, _U, _P, _P, _P, _P,
                             _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built on a machine with the CUDA "
            "toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libte_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compiles csrc/*.cu into the shared library unless it exists.
    ``verbose`` passes ``-Xptxas -v`` and prints what nvcc reports
    (registers, shared memory and spills of every kernel)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors = dict.fromkeys(l for l in log.splitlines()
                                       if "error" in l) or [log]
                failed.append(f"{src.name} (rc {proc.returncode}):\n"
                              + "\n".join(errors))
            elif verbose:
                for entry in _ptxas_summary(log):
                    print(f"[nvcc {src.name}] {entry}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)
    return out


def _ptxas_summary(log: str):
    """One entry per kernel variant: its name (demangled where ``c++filt``
    is on the PATH, without its parameter list), registers, shared memory
    and, where it spills, its spill bytes."""
    entries, name, spill = [], "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = "" if line.startswith("0 bytes stack") else f" ({line})"
        elif "Used" in line and "registers" in line:
            entries.append((name, line.split(":", 1)[1].strip() + spill))
            spill = ""
    names = [n for n, _ in entries]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                     for n in out.splitlines()]
    return [f"{n}: {e}" for n, (_, e) in zip(names, entries)]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Calls the C entry point ``name`` and raises on a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"dtype {t.dtype} not supported here; expected one "
                        f"of {sorted(map(str, allowed))}")
    return DTYPE_CODES[t.dtype]


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes its
    plain version); False when every tensor lies on one CUDA device (the
    wrapper launches its kernel). Anything else raises: a wrapper never
    quietly falls back to the plain version."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(map(str, devs))}")


def check_aligned(*tensors) -> None:
    for t in tensors:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
