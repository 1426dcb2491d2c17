"""Token-bin datasets, sequence packing and a prefetching loader (the
port's copy of transformerengine_tpu/data/loader.py, which it does not
import).

The C++ runtime in ``csrc/packer.cpp`` is built with ``g++`` into the
package's ``_build/`` directory at first use and loaded with ``ctypes``;
the library's name carries a hash of the source, so an edit rebuilds. A
NumPy implementation of the same packing runs where the caller asks for
it (``use_native=False``) or the library does not build; the tests hold
both to the reference byte for byte.

Packed batches are (tokens, segment_ids, positions) int32 numpy arrays of
shape (rows, seq_len): what
``SequenceDescriptor.from_segment_ids_and_pos`` and ``LlamaModel``'s
``positions`` take once the caller moves them to the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "packer.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
MAGIC = b"TEBIN001"

_lock = threading.Lock()
_lib = None
_lib_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libtepacker_{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    """The loaded packer library, built at first use; None where g++ is
    missing or the build fails (the NumPy path then runs)."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        out = library_path()
        if not out.exists():
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    tmp_lib = Path(tmp) / out.name
                    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o",
                                    str(tmp_lib), "-lpthread"],
                                   check=True, capture_output=True,
                                   timeout=120)
                    os.replace(tmp_lib, out)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.te_pack_sequences.restype = ctypes.c_int64
        lib.te_pack_sequences.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_int64]
        lib.te_loader_create.restype = ctypes.c_void_p
        lib.te_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32]
        lib.te_loader_next.restype = None
        lib.te_loader_next.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]
        lib.te_loader_destroy.restype = None
        lib.te_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _build_lib() is not None


# ---------------------------------------------------------------------------
# Token-bin file format
# ---------------------------------------------------------------------------

def write_token_bin(path: str, docs) -> None:
    """Writes a list of int32 token sequences as a TEBIN001 file."""
    offsets = np.zeros(len(docs) + 1, np.int64)
    for i, d in enumerate(docs):
        offsets[i + 1] = offsets[i] + len(d)
    flat = (np.concatenate([np.asarray(d, np.int32) for d in docs])
            if docs else np.zeros((0,), np.int32))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.int64(len(docs)).tobytes())
        f.write(offsets.tobytes())
        f.write(flat.astype(np.int32).tobytes())


def read_token_bin(path: str):
    """(flat tokens int32 (N,), offsets int64 (n_docs + 1,))."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path} is not a TEBIN001 file")
        n_docs = np.frombuffer(f.read(8), np.int64)[0]
        offsets = np.frombuffer(f.read(8 * (int(n_docs) + 1)), np.int64)
        flat = np.frombuffer(f.read(), np.int32)
    return flat.copy(), offsets.copy()


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def _pack_numpy(flat, offsets, max_len, pad_id):
    """The C++ packer's rule in NumPy: documents cut into chunks of at
    most ``max_len``, sorted by decreasing length (stable), each placed in
    the first row with room."""
    chunks = []
    for d in range(len(offsets) - 1):
        s, e = int(offsets[d]), int(offsets[d + 1])
        for c in range(s, e, max_len):
            chunks.append((c, min(max_len, e - c)))
    chunks.sort(key=lambda ch: -ch[1])
    rows, row_chunks = [], []
    for ch in chunks:
        for r in range(len(rows)):
            if rows[r] + ch[1] <= max_len:
                rows[r] += ch[1]
                row_chunks[r].append(ch)
                break
        else:
            rows.append(ch[1])
            row_chunks.append([ch])
    n = len(rows)
    tok = np.full((n, max_len), pad_id, np.int32)
    seg = np.zeros((n, max_len), np.int32)
    pos = np.zeros((n, max_len), np.int32)
    for r, chs in enumerate(row_chunks):
        cur = 0
        for sid, (start, ln) in enumerate(chs, 1):
            tok[r, cur:cur + ln] = flat[start:start + ln]
            seg[r, cur:cur + ln] = sid
            pos[r, cur:cur + ln] = np.arange(ln)
            cur += ln
    return tok, seg, pos


def pack_sequences(flat: np.ndarray, offsets: np.ndarray, max_len: int,
                   pad_id: int = 0, *, use_native: Optional[bool] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-fit-decreasing packing of the documents ``flat[offsets[i]:
    offsets[i + 1]]`` into (rows, max_len) int32 arrays (tokens,
    segment_ids, positions). Documents longer than ``max_len`` are split;
    ids count from 1 in each row, positions from 0 in each chunk, and
    padding has id 0 and token ``pad_id``. ``use_native``: True requires
    the C++ packer, False takes NumPy, None the C++ one where it builds."""
    flat = np.ascontiguousarray(flat, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lib = _build_lib() if use_native in (None, True) else None
    if lib is None:
        if use_native:
            raise RuntimeError("the native packer did not build")
        return _pack_numpy(flat, offsets, max_len, pad_id)
    n_docs = len(offsets) - 1
    # Capacity: every chunk in its own row.
    lens = np.diff(offsets)
    cap = max(int(np.sum((lens + max_len - 1) // max_len)) if n_docs else 0,
              1)
    tok = np.empty((cap, max_len), np.int32)
    seg = np.empty((cap, max_len), np.int32)
    pos = np.empty((cap, max_len), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.te_pack_sequences(
        flat.ctypes.data_as(i32p), offsets.ctypes.data_as(i64p), n_docs,
        max_len, pad_id, tok.ctypes.data_as(i32p), seg.ctypes.data_as(i32p),
        pos.ctypes.data_as(i32p), cap)
    if n < 0:
        raise RuntimeError("the packer ran out of rows")
    return tok[:n].copy(), seg[:n].copy(), pos[:n].copy()


# ---------------------------------------------------------------------------
# Prefetching loader
# ---------------------------------------------------------------------------

class PackedDataLoader:
    """Packed batches from a TEBIN001 file: each :meth:`next_batch`
    returns (tokens, segment_ids, positions), (batch_rows, seq_len) int32
    numpy arrays, from epoch-shuffled documents.

    The native loader (C++ threads packing ahead into a ring of
    ``ring_capacity`` batches) pulls documents while their first-fit
    packing fits the batch; with ``n_threads`` > 1 the batches' order
    varies from run to run. The NumPy loader (``use_native=False``, or no
    library) pulls documents up to the batch's token budget, packs them
    and keeps the first ``batch_rows`` rows; it shuffles with numpy's
    generator, not the C++ one, so the two give other batches."""

    def __init__(self, path: str, batch_rows: int, seq_len: int, *,
                 pad_id: int = 0, seed: int = 0, n_threads: int = 2,
                 ring_capacity: int = 4, use_native: Optional[bool] = None):
        self.batch_rows, self.seq_len, self.pad_id = batch_rows, seq_len, \
            pad_id
        self._handle = None
        self._lib = _build_lib() if use_native in (None, True) else None
        if self._lib is not None:
            self._handle = self._lib.te_loader_create(
                path.encode(), batch_rows, seq_len, pad_id, seed, n_threads,
                ring_capacity)
        if self._handle is None:
            if use_native:
                raise RuntimeError(f"the native loader could not open "
                                   f"{path}")
            self._flat, self._offsets = read_token_bin(path)
            self._rng = np.random.default_rng(seed)
            self._order = self._rng.permutation(len(self._offsets) - 1)
            self._cursor = 0

    @property
    def native(self) -> bool:
        return self._handle is not None

    def next_batch(self):
        b, s = self.batch_rows, self.seq_len
        if self._handle is not None:
            tok = np.empty((b, s), np.int32)
            seg = np.empty((b, s), np.int32)
            pos = np.empty((b, s), np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            self._lib.te_loader_next(
                self._handle, tok.ctypes.data_as(i32p),
                seg.ctypes.data_as(i32p), pos.ctypes.data_as(i32p))
            return tok, seg, pos
        picked = []
        budget, acc = b * s, 0
        while acc < budget:
            if self._cursor >= len(self._order):
                self._order = self._rng.permutation(len(self._order))
                self._cursor = 0
            d = self._order[self._cursor]
            ln = int(self._offsets[d + 1] - self._offsets[d])
            if picked and acc + ln > budget:
                break
            picked.append(d)
            acc += ln
            self._cursor += 1
        offs, parts = [0], []
        for d in picked:
            parts.append(self._flat[self._offsets[d]:self._offsets[d + 1]])
            offs.append(offs[-1] + len(parts[-1]))
        tok, seg, pos = _pack_numpy(
            np.concatenate(parts) if parts else np.zeros((0,), np.int32),
            np.asarray(offs, np.int64), s, self.pad_id)
        out_t = np.full((b, s), self.pad_id, np.int32)
        out_s = np.zeros((b, s), np.int32)
        out_p = np.zeros((b, s), np.int32)
        n = min(b, len(tok))
        out_t[:n], out_s[:n], out_p[:n] = tok[:n], seg[:n], pos[:n]
        return out_t, out_s, out_p

    def close(self) -> None:
        """Stops the native loader's threads and unmaps its file."""
        if self._handle is not None:
            self._lib.te_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
