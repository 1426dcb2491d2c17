"""The port's input pipeline (transformerengine_tpu_torch.data) against the
JAX package's (transformerengine_tpu.data): ``pack_sequences`` byte for
byte on the NumPy path and the native one (documents longer than
``max_len``, an empty input, a pad id), ``PackedDataLoader`` batches for
the same file, seed and path, the TEBIN001 round trip, and where the
port builds its packer."""
import numpy as np
import pytest
import torch

from transformerengine_tpu.data import loader as ref
from transformerengine_tpu_torch import _build
from transformerengine_tpu_torch.data import loader as port

torch.set_num_threads(2)


def _docs(rng, n: int, lo: int, hi: int):
    """``n`` documents of lengths log-uniform over [lo, hi), tokens in
    [1, 1000)."""
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)
    return [rng.integers(1, 1000, int(m)).astype(np.int32) for m in lens]


@pytest.fixture(scope="module", autouse=True)
def _reference_library(tmp_path_factory):
    """The reference builds its packer next to its source at first use;
    here it builds into a temporary directory instead, so that no two
    test processes write that file at once."""
    if ref._lib is None and not ref._lib_tried:
        ref._LIB_PATH = str(tmp_path_factory.mktemp("reference_packer")
                            / "libtepacker.so")


@pytest.fixture
def bin_file(tmp_path):
    docs = _docs(np.random.default_rng(0), 60, 4, 300)
    path = str(tmp_path / "docs.tebin")
    port.write_token_bin(path, docs)
    return path, docs


def _same(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_token_bin_round_trip(bin_file):
    """write_token_bin / read_token_bin round trip, and the file is the
    reference's byte for byte."""
    path, docs = bin_file
    flat, offsets = port.read_token_bin(path)
    assert offsets.dtype == np.int64 and len(offsets) == len(docs) + 1
    for i, d in enumerate(docs):
        np.testing.assert_array_equal(flat[offsets[i]:offsets[i + 1]], d)
    rflat, roffsets = ref.read_token_bin(path)
    assert flat.tobytes() == rflat.tobytes()
    assert offsets.tobytes() == roffsets.tobytes()


def test_token_bin_refuses_another_file(tmp_path):
    path = tmp_path / "other.bin"
    path.write_bytes(b"NOTTEBIN" + bytes(16))
    with pytest.raises(ValueError, match="TEBIN001"):
        port.read_token_bin(str(path))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("max_len,pad_id", [(64, 0), (128, 0), (50, 7)])
def test_pack_sequences_matches_reference(bin_file, native, max_len, pad_id):
    """First-fit-decreasing packing, byte for byte: documents longer than
    max_len split into chunks, ids from 1 in each row, positions from 0
    in each chunk, padding id 0 with the pad token."""
    if native:
        assert port.native_available() and ref.native_available()
    flat, offsets = port.read_token_bin(bin_file[0])
    assert int(np.diff(offsets).max()) > max_len
    got = port.pack_sequences(flat, offsets, max_len, pad_id,
                              use_native=native)
    _same(got, ref.pack_sequences(flat, offsets, max_len, pad_id,
                                  use_native=native))
    tok, seg, pos = got
    assert bool((tok[seg == 0] == pad_id).all())
    assert bool((pos[seg == 0] == 0).all())
    assert int(seg.max()) >= 2


@pytest.mark.parametrize("native", [False, True])
def test_pack_sequences_empty_input(native):
    """No document: no row on either side."""
    flat = np.zeros((0,), np.int32)
    offsets = np.zeros((1,), np.int64)
    got = port.pack_sequences(flat, offsets, 32, use_native=native)
    _same(got, ref.pack_sequences(flat, offsets, 32, use_native=native))
    assert got[0].shape == (0, 32)


def test_native_and_numpy_packing_agree(bin_file):
    """The two paths of the port give the same bytes."""
    flat, offsets = port.read_token_bin(bin_file[0])
    _same(port.pack_sequences(flat, offsets, 96, use_native=True),
          port.pack_sequences(flat, offsets, 96, use_native=False))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("rows,seq_len,seed", [(2, 64, 3), (4, 128, 11)])
def test_packed_loader_matches_reference(bin_file, native, rows, seq_len,
                                         seed):
    """Batches of PackedDataLoader against the reference's for the same
    file, seed and path, through more than one epoch (one native thread:
    with more, the batches' order depends on which thread finishes
    first, on both sides)."""
    path = bin_file[0]
    kw = dict(seed=seed, n_threads=1, use_native=native)
    a = port.PackedDataLoader(path, rows, seq_len, **kw)
    b = ref.PackedDataLoader(path, rows, seq_len, **kw)
    try:
        assert a.native == b.native == native
        for _ in range(12):
            got = a.next_batch()
            _same(got, b.next_batch())
            assert got[0].shape == (rows, seq_len)
    finally:
        a.close()
        b.close()


def test_packed_loader_batches_hold_whole_chunks(bin_file):
    """Every segment of a native batch is a contiguous run of one
    document's chunk with positions 0, 1, ...; padding is id 0."""
    path, docs = bin_file
    chunks = {d[c:c + 64].tobytes() for d in docs
              for c in range(0, len(d), 64)}
    loader = port.PackedDataLoader(path, 2, 64, seed=1, n_threads=2)
    try:
        for _ in range(8):
            tok, seg, pos = loader.next_batch()
            for r in range(2):
                for sid in set(seg[r].tolist()) - {0}:
                    idx = np.flatnonzero(seg[r] == sid)
                    np.testing.assert_array_equal(
                        idx, np.arange(idx[0], idx[-1] + 1))
                    np.testing.assert_array_equal(pos[r, idx],
                                                  np.arange(len(idx)))
                    assert tok[r, idx].tobytes() in chunks
    finally:
        loader.close()


def test_packer_builds_into_the_package_build_directory():
    """The port's packer library lives under the package's git-ignored
    _build/ directory, named by a hash of its source."""
    assert port.native_available()
    path = port.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("libtepacker_")


def test_native_required_raises_without_the_library(monkeypatch, bin_file):
    """use_native=True raises where the library does not build;
    use_native=None then takes the NumPy path."""
    monkeypatch.setattr(port, "_build_lib", lambda: None)
    flat, offsets = port.read_token_bin(bin_file[0])
    with pytest.raises(RuntimeError, match="did not build"):
        port.pack_sequences(flat, offsets, 64, use_native=True)
    _same(port.pack_sequences(flat, offsets, 64),
          ref.pack_sequences(flat, offsets, 64, use_native=False))
    loader = port.PackedDataLoader(bin_file[0], 2, 64)
    assert not loader.native
