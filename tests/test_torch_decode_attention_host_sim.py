"""The decode attention kernels' CUDA sources (``csrc/decode_attention.cu``
and ``csrc/paged_decode_attention.cu`` over ``csrc/decode_attn.cuh``) run
on the CPU in the host simulation of ``tools/flash_host_sim`` (g++ in
place of nvcc, a block's threads as threads, a card of 264 blocks), through
the wrappers, against the wrappers' plain versions at phase 3's
tolerances: one split and many, empty splits, a window inside a split and
across split boundaries, a sink with a length of 0, every cache dtype, both
query dtypes, G 1 to 32, D 48 to 256; and two launches bitwise
equal with a launch at another grid shape between them (the tickets are
reset). Then the wrappers' launch on fake CUDA tensors: the workspace and
its split count come from shapes alone, and B * Hkv above the kernels'
ticket counters raises before any launch."""
import importlib.util
import shutil
import warnings
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from transformerengine_tpu_torch import _build
from transformerengine_tpu_torch.ops import decode_attention as da
from transformerengine_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

RUN = (Path(__file__).resolve().parents[1] / "tools" / "flash_host_sim"
       / "run.py")


def _run_module():
    spec = importlib.util.spec_from_file_location("host_sim_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RUN = _run_module()
CASES = _RUN.decode_attn_cases(torch)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH here")
    return _RUN.Sim(_RUN.build(tmp_path_factory.mktemp("decode_attn_sim"),
                               ["decode_attn"]))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_decode_attention_sources_in_host_sim(sim, case):
    fails = []
    _RUN.run_decode_attn(torch, sim, fails, **case)
    assert not fails


def _fake(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="cuda")


# (call, B, Hq, D, the span a row can reach): the contiguous cache, with
# and without a window, and the paged pool (max_pages * page).
_E4 = torch.float8_e4m3fn
_SPANS = {
    "contiguous": (lambda: da.decode_attention(
        _fake(8, 1, 32, 128), _fake(8, 640, 8, 128, dtype=_E4),
        _fake(8, 640, 8, 128, dtype=_E4),
        _fake(8, dtype=torch.int32)), 8, 32, 128, 640),
    "window": (lambda: da.decode_attention(
        _fake(8, 1, 64, 64), _fake(8, 640, 8, 64, dtype=_E4),
        _fake(8, 640, 8, 64, dtype=_E4), _fake(8, dtype=torch.int32),
        window_left=128, softmax_sink=_fake(64, dtype=torch.float32)),
               8, 64, 64, 128 + 64),
    "one tile": (lambda: da.decode_attention(
        _fake(2, 1, 4, 64), _fake(2, 64, 2, 64), _fake(2, 64, 2, 64),
        _fake(2, dtype=torch.int32)), 2, 4, 64, 64),
    "long": (lambda: da.decode_attention(
        _fake(1, 1, 8, 128), _fake(1, 8192, 2, 128, dtype=_E4),
        _fake(1, 8192, 2, 128, dtype=_E4),
        _fake(1, dtype=torch.int32)), 1, 8, 128, 8192),
    "paged": (lambda: pa.paged_decode_attention(
        _fake(8, 1, 32, 128), _fake(40, 128, 8, 128, dtype=_E4),
        _fake(40, 128, 8, 128, dtype=_E4), _fake(8, 5, dtype=torch.int32),
        _fake(8, dtype=torch.int32)), 8, 32, 128, 5 * 128),
}


@pytest.mark.parametrize("case", list(_SPANS))
def test_workspace_from_shapes(case, monkeypatch):
    """The workspace holds min(ceil(span / 64), 64) splits of B * Hq *
    (D + 2) floats (none for one split), and the C entry point gets that
    split count; the lengths are never read on the host (fake tensors have
    no data to read)."""
    call, b, hq, d, span = _SPANS[case]
    seen = {}

    def launch(name, *args):
        seen[name] = args

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        call()
    (name, args), = seen.items()
    at = 10 if name == "te_decode_attention" else 11
    ws, splits = args[at], args[at + 1]
    want = min(-(-span // 64), 64)
    assert splits == want
    if want == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() == want * b * hq * (d + 2)


@pytest.mark.parametrize("paged", [False, True])
def test_rows_above_the_tickets_raise(paged, monkeypatch):
    """B * Hkv above the kernels' ticket counters (MAX_ROWS) raises a
    ValueError in the wrapper, before any launch."""
    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    b, hkv = da.MAX_ROWS // 8 + 1, 8
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = _fake(b, 1, 8, 64)
        lengths = _fake(b, dtype=torch.int32)
        with pytest.raises(ValueError, match="B \\* Hkv"):
            if paged:
                pages = _fake(4, 16, hkv, 64)
                pa.paged_decode_attention(q, pages, pages,
                                          _fake(b, 2, dtype=torch.int32),
                                          lengths)
            else:
                cache = _fake(b, 64, hkv, 64)
                da.decode_attention(q, cache, cache, lengths)
