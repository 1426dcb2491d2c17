"""The kernel build's report of ``nvcc -Xptxas -v``: one entry per kernel
variant, with its name, registers and, where it spills, its spill bytes
(what PERF.md's register table is read from), with ``c++filt`` on the
PATH and without."""
import shutil

import pytest

from transformerengine_tpu_torch import _build

LOG = """\
ptxas info    : Compiling entry function '_Z6kernelILi128EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvPf
    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 560 bytes cmem[0]
"""


@pytest.mark.parametrize("demangle", [True, False])
def test_ptxas_summary(monkeypatch, demangle):
    if demangle and shutil.which("c++filt") is None:
        pytest.skip("no c++filt on the PATH here")
    if not demangle:
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    entries = _build._ptxas_summary(LOG)
    names = (["void kernel<128>", "void kernel<64>"] if demangle
             else ["_Z6kernelILi128EEvPf", "_Z6kernelILi64EEvPf"])
    assert entries == [
        f"{names[0]}: Used 96 registers, used 1 barriers, 560 bytes cmem[0]"
        " (8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads)",
        f"{names[1]}: Used 168 registers, used 1 barriers, 560 bytes "
        "cmem[0]"]
