"""The NVFP4 kernels' CUDA source (``csrc/nvfp4_quantize.cu`` over
``csrc/nvfp4.cuh``) runs on the CPU in the host simulation of
``tools/flash_host_sim`` (g++ in place of nvcc, a block's threads as
threads, a card of 264 blocks), through the wrappers ``nvfp4_amax_2x``
and ``nvfp4_quantize_2x``, against their plain versions byte for byte:
bf16 and f32 x, without the RHT and with it under sign mask 0 and other
masks, round to nearest and stochastic rounding, shapes that are not tile
multiples, rows of three magnitudes (subnormal block scales), columns
whose runs cancel exactly under the rotation beside rows of +0 and -0,
more tiles than the simulated card's blocks; and two launches bitwise
equal with a launch at another shape between them (the amax pass resets
its running maxima and ticket). Then the rounding to nearest against the
table walk it replaced, over every f32 of magnitude at most 8 of both
signs, +-inf and quiet NaNs (``nvfp4_sweep.cpp``, about 11 s on 4
threads)."""
import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

RUN = (Path(__file__).resolve().parents[1] / "tools" / "flash_host_sim"
       / "run.py")


def _run_module():
    spec = importlib.util.spec_from_file_location("host_sim_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RUN = _run_module()
CASES = _RUN.nvfp4_cases(torch)


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH here")
    return tmp_path_factory.mktemp("nvfp4_sim")


@pytest.fixture(scope="module")
def sim(build_dir):
    return _RUN.Sim(_RUN.build(build_dir, ["nvfp4"]))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_nvfp4_sources_in_host_sim(sim, case):
    fails = []
    _RUN.run_nvfp4(torch, sim, fails, **case)
    assert not fails


def test_rounding_matches_the_table_over_every_f32(build_dir):
    rc, log = _RUN.nvfp4_sweep(build_dir)
    assert rc == 0, log
    assert "2181038088 patterns, 0 differ" in log, log
