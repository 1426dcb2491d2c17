"""The fused norm-quantize kernels' CUDA source (``csrc/norm_quant.cuh``
under ``csrc/mxfp8_norm_quantize.cu`` and ``csrc/norm_cast_transpose.cu``)
runs on the CPU in the host simulation of ``tools/flash_host_sim`` (g++ in
place of nvcc, a cluster's blocks as threads at once, its barrier, its
distributed shared memory, the bulk copies and their mbarriers), through
the wrappers ``mxfp8_norm_quantize_2x`` and ``norm_cast_transpose``: the
payloads, the E8M0 grids and the amax byte for byte against the plain
versions from the kernel's own statistics, and rsigma and mu within f32
ulps of the plain versions'. The cases: bf16 and f32 x, RMSNorm and
LayerNorm with beta, zero-centered gamma, e4m3 and e5m2, both orientations
and rowwise only, clusters of 2, 4 and 8 blocks with 32-column blocks that
do not divide evenly over them, a ragged last strip (M = 264), zero rows
(rsigma exactly 1 / sqrt(eps)), blocks below the E8M0 clip, shapes past
the cluster's budget (x read twice, in chunks), and two launches bitwise
equal with a launch at another shape between them (the amax's ticket
reset)."""
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
CASES = _RUN.norm_cases(torch)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH here")
    return _RUN.Sim(_RUN.build(tmp_path_factory.mktemp("norm_sim"),
                               ["norm"]))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_norm_sources_in_host_sim(sim, case):
    fails = []
    _RUN.run_norm(torch, sim, fails, **case)
    assert not fails
