"""The decode GEMMs' CUDA sources (``csrc/decode_matvec.cu`` and
``csrc/decode_kn_matvec.cu``) run on the CPU in the host simulation of
``tools/flash_host_sim`` (g++ in place of nvcc, a block's threads as
threads, mma.sync and prmt from their PTX definitions), through the
wrappers, against the wrappers' plain versions: every M tier and branch of
both tensor-core bodies and the FMA bodies, at 1e-4 of the largest output,
and row m of out at M rows bit for bit against one row of x."""
import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from transformerengine_tpu_torch.ops import decode_matmul as dm

torch.set_num_threads(2)

RUN = (Path(__file__).resolve().parents[1] / "tools" / "flash_host_sim"
       / "run.py")


def _run_module():
    spec = importlib.util.spec_from_file_location("host_sim_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RUN = _run_module()
CASES = _RUN.decode_cases(torch)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH here")
    return _RUN.Sim(_RUN.build(tmp_path_factory.mktemp("decode_sim"),
                               ["decode"]))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{fn.__name__}-{'-'.join(map(str, args))}"
                              for fn, args in CASES])
def test_decode_gemm_sources_in_host_sim(sim, case):
    fn, args = CASES[case]
    fails = []
    fn(torch, dm, sim, fails, *args)
    assert not fails
