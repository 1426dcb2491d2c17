"""Guards of the port: it imports nothing of JAX or of the JAX package (its
data module and its score mods included), its entry points never fall
back to the CPU on their own, no ``try`` wraps a kernel launch, and its
kernel wrappers never return the plain version for a tensor on the card,
segment ids, a bias, ALiBi and dropout included (the dropout seed's
pointer, threshold and tile sizes reach the kernels)."""
import ast
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from transformerengine_tpu_torch import _build
from transformerengine_tpu_torch.flex_attention import AlibiMod, SoftCapMod
from transformerengine_tpu_torch.inference import (
    ContinuousBatchingEngine, InferenceParams, generate, prefill)
from transformerengine_tpu_torch.models.llama import LLAMA_TINY, LlamaModel
from transformerengine_tpu_torch.models.mixtral import (
    MIXTRAL_TINY, MixtralModel)
from transformerengine_tpu_torch.ops import (
    decode_attention as da, decode_matmul as dm, flash_attention as fa,
    paged_attention as pa, quantize_kernels as qk)
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch import NVFP4BlockScaling
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    BlockScaleQuantizer, CurrentScaleQuantizer, DelayedScaleQuantizer,
    QuantizeLayout)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "transformerengine_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "transformerengine_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
FORBIDDEN = {FORBIDDEN!r}

def forbidden(name):
    return name.split(".")[0] in FORBIDDEN

# Forget anything preloaded, and refuse any later import of them.
for name in [n for n in sys.modules if forbidden(n)]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(ROOT)!r})
import transformerengine_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
left = sorted(n for n in sys.modules if forbidden(n))
print(len(names), left)
assert not left, left
"""


def test_importing_the_whole_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    count, left = out.stdout.split(" ", 1)
    assert int(count) >= 20 and left.strip() == "[]"


def test_data_module_loads_no_jax():
    """The input pipeline alone (its packer built and run) imports
    nothing of JAX or of the JAX package."""
    code = _IMPORT_ALL.split("import transformerengine_tpu_torch as pkg")[0] \
        + """
import numpy as np
from transformerengine_tpu_torch import data
tok, seg, pos = data.pack_sequences(np.arange(1, 50, dtype=np.int32),
                                    np.array([0, 20, 49]), 64)
left = sorted(n for n in sys.modules if forbidden(n))
print(int(seg.max()), left)
assert not left, left
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["2", "[]\n"]
    files = sorted((PORT / "data").rglob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "loader.py"]
    for path in files:
        assert not set(_imported_roots(path)) & set(FORBIDDEN), path


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    # The MoE slice's modules are among them.
    for name in ("moe.py", "permutation.py", "grouped_dense.py",
                 "ops/router.py", "ops/grouped_gemm.py", "nn/moe.py",
                 "models/mixtral.py", "quantize/microbatch.py",
                 "flex_attention.py"):
        assert PORT / name in files, name
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _calls_named(node, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if called == name:
                return True
    return False


def test_no_try_wraps_a_kernel_launch():
    """A failed launch raises to the caller: no module of the port, and
    not chip_smoke.py, catches around a call that launches a kernel."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    launching = 0
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        launching += _calls_named(tree, "launch")
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and node.handlers:
                assert not any(_calls_named(stmt, "launch")
                               for stmt in node.body), \
                    f"{path.relative_to(ROOT)}:{node.lineno}"
    assert launching >= 5


def test_entry_points_without_a_device_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaModel(LLAMA_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MixtralModel(MIXTRAL_TINY)
    from transformerengine_tpu_torch.models.mixtral import load_flax_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_flax_params({}, MIXTRAL_TINY)
    model = LlamaModel(LLAMA_TINY, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.int32)
    paged = InferenceParams(1, 8, is_paged=True, page_size=4)
    batching = dict(max_batch_size=2, max_sequence_length=16, prompt_len=8,
                    max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, tokens, torch.tensor([4]), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill(model, tokens, paged, torch.tensor([4]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model, **batching)
    # A model on the CPU given to an entry point bound for the card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="expected cuda"):
        generate(model, tokens, torch.tensor([4]), 2)
    with pytest.raises(ValueError, match="expected cuda"):
        prefill(model, tokens, paged, torch.tensor([4]))
    with pytest.raises(ValueError, match="expected cuda"):
        ContinuousBatchingEngine(model, **batching)


def test_packed_forward_keeps_the_card_default(monkeypatch):
    """LlamaModel's forward takes a segment descriptor and positions,
    and the model still defaults to the card: without one it raises;
    on the CPU the packed forward runs when asked for."""
    import inspect
    from transformerengine_tpu_torch.attention import SequenceDescriptor
    assert inspect.signature(LlamaModel).parameters["device"].default == \
        "cuda"
    params = inspect.signature(LlamaModel.forward).parameters
    assert list(params)[1:4] == ["tokens", "sequence_descriptor",
                                 "positions"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaModel(LLAMA_TINY)
    model = LlamaModel(LLAMA_TINY, device="cpu")
    seg = torch.tensor([[1, 1, 2, 2, 2, 0]])
    pos = torch.tensor([[0, 1, 0, 1, 2, 0]])
    with torch.no_grad():
        logits = model(torch.ones((1, 6), dtype=torch.int32),
                       SequenceDescriptor.from_segment_ids_and_pos(seg),
                       pos)
    assert logits.shape == (1, 6, LLAMA_TINY.vocab_size)


def _calls():
    """One call of each kernel wrapper, and of the quantizer methods that
    reach the fused casts, on tensors that lie on the card. They are fake
    tensors (shapes, dtypes and a device, no storage), so no card is
    needed to build them."""
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    e4m3 = torch.float8_e4m3fn
    both = QuantizeLayout.ROWWISE_COLWISE

    def cuda(*shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device="cuda")

    def delayed():
        return DelayedScaleQuantizer(torch.float8_e4m3fn,
                                     scale=cuda(1, dtype=f32),
                                     amax_history=cuda(16, dtype=f32))

    def mxfp8():
        return BlockScaleQuantizer(torch.float8_e4m3fn, both)

    return {
        "te_decode_tn_matvec": lambda: dm.decode_tn_matvec(
            cuda(8, 1024), cuda(2048, 1024, dtype=torch.float8_e4m3fn),
            cuda(1, dtype=torch.float32)),
        "te_flash_attention_fwd": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True),
        # The window and sink branch counts under its own names.
        "flash_fwd_sw": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True, window=(16, 0),
            softmax_sink=cuda(4, dtype=f32)),
        "flash_bwd_sw": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=torch.float32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True, window=(16, 0)),
        # The FP8 branches (fp8_dpa, and fp8_mha's fp8 O and dO) count
        # under their own names too.
        "flash_fwd_fp8": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), scale=0.2, causal=True,
            scale_invs=cuda(3, dtype=f32)),
        "flash_fwd_fp8_mha": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), scale=0.2, causal=True,
            window=(16, 0), scale_invs=cuda(3, dtype=f32),
            out_scale=cuda(1, dtype=f32)),
        "flash_bwd_fp8": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), cuda(2, 64, 4, 32),
            cuda(2, 4, 64, dtype=f32), cuda(2, 64, 4, 32), scale=0.2,
            causal=True, scale_invs=cuda(3, dtype=f32)),
        "flash_bwd_fp8_mha": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), cuda(2, 64, 4, 32, dtype=e4m3),
            cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32, dtype=torch.float8_e5m2), scale=0.2,
            causal=True, scale_invs=cuda(3, dtype=f32),
            o_scale_inv=cuda(1, dtype=f32), do_scale_inv=cuda(1, dtype=f32)),
        # The segment branches (packed documents) count under "_seg".
        "flash_fwd_seg": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True, q_segment_ids=cuda(2, 64, dtype=i32),
            kv_segment_ids=cuda(2, 64, dtype=i32)),
        "flash_bwd_seg": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True,
            q_segment_ids=cuda(2, 64, dtype=i32),
            kv_segment_ids=cuda(2, 64, dtype=i32)),
        "flash_fwd_fp8_mha_seg": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), scale=0.2, causal=True,
            scale_invs=cuda(3, dtype=f32), out_scale=cuda(1, dtype=f32),
            q_segment_ids=cuda(2, 64, dtype=i32),
            kv_segment_ids=cuda(2, 64, dtype=i32)),
        "flash_bwd_fp8_mha_seg": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), cuda(2, 64, 4, 32, dtype=e4m3),
            cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32, dtype=torch.float8_e5m2), scale=0.2,
            causal=True, scale_invs=cuda(3, dtype=f32),
            o_scale_inv=cuda(1, dtype=f32), do_scale_inv=cuda(1, dtype=f32),
            q_segment_ids=cuda(2, 64, dtype=i32),
            kv_segment_ids=cuda(2, 64, dtype=i32)),
        # A bias and ALiBi count under "_bias" and "_alibi".
        "flash_fwd_bias": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=False, bias=cuda(1, 4, 64, 64, dtype=f32)),
        "flash_bwd_bias": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=False,
            bias=cuda(2, 4, 64, 64)),
        "flash_fwd_alibi": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True, score_mod=AlibiMod(4)),
        "flash_bwd_alibi": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True,
            score_mod=AlibiMod(4)),
        # Dropout counts under "_dropout", also beside a bias.
        "flash_fwd_dropout": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True, dropout_probability=0.1,
            dropout_seed=cuda(2, dtype=i32)),
        "flash_bwd_dropout": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True,
            dropout_probability=0.1, dropout_seed=cuda(2, dtype=i32)),
        "flash_fwd_bias_dropout": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=False, bias=cuda(1, 4, 64, 64, dtype=f32),
            dropout_probability=0.3, dropout_seed=cuda(2, dtype=i32)),
        "flash_bwd_bias_dropout": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=False,
            bias=cuda(2, 4, 64, 64), dropout_probability=0.3,
            dropout_seed=cuda(2, dtype=i32)),
        # The soft cap counts under "_softcap"; dropout on FP8 Q/K/V under
        # the FP8 branch's name and "_dropout".
        "flash_fwd_softcap": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            scale=0.2, causal=True, score_mod=SoftCapMod(50.0)),
        "flash_bwd_softcap": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True,
            score_mod=SoftCapMod(50.0)),
        "flash_fwd_fp8_dropout": lambda: fa.flash_fwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), scale=0.2, causal=True,
            scale_invs=cuda(3, dtype=f32), dropout_probability=0.1,
            dropout_seed=cuda(2, dtype=i32)),
        "flash_bwd_fp8_mha_dropout": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32, dtype=e4m3), cuda(2, 64, 2, 32, dtype=e4m3),
            cuda(2, 64, 2, 32, dtype=e4m3), cuda(2, 64, 4, 32, dtype=e4m3),
            cuda(2, 4, 64, dtype=f32),
            cuda(2, 64, 4, 32, dtype=torch.float8_e5m2), scale=0.2,
            causal=True, scale_invs=cuda(3, dtype=f32),
            o_scale_inv=cuda(1, dtype=f32), do_scale_inv=cuda(1, dtype=f32),
            dropout_probability=0.1, dropout_seed=cuda(2, dtype=i32)),
        "te_paged_decode_attention": lambda: pa.paged_decode_attention(
            cuda(2, 1, 4, 32), cuda(6, 8, 2, 32, dtype=torch.float8_e4m3fn),
            cuda(6, 8, 2, 32, dtype=torch.float8_e4m3fn),
            cuda(2, 3, dtype=torch.int32), cuda(2, dtype=torch.int32),
            kv_scale=cuda(2, dtype=torch.float32)),
        "te_decode_kn_matvec": lambda: dm.decode_kn_matvec(
            cuda(8, 1024), cuda(1024, 2048, dtype=torch.float8_e4m3fn),
            cuda(32, 2048), block=32),
        "decode_kn_matvec_packed": lambda: dm.decode_kn_matvec(
            cuda(8, 1024, dtype=f32), cuda(512, 2048, dtype=torch.uint8),
            cuda(64, 2048), cuda(1, dtype=f32), block=16, packed=True),
        "te_decode_attention": lambda: da.decode_attention(
            cuda(2, 1, 4, 32), cuda(2, 128, 2, 32, dtype=torch.float8_e4m3fn),
            cuda(2, 128, 2, 32, dtype=torch.float8_e4m3fn),
            cuda(2, dtype=torch.int32), kv_scale=cuda(2, dtype=torch.float32)),
        "te_flash_attention_bwd": lambda: fa.flash_bwd(
            cuda(2, 64, 4, 32), cuda(2, 64, 2, 32), cuda(2, 64, 2, 32),
            cuda(2, 64, 4, 32), cuda(2, 4, 64, dtype=torch.float32),
            cuda(2, 64, 4, 32), scale=0.2, causal=True),
        "te_cast_transpose": lambda: qk.cast_transpose(
            cuda(64, 128), cuda(1, dtype=torch.float32), torch.float8_e5m2),
        "te_norm_cast_transpose": lambda: qk.norm_cast_transpose(
            cuda(256, 128), cuda(128, dtype=torch.float32), None,
            cuda(1, dtype=torch.float32), torch.float8_e4m3fn),
        # Shapes that are not multiples of 16 launch the kernel too.
        "delayed_quantize_2x": lambda: delayed().quantize(
            cuda(24, 40), layout=both),
        "current_quantize_2x": lambda: CurrentScaleQuantizer(
            torch.float8_e5m2).quantize(cuda(3, 8, 40, dtype=f32),
                                        layout=both),
        "quantize_normed": lambda: delayed().quantize_normed(
            cuda(256, 128), cuda(128, dtype=f32), None, norm="rmsnorm",
            zero_centered_gamma=False, epsilon=1e-6),
        "te_mxfp8_quantize_2x": lambda: qk.mxfp8_quantize_2x(
            cuda(64, 128), torch.float8_e5m2),
        "te_mxfp8_quantize_1x": lambda: qk.mxfp8_quantize_1x(
            cuda(64, 128, dtype=f32), colwise=True),
        "te_mxfp8_norm_quantize": lambda: qk.mxfp8_norm_quantize_2x(
            cuda(256, 128), cuda(128, dtype=f32), cuda(128, dtype=f32),
            norm="layernorm", rowwise_only=True),
        # Every MXFP8 orientation of the quantizer API launches a kernel,
        # ragged shapes included.
        "mxfp8_quantize_2x": lambda: mxfp8().quantize(cuda(3, 10, 40)),
        "mxfp8_rowwise": lambda: mxfp8().quantize(
            cuda(100, 37), layout=QuantizeLayout.ROWWISE),
        "mxfp8_colwise": lambda: mxfp8().quantize(
            cuda(24, 40, dtype=f32), layout=QuantizeLayout.COLWISE),
        "mxfp8_quantize_normed": lambda: mxfp8().quantize_normed(
            cuda(256, 128), cuda(128, dtype=f32), None, norm="rmsnorm",
            zero_centered_gamma=False, epsilon=1e-6),
        "te_mxfp8_qdq_2x_grouped": lambda: qk.mxfp8_qdq_2x_grouped(
            cuda(2, 64, 128)),
        "mxfp8_qdq_2x_grouped_e5m2_f32": lambda: qk.mxfp8_qdq_2x_grouped(
            cuda(3, 96, 256, dtype=f32), torch.float8_e5m2),
        "te_nvfp4_amax_2x": lambda: qk.nvfp4_amax_2x(cuda(64, 128), 0x1234),
        "te_nvfp4_quantize_2x": lambda: qk.nvfp4_quantize_2x(
            cuda(64, 128, dtype=f32), cuda(1, dtype=f32), cuda(1, dtype=f32),
            7, seed=5),
        # Both orientations of every NVFP4 role go through the two kernels.
        "nvfp4_x_quantize_2x": lambda: QuantizerFactory.create(
            NVFP4BlockScaling(), "x").quantize(cuda(2, 32, 64)),
        "nvfp4_kernel_quantize_2x": lambda: QuantizerFactory.create(
            NVFP4BlockScaling(), "kernel").quantize(cuda(64, 96, dtype=f32)),
        "nvfp4_dgrad_quantize_2x": lambda: QuantizerFactory.create(
            NVFP4BlockScaling(), "dgrad").quantize(cuda(48, 256)),
    }


# The C entry points each call launches, where they are not the one the
# case is named after: the flash backward runs a dQ and a dK/dV kernel.
_LAUNCHED = {"te_flash_attention_bwd": ["te_flash_attention_bwd_dq",
                                        "te_flash_attention_bwd_dkv"],
             "flash_fwd_sw": ["te_flash_attention_fwd"],
             "flash_bwd_sw": ["te_flash_attention_bwd_dq",
                              "te_flash_attention_bwd_dkv"],
             "flash_fwd_fp8": ["te_flash_attention_fwd"],
             "flash_fwd_fp8_mha": ["te_flash_attention_fwd"],
             "flash_bwd_fp8": ["te_flash_attention_bwd_dq",
                               "te_flash_attention_bwd_dkv"],
             "flash_bwd_fp8_mha": ["te_flash_attention_bwd_dq",
                                   "te_flash_attention_bwd_dkv"],
             "flash_fwd_seg": ["te_flash_attention_fwd"],
             "flash_fwd_fp8_mha_seg": ["te_flash_attention_fwd"],
             "flash_bwd_seg": ["te_flash_attention_bwd_dq",
                               "te_flash_attention_bwd_dkv"],
             "flash_bwd_fp8_mha_seg": ["te_flash_attention_bwd_dq",
                                       "te_flash_attention_bwd_dkv"],
             "flash_fwd_bias": ["te_flash_attention_fwd"],
             "flash_fwd_alibi": ["te_flash_attention_fwd"],
             "flash_bwd_bias": ["te_flash_attention_bwd_dq",
                                "te_flash_attention_bwd_dkv"],
             "flash_bwd_alibi": ["te_flash_attention_bwd_dq",
                                 "te_flash_attention_bwd_dkv"],
             "flash_fwd_dropout": ["te_flash_attention_fwd"],
             "flash_fwd_bias_dropout": ["te_flash_attention_fwd"],
             "flash_bwd_dropout": ["te_flash_attention_bwd_dq",
                                   "te_flash_attention_bwd_dkv"],
             "flash_bwd_bias_dropout": ["te_flash_attention_bwd_dq",
                                        "te_flash_attention_bwd_dkv"],
             "flash_fwd_softcap": ["te_flash_attention_fwd"],
             "flash_bwd_softcap": ["te_flash_attention_bwd_dq",
                                   "te_flash_attention_bwd_dkv"],
             "flash_fwd_fp8_dropout": ["te_flash_attention_fwd"],
             "flash_bwd_fp8_mha_dropout": ["te_flash_attention_bwd_dq",
                                           "te_flash_attention_bwd_dkv"],
             "delayed_quantize_2x": ["te_cast_transpose"],
             "current_quantize_2x": ["te_cast_transpose"],
             "quantize_normed": ["te_norm_cast_transpose"],
             "mxfp8_quantize_2x": ["te_mxfp8_quantize_2x"],
             "mxfp8_rowwise": ["te_mxfp8_quantize_1x"],
             "mxfp8_colwise": ["te_mxfp8_quantize_1x"],
             "mxfp8_quantize_normed": ["te_mxfp8_norm_quantize"],
             "decode_kn_matvec_packed": ["te_decode_kn_matvec"],
             "mxfp8_qdq_2x_grouped_e5m2_f32": ["te_mxfp8_qdq_2x_grouped"],
             **{f"nvfp4_{role}_quantize_2x": ["te_nvfp4_amax_2x",
                                              "te_nvfp4_quantize_2x"]
                for role in ("x", "kernel", "dgrad")}}


@pytest.mark.parametrize("entry", ["te_decode_tn_matvec",
                                   "te_flash_attention_fwd",
                                   "flash_fwd_sw", "flash_bwd_sw",
                                   "flash_fwd_fp8", "flash_fwd_fp8_mha",
                                   "flash_bwd_fp8", "flash_bwd_fp8_mha",
                                   "flash_fwd_seg", "flash_bwd_seg",
                                   "flash_fwd_fp8_mha_seg",
                                   "flash_bwd_fp8_mha_seg",
                                   "flash_fwd_bias", "flash_bwd_bias",
                                   "flash_fwd_alibi", "flash_bwd_alibi",
                                   "flash_fwd_dropout", "flash_bwd_dropout",
                                   "flash_fwd_bias_dropout",
                                   "flash_bwd_bias_dropout",
                                   "flash_fwd_softcap", "flash_bwd_softcap",
                                   "flash_fwd_fp8_dropout",
                                   "flash_bwd_fp8_mha_dropout",
                                   "te_decode_attention",
                                   "te_paged_decode_attention",
                                   "te_decode_kn_matvec",
                                   "decode_kn_matvec_packed",
                                   "te_flash_attention_bwd",
                                   "te_cast_transpose",
                                   "te_norm_cast_transpose",
                                   "delayed_quantize_2x",
                                   "current_quantize_2x",
                                   "quantize_normed",
                                   "te_mxfp8_quantize_2x",
                                   "te_mxfp8_quantize_1x",
                                   "te_mxfp8_norm_quantize",
                                   "mxfp8_quantize_2x", "mxfp8_rowwise",
                                   "mxfp8_colwise", "mxfp8_quantize_normed",
                                   "te_mxfp8_qdq_2x_grouped",
                                   "mxfp8_qdq_2x_grouped_e5m2_f32",
                                   "te_nvfp4_amax_2x", "te_nvfp4_quantize_2x",
                                   "nvfp4_x_quantize_2x",
                                   "nvfp4_kernel_quantize_2x",
                                   "nvfp4_dgrad_quantize_2x"])
def test_wrappers_on_the_card_launch_or_raise(entry, monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel, and counts the
    launch, or raises; it never returns its plain version, and the
    quantizers never quantize both orientations (nor, under MXFP8, any
    orientation) the unfused way."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(dm, "decode_tn_matvec_plain", plain)
    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(da, "decode_attention_plain", plain)
    monkeypatch.setattr(pa, "paged_decode_attention_plain", plain)
    monkeypatch.setattr(dm, "decode_kn_matvec_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(qk, "cast_transpose_plain", plain)
    monkeypatch.setattr(qk, "norm_cast_transpose_plain", plain)
    monkeypatch.setattr(qk, "mxfp8_quantize_2x_plain", plain)
    monkeypatch.setattr(qk, "mxfp8_quantize_1x_plain", plain)
    monkeypatch.setattr(qk, "mxfp8_norm_quantize_2x_plain", plain)
    monkeypatch.setattr(qk, "mxfp8_qdq_2x_grouped_plain", plain)
    monkeypatch.setattr(qmath, "tensor_scale_quantize", plain)
    monkeypatch.setattr(qmath, "current_scale_quantize", plain)
    monkeypatch.setattr(qmath, "mxfp8_quantize", plain)
    monkeypatch.setattr(qk, "nvfp4_amax_2x_plain", plain)
    monkeypatch.setattr(qk, "nvfp4_quantize_2x_plain", plain)
    monkeypatch.setattr(qmath, "nvfp4_quantize", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    launched = []
    with warnings.catch_warnings(), FakeTensorMode():
        # Fake tensors warn that their data pointers are not real.
        warnings.simplefilter("ignore", UserWarning)
        call = _calls()[entry]
        # Here there is no nvcc and no card: the launch raises.
        with pytest.raises(Exception) as err:
            call()
        assert not isinstance(err.value, AssertionError)
        before = _build.LAUNCHES.copy()
        def launch(name, *args):
            # As many arguments as the C entry point takes.
            assert len(args) == len(_build._SIGNATURES[name]), name
            launched.append(name)

        monkeypatch.setattr(_build, "launch", launch)
        call()
    expected = _LAUNCHED.get(entry, [entry])
    assert launched == expected
    grown = _build.LAUNCHES - before
    assert sum(grown.values()) == len(expected)
    if entry.endswith(("_sw", "_seg", "_bias", "_alibi", "_softcap",
                       "_dropout")):
        suffix = entry[entry.rindex("_"):]
        assert all(name.endswith(suffix) for name in grown), grown
    if entry.endswith("_bias_dropout"):
        assert all(name.endswith("_bias_dropout") for name in grown), grown
    if "_fp8" in entry:
        branch = "_fp8_mha" if "_mha" in entry else "_fp8"
        assert all(branch in name for name in grown), grown
        if entry == "flash_fwd_fp8_mha":     # with its window: "_sw" last
            assert all(name.endswith("_fp8_mha_sw") for name in grown), grown
    if entry.startswith("flash_") and not entry.endswith("_seg"):
        assert not any(name.endswith("_seg") for name in grown), grown


# Where the lengths and the segment ids sit among each C entry point's
# arguments.
_MASK_ARGS = {"te_flash_attention_fwd": slice(7, 11),
              "te_flash_attention_bwd_dq": slice(10, 14),
              "te_flash_attention_bwd_dkv": slice(11, 15)}


@pytest.mark.parametrize("how", ["kernel", "descriptor"])
def test_segment_ids_reach_the_kernels(how, monkeypatch):
    """On CUDA tensors the ids reach the forward, dQ and dK/dV kernels as
    int32 (B, S) pointers in place of the lengths, called directly or
    through ``flash_attention``'s descriptor (whose ids win over its
    lengths), and the plain versions never run."""
    from transformerengine_tpu_torch.attention import (
        AttnMaskType, SequenceDescriptor)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    seen = {}
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: seen.setdefault(
                            name, args[_MASK_ARGS[name]]))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16,
                         device="cuda")
        ids = torch.empty((2, 64), dtype=torch.int64, device="cuda")
        if how == "kernel":
            o, lse = fa.flash_fwd(q, kv, kv, scale=0.2, causal=True,
                                  q_segment_ids=ids, kv_segment_ids=ids)
            fa.flash_bwd(q, kv, kv, o, lse, q, scale=0.2, causal=True,
                         q_segment_ids=ids, kv_segment_ids=ids)
        else:
            lens = torch.empty((2,), dtype=torch.int32, device="cuda")
            desc = SequenceDescriptor(q_seqlens=lens, kv_seqlens=lens,
                                      q_segment_ids=ids, kv_segment_ids=ids)
            fa.flash_attention(q, kv, kv, desc,
                               attn_mask_type=AttnMaskType.PADDING_CAUSAL)
    expect = (["te_flash_attention_fwd"] if how == "descriptor"
              else list(_MASK_ARGS))
    assert sorted(seen) == sorted(expect)
    for name, (qlens, klens, qseg, kseg) in seen.items():
        assert qlens is None and klens is None, name
        for t in (qseg, kseg):
            assert t.dtype == torch.int32 and tuple(t.shape) == (2, 64), name
            assert t.device.type == "cuda" and t.is_contiguous(), name


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    w = torch.zeros((2048, 1024), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="all on one CUDA device"):
        dm.decode_tn_matvec(x, w)


# Where a bias (pointer, dtype code, batch), the ALiBi slopes and dbias
# sit among each C entry point's arguments.
_TERM_ARGS = {"te_flash_attention_fwd": slice(14, 18),
              "te_flash_attention_bwd_dq": slice(15, 20),
              "te_flash_attention_bwd_dkv": slice(16, 20)}


@pytest.mark.parametrize("term", ["bias", "alibi"])
def test_bias_and_slopes_reach_the_kernels(term, monkeypatch):
    """On CUDA tensors a broadcast bf16 bias reaches the forward, dQ and
    dK/dV kernels with its dtype code and batch 1 (the dQ kernel also
    gets a per-batch f32 dbias to write), and ALiBi reaches them as an
    (Hq,) f32 slopes vector and no bias; the plain versions never run,
    and the wrappers refuse a bias of the wrong shape before any
    launch."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    seen = {}
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: seen.setdefault(
                            name, args[_TERM_ARGS[name]]))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16,
                         device="cuda")
        kw = (dict(bias=torch.empty((1, 4, 64, 64), dtype=torch.bfloat16,
                                    device="cuda"))
              if term == "bias" else dict(score_mod=AlibiMod(4)))
        o, lse = fa.flash_fwd(q, kv, kv, scale=0.2, causal=False, **kw)
        grads = fa.flash_bwd(q, kv, kv, o, lse, q, scale=0.2, causal=False,
                             **kw)
        assert len(grads) == (4 if term == "bias" else 3)
        for bad in ((2, 4, 64, 32), (3, 4, 64, 64)):
            with pytest.raises(ValueError, match="bias must be"):
                fa.flash_fwd(q, kv, kv, scale=0.2, causal=False,
                             bias=torch.empty(bad, device="cuda"))
    assert sorted(seen) == sorted(_TERM_ARGS)
    for name, args in seen.items():
        bias, code, batch, slopes = args[:4]
        if term == "bias":
            assert (code, batch) == (_build.DTYPE_CODES[torch.bfloat16], 1)
            assert tuple(bias.shape) == (1, 4, 64, 64) and slopes is None
            if name == "te_flash_attention_bwd_dq":
                dbias = args[4]
                assert dbias.dtype == torch.float32
                assert tuple(dbias.shape) == (2, 4, 64, 64)
        else:
            assert bias is None and (code, batch) == (-1, 0)
            assert slopes.dtype == torch.float32 and \
                tuple(slopes.shape) == (4,)
            if name == "te_flash_attention_bwd_dq":
                assert args[4] is None


@pytest.mark.parametrize("how", ["kernel", "flash_attention"])
def test_dropout_seed_reaches_the_kernels(how, monkeypatch):
    """On CUDA tensors the forward, dQ and dK/dV kernels get the seed
    words as a (2,) int32 pointer on the card (no host copy of them), the
    reference's threshold, 1 / (1 - rate) in f32 and the reference's tile
    sizes (here the MAX_ROWS cap at GQA 4: 256 x 1024 at S 2048); the
    plain versions never run, and without dropout the seed is null.
    ``flash_attention`` passes its arguments on (its forward without
    autograd: fake tensors here cannot record a graph)."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    seen = {}
    monkeypatch.setattr(_build, "launch", lambda name, *args: seen.setdefault(
        name, []).append(args[-6:-1]))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((2, 2048, 16, 32), dtype=torch.bfloat16,
                        device="cuda")
        kv = torch.empty((2, 2048, 4, 32), dtype=torch.bfloat16,
                         device="cuda")
        seed = torch.empty((2,), dtype=torch.int32, device="cuda")
        kw = dict(dropout_probability=0.1, dropout_seed=seed)
        if how == "kernel":
            o, lse = fa.flash_fwd(q, kv, kv, scale=0.2, causal=True, **kw)
            fa.flash_bwd(q, kv, kv, o, lse, q, scale=0.2, causal=True, **kw)
            fa.flash_fwd(q, kv, kv, scale=0.2, causal=True)
        else:
            fa.flash_attention(q, kv, kv, **kw)
    assert sorted(seen) == (sorted(_MASK_ARGS) if how == "kernel"
                            else ["te_flash_attention_fwd"])
    inv = float(torch.tensor(1 / 0.9, dtype=torch.float32))
    for name, calls in seen.items():
        ptr, thr, got_inv, bq, bk = calls[0]
        assert ptr.dtype == torch.int32 and tuple(ptr.shape) == (2,), name
        assert ptr.device.type == "cuda", name
        assert (thr, got_inv, bq, bk) == (429496730, inv, 256, 1024), name
    if how == "kernel":
        assert seen["te_flash_attention_fwd"][1] == (None, 0, 1.0, 0, 0)


def test_a_dropout_launch_failure_raises(monkeypatch):
    """A failed build or launch of a dropout instance raises to the
    caller; the plain version never stands in for it."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def fail(name, *args):
        raise RuntimeError(f"{name} failed: CUDA error 1")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "launch", fail)
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((1, 64, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device="cuda")
        kw = dict(scale=0.2, causal=True, dropout_probability=0.1,
                  dropout_seed=torch.empty((2,), dtype=torch.int32,
                                           device="cuda"))
        with pytest.raises(RuntimeError, match="CUDA error"):
            fa.flash_fwd(q, kv, kv, **kw)
        lse = torch.empty((1, 4, 64), dtype=torch.float32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA error"):
            fa.flash_bwd(q, kv, kv, q, lse, q, **kw)


@pytest.mark.parametrize("how", ["kernel", "flex_attention"])
def test_soft_cap_reaches_the_kernels(how, monkeypatch):
    """On CUDA tensors the forward, dQ and dK/dV kernels get the cap as a
    float beside the scale, q unscaled (the tensor itself), no bias and
    no slopes; ``flex_attention(impl="flash")`` passes ``soft_cap_mod``
    and ``causal_mask_mod`` on as the cap and the causal rule with offset
    0 (its forward without autograd: fake tensors here cannot record a
    graph). Without a cap the kernels get 0. The plain versions never
    run."""
    from transformerengine_tpu_torch.flex_attention import (
        causal_mask_mod, flex_attention, soft_cap_mod)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    seen = {}
    monkeypatch.setattr(_build, "launch", lambda name, *args: seen.setdefault(
        name, []).append(args))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((2, 96, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((2, 128, 2, 32), dtype=torch.bfloat16,
                         device="cuda")
        if how == "kernel":
            kw = dict(scale=0.2, causal=True, score_mod=SoftCapMod(30.0))
            o, lse = fa.flash_fwd(q, kv, kv, **kw)
            fa.flash_bwd(q, kv, kv, o, lse, q, **kw)
            fa.flash_fwd(q, kv, kv, scale=0.2, causal=True)
        else:
            with torch.no_grad():
                flex_attention(q, kv, kv, score_mod=soft_cap_mod(30.0),
                               mask_mod=causal_mask_mod,
                               scaling_factor=0.2, impl="flash")
    assert sorted(seen) == (sorted(_MASK_ARGS) if how == "kernel"
                            else ["te_flash_attention_fwd"])
    for name, calls in seen.items():
        args = calls[0]
        assert args[0] is q, name                  # q not pre-scaled
        assert args[_TERM_ARGS[name]][0] is None, name      # no bias
        scale, cap = args[-8:-6]
        assert (scale, cap) == (0.2, 30.0), name
        causal, offset = args[-12:-10]
        assert (causal, offset) == (1, 0), name
    if how == "kernel":
        assert seen["te_flash_attention_fwd"][1][-7] == 0.0


def test_flex_causal_mask_alone_reaches_the_alibi_branch(monkeypatch):
    """``flex_attention(impl="flash")`` with ``causal_mask_mod`` and no
    score mod launches the forward's ALiBi branch: q unscaled (the tensor
    itself), an (Hq,) f32 slopes vector (zeros, which the CPU tests hold
    by their numbers), no cap, and the causal rule with offset 0."""
    from transformerengine_tpu_torch.flex_attention import (
        causal_mask_mod, flex_attention)
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", plain)
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    seen = {}
    monkeypatch.setattr(_build, "launch", lambda name, *args: seen.setdefault(
        name, args))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((2, 96, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((2, 128, 2, 32), dtype=torch.bfloat16,
                         device="cuda")
        with torch.no_grad():
            flex_attention(q, kv, kv, mask_mod=causal_mask_mod,
                           scaling_factor=0.2, impl="flash")
    args = seen["te_flash_attention_fwd"]
    assert list(seen) == ["te_flash_attention_fwd"]
    assert args[0] is q
    bias, _, _, slopes = args[_TERM_ARGS["te_flash_attention_fwd"]]
    assert bias is None
    assert slopes.dtype == torch.float32 and tuple(slopes.shape) == (4,)
    assert tuple(args[-8:-6]) == (0.2, 0.0)
    assert tuple(args[-12:-10]) == (1, 0)


def test_soft_cap_and_fp8_dropout_arguments(monkeypatch):
    """The cap's exclusions, before any launch: with a bias, with FP8
    Q/K/V, and a cap that is not finite and positive raise; FP8 Q/K/V
    with dropout now launch, with the seed words' pointer."""
    monkeypatch.setattr(_build, "stream", lambda t: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: launched.append((name, args)))
    e4m3 = torch.float8_e4m3fn
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q = torch.empty((1, 64, 4, 32), dtype=torch.bfloat16, device="cuda")
        kv = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device="cuda")
        q8, kv8 = q.to(e4m3), kv.to(e4m3)
        sinv = torch.empty((3,), dtype=torch.float32, device="cuda")
        cap = SoftCapMod(20.0)
        with pytest.raises(ValueError, match="mutually exclusive"):
            fa.flash_fwd(q, kv, kv, scale=0.2, causal=True, score_mod=cap,
                         bias=torch.empty((1, 4, 64, 64), device="cuda"))
        with pytest.raises(ValueError, match="FP8"):
            fa.flash_fwd(q8, kv8, kv8, scale=0.2, causal=True,
                         scale_invs=sinv, score_mod=cap)
        for bad in (0.0, -1.0, float("inf")):
            with pytest.raises(ValueError, match="finite soft cap"):
                fa.flash_fwd(q, kv, kv, scale=0.2, causal=True,
                             score_mod=SoftCapMod(bad))
        assert not launched
        seed = torch.empty((2,), dtype=torch.int32, device="cuda")
        fa.flash_fwd(q8, kv8, kv8, scale=0.2, causal=True, scale_invs=sinv,
                     dropout_probability=0.1, dropout_seed=seed)
    (name, args), = launched
    assert name == "te_flash_attention_fwd" and args[-6] is seed

