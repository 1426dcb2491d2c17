"""Train-state checkpoints of the port (``utils/checkpoint.py``): a save,
restore and resume of LLAMA_TINY under DelayedScaling with the
low-precision ``fused_adam`` (int16 remainders, bf16 and fp8 moments)
bitwise equal to uninterrupted training; fp8 ``ScaledTensor1x`` and
int16 leaves round-tripping in their own dtypes through a file that
loads with ``weights_only=True``; the template's checks; the reference's
train-state layout."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from transformerengine_tpu.utils.checkpoint import (
    state_with_quantize_meta as j_state_with_quantize_meta)
from transformerengine_tpu_torch import DelayedScaling, autocast
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss)
from transformerengine_tpu_torch.optimizers import (
    AdamState, ScaledState, clip_by_global_norm, fused_adam, grads_of)
from transformerengine_tpu_torch.quantize.qmath import current_scale_quantize
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode
from transformerengine_tpu_torch.quantize.tensor import ScaledTensor1x
from transformerengine_tpu_torch.utils import (
    restore_checkpoint, save_checkpoint, state_with_quantize_meta)

torch.set_num_threads(2)

B, S = 2, 32


def _batch():
    rng = np.random.default_rng(13)
    return (torch.from_numpy(rng.integers(1, 256, (B, S)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 256, (B, S)).astype(np.int32)))


def _opt():
    return fused_adam(1e-3, weight_decay=0.01, store_param_remainders=True,
                      exp_avg_dtype=torch.bfloat16,
                      exp_avg_sq_dtype=torch.float8_e4m3fn)


def _train(model, opt, state, steps):
    tok, tgt = _batch()
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        with autocast(recipe=DelayedScaling(amax_history_len=16)):
            cross_entropy_loss(model(tok), tgt).backward()
        grads, _ = clip_by_global_norm(grads_of(model), 1.0)
        state = opt.apply(model, state, grads)
    return state


def _tensors(state: AdamState) -> dict:
    out = {"step": state.step}
    for part in ("mu", "nu", "master"):
        for n, x in getattr(state, part).items():
            if isinstance(x, ScaledState):
                out[f"{part}.{n}.payload"] = x.payload
                out[f"{part}.{n}.scale_inv"] = x.scale_inv
            else:
                out[f"{part}.{n}"] = x
    return out


def _bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and torch.equal(got[n], t), n


@pytest.mark.parametrize("remat", [False, True])
def test_resume_is_bitwise_uninterrupted_training(tmp_path, remat):
    cfg = dataclasses.replace(LLAMA_TINY, remat=remat)
    model = LlamaModel(cfg, device="cpu", seed=2)
    with torch.no_grad():
        model.embedding.mul_(0.02)
    opt = _opt()
    state = _train(model, opt, opt.init(model), 2)
    path = save_checkpoint(str(tmp_path / "ckpt.pt"), state_with_quantize_meta(
        model.state_dict(), opt_state=state, step=2))
    state = _train(model, opt, state, 2)

    fresh = LlamaModel(cfg, device="cpu", seed=9)
    saved = restore_checkpoint(path)
    assert saved["step"] == 2 and isinstance(saved["opt_state"], AdamState)
    # Every delayed-scaling buffer is in the saved state_dict.
    assert sum(k.endswith("_amax_history") for k in saved["params"]) == \
        3 * 4 * cfg.num_layers
    fresh.load_state_dict(saved["params"])
    resumed = _train(fresh, opt, saved["opt_state"], 2)
    _bitwise(dict(fresh.state_dict()), dict(model.state_dict()))
    _bitwise(_tensors(resumed), _tensors(state))
    assert any(isinstance(v, ScaledState) for v in resumed.nu.values())
    assert any(v.dtype == torch.int16 for v in resumed.master.values())


def _fp8_leaf(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (16, 8)).astype(np.float32))
    data, sinv, amax = current_scale_quantize(x, torch.float8_e4m3fn)
    return ScaledTensor1x(data, sinv, amax.reshape(1), torch.bfloat16,
                          scaling_mode=ScalingMode.CURRENT_TENSOR_SCALING)


def test_fp8_and_int16_leaves_round_trip_in_their_dtypes(tmp_path):
    params = {"w": _fp8_leaf(0), "b": torch.randn(8).to(torch.bfloat16)}
    opt = fused_adam(1e-2, use_master_weights=True, store_param_remainders=True,
                     exp_avg_dtype=torch.float8_e5m2)
    state = opt.init(params)
    grads = {"w": torch.randn(16, 8), "b": torch.randn(8)}
    params, state = opt.step(grads, state, params)
    tree = {"params": params, "opt_state": state, "step": 1,
            "nested": [("a", torch.arange(3, dtype=torch.int16)), None]}
    path = save_checkpoint(str(tmp_path / "a.pt"), tree)
    raw = torch.load(path, weights_only=True)
    assert isinstance(raw, dict) and "params" in raw
    back = restore_checkpoint(path)
    w, w0 = back["params"]["w"], params["w"]
    assert isinstance(w, ScaledTensor1x) and w.dq_dtype == torch.bfloat16
    assert w.scaling_mode is ScalingMode.CURRENT_TENSOR_SCALING
    for f in ("data", "scale_inv", "amax"):
        assert getattr(w, f).dtype == getattr(w0, f).dtype
        assert torch.equal(getattr(w, f).view(torch.uint8)
                           if f == "data" else getattr(w, f),
                           getattr(w0, f).view(torch.uint8)
                           if f == "data" else getattr(w0, f))
    assert back["params"]["b"].dtype == torch.bfloat16
    _bitwise(_tensors(back["opt_state"]), _tensors(state))
    assert back["opt_state"].master["b"].dtype == torch.int16
    assert back["opt_state"].mu["w"].payload.dtype == torch.float8_e5m2
    assert back["nested"][0][0] == "a" and back["nested"][1] is None
    # One more step from the restored state equals one from the saved.
    grads = {"w": torch.randn(16, 8), "b": torch.randn(8)}
    p1, s1 = opt.step(grads, state, params)
    p2, s2 = opt.step(grads, back["opt_state"], back["params"])
    _bitwise(_tensors(s2), _tensors(s1))
    assert torch.equal(p2["b"], p1["b"])


def test_template_checks_and_force(tmp_path):
    state = {"x": torch.ones(3), "opt": AdamState(
        torch.zeros((), dtype=torch.int32), {"x": torch.zeros(3)},
        {"x": torch.zeros(3)}, {"x": None})}
    path = save_checkpoint(str(tmp_path / "t.pt"), state)
    back = restore_checkpoint(path, template=copy.deepcopy(state))
    assert torch.equal(back["x"], state["x"])
    assert back["opt"].master["x"] is None
    bad = dict(state, x=torch.ones(4))
    with pytest.raises(ValueError, match="state.x"):
        restore_checkpoint(path, template=bad)
    with pytest.raises(ValueError, match="keys differ"):
        restore_checkpoint(path, template={"x": torch.ones(3)})
    with pytest.raises(FileExistsError):
        save_checkpoint(path, state, force=False)


def test_train_state_layout_is_the_reference_one():
    for kw in (dict(), dict(quantize_meta={"q": 1}),
               dict(opt_state="o", step=3)):
        got = state_with_quantize_meta({"p": 0}, **kw)
        want = j_state_with_quantize_meta({"p": 0}, **kw)
        assert got == want
