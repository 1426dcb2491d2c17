"""The port's MIXTRAL_TINY training step under MXFP8BlockScaling against
the JAX package's eager ``value_and_grad`` of its loss, and its
forward without a gradient, with ``test_torch_mixtral.py``'s weights,
tokens and helpers.

The step is chaotic as a whole: the grouped GEMMs sum in another order
than XLA's ``ragged_dot``, a bf16 result a ulp apart moves its e4m3 code
by a step (an eighth of its value) at the next quantize, and so every
gradient differs by a few percent in norm, though each layer is exact on
equal inputs (``test_torch_moe_layers.py``). The second layer's router
inputs differ that way too (its logits by up to 0.07), more than some
tokens' gaps between their 2nd and 3rd logit, so its routing maps alone
are held equal. The gradients are held in norm, and the expert kernels'
must lie nearer the reference's MXFP8 gradients than the port's own bf16
step's: the recipe moves them further than the chaos does. Both
sides scale the loss by 2^16, which keeps the gradients' block exponents
where XLA's CPU ``exp2`` is exact (``test_torch_mxfp8_step.py``)."""
import numpy as np
import torch

from test_torch_mixtral import (
    _assert_same_routing, _flat, _model, _reference, _step, _tokens)
from transformerengine_tpu_torch import MXFP8BlockScaling, autocast
from transformerengine_tpu_torch import moe as t_moe
from transformerengine_tpu_torch.models.mixtral import MIXTRAL_TINY

torch.set_num_threads(2)

# Readings 1.1e-4 (loss) and up to 6.1e-2 in norm (the second layer's
# wo_kernel).
MXFP8_LOSS_ATOL = 2e-3
MXFP8_GNORM = 2 ** -3


def test_mxfp8_step_loss_and_grads_match(monkeypatch):
    loss_j, grads_j, _, _, ln_j = _reference("mxfp8")
    # Each MoE layer reads its group sizes to the host once per step.
    reads = []
    real = t_moe.host_sizes
    monkeypatch.setattr(t_moe, "host_sizes",
                        lambda g: reads.append(1) or real(g))
    model = _model()
    loss, seen = _step(model, "mxfp8")
    assert len(reads) == MIXTRAL_TINY.num_layers
    _assert_same_routing(seen, ln_j, strict=False)
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    assert abs(loss - loss_j) <= MXFP8_LOSS_ATOL
    plain = _model()
    _step(plain, "bf16")
    bf16 = {n: p.grad.float().numpy() for n, p in plain.named_parameters()}
    for name, p in named.items():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        got = p.grad.float().numpy()
        dist = np.linalg.norm(got - grads_j[name]) / np.linalg.norm(
            grads_j[name])
        assert dist <= MXFP8_GNORM, (name, dist)
        if name.endswith(("wi_kernel", "wo_kernel")):
            to_bf16 = np.linalg.norm(got - bf16[name]) / np.linalg.norm(
                bf16[name])
            assert to_bf16 > 2 * dist, (name, dist, to_bf16)


def test_mxfp8_forward_without_grad_runs_the_grouped_kernel(monkeypatch):
    """The forward without a gradient quantizes each expert stack once
    per layer and GEMM through the grouped QDQ (two a layer), and gives
    the training forward's logits."""
    from transformerengine_tpu_torch.ops import quantize_kernels as qk
    calls = []
    real = qk.mxfp8_qdq_2x_grouped
    monkeypatch.setattr(qk, "mxfp8_qdq_2x_grouped",
                        lambda *a, **k: calls.append(a[0].shape) or real(
                            *a, **k))
    model = _model()
    tok = torch.from_numpy(_tokens()[0])
    with torch.no_grad(), autocast(recipe=MXFP8BlockScaling()):
        logits = model(tok)
    assert logits.grad_fn is None
    cfg = MIXTRAL_TINY
    assert calls == [(cfg.num_experts, cfg.hidden_size,
                      2 * cfg.intermediate_size),
                     (cfg.num_experts, cfg.intermediate_size,
                      cfg.hidden_size)] * cfg.num_layers
    with autocast(recipe=MXFP8BlockScaling()):
        trained = model(tok)
    torch.testing.assert_close(trained.detach(), logits, rtol=0, atol=0)
