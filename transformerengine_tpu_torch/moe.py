"""MoE block: routing, dispatch, the grouped expert MLP and combine
(counterpart of transformerengine_tpu/moe.py, single device). Expert
parallelism (the reference's ``ep_axis`` paths) is not ported yet."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .dense import needs_grad
from .grouped_dense import grouped_dense
from .ops.activation import (_ACT, CLAMPED, clamped_swiglu,
                             normalize_activation_type)
from .ops.gemm import matmul_f32
from .ops.grouped_gemm import host_sizes
from .ops.router import compute_routing
from .permutation import token_combine, token_dispatch
from .quantize.quantizer import QuantizerSet, noop_quantizer_set


def _expert_mlp(h, w_up, w_down, group_sizes, acts, qset1, qset2,
                kernel_caches=None):
    """The grouped MLP over expert-contiguous rows: w_up (E, H, n_act*F),
    w_down (E, F, H); GPT-OSS's clamped SwiGLU takes two FFN halves."""
    kc1, kc2 = kernel_caches if kernel_caches is not None else (None, None)
    ffn = w_down.shape[1]
    z = grouped_dense(h, w_up, group_sizes, quantizer_set=qset1,
                      kernel_cache=kc1)
    if acts == CLAMPED:
        a = clamped_swiglu(z.reshape(*z.shape[:-1], 2, ffn))
    elif len(acts) == 2:
        z = z.reshape(*z.shape[:-1], 2, ffn)
        a = _ACT[acts[0]](z[..., 0, :]) * _ACT[acts[1]](z[..., 1, :])
    else:
        a = _ACT[acts[0]](z)
    return grouped_dense(a.to(h.dtype), w_down, group_sizes,
                         quantizer_set=qset2, kernel_cache=kc2)


def moe(x: torch.Tensor, router_weight: torch.Tensor, w_up: torch.Tensor,
        w_down: torch.Tensor, *, topk: int = 2,
        activation_type: Union[str, Sequence[str]] = "swiglu",
        score_function: str = "softmax", aux_loss_coeff: float = 1e-2,
        expert_bias: Optional[torch.Tensor] = None, num_groups: int = 0,
        group_topk: int = 0,
        quantizer_sets: Tuple[QuantizerSet, QuantizerSet] = (
            noop_quantizer_set, noop_quantizer_set),
        ep_axis: Optional[str] = None,
        kernel_caches=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output with x's shape and dtype, aux loss, a 0-d f32 tensor) of
    ``x`` (T, H) or (B, S, H): the f32 router, top-``topk`` routing,
    dispatch, the grouped expert MLP under ``quantizer_sets`` (up, down)
    and the weighted combine. With a gradient the group sizes are read
    to the host once here, for both grouped GEMMs and their backward;
    without one they stay an (E,) tensor on the device. ``kernel_caches``:
    (up, down) from ``quantize.microbatch.quantize_grouped_kernel``, or
    None."""
    if ep_axis:
        raise NotImplementedError("expert parallelism (ep_axis) is not "
                                  "ported yet")
    orig_shape = x.shape
    h = x.reshape(-1, x.shape[-1])
    t = h.shape[0]
    acts = normalize_activation_type(activation_type)
    # The router is an f32 GEMM; on the card it is full f32 only while
    # torch.backends.cuda.matmul.allow_tf32 is False (PyTorch's default),
    # and a TF32 product would move tokens that sit near a routing tie.
    logits = matmul_f32(h.float(), router_weight.float())
    probs, routing_map, aux_loss = compute_routing(
        logits, topk, score_function=score_function,
        aux_loss_coeff=aux_loss_coeff, expert_bias=expert_bias,
        num_groups=num_groups, group_topk=group_topk)
    disp, aux = token_dispatch(h, routing_map, num_out_tokens=t * topk)
    sizes = aux["group_sizes"]
    if needs_grad(x, router_weight, w_up, w_down):
        sizes = host_sizes(sizes)
    out_e = _expert_mlp(disp, w_up, w_down, sizes, acts, *quantizer_sets,
                        kernel_caches=kernel_caches)
    out = token_combine(out_e.to(h.dtype), probs, aux, topk=topk)
    return out.reshape(orig_shape).to(x.dtype), aux_loss
