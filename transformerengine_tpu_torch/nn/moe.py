"""Norm + top-k routed mixture-of-experts MLP (counterpart of
transformerengine_tpu/flax/moe.py), a sibling of ``LayerNormMLP``. It
returns its router aux loss beside its output, where the reference sows
it into ``"intermediates"``. Not ported yet: expert parallelism, the
expert bias and the capacity path."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..moe import moe
from ..ops.activation import normalize_activation_type, num_halves
from .module import LayerNorm, TransformerEngineBase, init_kernel


class MoELayerNormMLP(TransformerEngineBase):
    """RMSNorm, then :func:`~..moe.moe` with the reference's parameters:
    ``ln.scale`` (f32), ``router_kernel`` (H, E) f32, ``wi_kernel`` (E, H,
    n_act * F) and ``wo_kernel`` (E, F, H); quantizer sets "moe_up" and
    "moe_down". ``forward`` returns (output, aux loss). Inside
    ``kernel_caches`` the expert kernels are quantized once per step."""

    def __init__(self, hidden: int, intermediate_dim: int, *,
                 num_experts: int = 8, topk: int = 2, epsilon: float = 1e-6,
                 activations: Union[str, Sequence[str]] = ("silu", "linear"),
                 score_function: str = "softmax",
                 aux_loss_coeff: float = 1e-2,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.topk = topk
        self.score_function = score_function
        self.aux_loss_coeff = aux_loss_coeff
        self.activations = normalize_activation_type(activations)
        n_act = num_halves(self.activations)
        e, f = num_experts, intermediate_dim
        self.ln = LayerNorm(hidden, epsilon=epsilon, norm_type="rmsnorm",
                            device=device)
        self.router_kernel = init_kernel((hidden, e), hidden, torch.float32,
                                         device, generator)
        self.wi_kernel = init_kernel((e, hidden, n_act * f), hidden, dtype,
                                     device, generator)
        self.wo_kernel = init_kernel((e, f, hidden), f, dtype, device,
                                     generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        up, down = self.quantizer_set("moe_up"), self.quantizer_set("moe_down")
        return moe(
            self.ln(x), self.router_kernel, self.wi_kernel, self.wo_kernel,
            topk=self.topk, activation_type=self.activations,
            score_function=self.score_function,
            aux_loss_coeff=self.aux_loss_coeff, quantizer_sets=(up, down),
            kernel_caches=(
                self.kernel_cache("wi_kernel", self.wi_kernel, up, True),
                self.kernel_cache("wo_kernel", self.wo_kernel, down, True)))
