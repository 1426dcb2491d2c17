"""``torch.nn`` modules over the functional layers (counterpart of
transformerengine_tpu/flax/module.py: LayerNorm, DenseGeneral,
LayerNormDenseGeneral, LayerNormMLP).

Parameters keep the reference's names and layouts (kernels contracting
dim first, norm ``scale`` and, under ``norm_type="layernorm"``, its
``ln_bias`` in f32), so a Flax params tree maps onto a ``state_dict`` one
to one, and they are trainable. The norm modules take the reference's
``norm_type`` ("layernorm", the default, or "rmsnorm") and
``zero_centered_gamma`` (the scale stored as gamma - 1, zeros at init). After
:func:`~..quantize.prequant.prequantize_kernels`, a kernel parameter is
replaced by a :class:`~..quantize.prequant.PrequantizedKernel` whose
buffers hold the resident (N, K) payload.

Under :func:`~..quantize.helper.autocast`, each GEMM takes the quantizer
set of :meth:`TransformerEngineBase.quantizer_set`. A delayed-scaling
quantizer is backed by two buffers of the module, named as the
reference's ``quantize_meta`` variables: ``{name}_{role}_scale`` (1,) and
``{name}_{role}_amax_history`` (L,), role x, kernel or dgrad. They are
created at the first quantized call (as Flax creates the variables at
init), or by ``load_state_dict`` from a state that holds them, and every
backward pass writes the updated state into them (``dense.py``).

Gradient accumulation (the reference's ``kernel_cache`` collection, its
``is_first_microbatch`` weight workspace): inside ``with
kernel_caches(model):`` the first quantized call of each module's GEMM
quantizes its kernel once (``quantize/microbatch.py``) and every later
microbatch inside the block reuses it, so an optimizer step's N
microbatches quantize each kernel once. No cache exists outside the
block, and none is built at construction. The cache holds the weights
as they were when it was built and is never checked against them: step
the optimizer after the block ends, never inside it, or the layers
compute with stale weights.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..dense import dense
from ..layernorm import layernorm
from ..layernorm_dense import layernorm_dense
from ..layernorm_mlp import layernorm_mlp
from ..ops.activation import act_lu, normalize_activation_type, num_halves
from ..quantize.helper import QuantizerFactory, get_quantize_config
from ..quantize.microbatch import quantize_grouped_kernel, quantize_kernel
from ..quantize.prequant import PrequantizedKernel
from ..quantize.quantizer import (DelayedScaleQuantizer, QuantizerSet,
                                  noop_quantizer_set)

_META = re.compile(r"^\w+_(x|kernel|dgrad)_(scale|amax_history)$")


def init_kernel(shape, fan_in: int, dtype: torch.dtype, device,
                generator: Optional[torch.Generator]) -> nn.Parameter:
    """LeCun-normal kernel (std 1/sqrt(fan_in)), drawn in f32."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) / math.sqrt(fan_in)
    return nn.Parameter(w.to(dtype))


def _norm_params(module: nn.Module, hidden: int, norm_type: str,
                 zero_centered_gamma: bool, device) -> None:
    """The reference's norm parameters on ``module``: an f32 ``scale``
    (ones, or zeros under ``zero_centered_gamma``) and, for "layernorm",
    an f32 ``ln_bias`` of zeros (else None)."""
    if norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(f"norm_type must be layernorm or rmsnorm, got "
                         f"{norm_type!r}")
    module.norm_type = norm_type
    module.zero_centered_gamma = zero_centered_gamma
    fill = torch.zeros if zero_centered_gamma else torch.ones
    module.scale = nn.Parameter(fill(hidden, dtype=torch.float32,
                                     device=device))
    module.ln_bias = (nn.Parameter(torch.zeros(hidden, dtype=torch.float32,
                                               device=device))
                      if norm_type == "layernorm" else None)


class TransformerEngineBase(nn.Module):
    """Holds the delayed-scaling state of the module's GEMMs, and inside
    :func:`kernel_caches` their kernel caches."""

    # {kernel name: KernelCache or None} inside kernel_caches(), else None.
    _kernel_caches = None

    def kernel_cache(self, name: str, kernel, qset: QuantizerSet,
                     grouped: bool = False):
        """The cache of kernel ``name`` for this step (module docstring):
        built at the first call inside :func:`kernel_caches`, the same one
        after; None outside it, for a prequantized kernel and without
        quantization. ``grouped``: stacked expert kernels."""
        caches = self._kernel_caches
        if caches is None or isinstance(kernel, PrequantizedKernel) or \
                qset.x is None:
            return None
        if name not in caches:
            build = quantize_grouped_kernel if grouped else quantize_kernel
            caches[name] = build(kernel, qset)[0]
        return caches[name]

    def quantizer_set(self, name: str) -> QuantizerSet:
        """The quantizer set of GEMM ``name`` under the active recipe (the
        no-op set outside ``autocast``), its delayed-scaling state in this
        module's buffers."""
        cfg = get_quantize_config()
        if not cfg.enabled:
            return noop_quantizer_set
        qset = QuantizerFactory.create_set(cfg.recipe, device=self._device())
        out = {}
        for role in ("x", "kernel", "dgrad"):
            q = getattr(qset, role)
            if isinstance(q, DelayedScaleQuantizer):
                scale = self._meta_buffer(f"{name}_{role}_scale", q.scale)
                hist = self._meta_buffer(f"{name}_{role}_amax_history",
                                         q.amax_history)
                q = DelayedScaleQuantizer(
                    q.q_dtype, q.q_layout, scale=scale, amax_history=hist,
                    margin=q.margin, amax_compute_algo=q.amax_compute_algo)
            out[role] = q
        return QuantizerSet(**out)

    def _device(self) -> torch.device:
        t = next(self.parameters(), None)
        if t is None:
            t = next(self.buffers())
        return t.device

    def _meta_buffer(self, name: str, init: torch.Tensor) -> torch.Tensor:
        if name not in self._buffers:
            self.register_buffer(name, init.clone())
        return self._buffers[name]

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # Delayed-scaling buffers in the incoming state that this module
        # has not created yet (it has not run under the recipe) are
        # registered first, so a saved or converted state loads whole.
        for key, value in state_dict.items():
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            if "." not in name and _META.match(name) and \
                    name not in self._buffers:
                self.register_buffer(name, torch.empty_like(
                    value, device=self._device()))
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)


@contextlib.contextmanager
def kernel_caches(model: nn.Module):
    """One optimizer step of gradient accumulation over ``model``: inside,
    each module's kernels are quantized at their first call and reused by
    the later microbatches; the caches are dropped when the block ends
    (module docstring). Step the optimizer after the block."""
    mods = [m for m in model.modules()
            if isinstance(m, TransformerEngineBase)]
    if any(m._kernel_caches is not None for m in mods):
        raise RuntimeError("kernel_caches blocks do not nest")
    for m in mods:
        m._kernel_caches = {}
    try:
        yield model
    finally:
        for m in mods:
            m._kernel_caches = None


class LayerNorm(nn.Module):
    """LayerNorm (with ``ln_bias``) or RMSNorm over the last axis, its
    parameters in f32, differentiable through the functional
    ``layernorm``."""

    def __init__(self, hidden: int, *, epsilon: float = 1e-6,
                 norm_type: str = "layernorm",
                 zero_centered_gamma: bool = False, device=None):
        super().__init__()
        self.epsilon = epsilon
        _norm_params(self, hidden, norm_type, zero_centered_gamma, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.ln_bias, self.norm_type,
                         self.zero_centered_gamma, epsilon=self.epsilon)


def _bias(use_bias: bool, features: int, dtype: torch.dtype, device):
    """The reference's ``bias`` parameter: (features,) zeros in the
    kernel's dtype, or None."""
    if not use_bias:
        return None
    return nn.Parameter(torch.zeros(features, dtype=dtype, device=device))


class DenseGeneral(TransformerEngineBase):
    """``x . kernel (+ bias)`` with a (in_features, features) kernel and,
    with ``use_bias``, a (features,) ``bias``; quantizer set "dense".
    The port's models pass ``use_bias`` as the reference's attention does
    (off unless the model asks), so the default is off."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = init_kernel((in_features, features), in_features,
                                  dtype, device, generator)
        self.bias = _bias(use_bias, features, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qset = self.quantizer_set("dense")
        return dense(x, self.kernel, self.bias, quantizer_set=qset,
                     kernel_cache=self.kernel_cache("kernel", self.kernel,
                                                    qset))


class LayerNormDenseGeneral(TransformerEngineBase):
    """``norm(x) . kernel (+ bias)``; quantizer set "ln_dense". The port's
    layers pass ``use_bias`` as the reference's attention does, so the
    default is off."""

    def __init__(self, in_features: int, features: int, *,
                 epsilon: float = 1e-6, norm_type: str = "layernorm",
                 zero_centered_gamma: bool = False, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        _norm_params(self, in_features, norm_type, zero_centered_gamma,
                     device)
        self.kernel = init_kernel((in_features, features), in_features,
                                  dtype, device, generator)
        self.bias = _bias(use_bias, features, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qset = self.quantizer_set("ln_dense")
        return layernorm_dense(
            x, self.kernel, self.scale, beta=self.ln_bias, bias=self.bias,
            norm_type=self.norm_type,
            zero_centered_gamma=self.zero_centered_gamma,
            epsilon=self.epsilon, quantizer_set=qset,
            kernel_cache=self.kernel_cache("kernel", self.kernel, qset))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in training: each element kept with
    probability 1 - ``rate`` (a uniform draw from ``generator`` on ``x``'s
    device below it) and divided by it, in ``x``'s dtype; the reference's
    bits are JAX's and not copied."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def check_generator(training_rates, generator) -> None:
    """A training call with any dropout rate above 0 needs an explicit
    ``torch.Generator`` (the reference's ``dropout`` PRNG stream)."""
    if generator is None and any(r > 0.0 for r in training_rates):
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator (generator=...)")


class LayerNormMLP(TransformerEngineBase):
    """``dense(act(dense(norm(x))))`` with ``wi_kernel`` (hidden, n_act,
    intermediate) and ``wo_kernel`` (intermediate, hidden); quantizer
    sets "mlp1" and "mlp2". The activations default to the reference
    module's ``("relu",)``; its biases are not ported. With
    ``intermediate_dropout_rate`` > 0 a training call
    (``deterministic=False``) runs the reference's unfused chain (norm,
    dense, activation, :func:`dropout` from ``generator``, dense) on the
    same parameters and quantizer sets."""

    def __init__(self, hidden: int, intermediate_dim: int, *,
                 epsilon: float = 1e-6, norm_type: str = "layernorm",
                 zero_centered_gamma: bool = False,
                 activations: Union[str, Sequence[str]] = ("relu",),
                 intermediate_dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        self.intermediate_dropout_rate = intermediate_dropout_rate
        self.activations = normalize_activation_type(activations)
        n_act = num_halves(self.activations)
        _norm_params(self, hidden, norm_type, zero_centered_gamma, device)
        self.wi_kernel = init_kernel((hidden, n_act, intermediate_dim),
                                     hidden, dtype, device, generator)
        self.wo_kernel = init_kernel((intermediate_dim, hidden),
                                     intermediate_dim, dtype, device,
                                     generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.intermediate_dropout_rate
        check_generator((rate,), generator)
        qset1, qset2 = self.quantizer_set("mlp1"), self.quantizer_set("mlp2")
        kc1 = self.kernel_cache("wi_kernel", self.wi_kernel, qset1)
        kc2 = self.kernel_cache("wo_kernel", self.wo_kernel, qset2)
        if rate > 0.0:
            h, n_act, ffn = self.wi_kernel.shape
            y = layernorm(x, self.scale, self.ln_bias, self.norm_type,
                          self.zero_centered_gamma, epsilon=self.epsilon)
            a = dense(y, self.wi_kernel.reshape(h, n_act * ffn),
                      quantizer_set=qset1, kernel_cache=kc1)
            a = a.reshape(*a.shape[:-1], n_act, ffn) if n_act > 1 else a
            act = dropout(act_lu(a, self.activations), rate, generator)
            return dense(act, self.wo_kernel, quantizer_set=qset2,
                         kernel_cache=kc2)
        return layernorm_mlp(x, self.scale, self.wi_kernel, self.wo_kernel,
                             beta=self.ln_bias, norm_type=self.norm_type,
                             zero_centered_gamma=self.zero_centered_gamma,
                             epsilon=self.epsilon,
                             activation_type=self.activations,
                             quantizer_sets=(qset1, qset2),
                             kernel_caches=(kc1, kc2))
