"""The active quantization configuration, the ``autocast`` context and
``QuantizerFactory`` (counterpart of transformerengine_tpu/quantize/
helper.py). The only global state is which recipe is active; numeric
state (scales, amax histories) lives in the quantizers, and for ``nn``
modules in their buffers."""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

from ..common.recipe import (CustomRecipe, DelayedScaling, Float8BlockScaling,
                             Float8CurrentScaling, MXFP8BlockScaling,
                             NVFP4BlockScaling, Recipe)
from .quantizer import (BlockScaleQuantizer, CurrentScaleQuantizer,
                        DelayedScaleQuantizer, NVFP4Quantizer, Quantizer,
                        QuantizeLayout, QuantizerSet, noop_quantizer_set)
from .scaling_modes import ScalingMode


@dataclasses.dataclass
class QuantizeConfig:
    enabled: bool = False
    recipe: Optional[Recipe] = None


class _State(threading.local):
    def __init__(self):
        self.stack = [QuantizeConfig()]


_state = _State()


def get_quantize_config() -> QuantizeConfig:
    return _state.stack[-1]


@contextlib.contextmanager
def autocast(enabled: bool = True, recipe: Optional[Recipe] = None):
    """Low-precision execution for the port's modules in scope; the
    recipe defaults to ``DelayedScaling()``."""
    if enabled and recipe is None:
        recipe = DelayedScaling()
    cfg = QuantizeConfig(enabled=enabled, recipe=recipe)
    _state.stack.append(cfg)
    try:
        yield cfg
    finally:
        _state.stack.pop()


def _nvfp4_quantizer(recipe: NVFP4BlockScaling, role: str,
                     q_layout: QuantizeLayout) -> NVFP4Quantizer:
    qp = {"x": recipe.fp4_quant_fwd_inp,
          "kernel": recipe.fp4_quant_fwd_weight,
          "dgrad": recipe.fp4_quant_bwd_grad}[role]
    fos = recipe.nvfp4_4over6
    fmt = recipe.fp4_format
    return NVFP4Quantizer(
        fmt.bwd_dtype if role == "dgrad" else fmt.fwd_dtype, q_layout,
        scaling_mode=(ScalingMode.NVFP4_2D_SCALING if qp.fp4_2d_quantization
                      else ScalingMode.NVFP4_1D_SCALING),
        with_rht=qp.random_hadamard_transform,
        stochastic_rounding=qp.stochastic_rounding,
        four_over_six=(fos == "all" or (fos == "weights" and role == "kernel")
                       or (fos == "activations" and role == "x")))


class QuantizerFactory:
    """Quantizers and quantizer sets from a recipe."""

    @staticmethod
    def create(recipe: Optional[Recipe], role: str,
               q_layout: QuantizeLayout = QuantizeLayout.ROWWISE_COLWISE,
               device=None) -> Optional[Quantizer]:
        """The quantizer of one tensor ``role`` ("x", "kernel" or
        "dgrad"); gradients take the format's backward dtype. A delayed
        quantizer starts at scale 1 with a zero history of the recipe's
        length, on ``device``. MXFP8's margin is not read, as in the
        reference. Under NVFP4 each role takes its ``QParams`` (the RHT,
        stochastic rounding, 2D blocks) and "four over six" where
        ``nvfp4_4over6`` names its class of tensor. Under FP8 block
        scaling each role takes its block dim (1 x 128 or 128 x 128).
        A ``CustomRecipe`` returns its factory's quantizer for the role
        (None: high precision)."""
        if role not in ("x", "kernel", "dgrad"):
            raise ValueError(f"role must be x, kernel or dgrad, got {role!r}")
        if recipe is None:
            return None
        if isinstance(recipe, CustomRecipe):
            return recipe.qfactory(role) if recipe.qfactory else None
        if isinstance(recipe, NVFP4BlockScaling):
            return _nvfp4_quantizer(recipe, role, q_layout)
        if not isinstance(recipe, (DelayedScaling, Float8CurrentScaling,
                                   MXFP8BlockScaling, Float8BlockScaling)):
            raise TypeError(f"not a recipe: {type(recipe).__name__}")
        fmt = recipe.fp8_format
        dtype = fmt.bwd_dtype if role == "dgrad" else fmt.fwd_dtype
        if isinstance(recipe, DelayedScaling):
            return DelayedScaleQuantizer(
                dtype, q_layout,
                scale=torch.ones((1,), dtype=torch.float32, device=device),
                amax_history=torch.zeros((recipe.amax_history_len,),
                                         dtype=torch.float32, device=device),
                margin=recipe.margin,
                amax_compute_algo=recipe.amax_compute_algo)
        if isinstance(recipe, MXFP8BlockScaling):
            return BlockScaleQuantizer(dtype, q_layout)
        if isinstance(recipe, Float8BlockScaling):
            dim = {"x": recipe.x_block_scaling_dim,
                   "kernel": recipe.w_block_scaling_dim,
                   "dgrad": recipe.grad_block_scaling_dim}[role]
            return BlockScaleQuantizer(
                dtype, q_layout,
                scaling_mode=(ScalingMode.BLOCK_SCALING_2D if dim == 2
                              else ScalingMode.BLOCK_SCALING_1D),
                pow2_scales=recipe.force_pow_2_scales)
        return CurrentScaleQuantizer(dtype, q_layout)

    @staticmethod
    def create_set(recipe: Optional[Recipe] = None,
                   fwd_layout=QuantizeLayout.ROWWISE_COLWISE,
                   bwd_layout=QuantizeLayout.ROWWISE_COLWISE,
                   device=None) -> QuantizerSet:
        """One QuantizerSet (x, kernel, dgrad) for one GEMM, from
        ``recipe`` or else the active configuration."""
        if recipe is None:
            cfg = get_quantize_config()
            if not cfg.enabled:
                return noop_quantizer_set
            recipe = cfg.recipe
        return QuantizerSet(
            x=QuantizerFactory.create(recipe, "x", fwd_layout, device),
            kernel=QuantizerFactory.create(recipe, "kernel", fwd_layout,
                                           device),
            dgrad=QuantizerFactory.create(recipe, "dgrad", bwd_layout,
                                          device))
