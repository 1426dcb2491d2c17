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

from ..common.recipe import (DelayedScaling, Float8CurrentScaling,
                             MXFP8BlockScaling, Recipe)
from .quantizer import (BlockScaleQuantizer, CurrentScaleQuantizer,
                        DelayedScaleQuantizer, Quantizer, QuantizeLayout,
                        QuantizerSet, noop_quantizer_set)


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
        reference."""
        if role not in ("x", "kernel", "dgrad"):
            raise ValueError(f"role must be x, kernel or dgrad, got {role!r}")
        if recipe is None:
            return None
        if not isinstance(recipe, (DelayedScaling, Float8CurrentScaling,
                                   MXFP8BlockScaling)):
            raise NotImplementedError(
                f"recipe {type(recipe).__name__} is not ported yet; ported: "
                f"DelayedScaling, Float8CurrentScaling and "
                f"MXFP8BlockScaling")
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
