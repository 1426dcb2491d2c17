"""PyTorch and CUDA port of transformerengine_tpu for NVIDIA Hopper.

The JAX package ``transformerengine_tpu`` is the reference; this package
imports nothing of it (nor of JAX) and mirrors its layout: ``quantize/``,
``ops/``, ``inference/``, ``models/``, the functional layers, ``nn/`` in
place of ``flax/``, and ``csrc/`` for the hand-written CUDA kernels,
which are built with nvcc at first use (``_build.py``).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
from .common import recipe
from .common.recipe import (E4M3, E5M2, HYBRID, CustomRecipe, DelayedScaling,
                            Float8BlockScaling, Float8CurrentScaling, Format,
                            MMParams, MXFP8BlockScaling, NVFP4BlockScaling,
                            QParams, Recipe)
from .quantize.helper import autocast, get_quantize_config
from . import checkpoint_policies
from .flex_attention import flex_attention
from .graph import make_graphed_callables
from .models.gptoss import GPTOSS_20B, GPTOSS_TINY, GptOssModel
from .models.mixtral import MIXTRAL_8X7B, MIXTRAL_TINY, MixtralModel

__all__ = ["CustomRecipe", "DelayedScaling", "E4M3", "E5M2",
           "Float8BlockScaling", "Float8CurrentScaling", "Format",
           "GPTOSS_20B", "GPTOSS_TINY", "GptOssModel", "HYBRID",
           "MIXTRAL_8X7B", "MIXTRAL_TINY", "MMParams", "MXFP8BlockScaling",
           "MixtralModel", "NVFP4BlockScaling", "QParams", "Recipe",
           "autocast", "checkpoint_policies", "flex_attention",
           "get_quantize_config", "make_graphed_callables", "recipe"]
