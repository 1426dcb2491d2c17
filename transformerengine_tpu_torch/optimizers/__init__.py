"""Fused optimizers (counterpart of transformerengine_tpu/optimizers)."""
from .fused_adam import (AdamState, FusedAdam, GradientTransformation,
                         ScaledState, apply_updates, fused_adam, fused_sgd,
                         muon, newton_schulz)
from .multi_tensor import (clip_by_global_norm, grads_of,
                           multi_tensor_compute_scale_and_scale_inv,
                           multi_tensor_l2norm, multi_tensor_scale,
                           multi_tensor_unscale_l2norm)
