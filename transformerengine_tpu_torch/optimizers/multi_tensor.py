"""Multi-tensor utilities (counterpart of transformerengine_tpu/optimizers/
multi_tensor.py): the global L2 norm, its loss-unscaled form, the scale,
per-tensor FP8 scales from amaxes, and clipping by the global norm.

A tree here is a mapping of name to tensor (None leaves are skipped, as
JAX skips them), or a module, whose parameters' gradients are the tree.
Norms sum each leaf's squares in f32 and then add the leaves in the
mapping's order, as the reference adds its leaves in their tree order
(a dict's sorted keys); they are plain PyTorch ops, one chain a leaf.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

__all__ = [
    "multi_tensor_l2norm", "multi_tensor_unscale_l2norm",
    "multi_tensor_scale", "multi_tensor_compute_scale_and_scale_inv",
    "clip_by_global_norm", "grads_of",
]

Tree = Union[Mapping[str, Optional[torch.Tensor]], nn.Module]


def grads_of(model: nn.Module) -> dict:
    """{name: gradient} of the module's parameters (None where a
    parameter has none)."""
    return {n: p.grad for n, p in model.named_parameters()}


def _mapping(tree: Tree) -> Mapping:
    return grads_of(tree) if isinstance(tree, nn.Module) else tree


def _leaf_sq(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * xf).sum()


def _sum_in_order(values) -> torch.Tensor:
    total = None
    for v in values:
        total = v if total is None else total + v
    return total


def multi_tensor_l2norm(tree: Tree, per_tensor: bool = False):
    """The global L2 norm (f32, 0-dim) of the tree's leaves, and with
    ``per_tensor`` also {name: that leaf's norm}."""
    leaves = {n: t for n, t in _mapping(tree).items() if t is not None}
    sqs = {n: _leaf_sq(t) for n, t in leaves.items()}
    total = _sum_in_order(sqs.values())
    total = torch.sqrt(total) if total is not None else \
        torch.zeros((), dtype=torch.float32)
    if per_tensor:
        return total, {n: torch.sqrt(s) for n, s in sqs.items()}
    return total


def multi_tensor_unscale_l2norm(tree: Tree, inv_scale,
                                per_tensor: bool = False):
    """The L2 norm of ``tree * inv_scale``, each leaf widened to f32 first
    (a loss-scaled step's gradient norm in unscaled units)."""
    leaves = {n: t for n, t in _mapping(tree).items() if t is not None}
    unscaled = {}
    for n, t in leaves.items():
        inv = torch.as_tensor(inv_scale, dtype=torch.float32, device=t.device)
        unscaled[n] = t.float() * inv
    return multi_tensor_l2norm(unscaled, per_tensor=per_tensor)


def multi_tensor_scale(tree: Tree, scale) -> dict:
    """``tree * scale`` leaf by leaf, each product in f32 and rounded to
    the leaf's dtype; None leaves stay None."""
    out = {}
    for n, t in _mapping(tree).items():
        if t is None:
            out[n] = None
            continue
        s = torch.as_tensor(scale, dtype=torch.float32, device=t.device)
        out[n] = (t.float() * s).to(t.dtype)
    return out


def _scale_of(amax, max_fp8: float, margin: float, pow_2_scales: bool,
              epsilon: float) -> torch.Tensor:
    a = torch.as_tensor(amax, dtype=torch.float32).clamp_min(epsilon)
    # Tensor numerators: ``float / tensor`` multiplies by the reciprocal.
    scale = torch.full_like(a, max_fp8) / a / (2.0 ** margin)
    scale = torch.where(a > 0, scale, torch.ones_like(scale))
    if pow_2_scales:
        scale = torch.exp2(torch.floor(torch.log2(scale)))
    return scale


def multi_tensor_compute_scale_and_scale_inv(
        amaxes, max_fp8: float, *, margin: float = 0.0,
        pow_2_scales: bool = False, epsilon: float = 0.0
) -> Tuple[object, object]:
    """(scales, scale_invs) from amaxes, a tensor or a mapping of them:
    ``max_fp8 / max(amax, epsilon) / 2^margin``, 1 where that amax is 0;
    ``pow_2_scales`` rounds each scale down to a power of two (E8M0
    compatible)."""
    def one(amax):
        s = _scale_of(amax, max_fp8, margin, pow_2_scales, epsilon)
        return s, torch.ones_like(s) / s

    if isinstance(amaxes, Mapping):
        pairs = {n: one(a) for n, a in amaxes.items()}
        return ({n: p[0] for n, p in pairs.items()},
                {n: p[1] for n, p in pairs.items()})
    return one(amaxes)


def clip_by_global_norm(tree: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """(the tree scaled so its global L2 norm is at most ``max_norm``, the
    global norm): ``multi_tensor_l2norm`` then ``multi_tensor_scale`` by
    min(1, max_norm / max(norm, 1e-12)), as the reference's trainers
    clip. A module's tree is its gradients; the clipped copy is returned
    and the module is left as it is."""
    g = norm if norm is not None else multi_tensor_l2norm(tree)
    g = torch.as_tensor(g, dtype=torch.float32)
    factor = torch.clamp(torch.full_like(g, max_norm) / g.clamp_min(1e-12),
                         max=1.0)
    return multi_tensor_scale(tree, factor), g
