"""Checkpoint and resume of a training state with its quantizer state
(counterpart of transformerengine_tpu/utils/checkpoint.py).

The train state is a nested structure of mappings, lists and tuples
whose leaves are tensors, numbers, strings, None, the optimizers'
:class:`~..optimizers.fused_adam.AdamState` and ``ScaledState`` and fp8
``ScaledTensor1x`` leaves: typically :func:`state_with_quantize_meta` of
a model's ``state_dict()`` (which holds the delayed-scaling
``*_scale``/``*_amax_history`` buffers), the optimizer's state and the
step. ``torch.save`` writes each tensor in its own dtype (fp8 payloads,
int16 remainders), so a round trip is bitwise. The dataclasses are saved
as tagged dicts of their fields and built again on restore, so the file
loads with ``torch.load(weights_only=True)``: nothing but tensors and
plain containers is unpickled.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

import torch

from ..optimizers.fused_adam import AdamState, ScaledState
from ..quantize.scaling_modes import ScalingMode
from ..quantize.tensor import ScaledTensor1x

_TAG = "__checkpoint_class__"
_CLASSES = {cls.__name__: cls
            for cls in (AdamState, ScaledState, ScaledTensor1x)}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _encode(x):
    if isinstance(x, ScaledTensor1x):
        fields = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
        fields["dq_dtype"] = _dtype_name(x.dq_dtype)
        fields["scaling_mode"] = x.scaling_mode.name
        return {_TAG: "ScaledTensor1x", **fields}
    if type(x) in (AdamState, ScaledState):
        return {_TAG: type(x).__name__,
                **{f.name: _encode(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, Mapping):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    return x


def _decode(x):
    if isinstance(x, Mapping):
        fields = {k: _decode(v) for k, v in x.items() if k != _TAG}
        name = x.get(_TAG)
        if name is None:
            return fields
        if name == "ScaledTensor1x":
            fields["dq_dtype"] = getattr(torch, fields["dq_dtype"])
            fields["scaling_mode"] = ScalingMode[fields["scaling_mode"]]
        return _CLASSES[name](**fields)
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v) for v in x)
    return x


def save_checkpoint(path, state: Any, *, force: bool = True):
    """Writes ``state`` to ``path`` (over an existing file unless
    ``force`` is False, which then raises); returns the absolute path.
    ``path`` may also be a binary file object, written as it stands and
    returned."""
    if hasattr(path, "write"):
        torch.save(_encode(state), path)
        return path
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    torch.save(_encode(state), path)
    return path


def _like(got, template, where: str):
    """``got`` with each tensor moved to its ``template`` tensor's device,
    checked against the template's structure, shapes and dtypes."""
    if isinstance(template, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != template.shape \
                or got.dtype != template.dtype:
            raise ValueError(f"{where}: the checkpoint holds "
                             f"{_describe(got)}, the template "
                             f"{_describe(template)}")
        return got.to(template.device)
    if dataclasses.is_dataclass(template):
        if type(got) is not type(template):
            raise ValueError(f"{where}: {type(got).__name__} against "
                             f"{type(template).__name__}")
        return dataclasses.replace(got, **{
            f.name: _like(getattr(got, f.name), getattr(template, f.name),
                          f"{where}.{f.name}")
            for f in dataclasses.fields(template)
            if isinstance(getattr(template, f.name),
                          (torch.Tensor, Mapping, list, tuple))
            or dataclasses.is_dataclass(getattr(template, f.name))})
    if isinstance(template, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(template):
            raise ValueError(f"{where}: keys differ from the template's")
        return {k: _like(got[k], v, f"{where}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(got) != len(template):
            raise ValueError(f"{where}: length differs from the template's")
        return type(template)(_like(g, t, f"{where}[{i}]")
                              for i, (g, t) in enumerate(zip(got, template)))
    return got


def _describe(t) -> str:
    if isinstance(t, torch.Tensor):
        return f"{tuple(t.shape)} {t.dtype}"
    return type(t).__name__


def restore_checkpoint(path, template: Optional[Any] = None) -> Any:
    """The state :func:`save_checkpoint` wrote (``path`` or a binary file
    object, read from where it stands), each tensor on the device it was
    saved from. With ``template`` (a state of the same structure) each
    tensor goes to its template tensor's device, and a structure, shape
    or dtype that differs raises."""
    state = _decode(torch.load(path, weights_only=True))
    if template is not None:
        state = _like(state, template, "state")
    return state


def state_with_quantize_meta(params, quantize_meta=None, opt_state=None,
                             step=0) -> dict:
    """The train state's layout: the params (a ``state_dict``, which for
    the port's modules already holds the delayed-scaling buffers) beside
    the recipe state, the optimizer state and the step, so that a resume
    under DelayedScaling is bitwise."""
    state = {"params": params, "step": step}
    if quantize_meta is not None:
        state["quantize_meta"] = quantize_meta
    if opt_state is not None:
        state["opt_state"] = opt_state
    return state
