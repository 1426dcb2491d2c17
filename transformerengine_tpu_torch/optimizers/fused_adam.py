"""Fused optimizers (counterpart of transformerengine_tpu/optimizers/
fused_adam.py): Adam(W) with f32 masters, int16 remainders, fp8 param
leaves and low-precision states; SGD; Newton-Schulz and Muon.

A params tree is a mapping of name to tensor (or, for Adam, to a
per-tensor-scaled fp8 ``ScaledTensor1x``), as a module's
``named_parameters()`` names them. Each optimizer is a pair of
functions, ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``, as an optax transformation; :func:`apply_updates`
adds the updates, as ``optax.apply_updates`` does. Adam also has
``step(grads, state, params) -> (new_params, new_state)``, which writes
the new values itself (remainder masters and fp8 leaves need it), and
``apply(model, state, grads=None)``, the same step written into the
module's parameters in place (``copy_``), so the parameter objects and
whatever holds them stay valid.

Adam's arithmetic is the reference's ``_adam_math``, op for op and in
its order, in f32: ``b1c = 1 - beta1 ** step``, ``m2 = beta1 * m + (1 -
beta1) * g``, ``v2 = beta2 * v + (1 - beta2) * g * g``, ``u = (m2 / b1c)
/ (sqrt(v2 / b2c) + eps)``, AdamW's decay added to ``u`` (or classic L2
added to ``g``), and ``master - lr * u``. Python scalars enter each op in
f32, as JAX's weak types do, and every op is a plain PyTorch op, one
chain a leaf (a fused multi-tensor kernel is later work). This is not
``torch.optim.AdamW``, whose step folds the bias corrections into the
step size and decays the parameter first.

``store_param_remainders``: an f32 master is its bf16 high half (the
parameter, truncated) and its low 16 bits (an int16 remainder kept in
the state), so bf16 leaves carry the f32 trajectory exactly at two bytes
a parameter; the halves are bit views (``view(torch.int16)``), never a
cast. Other leaves keep f32 masters, as the reference's ``_master_for``
does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..quantize import qmath
from ..quantize.tensor import ScaledTensor1x

__all__ = ["AdamState", "ScaledState", "FusedAdam", "GradientTransformation",
           "apply_updates", "fused_adam", "fused_sgd", "newton_schulz",
           "muon"]


@dataclasses.dataclass
class AdamState:
    """Adam's state: the step count ((), int32, on the params' device) and
    {name: leaf} of the first and second moments (tensors or
    :class:`ScaledState`) and of the masters (f32, int16 remainders, or
    None)."""
    step: torch.Tensor
    mu: Dict[str, object]
    nu: Dict[str, object]
    master: Dict[str, Optional[torch.Tensor]]


@dataclasses.dataclass
class ScaledState:
    """A low-precision state leaf: a per-tensor current-scaled fp8 payload
    and its (1,) f32 ``scale_inv``."""
    payload: torch.Tensor
    scale_inv: torch.Tensor


def _split_master(master_f32: torch.Tensor):
    """(bf16 high half, int16 low half) of f32 masters, by bit views."""
    halves = master_f32.contiguous().view(torch.int16).unflatten(-1, (-1, 2))
    return (halves[..., 1].contiguous().view(torch.bfloat16),
            halves[..., 0].contiguous())


def _combine_master(p_bf16: torch.Tensor, rem_i16: torch.Tensor):
    """The f32 masters whose halves are ``p_bf16`` and ``rem_i16``."""
    halves = torch.stack([rem_i16, p_bf16.view(torch.int16)], dim=-1)
    return halves.view(torch.float32).squeeze(-1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root. The card's is; PyTorch's
    vectorized CPU one is not (tens of elements in 6,144 one ulp off),
    so on the CPU it is taken in f64 and rounded once, which gives the
    correctly rounded f32 result."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _is_quantized(p) -> bool:
    return isinstance(p, ScaledTensor1x)


def _param_value_f32(p) -> torch.Tensor:
    """f32 view of a param leaf (a tensor or an fp8 ScaledTensor1x)."""
    if _is_quantized(p):
        return p.dequantize().float()
    return p.float()


def _requantize_param(p_old, master_f32: torch.Tensor):
    """The new master in the leaf's storage: an fp8 leaf quantized anew by
    current scaling, a tensor rounded to its dtype (a copy, never the
    master itself)."""
    if _is_quantized(p_old):
        data, scale_inv, amax = qmath.current_scale_quantize(
            master_f32, p_old.data.dtype)
        return dataclasses.replace(
            p_old, data=data, scale_inv=scale_inv.to(p_old.scale_inv.dtype),
            amax=amax.reshape(1) if p_old.amax is not None else None)
    return master_f32.to(p_old.dtype, copy=True)


def _enc_state(x_f32: torch.Tensor, dtype: torch.dtype):
    if dtype == torch.float32:
        return x_f32
    if dtype.itemsize == 2:
        return x_f32.to(dtype)
    data, scale_inv, _ = qmath.current_scale_quantize(x_f32, dtype)
    return ScaledState(data, scale_inv)


def _dec_state(x, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x
    if isinstance(x, ScaledState):
        return x.payload.float() * x.scale_inv.float().reshape(())
    return x.float()


def _shape_of(p):
    return p.data.shape if _is_quantized(p) else p.shape


def _device_of(p) -> torch.device:
    return p.data.device if _is_quantized(p) else p.device


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    """Adam/AdamW (the reference's ``fused_adam``; :func:`fused_adam`
    builds it). ``init``, ``update`` and ``step`` are the reference's
    transformation; ``apply`` is the in-place form for a module."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    use_master_weights: bool = False
    adam_w_mode: bool = True
    store_param_remainders: bool = False
    exp_avg_dtype: torch.dtype = torch.float32
    exp_avg_sq_dtype: torch.dtype = torch.float32

    def _master_for(self, p):
        if self.store_param_remainders and not _is_quantized(p) \
                and p.dtype == torch.bfloat16:
            # f32(bf16 param) has zero low mantissa bits: remainder 0.
            return torch.zeros(p.shape, dtype=torch.int16, device=p.device)
        if self.use_master_weights or self.store_param_remainders:
            return _param_value_f32(p).to(torch.float32, copy=True)
        return None

    def init(self, params) -> AdamState:
        """Zero moments in their storage dtypes, the masters, step 0."""
        params = _named(params)
        mu, nu, master = {}, {}, {}
        for n, p in params.items():
            p = p.detach() if isinstance(p, torch.Tensor) else p
            for moments, dtype in ((mu, self.exp_avg_dtype),
                                   (nu, self.exp_avg_sq_dtype)):
                moments[n] = _enc_state(torch.zeros(
                    _shape_of(p), dtype=torch.float32,
                    device=_device_of(p)), dtype)
            master[n] = self._master_for(p)
        dev = _device_of(next(iter(params.values()))) if params else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         mu, nu, master)

    def _adam_math(self, step_f, g, m, v, ref):
        gf = g.float()
        b1c = 1.0 - self.beta1 ** step_f
        b2c = 1.0 - self.beta2 ** step_f
        if self.weight_decay and not self.adam_w_mode:   # classic L2
            gf = gf + self.weight_decay * ref
        m2 = self.beta1 * m + (1 - self.beta1) * gf
        v2 = self.beta2 * v + (1 - self.beta2) * gf * gf
        u = (m2 / b1c) / (_sqrt(v2 / b2c) + self.eps)
        if self.weight_decay and self.adam_w_mode:
            u = u + self.weight_decay * ref
        return m2, v2, ref - self.learning_rate * u

    def _leaf(self, step_f, p, g, m, v, w):
        """(new param, new mu, new nu, new master) of one leaf."""
        remainder = isinstance(w, torch.Tensor) and w.dtype == torch.int16
        if remainder:
            ref = _combine_master(p, w)
        elif w is not None:
            ref = w
        else:
            ref = _param_value_f32(p)
        m2, v2, master2 = self._adam_math(
            step_f, g, _dec_state(m, self.exp_avg_dtype),
            _dec_state(v, self.exp_avg_sq_dtype), ref)
        m2 = _enc_state(m2, self.exp_avg_dtype)
        v2 = _enc_state(v2, self.exp_avg_sq_dtype)
        if remainder:
            p2, rem2 = _split_master(master2)
            return p2, m2, v2, rem2
        return (_requantize_param(p, master2), m2, v2,
                master2 if w is not None else None)

    @staticmethod
    def _check_trees(grads, state: AdamState, params: dict) -> None:
        if params is None:
            raise ValueError("fused_adam needs params")
        sizes = [len(params), len(grads), len(state.mu), len(state.nu),
                 len(state.master)]
        names = set(params)
        if len(set(sizes)) != 1 or any(
                set(t) != names for t in (grads, state.mu, state.nu,
                                          state.master)):
            raise ValueError(
                "grads/state trees do not match the params tree "
                f"({sizes[0]} params vs {sizes[1]} grads, {sizes[2]}/"
                f"{sizes[3]}/{sizes[4]} state leaves)")

    @staticmethod
    def _next_step(state: AdamState):
        """(the new step count, it in f32)."""
        step = state.step + 1
        return step, step.to(torch.float32)

    def _run(self, grads, state: AdamState, params: dict):
        self._check_trees(grads, state, params)
        step, step_f = self._next_step(state)
        new_p, new_m, new_v, new_w = {}, {}, {}, {}
        for n, p in params.items():
            new_p[n], new_m[n], new_v[n], new_w[n] = self._leaf(
                step_f, p, grads[n], state.mu[n], state.nu[n],
                state.master[n])
        return new_p, AdamState(step, new_m, new_v, new_w)

    def step(self, grads, state: AdamState, params):
        """(new params, new state): the step written in each leaf's own
        storage (exact for remainder masters and fp8 leaves)."""
        return self._run(_named(grads), state, _named(params))

    def update(self, grads, state: AdamState, params=None):
        """(updates, new state) as an optax transformation: the new params
        minus the old ones in their dtype. Without ``params`` (no masters,
        no weight decay) the updates are the raw Adam deltas in the
        gradients' dtype and the masters stay as they were. Remainder
        masters and fp8 leaves need :meth:`step`."""
        if self.store_param_remainders:
            raise ValueError(
                "store_param_remainders needs the exact-apply path: use "
                ".step(grads, state, params) -> (new_params, new_state)")
        grads = _named(grads)
        if params is not None:
            params = _named(params)
            if any(_is_quantized(p) for p in params.values()):
                raise ValueError(
                    "quantized param leaves need .step(grads, state, "
                    "params)")
            new_params, st = self._run(grads, state, params)
            return {n: new_params[n] - params[n] for n in params}, st
        if self.use_master_weights or self.weight_decay:
            raise ValueError("update without params takes neither master "
                             "weights nor weight decay")
        step, step_f = self._next_step(state)
        out_u, out_m, out_v = {}, {}, {}
        for n, g in grads.items():
            zero = torch.zeros((), dtype=torch.float32, device=g.device)
            m2, v2, delta = self._adam_math(
                step_f, g, _dec_state(state.mu[n], self.exp_avg_dtype),
                _dec_state(state.nu[n], self.exp_avg_sq_dtype), zero)
            out_u[n] = delta.to(g.dtype)
            out_m[n] = _enc_state(m2, self.exp_avg_dtype)
            out_v[n] = _enc_state(v2, self.exp_avg_sq_dtype)
        return out_u, AdamState(step, out_m, out_v, state.master)

    @torch.no_grad()
    def apply(self, model, state: AdamState, grads=None) -> AdamState:
        """The step of :meth:`step` written in place: into the parameters
        of ``model`` (a module, or (name, parameter) pairs such as its
        ``named_parameters()``) with ``copy_``, and into ``state``, leaf
        by leaf, so one leaf's new state exists beside the old at a time.
        ``grads`` ({name: gradient}) defaults to each parameter's
        ``.grad``. Returns ``state``."""
        params = _named(model)
        grads = _named(grads) if grads is not None else {
            n: p.grad for n, p in params.items()}
        self._check_trees(grads, state, params)
        step, step_f = self._next_step(state)
        for n, p in params.items():
            p2, state.mu[n], state.nu[n], state.master[n] = self._leaf(
                step_f, p.detach(), grads[n], state.mu[n], state.nu[n],
                state.master[n])
            p.copy_(p2)
        state.step = step
        return state


def fused_adam(learning_rate: float = 1e-3, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, *,
               use_master_weights: bool = False, adam_w_mode: bool = True,
               store_param_remainders: bool = False,
               exp_avg_dtype: torch.dtype = torch.float32,
               exp_avg_sq_dtype: torch.dtype = torch.float32) -> FusedAdam:
    """Adam/AdamW with the reference's storage forms: plain params,
    ``use_master_weights`` (f32 masters), ``store_param_remainders``
    (int16 remainders of bf16 leaves), fp8 ``ScaledTensor1x`` leaves
    quantized anew from their f32 masters after each step, and moments
    stored in f32, bf16/f16 (casts) or fp8 (:class:`ScaledState`). The
    state lives on the params' device."""
    return FusedAdam(learning_rate, beta1, beta2, eps, weight_decay,
                     use_master_weights, adam_w_mode, store_param_remainders,
                     exp_avg_dtype, exp_avg_sq_dtype)


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params=None)
    -> (updates, state)``, as optax's."""
    init: Callable
    update: Callable


def apply_updates(params: Mapping, updates: Mapping) -> dict:
    """``params + updates`` leaf by leaf, in each param's dtype (as
    ``optax.apply_updates``)."""
    return {n: (p + updates[n]).to(p.dtype) for n, p in params.items()}


def _like(value: float, t: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``t``'s dtype and device, as JAX's weak typing
    converts it before the op."""
    return torch.as_tensor(value, dtype=t.dtype, device=t.device)


def fused_sgd(learning_rate: float = 1e-3, momentum: float = 0.0,
              weight_decay: float = 0.0,
              nesterov: bool = False) -> GradientTransformation:
    """SGD as the reference's optax chain: ``g + weight_decay * p``, then
    the trace ``t = g + momentum * t`` (Nesterov: ``g + momentum * t``
    of the new trace), then ``-learning_rate * g``. The state is the
    trace ({name: tensor in the param's dtype}; empty without
    momentum)."""

    def init(params):
        if not momentum:
            return {}
        return {n: torch.zeros_like(p) for n, p in _named(params).items()}

    def update(grads, state, params=None):
        u = _named(grads)
        if weight_decay:
            if params is None:
                raise ValueError("fused_sgd's weight decay needs params")
            params = _named(params)
            u = {n: g + _like(weight_decay, g) * params[n]
                 for n, g in u.items()}
        if momentum:
            trace = {n: g + _like(momentum, state[n]) * state[n]
                     for n, g in u.items()}
            u = ({n: g + _like(momentum, trace[n]) * trace[n]
                  for n, g in u.items()} if nesterov else trace)
            state = trace
        return {n: _like(-learning_rate, g) * g for n, g in u.items()}, state

    return GradientTransformation(init, update)


_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(g: torch.Tensor, steps: int = 5,
                  coeffs: Tuple[float, float, float] = _NS_COEFFS,
                  eps: float = 1e-7) -> torch.Tensor:
    """The quintic Newton-Schulz iteration orthogonalizing ``g`` (Muon):
    bf16 products with an f32 Frobenius norm; a matrix with more rows
    than columns is iterated transposed."""
    a, b, c = coeffs
    transpose = g.shape[-2] > g.shape[-1]
    x = g.to(torch.bfloat16)
    if transpose:
        x = x.transpose(-1, -2)
    norm = torch.linalg.vector_norm(x.float(), dim=(-2, -1), keepdim=True)
    x = x / (norm + eps).to(torch.bfloat16)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        bxx = _like(b, xxt) * xxt + _like(c, xxt) * (xxt @ xxt)
        x = _like(a, x) * x + bxx @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x.to(g.dtype)


def muon(learning_rate: float = 0.02, momentum: float = 0.95,
         ns_steps: int = 5, nesterov: bool = True) -> GradientTransformation:
    """Muon: f32 momentum, then the Newton-Schulz orthogonalized update,
    times sqrt(max(1, rows / cols)), for 2-D leaves; other leaves take
    the momentum update as it is (the caller masks them to another
    optimizer)."""

    def init(params):
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in _named(params).items()}

    def orth(u):
        if u.dim() != 2:
            return u
        factor = torch.sqrt(torch.tensor(max(1.0, u.shape[-2] / u.shape[-1]),
                                         dtype=torch.float32))
        return newton_schulz(u, ns_steps) * factor.to(u.device)

    def update(grads, state, params=None):
        grads = _named(grads)
        new_state = {n: momentum * state[n] + g.float()
                     for n, g in grads.items()}
        eff = ({n: g.float() + momentum * new_state[n]
                for n, g in grads.items()} if nesterov else new_state)
        return ({n: -learning_rate * orth(u) for n, u in eff.items()},
                new_state)

    return GradientTransformation(init, update)
