"""Llama-class causal LM (counterpart of transformerengine_tpu/models/
llama.py): RMSNorm + SwiGLU LayerNormMLP + GQA attention + RoPE, with
tied input/output embeddings, and its token-level cross-entropy loss.

A training step is the model's forward (no caches), ``cross_entropy_loss``
and ``loss.backward()``; under ``autocast`` with ``DelayedScaling`` the
backward also rolls every GEMM's quantizer state in the modules' buffers
(the reference's ``quantize_meta`` collection)."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..attention import SequenceDescriptor
from ..dense import needs_grad
from ..device import resolve_device
from ..inference.kv_cache import KVCache
from ..nn.module import LayerNorm
from ..nn.transformer import TransformerLayer
from ..ops.gemm import matmul_f32
from ..quantize.prequant import BlockResidentKernel, PrequantizedKernel


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16


LLAMA_TINY = LlamaConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_layers=2,
                         num_attention_heads=4, num_kv_heads=2,
                         max_seq_len=512, rope_base=10000.0)
LLAMA_8B = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32,
                       num_attention_heads=32, num_kv_heads=8)


class LlamaModel(nn.Module):
    """Decoder-only transformer LM. The weights are drawn on ``device``
    from a generator seeded with ``seed``; :func:`load_flax_params`
    gives the state of a reference model instead."""

    def __init__(self, config: LlamaConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedding = nn.Parameter(
            torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                        device=dev).to(cfg.dtype))
        self.layers = nn.ModuleList(
            TransformerLayer(
                cfg.hidden_size, cfg.intermediate_size,
                cfg.num_attention_heads, head_dim=cfg.head_dim,
                num_gqa_groups=cfg.num_kv_heads,
                layernorm_epsilon=cfg.norm_eps, mlp_activations="swiglu",
                rotary_pos_emb_base=cfg.rope_base,
                max_seq_len=cfg.max_seq_len, dtype=cfg.dtype, device=dev,
                generator=gen)
            for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                    device=dev)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def forward(self, tokens: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                kv_caches: Optional[Sequence[KVCache]] = None
                ) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) f32 logits. Attention is
        causal, and padding-causal when ``sequence_descriptor`` gives the
        lengths or, for a packed batch, the segment ids
        (:meth:`SequenceDescriptor.from_segment_ids_and_pos`);
        ``positions`` (B, S) are the tokens' RoPE positions (a packed
        batch's positions within each document). With ``kv_caches`` (one
        per layer) the call prefills or decodes through them, updating
        them in place."""
        x = self.embedding[tokens]
        for i, layer in enumerate(self.layers):
            x = layer(x, sequence_descriptor, positions,
                      kv_cache=kv_caches[i] if kv_caches is not None else None)
        return tied_logits(self.final_norm(x), self.embedding)


def tied_logits(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """(B, S, H) activations -> (B, S, vocab) f32 logits against the tied
    embedding."""
    b, s, h = x.shape
    x2d = x.reshape(b * s, h)
    if needs_grad(x2d, embedding):
        logits = _Logits.apply(x2d, embedding)
    else:
        logits = matmul_f32(x2d, embedding.t())
    return logits.reshape(b, s, -1)


class _Logits(torch.autograd.Function):
    """f32 logits ``x . embedding^T`` from the activations' dtype: bf16
    operands with f32 accumulation, without an f32 copy of the embedding
    in the forward. The backward takes the f32 logits' gradient against
    the widened operands (f32 products, as the reference's transposed dot
    with an f32 preferred type) and rounds the results to the operands'
    dtypes."""

    @staticmethod
    def forward(ctx, x2d, embedding):
        ctx.save_for_backward(x2d, embedding)
        return matmul_f32(x2d, embedding.t())

    @staticmethod
    def backward(ctx, g):
        x2d, embedding = ctx.saved_tensors
        g = g.float()
        dx = (g @ embedding.float()).to(x2d.dtype) \
            if ctx.needs_input_grad[0] else None
        demb = (g.t() @ x2d.float()).to(embedding.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, demb


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level cross entropy of (B, S, V) logits against (B, S)
    targets, in f32; with ``mask`` the mean over the valid tokens."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    return -ll.mean()


# Parameters kept in f32 whatever the model's dtype: norm scales, a MoE
# layer's router kernel and an attention's learnable sink.
F32_PARAMS = ("scale", "router_kernel", "softmax_offset")

_FP8_NUMPY = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}


def _bytes(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array's bytes as a tensor of a one-byte ``dtype``."""
    raw = np.ascontiguousarray(np.asarray(arr)).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(dtype).to(device)


def _resident_module(leaf, config: LlamaConfig, device) -> PrequantizedKernel:
    """The port's module for one ``PrequantizedKernel`` leaf of the
    reference's ``prequant`` collection (its arrays as numpy), with the
    same payload bytes: a ``BlockResidentKernel`` colwise, a per-tensor
    ``ScaledTensor1x`` one, or a plain (N, K) array."""
    cw, shape = leaf.colwise, tuple(leaf.logical_shape)
    if hasattr(cw, "payload"):
        payload = _bytes(cw.payload, torch.uint8 if cw.packed
                         else torch.float8_e4m3fn, device)
        scale = torch.from_numpy(np.asarray(cw.scale, np.float32)).to(
            device=device, dtype=torch.bfloat16)
        out_scale = None if cw.out_scale is None else torch.from_numpy(
            np.asarray(cw.out_scale, np.float32).reshape(1)).to(device)
        kn = BlockResidentKernel(payload, scale, out_scale, int(cw.block),
                                 bool(cw.packed))
        return PrequantizedKernel(None, None, shape, config.dtype, kn=kn)
    if hasattr(cw, "scale_inv"):
        data = _bytes(cw.data, _FP8_NUMPY[np.asarray(cw.data).dtype.name],
                      device)
        scale_inv = torch.from_numpy(
            np.asarray(cw.scale_inv, np.float32).reshape(1)).to(device)
        return PrequantizedKernel(data, scale_inv, shape, config.dtype)
    data = torch.from_numpy(np.array(cw, dtype=np.float32)).to(
        device=device, dtype=config.dtype)
    return PrequantizedKernel(data, None, shape, config.dtype)


def load_flax_params(params_np: Mapping, config: LlamaConfig,
                     device="cuda",
                     quantize_meta: Optional[Mapping] = None,
                     prequant: Optional[Mapping] = None) -> dict:
    """Maps the reference model's ``variables["params"]`` (nested dicts of
    numpy arrays, boxes removed) to a :class:`LlamaModel` ``state_dict`` on
    ``device``: ``layer_{i}`` becomes ``layers.{i}``, kernels take
    ``config.dtype``, and norm scales and router kernels stay f32
    (``F32_PARAMS``). ``quantize_meta``, the
    reference's collection of the same name, adds the delayed-scaling
    state (``{gemm}_{role}_scale`` and ``_amax_history``, f32) under the
    same keys; ``load_state_dict`` creates those buffers. ``prequant``, the
    reference's collection of resident kernels (its ``PrequantizedKernel``
    leaves with numpy arrays), adds under each kernel's key the port's
    :class:`PrequantizedKernel` module with the same payload bytes;
    :func:`load_flax_state` installs such a state."""
    dev = resolve_device(device)
    state = {}

    def walk(tree, prefix, param_dtype):
        for name, sub in tree.items():
            key = f"layers.{name[len('layer_'):]}" if name.startswith(
                "layer_") else name
            key = f"{prefix}{key}"
            if isinstance(sub, Mapping):
                walk(sub, key + ".", param_dtype)
            elif param_dtype == "prequant":
                state[key] = _resident_module(sub, config, dev)
            else:
                dtype = param_dtype if param_dtype is not None else (
                    torch.float32 if name in F32_PARAMS else config.dtype)
                arr = np.array(sub, dtype=np.float32)
                state[key] = torch.from_numpy(arr).to(device=dev, dtype=dtype)

    walk(params_np, "", None)
    if quantize_meta is not None:
        walk(quantize_meta, "", torch.float32)
    if prequant is not None:
        walk(prequant, "", "prequant")
    return state


def load_flax_state(model: nn.Module, state: Mapping) -> nn.Module:
    """Loads a :func:`load_flax_params` state into ``model``, in place:
    each resident module replaces the kernel parameter it is keyed by,
    and the tensors load as ``load_state_dict`` loads them. Returns
    ``model``."""
    tensors, resident = {}, set()
    for key, value in state.items():
        if not isinstance(value, nn.Module):
            tensors[key] = value
            continue
        owner, name = key.rsplit(".", 1)
        module = model.get_submodule(owner)
        delattr(module, name)
        setattr(module, name, value)
        resident |= {f"{key}.{b}" for b, _ in value.named_buffers()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    if set(missing) - resident or unexpected:
        raise KeyError(f"state does not fit the model: missing "
                       f"{sorted(set(missing) - resident)}, unexpected "
                       f"{unexpected}")
    return model
