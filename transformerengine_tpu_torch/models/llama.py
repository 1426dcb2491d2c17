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
                sequence_descriptor: Optional[SequenceDescriptor] = None, *,
                kv_caches: Optional[Sequence[KVCache]] = None
                ) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) f32 logits. Attention is
        causal, and padding-causal when ``sequence_descriptor`` gives the
        lengths. With ``kv_caches`` (one per layer) the call prefills or
        decodes through them, updating them in place."""
        x = self.embedding[tokens]
        for i, layer in enumerate(self.layers):
            x = layer(x, sequence_descriptor,
                      kv_cache=kv_caches[i] if kv_caches is not None else None)
        x = self.final_norm(x)
        b, s, h = x.shape
        x2d = x.reshape(b * s, h)
        if needs_grad(x2d, self.embedding):
            logits = _Logits.apply(x2d, self.embedding)
        else:
            logits = matmul_f32(x2d, self.embedding.t())
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


def load_flax_params(params_np: Mapping, config: LlamaConfig,
                     device="cuda",
                     quantize_meta: Optional[Mapping] = None) -> dict:
    """Maps the reference model's ``variables["params"]`` (nested dicts of
    numpy arrays, boxes removed) to a :class:`LlamaModel` ``state_dict`` on
    ``device``: ``layer_{i}`` becomes ``layers.{i}``, kernels take
    ``config.dtype`` and norm scales stay f32. ``quantize_meta``, the
    reference's collection of the same name, adds the delayed-scaling
    state (``{gemm}_{role}_scale`` and ``_amax_history``, f32) under the
    same keys; ``load_state_dict`` creates those buffers."""
    dev = resolve_device(device)
    state = {}

    def walk(tree, prefix, param_dtype):
        for name, sub in tree.items():
            key = f"layers.{name[len('layer_'):]}" if name.startswith(
                "layer_") else name
            key = f"{prefix}{key}"
            if isinstance(sub, Mapping):
                walk(sub, key + ".", param_dtype)
                continue
            dtype = param_dtype if param_dtype is not None else (
                torch.float32 if name == "scale" else config.dtype)
            arr = np.array(sub, dtype=np.float32)
            state[key] = torch.from_numpy(arr).to(device=dev, dtype=dtype)

    walk(params_np, "", None)
    if quantize_meta is not None:
        walk(quantize_meta, "", torch.float32)
    return state
