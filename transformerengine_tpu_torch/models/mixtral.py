"""Mixtral-class sparse-MoE causal LM (counterpart of
transformerengine_tpu/models/mixtral.py): RMSNorm, GQA attention with
RoPE, and a top-k routed ``MoELayerNormMLP`` in every layer, with tied
input/output embeddings. ``mixtral_loss`` adds the layers' summed router
aux losses to the token cross entropy.

The model has :class:`~.llama.LlamaModel`'s interface (``layers``,
``embedding``, ``forward(tokens, sequence_descriptor, kv_caches=...)``),
so the inference engine serves it as it serves Llama, and its
``remat``, ``remat_policy`` and ``scan_layers`` act as Llama's. Not
ported yet: expert parallelism."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from ..attention import AttnMaskType, SequenceDescriptor
from ..checkpoint_policies import remat_policy
from ..device import resolve_device
from ..inference.kv_cache import KVCache
from ..nn.module import LayerNorm
from ..nn.transformer import TransformerLayer
from . import llama
from .llama import (cross_entropy_loss, load_flax_opt_state, run_layer,
                    tied_logits)


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336   # per-expert FFN width
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    num_experts: int = 8
    topk: int = 2
    aux_loss_coeff: float = 1e-2
    max_seq_len: int = 8192
    rope_base: float = 1e6
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = False


MIXTRAL_TINY = MixtralConfig(vocab_size=256, hidden_size=128,
                             intermediate_size=256, num_layers=2,
                             num_attention_heads=4, num_kv_heads=2,
                             num_experts=4, topk=2, max_seq_len=512,
                             rope_base=10000.0)
MIXTRAL_8X7B = MixtralConfig()


class MixtralModel(nn.Module):
    """Decoder-only sparse-MoE transformer LM. The weights are drawn on
    ``device`` from a generator seeded with ``seed`` (the embedding at
    stddev 1, as the reference draws it); :func:`load_flax_params` gives
    the state of a reference model instead."""

    def __init__(self, config: MixtralConfig, *, device="cuda",
                 seed: int = 0):
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
                layernorm_epsilon=cfg.norm_eps, norm_type="rmsnorm",
                mlp_activations="swiglu",
                self_attn_mask_type=AttnMaskType.CAUSAL,
                enable_rotary_pos_emb=True,
                rotary_pos_emb_base=cfg.rope_base,
                max_seq_len=cfg.max_seq_len,
                num_moe_experts=cfg.num_experts, moe_topk=cfg.topk,
                moe_aux_loss_coeff=cfg.aux_loss_coeff, dtype=cfg.dtype,
                device=dev, generator=gen)
            for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                    norm_type="rmsnorm",
                                    device=dev)
        self.remat = remat_policy(cfg.remat_policy) if cfg.remat else None

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def forward(self, tokens: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None, *,
                kv_caches: Optional[Sequence[KVCache]] = None,
                return_aux_loss: bool = False):
        """(B, S) int tokens -> (B, S, vocab) f32 logits, and with
        ``return_aux_loss`` the summed router aux loss beside them.
        Attention and caches as in :meth:`LlamaModel.forward`."""
        x = self.embedding[tokens]
        aux_losses = []
        for i, layer in enumerate(self.layers):
            x, aux = run_layer(self.remat, layer, x, sequence_descriptor,
                               None, kv_caches[i] if kv_caches is not None
                               else None)
            aux_losses.append(aux)
        logits = tied_logits(self.final_norm(x), self.embedding)
        if return_aux_loss:
            return logits, collect_aux_loss(aux_losses)
        return logits


def collect_aux_loss(aux_losses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the layers' aux losses, in layer order, from an f32
    zero."""
    total = torch.zeros((), dtype=torch.float32, device=(
        aux_losses[0].device if aux_losses else None))
    for aux in aux_losses:
        total = total + aux.sum()
    return total


def mixtral_loss(model: MixtralModel, tokens: torch.Tensor,
                 targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token cross entropy plus the summed router aux loss."""
    logits, aux = model(tokens, return_aux_loss=True)
    return cross_entropy_loss(logits, targets, mask) + aux


def load_flax_params(params_np: Mapping, config: MixtralConfig,
                     device="cuda",
                     quantize_meta: Optional[Mapping] = None) -> dict:
    """The reference Mixtral's ``variables["params"]`` (nested dicts of
    numpy arrays, boxes removed) as a :class:`MixtralModel`
    ``state_dict`` on ``device``: ``layer_{i}`` becomes ``layers.{i}``,
    the expert kernels take ``config.dtype``, and norm scales and router
    kernels stay f32; ``quantize_meta`` adds the delayed-scaling state,
    and a ``scan_layers`` model's stacked trees are split, as
    :func:`.llama.load_flax_params` does (:func:`.llama.load_flax_opt_state`
    takes its ``fused_adam`` state)."""
    return llama.load_flax_params(params_np, config, device,
                                  quantize_meta=quantize_meta)
