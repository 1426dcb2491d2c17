"""GPT-OSS-class sparse-MoE causal LM (counterpart of
transformerengine_tpu/models/gptoss.py): top-k routed experts with the
clamped SwiGLU gate (limit 7, alpha 1.702), biased QKV and output
projections, a learnable per-head attention sink in every layer, and
alternating banded attention (even layers see a 128-token sliding
window, odd layers the full causal context), with tied input/output
embeddings.

The model has :class:`~.mixtral.MixtralModel`'s interface (``layers``,
``embedding``, ``forward(tokens, sequence_descriptor, kv_caches=...,
return_aux_loss=...)``), so the inference engine serves it through the
contiguous cache: the prefill's flash attention and the decode kernel
take each layer's window and sink. The paged cache refuses a windowed
layer (``nn/transformer.py``). ``remat`` and ``remat_policy`` act as
Llama's. Not ported yet: expert parallelism (``ep_axis``) and the
capacity path (``dropless=False``)."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from ..attention import AttnMaskType, SequenceDescriptor, SoftmaxType
from ..checkpoint_policies import remat_policy
from ..device import resolve_device
from ..nn.module import LayerNorm
from ..nn.transformer import TransformerLayer
from . import llama
from .llama import cross_entropy_loss, run_layer, tied_logits
from .mixtral import collect_aux_loss


@dataclasses.dataclass(frozen=True)
class GptOssConfig:
    vocab_size: int = 201088
    hidden_size: int = 2880
    head_dim: int = 64
    num_attention_heads: int = 64
    num_kv_heads: int = 8
    num_layers: int = 24
    num_experts: int = 32
    topk: int = 4
    intermediate_size: int = 2880        # per-expert FFN width
    sliding_window: int = 128            # even layers; odd layers full
    use_bias: bool = True
    aux_loss_coeff: float = 0.0          # router trained loss-free
    max_seq_len: int = 4096
    rope_base: float = 150000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "nothing_saveable"


GPTOSS_TINY = GptOssConfig(
    vocab_size=256, hidden_size=128, head_dim=32, num_attention_heads=4,
    num_kv_heads=2, num_layers=2, num_experts=4, topk=2,
    intermediate_size=128, sliding_window=32, max_seq_len=256,
    rope_base=10000.0)
GPTOSS_20B = GptOssConfig()
GPTOSS_120B = GptOssConfig(num_layers=36, num_experts=128,
                           hidden_size=2880)


def layer_window(config: GptOssConfig, i: int) -> Optional[Tuple[int, int]]:
    """Layer ``i``'s window: the band on even layers, none on odd ones."""
    return (config.sliding_window, 0) if i % 2 == 0 else None


class GptOssModel(nn.Module):
    """Decoder-only MoE transformer with attention sinks and alternating
    banded and full attention. The weights are drawn on ``device`` from a
    generator seeded with ``seed`` (the embedding at stddev 1, sinks and
    biases at zero, as the reference initializes them);
    :func:`load_flax_params` gives the state of a reference model
    instead."""

    def __init__(self, config: GptOssConfig, *, device="cuda",
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
                mlp_activations="clamped_swiglu", use_bias=cfg.use_bias,
                self_attn_mask_type=AttnMaskType.CAUSAL,
                enable_rotary_pos_emb=True,
                window_size=layer_window(cfg, i),
                softmax_type=SoftmaxType.LEARNABLE,
                rotary_pos_emb_base=cfg.rope_base,
                max_seq_len=cfg.max_seq_len,
                num_moe_experts=cfg.num_experts, moe_topk=cfg.topk,
                moe_aux_loss_coeff=cfg.aux_loss_coeff, dtype=cfg.dtype,
                device=dev, generator=gen)
            for i in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                    norm_type="rmsnorm",
                                    device=dev)
        self.remat = remat_policy(cfg.remat_policy) if cfg.remat else None

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def forward(self, tokens: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None, *,
                kv_caches=None, return_aux_loss: bool = False):
        """(B, S) int tokens -> (B, S, vocab) f32 logits, and with
        ``return_aux_loss`` the summed router aux loss beside them (zero
        at the default ``aux_loss_coeff``). Attention and caches as in
        :meth:`~.llama.LlamaModel.forward`, remat as its ``config.remat``
        says."""
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


def gptoss_loss(model: GptOssModel, tokens: torch.Tensor,
                targets: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token cross entropy plus the summed router aux loss."""
    logits, aux = model(tokens, return_aux_loss=True)
    return cross_entropy_loss(logits, targets, mask) + aux


def load_flax_params(params_np: Mapping, config: GptOssConfig,
                     device="cuda") -> dict:
    """The reference GPT-OSS model's ``variables["params"]`` (nested dicts
    of numpy arrays, boxes removed) as a :class:`GptOssModel`
    ``state_dict`` on ``device``: ``layer_{i}`` becomes ``layers.{i}``,
    kernels and biases take ``config.dtype``, and norm scales, router
    kernels and the sinks (``softmax_offset``) stay f32."""
    return llama.load_flax_params(params_np, config, device)
