"""Generation engine: prefill, then a decode loop over the KV cache
(counterpart of transformerengine_tpu/inference/engine.py). The
reference's ``lax.scan`` over decode steps is a Python loop here, and its
functional cache collection is a list of per-layer
:class:`~.kv_cache.KVCache` objects that the model updates in place.
Greedy decoding is exact; temperature, top-k and top-p sampling draw
from an explicit ``torch.Generator``."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..attention import SequenceDescriptor
from ..device import check_on, resolve_device
from .kv_cache import InferenceParams, KVCache


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float = 0.0, top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: argmax when ``temperature`` is
    0, else a draw from the tempered distribution cut to the ``top_k``
    largest logits (when > 0) and to the ``top_p`` nucleus (when < 1)."""
    if float(temperature) == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / max(float(temperature), 1e-6)
    vocab = x.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    if top_k > 0 or top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
    if top_k > 0:
        kth = sorted_x[..., min(top_k, vocab) - 1:min(top_k, vocab)]
        x = torch.where(x < kth, neg_inf, x)
        sorted_x = torch.where(
            torch.arange(vocab, device=x.device) < top_k, sorted_x, neg_inf)
    if top_p < 1.0:
        probs = torch.softmax(sorted_x, dim=-1)
        inside = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(inside, sorted_x, -neg_inf).amin(
            dim=-1, keepdim=True)
        x = torch.where(x < cutoff, neg_inf, x)
    draw = torch.multinomial(torch.softmax(x, dim=-1), 1, generator=generator)
    return draw[:, 0].to(torch.int32)


def _generator(generator, temperature, dev):
    if generator is None and float(temperature) != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    return generator


@torch.no_grad()
def prefill(model, tokens: torch.Tensor, inference_params: InferenceParams,
            prompt_lengths: torch.Tensor, *, temperature: float = 0.0,
            top_k: int = 0, top_p: float = 1.0,
            generator: Optional[torch.Generator] = None, device="cuda"
            ) -> Tuple[torch.Tensor, List[KVCache]]:
    """Runs the right-padded prompts (B, S) through ``model``, filling new
    caches. Returns (first sampled token (B,), per-layer caches).

    The caches' lengths advance by the padded width and are then rewound
    by each prompt's padding, so decode writes right after the last real
    token (over the padded slots)."""
    dev = resolve_device(device)
    check_on(dev, model=model.embedding)
    tokens = tokens.to(dev)
    lengths = prompt_lengths.to(device=dev, dtype=torch.int32)
    caches = [KVCache.allocate(inference_params,
                               layer.self_attention.num_kv_heads,
                               layer.self_attention.head_dim, dev)
              for layer in model.layers]
    logits = model(tokens, SequenceDescriptor.from_seqlens(lengths),
                   kv_caches=caches)
    pad = tokens.shape[1] - lengths
    for cache in caches:
        cache.length -= pad
    last = logits[torch.arange(tokens.shape[0], device=dev),
                  (lengths - 1).long()]
    tok = _sample(last, _generator(generator, temperature, dev), temperature,
                  top_k, top_p)
    return tok, caches


@torch.no_grad()
def decode_steps(model, kv_caches: List[KVCache], first_token: torch.Tensor,
                 num_steps: int, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None, device="cuda"
                 ) -> torch.Tensor:
    """Decodes ``num_steps`` tokens after ``first_token`` (B,), one model
    call per step, updating ``kv_caches`` in place. Returns (B,
    num_steps) int32."""
    dev = resolve_device(device)
    check_on(dev, model=model.embedding)
    generator = _generator(generator, temperature, dev)
    tok = first_token.to(device=dev, dtype=torch.int32)
    out = []
    for _ in range(num_steps):
        logits = model(tok[:, None], kv_caches=kv_caches)
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    if not out:
        return torch.empty((tok.shape[0], 0), dtype=torch.int32, device=dev)
    return torch.stack(out, dim=1)


def generate(model, prompt_tokens: torch.Tensor,
             prompt_lengths: torch.Tensor, max_new_tokens: int, *,
             inference_params: Optional[InferenceParams] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             kv_cache_dtype: torch.dtype = torch.bfloat16,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> torch.Tensor:
    """End-to-end generation from right-padded prompts (B, S_prompt) and
    their lengths (B,). Returns (B, max_new_tokens) int32."""
    dev = resolve_device(device)
    b, sp = prompt_tokens.shape
    if inference_params is None:
        inference_params = InferenceParams(
            max_batch_size=b, max_sequence_length=sp + max_new_tokens,
            kv_cache_dtype=kv_cache_dtype)
    generator = _generator(generator, temperature, dev)
    first, caches = prefill(model, prompt_tokens, inference_params,
                            prompt_lengths, temperature=temperature,
                            top_k=top_k, top_p=top_p, generator=generator,
                            device=dev)
    toks = decode_steps(model, caches, first, max_new_tokens - 1,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator, device=dev)
    return torch.cat([first[:, None], toks], dim=1)
