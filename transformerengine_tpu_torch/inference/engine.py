"""Generation engine: prefill, then decode steps over the KV cache
(counterpart of transformerengine_tpu/inference/engine.py). The
reference's functional cache collection is a list of per-layer caches
that the model updates in place: :class:`~.kv_cache.KVCache`, or
:class:`~.kv_cache.PagedKVCache` when ``InferenceParams.is_paged``.

The reference decodes as one compiled ``lax.scan``. Here, on the card,
one decode step (the model call on a (B, 1) static token buffer, then
the draw) is captured as a CUDA graph and replayed a step: the first
step on new caches runs eagerly (it warms every kernel and advances the
cache), the capture follows, and replays do the remaining steps and
every later call on the same caches. The graphs live on the caches
(:class:`CacheList`), one for each model and sampling structure, each
with the generator it draws from (another generator captures anew in
its place), and are freed with them. On CPU tensors the same code runs
every step eagerly.

Greedy decoding is exact. Temperature, top-k and top-p sampling draw
from an explicit ``torch.Generator`` (by default one seeded 0 that the
caches keep) as ``torch.multinomial`` does for one sample: the argmax of
the probabilities over exponential draws, which a graph can capture. As
in the reference, the sampling values are device tensors and only the
structure (greedy, top-k on or off, top-p on or off) is static."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..attention import SequenceDescriptor
from ..device import check_on, resolve_device
from ..graph import CapturedStep
from .kv_cache import InferenceParams, KVCache, PagedKVCache, check_pages


def _sample_mode(temperature, top_k, top_p) -> Tuple[bool, bool, bool]:
    """The static sampling structure: (greedy, top-k on, top-p on)."""
    return (float(temperature) == 0.0, int(top_k) > 0, float(top_p) < 1.0)


def _sampling_tensors(temperature, top_k, top_p, dev):
    """(temperature, top_k, top_p) as 0-d f32, int64 and f32 tensors."""
    return (torch.full((), float(temperature), dtype=torch.float32,
                       device=dev),
            torch.full((), int(top_k), dtype=torch.int64, device=dev),
            torch.full((), float(top_p), dtype=torch.float32, device=dev))


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature=0.0, top_k=0, top_p=1.0,
            mode: Optional[Tuple[bool, bool, bool]] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: argmax when greedy, else a draw
    from the tempered distribution cut to the ``top_k`` largest logits
    (when on) and to the ``top_p`` nucleus (when on). The values are
    numbers or 0-d tensors on the logits' device; ``mode`` is the static
    structure, by default that of numbers."""
    greedy, use_top_k, use_top_p = mode or _sample_mode(temperature, top_k,
                                                        top_p)
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if not isinstance(temperature, torch.Tensor):
        temperature, top_k, top_p = _sampling_tensors(
            temperature, top_k, top_p, logits.device)
    x = logits.float() / temperature.clamp_min(1e-6)
    vocab = x.shape[-1]
    if use_top_k or use_top_p:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
    if use_top_k:
        idx = (top_k - 1).clamp(0, vocab - 1).expand(x.shape[0], 1)
        kth = sorted_x.gather(-1, idx)
        x = torch.where(x < kth, float("-inf"), x)
        sorted_x = torch.where(
            torch.arange(vocab, device=x.device) < top_k, sorted_x,
            float("-inf"))
    if use_top_p:
        probs = torch.softmax(sorted_x, dim=-1)
        inside = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(inside, sorted_x, float("inf")).amin(
            dim=-1, keepdim=True)
        x = torch.where(x < cutoff, float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def _generator(generator, temperature, dev, caches):
    """The generator to draw from: the caller's; else, when sampling, the
    one that ``caches`` (a :class:`CacheList`) keep, seeded 0 when made;
    None for greedy decoding."""
    if float(temperature) == 0.0:
        return None
    if generator is not None:
        return generator
    if caches.generator is None:
        caches.generator = torch.Generator(device=dev).manual_seed(0)
    return caches.generator


class CacheList(list):
    """The per-layer caches of one batch (a list, as the model takes
    them), with the decode steps captured on them (``graphs``) and the
    generator that sampling draws from when the caller gives none
    (``generator``, made at first need)."""

    def __init__(self, caches=()):
        super().__init__(caches)
        self.graphs = {}
        self.generator = None


def allocate_caches(model, inference_params: InferenceParams, device
                    ) -> CacheList:
    """One empty cache per layer of ``model``: paged when
    ``inference_params.is_paged``, else contiguous."""
    kind = PagedKVCache if inference_params.is_paged else KVCache
    return CacheList(
        kind.allocate(inference_params, layer.self_attention.num_kv_heads,
                      layer.self_attention.head_dim, device)
        for layer in model.layers)


@torch.no_grad()
def prefill(model, tokens: torch.Tensor, inference_params: InferenceParams,
            prompt_lengths: torch.Tensor, *, temperature: float = 0.0,
            top_k: int = 0, top_p: float = 1.0,
            generator: Optional[torch.Generator] = None, device="cuda"
            ) -> Tuple[torch.Tensor, CacheList]:
    """Runs the right-padded prompts (B, S) through ``model``, filling new
    caches (paged when ``inference_params.is_paged``). Returns (first
    sampled token (B,), per-layer caches).

    The caches' lengths advance by the padded width and are then rewound
    by each prompt's padding, so decode writes right after the last real
    token (over the padded slots; a paged cache reuses the pages the
    prompt filled)."""
    dev = resolve_device(device)
    check_on(dev, model=model.embedding)
    tokens = tokens.to(dev)
    lengths = prompt_lengths.to(device=dev, dtype=torch.int32)
    caches = allocate_caches(model, inference_params, dev)
    logits = model(tokens, SequenceDescriptor.from_seqlens(lengths),
                   kv_caches=caches)
    pad = tokens.shape[1] - lengths
    for cache in caches:
        cache.length -= pad
    check_pages(caches)
    last = logits[torch.arange(tokens.shape[0], device=dev),
                  (lengths - 1).long()]
    tok = _sample(last, _generator(generator, temperature, dev, caches),
                  temperature, top_k, top_p)
    return tok, caches


def _decode_one(model, caches, tok, generator, values, mode):
    logits = model(tok[:, None], kv_caches=caches)
    return _sample(logits[:, -1], generator, *values, mode=mode)


class _DecodeGraph:
    """One decode step captured on a batch's caches: the model call on
    the static token buffer ``tok`` (B,), then the draw, written back into
    ``tok``; ``values`` are the static sampling tensors. It holds the
    model and the generator, so neither's id can be reused while the
    graph lives; the capture's closure holds no reference to this object
    or to the cache list, so the graph's memory is freed with the caches.
    On CPU tensors the step runs eagerly at each replay."""

    def __init__(self, model, caches, tok, generator, values, mode):
        self.model = model
        self.generator = generator
        self.tok = tok = tok.clone()
        self.values = values
        layers = list(caches)

        def step():
            tok.copy_(_decode_one(model, layers, tok, generator, values,
                                  mode))

        self.step = CapturedStep(step, "decode_step",
                                 () if generator is None else (generator,),
                                 eager=tok.device.type == "cpu")


@torch.no_grad()
def decode_steps(model, kv_caches: CacheList, first_token: torch.Tensor,
                 num_steps: int, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None, device="cuda"
                 ) -> torch.Tensor:
    """Decodes ``num_steps`` tokens after ``first_token`` (B,), updating
    ``kv_caches`` in place. Returns (B, num_steps) int32. Raises after
    the steps if a paged cache ran out of room.

    ``kv_caches`` must be the :class:`CacheList` that :func:`prefill` or
    :func:`allocate_caches` returned. The first step on them runs
    eagerly; then the step is captured, once for each model and sampling
    structure, and replayed for every later step and call. A call with
    another generator than the graph's captures the step anew in its
    place. A step that cannot be captured raises. On the CPU the same
    code runs every step eagerly."""
    dev = resolve_device(device)
    check_on(dev, model=model.embedding)
    if not isinstance(kv_caches, CacheList):
        raise TypeError("decode captures its step on the caches: pass the "
                        "CacheList that prefill or allocate_caches returned")
    tok = first_token.to(device=dev, dtype=torch.int32)
    mode = _sample_mode(temperature, top_k, top_p)
    generator = _generator(generator, temperature, dev, kv_caches)
    values = (temperature, top_k, top_p) if mode[0] else _sampling_tensors(
        temperature, top_k, top_p, dev)
    out = torch.empty((tok.shape[0], num_steps), dtype=torch.int32,
                      device=dev)
    key = (id(model), mode)
    graph = kv_caches.graphs.get(key)
    start = 0
    if num_steps and (graph is None or graph.generator is not generator):
        kv_caches.graphs.pop(key, None)
        tok = _decode_one(model, kv_caches, tok, generator, values, mode)
        out[:, 0] = tok
        graph = kv_caches.graphs[key] = _DecodeGraph(
            model, kv_caches, tok, generator, values, mode)
        start = 1
    elif num_steps:
        if tok.shape != graph.tok.shape:
            raise ValueError(f"first_token {tuple(tok.shape)} does not fit "
                             f"the caches' batch {tuple(graph.tok.shape)}")
        graph.tok.copy_(tok)
        if not mode[0]:
            for held, v in zip(graph.values, values):
                held.copy_(v)
    for i in range(start, num_steps):
        graph.step.replay()
        out[:, i] = graph.tok
    check_pages(kv_caches)
    return out


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
    first, caches = prefill(model, prompt_tokens, inference_params,
                            prompt_lengths, temperature=temperature,
                            top_k=top_k, top_p=top_p, generator=generator,
                            device=dev)
    toks = decode_steps(model, caches, first, max_new_tokens - 1,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator, device=dev)
    return torch.cat([first[:, None], toks], dim=1)
