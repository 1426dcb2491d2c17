"""Continuous batching: a host-side serving loop over slot-reused caches
(counterpart of transformerengine_tpu/inference/batching.py).

The device work is the engine's own prefill and one-step decode; the
scheduler only decides which slot runs what:
- ``submit`` queues a request (a token list);
- each ``step`` admits queued requests into free slots (a batch-1
  prefill whose cache rows are copied into the slot's rows, ``kv_scale``
  lane included), then runs one decode step for the whole batch and
  hands each live slot its token on the host;
- a slot finishes on EOS or ``max_new_tokens`` and is freed at once (its
  length reset to 0).

Prompts are right-padded to ``prompt_len``. Idle slots keep decoding
rows that nothing reads (batch rows are independent through every
layer), and their lengths keep growing: the cache drops their writes
past its rows and the decode kernels read at most that many.

FP8 caches keep one scale per slot, so each admission calibrates its own
prompt into its slot's lane without rescaling live neighbours;
``fixed_kv_scale`` pins one scale for every slot instead. Only the
contiguous cache is used, as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import torch

from ..device import check_on, resolve_device
from .engine import allocate_caches, decode_steps, prefill
from .kv_cache import InferenceParams, KVCache


def _scatter_slot(caches: List[KVCache], small: List[KVCache],
                  slot: int) -> None:
    """Copies each batch-1 cache into row ``slot`` of the batch-B cache of
    the same layer, in place: payloads, length and ``kv_scale`` lane."""
    for big, one in zip(caches, small):
        for name in ("k", "v", "length", "kv_scale"):
            getattr(big, name)[slot].copy_(getattr(one, name)[0])


def _reset_slot_length(caches: List[KVCache], slot) -> None:
    """Empties row ``slot`` (an int or an index tensor) of every layer's
    cache by zeroing its length."""
    for cache in caches:
        cache.length[slot] = 0


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: List[int]


class ContinuousBatchingEngine:
    """Slot-based continuous batching (greedy decoding).

    >>> eng = ContinuousBatchingEngine(model, max_batch_size=4,
    ...     max_sequence_length=256, prompt_len=64, max_new_tokens=32,
    ...     eos_id=2)
    >>> rid = eng.submit([1, 5, 7, 9])
    >>> outputs = eng.run()          # {rid: [tok, ...]}
    """

    def __init__(self, model, *, max_batch_size: int,
                 max_sequence_length: int, prompt_len: int,
                 max_new_tokens: int, eos_id: Optional[int] = None,
                 kv_cache_dtype: torch.dtype = torch.bfloat16,
                 fixed_kv_scale: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        check_on(self.device, model=model.embedding)
        self.model = model
        self.B = max_batch_size
        self.prompt_len = prompt_len
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.ip = InferenceParams(
            max_batch_size=max_batch_size,
            max_sequence_length=max_sequence_length,
            kv_cache_dtype=kv_cache_dtype, fixed_kv_scale=fixed_kv_scale)
        self.ip1 = dataclasses.replace(self.ip, max_batch_size=1)
        self.caches = allocate_caches(model, self.ip, self.device)
        self.current = torch.zeros(self.B, dtype=torch.int32,
                                   device=self.device)   # last token a slot
        self.queue: deque = deque()
        self.slot_req: List[Optional[_Request]] = [None] * self.B
        self.emitted: Dict[int, List[int]] = {}
        self._admission_done: Dict[int, List[int]] = {}
        self._next_rid = 0

    def submit(self, tokens: List[int]) -> int:
        """Queues a prompt; returns its request id."""
        if not 0 < len(tokens) <= self.prompt_len:
            raise ValueError(f"prompt length {len(tokens)} is not in 1.."
                             f"{self.prompt_len}, the padded admission width")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, list(tokens)))
        return rid

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def step(self) -> Dict[int, List[int]]:
        """Admits, then runs one decode step. Returns the requests that
        finished in this step."""
        self._admit()
        done, self._admission_done = self._admission_done, {}
        if self.active == 0:
            return done
        self.current = decode_steps(self.model, self.caches, self.current, 1,
                                    device=self.device)[:, 0]
        host = self.current.tolist()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            out = self.emitted[req.rid]
            out.append(host[slot])
            hit_eos = self.eos_id is not None and out[-1] == self.eos_id
            if hit_eos or len(out) >= self.max_new:
                done[req.rid] = out
                self._free(slot)
        return done

    def run(self) -> Dict[int, List[int]]:
        """Steps until the queue and all slots drain."""
        results: Dict[int, List[int]] = {}
        while self.queue or self.active:
            results.update(self.step())
        return results

    def _admit(self) -> None:
        for slot in range(self.B):
            if not self.queue or self.slot_req[slot] is not None:
                continue
            req = self.queue.popleft()
            tokens = torch.zeros((1, self.prompt_len), dtype=torch.int32)
            tokens[0, :len(req.tokens)] = torch.tensor(req.tokens,
                                                       dtype=torch.int32)
            first, small = prefill(
                self.model, tokens, self.ip1,
                torch.tensor([len(req.tokens)], dtype=torch.int32),
                device=self.device)
            _scatter_slot(self.caches, small, slot)
            self.current[slot] = first[0]
            self.slot_req[slot] = req
            # The first token comes from the prefill itself.
            self.emitted[req.rid] = [int(first[0])]
            if (self.eos_id is not None
                    and self.emitted[req.rid][-1] == self.eos_id) \
                    or self.max_new <= 1:
                self._admission_done[req.rid] = self.emitted[req.rid]
                self._free(slot)

    def _free(self, slot: int) -> None:
        self.slot_req[slot] = None
        _reset_slot_length(self.caches, slot)
