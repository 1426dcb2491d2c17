"""Score modifiers (counterpart of transformerengine_tpu/flex_attention.py,
its ``alibi_arith_mod`` alone).

A score mod is called as ``mod(score, b, h, q_idx, kv_idx)`` on the
natural-domain scores (``q . k * scale``) and returns the modified ones.
The flash kernels take one mod, ALiBi, which they recognise by its class
(:class:`AlibiMod`) and run in-kernel from the per-head slopes, which
their plain versions read too; the mod itself is a callable with the
reference's signature and formula. Any other callable is not ported yet (the
reference's other mods, its soft cap and its ``flex_attention``
implementations) and ``flash_attention(score_mod=...)`` refuses it.
"""
from __future__ import annotations

import torch


def alibi_slopes(num_heads: int, count=None, device=None) -> torch.Tensor:
    """(count,) f32 ALiBi slopes ``2^(-(h + 1) * (8 / num_heads))`` of
    heads 0..count-1 (``num_heads`` of them by default), in the
    reference's order of operations: the product in f32, then exp2."""
    h = torch.arange(num_heads if count is None else count,
                     dtype=torch.float32, device=device)
    return torch.exp2(-(h + 1.0) * (8.0 / num_heads))


class AlibiMod:
    """ALiBi with the standard geometric slopes computed from the head
    index: ``score - slope_h * |q_idx - kv_idx|``. Its VJP in the score
    is the identity."""

    def __init__(self, num_heads: int):
        self.num_heads = int(num_heads)

    def slopes(self, count=None, device=None) -> torch.Tensor:
        """The slopes of heads 0..count-1, as the kernels take them."""
        return alibi_slopes(self.num_heads, count, device)

    def __call__(self, score, b, h, q_idx, kv_idx):
        del b
        slope = torch.exp2(-(torch.as_tensor(h).to(torch.float32) + 1.0)
                           * (8.0 / self.num_heads))
        return score - slope * (q_idx - kv_idx).abs().to(torch.float32)


def alibi_arith_mod(num_heads: int) -> AlibiMod:
    """ALiBi as a score mod that the flash kernels run in-kernel."""
    return AlibiMod(num_heads)
