"""Flex attention: user-defined score and mask modifiers (counterpart of
transformerengine_tpu/flex_attention.py).

A score mod is called as ``mod(score, b, h, q_idx, kv_idx)`` on the
natural-domain scores (``q . k * scale``) and returns the modified ones; a
mask mod as ``mask(b, h, q_idx, kv_idx)`` and returns where a key is
visible. The indices are integer tensors that broadcast against the
scores. The reference's mods are small callable classes here, with its
signatures and formulas, so that the flash impl can recognise a mod by its
class and the chunked impl can reach the tensors a mod holds.

Three implementations, selected by ``impl``:

- ``"chunked"`` (and ``"auto"``): a flash-style online softmax over KV
  blocks of ``block_k`` keys, as a ``torch.autograd.Function`` whose
  backward recomputes each block's scores, so score memory is
  O(Sq * block_k) in both directions. It gives gradients to q, k, v and to
  the floating tensors that the score mod captures. The reference reaches
  those with ``jax.closure_convert``; PyTorch has no counterpart, so:

  * a mod class of this module exposes its tensors (``tensors()``, and
    ``with_tensors()`` for a copy that holds others): the function takes
    them as inputs, recomputes each block with detached copies, and
    returns their gradients, under ``.backward()`` and
    ``torch.autograd.grad`` alike;
  * any other callable's captured tensors are reached by a reentrant
    backward of each recomputed block (``torch.autograd.backward`` from
    inside the function's backward, as ``torch.utils.checkpoint``'s
    reentrant form does): their gradients accumulate into the ``.grad``
    of the leaves they come from, which ``.backward()`` reads and
    ``torch.autograd.grad`` does not (the same limit as that checkpoint).

  Integer tensors get no gradient, as in the reference.
- ``"flash"``: the flash kernels (ops/flash_attention.py), fastest.
  ``soft_cap_mod`` runs in their soft-cap branch; ``alibi_arith_mod``, and
  ``alibi_mod`` with (Hq,) slopes, in their ALiBi branch;
  ``causal_mask_mod`` is their causal rule with offset 0 (key j visible to
  query i when j <= i, the top-left diagonal); alone, it runs in the
  ALiBi branch with zero slopes, which scales the scores in f32 on
  unscaled q as the reference's flash impl does. Any other mod or mask,
  ``relative_position_bias_mod`` included (a table gather is not
  kernel-traceable in the reference either), raises
  ``NotImplementedError``; none falls back to a plain path. Captured
  tensors get no gradient, as in the reference. The reference folds a
  mask into its mod with a -1e30 fill and visits every tile, where the
  kernels skip the tiles above the diagonal: rows with a visible key give
  the same numbers.
- ``"reference"``: the direct O(Sq * Skv) materialization, the numerics'
  ground truth for the tests.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# score_mod(score, batch_idx, head_idx, q_idx, kv_idx) -> score
ScoreMod = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor], torch.Tensor]
# mask_mod(batch_idx, head_idx, q_idx, kv_idx) -> bool
MaskMod = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]

NEG_INF = -1e30     # m/lse floor
MASKED = -2e30      # masked fill; exp(MASKED - NEG_INF) underflows to 0


def alibi_slopes(num_heads: int, count=None, device=None) -> torch.Tensor:
    """(count,) f32 ALiBi slopes ``2^(-(h + 1) * (8 / num_heads))`` of
    heads 0..count-1 (``num_heads`` of them by default), in the
    reference's order of operations: the product in f32, then exp2."""
    h = torch.arange(num_heads if count is None else count,
                     dtype=torch.float32, device=device)
    return torch.exp2(-(h + 1.0) * (8.0 / num_heads))


class _Mod:
    """A mod that holds no tensor."""

    def tensors(self) -> tuple:
        """The tensors the mod computes with, whose gradients the chunked
        impl returns."""
        return ()

    def with_tensors(self, *tensors):
        """The same mod computing with ``tensors`` in place of its own."""
        return self


class AlibiMod(_Mod):
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


class AlibiSlopesMod(AlibiMod):
    """ALiBi with explicit per-head slopes (the reference's ``alibi_mod``):
    ``score - slopes[h] * |q_idx - kv_idx|``."""

    def __init__(self, slopes: torch.Tensor):
        self.slopes_tensor = slopes
        self.num_heads = int(slopes.shape[0])

    def slopes(self, count=None, device=None) -> torch.Tensor:
        """The (count,) f32 slopes as the kernels take them, detached (no
        gradient reaches them through the kernels)."""
        s = self.slopes_tensor.detach()
        if s.dim() != 1 or (count is not None and s.shape[0] != count):
            raise ValueError(f"the flash kernels take one ALiBi slope per "
                             f"query head ({count}), got {tuple(s.shape)}")
        return s.to(device=device, dtype=torch.float32).contiguous()

    def tensors(self) -> tuple:
        return (self.slopes_tensor,)

    def with_tensors(self, slopes):
        return AlibiSlopesMod(slopes)

    def __call__(self, score, b, h, q_idx, kv_idx):
        del b
        return score - self.slopes_tensor[h] * (q_idx - kv_idx).abs()


class SoftCapMod(_Mod):
    """Logit soft-capping (Gemma-2 style): ``cap * tanh(score / cap)``,
    the division a true one (on ``score``'s device)."""

    def __init__(self, cap: float):
        self.cap = float(cap)

    def __call__(self, score, b, h, q_idx, kv_idx):
        div = torch.full((), self.cap, dtype=score.dtype, device=score.device)
        return self.cap * torch.tanh(score / div)


class RelativePositionBiasMod(_Mod):
    """A learned relative bias, ``score + bias_table[h, clip(kv_idx -
    q_idx, -max_dist, max_dist) + max_dist]`` with ``bias_table`` (H, 2 *
    max_dist + 1). A table gather: chunked and reference impls only.

    It takes the impls' index grids: heads on the leading dims (the last
    two of ``h`` of size 1), queries and keys on the last two. Each
    head's row is gathered, then its columns by relative index alone, so
    no index of the scores' size is built. The table's gradient is summed
    with ``index_add_``: on a card its f32 atomic adds land in no fixed
    order, so that gradient can differ from run to run in its last bits
    (the reference's cannot)."""

    def __init__(self, bias_table: torch.Tensor):
        self.bias_table = bias_table
        self.max_dist = (bias_table.shape[-1] - 1) // 2

    def tensors(self) -> tuple:
        return (self.bias_table,)

    def with_tensors(self, bias_table):
        return RelativePositionBiasMod(bias_table)

    def __call__(self, score, b, h, q_idx, kv_idx):
        del b
        m = self.max_dist
        rel = (kv_idx - q_idx).clamp(-m, m) + m
        if h.shape[-2:] != (1, 1) or rel.numel() != rel.shape[-2] * \
                rel.shape[-1]:
            raise ValueError("relative_position_bias_mod takes the heads on "
                             "the leading dims and queries and keys on the "
                             "last two, as flex_attention's grids")
        rows = self.bias_table[h.reshape(h.shape[:-2])]
        return score + _ColumnGather.apply(rows, rel.reshape(rel.shape[-2:]))


class _ColumnGather(torch.autograd.Function):
    """``rows[..., idx]`` for a 2-D index of the last dimension. Its
    backward adds the gradient into the columns with ``index_add_`` where
    the indexing's own backward sorts the index and sums each column's
    duplicates in turn: 276 ms of a 318 ms chunked relative-bias call at
    LLAMA_8B's attention shape (an H100 80GB HBM3 at 700 W), where every
    column has about a thousand duplicates a block."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (rows.shape, rows.dtype)
        return rows[..., idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype = ctx.meta
        lead = g.shape[:-2]
        d = torch.zeros((*lead, shape[-1]), dtype=torch.float32,
                        device=g.device)
        d.index_add_(-1, idx.reshape(-1), g.reshape(*lead, -1).float())
        return d.to(dtype).sum_to_size(shape), None


class CausalMaskMod:
    """The causal mask: key ``kv_idx`` is visible to query ``q_idx`` when
    ``kv_idx <= q_idx``."""

    def __call__(self, b, h, q_idx, kv_idx):
        return kv_idx <= q_idx


causal_mask_mod = CausalMaskMod()


def relative_position_bias_mod(bias_table: torch.Tensor
                               ) -> RelativePositionBiasMod:
    """bias_table: (H, 2*max_dist+1) learned relative bias. Table gather:
    chunked/reference impls only (not kernel-traceable)."""
    return RelativePositionBiasMod(bias_table)


def alibi_mod(slopes: torch.Tensor) -> AlibiSlopesMod:
    """ALiBi score modifier with explicit (H,) slopes."""
    return AlibiSlopesMod(slopes)


def alibi_arith_mod(num_heads: int) -> AlibiMod:
    """ALiBi with the standard geometric slope computed arithmetically
    from the head index; the flash kernels run it in-kernel."""
    return AlibiMod(num_heads)


def soft_cap_mod(cap: float) -> SoftCapMod:
    """Logit soft-capping (Gemma-2 style); the flash kernels run it
    in-kernel."""
    return SoftCapMod(cap)


def _identity(score, b, h, q_idx, kv_idx):
    return score


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Reference (O(Sq * Skv) materialization)
# ---------------------------------------------------------------------------

def _reference_flex(q, k, v, score_mod, mask_mod, scale):
    """Direct O(Sq*Skv) evaluation (numerics ground truth), differentiable
    by autograd in everything the mods compute with."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    dev = q.device
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    hidx = torch.arange(hq, device=dev)[None, :, None, None]
    qidx = torch.arange(sq, device=dev)[None, None, :, None]
    kidx = torch.arange(skv, device=dev)[None, None, None, :]
    if score_mod is not None:
        s = score_mod(s, bidx, hidx, qidx, kidx)
    if mask_mod is not None:
        s = torch.where(mask_mod(bidx, hidx, qidx, kidx), s,
                        torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax path (O(Sq * block_k) score memory)
# ---------------------------------------------------------------------------

def _idx_grids(b, hkv, group, sq, block_k, k0, device):
    """(b, h, q, kv) index grids broadcastable against a (B, Hkv, G, Sq,
    block_k) score block; h is the QUERY head index hk * group + g."""
    bidx = torch.arange(b, device=device)[:, None, None, None, None]
    hidx = (torch.arange(hkv, device=device)[:, None] * group
            + torch.arange(group, device=device)[None, :]
            )[None, :, :, None, None]
    qidx = torch.arange(sq, device=device)[None, None, None, :, None]
    kidx = (k0 + torch.arange(block_k, device=device)
            )[None, None, None, None, :]
    return bidx, hidx, qidx, kidx


def _raw_scores(q5, k_blk, scale):
    """(B, Hkv, G, Sq, block_k) f32 ``q . k * scale`` of one KV block."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q5, k_blk)
    return s.mul_(scale)


def _block_scores(s_raw, i, skv, block_k, mod, maskm):
    """The masked, modified scores of KV block i from its raw scores;
    shared by the forward and the backward's recomputation, so the two
    see the same numbers."""
    b, hkv, group, sq, _ = s_raw.shape
    grids = _idx_grids(b, hkv, group, sq, block_k, i * block_k,
                       s_raw.device)
    s = mod(s_raw, *grids)
    valid = grids[3] < skv          # KV padding (block-multiple round-up)
    if maskm is not None:
        valid = valid & maskm(*grids)
    return torch.where(valid, s, torch.full((), MASKED, device=s.device))


def _bmm_acc(acc, a, b, a_t: bool = False):
    """``acc += a @ b`` in place over the (B, Hkv) batch, with ``a`` (B,
    Hkv, G, X, Y) read as (B * Hkv, G * X, Y) (or its transpose with
    ``a_t``, contracting G and X) and ``b`` (B, Hkv, ., .)."""
    bh = a.shape[0] * a.shape[1]
    a3 = a.reshape(bh, -1, a.shape[-1])
    if a_t:
        acc.view(bh, acc.shape[-2], acc.shape[-1]).baddbmm_(
            a3.transpose(1, 2), b.reshape(bh, -1, b.shape[-1]))
    else:
        acc.view(bh, -1, acc.shape[-1]).baddbmm_(
            a3, b.reshape(bh, b.shape[-2], b.shape[-1]))


class _ChunkedFlex(torch.autograd.Function):
    """The chunked impl on (B, Hkv, G, Sq, D) f32 q and (B, Hkv, Skv_p, D)
    f32 k and v padded to whole blocks; ``tensors`` are the mod class's
    (or none for another callable)."""

    @staticmethod
    def forward(ctx, q5, k4, v4, mod, maskm, scale, block_k, skv, *tensors):
        b, hkv, group, sq, d = q5.shape
        nk = k4.shape[2] // block_k
        m = torch.full((b, hkv, group, sq), NEG_INF, device=q5.device)
        l = torch.zeros((b, hkv, group, sq), device=q5.device)
        acc = torch.zeros_like(q5)
        for i in range(nk):
            blk = slice(i * block_k, (i + 1) * block_k)
            s = _block_scores(_raw_scores(q5, k4[:, :, blk], scale), i, skv,
                              block_k, mod, maskm)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = s.sub_(m_new[..., None]).exp_()
            l = l * alpha + p.sum(dim=-1)
            acc.mul_(alpha[..., None])
            _bmm_acc(acc, p, v4[:, :, blk])
            m = m_new
            del s, p
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        o = acc.div_(l_safe[..., None])
        lse = torch.where(l > 0, m + torch.log(l_safe),
                          torch.full_like(l, NEG_INF))
        ctx.save_for_backward(q5, k4, v4, o, lse, *tensors)
        ctx.cfg = (mod, maskm, scale, block_k, skv)
        return o

    @staticmethod
    def backward(ctx, do):
        q5, k4, v4, o, lse, *tensors = ctx.saved_tensors
        mod, maskm, scale, block_k, skv = ctx.cfg
        nk = k4.shape[2] // block_k
        do = do.contiguous()
        delta = (do * o).sum(dim=-1)[..., None]
        dq, dk, dv = (torch.zeros_like(t) for t in (q5, k4, v4))
        # Only floating tensors get gradients (the reference gives integer
        # constants float0 cotangents).
        grads = [torch.zeros_like(t) if t.is_floating_point()
                 and ctx.needs_input_grad[8 + n] else None
                 for n, t in enumerate(tensors)]
        for i in range(nk):
            blk = slice(i * block_k, (i + 1) * block_k)
            k_blk, v_blk = k4[:, :, blk], v4[:, :, blk]
            # The raw scores are a leaf: the block's VJP stops there.
            s_in = _raw_scores(q5.detach(), k_blk.detach(), scale)
            with torch.enable_grad():
                s_in.requires_grad_()
                leaves = [t.detach().requires_grad_(g is not None)
                          for t, g in zip(tensors, grads)]
                s = _block_scores(s_in, i, skv, block_k,
                                  mod.with_tensors(*leaves) if tensors
                                  else mod, maskm)
            p = torch.sub(s.detach(), lse[..., None]).exp_()  # masked -> 0
            _bmm_acc(dv[:, :, blk], p, do, a_t=True)
            ds = torch.einsum("bhgqd,bhkd->bhgqk", do, v_blk)
            ds.sub_(delta).mul_(p)
            del p
            if s.requires_grad:
                # The block's VJP through the mod and the mask, into the
                # raw scores, the mod class's tensors and (reentrant) any
                # tensor a plain callable captures.
                torch.autograd.backward(s, ds)
            del s, ds
            if s_in.grad is not None:
                ds_raw = s_in.grad.mul_(scale)
                _bmm_acc(dq, ds_raw, k_blk)
                _bmm_acc(dk[:, :, blk], ds_raw, q5, a_t=True)
                del ds_raw
            del s_in
            for g, leaf in zip(grads, leaves):
                if g is not None and leaf.grad is not None:
                    g.add_(leaf.grad)
        return (dq, dk, dv, None, None, None, None, None, *grads)


def _chunked_flex(q, k, v, score_mod, mask_mod, scale, block_k):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    block_k = max(128, min(block_k, _ceil_to(skv, 128)))
    skv_p = _ceil_to(skv, block_k)
    # (B, Hkv, G, Sq, D) query / (B, Hkv, Skv_p, D) key-value, f32.
    q5 = q.float().transpose(1, 2).reshape(b, hkv, group, sq, d)
    k4 = k.float().transpose(1, 2)
    v4 = v.float().transpose(1, 2)
    if skv_p != skv:
        pad = (0, 0, 0, skv_p - skv)
        k4 = torch.nn.functional.pad(k4, pad)
        v4 = torch.nn.functional.pad(v4, pad)
    mod = score_mod if score_mod is not None else _identity
    tensors = mod.tensors() if isinstance(mod, _Mod) else ()
    o = _ChunkedFlex.apply(q5.contiguous(), k4.contiguous(),
                           v4.contiguous(), mod, mask_mod, float(scale),
                           block_k, skv, *tensors)
    # Cast before the transpose: the backward's dO then reaches the
    # function contiguous, in f32 once.
    return o.to(q.dtype).reshape(b, hq, sq, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# Flash (the kernels)
# ---------------------------------------------------------------------------

def _flash_flex(q, k, v, score_mod, mask_mod, scale):
    from .attention import AttnMaskType
    from .ops.flash_attention import flash_attention
    if mask_mod is not None and not isinstance(mask_mod, CausalMaskMod):
        raise NotImplementedError(
            "flex_attention(impl=\"flash\") takes causal_mask_mod as its one "
            "mask_mod; use impl=\"chunked\" for any other")
    if score_mod is not None and not isinstance(score_mod,
                                                (SoftCapMod, AlibiMod)):
        raise NotImplementedError(
            "flex_attention(impl=\"flash\") runs soft_cap_mod, "
            "alibi_arith_mod and alibi_mod (the kernels' branches); use "
            "impl=\"chunked\" for any other score_mod (a table gather such "
            "as relative_position_bias_mod is not kernel-traceable)")
    mask = AttnMaskType.NO_MASK
    if mask_mod is not None:
        mask = AttnMaskType.CAUSAL
        if score_mod is None:
            # The reference folds the mask into a score mod, so its kernel
            # scales the scores in f32 on unscaled q; the ALiBi branch with
            # zero slopes computes the same (s * scale - 0) * log2(e),
            # where the plain branch would round q * scale * log2(e) to
            # q's dtype.
            score_mod = AlibiSlopesMod(torch.zeros(q.shape[2],
                                                   device=q.device))
    return flash_attention(q, k, v, attn_mask_type=mask,
                           scaling_factor=scale, score_mod=score_mod)


def flex_attention(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Skv, Hkv, D)
    v: torch.Tensor,
    score_mod: Optional[ScoreMod] = None,
    mask_mod: Optional[MaskMod] = None,
    *,
    scaling_factor: Optional[float] = None,
    impl: str = "auto",         # auto | chunked | flash | reference
    block_k: int = 512,
) -> torch.Tensor:
    """Attention with arbitrary score/mask modification, differentiable
    through the modifier (including the tensors it captures on the chunked
    path); O (B, Sq, Hq, D) in q's dtype. ``block_k`` is the chunked
    impl's KV block, rounded to a multiple of 128 that Skv needs at
    most."""
    d = q.shape[-1]
    scale = scaling_factor if scaling_factor is not None else 1.0 / d ** 0.5
    if impl == "auto":
        impl = "chunked"
    if impl == "reference":
        return _reference_flex(q, k, v, score_mod, mask_mod, scale)
    if impl == "chunked":
        return _chunked_flex(q, k, v, score_mod, mask_mod, scale, block_k)
    if impl == "flash":
        return _flash_flex(q, k, v, score_mod, mask_mod, scale)
    raise ValueError(f"unknown flex impl {impl!r}")
