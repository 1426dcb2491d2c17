"""Flash attention over BSHD tensors, forward and backward (counterpart
of transformerengine_tpu/ops/flash_attention.py flash_attention and its
``_flash_core`` custom VJP).

:func:`flash_fwd` returns O and the log-sum-exp of each query row. On
CUDA tensors it launches the kernel in ``csrc/flash_attention.cu``; on
CPU tensors it runs :func:`flash_fwd_plain`, which materializes the
scores. :func:`flash_bwd` returns dQ, dK and dV from the saved LSE (the
reference's ``_flash_bwd``): the two kernels in
``csrc/flash_attention_bwd.cu`` on CUDA tensors, :func:`flash_bwd_plain`
on CPU tensors. :func:`flash_attention` is differentiable: its autograd
function saves q, k, v, O and LSE, as the reference's forward rule does.
Both directions keep the reference's numerics: ``scale * log2(e)`` is folded
into q in q's dtype, the softmax runs in the exp2 domain, masked scores
are -2e30 under a running max floored at -1e30, the softmax weights are
rounded to V's dtype for the PV product, and a row with no visible key
writes O = 0 and LSE = -1e30. The backward works in the log2 domain
too (LSE times log2(e)), rounds ds and p to the inputs' dtype before
their products, and scales dQ by ``scale`` and dK by ln(2) at the end;
fully masked rows and padded keys get exact zeros.

Masks: none, causal (with the bottom-right offset) and padding from
per-sequence lengths, whose padded rows and keys (segment 0 in the
reference) are masked on both sides. GQA takes Hq % Hkv == 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ..attention import AttnMaskType

NEG_INF = -1e30
MASKED = -2e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# Arguments of the reference function that this port does not take yet
# (ROADMAP.md lists them); passing any of them raises.
_UNPORTED = ("window_size", "q_position_offset", "bias", "block_q",
             "block_k", "qkv_quantizers", "dropout_probability",
             "dropout_seed", "score_mod", "softmax_type", "softmax_offset",
             "mha_proj")


def flash_fwd_plain(q, k, v, q_seqlens=None, kv_seqlens=None, *,
                    causal: bool, offset: int = 0):
    """Reference forward; ``q`` arrives pre-scaled by scale * log2(e)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(b, sq, hkv, g, d), k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos + offset)
    if q_seqlens is not None:
        mask = (mask & (qpos < q_seqlens.reshape(-1, 1, 1))
                & (kpos < kv_seqlens.reshape(-1, 1, 1)))
    s = torch.where(mask[:, None, None], s, MASKED)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    lse = torch.where(l > 0, m * LN2 + torch.log(l_safe),
                      torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse.reshape(b, hq, sq)


def _check_qkv(q, k, v, q_seqlens, kv_seqlens) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected BSHD q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")
    if (q_seqlens is None) != (kv_seqlens is None):
        raise ValueError("give both q_seqlens and kv_seqlens, or neither")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_seqlens: Optional[torch.Tensor] = None,
              kv_seqlens: Optional[torch.Tensor] = None, *,
              scale: float, causal: bool, offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (B, Sq, Hq, D) in q's dtype and LSE (B, Hq, Sq) f32.

    ``q_seqlens`` / ``kv_seqlens`` (B,) give each sequence's valid
    lengths (both or neither); ``offset`` shifts the causal diagonal
    (key j is visible to query i when j <= i + offset)."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    if _build.on_cpu(q, k, v, q_seqlens, kv_seqlens):
        return flash_fwd_plain(qs, k, v, q_seqlens, kv_seqlens,
                               causal=causal, offset=offset)
    code = _build.dtype_code(q, (torch.float32, torch.bfloat16))
    if d % 16 or d > 256:
        raise ValueError(f"the flash kernel takes D % 16 == 0 and D <= 256, "
                         f"got {d}")
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    if q_seqlens is not None:
        q_seqlens = q_seqlens.to(torch.int32).contiguous()
        kv_seqlens = kv_seqlens.to(torch.int32).contiguous()
    _build.check_aligned(qs, k, v)
    o = torch.empty_like(qs)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch("te_flash_attention_fwd", _build.ptr(qs), _build.ptr(k),
                  _build.ptr(v), code, _build.ptr(o), _build.ptr(lse),
                  _build.ptr(q_seqlens), _build.ptr(kv_seqlens), b, sq, skv,
                  hq, hkv, d, int(causal), offset, _build.stream(q))
    _build.LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens=None,
                    kv_seqlens=None, *, scale: float, causal: bool,
                    offset: int = 0):
    """Reference backward; ``qs`` arrives pre-scaled by scale * log2(e),
    ``delta`` is rowsum(dO * O) (B, Sq, Hq) f32."""
    b, sq, hq, d = qs.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = qs.float().reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    qpos = torch.arange(sq, device=qs.device)[:, None]
    kpos = torch.arange(skv, device=qs.device)[None, :]
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=qs.device)
    if causal:
        mask = mask & (kpos <= qpos + offset)
    if q_seqlens is not None:
        mask = (mask & (qpos < q_seqlens.reshape(-1, 1, 1))
                & (kpos < kv_seqlens.reshape(-1, 1, 1)))
    lse2 = (lse.float() * LOG2E).reshape(b, hkv, g, sq, 1)
    p = torch.where(mask[:, None, None], torch.exp2(s - lse2),
                    torch.zeros((), device=qs.device))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    dl = delta.float().permute(0, 2, 1).reshape(b, hkv, g, sq, 1)
    ds = p * (dp - dl)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(qs.dtype).float(), qf) * LN2
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), dof)
    return (dq.reshape(b, sq, hq, d).to(qs.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              q_seqlens: Optional[torch.Tensor] = None,
              kv_seqlens: Optional[torch.Tensor] = None, *,
              scale: float, causal: bool, offset: int = 0):
    """(dQ, dK, dV) of :func:`flash_fwd` for the output gradient ``do``,
    from its inputs (q unscaled), O and LSE; each in its input's dtype
    and shape."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"expected O and dO like q {tuple(q.shape)} and LSE "
                         f"(B, Hq, Sq), got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    if _build.on_cpu(q, k, v, o, lse, do, q_seqlens, kv_seqlens):
        return flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens,
                               kv_seqlens, scale=scale, causal=causal,
                               offset=offset)
    code = _build.dtype_code(q, (torch.float32, torch.bfloat16))
    if d % 16 or d > 256:
        raise ValueError(f"the flash kernels take D % 16 == 0 and D <= 256, "
                         f"got {d}")
    do = do.to(q.dtype).contiguous()
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    lse2 = (lse.float() * LOG2E).contiguous()
    if q_seqlens is not None:
        q_seqlens = q_seqlens.to(torch.int32).contiguous()
        kv_seqlens = kv_seqlens.to(torch.int32).contiguous()
    _build.check_aligned(qs, k, v, do, lse2, delta)
    dq = torch.empty_like(qs)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    P, st = _build.ptr, _build.stream(q)
    _build.launch("te_flash_attention_bwd_dq", P(qs), P(k), P(v), code,
                  P(do), P(lse2), P(delta), P(dq), P(q_seqlens),
                  P(kv_seqlens), b, sq, skv, hq, hkv, d, int(causal), offset,
                  float(scale), st)
    _build.LAUNCHES["flash_attention_bwd_dq"] += 1
    _build.launch("te_flash_attention_bwd_dkv", P(qs), P(k), P(v), code,
                  P(do), P(lse2), P(delta), P(dk), P(dv), P(q_seqlens),
                  P(kv_seqlens), b, sq, skv, hq, hkv, d, int(causal), offset,
                  st)
    _build.LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """O = flash_fwd(q, k, v); the backward runs :func:`flash_bwd` from
    the saved q, k, v, O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, q_seqlens, kv_seqlens, scale, causal, offset):
        o, lse = flash_fwd(q, k, v, q_seqlens, kv_seqlens, scale=scale,
                           causal=causal, offset=offset)
        ctx.save_for_backward(q, k, v, o, lse, q_seqlens, kv_seqlens)
        ctx.cfg = (scale, causal, offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seqlens, kv_seqlens = ctx.saved_tensors
        scale, causal, offset = ctx.cfg
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, q_seqlens, kv_seqlens,
                               scale=scale, causal=causal, offset=offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sequence_descriptor=None, *, attn_mask_type=None,
                    scaling_factor: Optional[float] = None,
                    **unported) -> torch.Tensor:
    """Flash attention over BSHD inputs; returns O (B, Sq, Hq, D),
    differentiable in q, k and v.

    Masking comes from ``attn_mask_type`` and the lengths in
    ``sequence_descriptor`` (a :class:`~..attention.SequenceDescriptor`).
    The reference's window, bias, dropout, score_mod, softmax sink, FP8
    Q/K/V and fused output projection are not ported yet and raise."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"flash_attention() got an unexpected argument "
                            f"{name!r}")
        if value is not None:
            raise NotImplementedError(
                f"flash_attention({name}=...) is not ported yet")
    mask_type = attn_mask_type or AttnMaskType.NO_MASK
    q_seqlens = kv_seqlens = None
    if sequence_descriptor is not None and \
            sequence_descriptor.q_seqlens is not None:
        q_seqlens = sequence_descriptor.q_seqlens
        kv_seqlens = (sequence_descriptor.kv_seqlens
                      if sequence_descriptor.kv_seqlens is not None
                      else q_seqlens)
    if mask_type.is_padding and q_seqlens is None:
        raise ValueError("padding mask requires a sequence_descriptor")
    d = q.shape[-1]
    offset = k.shape[1] - q.shape[1] if mask_type.is_bottom_right else 0
    scale = scaling_factor if scaling_factor is not None else 1.0 / d ** 0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_seqlens, kv_seqlens,
                                     float(scale), mask_type.is_causal,
                                     offset)
    return flash_fwd(q, k, v, q_seqlens, kv_seqlens, scale=scale,
                     causal=mask_type.is_causal, offset=offset)[0]
