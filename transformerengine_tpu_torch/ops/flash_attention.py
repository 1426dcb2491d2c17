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

Masks: none, causal (with the bottom-right offset), padding from
per-sequence lengths, whose padded rows and keys (segment 0 in the
reference) are masked on both sides, and a static sliding window
``(left, right)``: key j is visible to query i when ``i + offset - left
<= j <= i + offset + right``, each side where it is >= 0 (the
reference's ``_mask_scores``). GQA takes Hq % Hkv == 0.

Softmax sink (``softmax_type`` OFF_BY_ONE or LEARNABLE): one virtual key
per query head with logit ``sink`` and no value joins the denominator at
the end of the forward (the reference's ``_fwd_write_out``), so a row
with no visible key writes O = 0 and LSE = sink. The backward kernels
need nothing for it (the LSE carries it); its gradient ``dsink = -sum
exp(sink - LSE) * rowsum(dO * O)`` over batch and queries is computed
outside them, as the reference's ``_flash_core_bwd`` does.

A launch with a window or a sink counts under its own name
(``flash_attention_fwd_sw``, ``flash_attention_bwd_dq_sw``,
``flash_attention_bwd_dkv_sw``), so a path can show which branch it ran.
"""
from __future__ import annotations

import numbers
from typing import Optional, Tuple

import torch

from .. import _build
from ..attention import AttnMaskType, SoftmaxType

NEG_INF = -1e30
MASKED = -2e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

NO_WINDOW = (-1, -1)

# Arguments of the reference function that this port does not take yet
# (ROADMAP.md lists them); passing any of them raises.
_UNPORTED = ("q_position_offset", "bias", "block_q", "block_k",
             "qkv_quantizers", "dropout_probability", "dropout_seed",
             "score_mod", "mha_proj")


def _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
             device):
    """(B or 1, Sq, Skv) bool: which keys each query sees."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window[0] >= 0:
        mask = mask & (kpos >= qpos - window[0])
    if window[1] >= 0:
        mask = mask & (kpos <= qpos + window[1])
    if q_seqlens is not None:
        rows = torch.arange(sq, device=device)[:, None]
        mask = (mask & (rows < q_seqlens.reshape(-1, 1, 1))
                & (kpos < kv_seqlens.reshape(-1, 1, 1)))
    return mask


def flash_fwd_plain(q, k, v, q_seqlens=None, kv_seqlens=None, *,
                    causal: bool, offset: int = 0, window=NO_WINDOW,
                    softmax_sink=None):
    """Reference forward; ``q`` arrives pre-scaled by scale * log2(e)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(b, sq, hkv, g, d), k.float())
    mask = _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
                    q.device)
    s = torch.where(mask[:, None, None], s, MASKED)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    if softmax_sink is not None:
        s0 = (softmax_sink.float() * LOG2E).reshape(1, hkv, g, 1, 1)
        m2 = torch.maximum(m, s0)
        alpha = torch.exp2(m - m2)
        l2 = l * alpha + torch.exp2(s0 - m2)
        o = acc * alpha / l2
        lse = m2 * LN2 + torch.log(l2)
    else:
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        o = acc / l_safe
        lse = torch.where(l > 0, m * LN2 + torch.log(l_safe),
                          torch.full_like(l, NEG_INF))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return o.to(q.dtype), lse.reshape(b, hq, sq)


def _window(window) -> Tuple[int, int]:
    """A static two-sided window as (left, right), -1 for an inactive
    side (any negative int, as the reference's ``_win_active``)."""
    if window is None:
        return NO_WINDOW
    left, right = window
    for side in (left, right):
        if not isinstance(side, numbers.Integral):
            raise NotImplementedError(
                "a dynamic (traced or tensor) window is not ported yet")
    return (int(left) if left >= 0 else -1, int(right) if right >= 0 else -1)


def _sw(window, softmax_sink) -> str:
    """The launch count's suffix: "_sw" for the window and sink branch."""
    return "_sw" if window != NO_WINDOW or softmax_sink is not None else ""


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
              scale: float, causal: bool, offset: int = 0,
              window=NO_WINDOW, softmax_sink: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (B, Sq, Hq, D) in q's dtype and LSE (B, Hq, Sq) f32.

    ``q_seqlens`` / ``kv_seqlens`` (B,) give each sequence's valid
    lengths (both or neither); ``offset`` shifts the causal diagonal and
    the window (key j is visible to query i when j <= i + offset);
    ``window`` is a static (left, right), -1 for an inactive side;
    ``softmax_sink`` the (Hq,) sink logits, or None."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    window = _window(window)
    if softmax_sink is not None and softmax_sink.numel() != hq:
        raise ValueError(f"softmax_sink must hold Hq={hq} values, got "
                         f"{tuple(softmax_sink.shape)}")
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    if _build.on_cpu(q, k, v, q_seqlens, kv_seqlens, softmax_sink):
        return flash_fwd_plain(qs, k, v, q_seqlens, kv_seqlens,
                               causal=causal, offset=offset, window=window,
                               softmax_sink=softmax_sink)
    code = _build.dtype_code(q, (torch.float32, torch.bfloat16))
    if d % 16 or d > 256:
        raise ValueError(f"the flash kernel takes D % 16 == 0 and D <= 256, "
                         f"got {d}")
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    if q_seqlens is not None:
        q_seqlens = q_seqlens.to(torch.int32).contiguous()
        kv_seqlens = kv_seqlens.to(torch.int32).contiguous()
    sink = (softmax_sink.float().reshape(hq).contiguous()
            if softmax_sink is not None else None)
    _build.check_aligned(qs, k, v, sink)
    o = torch.empty_like(qs)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch("te_flash_attention_fwd", _build.ptr(qs), _build.ptr(k),
                  _build.ptr(v), code, _build.ptr(o), _build.ptr(lse),
                  _build.ptr(q_seqlens), _build.ptr(kv_seqlens),
                  _build.ptr(sink), b, sq, skv, hq, hkv, d, int(causal),
                  offset, window[0], window[1], _build.stream(q))
    _build.LAUNCHES["flash_attention_fwd" + _sw(window, sink)] += 1
    return o, lse


def flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens=None,
                    kv_seqlens=None, *, scale: float, causal: bool,
                    offset: int = 0, window=NO_WINDOW):
    """Reference backward; ``qs`` arrives pre-scaled by scale * log2(e),
    ``delta`` is rowsum(dO * O) (B, Sq, Hq) f32."""
    b, sq, hq, d = qs.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = qs.float().reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
                    qs.device)
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
              scale: float, causal: bool, offset: int = 0,
              window=NO_WINDOW, softmax_sink: Optional[torch.Tensor] = None):
    """(dQ, dK, dV) of :func:`flash_fwd` for the output gradient ``do``,
    from its inputs (q unscaled), O and LSE; each in its input's dtype
    and shape. ``softmax_sink`` is the forward's: the kernels need only
    the LSE, which holds it, and it names the launch counts
    (:func:`sink_grad` gives its gradient)."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"expected O and dO like q {tuple(q.shape)} and LSE "
                         f"(B, Hq, Sq), got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    window = _window(window)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    if _build.on_cpu(q, k, v, o, lse, do, q_seqlens, kv_seqlens):
        return flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens,
                               kv_seqlens, scale=scale, causal=causal,
                               offset=offset, window=window)
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
    left, right = window
    sw = _sw(window, softmax_sink)
    _build.launch("te_flash_attention_bwd_dq", P(qs), P(k), P(v), code,
                  P(do), P(lse2), P(delta), P(dq), P(q_seqlens),
                  P(kv_seqlens), b, sq, skv, hq, hkv, d, int(causal), offset,
                  left, right, float(scale), st)
    _build.LAUNCHES["flash_attention_bwd_dq" + sw] += 1
    _build.launch("te_flash_attention_bwd_dkv", P(qs), P(k), P(v), code,
                  P(do), P(lse2), P(delta), P(dk), P(dv), P(q_seqlens),
                  P(kv_seqlens), b, sq, skv, hq, hkv, d, int(causal), offset,
                  left, right, st)
    _build.LAUNCHES["flash_attention_bwd_dkv" + sw] += 1
    return dq, dk, dv


def sink_grad(softmax_sink: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor) -> torch.Tensor:
    """The sink's gradient, (Hq,) in its dtype: ``-sum_{b,q} exp(sink -
    LSE) * rowsum(dO * O)``, from the forward's O (B, Sq, Hq, D) and LSE
    (B, Hq, Sq); a row with no visible key has O = 0 and adds nothing."""
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    p_sink = torch.exp(softmax_sink.float().reshape(1, -1, 1) - lse)
    return (-(p_sink * delta).sum(dim=(0, 2))).to(softmax_sink.dtype)


class _FlashAttention(torch.autograd.Function):
    """O = flash_fwd(q, k, v); the backward runs :func:`flash_bwd` from
    the saved q, k, v, O and LSE, and :func:`sink_grad` for a sink."""

    @staticmethod
    def forward(ctx, q, k, v, sink, q_seqlens, kv_seqlens, scale, causal,
                offset, window):
        o, lse = flash_fwd(q, k, v, q_seqlens, kv_seqlens, scale=scale,
                           causal=causal, offset=offset, window=window,
                           softmax_sink=sink)
        ctx.save_for_backward(q, k, v, o, lse, sink, q_seqlens, kv_seqlens)
        ctx.cfg = (scale, causal, offset, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, sink, q_seqlens, kv_seqlens = ctx.saved_tensors
        scale, causal, offset, window = ctx.cfg
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, q_seqlens, kv_seqlens,
                               scale=scale, causal=causal, offset=offset,
                               window=window, softmax_sink=sink)
        dsink = (sink_grad(sink, o, lse, do)
                 if sink is not None and ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dsink, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sequence_descriptor=None, *, attn_mask_type=None,
                    scaling_factor: Optional[float] = None,
                    window_size: Optional[Tuple[int, int]] = None,
                    softmax_type: Optional[SoftmaxType] = None,
                    softmax_offset: Optional[torch.Tensor] = None,
                    **unported) -> torch.Tensor:
    """Flash attention over BSHD inputs; returns O (B, Sq, Hq, D),
    differentiable in q, k, v and the learnable sink.

    Masking comes from ``attn_mask_type``, the lengths in
    ``sequence_descriptor`` (a :class:`~..attention.SequenceDescriptor`)
    and the static ``window_size`` (left, right). ``softmax_type``
    OFF_BY_ONE adds a sink of logit 0 to every head, LEARNABLE the (Hq,)
    logits ``softmax_offset``. The reference's dynamic window,
    ``q_position_offset``, bias, dropout, score_mod, FP8 Q/K/V and fused
    output projection are not ported yet and raise."""
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
    d, hq = q.shape[-1], q.shape[2]
    offset = k.shape[1] - q.shape[1] if mask_type.is_bottom_right else 0
    scale = scaling_factor if scaling_factor is not None else 1.0 / d ** 0.5
    window = _window(window_size)
    sink = None
    if softmax_type is SoftmaxType.OFF_BY_ONE:
        sink = torch.zeros((hq,), dtype=torch.float32, device=q.device)
    elif softmax_type is SoftmaxType.LEARNABLE:
        if softmax_offset is None:
            raise ValueError("LEARNABLE softmax requires softmax_offset (Hq,)")
        sink = softmax_offset.reshape(hq)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, sink)):
        return _FlashAttention.apply(q, k, v, sink, q_seqlens, kv_seqlens,
                                     float(scale), mask_type.is_causal,
                                     offset, window)
    return flash_fwd(q, k, v, q_seqlens, kv_seqlens, scale=scale,
                     causal=mask_type.is_causal, offset=offset,
                     window=window, softmax_sink=sink)[0]
