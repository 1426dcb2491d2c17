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
reference) are masked on both sides, segment ids of packed documents
((B, S) int32 ``q_segment_ids`` and ``kv_segment_ids``: query i sees key
j when their ids are equal and not 0, any ids in any order), and a static
sliding window ``(left, right)``: key j is visible to query i when ``i +
offset - left <= j <= i + offset + right``, each side where it is >= 0
(the reference's ``_mask_scores``; the causal rule and the window compare
indices, also in a packed row). The terms compose. GQA takes Hq % Hkv ==
0.

Softmax sink (``softmax_type`` OFF_BY_ONE or LEARNABLE): one virtual key
per query head with logit ``sink`` and no value joins the denominator at
the end of the forward (the reference's ``_fwd_write_out``), so a row
with no visible key writes O = 0 and LSE = sink. The backward kernels
need nothing for it (the LSE carries it); its gradient ``dsink = -sum
exp(sink - LSE) * rowsum(dO * O)`` over batch and queries is computed
outside them, as the reference's ``_flash_core_bwd`` does.

FP8 (the reference's ``_fp8_core`` and ``_fp8_mha_core``): with
``scale_invs`` the kernels take per-tensor-scaled e4m3 Q/K/V payloads and
the (3,) f32 dequantization multipliers ``[sq_inv, sk_inv, sv_inv]`` as a
device tensor (no host read). q is not pre-scaled: the scores are
multiplied by ``smult = sq_inv * sk_inv * scale * log2(e)`` before the
mask, p (and in the backward ds) rounds to bf16 before its product with a
payload, and V's ``sv_inv`` multiplies the accumulator at write-out. The
forward writes O in a high-precision dtype, or (``out_scale``, fp8_mha
under delayed scaling) casts ``O * out_scale`` to fp8 in its epilogue,
saturating, and returns the amax of O before the cast. The backward
takes a high-precision dO, or fp8 O and dO payloads with ``o_scale_inv``
and ``do_scale_inv``: ``delta`` is computed on the payloads times ``so *
sdo``, dp takes ``sv_inv * sdo``, and the epilogues multiply dQ by
``scale * sk_inv``, dK by ``scale * sq_inv`` and dV by ``sdo``. Every
product is exact in f32 (e4m3 x e4m3, bf16 x e4m3 and bf16 x e5m2 fit its
mantissa), so kernel and plain version differ in summation order alone.
:func:`flash_attention` takes ``qkv_quantizers`` (Q/K/V quantized inside
the autograd function) and ``mha_proj`` (the output projection and its
gradients inside it too, on the fp8 O and dO payloads).

Post-scale bias (the reference's ``bias``): a (B or 1, Hq, Sq, Skv) f32
or bf16 tensor added to the natural-domain scores, ``bias * log2(e)`` in
f32 on the pre-scaled exp2-domain scores, before the mask; a first
dimension of 1 broadcasts over the batch. The backward also returns dbias,
the per-batch f32 ``ds`` (B, Hq, Sq, Skv) before its rounding, 0 wherever
a pair is masked; the autograd function sums it over a broadcast batch and
casts it to the bias's dtype, as the reference's ``_flash_core_bwd``
does. ALiBi (``score_mod=``:class:`~..flex_attention.AlibiMod`, or an
:class:`~..flex_attention.AlibiSlopesMod` with explicit (Hq,) slopes): q is
not pre-scaled; the kernels compute ``(s * scale - slope_h * |i + offset -
j|) * log2(e)`` from an (Hq,) f32 slopes vector that the wrapper makes
once and both the kernels and the plain versions read, and dQ and dK both
take ``scale`` as their multiplier (the mod's VJP is the identity).

Soft cap (``score_mod=``:class:`~..flex_attention.SoftCapMod`, the
reference's ``soft_cap_mod``, Gemma-2's logit cap): q is not pre-scaled;
each score becomes ``cap * tanh(s * scale / cap) * log2(e)`` in the order
of the reference's jaxpr (a true division by ``cap``, then ``tanh``), and
the backward multiplies ds by the mod's VJP before ds is rounded, in the
order of JAX's transpose of its ``tanh`` rule: ``w = (cap * ds) * (1 - t)``,
then ``(w + w * t) / cap`` with ``t`` the forward's tanh (never ``1 -
t^2``, which cancels where t saturates); dQ and dK take ``scale``. A bias,
ALiBi or the cap (one of them) composes with the masks, the window, the
sink and dropout, and with neither FP8 branch; no other score mod runs in
the kernels (:func:`~..flex_attention.flex_attention` runs the others).

Dropout (the reference's ``dropout_rate`` branch, ``_dropout_keep``): with
``dropout_probability`` > 0 and ``dropout_seed``, the two 32-bit words of
the reference's seed as a (2,) int32 tensor that the kernels read on the
card, each visible score keeps or drops by the reference's integer hash of
(seed, batch, kv head, the reference's tile origin and the score's row
and column within that tile). The tiles are the reference's
(``_effective_blocks`` of ``block_q`` and ``block_k``); they decide the
bits alone, never the CUDA tiles. The denominator sums the undropped
weights; the PV product takes ``where(keep, p * inv, 0)`` with ``inv =
1 / (1 - rate)`` rounded to f32, and the backward applies the same mask
to dp (dQ, dK) and to the weights of dV, so the forward's mask is replayed
and never stored. :func:`dropout_keep` is the plain mask. FP8 Q/K/V take
dropout too (the reference's ``_fp8_core`` and ``_fp8_mha_core`` pass the
seed through): the weights round to bf16 after the mask, and the autograd
functions pass the forward's seed and tiles to the backward.

A launch counts under a name that says its branch: ``_fp8`` for FP8
Q/K/V, ``_fp8_mha`` for the fp8 O epilogue and for a backward from fp8 O
and dO, ``_bias`` with a bias, ``_alibi`` with ALiBi and ``_softcap`` with
the soft cap, ``_dropout`` with dropout, then ``_sw`` with a window or a sink
(``flash_attention_fwd_sw``, ``flash_attention_bwd_dq_fp8_sw``,
``flash_attention_bwd_dkv_fp8_mha``, ``flash_attention_fwd_bias_sw``,
``flash_attention_fwd_bias_dropout``), and ``_seg`` last with segment ids
(``flash_attention_fwd_seg``, ``flash_attention_bwd_dq_fp8_mha_seg``), so
a path can show which branch it ran.
"""
from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Optional, Tuple

import torch

from .. import _build
from ..attention import AttnMaskType, SoftmaxType
from ..flex_attention import AlibiMod, SoftCapMod
from ..quantize.dtypes import is_fp8_dtype
from ..quantize.qmath import saturate_cast
from ..quantize.quantizer import DelayedScaleQuantizer, QuantizeLayout
from ..quantize.tensor import ScaledTensor1x
from .gemm import q_dot

NEG_INF = -1e30
MASKED = -2e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

NO_WINDOW = (-1, -1)

# The reference's tile geometry (its DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K and
# MAX_ROWS defaults): the port's kernels tile otherwise, and these decide
# the dropout bits alone.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
MAX_ROWS = 1024

# Arguments of the reference function that this port does not take yet
# (ROADMAP.md lists them; with the dynamic window they wait for ring
# attention, their one consumer); passing any of them raises.
_UNPORTED = ("q_position_offset",)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _effective_blocks(sq: int, skv: int, group: int, block_q: int,
                      block_k: int) -> Tuple[int, int]:
    """The reference's tile sizes for (Sq, Skv) and a GQA group: the
    group's packed rows are capped at MAX_ROWS."""
    block_q = min(block_q, _ceil_to(sq, 8), max(8, MAX_ROWS // max(group, 1)))
    block_k = min(block_k, _ceil_to(skv, 8))
    return block_q, block_k


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Attention dropout at ``rate`` (0 < rate < 1) from ``seed``, the (2,)
    int32 words on the attention's device, with the reference's
    ``block_q`` and ``block_k`` (before :func:`_effective_blocks`)."""
    seed: torch.Tensor
    rate: float
    block_q: int = DEFAULT_BLOCK_Q
    block_k: int = DEFAULT_BLOCK_K

    @property
    def threshold(self) -> int:
        """The reference's keep threshold: keep where bits >= it."""
        return min(4294967295, int(round(self.rate * 4294967296.0)))

    @property
    def inv(self) -> float:
        """1 / (1 - rate) rounded to f32, as the reference's f32 kernel
        takes the Python constant."""
        return float(torch.tensor(1.0 / (1.0 - self.rate),
                                  dtype=torch.float32))

    def blocks(self, sq: int, skv: int, group: int) -> Tuple[int, int]:
        return _effective_blocks(sq, skv, group, self.block_q, self.block_k)


def dropout_seed(seed, device=None) -> torch.Tensor:
    """The reference's two seed words as a contiguous (2,) int32 tensor on
    ``device``: the first two elements of ``seed`` (an integer tensor or
    sequence, zero-padded to two), each taken modulo 2^32."""
    t = seed if isinstance(seed, torch.Tensor) else torch.tensor(seed)
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
        raise TypeError(f"dropout_seed must hold integers, got {t.dtype}")
    if t.shape != (2,):
        t = t.reshape(-1)[:2]
    if t.dtype != torch.int32:
        t = t.to(torch.int64) & 0xFFFFFFFF
        t = torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
    if t.numel() < 2:
        t = torch.cat([t, t.new_zeros(2 - t.numel())])
    if device is not None and t.device != torch.device(device):
        t = t.to(device)
    return t.contiguous()


def _dropout(rate, seed, block_q, block_k, device) -> Optional[Dropout]:
    """The Dropout of a call, or None at rate 0; a rate above 0 needs a
    seed, as the reference's wrapper asks."""
    rate = float(rate or 0.0)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_probability must lie in [0, 1), got {rate}")
    if rate == 0.0:
        return None
    if seed is None:
        raise ValueError("flash attention dropout requires an explicit "
                         "dropout_seed (a silent default would reuse the same "
                         "mask every step)")
    return Dropout(dropout_seed(seed, device), rate, int(block_q),
                   int(block_k))


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant,
    each partial product below 2^49."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep(seed: torch.Tensor, b: int, hq: int, hkv: int, sq: int,
                 skv: int, rate: float, block_q: int = DEFAULT_BLOCK_Q,
                 block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """The plain keep mask (B, Hq, Sq, Skv) bool on ``seed``'s device:
    the reference's ``_dropout_keep`` hash (its off-TPU branch) of query i,
    key j and query head h, with group G = Hq / Hkv and its tiles (bq, bk)
    = ``_effective_blocks(Sq, Skv, G, block_q, block_k)``: row (h % G) *
    bq + i % bq and column j % bk of the tile at (i - i % bq, j - j % bk)
    of (batch, h / G). Computed one (batch, kv head) at a time in int64,
    every product kept exact below 2^63 and taken modulo 2^32."""
    g = hq // hkv
    bq, bk = _effective_blocks(sq, skv, g, block_q, block_k)
    thr = Dropout(seed, rate).threshold
    dev = seed.device
    words = seed.to(torch.int64) & _M32
    i = torch.arange(sq, dtype=torch.int64, device=dev)
    j = torch.arange(skv, dtype=torch.int64, device=dev)
    rows = (torch.arange(g, dtype=torch.int64, device=dev)[:, None] * bq
            + (i % bq)[None, :])
    r_hash = _mul32(rows, 0x9E3779B9)[:, :, None]                # (G, Sq, 1)
    c_hash = _mul32(j % bk, 0x85EBCA6B)[None, None, :]           # (1, 1, Skv)
    q_part = _mul32(i - i % bq, 0x9E3779B1)[None, :, None]
    k_part = _mul32(j - j % bk, 0x85EBCA77)[None, None, :]
    seed_part = _mul32(words[0], 0xC2B2AE35) + words[1]
    keep = torch.empty((b, hkv, g, sq, skv), dtype=torch.bool, device=dev)
    for bi in range(b):
        for hk in range(hkv):
            base = (seed_part + bi * 0x27D4EB2F + hk * 0x165667B1) & _M32
            x = (r_hash ^ c_hash) ^ ((base + q_part + k_part) & _M32)
            x = x ^ (x >> 16)
            x = _mul32(x, 0x7FEB352D)
            x = x ^ (x >> 15)
            x = _mul32(x, 0x846CA68B)
            keep[bi, hk] = (x ^ (x >> 16)) >= thr
    return keep.reshape(b, hq, sq, skv)


def _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
             device, q_segment_ids=None, kv_segment_ids=None):
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
    if q_segment_ids is not None:
        qs = q_segment_ids[:, :, None]
        mask = mask & (qs == kv_segment_ids[:, None, :]) & (qs != 0)
    return mask


def _score_terms(s, bias, alibi_slopes, scale, offset, soft_cap=None):
    """(the exp2-domain scores (B, Hkv, G, Sq, Skv), the soft cap's tanh
    or None) after a bias (``s`` from pre-scaled q: ``s + bias *
    log2(e)``), ALiBi (``s`` from unscaled q: ``(s * scale - slope_h * |i
    + offset - j|) * log2(e)``) or the soft cap (``s`` from unscaled q:
    ``cap * tanh(s * scale / cap) * log2(e)``), in the reference's order of
    f32 operations."""
    b, hkv, g, sq, skv = s.shape
    if bias is not None:
        bb = bias.float().reshape(bias.shape[0], hkv, g, sq, skv)
        return s + bb * LOG2E, None
    if alibi_slopes is not None:
        qpos = torch.arange(sq, device=s.device)[:, None] + offset
        kpos = torch.arange(skv, device=s.device)[None, :]
        dist = (qpos - kpos).abs().to(torch.float32)
        slope = alibi_slopes.float().reshape(1, hkv, g, 1, 1)
        return (s * scale - slope * dist) * LOG2E, None
    if soft_cap is not None:
        # A true division by a tensor on s's device (a Python number would
        # take CUDA's product with its reciprocal).
        th = torch.tanh(s * scale / _cap_tensor(soft_cap, s.device))
        return soft_cap * th * LOG2E, th
    return s, None


def _cap_tensor(cap: float, device) -> torch.Tensor:
    return torch.full((), cap, dtype=torch.float32, device=device)


def _soft_cap_grad(ds, th, cap: float):
    """The soft cap's VJP of f32 ``ds`` from the forward's tanh ``th``, in
    the order of JAX's transpose of its tanh rule: ``w = (cap * ds) * (1 -
    t)``, then ``(w + w * t) / cap``, each product and sum rounded on its
    own."""
    w = (ds * cap) * (1.0 - th)
    return (w + w * th) / _cap_tensor(cap, ds.device)


def _drop(x, dropout: Dropout, b, hq, hkv, sq, skv):
    """``where(keep, x * inv, 0)`` over (B, Hkv, G, Sq, Skv) f32 ``x``."""
    keep = dropout_keep(dropout.seed, b, hq, hkv, sq, skv, dropout.rate,
                        dropout.block_q, dropout.block_k)
    # inv is an f32 value, so the f32 product rounds once, as the
    # reference's; no host-to-card copy (the card's timer captures this).
    return torch.where(keep.reshape(x.shape), x * dropout.inv,
                       torch.zeros((), device=x.device))


def flash_fwd_plain(q, k, v, q_seqlens=None, kv_seqlens=None, *,
                    causal: bool, offset: int = 0, window=NO_WINDOW,
                    softmax_sink=None, fp8_scales=None, out_dtype=None,
                    q_segment_ids=None, kv_segment_ids=None, bias=None,
                    alibi_slopes=None, scale: float = 1.0,
                    dropout: Optional[Dropout] = None,
                    soft_cap: Optional[float] = None):
    """Reference forward. Without ``fp8_scales`` ``q`` arrives pre-scaled
    by scale * log2(e) and O takes q's dtype. With them (the FP8 branch)
    q, k and v are payloads and ``fp8_scales`` is :func:`fp8_fwd_scales`'
    [smult, sv_inv, out_scale]; O takes ``out_dtype``, and an fp8
    ``out_dtype`` casts O * out_scale and returns the amax of O as a
    third output. ``bias`` (B or 1, Hq, Sq, Skv) is added to the
    pre-scaled scores; with ``alibi_slopes`` (Hq,) or ``soft_cap`` q
    arrives unscaled and ``scale`` is the softmax scale. With ``dropout``
    the denominator sums
    the undropped weights and the PV product takes ``where(keep, p * inv,
    0)`` (:func:`dropout_keep`)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    fp8 = fp8_scales is not None
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(b, sq, hkv, g, d), k.float())
    if fp8:
        s = s * fp8_scales[0]
    s, _ = _score_terms(s, bias, alibi_slopes, scale, offset, soft_cap)
    mask = _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
                    q.device, q_segment_ids, kv_segment_ids)
    s = torch.where(mask[:, None, None], s, MASKED)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout is not None:
        p = _drop(p, dropout, b, hq, hkv, sq, skv)
    p_dtype = torch.bfloat16 if fp8 else v.dtype
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), v.float())
    if fp8:
        acc = acc * fp8_scales[1]
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
    lse = lse.reshape(b, hq, sq)
    out_dtype = out_dtype or q.dtype
    if is_fp8_dtype(out_dtype):
        return saturate_cast(o * fp8_scales[2], out_dtype), lse, \
            o.abs().amax()
    return o.to(out_dtype), lse


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


def _branch(fp8: bool, fp8_mha: bool, window, softmax_sink,
            segments: bool, bias=None, slopes=None, dropout=None,
            cap=None) -> str:
    """The launch count's suffix of a branch: "_fp8" for FP8 Q/K/V,
    "_fp8_mha" with fp8 O (and dO), "_bias" with a bias, "_alibi" with
    ALiBi and "_softcap" with the soft cap, "_dropout" with dropout, then
    :func:`_sw`'s, then "_seg" with segment ids."""
    return (("_fp8_mha" if fp8_mha else "_fp8" if fp8 else "")
            + ("_bias" if bias is not None else "")
            + ("_alibi" if slopes is not None else "")
            + ("_softcap" if cap is not None else "")
            + ("_dropout" if dropout is not None else "")
            + _sw(window, softmax_sink) + ("_seg" if segments else ""))


def _dropout_args(dropout: Optional[Dropout], sq: int, skv: int,
                  group: int) -> tuple:
    """The kernels' (seed, threshold, inv, block_q, block_k), or a null
    seed without dropout."""
    if dropout is None:
        return (_build.ptr(None), 0, 1.0, 0, 0)
    return (_build.ptr(dropout.seed), dropout.threshold, dropout.inv,
            *dropout.blocks(sq, skv, group))


def _check_score_terms(q, k, bias, score_mod, fp8: bool):
    """(the ALiBi slopes (Hq,) f32 on q's device or None, the soft cap or
    None); raises for what the kernels do not take: a bias not (B or 1,
    Hq, Sq, Skv) in f32 or bf16, a bias with a score mod, either with FP8
    Q/K/V, a cap that is not finite and positive, and any score mod other
    than ALiBi and the soft cap (``flex_attention(impl="chunked")`` runs
    any mod)."""
    if score_mod is not None and not isinstance(score_mod,
                                                (AlibiMod, SoftCapMod)):
        raise NotImplementedError(
            "the flash kernels run ALiBi and the soft cap (flex_attention's "
            "alibi_arith_mod, alibi_mod and soft_cap_mod); other score mods "
            "are not ported to them: flex_attention(impl=\"chunked\") runs "
            "any mod")
    if bias is not None and score_mod is not None:
        raise ValueError("score_mod and bias are mutually exclusive")
    if fp8 and (bias is not None or score_mod is not None):
        raise ValueError("FP8 flash attention takes no bias or score_mod")
    if bias is not None:
        b, sq, hq = q.shape[:3]
        want = (hq, sq, k.shape[1])
        if bias.dim() != 4 or bias.shape[0] not in (1, b) or \
                tuple(bias.shape[1:]) != want:
            raise ValueError(f"bias must be (B or 1, Hq, Sq, Skv) with B={b}"
                             f" and (Hq, Sq, Skv) = {want}, got "
                             f"{tuple(bias.shape)}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the bias must be f32 or bf16, got {bias.dtype}")
    if score_mod is None:
        return None, None
    if isinstance(score_mod, SoftCapMod):
        cap = score_mod.cap
        if not (math.isfinite(cap) and cap > 0.0):
            raise ValueError(f"the flash kernels take a finite soft cap "
                             f"above 0, got {cap}")
        return None, cap
    return score_mod.slopes(q.shape[2], q.device), None


def fp8_fwd_scales(scale_invs: torch.Tensor, scale: float,
                   out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward's (3,) f32 multipliers from the payloads' dequant
    scales ``[sq_inv, sk_inv, sv_inv]``: the score multiplier ``smult =
    sq_inv * sk_inv * scale * log2(e)``, V's ``sv_inv`` and the fp8 O
    epilogue's scale (1 without one), on the scales' device."""
    sq_inv, sk_inv, sv_inv = scale_invs.float().reshape(3).unbind()
    oscale = (out_scale.float().reshape(()) if out_scale is not None
              else sv_inv.new_ones(()))
    return torch.stack([sq_inv * sk_inv * (scale * LOG2E), sv_inv, oscale])


def fp8_bwd_scales(scale_invs: torch.Tensor, scale: float,
                   sdo: torch.Tensor) -> torch.Tensor:
    """The backward's (5,) f32 multipliers: ``[smult, sv_inv * sdo, scale
    * sk_inv, scale * sq_inv, sdo]`` (the score multiplier, dp's, dQ's,
    dK's and dV's), with ``sdo`` dO's dequant scale (1 for a
    high-precision dO)."""
    sq_inv, sk_inv, sv_inv = scale_invs.float().reshape(3).unbind()
    sdo = sdo.float().reshape(())
    return torch.stack([sq_inv * sk_inv * (scale * LOG2E), sv_inv * sdo,
                        scale * sk_inv, scale * sq_inv, sdo])


def _check_qkv(q, k, v, q_seqlens, kv_seqlens, q_segment_ids=None,
               kv_segment_ids=None) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected BSHD q, k, v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")
    if (q_seqlens is None) != (kv_seqlens is None):
        raise ValueError("give both q_seqlens and kv_seqlens, or neither")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both q_segment_ids and kv_segment_ids, or "
                         "neither")
    if q_segment_ids is not None:
        if q_seqlens is not None:
            raise ValueError("give segment ids or lengths, not both")
        want = ((q.shape[0], q.shape[1]), (k.shape[0], k.shape[1]))
        got = (tuple(q_segment_ids.shape), tuple(kv_segment_ids.shape))
        if got != want:
            raise ValueError(f"segment ids must be (B, Sq) and (B, Skv) = "
                             f"{want}, got {got}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")


def _check_fp8(q, scale_invs) -> None:
    """The FP8 branch takes e4m3 Q/K/V payloads (what the reference's
    fp8_dpa quantizers make) and their three dequant scales."""
    if q.dtype != torch.float8_e4m3fn:
        raise TypeError(f"FP8 flash attention takes e4m3 Q/K/V payloads, "
                        f"got {q.dtype}")
    if scale_invs.numel() != 3:
        raise ValueError(f"scale_invs must hold [sq_inv, sk_inv, sv_inv], "
                         f"got {tuple(scale_invs.shape)}")


def _int32(*tensors):
    """The kernels' int32 lengths or segment ids (None stays None)."""
    return tuple(None if t is None else t.to(torch.int32).contiguous()
                 for t in tensors)


def _check_head_dim(d: int) -> None:
    if d % 16 or d > 256:
        raise ValueError(f"the flash kernels take D % 16 == 0 and D <= 256, "
                         f"got {d}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_seqlens: Optional[torch.Tensor] = None,
              kv_seqlens: Optional[torch.Tensor] = None, *,
              scale: float, causal: bool, offset: int = 0,
              window=NO_WINDOW, softmax_sink: Optional[torch.Tensor] = None,
              scale_invs: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              out_scale: Optional[torch.Tensor] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, score_mod=None,
              dropout_probability: float = 0.0,
              dropout_seed: Optional[torch.Tensor] = None,
              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """O (B, Sq, Hq, D) and LSE (B, Hq, Sq) f32.

    ``q_seqlens`` / ``kv_seqlens`` (B,) give each sequence's valid
    lengths (both or neither); ``q_segment_ids`` / ``kv_segment_ids``
    (B, Sq) and (B, Skv) the ids of packed documents (both or neither,
    and not with lengths): a query with id 0 or no visible key writes O
    = 0 and LSE = -1e30 (the sink with one); ``offset`` shifts the causal
    diagonal and the window (key j is visible to query i when j <= i +
    offset);
    ``window`` is a static (left, right), -1 for an inactive side;
    ``softmax_sink`` the (Hq,) sink logits, or None. ``bias`` (B or 1,
    Hq, Sq, Skv), f32 or bf16, is a post-scale bias; ``score_mod`` an
    :class:`~..flex_attention.AlibiMod` (ALiBi) or
    :class:`~..flex_attention.SoftCapMod` (the soft cap), or None.
    ``dropout_probability`` > 0 drops attention weights by the hash of
    ``dropout_seed`` (the reference's two words, (2,) int32) over the
    reference's ``block_q`` x ``block_k`` tiles, FP8 included.

    FP8 (the reference's ``_flash_fwd`` with ``scale_invs``): q, k and v
    are e4m3 payloads and ``scale_invs`` their (3,) f32 dequant scales;
    O takes ``out_dtype`` (bf16 by default, or f32). With ``out_scale``
    (a (1,) f32 tensor) O is cast to the fp8 ``out_dtype`` (e4m3 by
    default) in the epilogue, and the amax of O before the cast (an f32
    scalar tensor) comes back as a third output. Without ``scale_invs``
    O takes q's dtype."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens, q_segment_ids, kv_segment_ids)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    window = _window(window)
    if softmax_sink is not None and softmax_sink.numel() != hq:
        raise ValueError(f"softmax_sink must hold Hq={hq} values, got "
                         f"{tuple(softmax_sink.shape)}")
    fp8 = scale_invs is not None
    fp8_out = out_scale is not None
    slopes, cap = _check_score_terms(q, k, bias, score_mod, fp8)
    drop = _dropout(dropout_probability, dropout_seed, block_q, block_k,
                    q.device)
    if fp8_out and not fp8:
        raise ValueError("the fp8 O epilogue takes FP8 Q/K/V payloads")
    if fp8:
        _check_fp8(q, scale_invs)
        out_dtype = out_dtype or (torch.float8_e4m3fn if fp8_out
                                  else torch.bfloat16)
        if is_fp8_dtype(out_dtype) != fp8_out:
            raise ValueError("an fp8 O takes an out_scale, and out_scale an "
                             "fp8 out_dtype")
        qs, sc = q, fp8_fwd_scales(scale_invs, scale, out_scale)
    else:
        if out_dtype not in (None, q.dtype):
            raise ValueError("O takes q's dtype outside the FP8 branch")
        out_dtype = q.dtype
        sc = None
        qs = q if slopes is not None or cap is not None else \
            (q.float() * (scale * LOG2E)).to(q.dtype)
    if _build.on_cpu(q, k, v, q_seqlens, kv_seqlens, softmax_sink,
                     scale_invs, out_scale, q_segment_ids, kv_segment_ids,
                     bias, drop and drop.seed):
        return flash_fwd_plain(qs, k, v, q_seqlens, kv_seqlens,
                               causal=causal, offset=offset, window=window,
                               softmax_sink=softmax_sink, fp8_scales=sc,
                               out_dtype=out_dtype,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, bias=bias,
                               alibi_slopes=slopes, scale=scale,
                               dropout=drop, soft_cap=cap)
    code = _build.dtype_code(q, (torch.float32, torch.bfloat16,
                                 torch.float8_e4m3fn))
    out_code = _build.DTYPE_CODES[out_dtype]
    _check_head_dim(d)
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    q_seqlens, kv_seqlens, qseg, kseg = _int32(q_seqlens, kv_seqlens,
                                               q_segment_ids, kv_segment_ids)
    sink = (softmax_sink.float().reshape(hq).contiguous()
            if softmax_sink is not None else None)
    amax = torch.zeros((1,), dtype=torch.float32, device=q.device) \
        if fp8_out else None
    bias = bias.contiguous() if bias is not None else None
    _build.check_aligned(qs, k, v, sink, sc, bias, slopes)
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    P = _build.ptr
    _build.launch("te_flash_attention_fwd", P(qs), P(k), P(v), code, P(o),
                  out_code, P(lse), P(q_seqlens), P(kv_seqlens), P(qseg),
                  P(kseg), P(sink), P(sc), P(amax), P(bias),
                  *_bias_args(bias), P(slopes), b, sq, skv, hq, hkv, d,
                  int(causal), offset, window[0], window[1], float(scale),
                  float(cap or 0.0), *_dropout_args(drop, sq, skv, hq // hkv),
                  _build.stream(q))
    _build.LAUNCHES["flash_attention_fwd" + _branch(
        fp8, fp8_out, window, sink, qseg is not None, bias, slopes,
        drop, cap)] += 1
    if fp8_out:
        return o, lse, amax.reshape(())
    return o, lse


def _bias_args(bias) -> tuple:
    """The kernels' (bias dtype code, bias batch) for ``bias`` or None."""
    if bias is None:
        return (-1, 0)
    return (_build.DTYPE_CODES[bias.dtype], bias.shape[0])


def flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens=None,
                    kv_seqlens=None, *, scale: float, causal: bool,
                    offset: int = 0, window=NO_WINDOW, fp8_scales=None,
                    grad_dtype=None, q_segment_ids=None,
                    kv_segment_ids=None, bias=None, alibi_slopes=None,
                    dropout: Optional[Dropout] = None,
                    soft_cap: Optional[float] = None):
    """Reference backward; ``delta`` is rowsum(dO * O) (B, Sq, Hq) f32.
    Without ``fp8_scales`` ``qs`` arrives pre-scaled by scale * log2(e)
    and each gradient takes its input's dtype. With them (the FP8 branch)
    ``qs``, k and v are payloads, do a payload or a high-precision
    tensor, ``fp8_scales`` :func:`fp8_bwd_scales`' five multipliers, and
    the gradients take ``grad_dtype``. With ``bias`` (q pre-scaled) a
    fourth output is dbias, the per-batch f32 ds (B, Hq, Sq, Skv); with
    ``alibi_slopes`` or ``soft_cap`` q arrives unscaled and dK takes
    ``scale``, and the cap's VJP multiplies ds before its rounding. With
    ``dropout`` the forward's mask applies to dp and to the weights of
    dV."""
    b, sq, hq, d = qs.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    fp8 = fp8_scales is not None
    qf = qs.float().reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if fp8:
        s = s * fp8_scales[0]
    s, th = _score_terms(s, bias, alibi_slopes, scale, offset, soft_cap)
    mask = _visible(sq, skv, q_seqlens, kv_seqlens, causal, offset, window,
                    qs.device, q_segment_ids, kv_segment_ids)
    lse2 = (lse.float() * LOG2E).reshape(b, hkv, g, sq, 1)
    p = torch.where(mask[:, None, None], torch.exp2(s - lse2),
                    torch.zeros((), device=qs.device))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    if fp8:
        dp = dp * fp8_scales[1]
    pd = p
    if dropout is not None:
        pd = _drop(p, dropout, b, hq, hkv, sq, skv)
        dp = _drop(dp, dropout, b, hq, hkv, sq, skv)
    dl = delta.float().permute(0, 2, 1).reshape(b, hkv, g, sq, 1)
    ds = p * (dp - dl)
    if th is not None:
        ds = _soft_cap_grad(ds, th, soft_cap)
    if fp8:
        ds_t = p_t = torch.bfloat16
        dq_mult, dk_mult, dv_mult = fp8_scales[2], fp8_scales[3], \
            fp8_scales[4]
    else:
        ds_t, p_t = qs.dtype, v.dtype
        dq_mult, dv_mult = scale, 1.0
        dk_mult = scale if alibi_slopes is not None or \
            soft_cap is not None else LN2
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(ds_t).float(),
                      k.float()) * dq_mult
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(ds_t).float(), qf) * dk_mult
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pd.to(p_t).float(), dof) * dv_mult
    dq = dq.reshape(b, sq, hq, d)
    if fp8:
        return dq.to(grad_dtype), dk.to(grad_dtype), dv.to(grad_dtype)
    grads = dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if bias is not None:
        return (*grads, ds.reshape(b, hq, sq, skv))
    return grads


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              q_seqlens: Optional[torch.Tensor] = None,
              kv_seqlens: Optional[torch.Tensor] = None, *,
              scale: float, causal: bool, offset: int = 0,
              window=NO_WINDOW, softmax_sink: Optional[torch.Tensor] = None,
              scale_invs: Optional[torch.Tensor] = None,
              grad_dtype: Optional[torch.dtype] = None,
              o_scale_inv: Optional[torch.Tensor] = None,
              do_scale_inv: Optional[torch.Tensor] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, score_mod=None,
              dropout_probability: float = 0.0,
              dropout_seed: Optional[torch.Tensor] = None,
              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """(dQ, dK, dV) of :func:`flash_fwd` for the output gradient ``do``,
    from its inputs (q unscaled), O and LSE and the forward's mask
    (lengths or segment ids); each in its input's dtype and shape. A
    query with no visible key gets dQ = 0 and adds nothing to dK or
    dV. ``softmax_sink`` is the forward's: the kernels need only
    the LSE, which holds it, and it names the launch counts
    (:func:`sink_grad` gives its gradient). With the forward's ``bias``
    a fourth output is dbias, the per-batch f32 ``ds`` (B, Hq, Sq, Skv),
    0 wherever a pair is masked or its tile skipped; ``score_mod`` is the
    forward's ALiBi or soft cap, and the dropout arguments the forward's
    (its mask is recomputed, not stored), FP8 included.

    FP8 (the reference's ``_flash_bwd`` with ``scale_invs``): q, k and v
    are the forward's e4m3 payloads; O and dO are high-precision, or
    (fp8_mha) fp8 payloads with the (1,) f32 dequant scales
    ``o_scale_inv`` and ``do_scale_inv``. The gradients take
    ``grad_dtype`` (dO's dtype by default)."""
    _check_qkv(q, k, v, q_seqlens, kv_seqlens, q_segment_ids, kv_segment_ids)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"expected O and dO like q {tuple(q.shape)} and LSE "
                         f"(B, Hq, Sq), got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    window = _window(window)
    fp8 = scale_invs is not None
    fp8_mha = o_scale_inv is not None or do_scale_inv is not None
    slopes, cap = _check_score_terms(q, k, bias, score_mod, fp8)
    drop = _dropout(dropout_probability, dropout_seed, block_q, block_k,
                    q.device)
    if fp8_mha and not fp8:
        raise ValueError("fp8 O and dO payloads take FP8 Q/K/V payloads")
    delta = (do.float() * o.float()).sum(dim=-1)
    if fp8:
        _check_fp8(q, scale_invs)
        one = scale_invs.new_ones((), dtype=torch.float32)
        sdo = do_scale_inv.float().reshape(()) if do_scale_inv is not None \
            else one
        if fp8_mha:
            so = o_scale_inv.float().reshape(()) if o_scale_inv is not None \
                else one
            delta = delta * (so * sdo)
        grad_dtype = grad_dtype or (torch.bfloat16 if is_fp8_dtype(do.dtype)
                                    else do.dtype)
        qs, sc = q, fp8_bwd_scales(scale_invs, scale, sdo)
    else:
        sc, grad_dtype = None, q.dtype
        qs = q if slopes is not None or cap is not None else \
            (q.float() * (scale * LOG2E)).to(q.dtype)
    if _build.on_cpu(q, k, v, o, lse, do, q_seqlens, kv_seqlens, scale_invs,
                     o_scale_inv, do_scale_inv, q_segment_ids,
                     kv_segment_ids, bias, drop and drop.seed):
        return flash_bwd_plain(qs, k, v, do, lse, delta, q_seqlens,
                               kv_seqlens, scale=scale, causal=causal,
                               offset=offset, window=window, fp8_scales=sc,
                               grad_dtype=grad_dtype,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, bias=bias,
                               alibi_slopes=slopes, dropout=drop,
                               soft_cap=cap)
    code = _build.dtype_code(q, (torch.float32, torch.bfloat16,
                                 torch.float8_e4m3fn))
    _check_head_dim(d)
    if not fp8:
        do = do.to(q.dtype)
    if grad_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernels write f32 or bf16 gradients, "
                        f"got {grad_dtype}")
    do_code, g_code = (_build.DTYPE_CODES[do.dtype],
                       _build.DTYPE_CODES[grad_dtype])
    do = do.contiguous()
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    lse2 = (lse.float() * LOG2E).contiguous()
    q_seqlens, kv_seqlens, qseg, kseg = _int32(q_seqlens, kv_seqlens,
                                               q_segment_ids, kv_segment_ids)
    bias = bias.contiguous() if bias is not None else None
    _build.check_aligned(qs, k, v, do, lse2, delta, sc, bias, slopes)
    dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=grad_dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=grad_dtype, device=q.device)
    # The dQ kernel writes every element of dbias, zeros included.
    dbias = (torch.empty((b, hq, sq, skv), dtype=torch.float32,
                         device=q.device) if bias is not None else None)
    P, st = _build.ptr, _build.stream(q)
    left, right = window
    name = _branch(fp8, fp8_mha, window, softmax_sink, qseg is not None,
                   bias, slopes, drop, cap)
    terms = (P(bias), *_bias_args(bias), P(slopes))
    drop_args = _dropout_args(drop, sq, skv, hq // hkv)
    _build.launch("te_flash_attention_bwd_dq", P(qs), P(k), P(v), code,
                  P(do), do_code, P(lse2), P(delta), P(dq), g_code,
                  P(q_seqlens), P(kv_seqlens), P(qseg), P(kseg), P(sc),
                  *terms, P(dbias), b, sq, skv, hq, hkv, d, int(causal),
                  offset, left, right, float(scale), float(cap or 0.0),
                  *drop_args, st)
    _build.LAUNCHES["flash_attention_bwd_dq" + name] += 1
    _build.launch("te_flash_attention_bwd_dkv", P(qs), P(k), P(v), code,
                  P(do), do_code, P(lse2), P(delta), P(dk), P(dv), g_code,
                  P(q_seqlens), P(kv_seqlens), P(qseg), P(kseg), P(sc),
                  *terms, b, sq, skv, hq, hkv, d, int(causal), offset, left,
                  right, float(scale), float(cap or 0.0), *drop_args, st)
    _build.LAUNCHES["flash_attention_bwd_dkv" + name] += 1
    if dbias is not None:
        return dq, dk, dv, dbias
    return dq, dk, dv


def sink_grad(softmax_sink: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, delta_scale=None) -> torch.Tensor:
    """The sink's gradient, (Hq,) in its dtype: ``-sum_{b,q} exp(sink -
    LSE) * rowsum(dO * O)``, from the forward's O (B, Sq, Hq, D) and LSE
    (B, Hq, Sq); a row with no visible key has O = 0 and adds nothing.
    For fp8 O and dO payloads ``delta_scale`` is ``so * sdo``."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if delta_scale is not None:
        delta = delta * delta_scale
    p_sink = torch.exp(softmax_sink.float().reshape(1, -1, 1) - lse)
    return (-(p_sink * delta.permute(0, 2, 1)).sum(dim=(0, 2))).to(
        softmax_sink.dtype)


def _mask_kw(masks) -> dict:
    """flash_fwd's and flash_bwd's mask arguments from the (q_seqlens,
    kv_seqlens, q_segment_ids, kv_segment_ids) that the autograd
    functions carry."""
    return dict(zip(("q_seqlens", "kv_seqlens", "q_segment_ids",
                     "kv_segment_ids"), masks))


def _dropout_kw(drop: Optional[Dropout]) -> dict:
    """flash_fwd's and flash_bwd's dropout arguments from a Dropout."""
    if drop is None:
        return {}
    return dict(dropout_probability=drop.rate, dropout_seed=drop.seed,
                block_q=drop.block_q, block_k=drop.block_k)


class _FlashAttention(torch.autograd.Function):
    """O = flash_fwd(q, k, v); the backward runs :func:`flash_bwd` from
    the saved q, k, v, O, LSE, bias and mask (and the dropout seed, whose
    mask it replays), :func:`sink_grad` for a sink, and reduces dbias over
    a broadcast batch in the bias's dtype (the reference's
    ``_flash_core_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, sink, bias, q_seqlens, kv_seqlens,
                q_segment_ids, kv_segment_ids, scale, causal, offset, window,
                score_mod, drop):
        masks = (q_seqlens, kv_seqlens, q_segment_ids, kv_segment_ids)
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal,
                           offset=offset, window=window, softmax_sink=sink,
                           bias=bias, score_mod=score_mod, **_mask_kw(masks),
                           **_dropout_kw(drop))
        ctx.save_for_backward(q, k, v, o, lse, sink, bias, *masks)
        ctx.cfg = (scale, causal, offset, window, score_mod, drop)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, sink, bias, *masks = ctx.saved_tensors
        scale, causal, offset, window, score_mod, drop = ctx.cfg
        dq, dk, dv, *dbias = flash_bwd(
            q, k, v, o, lse, do, scale=scale, causal=causal, offset=offset,
            window=window, softmax_sink=sink, bias=bias, score_mod=score_mod,
            **_mask_kw(masks), **_dropout_kw(drop))
        dsink = (sink_grad(sink, o, lse, do)
                 if sink is not None and ctx.needs_input_grad[3] else None)
        dbias = dbias[0] if dbias and ctx.needs_input_grad[4] else None
        if dbias is not None:
            if bias.shape[0] == 1:
                dbias = dbias.sum(dim=0, keepdim=True)
            dbias = dbias.to(bias.dtype)
        return (dq, dk, dv, dsink, dbias) + (None,) * 10


def _quantize_qkv(quantizers, q, k, v):
    """Q, K and V quantized rowwise by their per-tensor quantizers, and
    their (3,) f32 dequant scales."""
    out = [z.quantize(t, layout=QuantizeLayout.ROWWISE)
           for z, t in zip(quantizers, (q, k, v))]
    scale_invs = torch.cat([t.scale_inv.float().reshape(1) for t in out])
    return out, scale_invs


def _write_back(quantizers, amaxes) -> None:
    """Each delayed-scaling quantizer takes the state that this step's
    amax gives it, in place (the reference's cotangent of the quantizers:
    the updated state); stateless quantizers are left as they are."""
    for z, a in zip(quantizers, amaxes):
        if isinstance(z, DelayedScaleQuantizer) and a is not None:
            z.write_back(z.update(a))


def _fp8_fwd(q, k, v, sink, masks, quantizers, cfg, drop=None):
    """The reference's ``_fp8_core_fwd``: O in q's dtype, and the
    residuals (payloads, dequant scales, O, LSE, amaxes); ``drop`` the
    dropout, or None."""
    scale, causal, offset, window = cfg
    (qq, qk, qv), sinv = _quantize_qkv(quantizers, q, k, v)
    o, lse = flash_fwd(qq.data, qk.data, qv.data, scale=scale,
                       causal=causal, offset=offset, window=window,
                       softmax_sink=sink, scale_invs=sinv, out_dtype=q.dtype,
                       **_mask_kw(masks), **_dropout_kw(drop))
    return o, (qq.data, qk.data, qv.data, sinv, o, lse,
               qq.amax, qk.amax, qv.amax)


class _FP8Attention(torch.autograd.Function):
    """Flash attention on FP8 Q/K/V (the reference's ``_fp8_core``): Q, K
    and V are quantized per tensor inside the function, the kernels take
    the payloads, and the backward writes each delayed quantizer's
    updated state back (a current-scaling one keeps none). With dropout
    the backward replays the forward's mask from its seed."""

    @staticmethod
    def forward(ctx, q, k, v, sink, q_seqlens, kv_seqlens, q_segment_ids,
                kv_segment_ids, quantizers, cfg, drop):
        masks = (q_seqlens, kv_seqlens, q_segment_ids, kv_segment_ids)
        o, res = _fp8_fwd(q, k, v, sink, masks, quantizers, cfg, drop)
        ctx.save_for_backward(*res, sink, *masks)
        ctx.quantizers, ctx.cfg, ctx.drop = quantizers, cfg, drop
        return o

    @staticmethod
    def backward(ctx, do):
        qd, kd, vd, sinv, o, lse, *rest = ctx.saved_tensors
        amaxes, sink, masks = rest[:3], rest[3], rest[4:]
        scale, causal, offset, window = ctx.cfg
        dq, dk, dv = flash_bwd(qd, kd, vd, o, lse, do, scale=scale,
                               causal=causal, offset=offset, window=window,
                               softmax_sink=sink, scale_invs=sinv,
                               grad_dtype=do.dtype, **_mask_kw(masks),
                               **_dropout_kw(ctx.drop))
        dsink = (sink_grad(sink, o, lse, do)
                 if sink is not None and ctx.needs_input_grad[3] else None)
        _write_back(ctx.quantizers, amaxes)
        return (dq, dk, dv, dsink) + (None,) * 7


def _fp8_mha_fwd(q, k, v, w, sink, masks, quantizers, cfg, drop=None):
    """The reference's ``_fp8_mha_core_fwd``: the attention on FP8 Q/K/V
    with an fp8 O (cast in the kernel's epilogue under delayed scaling,
    quantized after it under current scaling), then the output projection
    of the O payload, (B, Sq, N) in q's dtype; and the residuals. ``drop``
    is the dropout, or None."""
    scale, causal, offset, window = cfg
    qq_z, qk_z, qv_z, qo_z, qw_z, _, _ = quantizers
    (qq, qk, qv), sinv = _quantize_qkv((qq_z, qk_z, qv_z), q, k, v)
    kw = dict(scale=scale, causal=causal, offset=offset, window=window,
              softmax_sink=sink, scale_invs=sinv, **_mask_kw(masks),
              **_dropout_kw(drop))
    if isinstance(qo_z, DelayedScaleQuantizer):
        o_pay, lse, o_amax = flash_fwd(qq.data, qk.data, qv.data,
                                       out_dtype=qo_z.q_dtype,
                                       out_scale=qo_z.scale, **kw)
        so_inv = (1.0 / qo_z.scale.float()).reshape(1)
    else:
        o_bf, lse = flash_fwd(qq.data, qk.data, qv.data,
                              out_dtype=torch.bfloat16, **kw)
        qo = qo_z.quantize(o_bf, layout=QuantizeLayout.ROWWISE)
        o_pay, so_inv, o_amax = qo.data, qo.scale_inv.reshape(1), qo.amax
    b, sq, hq, d = q.shape
    # BSHD: O is already (B * Sq, Hq * D) for the projection.
    o_st = ScaledTensor1x(o_pay.reshape(b * sq, hq * d), so_inv, None,
                          q.dtype)
    qw = qw_z.quantize(w, layout=QuantizeLayout.ROWWISE)
    out = q_dot(o_st, qw, 1, 0).reshape(b, sq, w.shape[1]).to(q.dtype)
    return out, (qq.data, qk.data, qv.data, sinv, o_pay, so_inv, lse,
                 qw.data, qw.scale_inv.reshape(1), qq.amax, qk.amax, qv.amax,
                 o_amax, qw.amax)


class _FP8MHA(torch.autograd.Function):
    """Flash attention and the output projection in one function (the
    reference's ``_fp8_mha_core``, recipe flag fp8_mha): the projection
    and its wgrad take the fp8 O payload, the backward quantizes dO once
    and the flash backward kernels read the fp8 O and dO payloads. The
    quantizers are (q, k, v, o, w, g, do); the backward writes each
    delayed one's updated state back, and replays the forward's dropout
    mask from its seed."""

    @staticmethod
    def forward(ctx, q, k, v, w, sink, q_seqlens, kv_seqlens, q_segment_ids,
                kv_segment_ids, quantizers, cfg, drop):
        masks = (q_seqlens, kv_seqlens, q_segment_ids, kv_segment_ids)
        out, res = _fp8_mha_fwd(q, k, v, w, sink, masks, quantizers, cfg,
                                drop)
        ctx.save_for_backward(*res, sink, *masks)
        ctx.quantizers, ctx.cfg, ctx.drop = quantizers, cfg, drop
        ctx.meta = (q.dtype, tuple(w.shape), w.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (qd, kd, vd, sinv, o_pay, so_inv, lse, w_pay, sw_inv,
         *rest) = ctx.saved_tensors
        amaxes, sink, masks = rest[:5], rest[5], rest[6:]
        scale, causal, offset, window = ctx.cfg
        q_dtype, w_shape, w_dtype = ctx.meta
        qg_z, qdo_z = ctx.quantizers[5], ctx.quantizers[6]
        b, sq, hq, d = qd.shape
        qg = qg_z.quantize(g.reshape(b * sq, w_shape[1]),
                           layout=QuantizeLayout.ROWWISE)
        o_st = ScaledTensor1x(o_pay.reshape(b * sq, hq * d), so_inv, None,
                              q_dtype)
        dw = q_dot(o_st, qg, 0, 0).reshape(w_shape).to(w_dtype)
        w_st = ScaledTensor1x(w_pay, sw_inv, None, q_dtype)
        do4 = q_dot(qg, w_st, 1, 1).reshape(b, sq, hq, d).to(torch.bfloat16)
        qdo = qdo_z.quantize(do4, layout=QuantizeLayout.ROWWISE)
        dq, dk, dv = flash_bwd(qd, kd, vd, o_pay, lse, qdo.data, scale=scale,
                               causal=causal, offset=offset, window=window,
                               softmax_sink=sink, scale_invs=sinv,
                               grad_dtype=q_dtype, o_scale_inv=so_inv,
                               do_scale_inv=qdo.scale_inv, **_mask_kw(masks),
                               **_dropout_kw(ctx.drop))
        dsink = None
        if sink is not None and ctx.needs_input_grad[4]:
            dsink = sink_grad(sink, o_pay, lse, qdo.data,
                              so_inv.float().reshape(())
                              * qdo.scale_inv.float().reshape(()))
        _write_back(ctx.quantizers, (*amaxes, qg.amax, qdo.amax))
        return (dq, dk, dv, dw, dsink) + (None,) * 7


def _check_tensor_scaling(quantizers, what: str) -> None:
    for qz in quantizers:
        if not qz.scaling_mode.is_tensor_scaling:
            raise ValueError(f"{what} requires per-tensor scaling quantizers,"
                             f" got {qz.scaling_mode}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sequence_descriptor=None, *, attn_mask_type=None,
                    scaling_factor: Optional[float] = None,
                    window_size: Optional[Tuple[int, int]] = None,
                    softmax_type: Optional[SoftmaxType] = None,
                    softmax_offset: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, score_mod=None,
                    qkv_quantizers=None, mha_proj=None,
                    dropout_probability: float = 0.0, dropout_seed=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    **unported) -> torch.Tensor:
    """Flash attention over BSHD inputs; returns O (B, Sq, Hq, D),
    differentiable in q, k, v, the learnable sink and the bias.

    Masking comes from ``attn_mask_type``, the segment ids or else the
    lengths in ``sequence_descriptor`` (a
    :class:`~..attention.SequenceDescriptor`; its ids mask a packed batch
    whatever the mask type, as the reference's do) and the static
    ``window_size`` (left, right). ``softmax_type``
    OFF_BY_ONE adds a sink of logit 0 to every head, LEARNABLE the (Hq,)
    logits ``softmax_offset``. ``bias`` (B or 1, Hq, Sq, Skv) is a
    post-scale bias; ``score_mod`` ALiBi
    (:func:`~..flex_attention.alibi_arith_mod`, or
    :func:`~..flex_attention.alibi_mod` with (Hq,) slopes) or the soft cap
    (:func:`~..flex_attention.soft_cap_mod`), not with a bias, and neither
    with FP8; any other mod raises (``flex_attention(impl="chunked")``
    runs it).

    ``qkv_quantizers``: a (q, k, v) tuple of per-tensor quantizers (e4m3)
    runs the FP8 branch. ``mha_proj``: ``(w, quantizers)``, the output
    projection's (Hq * D, N) kernel and the seven per-tensor quantizers
    (q, k, v, o, w, g, do), runs the attention and the projection on fp8
    O and dO and returns (B, Sq, N), differentiable in w too. Either way
    a delayed quantizer's state is updated by the backward.

    ``dropout_probability`` > 0 needs ``dropout_seed``: a (2,) int32
    tensor of the reference's two words (``jax.random.key_data`` of its
    key), or a sequence of them. ``block_q`` and ``block_k`` are the
    reference's tile sizes, which decide the dropout bits (and nothing
    else here); FP8 Q/K/V (``qkv_quantizers``, ``mha_proj``) take dropout
    too. The reference's dynamic window (a traced ``window_size``) and
    ``q_position_offset`` are not ported yet and raise: ring attention,
    their one consumer, comes with the parallelism slice."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"flash_attention() got an unexpected argument "
                            f"{name!r}")
        if value is not None:
            raise NotImplementedError(
                f"flash_attention({name}=...) is not ported yet")
    mask_type = attn_mask_type or AttnMaskType.NO_MASK
    masks = (None,) * 4
    desc = sequence_descriptor
    if desc is not None and desc.q_segment_ids is not None:
        masks = (None, None, desc.q_segment_ids, desc.kv_segment_ids)
    elif desc is not None and desc.q_seqlens is not None:
        masks = (desc.q_seqlens, desc.kv_seqlens
                 if desc.kv_seqlens is not None else desc.q_seqlens,
                 None, None)
    if mask_type.is_padding and masks == (None,) * 4:
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
    cfg = (float(scale), mask_type.is_causal, offset, window)
    drop = _dropout(dropout_probability, dropout_seed, block_q, block_k,
                    q.device)
    grad = torch.is_grad_enabled()
    if score_mod is not None and qkv_quantizers is not None:
        raise ValueError("score_mod is not supported on the FP8 flash path")
    if score_mod is not None and bias is not None:
        raise ValueError("score_mod and bias are mutually exclusive; fold "
                         "the bias into the mod or use the bias alone")
    if mha_proj is not None and (bias is not None or score_mod is not None):
        raise ValueError("fp8_mha does not take a bias or score_mod")
    if qkv_quantizers is not None and bias is not None:
        raise ValueError("FP8 flash attention does not take a bias")
    if mha_proj is not None:
        w, quantizers = mha_proj
        quantizers = tuple(quantizers)
        if len(quantizers) != 7:
            raise ValueError("mha_proj takes (w, (q, k, v, o, w, g, do) "
                             "quantizers)")
        _check_tensor_scaling(quantizers, "fp8_mha")
        if grad and any(t is not None and t.requires_grad
                        for t in (q, k, v, w, sink)):
            return _FP8MHA.apply(q, k, v, w, sink, *masks, quantizers, cfg,
                                 drop)
        return _fp8_mha_fwd(q, k, v, w, sink, masks, quantizers, cfg,
                            drop)[0]
    if qkv_quantizers is not None:
        quantizers = tuple(qkv_quantizers)
        _check_tensor_scaling(quantizers, "FP8 flash attention")
        if grad and any(t is not None and t.requires_grad
                        for t in (q, k, v, sink)):
            return _FP8Attention.apply(q, k, v, sink, *masks, quantizers,
                                       cfg, drop)
        return _fp8_fwd(q, k, v, sink, masks, quantizers, cfg, drop)[0]
    if grad and any(t is not None and t.requires_grad
                    for t in (q, k, v, sink, bias)):
        return _FlashAttention.apply(q, k, v, sink, bias, *masks, *cfg,
                                     score_mod, drop)
    return flash_fwd(q, k, v, scale=scale, causal=mask_type.is_causal,
                     offset=offset, window=window, softmax_sink=sink,
                     bias=bias, score_mod=score_mod, **_mask_kw(masks),
                     **_dropout_kw(drop))[0]
