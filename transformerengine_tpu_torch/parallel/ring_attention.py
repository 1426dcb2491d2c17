"""Context-parallel attention over a ``torch.distributed`` process group
(counterpart of transformerengine_tpu/parallel/ring_attention.py). The
sequence is split over the group's ``cp`` ranks; each rank holds its
shard of q, k and v (B, L, H, D) and computes the attention of its own
queries:

* :func:`all_gather_attn`: K and V gathered from every rank, one flash
  call with the rank's runtime q-position offset (``idx * L``); FP8
  payloads on the wire under ``fp8_dpa``;
* :func:`ring_attn`: the K/V chunks rotate around the ring while each
  rank attends to the resident one and merges the partial results in
  log-sum-exp space; its backward runs the same ring with the dK/dV
  accumulators rotating beside their chunks, so each arrives home summed
  after ``cp`` steps. Each step is a flash call whose runtime positions
  [qoff, left, right] are a row of one (cp, 3) int32 table made on the
  device once per call, so the kernels read them and the host never
  waits; the reference's launches are kept, the fully masked ones too;
* :func:`ulysses_attn`: all-to-alls swap the sequence split for a head
  split, one flash call over the whole sequence on ``H / cp`` heads;
* :func:`hierarchical_attn`: Ulysses inside an inner group, the ring
  over an outer one.

The reference runs them inside ``shard_map``, whose transpose sums the
gradients of replicated inputs (a sink, a broadcast bias) over the ranks.
Here each rank's gradient of such an input is its own share: the caller
sums it over the group once, as it sums the weights' gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..attention import AttnMaskType, SequenceDescriptor, SoftmaxType
from ..ops.flash_attention import (NEG_INF, flash_attention, flash_bwd,
                                   flash_fwd, sink_grad)
from ..quantize.quantizer import CurrentScaleQuantizer, QuantizeLayout
from .group import (AllGather, AllToAll, all_gather, all_to_all,
                    axis_index, axis_size, pmax, reduce_scatter, ring_shift)

FP8_MAX = 448.0


def _local_segments(sequence_descriptor, group, L: int, *,
                    allow_seqlens: bool = True, positions=None):
    """(qseg, kseg) (B, L) int32 of this rank's shard, or (None, None).
    Segment ids are taken as they are; lengths are global, against the
    shard's global ``positions`` (the contiguous ones, idx * L + i, by
    default)."""
    sd = sequence_descriptor
    if sd is None:
        return None, None
    if sd.q_segment_ids is not None:
        kseg = sd.kv_segment_ids if sd.kv_segment_ids is not None \
            else sd.q_segment_ids
        return sd.q_segment_ids.to(torch.int32), kseg.to(torch.int32)
    if sd.q_seqlens is not None:
        if positions is None:
            if not allow_seqlens:
                raise ValueError("this CP strategy needs segment ids or an "
                                 "explicit position map for its layout")
            positions = axis_index(group) * L + torch.arange(
                L, device=sd.q_seqlens.device)
        klens = sd.kv_seqlens if sd.kv_seqlens is not None else sd.q_seqlens
        qseg = (positions[None, :] < sd.q_seqlens[:, None]).to(torch.int32)
        kseg = (positions[None, :] < klens[:, None]).to(torch.int32)
        return qseg, kseg
    return None, None


def _fp8_quantizers():
    """Current-scaling e4m3 quantizers of Q, K and V."""
    return tuple(CurrentScaleQuantizer(torch.float8_e4m3fn,
                                       QuantizeLayout.ROWWISE)
                 for _ in range(3))


def _kv_q(t: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Per-tensor e4m3 quantize (the reference's ``_kv_q``): (payload, its
    f32 dequant scale amax / 448, or 1 for a zero tensor); ``amax`` the
    group's where the payloads of several ranks share one scale."""
    if amax is None:
        amax = t.float().abs().amax()
    scale_inv = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t.float() / scale_inv).to(torch.float8_e4m3fn), scale_inv


def _kv_dq(payload: torch.Tensor, scale_inv: torch.Tensor, dtype):
    """The reference's ``_kv_dq``: payload times scale, both in bf16."""
    return (payload.to(torch.bfloat16)
            * scale_inv.to(torch.bfloat16)).to(dtype)


def _kv_q_global(t: torch.Tensor, group):
    """:func:`_kv_q` against the group's amax (the reference's
    ``_kv_q_global``), so the ranks' payloads form one tensor."""
    return _kv_q(t, pmax(t.float().abs().amax(), group))


class _Fp8Exchange(torch.autograd.Function):
    """``t`` quantized to e4m3 against the group's amax, its payload
    gathered (``dims`` = (dim,)) or all-to-all'd (``dims`` = (split,
    concat)) and dequantized: FP8 bytes on the wire. The gradient passes
    the quantization straight through, as the reference's FP8 ring does,
    and takes the exchange's transpose (:func:`reduce_scatter`, the
    reverse all-to-all). The reference has no gradient here: JAX cannot
    differentiate its ``pmax`` (ROADMAP.md, Queue 3)."""

    @staticmethod
    def forward(ctx, t, group, dims):
        ctx.group, ctx.dims = group, dims
        payload, scale_inv = _kv_q_global(t, group)
        if len(dims) == 1:
            moved = all_gather(payload, group, dims[0])
        else:
            moved = all_to_all(payload, group, *dims)
        return _kv_dq(moved, scale_inv, t.dtype)

    @staticmethod
    def backward(ctx, g):
        group, dims = ctx.group, ctx.dims
        if len(dims) == 1:
            return reduce_scatter(g, group, dims[0]), None, None
        return all_to_all(g.contiguous(), group, dims[1], dims[0]), None, None


def all_gather_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    group, *, causal: bool = True,
                    scaling_factor: Optional[float] = None,
                    window_size: Optional[Tuple[int, int]] = None,
                    sequence_descriptor=None, softmax_sink=None, bias=None,
                    score_mod=None, fp8_dpa: bool = False) -> torch.Tensor:
    """The reference's ``all_gather_attn``: K/V (and the kv segment ids)
    gathered over the group, one flash call whose runtime q-position
    offset is this rank's ``idx * L`` (a one-element tensor on the
    inputs' device, so the kernels read it). ``bias`` (B or 1, Hq, L,
    S_total): this rank's rows over the whole key length. ``fp8_dpa``
    (without a bias or score mod) quantizes K/V against the group's amax
    before the gather, half the bytes, and runs the FP8 kernels;
    ``softmax_sink`` (Hq,) joins the one flash call."""
    idx, L = axis_index(group), q.shape[1]
    use_fp8 = fp8_dpa and bias is None and score_mod is None
    if use_fp8:
        k_full = _Fp8Exchange.apply(k, group, (1,))
        v_full = _Fp8Exchange.apply(v, group, (1,))
    else:
        k_full = AllGather.apply(k, group, 1)
        v_full = AllGather.apply(v, group, 1)
    qseg, kseg = _local_segments(sequence_descriptor, group, L)
    sd = None
    if qseg is not None:
        sd = SequenceDescriptor(q_segment_ids=qseg,
                                kv_segment_ids=all_gather(kseg, group, 1))
    qoff = torch.full((1,), idx * L, dtype=torch.int32, device=q.device)
    return flash_attention(
        q, k_full, v_full, sd,
        qkv_quantizers=_fp8_quantizers() if use_fp8 else None,
        attn_mask_type=(AttnMaskType.CAUSAL if causal
                        else AttnMaskType.NO_MASK),
        scaling_factor=scaling_factor, window_size=window_size,
        q_position_offset=qoff, bias=bias, score_mod=score_mod,
        softmax_type=(SoftmaxType.LEARNABLE if softmax_sink is not None
                      else None),
        softmax_offset=softmax_sink)


def _ring_qoff(idx: int, j: int, L: int, striped: bool) -> int:
    """The step's q-position offset against resident chunk ``j``.
    Contiguous: chunk j holds key positions j * L.., rank idx's queries
    start at idx * L, so qoff = (idx - j) * L. Striped: rank r's token i
    sits at global position r + i * cp, so the causal rule is plain
    causal for j <= idx and strictly causal (qoff = -1) for j > idx."""
    if striped:
        return 0 if j <= idx else -1
    return (idx - j) * L


def _ring_striped_window(window, idx: int, j: int, cp: int, qoff0: int):
    """The striped layout's local-index window against chunk ``j`` (the
    reference's ``_ring_striped_window``): the global (w0, w1) becomes
    iq - ik <= floor((w0 - delta) / cp) and ik - iq <= floor((w1 + delta)
    / cp) with delta = idx - j, the striped qoff folded back in. An
    active side may come out -1 (w0 < cp, j > idx): it stays active."""
    delta = idx - j
    w0, w1 = window
    return ((w0 - delta) // cp + qoff0 if w0 >= 0 else -1,
            (w1 + delta) // cp - qoff0 if w1 >= 0 else -1)


def _ring_table(idx: int, cp: int, L: int, striped: bool, window, device):
    """The ring's (cp, 3) int32 table of each step's [qoff, left, right],
    made on ``device`` once per call."""
    rows = []
    for s in range(cp):
        j = (idx - s) % cp
        qoff = _ring_qoff(idx, j, L, striped)
        win = window
        if striped and (window[0] >= 0 or window[1] >= 0):
            win = _ring_striped_window(window, idx, j, cp, qoff)
        rows.append([qoff, *win])
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _step_positions(table: torch.Tensor, s: int, window) -> dict:
    """Step ``s``'s runtime positions as flash_fwd and flash_bwd take them:
    the offset and the active window sides as views of the table's row,
    an inactive side -1."""
    return dict(q_position_offset=table[s, 0:1],
                window=tuple(table[s, 1 + i:2 + i] if window[i] >= 0
                             else -1 for i in range(2)))


def _ring_steps(group, striped: bool, window, L: int, device):
    """(cp, this rank's index, :func:`_ring_table`)."""
    cp, idx = axis_size(group), axis_index(group)
    return cp, idx, _ring_table(idx, cp, L, striped, window, device)


class _RingAttention(torch.autograd.Function):
    """The reference's ``ring_attn`` custom VJP, forward and backward on
    this rank; see :func:`ring_attn`."""

    @staticmethod
    def forward(ctx, q, k, v, sink, bias, qseg, kseg, group, causal, scale,
                window, striped, fp8_kv, score_mod):
        if bias is not None and striped:
            raise NotImplementedError("a bias under the striped ring")
        b, L, hq, d = q.shape
        cp, idx, table = _ring_steps(group, striped, window, L, q.device)
        fp8_compute = fp8_kv and bias is None and score_mod is None
        num = torch.zeros((b, L, hq, d), dtype=torch.float32,
                          device=q.device)
        den = torch.zeros((b, L, hq), dtype=torch.float32, device=q.device)
        m_run = torch.full((b, L, hq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        kv = _ring_kv(k, v, kseg, fp8_kv)
        q_pay = _kv_q(q) if fp8_compute else None
        for s in range(cp):
            j = (idx - s) % cp
            o_s, lse_s = flash_fwd(
                *_step_qkv(q, q_pay, kv, fp8_kv, fp8_compute),
                scale=scale, causal=causal, q_segment_ids=qseg,
                kv_segment_ids=kv["kseg"],
                bias=_bias_chunk(bias, j, L), score_mod=score_mod,
                **_fp8_kw(q_pay, kv, fp8_compute, out_dtype=q.dtype),
                **_step_positions(table, s, window))
            lse_s = lse_s.transpose(1, 2)
            m_new = torch.maximum(m_run, lse_s)
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            alpha = torch.where(m_run <= NEG_INF / 2, 0.0,
                                torch.exp(m_run - m_safe))
            w = torch.where(lse_s <= NEG_INF / 2, 0.0,
                            torch.exp(lse_s - m_safe))
            num = num * alpha[..., None] + o_s.float() * w[..., None]
            den = den * alpha + w
            m_run = m_new
            if s != cp - 1:
                kv = _rotate(kv, group)
        if sink is not None:
            # One virtual key per (head, row) with logit s0 and no value
            # joins the total denominator once, after the ring.
            s0 = sink.float().reshape(1, 1, hq)
            m2 = torch.maximum(m_run, s0)
            alpha = torch.where(m_run <= NEG_INF / 2, 0.0,
                                torch.exp(m_run - m2))
            den2 = den * alpha + torch.exp(s0 - m2)
            o = ((num * alpha[..., None]) / den2[..., None]).to(q.dtype)
            lse = m2 + torch.log(den2)
        else:
            den_safe = torch.where(den > 0, den, 1.0)
            o = (num / den_safe[..., None]).to(q.dtype)
            lse = torch.where(den > 0, m_run + torch.log(den_safe), NEG_INF)
        lse = lse.transpose(1, 2).contiguous()
        ctx.save_for_backward(q, k, v, qseg, kseg, sink, bias, o, lse)
        ctx.cfg = (group, causal, scale, window, striped, fp8_kv, score_mod)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qseg, kseg, sink, bias, o, lse = ctx.saved_tensors
        group, causal, scale, window, striped, fp8_kv, score_mod = ctx.cfg
        b, L, hq, _ = q.shape
        cp, idx, table = _ring_steps(group, striped, window, L, q.device)
        fp8_compute = fp8_kv and bias is None and score_mod is None
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dbias = (torch.zeros((b, hq, L, bias.shape[3]), dtype=torch.float32,
                             device=q.device) if bias is not None else None)
        # The same quantization as the forward: the local flash backward
        # differentiates the exact forward computation.
        kv = _ring_kv(k, v, kseg, fp8_kv)
        kv["dk"] = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        kv["dv"] = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        q_pay = _kv_q(q) if fp8_compute else None
        for s in range(cp):
            j = (idx - s) % cp
            grads = flash_bwd(
                *_step_qkv(q, q_pay, kv, fp8_kv, fp8_compute), o, lse, do,
                scale=scale, causal=causal, q_segment_ids=qseg,
                kv_segment_ids=kv["kseg"], bias=_bias_chunk(bias, j, L),
                score_mod=score_mod,
                **_fp8_kw(q_pay, kv, fp8_compute, grad_dtype=q.dtype),
                **_step_positions(table, s, window))
            if dbias is not None:
                dbias[..., j * L:(j + 1) * L] = grads[3]
            dq += grads[0].float()
            kv["dk"] += grads[1].float()
            kv["dv"] += grads[2].float()
            # The chunk and its gradient accumulators rotate together;
            # after cp rotations both are back at their owner.
            kv = _rotate(kv, group)
        dsink = sink_grad(sink, o, lse, do) \
            if sink is not None and ctx.needs_input_grad[3] else None
        if dbias is not None:
            if bias.shape[0] == 1:
                dbias = dbias.sum(dim=0, keepdim=True)
            dbias = dbias.to(bias.dtype)
        return (dq.to(q.dtype), kv["dk"].to(k.dtype), kv["dv"].to(v.dtype),
                dsink, dbias) + (None,) * 9


def _ring_kv(k, v, kseg, fp8_kv: bool) -> dict:
    """The state that rotates: K and V (e4m3 payloads and their scales
    under ``fp8_kv``) and the kv segment ids."""
    kv = dict(kseg=kseg)
    if fp8_kv:
        (kv["k"], kv["ks"]), (kv["v"], kv["vs"]) = _kv_q(k), _kv_q(v)
    else:
        kv["k"], kv["v"] = k, v
    return kv


def _rotate(kv: dict, group) -> dict:
    names = [n for n, t in kv.items() if t is not None]
    moved = ring_shift([kv[n] for n in names], group)
    return {**kv, **dict(zip(names, moved))}


def _step_qkv(q, q_pay, kv, fp8_kv: bool, fp8_compute: bool):
    """A step's Q, K and V: the payloads under FP8 compute, K/V
    dequantized under ``fp8_kv`` with a bias or score mod."""
    if fp8_compute:
        return q_pay[0], kv["k"], kv["v"]
    if fp8_kv:
        return (q, _kv_dq(kv["k"], kv["ks"], q.dtype),
                _kv_dq(kv["v"], kv["vs"], q.dtype))
    return q, kv["k"], kv["v"]


def _fp8_kw(q_pay, kv, fp8_compute: bool, **dtype) -> dict:
    """The FP8 kernels' arguments: the scales of Q and of the resident
    chunk's K and V, and ``dtype`` (O's or the gradients')."""
    if not fp8_compute:
        return {}
    return dict(scale_invs=torch.stack([q_pay[1], kv["ks"], kv["vs"]]),
                **dtype)


def _bias_chunk(bias, j: int, L: int):
    """The bias's columns of resident chunk ``j``."""
    return None if bias is None else bias[..., j * L:(j + 1) * L]


def ring_attn(q, k, v, qseg, kseg, sink, bias, group, causal: bool,
              scale: float, window: Tuple[int, int] = (-1, -1),
              striped: bool = False, fp8_kv: bool = False,
              score_mod=None) -> torch.Tensor:
    """Ring attention of this rank's shard (B, L, H, D) over ``group``.

    ``qseg``/``kseg``: optional (B, L) int32 segment ids of the shard; the
    kv ids rotate with their chunk. ``sink``: optional (Hq,) sink logits,
    one virtual key per query row, merged once after the ring (its
    gradient is this rank's share). ``bias``: optional post-scale bias of
    this rank's rows over the whole key length, (B or 1, Hq, L, S_total);
    each step takes its chunk's columns (contiguous layout only).
    ``score_mod``: ALiBi (the step's offset reaches its positions) or
    another mod the flash kernels take. ``fp8_kv``: K/V rotate as e4m3
    payloads with one scale per chunk, and without a bias or mod each
    step runs the FP8 kernels (q quantized once per rank). ``striped``:
    the striped layout (:func:`~.cp_utils.reorder_causal_striped`)."""
    if q.shape[1] % 8:
        raise ValueError(f"ring attention needs a local length that is a "
                         f"multiple of 8, got {q.shape[1]}")
    return _RingAttention.apply(q, k, v, sink, bias, qseg, kseg, group,
                                causal, float(scale), tuple(window), striped,
                                fp8_kv, score_mod)


def ring_attn_in_group(q, k, v, sequence_descriptor=None, *, group,
                       attn_mask_type=None,
                       scaling_factor: Optional[float] = None,
                       window_size: Optional[Tuple[int, int]] = None,
                       striped: bool = False, fp8_kv: bool = False,
                       softmax_sink=None, bias=None,
                       score_mod=None) -> torch.Tensor:
    """The reference's ``ring_attn_under_shard_map``, the entry of
    ``fused_attn`` for RING and RING_STRIPED: ``sequence_descriptor``
    describes the shard (segment ids as they are, lengths global, against
    the contiguous or striped positions)."""
    causal = attn_mask_type.is_causal if attn_mask_type else False
    scale = scaling_factor if scaling_factor is not None \
        else 1.0 / q.shape[-1] ** 0.5
    window = tuple(window_size) if window_size is not None else (-1, -1)
    positions = None
    if striped and sequence_descriptor is not None \
            and sequence_descriptor.q_segment_ids is None:
        # Rank r's token i sits at global position r + i * cp.
        cp, idx = axis_size(group), axis_index(group)
        positions = idx + torch.arange(q.shape[1], device=q.device) * cp
    qseg, kseg = _local_segments(sequence_descriptor, group, q.shape[1],
                                 positions=positions)
    return ring_attn(q, k, v, qseg, kseg, softmax_sink, bias, group, causal,
                     float(scale), window, striped, fp8_kv, score_mod)


def _sink_heads(softmax_sink, group, hq: int):
    """This rank's heads' sink logits after a head split over ``group``."""
    if softmax_sink is None:
        return None
    n, r = axis_size(group), axis_index(group)
    return softmax_sink.float().reshape(hq)[r * (hq // n):(r + 1) * (hq // n)]


def _check_heads(hq: int, hkv: int, n: int) -> None:
    if hq % n or hkv % n:
        raise ValueError(f"Ulysses needs head counts divisible by cp={n}, "
                         f"got {hq}/{hkv}")


def ulysses_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                 *, causal: bool = True, scaling_factor=None,
                 window_size=None, sequence_descriptor=None,
                 softmax_sink=None, fp8_dpa: bool = False) -> torch.Tensor:
    """The reference's ``ulysses_attn``: all-to-alls turn the sequence
    split into a head split, one flash call over the whole sequence on
    this rank's heads, and back. Segment ids are gathered to the whole
    length; ``softmax_sink`` (Hq,) is cut to the rank's heads; ``fp8_dpa``
    sends e4m3 payloads (against the group's amax) and runs the FP8
    kernels."""
    n = axis_size(group)
    b, L, hq, d = q.shape
    _check_heads(hq, k.shape[2], n)
    qseg, kseg = _local_segments(sequence_descriptor, group, L)
    sd = None
    if qseg is not None:
        sd = SequenceDescriptor(q_segment_ids=all_gather(qseg, group, 1),
                                kv_segment_ids=all_gather(kseg, group, 1))
    if fp8_dpa:
        qg, kg, vg = (_Fp8Exchange.apply(t, group, (2, 1)) for t in (q, k, v))
    else:
        qg, kg, vg = (AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    sink = _sink_heads(softmax_sink, group, hq)
    out = flash_attention(
        qg, kg, vg, sd,
        attn_mask_type=(AttnMaskType.CAUSAL if causal
                        else AttnMaskType.NO_MASK),
        scaling_factor=scaling_factor, window_size=window_size,
        qkv_quantizers=_fp8_quantizers() if fp8_dpa else None,
        softmax_type=SoftmaxType.LEARNABLE if sink is not None else None,
        softmax_offset=sink)
    return AllToAll.apply(out, group, 1, 2)


def hierarchical_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      inner_group, outer_group, *, causal: bool = True,
                      scaling_factor=None, window_size=None,
                      sequence_descriptor=None, softmax_sink=None,
                      striped: bool = False,
                      fp8_kv: bool = False) -> torch.Tensor:
    """The reference's ``hierarchical_attn``: Ulysses all-to-alls inside
    ``inner_group``, the ring over ``outer_group`` (two groups from
    ``dist.new_group``). The sequence is split over both: this rank's
    shard is number ``outer * p_in + inner`` (contiguous), or under
    ``striped`` the outer ring's stripes, each cut contiguously over the
    inner group."""
    p_in = axis_size(inner_group)
    b, L, hq, d = q.shape
    _check_heads(hq, k.shape[2], p_in)
    scale = scaling_factor if scaling_factor is not None else 1.0 / d ** 0.5
    window = tuple(window_size) if window_size is not None else (-1, -1)
    sd = sequence_descriptor
    positions = None
    if sd is not None and sd.q_segment_ids is None \
            and sd.q_seqlens is not None:
        i_in, i_out = axis_index(inner_group), axis_index(outer_group)
        p_out = axis_size(outer_group)
        ar = torch.arange(L, device=q.device)
        positions = (i_out + (i_in * L + ar) * p_out if striped
                     else (i_out * p_in + i_in) * L + ar)
    qseg, kseg = _local_segments(sd, inner_group, L, allow_seqlens=False,
                                 positions=positions)
    if qseg is not None:
        qseg = all_gather(qseg, inner_group, 1)
        kseg = all_gather(kseg, inner_group, 1)
    sink = _sink_heads(softmax_sink, inner_group, hq)
    qg, kg, vg = (AllToAll.apply(t, inner_group, 2, 1) for t in (q, k, v))
    out = ring_attn(qg, kg, vg, qseg, kseg, sink, None, outer_group, causal,
                    float(scale), window, striped, fp8_kv)
    return AllToAll.apply(out, inner_group, 1, 2)
