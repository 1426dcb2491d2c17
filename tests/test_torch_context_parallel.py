"""The port's context parallelism on 4 gloo ranks of the CPU against the
JAX package: RING, RING_STRIPED (with the striped reorder, windows (37,
0) and (2, 0), the latter the live -1 left bound), ALL_GATHER and
ULYSSES_A2A through ``fused_attn`` with the group, and the hierarchical
2 x 2 form (Ulysses inside pairs, the ring across them), with segment
ids, global lengths, the off-by-one and learnable sinks, a post-scale
bias and ALiBi: each rank's O and dQ, dK, dV, the sink's and the bias's
gradients summed once over the ranks (the caller's sum), against the
reference's single-device unfused ``fused_attn`` on the whole sequence
and its ``jax.vjp``. The FP8 ring against the reference's
``ring_attn(fp8_kv=True)`` under ``shard_map`` (cp 2, S 64, contiguous
and striped), and the refusals under CP: attention dropout and an
explicit mask (which the reference's CP branch drops), ALiBi on the
striped ring, a bias under Ulysses and Ulysses' head count.

The ranks are processes of ``test_torch_cp_group.py``'s pool; on CPU
tensors the flash wrappers run their plain versions."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_cp_group import CP, pool  # noqa: F401 (the fixture)
from transformerengine_tpu.attention import (
    AttnBackend as JBackend, AttnBiasType as JBias, AttnMaskType as JMask,
    SequenceDescriptor as JDesc, SoftmaxType as JSoftmax,
    fused_attn as j_fused_attn)
from transformerengine_tpu.ops.flash_attention import (
    flash_attention as j_flash_attention)
from transformerengine_tpu.parallel.cp_utils import (
    inverse_reorder_causal_striped as j_unstripe,
    reorder_causal_striped as j_stripe)
from transformerengine_tpu.parallel.ring_attention import (
    _kv_dq as j_kv_dq, _kv_q as j_kv_q, all_gather_attn as j_all_gather_attn,
    ring_attn as j_ring_attn, ulysses_attn as j_ulysses_attn)
from transformerengine_tpu.quantize.quantizer import (
    CurrentScaleQuantizer as JCurrent, QuantizeLayout as JLayout)
from transformerengine_tpu.quantize.scaling_modes import ScalingMode as JMode

B, S, HQ, HKV, D = 2, 128, 8, 4, 32
# Relative to each output's largest |ref|. f32: the ring merges partial
# results in f32 in the exp domain where the reference normalizes one
# softmax; the plain flash steps run in the exp2 domain (readings below
# 2e-6). bf16: q, k and v are bf16 on both sides, the port's steps round
# O and the step gradients to bf16 before the f32 merge and sums, as the
# reference's ring does (readings below 1.2e-2); 2^-5.
_RTOL = {"float32": 2e-5, "bfloat16": 2 ** -5}

# name: (strategy, dtype, mask, window, sink, term, masking)
# sink: None, "off_by_one" or "learnable"; term: None, "bias" or "alibi";
# masking: None, "seg" (segment ids) or "lens" (global lengths).
_CASES = {
    "ring_causal": ("RING", "float32", "causal", None, None, None, None),
    "ring_no_mask": ("RING", "float32", "no_mask", None, None, None, None),
    "ring_segments_learnable": ("RING", "float32", "causal", None,
                                "learnable", None, "seg"),
    "ring_lens_off_by_one": ("RING", "bfloat16", "padding_causal", None,
                             "off_by_one", None, "lens"),
    "ring_bias": ("RING", "float32", "causal", None, None, "bias", None),
    "ring_alibi_window": ("RING", "float32", "causal", (40, 0), None,
                          "alibi", None),
    "striped_causal": ("RING_STRIPED", "float32", "causal", None, None,
                       None, None),
    "striped_window37": ("RING_STRIPED", "float32", "causal", (37, 0),
                         None, None, None),
    "striped_window2_live_minus1": ("RING_STRIPED", "float32", "causal",
                                    (2, 0), None, None, None),
    "striped_lens_learnable": ("RING_STRIPED", "bfloat16", "padding_causal",
                               None, "learnable", None, "lens"),
    "all_gather_bias_learnable": ("ALL_GATHER", "float32", "causal", None,
                                  "learnable", "bias", None),
    "all_gather_alibi_segments": ("ALL_GATHER", "float32", "causal", None,
                                  None, "alibi", "seg"),
    "ulysses_segments_learnable": ("ULYSSES_A2A", "float32", "causal", None,
                                   "learnable", None, "seg"),
    "ulysses_window_bf16": ("ULYSSES_A2A", "bfloat16", "causal", (20, 0),
                            None, None, None),
    "hierarchical_learnable": ("HIERARCHICAL", "float32", "causal", None,
                               "learnable", None, None),
    "hierarchical_lens": ("HIERARCHICAL", "float32", "padding_causal", None,
                          None, None, "lens"),
}
_LENS = np.array([128, 77], np.int32)


def _segments(rng) -> np.ndarray:
    """Packed rows: documents of random lengths, a padded tail (id 0)."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, doc = 0, 1
        while pos < S - 10:
            n = int(rng.integers(5, 50))
            seg[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


@functools.lru_cache(maxsize=None)
def _inputs(name):
    strategy, dtype, mask, window, sink, term, masking = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 900)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        # The values either side holds: bf16 cases round once, here.
        return np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    spec = dict(strategy=strategy, dtype=dtype, mask=mask, window=window,
                q=draw(B, S, HQ, D), k=draw(B, S, HKV, D),
                v=draw(B, S, HKV, D), do=draw(B, S, HQ, D))
    if sink is not None:
        spec["sink_type"] = sink
        if sink == "learnable":
            spec["sink"] = rng.standard_normal(HQ).astype(np.float32)
    if term == "bias":
        spec["bias_type"] = "post_scale_bias"
        spec["bias"] = rng.standard_normal((1, HQ, S, S)).astype(np.float32)
    elif term == "alibi":
        spec["bias_type"] = "alibi"
    if masking == "seg":
        spec["seg"] = _segments(rng)
    elif masking == "lens":
        spec["lens"] = _LENS
    return spec


def _reference(spec):
    """The reference's unfused attention on the whole sequence and its
    VJP: O, dQ, dK, dV, and dsink and dbias where they apply."""
    dtype = jnp.dtype(spec["dtype"])
    q, k, v, do = (jnp.asarray(spec[n]).astype(dtype)
                   for n in ("q", "k", "v", "do"))
    desc = None
    if "seg" in spec:
        seg = jnp.asarray(spec["seg"])
        desc = JDesc(q_segment_ids=seg, kv_segment_ids=seg)
    elif "lens" in spec:
        desc = JDesc.from_seqlens(jnp.asarray(spec["lens"]))
    sink = jnp.asarray(spec["sink"]) if "sink" in spec else None
    bias = jnp.asarray(spec["bias"]) if "bias" in spec else None

    def f(q, k, v, sink, bias):
        return j_fused_attn(
            (q, k, v), bias, desc,
            attn_bias_type=JBias(spec.get("bias_type", "no_bias")),
            attn_mask_type=JMask(spec["mask"]), window_size=spec["window"],
            softmax_type=JSoftmax(spec.get("sink_type", "vanilla")),
            softmax_offset=sink, backend=JBackend.UNFUSED)

    o, vjp = jax.vjp(f, q, k, v, sink, bias)
    dq, dk, dv, dsink, dbias = vjp(do)
    return dict(o=o, dq=dq, dk=dk, dv=dv, dsink=dsink, dbias=dbias)


def _gathered(outs, name: str, striped: bool) -> np.ndarray:
    """The ranks' shards of ``name`` put back in sequence order."""
    x = np.concatenate([o[name] for o in outs], axis=1)
    if striped:
        x = np.asarray(j_unstripe(jnp.asarray(x), CP))
    return x


def _close(name, got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_cp_matches_reference_unfused(pool, name):  # noqa: F811
    """O, dQ, dK and dV of every rank, in sequence order, and the sink's
    and the bias's gradients summed once over the ranks, against the
    reference's unfused attention on the whole sequence."""
    spec = _inputs(name)
    outs = pool.run("cp_attention", spec)
    ref = _reference(spec)
    striped = spec["strategy"] == "RING_STRIPED"
    rtol = _RTOL[spec["dtype"]]
    for n in ("o", "dq", "dk", "dv"):
        _close(f"{name} {n}", _gathered(outs, n, striped), ref[n], rtol)
    if "sink" in spec:
        # The caller's one sum over the group: each rank's own share.
        _close(f"{name} dsink", sum(o["dsink"] for o in outs), ref["dsink"],
               rtol)
    if "bias" in spec:
        # Each rank's gradient of its own rows of the one bias.
        _close(f"{name} dbias", np.concatenate([o["dbias"] for o in outs],
                                               axis=2), ref["dbias"], rtol)


# The FP8 ring: cp 2 over S 64, B 1, bf16 inputs quantized to e4m3 on
# both sides (the same payloads and scales), every product exact in f32;
# p and ds round to bf16 after sums in other orders, and the merges run
# in f32: readings below 1.6e-2 of each output's largest. 2^-5.
_FP8_RTOL = 2 ** -5


@functools.lru_cache(maxsize=None)
def _fp8_inputs(striped: bool):
    rng = np.random.default_rng(55 + striped)
    shapes = dict(q=(1, 64, HQ, D), k=(1, 64, HKV, D), v=(1, 64, HKV, D),
                  do=(1, 64, HQ, D))
    spec = {n: np.asarray(jnp.asarray(rng.standard_normal(s).astype(
        np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
        for n, s in shapes.items()}
    spec.update(striped=striped, scale=D ** -0.5)
    return spec


def _reference_fp8_ring(spec):
    """The reference's ``ring_attn(fp8_kv=True)`` under ``shard_map`` over 2
    devices, the sequence sharded (striped first with ``striped``), and
    its VJP; outputs in the shards' order."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("cp",))
    q, k, v, do = (jnp.asarray(spec[n]).astype(jnp.bfloat16)
                   for n in ("q", "k", "v", "do"))
    if spec["striped"]:
        q, k, v, do = (j_stripe(t, 2) for t in (q, k, v, do))
    seq = P(None, "cp")

    def local(q, k, v):
        return j_ring_attn(q, k, v, None, None, None, None, "cp", True,
                           spec["scale"], (-1, -1), spec["striped"], True)

    f = jax.shard_map(local, mesh=mesh, in_specs=(seq, seq, seq),
                      out_specs=seq, check_vma=False)

    # Jitted: the interpret-mode kernels run eagerly in 28 s, compiled in
    # 2.5 s.
    @jax.jit
    def step(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o, *vjp(do))
    return step(q, k, v, do)


@pytest.mark.parametrize("striped", [False, True])
def test_fp8_ring_matches_reference_ring(pool, striped):  # noqa: F811
    """The FP8 ring (K/V rotating as e4m3 payloads with their scales, q
    quantized once per rank, the FP8 kernels on each step) against the
    reference's: O and the gradients of both pairs of ranks."""
    spec = _fp8_inputs(striped)
    outs = pool.run("fp8_ring", spec)
    ref = _reference_fp8_ring(spec)
    for pair in ((0, 1), (2, 3)):
        for n, r in zip(("o", "dq", "dk", "dv"), ref):
            got = np.concatenate([outs[i][n] for i in pair], axis=1)
            _close(f"fp8 ring {n} ranks {pair}", got, r, _FP8_RTOL)


# FP8 under ALL_GATHER and ULYSSES_A2A, and the FP8 ring with a bias or
# ALiBi, through ``fused_attn`` under ``DelayedScaling(fp8_dpa=True)`` on
# the 4 ranks: bf16, causal, B 2, S 128. name: (strategy, sink, term).
_FP8_CASES = {
    "all_gather_fp8_learnable": ("ALL_GATHER", "learnable", None),
    "ulysses_fp8": ("ULYSSES_A2A", None, None),
    "ring_fp8_bias": ("RING", None, "bias"),
    "ring_fp8_alibi": ("RING", None, "alibi"),
}
# Relative to each output's largest |ref|. The quantized payloads and
# scales are the same on both sides: the exchanges' O matches bit for
# bit, and their gradients, whose plain FP8 steps sum in other orders
# than the reference's kernels, read below 2.2e-3; the ring's
# dequantized steps run in bf16 and round each step's O and gradients
# before the f32 merges (readings below 6.5e-3). 2^-6.
_FP8_CP_RTOL = 2 ** -6


@functools.lru_cache(maxsize=None)
def _fp8_cp_inputs(name):
    strategy, sink, term = _FP8_CASES[name]
    rng = np.random.default_rng(sorted(_FP8_CASES).index(name) + 700)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    spec = dict(strategy=strategy, dtype="bfloat16", mask="causal",
                window=None, fp8=True, q=draw(B, S, HQ, D),
                k=draw(B, S, HKV, D), v=draw(B, S, HKV, D),
                do=draw(B, S, HQ, D))
    if sink is not None:
        spec["sink_type"] = sink
        spec["sink"] = rng.standard_normal(HQ).astype(np.float32)
    if term == "bias":
        spec["bias_type"] = "post_scale_bias"
        spec["bias"] = rng.standard_normal((1, HQ, S, S)).astype(np.float32)
    elif term == "alibi":
        spec["bias_type"] = "alibi"
    return spec


def _j_e4m3():
    return JCurrent(q_dtype=jnp.dtype(jnp.float8_e4m3fn),
                    scaling_mode=JMode.CURRENT_TENSOR_SCALING,
                    q_layout=JLayout.ROWWISE)


def _j_qdq(t):
    """The reference's e4m3 quantize and dequantize of ``t`` against its
    own amax (a rank's chunk, or the whole tensor: the group's amax)."""
    return j_kv_dq(*j_kv_q(t), t.dtype)


def _reference_fp8_exchange(spec):
    """The reference's FP8 all-gather or Ulysses attention, rank by rank
    on one device, and its VJP: the payloads are quantized against the
    whole tensor's amax (the group's) and dequantized as its strategy
    does, then each rank's flash call with e4m3 current-scaling
    quantizers (ALL_GATHER: the rank's queries against the whole K/V at
    offset idx * L; ULYSSES_A2A: the rank's heads over the whole
    sequence). The gradient passes the exchange's quantization straight
    through and sums (or places) the ranks' shares: JAX cannot
    differentiate the reference's own ``pmax``, so its strategies have
    no gradient to hold the port's to."""
    q, k, v, do = (jnp.asarray(spec[n]).astype(jnp.bfloat16)
                   for n in ("q", "k", "v", "do"))
    sink = jnp.asarray(spec["sink"]) if "sink" in spec else None
    stype = JSoftmax.LEARNABLE if sink is not None else None
    L, gq, gkv = S // CP, HQ // CP, HKV // CP

    def flash(q, k, v, sink, offset):
        return j_flash_attention(
            q, k, v, attn_mask_type=JMask.CAUSAL,
            qkv_quantizers=tuple(_j_e4m3() for _ in range(3)),
            q_position_offset=offset, softmax_type=stype,
            softmax_offset=sink)

    @jax.jit
    def run(q, k, v, do, sink):
        k, v = _j_qdq(k), _j_qdq(v)
        o, dq = [], []
        dk, dv = jnp.zeros(k.shape, jnp.float32), jnp.zeros(v.shape,
                                                            jnp.float32)
        dsink = None if sink is None else jnp.zeros_like(sink)
        if spec["strategy"] == "ALL_GATHER":
            for r in range(CP):
                rows = slice(r * L, (r + 1) * L)
                o_r, vjp = jax.vjp(functools.partial(flash, offset=r * L),
                                   q[:, rows], k, v, sink)
                g = vjp(do[:, rows])
                o.append(o_r)
                dq.append(g[0])
                dk, dv = dk + g[1], dv + g[2]
                if sink is not None:
                    dsink = dsink + g[3]
            return (jnp.concatenate(o, 1), jnp.concatenate(dq, 1), dk, dv,
                    dsink)
        q = _j_qdq(q)
        for r in range(CP):
            hq, hkv = slice(r * gq, (r + 1) * gq), slice(r * gkv,
                                                         (r + 1) * gkv)
            o_r, vjp = jax.vjp(functools.partial(flash, sink=None, offset=0),
                               q[:, :, hq], k[:, :, hkv], v[:, :, hkv])
            g = vjp(do[:, :, hq])
            o.append(o_r)
            dq.append(g[0])
            dk, dv = dk.at[:, :, hkv].set(g[1]), dv.at[:, :, hkv].set(g[2])
        return jnp.concatenate(o, 2), jnp.concatenate(dq, 2), dk, dv, None
    o, dq, dk, dv, dsink = run(q, k, v, do, sink)
    return dict(o=o, dq=dq, dk=dk, dv=dv, dsink=dsink)


def _reference_fp8_exchange_forward(spec):
    """The reference's ``all_gather_attn`` or ``ulysses_attn`` with
    ``fp8_dpa`` under ``shard_map`` over 4 devices (forward only)."""
    mesh = Mesh(np.array(jax.devices()[:CP]), ("cp",))
    q, k, v = (jnp.asarray(spec[n]).astype(jnp.bfloat16) for n in "qkv")
    sink = jnp.asarray(spec["sink"]) if "sink" in spec else None
    fn = (j_all_gather_attn if spec["strategy"] == "ALL_GATHER"
          else j_ulysses_attn)
    seq = P(None, "cp")
    f = jax.shard_map(
        lambda q, k, v: fn(q, k, v, "cp", causal=True, softmax_sink=sink,
                           fp8_dpa=True),
        mesh=mesh, in_specs=(seq, seq, seq), out_specs=seq, check_vma=False)
    return jax.jit(f)(q, k, v)


def _reference_fp8_ring_dequantized(spec):
    """The reference's FP8 ring with a bias or a score mod, which rotates
    e4m3 K/V with one scale per chunk and attends in bf16 to their
    dequantized values, as one unfused attention on the whole sequence
    over K/V quantized and dequantized chunk by chunk (each rank's), and
    its VJP: the ring's custom VJP passes the quantization straight
    through."""
    L = S // CP

    def chunks(t):
        return jnp.concatenate([_j_qdq(t[:, r * L:(r + 1) * L])
                                for r in range(CP)], axis=1)
    deq = dict(spec)
    for n in ("k", "v"):
        deq[n] = np.asarray(chunks(jnp.asarray(spec[n]).astype(
            jnp.bfloat16)).astype(jnp.float32))
    return _reference(deq)


@pytest.mark.parametrize("name", sorted(_FP8_CASES))
def test_cp_fp8_matches_reference(pool, name):  # noqa: F811
    """FP8 under CP through ``fused_attn`` on the 4 ranks: ALL_GATHER (with
    a learnable sink) and ULYSSES_A2A, whose e4m3 payloads cross the
    group and run the FP8 kernels, and the FP8 ring with a bias or ALiBi,
    whose steps attend to dequantized K/V. O, dQ, dK, dV (and the sink's
    and the bias's gradients summed once) against the reference's
    computation on one device; the exchanges' O also against the
    reference's strategy under ``shard_map``."""
    spec = _fp8_cp_inputs(name)
    outs = pool.run("cp_attention", spec)
    if spec["strategy"] == "RING":
        ref = _reference_fp8_ring_dequantized(spec)
    else:
        ref = _reference_fp8_exchange(spec)
        sharded = _reference_fp8_exchange_forward(spec)
        _close(f"{name} o reference", ref["o"], sharded, _FP8_CP_RTOL)
    for n in ("o", "dq", "dk", "dv"):
        _close(f"{name} {n}", _gathered(outs, n, False), ref[n],
               _FP8_CP_RTOL)
    if "sink" in spec:
        _close(f"{name} dsink", sum(o["dsink"] for o in outs), ref["dsink"],
               _FP8_CP_RTOL)
    if "bias" in spec:
        _close(f"{name} dbias", np.concatenate([o["dbias"] for o in outs],
                                               axis=2), ref["dbias"],
               _FP8_CP_RTOL)


@pytest.mark.parametrize("what,error,match", [
    ("dropout", "NotImplementedError", "dropout"),
    ("mask", "NotImplementedError", "explicit mask"),
    ("striped_alibi", "NotImplementedError", "ALiBi"),
    ("ulysses_bias", "NotImplementedError", "bias"),
    ("ulysses_heads", "ValueError", "divisible"),
])
def test_cp_refusals(pool, what, error, match):  # noqa: F811
    """Under CP, attention dropout and an explicit mask raise (the
    reference's CP branch returns before it reads them, so its layers
    train without attention dropout: ROADMAP.md, Queue 3), and so do the
    reference's own refusals."""
    for name, message in pool.run("cp_refusal", what):
        assert name == error and match in message, (name, message)
