"""Context parallelism's collectives (``parallel/group.py``) on 4 gloo ranks
of the CPU, and the rank side of every context-parallel test.

:class:`RankPool` starts 4 processes once per test module (a module-
scoped fixture in each file), each of which joins one gloo group
(``torch.set_num_threads(1)``), makes the hierarchical form's inner
pairs {0, 1}, {2, 3} and outer pairs {0, 2}, {1, 3}, and then runs the
tasks it is sent: a function of this module (which imports torch, numpy
and the port, never JAX) called as ``fn(rank, groups, *args)`` on numpy
inputs, its numpy outputs sent back. The JAX references live in the test
files that use the pool (``test_torch_context_parallel.py``,
``test_torch_cp_model.py``).

Here: the ring shift, the tiled all-gather and all-to-all (and their
gradients), ``pmax`` and the sum against what each rank can compute
alone; the reorders of ``cp_utils.py`` as permutations."""
import contextlib
import datetime
import importlib
import multiprocessing
import queue
import socket
import traceback

import numpy as np
import pytest
import torch

CP = 4
TIMEOUT_S = 120


def _rank_main(rank: int, port: int, tasks, results) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=CP, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        inner = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
        outer = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
        groups = dict(world=dist.group.WORLD, inner=inner, outer=outer)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = tasks.get()
        if job is None:
            break
        module, name, args = job
        try:
            fn = getattr(importlib.import_module(module), name)
            results.put((rank, True, fn(rank, groups, *args)))
        except Exception:
            # The test that sent the task fails with this traceback.
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """Four gloo ranks in processes of their own; :meth:`run` sends each a
    task and returns their outputs in rank order."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        self.tasks = [ctx.Queue() for _ in range(CP)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, port, self.tasks[r], self.results),
                                  daemon=True) for r in range(CP)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args):
        """``name`` (a function of this module) on every rank with
        ``args``; raises with the traceback of a rank that failed."""
        for q in self.tasks:
            q.put((__name__, name, args))
        out = [None] * CP
        for _ in range(CP):
            try:
                rank, ok, value = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise AssertionError(f"{name}: a rank did not answer in "
                                     f"{TIMEOUT_S} s") from None
            if not ok:
                raise AssertionError(f"{name} failed on rank {rank}:\n"
                                     f"{value}")
            out[rank] = value
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


@contextlib.contextmanager
def rank_pool():
    pool = RankPool()
    try:
        yield pool
    finally:
        pool.close()


@pytest.fixture(scope="module")
def pool():
    with rank_pool() as p:
        yield p


# ---------------------------------------------------------------------------
# Rank-side tasks
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.detach().float().numpy()


def collectives(rank, groups, slabs):
    """Each collective of group.py on this rank's (B, S, H, D) slab, and
    the gradients of the differentiable gather and all-to-all for an
    upstream gradient of 1 + the output."""
    from transformerengine_tpu_torch.parallel import group as grp
    world, inner = groups["world"], groups["inner"]
    t = torch.from_numpy(slabs[rank])
    out = dict(index=grp.axis_index(world), size=grp.axis_size(world),
               inner_index=grp.axis_index(inner))
    shifted = grp.ring_shift([t, t.to(torch.bfloat16),
                              t.to(torch.float8_e4m3fn)], world)
    out["shift"] = [_np(s) for s in shifted]
    out["shift_dtypes"] = [str(s.dtype) for s in shifted]
    out["gather"] = _np(grp.all_gather(t, world, 1))
    out["reduce_scatter"] = _np(grp.reduce_scatter(
        grp.all_gather(t, world, 1) * (rank + 1), world, 1))
    out["a2a"] = _np(grp.all_to_all(t, world, 2, 1))
    out["inner_a2a"] = _np(grp.all_to_all(t, inner, 2, 1))
    out["pmax"] = _np(grp.pmax(t.abs().amax(), world))
    out["sum"] = _np(grp.all_reduce_sum(t, world))
    leaf = t.clone().requires_grad_()
    g = grp.AllGather.apply(leaf, world, 1)
    g.backward(1 + g.detach())
    out["gather_grad"] = _np(leaf.grad)
    leaf = t.clone().requires_grad_()
    a = grp.AllToAll.apply(leaf, world, 2, 1)
    a.backward(1 + a.detach())
    out["a2a_grad"] = _np(leaf.grad)
    out["staged"] = dict(grp.STAGED)
    return out


def test_collectives_on_four_gloo_ranks(pool):
    """The ring shift sends to the next rank (any dtype, fp8 bytes
    included); the gather concatenates in rank order; the all-to-all
    sends chunk i of the heads to rank i, concatenated by source along
    the sequence (over the world and over an inner pair); pmax and the
    sum reduce; the reduce-scatter sums the ranks' tensors and keeps the
    rank's slice; the gather's gradient is the sum of the ranks' gradients
    of the rank's slice, the all-to-all's the reverse exchange; host
    tensors stage nothing."""
    rng = np.random.default_rng(3)
    slabs = [rng.standard_normal((1, 4, 8, 2)).astype(np.float32)
             for _ in range(CP)]
    out = pool.run("collectives", slabs)
    full = np.concatenate(slabs, axis=1)
    heads = [np.split(x, CP, axis=2) for x in slabs]
    for r, o in enumerate(out):
        assert (o["index"], o["size"], o["inner_index"]) == (r, CP, r % 2)
        prev = slabs[(r - 1) % CP]
        np.testing.assert_array_equal(o["shift"][0], prev)
        np.testing.assert_array_equal(o["shift"][1], torch.from_numpy(
            prev).to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(o["shift"][2], torch.from_numpy(
            prev).to(torch.float8_e4m3fn).float().numpy())
        assert o["shift_dtypes"] == ["torch.float32", "torch.bfloat16",
                                     "torch.float8_e4m3fn"]
        np.testing.assert_array_equal(o["gather"], full)
        # Ranks 0..3 send (rank + 1) times the whole: 10 times the slice.
        np.testing.assert_allclose(o["reduce_scatter"], 10 * slabs[r],
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            o["a2a"], np.concatenate([heads[src][r] for src in range(CP)],
                                     axis=1))
        pair = [2 * (r // 2), 2 * (r // 2) + 1]
        np.testing.assert_array_equal(o["inner_a2a"], np.concatenate(
            [np.split(slabs[src], 2, axis=2)[r % 2] for src in pair],
            axis=1))
        assert o["pmax"] == max(np.abs(x).max() for x in slabs)
        # f32 sums of 4 terms in gloo's order.
        np.testing.assert_allclose(o["sum"], sum(slabs), rtol=1e-6,
                                   atol=1e-6)
        # d/dx_r of sum over ranks of <1 + gather, gather>: each rank's
        # upstream gradient 1 + full, so the slice's gradient is 4 (1 +
        # x_r).
        np.testing.assert_allclose(o["gather_grad"], CP * (1 + slabs[r]),
                                   rtol=1e-6)
        np.testing.assert_allclose(o["a2a_grad"], 1 + slabs[r], rtol=1e-6)
        assert o["staged"] == {}


def test_reorders_are_the_reference_permutations():
    """The dual-chunk swap and the striped reorder (stripes of 1 and 2)
    as the reference's index maps, their inverses, and the dual-chunk
    positions of each rank's shard."""
    from transformerengine_tpu_torch.parallel import cp_utils as cu
    s = 16
    x = torch.arange(s)[None, :, None].repeat(2, 1, 3)
    dual = cu.reorder_causal_dual_chunk_swap(x, CP)
    chunk = s // (2 * CP)
    order = [c for i in range(CP) for c in (i, 2 * CP - 1 - i)]
    want = [c * chunk + t for c in order for t in range(chunk)]
    assert dual[0, :, 0].tolist() == want
    assert torch.equal(cu.inverse_reorder_causal_dual_chunk_swap(dual, CP),
                       x)
    striped = cu.reorder_causal_striped(x, CP)
    assert striped[0, :, 0].tolist() == [r + i * CP for r in range(CP)
                                         for i in range(s // CP)]
    assert torch.equal(cu.inverse_reorder_causal_striped(striped, CP), x)
    st2 = cu.reorder_causal_striped(x, CP, stripe_size=2)
    assert st2[0, :4, 0].tolist() == [0, 1, 8, 9]
    assert torch.equal(cu.inverse_reorder_causal_striped(st2, CP,
                                                         stripe_size=2), x)
    L = s // CP
    for r in range(CP):
        assert cu.dual_chunk_positions(CP, L, r).tolist() == \
            dual[0, r * L:(r + 1) * L, 0].tolist()
    with pytest.raises(ValueError, match="multiple"):
        cu.reorder_causal_striped(x[:, :6], CP)


def _shard(x, rank: int, striped: bool, n: int = CP):
    """Rank ``rank``'s shard of a (B, S, ...) tensor (of the striped
    reorder with ``striped``)."""
    from transformerengine_tpu_torch.parallel.cp_utils import (
        reorder_causal_striped)
    if striped:
        x = reorder_causal_striped(x, n)
    L = x.shape[1] // n
    return x[:, rank * L:(rank + 1) * L]


def cp_attention(rank, groups, spec):
    """One context-parallel attention call on this rank's shard of
    ``spec``'s global q, k, v (f32 numpy, cast to ``spec["dtype"]``)
    through ``fused_attn`` with the world group (``hierarchical_attn``
    for "HIERARCHICAL"), its backward for this rank's shard of dO, and
    the gradients: O, dQ, dK, dV of the shard, and this rank's own dsink
    and dbias (its rows of the whole bias)."""
    from transformerengine_tpu_torch import DelayedScaling, autocast
    from transformerengine_tpu_torch.attention import (
        AttnBiasType, AttnMaskType, CPStrategy, SequenceDescriptor,
        SoftmaxType, fused_attn)
    from transformerengine_tpu_torch.parallel.ring_attention import (
        hierarchical_attn)
    dtype = getattr(torch, spec["dtype"])
    strategy = spec["strategy"]
    striped = strategy == "RING_STRIPED"
    q, k, v, do = (_shard(torch.from_numpy(spec[n]), rank, striped)
                   .to(dtype).contiguous() for n in ("q", "k", "v", "do"))
    for t in (q, k, v):
        t.requires_grad_()
    desc = None
    if spec.get("seg") is not None:
        seg = _shard(torch.from_numpy(spec["seg"]), rank, striped)
        desc = SequenceDescriptor(q_segment_ids=seg, kv_segment_ids=seg)
    elif spec.get("lens") is not None:
        desc = SequenceDescriptor.from_seqlens(torch.from_numpy(spec["lens"]))
    sink = None
    stype = SoftmaxType(spec.get("sink_type", "vanilla"))
    if spec.get("sink") is not None:
        sink = torch.from_numpy(spec["sink"]).requires_grad_()
    bias, btype = None, AttnBiasType(spec.get("bias_type", "no_bias"))
    if spec.get("bias") is not None:
        L = q.shape[1]
        bias = torch.from_numpy(spec["bias"][:, :, rank * L:(rank + 1) * L]
                                ).contiguous().requires_grad_()
    mask = AttnMaskType(spec["mask"])
    window = spec.get("window")
    if strategy == "HIERARCHICAL":
        o = hierarchical_attn(q, k, v, groups["inner"], groups["outer"],
                              causal=mask.is_causal, window_size=window,
                              sequence_descriptor=desc, softmax_sink=sink)
    else:
        with autocast(enabled=spec.get("fp8", False),
                      recipe=DelayedScaling(fp8_dpa=True)):
            o = fused_attn(
                (q, k, v), desc, bias=bias, attn_bias_type=btype,
                attn_mask_type=mask, window_size=window, softmax_type=stype,
                softmax_offset=sink,
                context_parallel_strategy=CPStrategy[strategy],
                context_parallel_group=groups["world"])
    o.backward(do)
    return dict(o=_np(o), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad),
                dsink=_np(sink.grad) if sink is not None else None,
                dbias=_np(bias.grad) if bias is not None else None)


def cp_refusal(rank, groups, what: str):
    """The refusals of ``fused_attn`` under CP, by ``what``: the error's
    type name and message."""
    from transformerengine_tpu_torch.attention import (
        AttnBiasType, AttnMaskType, CPStrategy, fused_attn)
    q = torch.zeros((1, 16, 8, 32))
    k = v = torch.zeros((1, 16, 4, 32))
    kw = dict(attn_mask_type=AttnMaskType.CAUSAL,
              context_parallel_strategy=CPStrategy.RING,
              context_parallel_group=groups["world"])
    if what == "dropout":
        kw.update(dropout_probability=0.1, seed=torch.tensor([1, 2]))
    elif what == "mask":
        kw.update(mask=torch.ones((1, 1, 16, 64), dtype=torch.bool))
    elif what == "striped_alibi":
        kw.update(attn_bias_type=AttnBiasType.ALIBI,
                  context_parallel_strategy=CPStrategy.RING_STRIPED)
    elif what == "ulysses_bias":
        kw.update(attn_bias_type=AttnBiasType.POST_SCALE_BIAS,
                  bias=torch.zeros((1, 8, 16, 64)),
                  context_parallel_strategy=CPStrategy.ULYSSES_A2A)
    elif what == "ulysses_heads":
        q = torch.zeros((1, 16, 6, 32))
        k = v = torch.zeros((1, 16, 2, 32))
        kw.update(context_parallel_strategy=CPStrategy.ULYSSES_A2A)
    try:
        fused_attn((q, k, v), **kw)
    except Exception as e:  # the refusal is the result
        return type(e).__name__, str(e)
    return None, ""


def fp8_ring(rank, groups, spec):
    """``ring_attn(fp8_kv=True)`` over the inner pair (cp 2) on this
    rank's contiguous (or striped) shard of ``spec``'s bf16 q, k, v and
    its backward: O, dQ, dK, dV of the shard."""
    from transformerengine_tpu_torch.parallel.ring_attention import (
        ring_attn)
    inner = groups["inner"]
    idx = rank % 2
    striped = spec["striped"]
    q, k, v, do = (_shard(torch.from_numpy(spec[n]), idx, striped, 2)
                   .to(torch.bfloat16).contiguous()
                   for n in ("q", "k", "v", "do"))
    for t in (q, k, v):
        t.requires_grad_()
    o = ring_attn(q, k, v, None, None, None, None, inner, True,
                  spec["scale"], (-1, -1), striped, True)
    o.backward(do)
    return dict(o=_np(o), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))


def llama_cp_step(rank, groups, params, tokens, targets):
    """One bf16 LLAMA_TINY step with context parallelism over the world
    group on this rank's contiguous shard of the (B, S) batch: the
    forward with the tokens' global RoPE positions, the rank's summed
    cross entropy over the global token count, the backward, the loss and
    every gradient summed over the group (the caller's sums). Returns the
    summed loss, the rank's logits, the summed gradients (rank 0) and the
    ring's flash calls by direction and form of the offset."""
    import collections
    import dataclasses
    from transformerengine_tpu_torch.models.llama import (
        LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)
    from transformerengine_tpu_torch.parallel import group as grp
    from transformerengine_tpu_torch.parallel import ring_attention as ra
    world = groups["world"]
    cfg = dataclasses.replace(LLAMA_TINY, context_parallel_group=world)
    model = LlamaModel(cfg, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    s = tokens.shape[1]
    L = s // CP
    sl = slice(rank * L, (rank + 1) * L)
    calls = collections.Counter()
    fwd, bwd = ra.flash_fwd, ra.flash_bwd

    def count(fn, what):
        def call(*args, **kw):
            tensor = isinstance(kw.get("q_position_offset"), torch.Tensor)
            calls[what + ("_qoff" if tensor else "")] += 1
            return fn(*args, **kw)
        return call
    ra.flash_fwd, ra.flash_bwd = count(fwd, "fwd"), count(bwd, "bwd")
    try:
        positions = torch.arange(rank * L, (rank + 1) * L)[None].repeat(
            tokens.shape[0], 1)
        logits = model(torch.from_numpy(tokens[:, sl]), positions=positions)
        loss = cross_entropy_loss(logits, torch.from_numpy(targets[:, sl])) \
            * (L / s)
        loss.backward()
    finally:
        ra.flash_fwd, ra.flash_bwd = fwd, bwd
    grads = {n: _np(grp.all_reduce_sum(p.grad, world))
             for n, p in model.named_parameters()}
    return dict(loss=float(grp.all_reduce_sum(loss.detach(), world)),
                logits=_np(logits), grads=grads if rank == 0 else None,
                calls=dict(calls))
