"""Llama-class causal LM (counterpart of transformerengine_tpu/models/
llama.py): RMSNorm + SwiGLU LayerNormMLP + GQA attention + RoPE, with
tied input/output embeddings, and its token-level cross-entropy loss.

A training step is the model's forward (no caches), ``cross_entropy_loss``
and ``loss.backward()``; under ``autocast`` with ``DelayedScaling`` the
backward also rolls every GEMM's quantizer state in the modules' buffers
(the reference's ``quantize_meta`` collection).

Context parallelism (``LlamaConfig.context_parallel_group``, a
``torch.distributed`` process group: the reference's
``context_parallel_axis``): every layer's attention runs the ring over
the group, each rank feeding its shard of the sequence (B, S / cp) and
its tokens' global RoPE positions (``positions``). The step's sums over
the group are the caller's, as under the reference's ``shard_map`` they
come from its transpose: each rank's loss is its tokens' summed cross
entropy over the global token count, and the weights' gradients are
summed over the group (``parallel.group.all_reduce_sum``).

``remat`` (with ``remat_policy``: ``"nothing_saveable"``, ``"dots"`` or
``"offload_dots"``) runs each layer of a training forward as one
checkpointed call (``checkpoint_policies.checkpoint``), which the
backward runs again. ``scan_layers`` changes no computation here: the
reference's scanned model stacks its layers' variables on a leading
axis, and :func:`load_flax_params` and :func:`load_flax_opt_state` split
such a tree into ``layers.{i}``."""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..attention import AttnMaskType, SequenceDescriptor
from ..checkpoint_policies import checkpoint, remat_policy
from ..dense import needs_grad
from ..device import resolve_device
from ..inference.kv_cache import KVCache
from ..nn.module import LayerNorm
from ..nn.transformer import TransformerLayer, flax_state
from ..ops.gemm import matmul_f32
from ..optimizers.fused_adam import AdamState, ScaledState
from ..quantize.prequant import BlockResidentKernel, PrequantizedKernel


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = False
    context_parallel_group: Optional[object] = None


LLAMA_TINY = LlamaConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_layers=2,
                         num_attention_heads=4, num_kv_heads=2,
                         max_seq_len=512, rope_base=10000.0)
LLAMA_8B = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32,
                       num_attention_heads=32, num_kv_heads=8)


class LlamaModel(nn.Module):
    """Decoder-only transformer LM. The weights are drawn on ``device``
    from a generator seeded with ``seed``; :func:`load_flax_params`
    gives the state of a reference model instead."""

    def __init__(self, config: LlamaConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        self.config = cfg
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedding = nn.Parameter(
            torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                        device=dev).to(cfg.dtype))
        self.layers = nn.ModuleList(
            TransformerLayer(
                cfg.hidden_size, cfg.intermediate_size,
                cfg.num_attention_heads, head_dim=cfg.head_dim,
                num_gqa_groups=cfg.num_kv_heads,
                layernorm_epsilon=cfg.norm_eps, norm_type="rmsnorm",
                mlp_activations="swiglu",
                self_attn_mask_type=AttnMaskType.CAUSAL,
                enable_rotary_pos_emb=True,
                rotary_pos_emb_base=cfg.rope_base,
                max_seq_len=cfg.max_seq_len, dtype=cfg.dtype, device=dev,
                generator=gen,
                context_parallel_group=cfg.context_parallel_group)
            for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.norm_eps,
                                    norm_type="rmsnorm",
                                    device=dev)
        self.remat = remat_policy(cfg.remat_policy) if cfg.remat else None

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def forward(self, tokens: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                kv_caches: Optional[Sequence[KVCache]] = None
                ) -> torch.Tensor:
        """(B, S) int tokens -> (B, S, vocab) f32 logits. Attention is
        causal, and padding-causal when ``sequence_descriptor`` gives the
        lengths or, for a packed batch, the segment ids
        (:meth:`SequenceDescriptor.from_segment_ids_and_pos`);
        ``positions`` (B, S) are the tokens' RoPE positions (a packed
        batch's positions within each document). With ``kv_caches`` (one
        per layer) the call prefills or decodes through them, updating
        them in place. Under ``config.remat`` each layer of a forward
        without caches is one checkpointed call."""
        x = self.embedding[tokens]
        for i, layer in enumerate(self.layers):
            x = run_layer(self.remat, layer, x, sequence_descriptor,
                          positions, kv_caches[i] if kv_caches is not None
                          else None)
        return tied_logits(self.final_norm(x), self.embedding)


def run_layer(remat, layer, x, sequence_descriptor, positions, kv_cache):
    """One layer's call: a checkpointed call under the ``remat`` policy
    (not None) when it has no cache, else the plain call."""
    if remat is not None and kv_cache is None:
        return checkpoint(layer, x, sequence_descriptor, positions,
                          policy=remat)
    return layer(x, sequence_descriptor, positions, kv_cache=kv_cache)


def tied_logits(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """(B, S, H) activations -> (B, S, vocab) f32 logits against the tied
    embedding."""
    b, s, h = x.shape
    x2d = x.reshape(b * s, h)
    if needs_grad(x2d, embedding):
        logits = _Logits.apply(x2d, embedding)
    else:
        logits = matmul_f32(x2d, embedding.t())
    return logits.reshape(b, s, -1)


class _Logits(torch.autograd.Function):
    """f32 logits ``x . embedding^T`` from the activations' dtype: bf16
    operands with f32 accumulation, without an f32 copy of the embedding
    in the forward. The backward takes the f32 logits' gradient against
    the widened operands (f32 products, as the reference's transposed dot
    with an f32 preferred type) and rounds the results to the operands'
    dtypes."""

    @staticmethod
    def forward(ctx, x2d, embedding):
        ctx.save_for_backward(x2d, embedding)
        return matmul_f32(x2d, embedding.t())

    @staticmethod
    def backward(ctx, g):
        x2d, embedding = ctx.saved_tensors
        g = g.float()
        dx = (g @ embedding.float()).to(x2d.dtype) \
            if ctx.needs_input_grad[0] else None
        demb = (g.t() @ x2d.float()).to(embedding.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, demb


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level cross entropy of (B, S, V) logits against (B, S)
    targets, in f32; with ``mask`` the mean over the valid tokens."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    return -ll.mean()


_FP8_NUMPY = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}


def _bytes(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array's bytes as a tensor of a one-byte ``dtype``."""
    raw = np.ascontiguousarray(np.asarray(arr)).view(np.uint8)
    return torch.from_numpy(raw.copy()).view(dtype).to(device)


def _resident_module(leaf, config: LlamaConfig, device) -> PrequantizedKernel:
    """The port's module for one ``PrequantizedKernel`` leaf of the
    reference's ``prequant`` collection (its arrays as numpy), with the
    same payload bytes: a ``BlockResidentKernel`` colwise, a per-tensor
    ``ScaledTensor1x`` one, or a plain (N, K) array."""
    cw, shape = leaf.colwise, tuple(leaf.logical_shape)
    if hasattr(cw, "payload"):
        payload = _bytes(cw.payload, torch.uint8 if cw.packed
                         else torch.float8_e4m3fn, device)
        scale = torch.from_numpy(np.asarray(cw.scale, np.float32)).to(
            device=device, dtype=torch.bfloat16)
        out_scale = None if cw.out_scale is None else torch.from_numpy(
            np.asarray(cw.out_scale, np.float32).reshape(1)).to(device)
        kn = BlockResidentKernel(payload, scale, out_scale, int(cw.block),
                                 bool(cw.packed))
        return PrequantizedKernel(None, None, shape, config.dtype, kn=kn)
    if hasattr(cw, "scale_inv"):
        data = _bytes(cw.data, _FP8_NUMPY[np.asarray(cw.data).dtype.name],
                      device)
        scale_inv = torch.from_numpy(
            np.asarray(cw.scale_inv, np.float32).reshape(1)).to(device)
        return PrequantizedKernel(data, scale_inv, shape, config.dtype)
    data = torch.from_numpy(np.array(cw, dtype=np.float32)).to(
        device=device, dtype=config.dtype)
    return PrequantizedKernel(data, None, shape, config.dtype)


def load_flax_params(params_np: Mapping, config: LlamaConfig,
                     device="cuda",
                     quantize_meta: Optional[Mapping] = None,
                     prequant: Optional[Mapping] = None) -> dict:
    """Maps the reference model's ``variables["params"]`` (nested dicts of
    numpy arrays, boxes removed) to a :class:`LlamaModel` ``state_dict`` on
    ``device``: ``layer_{i}`` becomes ``layers.{i}``, kernels take
    ``config.dtype``, and norm scales and router kernels stay f32
    (``nn.transformer.F32_PARAMS``). ``quantize_meta``, the
    reference's collection of the same name, adds the delayed-scaling
    state (``{gemm}_{role}_scale`` and ``_amax_history``, f32) under the
    same keys; ``load_state_dict`` creates those buffers. ``prequant``, the
    reference's collection of resident kernels (its ``PrequantizedKernel``
    leaves with numpy arrays), adds under each kernel's key the port's
    :class:`PrequantizedKernel` module with the same payload bytes;
    :func:`load_flax_state` installs such a state. Under
    ``config.scan_layers`` the params and ``quantize_meta`` are the
    scanned model's, each layer's leaves stacked under ``layers``."""
    dev = resolve_device(device)
    # GPT-OSS's config has no scanned form, as the reference's has none.
    scanned = getattr(config, "scan_layers", False)
    if scanned:
        params_np = unstack_layers(params_np, config.num_layers)
    state = flax_state(params_np, config.dtype, dev)
    if quantize_meta is not None:
        if scanned:
            quantize_meta = unstack_layers(quantize_meta, config.num_layers)
        state.update(flax_state(quantize_meta, torch.float32, dev))
    if prequant is not None:
        state.update(flax_state(prequant, None, dev, leaf=lambda name, arr:
                                _resident_module(arr, config, dev)))
    return state


def unstack_layers(tree: Mapping, num_layers: int) -> dict:
    """A scanned reference model's tree (``layers`` holding every layer's
    leaves stacked on a leading axis) with ``layers`` split into
    ``layer_{i}`` subtrees, as the unscanned model names them. A
    per-tensor scaled state leaf (``payload`` and ``scale_inv``) keeps its
    one scale, which the reference took over the whole stack."""
    if "layers" not in tree:
        raise KeyError("the tree has no stacked 'layers' (scan_layers)")

    def index(sub, i):
        if isinstance(sub, Mapping):
            return {k: index(v, i) for k, v in sub.items()}
        if sub is None:
            return None
        if hasattr(sub, "payload"):
            return ScaledState(np.asarray(sub.payload)[i],
                               np.asarray(sub.scale_inv))
        arr = np.asarray(sub)
        if arr.shape[:1] != (num_layers,):
            raise ValueError(f"a stacked leaf of shape {arr.shape} has no "
                             f"leading axis of {num_layers} layers")
        return arr[i]

    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(num_layers):
        out[f"layer_{i}"] = index(tree["layers"], i)
    return out


# numpy's (ml_dtypes') names of the dtypes that torch.from_numpy cannot
# take: the unsigned view that carries their bits, and the torch dtype.
_NUMPY_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
               "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _np_tensor(arr, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and bits on
    ``device``."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name in _NUMPY_BITS:
        view, dtype = _NUMPY_BITS[arr.dtype.name]
        return torch.from_numpy(arr.view(view).copy()).view(dtype).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def load_flax_opt_state(opt_state, config: LlamaConfig,
                        device="cuda") -> AdamState:
    """The reference's ``fused_adam`` state (its ``AdamState`` with numpy
    arrays: ``step``, ``mu``, ``nu``, ``master``) as the port's
    :class:`~..optimizers.fused_adam.AdamState`, keyed as
    :func:`load_flax_params` keys the params: each leaf in its own dtype
    and bits (f32, bf16 or int16 remainders; a ``ScaledState``'s fp8
    payload and scale), None masters kept. Under ``config.scan_layers``
    the trees are the scanned model's."""
    dev = resolve_device(device)

    def leaf(name, arr):
        if arr is None:
            return None
        if hasattr(arr, "payload"):
            return ScaledState(_np_tensor(arr.payload, dev),
                               _np_tensor(arr.scale_inv, dev))
        return _np_tensor(arr, dev)

    def tree(t):
        if config.scan_layers:
            t = unstack_layers(t, config.num_layers)
        return flax_state(t, None, dev, leaf=leaf)

    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32,
                        device=dev)
    return AdamState(step, tree(opt_state.mu), tree(opt_state.nu),
                     tree(opt_state.master))


def load_flax_state(model: nn.Module, state: Mapping) -> nn.Module:
    """Loads a :func:`load_flax_params` state into ``model``, in place:
    each resident module replaces the kernel parameter it is keyed by,
    and the tensors load as ``load_state_dict`` loads them. Returns
    ``model``."""
    tensors, resident = {}, set()
    for key, value in state.items():
        if not isinstance(value, nn.Module):
            tensors[key] = value
            continue
        owner, name = key.rsplit(".", 1)
        module = model.get_submodule(owner)
        delattr(module, name)
        setattr(module, name, value)
        resident |= {f"{key}.{b}" for b, _ in value.named_buffers()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    if set(missing) - resident or unexpected:
        raise KeyError(f"state does not fit the model: missing "
                       f"{sorted(set(missing) - resident)}, unexpected "
                       f"{unexpected}")
    return model
