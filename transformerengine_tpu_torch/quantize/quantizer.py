"""Quantizers (counterpart of transformerengine_tpu/quantize/quantizer.py),
for current scaling, delayed scaling, MXFP8, FP8 block scaling and NVFP4.

A quantizer is a frozen dataclass. Delayed scaling's state (``scale`` and
``amax_history``) is held in tensors; :meth:`DelayedScaleQuantizer.update`
returns a new quantizer with the rolled state, as the reference does, and
:meth:`QuantizerSet.write_back` copies such a state into the tensors of
the set it was computed from, in place. The layers call it once per
backward pass, which is how the reference's "the quantizer set's
cotangent is the updated state" reaches the buffers of an ``nn`` module.
The block-scaled quantizers keep no state.

Both orientations at once (``QuantizeLayout.ROWWISE_COLWISE``) go through
``ops/quantize_kernels.cast_transpose`` under tensor scaling,
``mxfp8_quantize_2x`` under MXFP8 and ``nvfp4_amax_2x`` then
``nvfp4_quantize_2x`` under NVFP4 (1D blocks, without "four over six",
M and N multiples of 16; other NVFP4 cases take the two generic passes,
as the reference does); one MXFP8 orientation through
``mxfp8_quantize_1x``; ``quantize_normed`` through
``norm_cast_transpose`` or ``mxfp8_norm_quantize_2x``: the kernels on
CUDA tensors, their plain versions on CPU tensors. FP8 block scaling
(``BlockScaleQuantizer`` in a ``BLOCK_SCALING_*`` mode) has no kernel in
the reference, which quantizes it in plain XLA, and is plain PyTorch
here: it never reaches the MXFP8 kernels. Under block scaling the colwise
usage is the transposed view quantized on its own (its blocks run down
the input's columns), never the transpose of the rowwise payload; under
NVFP4 it may be rotated first (the RHT) and has its own tensor scale and
amax. One NVFP4 orientation has no kernel in the reference and is plain
PyTorch here too.

Stochastic rounding needs a ``torch.Generator`` passed to
:meth:`Quantizer.quantize`, where the reference takes a key: one seed is
drawn from it per call, and the bits come from ``qmath.sr_bits`` of that
seed (stream 0 rowwise, 1 colwise). Every FP8 quantizer then rounds
stochastically (``qmath.stochastic_cast``) in the generic passes, as the
reference's fused kernels decline a key; NVFP4 where its ``QParams`` ask.
Without a generator, rounding is to nearest, as in the reference's
layers, which pass no key.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import ClassVar, Optional

import torch

from ..ops import quantize_kernels as qk
from . import qmath
from .hadamard import apply_rht
from .scaling_modes import ScalingMode
from .tensor import ScaledTensor1x, ScaledTensor2x


class QuantizeLayout(enum.Enum):
    ROWWISE = enum.auto()
    COLWISE = enum.auto()
    ROWWISE_COLWISE = enum.auto()


@dataclasses.dataclass(frozen=True)
class Quantizer:
    """Base of the quantizers. ROWWISE keeps the logical layout; COLWISE
    stores the 2D view (leading dims folded) transposed, so the quantized
    axis is again the last one (the (N, K) layout a TN GEMM reads);
    ROWWISE_COLWISE returns both as a ScaledTensor2x. Each subclass fixes
    its ``scaling_mode`` (NVFP4 per instance).

    The hooks return one orientation as a tuple (data in stored layout,
    scale_inv, tensor_scale_inv or None, amax or None)."""

    q_dtype: torch.dtype
    q_layout: QuantizeLayout = QuantizeLayout.ROWWISE

    scaling_mode: ClassVar[ScalingMode]

    def _quantize_2d(self, x2d, colwise: bool = False, seed=None):
        """One orientation of a 2D tensor quantized along its last axis;
        ``colwise`` says that ``x2d`` is the transposed view."""
        raise NotImplementedError

    def _fused_1x(self, x2d, colwise: bool, seed=None):
        """One orientation from the UNTRANSPOSED 2D view (the colwise
        form transposes in the kernel), or None to quantize the
        (transposed) view with :meth:`_quantize_2d`."""
        return None

    def _fused_2x(self, x2d, seed=None):
        """(rowwise, colwise) of both orientations from one pass, or None
        for the two generic passes."""
        return None

    def _seed(self, generator: Optional[torch.Generator]):
        """The seed of this call's stochastic rounding, or None: one draw
        from ``generator`` where there is one."""
        if generator is None:
            return None
        return int(torch.randint(0, 2 ** 32, (), generator=generator,
                                 device=generator.device))

    def _tensor(self, parts, dq_dtype, layout):
        data, s_inv, ts_inv, amax = parts
        return ScaledTensor1x(data, s_inv, amax, dq_dtype, layout=layout,
                              scaling_mode=self.scaling_mode,
                              tensor_scale_inv=ts_inv)

    def quantize(self, x: torch.Tensor, *, dq_dtype=None,
                 layout: Optional[QuantizeLayout] = None,
                 generator: Optional[torch.Generator] = None):
        """Quantizes ``x`` (any rank; its 2D view folds the leading dims).
        ``layout`` overrides the quantizer's own ``q_layout``;
        ``generator`` feeds stochastic rounding where the quantizer asks
        for it."""
        q_layout = layout if layout is not None else self.q_layout
        dq_dtype = dq_dtype or x.dtype
        x2d = x.reshape(-1, x.shape[-1])
        t_shape = (x.shape[-1],) + tuple(x.shape[:-1])
        seed = self._seed(generator)

        def colwise():
            data, *rest = (self._fused_1x(x2d, True, seed)
                           or self._quantize_2d(x2d.t(), True, seed))
            return (data.contiguous().reshape(t_shape), *rest)

        def rowwise():
            data, *rest = (self._fused_1x(x2d, False, seed)
                           or self._quantize_2d(x2d, False, seed))
            return (data.reshape(x.shape), *rest)

        if q_layout is QuantizeLayout.COLWISE:
            return self._tensor(colwise(), dq_dtype, "T")
        if q_layout is QuantizeLayout.ROWWISE:
            return self._tensor(rowwise(), dq_dtype, "N")
        fused = self._fused_2x(x2d, seed)
        if fused is not None:
            (row, *row_rest), (col, *col_rest) = fused
            row_parts = (row.reshape(x.shape), *row_rest)
            col_parts = (col.reshape(t_shape), *col_rest)
        elif self.scaling_mode.is_tensor_scaling:
            # One scale both ways: the colwise payload is the rowwise one
            # transposed (stochastic rounding draws once, as the
            # reference).
            row_parts = rowwise()
            col = row_parts[0].reshape(x2d.shape).t().contiguous()
            col_parts = (col.reshape(t_shape), *row_parts[1:])
        else:
            row_parts, col_parts = rowwise(), colwise()
        return ScaledTensor2x(rowwise=self._tensor(row_parts, dq_dtype, "N"),
                              colwise=self._tensor(col_parts, dq_dtype, "T"))

    def update(self, amax) -> "Quantizer":
        """End-of-step state update (the quantizer itself when it keeps
        no state)."""
        return self


def _ubits(seed, colwise: bool, x2d: torch.Tensor):
    """The stochastic-rounding bits of one orientation's 2D view, or None
    (round to nearest) without a seed."""
    if seed is None:
        return None
    return qmath.sr_bits(seed, int(colwise), x2d.shape, x2d.device)


@dataclasses.dataclass(frozen=True)
class CurrentScaleQuantizer(Quantizer):
    """Per-tensor scaling from the current amax."""

    scaling_mode: ClassVar[ScalingMode] = ScalingMode.CURRENT_TENSOR_SCALING

    def _quantize_2d(self, x2d, colwise=False, seed=None):
        data, s_inv, amax = qmath.current_scale_quantize(
            x2d, self.q_dtype, _ubits(seed, colwise, x2d))
        return data, s_inv, None, amax

    def _fused_2x(self, x2d, seed=None):
        if seed is not None:
            return None
        amax = qmath.compute_amax(x2d)
        scale = qmath.compute_scale_from_amax(amax, self.q_dtype)
        row, col, _ = qk.cast_transpose(x2d, scale.reshape(1), self.q_dtype)
        s_inv = (1.0 / scale).reshape(1)
        return (row, s_inv, None, amax), (col, s_inv, None, amax)


def _ones_scale():
    return torch.ones((1,), dtype=torch.float32)


def _zero_history():
    return torch.zeros((1024,), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DelayedScaleQuantizer(Quantizer):
    """Per-tensor scaling from an amax history carried across steps:
    ``scale`` (1,) f32 quantizes this step; :meth:`update` records this
    step's amax, rolls the history and computes the next scale."""

    scaling_mode: ClassVar[ScalingMode] = ScalingMode.DELAYED_TENSOR_SCALING

    scale: torch.Tensor = dataclasses.field(default_factory=_ones_scale)
    amax_history: torch.Tensor = dataclasses.field(
        default_factory=_zero_history)
    margin: float = 0.0
    amax_compute_algo: str = "max"

    def _quantize_2d(self, x2d, colwise=False, seed=None):
        data, s_inv, amax = qmath.tensor_scale_quantize(
            x2d, self.q_dtype, self.scale, _ubits(seed, colwise, x2d))
        return data, s_inv, None, amax

    def _fused_2x(self, x2d, seed=None):
        if seed is not None:
            return None
        row, col, amax = qk.cast_transpose(x2d, self.scale.reshape(1),
                                           self.q_dtype)
        s_inv = (1.0 / self.scale.float()).reshape(1)
        amax = amax.reshape(())
        return (row, s_inv, None, amax), (col, s_inv, None, amax)

    def quantize_normed(self, x2d: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor], *, norm: str,
                        zero_centered_gamma: bool, epsilon: float,
                        dq_dtype=None, layout=None):
        """Normalization fused with the quantize of both orientations:
        (ScaledTensor2x, mu or None, rsigma (M,)), bit-identical to
        ``ops/normalization`` followed by :meth:`quantize`; the rowwise
        ScaledTensor1x alone for ``layout=ROWWISE``. None when the shape
        rule of the fused kernel (M % 8 == 0, H % 128 == 0, M >= 256)
        does not hold."""
        m, h = x2d.shape
        if m % 8 or h % 128 or m < 256:
            return None
        outs = qk.norm_cast_transpose(
            x2d, gamma, beta, self.scale.reshape(1), self.q_dtype, norm=norm,
            zero_centered_gamma=zero_centered_gamma, epsilon=epsilon)
        row, col, amax, rsigma = outs[:4]
        amax = amax.reshape(())
        mu = outs[4].reshape(m) if norm == "layernorm" else None
        dq_dtype = dq_dtype or x2d.dtype
        s_inv = (1.0 / self.scale.float()).reshape(1)
        rw = self._tensor((row, s_inv, None, amax), dq_dtype, "N")
        if layout is QuantizeLayout.ROWWISE:
            return rw, mu, rsigma.reshape(m)
        cw = self._tensor((col, s_inv, None, amax), dq_dtype, "T")
        return ScaledTensor2x(rowwise=rw, colwise=cw), mu, rsigma.reshape(m)

    def update(self, amax) -> "DelayedScaleQuantizer":
        """Records ``amax`` in slot 0 of the history, reduces the history
        (``max`` or ``most_recent``), computes the next scale with the
        margin, then rolls the history by one and clears slot 0."""
        hist = self.amax_history.float().clone()
        hist[0] = torch.as_tensor(amax, dtype=torch.float32,
                                  device=hist.device).reshape(())
        amax_red = hist.max() if self.amax_compute_algo == "max" else hist[0]
        new_scale = qmath.compute_scale_from_amax(amax_red, self.q_dtype,
                                                  self.margin)
        new_hist = torch.roll(hist, -1)
        new_hist[0] = 0.0
        return dataclasses.replace(self, scale=new_scale.reshape(1),
                                   amax_history=new_hist)

    def write_back(self, new: "DelayedScaleQuantizer") -> None:
        """Copies ``new``'s state into this quantizer's tensors."""
        self.scale.copy_(new.scale)
        self.amax_history.copy_(new.amax_history)


_BLOCK_MODES = (ScalingMode.MXFP8_1D_SCALING, ScalingMode.BLOCK_SCALING_1D,
                ScalingMode.BLOCK_SCALING_2D)


@dataclasses.dataclass(frozen=True)
class BlockScaleQuantizer(Quantizer):
    """Block scaling from each block's own amax, in one of the
    reference's three modes (``scaling_mode``): MXFP8, one E8M0 scale per
    32 elements along the quantized axis; FP8 block scaling, one f32
    scale per 1 x 128 block (``BLOCK_SCALING_1D``) or 128 x 128 tile
    (``BLOCK_SCALING_2D``), rounded down to a power of two under
    ``pow2_scales``. Under MXFP8 every orientation, and the fused norm,
    goes through a kernel for any shape; FP8 block scaling is plain
    PyTorch, as the reference's plain XLA, and has no fused norm. The
    tensors carry no amax."""

    scaling_mode: ScalingMode = ScalingMode.MXFP8_1D_SCALING
    pow2_scales: bool = True

    def __post_init__(self):
        if self.scaling_mode not in _BLOCK_MODES:
            raise ValueError(f"BlockScaleQuantizer takes an MXFP8 or FP8 "
                             f"block scaling mode, got {self.scaling_mode}")

    @property
    def _mxfp8(self) -> bool:
        return self.scaling_mode is ScalingMode.MXFP8_1D_SCALING

    def _quantize_2d(self, x2d, colwise=False, seed=None):
        """The unfused ground truth (``qmath.mxfp8_quantize``, which
        :meth:`_fused_1x` and :meth:`_fused_2x` equal bit for bit, or
        ``qmath.block_quantize``)."""
        ubits = _ubits(seed, colwise, x2d)
        if self._mxfp8:
            data, scale = qmath.mxfp8_quantize(x2d, self.q_dtype, ubits)
            return data, scale, None, None
        br, bc = self.scaling_mode.block_shape
        data, s_inv = qmath.block_quantize(x2d, self.q_dtype, br, bc,
                                           self.pow2_scales, ubits)
        return data, s_inv, None, None

    def _fused_1x(self, x2d, colwise: bool, seed=None):
        if not self._mxfp8 or seed is not None:
            return None
        data, scale = qk.mxfp8_quantize_1x(x2d, self.q_dtype,
                                           colwise=colwise)
        return data, scale, None, None

    def _fused_2x(self, x2d, seed=None):
        if not self._mxfp8 or seed is not None:
            return None
        row, col, srow, scol = qk.mxfp8_quantize_2x(x2d, self.q_dtype)
        return (row, srow, None, None), (col, scol, None, None)

    def quantize_normed(self, x2d: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor], *, norm: str,
                        zero_centered_gamma: bool, epsilon: float,
                        dq_dtype=None, layout=None):
        """Normalization fused with the MXFP8 quantize: (ScaledTensor2x,
        mu or None, rsigma (M,)), bit-identical to ``ops/normalization``
        followed by :meth:`quantize`; the rowwise ScaledTensor1x alone for
        ``layout=ROWWISE``. None under FP8 block scaling, and where the
        reference's shape rule (M % 256 == 0, H % 128 == 0) does not
        hold."""
        m, h = x2d.shape
        if not self._mxfp8 or m % 256 or h % 128:
            return None
        rowwise_only = layout is QuantizeLayout.ROWWISE
        outs = qk.mxfp8_norm_quantize_2x(
            x2d, gamma, beta, self.q_dtype, norm=norm,
            zero_centered_gamma=zero_centered_gamma, epsilon=epsilon,
            rowwise_only=rowwise_only)
        row, col, srow, scol, rsigma = outs[:5]
        mu = outs[5].reshape(m) if norm == "layernorm" else None
        dq_dtype = dq_dtype or x2d.dtype
        rw = self._tensor((row, srow, None, None), dq_dtype, "N")
        if rowwise_only:
            return rw, mu, rsigma.reshape(m)
        cw = self._tensor((col, scol, None, None), dq_dtype, "T")
        return ScaledTensor2x(rowwise=rw, colwise=cw), mu, rsigma.reshape(m)


@dataclasses.dataclass(frozen=True)
class NVFP4Quantizer(Quantizer):
    """NVFP4: e2m1 values with an e4m3 scale per block (``scaling_mode``:
    (1, 16), or (16, 16) for 2D weights) under an f32 scale per tensor,
    optionally with the random Hadamard transform of the colwise usage
    (sign mask ``rht_sign_mask``), stochastic rounding (with a generator)
    and "four over six" block scales. Stateless; the tensors carry their
    amax and tensor scale.

    The RHT applies to the colwise usage only: the two colwise operands
    meet in the wgrad GEMM, which contracts over tokens, where the
    rotations cancel (H H^T = I); the rowwise usages meet unrotated
    partners."""

    scaling_mode: ScalingMode = ScalingMode.NVFP4_1D_SCALING
    with_rht: bool = False
    rht_sign_mask: int = 0
    stochastic_rounding: bool = False
    four_over_six: bool = False

    def __post_init__(self):
        if not self.scaling_mode.is_nvfp4:
            raise ValueError(f"NVFP4Quantizer takes an NVFP4 scaling mode, "
                             f"got {self.scaling_mode}")

    def _seed(self, generator):
        if not self.stochastic_rounding:
            return None
        return super()._seed(generator)

    def _quantize_2d(self, x2d, colwise=False, seed=None):
        if self.with_rht and colwise:
            x2d = apply_rht(x2d, self.rht_sign_mask)
        data, block_scale, ts_inv, amax = qmath.nvfp4_quantize(
            x2d, seed, int(colwise), block_shape=self.scaling_mode.block_shape,
            four_over_six=self.four_over_six)
        return data, block_scale, ts_inv, amax

    def _fused_2x(self, x2d, seed=None):
        """``nvfp4_amax_2x`` then ``nvfp4_quantize_2x``: (1, 16) blocks
        without "four over six", M and N multiples of 16 (the reference
        also declines its fused pass for the first two)."""
        m, n = x2d.shape
        if (self.scaling_mode is not ScalingMode.NVFP4_1D_SCALING
                or self.four_over_six or m % 16 or n % 16 or m * n == 0):
            return None
        mask = self.rht_sign_mask if self.with_rht else None
        arow, acol = qk.nvfp4_amax_2x(x2d, mask)
        ts_row = qmath.nvfp4_tensor_scale(arow)
        ts_col = qmath.nvfp4_tensor_scale(acol)
        row, srow, col, scol = qk.nvfp4_quantize_2x(x2d, ts_row, ts_col, mask,
                                                    seed)
        return ((row, srow, ts_row.reshape(1), arow),
                (col, scol, ts_col.reshape(1), acol))


@dataclasses.dataclass(frozen=True)
class NoopQuantizer(Quantizer):
    """Pass-through quantizer for a tensor role left in high precision."""

    scaling_mode: ClassVar[ScalingMode] = ScalingMode.NO_SCALING

    def quantize(self, x, *, dq_dtype=None, layout=None, generator=None):
        return x


@dataclasses.dataclass(frozen=True)
class QuantizerSet:
    """The quantizers of one GEMM: activation input, weight and incoming
    gradient."""

    x: Optional[Quantizer]
    kernel: Optional[Quantizer]
    dgrad: Optional[Quantizer]

    def update(self, amaxes: "QuantizerSet") -> "QuantizerSet":
        """Each quantizer updated with the matching entry of ``amaxes``."""
        return QuantizerSet(
            x=self.x.update(amaxes.x) if self.x is not None else None,
            kernel=(self.kernel.update(amaxes.kernel)
                    if self.kernel is not None else None),
            dgrad=(self.dgrad.update(amaxes.dgrad)
                   if self.dgrad is not None else None))

    def write_back(self, new: "QuantizerSet") -> None:
        """Copies the state of ``new`` (computed from this set by
        :meth:`update`) into this set's tensors, in place: a module's
        quantizer set holds its buffers, so they take the new state."""
        for role in ("x", "kernel", "dgrad"):
            q = getattr(self, role)
            if isinstance(q, DelayedScaleQuantizer):
                q.write_back(getattr(new, role))


noop_quantizer_set = QuantizerSet(x=None, kernel=None, dgrad=None)
