"""The port's fused cross entropy against the JAX package's
``ops/cross_entropy.py`` on the same numpy-seeded logits and targets:
values and the logits' gradients for every reduction, with label
smoothing and ``ignore_index``; the detached max shift; the
vocab-parallel form's refusal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.ops.cross_entropy import (
    cross_entropy as j_cross_entropy)
from transformerengine_tpu_torch.models.llama import cross_entropy_loss
from transformerengine_tpu_torch.ops.cross_entropy import (
    cross_entropy, parallel_cross_entropy)

torch.set_num_threads(2)

# XLA's and PyTorch's CPU exp, log and sums differ by f32 ulps: the loss
# to this share, each gradient element to four f32 ulps of the largest
# (readings: one ulp).
LOSS_RTOL = 1e-6
GRAD_ULPS_OF_MAX = 2 ** -21


def _inputs(shape=(3, 7), vocab=50, ignore=(), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (vocab,)) * 3).astype(dtype)
    targets = rng.integers(0, vocab, shape).astype(np.int32)
    for idx in ignore:
        targets[idx] = -100
    return logits, targets


def _both(logits, targets, **kw):
    def jloss(x):
        return j_cross_entropy(x, jnp.asarray(targets), **kw)
    if kw.get("reduction") == "none":
        jv, jvjp = jax.vjp(jloss, jnp.asarray(logits))
        cot = np.random.default_rng(1).standard_normal(
            targets.shape).astype(np.float32)
        (jg,) = jvjp(jnp.asarray(cot))
    else:
        jv, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
        cot = None
    x = torch.tensor(logits, requires_grad=True)
    tv = cross_entropy(x, torch.from_numpy(targets), **kw)
    tv.backward(torch.from_numpy(cot) if cot is not None else None)
    return (np.asarray(jv), np.asarray(jg)), (tv.detach().numpy(),
                                              x.grad.numpy())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [(), ((0, 2), (1, 5), (2, 0))],
                         ids=["all_valid", "ignored"])
def test_cross_entropy_matches_reference(reduction, smoothing, ignore):
    logits, targets = _inputs(ignore=ignore)
    (jv, jg), (tv, tg) = _both(logits, targets, reduction=reduction,
                               label_smoothing=smoothing)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=GRAD_ULPS_OF_MAX * np.abs(jg).max())
    for idx in ignore:
        # An ignored target contributes nothing, in value or gradient.
        assert not tg[idx].any()
        if reduction == "none":
            assert tv[idx] == 0.0


def test_bf16_logits_and_a_custom_ignore_index():
    logits, targets = _inputs(shape=(2, 9), vocab=33, seed=2)
    targets[0, 3] = 7
    bf16 = torch.tensor(logits).to(torch.bfloat16)
    want = j_cross_entropy(jnp.asarray(bf16.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(targets), ignore_index=7)
    got = cross_entropy(bf16, torch.from_numpy(targets), ignore_index=7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_all_ignored_mean_is_zero_and_alias():
    logits, targets = _inputs(shape=(4,), vocab=10, seed=3)
    targets[:] = -100
    x = torch.tensor(logits, requires_grad=True)
    loss = parallel_cross_entropy(x, torch.from_numpy(targets))
    loss.backward()
    assert float(loss.detach()) == 0.0 and not x.grad.any()
    assert parallel_cross_entropy is cross_entropy


def test_max_shift_is_detached_and_matches_the_model_loss():
    """The shift leaves no gradient of its own: the gradient is softmax
    minus one-hot over the token count, and the mean equals the model's
    log-softmax loss."""
    logits, targets = _inputs(shape=(2, 5), vocab=40, seed=4)
    x = torch.tensor(logits, requires_grad=True)
    loss = cross_entropy(x, torch.from_numpy(targets))
    loss.backward()
    p = torch.softmax(torch.tensor(logits, dtype=torch.float64), -1)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(targets).long(),
                                         40).double()
    np.testing.assert_allclose(x.grad.numpy(), ((p - onehot) / 10).numpy(),
                               rtol=0, atol=1e-7)
    ref = cross_entropy_loss(torch.tensor(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)


def test_refusals():
    logits, targets = _inputs()
    with pytest.raises(NotImplementedError, match="tp_group"):
        cross_entropy(torch.tensor(logits), torch.from_numpy(targets),
                      tp_group=object())
    with pytest.raises(ValueError, match="reduction"):
        cross_entropy(torch.tensor(logits), torch.from_numpy(targets),
                      reduction="avg")
