"""The port's sampling (inference/engine.py ``_sample``) against the JAX
package's. The two draw from different generators, so the tests compare
what is deterministic (greedy, and filters that leave one token) and the
set of tokens each filter lets through."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.inference.engine import (
    _sample as j_sample, _sample_mode as j_sample_mode)
from transformerengine_tpu_torch.inference import generate
from transformerengine_tpu_torch.inference.engine import _sample
from transformerengine_tpu_torch.models.llama import LLAMA_TINY, LlamaModel

torch.set_num_threads(2)


def _jax_sample(logits: np.ndarray, key: int, temperature, top_k, top_p):
    sampling = (jnp.float32(temperature), jnp.int32(top_k),
                jnp.float32(top_p))
    return np.asarray(j_sample(jnp.asarray(logits), jax.random.PRNGKey(key),
                               sampling,
                               j_sample_mode(temperature, top_k, top_p)))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.7, 1, 1.0), (1.0, 0, 1e-6), (0.5, 1, 0.3)])
def test_sample_deterministic_cases_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32) * 3
    gen = torch.Generator().manual_seed(0)
    got = _sample(torch.from_numpy(logits), gen, temperature, top_k, top_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_sample(logits, 0, temperature, top_k,
                                              top_p))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def _allowed(logits: np.ndarray, temperature, top_k, top_p) -> set:
    """The reference's rule: the top_k largest, then the smallest prefix
    of the sorted tempered distribution whose mass reaches top_p."""
    order = np.argsort(-logits)
    keep = order[:top_k] if top_k > 0 else order
    x = logits[keep] / temperature
    p = np.exp(x - x.max())
    p /= p.sum()
    inside = np.cumsum(p) - p < top_p
    return set(keep[inside].tolist())


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, 1.0), (1.0, 0, 0.5), (0.8, 10, 0.6)])
def test_sample_filters_let_through_the_same_tokens(temperature, top_k,
                                                    top_p):
    # Descending logits with gaps wide enough that every allowed token
    # shows up in 600 draws on both sides.
    logits = np.linspace(3.0, -3.0, 32).astype(np.float32)
    rng = np.random.default_rng(1)
    logits = logits[rng.permutation(32)]
    batch = np.tile(logits, (600, 1))
    gen = torch.Generator().manual_seed(1)
    got = set(_sample(torch.from_numpy(batch), gen, temperature, top_k,
                      top_p).tolist())
    ref = set(_jax_sample(batch, 1, temperature, top_k, top_p).tolist())
    allowed = _allowed(logits, temperature, top_k, top_p)
    assert 2 <= len(allowed) < 32
    assert got == ref == allowed


def test_generate_sampling_follows_its_generator():
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=3)
    model.embedding.data.mul_(0.02)
    tokens = torch.randint(1, 256, (2, 12),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    lengths = torch.tensor([12, 7], dtype=torch.int32)

    def run(seed):
        return generate(model, tokens, lengths, 6, temperature=1.0,
                        top_k=50, top_p=0.95, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    first = run(0)
    assert first.shape == (2, 6) and int(first.min()) >= 0
    assert int(first.max()) < LLAMA_TINY.vocab_size
    assert torch.equal(first, run(0))
    assert not all(torch.equal(first, run(s)) for s in (1, 2, 3))
