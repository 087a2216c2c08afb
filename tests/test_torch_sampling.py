"""The port's sampler (``nf4_tpu_torch/serve/sampling.py``) against
``nf4_tpu.serve.sampling`` on the CPU.

Deterministic parts are held to the JAX package on the same fp32 logits
[B, V] with distinct values: ``filter_logits_batched`` must give the same
-inf pattern and its finite entries within 1e-6 relative; greedy rows of
``sample_batched`` (with the repetition penalty on a bool mask, the
presence and frequency penalties on counts, and ``logit_bias``) the same
tokens.  Stochastic draws cannot reproduce ``jax.random``'s bits: 20,000
draws per parameter row at V = 16 must have frequencies within 0.02 of
softmax of the JAX package's filtered logits, and never a token the filter
removed.  A seeded row's draw depends on (seed, step) only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.serve import sampling as jsampling
from nf4_tpu_torch.serve import sampling
from nf4_tpu_torch.serve.sampling import BatchedSampling, KeyStream, SamplingParams, sample, sample_batched

ROWS = [
    SamplingParams(),
    SamplingParams(temperature=0.7),
    SamplingParams(temperature=1.3, top_k=5),
    SamplingParams(temperature=0.9, top_p=0.8),
    SamplingParams(temperature=1.0, min_p=0.1),
    SamplingParams(temperature=0.8, top_k=7, top_p=0.9, min_p=0.05),
    SamplingParams(temperature=0.5, top_k=1),
    SamplingParams(temperature=1.1, top_k=100000, top_p=0.3),
]


def _logits(b, v, seed):
    """fp32 logits [b, v] with distinct values in every row."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(v) * (6.0 / v) - 3.0 + rng.random(v) * 1e-3 for _ in range(b)]).astype(np.float32)


def _both(params):
    return BatchedSampling.stack(params, "cpu"), jsampling.BatchedSampling.stack(params)


@pytest.mark.parametrize("v", [16, 50, 1000])
def test_filter_logits_batched_matches_jax(v):
    logits = _logits(len(ROWS), v, v)
    bp, jbp = _both(ROWS)
    got = sampling.filter_logits_batched(torch.from_numpy(logits), bp).numpy()
    want = np.asarray(jsampling.filter_logits_batched(jnp.asarray(logits), jbp))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    assert np.isfinite(got).any(axis=-1).all()  # the top token always stays


@pytest.mark.parametrize("counts", [False, True])
def test_greedy_rows_with_penalties_and_bias_match_jax(counts):
    """64 greedy rows, each with its own penalties and bias, on a bool mask
    or on counts: the port's tokens equal the JAX package's."""
    rng = np.random.default_rng(1 + counts)
    b, v = 64, 40
    logits = _logits(b, v, 3)
    params = [
        SamplingParams(
            repetition_penalty=float(rng.choice([1.0, 1.3, 2.5])),
            presence_penalty=float(rng.choice([0.0, 0.5])) if counts else 0.0,
            frequency_penalty=float(rng.choice([0.0, 0.7])) if counts else 0.0,
        )
        for _ in range(b)
    ]
    mask = rng.integers(0, 3, (b, v)).astype(np.int32) * (rng.random((b, v)) < 0.3)
    if not counts:
        mask = mask > 0
    bias = np.where(rng.random((b, v)) < 0.05, rng.choice([-100.0, 4.0], (b, v)), 0.0).astype(np.float32)
    bp, jbp = _both(params)
    got = sample_batched(torch.from_numpy(logits), bp, generated_mask=torch.from_numpy(mask),
                         logit_bias=torch.from_numpy(bias))
    want = jsampling.sample_batched(jnp.asarray(logits), jbp, None, generated_mask=jnp.asarray(mask),
                                    logit_bias=jnp.asarray(bias))
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(want).tolist()
    # The key changes nothing for greedy rows.
    keyed = sample_batched(torch.from_numpy(logits), bp, KeyStream(3, "cpu").next(),
                           generated_mask=torch.from_numpy(mask), logit_bias=torch.from_numpy(bias))
    assert torch.equal(keyed, got)


def test_apply_repetition_penalty_matches_jax():
    logits = _logits(3, 30, 4)
    mask = np.random.default_rng(4).random((3, 30)) < 0.4
    got = sampling.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(mask), 1.7).numpy()
    want = np.asarray(jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(mask), 1.7))
    np.testing.assert_array_equal(got, want)


def test_greedy_first_index_on_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0]])
    assert sample(logits, SamplingParams()).tolist() == [1, 0]
    bp = BatchedSampling.stack([SamplingParams()] * 2, "cpu")
    assert sample_batched(logits, bp).tolist() == [1, 0]


@pytest.mark.parametrize("row", range(1, len(ROWS)))
@pytest.mark.parametrize("seeded", [False, True])
def test_stochastic_frequencies_match_jax_distribution(row, seeded):
    """20,000 draws of one parameter row at V = 16 (one shared draw over
    20,000 copies of the row; seeded: one seed over 20,000 steps)."""
    n, v = 20000, 16
    logits = _logits(1, v, 10 + row)
    p = ROWS[row]
    jbp = jsampling.BatchedSampling.stack([p])
    target = np.asarray(jsampling.filter_logits_batched(jnp.asarray(logits), jbp))[0]
    probs = np.exp(target - target.max())
    probs /= probs.sum()
    if seeded:
        p = SamplingParams(**{**p.__dict__, "seed": 1234})
    bp = BatchedSampling.stack([p] * n, "cpu")
    steps = torch.arange(n, dtype=torch.int32) if seeded else None
    toks = sample_batched(torch.from_numpy(np.repeat(logits, n, 0)), bp, KeyStream(row, "cpu").next(),
                          step_idx=steps).numpy()
    freq = np.bincount(toks, minlength=v) / n
    assert np.all(freq[np.isneginf(target)] == 0)
    assert np.abs(freq - probs).max() <= 0.02, (freq, probs)


def test_seeded_stream_depends_only_on_seed_and_step():
    """A seeded row draws the same token at the same (seed, step) whatever
    its row, its batchmates or the engine's key; other steps or seeds draw
    other noise."""
    logits = torch.from_numpy(np.repeat(_logits(1, 64, 7), 6, 0))
    p = SamplingParams(temperature=1.5, seed=42)
    other = SamplingParams(temperature=1.5)
    a = sample_batched(logits, BatchedSampling.stack([p, other, p, other, p, p], "cpu"), KeyStream(0, "cpu").next(),
                       step_idx=torch.tensor([3, 3, 3, 9, 3, 4]))
    b = sample_batched(logits[:1], BatchedSampling.stack([p], "cpu"), KeyStream(99, "cpu").next(),
                       step_idx=torch.tensor([3]))
    assert a[0] == a[2] == a[4] == b[0]
    steps = torch.arange(200, dtype=torch.int32)
    many = sample_batched(logits[:1].expand(200, -1), BatchedSampling.stack([p] * 200, "cpu"),
                          KeyStream(5, "cpu").next(), step_idx=steps)
    again = sample_batched(logits[:1].expand(200, -1), BatchedSampling.stack([p] * 200, "cpu"),
                           KeyStream(6, "cpu").next(), step_idx=steps)
    assert torch.equal(many, again) and len(set(many.tolist())) > 5
    reseeded = BatchedSampling.stack([SamplingParams(temperature=1.5, seed=43)] * 200, "cpu")
    assert not torch.equal(sample_batched(logits[:1].expand(200, -1), reseeded, KeyStream(5, "cpu").next(),
                                          step_idx=steps), many)


def test_key_stream_advances_and_rows_differ():
    """Each draw of a key stream has a new key; rows of one unseeded draw
    get independent noise; two streams of one seed agree."""
    s, t = KeyStream(3, "cpu"), KeyStream(3, "cpu")
    keys = [s.next() for _ in range(4)]
    assert len({int(k) for k in keys}) == 4 and int(s.counter) == 4
    assert int(t.next()) == int(keys[0])
    logits = torch.zeros((400, 8))
    toks = sample_batched(logits, BatchedSampling.stack([SamplingParams(temperature=1.0)] * 400, "cpu"), keys[1])
    assert len(set(toks.tolist())) == 8


def test_scalar_sample_matches_batched():
    """``sample`` with one strategy equals ``sample_batched`` with uniform
    rows and the same key (the JAX package's op-for-op claim)."""
    logits = torch.from_numpy(_logits(4, 32, 2))
    mask = torch.from_numpy(np.random.default_rng(2).random((4, 32)) < 0.2)
    for p in ROWS + [SamplingParams(repetition_penalty=2.0), SamplingParams(temperature=0.6, repetition_penalty=1.5)]:
        key = KeyStream(1, "cpu").next()
        want = sample(logits, p, key if p.temperature else None, generated_mask=mask)
        got = sample_batched(logits, BatchedSampling.stack([p] * 4, "cpu"), key if p.temperature else None,
                             generated_mask=mask)
        assert torch.equal(got, want), p


def test_mix32_is_a_32_bit_hash():
    """The hash keeps values in [0, 2**32), is the same as a Python-int
    reference, and spreads consecutive inputs."""
    x = torch.arange(0, 1 << 16, dtype=torch.int64) * 65537
    h = sampling.mix32(x & 0xFFFFFFFF)
    assert int(h.min()) >= 0 and int(h.max()) < 1 << 32

    def ref(v):
        v &= 0xFFFFFFFF
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    assert [int(t) for t in h[:50]] == [ref(int(t)) for t in (x[:50] & 0xFFFFFFFF)]
    assert np.bincount((h >> 28).numpy(), minlength=16).min() > 3500
