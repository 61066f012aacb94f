"""Deterministic synthetic data (counterpart of ``repro/data/synthetic.py``).

``TokenStream.batch(step, shard, n_shards)`` is a pure function of (seed,
step, shard), so a restart recomputes exactly the batch it would have seen
and a relocated worker regenerates its shard with no coordination.

The stream has the reference's law: a noisy Markov chain over a
vocab-seeded permutation — token ``t+1`` is ``perm[token_t]`` with
probability 1 − noise, else uniform — drawn with ``torch.Generator``s
instead of ``jax.random`` keys.  ``jax.random``'s bits cannot be reproduced
without JAX, so the port's tokens differ from the reference's for the same
seed; tests that compare the two packages feed both the same numpy
batches.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each word in turn)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """→ {"tokens": (B/n_shards, S+1) int64, on the CPU} for the shard."""
        if self.global_batch % n_shards:
            raise ValueError(f"batch {self.global_batch} does not split into "
                             f"{n_shards} shards")
        b = self.global_batch // n_shards
        gen = torch.Generator().manual_seed(_mix(self.seed, step, shard))
        return {"tokens": markov_tokens(gen, b, self.seq_len + 1, self.vocab,
                                        self.noise)}


def markov_tokens(gen: torch.Generator, batch: int, length: int, vocab: int,
                  noise: float) -> torch.Tensor:
    """(batch, length) tokens of the noisy Markov chain; the permutation is
    seeded by the vocab alone, so every batch, shard and step share it."""
    perm = torch.randperm(vocab, generator=torch.Generator().manual_seed(vocab))
    x = torch.randint(0, vocab, (batch,), generator=gen)
    flip = torch.rand((batch, length), generator=gen) < noise
    rnd = torch.randint(0, vocab, (batch, length), generator=gen)
    out = torch.empty((batch, length), dtype=torch.int64)
    for i in range(length):
        x = torch.where(flip[:, i], rnd[:, i], perm[x])
        out[:, i] = x
    return out
