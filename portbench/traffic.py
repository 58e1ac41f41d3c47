"""The one traffic generator: it reads a mix (``portbench/traffic/<mix>.json``)
and gives every request or training batch of a run from ``--seed``.

A prefill mix fixes a *cycle* of prompt lengths, the same multiset for
every seed; the seed sets the order within each cycle and the token ids.
So every seed offers the same histogram, the longest request included, and
a run of any length sees whole cycles but for its last one.  Lengths come
from one of two keys of ``"lengths"``:

- ``"list"``: the lengths themselves;
- ``"lognormal"``: ``{"median", "sigma", "min", "max", "strata"}``, one
  length per stratum of equal probability, at the stratum's middle
  quantile, clipped to [min, max] and cut to a whole token (never rounded
  to a tile).

``"always"`` adds lengths that every cycle holds once (the longest request).

A training mix gives ``batch`` and ``seq``; its batches are those of
``SyntheticLMData`` (the port's ``data/pipeline.py``), whose arithmetic is
copied here so that the program receives only the generated inputs.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np


def seed_words(seed: int, *more: int) -> np.random.SeedSequence:
    """A seed sequence from any whole number (the run's ``--seed`` may pass
    32 bits, or be negative) and further words."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]
    return np.random.SeedSequence(words + [int(w) for w in more])


def cycle_lengths(mix: dict) -> List[int]:
    """The prompt lengths of one cycle, sorted."""
    spec = mix["lengths"]
    if "list" in spec:
        lengths = [int(n) for n in spec["list"]]
    else:
        ln = spec["lognormal"]
        dist = statistics.NormalDist(np.log(ln["median"]), ln["sigma"])
        k = ln["strata"]
        lengths = [int(min(max(np.exp(dist.inv_cdf((i + 0.5) / k)),
                               ln["min"]), ln["max"])) for i in range(k)]
    lengths += [int(n) for n in spec.get("always", [])]
    if not lengths or min(lengths) < 1:
        raise ValueError(f"a mix needs positive lengths, got {lengths}")
    return sorted(lengths)


class PrefillTraffic:
    """Request ``i`` of a run: its prompt length and token ids, made on the
    host from (seed, i) alone, so the reference can make them again."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.cycle = cycle_lengths(mix)
        self.vocab = vocab
        self.seed = seed
        self._orders: Dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        c, j = divmod(i, len(self.cycle))
        if c not in self._orders:
            rng = np.random.default_rng(seed_words(self.seed, 1, c))
            self._orders[c] = rng.permutation(len(self.cycle))
        return self.cycle[int(self._orders[c][j])]

    def ids(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(seed_words(self.seed, 2, i))
        return rng.integers(0, self.vocab, size=self.length(i),
                            dtype=np.int64)

    def longest(self) -> int:
        return self.cycle[-1]


def check_sample(lengths: List[int], size: int, seed: int) -> List[int]:
    """Indices of the served requests the correctness check compares:
    the first of the longest, and others drawn from the seed, ``size`` in
    all (or every request, when fewer were served)."""
    if not lengths:
        return []
    first_longest = lengths.index(max(lengths))
    rest = [i for i in range(len(lengths)) if i != first_longest]
    rng = np.random.default_rng(seed_words(seed, 3))
    picked = rng.permutation(len(rest))[:max(size - 1, 0)]
    return sorted([first_longest] + [rest[int(j)] for j in picked])


class TrainBatches:
    """Batch ``step`` of a run: ``SyntheticLMData.batch_at``'s arithmetic
    (a Zipf-like unigram over the first min(vocab, 4096) ids, and with
    probability 1/2 the next token is the current one plus one), seeded by
    (seed, step)."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.batch, self.seq = int(mix["batch"]), int(mix["seq"])
        self.seed = seed
        self.alphabet = min(vocab, 4096)
        ranks = np.arange(1, self.alphabet + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed_words(self.seed, 4, step))
        b, s = self.batch, self.seq
        toks = rng.choice(self.alphabet, size=(b, s + 1), p=self.unigram)
        copy_mask = rng.random((b, s)) < 0.5
        nxt = (toks[:, :-1] + 1) % self.alphabet
        toks[:, 1:] = np.where(copy_mask, nxt, toks[:, 1:])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
