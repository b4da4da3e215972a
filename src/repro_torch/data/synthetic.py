"""Deterministic synthetic datasets (numpy; a copy of ``repro/data/synthetic.py``).

* ``lm_batches`` — zipfian token stream with a planted bigram structure so a
  real LM can reduce loss well below the unigram entropy (the quickstart /
  train_lm examples and the trainer tests rely on this learnability).
* ``classification`` — MNIST/CIFAR-like class-conditional blobs used by the
  paper-figure benchmarks (MLP / ViT / BagNet comparisons): inputs are
  ``mu_class + noise`` with within-class low-rank structure, so both linear
  and deep models show a clean accuracy-vs-budget signal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ClassStream", "LMStream", "classification"]


@dataclasses.dataclass
class LMStream:
    vocab: int
    seed: int = 0
    alpha: float = 1.1  # zipf exponent

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # planted deterministic bigram successor table on top of zipf unigrams
        self._succ = rng.integers(0, self.vocab, size=(self.vocab,), dtype=np.int32)
        w = (np.arange(1, self.vocab + 1, dtype=np.float64)) ** (-self.alpha)
        self._p = w / w.sum()

    def batches(self, batch: int, seq: int, *, start_step: int = 0, p_bigram: float = 0.8):
        """Infinite iterator of {tokens, labels} (labels = next token)."""
        step = start_step
        while True:
            rng = np.random.default_rng((self.seed, step))
            toks = np.empty((batch, seq + 1), np.int32)
            toks[:, 0] = rng.choice(self.vocab, size=batch, p=self._p)
            for t in range(seq):
                follow = rng.random(batch) < p_bigram
                rand = rng.choice(self.vocab, size=batch, p=self._p)
                toks[:, t + 1] = np.where(follow, self._succ[toks[:, t]], rand)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1


@dataclasses.dataclass
class ClassStream:
    """Infinite ``{"x", "y"}`` batch iterator over :func:`classification`
    blobs — the §5 MLP's data in the shape ``train_loop`` consumes (each
    batch is a fresh seeded draw, deterministic in ``(seed, step)``)."""

    dim: int = 784
    n_classes: int = 10
    seed: int = 0
    noise: float = 1.0

    def batches(self, batch: int, *, start_step: int = 0):
        step = start_step
        while True:
            x, y = classification(batch, self.dim, self.n_classes,
                                  seed=(self.seed * 100003 + step),
                                  noise=self.noise)
            yield {"x": x, "y": y}
            step += 1


def classification(n: int, dim, n_classes: int, *, seed: int = 0, noise: float = 1.0,
                   flatten: bool = True, mu_seed: int = 1234, mu_scale: float = 0.15):
    """Class-conditional gaussian blobs. dim: int (MLP) or (H, W, C) image.

    Class means are drawn from ``mu_seed`` (shared between train/test splits
    that differ only in ``seed``); per-coordinate separation ``mu_scale`` is
    small relative to ``noise`` so the task is non-trivial (chance ≈ 1/C,
    bayes-optimal well above — deep nets show a clean accuracy-vs-budget
    signal instead of saturating).
    """
    rng_mu = np.random.default_rng(mu_seed)
    rng = np.random.default_rng(seed)
    d = int(np.prod(dim))
    mu = rng_mu.normal(size=(n_classes, d)).astype(np.float32) * mu_scale
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = mu[y] + rng.normal(size=(n, d)).astype(np.float32) * noise
    if not flatten and not np.isscalar(dim):
        x = x.reshape((n,) + tuple(dim))
    return x, y
