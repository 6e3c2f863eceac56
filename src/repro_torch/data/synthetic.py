"""Synthetic datasets, numpy only, made from a seed (no FEMNIST download);
a copy of the reference package's ``data/synthetic.py``, array for array.

* ``femnist_like``: a 62-class, 28x28 image task with *writer-style* non-IID
  structure: each synthetic "writer" has a private affine style (stroke
  weight, slant, offset) applied to class prototypes — mirroring LEAF
  FEMNIST's per-writer partitioning (arXiv:1812.01097). Learnable but not
  trivial; accuracy saturates with rounds like Fig 2a.

* ``lm_tokens``: a Zipf-distributed Markov token stream for LM smoke tests
  and the ~100M-param example run.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

N_CLASSES = 62
IMG = 28


def _class_prototypes(rng: np.random.Generator) -> np.ndarray:
    """Smooth random prototypes per class: (62, 28, 28)."""
    protos = rng.normal(0.0, 1.0, size=(N_CLASSES, IMG, IMG)).astype(np.float32)
    # low-pass: average pooling smooths into blob-like glyphs
    k = 5
    padded = np.pad(protos, ((0, 0), (k // 2, k // 2), (k // 2, k // 2)),
                    mode="wrap")
    out = np.zeros_like(protos)
    for dy in range(k):
        for dx in range(k):
            out += padded[:, dy : dy + IMG, dx : dx + IMG]
    out /= k * k
    out = (out - out.mean(axis=(1, 2), keepdims=True)) / (
        out.std(axis=(1, 2), keepdims=True) + 1e-6
    )
    return out


def femnist_like(
    n_writers: int,
    samples_per_writer: int,
    seed: int = 0,
    label_skew: float = 0.5,
) -> Tuple[list, Dict[str, np.ndarray]]:
    """Returns (per_writer_datasets, test_set).

    Each writer draws classes from a writer-specific Dirichlet distribution
    (``label_skew`` < 1 -> strong non-IID) and renders prototypes with the
    writer's private style + noise.
    """
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng)
    writers = []
    for w in range(n_writers):
        wrng = np.random.default_rng(seed * 100_003 + w)
        class_probs = wrng.dirichlet(np.full(N_CLASSES, label_skew))
        gain = wrng.uniform(0.6, 1.4)
        bias = wrng.uniform(-0.3, 0.3)
        shift = wrng.integers(-2, 3, size=2)
        labels = wrng.choice(N_CLASSES, size=samples_per_writer, p=class_probs)
        imgs = protos[labels] * gain + bias
        imgs = np.roll(imgs, shift=tuple(shift), axis=(1, 2))
        imgs = imgs + wrng.normal(0, 0.35, size=imgs.shape)
        writers.append(
            {
                "images": imgs[..., None].astype(np.float32),
                "labels": labels.astype(np.int32),
            }
        )
    # test set spans ALL writers' styles (uniform labels): a client fraction
    # that never sees some writers' styles plateaus below full involvement —
    # the paper's Fig 2a saturation effect.
    trng = np.random.default_rng(seed + 777)
    per_writer = max(4, (4 * samples_per_writer) // max(n_writers, 1))
    t_imgs, t_labels = [], []
    for w in range(n_writers):
        wrng = np.random.default_rng(seed * 100_003 + w)
        wrng.dirichlet(np.full(N_CLASSES, label_skew))  # keep stream aligned
        gain = wrng.uniform(0.6, 1.4)
        bias = wrng.uniform(-0.3, 0.3)
        shift = wrng.integers(-2, 3, size=2)
        labels = trng.integers(0, N_CLASSES, size=per_writer)
        imgs = protos[labels] * gain + bias
        imgs = np.roll(imgs, shift=tuple(shift), axis=(1, 2))
        imgs = imgs + trng.normal(0, 0.35, size=imgs.shape)
        t_imgs.append(imgs)
        t_labels.append(labels)
    order = trng.permutation(n_writers * per_writer)
    test = {
        "images": np.concatenate(t_imgs)[order][..., None].astype(np.float32),
        "labels": np.concatenate(t_labels)[order].astype(np.int32),
    }
    return writers, test


def lm_tokens(
    n_tokens: int,
    vocab_size: int,
    seed: int = 0,
    order: int = 1,
) -> np.ndarray:
    """Zipf-Markov token stream: learnable bigram structure."""
    rng = np.random.default_rng(seed)
    # sparse row-stochastic transition with Zipf-ish mass
    fanout = min(32, vocab_size)
    nexts = rng.integers(0, vocab_size, size=(vocab_size, fanout))
    probs = 1.0 / np.arange(1, fanout + 1)
    probs /= probs.sum()
    out = np.empty(n_tokens, dtype=np.int32)
    tok = int(rng.integers(vocab_size))
    choices = rng.choice(fanout, size=n_tokens, p=probs)
    jumps = rng.random(n_tokens) < 0.05
    randoms = rng.integers(0, vocab_size, size=n_tokens)
    for i in range(n_tokens):
        tok = int(randoms[i]) if jumps[i] else int(nexts[tok, choices[i]])
        out[i] = tok
    return out
