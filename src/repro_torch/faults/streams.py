"""Counter-based fault streams: threefry uniforms keyed per fault event.

Every fault decision is a pure function of ``(seed, fault_class, round,
entity)`` (entity: a client id for dropout and loss draws, a PON index
for outage windows), drawn through the Threefry-2x32 core of the
arrival sampler (``kernels.traffic.ref.threefry2x32``) on CPU tensors:
these are host decisions, made once a round. Streams are O(1)-seekable
(round ``r`` is addressed directly) and chunk-invariant (one entity or
a batch of them draw the same values each).

The seed fills one key word, the fault class Weyl-shifts both words and
the per-case seed mixes in through a third Weyl constant; all three
differ from every traffic-sampler constant, so a fault stream never
aliases an arrival stream.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import MASK32
from repro_torch.kernels.traffic.ref import threefry2x32

# fault classes (the stream key's class word)
FAULT_DROPOUT = 0                 # a client dies mid-upload
FAULT_OUTAGE = 1                  # an ONU/link outage window (per PON)
FAULT_LOSS = 2                    # an update payload lost or corrupted

# Weyl constants: xxhash PRIME32_1/2 and a splitmix increment, distinct
# from the traffic sampler's
_CLASS_WEYL_0 = 0x9E3779B1
_CLASS_WEYL_1 = 0x85EBCA77
_CASE_WEYL = 0x6C8E9CF5

_INV_2_32 = float(2.0 ** -32)


def fault_key(seed: int, fault_class: int, case_seed: int = 0,
              ) -> Tuple[int, int]:
    """uint32 key words of one ``(seed, fault_class, case)`` stream."""
    eff = (int(seed) + int(case_seed) * _CASE_WEYL) & MASK32
    k0 = (eff + int(fault_class) * _CLASS_WEYL_0) & MASK32
    k1 = ((int(fault_class) + 1) * _CLASS_WEYL_1) & MASK32
    return k0, k1


def _words(seed, fault_class, round_index, ent: np.ndarray, case_seed):
    """The two raw uint32 words (int64 tensors) of each entity's draw."""
    k0, k1 = fault_key(seed, fault_class, case_seed)
    c1 = torch.as_tensor(ent & MASK32, dtype=torch.int64)
    c0 = torch.full_like(c1, int(round_index) & MASK32)
    return threefry2x32(torch.tensor(k0), torch.tensor(k1), c0, c1)


def fault_uniforms(seed: int, fault_class: int, round_index: int,
                   entity, case_seed: int = 0):
    """Two independent uniforms in (0, 1) per ``(round, entity)`` event.

    ``entity`` is an int or an int array (client ids or PON indices);
    the result matches its shape (floats for an int, float64 numpy
    arrays otherwise). The open-interval map ``(x + 0.5) * 2^-32``, in
    float64, makes ``rate=0.0`` never fire and ``rate=1.0`` always fire.
    """
    ent = np.atleast_1d(np.asarray(entity, np.int64))
    x0, x1 = _words(seed, fault_class, round_index, ent, case_seed)
    u0 = ((x0.to(torch.float64) + 0.5) * _INV_2_32).numpy()
    u1 = ((x1.to(torch.float64) + 0.5) * _INV_2_32).numpy()
    if np.ndim(entity) == 0:
        return float(u0[0]), float(u1[0])
    return u0, u1


def fault_fingerprint(seed: int, fault_class: int, round_index: int,
                      n_entities: int, case_seed: int = 0) -> int:
    """The raw stream words of entities ``0..n-1`` XOR-reduced into one
    64-bit value: a pinned regression value for the stream's bits."""
    ent = np.arange(n_entities, dtype=np.int64)
    x0, x1 = _words(seed, fault_class, round_index, ent, case_seed)
    out = 0
    for a, b in zip(x0.tolist(), x1.tolist()):
        out ^= (int(a) << 32) | int(b)
    return out
