"""Plain PyTorch versions of the cycle engine's grant primitives.

* :func:`waterfill_grants_ref` — oldest-first sequential
  ``take = min(backlog, cap)`` grants as stable argsort + prefix-sum
  room, the plain version of the Hopper kernel K2 (``kernel.py``) and
  the mirror of the host engine's ``_waterfill``. Rows whose total
  demand sits at least one bit under capacity keep their backlog
  bitwise.
* :func:`cps_waterfill_ref` — the max-min CPS split across a case's
  PONs, at the closed-form water level.

On the CPU ``torch.cumsum`` adds left to right and the stable
``torch.argsort`` orders ties by index, so both equal the numpy engine
bit for bit; a CUDA ``cumsum`` is a parallel scan and may not.
"""
from __future__ import annotations

import torch

from repro_torch._device import seq_cumsum

CAP_EPS = 1e-9        # the DBAs' "capacity exhausted" threshold


def hard_rows(backlog: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Rows whose demand exceeds ``cap - 1``: only they need the sort."""
    return backlog.sum(dim=1) > cap - 1.0


def waterfill_grants_ref(backlog, hol, cap, hard=None) -> torch.Tensor:
    """Oldest-first waterfill grants ``(R, N)`` float64.

    ``hol`` sorts queues by head-of-line age (float times with ``inf``
    for empty queues, or integer arrival cycles); ``cap`` is the
    per-row capacity ``(R,)``; ``hard`` (optional) the precomputed
    :func:`hard_rows`.
    """
    if hard is None:
        hard = hard_rows(backlog, cap)
    order = torch.argsort(hol, dim=1, stable=True)
    b_s = torch.gather(backlog, 1, order)
    prefix = torch.cumsum(b_s, dim=1)
    room = cap[:, None] - (prefix - b_s)
    g_s = torch.where(room > CAP_EPS, torch.minimum(b_s, room), 0.0)
    g = torch.empty_like(backlog).scatter_(1, order, g_s)
    return torch.where(hard[:, None], g, backlog)


def cps_waterfill_ref(want: torch.Tensor, cap: float) -> torch.Tensor:
    """Max-min fair split of ``cap`` over each row of ``want`` ``(G, P)``.

    Rows within ``cap`` return ``want`` unchanged; over rows sit at the
    water level ``eff_p = min(want_p, mu)``.
    """
    P = want.shape[1]
    over = want.sum(dim=1) > cap + CAP_EPS
    ws = torch.sort(want, dim=1).values
    prev = seq_cumsum(ws) - ws
    # after granting the k smallest demands in full, the rest split the
    # residual evenly; the water level is the first feasible mu_k
    mu_k = (cap - prev) / (P - torch.arange(P, dtype=want.dtype,
                                            device=want.device))
    k = torch.argmax((mu_k <= ws).to(torch.int8), dim=1, keepdim=True)
    mu = torch.gather(mu_k, 1, k)
    return torch.where(over[:, None], torch.minimum(want, mu), want)
