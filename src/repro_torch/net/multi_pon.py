"""Multi-PON (wavelength-stacked) topology sharing one CPS uplink.

``n_pons`` wavelength/OLT segments, each a full TDM-PON with its own
cycle capacity and DBA, converge on a CPS link. Per polling cycle the
CPS capacity is waterfilled across the PONs (max-min fair,
:func:`cps_waterfill`, shared with ``kernels/ponsim``; its cap is a
float, or one per row as the tenant jobs' fairness split passes it). Client
``i`` lives on global ONU ``i % (n_pons * cfg.n_onus)``: PON
``onu // cfg.n_onus``, local ONU ``onu % cfg.n_onus``. The per-PON
cycle-level oracle of the JAX package is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.slicing import ClientProfile
from repro_torch.kernels.ponsim.ref import (  # noqa: F401 (re-export)
    cps_waterfill_ref as cps_waterfill,
)
from repro_torch.net.traffic import background_rate_for_load


@dataclass(frozen=True)
class MultiPonTopology:
    """Several OLT/wavelength segments sharing a CPS uplink.

    ``cps_rate_bps`` is the shared CPS link (``None`` = uncontended);
    its cycle capacity is ``rate * cycle_time`` with no PON framing.
    ``pon_rates_bps`` overrides each PON's line rate.
    """

    n_pons: int = 1
    cps_rate_bps: Optional[float] = None
    pon_rates_bps: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.n_pons < 1:
            raise ValueError("n_pons must be >= 1")
        if self.cps_rate_bps is not None and self.cps_rate_bps <= 0:
            raise ValueError("cps_rate_bps must be positive")
        if self.pon_rates_bps is not None:
            rates = tuple(float(r) for r in self.pon_rates_bps)
            if len(rates) != self.n_pons:
                raise ValueError(
                    f"pon_rates_bps needs {self.n_pons} entries; "
                    f"got {len(rates)}"
                )
            object.__setattr__(self, "pon_rates_bps", rates)

    @property
    def trivial(self) -> bool:
        """True when the topology adds nothing over a lone PONConfig."""
        return (self.n_pons == 1 and self.cps_rate_bps is None
                and self.pon_rates_bps is None)

    def rates(self, cfg) -> np.ndarray:
        if self.pon_rates_bps is not None:
            return np.asarray(self.pon_rates_bps, np.float64)
        return np.full(self.n_pons, cfg.line_rate_bps, np.float64)

    def capacity_bits(self, cfg) -> np.ndarray:
        """Per-PON cycle capacity ``(n_pons,)`` (payload bits)."""
        return self.rates(cfg) * cfg.cycle_time_s * cfg.efficiency

    def cps_capacity_bits(self, cfg) -> Optional[float]:
        if self.cps_rate_bps is None:
            return None
        return float(self.cps_rate_bps) * cfg.cycle_time_s

    def total_onus(self, cfg) -> int:
        return self.n_pons * cfg.n_onus


def pon_bg_rates(clients: Sequence[ClientProfile], model_bits: float,
                 total_load: float, cfg, topo: MultiPonTopology,
                 t_round_hint: float = 10.0,
                 model_bits_by_client=None) -> np.ndarray:
    """Per-ONU background rate ``(n_pons,)`` of each wavelength segment:
    what makes up ``total_load`` on that PON beside the training traffic
    of the clients placed on it. ``model_bits_by_client`` (tenant jobs)
    prices each client's download at its own job's model size; ``None``
    keeps the single-job arithmetic."""
    rates = topo.rates(cfg)
    total = topo.total_onus(cfg)
    out = np.zeros(topo.n_pons)
    for p in range(topo.n_pons):
        cl = [c for c in clients
              if (c.client_id % total) // cfg.n_onus == p]
        if not cl:
            training_rate = 0.0
        elif model_bits_by_client is not None:
            training_rate = sum(
                model_bits_by_client[c.client_id] + c.m_ud_bits
                for c in cl
            ) / max(t_round_hint, 1e-9)
        else:
            training_rate = (
                len(cl)
                * (model_bits + float(np.mean([c.m_ud_bits for c in cl])))
                / max(t_round_hint, 1e-9)
            )
        out[p] = background_rate_for_load(
            total_load, float(rates[p]), training_rate
        ) / cfg.n_onus
    return out
