"""Metrics on the device: counters, gauges, streaming histograms.

The port of ``repro.obs.metrics``. The accumulators are float64 tensors
on an explicit ``device``, shaped ``(B, ...)`` over the engine's row
axis (sweep cells, ``(case, pon)`` pairs or folded ``(case, round)``
rows), and are updated with a handful of tensor reductions. Reading
them (``total``, ``summary``, ``percentile``) copies their state to the
host once and folds it there with the reference's numpy code, so a
report equals the reference's given equal state.

* ``CounterArray``: additive totals;
* ``GaugeArray``: last/min/max/sum/count of an observed series;
* ``StreamingHistogram``: fixed-edge counts with underflow and overflow
  bins (numpy's binning: ``torch.bucketize(right=True)`` is
  ``searchsorted(side="right")``, and a value on the top edge goes to
  the last interior bin), exact ``n``/``sum``/``min``/``max`` sidecars,
  mergeable, with percentiles interpolated inside bins and clamped to
  the observed extremes.

``PhaseStats`` is one engine phase's accumulators: ``cycle()`` only
appends the tensors it is handed, and every ``_CHUNK`` cycles they are
stacked into ``(C, B)`` blocks and folded, so a cycle costs no host
sync. ``cycle_rows()`` takes a cycle's backlogs and grants as ``(B, N)``
rows instead; their row sums are taken at the fold, every buffered
cycle's in one ``np_sum`` (``np.sum(axis=1)``'s order, so they equal the
reference's bit for bit). ``Collector`` is the hub the simulation stack threads through;
``collector=None`` (the default everywhere) leaves every output bitwise
unchanged.

Order of sums: sums over the cycles of a block (bit totals, gauge and
histogram sums) are ``torch.sum``'s, which may add in another order
than numpy's (a total agrees with the reference's to rel 1e-12); bins,
counts, cycles, minima and maxima are exact, and so are the sums of a
histogram's ``add`` and ``flat`` (``np_sum``: numpy's pairwise order).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, FLOAT, np_sum, resolve_device

__all__ = [
    "CounterArray",
    "GaugeArray",
    "StreamingHistogram",
    "PhaseStats",
    "Collector",
    "DEFAULT_DELAY_EDGES",
    "DEFAULT_UTIL_EDGES",
]

# upload delays: 0.1 s bins to 30 s; utilization: 0..1 in 4% steps.
# Fixed edges keep the accumulators mergeable across phases and rounds.
DEFAULT_DELAY_EDGES = np.round(np.linspace(0.0, 30.0, 301), 6)
DEFAULT_UTIL_EDGES = np.round(np.linspace(0.0, 1.0, 26), 6)


def _host(*tensors) -> List[np.ndarray]:
    """float64 numpy copies of ``tensors`` through one copy to the host
    (int64 counts stay exact below 2**53)."""
    flat = torch.cat([t.reshape(-1).to(FLOAT) for t in tensors]).cpu()
    flat = flat.numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=FLOAT, device=device)


def _shape(shape) -> tuple:
    """A shape given as an int or a sequence, as a tuple."""
    if isinstance(shape, (tuple, list, torch.Size)):
        return tuple(shape)
    return (int(shape),)


# -- the reference's folds, on host copies ------------------------------------

def _gauge_summary(last, vmin, vmax, total, count) -> dict:
    n = int(np.max(count)) if count.size else 0
    if n == 0:
        return {"count": 0}
    return {
        "count": n,
        "mean": float(np.mean(total / np.maximum(count, 1))),
        "min": float(np.min(vmin)),
        "max": float(np.max(vmax)),
        "last": float(np.mean(last)),
    }


def _percentile(edges, counts, n, vmin, vmax, q):
    """``StreamingHistogram.percentile`` of the reference on host state."""
    qs = np.atleast_1d(np.asarray(q, np.float64))
    lead = np.shape(n)
    counts = counts.reshape(-1, counts.shape[-1])
    n = np.asarray(n, np.float64).reshape(-1)
    vmin = np.asarray(vmin, np.float64).reshape(-1)
    vmax = np.asarray(vmax, np.float64).reshape(-1)
    E = edges.size
    # bin supports: underflow/overflow collapse onto observed extremes
    lo = np.concatenate(([0.0], edges))
    hi = np.concatenate((edges, [0.0]))
    out = np.full((counts.shape[0], qs.size), np.nan)
    for b in range(counts.shape[0]):
        if n[b] <= 0:
            continue
        c = counts[b]
        cum = np.cumsum(c)
        targets = qs / 100.0 * n[b]
        idx = np.searchsorted(cum, targets, side="left")
        idx = np.minimum(idx, E)
        prev = np.where(idx > 0, cum[idx - 1], 0.0)
        width = np.where(c[idx] > 0, (targets - prev) / c[idx], 0.0)
        b_lo = lo[idx].copy()
        b_hi = hi[idx].copy()
        # edge bins: the observed extremes bound the support
        b_lo[idx == 0] = vmin[b]
        b_hi[idx == 0] = min(edges[0], vmax[b])
        b_hi[idx == E] = vmax[b]
        b_lo[idx == E] = max(edges[-1], vmin[b])
        est = b_lo + width * (b_hi - b_lo)
        out[b] = np.clip(est, vmin[b], vmax[b])
    out = out.reshape(lead + qs.shape)
    return out if np.ndim(q) or lead else float(out[0])


def _hist_summary(edges, counts, n, total, vmin, vmax,
                  percentiles=(50.0, 95.0, 99.0)) -> dict:
    if np.shape(n):
        # the reference's flat(): batch axes folded into one histogram
        counts = counts.reshape(-1, counts.shape[-1]).sum(axis=0)
        n, total = np.asarray(float(np.sum(n))), float(np.sum(total))
        vmin, vmax = float(np.min(vmin)), float(np.max(vmax))
    nf = float(n)
    out = {"n": nf, "edges": [float(edges[0]), float(edges[-1])],
           "bins": int(edges.size - 1)}
    if nf > 0:
        out.update({"mean": float(total) / nf, "min": float(vmin),
                    "max": float(vmax)})
        for q, v in zip(percentiles, np.atleast_1d(_percentile(
                edges, counts, np.asarray(n), vmin, vmax,
                list(percentiles)))):
            out[f"p{q:g}"] = float(v)
    return out


# -- accumulators --------------------------------------------------------------

class CounterArray:
    """Additive totals, optionally batched ``(B, ...)``."""

    def __init__(self, shape=(), device=DEFAULT_DEVICE):
        self.value = torch.zeros(_shape(shape), dtype=FLOAT,
                                 device=resolve_device(device))

    def add(self, x) -> None:
        self.value += _on(x, self.value.device)

    @property
    def total(self) -> float:
        return float(np.sum(_host(self.value)[0]))


class GaugeArray:
    """Summary of an observed series: last/min/max/sum/count."""

    def __init__(self, shape=(), device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        shape = _shape(shape)
        self.last = torch.zeros(shape, dtype=FLOAT, device=dev)
        self.min = torch.full(shape, torch.inf, dtype=FLOAT, device=dev)
        self.max = torch.full(shape, -torch.inf, dtype=FLOAT, device=dev)
        self.sum = torch.zeros(shape, dtype=FLOAT, device=dev)
        self.count = torch.zeros(shape, dtype=torch.int64, device=dev)

    def _state(self):
        return self.last, self.min, self.max, self.sum, self.count

    def observe(self, x) -> None:
        x = _on(x, self.sum.device)
        self.last = x.expand(self.last.shape).clone()
        torch.minimum(self.min, x, out=self.min)
        torch.maximum(self.max, x, out=self.max)
        self.sum += x
        self.count += 1

    def observe_block(self, block) -> None:
        """Fold ``(C, ...)`` stacked observations (C cycles) at once."""
        block = _on(block, self.sum.device)
        self.last = block[-1].clone()
        torch.minimum(self.min, block.amin(dim=0), out=self.min)
        torch.maximum(self.max, block.amax(dim=0), out=self.max)
        self.sum += block.sum(dim=0)
        self.count += block.shape[0]

    @property
    def mean(self) -> torch.Tensor:
        return self.sum / torch.clamp(self.count, min=1)

    def summary(self) -> dict:
        return _gauge_summary(*_host(*self._state()))


class StreamingHistogram:
    """Fixed-edge streaming histogram with under/overflow bins.

    ``edges`` (strictly increasing, length ``E``, kept on the host and
    on ``device``) make ``E - 1`` interior bins; ``counts`` has ``E + 1``
    slots, slot 0 for values below ``edges[0]`` and slot ``E`` for
    values above ``edges[-1]``, the interior half-open like
    ``np.histogram``'s with the last bin closed. With a ``batch_shape``
    the counts are ``(B, ..., E + 1)`` and ``add`` takes each value's
    leading row index.
    """

    def __init__(self, edges: Sequence[float], batch_shape=(),
                 device=DEFAULT_DEVICE):
        edges = np.asarray(edges, np.float64)
        if edges.ndim != 1 or edges.size < 2:
            raise ValueError("edges must be a 1-D array of >= 2 values")
        if np.any(np.diff(edges) <= 0):
            raise ValueError("edges must be strictly increasing")
        dev = resolve_device(device)
        self.edges = edges
        self.device = dev
        self._edges = torch.as_tensor(edges, device=dev)
        lead = _shape(batch_shape)
        self.counts = torch.zeros(lead + (edges.size + 1,), dtype=FLOAT,
                                  device=dev)
        self.n = torch.zeros(lead, dtype=FLOAT, device=dev)
        self.sum = torch.zeros(lead, dtype=FLOAT, device=dev)
        self.vmin = torch.full(lead, torch.inf, dtype=FLOAT, device=dev)
        self.vmax = torch.full(lead, -torch.inf, dtype=FLOAT, device=dev)

    def _state(self):
        return self.counts, self.n, self.sum, self.vmin, self.vmax

    def _bin(self, values: torch.Tensor) -> torch.Tensor:
        # side="right" maps e_i to bin i + 1, so slot 0 is the underflow;
        # a value on the top edge stays in the last interior bin
        idx = torch.bucketize(values, self._edges, right=True)
        return torch.where(values == self._edges[-1], self.edges.size - 1,
                           idx)

    def add(self, values, weights=None, rows=None) -> None:
        """Accumulate ``values`` (any shape); ``rows`` (integer indices,
        the same shape) puts each value in its leading batch row."""
        values = _on(values, self.device).reshape(-1)
        if values.numel() == 0:
            return
        w = (torch.ones_like(values) if weights is None
             else _on(weights, self.device).reshape(-1))
        idx = self._bin(values)
        if rows is None:
            self.counts.index_put_((idx,), w, accumulate=True)
            self.n += np_sum(w[None])[0]
            self.sum += np_sum((values * w)[None])[0]
            self.vmin = torch.minimum(self.vmin, values.min())
            self.vmax = torch.maximum(self.vmax, values.max())
        else:
            rows = torch.as_tensor(rows, dtype=torch.int64,
                                   device=self.device).reshape(-1)
            self.counts.index_put_((rows, idx), w, accumulate=True)
            self.n.index_put_((rows,), w, accumulate=True)
            self.sum.index_put_((rows,), values * w, accumulate=True)
            self.vmin.scatter_reduce_(0, rows, values, "amin")
            self.vmax.scatter_reduce_(0, rows, values, "amax")

    def add_block_per_row(self, block) -> None:
        """Accumulate a ``(C, B)`` block, one value per batch row per
        cycle: ``C`` calls of ``add(block[c], rows=arange(B))`` as one
        scatter over ``row * (E + 1) + bin``."""
        block = _on(block, self.device)
        if block.numel() == 0:
            return
        C, B = block.shape
        nbins = self.edges.size + 1
        flat = (self._bin(block)
                + torch.arange(B, device=self.device) * nbins).reshape(-1)
        self.counts.view(-1).scatter_add_(
            0, flat, torch.ones(flat.shape, dtype=FLOAT, device=self.device))
        self.n += C
        self.sum += block.sum(dim=0)
        torch.minimum(self.vmin, block.amin(dim=0), out=self.vmin)
        torch.maximum(self.vmax, block.amax(dim=0), out=self.vmax)

    def merge(self, other: "StreamingHistogram") -> None:
        if not np.array_equal(self.edges, other.edges):
            raise ValueError("cannot merge histograms with differing edges")
        self.counts += other.counts
        self.n += other.n
        self.sum += other.sum
        self.vmin = torch.minimum(self.vmin, other.vmin)
        self.vmax = torch.maximum(self.vmax, other.vmax)

    def flat(self) -> "StreamingHistogram":
        """Batch axes collapsed into one histogram."""
        out = StreamingHistogram(self.edges, device=self.device)
        out.counts = self.counts.reshape(-1, self.counts.shape[-1]).sum(0)
        out.n = np_sum(self.n.reshape(1, -1))[0]
        out.sum = np_sum(self.sum.reshape(1, -1))[0]
        out.vmin = self.vmin.min()
        out.vmax = self.vmax.max()
        return out

    def percentile(self, q):
        """Percentile estimate(s) by linear interpolation inside bins,
        on the host: ``(...,) + q.shape`` numpy arrays for batched
        histograms, a float for one ``q`` of an unbatched one."""
        counts, n, _, vmin, vmax = _host(*self._state())
        return _percentile(self.edges, counts, n, vmin, vmax, q)

    def summary(self, percentiles=(50.0, 95.0, 99.0)) -> dict:
        return _hist_summary(self.edges, *_host(*self._state()),
                             percentiles=percentiles)


class PhaseStats:
    """Per-phase engine accumulators over the ``(B,)`` row axis.

    One a ``_run_phase`` call. Every polling cycle is handed over with
    fresh tensors (or tensors the engine never writes), which are only
    buffered: ``cycle(...)`` takes ``(B,)`` row sums, ``cycle_rows(...)``
    the ``(B, N)`` rows they sum. Every ``_CHUNK`` cycles (or
    ``_ROW_BUDGET`` buffered row elements) ``_flush`` sums the rows of
    every buffered cycle in one ``np_sum``, stacks the sums into
    ``(C, B)`` blocks and folds them with tensor reductions.
    ``summary()`` flushes the tail and copies the state to the host
    once. ``cycles`` is a host count.
    """

    _CHUNK = 1024              # cycles buffered between folds
    _ROW_BUDGET = 1 << 24      # buffered row elements (128 MiB) a fold

    def __init__(self, label: str, n_rows: int,
                 util_edges=DEFAULT_UTIL_EDGES, device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.label = label
        self.n_rows = n_rows
        self.device = dev
        self.cycles = np.zeros(n_rows, np.int64)
        self.cap_bits = CounterArray(n_rows, dev)        # offered capacity
        self.bg_backlog = GaugeArray(n_rows, dev)        # per-cycle bg depth
        self.fl_backlog = GaugeArray(n_rows, dev)        # per-cycle FL depth
        self.bg_grant_bits = CounterArray(n_rows, dev)
        self.fl_grant_bits = CounterArray(n_rows, dev)
        self.residual_bits = CounterArray(n_rows, dev)   # unused capacity
        self.util = StreamingHistogram(util_edges, (n_rows,), dev)
        self.cps_want_bits = CounterArray(n_rows, dev)   # CPS demand (row)
        self.cps_eff_bits = CounterArray(n_rows, dev)    # CPS share granted
        self._buf: list = []
        self._row_elems = 0
        self._zero = torch.zeros(n_rows, dtype=FLOAT, device=dev)

    def cycle(self, cap, bg_backlog=None, fl_backlog=None,
              bg_grants=None, fl_grants=None,
              cps_want=None, cps_eff=None) -> None:
        self._buf.append((cap, bg_backlog, fl_backlog, bg_grants,
                          fl_grants, cps_want, cps_eff))
        if len(self._buf) >= self._CHUNK:
            self._flush()

    _ROW_NAMES = ("bg_backlog", "fl_backlog", "bg_grants", "fl_grants")

    def cycle_rows(self, cap, rows: torch.Tensor, names,
                   cps_want=None, cps_eff=None) -> None:
        """``cycle()`` with the backlogs and grants still ``(B, N)``:
        ``rows`` (a fresh tensor) stacks them ``(len(names) * B, N)`` in
        the order of ``names``, each one of ``cycle()``'s ``bg_backlog``,
        ``fl_backlog``, ``bg_grants``, ``fl_grants``."""
        self._buf.append((cap, rows, tuple(names), cps_want, cps_eff))
        self._row_elems += rows.numel()
        if (len(self._buf) >= self._CHUNK
                or self._row_elems >= self._ROW_BUDGET):
            self._flush()

    def _sum_rows(self) -> list:
        """The buffer with every ``cycle_rows`` entry's rows summed (one
        ``np_sum`` over all of them) into ``cycle()``'s form."""
        raw = [t[1] for t in self._buf if len(t) == 5]
        if not raw:
            return self._buf
        sums = iter(np_sum(torch.cat(raw)).split(self.n_rows))
        out = []
        for t in self._buf:
            if len(t) == 5:
                cap, _, names, cw, ce = t
                got = {name: next(sums) for name in names}
                t = (cap, *(got.get(n) for n in self._ROW_NAMES), cw, ce)
            out.append(t)
        return out

    def _flush(self) -> None:
        if not self._buf:
            return
        B, dev, buf = self.n_rows, self.device, self._sum_rows()
        # the engine hands (B,) caps; a scalar one (direct use) broadcasts
        caps = torch.stack([_on(t[0], dev).expand(B) for t in buf])
        self.cycles += caps.shape[0]
        self.cap_bits.add(caps.sum(dim=0))

        def gather(i):
            vals = [t[i] for t in buf if t[i] is not None]
            return torch.stack(vals) if vals else None

        bgd, fld = gather(1), gather(2)
        if bgd is not None:
            self.bg_backlog.observe_block(bgd)
        if fld is not None:
            self.fl_backlog.observe_block(fld)
        bg_g = torch.stack([self._zero if t[3] is None else t[3]
                            for t in buf])
        fl_g = torch.stack([self._zero if t[4] is None else t[4]
                            for t in buf])
        self.bg_grant_bits.add(bg_g.sum(dim=0))
        self.fl_grant_bits.add(fl_g.sum(dim=0))
        granted = bg_g + fl_g
        self.residual_bits.add(torch.clamp(caps - granted, min=0.0).sum(0))
        self.util.add_block_per_row(
            torch.where(caps > 0, granted / caps, 0.0))
        cw, ce = gather(5), gather(6)
        if cw is not None:
            self.cps_want_bits.add(cw.sum(dim=0))
        if ce is not None:
            self.cps_eff_bits.add(ce.sum(dim=0))
        self._buf = []
        self._row_elems = 0

    def summary(self) -> dict:
        self._flush()
        counters = (self.cap_bits, self.bg_grant_bits, self.fl_grant_bits,
                    self.residual_bits, self.cps_want_bits,
                    self.cps_eff_bits)
        h = _host(*(c.value for c in counters), *self.bg_backlog._state(),
                  *self.fl_backlog._state(), *self.util._state())
        cap, bg_g, fl_g, resid, cps_w, cps_e = (float(np.sum(a))
                                                for a in h[:6])
        grant = bg_g + fl_g
        out = {
            "label": self.label,
            "rows": self.n_rows,
            "cycles": int(self.cycles.max()) if self.n_rows else 0,
            "cap_bits": cap,
            "bg_grant_bits": bg_g,
            "fl_grant_bits": fl_g,
            "residual_bits": resid,
            "grant_utilization": grant / cap if cap > 0 else 0.0,
            "bg_backlog": _gauge_summary(*h[6:11]),
            "fl_backlog": _gauge_summary(*h[11:16]),
            "util_hist": _hist_summary(self.util.edges, *h[16:21]),
        }
        if cps_w > 0:
            out["cps_want_bits"] = cps_w
            out["cps_eff_bits"] = cps_e
            out["cps_utilization"] = cps_e / cps_w
        return out


def _finite(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    return x[np.isfinite(x)]


class Collector:
    """The observability hub threaded through the simulation stack.

    Passing a ``Collector`` to ``simulate`` / ``simulate_round_sweep`` /
    ``simulate_timeline_sweep`` / ``FLNetworkCoSim.run`` turns collection
    on; ``None`` (the default everywhere) leaves every output bitwise
    unchanged. State:

    * ``phases``: a ``PhaseStats`` per engine phase (cycles, backlog
      depths, grant utilization, residual capacity, CPS want/eff), on
      the device the phase ran on;
    * ``delay_hist[(policy, load)]``: FL upload completion times (s into
      the round), on ``device``;
    * ``slack_hist[(policy, load)]``: deadline minus completion of the
      clients that made a deadline;
    * ``staleness``: counts per staleness value across rounds;
    * ``counters``/``gauges``: named accumulators on ``device``;
    * ``rounds``/``events``: per-round and free-form dicts (host);
    * ``tracer``: a span tracer (``obs.trace.SpanTracer``), disabled
      unless one is passed in.
    """

    def __init__(self,
                 delay_edges: Sequence[float] = DEFAULT_DELAY_EDGES,
                 util_edges: Sequence[float] = DEFAULT_UTIL_EDGES,
                 slack_edges: Optional[Sequence[float]] = None,
                 tracer=None,
                 keep_phases: bool = True,
                 device=DEFAULT_DEVICE):
        from repro_torch.obs.trace import SpanTracer

        self.device = resolve_device(device)
        self.delay_edges = np.asarray(delay_edges, np.float64)
        self.util_edges = np.asarray(util_edges, np.float64)
        self.slack_edges = (self.delay_edges - self.delay_edges[-1] / 2
                            if slack_edges is None
                            else np.asarray(slack_edges, np.float64))
        self.tracer = tracer if tracer is not None else SpanTracer(
            enabled=False)
        self.keep_phases = keep_phases
        self.phases: List[PhaseStats] = []
        self.delay_hist: Dict[tuple, StreamingHistogram] = {}
        self.slack_hist: Dict[tuple, StreamingHistogram] = {}
        self.staleness: Dict[int, float] = {}
        self.counters: Dict[str, CounterArray] = {}
        self.gauges: Dict[str, GaugeArray] = {}
        self.rounds: List[dict] = []
        self.events: List[dict] = []

    # -- engine hooks ----------------------------------------------------------

    def phase(self, label: str, n_rows: int, device=None) -> PhaseStats:
        """A phase's accumulators, on ``device`` (the phase's own; by
        default the collector's)."""
        st = PhaseStats(label, n_rows, self.util_edges,
                        self.device if device is None else device)
        if self.keep_phases:
            self.phases.append(st)
        return st

    def _hist(self, table: dict, edges, policy: str, load: float,
              values) -> None:
        values = _finite(values)
        if values.size == 0:
            return
        key = (policy, round(float(load), 6))
        hist = table.get(key)
        if hist is None:
            hist = table[key] = StreamingHistogram(edges,
                                                   device=self.device)
        hist.add(values)

    def record_upload_times(self, policy: str, load: float, times) -> None:
        self._hist(self.delay_hist, self.delay_edges, policy, load, times)

    def record_slack(self, policy: str, load: float, slack) -> None:
        self._hist(self.slack_hist, self.slack_edges, policy, load, slack)

    def record_staleness(self, taus) -> None:
        for t in np.atleast_1d(np.asarray(taus, np.int64)).ravel():
            t = int(t)
            self.staleness[t] = self.staleness.get(t, 0.0) + 1.0

    # -- named metrics ---------------------------------------------------------

    def counter(self, name: str, shape=()) -> CounterArray:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = CounterArray(shape, self.device)
        return c

    def gauge(self, name: str, shape=()) -> GaugeArray:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = GaugeArray(shape, self.device)
        return g

    # -- event streams ---------------------------------------------------------

    def record_round(self, **fields) -> None:
        self.rounds.append(dict(fields))

    def event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})

    # -- reporting -------------------------------------------------------------

    def report(self):
        """Fold everything into a serialisable ``MetricsReport``."""
        from repro_torch.obs.export import MetricsReport

        return MetricsReport.from_collector(self)
