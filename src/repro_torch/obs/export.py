"""Export sinks: JSONL event logs, CSV and JSON summaries, MetricsReport.

The port of ``repro.obs.export``. Three consumers share these writers:

* ``launch.serve``: structured JSONL events (``--log-jsonl``), with the
  console line kept as a formatted view of the same event
  (``EventLog``);
* runs that keep their metrics: ``MetricsReport`` summaries written as
  JSON and CSV;
* tests, which round-trip the formats.

Every event is one JSON object a line with at least ``event`` and
``ts`` (unix seconds); numbers stay numbers, and tensors and numpy
values become Python numbers and lists, so no tensor reaches a line.
"""
from __future__ import annotations

import csv
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "JsonlSink",
    "EventLog",
    "MetricsReport",
    "write_summary_json",
    "write_summary_csv",
]


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.dim() == 0 else v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class JsonlSink:
    """Append-only JSON-lines event sink (one object a line)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self.n_events = 0

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(_jsonable(event), sort_keys=True))
        self._f.write("\n")
        self._f.flush()
        self.n_events += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EventLog:
    """Structured events with the console as a formatted view.

    ``emit("serve", echo="{arch}: ...", arch="olmo-1b", ...)`` writes
    the whole event to the JSONL sink (when one is attached) and prints
    the ``echo`` format string, so the console shows what it always did
    while every line gains a machine-readable twin. ``echo=None`` logs
    silently.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 console: bool = True, clock=time.time):
        self.sink = JsonlSink(jsonl_path) if jsonl_path else None
        self.console = console
        self._clock = clock

    def emit(self, event: str, echo: Optional[str] = None,
             **fields) -> None:
        if self.sink is not None:
            self.sink.emit({"event": event, "ts": self._clock(), **fields})
        if self.console and echo is not None:
            print(echo.format(**fields), flush=True)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


def write_summary_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(_jsonable(payload), f, indent=2, sort_keys=True)
        f.write("\n")


def write_summary_csv(path: str, rows: List[dict]) -> None:
    """Rows of flat dicts to CSV, the union of their keys as header."""
    keys: List[str] = []
    for row in rows:
        for k in row:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for row in rows:
            w.writerow({k: _jsonable(row.get(k, "")) for k in keys})


@dataclass
class MetricsReport:
    """Serialisable fold of a ``Collector``."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, dict] = field(default_factory=dict)
    delay_percentiles: Dict[str, dict] = field(default_factory=dict)
    slack_percentiles: Dict[str, dict] = field(default_factory=dict)
    staleness: Dict[str, float] = field(default_factory=dict)
    phases: List[dict] = field(default_factory=list)
    rounds: List[dict] = field(default_factory=list)
    n_events: int = 0

    @classmethod
    def from_collector(cls, collector) -> "MetricsReport":
        delay = {
            f"{policy}@load{load:g}": hist.summary()
            for (policy, load), hist in sorted(collector.delay_hist.items())
        }
        slack = {
            f"{policy}@load{load:g}": hist.summary()
            for (policy, load), hist in sorted(collector.slack_hist.items())
        }
        return cls(
            counters={k: c.total for k, c in sorted(
                collector.counters.items())},
            gauges={k: g.summary() for k, g in sorted(
                collector.gauges.items())},
            delay_percentiles=delay,
            slack_percentiles=slack,
            staleness={str(k): v for k, v in sorted(
                collector.staleness.items())},
            phases=[p.summary() for p in collector.phases],
            rounds=list(collector.rounds),
            n_events=len(collector.events),
        )

    def to_dict(self) -> dict:
        return _jsonable({
            "counters": self.counters,
            "gauges": self.gauges,
            "delay_percentiles": self.delay_percentiles,
            "slack_percentiles": self.slack_percentiles,
            "staleness": self.staleness,
            "phases": self.phases,
            "rounds": self.rounds,
            "n_events": self.n_events,
        })

    def save_json(self, path: str) -> None:
        write_summary_json(path, self.to_dict())

    def phase_rows(self) -> List[dict]:
        """Flat per-phase rows for the CSV."""
        rows = []
        for p in self.phases:
            rows.append({
                "phase": p.get("label", ""),
                "rows": p.get("rows", 0),
                "cycles": p.get("cycles", 0),
                "cap_bits": p.get("cap_bits", 0.0),
                "bg_grant_bits": p.get("bg_grant_bits", 0.0),
                "fl_grant_bits": p.get("fl_grant_bits", 0.0),
                "residual_bits": p.get("residual_bits", 0.0),
                "grant_utilization": p.get("grant_utilization", 0.0),
                "cps_utilization": p.get("cps_utilization", ""),
            })
        return rows

    def save_csv(self, path: str) -> None:
        write_summary_csv(path, self.phase_rows())
