"""Nested span tracer exporting Chrome trace-event JSON.

The port of ``repro.obs.trace``, pure Python on the host clock. The
orchestration of a run (engine phases, timeline rounds, FL training
rounds) is a tree of spans, recorded as Chrome trace-event "X"
(complete) events that Perfetto or ``chrome://tracing`` show. A disabled
tracer is a strict no-op: ``span()`` yields at once and takes no time
stamp, so an instrumented call site costs one attribute check with
tracing off. Spans time the host: a span around device work ends when
the host has queued it, not when the card has run it, unless the work
itself waits for the card.

Format: ``{"traceEvents": [{"name", "ph": "X", "ts", "dur", "pid",
"tid", "cat", "args"}, ...], "displayTimeUnit": "ms"}``, times in
microseconds.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import List

__all__ = ["SpanTracer", "NULL_TRACER", "load_trace", "validate_trace",
           "maybe_span"]

_REQUIRED_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


class SpanTracer:
    """Collects nested spans; ``enabled=False`` is a strict no-op."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._t0 = clock()
        self.events: List[dict] = []
        self._depth = 0
        self._pid = os.getpid()
        self._tid = threading.get_ident() & 0xFFFF

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "repro", **args):
        if not self.enabled:
            yield self
            return
        t_start = self._now_us()
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            self.events.append({
                "name": name,
                "ph": "X",
                "ts": t_start,
                "dur": self._now_us() - t_start,
                "pid": self._pid,
                "tid": self._tid,
                "cat": cat,
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name,
            "ph": "i",
            "ts": self._now_us(),
            "dur": 0.0,
            "pid": self._pid,
            "tid": self._tid,
            "cat": cat,
            "s": "t",
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def to_chrome(self) -> dict:
        return {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_trace(payload: dict) -> List[dict]:
    """Schema check; returns the events (raises on malformed input)."""
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace payload missing 'traceEvents' list")
    for e in events:
        missing = [k for k in _REQUIRED_KEYS if k not in e]
        if missing:
            raise ValueError(f"trace event {e.get('name')!r} missing "
                             f"required keys {missing}")
        if e["ph"] not in ("X", "i", "B", "E", "M"):
            raise ValueError(f"unknown trace phase {e['ph']!r}")
        if e["ph"] == "X" and e["dur"] < 0:
            raise ValueError(f"negative span duration in {e['name']!r}")
    return events


NULL_TRACER = SpanTracer(enabled=False)


def maybe_span(collector, name: str, **args):
    """``collector.tracer.span(...)``, or a no-op context when
    ``collector`` is None: the one line an instrumented call site uses,
    so the disabled path stays one identity check."""
    if collector is None:
        return nullcontext()
    return collector.tracer.span(name, **args)
