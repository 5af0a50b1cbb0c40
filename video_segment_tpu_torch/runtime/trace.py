"""Host spans and counters of one segmentation stream.

A `Trace` accumulates host seconds by span name and integers by counter
name.  `SegmentStream` makes one and hands it to its dense and region
stages and to its flow timer; a stage built alone makes its own.  Two
streams never share a trace, and writes are safe from any thread (the
dense stage's tail worker, the pipeline's stage threads).

    with trace.span("region.levels"):
        ...
    trace.count("region.sets")

A span takes two host clock reads.  While a Kineto profiler records
(`torch.autograd._profiler_enabled()`), it is also a
`torch.profiler.record_function` range of the same name, so it lands in
the profiler's trace on the clock of the card's activity; otherwise no
range is opened.  The range opens before the span's first clock read and
closes after its second, so it holds the span's seconds.  A span adds no
device sync: where the work it times runs on the device, its seconds
include that work only if the block ends in a blocking copy or a sync of
its own.  Names are dotted by nesting:
`region.upload` runs inside `region`.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


class Trace:
    """Host seconds by span name and counts by counter name."""

    now = staticmethod(time.monotonic)

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}
        self._counters: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, start: float | None = None):
        """Time the block under `name`.  `start`, a `now()` reading taken
        earlier, counts the seconds from there instead (a stage that
        begins in one call or thread and ends in another); the profiler's
        range still covers the block alone.  Yields a record whose `end`
        is set when the block exits."""
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        rec = _Span(self.now() if start is None else start)
        try:
            yield rec
        finally:
            rec.end = self.now()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self._seconds[name] = (self._seconds.get(name, 0.0)
                                       + rec.end - rec.start)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    @property
    def seconds(self) -> dict:
        """Host seconds by span name (a copy)."""
        with self._lock:
            return dict(self._seconds)

    @property
    def counters(self) -> dict:
        """Counts by counter name (a copy)."""
        with self._lock:
            return dict(self._counters)

    def summary(self, frames: int) -> str:
        """One line: each span's milliseconds a frame over `frames`, then
        each counter."""
        per = max(frames, 1)
        parts = [f"{k} {1e3 * v / per:.2f}"
                 for k, v in sorted(self.seconds.items())]
        parts += [f"{k} {v}" for k, v in sorted(self.counters.items())]
        return (f"spans (ms a frame over {frames} frames) and counters: "
                + ", ".join(parts))


class _Span:
    __slots__ = ("start", "end")

    def __init__(self, start: float):
        self.start = start
        self.end = None
