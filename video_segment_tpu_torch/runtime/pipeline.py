"""Threaded host pipeline with bounded queues and rate telemetry.

Host-side equivalent of the reference streaming runtime
(video_framework/video_pipeline.{h,cpp} + concurrent_queue.h): a chain of
stages, each running on its own thread, joined by bounded producer/consumer
queues.  Backpressure is structural — a full queue blocks the producer
(the reference instead throttles the root's frame rate against queue depth,
video_unit.cpp:411-454; with a blocking bounded queue the effect is the
same in steady state).  The reference's tunable rate control exists on top
of that as `RatePolicy` (video_unit.h:309-340): a source fps cap plus a
dynamic feedback loop that tracks the slowest stage and throttles against
queue depth — see `Pipeline(rate_policy=...)`.

Telemetry mirrors VideoUnit's measurement scheme: per-stage processing time
over a sliding window (video_unit.cpp:348-387) exposed as rates, plus live
queue depths (VideoPipelineStats, video_pipeline.cpp:184-277).

Failure semantics: the first stage exception aborts the whole pipeline —
every blocked put/get wakes up via a shared abort flag, `run()` re-raises
the original error promptly, and no thread is left wedged on a full queue
(the reference simply CHECK-fails the process; we unwind cleanly instead).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

_SENTINEL = object()
_POLL = 0.05  # abort-check period for blocked queue ops (seconds)


class _Aborted(Exception):
    """Internal: a blocked queue op observed the pipeline abort flag."""


@dataclasses.dataclass
class RatePolicy:
    """Source-side rate control (reference video_unit.h:309-340).

    max_rate caps the source feed rate in fps (0 = unlimited).  With
    dynamic_rate, after `startup_frames` frames and every `update_interval`
    seconds the cap is re-derived from the slowest stage's measured rate
    times `dynamic_rate_scale`; if the deepest queue exceeds
    `queue_throttle_threshold`, the rate is halved for every
    `num_throttle_frames` of excess (video_unit.cpp:427-447), floored at
    `min_throttle_rate` of the base rate to avoid stalling.
    """

    max_rate: float = 0.0
    dynamic_rate: bool = False
    dynamic_rate_scale: float = 1.0
    startup_frames: int = 0
    update_interval: float = 0.0
    queue_throttle_threshold: int = 8
    num_throttle_frames: int = 4
    min_throttle_rate: float = 0.2


class StageStats:
    """Sliding-window rate measurement (64 samples, like the reference)."""

    def __init__(self, name: str, window: int = 64):
        self.name = name
        self.times = collections.deque(maxlen=window)
        self.processed = 0

    def record(self, dt: float):
        self.times.append(dt)
        self.processed += 1

    @property
    def rate(self) -> float:
        if not self.times:
            return 0.0
        total = sum(self.times)
        return len(self.times) / total if total > 0 else 0.0


class Stage:
    """One pipeline stage: fn(item) -> iterable of outputs (or None).

    `flush()` on the underlying object (if present) is called after the
    input stream ends, producing trailing outputs — matching the reference
    units' flush-on-EOS ProcessFrame(flush=true) convention.
    """

    def __init__(self, name: str,
                 fn: Callable[[Any], Iterable | None],
                 flush: Callable[[], Iterable | None] | None = None):
        self.name = name
        self.fn = fn
        self.flush = flush
        self.stats = StageStats(name)


class Pipeline:
    """stages[0] consumes the source iterator; outputs of the last stage
    are yielded from run()."""

    def __init__(self, stages: list[Stage], queue_size: int = 10,
                 rate_policy: RatePolicy | None = None):
        self.stages = stages
        self.queue_size = queue_size
        self.rate_policy = rate_policy or RatePolicy()
        self.queues: list[queue.Queue] = []
        self._threads: list[threading.Thread] = []
        self._error: BaseException | None = None
        self._abort = threading.Event()

    # -- abort-aware bounded queue ops ------------------------------------
    def _put(self, q: queue.Queue, item):
        while True:
            if self._abort.is_set():
                raise _Aborted
            try:
                q.put(item, timeout=_POLL)
                return
            except queue.Full:
                continue

    def _get(self, q: queue.Queue):
        while True:
            if self._abort.is_set():
                raise _Aborted
            try:
                return q.get(timeout=_POLL)
            except queue.Empty:
                continue

    def _fail(self, e: BaseException):
        if self._error is None:
            self._error = e
        self._abort.set()

    # -- workers -----------------------------------------------------------
    def _worker(self, stage: Stage, q_in: queue.Queue, q_out: queue.Queue):
        try:
            while True:
                item = self._get(q_in)
                if item is _SENTINEL:
                    break
                t0 = time.monotonic()
                out = stage.fn(item)
                stage.stats.record(time.monotonic() - t0)
                if out is not None:
                    for o in out:
                        self._put(q_out, o)
            if stage.flush is not None:
                t0 = time.monotonic()
                out = stage.flush()
                stage.stats.record(time.monotonic() - t0)
                if out is not None:
                    for o in out:
                        self._put(q_out, o)
            self._put(q_out, _SENTINEL)
        except _Aborted:
            pass
        except BaseException as e:  # propagate to run()
            self._fail(e)

    def _current_rate(self, fed: int, last_update: float) -> tuple[float,
                                                                   float]:
        """Dynamic-rate feedback (video_unit.cpp:411-454): slowest stage
        rate x dynamic_rate_scale, throttled against the deepest queue."""
        rp = self.rate_policy
        now = time.monotonic()
        if (fed < rp.startup_frames
                or now - last_update < rp.update_interval):
            return rp.max_rate, last_update
        rates = [st.stats.rate for st in self.stages if st.stats.times]
        if not rates:
            return rp.max_rate, now
        min_rate = min(rates)
        max_queue = max(q.qsize() for q in self.queues)
        scale = 1.0
        if max_queue > rp.queue_throttle_threshold:
            scale = 0.5 ** ((max_queue - rp.queue_throttle_threshold)
                            / rp.num_throttle_frames)
            scale = max(scale, rp.min_throttle_rate)
        return min_rate * scale * rp.dynamic_rate_scale, now

    def _feed(self, source: Iterable):
        rp = self.rate_policy
        rate = rp.max_rate
        last_update = time.monotonic()
        last_put = 0.0
        fed = 0
        try:
            for item in source:
                if rp.dynamic_rate:
                    rate, last_update = self._current_rate(fed, last_update)
                if rate and rate > 0:
                    wait = last_put + 1.0 / rate - time.monotonic()
                    while wait > 0:
                        if self._abort.is_set():
                            raise _Aborted
                        time.sleep(min(wait, _POLL))
                        wait = last_put + 1.0 / rate - time.monotonic()
                last_put = time.monotonic()
                self._put(self.queues[0], item)
                fed += 1
            self._put(self.queues[0], _SENTINEL)
        except _Aborted:
            pass
        except BaseException as e:
            self._fail(e)

    def run(self, source: Iterable) -> Iterator:
        n = len(self.stages)
        self.queues = [queue.Queue(maxsize=self.queue_size)
                       for _ in range(n + 1)]
        for i, st in enumerate(self.stages):
            t = threading.Thread(target=self._worker,
                                 args=(st, self.queues[i],
                                       self.queues[i + 1]),
                                 name=f"stage-{st.name}", daemon=True)
            t.start()
            self._threads.append(t)

        feeder = threading.Thread(target=self._feed, args=(source,),
                                  name="source", daemon=True)
        feeder.start()

        q_last = self.queues[-1]
        try:
            while True:
                item = self._get(q_last)
                if item is _SENTINEL:
                    break
                yield item
        except _Aborted:
            pass
        except GeneratorExit:
            # Consumer abandoned the generator: wake every blocked thread
            # so nothing is left wedged on a full queue.
            self._abort.set()
            raise
        feeder.join()
        for t in self._threads:
            t.join()
        if self._error is not None:
            raise self._error

    def status(self) -> str:
        parts = []
        for i, st in enumerate(self.stages):
            depth = self.queues[i].qsize() if self.queues else 0
            parts.append(f"{st.name}[q={depth} n={st.stats.processed} "
                         f"{st.stats.rate:.1f}/s]")
        return " -> ".join(parts)


class Unit:
    """Node of a processing tree (the reference's VideoUnit,
    video_unit.h:343-510): `fn(item)` yields outputs that are passed to
    EVERY child (video_unit.cpp:228-239 hands each FrameSet to all
    children), `flush()` produces trailing outputs at end-of-stream, and
    `seek(pts) -> bool` repositions the unit — children are re-seeked only
    when it returns True (video_unit.cpp:251-263; the reference's default
    SeekImpl returns true).

    Items fan out by reference, not by copy — children must treat inputs
    as read-only, the same shared-FrameSetPtr contract the reference has.
    Leaves collect by default: their outputs are yielded from
    UnitTree.run() tagged with the unit name.
    """

    def __init__(self, name: str,
                 fn: Callable[[Any], Iterable | None] | None = None,
                 flush: Callable[[], Iterable | None] | None = None,
                 seek: Callable[[int], bool] | None = None,
                 collect: bool | None = None):
        self.stage = Stage(name, fn if fn is not None else (lambda x: [x]),
                           flush)
        self._seek_impl = seek
        self.children: list[Unit] = []
        self.collect = collect

    @property
    def name(self) -> str:
        return self.stage.name

    def add_child(self, child: "Unit") -> "Unit":
        """Attach `child` below this unit (AttachTo, video_unit.cpp:150);
        returns the child so chains read root.add_child(a).add_child(b)."""
        self.children.append(child)
        return child

    def seek(self, pts: int = 0) -> bool:
        """Tree-wide Seek (video_unit.cpp:251-263): reposition this unit,
        then re-seek children only if the position changed.  Call between
        runs — units are not required to handle mid-stream seeks."""
        changed = (self._seek_impl(pts) if self._seek_impl is not None
                   else True)
        if changed:
            for child in self.children:
                child.seek(pts)
        return changed

    def walk(self) -> Iterator["Unit"]:
        yield self
        for child in self.children:
            yield from child.walk()


class UnitTree(Pipeline):
    """Threaded runner for a `Unit` tree: one worker thread per unit, a
    bounded queue per tree edge, outputs fanned out to every child.  The
    linear `Pipeline` is the single-child special case; rate policy,
    telemetry, and the abort-on-failure semantics are shared.

    run() yields `(unit_name, item)` for every output of a collecting
    unit (leaves by default; pass collect=True/False to override).
    """

    def __init__(self, root: Unit, queue_size: int = 10,
                 rate_policy: RatePolicy | None = None):
        self.root = root
        units = list(root.walk())
        names = [u.name for u in units]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate unit names: {names}")
        super().__init__([u.stage for u in units], queue_size=queue_size,
                         rate_policy=rate_policy)
        self._units = units

    def _tree_worker(self, unit: Unit, q_in: queue.Queue,
                     q_children: list[queue.Queue],
                     q_collect: queue.Queue | None):
        def emit(out):
            if out is None:
                return
            for o in out:
                for qc in q_children:
                    self._put(qc, o)
                if q_collect is not None:
                    self._put(q_collect, (unit.name, o))

        try:
            while True:
                item = self._get(q_in)
                if item is _SENTINEL:
                    break
                t0 = time.monotonic()
                emit(unit.stage.fn(item))
                unit.stage.stats.record(time.monotonic() - t0)
            if unit.stage.flush is not None:
                t0 = time.monotonic()
                emit(unit.stage.flush())
                unit.stage.stats.record(time.monotonic() - t0)
            for qc in q_children:
                self._put(qc, _SENTINEL)
            if q_collect is not None:
                self._put(q_collect, _SENTINEL)
        except _Aborted:
            pass
        except BaseException as e:
            self._fail(e)

    def run(self, source: Iterable) -> Iterator:
        in_q = {u.name: queue.Queue(maxsize=self.queue_size)
                for u in self._units}
        collectors = [u for u in self._units
                      if (not u.children if u.collect is None
                          else u.collect)]
        out_q = queue.Queue(maxsize=max(self.queue_size,
                                        len(collectors) or 1))
        # queues[0] must be the root input (the feeder and the dynamic-rate
        # policy address it); the rest feed depth telemetry.
        self.queues = [in_q[self.root.name]] + \
            [q for n, q in in_q.items() if n != self.root.name] + [out_q]
        collect_set = {u.name for u in collectors}
        for u in self._units:
            t = threading.Thread(
                target=self._tree_worker,
                args=(u, in_q[u.name],
                      [in_q[c.name] for c in u.children],
                      out_q if u.name in collect_set else None),
                name=f"unit-{u.name}", daemon=True)
            t.start()
            self._threads.append(t)

        feeder = threading.Thread(target=self._feed, args=(source,),
                                  name="source", daemon=True)
        feeder.start()

        remaining = len(collectors)
        try:
            while remaining > 0:
                item = self._get(out_q)
                if item is _SENTINEL:
                    remaining -= 1
                    continue
                yield item
        except _Aborted:
            pass
        except GeneratorExit:
            self._abort.set()
            raise
        feeder.join()
        for t in self._threads:
            t.join()
        if self._error is not None:
            raise self._error


class StatusPrinter:
    """Periodic pipeline status line (the reference's --pipeline_status)."""

    def __init__(self, pipeline: Pipeline, interval: float = 2.0):
        self.pipeline = pipeline
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(self.interval):
            print(f"[pipeline] {self.pipeline.status()}", flush=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
