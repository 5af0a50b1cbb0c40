"""A benchmark clip's seconds with and without tracing, and where the card
sits idle, by the program span open on the host across each gap.

    python3 scripts/span_trace.py --seed N --out FILE.json
        [--modes plain,tracer,user]

Run from the root of a checkout (its `bench_port/` and
`video_segment_tpu_torch/` are imported from the working directory, so a
second checkout can be measured with this file).  Needs one CUDA card.
Builds the `c2_272x480.long140` clip from the seed, warms up as the
benchmark does, then segments the whole clip once per mode, each a new
stream through the benchmark's entry:

- `plain`: no profiler;
- `tracer`: under the benchmark harness's `Tracer` (the card's activity
  and the CUDA runtime calls, no host ranges);
- `user`: under a Kineto profiler recording the card's activity, the CUDA
  runtime calls and user-scope `record_function` ranges (the program's
  spans) and no aten op.

Prints and writes each clip's seconds, stage seconds and counters.  Of the last
`user` clip it also writes the device's idle seconds between its busy
intervals, two ways: each gap whole, put down to the innermost span open
on the host across all of it (`idle_by_span`; a gap that no one span
covers, such as one that runs from a stage's end into the next stage, is
counted under "(no span)"), and each idle instant put down to the
innermost span open at that instant (`idle_split_by_span`; instants
outside every span under "(between spans)").  Also: the CUDA runtime
calls by the innermost span open at their start, the device seconds by
the span open when their launch was issued, host-to-device copies (count
and device seconds) by span, and each span's summed range seconds beside the stream's
`stage_seconds`.
"""

import argparse
import bisect
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

NO_SPAN = "(no span)"
BETWEEN = "(between spans)"


def _user_profiler():
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd import (ProfilerActivity, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    class Profiler:
        def __enter__(self):
            cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                 False, False, _ExperimentalConfig())
            acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
            _prepare_profiler(cfg, acts)
            _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
            return self

        def __exit__(self, *exc):
            self.events = _disable_profiler().events()
            return False

    return Profiler()


class _Spans:
    """One thread's properly nested ranges: the innermost open at a time,
    and the innermost open across an interval."""

    def __init__(self, ranges):
        self.r = sorted(ranges, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.r]
        self.parent = [None] * len(self.r)
        stack = []
        for i, (s, e, _) in enumerate(self.r):
            while stack and self.r[stack[-1]][1] <= s:
                stack.pop()
            self.parent[i] = stack[-1] if stack else None
            stack.append(i)

        # Where the innermost open span changes: every start and end.
        self.cuts = sorted({t for s, e, _ in self.r for t in (s, e)})
        self.inner = [self.covering(t, t, BETWEEN, strict=True)
                      for t in self.cuts]

    def covering(self, lo, hi, none=NO_SPAN, strict=False):
        """The innermost span open over [lo, hi] (open at lo and not yet
        closed, with `strict`)."""
        i = bisect.bisect_right(self.starts, lo) - 1
        while i is not None and i >= 0:
            s, e, _ = self.r[i]
            if s <= lo and (hi < e if strict else hi <= e):
                return self.r[i][2]
            i = self.parent[i]
        return none

    def split(self, lo, hi):
        """[lo, hi) cut where the innermost open span changes: (name,
        nanoseconds) pieces."""
        k = bisect.bisect_right(self.cuts, lo) - 1
        out, t = [], lo
        while t < hi:
            nxt = self.cuts[k + 1] if k + 1 < len(self.cuts) else hi
            end = min(nxt, hi)
            out.append((self.inner[k] if k >= 0 else BETWEEN, end - t))
            t, k = end, k + 1
        return out


def analyse(events, stage_seconds) -> dict:
    from torch.autograd import DeviceType
    dev, calls, ann = [], [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, end, e.name(), e.correlation_id(),
                            e.linked_correlation_id()))
        elif e.is_user_annotation():
            ann.append((s, end, e.name(), e.start_thread_id()))
        elif e.name().startswith("cuda"):
            calls.append((s, end, e.name(), e.correlation_id()))
    threads: dict = {}
    for a in ann:
        threads[a[3]] = threads.get(a[3], 0) + 1
    main = max(threads, key=threads.get) if threads else None
    spans = _Spans([(s, e, n) for s, e, n, t in ann if t == main])

    dev.sort()
    union, gaps = [], []
    for s, e, *_ in dev:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            if union:
                gaps.append((union[-1][1], s))
            union.append([s, e])
    busy = sum(e - s for s, e in union) * 1e-9
    idle: dict = {}
    split: dict = {}
    for gs, ge in gaps:
        name = spans.covering(gs, ge)
        sec, n = idle.get(name, (0.0, 0))
        idle[name] = (sec + (ge - gs) * 1e-9, n + 1)
        for piece, ns in spans.split(gs, ge):
            split[piece] = split.get(piece, 0.0) + ns * 1e-9

    call_span, by_call = {}, {}
    for s, e, n, corr in calls:
        name = spans.covering(s, s)
        call_span[corr] = name
        by_call.setdefault(name, {})
        by_call[name][n] = by_call[name].get(n, 0) + 1
    dev_by_span, htod = {}, {}
    for s, e, n, corr, linked in dev:
        name = call_span.get(corr, call_span.get(linked, NO_SPAN))
        dev_by_span[name] = dev_by_span.get(name, 0.0) + (e - s) * 1e-9
        if "HtoD" in n:
            sec, k = htod.get(name, (0.0, 0))
            htod[name] = (sec + (e - s) * 1e-9, k + 1)

    ranges: dict = {}
    for s, e, n, t in ann:
        ranges[n] = ranges.get(n, 0.0) + (e - s) * 1e-9
    return {
        "device_events": len(dev), "runtime_calls": len(calls),
        "spans": len(ann), "span_threads": threads,
        "window_s": ((union[-1][1] - union[0][0]) * 1e-9 if union
                     else 0.0),
        "busy_s": busy, "gaps": len(gaps),
        "idle_by_span": sorted(([k, v[0], v[1]] for k, v in idle.items()),
                               key=lambda x: -x[1]),
        "idle_split_by_span": sorted(split.items(), key=lambda x: -x[1]),
        "calls_by_span": by_call,
        "device_s_by_span": sorted(dev_by_span.items(), key=lambda x: -x[1]),
        "htod_by_span": {k: {"device_s": v[0], "copies": v[1]}
                         for k, v in htod.items()},
        "range_s_vs_stage_s": {k: [v, stage_seconds.get(k)]
                               for k, v in sorted(ranges.items())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--modes", default="plain,tracer,user")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    from bench_port import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    _, cell, config, traffic, _ = harness.load_cell("c2_272x480.long140")
    frames = harness.make_clip(traffic, config, args.seed)[0]
    work = tempfile.mkdtemp(prefix="span_trace_")
    entry_mod = importlib.import_module(
        f"bench_port.entries.{traffic['entry']}")
    entry = entry_mod.Entry(config, "cuda", work)
    # The entry returns stage seconds; the counters are read off the
    # stream it makes (a program without them gives None).
    from video_segment_tpu_torch import api
    streams = []
    make = api.segment_frames

    def segment_frames(*a, **k):
        streams.append(make(*a, **k))
        return streams[-1]

    api.segment_frames = segment_frames
    pb = os.path.join(work, "clip.pb")
    entry.run_clip(entry.prepare(frames[:traffic["warmup_frames"]]), pb)
    clip_in = entry.prepare(frames)
    out = {"cwd": os.getcwd(), "seed": args.seed,
           "card": torch.cuda.get_device_name(), "clips": []}
    for mode in args.modes.split(","):
        prof = {"plain": None, "tracer": harness.Tracer(True),
                "user": _user_profiler()}[mode]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if prof is None:
            clip = entry.run_clip(clip_in, pb)
            torch.cuda.synchronize()
            clip_s = time.monotonic() - t0
            stop_s = 0.0
        else:
            with prof:
                clip = entry.run_clip(clip_in, pb)
                torch.cuda.synchronize()
                clip_s = time.monotonic() - t0
            stop_s = time.monotonic() - t0 - clip_s
        rec = {"mode": mode, "frames": clip["frames"], "clip_s": clip_s,
               "profiler_stop_s": stop_s,
               "stage_seconds": clip["stage_seconds"],
               "counters": getattr(streams[-1], "counters", None)}
        print(f"[span_trace] {mode}: {clip['frames']} frames in "
              f"{clip_s:.3f} s (profiler stop {stop_s:.1f} s); counters "
              f"{rec['counters']}", flush=True)
        if mode == "user":
            rec["trace"] = analyse(prof.events, clip["stage_seconds"])
            del prof
        out["clips"].append(rec)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    last = [c for c in out["clips"] if "trace" in c]
    if last:
        t = last[-1]["trace"]
        print(f"[span_trace] user trace: busy {t['busy_s']:.3f} s of "
              f"{t['window_s']:.3f} s, {t['gaps']} gaps, {t['spans']} "
              f"ranges on threads {t['span_threads']}")
        for name, sec, n in t["idle_by_span"]:
            print(f"[span_trace] idle {name}: {sec:.4f} s in {n} gaps")
        for name, sec in t["idle_split_by_span"]:
            print(f"[span_trace] idle, split, {name}: {sec:.4f} s")
        for name, calls in sorted(t["calls_by_span"].items()):
            print(f"[span_trace] calls in {name}: {calls}")
        print(f"[span_trace] device s by span: {t['device_s_by_span']}")
        print(f"[span_trace] HtoD by span: {t['htod_by_span']}")
        print(f"[span_trace] range s vs stage s: "
              f"{t['range_s_vs_stage_s']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
