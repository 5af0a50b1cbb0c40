"""One run of one cell: set-up, the measured window, the traced clip, the
check of the output against the drawn scene, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: `configs/<config>.json`, `traffic/<traffic>.json` (its
`entry` names the module under `entries/` that drives the port, its
`checks` the modules under `checks/` that add numbers to the check),
`metrics/<metric>.py` and `limits/<cell>.json`.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_port")
BANNED = ("jax", "jaxlib", "flax", "video_segment_tpu")
# Clips of a window whose frames the check parses and compares.
CLIPS_COMPARED = 2


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str) -> tuple:
    """(manifest, cell, config, traffic, limits) of a workload name."""
    manifest = _json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = _json(ROOT, conf["file"])
    traffic = _json(HERE, "traffic", cell["traffic"] + ".json")
    limits = _json(HERE, "limits", workload + ".json")
    return manifest, cell, config, traffic, limits


def cell_metrics(manifest: dict, workload: str, section: str) -> list:
    return [m for m in manifest[section]
            if workload in m.get("workloads", [workload])]


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def window_records(clips: list, t_start: float, setup_s: float,
                   peak: int) -> dict:
    frames = sum(c["frames"] for c in clips)
    lat = [x for c in clips for x in c.get("latencies", [])]
    return {"frames": frames, "seconds": clips[-1]["end"] - t_start,
            "latencies": lat, "peak_bytes": peak, "setup_s": setup_s,
            "clips": len(clips)}


class Tracer:
    """A `torch.profiler` (Kineto) trace of the card's activity and the
    CUDA runtime calls, without host op events (over a million a clip),
    whose raw events are read directly, without the profiler's per-event
    post-processing (minutes for a clip's events)."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler
        self._prof = profiler.profile(use_device="cuda" if cuda else None,
                                      use_cpu=not cuda, use_kineto=True)
        self.events = None

    def __enter__(self):
        self._prof._prepare_trace()
        self._prof._start_trace()
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self.events = _disable_profiler().events()
        return False


def short_name(name: str) -> str:
    """A device op's name, shortened to 100 characters."""
    return name.replace("void ", "").replace("at::native::", "")[:100]


def trace_records(events, window_s: float) -> dict:
    """Device seconds by op, each launch's seconds by kernel, device busy
    seconds and the breakdown of one traced clip from the profiler's raw
    events."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        if e.is_user_annotation():
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    dev.sort()
    by_name: dict = {}
    launches: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        launches.setdefault(n, []).append((e - s) * 1e-9)
    union, gaps = [], []
    for s, e, n in dev:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            if union:
                gaps.append((union[-1][1], s, n))
            union.append([s, e])
    busy = sum(e - s for s, e in union) * 1e-9
    span_s = (union[-1][1] - union[0][0]) * 1e-9 if union else 0.0
    return {"launches": launches, "busy_s": busy, "window_s": window_s,
            "device_span_s": span_s,
            "events": {"device": len(dev), "host": len(host)},
            "breakdown": {
                "device_ops": sorted(([short_name(n), t]
                                      for n, t in by_name.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": _attribute_gaps(gaps, host)}}


def _attribute_gaps(gaps: list, host: list, top: int = 400) -> list:
    """The idle seconds of the `top` longest gaps between device
    intervals, summed by what the host did: the CUDA runtime call that
    covered most of the gap, else "host work before <the device op that
    ended the gap>"; all shorter gaps together; the ten largest."""
    import bisect
    host.sort()
    starts = [s for s, _, _ in host]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out: dict = {}
    for gs, ge, nxt in gaps[:top]:
        best, name = 0, f"host work before {short_name(nxt)}"
        i = bisect.bisect_right(starts, ge)
        for k in range(i - 1, max(i - 2000, -1), -1):
            s, e, n = host[k]
            ov = min(e, ge) - max(s, gs)
            if ov > best and 2 * ov > ge - gs:
                best, name = ov, n
        out[name] = out.get(name, 0.0) + (ge - gs) * 1e-9
    rest = sum(ge - gs for gs, ge, _ in gaps[top:]) * 1e-9
    if rest:
        out[f"{len(gaps) - top} shorter gaps"] = rest
    return sorted(([n, t] for n, t in out.items()), key=lambda x: -x[1])[:10]


def clip_sums(clips: list, key: str) -> dict:
    """Each name's values in the clips' `key` dicts (`stage_seconds`,
    `counters`), summed over the clips."""
    out: dict = {}
    for c in clips:
        for k, v in c.get(key, {}).items():
            out[k] = out.get(k, 0) + v
    return out


def sample_clips(n: int, seed: int, k: int) -> set:
    """The clips of the window whose frames the check compares: `k` drawn
    from the seed (every clip where there are no more); the others are
    read for their frame count only."""
    import numpy as np
    if n <= k:
        return set(range(n))
    rng = np.random.default_rng([seed, n])
    return set(rng.choice(n, size=k, replace=False).tolist())


def _log(msg: str) -> None:
    print(f"[bench_port {time.monotonic():.1f}] {msg}", file=sys.stderr,
          flush=True)


def _read_metric(name: str, rec: dict):
    mod = importlib.import_module(f"bench_port.metrics.{name}")
    v = mod.read(rec)
    return None if v is None else float(v)


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _measure(entry, warm, clip_in, work: str, seconds: float, trace: bool,
             device: str, t0: float) -> tuple:
    """Warm up, then run whole clips until `seconds` have passed (the clip
    in flight at the deadline is finished).  Returns (clips, `.pb` paths,
    window start, set-up seconds, (trace events, traced seconds) or
    None)."""
    import torch
    cuda = device == "cuda"
    entry.run_clip(warm, os.path.join(work, "warm.pb"))
    os.remove(os.path.join(work, "warm.pb"))
    gc.collect()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_start = time.monotonic()
    setup_s = t_start - t0
    _log(f"set-up {setup_s:.1f} s; window opens")
    clips, pbs, traced = [], [], None
    while not clips or time.monotonic() < t_start + seconds:
        pb = os.path.join(work, f"clip{len(clips)}.pb")
        if trace and traced is None:
            # The traced window is the clip alone, not the profiler's
            # start and stop.
            with Tracer(cuda) as tracer:
                tc = time.monotonic()
                clip = entry.run_clip(clip_in, pb)
                _sync(device)
                window_s = time.monotonic() - tc
            traced = (tracer.events, window_s)
            clip["traced"] = True
        else:
            clip = entry.run_clip(clip_in, pb)
        clips.append(clip)
        pbs.append(pb)
        _log(f"clip {len(clips)}: {clip['frames']} frames")
    _sync(device)
    return clips, pbs, t_start, setup_s, traced


def _check(pbs: list, checked: set, truth: dict, config: dict,
           traffic: dict, files: list) -> dict:
    """The clips' `.pb` files against the drawn scene and the
    configuration's guarantees, then each check the traffic names
    (`checks/<name>.py`: `numbers(files, truth, config, traffic)` over the
    side files of the compared clips, in clip order): the numbers that
    `limits/<cell>.json` bounds (`compare.py`)."""
    from bench_port import compare
    _log("window closed; comparing")
    objects = truth["objects"]
    n = objects.shape[0]
    numbers = {"frames_wrong": 0}
    for k, pb in enumerate(pbs):
        if k not in checked:
            numbers["frames_wrong"] += compare.count_wrong(pb, n)
            continue
        sets, wrong = compare.program_sets(pb, n, config["width"],
                                           config["height"])
        numbers["frames_wrong"] += wrong
        for key, v in compare.clip_numbers(sets, objects).items():
            numbers[key] = max(numbers.get(key, 0), v)
    for name in traffic.get("checks", []):
        mod = importlib.import_module(f"bench_port.checks.{name}")
        numbers.update(mod.numbers(files, truth, config, traffic))
    _log("compared")
    return numbers


def make_clip(traffic: dict, config: dict, seed: int) -> tuple:
    """(frames, truth) of the cell's clip: truth["objects"] is each
    pixel's drawn object; with the traffic's `texture_motion` "rigid",
    truth["flow"] and truth["valid"] are the drawn backward displacement
    and where it holds (`generator._motion`)."""
    from bench_port import generator
    motion = traffic.get("texture_motion", "panned")
    out = generator.synthetic_clip(
        traffic["clip_frames"], seed=seed, h=config["height"],
        w=config["width"], shapes=traffic["shapes"], sizes=traffic["sizes"],
        texture=traffic["texture"], noise=traffic["noise"], truth=True,
        texture_motion=motion, motion=motion == "rigid")
    truth = {"objects": out[1]}
    if len(out) > 2:
        truth.update(out[2])
    return out[0], truth


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str, t0: float, cell_files: tuple | None = None) -> tuple:
    """One run; returns (result dict, check lines).  `t0` is the process's
    start on the host clock (time.monotonic).  `cell_files` replaces
    `load_cell(workload)` (the tests' small cells on the CPU)."""
    import torch

    from bench_port import compare, generator

    manifest, cell, config, traffic, limits = (cell_files
                                               or load_cell(workload))
    cuda = device == "cuda"
    entry_mod = importlib.import_module(
        f"bench_port.entries.{traffic['entry']}")
    frames, truth = make_clip(traffic, config, seed)
    work = tempfile.mkdtemp(prefix="bench_port_")
    try:
        entry = entry_mod.Entry(config, device, work)
        # Set-up: build the kernels and warm every shape of the cell.
        warm = entry.prepare(frames[:traffic["warmup_frames"]])
        clip_in = entry.prepare(frames)
        clips, pbs, t_start, setup_s, traced = _measure(
            entry, warm, clip_in, work, seconds, trace, device, t0)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rec = window_records(clips, t_start, setup_s, peak)
        rec.update(height=config["height"], width=config["width"])
        if trace:
            rec.update(trace_records(*traced))
            traced = None
            _log(f"trace read: {rec['events']} events, device span "
                 f"{rec['device_span_s']:.2f} s of {rec['window_s']:.2f}; "
                 + ", ".join(f"{short_name(n)} x{len(v)}"
                             for n, v in rec["launches"].items()
                             if "tile_" in n))
            plain = [c for c in clips if not c.get("traced")] or clips
            rec.update(stage_seconds=clip_sums(plain, "stage_seconds"),
                       counters=clip_sums(plain, "counters"),
                       stage_frames=sum(c["frames"] for c in plain),
                       traced_solves=generator.chunk_solves(
                           len(frames),
                           config["dense_options"]["chunk_size"]))
        checked = sample_clips(len(pbs), seed, CLIPS_COMPARED)
        files = [clips[k].get("files", {}) for k in sorted(checked)]
        del entry, clips, warm, clip_in
        gc.collect()
        numbers = _check(pbs, checked, truth, config, traffic, files)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(manifest, workload, section):
        v = _read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    result = {"correct": compare.judge(numbers, limits),
              "attempted": len(pbs) * len(frames),
              "failed": int(numbers["frames_wrong"]),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return result, lines
