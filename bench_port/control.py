"""The control of the check, and the readings its limits are set from.

The configuration states no precision: its guarantees are about the
partition (`configs/<config>.json`, `guarantees`).  The control breaks one
of them with the program's own option: the dense stage's minimum region
size (`frac_min_region_size`) set to 0 on every options object the
program builds (`program_option`: the `seg_tree` entry has no flag for
it), the step a faster solver would be tempted to drop.  Where the
configuration runs flow, a second control runs TV-L1 at one scale (the
program's own `TVL1Params(nscales=1)`), the step a faster flow would be
tempted to drop.  For each seed this runs one clip of the cell at its
own size through the cell's entry as stated (the sound reading, with
the traffic's `checks`) and with each control, and reads planted faults
off the sound run's output: in its `.pb`, the labels of the first frame
kept for every frame (a state that never advances), one frame's regions
merged into one (an answer altered where it is produced) and every second
frame left out; in its `.flow` file, where it wrote one, every field
zeroed, halved or negated, one field in six doubled (a fault at a
micro-batch's seam) and the file cut short.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed: each reading's numbers and whether they pass
the cell's limits.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

# Planted `.flow` faults: each field's new value from its field `x` and
# its index `i` (field i is frame i + 1's flow).
FLOW_FAULTS = {
    "flow_zeroed": lambda x, i: 0 * x,
    "flow_halved": lambda x, i: 0.5 * x,
    "flow_negated": lambda x, i: -x,
    "flow_one_in_six_doubled": lambda x, i: 2 * x if i % 6 == 5 else x,
}


def _clip_numbers(entry_mod, config: dict, traffic: dict, frames, truth,
                  device: str, work: str) -> tuple:
    """(numbers, chunk sets, side files, seconds) of one clip run through
    the entry with `config`."""
    from bench_port import compare
    pb = os.path.join(work, "clip.pb")
    entry = entry_mod.Entry(config, device, work)
    clip_in = entry.prepare(frames)
    t = time.monotonic()
    clip = entry.run_clip(clip_in, pb)
    seconds = time.monotonic() - t
    sets, wrong = compare.program_sets(pb, len(frames), config["width"],
                                       config["height"])
    numbers = dict(compare.clip_numbers(sets, truth["objects"]),
                   frames_wrong=wrong)
    files = clip.get("files", {})
    for name in traffic.get("checks", []):
        mod = importlib.import_module(f"bench_port.checks.{name}")
        numbers.update(mod.numbers([files], truth, config, traffic))
    return numbers, sets, files, seconds


def _faults(sets: list, objects) -> dict:
    import numpy as np

    from bench_port import compare
    labels = np.concatenate([lab for lab, _ in sets])
    n = len(labels)
    frozen = [(np.repeat(labels[:1], len(lab), 0), h) for lab, h in sets]
    merged_labels = labels.copy()
    merged_labels[n // 2] = merged_labels[n // 2].flat[0]
    merged, k = [], 0
    for lab, h in sets:
        merged.append((merged_labels[k:k + len(lab)], h))
        k += len(lab)
    out = {"unchanged_state": compare.clip_numbers(frozen, objects),
           "altered": compare.clip_numbers(merged, objects),
           "half_left_out": {"frames_wrong": n - (n + 1) // 2}}
    for v in out.values():
        v.setdefault("frames_wrong", 0)
    return out


def _flow_faults(files: dict, truth, config: dict, traffic: dict,
                 work: str) -> dict:
    """The traffic's checks over planted copies of the sound run's `.flow`
    file (FLOW_FAULTS, and the file cut to half its fields)."""
    import numpy as np

    from bench_port.checks import flow_epe
    if "flow" not in files:
        return {}
    w, h, ftype, fields, _ = flow_epe.read_flow(files["flow"])
    head = np.asarray([w, h, ftype], "<i4").tobytes()
    planted = {name: [fault(x, i) for i, x in enumerate(fields)]
               for name, fault in FLOW_FAULTS.items()}
    planted["flow_cut_short"] = list(fields[:len(fields) // 2])
    out = {}
    for name, body in planted.items():
        path = os.path.join(work, f"{name}.flow")
        with open(path, "wb") as f:
            f.write(head + b"".join(np.asarray(x, "<f4").tobytes()
                                    for x in body))
        out[name] = {}
        for check in traffic.get("checks", []):
            mod = importlib.import_module(f"bench_port.checks.{check}")
            out[name].update(mod.numbers([dict(files, flow=path)], truth,
                                         config, traffic))
    return out


@contextlib.contextmanager
def program_option(module: str, cls: str, **fields):
    """Every `cls` object of the program's `module` built meanwhile takes
    `fields` once built, whatever its caller passed: the program's own
    option, where the entry has no way to state it."""
    mod = importlib.import_module(module)
    real = getattr(mod, cls)

    class Patched(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            for name, value in fields.items():
                setattr(self, name, value)

    setattr(mod, cls, Patched)
    try:
        yield
    finally:
        setattr(mod, cls, real)


def readings(workload: str, seed: int, device: str,
             cell_files: tuple | None = None) -> dict:
    from bench_port import compare, harness
    _, _, config, traffic, limits = (cell_files
                                     or harness.load_cell(workload))
    frames, truth = harness.make_clip(traffic, config, seed)
    entry_mod = importlib.import_module(
        f"bench_port.entries.{traffic['entry']}")
    work = tempfile.mkdtemp(prefix="bench_port_control_")

    def run(cfg, sub):
        os.mkdir(os.path.join(work, sub))
        return _clip_numbers(entry_mod, cfg, traffic, frames, truth, device,
                             os.path.join(work, sub))

    try:
        sound, sets, files, secs = run(config, "sound")
        faults = _faults(sets, truth["objects"])
        faults.update(_flow_faults(files, truth, config, traffic, work))
        with program_option("video_segment_tpu_torch.core.options",
                            "DenseSegmentationOptions",
                            frac_min_region_size=0.0):
            low = run(config, "control")[0]
        flow_low = None
        if config.get("use_flow"):
            from video_segment_tpu_torch.core.flow import TVL1Params
            with program_option("video_segment_tpu_torch.core.flow",
                                "FlowEngine", params=TVL1Params(nscales=1)):
                flow_low = run(config, "flow_control")[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"seed": seed, "sound": sound,
           "sound_passes": compare.judge(sound, limits),
           "control": low, "passes": compare.judge(low, limits),
           "faults": {k: dict(v, passes=compare.judge(v, limits))
                      for k, v in faults.items()},
           "clip_s": secs}
    if flow_low is not None:
        out["flow_control"] = dict(flow_low,
                                   passes=compare.judge(flow_low, limits))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
