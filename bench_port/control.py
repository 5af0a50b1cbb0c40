"""The control of the check, and the readings its limits are set from.

The configuration states no precision: its guarantees are about the
partition (`configs/<config>.json`, `guarantees`).  The control breaks one
of them with the program's own option: the dense stage's minimum region
size (`frac_min_region_size`) set to 0, the step a faster solver would be
tempted to drop.  For each seed this runs one clip of the cell at its own
size through the cell's entry as stated (the sound reading) and with the
control's option, and reads planted faults off the sound run's `.pb`: the
labels of the first frame kept for every frame (a state that never
advances), one frame's regions merged into one (an answer altered where it
is produced) and every second frame left out.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed: each reading's numbers and whether they pass
the cell's limits.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _clip_numbers(entry_mod, config: dict, frames, truth, device: str,
                  work: str) -> tuple:
    from bench_port import compare
    pb = os.path.join(work, "clip.pb")
    t = time.monotonic()
    entry_mod.Entry(config, device, work).run_clip(frames, pb)
    seconds = time.monotonic() - t
    sets, wrong = compare.program_sets(pb, len(frames), config["width"],
                                       config["height"])
    numbers = dict(compare.clip_numbers(sets, truth),
                   frames_wrong=wrong)
    return numbers, sets, seconds


def _faults(sets: list, truth) -> dict:
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
    out = {"unchanged_state": compare.clip_numbers(frozen, truth),
           "altered": compare.clip_numbers(merged, truth),
           "half_left_out": {"frames_wrong": n - (n + 1) // 2}}
    for v in out.values():
        v.setdefault("frames_wrong", 0)
    return out


def readings(workload: str, seed: int, device: str,
             cell_files: tuple | None = None) -> dict:
    import importlib
    import shutil
    import tempfile

    from bench_port import compare, harness
    _, _, config, traffic, limits = (cell_files
                                     or harness.load_cell(workload))
    frames, truth = harness.make_clip(traffic, config, seed)
    entry_mod = importlib.import_module(
        f"bench_port.entries.{traffic['entry']}")
    control = dict(config, dense_options=dict(config["dense_options"],
                                              frac_min_region_size=0.0))
    work = tempfile.mkdtemp(prefix="bench_port_control_")
    try:
        sound, sets, secs = _clip_numbers(entry_mod, config, frames, truth,
                                          device, work)
        faults = _faults(sets, truth)
        low, _, _ = _clip_numbers(entry_mod, control, frames, truth, device,
                                  work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"seed": seed, "sound": sound,
            "sound_passes": compare.judge(sound, limits),
            "control": low, "passes": compare.judge(low, limits),
            "faults": {k: dict(v, passes=compare.judge(v, limits))
                       for k, v in faults.items()},
            "clip_s": secs}


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
