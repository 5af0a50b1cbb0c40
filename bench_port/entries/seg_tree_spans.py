"""Entry `seg_tree_spans`: the `seg_tree_cli` entry (the port's
`tools/seg_tree.py` in-process, `--write_to_file --save_flow`, the
configuration's options as flags), run through `seg_tree.run`, which
hands back the run's trace.  Besides what `seg_tree_cli` returns, a clip
returns the trace's span seconds (`stage_seconds`: `flow`, `encode`,
`encode.vectorize` beside the stages' spans) and `counters`, and
`files["clip"]`, the input the run read, `files["frames"]`, a `.npy`
of its frames as they decode (`prepare` checks that the file decodes to
them bit for bit; for `checks/flow_ref`, which decodes no video), and
`files["pb"]`, the `.pb` it wrote (for `checks/frame_state` and
`checks/min_region`).

A program whose `seg_tree` has no `run` (one older than these spans)
cannot run this entry: building it raises at once."""

from __future__ import annotations

import contextlib
import io
import re
import sys
import time

from bench_port.entries import seg_tree_cli


class Entry(seg_tree_cli.Entry):
    def __init__(self, config: dict, device: str, workdir: str):
        from video_segment_tpu_torch.tools import seg_tree
        if not hasattr(seg_tree, "run"):
            raise RuntimeError("this program's seg_tree has no run(argv) "
                               "that returns its trace")
        super().__init__(config, device, workdir)

    def prepare(self, frames: list) -> dict:
        import numpy as np
        clip = super().prepare(frames)
        clip["frames"] = self._fresh("frames") + ".npy"
        np.save(clip["frames"], np.stack(frames))
        return clip

    def run_clip(self, clip: dict, pb_path: str) -> dict:
        from video_segment_tpu_torch.tools import seg_tree
        src = self._link(clip)
        argv = ["--input_file", src, "--output_file", pb_path,
                "--write_to_file", "--save_flow", "--device", self.device,
                *self.flags]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc, trace = seg_tree.run(argv)
        end = time.monotonic()
        sys.stderr.write(said.getvalue())
        if rc:
            raise RuntimeError(f"seg_tree exited with {rc}")
        done = re.search(r"Processed (\d+) frames", said.getvalue())
        return {"frames": int(done.group(1)) if done else 0, "end": end,
                "stage_seconds": trace.seconds, "counters": trace.counters,
                "files": {"flow": src + ".flow", "clip": src,
                          "frames": clip["frames"], "pb": pb_path}}
