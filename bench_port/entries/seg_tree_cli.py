"""Entry `seg_tree_cli`: the port's command line, `tools/seg_tree.py`, run
in-process on a video file as users run it: `--write_to_file` (boundary
polygons, per-region scanlines stripped), `--save_flow` (the flow it
computed, in the reference's `.flow` format, for the check) and the
configuration's options as flags; the threaded pipeline, flow on unless
the configuration turns it off.

`prepare` writes the clip once as a lossless FFV1 `.avi` (a PNG sequence
where this machine's cv2 does not read FFV1 back bit for bit).  The flow
engine reuses an existing `<input>.flow` and then computes no flow, so
each clip runs on a fresh hard link of the file, beside which its `.flow`
is written.  The program's standard output goes to standard error: the
harness's result is the last line of standard output."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import sys
import time

# Keys of a configuration that describe it and set no option.
_DESCRIPTIVE = {"name", "width", "height", "source", "reduced", "assumed",
                "guarantees"}


def _value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _defaults(cls) -> dict:
    return {f.name: f.default for f in dataclasses.fields(cls)}


def flags(config: dict) -> list:
    """The `seg_tree` flags that state the configuration's options (each
    against the options' declared defaults, which `seg_tree` starts
    from); raises ValueError for an option that no flag can express."""
    from video_segment_tpu_torch.core.options import (
        DenseSegmentationOptions, RegionSegmentationOptions)
    unknown = set(config) - _DESCRIPTIVE - {"use_flow", "dense_options",
                                             "region_options"}
    if unknown:
        raise ValueError(f"seg_tree has no flag for {sorted(unknown)}")
    out = ["--flow" if config.get("use_flow", True) else "--no-flow"]
    dense = _defaults(DenseSegmentationOptions)
    for k, v in config.get("dense_options", {}).items():
        if k == "chunk_size":
            out += ["--chunk_size", str(int(v))]
        elif k == "async_tail":
            if not v:   # seg_tree runs the tail asynchronously
                raise ValueError("seg_tree has no flag for async_tail=False")
        elif k not in dense or dense[k] != v:
            raise ValueError(f"seg_tree has no flag for dense option "
                             f"{k}={v!r}")
    region = _defaults(RegionSegmentationOptions)
    for k, v in config.get("region_options", {}).items():
        if k not in region:
            raise ValueError(f"no region option {k!r}")
        if region[k] != v:
            out += ["--region_param", f"{k}={_value(v)}"]
    return out


class Entry:
    def __init__(self, config: dict, device: str, workdir: str):
        self.config = config
        self.device = device
        self.workdir = workdir
        self.flags = flags(config)
        self._n = 0

    def _fresh(self, stem: str) -> str:
        self._n += 1
        return os.path.join(self.workdir, f"{stem}{self._n}")

    def prepare(self, frames: list) -> dict:
        """The clip as a file: {"path": the input seg_tree opens, "files":
        the files to link for each run}."""
        import cv2
        import numpy as np
        h, w = frames[0].shape[:2]
        path = self._fresh("clip") + ".avi"
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30,
                             (w, h))
        for f in frames:
            vw.write(f)
        vw.release()
        cap = cv2.VideoCapture(path)
        back = []
        while len(back) <= len(frames):
            ok, f = cap.read()
            if not ok:
                break
            back.append(f)
        cap.release()
        if len(back) == len(frames) and all(
                np.array_equal(a, b) for a, b in zip(frames, back)):
            return {"path": path, "files": [path]}
        os.remove(path)
        folder = self._fresh("clip")
        os.mkdir(folder)
        files = []
        for i, f in enumerate(frames):
            files.append(os.path.join(folder, f"{i:05d}.png"))
            cv2.imwrite(files[-1], f)
        return {"path": os.path.join(folder, "%05d.png"), "files": files}

    def _link(self, clip: dict) -> str:
        """A fresh name for the clip's files (hard links): no `.flow` beside
        it yet."""
        if len(clip["files"]) == 1:
            path = self._fresh("run") + ".avi"
            os.link(clip["path"], path)
            return path
        folder = self._fresh("run")
        os.mkdir(folder)
        for f in clip["files"]:
            os.link(f, os.path.join(folder, os.path.basename(f)))
        return os.path.join(folder, os.path.basename(clip["path"]))

    def run_clip(self, clip: dict, pb_path: str) -> dict:
        """Run `seg_tree` over one clip (from `prepare`) into `pb_path`.
        Returns the frames it reports, the end time (host clock, the run
        returned) and the `.flow` file it wrote."""
        import io

        from video_segment_tpu_torch.tools import seg_tree
        src = self._link(clip)
        argv = ["--input_file", src, "--output_file", pb_path,
                "--write_to_file", "--save_flow", "--device", self.device,
                *self.flags]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = seg_tree.main(argv)
        end = time.monotonic()
        sys.stderr.write(said.getvalue())
        if rc:
            raise RuntimeError(f"seg_tree exited with {rc}")
        done = re.search(r"Processed (\d+) frames", said.getvalue())
        return {"frames": int(done.group(1)) if done else 0, "end": end,
                "files": {"flow": src + ".flow"}}
