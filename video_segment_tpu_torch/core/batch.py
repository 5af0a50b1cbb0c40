"""Fused multi-clip dense over-segmentation (PyTorch port).

Port of video_segment_tpu/core/batch.py: N same-resolution clips stream in
lockstep, and the clips whose chunk is ready at one step are prepared
together, grouped by chunk class (`_signature`) and solved group by group.
Host tails (slot compaction, spatial connectedness, global ids, RLE,
hierarchy) stay per clip and, with `async_tail`, overlap the next clip's
solve through each clip's tail worker.

The contract is the JAX class's: each clip's output equals its standalone
streaming run at the same band decomposition.  The JAX class stacks a
group's inputs and runs one vmapped program over the clip axis, unifying
`table_slots` to the group's maximum.  Here a group's clips are solved one
after the other through `DenseSegmentation._dispatch_solve`, each with its
own table sizing, as the banded solve runs its row bands one after the
other: the solver's device work is eager torch ops and kernel launches on
one stream, so a clip axis would not merge launches without rewriting every
phase of the solver, and it would have to keep the table caps (which decide
sink overflow and recompaction) per clip to stay exact.  So the batch
needs no `_materialize_solve_inputs` (neutral full volumes for optional
inputs, which the JAX class needs to stack them; in this port only the
mesh solve uses them).
`group_sizes` records, per step that solved, the sizes of the groups in
dispatch order.

The constructor scales the per-clip voxel budget down by the clip count,
as the JAX class does, so the clips pick the band decomposition whose
batch fits the original budget, and rejects a configuration whose batched
per-band footprint exceeds twice that budget.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from video_segment_tpu_torch.core import oversegmentation as ov
from video_segment_tpu_torch.core.dense import DenseSegmentation, SegFrame
from video_segment_tpu_torch.core.options import DenseSegmentationOptions
from video_segment_tpu_torch.runtime.trace import Trace


class BatchDenseSegmentation:
    """Lockstep multi-clip streaming over-segmentation.

    Usage:
        bd = BatchDenseSegmentation(options, w, h, n_clips)
        for step in range(n_frames):
            outs = bd.process_frames(False, [clip_frame(i) for i in range(n)])
        outs = bd.process_frames(True)
    `outs[i]` is clip i's list of SegFrame results, same contract as
    DenseSegmentation.process_frame.  `device` defaults to "cuda" and
    raises without CUDA, like every entry of the port.
    """

    def __init__(self, options: DenseSegmentationOptions, frame_width: int,
                 frame_height: int, n_clips: int,
                 solver_params: ov.OversegParams | None = None, *,
                 device: str | torch.device = "cuda"):
        if n_clips < 1:
            raise ValueError("n_clips must be >= 1")
        opts = dataclasses.replace(
            options,
            max_solve_voxels=max(options.max_solve_voxels // n_clips, 1))
        self.clips = [DenseSegmentation(opts, frame_width, frame_height,
                                        solver_params=solver_params,
                                        device=device)
                      for _ in range(n_clips)]
        c0 = self.clips[0]
        self.device = c0.device
        vox = (n_clips * (c0.options.chunk_size + 1)
               * ((frame_height + c0._pad_rows) // max(c0._bands, 1))
               * frame_width)
        if vox > options.max_solve_voxels * 2:
            raise ValueError(
                f"batched per-band footprint {vox} exceeds budget "
                f"{options.max_solve_voxels}")
        self.group_sizes: list[list[int]] = []

    # -- streaming --------------------------------------------------------

    def process_frames(self, flush: bool,
                       frames: list[np.ndarray | None] | None = None,
                       flows: list | None = None) -> list[list[SegFrame]]:
        if frames is not None:
            if flows is None:
                flows = [None] * len(self.clips)
            for ds, fr, fl in zip(self.clips, frames, flows):
                if fr is not None:
                    ds._ingest(fr, fl)

        outs: list[list[SegFrame]] = [[] for _ in self.clips]
        ready = [i for i, ds in enumerate(self.clips)
                 if ds._chunk_ready(flush)]
        if ready:
            # A clip's chunk_solve runs from its preparation to its outputs
            # on the host, the other clips' solves included.
            starts, preps = [], []
            for i in ready:
                starts.append(Trace.now())
                preps.append(self.clips[i]._prepare_chunk(flush))
            results = self._solve_batch([self.clips[i] for i in ready],
                                        preps)
            for i, prep, res, start in zip(ready, preps, results, starts):
                ds = self.clips[i]
                with ds.trace.span("chunk_solve", start=start) as solve:
                    host = ds._solve_to_host(prep, res)
                outs[i] = ds._post_solve(prep, host, flush, solve.end)
        if flush:
            for i, ds in enumerate(self.clips):
                if i not in ready:
                    outs[i] = ds._drain_pending()
        return outs

    def join(self):
        for ds in self.clips:
            ds.join()

    # -- batched dispatch -------------------------------------------------

    @staticmethod
    def _signature(prep: dict):
        """Chunk class: preps in the same class run the same sequence of
        device programs (their params may differ only in live-seed table
        sizing)."""
        return (prep["t_solve"], prep["vol"].shape[1],
                prep["flow"] is not None,
                prep["constraints"] is not None,
                prep["tile_stats"] is not None,
                prep["head_planes"],
                prep["params"]._replace(table_slots=0, band_table_slots=0))

    def _solve_batch(self, clips, preps) -> list[ov.OversegResult]:
        groups: dict = {}
        for k, prep in enumerate(preps):
            groups.setdefault(self._signature(prep), []).append(k)
        results: list = [None] * len(preps)
        for members in groups.values():
            for k in members:
                results[k] = clips[k]._dispatch_solve(preps[k])
        self.group_sizes.append([len(m) for m in groups.values()])
        return results
