"""Streaming chunked dense over-segmentation stage (PyTorch port).

Port of video_segment_tpu/core/dense.py: buffers preprocessed frames,
pre-segments them tile-locally, solves each chunk with the edge-table
solver (or the v1 pixel solver, `OversegParams(edge_table=False)`),
assigns globally consistent region ids across chunks and emits per-frame
RLE results plus a level-0 hierarchy per chunk (chunk streaming protocol:
see the JAX module docstring).

Pre-segmentation: "felz" runs the tile felz pre-solve (K1) per frame at
ingest; "flood" runs the tile flood (K4) over each padded chunk volume
when the chunk is solved.  "auto" means "felz" on every device, so CPU
runs execute the algorithm the card runs (the JAX package picks "flood"
off a TPU).  The edge-table solver always pre-segments; the v1 solver
does so only with `tile_presegment` (its flood then stops at the
force-merge weight), and seeds one region a voxel otherwise.  With
optical flow (a backward flow field per frame after the first,
`core/flow.FlowField`s or arrays) the solver's temporal edges are
displaced along it and connectedness advects centroids by it.  An
edge-table chunk over `max_solve_voxels` (or `solver_bands > 1`) is solved
in row bands: frames are edge-padded at ingest to a whole number of
8-row-aligned bands, the solver's pixel phases run one band at a time, and
outputs are sliced back to the true height; the v1 solver shrinks
`chunk_size` to fit instead.  With a device mesh (`mesh=`,
`parallel/mesh.Mesh`) the band count is the mesh's "space" size and each
chunk solve runs band b's pixel phase on the mesh's space-b device
(`parallel/mesh.sharded_chunk_solver`); the stage itself lives on the
mesh's first device.  The host tail (N4 fix result, compaction,
connectedness, id assignment, RLE) runs the port's copies of the JAX
package's host modules (`core/connectedness.py`, `ops/rle.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.core import oversegmentation as ov
from video_segment_tpu_torch.core.options import DenseSegmentationOptions
from video_segment_tpu_torch.ops import (bilateral, filters, rle, tile_felz,
                                         tile_preseg)
from video_segment_tpu_torch.runtime.trace import Trace


@dataclasses.dataclass
class HierarchyLevelData:
    """One hierarchy level, arrays indexed per region (global ids)."""
    ids: np.ndarray           # (R,) int64, ascending
    sizes: np.ndarray         # (R,) int64 (window-adjusted voxel counts)
    start_frames: np.ndarray  # (R,) global video frame index
    end_frames: np.ndarray
    neighbor_pairs: np.ndarray  # (P,2) int64 global-id pairs, a<b
    parent_ids: np.ndarray | None = None   # (R,) or None (top level)
    child_pairs: np.ndarray | None = None  # (C,2) (parent_gid, child_gid)


@dataclasses.dataclass
class SegFrame:
    """Per-frame segmentation result (host representation of
    SegmentationDesc)."""
    frame_width: int
    frame_height: int
    region_ids: np.ndarray        # (R,) ascending global ids in this frame
    interval_counts: np.ndarray   # (R,)
    ys: np.ndarray
    lxs: np.ndarray
    rxs: np.ndarray
    chunk_size: int = 0
    overlap_start: int = 0
    chunk_id: int = -1
    hierarchy_frame_idx: int = 0
    hierarchy: list[HierarchyLevelData] | None = None  # chunk-start frame only
    frame_index: int = -1         # global video frame index
    moments: np.ndarray | None = None  # (R,6) ShapeMoments rows


def _finalize_labels(lab: torch.Tensor, h: int, fix_n4: bool):
    """Slice pad rows off the solver's label volume and resolve N4
    checkerboard diagonal crossings on the device (bitwise-equal to
    ops/rle.enforce_n4_connectivity per frame).  The pad rows go first: a
    replicated bottom row would fire the crossing pattern along the true
    bottom edge."""
    lab = lab[:, :h]
    if not fix_n4:
        return lab
    a = lab[:, :-1, :-1]
    b = lab[:, :-1, 1:]
    c = lab[:, 1:, :-1]
    d = lab[:, 1:, 1:]
    cross = (a == d) & (b == c) & (a != b)
    flip = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    flip[:, :-1, :-1] = cross
    right = torch.cat([lab[:, :, 1:], lab[:, :, -1:]], dim=2)
    return torch.where(flip, right, lab)


def _preprocess_u8(frame_u8: torch.Tensor, mode: str, pad_rows: int = 0):
    """u8 -> f32 -> presmooth -> edge-pad `pad_rows` rows at the bottom
    (one frame, on its device)."""
    img = frame_u8.to(torch.float32) * (1.0 / 255.0)
    img = filters.presmooth(img, mode)
    if pad_rows:
        img = _pad_rows_edge(img, 0, pad_rows)
    return img


def _materialize_solve_inputs(prep: dict, w: int):
    """Materialize a `_prepare_chunk` dict's optional per-voxel solver
    inputs to their neutral full volumes, as the JAX package does for its
    mesh dispatch (`sharded_chunk_solver`).  Flow and cell stats stay None
    when absent: the mesh solve reads them only when they exist, so the
    JAX package's zero volumes would be allocated and thrown away."""
    t_solve, hp = prep["t_solve"], prep["hp"]
    dev = prep["vol"].device
    shape3 = (t_solve, hp, w)
    n = t_solve * hp * w
    init = (prep["init_label"].reshape(shape3)
            if prep["init_label"] is not None
            else torch.arange(n, dtype=torch.int32, device=dev)
            .reshape(shape3))
    constr = (prep["constraints"].reshape(shape3)
              if prep["constraints"] is not None
              else torch.full(shape3, -1, dtype=torch.int32, device=dev))
    froz = (prep["frozen"].reshape(shape3) if prep["frozen"] is not None
            else torch.zeros(shape3, dtype=torch.bool, device=dev))
    tf = prep["tile_fin"]
    if tf is None:
        fin = torch.full(shape3, ov.NUM_BUCKETS, dtype=torch.int32,
                         device=dev)
    elif tf.dtype == torch.bool:
        fin = torch.where(tf.reshape(shape3), 0, ov.NUM_BUCKETS) \
            .to(torch.int32)
    else:
        fin = tf.reshape(shape3).to(torch.int32)
    cells = (tuple(x.reshape(shape3) for x in prep["tile_stats"])
             if prep["tile_stats"] is not None else None)
    return prep["vol"], prep["flow"], init, constr, froz, fin, cells


def _pad_rows_edge(x: torch.Tensor, dim: int, pad_rows: int):
    """Repeat the last index of `dim` (the image rows) `pad_rows` times."""
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    return torch.cat([x] + [last] * pad_rows, dim=dim)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same device ("cuda" is the current
    card)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


class DenseSegmentation:
    """Streaming over-segmentation.

    Usage:
        ds = DenseSegmentation(DenseSegmentationOptions(), width, height)
        for frame in frames:
            results += ds.process_frame(False, frame)
        results += ds.process_frame(True)

    `stage_seconds` holds wall-clock seconds per stage ("ingest_preseg",
    "chunk_solve", "host_tail"); stage boundaries synchronize the device
    so each stage owns its device time.  They are spans of `trace`
    (`runtime/trace.py`; a new one unless given), which also times the
    host tail's parts ("host_tail.compact", ".connect", ".ids", ".rle").
    Its counter "ingest.bilateral_kernel" counts the frames that K6
    smoothed at ingest (read from the kernel's launches on the ingesting
    thread: every frame of a bilateral stage on a card, none on the CPU).

    `device` defaults to "cuda" (raising without CUDA).  With
    `mesh=parallel.mesh.Mesh`, the chunk solves run their row bands over
    the mesh's "space" axis and the stage lives on the mesh's first
    device; a `device` naming another device is an error.
    """

    def __init__(self, options: DenseSegmentationOptions, frame_width: int,
                 frame_height: int,
                 solver_params: ov.OversegParams | None = None, *,
                 device: str | torch.device | None = None, mesh=None,
                 trace: Trace | None = None):
        if options.chunk_size < 3:
            raise ValueError("chunk_size needs to be at least 3 frames")
        options = dataclasses.replace(options)
        base = solver_params or ov.OversegParams()
        # Under a mesh the band count is the "space" size.
        self._mesh = mesh
        mesh_bands = 0
        if mesh is not None:
            mesh_bands = mesh.shape["space"]
            self.device = devmod.resolve(mesh.first)
            if device is not None and not _same_device(
                    devmod.resolve(device), self.device):
                raise ValueError(f"device={str(device)!r} differs from the "
                                 f"mesh's first device {self.device}")
        else:
            self.device = devmod.resolve("cuda" if device is None
                                         else device)
        # Large-resolution chunks: split the edge-table solve's pixel
        # phases into spatial row bands (bounding peak memory to one band)
        # instead of shrinking the chunk.  Bands must align to the 8-row
        # preseg tiles; the padded rows replicate the bottom image row.
        # The v1 pixel solver has no bands: it shrinks the chunk instead.
        self._bands = 1
        self._pad_rows = 0
        t_solve_full = options.chunk_size + 1
        chunk_vox = t_solve_full * frame_width * frame_height
        forced_bands = mesh_bands or options.solver_bands
        if forced_bands > 1:
            units = -(-frame_height // 8)
            u = -(-units // forced_bands)
            self._bands = forced_bands
            self._pad_rows = forced_bands * u * 8 - frame_height
            if (base.edge_table and chunk_vox // forced_bands
                    > options.max_solve_voxels):
                raise ValueError(
                    f"{forced_bands} bands leave per-band pixel phases over "
                    f"max_solve_voxels ({chunk_vox // forced_bands} > "
                    f"{options.max_solve_voxels}); use more devices or a "
                    f"smaller chunk_size")
        elif base.edge_table and chunk_vox > options.max_solve_voxels:
            unit_vox = 8 * frame_width * t_solve_full
            u_max = max(1, options.max_solve_voxels // unit_vox)
            units = -(-frame_height // 8)
            bands = min(-(-units // u_max), 16)
            u = -(-units // bands)
            self._bands = bands
            self._pad_rows = bands * u * 8 - frame_height
            import sys
            print(f"[dense] solving {frame_width}x{frame_height} in "
                  f"{bands} row bands (+{self._pad_rows} pad rows)",
                  file=sys.stderr, flush=True)
        elif not base.edge_table:
            max_chunk = options.max_solve_voxels // max(
                frame_width * frame_height, 1) - 1
            if options.chunk_size > max(3, max_chunk):
                import sys
                print(f"[dense] chunk_size {options.chunk_size} -> "
                      f"{max(3, max_chunk)} to respect max_solve_voxels "
                      f"at {frame_width}x{frame_height}", file=sys.stderr,
                      flush=True)
                options.chunk_size = max(3, max_chunk)
        self.options = options
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.overlap_frames = options.overlap_frames()
        self.constraint_frames = options.constraint_frames()
        self.min_region_size = options.min_region_size(frame_width,
                                                       frame_height)
        self._params = base._replace(
            min_region_size=self.min_region_size,
            metric=options.color_distance,
            two_stage=options.two_stage_oversegment,
            bands=self._bands,
            force_merge_weight=0.002 if options.color_distance == "l1"
            else 0.001)
        ov._check_scope(self._params)
        if options.preseg_mode not in ("auto", "felz", "flood"):
            raise ValueError(f"unknown preseg_mode {options.preseg_mode!r}")
        self._preseg_mode = ("felz" if options.preseg_mode == "auto"
                             else options.preseg_mode)
        # Pre-segment at all: always for the edge-table solver (its table
        # must hold the live regions), by option for the v1 solver.
        self._presegment = options.tile_presegment or self._params.edge_table
        if (self._preseg_mode == "felz" and self._params.edge_table
                and self._params.table_divisor
                == ov.OversegParams().table_divisor):
            # The felz pre-solve collapses pixels enough for a tighter
            # region table; explicit caller-set divisors are respected.
            self._params = self._params._replace(table_divisor=16)

        self._buffer: list[torch.Tensor] = []   # smoothed (Hp,W,3)
        self._preseg_buffer: list = []          # per-frame K1 results (felz)
        # _flow_buffer[i]: backward flow of buffer frame i (None only for
        # the first video frame); FlowFields stay device-resident.
        self._flow_buffer: list = []
        self._has_flow = False
        self._chunk_start = 0
        self._chunk_id = 0
        self._max_region_id = 0
        self._num_output_frames = 0
        self._overlap_gids: list[np.ndarray] = []
        self.trace = trace if trace is not None else Trace()
        self.solve_diag: list[np.ndarray] = []  # per chunk solve
        self._tail_exec = None
        self._pending = None
        self._planes_ready = None
        if options.async_tail:
            from concurrent.futures import ThreadPoolExecutor
            self._tail_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dense-tail")

    @property
    def stage_seconds(self) -> dict:
        secs = self.trace.seconds
        return {k: secs[k] for k in ("ingest_preseg", "chunk_solve",
                                     "host_tail") if k in secs}

    # -- streaming state ---------------------------------------------------

    def load_state(self, state: dict) -> None:
        """Adopt streaming state held between chunks (e.g. a JAX
        DenseSegmentation's): `overlap_gids` (list of (H,W) int64 global-id
        planes), `max_region_id`, `chunk_start`, `chunk_id`,
        `num_output_frames`, `buffer` (the buffered preprocessed float32
        frames as the stage holds them: (H + pad rows, W, 3), already
        padded to the band grid; their pre-segmentations are recomputed
        here in felz mode), and optionally `flow_buffer` (per buffered
        frame, an (H,W,2) backward flow or None) with `has_flow`."""
        self.join()
        self._overlap_gids = [np.asarray(g, np.int64)
                              for g in state["overlap_gids"]]
        self._max_region_id = int(state["max_region_id"])
        self._chunk_start = int(state["chunk_start"])
        self._chunk_id = int(state["chunk_id"])
        self._num_output_frames = int(state["num_output_frames"])
        self._buffer = [torch.tensor(np.asarray(f, np.float32),
                                     device=self.device)
                        for f in state["buffer"]]
        hp = self.frame_height + self._pad_rows
        for b in self._buffer:
            if tuple(b.shape) != (hp, self.frame_width, 3):
                raise ValueError(
                    f"buffered frame {tuple(b.shape)} does not match this "
                    f"stage's padded geometry {(hp, self.frame_width, 3)}")
        self._preseg_buffer = ([self._preseg_frame(b) for b in self._buffer]
                               if self._felz_at_ingest() else [])
        self._flow_buffer = [None if f is None else np.asarray(f, np.float32)
                             for f in state.get("flow_buffer",
                                                [None] * len(self._buffer))]
        self._has_flow = bool(state.get("has_flow", False))

    # -- preprocessing ----------------------------------------------------

    def preprocess(self, frame_bgr_u8: np.ndarray) -> torch.Tensor:
        """uint8 BGR -> smoothed float [0,1] on the device (the frame
        crosses to the device as uint8), padded to the band grid when the
        solve is banded."""
        frame = torch.as_tensor(np.ascontiguousarray(frame_bgr_u8),
                                device=self.device)
        return _preprocess_u8(frame, self.options.presmoothing,
                              self._pad_rows)

    def _preseg_frame(self, img: torch.Tensor):
        """Tile-local felz pre-solve (K1) of one (padded) frame: frame-local
        voxel label ids, finalize levels, cell-positioned region stats."""
        p = self._params
        return tile_felz.tile_felzenszwalb(
            img[None].contiguous(), schedule=p.preseg_schedule,
            rounds_per_level=p.preseg_rounds_per_level,
            merge_threshold=p.merge_threshold,
            metric=self.options.color_distance,
            fin_margin=p.preseg_fin_margin,
            fin_eager=p.preseg_fin_eager, fin_gated=p.preseg_fin_gated,
            pair_merge=p.preseg_pair_merge)

    def _felz_at_ingest(self) -> bool:
        """Whether each frame gets its felz pre-segmentation (K1) at
        ingest."""
        return self._preseg_mode == "felz" and self._presegment

    # -- streaming --------------------------------------------------------

    def process_frame(self, flush: bool,
                      frame_bgr_u8: np.ndarray | None = None,
                      flow=None) -> list[SegFrame]:
        """Ingest a frame (with its backward flow, if any) and return the
        SegFrames that became ready; `flush` closes the stream."""
        if frame_bgr_u8 is not None:
            self._ingest(frame_bgr_u8, flow)
        if self._chunk_ready(flush):
            return self._segment_chunk(flush)
        if flush:
            return self._drain_pending()
        return []

    def _ingest(self, frame_bgr_u8: np.ndarray, flow) -> None:
        with self.trace.span("ingest_preseg"):
            n0 = bilateral.thread_launches()
            img = self.preprocess(frame_bgr_u8)
            self.trace.count("ingest.bilateral_kernel",
                             bilateral.thread_launches() - n0)
            self._buffer.append(img)
            if self._felz_at_ingest():
                self._preseg_buffer.append(self._preseg_frame(img))
            if flow is None or hasattr(flow, "numpy_f16"):
                self._flow_buffer.append(flow)
            else:
                self._flow_buffer.append(np.asarray(flow, np.float32))
            if flow is not None:
                self._has_flow = True
            devmod.synchronize(self.device)

    def _chunk_ready(self, flush: bool) -> bool:
        return bool(self._buffer) and (
            flush or
            len(self._buffer) - self._chunk_start >= self.options.chunk_size)

    def _drain_pending(self) -> list[SegFrame]:
        if self._pending is None:
            return []
        prev = self._pending
        self._pending = None
        self._planes_ready = None
        return list(prev.result())

    def join(self):
        """Block until deferred tail work has settled."""
        if self._pending is not None:
            self._pending.result()

    # -- chunk solve ------------------------------------------------------

    def _segment_chunk(self, flush: bool) -> list[SegFrame]:
        with self.trace.span("chunk_solve") as solve:
            prep = self._prepare_chunk(flush)
            host = self._solve_to_host(prep, self._dispatch_solve(prep))
        return self._post_solve(prep, host, flush, solve.end)

    def _prepare_chunk(self, flush: bool) -> dict:
        t = len(self._buffer)
        h, w = self.frame_height, self.frame_width
        dev = self.device
        # Canonical temporal extents (full chunks, and a small shape for
        # flush tails), padding by repeating the last frame.
        t_small = min(5, self.options.chunk_size + 1)
        t_solve = t_small if t <= t_small else self.options.chunk_size + 1
        pad = t_solve - t
        # Buffered frames are already row-padded to the band grid: pad
        # pixels replicate the bottom row and merge into the bottom-edge
        # regions; outputs are sliced back to the true height.
        hp = h + self._pad_rows
        vol = torch.stack(self._buffer + [self._buffer[-1]] * pad)

        flow = None
        if self._has_flow and t > 1:
            tail = self._flow_buffer[1:t]
            if any(f is None for f in tail):
                raise ValueError("flow must be passed for every frame or none")
            # FlowFields stack on the device (no host round trip); pad
            # frames get zero flow.
            devs = [f.device().to(dev) if hasattr(f, "numpy_f16")
                    else torch.tensor(f, device=dev) for f in tail]
            flow = torch.stack(devs + [torch.zeros_like(devs[0])] * pad)
            if self._pad_rows:
                flow = _pad_rows_edge(flow, 1, self._pad_rows)

        tile_init = tile_fin = tile_stats = None
        if self._felz_at_ingest():
            while len(self._preseg_buffer) < len(self._buffer):
                k = len(self._preseg_buffer)
                self._preseg_buffer.append(
                    self._preseg_frame(self._buffer[k]))
            per_frame = (self._preseg_buffer[:t]
                         + [self._preseg_buffer[t - 1]] * pad)
            offs = (torch.arange(t_solve, dtype=torch.int32, device=dev)
                    [:, None, None] * (hp * w))
            tile_init = torch.cat([lab for lab, _, _ in per_frame]) + offs
            tile_fin = torch.cat([fin for _, fin, _ in per_frame])
            tile_stats = tuple(torch.cat([st[i] for _, _, st in per_frame])
                               for i in range(4))
            if not self._params.carry_preseg_fin:
                tile_fin = None
        elif self._presegment:
            # Tile flood (K4) over the whole padded chunk: tile-local
            # regions of pixels within `preseg_threshold` of a neighbour
            # for the edge-table solver (its table must hold them); the v1
            # solver floods only the merges the force-merge shortcut makes
            # unconditionally.
            thr = (self._params.preseg_threshold if self._params.edge_table
                   else self._params.force_merge_weight)
            tile_init = tile_preseg.tile_presegment(
                vol, thr, self.options.color_distance)

        # The previous chunk's (possibly deferred) tail produces the
        # overlap constraint planes.
        if self._planes_ready is not None:
            self._planes_ready.wait()

        constraints = frozen = None
        init_label = tile_init
        cid_to_gid = np.zeros(0, np.int64)
        if self._overlap_gids:
            planes = np.stack(self._overlap_gids)  # (overlap, H, W) gids
            if self._pad_rows:
                planes = np.pad(planes, ((0, 0), (0, self._pad_rows),
                                         (0, 0)), mode="edge")
            cid_to_gid, compact = np.unique(planes, return_inverse=True)
            if len(cid_to_gid) > self._params.max_constraints:
                raise ValueError(
                    f"{len(cid_to_gid)} constraint regions exceed the solver "
                    f"cap {self._params.max_constraints}")
            compact = compact.reshape(planes.shape).astype(np.int32)
            n_constrained = 1 + self.constraint_frames
            constraints = torch.cat([
                torch.as_tensor(compact[:n_constrained], device=dev),
                torch.full((t_solve - n_constrained, hp, w), -1,
                           dtype=torch.int32, device=dev)])
            frozen = torch.zeros((t_solve, hp, w), dtype=torch.bool,
                                 device=dev)
            frozen[0] = True
            # Plane 0 pre-merges to one canonical voxel per compact id
            # -- per (id, band) in banded solves, since band-local seed
            # compaction needs init roots inside their own band (the band
            # groups rejoin in the frozen-group constraint merge);
            # constrained planes pre-merge within (preseg region x
            # constraint id) groups, which never span bands.
            init_sm = np.empty((n_constrained, hp, w), np.int32)
            key0 = compact[0].astype(np.int64)
            if self._bands > 1:
                bh = hp // self._bands
                key0 = key0 * self._bands + (np.arange(hp) // bh)[:, None]
            key0 = key0.ravel()
            uniq, first = np.unique(key0, return_index=True)
            init_sm[0] = first[np.searchsorted(uniq, key0)] \
                .reshape(hp, w).astype(np.int32)
            if tile_init is None:
                # No pre-segmentation (v1 with tile_presegment off): the
                # constrained and the free planes seed one region a voxel.
                init_sm[1:] = np.arange(hp * w, n_constrained * hp * w,
                                        dtype=np.int32) \
                    .reshape(n_constrained - 1, hp, w)
                free = torch.arange(n_constrained * hp * w,
                                    t_solve * hp * w, dtype=torch.int32,
                                    device=dev).reshape(-1, hp, w)
            else:
                tile_sm = tile_init[1:n_constrained].cpu().numpy()
                for pl_i in range(1, n_constrained):
                    key = (tile_sm[pl_i - 1].astype(np.int64).ravel()
                           * (len(cid_to_gid) + 1)
                           + compact[pl_i].ravel() + 1)
                    uniq, first = np.unique(key, return_index=True)
                    canon = first[np.searchsorted(uniq, key)]
                    init_sm[pl_i] = (pl_i * hp * w + canon) \
                        .reshape(hp, w).astype(np.int32)
                free = tile_init[n_constrained:]
            init_label = torch.cat([torch.as_tensor(init_sm, device=dev),
                                    free])
            if tile_fin is not None:
                # Constrained planes run fully open (level NUM_BUCKETS).
                plane = torch.arange(t_solve, device=dev)[:, None, None]
                tile_fin = torch.where(plane >= n_constrained, tile_fin,
                                       ov.NUM_BUCKETS)

        # Live-seed count -> 16384-quantized table size (the table caps
        # are semantics: they decide sink overflow and recompaction); per
        # band, the largest band's count.  The v1 solver sizes its own
        # compact table.
        params = self._params
        if params.edge_table and init_label is not None:
            q = 16384
            flat = init_label.reshape(-1)
            is_root = flat == torch.arange(flat.shape[0], device=dev)
            if self._bands > 1:
                bh = hp // self._bands
                n_seeds = int(is_root.reshape(t_solve, self._bands, bh, w)
                              .sum(dim=(0, 2, 3)).max())
                cap_b = ((n_seeds + 1024 + q - 1) // q) * q
                params = params._replace(
                    band_table_slots=min(cap_b, t_solve * bh * w))
            else:
                slots = ((int(is_root.sum()) + 1024 + q - 1) // q) * q
                params = params._replace(
                    table_slots=min(slots, t_solve * hp * w))

        head_planes = (1 + self.constraint_frames if self._overlap_gids
                       else 0)
        return dict(t=t, t_solve=t_solve, hp=hp, vol=vol, flow=flow,
                    constraints=constraints, init_label=init_label,
                    frozen=frozen, tile_fin=tile_fin, tile_stats=tile_stats,
                    params=params, head_planes=head_planes,
                    cid_to_gid=cid_to_gid)

    def _dispatch_solve(self, prep: dict) -> ov.OversegResult:
        if self._mesh is not None:
            res = self._solve_on_mesh(prep)
        else:
            res = ov.oversegment(prep["vol"], flow=prep["flow"],
                                 constraints=prep["constraints"],
                                 init_label=prep["init_label"],
                                 frozen=prep["frozen"],
                                 fin=prep["tile_fin"],
                                 params=prep["params"],
                                 cell_stats=prep["tile_stats"],
                                 head_planes=prep["head_planes"])
        self.solve_diag.append(res.diag)
        return res

    def _solve_on_mesh(self, prep: dict) -> ov.OversegResult:
        """The chunk solve through the mesh's banded solver
        (parallel/mesh.sharded_chunk_solver), the optional inputs
        materialized as in the JAX package.  Building the solver costs
        nothing (eager ops), so unlike the JAX class none is cached."""
        from video_segment_tpu_torch.parallel import mesh as pmesh

        params = prep["params"]
        has_flow = prep["flow"] is not None
        has_constraints = prep["constraints"] is not None
        use_cells = prep["tile_stats"] is not None
        solver = pmesh.sharded_chunk_solver(
            self._mesh, params, has_flow, has_constraints,
            prep["head_planes"], use_cells)
        return solver(*_materialize_solve_inputs(prep, self.frame_width))

    def _solve_to_host(self, prep: dict, res: ov.OversegResult) -> dict:
        """The solve's outputs that the host tail reads, on the host, then
        a device sync: the end of the chunk solve."""
        t = prep["t"]
        n4 = self.options.enforce_n4_connectivity
        slotvol = lut = labels = None
        if res.label16 is not None and int(res.nsink) == 0:
            # Slot-rank compaction (the JAX package's u16 transport path):
            # compact ids follow slot order, which decides new global ids.
            lut = res.lut.cpu().numpy()
            slotvol = _finalize_labels(res.label16, self.frame_height,
                                       n4)[:t].cpu().numpy()
        else:
            labels = _finalize_labels(res.label, self.frame_height,
                                      n4)[:t].cpu().numpy()
        res = ov.OversegResult(label=None, constr=res.constr.cpu().numpy(),
                               size=res.size.cpu().numpy(),
                               orig=res.orig.cpu().numpy())
        devmod.synchronize(self.device)
        return dict(labels=labels, slotvol=slotvol, lut=lut, res=res)

    def _post_solve(self, prep: dict, host: dict, flush: bool,
                    solve_end: float) -> list[SegFrame]:
        """Rotate the streaming state and run (or queue) the host tail of
        a solved chunk; `host` from `_solve_to_host`, `solve_end` the host
        clock when the solve ended, where a queued tail's seconds start."""
        t = prep["t"]
        last_output = (t - 1) if flush else (t - self.overlap_frames)
        flow_np = None
        if (self.options.enforce_spatial_connectedness and self._has_flow
                and t > 1):
            # Centroid advection samples a few points per frame: the
            # half-width (f16, batched) download is far inside its
            # tolerance (4% of the frame diagonal).
            flow_np = np.stack([
                f.numpy_f16() if hasattr(f, "numpy_f16") else np.asarray(f)
                for f in self._flow_buffer[1:t]])
        ctx = dict(host, cid_to_gid=prep["cid_to_gid"], flush=flush, t=t,
                   last_output=last_output, flow_np=flow_np,
                   had_constraints=bool(self._overlap_gids),
                   chunk_start=self._chunk_start, chunk_id=self._chunk_id,
                   solve_end=solve_end)

        # Rotate streaming state now — the tail never touches it.
        if flush:
            self._buffer.clear()
            self._preseg_buffer.clear()
            self._flow_buffer.clear()
            self._chunk_start = 0
        else:
            self._buffer = self._buffer[last_output:]
            self._preseg_buffer = self._preseg_buffer[last_output:]
            self._flow_buffer = self._flow_buffer[last_output:]
            self._chunk_start = 1
        self._chunk_id += 1

        if self._tail_exec is None:
            return self._chunk_tail(ctx, None)
        import threading
        prev = self._pending
        ev = threading.Event()
        self._planes_ready = ev
        self._pending = self._tail_exec.submit(self._chunk_tail, ctx, ev)
        out = list(prev.result()) if prev is not None else []
        if flush:
            out += self._pending.result()
            self._pending = None
            self._planes_ready = None
        return out

    def _chunk_tail(self, ctx, planes_ready) -> list[SegFrame]:
        """Host tail: compaction, spatial connectedness, global ids,
        overlap constraint planes (released via `planes_ready`), level-0
        hierarchy and per-frame RLE.  In the tail worker (`planes_ready`
        given) its seconds count from the end of the chunk's solve, so
        they include the wait for the worker; run in line they count the
        block alone, which then equals its profiler range."""
        start = ctx["solve_end"] if planes_ready is not None else None
        with self.trace.span("host_tail", start=start):
            try:
                return self._host_tail(ctx, planes_ready)
            finally:
                if planes_ready is not None:
                    planes_ready.set()

    def _host_tail(self, ctx, planes_ready) -> list[SegFrame]:
        res = ctx["res"]
        cid_to_gid = ctx["cid_to_gid"]
        flush = ctx["flush"]
        t = ctx["t"]
        last_output = ctx["last_output"]
        chunk_start = ctx["chunk_start"]
        h, w = self.frame_height, self.frame_width
        span = self.trace.span

        with span("host_tail.compact"):
            if ctx["slotvol"] is not None:
                slotvol = ctx["slotvol"]
                cnt = np.bincount(slotvol.ravel(), minlength=len(ctx["lut"]))
                present = cnt > 0
                rank = (np.cumsum(present) - 1).astype(np.int32)
                compact = rank[slotvol]
                num_regions = int(present.sum())
                constr_of_region = np.asarray(res.constr)[present]
            else:
                compact, roots = rle.compact_labels(ctx["labels"])
                num_regions = len(roots)
                constr_of_region, _ = ov.region_attrs(res, roots)

        if self.options.enforce_spatial_connectedness:
            from video_segment_tpu_torch.core import connectedness
            with span("host_tail.connect"):
                compact, n2, _origin = \
                    connectedness.enforce_spatial_connectedness(
                        compact, num_regions, flow=ctx["flow_np"])
            if n2 > num_regions:
                # Split-off tubes are new, unconstrained regions.
                constr_of_region = np.concatenate(
                    [constr_of_region,
                     np.full(n2 - num_regions, -1, constr_of_region.dtype)])
                num_regions = n2

        with span("host_tail.ids"):
            # Global id assignment (AssignUniqueRegionIds).
            gids = np.full(num_regions, -1, np.int64)
            constrained = constr_of_region >= 0
            if constrained.any():
                gids[constrained] = cid_to_gid[constr_of_region[constrained]]
            new_idx = np.flatnonzero(~constrained)
            gids[new_idx] = self._max_region_id + np.arange(len(new_idx))
            self._max_region_id = max(self._max_region_id,
                                      int(gids.max()) + 1)

            if flush:
                self._overlap_gids = []
            else:
                self._overlap_gids = [gids[compact[f]]
                                      for f in range(last_output, t)]
            if planes_ready is not None:
                planes_ready.set()

            window_lo = 1 if ctx["had_constraints"] else 0  # excl. frozen
            out_chunk_size = last_output - chunk_start + 1
            hierarchy_frame_idx = self._num_output_frames
            global_frame0 = self._num_output_frames - chunk_start

            win = compact[window_lo:last_output + 1]
            start_f, end_f, _ = rle.region_presence(win, num_regions)
            sizes = rle.region_sizes(win, num_regions)
            in_window = sizes > 0
            pairs = rle.neighbor_pairs(win)
            keep = in_window[pairs[:, 0]] & in_window[pairs[:, 1]]
            gp = np.sort(gids[pairs[keep]], axis=1)
            order = np.argsort(gids[in_window], kind="stable")
            hier = HierarchyLevelData(
                ids=gids[in_window][order],
                sizes=sizes[in_window][order],
                start_frames=(global_frame0 + window_lo
                              + start_f[in_window][order]),
                end_frames=global_frame0 + window_lo + end_f[in_window][order],
                neighbor_pairs=gp)

        results = []
        with span("host_tail.rle"):
            for local in range(chunk_start, last_output + 1):
                gimg = gids[compact[local]]
                ids, counts, ys, lxs, rxs = rle.frame_rle(gimg)
                results.append(SegFrame(
                    frame_width=w, frame_height=h,
                    region_ids=ids, interval_counts=counts,
                    ys=ys, lxs=lxs, rxs=rxs,
                    moments=rle.shape_moments(counts, ys, lxs, rxs),
                    chunk_size=out_chunk_size, overlap_start=out_chunk_size,
                    chunk_id=ctx["chunk_id"],
                    hierarchy_frame_idx=hierarchy_frame_idx,
                    hierarchy=[hier] if local == chunk_start else None,
                    frame_index=global_frame0 + local))
        self._num_output_frames += len(results)
        return results
