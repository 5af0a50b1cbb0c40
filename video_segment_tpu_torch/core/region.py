"""Streaming hierarchical region segmentation over chunk sets (PyTorch port).

Port of video_segment_tpu/core/region.py (semantics and reference
citations there): consumes the dense stage's per-frame results plus
per-frame Lab appearance and optical-flow features, groups chunks into
chunk sets (default 6 chunks, overlap 2), accumulates per-region Lab
histograms and per-frame flow angle histograms, agglomerates hierarchy
levels on the device and re-emits frames with the multi-level hierarchy
attached.  Cross-set continuity (counterpart constraints and id
inheritance) is the JAX package's.

Windowed appearance (`appearance_window_size > 0`) keeps per-window
gain-calibrated histograms beside the region histograms, and their
distance replaces the appearance term in agglomeration.
`save_descriptors` is read by the emitter only (`tools/seg_tree`), as in
the JAX package.  Histograms come from the port's native threaded
accumulator (`native/`); `_accumulate_all` and `_accumulate_windowed` are
the torch paths when that library is unavailable.  Lab conversion is
`bgr_to_lab_u8` (OpenCV's 8-bit BGR->Lab formula; no cv2 import): one
native pass that also sums the channels for the frame's Lab mean, or,
without the library, its NumPy body, which is the same integer arithmetic
and the oracle the native pass is tested against (counter
`region.lab_native` counts the frames converted natively); flow angles
are binned and magnitudes rounded to float16 in NumPy exactly as the
JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch import native
from video_segment_tpu_torch.core import agglomeration
from video_segment_tpu_torch.core.dense import HierarchyLevelData, SegFrame
from video_segment_tpu_torch.core.options import RegionSegmentationOptions
from video_segment_tpu_torch.ops import rle
from video_segment_tpu_torch.runtime.trace import Trace


def _next_pow2(x: int) -> int:
    return 1 << max(4, (x - 1).bit_length())


# OpenCV's 8-bit BGR->Lab is fixed point (color.cpp, RGB2Lab_b): gamma and
# cube-root lookup tables, XYZ coefficients scaled by 2^12; reproduced here
# (L exact, a/b within 1 of cv2, which blends in a packed 3-D table).
_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _lab_tables():
    v = np.arange(256) / 255.0
    gamma = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * (1 << _GAMMA_SHIFT)
                        * gamma.astype(np.float32)).astype(np.int64)
    x = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) \
        / (255.0 * (1 << _GAMMA_SHIFT))
    cbrt_tab = np.rint((1 << _LAB_SHIFT2) * np.where(
        x < 0.008856, x * 7.787 + 16.0 / 116.0, np.cbrt(x))).astype(np.int64)
    srgb2xyz = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]], np.float32)
    white = np.array([0.950456, 1.0, 1.088754], np.float32)
    coeffs = np.rint((1 << _LAB_SHIFT) * srgb2xyz.astype(np.float64)
                     / white.astype(np.float64)[:, None]).astype(np.int64)
    return gamma_tab, cbrt_tab, coeffs


_GAMMA_TAB, _CBRT_TAB, _XYZ_COEFFS = _lab_tables()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _bgr_to_lab_numpy(frame_bgr_u8: np.ndarray) -> np.ndarray:
    """The NumPy body of `bgr_to_lab_u8`: the oracle the native pass is
    held to, and the path where the native library is unavailable."""
    rgb = _GAMMA_TAB[frame_bgr_u8[..., ::-1]]
    f = [_CBRT_TAB[_descale(rgb @ _XYZ_COEFFS[i], _LAB_SHIFT)]
         for i in range(3)]
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << _LAB_SHIFT2)
    lab = np.stack([_descale(lscale * f[1] + lshift, _LAB_SHIFT2),
                    _descale(500 * (f[0] - f[1]) + half, _LAB_SHIFT2),
                    _descale(200 * (f[1] - f[2]) + half, _LAB_SHIFT2)],
                   axis=-1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def _lab_and_sums(frame_bgr_u8: np.ndarray):
    """(Lab, (3,) int64 channel sums) from the native pass, or (Lab, None)
    from the NumPy body where the native library is unavailable."""
    got = native.bgr_to_lab_u8(frame_bgr_u8, _GAMMA_TAB, _CBRT_TAB,
                               _XYZ_COEFFS)
    if got is None:
        return _bgr_to_lab_numpy(frame_bgr_u8), None
    return got


def bgr_to_lab_u8(frame_bgr_u8: np.ndarray) -> np.ndarray:
    """(H,W,3) uint8 BGR -> uint8 Lab with OpenCV's 8-bit encoding
    (L*255/100, a+128, b+128; sRGB gamma, D65 white), within 1 of
    cv2.cvtColor(COLOR_BGR2Lab) on every channel.  One native pass
    (`native.bgr_to_lab_u8`) where the library builds, else the NumPy
    body; the two are the same integer arithmetic and give the same
    bytes."""
    return _lab_and_sums(frame_bgr_u8)[0]


_BGR_TO_LAB_U8 = bgr_to_lab_u8


def rasterize_ids(draw_ids, counts, intervals, h, w) -> np.ndarray:
    """Vectorized scanline fill: per-region draw ids over RLE intervals
    (the same as segment_util/util.py:rasterize_ids, whose module
    imports the protobuf layer)."""
    img = np.full(h * w, -1, np.int64)
    if len(intervals) == 0:
        return img.reshape(h, w)
    ys = intervals[:, 0].astype(np.int64)
    lxs = intervals[:, 1].astype(np.int64)
    rxs = intervals[:, 2].astype(np.int64)
    lens = rxs - lxs + 1
    starts = ys * w + lxs
    total = int(lens.sum())
    offs = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
    pos = np.repeat(starts, lens) + offs
    vals = np.repeat(np.repeat(draw_ids, counts), lens)
    img[pos] = vals
    return img.reshape(h, w)


def _interpolated_add(hist: torch.Tensor, base: torch.Tensor,
                      lab: torch.Tensor, lum_bins: int, color_bins: int):
    """Trilinear interpolated adds of (N,3) float Lab values into the flat
    table `hist` at row offsets `base` (histograms.cpp:142-199: bin
    coordinate v/255*(bins-1), weight split across the 8 surrounding
    bins)."""
    def axis(vals, bins):
        b = vals * ((bins - 1) / 255.0)
        i0 = torch.floor(b).to(torch.int64)
        d = b - i0.to(torch.float32)
        i1 = i0 + (d >= 1e-6).to(torch.int64)
        return ((i0, 1.0 - d), (i1, d))

    xs = axis(lab[:, 0], lum_bins)
    ys = axis(lab[:, 1], color_bins)
    zs = axis(lab[:, 2], color_bins)
    for xi, wx in xs:
        for yi, wy in ys:
            for zi, wz in zs:
                hist.index_add_(
                    0, base + (xi * color_bins + yi) * color_bins + zi,
                    wx * wy * wz)
    return hist


def _accumulate_all(labels: torch.Tensor, lab_u8: torch.Tensor, rcap: int,
                    lum_bins: int, color_bins: int, fbin=None, fmag=None,
                    flow_bins: int = 16):
    """The torch path used without the native accumulator: (rcap, bins) Lab
    color histograms with trilinear interpolated adds
    (histograms.cpp:142-199) and, given per-pixel flow angle bins `fbin`
    and magnitudes `fmag` ((T,H,W) like `labels`), the per-frame flow
    histograms (T, rcap, flow_bins) and vector counts (T, rcap).  Returns
    (hist, flow_hist, flow_cnt); the flow tables have T=0 without flow."""
    nbins = lum_bins * color_bins * color_bins
    lab = lab_u8.reshape(-1, 3).to(torch.float32)
    hist = torch.zeros(rcap * nbins, dtype=torch.float32,
                       device=labels.device)
    _interpolated_add(hist, labels.reshape(-1).long() * nbins, lab,
                      lum_bins, color_bins)
    hist = hist.reshape(rcap, nbins)
    dev = labels.device
    if fbin is None:
        return (hist, torch.zeros((0, rcap, flow_bins), device=dev),
                torch.zeros((0, rcap), device=dev))
    t = labels.shape[0]
    tkey = (torch.arange(t, device=dev)[:, None, None] * rcap
            + labels.long()).reshape(-1)
    fh = torch.zeros(t * rcap * flow_bins, device=dev).index_add_(
        0, tkey * flow_bins + fbin.reshape(-1).long(),
        fmag.reshape(-1).to(torch.float32))
    fc = torch.zeros(t * rcap, device=dev).index_add_(
        0, tkey, torch.ones(tkey.shape, device=dev))
    return hist, fh.reshape(t, rcap, flow_bins), fc.reshape(t, rcap)


def _accumulate_windowed(labels: torch.Tensor, lab_u8: torch.Tensor,
                         gains: torch.Tensor, win_slot: torch.Tensor,
                         rcap: int, wcap: int, lum_bins: int,
                         color_bins: int):
    """The torch path used without the native accumulator: per-window
    gain-calibrated color histograms (WindowedAppearanceDescriptor,
    region_descriptor.cpp:149-205).  Frame t's Lab values are scaled by
    its (3,) gain `gains[t]`, clamped to 255 and added with trilinear
    interpolation into window `win_slot[t]`'s table.  Returns
    ((wcap, rcap, B) histograms, (wcap, rcap) sample counts)."""
    nbins = lum_bins * color_bins * color_bins
    dev = labels.device
    lab = torch.clamp(lab_u8.to(torch.float32) * gains[:, None, None, :],
                      max=255.0).reshape(-1, 3)
    key = (win_slot.long()[:, None, None] * rcap
           + labels.long()).reshape(-1)
    hist = torch.zeros(wcap * rcap * nbins, dtype=torch.float32, device=dev)
    _interpolated_add(hist, key * nbins, lab, lum_bins, color_bins)
    cnt = torch.zeros(wcap * rcap, dtype=torch.float32, device=dev) \
        .index_add_(0, key, torch.ones(key.shape, device=dev))
    return hist.reshape(wcap, rcap, nbins), cnt.reshape(wcap, rcap)


@dataclasses.dataclass
class _ChunkData:
    frames: list                  # SegFrame records (emitted window)
    gids: np.ndarray              # (Rc,) sorted region ids in chunk
    sizes: np.ndarray
    start_frames: np.ndarray
    end_frames: np.ndarray
    neighbor_pairs: np.ndarray
    hist: np.ndarray | None = None       # (Rc, B) float32 host cache
    flow_hist: np.ndarray | None = None  # (Tc, Rc, FB) float32
    flow_cnt: np.ndarray | None = None   # (Tc, Rc) float32
    win_ids: np.ndarray | None = None    # (Wc,) global window indices
    win_hist: np.ndarray | None = None   # (Wc, Rc, B) float32
    win_cnt: np.ndarray | None = None    # (Wc, Rc) float32


@dataclasses.dataclass
class _FrameFeatures:
    lab_u8: np.ndarray            # (H,W,3) uint8 Lab
    flow_bin: np.ndarray | None   # (H,W) int8
    flow_mag: np.ndarray | None   # (H,W) float16


class RegionSegmentation:
    """Chunk-set hierarchical segmentation.  `stage_seconds["region"]`
    holds the wall-clock seconds spent in features, histograms,
    agglomeration and emission: the `region` span of `trace`
    (`runtime/trace.py`; a new one unless given), which also times its
    parts (`region.features`, `.accumulate`, `.tables`, `.upload`,
    `.levels`, `.hierarchy`, `.emit`) and counts per chunk set
    `region.sets`, `region.regions` and `region.table_bytes` (the bytes of
    the tables `agglomerate` copies to the device), and per frame
    `region.lab_native` (a frame converted to Lab by the native pass)."""

    def __init__(self, options: RegionSegmentationOptions, frame_width: int,
                 frame_height: int, *, device: str | torch.device = "cuda",
                 trace: Trace | None = None):
        self.options = options
        self.device = devmod.resolve(device)
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.num_color_bins = (options.luminance_bins * options.color_bins
                               * options.color_bins)
        self._features: dict[int, _FrameFeatures] = {}
        self._chunks: list[_ChunkData] = []
        self._open_frames: list = []
        self._set_id = 0
        self._has_flow = False
        # First-frame Lab mean per appearance window (gain anchors) and
        # per-frame Lab means for the gains.
        self._window_anchor: dict[int, np.ndarray] = {}
        self._frame_means: dict[int, np.ndarray] = {}
        self._prev_assign: list = []
        self.trace = trace if trace is not None else Trace()

    @property
    def stage_seconds(self) -> dict:
        return {"region": self.trace.seconds.get("region", 0.0)}

    # -- per-frame feature ingestion -------------------------------------

    def add_frame(self, frame_index: int, frame_bgr_u8: np.ndarray,
                  flow=None):
        """Register a video frame's appearance (Lab) and, given its backward
        flow (a FlowField or an (H,W,2) array), flow features: the angle
        bin (histograms.cpp:471-479) and the magnitude as float16.  The
        frame's Lab mean is kept for windowed appearance gains; the first
        frame of each window anchors it."""
        with self.trace.span("region"), self.trace.span("region.features"):
            self._add_features(frame_index, frame_bgr_u8, flow)

    def _add_features(self, frame_index, frame_bgr_u8, flow):
        fb = fm = None
        if flow is not None:
            self._has_flow = True
            # FlowFields serve the half-width host copy shared with the
            # dense stage's connectedness download.
            if hasattr(flow, "numpy_f16"):
                flow = flow.numpy_f16().astype(np.float32)
            else:
                flow = np.asarray(flow, np.float32)
            ang = (np.arctan2(flow[..., 1], flow[..., 0])
                   / (2.0 * np.pi + 1e-4) + 0.5)
            fb = np.clip((ang * self.options.flow_bins).astype(np.int32),
                         0, self.options.flow_bins - 1).astype(np.int8)
            fm = np.hypot(flow[..., 0], flow[..., 1]).astype(np.float16)
        if bgr_to_lab_u8 is _BGR_TO_LAB_U8:
            lab, sums = _lab_and_sums(frame_bgr_u8)
        else:  # a conversion put in its place (cv2's, in parity tests)
            lab, sums = bgr_to_lab_u8(frame_bgr_u8), None
        if sums is None:
            mean = lab.reshape(-1, 3).mean(axis=0).astype(np.float32)
        else:
            # Float64 partial sums of uint8 are exact integers, so this is
            # the float32 mean NumPy's gives.
            mean = (sums / (lab.size // 3)).astype(np.float32)
            self.trace.count("region.lab_native")
        self._features[frame_index] = _FrameFeatures(lab, fb, fm)
        self._frame_means[frame_index] = mean
        wsz = self.options.appearance_window_size
        if wsz > 0:
            self._window_anchor.setdefault(frame_index // wsz, mean)

    # -- dense results ingestion -----------------------------------------

    def process_frames(self, flush: bool, seg_frames: list) -> list:
        """Feed dense-stage SegFrames; returns hierarchical SegFrames when a
        chunk set completes (or on flush)."""
        out = []
        with self.trace.span("region"):
            for sf in seg_frames:
                if sf.hierarchy is not None and self._open_frames:
                    self._close_chunk()
                self._open_frames.append(sf)
                out += self._maybe_process_set(False)
            if flush:
                if self._open_frames:
                    self._close_chunk()
                out += self._maybe_process_set(True)
        return out

    # -- chunk bookkeeping ------------------------------------------------

    def _close_chunk(self):
        with self.trace.span("region.accumulate"):
            frames = self._open_frames
            self._open_frames = []
            hier = frames[0].hierarchy[0]
            chunk = _ChunkData(
                frames=frames, gids=hier.ids.astype(np.int64),
                sizes=hier.sizes, start_frames=hier.start_frames,
                end_frames=hier.end_frames,
                neighbor_pairs=hier.neighbor_pairs)
            self._accumulate_chunk(chunk)
            self._chunks.append(chunk)

    def _accumulate_chunk(self, chunk: _ChunkData):
        """Histogram accumulation for one chunk, cached on the host."""
        tc = len(chunk.frames)
        rc = len(chunk.gids)
        rcap = _next_pow2(rc + 1)
        if rcap * self.num_color_bins >= 2 ** 31:
            raise ValueError(
                f"chunk has {rc} over-segmented regions; flat histogram "
                f"keys would overflow int32 (rcap {rcap} * "
                f"{self.num_color_bins} bins)")
        h, w = self.frame_height, self.frame_width
        labels = np.empty((tc, h, w), np.int32)
        lab_u8 = np.empty((tc, h, w, 3), np.uint8)
        use_flow = self._has_flow
        fbin = np.zeros((tc, h, w), np.int8) if use_flow else None
        fmag = np.zeros((tc, h, w), np.float16) if use_flow else None
        for i, sf in enumerate(chunk.frames):
            idx = np.searchsorted(chunk.gids, sf.region_ids)
            intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
            labels[i] = rasterize_ids(idx, sf.interval_counts, intervals,
                                      h, w)
            feat = self._features[sf.frame_index]
            lab_u8[i] = feat.lab_u8
            if use_flow and feat.flow_bin is not None:
                fbin[i] = feat.flow_bin
                fmag[i] = feat.flow_mag

        lum, cb, fb = (self.options.luminance_bins, self.options.color_bins,
                       self.options.flow_bins)
        nat = native.accumulate_lab_hist(labels, lab_u8, rcap, lum, cb)
        if nat is not None:
            chunk.hist = np.ascontiguousarray(nat[0, :rc])
            if use_flow:
                tkey = ((np.arange(tc, dtype=np.int64)[:, None, None] * rcap
                         + labels) * fb + fbin)
                fh = native.weighted_bincount(tkey, fmag.astype(np.float32),
                                              tc * rcap * fb)
                fc = native.weighted_bincount(
                    tkey // fb, np.ones(tkey.size, np.float32), tc * rcap)
                chunk.flow_hist = fh.reshape(tc, rcap, fb)[:, :rc]
                chunk.flow_cnt = fc.reshape(tc, rcap)[:, :rc]
        else:
            def dev(x):
                return None if x is None else torch.as_tensor(
                    x, device=self.device)

            hist, fh, fc = _accumulate_all(
                dev(labels), dev(lab_u8), rcap, lum, cb, dev(fbin),
                dev(fmag), fb)
            chunk.hist = hist[:rc].cpu().numpy()
            if use_flow:
                chunk.flow_hist = fh[:, :rc].cpu().numpy()
                chunk.flow_cnt = fc[:, :rc].cpu().numpy()
        if self.options.appearance_window_size > 0:
            self._accumulate_windows(chunk, labels, lab_u8, rcap)
        for sf in chunk.frames:
            self._features.pop(sf.frame_index, None)
            self._frame_means.pop(sf.frame_index, None)

    def _accumulate_windows(self, chunk: _ChunkData, labels, lab_u8,
                            rcap: int):
        """Per-window histograms of one chunk (JAX `core/region.py`
        `_accumulate_chunk`): each frame's Lab scaled by its window
        anchor's mean over its own mean, into the slot of its window."""
        wsz = self.options.appearance_window_size
        tc, rc = len(chunk.frames), len(chunk.gids)
        wins = sorted({sf.frame_index // wsz for sf in chunk.frames})
        wcap = len(wins) + 1
        if wcap * rcap * self.num_color_bins >= 2 ** 31:
            raise ValueError(
                f"windowed appearance table too large: {wcap} windows * "
                f"{rcap} regions * {self.num_color_bins} bins would overflow "
                f"int32 scatter keys")
        slot_of = {g: i for i, g in enumerate(wins)}
        win_slot = np.full(tc, wcap - 1, np.int32)
        gains = np.ones((tc, 3), np.float32)
        for i, sf in enumerate(chunk.frames):
            feat_mean = self._frame_means[sf.frame_index]
            g = sf.frame_index // wsz
            win_slot[i] = slot_of[g]
            anchor = self._window_anchor.get(g, feat_mean)
            gains[i] = anchor / (feat_mean + 1e-3)
        lum, cb = self.options.luminance_bins, self.options.color_bins
        natw = native.accumulate_lab_hist(labels, lab_u8, rcap, lum, cb,
                                          gains=gains, win_slot=win_slot,
                                          wcap=wcap)
        if natw is not None:
            cnt = native.weighted_bincount(
                win_slot[:, None, None].astype(np.int64) * rcap + labels,
                np.ones(labels.size, np.float32), wcap * rcap)
            chunk.win_hist = np.ascontiguousarray(natw[:len(wins), :rc])
            chunk.win_cnt = cnt.reshape(wcap, rcap)[:len(wins), :rc]
        else:
            def dev(x):
                return torch.as_tensor(x, device=self.device)

            wh, wc = _accumulate_windowed(dev(labels), dev(lab_u8),
                                          dev(gains), dev(win_slot), rcap,
                                          wcap, lum, cb)
            chunk.win_hist = wh[:len(wins), :rc].cpu().numpy()
            chunk.win_cnt = wc[:len(wins), :rc].cpu().numpy()
        chunk.win_ids = np.asarray(wins, np.int64)

    # -- chunk-set processing ---------------------------------------------

    def _maybe_process_set(self, flush: bool) -> list:
        out = []
        while len(self._chunks) >= self.options.chunk_set_size:
            out += self._process_set(self._chunks[:self.options.chunk_set_size],
                                     emit_all=False)
            keep = self.options.chunk_set_overlap
            self._chunks = self._chunks[self.options.chunk_set_size - keep:]
        if flush and self._chunks:
            out += self._process_set(self._chunks, emit_all=True)
            self._chunks = []
        return out

    def _process_set(self, chunks: list[_ChunkData], emit_all: bool) -> list:
        opts = self.options
        span = self.trace.span
        with span("region.tables"):
            tb = self._set_tables(chunks)
        all_gids, r, sizes = tb["all_gids"], tb["r"], tb["sizes"]
        self.trace.count("region.sets")
        self.trace.count("region.regions", r)
        levels_raw = agglomeration.agglomerate(
            tb["hist"], tb["fh"], tb["fc"], sizes, tb["edges"], r,
            min_region_num=opts.min_region_num,
            max_region_num=opts.max_region_num,
            cutoff_fraction=opts.level_cutoff_fraction,
            penalizer=opts.small_region_penalizer,
            use_flow=self._has_flow and opts.use_flow,
            constraints=tb["constraints"], win_hist=tb["whist"],
            win_cnt=tb["wcnt"], reeval_cap=opts.agglo_reeval_cap,
            max_subrounds=opts.agglo_subrounds, device=self.device,
            trace=self.trace)
        rcap = sizes.shape[0]
        if not levels_raw:
            levels_raw = [np.arange(rcap, dtype=np.int32)]

        with span("region.hierarchy"):
            level_ids = []
            for lab in levels_raw:
                ids = np.full(rcap, np.iinfo(np.int64).max, np.int64)
                np.minimum.at(ids, lab[:r], all_gids)
                level_ids.append(ids)
            level_ids = self._inherit_ids(levels_raw, level_ids, all_gids,
                                          sizes, r)
            hierarchy = self._build_hierarchy(
                levels_raw, level_ids, r, all_gids, sizes, tb["start_f"],
                tb["end_f"], tb["pairs"])

            keep = 0 if emit_all else opts.chunk_set_overlap
            if keep:
                ov_gids = np.unique(np.concatenate(
                    [c.gids for c in chunks[-keep:]]))
                pos = np.searchsorted(all_gids, ov_gids)
                self._prev_assign = [
                    (ov_gids, level_ids[lv][levels_raw[lv][pos]])
                    for lv in range(len(levels_raw))]
            else:
                self._prev_assign = []

        with span("region.emit"):
            n_emit_chunks = (len(chunks) if emit_all
                             else len(chunks) - opts.chunk_set_overlap)
            out_frames = [sf for c in chunks[:n_emit_chunks]
                          for sf in c.frames]
            lab0 = levels_raw[0]
            ids0 = level_ids[0]
            results = []
            first_idx = out_frames[0].frame_index
            for k, sf in enumerate(out_frames):
                idx = np.searchsorted(all_gids, sf.region_ids)
                draw = ids0[lab0[idx]]
                intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
                img = rasterize_ids(draw, sf.interval_counts, intervals,
                                    self.frame_height, self.frame_width)
                rids, counts, ys, lxs, rxs = rle.frame_rle(img)
                results.append(SegFrame(
                    frame_width=self.frame_width,
                    frame_height=self.frame_height,
                    region_ids=rids, interval_counts=counts,
                    ys=ys, lxs=lxs, rxs=rxs,
                    moments=rle.shape_moments(counts, ys, lxs, rxs),
                    chunk_size=len(out_frames),
                    overlap_start=len(out_frames), chunk_id=self._set_id,
                    hierarchy_frame_idx=first_idx,
                    hierarchy=hierarchy if k == 0 else None,
                    frame_index=sf.frame_index))
        self._set_id += 1
        return results

    def _set_tables(self, chunks: list[_ChunkData]) -> dict:
        """A chunk set's statistics tables, edges and counterpart
        constraints, merged on the host from its chunks."""
        opts = self.options
        all_gids = np.unique(np.concatenate([c.gids for c in chunks]))
        r = len(all_gids)
        rcap = _next_pow2(r + 1)
        sizes = np.zeros(rcap, np.float32)
        start_f = np.full(r, np.iinfo(np.int32).max, np.int64)
        end_f = np.full(r, -1, np.int64)
        hist = np.zeros((rcap, self.num_color_bins), np.float32)
        # Per-frame flow tables of the set: frames stacked in chunk order.
        t_total = sum(len(c.frames) for c in chunks)
        tcap = _next_pow2(t_total) if self._has_flow else 0
        fh = np.zeros((tcap, rcap, opts.flow_bins), np.float32)
        fc = np.zeros((tcap, rcap), np.float32)
        # Windowed appearance: the set's windows, in window order.
        all_wins = sorted({int(wid) for c in chunks
                           for wid in (c.win_ids if c.win_ids is not None
                                       else [])})
        whist = np.zeros((len(all_wins), rcap, self.num_color_bins),
                         np.float32)
        wcnt = np.zeros((len(all_wins), rcap), np.float32)

        pair_list = []
        t_off = 0
        for c in chunks:
            idx = np.searchsorted(all_gids, c.gids)
            np.add.at(sizes, idx, c.sizes.astype(np.float32))
            np.minimum.at(start_f, idx, c.start_frames)
            np.maximum.at(end_f, idx, c.end_frames)
            hist[idx] += c.hist.astype(np.float32)
            if self._has_flow and c.flow_hist is not None:
                tc = c.flow_hist.shape[0]
                fh[t_off:t_off + tc, idx] = c.flow_hist
                fc[t_off:t_off + tc, idx] = c.flow_cnt
                t_off += tc
            if c.win_hist is not None:
                for wi, wid in enumerate(c.win_ids):
                    slot = all_wins.index(int(wid))
                    whist[slot][idx] += c.win_hist[wi]
                    wcnt[slot][idx] += c.win_cnt[wi]
            if len(c.neighbor_pairs):
                pair_list.append(np.searchsorted(all_gids, c.neighbor_pairs))
        if pair_list:
            pairs = np.unique(np.concatenate(pair_list), axis=0)
        else:
            pairs = np.zeros((0, 2), np.int64)
        ecap = _next_pow2(max(len(pairs), 1))
        edges = np.zeros((ecap, 2), np.int32)
        edges[:len(pairs)] = pairs

        # Counterpart constraints from the previous set's overlap chunks.
        constraints = None
        if self._prev_assign:
            constraints = []
            for pg, pid in self._prev_assign:
                carr = np.full(rcap, -1, np.int32)
                if len(pg):
                    pos = np.searchsorted(pg, all_gids)
                    pos_c = np.minimum(pos, len(pg) - 1)
                    has = pg[pos_c] == all_gids
                    if has.any():
                        hidx = np.flatnonzero(has)
                        _, inv = np.unique(pid[pos_c[hidx]],
                                           return_inverse=True)
                        carr[hidx] = inv.astype(np.int32)
                constraints.append(carr)

        return dict(all_gids=all_gids, r=r, sizes=sizes, start_f=start_f,
                    end_f=end_f, hist=hist, fh=fh, fc=fc, whist=whist,
                    wcnt=wcnt, pairs=pairs, edges=edges,
                    constraints=constraints)

    def _inherit_ids(self, levels_raw, level_ids, all_gids, sizes, r):
        """Carry hierarchy ids across chunk sets (see the JAX package): a
        group inherits a previous-set id X only when the region with gid X
        is one of its members; the largest carried size wins."""
        if not self._prev_assign:
            return level_ids
        out = []
        for lv, lab in enumerate(levels_raw):
            ids = level_ids[lv]
            if lv >= len(self._prev_assign):
                out.append(ids)
                continue
            pg, pid = self._prev_assign[lv]
            pos = np.searchsorted(pg, all_gids)
            pos_c = np.minimum(pos, len(pg) - 1)
            has = (len(pg) > 0) & (pg[pos_c] == all_gids)
            mi = np.flatnonzero(has)
            if not len(mi):
                out.append(ids)
                continue
            roots_m = lab[mi]
            prev_m = pid[pos_c[mi]]
            w_m = sizes[mi]
            order = np.lexsort((prev_m, roots_m))
            rk, pk, wk = roots_m[order], prev_m[order], w_m[order]
            new = np.ones(len(rk), bool)
            new[1:] = (rk[1:] != rk[:-1]) | (pk[1:] != pk[:-1])
            starts = np.flatnonzero(new)
            wsum = np.add.reduceat(wk, starts)
            g_root, g_prev = rk[starts], pk[starts]
            xpos = np.searchsorted(all_gids, g_prev)
            xpos_c = np.minimum(xpos, r - 1)
            xin = all_gids[xpos_c] == g_prev
            xok = xin & (lab[xpos_c] == g_root)
            g_root, g_prev, wsum = g_root[xok], g_prev[xok], wsum[xok]
            if len(g_root):
                order2 = np.lexsort((-wsum, g_root))
                first = np.ones(len(order2), bool)
                rr = g_root[order2]
                first[1:] = rr[1:] != rr[:-1]
                sel = order2[first]
                ids = ids.copy()
                ids[g_root[sel]] = g_prev[sel]
            out.append(ids)
        return out

    def _build_hierarchy(self, levels_raw, level_ids, r, all_gids, sizes,
                         start_f, end_f, pairs):
        """HierarchyLevelData per level: level 0 = the cut regions, upper
        levels with parent/child links."""
        out = []
        for lv, lab in enumerate(levels_raw):
            roots = np.unique(lab[:r])
            ids = level_ids[lv][roots]
            order = np.argsort(ids)
            roots = roots[order]
            ids = ids[order]
            lsizes = np.zeros(len(lab), np.float64)
            np.add.at(lsizes, lab[:r], sizes[:r])
            lstart = np.full(len(lab), np.iinfo(np.int32).max, np.int64)
            lend = np.full(len(lab), -1, np.int64)
            np.minimum.at(lstart, lab[:r], start_f)
            np.maximum.at(lend, lab[:r], end_f)
            if len(pairs):
                lp = level_ids[lv][lab[pairs]]
                lp = np.sort(lp, axis=1)
                lp = np.unique(lp[lp[:, 0] != lp[:, 1]], axis=0)
            else:
                lp = np.zeros((0, 2), np.int64)
            parent_ids = None
            if lv + 1 < len(levels_raw):
                parent_ids = level_ids[lv + 1][levels_raw[lv + 1][roots]]
            child_pairs = None
            if lv > 0:
                prev_roots = np.unique(levels_raw[lv - 1][:r])
                cp_parent = level_ids[lv][lab[prev_roots]]
                cp_child = level_ids[lv - 1][prev_roots]
                child_pairs = np.stack([cp_parent, cp_child], axis=1)
            out.append(HierarchyLevelData(
                ids=ids, sizes=lsizes[roots].astype(np.int64),
                start_frames=lstart[roots], end_frames=lend[roots],
                neighbor_pairs=lp, parent_ids=parent_ids,
                child_pairs=child_pairs))
        return out
