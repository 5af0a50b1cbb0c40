"""Dense TV-L1 optical flow on torch tensors, plus the `.flow` cache.

Port of video_segment_tpu/core/flow.py (algorithm, calibration notes and
reference citations there): Zach et al.'s duality-based TV-L1 with an
image pyramid (every level at least 16 px on its short side), per-scale
warps, the pointwise thresholding step on the data term and Chambolle
dual updates on the smoothness term; the finest scale runs its own
`fine_warps` x `fine_iterations` schedule.  Inputs are grayscale [0,1],
scaled by 255 inside.  Every op carries a leading batch dimension, so
`tvl1_flow_batch` computes B pairs in the same launches as one.

On a CUDA tensor each scale's warps and iterations run as hand-written
kernels (`ops/tvl1.py`, `csrc/tvl1.cu`), one C call a scale, bit for bit
the eager body; the pyramid, `_grad` and the resizes stay torch ops.  On
a CPU tensor the JAX `fori_loop` is a Python loop of ordinary torch ops
(`_tvl1_scale`, the plain version).  The `.flow` files are byte-compatible
with the JAX package's and the reference's (flow_reader.cpp:239-249).
This module imports neither jax nor cv2.
"""

from __future__ import annotations

import contextlib
import os
import struct
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.ops import tvl1 as tvl1_ops


class TVL1Params(NamedTuple):
    """Fields and defaults identical to the JAX package's TVL1Params."""
    tau: float = 0.25
    lambda_: float = 0.15
    theta: float = 0.3
    nscales: int = 8
    warps: int = 3
    iterations: int = 40
    fine_warps: int = 2
    fine_iterations: int = 20
    epsilon: float = 0.01


def tvl1_params_from_jax(p) -> TVL1Params:
    """Map a JAX TVL1Params (or its `_asdict()`) to the port's."""
    d = p._asdict() if hasattr(p, "_asdict") else dict(p)
    return TVL1Params(**{k: d[k] for k in TVL1Params._fields if k in d})


def _downsample2(img):
    """2x2 box mean over the last two dims (odd edges dropped)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2, w // 2
    x = img[..., :h2 * 2, :w2 * 2].reshape(*img.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def _resize_bilinear(img, out_h, out_w):
    h, w = img.shape[-2:]
    dev = img.device
    ys = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5)
          * (h / out_h) - 0.5)
    xs = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5)
          * (w / out_w) - 0.5)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]
    r0 = img[..., y0, :]
    r1 = img[..., y1, :]
    a, b = r0[..., x0], r0[..., x1]
    c, d = r1[..., x0], r1[..., x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _warp(img, u1, u2):
    """Bilinear sample img at (x+u1, y+u2), clamped.  `img` is (..., H, W)
    with leading dims that broadcast over u1/u2's (B, H, W): one index
    computation serves several images warped by the same flow."""
    h, w = img.shape[-2:]
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + u2
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + u1
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(*yy.shape[:-2], h * w)
        return torch.gather(flat, -1, idx.expand(flat.shape)) \
            .reshape(img.shape)

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def _grad(img):
    """Central differences (forward at borders)."""
    gx = torch.cat([img[..., :, 1:2] - img[..., :, 0:1],
                    0.5 * (img[..., :, 2:] - img[..., :, :-2]),
                    img[..., :, -1:] - img[..., :, -2:-1]], dim=-1)
    gy = torch.cat([img[..., 1:2, :] - img[..., 0:1, :],
                    0.5 * (img[..., 2:, :] - img[..., :-2, :]),
                    img[..., -1:, :] - img[..., -2:-1, :]], dim=-2)
    return gx, gy


def _forward_diff(u):
    ux = F.pad(u[..., :, 1:] - u[..., :, :-1], (0, 1))
    uy = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 0, 1))
    return ux, uy


def _divergence(p1, p2):
    """Backward-difference divergence (adjoint of forward gradient):
    d[0] = p[0], d[i] = p[i] - p[i-1], d[-1] = -p[-2] along each axis."""
    q1 = p1[..., :, :-1]
    q2 = p2[..., :-1, :]
    d1 = F.pad(q1, (0, 1)) - F.pad(q1, (1, 0))
    d2 = F.pad(q2, (0, 0, 0, 1)) - F.pad(q2, (0, 0, 1, 0))
    return d1 + d2


def _tvl1_scale(i0, i1, u1, u2, p: TVL1Params):
    """Warps + primal-dual iterations at one pyramid scale ((B,H,W))."""
    i1x, i1y = _grad(i1)
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta

    p11 = torch.zeros_like(i0)
    p12 = torch.zeros_like(i0)
    p21 = torch.zeros_like(i0)
    p22 = torch.zeros_like(i0)
    stack = torch.stack([i1, i1x, i1y])

    for _ in range(p.warps):
        i1w, i1wx, i1wy = _warp(stack, u1, u2)
        grad2 = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
        # Loop invariants of the thresholding step (same values as the
        # JAX body computes each iteration).
        hi_t = l_t * grad2
        lo_t = -l_t * grad2
        g = torch.clamp(grad2, min=1e-9)
        step1, step2 = l_t * i1wx, l_t * i1wy
        nstep1, nstep2 = -l_t * i1wx, -l_t * i1wy
        for _ in range(p.iterations):
            rho = rho_c + i1wx * u1 + i1wy * u2
            lo = rho < lo_t
            hi = rho > hi_t
            nrho = -rho
            d1 = torch.where(lo, step1,
                             torch.where(hi, nstep1, nrho * i1wx / g))
            d2 = torch.where(lo, step2,
                             torch.where(hi, nstep2, nrho * i1wy / g))
            v1 = u1 + d1
            v2 = u2 + d2
            # Dual ascent on the TV term.
            u1 = v1 + p.theta * _divergence(p11, p12)
            u2 = v2 + p.theta * _divergence(p21, p22)
            u1x, u1y = _forward_diff(u1)
            u2x, u2y = _forward_diff(u2)
            ng1 = 1.0 + taut * torch.hypot(u1x, u1y)
            ng2 = 1.0 + taut * torch.hypot(u2x, u2y)
            p11 = (p11 + taut * u1x) / ng1
            p12 = (p12 + taut * u1y) / ng1
            p21 = (p21 + taut * u2x) / ng2
            p22 = (p22 + taut * u2y) / ng2
    return u1, u2


def _tvl1_scale_kernel(i0, i1, u1, u2, p: TVL1Params):
    """`_tvl1_scale` through the CUDA kernels (raises off a card)."""
    i1x, i1y = _grad(i1)
    return tvl1_ops.tvl1_scale(i0, i1, i1x, i1y, u1, u2, p)


def _pyramid_scales(h: int, w: int, nscales: int) -> int:
    """Scales of the pyramid over (h, w): every level keeps min-dim >= 16
    (see the JAX module)."""
    n = 1
    while n < nscales and min(h, w) // 2 >= 16:
        h, w, n = h // 2, w // 2, n + 1
    return n


def kernel_launches(h: int, w: int, params: TVL1Params) -> int:
    """K5 launches of one `tvl1_flow_batch` of (h, w) pairs on a card,
    whatever the batch: a warp launch and one per iteration, per warp, at
    every scale."""
    n = _pyramid_scales(h, w, params.nscales)
    return ((n - 1) * max(params.warps, 0) * (1 + max(params.iterations, 0))
            + max(params.fine_warps, 0)
            * (1 + max(params.fine_iterations, 0)))


def _tvl1_flow_impl(i0, i1, params: TVL1Params, scale=None):
    """(B,H,W) pairs -> (B,H,W,2) flow from i0 to i1.  `scale` runs one
    pyramid scale: by default the eager body on the CPU, else the
    kernels."""
    if scale is None:
        scale = _tvl1_scale if i0.device.type == "cpu" else _tvl1_scale_kernel
    i0 = i0 * 255.0
    i1 = i1 * 255.0
    pyr0 = [i0]
    pyr1 = [i1]
    for _ in range(_pyramid_scales(*i0.shape[-2:], params.nscales) - 1):
        pyr0.append(_downsample2(pyr0[-1]))
        pyr1.append(_downsample2(pyr1[-1]))

    u1 = torch.zeros_like(pyr0[-1])
    u2 = torch.zeros_like(pyr0[-1])
    for s in range(len(pyr0) - 1, -1, -1):
        hs, ws = pyr0[s].shape[-2:]
        if u1.shape != pyr0[s].shape:
            sy = hs / u1.shape[-2]
            sx = ws / u1.shape[-1]
            u1 = _resize_bilinear(u1, hs, ws) * sx
            u2 = _resize_bilinear(u2, hs, ws) * sy
        p = (params._replace(warps=params.fine_warps,
                             iterations=params.fine_iterations)
             if s == 0 else params)
        u1, u2 = scale(pyr0[s], pyr1[s], u1, u2, p)
    return torch.stack([u1, u2], dim=-1)


def tvl1_flow(i0: torch.Tensor, i1: torch.Tensor,
              params: TVL1Params = TVL1Params()) -> torch.Tensor:
    """Dense flow from i0 to i1 (grayscale float [0,1], (H,W)); (H,W,2)
    on the inputs' device."""
    return _tvl1_flow_impl(i0[None], i1[None], params)[0]


def tvl1_flow_batch(i0s: torch.Tensor, i1s: torch.Tensor,
                    params: TVL1Params = TVL1Params()) -> torch.Tensor:
    """Batched flow over B frame pairs ((B,H,W) -> (B,H,W,2)): the batch
    is a leading dimension of every op, one launch sequence for all."""
    return _tvl1_flow_impl(i0s, i1s, params)


def tvl1_flow_plain(i0s: torch.Tensor, i1s: torch.Tensor,
                    params: TVL1Params = TVL1Params()) -> torch.Tensor:
    """`tvl1_flow_batch` through the eager body on any device: the plain
    version the kernels are held to on the card."""
    return _tvl1_flow_impl(i0s, i1s, params, _tvl1_scale)


def bgr_to_gray(frame_bgr_u8: np.ndarray) -> np.ndarray:
    """BT.601 luminance in [0,1] (LuminanceUnit, conversion_units.cpp)."""
    f = frame_bgr_u8.astype(np.float32)
    return (0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]) / 255.0


FLOW_FORWARD = 0
FLOW_BACKWARD = 1
FLOW_BOTH = 2


class _LazyFlowBatch:
    """Shared host cache for one micro-batch of device flow fields: the
    first host consumer triggers ONE float16 download of the whole
    (B,H,W,2) batch, and every FlowField of the batch serves its slice
    from it (see the JAX module for why f16 suffices)."""

    __slots__ = ("dev", "_f16")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev          # (B,H,W,2) float32 on the engine's device
        self._f16 = None

    def f16(self, i: int) -> np.ndarray:
        if self._f16 is None:
            self._f16 = self.dev.to(torch.float16).cpu().numpy()
        return self._f16[i]


class FlowField:
    """Handle for one frame's (H,W,2) flow field (see the JAX FlowField):
    device-resident when computed by the engine, so the dense solver reads
    `.device()` without a host round trip; host consumers read
    `.numpy_f16()` (batched half-width download) or `.numpy()` /
    `np.asarray(field)` (exact float32, for the `.flow` writer)."""

    __slots__ = ("_dev", "_host", "_batch", "_idx", "_target")

    def __init__(self, dev: torch.Tensor | None = None, host=None,
                 batch: _LazyFlowBatch | None = None, idx: int = 0,
                 device: str | torch.device | None = None):
        self._dev = dev
        self._host = None if host is None else np.asarray(host, np.float32)
        self._batch = batch
        self._idx = idx
        self._target = (dev.device if dev is not None
                        else torch.device(device or "cpu"))

    def device(self) -> torch.Tensor:
        """(H,W,2) float32 on the engine's device (uploads once for
        host-backed fields)."""
        if self._dev is None:
            # A copy: cache-read fields are read-only buffers.
            self._dev = torch.tensor(self.numpy(), device=self._target)
        return self._dev

    def numpy(self) -> np.ndarray:
        """Exact float32 host copy (downloads once)."""
        if self._host is None:
            self._host = self._dev.to(torch.float32).cpu().numpy()
        return self._host

    def numpy_f16(self) -> np.ndarray:
        """Half-width host copy for tolerance-insensitive consumers; serves
        the exact copy when one already exists or the field has no batch."""
        if self._host is not None:
            return self._host
        if self._batch is not None:
            return self._batch.f16(self._idx)
        return self.numpy()

    @property
    def shape(self):
        src = self._host if self._host is not None else self._dev
        return tuple(src.shape)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and a.dtype != np.dtype(dtype):
            return a.astype(dtype)
        return a.copy() if copy else a


def as_flow_host(flow, prefer_f16: bool = True) -> np.ndarray | None:
    """Host array view of a flow argument (FlowField or ndarray or None)."""
    if flow is None:
        return None
    if isinstance(flow, FlowField):
        return flow.numpy_f16() if prefer_f16 else flow.numpy()
    return np.asarray(flow)


def flow_to_hsv_bgr(flow) -> np.ndarray:
    """Render a flow field as a BGR image: hue from flow angle, saturation
    and value from magnitude (flow_reader.cpp:306-330 formula exactly:
    H=(atan2(y,x)/pi+1)*90, S=V=min(|f|*20, 255))."""
    import cv2

    flow = as_flow_host(flow)
    x, y = flow[..., 0], flow[..., 1]
    hsv = np.empty((*x.shape, 3), np.uint8)
    hsv[..., 0] = ((np.arctan2(y, x) / np.pi + 1.0) * 90.0).astype(np.uint8)
    mag = np.minimum(np.hypot(x, y) * 20.0, 255.0).astype(np.uint8)
    hsv[..., 1] = mag
    hsv[..., 2] = mag
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


class FlowPair(NamedTuple):
    """Per-frame flow fields when flow_type != FLOW_BACKWARD (forward =
    calc(prev, cur), backward = calc(cur, prev))."""

    forward: FlowField | None
    backward: FlowField | None


class FlowCacheWriter:
    """Reference-compatible .flow file writer (flow_reader.cpp:239-249):
    int32 width/height/flow_type header, then raw float32 (x,y) fields."""

    def __init__(self, path: str, width: int, height: int,
                 flow_type: int = FLOW_BACKWARD):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<iii", width, height, flow_type))

    def write(self, flow) -> None:
        self._f.write(np.ascontiguousarray(flow, np.float32).tobytes())

    def close(self) -> None:
        self._f.close()


class FlowCacheReader:
    """Reference-compatible .flow file reader."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self.width, self.height, self.flow_type = struct.unpack(
            "<iii", self._f.read(12))
        self._frame_bytes = self.width * self.height * 2 * 4

    def read(self) -> np.ndarray | None:
        buf = self._f.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            return None
        return np.frombuffer(buf, np.float32).reshape(
            self.height, self.width, 2)

    def close(self) -> None:
        self._f.close()


class FlowEngine:
    """Streaming flow provider on `device` with transparent .flow caching
    (seg_tree.cpp:120-126: reuse <input>.flow when present).

    `flow_type` is BACKWARD (default: what segmentation consumes; results
    are FlowFields), FORWARD or BOTH (results are FlowPairs; the cache
    stores forward then backward per frame).  `compute(frame, idx)` is
    synchronous per frame; `push(frame, idx)` / `flush()` micro-batch
    `batch` pairs into one `tvl1_flow_batch` and return completed
    (idx, frame, flow) triples in order.  `device` defaults to "cuda" and
    raises without CUDA, like every entry of the port.  With a `trace`
    (`runtime/trace.py`), each micro-batch is a `flow` span (its launches
    and, when a cache is written, the fields' download, which waits for
    the device) and counts its computed fields in `flow.pairs`, and in
    `flow.kernel_pairs` those whose every K5 launch the kernels made (read
    from the wrapper's launches on this thread: every one on a card, none
    on the CPU)."""

    def __init__(self, width: int, height: int, cache_path: str | None = None,
                 params: TVL1Params = TVL1Params(), batch: int = 6,
                 flow_type: int = FLOW_BACKWARD, *,
                 device: str | torch.device = "cuda", trace=None):
        self.device = devmod.resolve(device)
        self.trace = trace
        self.params = params
        self.batch = max(batch, 1)
        self.flow_type = flow_type
        self._pending: list[tuple[int, np.ndarray, torch.Tensor]] = []
        self._prev: torch.Tensor | None = None   # gray of the last frame
        self._kernel_pairs = 0   # since the last `_count`
        self._reader = None
        self._writer = None
        if cache_path and os.path.exists(cache_path):
            try:
                r = FlowCacheReader(cache_path)
                if (r.width, r.height) == (width, height):
                    self._reader = r
                    self.flow_type = r.flow_type
                else:
                    r.close()
            except (OSError, struct.error):
                pass  # corrupt/truncated cache: recompute
        elif cache_path:
            try:
                self._writer = FlowCacheWriter(cache_path, width, height,
                                               flow_type)
            except OSError:
                self._writer = None  # unwritable location: just recompute

    def _gray(self, frame_bgr_u8: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(bgr_to_gray(frame_bgr_u8), device=self.device)

    def _wrap(self, fwd, bwd):
        if self.flow_type == FLOW_BACKWARD:
            return bwd
        return FlowPair(fwd, bwd)

    def _read_cached(self):
        def field(want):
            if self.flow_type not in want:
                return None
            arr = self._reader.read()
            return None if arr is None else FlowField(host=arr,
                                                      device=self.device)

        fwd = field((FLOW_FORWARD, FLOW_BOTH))
        bwd = field((FLOW_BACKWARD, FLOW_BOTH))
        return self._wrap(fwd, bwd)

    def _write_cached(self, fwd, bwd) -> None:
        if self._writer is None:
            return
        if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
            self._writer.write(fwd)
        if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
            self._writer.write(bwd)

    def compute(self, frame_bgr_u8: np.ndarray, frame_index: int):
        """Flow for this frame (None for the first)."""
        if self._reader is not None:
            if frame_index == 0:
                return None
            return self._read_cached()
        cur = self._gray(frame_bgr_u8)
        flow = None
        if self._prev is not None:
            fwd = bwd = None
            if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
                fwd = FlowField(dev=self._tvl1(self._prev[None],
                                               cur[None])[0])
            if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
                bwd = FlowField(dev=self._tvl1(cur[None],
                                               self._prev[None])[0])
            self._count(int(fwd is not None) + int(bwd is not None))
            self._write_cached(fwd, bwd)
            flow = self._wrap(fwd, bwd)
        self._prev = cur
        return flow

    # -- micro-batched path -------------------------------------------------

    def push(self, frame_bgr_u8: np.ndarray, frame_index: int) -> list:
        """Buffer a frame; return completed (idx, frame, flow) triples."""
        if self._reader is not None:
            fl = None if frame_index == 0 else self._read_cached()
            return [(frame_index, frame_bgr_u8, fl)]
        self._pending.append((frame_index, frame_bgr_u8,
                              self._gray(frame_bgr_u8)))
        # The first frame of the stream has no backward flow: release it
        # immediately so downstream chunking is not skewed.
        out = []
        if frame_index == 0:
            idx, frame, gray = self._pending.pop(0)
            self._prev = gray
            out.append((idx, frame, None))
        if len(self._pending) >= self.batch:
            out.extend(self._drain())
        return out

    def flush(self) -> list:
        """Compute flow for all remaining buffered frames."""
        return self._drain()

    def _drain(self) -> list:
        if not self._pending:
            return []
        with (self.trace.span("flow") if self.trace is not None
              else contextlib.nullcontext()):
            return self._drain_batch()

    def _drain_batch(self) -> list:
        grays = [g for _, _, g in self._pending]
        prevs = ([self._prev] if self._prev is not None
                 else [grays[0]]) + grays[:-1]
        n = len(grays)
        prevs_a = torch.stack(prevs)
        curs_a = torch.stack(grays)

        def fields(dev_batch):
            lazy = _LazyFlowBatch(dev_batch)
            return [FlowField(dev=dev_batch[i], batch=lazy, idx=i)
                    for i in range(n)]

        fwds = bwds = [None] * n
        if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
            bwds = fields(self._tvl1(curs_a, prevs_a))
        if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
            fwds = fields(self._tvl1(prevs_a, curs_a))
        self._count(n * (2 if self.flow_type == FLOW_BOTH else 1))
        out = []
        for (idx, frame, _), fw, bw in zip(self._pending, fwds, bwds):
            self._write_cached(fw, bw)
            out.append((idx, frame, self._wrap(fw, bw)))
        self._prev = grays[-1]
        self._pending.clear()
        return out

    def _tvl1(self, i0s, i1s):
        """`tvl1_flow_batch`, adding its pairs to `_kernel_pairs` when the
        kernels made every launch of it."""
        n0 = tvl1_ops.thread_launches()
        out = tvl1_flow_batch(i0s, i1s, self.params)
        want = kernel_launches(*i0s.shape[-2:], self.params)
        if want > 0 and tvl1_ops.thread_launches() - n0 == want:
            self._kernel_pairs += i0s.shape[0]
        return out

    def _count(self, pairs: int) -> None:
        if self.trace is not None:
            self.trace.count("flow.pairs", pairs)
            self.trace.count("flow.kernel_pairs", self._kernel_pairs)
        self._kernel_pairs = 0

    def close(self) -> None:
        if self._reader:
            self._reader.close()
        if self._writer:
            self._writer.close()
