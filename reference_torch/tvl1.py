"""A plain TV-L1 optical flow: the yardstick the port's flow is held to.

The duality-based TV-L1 of Zach, Pock and Bischof ("A Duality Based
Approach for Realtime TV-L1 Optical Flow", DAGM 2007), as the port states
it (`video_segment_tpu_torch/core/flow.py`): grayscale input in [0, 1]
scaled by 255, an image pyramid in which every level is at least 16 px on
its short side, per-scale warps, the pointwise thresholding of the data
term and Chambolle's dual updates of the smoothness term, with tau 0.25,
lambda 0.15, theta 0.3, up to 8 scales, 3 warps x 40 iterations and, at
the finest scale, 2 warps x 20 iterations.

Written for reading, not speed: one frame pair at a time, float32 (or the
dtype asked for), every step a few plain torch ops on (H, W) tensors, no
batching, no cache, no kernel, TF32 off.  It imports only torch and
numpy.

Where it departs from the published algorithm, and from OpenCV's
`DualTVL1OpticalFlow`, which the upstream `seg_tree` calls
(flow_reader.cpp; warps 2 and iterations 10 there, seg_tree.cpp:174-175):

- A fixed number of iterations per warp; no stopping rule on the change
  of u (OpenCV's epsilon 0.01, up to 300 iterations).
- The pyramid halves each level by a 2x2 box mean, dropping an odd last
  row or column, and stops before a level under 16 px on its short side
  (OpenCV: `scaleStep` 0.8 by bilinear resizing, `nscales` 5, no floor).
- The finest scale runs its own 2 x 20 schedule.
- Warping samples bilinearly at clamped coordinates (OpenCV: bicubic
  `remap` with replicated borders); the gradients of the second image are
  taken once a scale by central differences (one-sided at the borders)
  and warped with it, as OpenCV does.
- The flow passed to a finer scale is resized bilinearly with pixel
  centres aligned and scaled by the ratio of the sizes.
- No median filtering of the flow between warps (OpenCV's
  `medianFiltering` 5), and no gamma term.
- The thresholding step divides by max(|grad I1|^2, 1e-9) where OpenCV
  tests |grad I1|^2 against a small epsilon.
- The grayscale conversion is BT.601 luminance, 0.299 R + 0.587 G +
  0.114 B, over 255.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Params:
    tau: float = 0.25
    lam: float = 0.15
    theta: float = 0.3
    nscales: int = 8
    warps: int = 3
    iterations: int = 40
    fine_warps: int = 2
    fine_iterations: int = 20


def gray(frame_bgr: np.ndarray) -> np.ndarray:
    """BT.601 luminance in [0, 1], float32, of a BGR uint8 frame."""
    bgr = frame_bgr.astype(np.float32)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    return ((np.float32(0.299) * r + np.float32(0.587) * g
             + np.float32(0.114) * b) / np.float32(255.0)).astype(np.float32)


def _halve(img: torch.Tensor) -> torch.Tensor:
    """2x2 box mean; an odd last row or column is dropped."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    return (img[0::2, 0::2] + img[0::2, 1::2]
            + img[1::2, 0::2] + img[1::2, 1::2]) / 4


def _bilinear(img: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """img sampled at real coordinates (y, x) (pixel centres at integers),
    each clamped into the image: the edge value outside it."""
    h, w = img.shape
    y = y.clamp(0, h - 1)
    x = x.clamp(0, w - 1)
    y0 = y.floor()
    x0 = x.floor()
    fy = y - y0
    fx = x - x0
    # Clamped again as integers: in a precision below float32 the bound
    # h - 1 itself may round up to h.
    y0 = y0.long().clamp(0, h - 1)
    x0 = x0.long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bottom = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bottom * fy


def _grid(h: int, w: int, like: torch.Tensor) -> tuple:
    ys = torch.arange(h, device=like.device, dtype=like.dtype)
    xs = torch.arange(w, device=like.device, dtype=like.dtype)
    return ys[:, None].expand(h, w), xs[None, :].expand(h, w)


def _upscale(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """u resized to (h, w), pixel centres aligned (half-pixel offsets)."""
    y, x = _grid(h, w, u)
    sy, sx = u.shape[0] / h, u.shape[1] / w
    return _bilinear(u, (y + 0.5) * sy - 0.5, (x + 0.5) * sx - 0.5)


def _central_gradient(img: torch.Tensor) -> tuple:
    """(d/dx, d/dy): central differences, one-sided at the borders."""
    gx = torch.empty_like(img)
    gy = torch.empty_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2
    gx[:, 0] = img[:, 1] - img[:, 0]
    gx[:, -1] = img[:, -1] - img[:, -2]
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) / 2
    gy[0, :] = img[1, :] - img[0, :]
    gy[-1, :] = img[-1, :] - img[-2, :]
    return gx, gy


def _forward_gradient(u: torch.Tensor) -> tuple:
    """Forward differences, 0 on the last column / row."""
    ux = torch.zeros_like(u)
    uy = torch.zeros_like(u)
    ux[:, :-1] = u[:, 1:] - u[:, :-1]
    uy[:-1, :] = u[1:, :] - u[:-1, :]
    return ux, uy


def _divergence(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Minus the adjoint of `_forward_gradient`: backward differences,
    p[0] at the first column / row and -p[-2] at the last."""
    dx = torch.empty_like(px)
    dx[:, 0] = px[:, 0]
    dx[:, 1:-1] = px[:, 1:-1] - px[:, :-2]
    dx[:, -1] = -px[:, -2]
    dy = torch.empty_like(py)
    dy[0, :] = py[0, :]
    dy[1:-1, :] = py[1:-1, :] - py[:-2, :]
    dy[-1, :] = -py[-2, :]
    return dx + dy


def _solve_scale(i0, i1, u1, u2, warps: int, iterations: int, p: Params):
    h, w = i0.shape
    y, x = _grid(h, w, i0)
    i1x, i1y = _central_gradient(i1)
    lt = p.lam * p.theta
    step = p.tau / p.theta
    p1x = torch.zeros_like(i0)
    p1y = torch.zeros_like(i0)
    p2x = torch.zeros_like(i0)
    p2y = torch.zeros_like(i0)
    for _ in range(warps):
        # Linearise I1 around the current flow.
        wy, wx = y + u2, x + u1
        i1w = _bilinear(i1, wy, wx)
        gx = _bilinear(i1x, wy, wx)
        gy = _bilinear(i1y, wy, wx)
        g2 = gx * gx + gy * gy
        u1_0, u2_0 = u1, u2
        for _ in range(iterations):
            # Data term: rho(u) = I1(x + u0) + grad I1 . (u - u0) - I0.
            rho = i1w + gx * (u1 - u1_0) + gy * (u2 - u2_0) - i0
            below = rho < -lt * g2
            above = rho > lt * g2
            inside = -rho / g2.clamp(min=1e-9)
            v1 = u1 + torch.where(below, lt * gx,
                                  torch.where(above, -lt * gx, inside * gx))
            v2 = u2 + torch.where(below, lt * gy,
                                  torch.where(above, -lt * gy, inside * gy))
            # Smoothness term: primal step, then Chambolle's dual step.
            u1 = v1 + p.theta * _divergence(p1x, p1y)
            u2 = v2 + p.theta * _divergence(p2x, p2y)
            u1x, u1y = _forward_gradient(u1)
            u2x, u2y = _forward_gradient(u2)
            n1 = 1 + step * torch.sqrt(u1x * u1x + u1y * u1y)
            n2 = 1 + step * torch.sqrt(u2x * u2x + u2y * u2y)
            p1x = (p1x + step * u1x) / n1
            p1y = (p1y + step * u1y) / n1
            p2x = (p2x + step * u2x) / n2
            p2y = (p2y + step * u2y) / n2
    return u1, u2


def tvl1(i0: torch.Tensor, i1: torch.Tensor,
         params: Params = Params()) -> torch.Tensor:
    """Flow from i0 to i1, grayscale (H, W) in [0, 1]: (H, W, 2), (dx,
    dy) such that i0(x) ~ i1(x + flow(x)), in the inputs' dtype and on
    their device."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        levels = [(i0 * 255, i1 * 255)]
        while len(levels) < params.nscales and \
                min(levels[-1][0].shape) // 2 >= 16:
            a, b = levels[-1]
            levels.append((_halve(a), _halve(b)))
        u1 = torch.zeros_like(levels[-1][0])
        u2 = torch.zeros_like(levels[-1][0])
        for s in reversed(range(len(levels))):
            a, b = levels[s]
            h, w = a.shape
            if u1.shape != a.shape:
                ry, rx = h / u1.shape[0], w / u1.shape[1]
                u1 = _upscale(u1, h, w) * rx
                u2 = _upscale(u2, h, w) * ry
            if s == 0:
                warps, iterations = params.fine_warps, params.fine_iterations
            else:
                warps, iterations = params.warps, params.iterations
            u1, u2 = _solve_scale(a, b, u1, u2, warps, iterations, params)
        return torch.stack([u1, u2], dim=-1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def flow_bgr(prev_bgr: np.ndarray, cur_bgr: np.ndarray,
             device: str | torch.device = "cpu",
             params: Params = Params(),
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Backward flow of a pair of BGR uint8 frames (from `cur` to `prev`,
    what the port's `.flow` file holds for `cur`), float32 (H, W, 2) on
    the host."""
    a = torch.as_tensor(gray(cur_bgr), device=device).to(dtype)
    b = torch.as_tensor(gray(prev_bgr), device=device).to(dtype)
    return tvl1(a, b, params).float().cpu().numpy()
