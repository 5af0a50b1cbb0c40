"""Seeded synthetic clips: the traffic generator of every cell.

Moving piecewise-smooth textured ellipses over a background texture that
pans 2 px left a frame, plus sensor noise, as BGR uint8 frames, and the
ground truth the check reads: each pixel's object (0 the background,
k + 1 the k-th ellipse).  With `sizes="drawn"` and the default texture
and noise it is the repository's `chip_smoke.synthetic_clip`, frame for
frame.  With `sizes="fixed"` every seed paints the same ellipses (radii,
texture amplitudes, speeds) in another order, place, direction and
colour, and they bounce off the frame's borders instead of leaving it,
so that every seed shows the same amount of structure.

With `texture_motion="rigid"` each ellipse carries a texture patch of its
own, sampled bilinearly in ellipse-relative coordinates, so the whole
ellipse translates rigidly (bounces included), and `motion` gives the
backward displacement each pixel was drawn with: what a backward flow
field (frame f to frame f - 1) has to find.  The default
(`"panned"`) draws each ellipse's inside from the panned, flipped
background texture, where that motion is undefined.
"""

from __future__ import annotations

import numpy as np

# A pixel's drawn displacement counts (`valid`) only where it and its
# source lie at least this many pixels (Chebyshev) from every object
# boundary and from the frame's border, in their frames.
MOTION_MARGIN = 3
# Rows and columns of a rigid texture patch beyond its ellipse's box.
_PATCH_PAD = 2


def _ellipses(rng, shapes: int, sizes: str, h: int, w: int) -> list:
    if sizes == "drawn":
        return [dict(cy=rng.uniform(30, h - 30), cx=rng.uniform(30, w - 30),
                     ry=rng.uniform(12, 50), rx=rng.uniform(15, 80),
                     vy=rng.uniform(-1.5, 1.5), vx=rng.uniform(-3, 3),
                     col=rng.uniform(20, 235, 3),
                     grad=rng.uniform(-40, 40, 3),
                     tex=rng.uniform(0.0, 0.6))
                for _ in range(shapes)]
    if sizes != "fixed":
        raise ValueError(f"sizes {sizes!r}")
    q = (np.arange(shapes) + 0.5) / shapes
    scale = min(h / 272, w / 480)
    out = []
    for k in rng.permutation(shapes):
        ry, rx = scale * (12 + 38 * q[k]), scale * (15 + 65 * q[::-1][k])
        speed = scale * (0.5 + 2.5 * q[(k * 5) % shapes])
        angle = rng.uniform(0, 2 * np.pi)
        out.append(dict(cy=rng.uniform(ry, h - ry), cx=rng.uniform(rx, w - rx),
                        ry=ry, rx=rx, vy=speed * np.sin(angle),
                        vx=speed * np.cos(angle),
                        col=rng.uniform(20, 235, 3),
                        grad=rng.uniform(-40, 40, 3),
                        tex=0.6 * q[(k * 7) % shapes]))
    return out


def _bounce(p0: float, v: float, f: int, lo: float, hi: float) -> float:
    """Position at frame `f` of a point moving at `v` from `p0`, reflected
    at `lo` and `hi`."""
    span = hi - lo
    if span <= 0:
        return lo
    x = (p0 - lo + v * f) % (2 * span)
    return lo + (x if x <= span else 2 * span - x)


def _centre(s: dict, f: int, sizes: str, h: int, w: int) -> tuple:
    """(cy, cx) of ellipse `s` at frame `f`."""
    if sizes == "fixed":
        return (_bounce(s["cy"], s["vy"], f, s["ry"], h - s["ry"]),
                _bounce(s["cx"], s["vx"], f, s["rx"], w - s["rx"]))
    return s["cy"] + s["vy"] * f, s["cx"] + s["vx"] * f


def _patch(rng, s: dict, texture: float) -> np.ndarray:
    """An ellipse's own (rows, cols, 3) texture: smoothed noise scaled to
    a standard deviation of `texture`, as the background's."""
    import scipy.ndimage as ndi
    ph = int(np.ceil(2 * s["ry"])) + 2 * _PATCH_PAD + 2
    pw = int(np.ceil(2 * s["rx"])) + 2 * _PATCH_PAD + 2
    tex = ndi.gaussian_filter(rng.normal(0, 1, (ph, pw, 3)), (2.5, 2.5, 0))
    return (texture * tex / tex.std()).astype(np.float32)


def _bilinear(img: np.ndarray, v: np.ndarray, u: np.ndarray) -> np.ndarray:
    """`img` (rows, cols, 3) sampled at rows `v` and columns `u`."""
    v0 = np.floor(v).astype(np.int64)
    u0 = np.floor(u).astype(np.int64)
    fv = (v - v0)[:, None]
    fu = (u - u0)[:, None]
    return ((img[v0, u0] * (1 - fu) + img[v0, u0 + 1] * fu) * (1 - fv)
            + (img[v0 + 1, u0] * (1 - fu) + img[v0 + 1, u0 + 1] * fu) * fv)


def _interior(objects: np.ndarray) -> np.ndarray:
    """Pixels at least MOTION_MARGIN from every object boundary and from
    the border of their frame."""
    import scipy.ndimage as ndi
    size = (1, 2 * MOTION_MARGIN + 1, 2 * MOTION_MARGIN + 1)
    lo = ndi.minimum_filter(objects, size=size, mode="constant", cval=-1)
    hi = ndi.maximum_filter(objects, size=size, mode="constant", cval=-1)
    return lo == hi


def _motion(objects: np.ndarray, centres: np.ndarray) -> dict:
    """The backward displacement each pixel was drawn with and where it is
    trusted: `flow` (n, h, w, 2) float32, (dx, dy) from frame f to where
    the pixel was in frame f - 1 (+2 px in x on the background, c(f - 1)
    - c(f) inside ellipse k); `valid` (n, h, w) bool: the same object at
    both ends, both ends MOTION_MARGIN inside their objects, the source
    inside the frame.  Frame 0 has no displacement and no valid pixel."""
    n, h, w = objects.shape
    step = np.zeros((n, centres.shape[1] + 1, 2), np.float64)
    step[:, 0, 0] = 2.0
    step[1:, 1:, 0] = centres[:-1, :, 1] - centres[1:, :, 1]
    step[1:, 1:, 1] = centres[:-1, :, 0] - centres[1:, :, 0]
    fr = np.arange(n)[:, None, None]
    flow = step[fr, objects.astype(np.int64)].astype(np.float32)
    flow[0] = 0
    inner = _interior(objects)
    yy, xx = np.mgrid[0:h, 0:w]
    valid = np.zeros((n, h, w), bool)
    for f in range(1, n):
        sx = np.rint(xx + flow[f, ..., 0]).astype(np.int64)
        sy = np.rint(yy + flow[f, ..., 1]).astype(np.int64)
        inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        sx, sy = np.clip(sx, 0, w - 1), np.clip(sy, 0, h - 1)
        valid[f] = (inside & inner[f] & inner[f - 1, sy, sx]
                    & (objects[f - 1, sy, sx] == objects[f]))
    return {"flow": flow, "valid": valid}


def synthetic_clip(n: int, seed: int = 0, h: int = 272, w: int = 480,
                   shapes: int = 12, sizes: str = "drawn",
                   texture: float = 20.0, noise: float = 3.0,
                   truth: bool = False, texture_motion: str = "panned",
                   motion: bool = False):
    """`n` BGR uint8 (h, w) frames drawn from `seed`; with `truth`, also
    the (n, h, w) int16 object of each pixel; with `motion` (rigid
    texture only), also the drawn displacement (`_motion`)."""
    import scipy.ndimage as ndi
    if texture_motion not in ("panned", "rigid"):
        raise ValueError(f"texture_motion {texture_motion!r}")
    rigid = texture_motion == "rigid"
    if motion and not rigid:
        raise ValueError("motion inside panned-texture ellipses is "
                         "undefined: draw them with texture_motion rigid")
    rng = np.random.default_rng(seed)
    H, W = h, w
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pan = 2 * n
    tex = ndi.gaussian_filter(rng.normal(0, 1, (H, W + pan, 3)),
                              (2.5, 2.5, 0))
    tex = (texture * tex / tex.std()).astype(np.float32)
    grad = np.stack([50 + 80 * xx / W, 70 + 60 * yy / H,
                     150 - 60 * xx / W], -1)
    ellipses = _ellipses(rng, shapes, sizes, H, W)
    patches = [_patch(rng, s, texture) for s in ellipses] if rigid else None
    frames = []
    objects = np.zeros((n, H, W), np.int16) if truth or motion else None
    centres = np.zeros((n, len(ellipses), 2))
    for f in range(n):
        bg_tex = tex[:, 2 * f:2 * f + W]
        img = grad + bg_tex
        for k, s in enumerate(ellipses):
            cy, cx = centres[f, k] = _centre(s, f, sizes, H, W)
            d = ((yy - cy) / s["ry"]) ** 2 + ((xx - cx) / s["rx"]) ** 2
            m = d < 1
            if rigid:
                own = _bilinear(patches[k],
                                yy[m] - cy + s["ry"] + _PATCH_PAD,
                                xx[m] - cx + s["rx"] + _PATCH_PAD)
            else:
                own = bg_tex[::-1][m]
            img[m] = s["col"] + s["grad"] * d[m, None] + s["tex"] * own
            if objects is not None:
                objects[f][m] = k + 1
        img += rng.normal(0, noise, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    out = (frames,)
    if truth:
        out += (objects,)
    if motion:
        out += (_motion(objects, centres),)
    return out if len(out) > 1 else frames


def chunk_solves(n_frames: int, chunk_size: int) -> list:
    """Frames in each chunk solve of the dense streaming protocol (2
    overlap frames, one constraint frame) over n_frames, flush included:
    a frozen extension of `chip_smoke.expected_chunk_solves`."""
    buf, start, solves = 0, 0, []
    for _ in range(n_frames):
        buf += 1
        if buf - start >= chunk_size:
            solves.append(buf)
            buf, start = 2, 1
    if buf > 0:
        solves.append(buf)
    return solves
