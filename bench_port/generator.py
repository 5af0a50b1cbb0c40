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
"""

from __future__ import annotations

import numpy as np


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


def synthetic_clip(n: int, seed: int = 0, h: int = 272, w: int = 480,
                   shapes: int = 12, sizes: str = "drawn",
                   texture: float = 20.0, noise: float = 3.0,
                   truth: bool = False):
    """`n` BGR uint8 (h, w) frames drawn from `seed`; with `truth`, also
    the (n, h, w) int16 object of each pixel."""
    import scipy.ndimage as ndi
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
    frames = []
    objects = np.zeros((n, H, W), np.int16) if truth else None
    for f in range(n):
        bg_tex = tex[:, 2 * f:2 * f + W]
        img = grad + bg_tex
        for k, s in enumerate(ellipses):
            if sizes == "fixed":
                cy = _bounce(s["cy"], s["vy"], f, s["ry"], H - s["ry"])
                cx = _bounce(s["cx"], s["vx"], f, s["rx"], W - s["rx"])
            else:
                cy, cx = s["cy"] + s["vy"] * f, s["cx"] + s["vx"] * f
            d = ((yy - cy) / s["ry"]) ** 2 + ((xx - cx) / s["rx"]) ** 2
            m = d < 1
            img[m] = (s["col"] + s["grad"] * d[m, None]
                      + s["tex"] * bg_tex[::-1][m])
            if truth:
                objects[f][m] = k + 1
        img += rng.normal(0, noise, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return (frames, objects) if truth else frames


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
