"""The bilateral presmoothing filter (K6): the CUDA wrapper.

`bilateral` runs `ops/filters.py`'s `bilateral_filter_plain` (the eager
torch body, which the CPU takes) through `csrc/bilateral.cu`: one launch
a frame, one thread a pixel.  The kernel rounds every operation as the
eager ops do, in the same order, so the output equals the eager body's on
the card bit for bit.  No TPU kernel corresponds: the JAX package runs
the filter as XLA ops.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from video_segment_tpu_torch import _build

MAX_RADIUS = 16   # MAX_RADIUS in csrc/bilateral.cu: the largest halo it takes
TILE_W, TILE_H = 32, 8   # TW, TH in csrc/bilateral.cu: a CTA's pixels

_thread = threading.local()


def thread_launches() -> int:
    """Launches `bilateral` has queued from the calling thread.  A caller
    reads it before and after a call to learn whether the kernel smoothed
    it, whatever other threads launch meanwhile."""
    return getattr(_thread, "launches", 0)


@functools.lru_cache(maxsize=None)
def taps(radius: int) -> int:
    """Taps of the circular window of `radius` (dy^2 + dx^2 <= radius^2)."""
    return sum(dy * dy + dx * dx <= radius * radius
               for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1))


def _lib():
    lib = _build.load("bilateral")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.bilateral_filter.argtypes = ([vp] * 3 + [ci] * 3
                                         + [ctypes.c_float, vp])
        lib.bilateral_filter.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def bilateral(img: torch.Tensor, ws: torch.Tensor, radius: int,
              color_coeff: float) -> torch.Tensor:
    """Smooth a contiguous (H,W,3) float32 CUDA image: `ws` the (taps,)
    float32 spatial weights of the circular window of `radius` on the same
    device, in `_circular_offsets` order; `color_coeff` the colour
    weight's exponent factor (-0.5 / sigma_color^2).  Returns a new
    (H,W,3) float32 image.  Raises on anything else; never falls back to
    the eager body."""
    if img.dtype != torch.float32:
        raise TypeError(f"expected a float32 image, got {img.dtype}")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H,W,3) image, got "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("the image must be contiguous")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside the kernel's 1.."
                         f"{MAX_RADIUS}")
    if (ws.dtype != torch.float32 or tuple(ws.shape) != (taps(radius),)
            or not ws.is_contiguous()):
        raise ValueError(f"expected {taps(radius)} contiguous float32 "
                         f"weights, got {ws.dtype} {tuple(ws.shape)}")
    if img.device.type != "cuda" or ws.device != img.device:
        raise ValueError(f"expected the image and weights on one CUDA "
                         f"device, got {img.device} and {ws.device}")
    h, w, _ = img.shape
    if -(-h // TILE_H) > 65535:
        raise ValueError(f"grid too large for {tuple(img.shape)}")
    out = torch.empty_like(img)
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.bilateral_filter(img.data_ptr(), out.data_ptr(),
                                   ws.data_ptr(), h, w, radius, color_coeff,
                                   stream)
    if err:
        raise RuntimeError(f"bilateral kernel launch failed: CUDA error "
                           f"{err}")
    _thread.launches = thread_launches() + 1
    _build.count_launch(bilateral)
    return out


bilateral.launches = 0
