"""TV-L1 flow at one pyramid scale (K5): the CUDA wrapper.

`tvl1_scale` runs `core/flow.py`'s `_tvl1_scale` (its plain version, the
eager torch body the CPU takes) through `csrc/tvl1.cu`: one C call per
scale queues, on the current stream, one warp launch per warp and one
launch per primal-dual iteration, each doing a whole iteration of B
pairs.  The kernels round every operation as the eager ops do, in the
same order, so the fields equal the eager body's on the card bit for bit.
No TPU kernel corresponds: the JAX package runs TV-L1 as XLA ops.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from video_segment_tpu_torch import _build

G_MIN = 1e-9    # the eager body's `torch.clamp(grad2, min=1e-9)`
TILE_H = 8      # TH in csrc/tvl1.cu: rows of an iteration kernel's tile

_thread = threading.local()


def thread_launches() -> int:
    """Launches `tvl1_scale` has queued from the calling thread.  A caller
    reads it before and after a call to learn what the kernels ran of it,
    whatever other threads launch meanwhile."""
    return getattr(_thread, "launches", 0)


def _lib():
    lib = _build.load("tvl1")
    if not getattr(lib, "_vst_typed", False):
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        cf = ctypes.c_float
        lib.tvl1_scale.argtypes = ([vp] * 8 + [ci] * 5 + [cf] * 5 + [vp])
        lib.tvl1_scale.restype = ctypes.c_int
        lib._vst_typed = True
    return lib


def tvl1_scale(i0: torch.Tensor, i1: torch.Tensor, i1x: torch.Tensor,
               i1y: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
               p) -> tuple[torch.Tensor, torch.Tensor]:
    """`p.warps` warps of `p.iterations` iterations each at one scale of B
    pairs: every argument a contiguous (B,H,W) float32 CUDA tensor (i1x,
    i1y the central differences of i1; u1, u2 the flow entering the
    scale); `p` a `TVL1Params`.  Returns the scale's (u1, u2).  Raises on
    anything else; never falls back to the eager body."""
    planes = (i0, i1, i1x, i1y, u1, u2)
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.ndim != 3 or t.shape != i0.shape:
            raise ValueError(f"expected six (B,H,W) planes of one shape, got "
                             f"{[tuple(x.shape) for x in planes]}")
        if not t.is_contiguous():
            raise ValueError("every plane must be contiguous")
        if t.device.type != "cuda" or t.device != i0.device:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in planes]}")
    b, h, w = i0.shape
    if b > 65535 or -(-h // TILE_H) > 65535:
        raise ValueError(f"grid too large for {tuple(i0.shape)}")
    # A negative count runs nothing, as the eager body's `range` does.
    warps, iterations = max(int(p.warps), 0), max(int(p.iterations), 0)
    state = torch.empty((2, 6, b, h, w), dtype=torch.float32,
                        device=i0.device)
    inv = torch.empty((3, b, h, w), dtype=torch.float32, device=i0.device)
    # The Python doubles the eager body multiplies by; ctypes rounds each
    # to float32 as torch rounds a scalar operand.
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta
    lib = _lib()
    with torch.cuda.device(i0.device):
        stream = torch.cuda.current_stream(i0.device).cuda_stream
        err = lib.tvl1_scale(
            i0.data_ptr(), i1.data_ptr(), i1x.data_ptr(), i1y.data_ptr(),
            u1.data_ptr(), u2.data_ptr(), state.data_ptr(), inv.data_ptr(),
            b, h, w, warps, iterations, l_t, -l_t, taut, p.theta, G_MIN,
            stream)
    if err:
        raise RuntimeError(f"tvl1 kernel launch failed: CUDA error {err}")
    n = warps * (1 + iterations)
    _thread.launches = thread_launches() + n
    _build.count_launch(tvl1_scale, n)
    out = state[warps * iterations % 2]
    return out[0], out[1]


tvl1_scale.launches = 0
