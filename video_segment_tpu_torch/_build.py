"""Lazy nvcc build of the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles at first use into a shared library with a
plain C interface (loaded with ctypes), cached under `_build/` by a hash of
the source and the flags.  Only the sources in this package are compiled.
A missing nvcc or a failed build raises with the compiler output; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# Never --use_fast_math: bucket indices are int(d * 2048) of an f32
# distance, so a contracted FMA or an approximate sqrt/divide moves a bucket
# across an integer boundary.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()  # guards _name_locks
# One lock per kernel, so that builds of different kernels overlap.
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "video_segment_tpu_torch are built from csrc/ at "
                       "first use")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`.  Thread-safe; builds of
    different kernels may run at once (one nvcc each)."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{' '.join(cmd)}"
                                   f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


_count_lock = threading.Lock()


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` launches to `wrapper.launches`.  Wrappers launch from several
    threads (the pipeline's stage threads, concurrent clips), and `+=` on
    an attribute is a read and a write that another thread can come
    between."""
    with _count_lock:
        wrapper.launches += n


RESOURCE_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
                 "threads", "ctas_per_sm")


def resources(name: str) -> dict:
    """What `csrc/<name>.cu`'s `<name>_resources` reports for its kernel
    at the main path's launch configuration: registers and local (spill)
    bytes a thread, static and dynamic shared memory and threads a CTA,
    and CTAs resident on one SM by the occupancy API.  Needs the card."""
    fn = getattr(load(name), f"{name}_resources")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = fn(out)
    if err:
        raise RuntimeError(f"{name}_resources failed: CUDA error {err}")
    return dict(zip(RESOURCE_KEYS, out))
