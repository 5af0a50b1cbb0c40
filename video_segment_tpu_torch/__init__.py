"""PyTorch / CUDA port of the hierarchical video segmentation pipeline.

A second package beside ``video_segment_tpu`` (the JAX/Pallas reference):
the same streaming dense over-segmentation, edge-table region solver and
hierarchical agglomeration, written as plain functions on torch tensors,
with the two Pallas kernels of the flow-off path rewritten as hand CUDA
kernels for Hopper (``csrc/``):

- ``ops.tile_felz.tile_felzenszwalb``: tile-local Felzenszwalb pre-solve;
- ``ops.tile_extract.tile_reduce_min``: per-tile edge-key minima.

Every public entry takes an explicit ``device`` (default ``"cuda"``); a
machine without CUDA fails instead of falling back to the CPU.  On CPU
tensors the kernel wrappers run their plain PyTorch versions.

JAX-free host modules (option dataclasses, RLE, connectedness, the native
g++ helpers) are shared with ``video_segment_tpu``.  The package never
imports ``jax``: the shared package's optional JAX cache setup is switched
off before it is first imported.
"""

import os as _os

# video_segment_tpu/__init__.py imports jax (when installed) only to set up
# its persistent compilation cache; VST_JAX_CACHE=0 skips that import.
_os.environ.setdefault("VST_JAX_CACHE", "0")

__version__ = "0.1.0"
