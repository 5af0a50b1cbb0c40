"""PyTorch / CUDA port of the hierarchical video segmentation pipeline.

A second package beside ``video_segment_tpu`` (the JAX/Pallas reference):
the same streaming dense over-segmentation, edge-table region solver and
hierarchical agglomeration, written as plain functions on torch tensors,
with every Pallas kernel of the JAX package rewritten as a hand CUDA
kernel for Hopper (``csrc/``):

- ``ops.tile_felz.tile_felzenszwalb``: tile-local Felzenszwalb pre-solve;
- ``ops.tile_extract.tile_reduce_min``: per-tile edge-key minima;
- ``ops.tile_table.tile_table_rounds``: supertile table merge rounds;
- ``ops.tile_preseg.tile_presegment``: tile flood pre-segmentation;

and two kernels for what the JAX package runs as XLA ops:

- ``ops.tvl1.tvl1_scale``: one pyramid scale of TV-L1 optical flow (its
  warps and primal-dual iterations);
- ``ops.bilateral.bilateral``: the bilateral presmoothing filter of one
  frame.

``parallel`` holds the device mesh (clips on "data", solver row bands on
"space") and the multi-device dry run.

Every public entry takes an explicit ``device`` (default ``"cuda"``); a
machine without CUDA fails instead of falling back to the CPU.  On CPU
tensors the kernel wrappers run their plain PyTorch versions.

The package imports nothing of ``video_segment_tpu``: its host modules
(options, RLE, connectedness, the native g++ helpers, the ``.pb`` writer
and its schema, boundary vectorization) are copies of the JAX package's.
"""

__version__ = "0.1.0"
