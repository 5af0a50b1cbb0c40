"""Data-parallel union/find primitives (pointer jumping, hooking).

Port of video_segment_tpu/ops/cc.py: regions hook onto merge partners and
pointer jumping (path doubling) resolves all chains to roots.  The JAX
`while_loop` becomes a Python loop whose exit test syncs with the device
once per doubling step.
"""

from __future__ import annotations

import torch


def pointer_jump(parent: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Resolve (N,) int parent pointers (roots: parent[i] == i) to roots."""
    p = parent
    for _ in range(max_iters):
        p2 = p.index_select(0, p)
        if torch.equal(p2, p):
            break
        p = p2
    return p


def break_two_cycles(parent: torch.Tensor) -> torch.Tensor:
    """Resolve mutual hooks a<->b by making the smaller index the root."""
    idx = torch.arange(parent.shape[0], dtype=parent.dtype,
                       device=parent.device)
    mutual = parent.index_select(0, parent) == idx
    return torch.where(mutual & (parent > idx), idx, parent)


def hook_and_resolve(parent: torch.Tensor) -> torch.Tensor:
    """break_two_cycles + pointer_jump in one call."""
    return pointer_jump(break_two_cycles(parent))
