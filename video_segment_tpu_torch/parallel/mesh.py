"""Device mesh of the segmentation compute path (PyTorch port).

Port of video_segment_tpu/parallel/mesh.py (see its module docstring for
the strategy): a "data" axis over clips and a "space" axis over frame
rows.  The pixel front-end (presmoothing) shards rows with a halo copied
from the neighbouring shards; the solver shards through its row-band
decomposition (`OversegParams.bands`): band b's pixel phase (seed
compaction and edge extraction, K2) runs on the mesh's space-b device and
the O(regions) table phases run on the band outputs gathered on the first
device.  The band decomposition, not the mesh, defines the math, so every
mesh result equals the single-device banded solve bit for bit.

A `Mesh` is a (data, space) grid of `torch.device`s in which a device may
appear more than once: a grid of `cpu` entries, or of one card's
`cuda:0`, holds the mesh code to the single-device code on one device, as
the JAX package's virtual host devices do.  There is no single-process
sharded tensor: each function takes whole tensors, moves each shard to its
device with `.to()` and gathers the results on the first device.  Work is
issued from one Python thread, shard after shard; on distinct cards their
launches overlap only as far as the solver's host syncs allow.
"""

from __future__ import annotations

import numpy as np
import torch

from video_segment_tpu_torch import device as devmod
from video_segment_tpu_torch.core import oversegmentation as ov
from video_segment_tpu_torch.ops import filters
from video_segment_tpu_torch.ops import pixel_distance as pd


class Mesh:
    """(data, space) grid of torch devices, `devices` a numpy object array
    of that shape; a device may repeat."""

    axis_names = ("data", "space")

    def __init__(self, devices):
        shape = np.shape(devices)
        if len(shape) != 2 or 0 in shape:
            raise ValueError(f"a mesh needs a non-empty (data, space) grid "
                             f"of devices, got shape {shape}")
        self.devices = np.empty(shape, dtype=object)
        for i, j in np.ndindex(shape):
            # Raises for a cuda entry without CUDA: no fallback.
            self.devices[i, j] = devmod.resolve(devices[i][j])

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that gathers results and runs the table phases."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, data: int | None = None,
              space: int | None = None, *,
              device: str | torch.device = "cuda",
              repeat: bool = False) -> Mesh:
    """A mesh of `n_devices` entries, by default `space = min(4, n)`
    lowered until it divides n (8 devices: data 2, space 4).

    `device="cuda"` takes the first n cards (all of them for None) and
    raises past `torch.cuda.device_count()`, unless `repeat` asks for the
    cards in turn (on one card every entry is `cuda:0`); `device="cpu"`
    builds n `cpu` entries (one for None)."""
    dev = devmod.resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count and not repeat:
            raise ValueError(f"{n} devices asked for, {count} cards present "
                             "(repeat=True takes the cards in turn)")
        devs = [torch.device("cuda", i % count) for i in range(n)]
    else:
        n = n_devices or 1
        devs = [dev] * n
    if data is None or space is None:
        # Favour spatial sharding within a clip, data across clips.
        space = min(4, n)
        while n % space:
            space -= 1
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} does not hold {n} devices")
    return Mesh([devs[i * space:(i + 1) * space] for i in range(data)])


def halo_exchange_rows(shards: list, halo: int = 1,
                       border: str = "edge") -> list:
    """Pad each row shard (..., Hs, W, C) of one mesh row, given in
    "space" order, with `halo` rows from its neighbours (copied to the
    shard's device).  At the outer edge the fill matches the downstream
    filter's border mode: "edge" (BORDER_REPLICATE) or "reflect"
    (reflect-101), so shard outputs equal single-device outputs."""
    out = []
    for i, x in enumerate(shards):
        if i > 0:
            top = shards[i - 1][..., -halo:, :, :].to(x.device)
        elif border == "reflect":
            top = torch.flip(x[..., 1:halo + 1, :, :], dims=(-3,))
        else:   # edge: the border row repeated, as BORDER_REPLICATE does
            top = x[..., :1, :, :].repeat_interleave(halo, dim=-3)
        if i < len(shards) - 1:
            bot = shards[i + 1][..., :halo, :, :].to(x.device)
        elif border == "reflect":
            bot = torch.flip(x[..., -halo - 1:-1, :, :], dims=(-3,))
        else:
            bot = x[..., -1:, :, :].repeat_interleave(halo, dim=-3)
        out.append(torch.cat([top, x, bot], dim=-3))
    return out


def _split(x: torch.Tensor, parts: int, dim: int, what: str) -> list:
    if x.shape[dim] % parts:
        raise ValueError(f"{what} {x.shape[dim]} does not split into "
                         f"{parts} equal shards")
    return list(torch.split(x, x.shape[dim] // parts, dim=dim))


def sharded_presmooth(mesh: Mesh, mode: str = "bilateral", halo: int = 4):
    """Presmoothing over (B,T,H,W,3): B split over "data", H over "space".

    Returns fn(vol) -> (B,T,H,W,3) float32 on the mesh's first device.
    Each shard runs `ops/filters.presmooth` image by image on its own
    device with true neighbour rows in the halo; the filter's own border
    padding only touches rows that are cropped away, so the result equals
    the single-device filter bit for bit."""
    border = "reflect" if mode == "gaussian" else "edge"
    data, space = mesh.devices.shape

    def fn(vol: torch.Tensor) -> torch.Tensor:
        rows = []
        for i, clips in enumerate(_split(vol, data, 0, "clip axis")):
            shards = [s.to(mesh.devices[i, j]) for j, s in
                      enumerate(_split(clips, space, 2, "height"))]
            if halo:
                shards = halo_exchange_rows(shards, halo, border)
            outs = []
            for s in shards:
                sm = torch.stack([torch.stack([filters.presmooth(img, mode)
                                               for img in clip])
                                  for clip in s])
                outs.append((sm[:, :, halo:-halo] if halo else sm)
                            .to(mesh.first))
            rows.append(torch.cat(outs, dim=2))
        return torch.cat(rows, dim=0)

    return fn


def _neutral_inputs(n: int, device):
    """(init, constr, frozen, fin) of an unconstrained solve: one seed a
    voxel, no constraints, nothing frozen, every level open."""
    return (torch.arange(n, dtype=torch.int32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            torch.full((n,), ov.NUM_BUCKETS, dtype=torch.int32,
                       device=device))


def _free_solve_one(params, has_flow):
    """Per-clip unconstrained solve of `fused_oversegment`: (T,H,W,3)
    [+(T-1,H,W,2) flow] -> (T,H,W) int32 labels through the edge-table
    solver, on vol's device."""
    thetas, level_rounds = ov._solve_schedule(params)

    def solve_one(vol, flow):
        t, h, w, _ = vol.shape
        n = t * h * w
        return ov._solve_edge_table(
            vol, *_neutral_inputs(n, vol.device), params, n, thetas,
            level_rounds, False,
            flow=flow.to(torch.float32) if has_flow else None) \
            .label.reshape(t, h, w)

    return solve_one


def fused_oversegment(params=None, has_flow: bool = False,
                      max_solve_voxels: int = 8_000_000):
    """Multi-clip over-segmentation on one device.

    Returns fn(vols, flows=None) for vols (clips,T,H,W,3) [flows
    (clips,T-1,H,W,2)] -> (clips,T,H,W) int32 labels, each clip's equal to
    its single-clip edge-table solve.  The JAX function runs one vmapped
    program over the clip axis; here the clips are solved one after the
    other (the solver is eager ops and kernel launches on one stream, as
    in `core/batch.py`).  A batch over `max_solve_voxels` is refused up
    front, as the JAX function refuses it."""
    p = (params or ov.OversegParams())._replace(edge_table=True)
    solve_one = _free_solve_one(p, has_flow)

    def fn(vols, flows=None):
        b, t, h, w = vols.shape[:4]
        if b * t * h * w > max_solve_voxels:
            raise ValueError(
                f"batched solve footprint {b}x{t}x{h}x{w} = "
                f"{b * t * h * w} voxels exceeds max_solve_voxels "
                f"({max_solve_voxels}); shrink the batch or route clips "
                f"through the banded/streaming path")
        return torch.stack([solve_one(vols[i], None if flows is None
                                      else flows[i]) for i in range(b)])

    return fn


def sharded_chunk_solver(mesh: Mesh, params, has_flow: bool,
                         has_constraints: bool, head_planes: int,
                         use_cells: bool, row: int = 0):
    """The constrained streaming chunk solve of one clip with the solver's
    row bands over the mesh's "space" axis (mesh row `row`).

    This is the mesh form of the dense stage's chunk solve:
    `ov._band_phase` runs band b's pixel phase on its device (K2 launches
    there) and gathers the outputs on vol's device, where
    `_solve_banded(band_outputs=...)` finishes the solve.  `params.bands`
    must be a multiple of the space size (`DenseSegmentation(mesh=...)`
    sets it equal).

    Returns fn(vol, flow, init, constr, frozen, fin, cells4) ->
    OversegResult; the inputs are volumes (T,H,W[,C]) on one device, as
    `core/dense._materialize_solve_inputs` makes them (flow and cells4 are
    read only with has_flow and use_cells), and the result equals the
    single-device banded solve bit for bit."""
    thetas, level_rounds = ov._solve_schedule(params)
    devices = list(mesh.devices[row])

    def solve(vol, flow, init, constr, frozen, fin, cells):
        if params.gradient_trait:
            vol = torch.cat([vol, pd.gradient_features(vol)], dim=-1)
        t, h, w, _ = vol.shape
        n = t * h * w
        args = (vol, flow.to(torch.float32) if has_flow else None,
                init.reshape(n), constr.reshape(n), frozen.reshape(n),
                fin.reshape(n), params)
        cells_f = (tuple(c.reshape(n) for c in cells) if use_cells
                   else None)
        outs = ov._band_phase(*args, has_constraints, cells_f, head_planes,
                              devices=devices)
        return ov._solve_banded(*args, thetas, level_rounds,
                                has_constraints, cells_f, head_planes,
                                band_outputs=outs)

    return solve


def sharded_oversegment(mesh: Mesh, params=None, has_flow: bool = False):
    """Over-segmentation with clips on "data" and the solver's row bands
    on "space".

    Returns fn(vols, flows=None) for vols (clips,T,H,W,3) [flows
    (clips,T-1,H,W,2)] -> (clips,T,H,W) int32 labels on the mesh's first
    device.  Clip i runs through `sharded_chunk_solver` on mesh row i, one
    band a device, its table phases on that row's first device.  clips
    must equal the "data" size; H must split into `space` bands of
    8-aligned height.  Labels equal the single-device banded solve (the
    band decomposition, not the mesh, defines the math)."""
    data, space = mesh.devices.shape
    p = (params or ov.OversegParams())._replace(bands=space, edge_table=True)
    solvers = [sharded_chunk_solver(mesh, p, has_flow, False, 0, False,
                                    row=i) for i in range(data)]

    def fn(vols, flows=None):
        if vols.shape[0] != data:
            raise ValueError(f"{vols.shape[0]} clips for a data axis of "
                             f"{data}")
        labels = []
        for i, solve in enumerate(solvers):
            home = mesh.devices[i, 0]
            t, h, w, _ = vols[i].shape
            res = solve(vols[i].to(home),
                        flows[i].to(home) if has_flow else None,
                        *_neutral_inputs(t * h * w, home), None)
            labels.append(res.label.reshape(t, h, w).to(mesh.first))
        return torch.stack(labels)

    return fn
