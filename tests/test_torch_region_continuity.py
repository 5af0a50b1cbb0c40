"""The port's cross-set continuity against the JAX package's.

Counterparts of `tests/test_region_continuity.py` on the same frames and
options (hierarchy ids persist over a static scene; overlap regions
grouped at level l stay grouped at level l in the next set), and the
default set geometry (6 chunks a set, 2 kept as overlap) over enough
4-frame chunks for two seams, with flow off and on.  Each test asserts
the JAX test's property on the port and holds the port's emitted frames,
hierarchies, per-set level assignments and overlap assignments
(`_prev_assign`) to the JAX package's, exactly: `preseg_mode="felz"` is
pinned (F4) and the port's Lab conversion is replaced by cv2's, as in
`tests/test_torch_region.py`.  The seam property over every region of
the next set is `chip_smoke.seam_check`, the check that `chip_smoke.py`
phases 29 and 31 run on the card; `test_seams_card_vs_cpu_on_card` holds
the card to the CPU across seams on a 136x240 stream.
"""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bench_port import generator
from video_segment_tpu.core import dense as jdense
from video_segment_tpu.core import region as jregion
from video_segment_tpu.core.options import (DenseSegmentationOptions,
                                            RegionSegmentationOptions)
from video_segment_tpu_torch import api
from video_segment_tpu_torch.core import dense as tdense
from video_segment_tpu_torch.core import region as tregion
from video_segment_tpu_torch.core.options import options_from_jax

from test_region_continuity import _moving_video, _static_video
from test_torch_dense import assert_frames_equal, jax_flows
from test_torch_region import _cv2_lab
from test_torch_streaming_long import _assert_hierarchies_equal

torch.set_num_threads(2)


def _run(pkg, d, r, frames, flows=None):
    """Feed `frames` (and backward `flows`, None for the first frame)
    through the dense and region stages of `pkg` ("jax" or "port"):
    (emitted frames, per-set `_prev_assign` after each set as the JAX
    test captures it, `chip_smoke.set_records` of the sets)."""
    h, w = frames[0].shape[:2]
    if pkg == "jax":
        ds = jdense.DenseSegmentation(d, w, h)
        rs = jregion.RegionSegmentation(r, w, h)
    else:
        ds = tdense.DenseSegmentation(options_from_jax(d), w, h,
                                      device="cpu")
        rs = tregion.RegionSegmentation(options_from_jax(r), w, h,
                                        device="cpu")
    seen, out = [], []
    with chip_smoke.set_records(type(rs)) as sets:
        orig = rs._process_set

        def capture(chunks, emit_all):
            res = orig(chunks, emit_all)
            seen.append([(pg.copy(), pid.copy())
                         for pg, pid in rs._prev_assign])
            return res

        rs._process_set = capture
        for i, fr in enumerate(frames):
            fl = None if flows is None else flows[i]
            rs.add_frame(i, fr, fl)
            out += rs.process_frames(False, ds.process_frame(False, fr, fl))
        out += rs.process_frames(True, ds.process_frame(True))
    return out, seen, sets


def _both(d, r, frames, monkeypatch, flows=None):
    """Both packages on the same input, held equal exactly: emitted
    frames, hierarchies, `_prev_assign` after every set, and every set's
    gids and per-level ids.  Returns the port's run."""
    _cv2_lab(monkeypatch)
    want, wseen, wsets = _run("jax", d, r, frames, flows)
    got, seen, sets = _run("port", d, r, frames, flows)
    assert [sf.frame_index for sf in got] == list(range(len(frames)))
    assert_frames_equal(got, want)
    _assert_hierarchies_equal(got, want)
    assert len(seen) == len(wseen) == len(sets) == len(wsets)
    for a, b in zip(seen, wseen):
        assert len(a) == len(b)
        for (pg, pid), (wg, wid) in zip(a, b):
            np.testing.assert_array_equal(pg, wg)
            np.testing.assert_array_equal(pid, wid)
    for a, b in zip(sets, wsets):
        assert (a["chunks"], a["flush"], a["constrained"], a["rows"]) == \
            (b["chunks"], b["flush"], b["constrained"], b["rows"])
        np.testing.assert_array_equal(a["gids"], b["gids"])
        assert len(a["ids"]) == len(b["ids"])
        for x, y in zip(a["ids"], b["ids"]):
            np.testing.assert_array_equal(x, y)
    return got, seen, sets


def _felz(d: DenseSegmentationOptions) -> DenseSegmentationOptions:
    return dataclasses.replace(d, preseg_mode="felz")


def _assert_composition_stable(seen, hier_frames):
    """The JAX test's seam assertion, on the captured `_prev_assign`s."""
    for k in range(len(seen) - 1):
        prev, nxt = seen[k], seen[k + 1]
        hier_next = hier_frames[k + 1].hierarchy
        for lv in range(min(len(prev), len(hier_next))):
            pg, pid = prev[lv]
            if not len(pg) or lv >= len(nxt):
                continue
            groups = collections.defaultdict(list)
            for g, i_ in zip(pg.tolist(), pid.tolist()):
                groups[i_].append(g)
            ng, nid = nxt[lv]
            lookup = dict(zip(ng.tolist(), nid.tolist()))
            for members in groups.values():
                next_ids = {lookup[g] for g in members if g in lookup}
                assert len(next_ids) <= 1, (lv, next_ids)


def test_hierarchy_ids_persist_across_sets_matches_jax(monkeypatch):
    frames = _static_video(30)
    d = _felz(DenseSegmentationOptions(chunk_size=5, presmoothing="gaussian",
                                       frac_min_region_size=0.08))
    r = RegionSegmentationOptions(chunk_set_size=3, chunk_set_overlap=1,
                                  min_region_num=2, max_region_num=40,
                                  use_flow=False)
    out, _, sets = _both(d, r, frames, monkeypatch)
    hier_frames = [sf for sf in out if sf.hierarchy]
    assert len(hier_frames) >= 2
    for a, b in zip(hier_frames, hier_frames[1:]):
        ids_a = set(a.hierarchy[0].ids.tolist())
        ids_b = set(b.hierarchy[0].ids.tolist())
        assert len(ids_a & ids_b) / max(len(ids_a), 1) > 0.9, (ids_a, ids_b)
    mid = [sf for sf in out if sf.frame_index in (5, 20)]
    assert set(mid[0].region_ids.tolist()) == set(mid[1].region_ids.tolist())
    assert all(s["share0"] > 0.9 for s in chip_smoke.seam_check(sets))


def test_moving_scene_composition_stable_across_seams_matches_jax(
        monkeypatch):
    frames = _moving_video(30)
    d = _felz(DenseSegmentationOptions(chunk_size=5, presmoothing="gaussian",
                                       frac_min_region_size=0.08))
    r = RegionSegmentationOptions(chunk_set_size=3, chunk_set_overlap=1,
                                  min_region_num=2, max_region_num=60,
                                  use_flow=False)
    out, seen, sets = _both(d, r, frames, monkeypatch)
    hier_frames = [sf for sf in out if sf.hierarchy]
    assert len(hier_frames) >= 3
    _assert_composition_stable(seen, hier_frames)
    seams = chip_smoke.seam_check(sets)
    assert len(seams) == len(hier_frames) - 1
    assert sum(sum(s["groups"]) for s in seams) > 0


def _default_geometry_video(n, h=24, w=48):
    """`_moving_video`'s scene with the square sliding 1 px every other
    frame, so that it stays in view for `n` up to 60."""
    rng = np.random.default_rng(7)
    noise = (rng.random((h, w, 3)) * 20).astype(np.uint8)
    frames = []
    for i in range(n):
        img = np.full((h, w, 3), 60, np.uint8) + noise
        img[:, : w // 3] = (190, 90, 50)
        x = 8 + i // 2
        img[6:18, x:x + 10] = (40, 200, 120)
        frames.append(img)
    return frames


@pytest.mark.parametrize("use_flow", [False, True], ids=["flow_off",
                                                         "flow_on"])
def test_default_set_geometry_matches_jax(monkeypatch, use_flow):
    """The defaults' chunk sets (6 chunks, 2 kept as overlap) over 48
    frames in 4-frame chunks: 16 chunk solves, so a full set, two
    constrained full sets and the flush set (3 seams).  With flow on both
    packages get the same JAX-computed flow arrays."""
    frames = _default_geometry_video(48)
    d = DenseSegmentationOptions(chunk_size=4, presmoothing="gaussian",
                                 frac_min_region_size=0.03,
                                 preseg_mode="felz")
    r = RegionSegmentationOptions(min_region_num=2, max_region_num=60,
                                  use_flow=use_flow)
    assert (r.chunk_set_size, r.chunk_set_overlap) == (6, 2)
    flows = jax_flows(frames) if use_flow else None
    out, seen, sets = _both(d, r, frames, monkeypatch, flows)
    hier_frames = [sf for sf in out if sf.hierarchy]
    assert [s["chunks"] for s in sets] == [6, 6, 6, 4]
    assert [s["flush"] for s in sets] == [False, False, False, True]
    assert [s["constrained"] for s in sets] == [False, True, True, True]
    _assert_composition_stable(seen, hier_frames)
    seams = chip_smoke.seam_check(sets)
    assert len(seams) == 3
    assert all(s["levels"] >= 1 and s["share0"] > 0 for s in seams)


def seam_card_vs_cpu(frames) -> dict:
    """`segment_frames` (flow off, 4-frame chunks) over `frames` on the
    card and on the CPU, each under `chip_smoke.set_records`: the seam
    property on both devices (`chip_smoke.seam_check`) and level-0
    boundary F of the emitted frames, card against CPU (float order
    differs on the card, F1 and F3: the hierarchies are not compared for
    equality).  Raises where a check fails."""
    h, w = frames[0].shape[:2]
    options = api.DenseSegmentationOptions(chunk_size=4)
    res = {}
    for name in ("cuda", "cpu"):
        with chip_smoke.set_records() as sets:
            stream = api.segment_frames(iter(frames), w, h, use_flow=False,
                                        dense_options=options, device=name)
            out = list(stream)
        if [sf.frame_index for sf in out] != list(range(len(frames))):
            raise AssertionError(f"{name}: frames missing or out of order")
        res[name] = dict(img=chip_smoke.rasterize(out), sets=sets,
                         seams=chip_smoke.seam_check(sets),
                         solves=len(stream.solve_diag))
    if res["cuda"]["solves"] != res["cpu"]["solves"] or \
            len(res["cuda"]["sets"]) != len(res["cpu"]["sets"]):
        raise AssertionError("card and CPU ran different chunk sets")
    if len(res["cuda"]["seams"]) < 2:
        raise AssertionError(f"{len(res['cuda']['seams'])} seams, want 2 or "
                             f"more")
    res["f"] = chip_smoke.boundary_f(res["cuda"]["img"], res["cpu"]["img"])
    if res["f"] < 0.9:
        raise AssertionError(f"seams card vs CPU: level-0 boundary F "
                             f"{res['f']:.4f} < 0.9")
    return res


@pytest.mark.cuda
def test_seams_card_vs_cpu_on_card():
    """Across seams on both devices: the 40-frame 136x240 synthetic clip
    in 4-frame chunks (14 chunk solves, 3 seams) through `segment_frames`
    (flow off) on the card and on the CPU; the seam property holds on both
    devices and the emitted frames agree at level-0 boundary F >= 0.9
    (`seam_card_vs_cpu` raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        res = seam_card_vs_cpu(
            generator.synthetic_clip(40, seed=3, h=136, w=240))
    finally:
        torch.set_num_threads(threads)
    assert res["f"] >= 0.9
    assert res["cuda"]["solves"] == res["cpu"]["solves"] == 14
    for name in ("cuda", "cpu"):
        assert len(res[name]["seams"]) >= 2
