"""Port region stage and the whole slice against the JAX package.

- `agglomerate` on fixed seeded histograms (with and without per-frame
  flow tables): per-level labels exact given the JAX package's
  distances, and exact with the port's own (seeds 5-9, free and
  constrained: chi-square sums and the size penalty's log2 in XLA's CPU
  order, ROADMAP.md Queue 3, F1).
- `flow_bins`, `edge_flow_distance`, `xla_log2` and `combined_distance`
  against JAX's compiled functions, bit for bit.
- `segment_frames` end to end on the dense tests' clip (unsmoothed, see
  test_torch_dense), with the port's Lab conversion replaced by cv2's in
  those tests only, flow off and flow on.  Given the same flow arrays (and
  flow off) the per-level id images must be exact.  Where each package
  computes its own flow, or a float-order flip of the agglomeration's
  chi-square sums moves a quantized distance (ROADMAP.md, Queue 3), they
  may instead agree at boundary F >= 0.95 at every level; the tests report
  which case held.
- `bgr_to_lab_u8` within 1 of cv2 on every channel.
- `segment_video` (flow off and on) writes a .pb that SegmentationReader
  and the protobuf layer read back.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu import api as japi
from video_segment_tpu.core import agglomeration as jagg
from video_segment_tpu.core.options import (DenseSegmentationOptions,
                                            RegionSegmentationOptions)
from video_segment_tpu.segment_util import metrics
from video_segment_tpu_torch import api as tapi
from video_segment_tpu_torch.core import agglomeration as tagg
from video_segment_tpu_torch.core import region as tregion
from video_segment_tpu_torch.core.options import options_from_jax

from test_torch_dense import clip

torch.set_num_threads(2)

H, W = 24, 256


def _hist_problem(seed, r=200, bins=1000):
    rng = np.random.default_rng(seed)
    rcap = 1 << r.bit_length()
    centers = rng.integers(0, bins, 12)
    hist = np.zeros((rcap, bins), np.float32)
    for i in range(r):
        c = centers[i % 12]
        idx = (c + rng.integers(-20, 20, 30)) % bins
        np.add.at(hist[i], idx, rng.random(30).astype(np.float32))
    sizes = np.zeros(rcap, np.float32)
    sizes[:r] = rng.integers(20, 2000, r)
    side = int(np.ceil(np.sqrt(r)))
    pairs = set()
    for i in range(r):
        for j in (i + 1, i + side):
            if j < r and (j != i + 1 or (i + 1) % side):
                pairs.add((i, j))
    edges = np.asarray(sorted(pairs), np.int32)
    return hist, sizes, edges, r


def _flow_tables(seed, rcap, r, t=6, bins=16):
    """Per-frame flow angle histograms and vector counts: region i lives in
    a run of frames, with a dominant angle bin per region group."""
    rng = np.random.default_rng(seed)
    fh = np.zeros((t, rcap, bins), np.float32)
    fc = np.zeros((t, rcap), np.float32)
    for i in range(r):
        t0 = int(rng.integers(0, t))
        t1 = int(rng.integers(t0 + 1, t + 1))
        main = (i // 7) % bins
        for f in range(t0, t1):
            n = int(rng.integers(5, 60))
            b = (main + rng.integers(-2, 3, n)) % bins
            np.add.at(fh[f, i], b, rng.random(n).astype(np.float32) * 4)
            fc[f, i] = n
    return fh, fc


def _agglomerate_both(seed, constrained, flow=False, **problem):
    hist, sizes, edges, r = _hist_problem(seed, **problem)
    kw = dict(min_region_num=5, max_region_num=150, use_flow=flow)
    if constrained:
        constr = np.full(hist.shape[0], -1, np.int32)
        constr[:40] = np.arange(40) // 8
        kw["constraints"] = [constr, constr]
    if flow:
        fh, fc = _flow_tables(seed, hist.shape[0], r)
    else:
        fh = np.zeros((0, hist.shape[0], 16), np.float32)
        fc = np.zeros((0, hist.shape[0]), np.float32)
    want = jagg.agglomerate(hist, fh, fc, sizes, edges, r, **kw)
    got = tagg.agglomerate(hist, fh, fc, sizes, edges, r, device="cpu", **kw)
    return got, want, r


@pytest.mark.parametrize("case", ["free", "constrained", "flow"])
def test_agglomerate_matches_jax_given_jax_distances(monkeypatch, case):
    """With JAX's chi-square distances substituted (appearance, and in the
    flow case flow and their SquaredOR combination, which XLA contracts
    into FMAs once the flow distance is nonzero: F1's flow case, ROADMAP.md
    Queue 3), every level equals the JAX package's exactly: the merge logic
    (budgets, radix kth select, hooking, phases, constraint forcing, the
    flow tables' re-aggregation) is the same."""
    import jax
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    jdist = jax.jit(jhops.edge_color_distance)
    jfdist = jax.jit(jhops.edge_flow_distance)
    calls = []

    def jax_distance(hist, edges, batch=8192):
        d = jdist(jnp.asarray(hist.numpy()), jnp.asarray(edges.numpy()))
        return torch.from_numpy(np.array(d))

    def jax_flow_distance(fh, fc, edges, batch=8192):
        calls.append(1)
        d = jfdist(jnp.asarray(fh.numpy()), jnp.asarray(fc.numpy()),
                   jnp.asarray(edges.numpy()))
        return torch.from_numpy(np.array(d))

    monkeypatch.setattr(thops, "edge_color_distance", jax_distance)
    monkeypatch.setattr(thops, "edge_flow_distance", jax_flow_distance)
    if case == "flow":
        jcomb = jax.jit(jhops.combined_distance,
                        static_argnames=("penalizer", "use_flow"))

        def jax_combined(*args, penalizer, use_flow):
            d = jcomb(*(jnp.asarray(a.numpy()) for a in args),
                      penalizer=penalizer, use_flow=use_flow)
            return torch.from_numpy(np.array(d))

        monkeypatch.setattr(thops, "combined_distance", jax_combined)
    got, want, _ = _agglomerate_both(5, case == "constrained",
                                     flow=case == "flow")
    assert bool(calls) == (case == "flow")
    assert len(want) > 3
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_agglomerate_float_order_flip():
    """Own distances, on the input that showed F1's flip (ROADMAP.md,
    Queue 3): chi-square sums over 4000 bins now run in XLA's order
    (`ordered_sum`), so the distances and every level equal the JAX
    package's exactly."""
    problem = dict(r=300, bins=4000)
    hist, _, edges, _ = _hist_problem(5, **problem)
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    dj = np.asarray(jhops.edge_color_distance(jnp.asarray(hist),
                                              jnp.asarray(edges)))
    dt = thops.edge_color_distance(torch.from_numpy(hist),
                                   torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(dt, dj)
    got, want, r = _agglomerate_both(5, False, **problem)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["free", "constrained"])
@pytest.mark.parametrize("seed", [5, 6, 7, 8, 9])
def test_agglomerate_own_distances_match_jax(seed, case):
    """Own distances on the CPU (chi-square sums in XLA's order, and the
    size penalty's log2 in XLA's polynomial with its fused multiply-adds:
    F1, ROADMAP.md Queue 3): every level equals the JAX package's."""
    got, want, _ = _agglomerate_both(seed, case == "constrained")
    assert len(want) >= 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bins", [4000, 1025, 33, 32, 16, 7])
def test_native_edge_color_distance_matches_plain_and_jax(bins):
    """The CPU's native chi-square (`native.chi_square_edges`, which
    `edge_color_distance` takes on the CPU) equals the torch ops bit for
    bit on sparse rows, empty rows, rows of tiny and of huge weights, and
    normalized bins at the 1e-12 gate; and the JAX package's, except at
    exactly 32 bins, where XLA orders the sum otherwise than both port
    paths (1 ulp; no configuration has 32 colour bins)."""
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch import native
    from video_segment_tpu_torch.ops import histograms as thops
    assert native.available()
    rng = np.random.default_rng(bins)
    r = 64
    x = rng.random((r, bins)).astype(np.float32)
    x[rng.random((r, bins)) < 0.9] = 0
    x[:4] = 0
    x[4:8] *= np.float32(1e-30)
    x[8:12] *= np.float32(1e6)
    x[12:16] = 0
    x[12:16, 0] = 1
    x[12:16, 1:4] = np.asarray([5e-13, 1e-12, 2e-12], np.float32)
    edges = rng.integers(0, r, (700, 2)).astype(np.int32)
    edges[:64] = np.stack([np.arange(64) % 16, (np.arange(64) + 1) % 16], 1)
    hist, ed = torch.from_numpy(x), torch.from_numpy(edges)
    got = thops.edge_color_distance(hist, ed)
    plain = thops.edge_color_distance_plain(hist, ed)
    want = np.asarray(jhops.edge_color_distance(jnp.asarray(x),
                                                jnp.asarray(edges)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  plain.numpy().view(np.int32))
    if bins != 32:
        np.testing.assert_array_equal(got.numpy(), want)


def test_xla_log2_matches_jax():
    """`xla_log2` equals `jax.jit(jnp.log2)` on the CPU bit for bit over
    the size ratios' range (1e-20 up to thousands), where torch.log2 (the
    correctly rounded one) differs in a large share of the values."""
    import jax
    from video_segment_tpu_torch.ops import histograms as thops
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.exp(rng.uniform(np.log(1e-20), np.log(1e4), 100000)),
        rng.uniform(0.5, 2.0, 20000), rng.integers(1, 4000, 20000) / 500.0,
        [1e-20, 1.0, 2.0, 0.5, np.sqrt(0.5)]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log2)(x))
    got = thops.xla_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = torch.log2(torch.from_numpy(x)).numpy()
    assert (plain != want).mean() > 0.05


@pytest.mark.parametrize("penalizer", [0.25, 0.4])
@pytest.mark.parametrize("use_flow", [False, True])
def test_combined_distance_matches_jax(use_flow, penalizer):
    """The size-penalized SquaredOR combination equals JAX's compiled one
    bit for bit on the CPU, with the penalizer traced as the JAX
    agglomeration passes it (k = penalizer * float32(1 / ln 2))."""
    import jax
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    rng = np.random.default_rng(4)
    n = 20000
    c, f = (rng.random(n).astype(np.float32) for _ in range(2))
    sa, sb = (rng.integers(1, 4000, n).astype(np.float32) for _ in range(2))
    inv = np.float32(1 / 731.0)
    jfn = jax.jit(lambda c, f, a, b, i, p: jhops.combined_distance(
        c, f, a, b, i, penalizer=p, use_flow=use_flow))
    want = np.asarray(jfn(c, f, sa, sb, inv, np.float32(penalizer)))
    got = thops.combined_distance(
        *(torch.from_numpy(np.asarray(a)) for a in (c, f, sa, sb, inv)),
        penalizer=penalizer, use_flow=use_flow).numpy()
    assert (want > 0).mean() > 0.5 and (want < 1).mean() > 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16, 33, 100, 1000, 4000])
def test_ordered_sum_matches_jax(n):
    """`ordered_sum` and `ordered_dot` reproduce the compiled JAX sums bit
    for bit: XLA's CPU tree of 32-wide windows, and its fused
    multiply-adds for short weighted sums."""
    import jax
    from video_segment_tpu_torch.ops import histograms as thops
    rng = np.random.default_rng(n)
    x = (rng.random((64, n)) * (rng.random((64, n)) < 0.5)).astype(
        np.float32)
    w = rng.integers(0, 40, (64, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    np.testing.assert_array_equal(
        thops.ordered_sum(torch.from_numpy(x)).numpy(), want)
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=1))(x, w))
    np.testing.assert_array_equal(
        thops.ordered_dot(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        want)


def _jregion():
    """The JAX package's region module.  Imported where used: it imports
    the JAX package's protobuf layer, which compiles its schema with
    `protoc` at import, so the card tests can run where there is none."""
    from video_segment_tpu.core import region
    return region


def test_accumulate_all_matches_jax():
    jregion = _jregion()
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 30, (2, 8, 16)).astype(np.int32)
    lab_u8 = rng.integers(0, 256, (2, 8, 16, 3)).astype(np.uint8)
    want, _, _ = jregion._accumulate_all(
        jnp.asarray(labels), jnp.asarray(lab_u8), jnp.zeros((1, 1, 1)),
        jnp.zeros((1, 1, 1)), 32, 10, 20, 16, False)
    got, fh, fc = tregion._accumulate_all(torch.from_numpy(labels),
                                          torch.from_numpy(lab_u8), 32, 10,
                                          20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fh.shape == (0, 32, 16) and fc.shape == (0, 32)


def test_accumulate_all_flow_matches_jax_and_native():
    """Per-frame flow histograms (magnitude-weighted angle bins) and vector
    counts: the torch path equals JAX's device path and the native
    weighted-bincount path the region stage takes first."""
    from video_segment_tpu import native
    jregion = _jregion()
    rng = np.random.default_rng(10)
    t, h, w, rcap, fb = 2, 8, 16, 32, 16
    labels = rng.integers(0, 30, (t, h, w)).astype(np.int32)
    lab_u8 = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
    fbin = rng.integers(0, fb, (t, h, w)).astype(np.int8)
    fmag = (rng.random((t, h, w)) * 5).astype(np.float16)
    want = jregion._accumulate_all(
        jnp.asarray(labels), jnp.asarray(lab_u8), jnp.asarray(fbin),
        jnp.asarray(fmag), rcap, 10, 20, fb, True)
    got = tregion._accumulate_all(
        torch.from_numpy(labels), torch.from_numpy(lab_u8), rcap, 10, 20,
        torch.from_numpy(fbin), torch.from_numpy(fmag), fb)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    tkey = ((np.arange(t, dtype=np.int64)[:, None, None] * rcap + labels)
            * fb + fbin)
    nat_h = native.weighted_bincount(tkey, fmag.astype(np.float32),
                                     t * rcap * fb)
    nat_c = native.weighted_bincount(tkey // fb, np.ones(tkey.size,
                                                         np.float32),
                                     t * rcap)
    np.testing.assert_allclose(got[1].numpy().reshape(-1), nat_h,
                               rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy().reshape(-1), nat_c)


def test_flow_descriptor_ops_match_jax():
    """flow_bins exact in its bins; edge_flow_distance exact (16-bin
    chi-square sums and the weighted sum over frames in XLA's order)."""
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    rng = np.random.default_rng(11)
    flow = rng.normal(0, 3, (4, 8, 16, 2)).astype(np.float32)
    flow[0, 0, :4] = [[1, 0], [0, 1], [-1, 0], [0, -1]]
    bj, mj = jhops.flow_bins(jnp.asarray(flow))
    bt, mt = thops.flow_bins(torch.from_numpy(flow))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
    rcap, r = 256, 200
    fh, fc = _flow_tables(12, rcap, r)
    _, _, edges, _ = _hist_problem(12)
    want = np.asarray(jhops.edge_flow_distance(
        jnp.asarray(fh), jnp.asarray(fc), jnp.asarray(edges)))
    got = thops.edge_flow_distance(torch.from_numpy(fh),
                                   torch.from_numpy(fc),
                                   torch.from_numpy(edges), batch=64).numpy()
    assert (want > 0).sum() > len(edges) // 2
    np.testing.assert_array_equal(got, want)
    # The size-penalized SquaredOR combination, compiled as the JAX
    # agglomeration runs it: XLA's log polynomial and fused multiply-adds,
    # reproduced exactly (ROADMAP.md, Queue 3, F1).
    import jax
    n = 4096
    c, f = (torch.from_numpy(rng.random(n).astype(np.float32))
            for _ in range(2))
    sa, sb = (torch.from_numpy(rng.integers(1, 2000, n).astype(np.float32))
              for _ in range(2))
    inv = torch.tensor(1 / 500.0)
    want_c = np.asarray(jax.jit(jhops.combined_distance)(
        *(jnp.asarray(x.numpy()) for x in (c, f, sa, sb, inv))))
    got_c = thops.combined_distance(c, f, sa, sb, inv).numpy()
    np.testing.assert_array_equal(got_c, want_c)


def test_histogram_ops_match_jax():
    """lab_bins and accumulate_histogram exact (integer bins, sums of
    small integer weights); chi_square within float32 rounding."""
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    rng = np.random.default_rng(9)
    lab_u8 = rng.integers(0, 256, (3, 8, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, 12, (3, 8, 16)).astype(np.int32)
    weights = rng.integers(1, 5, (3, 8, 16)).astype(np.float32)
    bins_j = np.asarray(jhops.lab_bins(jnp.asarray(lab_u8)))
    bins_t = thops.lab_bins(torch.from_numpy(lab_u8)).numpy()
    np.testing.assert_array_equal(bins_t, bins_j)
    for w in (None, weights):
        want = jhops.accumulate_histogram(
            jnp.zeros((12, 4000), jnp.float32), jnp.asarray(labels),
            jnp.asarray(bins_j), None if w is None else jnp.asarray(w),
            12, 4000)
        got = thops.accumulate_histogram(
            torch.zeros((12, 4000)), torch.from_numpy(labels),
            torch.from_numpy(bins_t), None if w is None
            else torch.from_numpy(w), 12, 4000)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a, b = got.numpy()[:6], got.numpy()[6:]
    np.testing.assert_allclose(
        thops.chi_square(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jhops.chi_square(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)


def test_bgr_to_lab_u8_within_one_of_cv2():
    import cv2
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (256, 512, 3)).astype(np.uint8)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 3, 2)
    dark = np.stack(np.meshgrid(*[np.arange(64, dtype=np.uint8)] * 3,
                                indexing="ij"), -1).reshape(512, 512, 3)
    for im in (img, gray, dark):
        want = cv2.cvtColor(im, cv2.COLOR_BGR2Lab).astype(np.int32)
        got = tregion.bgr_to_lab_u8(im).astype(np.int32)
        assert np.abs(got - want).max() <= 1


def _options(use_flow=False):
    return (DenseSegmentationOptions(chunk_size=4, presmoothing="none",
                                     frac_min_region_size=0.05,
                                     preseg_mode="felz"),
            RegionSegmentationOptions(chunk_set_size=2, chunk_set_overlap=1,
                                      min_region_num=3, max_region_num=60,
                                      use_flow=use_flow))


def _level_images(frames_out, h, w):
    """{frame_index: [id image per hierarchy level]} from emitted frames:
    each chunk set's hierarchy maps level-0 ids to their ancestors."""
    out = {}
    hier = None
    for sf in frames_out:
        if sf.hierarchy is not None:
            hier = sf.hierarchy
        maps = [dict(zip(lv.ids.tolist(), lv.parent_ids.tolist()))
                for lv in hier if lv.parent_ids is not None]
        cur = sf.region_ids.astype(np.int64)
        ids = [cur]
        for m in maps:
            cur = np.asarray([m[int(i)] for i in cur], np.int64)
            ids.append(cur)
        intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
        out[sf.frame_index] = [
            tregion.rasterize_ids(d, sf.interval_counts, intervals, h, w)
            for d in ids]
    return out


def _compare_levels(got, want, exact_required=False) -> bool:
    """Per-level id images of every frame: equal, or (unless
    `exact_required`) at boundary F >= 0.95 at every level.  Returns
    whether all were equal."""
    assert [sf.frame_index for sf in got] == [sf.frame_index for sf in want]
    assert sum(sf.hierarchy is not None for sf in got) >= 2
    lw, lg = _level_images(want, H, W), _level_images(got, H, W)
    exact = True
    for f in lw:
        assert len(lg[f]) == len(lw[f]), f"frame {f} level count"
        for lv, (a, b) in enumerate(zip(lg[f], lw[f])):
            assert (a >= 0).all()
            if not np.array_equal(a, b):
                assert not exact_required, f"frame {f} level {lv} differs"
                exact = False
                fm = metrics.boundary_f_measure(a, b)["f_measure"]
                assert fm >= 0.95, (f, lv, fm)
    return exact


def _cv2_lab(monkeypatch):
    import cv2
    monkeypatch.setattr(tregion, "bgr_to_lab_u8",
                        lambda im: cv2.cvtColor(im, cv2.COLOR_BGR2Lab))


def test_segment_frames_matches_jax(monkeypatch):
    _cv2_lab(monkeypatch)
    frames = clip()
    d, r = _options()
    td, tr = map(options_from_jax, (d, r))
    want = list(japi.segment_frames(iter(frames), W, H, use_flow=False,
                                    dense_options=d, region_options=r))
    got = list(tapi.segment_frames(iter(frames), W, H, use_flow=False,
                                   dense_options=td, region_options=tr,
                                   device="cpu"))
    exact = _compare_levels(got, want)
    print(f"segment_frames parity: "
          f"{'exact' if exact else 'boundary F >= 0.95 (float-order flip)'}")


class _ServedFlow:
    """Stands in for a FlowEngine: serves precomputed backward flows."""

    device = torch.device("cpu")

    def __init__(self, flows, wrap=None):
        self.flows = flows
        self.wrap = wrap or (lambda f: f)

    def compute(self, frame, idx):
        f = self.flows[idx]
        return None if f is None else self.wrap(f)


def test_segment_frames_flow_matches_jax_given_same_flow(monkeypatch):
    """The default use_flow=True path, stage by stage: both packages get
    the same JAX-computed flow arrays (the port as FlowFields), which feed
    the solver, connectedness and the flow descriptors; the per-level id
    images must be exact."""
    from video_segment_tpu.core import flow as jflow
    from video_segment_tpu_torch.core import flow as tflow
    from test_torch_dense import jax_flows
    _cv2_lab(monkeypatch)
    frames = clip()
    flows = jax_flows(frames)
    monkeypatch.setattr(jflow, "FlowEngine",
                        lambda w, h: _ServedFlow(flows))
    monkeypatch.setattr(tflow, "FlowEngine", lambda w, h, device: _ServedFlow(
        flows, lambda f: tflow.FlowField(dev=torch.tensor(f))))
    d, r = _options(use_flow=True)
    td, tr = map(options_from_jax, (d, r))
    want = list(japi.segment_frames(iter(frames), W, H, dense_options=d,
                                    region_options=r))
    stream = tapi.segment_frames(iter(frames), W, H, dense_options=td,
                                 region_options=tr, device="cpu")
    got = list(stream)
    assert stream.stage_seconds["flow"] >= 0.0
    _compare_levels(got, want, exact_required=True)
    # Flow reached the region stage: flow off gives another hierarchy.
    d, r = _options(use_flow=False)
    off = list(japi.segment_frames(iter(frames), W, H, use_flow=False,
                                   dense_options=d, region_options=r))
    lw, lo = _level_images(want, H, W), _level_images(off, H, W)
    assert any(len(lw[f]) != len(lo[f])
               or any(not np.array_equal(a, b) for a, b in zip(lw[f], lo[f]))
               for f in lw)


def test_segment_frames_flow_own_engines_match_jax(monkeypatch):
    """Through the two public APIs with their defaults (use_flow=True),
    each package computing its own TV-L1 flow (within 1e-3 px of each
    other): exact, or boundary F >= 0.95 where a flow's truncation or a
    float-order flip moves a decision."""
    _cv2_lab(monkeypatch)
    frames = clip()
    d, r = _options(use_flow=True)
    td, tr = map(options_from_jax, (d, r))
    want = list(japi.segment_frames(iter(frames), W, H, dense_options=d,
                                    region_options=r))
    got = list(tapi.segment_frames(iter(frames), W, H, dense_options=td,
                                   region_options=tr, device="cpu"))
    exact = _compare_levels(got, want)
    print(f"segment_frames flow parity: "
          f"{'exact' if exact else 'boundary F >= 0.95'}")


def test_segment_video_writes_pb(tmp_path):
    import cv2
    from video_segment_tpu import proto
    from video_segment_tpu.dataio import seg_io
    vid = str(tmp_path / "in.mp4")
    wr = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for img in clip(8):
        wr.write(img)
    wr.release()
    d, r = _options()
    td, tr = map(options_from_jax, (d, r))
    out = tapi.segment_video(vid, str(tmp_path / "out.pb"), use_flow=False,
                             dense_options=td, region_options=tr, device="cpu")
    reader = seg_io.SegmentationReader(out)
    assert reader.open_and_read_headers()
    assert reader.num_frames == 8
    desc = proto.SegmentationDesc()
    desc.ParseFromString(reader.read_frame())
    assert (desc.frame_width, desc.frame_height) == (W, H)
    assert len(desc.region) >= 2


def test_segment_video_flow_writes_pb(tmp_path):
    """segment_video with its default use_flow=True: the .pb reads back,
    every frame fully covered and a hierarchy above level 0."""
    import cv2
    from video_segment_tpu import proto
    from video_segment_tpu.dataio import seg_io
    vid = str(tmp_path / "in.mp4")
    wr = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for img in clip(8):
        wr.write(img)
    wr.release()
    d, r = _options(use_flow=True)
    td, tr = map(options_from_jax, (d, r))
    out = tapi.segment_video(vid, str(tmp_path / "out.pb"), dense_options=td,
                             region_options=tr, device="cpu")
    reader = seg_io.SegmentationReader(out)
    assert reader.open_and_read_headers()
    assert reader.num_frames == 8
    for _ in range(8):
        desc = proto.SegmentationDesc()
        desc.ParseFromString(reader.read_frame())
        assert (desc.frame_width, desc.frame_height) == (W, H)
        area = sum(iv.right_x - iv.left_x + 1 for reg in desc.region
                   for iv in reg.raster.scan_inter)
        assert area == W * H
    assert len(desc.region) >= 2


# ---------------------------------------------------------------------------
# Windowed appearance (appearance_window_size > 0).


def _window_tables(seed, hist, r, nw=4):
    """Per-window tables that split each region's histogram over a run of
    windows (counts 0 outside it), with a per-window tilt so that the
    windowed distance differs from the whole-histogram one."""
    rng = np.random.default_rng(seed + 100)
    rcap, bins = hist.shape
    whist = np.zeros((nw, rcap, bins), np.float32)
    wcnt = np.zeros((nw, rcap), np.float32)
    for i in range(r):
        w0 = int(rng.integers(0, nw))
        w1 = int(rng.integers(w0 + 1, nw + 1))
        for w in range(w0, w1):
            tilt = rng.random(bins).astype(np.float32) * 0.2 + 0.9
            whist[w, i] = hist[i] * tilt / (w1 - w0)
            wcnt[w, i] = int(rng.integers(5, 300))
    return whist, wcnt


def test_edge_color_distance_windowed_matches_jax():
    """Within 1e-6 of `jax.jit` of the JAX function (bitwise on the CPU:
    the chi-square sums run in XLA's order), with windows absent on either
    side, edges whose two sides share no window (no finite minimum: 0),
    and batches shorter than a whole batch."""
    import jax
    from video_segment_tpu.ops import histograms as jhops
    from video_segment_tpu_torch.ops import histograms as thops
    hist, _, edges, r = _hist_problem(14, r=120, bins=4000)
    whist, wcnt = _window_tables(14, hist, r, nw=5)
    wcnt[:, 0] = 0.0
    wcnt[:, 1] = [0, 0, 0, 0, 7]
    wcnt[:, 2] = [9, 9, 0, 0, 0]
    edges = np.concatenate([edges, [[0, 3], [1, 2], [2, 1]]]).astype(np.int32)
    want = np.asarray(jax.jit(jhops.edge_color_distance_windowed)(
        whist, wcnt, edges))
    got = thops.edge_color_distance_windowed(
        torch.from_numpy(whist), torch.from_numpy(wcnt),
        torch.from_numpy(edges), batch=100).numpy()
    assert got[-3] == 0.0 and got[-2] == 0.0
    assert (want > 0).sum() > len(edges) // 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 6, 7, 8, 9])
def test_agglomerate_windowed_matches_jax(seed):
    """`agglomerate` with window tables (their distance replaces the
    appearance term; they re-aggregate per root): every level equals the
    JAX package's, free for seeds 5-7, constrained for 8-9."""
    hist, sizes, edges, r = _hist_problem(seed, bins=300)
    whist, wcnt = _window_tables(seed, hist, r)
    kw = dict(min_region_num=5, max_region_num=150, use_flow=False,
              win_hist=whist, win_cnt=wcnt)
    if seed >= 8:
        constr = np.full(hist.shape[0], -1, np.int32)
        constr[:40] = np.arange(40) // 8
        kw["constraints"] = [constr, constr]
    fh = np.zeros((0, hist.shape[0], 16), np.float32)
    fc = np.zeros((0, hist.shape[0]), np.float32)
    want = jagg.agglomerate(hist, fh, fc, sizes, edges, r, **kw)
    got = tagg.agglomerate(hist, fh, fc, sizes, edges, r, device="cpu", **kw)
    plain = tagg.agglomerate(hist, fh, fc, sizes, edges, r, device="cpu",
                             **{k: v for k, v in kw.items()
                                if not k.startswith("win")})
    assert len(want) >= 1 and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if seed < 8:    # the windows changed the hierarchy
        assert any(not np.array_equal(a, b) for a, b in zip(got, plain))


def test_agglomerate_windowed_phases_match_jax():
    """Over 2048 regions the level loop runs in shrinking phases: the
    window tables are gathered into each compacted table as JAX does."""
    hist, sizes, edges, r = _hist_problem(15, r=2100, bins=40)
    whist, wcnt = _window_tables(15, hist, r, nw=3)
    kw = dict(min_region_num=20, max_region_num=1500, use_flow=False,
              win_hist=whist, win_cnt=wcnt)
    fh = np.zeros((0, hist.shape[0], 16), np.float32)
    fc = np.zeros((0, hist.shape[0]), np.float32)
    assert len(tagg._phase_specs(hist.shape[0], len(edges), 1024, 256,
                                 16)) > 1
    want = jagg.agglomerate(hist, fh, fc, sizes, edges, r, **kw)
    got = tagg.agglomerate(hist, fh, fc, sizes, edges, r, device="cpu", **kw)
    assert len(want) >= 3 and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_accumulate_windowed_matches_jax_and_native():
    """Per-window gain-calibrated histograms and counts: the torch path
    equals JAX's device path, and within 1e-4 of the native accumulator
    the region stage takes first (its own float order)."""
    from video_segment_tpu_torch import native
    jregion = _jregion()
    rng = np.random.default_rng(0)
    t, h, w, rcap, wcap, lb, cb = 4, 6, 8, 8, 3, 4, 5
    labels = rng.integers(0, rcap - 1, (t, h, w)).astype(np.int32)
    lab_u8 = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
    gains = rng.uniform(0.8, 1.2, (t, 3)).astype(np.float32)
    win_slot = np.array([0, 0, 1, 2], np.int32)
    want = jregion._accumulate_windowed(
        jnp.asarray(labels), jnp.asarray(lab_u8), jnp.asarray(gains),
        jnp.asarray(win_slot), rcap, wcap, lb, cb)
    got = tregion._accumulate_windowed(
        torch.from_numpy(labels), torch.from_numpy(lab_u8),
        torch.from_numpy(gains), torch.from_numpy(win_slot), rcap, wcap, lb,
        cb)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    nat = native.accumulate_lab_hist(labels, lab_u8, rcap, lb, cb,
                                     gains=gains, win_slot=win_slot,
                                     wcap=wcap)
    assert (got[0].numpy() == 255 * 0).sum() > 0 and (lab_u8 > 230).any()
    np.testing.assert_allclose(got[0].numpy(), nat, rtol=0, atol=1e-4)


def _windowed_frames():
    """The JAX package's windowed-appearance clip (tests/
    test_windowed_appearance.py), 12 frames 24x20."""
    frames = []
    for i in range(12):
        img = np.full((20, 24, 3), 60, np.uint8)
        img[:, :12] = (200, 80, 40)
        img[(4 + i // 2) % 12:(12 + i // 2) % 20, 14:20] = (40, 200, 120)
        img[:, :, 0] = np.clip(img[:, :, 0].astype(np.int32) + 6 * i,
                               0, 255).astype(np.uint8)
        frames.append(img)
    return frames


def _windowed_run(pkg, frames, monkeypatch):
    """Dense + windowed region stage of `pkg`, recording every closed
    chunk's window tables."""
    if pkg == "jax":
        from video_segment_tpu.core import dense as mdense
        mregion = _jregion()
        dopt, ropt = DenseSegmentationOptions, RegionSegmentationOptions
        kw = {}
    else:
        from video_segment_tpu_torch.core import dense as mdense
        from video_segment_tpu_torch.core import options as topts
        mregion = tregion
        dopt, ropt = (topts.DenseSegmentationOptions,
                      topts.RegionSegmentationOptions)
        kw = dict(device="cpu")
    chunks = []
    orig = mregion.RegionSegmentation._accumulate_chunk

    def recording(self, chunk):
        orig(self, chunk)
        chunks.append(chunk)

    monkeypatch.setattr(mregion.RegionSegmentation, "_accumulate_chunk",
                        recording)
    ds = mdense.DenseSegmentation(
        dopt(chunk_size=4, presmoothing="gaussian",
             frac_min_region_size=0.1, preseg_mode="felz"), 24, 20, **kw)
    rs = mregion.RegionSegmentation(
        ropt(chunk_set_size=2, chunk_set_overlap=1, min_region_num=2,
             max_region_num=30, use_flow=False, appearance_window_size=4),
        24, 20, **kw)
    out = []
    for i, fr in enumerate(frames):
        rs.add_frame(i, fr)
        out += rs.process_frames(False, ds.process_frame(False, fr))
    out += rs.process_frames(True, ds.process_frame(True))
    return out, chunks


def test_windowed_region_stage_matches_jax(monkeypatch):
    """The JAX package's windowed pipeline case (window 4, frames drifting
    in brightness so the gains move), both packages end to end with cv2's
    Lab in the port (F6): every chunk's window histograms within 1e-4 and
    counts exact, every emitted frame's RLE and hierarchy exact."""
    _cv2_lab(monkeypatch)
    frames = _windowed_frames()
    want, wchunks = _windowed_run("jax", frames, monkeypatch)
    got, tchunks = _windowed_run("port", frames, monkeypatch)
    assert len(tchunks) == len(wchunks) >= 3
    for a, b in zip(tchunks, wchunks):
        np.testing.assert_array_equal(a.win_ids, b.win_ids)
        np.testing.assert_array_equal(a.win_cnt, b.win_cnt)
        np.testing.assert_allclose(a.win_hist, b.win_hist, rtol=0,
                                   atol=1e-4)
        assert a.win_hist.sum() > 0
    from test_torch_dense import assert_frames_equal
    assert_frames_equal(got, want)
    assert [sf.frame_index for sf in got] == list(range(12))
    hier = [(sf.hierarchy, wf.hierarchy) for sf, wf in zip(got, want)
            if sf.hierarchy is not None]
    assert len(hier) >= 2
    for hg, hw in hier:
        assert len(hg) == len(hw)
        for lg, lw in zip(hg, hw):
            for f in ("ids", "sizes", "neighbor_pairs", "parent_ids"):
                np.testing.assert_array_equal(getattr(lg, f), getattr(lw, f),
                                              err_msg=f)


def test_compact_phase_keys_past_int32():
    """R8 (ROADMAP.md Queue 3): compacting a set of more than 262144
    regions into a 262144-slot table, the edge dedup key lo * cap + hi
    passes 2^31 (the JAX package's int32 key wraps).  The port's int64 key
    keeps every edge: the compacted list equals a NumPy dedup."""
    rng = np.random.default_rng(21)
    old_cap, new_cap, n_act = 1 << 19, 1 << 18, 10000
    live = np.sort(rng.choice(old_cap, n_act, replace=False))
    sizes = np.zeros(old_cap, np.float32)
    sizes[live] = 1.0
    e = live[rng.integers(0, n_act, (30000, 2))].astype(np.int32)
    rank = np.full(old_cap, -1, np.int64)
    rank[live] = np.arange(n_act)
    lo = np.minimum(rank[e[:, 0]], rank[e[:, 1]])
    hi = np.maximum(rank[e[:, 0]], rank[e[:, 1]])
    keep = lo != hi
    want = np.unique(lo[keep] * new_cap + hi[keep])
    assert want.max() > 2 ** 31
    z = torch.zeros
    state = tagg.AggloState(
        torch.arange(old_cap, dtype=torch.int32), z((old_cap, 1)),
        z((0, old_cap, 16)), z((0, old_cap)), torch.from_numpy(sizes),
        z((0, old_cap, 1)), z((0, old_cap)))
    slots = torch.arange(old_cap, dtype=torch.int32)
    _, _, _, edges, evalid = tagg._compact_phase(
        state, slots, slots, torch.from_numpy(e),
        torch.ones(len(e), dtype=torch.bool), new_cap, 1 << 15)
    got = edges[evalid].numpy().astype(np.int64)
    assert edges.dtype == torch.int32 and int(evalid.sum()) == len(want)
    np.testing.assert_array_equal(got[:, 0] * new_cap + got[:, 1], want)
