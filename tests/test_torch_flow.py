"""Port TV-L1 flow and FlowEngine against the JAX package's core/flow.

- `TVL1Params` fields and defaults equal JAX's; `tvl1_params_from_jax`
  round-trips.
- `tvl1_flow` / `tvl1_flow_batch` on seeded textured pairs shifted by
  (2.3, -1.7) px: within 1e-3 px of JAX (same algorithm; XLA contracts
  FMAs and `hypot` differs by ulps, so the fields are not bit-equal).
- `.flow` files: the bytes the JAX writer and the port's writer produce
  are identical, and each package's reader reads the other's file.
- `FlowEngine`: push/flush micro-batching equals per-frame `compute` for
  BACKWARD, FORWARD and BOTH; cache reuse; one f16 download per batch.
- The CUDA kernels (`ops/tvl1.py`): a CPU tensor takes the eager body and
  never loads the library; the engine counts `flow.kernel_pairs`.  On a
  card the kernel path equals the eager body (`tvl1_flow_plain` on the
  same CUDA tensors) bit for bit, and the wrapper raises on what it does
  not take.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.core import flow as jflow
from video_segment_tpu_torch import _build
from video_segment_tpu_torch.core import flow as tflow
from video_segment_tpu_torch.ops import tvl1 as tvl1_ops
from video_segment_tpu_torch.runtime.trace import Trace

torch.set_num_threads(2)

FLOW_TOL = 1e-3   # px; measured about 4e-5 at these sizes


def _pair(seed, h, w, shift=(-1.7, 2.3)):
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.random((h + 16, w + 16)), 1.5)
    base = ((base - base.min()) / (base.max() - base.min())).astype(np.float32)
    i1 = base[8:8 + h, 8:8 + w]
    i0 = ndi.shift(base, shift, order=1)[8:8 + h, 8:8 + w].astype(np.float32)
    return i0, i1


def _frames(seed, n, h=32, w=40):
    """Smooth random BGR frames (TV-L1 on white noise amplifies float
    differences past the tolerance without telling anything)."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = ndi.gaussian_filter(rng.random((h, w, 3)), (1.5, 1.5, 0))
        img = (img - img.min()) / (img.max() - img.min())
        out.append((img * 255).astype(np.uint8))
    return out


def test_tvl1_params_match_jax():
    assert tflow.TVL1Params._fields == jflow.TVL1Params._fields
    assert tflow.TVL1Params() == tuple(jflow.TVL1Params())
    jp = jflow.TVL1Params(nscales=3, iterations=17, fine_warps=1)
    tp = tflow.tvl1_params_from_jax(jp)
    assert isinstance(tp, tflow.TVL1Params)
    assert tuple(tp) == tuple(jp)
    assert jflow.TVL1Params(**tp._asdict()) == jp
    assert (tflow.FLOW_FORWARD, tflow.FLOW_BACKWARD, tflow.FLOW_BOTH) == \
        (jflow.FLOW_FORWARD, jflow.FLOW_BACKWARD, jflow.FLOW_BOTH)


@pytest.mark.parametrize("shape", [(32, 64), (48, 96)], ids=["32x64", "48x96"])
def test_tvl1_flow_matches_jax(shape):
    """Default params; 32x64 is one pyramid scale, 48x96 two."""
    i0, i1 = _pair(0, *shape)
    want = np.asarray(jflow.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1)))
    got = tflow.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1)).numpy()
    assert got.shape == shape + (2,)
    assert np.abs(got - want).max() <= FLOW_TOL
    # The recovered motion is the shift (backward flow i0 -> i1).
    inner = got[8:-8, 8:-8]
    assert abs(np.median(inner[..., 0]) + 2.3) < 0.3
    assert abs(np.median(inner[..., 1]) - 1.7) < 0.3

    a = np.stack([i0, i1])
    b = np.stack([i1, i0])
    want_b = np.asarray(jflow.tvl1_flow_batch(jnp.asarray(a), jnp.asarray(b)))
    got_b = tflow.tvl1_flow_batch(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    assert np.abs(got_b - want_b).max() <= FLOW_TOL
    # The batch is a leading dimension of the same ops: pair 0 is `got`.
    np.testing.assert_array_equal(got_b[0], got)


def test_bgr_to_gray_matches_jax():
    img = _frames(1, 1)[0]
    np.testing.assert_array_equal(tflow.bgr_to_gray(img),
                                  jflow.bgr_to_gray(img))


@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
def test_flow_cache_bytes_match_jax(tmp_path, writer_pkg):
    rng = np.random.default_rng(2)
    fields = [rng.normal(0, 3, (6, 8, 2)).astype(np.float32)
              for _ in range(3)]
    paths = {}
    for name, mod in (("jax", jflow), ("port", tflow)):
        paths[name] = str(tmp_path / f"{name}.flow")
        wr = mod.FlowCacheWriter(paths[name], 8, 6, mod.FLOW_BOTH)
        for f in fields:
            wr.write(f)
        wr.close()
    with open(paths["jax"], "rb") as fa, open(paths["port"], "rb") as fb:
        assert fa.read() == fb.read()
    reader_mod = tflow if writer_pkg == "jax" else jflow
    r = reader_mod.FlowCacheReader(paths[writer_pkg])
    assert (r.width, r.height, r.flow_type) == (8, 6, jflow.FLOW_BOTH)
    for f in fields:
        np.testing.assert_array_equal(r.read(), f)
    assert r.read() is None
    r.close()


def _as_np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("flow_type", ["backward", "forward", "both"])
def test_flow_engine_batched_equals_compute(flow_type):
    """push/flush (batch 3) returns the flows of per-frame compute, in order
    and with their indices, for every flow_type; compute equals JAX's
    engine within the TV-L1 tolerance."""
    ft = {"backward": tflow.FLOW_BACKWARD, "forward": tflow.FLOW_FORWARD,
          "both": tflow.FLOW_BOTH}[flow_type]
    frames = _frames(3, 7)
    params = tflow.TVL1Params(nscales=2, iterations=20, warps=2)
    eng_a = tflow.FlowEngine(40, 32, params=params, flow_type=ft,
                             device="cpu")
    ref = [eng_a.compute(f, i) for i, f in enumerate(frames)]
    eng_b = tflow.FlowEngine(40, 32, params=params, batch=3, flow_type=ft,
                             device="cpu")
    got = []
    for i, f in enumerate(frames):
        got.extend(eng_b.push(f, i))
    got.extend(eng_b.flush())
    assert [i for i, _, _ in got] == list(range(7))
    assert got[0][2] is None and ref[0] is None

    eng_j = jflow.FlowEngine(40, 32, params=jflow.TVL1Params(
        **params._asdict()), flow_type=ft)
    jref = [eng_j.compute(f, i) for i, f in enumerate(frames)]

    def parts(x):
        if ft == tflow.FLOW_BACKWARD:
            return [_as_np(x)]
        assert isinstance(x, (tflow.FlowPair, jflow.FlowPair))
        return [_as_np(x.forward), _as_np(x.backward)]

    for i in range(1, 7):
        for g, r, j in zip(parts(got[i][2]), parts(ref[i]), parts(jref[i])):
            if r is None:   # the half that FORWARD leaves out
                assert g is None and j is None and flow_type == "forward"
                continue
            np.testing.assert_allclose(g, r, atol=1e-5)
            assert np.abs(r - j).max() <= FLOW_TOL


def test_flow_engine_cache_reuse(tmp_path):
    frames = _frames(4, 3)
    path = str(tmp_path / "vid.flow")
    params = tflow.TVL1Params(nscales=2, iterations=10, warps=1)
    eng = tflow.FlowEngine(40, 32, cache_path=path, params=params,
                           device="cpu")
    flows = [eng.compute(f, i) for i, f in enumerate(frames)]
    eng.close()
    assert flows[0] is None and isinstance(flows[1], tflow.FlowField)
    # The JAX engine reads the port's cache, and the port's engine too.
    jeng = jflow.FlowEngine(40, 32, cache_path=path)
    assert jeng._reader is not None
    jcached = [jeng.compute(f, i) for i, f in enumerate(frames)]
    jeng.close()
    eng2 = tflow.FlowEngine(40, 32, cache_path=path, device="cpu")
    assert eng2._reader is not None
    cached = [eng2.compute(f, i) for i, f in enumerate(frames)]
    eng2.close()
    for i in (1, 2):
        np.testing.assert_array_equal(cached[i].numpy(), flows[i].numpy())
        np.testing.assert_array_equal(np.asarray(jcached[i]),
                                      flows[i].numpy())
        assert cached[i].device().device.type == "cpu"


def test_flow_field_one_f16_download_per_batch():
    """Every FlowField of a micro-batch serves its half-width host copy
    from one download of the whole batch; `.numpy()` stays exact f32."""
    frames = _frames(5, 5)
    params = tflow.TVL1Params(nscales=1, iterations=5, warps=1)
    eng = tflow.FlowEngine(40, 32, params=params, batch=4, device="cpu")
    out = []
    for i, f in enumerate(frames):
        out.extend(eng.push(f, i))
    fields = [fl for _, _, fl in out if fl is not None]
    assert len(fields) == 4
    batch = fields[0]._batch
    assert all(f._batch is batch for f in fields)

    class Spy:
        downloads = 0

        def __init__(self, t):
            self.t = t

        def to(self, dtype):
            Spy.downloads += 1
            return self.t.to(dtype)

    dev_batch = batch.dev
    batch.dev = Spy(dev_batch)
    halves = [f.numpy_f16() for f in fields]
    assert Spy.downloads == 1
    for k, (f, h) in enumerate(zip(fields, halves)):
        assert h.dtype == np.float16 and h.shape == (32, 40, 2)
        exact = f.numpy()
        assert exact.dtype == np.float32
        np.testing.assert_array_equal(exact, dev_batch[k].numpy())
        np.testing.assert_array_equal(h, exact.astype(np.float16))
        assert f.device() is f._dev


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tflow.FlowEngine(40, 32)
    with pytest.raises(RuntimeError, match="cuda"):
        tflow.FlowEngine(40, 32, device="cuda")


@pytest.mark.cuda
def test_tvl1_card_matches_cpu():
    """The same torch ops on the card: within the TV-L1 tolerance of the
    CPU run (float atomics play no part; only kernel rounding differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    i0, i1 = _pair(0, 48, 96)
    a, b = torch.from_numpy(np.stack([i0, i1])), torch.from_numpy(
        np.stack([i1, i0]))
    want = tflow.tvl1_flow_batch(a, b).numpy()
    got = tflow.tvl1_flow_batch(a.cuda(), b.cuda()).cpu().numpy()
    assert np.abs(got - want).max() <= FLOW_TOL
    eng = tflow.FlowEngine(40, 32, params=tflow.TVL1Params(nscales=2))
    fields = [fl for i, f in enumerate(_frames(6, 3))
              if (fl := eng.compute(f, i)) is not None]
    assert all(f.device().is_cuda for f in fields)
    assert fields[0].numpy().dtype == np.float32


def _pairs(shape, seed=10):
    """(B,H,W) float32 i0s and i1s: each pair its own texture and shift."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    got = [_pair(seed + k, h, w, shift=tuple(rng.uniform(-3, 3, 2)))
           for k in range(b)]
    return (torch.from_numpy(np.stack([a for a, _ in got])),
            torch.from_numpy(np.stack([c for _, c in got])))


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded")
    monkeypatch.setattr(_build, "load", refuse)


def test_tvl1_cpu_takes_eager_body(monkeypatch):
    """On the CPU `tvl1_flow_batch` is the eager body: equal to
    `tvl1_flow_plain` bit for bit, no kernel launched, no library built."""
    _no_library(monkeypatch)
    monkeypatch.setattr(tvl1_ops.tvl1_scale, "launches", 0)
    a, b = _pairs((2, 37, 53))
    params = tflow.TVL1Params(iterations=7, fine_iterations=5)
    n0 = tvl1_ops.thread_launches()
    got = tflow.tvl1_flow_batch(a, b, params)
    assert _bits_equal(got, tflow.tvl1_flow_plain(a, b, params))
    assert tvl1_ops.tvl1_scale.launches == 0
    assert tvl1_ops.thread_launches() == n0


def test_tvl1_wrapper_validates_before_loading(monkeypatch):
    """The wrapper refuses a float64, a misshapen, a non-contiguous and a
    CPU plane before it loads the library."""
    _no_library(monkeypatch)
    p = tflow.TVL1Params()
    ok = [torch.zeros((2, 17, 30)) for _ in range(6)]
    for k, bad, err in (
            (0, torch.zeros((2, 17, 30), dtype=torch.float64), TypeError),
            (4, torch.zeros((2, 17, 31)), ValueError),
            (5, torch.zeros((2, 30, 17)).transpose(1, 2), ValueError),
            (1, torch.zeros((2, 17, 30)), ValueError)):
        planes = list(ok)
        planes[k] = bad
        with pytest.raises(err):
            tvl1_ops.tvl1_scale(*planes, p)


@pytest.mark.parametrize("shape,params,want", [
    ((6, 272, 480), tflow.TVL1Params(), 534),
    ((1, 37, 53), tflow.TVL1Params(), 165),
    ((2, 17, 30), tflow.TVL1Params(), 42),
    ((1, 64, 64), tflow.TVL1Params(nscales=2, warps=2, iterations=7,
                                   fine_warps=1, fine_iterations=5), 22),
    ((1, 64, 64), tflow.TVL1Params(warps=-1, iterations=4,
                                   fine_iterations=-2), 2)],
    ids=["cell", "ragged", "one_scale", "odd_iterations", "negative"])
def test_kernel_launches_follow_the_pyramid(shape, params, want):
    """`kernel_launches` counts what the wrapper would launch over the
    scales `_tvl1_flow_impl` actually runs (a recording scale on the
    CPU stands in for the kernels)."""
    per_scale = []

    def recording(i0, i1, u1, u2, p):
        per_scale.append(max(p.warps, 0) * (1 + max(p.iterations, 0)))
        return u1, u2

    tflow._tvl1_flow_impl(*_pairs(shape), params, recording)
    assert sum(per_scale) == tflow.kernel_launches(*shape[1:], params) \
        == want


@pytest.mark.parametrize("short", [0, 1], ids=["every_launch", "one_short"])
def test_flow_engine_counts_kernel_pairs_from_launches(monkeypatch, short):
    """`flow.kernel_pairs` counts a pair only when the wrapper's launches
    on the engine's thread make up the whole schedule: a stand-in scale
    that reports its launches as the wrapper does, all of them or one
    short."""
    eager = tflow._tvl1_scale

    def scale(i0, i1, u1, u2, p):
        tvl1_ops._thread.launches = (tvl1_ops.thread_launches()
                                     + p.warps * (1 + p.iterations) - short)
        return eager(i0, i1, u1, u2, p)

    monkeypatch.setattr(tflow, "_tvl1_scale", scale)
    trace = Trace()
    eng = tflow.FlowEngine(40, 32, params=tflow.TVL1Params(
        nscales=2, iterations=3, warps=1, fine_warps=1, fine_iterations=3),
        batch=3, device="cpu", trace=trace)
    frames = _frames(8, 5)
    for i, f in enumerate(frames[:4]):
        eng.push(f, i)
    eng.flush()
    eng.compute(frames[4], 4)
    assert trace.counters == {"flow.pairs": 4,
                              "flow.kernel_pairs": 0 if short else 4}


@pytest.mark.parametrize("mode", ["batched", "compute"])
def test_flow_engine_counts_kernel_pairs_on_cpu(mode):
    """Every computed field counts in `flow.pairs`; on the CPU none in
    `flow.kernel_pairs`."""
    trace = Trace()
    eng = tflow.FlowEngine(40, 32, params=tflow.TVL1Params(
        nscales=1, iterations=3, warps=1, fine_warps=1, fine_iterations=3),
        batch=3, device="cpu", trace=trace)
    frames = _frames(8, 5)
    for i, f in enumerate(frames):
        if mode == "batched":
            eng.push(f, i)
        else:
            eng.compute(f, i)
    eng.flush()
    assert trace.counters == {"flow.pairs": 4, "flow.kernel_pairs": 0}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 272, 480), (1, 37, 53), (2, 17, 30)],
                         ids=["cell", "ragged", "one_scale"])
def test_tvl1_kernels_equal_eager_on_card(shape):
    """The kernel path against the eager body on the same CUDA tensors,
    bit for bit: the cell's batch (5 scales), a ragged pair whose pyramid
    stops after 2 scales, and 2 pairs at the coarsest size (1 scale)."""
    _need_card()
    a, b = (t.cuda() for t in _pairs(shape))
    before = tvl1_ops.tvl1_scale.launches
    got = tflow.tvl1_flow_batch(a, b)
    launched = tvl1_ops.tvl1_scale.launches - before
    want = tflow.tvl1_flow_plain(a, b)
    torch.cuda.synchronize()
    assert launched == tflow.kernel_launches(*shape[1:], tflow.TVL1Params())
    assert _bits_equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    tflow.TVL1Params(nscales=1),
    tflow.TVL1Params(nscales=2, warps=2, iterations=7, fine_warps=1,
                     fine_iterations=5),
    tflow.TVL1Params(tau=0.2, lambda_=0.3, theta=0.25, iterations=0)],
    ids=["one_scale", "odd_iterations", "no_iterations"])
def test_tvl1_kernels_honour_params_on_card(params):
    """Any schedule and any weights: still the eager body bit for bit."""
    _need_card()
    a, b = (t.cuda() for t in _pairs((3, 48, 96), seed=20))
    got = tflow.tvl1_flow_batch(a, b, params)
    assert _bits_equal(got, tflow.tvl1_flow_plain(a, b, params))


@pytest.mark.cuda
def test_flow_engine_counts_kernel_pairs_on_card():
    _need_card()
    trace = Trace()
    before = tvl1_ops.tvl1_scale.launches
    eng = tflow.FlowEngine(40, 32, batch=3, trace=trace)
    for i, f in enumerate(_frames(9, 7)):
        eng.push(f, i)
    eng.flush()
    eng.compute(_frames(9, 1)[0], 7)
    assert trace.counters["flow.kernel_pairs"] == \
        trace.counters["flow.pairs"] == 7
    assert tvl1_ops.tvl1_scale.launches > before


@pytest.mark.cuda
def test_tvl1_wrapper_raises_on_card():
    """A non-contiguous or a float64 CUDA plane raises; so does a
    `tvl1_flow_batch` of float64 pairs (the kernel path takes no other
    type, and nothing falls back to the eager body)."""
    _need_card()
    p = tflow.TVL1Params()
    ok = [torch.zeros((2, 17, 30), device="cuda") for _ in range(6)]
    for k, bad, err in (
            (2, torch.zeros((2, 30, 17), device="cuda").transpose(1, 2),
             ValueError),
            (3, torch.zeros((2, 17, 30), dtype=torch.float64,
                            device="cuda"), TypeError)):
        planes = list(ok)
        planes[k] = bad
        with pytest.raises(err):
            tvl1_ops.tvl1_scale(*planes, p)
    a, b = _pairs((1, 17, 30))
    with pytest.raises(TypeError):
        tflow.tvl1_flow_batch(a.double().cuda(), b.double().cuda())
