"""Port K1 (tile_felzenszwalb) against the JAX kernel and its NumPy mirror.

The plain PyTorch version runs here on the CPU; it must equal the mirror
`tile_felz_reference` and the JAX Pallas kernel (interpret mode) exactly
in labels and finalize levels, and match the cell-positioned stats to
1e-5 relative (the mirror and the JAX kernel sum colours in float32, the
port in float64).  The CUDA kernel is held to the plain version bit for
bit on a card (`-m cuda`), on ragged shapes, T > 1, a flat frame and
presmoothed frames of the benchmark's clip, under every variant; its gate
keys are checked here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.ops import tile_felz as jtf
from video_segment_tpu_torch.ops import tile_felz as ttf

torch.set_num_threads(2)

# Dense-stage arguments (core/dense.py:_preseg_frame with default params).
DENSE_KW = dict(schedule=(4, 32, 96), rounds_per_level=2,
                merge_threshold=0.05, metric="l2", fin_margin=1.0,
                fin_eager=True, fin_gated=True)


@pytest.fixture(scope="module")
def textured_vol():
    rng = np.random.default_rng(7)
    base = rng.random((2, 24, 300, 3)).astype(np.float32)
    import scipy.ndimage as ndi
    return ndi.gaussian_filter(base, (0, 2, 2, 0)).astype(np.float32)


def _check_stats(st_a, st_b, vol):
    for a, b in zip(st_a, st_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    t, h, w, _ = vol.shape
    assert float(np.asarray(st_a[0]).sum()) == t * h * w


def test_plain_matches_mirror_and_jax_dense_args(textured_vol):
    vol = textured_vol
    lab_p, fin_p, st_p = ttf.tile_felzenszwalb(torch.from_numpy(vol),
                                               **DENSE_KW)
    lab_m, fin_m, st_m = jtf.tile_felz_reference(vol, **DENSE_KW)
    lab_j, fin_j, _ = jtf.tile_felzenszwalb(jnp.asarray(vol), **DENSE_KW)
    np.testing.assert_array_equal(lab_p.numpy(), lab_m)
    np.testing.assert_array_equal(fin_p.numpy(), fin_m)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(fin_p.numpy(), np.asarray(fin_j))
    _check_stats(st_p, st_m, vol)
    # Labels are self-rooted: a pointer jump is a no-op.
    flat = lab_p.reshape(-1).long()
    assert torch.equal(flat[flat], flat)


VARIANTS = {
    "margin": dict(schedule=(4, 32, 96), fin_margin=1.5),
    "eager": dict(schedule=(4, 32, 96), fin_eager=True),
    "gated": dict(schedule=(4, 32, 96), fin_gated=True),
    "pair_tuple": dict(schedule=(4, 32, 96), fin_eager=True, fin_gated=True,
                       pair_merge=True, rounds_per_level=(8, 4, 2)),
    "l1": dict(schedule=(4, 32, 96), metric="l1", fin_eager=True,
               fin_gated=True),
}


@pytest.mark.parametrize("kw", list(VARIANTS.values()), ids=list(VARIANTS))
def test_plain_matches_mirror_variants(textured_vol, kw):
    vol = textured_vol[:1]
    lab_p, fin_p, st_p = ttf.tile_felzenszwalb(torch.from_numpy(vol), **kw)
    lab_m, fin_m, st_m = jtf.tile_felz_reference(vol, **kw)
    np.testing.assert_array_equal(lab_p.numpy(), lab_m)
    np.testing.assert_array_equal(fin_p.numpy(), fin_m)
    _check_stats(st_p, st_m, vol)


def test_margined_fixture_fin_level():
    """A | b1 | b2 flat strips: b1+b2 merge, A|B fails at bucket 94."""
    h, w = 8, 128
    vol = np.full((1, h, w, 3), 0.100, np.float32)
    vol[:, :, 64:96] = 0.146
    vol[:, :, 96:] = 0.1558
    kw = dict(schedule=(4, 32, 96), rounds_per_level=8, fin_margin=1.0)
    lab_p, fin_p, _ = ttf.tile_felzenszwalb(torch.from_numpy(vol), **kw)
    assert len(np.unique(lab_p.numpy())) == 2
    np.testing.assert_array_equal(
        fin_p.numpy()[0], np.full((h, w), int(abs(0.146 - 0.100) * 2048)))


def test_wrapper_validates_inputs():
    with pytest.raises(ValueError):
        ttf.tile_felzenszwalb(torch.zeros((2, 8, 8)))
    with pytest.raises(TypeError):
        ttf.tile_felzenszwalb(torch.zeros((1, 8, 8, 3), dtype=torch.float64))


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("threshold", [0.05, 0.075, 0.0123, 0.5])
def test_gate_key_splits_distances_exactly(metric, threshold):
    """The kernel's gate compares the float64 key (sum of squared / of
    absolute mean differences) with `gate_key`; on keys around it and on
    random keys, `key < gate_key` equals the plain version's
    `distance < threshold` with its division and square root."""
    key = ttf.gate_key(threshold, metric)

    def dist(k):
        d = torch.tensor([k], dtype=torch.float64) / 3.0
        return float((ttf.sqrt64(d) if metric == "l2" else d)[0])

    assert dist(key) >= threshold
    below = np.nextafter(key, 0.0)
    assert dist(below) < threshold
    rng = np.random.default_rng(0)
    ks = np.concatenate([key * (1 + rng.normal(0, 1e-12, 200)),
                         rng.random(200) * 3 * key,
                         [0.0, below, key, np.nextafter(key, np.inf)]])
    for k in np.abs(ks):
        assert (k < key) == (dist(k) < threshold), k


def _clip_frames(n):
    """Presmoothed frames of the benchmark's synthetic 272x480 clip
    (`bench_port.generator`, the clip of chip_smoke.py's main path): the
    inputs the main path feeds K1."""
    from bench_port import generator
    from video_segment_tpu_torch.core import dense
    frames = generator.synthetic_clip(n)
    return torch.stack([dense._preprocess_u8(torch.as_tensor(f).cuda(),
                                             "bilateral") for f in frames])


def _card_input(name, textured_vol):
    if name == "textured":           # T=2, W not a multiple of 128
        return torch.from_numpy(textured_vol).cuda()
    if name == "ragged":             # T=3, neither H nor W tile multiples
        rng = np.random.default_rng(9)
        import scipy.ndimage as ndi
        vol = ndi.gaussian_filter(rng.random((3, 21, 203, 3)),
                                  (0, 1.5, 1.5, 0)).astype(np.float32)
        return torch.from_numpy(vol).cuda()
    if name == "flat":               # one region per tile: most contention
        return torch.full((2, 16, 256, 3), 0.4, device="cuda")
    return _clip_frames(2)           # "clip": (2, 272, 480) presmoothed


@pytest.mark.cuda
@pytest.mark.parametrize("inp", ["textured", "ragged", "flat", "clip"])
@pytest.mark.parametrize("kw", [DENSE_KW, *VARIANTS.values()],
                         ids=["dense", *VARIANTS])
def test_kernel_matches_plain_on_card(textured_vol, kw, inp):
    """Bit for bit: labels, fin levels, sizes and colour sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    vol = _card_input(inp, textured_vol)
    before = ttf.tile_felzenszwalb.launches
    lab_k, fin_k, st_k = ttf.tile_felzenszwalb(vol, **kw)
    assert ttf.tile_felzenszwalb.launches == before + 1
    lab_p, fin_p, st_p = ttf.tile_felzenszwalb_plain(vol, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lab_k, lab_p)
    assert torch.equal(fin_k, fin_p)
    for a, b in zip(st_k, st_p):
        assert torch.equal(a, b), float((a - b).abs().max())
    if inp == "flat" and not kw.get("pair_merge"):
        assert torch.unique(lab_k).numel() == vol.shape[0] * 2 * 2


def _tiny_colour_input(kind):
    """Frames seeded with colours in (0, 2^-20), where a float64 sum of
    float32 colours is no longer exact once it also holds ordinary ones:
    "tiny" has nothing else, "mixed" scatters them through a textured
    frame one channel at a time, "tails" fades bright blobs into a dark
    floor of them (a presmoothed bright pixel's far tail)."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(31)
    shape = (2, 40, 300)
    tiny = (2.0 ** rng.uniform(-60, -20, shape + (3,))).astype(np.float32)
    assert ((tiny > 0) & (tiny < 2.0 ** -20)).all()
    if kind == "tiny":
        return tiny
    vol = ndi.gaussian_filter(rng.random(shape + (3,)),
                              (0, 1.5, 1.5, 0)).astype(np.float32)
    if kind == "mixed":
        return np.where(rng.random(shape + (3,)) < 0.3, tiny, vol)
    blobs = ndi.gaussian_filter((rng.random(shape) < 0.002)
                                .astype(np.float64), (0, 2.0, 2.0))
    tails = (blobs / blobs.max())[..., None] ** 4 * vol
    return np.where(tails < 2.0 ** -20, np.minimum(tiny, 2.0 ** -21),
                    tails).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiny", "mixed", "tails"])
@pytest.mark.parametrize("kw", [DENSE_KW, VARIANTS["pair_tuple"],
                                VARIANTS["l1"]],
                         ids=["dense", "pair_tuple", "l1"])
def test_kernel_matches_plain_on_tiny_colours(kind, kw):
    """K1 against its plain version, bit for bit, on colours below 2^-20:
    the kernel's float64 colour sums are exact only for colours that are 0
    or at least 2^-20, so a region that holds smaller ones could see its
    mean move with the order of the sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    vol_np = _tiny_colour_input(kind)
    assert ((vol_np > 0) & (vol_np < 2.0 ** -20)).mean() > 0.05
    vol = torch.from_numpy(vol_np).cuda()
    lab_k, fin_k, st_k = ttf.tile_felzenszwalb(vol, **kw)
    lab_p, fin_p, st_p = ttf.tile_felzenszwalb_plain(vol, **kw)
    torch.cuda.synchronize()
    assert torch.equal(lab_k, lab_p)
    assert torch.equal(fin_k, fin_p)
    for a, b in zip(st_k, st_p):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert torch.unique(lab_k).numel() < lab_k.numel() * 9 // 10  # merged
