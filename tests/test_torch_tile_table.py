"""Port K3 (tile_table_rounds) against the JAX oracle and Pallas kernel.

Inputs follow tests/test_tile_table.py: colours quantized to multiples of
1/64 and small integer sizes, so float32 (JAX) and float64 (port) sums are
all exact and label equality is exact.  The plain PyTorch version must
equal `blocked_rounds_reference` and the Pallas kernel (interpret mode);
`blocked_layout` must equal JAX's.  The CUDA kernel is held to the plain
version on a card, on tables that stress its design: one region over a
whole 4096-slot supertile, 4095 labels merging into one root in one round,
fewer slots than threads, K of 1 and 12, and a table that needs every
round.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_segment_tpu.ops import tile_table as jtt
from video_segment_tpu_torch.ops import tile_table as ttt

torch.set_num_threads(2)

I32MAX = 2 ** 31 - 1


def mk_case(rng, n=3, sr=4, k=6, frac_blocked=0.05):
    """(labr, labc, size, c0, c1, c2, fin, blocked, edges) as (N, S) /
    (N, K, S) numpy arrays, identity labels."""
    s = sr * ttt.L
    labr = np.tile((np.arange(s, dtype=np.int32) // ttt.L)[None], (n, 1))
    labc = np.tile((np.arange(s, dtype=np.int32) % ttt.L)[None], (n, 1))
    size = rng.integers(1, 5, (n, s)).astype(np.float32)
    cols = rng.integers(0, 65, (3, n, s)).astype(np.float32) / 64.0
    c = [cols[i] * size for i in range(3)]
    fin = np.where(rng.random((n, s)) < 0.2, rng.integers(0, 256, (n, s)),
                   ttt.NUM_BUCKETS).astype(np.int32)
    blocked = (rng.random((n, s)) < frac_blocked).astype(np.int32)
    ptn = rng.integers(0, s, (n, k, s)).astype(np.int32)
    bkt = rng.integers(0, 300, (n, k, s)).astype(np.int32)
    absent = rng.random((n, k, s)) < 0.3
    edges = np.where(absent, I32MAX, (bkt << ttt.PBITS) | ptn)
    return (labr, labc, size, c[0], c[1], c[2], fin, blocked,
            edges.astype(np.int32))


def flat_case(case):
    """Identical colours, open fins, nothing blocked: every edge passes."""
    case = list(case)
    for i in (3, 4, 5):
        case[i] = np.zeros_like(case[i])
    case[6] = np.full_like(case[6], ttt.NUM_BUCKETS)
    return tuple(case)


def absorb_case(rng, n=2, sr=32, k=12):
    """Flat colours, open fins, nothing blocked, and every slot's first edge
    to slot 0 at bucket 0: once slot 0 has hooked into some root R, every
    other root's best partner is R's region, and the next rounds hook them
    all onto it (those above R, then those below)."""
    case = list(flat_case(mk_case(rng, n=n, sr=sr, k=k, frac_blocked=0.0)))
    case[8][:, 0] = 0
    return tuple(case)


def one_region_case(rng, n=2, sr=32, k=12):
    """Every slot already in the region of slot 0."""
    case = list(mk_case(rng, n=n, sr=sr, k=k))
    case[0] = np.zeros_like(case[0])
    case[1] = np.zeros_like(case[1])
    return tuple(case)


def run_port(case, device="cpu", plain=False, **kw):
    n, s = case[2].shape
    sr = s // ttt.L
    planes = [torch.from_numpy(x.reshape(n, sr, ttt.L)).to(device)
              for x in case[:8]]
    edges = torch.from_numpy(case[8].reshape(n, -1, sr, ttt.L)).to(device)
    fn = ttt.tile_table_rounds_plain if plain else ttt.tile_table_rounds
    outr, outc = fn(*planes, edges, **kw)
    return (outr.long() * ttt.L + outc.long()).reshape(n, s).cpu().numpy()


def run_oracle(case, theta, rounds, mthr):
    labr, labc, size, c0, c1, c2, fin, blocked, edges = case
    lab = (labr * ttt.L + labc).astype(np.int32)
    fn = jax.vmap(lambda la, sz, a0, a1, a2, fi, bl, ed:
                  jtt.blocked_rounds_reference(
                      la, sz, a0, a1, a2, fi, bl, ed, theta, rounds=rounds,
                      merge_threshold=mthr, force_merge_weight=0.001,
                      metric="l2"))
    return np.asarray(fn(*(jnp.asarray(x) for x in (lab, size, c0, c1, c2,
                                                     fin)),
                         jnp.asarray(blocked) > 0, jnp.asarray(edges)))


def run_pallas(case, theta, rounds, mthr):
    n, s = case[2].shape
    sr = s // jtt.L
    resh = [jnp.asarray(x).reshape(n, sr, jtt.L) for x in case[:8]]
    outr, outc = jtt.tile_table_rounds(
        *resh, jnp.asarray(case[8]).reshape(n, -1, sr, jtt.L), theta=theta,
        rounds=rounds, merge_threshold=mthr, force_merge_weight=0.001,
        metric="l2", interpret=True)
    return (np.asarray(outr).reshape(n, s) * jtt.L
            + np.asarray(outc).reshape(n, s))


CASES = {
    "theta64": (7, 64, 0.08, 5, False),
    "theta256": (7, 256, 0.15, 5, False),
    "theta16": (7, 16, 0.05, 5, False),
    "heavy_merging": (11, 2047, 0.05, 8, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_oracle_and_pallas(name):
    seed, theta, mthr, rounds, flat = CASES[name]
    rng = np.random.default_rng(seed)
    case = (flat_case(mk_case(rng, n=2, k=8, frac_blocked=0.0)) if flat
            else mk_case(rng))
    got = run_port(case, theta=theta, rounds=rounds, merge_threshold=mthr,
                   force_merge_weight=0.001, metric="l2")
    want = run_oracle(case, theta, rounds, mthr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, run_pallas(case, theta, rounds, mthr))
    assert (got != np.arange(got.shape[1])[None]).any()   # merges happened


def test_plain_absorb_matches_oracle():
    """Every root hooks onto one region within five rounds: the plain
    version equals `blocked_rounds_reference` and ends in one region a
    supertile."""
    case = absorb_case(np.random.default_rng(5), sr=4)
    got = run_port(case, theta=300, rounds=5, merge_threshold=0.05,
                   force_merge_weight=0.001, metric="l2")
    np.testing.assert_array_equal(got, run_oracle(case, 300, 5, 0.05))
    assert all(len(np.unique(row)) == 1 for row in got)


def test_l1_and_round_budget():
    """l1 metric, and supertiles stopping at different rounds (frozen
    labels must not move once a supertile is idle)."""
    rng = np.random.default_rng(3)
    case = list(mk_case(rng, n=4, sr=2, k=4))
    case[8][1] = I32MAX                        # supertile 1: no edges
    case = tuple(case)
    for rounds in (0, 1, 3):
        got = run_port(case, theta=128, rounds=rounds, merge_threshold=0.1,
                       force_merge_weight=0.001, metric="l1")
        ident = np.arange(got.shape[1])
        np.testing.assert_array_equal(got[1], ident)
        if rounds == 0:
            np.testing.assert_array_equal(got, np.tile(ident, (4, 1)))
    lab, sz = case[0] * ttt.L + case[1], case[2]
    want = np.asarray(jax.vmap(
        lambda la, s_, a0, a1, a2, fi, bl, ed: jtt.blocked_rounds_reference(
            la, s_, a0, a1, a2, fi, bl, ed, 128, rounds=3,
            merge_threshold=0.1, force_merge_weight=0.001, metric="l1"))(
        *(jnp.asarray(x) for x in (lab, sz, *case[3:7])),
        jnp.asarray(case[7]) > 0, jnp.asarray(case[8])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nseg,n_sup,s_cap", [(1000, 7, 128),
                                              (3000, 3, 1024)])
def test_blocked_layout_matches_jax(nseg, n_sup, s_cap):
    rng = np.random.default_rng(nseg)
    sup = rng.integers(0, n_sup, nseg).astype(np.int32)
    sup[-1] = n_sup                            # sink slot
    g2b_j, b2g_j = jtt.blocked_layout(jnp.asarray(sup), n_sup, s_cap)
    g2b, b2g = ttt.blocked_layout(torch.from_numpy(sup), n_sup, s_cap)
    np.testing.assert_array_equal(g2b.numpy(), np.asarray(g2b_j))
    np.testing.assert_array_equal(b2g.numpy(), np.asarray(b2g_j))
    over = np.maximum(np.bincount(sup[:-1], minlength=n_sup) - s_cap, 0)
    assert (g2b.numpy() < 0).sum() == over.sum() + 1
    assert (over.sum() > 0) == (s_cap == 128)


def test_wrapper_validates_inputs():
    rng = np.random.default_rng(0)
    case = mk_case(rng, n=1, sr=1, k=2)
    planes = [torch.from_numpy(x.reshape(1, 1, ttt.L)) for x in case[:8]]
    edges = torch.from_numpy(case[8].reshape(1, 2, 1, ttt.L))
    kw = dict(theta=4, rounds=1, merge_threshold=0.05,
              force_merge_weight=0.001, metric="l2")
    with pytest.raises(TypeError):
        ttt.tile_table_rounds(*planes[:2], planes[2].double(), *planes[3:],
                              edges, **kw)
    with pytest.raises(ValueError):
        ttt.tile_table_rounds(*planes, edges[:, :, :, :64], **kw)
    big = torch.zeros((1, 33, ttt.L), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttt.tile_table_rounds(big, *planes[1:], edges, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    seed, theta, mthr, rounds, flat = CASES[name]
    rng = np.random.default_rng(seed)
    case = (flat_case(mk_case(rng, n=2, sr=32, k=8, frac_blocked=0.0))
            if flat else mk_case(rng, sr=32, k=12))
    kw = dict(theta=theta, rounds=rounds, merge_threshold=mthr,
              force_merge_weight=0.001, metric="l2")
    before = ttt.tile_table_rounds.launches
    got = run_port(case, device="cuda", **kw)
    assert ttt.tile_table_rounds.launches == before + 1
    want = run_port(case, device="cuda", plain=True, **kw)
    np.testing.assert_array_equal(got, want)


K3_CARD_CASES = {
    # name: (table, theta, merge_threshold, rounds, metric)
    "one_region": ("one_region", 256, 0.15, 5, "l2"),
    "absorb": ("absorb", 300, 0.05, 5, "l2"),
    "sr1_k1": ("sr1_k1", 256, 0.15, 5, "l2"),
    "sr4_k12": ("sr4_k12", 256, 0.15, 5, "l1"),
    "k1": ("k1", 2047, 0.1, 5, "l2"),
    "all_rounds": ("all_rounds", 2047, 0.2, 5, "l2"),
}


def _k3_card_table(name, rng):
    if name == "one_region":
        return one_region_case(rng)
    if name == "absorb":
        return absorb_case(rng)
    if name == "sr1_k1":
        return mk_case(rng, n=3, sr=1, k=1)
    if name == "sr4_k12":
        return mk_case(rng, n=3, sr=4, k=12)
    if name == "k1":
        return mk_case(rng, n=4, sr=32, k=1)
    return mk_case(rng, n=4, sr=32, k=12, frac_blocked=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K3_CARD_CASES))
def test_kernel_design_cases_on_card(name):
    """The kernel equals its plain version bit for bit where its design is
    stressed: atomics on one root (one_region: the whole supertile in one
    label from the start; absorb: thousands of labels add their sums to one
    root in one round), fewer slots than threads (SR 1 and 4), K = 1 and 12, the
    blocked and finalize gates on (random tables), and a table whose fifth
    round still merges (all_rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode)")
    table, theta, mthr, rounds, metric = K3_CARD_CASES[name]
    case = _k3_card_table(table, np.random.default_rng(17))
    kw = dict(theta=theta, rounds=rounds, merge_threshold=mthr,
              force_merge_weight=0.001, metric=metric)
    got = run_port(case, device="cuda", **kw)
    want = run_port(case, device="cuda", plain=True, **kw)
    np.testing.assert_array_equal(got, want)
    if name in ("absorb", "one_region"):
        assert all(len(np.unique(row)) == 1 for row in got)
    if name == "all_rounds":
        fewer = run_port(case, device="cuda", plain=True,
                         **dict(kw, rounds=rounds - 1))
        assert (fewer != want).any()
