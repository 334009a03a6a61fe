"""The split-N top-k of ``csrc/fused_topk.cu`` as plain torch arithmetic:
the points cut into ``fused_topk.split_bounds`` runs, a stable top-k of
packed (distance bits, index) keys per run, then the kernel's split
merge (each key's slot is the count of keys below it over all runs).
The model is held against the plain version ``ref.topk_l2`` and against
the JAX package's ``topk_l2_pallas`` in interpret mode, as
tests/test_kernels.py runs it. The CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: ids exact. Distances equal to the plain version's bit for bit
(the model ranks the plain version's own distances) and within
rtol=1e-5, atol=1e-5 of the Pallas kernel's (fp32 summation order, XLA
vs torch's CPU GEMM); exactly equal on integer-grid inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_topk import topk_l2_pallas
from repro_torch.kernels import fused_topk
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

RTOL = ATOL = 1e-5   # fp32 summation order (XLA vs torch CPU GEMM)
PAD = torch.iinfo(torch.int64).max   # an empty slot: after every real key


def _keys(d: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The kernel's ``pack_key``: (fp32 bits of the clamped distance << 32)
    | column."""
    d = torch.clamp_min(d, 0.0) + 0.0          # -0.0 -> +0.0
    return (d.view(torch.int32).to(torch.int64) << 32) | cols


def split_topk_model(q: torch.Tensor, p: torch.Tensor, k: int,
                     splits: int):
    """Per split, the k best keys (padded with empty slots where the
    split is narrower than k); then the split merge. Returns (distances,
    ids) as ``ref.topk_l2`` does."""
    d = tref.pairwise_sq_l2(q, p)
    m, n = d.shape
    parts = torch.full((m, splits, k), PAD, dtype=torch.int64)
    for s, (b, e) in enumerate(fused_topk.split_bounds(n, splits)):
        kk = min(k, e - b)
        key = _keys(d[:, b:e], torch.arange(b, e))
        parts[:, s, :kk] = torch.topk(key, kk, dim=1, largest=False).values
    flat = parts.reshape(m, splits * k)
    # slot of a key: the keys below it in every split (its own included:
    # real keys are unique, each column lies in one split)
    slot = sum(torch.searchsorted(parts[:, t].contiguous(), flat)
               for t in range(splits))
    real = (flat != PAD) & (slot < k)
    out = torch.full((m, k), PAD, dtype=torch.int64)
    rows = torch.arange(m)[:, None].expand_as(flat)
    out[rows[real], slot[real]] = flat[real]
    assert bool((out != PAD).all())          # k <= n real keys fill it
    ids = out & 0xFFFFFFFF
    dist = (out >> 32).to(torch.int32).view(torch.float32)
    return dist, ids


def _grid_with_cross_split_ties(n, d, splits, seed):
    """Integer-grid points in which each of four rows is copied just
    either side of every split boundary: exact ties across splits."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-3, 4, (n, d)).astype(np.float32)
    bounds = fused_topk.split_bounds(n, splits)
    q = p[[(b + e) // 2 for b, e in bounds[-4:]]].copy()
    for j in range(4):
        for b, _ in bounds[1:]:
            p[b - 1 - j] = q[j]
            p[b + j] = q[j]
    return q, p


@pytest.mark.parametrize("m,n,d,k,splits,kind", [
    (20, 1000, 8, 2, 8, "grid"),       # ties across split boundaries
    (20, 1000, 8, 300, 8, "grid"),     # k above a split's 128 points
    (20, 1000, 8, 1000, 8, "grid"),    # k = N
    (13, 700, 6, 1, 3, "gauss"),
    (13, 700, 6, 17, 5, "gauss"),
    (9, 300, 5, 200, 3, "gauss"),      # k above every split's width
    (7, 129, 4, 2, 2, "gauss"),        # a one-point last tile
])
def test_split_model_matches_plain_and_pallas(m, n, d, k, splits, kind):
    if kind == "grid":
        q, p = _grid_with_cross_split_ties(n, d, splits, seed=k)
        extra = np.random.default_rng(1).integers(-3, 4, (m - 4, d))
        q = np.concatenate([q, extra.astype(np.float32)])
    else:
        rng = np.random.default_rng(m + n)
        q = rng.normal(size=(m, d)).astype(np.float32)
        p = rng.normal(size=(n, d)).astype(np.float32)
    gd, gi = split_topk_model(torch.from_numpy(q), torch.from_numpy(p), k,
                              splits)
    wd, wi = tref.topk_l2(torch.from_numpy(q), torch.from_numpy(p), k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    pd, pi = topk_l2_pallas(jnp.asarray(q), jnp.asarray(p), k,
                            interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    if kind == "grid":
        np.testing.assert_array_equal(gd.numpy(), np.asarray(pd))
    else:
        np.testing.assert_allclose(gd.numpy(), np.asarray(pd), rtol=RTOL,
                                   atol=ATOL)


def test_cross_split_ties_keep_the_lower_index():
    """Each of the four queries ties at 0 with its copies on both sides
    of every boundary; its k best are those copies by ascending index,
    whichever split holds them."""
    q, p = _grid_with_cross_split_ties(1000, 8, 8, seed=3)
    want = [sorted(np.flatnonzero((p == q[j]).all(1)))[:6]
            for j in range(4)]
    gd, gi = split_topk_model(torch.from_numpy(q), torch.from_numpy(p), 6,
                              8)
    assert gi.tolist() == [[int(i) for i in w] for w in want]
    assert bool((gd == 0).all())


@pytest.mark.parametrize("n,splits", [(1, 1), (33, 1), (129, 2),
                                      (5003, 40), (200000, 8),
                                      (200000, 132)])
def test_split_bounds_cut_whole_tiles(n, splits):
    """The runs cover [0, n) in order, none empty, each a whole number of
    128-point tiles but the last, the tile counts differing by at most
    one: the kernel's split s takes tiles [s T / S, (s + 1) T / S)."""
    bounds = fused_topk.split_bounds(n, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(b < e for b, e in bounds)
    assert all(b % fused_topk.TILE_N == 0 for b, _ in bounds)
    tiles = [-(-(e - b) // fused_topk.TILE_N) for b, e in bounds]
    assert max(tiles) - min(tiles) <= 1


@pytest.mark.parametrize("k,want", [(1, "reg"), (2, "reg"), (3, "merge"),
                                    (1000, "merge")])
def test_route_is_chosen_by_k_alone(k, want):
    assert fused_topk.route(k) == want
    assert (k <= fused_topk.REG_K) == (want == "reg")
