"""The build options against the JAX package: HIBOG (the paper's Table 6
baseline) and ``build_index(split_lpgf=True)``.

Tolerance: neighbour ids, trees and permutations exact; HIBOG's moved
points within 1e-5 (relative, fp32 summation order).
"""
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core.lpgf import hibog as jhibog
from repro.kernels import ops as jops
from repro_torch.core import index as tindex
from repro_torch.core import lpgf as tlpgf_mod
from repro_torch.core.lpgf import hibog as thibog
from repro_torch.core.measurement import silhouette

torch.set_num_threads(1)


def _blobs(n=600, d=8, k=4, spread=6.0, seed=0):
    """``tests/test_feature_rep.py``'s blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return x, lab


def _recording(monkeypatch, mod, name, into):
    real = getattr(mod, name)

    def rec(*a, **kw):
        d, idx = real(*a, **kw)
        into.append(np.asarray(idx))
        return d, idx
    monkeypatch.setattr(mod, name, rec)


def _unique_grid(n, d, seed, scale=0.25):
    """Distinct points of a quarter-integer grid: every squared distance
    is exact in fp32 in both packages (and stays exact after HIBOG's
    moves, multiples of 1/64 here), so the neighbours are decided
    alike, ties by index."""
    rng = np.random.default_rng(seed)
    x = np.unique(rng.integers(-12, 13, (2 * n, d)), axis=0)
    return (x[rng.permutation(len(x))[:n]] * scale).astype(np.float32)


@pytest.mark.parametrize("seed,k,iters", [(4, 8, 2), (1, 3, 1)])
def test_hibog_matches_reference(monkeypatch, seed, k, iters):
    """Each iteration's k + 1 nearest ids equal the reference's (the point
    itself first on the distinct input), and the moved points lie within
    1e-5 of its."""
    x = _unique_grid(600, 6, seed)
    jn, tn = [], []
    _recording(monkeypatch, jops, "topk_l2_blocked", jn)
    _recording(monkeypatch, tlpgf_mod.ops, "topk_l2_blocked", tn)
    want = jhibog(x, k=k, iters=iters)
    got = thibog(x, k=k, iters=iters, device="cpu")
    assert len(jn) == len(tn) == iters
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tn[0][:, 0], np.arange(len(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hibog_also_improves():
    """The reference's own assertion (``tests/test_feature_rep.py``), on
    the port."""
    x, lab = _blobs(seed=4)
    assert silhouette(thibog(x, iters=2, device="cpu"), lab) > \
        silhouette(x, lab)


def _clustered_grid(n, d, seed, scale=2.0 ** -17):
    """Six clusters of distinct grid points, spaced ``scale`` apart. LPGF
    moves each node's points from the grid, where every squared distance
    is exact, so both packages take the same ring decisions; at this
    scale the fp32 self-distance residues of the moved points (about
    |p|^2 * 2^-24) stay below DPC's 1e-12 floor in both, so neither
    package counts any in its cutoff's quantile."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-40, 41, (6, d))
    lab = rng.integers(0, 6, 2 * n)
    x = np.unique(c[lab] + rng.integers(-6, 7, (2 * n, d)), axis=0)
    return (x[rng.permutation(len(x))[:n]] * scale).astype(np.float32)


# DPC's cutoff is the 2% quantile of the moved points' sampled distances,
# through the fp32 expansion |p|^2 + |q|^2 - 2 p.q, whose error relative to
# a squared distance grows with |p|^2 / d^2 (~1,600 here): the two
# packages' cutoffs agree within this (measured: 3.0e-5)
CUTOFF_RTOL = 1e-3


def test_build_index_split_lpgf_matches_reference(monkeypatch):
    """``split_lpgf=True`` on a seed where the cutoffs of every DPC call
    of both builds agree (checked: the 2% quantiles are recorded, the same
    number of calls, each within ``CUTOFF_RTOL``): the same permutation
    and node structure as the reference's build, every row in exactly one
    leaf, and LPGF run on each split node."""
    x = _clustered_grid(1500, 6, 1)
    kw = dict(min_leaf=32, max_leaf=256, dpc_sample=512, seed=0,
              split_lpgf=True)
    cutoffs = {"ref": [], "port": []}
    quantile = np.quantile

    def run(side, build, **extra):
        def rec(a, q, *args, **kwargs):
            v = quantile(a, q, *args, **kwargs)
            cutoffs[side].append(float(v))
            return v
        monkeypatch.setattr(np, "quantile", rec)
        try:
            return build(x, **kw, **extra)
        finally:
            monkeypatch.setattr(np, "quantile", quantile)

    moved = []
    real_lpgf = tindex.lpgf
    monkeypatch.setattr(tindex, "lpgf", lambda pts, **a: moved.append(
        len(pts)) or real_lpgf(pts, **a))
    jt, jperm, _ = run("ref", jindex.build_index)
    tt, tperm, rep = run("port", tindex.build_index, device="cpu")
    assert len(cutoffs["ref"]) == len(cutoffs["port"]) > 1
    np.testing.assert_allclose(cutoffs["port"], cutoffs["ref"],
                               rtol=CUTOFF_RTOL)
    np.testing.assert_array_equal(jperm, tperm)
    assert jt.children == tt.children
    for f in ("parent", "is_leaf", "bucket_start", "bucket_end", "depth"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    for f in ("centroid", "radius", "lm_a", "lm_b"):
        np.testing.assert_allclose(getattr(jt, f), getattr(tt, f),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.sort(tperm), np.arange(len(x)))
    assert rep.n_leaves == len(tt.leaf_ids) > 1
    assert moved and moved[0] == len(x) and min(moved) > kw["min_leaf"]


def test_split_lpgf_changes_the_split():
    """The option is live: on these points the LPGF-moved split gives
    another tree than the plain one."""
    x = _clustered_grid(1500, 6, 1)
    kw = dict(min_leaf=32, max_leaf=256, dpc_sample=512, seed=0,
              device="cpu")
    plain, pperm, _ = tindex.build_index(x, **kw)
    moved, mperm, _ = tindex.build_index(x, split_lpgf=True, **kw)
    assert not (np.array_equal(pperm, mperm)
                and plain.children == moved.children)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named, HIBOG, LPGF, DPC and ``build_index`` go to the
    card, as the package's device rule says, and raise where there is
    none (this build's CUDA is faked away)."""
    from repro_torch.core import dpc as tdpc_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _clustered_grid(200, 4, 0)
    for call in (lambda: tlpgf_mod.hibog(x), lambda: tlpgf_mod.lpgf(x),
                 lambda: tdpc_mod.dpc(x),
                 lambda: tindex.build_index(x, split_lpgf=True)):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            call()
