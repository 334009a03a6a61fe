"""The redesigned ``lpgf_force`` of ``csrc/lpgf_force.cu`` as plain torch
arithmetic: the distance tiles with row tile <= column tile only, in the
kernel's order, each stored with its mirror into an (N, N) buffer beside
per-tile row and column minima; d1 as the least of a row's partials; the
weights in place of the distances; then w @ x as the tile's product over
(w, x^T) with the epilogue F = acc - W * x. The model is held against the
plain version ``ref.lpgf_force`` and against the JAX package's
``lpgf_force_pallas`` in interpret mode, as tests/test_kernels.py runs
it. The CUDA kernels themselves are held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: against the plain version F within 1e-5 of its largest entry
and W rtol 1e-5 (fp32 sum order); against the Pallas kernel F within
2e-5 of its largest entry and W within 1e-4, as
tests/test_torch_kernels.py holds the plain version to it (XLA's sum
order). Integer-grid points make every distance exact, so there the
model's distances equal the plain version's bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lpgf_force import lpgf_force_pallas
from repro_torch.kernels import lpgf_force
from repro_torch.kernels import ref as tref
from repro_torch.utils.quant import sqrt_rn

torch.set_num_threads(1)

TILE = lpgf_force.TILE


def upper_tile(g: np.ndarray):
    """The kernel's ``upper_tile``: the g-th tile pair (rt <= ct), column
    tile by column tile, from an fp32 square root and integer fix-ups."""
    g = np.asarray(g, np.int64)
    c = ((np.sqrt(np.float32(8) * g.astype(np.float32) + np.float32(1))
          - np.float32(1)) * np.float32(0.5)).astype(np.int64)
    while True:
        down = (c > 0) & (c * (c + 1) // 2 > g)
        up = (c + 1) * (c + 2) // 2 <= g
        if not (down.any() or up.any()):
            break
        c = c - down + up
    return g - c * (c + 1) // 2, c


def force_model(x: torch.Tensor, radius: float, g_mean: float,
                c: float = 1.1):
    """(F, W, scratch) by the kernels' steps; scratch holds the mirrored
    distances, the partial minima and how often each partial was
    written."""
    n = x.shape[0]
    t = -(-n // TILE)
    d2 = torch.full((n, n), float("nan"))
    pmin = torch.full((n, t), float("nan"))
    writes = torch.zeros((n, t), dtype=torch.int64)
    rt, ct = upper_tile(np.arange(t * (t + 1) // 2))
    for r, cc in zip(rt.tolist(), ct.tolist()):
        rows = torch.arange(r * TILE, min(n, (r + 1) * TILE))
        cols = torch.arange(cc * TILE, min(n, (cc + 1) * TILE))
        tile = tref.pairwise_sq_l2(x[rows], x[cols])
        # self excluded by index, as the kernel does (not by d2 <= 1e-12)
        off = torch.where(rows[:, None] == cols[None, :],
                          torch.full_like(tile, float("inf")), tile)
        d2[rows[:, None], cols[None, :]] = tile
        pmin[rows, cc] = off.min(1).values
        writes[rows, cc] += 1
        if r != cc:
            d2[cols[:, None], rows[None, :]] = tile.T
            pmin[cols, r] = off.min(0).values
            writes[cols, r] += 1
    d1 = pmin.min(1).values
    # the weights replace the distances, with the kernel's fp32 constants
    r2 = float(np.float32(float(radius) * float(radius)))
    g = float(np.float32(g_mean))
    inv_c = float(np.float32(1.0 / c))
    ok = ~torch.eye(n, dtype=torch.bool)
    thr = g * sqrt_rn(d1)
    near = ok & (d2 <= thr[:, None])
    in_r = ok & (d2 <= r2)
    far = in_r & ~near
    w = (torch.where(far, d1[:, None] / torch.clamp_min(d2, 1e-12), 0.0)
         + torch.where(near & in_r, inv_c, 0.0))
    wsum = w.sum(1)
    # w @ x as the tile's dot product over (w, x^T), depth N, then the
    # epilogue
    xt = x.T.contiguous()
    acc = w @ xt.T
    f = acc - wsum[:, None] * x
    return f, wsum, dict(d2=d2, pmin=pmin, writes=writes, d1=d1, w=w)


def _points(n, d, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "grid":
        x = (rng.integers(-12, 13, (n, d)) * 0.25).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    if n > 7:
        x[7] = x[3]                                      # a duplicate
    return x


def _g(x: np.ndarray) -> float:
    """Mean nearest-neighbour distance; 1 for a single point."""
    if len(x) == 1:
        return 1.0
    d2 = tref.pairwise_sq_l2(torch.from_numpy(x), torch.from_numpy(x))
    d2.fill_diagonal_(float("inf"))
    return float(d2.min(1).values.sqrt().mean())


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("n,d,r_mult", [(1, 5, 7.5), (127, 9, 7.5),
                                        (129, 6, 1.5), (300, 11, 2.5)])
def test_model_matches_plain_and_pallas(n, d, r_mult, kind):
    x = _points(n, d, kind, n + d)
    g = _g(x)
    xt = torch.from_numpy(x)
    f, w, s = force_model(xt, r_mult * g, g)
    # each partial written once, the distances mirrored and complete
    assert bool((s["writes"] == 1).all())
    assert not bool(torch.isnan(s["d2"]).any())
    assert torch.equal(s["d2"], s["d2"].T)
    off = s["d2"].clone()
    off.fill_diagonal_(float("inf"))
    assert torch.equal(s["d1"], off.min(1).values)
    if kind == "grid":
        assert torch.equal(s["d2"], tref.pairwise_sq_l2(xt, xt))
        if n > 7:   # the duplicate is its twin's nearest neighbour
            assert s["d1"][3] == 0 and s["d1"][7] == 0
    wf, ww = tref.lpgf_force(xt, r_mult * g, g)
    scale = float(wf.abs().max()) + 1e-6
    assert float((f - wf).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(w, ww, rtol=1e-5, atol=1e-5)
    pf, pw = lpgf_force_pallas(jnp.asarray(x), r_mult * g, g, bm=32, bn=32,
                               interpret=True)
    pscale = float(np.abs(np.asarray(pf)).max()) + 1e-6
    np.testing.assert_allclose(f.numpy() / pscale, np.asarray(pf) / pscale,
                               atol=2e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(pw), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t", [1, 2, 32, 47, 1000])
def test_upper_tile_walks_each_pair_once_in_order(t):
    """The kernel's tile index law gives the pairs rt <= ct, column tile
    by column tile, each once: 528 at N = 4096 (t = 32)."""
    rt, ct = upper_tile(np.arange(t * (t + 1) // 2))
    want = [(r, c) for c in range(t) for r in range(c + 1)]
    assert list(zip(rt.tolist(), ct.tolist())) == want
    if t == 32:
        assert len(want) == 528


def test_upper_tile_fixups_repair_the_fp32_root():
    """Above 2^24 the fp32 square root alone misplaces some g by one
    column tile (N = 640,000 rows, 5,000 tiles); with the fix-ups every
    g maps to the one pair with ct (ct + 1) / 2 + rt = g, 0 <= rt <= ct."""
    t = 5000
    g = np.arange(t * (t + 1) // 2 - 1_000_000, t * (t + 1) // 2)
    raw = ((np.sqrt(np.float32(8) * g.astype(np.float32) + np.float32(1))
            - np.float32(1)) * np.float32(0.5)).astype(np.int64)
    assert bool(((raw * (raw + 1) // 2 > g)
                 | ((raw + 1) * (raw + 2) // 2 <= g)).any())
    rt, ct = upper_tile(g)
    assert bool(((0 <= rt) & (rt <= ct) & (ct < t)).all())
    assert np.array_equal(ct * (ct + 1) // 2 + rt, g)


def test_model_weights_exclude_self_by_index():
    """A point's duplicate lies at distance exactly 0 and counts as its
    neighbour (d1 = 0, the near ring at 1/c); its own pair never counts,
    though it too lies at 0."""
    x = _points(20, 4, "grid", 3)
    f, w, s = force_model(torch.from_numpy(x), 100.0, 1.0)
    inv_c = float(np.float32(1.0 / 1.1))
    assert s["w"][3, 7] == inv_c and s["w"][7, 3] == inv_c
    assert bool((torch.diagonal(s["w"]) == 0).all())
    wf, ww = tref.lpgf_force(torch.from_numpy(x), 100.0, 1.0)
    torch.testing.assert_close(w, ww, rtol=1e-5, atol=1e-5)
